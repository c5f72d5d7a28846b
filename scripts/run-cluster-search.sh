#!/usr/bin/env bash
# Tiptoe-style cluster baseline (reference run-cluster-search.sh role).
set -euo pipefail
cd "$(dirname "$0")/.."
python -m pacmann.cli.cluster_search -n "${N:-1000000}" -d 128 -k 10 \
  -q "${Q:-100}" ${INPUT:+-input "$INPUT"} ${QUERY:+-query "$QUERY"} \
  ${GND:+-gnd "$GND"} -report "${REPORT:-cluster-report.txt}" "$@"
