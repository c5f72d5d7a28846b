#!/usr/bin/env bash
# Non-private ANN baseline (reference run-ngt-search.sh role).
set -euo pipefail
cd "$(dirname "$0")/.."
python -m pacmann.cli.ann -n "${N:-1000000}" -d 128 -m 32 -k 10 \
  -q "${Q:-100}" -step 20 -parallel 3 \
  ${INPUT:+-input "$INPUT"} ${QUERY:+-query "$QUERY"} ${GND:+-gnd "$GND"} \
  ${GRAPH:+-graph "$GRAPH"} "$@"
