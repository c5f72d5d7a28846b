"""Profile the fused private search on the device and reduce the trace.

Builds the SIFT1M-shaped engine (data from --seed), warms one group shape,
then records `--searches` searches under jax.profiler and reduces the trace
to: device busy share of the window (union of kernel intervals on the
device planes), the kernels that take the most device time, and the number
of device->host copies per beam step — the sign that a loop predicate
(lax.while_loop in the claim fixpoint, lax.cond in the segment scan) is
read back by the host on every iteration.

Usage: python scripts/trace_fused.py [--n 1000000] [--group 1] [--searches 3]
Writes chiprun_out/trace_fused_g<group>.json (and the raw trace under
chiprun_out/trace/).
"""

import argparse
import glob
import json
import os
import sys
import time
from collections import Counter

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _union(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(path: str, t0_ns: int, t1_ns: int):
    """Device busy share, top kernels and copy counts inside [t0, t1]."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    busy, kernels, copies, lines = [], Counter(), Counter(), []
    window = [None, None]
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines.append(f"{plane.name}|{line.name}")
            for ev in line.events:
                s, e = ev.start_ns, ev.start_ns + ev.duration_ns
                window[0] = s if window[0] is None else min(window[0], s)
                window[1] = e if window[1] is None else max(window[1], e)
                name = ev.name
                low = name.lower()
                if "memcpy" in low or "dtoh" in low or "htod" in low:
                    copies[name] += 1
                else:
                    busy.append((s, e))
                    kernels[name] += ev.duration_ns
    span = (window[1] - window[0]) if window[0] is not None else 0
    b = _union(busy)
    return dict(device_lines=lines, device_span_ms=span / 1e6,
                device_busy_ms=b / 1e6,
                idle_share=(1 - b / span) if span else None,
                top_kernels_ms={k: v / 1e6 for k, v in
                                kernels.most_common(15)},
                copies=dict(copies.most_common(10)),
                host_window_ms=(t1_ns - t0_ns) / 1e6)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--group", type=int, default=1)
    ap.add_argument("--searches", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    import chip_smoke
    from pacmann.io.synth import synth_raw_device
    from pacmann.pir.device_engine import DevicePianoEngine
    from pacmann.utils.platform import card_name_power, enable_compile_cache

    enable_compile_cache()
    card = card_name_power()
    n, G = args.n, args.group
    raw = synth_raw_device(n, chip_smoke.DIM + chip_smoke.M, args.seed,
                           float_cols=chip_smoke.DIM, nbr_cols=chip_smoke.M)
    eng = DevicePianoEngine(n, chip_smoke.ENTRY_BYTES, chip_smoke.M, raw, 8)
    eng.preprocessing(rng=np.random.default_rng(args.seed + 1))
    fs = chip_smoke._fused(eng, raw, n, args.seed)
    q = np.random.default_rng(args.seed + 2).random(
        (G, chip_smoke.DIM), dtype=np.float32)
    kw = dict(k=chip_smoke.K, max_step=chip_smoke.STEP,
              parallel=chip_smoke.PAR)
    fs.search(q, seed=1, **kw)                                 # compile
    fs.ensure_budget(chip_smoke.STEP, G * args.searches, chip_smoke.PAR)
    out_dir = os.path.join("chiprun_out", "trace", f"g{G}")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter_ns()
    with jax.profiler.trace(out_dir):
        for i in range(args.searches):
            fs.search(q, seed=2 + i, **kw)
        jax.block_until_ready(eng.state)
    t1 = time.perf_counter_ns()
    path = sorted(glob.glob(os.path.join(out_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    res = reduce_trace(path, t0, t1)
    steps = args.searches * chip_smoke.STEP
    res.update(card=card, n=n, group=G, searches=args.searches,
               copies_per_step={k: v / steps for k, v in
                                res["copies"].items()},
               wall_ms_per_search=(t1 - t0) / 1e6 / args.searches)
    with open(os.path.join("chiprun_out", f"trace_fused_g{G}.json"),
              "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: res[k] for k in (
        "group", "idle_share", "device_busy_ms", "device_span_ms",
        "wall_ms_per_search", "copies_per_step", "top_kernels_ms")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
