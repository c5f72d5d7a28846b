"""Full private-search quality at scale (canonical n=1e6 demo).

Builds (or loads) the Vamana-style graph over SIFT-like clustered synthetic
vectors, then measures recall@10 for (a) the plaintext beam engine and
(b) the fused private path, against brute-force ground truth — the canonical
configuration of the reference (k=10, step=20, parallel=3, FailureProbLog2=8;
/root/reference/run-private-search.sh:16-18, private-search-report.txt).

Usage:
  python scripts/e2e_scale.py [--n 1000000] [--rounds 5] [--queries 100]
                              [--uniform] [--rebuild] [--build-only]

Writes phase timings to stdout, and the graph cache plus a JSON report to
runs/ (not committed).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pacmann.io.synth import synth_continuum, synth_continuum_device  # noqa: E402


def synth_vectors(n: int, d: int, clustered: bool, rng,
                  latent: int = 16, spread: float = 0.35) -> np.ndarray:
    """SIFT-like synthetic data (or uniform with --uniform).

    Clustered mode: a mixture of Gaussians whose CENTERS live in a
    `latent`-dimensional random subspace. Real descriptor data (SIFT
    intrinsic dimension ~12-16) is navigable because inter-cluster
    distances vary — beam search can route through chains of nearby
    clusters. Drawing centers i.i.d. in the full d=128 makes every pair of
    centers equidistant (distance concentration), which is ADVERSARIAL for
    any graph-ANN method: a query whose cluster holds no start vertex is
    unreachable (measured: recall caps at the fraction of start-covered
    clusters, ~0.52 at n=1e6). The low-dim-center mixture is the faithful
    stand-in for SIFT; the full-d variant remains available via latent=0
    for the adversarial row of the results table.
    """
    if not clustered:
        return rng.random((n, d), dtype=np.float32)
    n_c = max(256, int(np.sqrt(n)) // 4)  # 1M -> 250 -> 256; 65k -> 256
    n_c = 1 << int(np.ceil(np.log2(n_c)) + 2)  # 1M -> 1024
    if latent and latent < d:
        u = rng.standard_normal((n_c, latent)).astype(np.float32)
        basis = (rng.standard_normal((latent, d)) / np.sqrt(latent)) \
            .astype(np.float32)
        centers = u @ basis
    else:
        centers = rng.standard_normal((n_c, d)).astype(np.float32)
    out = np.empty((n, d), np.float32)
    block = 1 << 16
    for b0 in range(0, n, block):
        b = min(block, n - b0)
        lab = rng.integers(0, n_c, b)
        out[b0:b0 + b] = (centers[lab]
                          + spread * rng.standard_normal((b, d)).astype(
                              np.float32))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--random-starts", action="store_true",
                    help="reference-style random sqrt(n) starts instead of "
                         "the centroid start selection")
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--uniform", action="store_true")
    ap.add_argument("--continuum", action="store_true",
                    help="latent-manifold continuum data (the graph-vs-"
                         "cluster separation workload: nearest-centroid "
                         "collapses, graph search holds)")
    ap.add_argument("--device-synth", action="store_true",
                    help="synthesize the continuum data ON DEVICE and keep "
                         "the whole data path device-resident (no (n,d) "
                         "vector upload, no 640 MB raw-DB upload)")
    ap.add_argument("--latent", type=int, default=16,
                    help="intrinsic dim of cluster centers (0 = full-d "
                         "equidistant centers, the adversarial variant)")
    ap.add_argument("--keep", type=int, default=16,
                    help="keep_nearest harvest slots in the final prunes")
    ap.add_argument("--corridor", type=str, default="16:2",
                    help="phase-2b self-search beam budget max_step:parallel"
                         " (the highway-candidate generator)")
    ap.add_argument("--rebuild", action="store_true")
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--step", type=int, default=20)
    ap.add_argument("--parallel", type=int, default=3)
    args = ap.parse_args()

    n, d, m = args.n, 128, 32
    _cf = [int(x) for x in args.corridor.split(":")]
    cs, cp, cn = _cf[0], _cf[1], (_cf[2] if len(_cf) > 2 else 1)
    tag = (f"{n}_uniform" if args.uniform
           else f"{n}_continuum_l{args.latent}dev" if args.continuum
           and args.device_synth
           else f"{n}_continuum_l{args.latent}" if args.continuum
           else f"{n}_clustered_l{args.latent}")
    if (args.keep, cs, cp, cn) != (16, 16, 2, 1):  # recipe-bearing tag
        tag += f"_k{args.keep}c{cs}x{cp}x{cn}"
    run_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "runs")
    os.makedirs(run_dir, exist_ok=True)
    gpath = os.path.join(run_dir, f"graph_{tag}.npy")
    report_path = os.path.join(run_dir, f"e2e_{tag}_report.json")
    report = {"n": n, "d": d, "m": m, "rounds": args.rounds,
              "keep_nearest": args.keep, "corridor": args.corridor,
              "clustered": not args.uniform, "continuum": args.continuum,
              "latent": args.latent,
              "k": args.k,
              "step": args.step, "parallel": args.parallel}

    rng = np.random.default_rng(0)
    t0 = time.time()
    if args.continuum and args.device_synth:
        vectors = synth_continuum_device(n, d, seed=0, latent=args.latent)
        vectors.block_until_ready()
    elif args.continuum:
        vectors = synth_continuum(n, d, rng, latent=args.latent)
    else:
        vectors = synth_vectors(n, d, not args.uniform, rng,
                                latent=args.latent)
    print(f"vectors synthesized: {time.time()-t0:.1f}s", flush=True)

    from pacmann.graph.build import build_graph

    if os.path.exists(gpath) and not args.rebuild:
        graph = np.load(gpath).astype(np.int64)
        print("graph loaded", flush=True)
    else:
        t0 = time.time()
        graph = np.asarray(build_graph(vectors, m, rounds=args.rounds,
                                       seed=0, verbose=True,
                                       keep_nearest=args.keep,
                                       corridor_step=cs, corridor_par=cp,
                                       corridor_passes=cn),
                           np.int64)
        build_s = time.time() - t0
        report["build_s"] = round(build_s, 1)
        print(f"graph built: {build_s:.1f}s", flush=True)
        import jax

        ms = jax.local_devices()[0].memory_stats() or {}
        if "peak_bytes_in_use" in ms:
            report["peak_mem_build_gib"] = round(
                ms["peak_bytes_in_use"] / 2**30, 2)
        np.save(gpath, graph.astype(np.int32))
        # interim dump: a long big-n run leaves the build record even if a
        # later phase dies
        with open(report_path, "w") as f:
            json.dump(report, f, indent=1)
    if args.build_only:
        with open(report_path, "w") as f:
            json.dump(report, f)
        print("DONE (build only)", flush=True)
        return

    from pacmann.graph.recall import brute_force_knn, compute_recall

    Q = args.queries
    if args.uniform:
        queries = rng.random((Q, d), dtype=np.float32)
    else:
        # np.asarray first: with device-resident vectors this is a device
        # gather + a small (Q, d) D2H, not a full-DB pull
        queries = np.asarray(vectors[rng.choice(n, Q, replace=False)]) \
            + 0.1 * rng.standard_normal((Q, d)).astype(np.float32)
    t0 = time.time()
    gnd = brute_force_knn(vectors, queries, args.k)
    print(f"ground truth: {time.time()-t0:.1f}s", flush=True)

    from pacmann.graph.beam import PlaintextEngine
    from pacmann.graph.build import choose_start_ids

    if args.random_starts:
        sids = rng.choice(n, int(np.sqrt(n)), replace=False)
    else:
        t0 = time.time()
        sids = choose_start_ids(vectors, int(np.sqrt(n)), seed=0)
        print(f"centroid starts: {time.time()-t0:.1f}s", flush=True)
    eng = PlaintextEngine(vectors, graph, start_ids=sids)
    t0 = time.time()
    ids, _ = eng.search(queries, args.k, args.step, args.parallel, seed=1)
    r_plain = compute_recall(gnd, ids, args.k)
    report["plaintext_recall"] = round(r_plain, 4)
    print(f"plaintext recall@{args.k}: {r_plain:.4f} "
          f"({time.time()-t0:.1f}s incl. compile)", flush=True)

    from pacmann.pir.device_engine import DevicePianoEngine
    from pacmann.private.fused_search import FusedPrivateSearch
    from pacmann.private.oracle import (
        pack_vertex_db,
        pack_vertex_db_device,
    )

    if args.device_synth:
        raw = pack_vertex_db_device(vectors, graph)  # zero host round trip
    else:
        raw = pack_vertex_db(vectors, graph)
    engine = DevicePianoEngine(n, 4 * (d + m), m, raw, 8)
    t0 = time.time()
    engine.preprocessing(rng=np.random.default_rng(1))
    prep_s = time.time() - t0
    report["prep_s"] = round(prep_s, 2)
    print(f"prep: {prep_s:.1f}s (incl. compile)", flush=True)
    import jax

    ms = jax.local_devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" in ms:
        report["peak_mem_gib"] = round(ms["peak_bytes_in_use"] / 2**30, 2)

    fs = FusedPrivateSearch(engine, sids, np.asarray(vectors[sids]),
                            graph[sids], dim=d, m=m, n=n)
    # group-16 fused calls; the segmented path refreshes hints mid-group
    # whenever the budget window is short, so any group size works
    B = 16
    t0 = time.time()
    fs.search(queries[:B], k=args.k, max_step=args.step,
              parallel=args.parallel, seed=2)
    print(f"fused compile: {time.time()-t0:.1f}s", flush=True)
    out = np.zeros((Q, args.k), np.int64)
    t0 = time.time()
    for i in range(0, Q, B):
        j = min(i + B, Q)
        qb = queries[i:j]
        if len(qb) < B:
            qb = np.concatenate([qb, np.tile(qb[-1:], (B - len(qb), 1))])
        out[i:j] = fs.search(qb, k=args.k, max_step=args.step,
                             parallel=args.parallel, seed=3 + i)[: j - i]
    dt = time.time() - t0
    r_priv = compute_recall(gnd, out, args.k)
    report["private_recall"] = round(r_priv, 4)
    report["private_ms_per_query"] = round(dt / Q * 1000, 2)
    print(f"fused private: {dt/Q*1000:.1f} ms/query, "
          f"recall@{args.k}: {r_priv:.4f}", flush=True)

    with open(report_path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"report -> {report_path}", flush=True)
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
