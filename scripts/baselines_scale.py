"""Baseline runs at canonical scale on the same synthetic data as
scripts/e2e_scale.py — anchors the comparison table the way the reference's
ngt-report.txt / cluster-report.txt do (C15/C16):

  exact   — linear scan (recall 1.0 by construction; quality UPPER
            bound, the role NGT's 0.999 plays in the reference)
  cluster — Tiptoe-style k-means + in-cluster scan (quality LOWER bound,
            reference: 0.391 on SIFT1M)

Usage: python scripts/baselines_scale.py [--n 1000000] [--latent 16]
Writes runs/{exact,cluster}-{tag}-report.txt (runs/ is not committed).
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--latent", type=int, default=16)
    ap.add_argument("--continuum", action="store_true",
                    help="latent-manifold continuum data (the separation "
                         "workload; expect cluster recall to collapse)")
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--k", type=int, default=10)
    args = ap.parse_args()
    n, d, Q, k = args.n, 128, args.queries, args.k
    kind = "continuum" if args.continuum else "clustered"
    tag = f"{n}_{kind}_l{args.latent}"

    from pacmann.io.synth import synth_continuum
    from scripts.e2e_scale import synth_vectors

    rng = np.random.default_rng(0)
    t0 = time.time()
    if args.continuum:
        vectors = synth_continuum(n, d, rng, latent=args.latent)
    else:
        vectors = synth_vectors(n, d, True, rng, latent=args.latent)
    print(f"vectors: {time.time()-t0:.1f}s", flush=True)
    queries = vectors[rng.choice(n, Q, replace=False)] \
        + 0.1 * rng.standard_normal((Q, d)).astype(np.float32)

    from pacmann.graph.recall import brute_force_knn, compute_recall

    t0 = time.time()
    gnd = brute_force_knn(vectors, queries, k)
    print(f"gnd: {time.time()-t0:.1f}s", flush=True)

    os.makedirs("runs", exist_ok=True)

    # ---- exact scan (quality upper bound; ngt-search.go role)
    import jax
    import jax.numpy as jnp

    from pacmann.ops.distance import l2_distance_xla
    from pacmann.utils.platform import card_name_power

    v_dev = jnp.asarray(vectors)
    q_dev = jnp.asarray(queries)

    @jax.jit
    def topk(q, v):
        dist = l2_distance_xla(q, v)
        negd, idx = jax.lax.top_k(-dist, k)
        return idx

    ids = np.asarray(topk(q_dev, v_dev))  # compile
    t0 = time.perf_counter()
    ids = np.asarray(topk(q_dev, v_dev))
    dt = time.perf_counter() - t0
    rec = compute_recall(gnd, ids, k)
    lines = [
        f"Exact scan baseline (quality upper bound; NGT role, "
        f"ngt-search.go:68-294)",
        f"n {n} dim {d} k {k} queries {Q} data {kind} latent={args.latent}",
        f"Avg query time: {dt/Q*1000:.3f} ms "
        f"({n*Q/max(dt,1e-9)/1e9:.2f} G dist/s on {card_name_power()})",
        f"Recall@{k}: {rec:.4f}",
        f"(reference NGT on SIFT1M: recall 0.999, 1.03 ms/query)",
    ]
    path = f"runs/exact-{tag}-report.txt"
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)

    # ---- cluster baseline (quality lower bound; cluster-search.py role)
    from pacmann.graph.cluster import ClusterSearcher

    K = int(np.sqrt(n))
    t0 = time.time()
    cs = ClusterSearcher(vectors, n_clusters=K, n_iter=10, seed=0)
    build_s = time.time() - t0
    # compile warmup at the timed block shape
    cs.search(queries[: cs.QUERY_BLOCK], k)
    t0 = time.perf_counter()
    ids_c = cs.search(queries, k)
    t_query = time.perf_counter() - t0
    rec_c = compute_recall(gnd, ids_c, k)
    lines = [
        f"Cluster (Tiptoe-style) baseline: k-means sqrt(n)={K} clusters, "
        f"nearest-cluster brute force (cluster-search.py role)",
        f"n {n} dim {d} k {k} queries {Q} data {kind} latent={args.latent}",
        f"k-means build: {build_s:.1f}s",
        f"Avg query time: {t_query/Q*1000:.3f} ms",
        f"Recall@{k}: {rec_c:.4f}",
        f"(reference FAISS cluster baseline on SIFT1M: recall 0.391, "
        f"0.374 ms/query)",
    ]
    path = f"runs/cluster-{tag}-report.txt"
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)


if __name__ == "__main__":
    main()
