"""Exact-search baseline — the quality upper bound (recall 1.0 by
construction), the role the NGT driver plays in the reference
(/root/reference/ngt-search/ngt-search.go, C15) with the linear-scan
inner-product baseline of graphann_test.go:221-284. One device uses one
distance product; several shard DB rows over the mesh
(parallel/sharding.py)."""

from __future__ import annotations

import argparse
import time

import numpy as np

from pacmann.graph.recall import compute_recall
from pacmann.io.loaders import load_float32_matrix, load_int_matrix
from pacmann.utils.platform import enable_compile_cache


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pacmann-exact-search")
    p.add_argument("-n", type=int, default=100000)
    p.add_argument("-d", "--dim", type=int, default=128)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("-q", type=int, default=100)
    p.add_argument("-input", default="")
    p.add_argument("-query", default="")
    p.add_argument("-gnd", default="")
    p.add_argument("-shards", type=int, default=1,
                   help=">1: shard DB rows over a device mesh")
    p.add_argument("-seed", type=int, default=0)
    args = p.parse_args(argv)
    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(args.seed)
    if args.input:
        vectors = load_float32_matrix(args.input, args.n, args.dim)
    else:
        vectors = rng.random((args.n, args.dim), dtype=np.float32)
    if args.query:
        queries = load_float32_matrix(args.query, args.q, args.dim)
    else:
        queries = rng.random((args.q, args.dim), dtype=np.float32)

    if args.shards > 1:
        from pacmann.parallel.sharding import (
            make_mesh, replicate, sharded_l2_topk)

        mesh = make_mesh(args.shards)
        pad = (-len(vectors)) % args.shards
        if pad:
            vectors = np.pad(vectors, ((0, pad), (0, 0)),
                             constant_values=np.inf)
        v_dev = jax.device_put(
            vectors, jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec("shard", None)))
        q_dev = replicate(mesh, queries)
        ids, _ = sharded_l2_topk(mesh, q_dev, v_dev, args.k)  # compile
        t0 = time.perf_counter()
        ids, dists = sharded_l2_topk(mesh, q_dev, v_dev, args.k)
        ids = np.asarray(ids)
        dt = time.perf_counter() - t0
    else:
        from pacmann.ops.distance import l2_distance_xla

        v_dev = jnp.asarray(vectors)
        q_dev = jnp.asarray(queries)

        @jax.jit
        def topk(q, v):
            d = l2_distance_xla(q, v)
            negd, idx = jax.lax.top_k(-d, args.k)
            return idx

        np.asarray(topk(q_dev, v_dev))  # compile
        t0 = time.perf_counter()
        ids = np.asarray(topk(q_dev, v_dev))
        dt = time.perf_counter() - t0

    print(f"Exact scan: {dt/max(args.q,1)*1000:.3f} ms/query "
          f"({args.n * args.q / max(dt, 1e-9) / 1e9:.2f} G dist/s)")
    if args.gnd:
        gnd = load_int_matrix(args.gnd, args.q, args.k)
        print(f"Recall@{args.k}: {compute_recall(gnd, ids, args.k):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
