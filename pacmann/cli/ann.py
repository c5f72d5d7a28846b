"""Non-private ANN driver — plaintext sanity path.

Port of /root/reference/graphann/cmd/ann/ann.go (C14): build/load graph,
batched plaintext beam search on the device engine, recall report.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from pacmann.graph.beam import PlaintextEngine
from pacmann.graph.recall import brute_force_knn, compute_recall
from pacmann.io.loaders import (
    load_float32_matrix,
    load_int_matrix,
    save_int_matrix,
)
from pacmann.utils.platform import enable_compile_cache


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pacmann-ann")
    p.add_argument("-n", type=int, default=1000)
    p.add_argument("-d", "--dim", type=int, default=128)
    p.add_argument("-m", type=int, default=32)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("-q", type=int, default=100)
    p.add_argument("-input", default="")
    p.add_argument("-graph", default="")
    p.add_argument("-query", default="")
    p.add_argument("-output", default="")
    p.add_argument("-gnd", default="")
    p.add_argument("-step", type=int, default=20)
    p.add_argument("-parallel", type=int, default=3)
    p.add_argument("-seed", type=int, default=0)
    args = p.parse_args(argv)
    enable_compile_cache()

    rng = np.random.default_rng(args.seed)
    if args.input:
        vectors = load_float32_matrix(args.input, args.n, args.dim)
    else:
        vectors = rng.random((args.n, args.dim), dtype=np.float32)

    import os

    if args.graph and os.path.exists(args.graph):
        graph = load_int_matrix(args.graph, args.n, args.m)
    else:
        from pacmann.graph.build import build_graph

        t0 = time.perf_counter()
        graph = build_graph(vectors, args.m, seed=args.seed)
        print(f"Graph build time: {time.perf_counter() - t0:.2f}s")
        if args.graph:
            save_int_matrix(args.graph, graph)

    if args.query:
        queries = load_float32_matrix(args.query, args.q, args.dim)
    else:
        queries = rng.random((args.q, args.dim), dtype=np.float32)

    engine = PlaintextEngine(vectors, graph)
    t0 = time.perf_counter()
    ids, _ = engine.search(queries, args.k, args.step, args.parallel,
                           seed=args.seed)
    search_t = time.perf_counter() - t0
    print(f"Search time: {search_t:.3f}s "
          f"({search_t / max(args.q, 1) * 1000:.2f} ms/query)")

    if args.output:
        save_int_matrix(args.output, ids)

    if args.gnd:
        gnd = load_int_matrix(args.gnd, args.q, args.k)
    else:
        gnd = brute_force_knn(vectors, queries, args.k)
    recall = compute_recall(gnd, ids, args.k)
    print(f"Recall@{args.k}: {recall:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
