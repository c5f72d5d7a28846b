"""Recall / graph-quality evaluation.

Ports of ComputeRecall (/root/reference/graphann/build_graph.go:809-851,
duplicate-aware recall@k) and EvaluateGraphQuality (:764-805, 100 self-queries
reporting hit rate + average steps-to-reach).
"""

from __future__ import annotations

import numpy as np


def compute_recall(gnd: np.ndarray, response: np.ndarray, k: int) -> float:
    """Duplicate-aware recall@k against top-k ground truth.

    The reference counts each *distinct* response id at most once and scores
    it iff it appears in the top-k ground truth — i.e. per query the hit
    count is |set(response[:k]) ∩ set(gnd[:k])|.
    """
    gnd = np.asarray(gnd)[:, :k]
    response = np.asarray(response)[:, :k]
    num_q = response.shape[0]
    total = 0.0
    for i in range(num_q):
        total += len(set(response[i].tolist()) & set(gnd[i].tolist()))
    return float(total / (num_q * float(k)))


def brute_force_knn(vectors: np.ndarray, queries: np.ndarray, k: int,
                    block: int = 4096) -> np.ndarray:
    """Exact ground-truth top-k by blocked L2 scan (for synthetic tests)."""
    from pacmann.ops.distance import l2_distance_xla

    if isinstance(vectors, np.ndarray):
        vectors = np.asarray(vectors, np.float32)
    # else: device-resident vectors stay on device — the blocked
    # l2_distance_xla passes slice them there (no D2H of the big array)
    out = []
    for start in range(0, queries.shape[0], 256):
        q = np.asarray(queries[start : start + 256], np.float32)
        best_d = None
        best_i = None
        for b0 in range(0, vectors.shape[0], block):
            d = np.asarray(l2_distance_xla(q, vectors[b0 : b0 + block]))
            ids = np.arange(b0, b0 + d.shape[1])
            if best_d is None:
                best_d, best_i = d, np.broadcast_to(ids, d.shape).copy()
            else:
                best_d = np.concatenate([best_d, d], axis=1)
                best_i = np.concatenate(
                    [best_i, np.broadcast_to(ids, d.shape)], axis=1
                )
            if best_d.shape[1] > 4 * k:
                part = np.argpartition(best_d, k, axis=1)[:, : 2 * k]
                best_d = np.take_along_axis(best_d, part, axis=1)
                best_i = np.take_along_axis(best_i, part, axis=1)
        order = np.argsort(best_d, axis=1, kind="stable")[:, :k]
        out.append(np.take_along_axis(best_i, order, axis=1))
    return np.concatenate(out, axis=0)


def evaluate_graph_quality(vectors: np.ndarray, graph: np.ndarray,
                           num_queries: int = 100, seed: int = 0,
                           use_engine: bool = True):
    """Self-query probe: search for each target's own vector; report hit rate
    and average steps (build_graph.go:764-805: k=20, maxStep=20, parallel=2).
    """
    rng = np.random.default_rng(seed)
    n = vectors.shape[0]
    targets = rng.integers(0, n, size=num_queries)
    # fancy-index FIRST (device gather for device arrays), then pull the
    # small (Q, d) slice — np.asarray(vectors) would D2H the whole DB
    queries = np.asarray(vectors[targets])

    if use_engine:
        from pacmann.graph.beam import PlaintextEngine

        engine = PlaintextEngine(vectors, graph)
        ids, steps = engine.search(queries, k=20, max_step=20, parallel=2,
                                   seed=seed)
    else:
        from pacmann.graph.beam_host import BasicGraphOracle, BeamSearcher

        searcher = BeamSearcher(BasicGraphOracle(vectors, graph), rng)
        searcher.preprocess()
        ids, steps = searcher.search_knn_batch(queries, 20, 20, 2)

    hits = ids[:, 0] == targets
    hit_rate = float(np.mean(hits))
    avg_steps = float(np.mean(steps[hits, 0])) if np.any(hits) else float("nan")
    return hit_rate, avg_steps
