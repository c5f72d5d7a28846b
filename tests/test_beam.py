"""Beam search: the vectorized device engine (graph/beam.py) against the
host-tier reference twin (graph/beam_host.py), plus graph-build quality
(the role of TestBuildGraphAndSearch / TestSearchQuality,
graphann_test.go:60-213, on synthetic data)."""

import numpy as np

from pacmann.graph.beam import PlaintextEngine
from pacmann.graph.beam_host import BasicGraphOracle, BeamSearcher
from pacmann.graph.build import build_graph
from pacmann.graph.recall import (
    brute_force_knn,
    compute_recall,
    evaluate_graph_quality,
)


def _data(n=2048, d=16, m=8, seed=11):
    rng = np.random.default_rng(seed)
    vectors = rng.random((n, d), dtype=np.float32)
    graph = np.asarray(build_graph(vectors, m, rounds=3, seed=seed), np.int64)
    return vectors, graph, rng


def test_engine_and_host_recall_parity():
    vectors, graph, rng = _data()
    queries = rng.random((16, vectors.shape[1]), dtype=np.float32)
    gnd = brute_force_knn(vectors, queries, 10)

    engine = PlaintextEngine(vectors, graph)
    ids_e, steps_e = engine.search(queries, k=10, max_step=12, parallel=3)
    r_engine = compute_recall(gnd, ids_e, 10)

    host = BeamSearcher(BasicGraphOracle(vectors, graph),
                        np.random.default_rng(0))
    host.preprocess()
    ids_h, _ = host.search_knn_batch(queries, 10, 12, 3)
    r_host = compute_recall(gnd, ids_h, 10)

    # identical traversal semantics -> equivalent quality (RNG padding and
    # tie-breaks differ, so exact id equality is not required)
    assert r_engine > 0.55, r_engine
    assert abs(r_engine - r_host) < 0.15, (r_engine, r_host)


def test_engine_reach_steps_monotonic():
    vectors, graph, rng = _data()
    queries = rng.random((4, vectors.shape[1]), dtype=np.float32)
    engine = PlaintextEngine(vectors, graph)
    ids, steps = engine.search(queries, k=10, max_step=12, parallel=3)
    assert np.all(steps[ids >= 0] >= 0)
    assert np.all(steps[ids >= 0] < 12)


def test_graph_self_query_quality():
    """evaluate_graph_quality: searching a vertex's own vector should find it
    (build_graph.go:764-805 gate)."""
    vectors, graph, _ = _data()
    hit_rate, avg_steps = evaluate_graph_quality(
        vectors, graph, num_queries=50, seed=3)
    assert hit_rate > 0.9, hit_rate
    assert avg_steps < 12


def test_built_graph_beats_random_graph():
    vectors, graph, rng = _data()
    n, m = graph.shape
    rand_graph = rng.integers(0, n, size=(n, m))
    queries = rng.random((16, vectors.shape[1]), dtype=np.float32)
    gnd = brute_force_knn(vectors, queries, 10)
    engine = PlaintextEngine(vectors, graph)
    r_built = compute_recall(gnd, engine.search(queries, 10, 12, 3)[0], 10)
    engine_r = PlaintextEngine(vectors, rand_graph)
    r_rand = compute_recall(gnd, engine_r.search(queries, 10, 12, 3)[0], 10)
    assert r_built > r_rand + 0.2, (r_built, r_rand)


def test_build_graph_n_not_block_multiple():
    """n in (1024, 2048) not a multiple of the 1024 search block used to
    crash search_paths_all (nblocks floor-div reshape); build_graph must
    work for any n (ADVICE r2, medium)."""
    rng = np.random.default_rng(5)
    n, m = 1500, 8
    vectors = rng.random((n, 12), dtype=np.float32)
    graph = np.asarray(build_graph(vectors, m, rounds=2, seed=5))
    assert graph.shape == (n, m)
    assert np.all(graph >= 0) and np.all(graph < n)


def test_graph_degree_invariants():
    vectors, graph, _ = _data()
    n, m = graph.shape
    assert np.all(graph >= 0) and np.all(graph < n)
    # exactly m distinct non-self out-edges (build_graph.go:457-475)
    for u in range(0, n, 97):
        row = graph[u]
        assert len(set(row.tolist())) == m
        assert u not in row
