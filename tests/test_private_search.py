"""End-to-end private search on synthetic data.

The device twin of the reference's north-star path (private-search.go:71-329):
entry packing, PIR-backed oracle, beam search over oblivious fetches, recall
vs brute-force ground truth, success accounting, proactive hint refresh.
Sizes scaled down for CI speed; full-scale runs live in bench.py.
"""

import numpy as np

from pacmann.graph.build import build_graph
from pacmann.graph.recall import brute_force_knn
from pacmann.private.driver import (
    PrivateSearchConfig,
    run_private_search,
)
from pacmann.private.oracle import pack_vertex_db, unpack_entries


def test_entry_pack_roundtrip():
    rng = np.random.default_rng(0)
    vec = rng.standard_normal((20, 16)).astype(np.float32)
    g = rng.integers(0, 1000, size=(20, 8)).astype(np.int64)
    raw = pack_vertex_db(vec, g)
    assert raw.shape == (20, 24) and raw.dtype == np.uint32
    v2, g2 = unpack_entries(raw, 16, 8)
    assert np.array_equal(v2, vec)
    assert np.array_equal(g2, g)


def _setup(n=2048, dim=16, m=8, q=8, seed=5):
    rng = np.random.default_rng(seed)
    vectors = rng.random((n, dim), dtype=np.float32)
    graph = np.asarray(build_graph(vectors, m, rounds=3, seed=seed), np.int64)
    queries = rng.random((q, dim), dtype=np.float32)
    gnd = brute_force_knn(vectors, queries, 10)
    return vectors, graph, queries, gnd


def test_private_vs_nonprivate_recall():
    vectors, graph, queries, gnd = _setup()
    n, dim = vectors.shape
    m = graph.shape[1]
    base = dict(n=n, dim=dim, m=m, k=10, q=queries.shape[0],
                max_step=16, parallel=3, build_graph=False, seed=7)

    plain = run_private_search(
        PrivateSearchConfig(**base, non_private=True),
        vectors=vectors, graph=graph, queries=queries, gnd=gnd,
    )
    priv = run_private_search(
        PrivateSearchConfig(**base),
        vectors=vectors, graph=graph, queries=queries, gnd=gnd,
    )
    # the graph + beam search must find real neighbors (uniform-random d=16
    # data is the structureless worst case; measured ~0.78 at 16 steps)
    assert plain.recall > 0.65, plain.recall
    # the private path loses some fetches to the lossy batch contract but
    # must stay in the same quality regime (measured ~0.71)
    assert priv.recall > plain.recall - 0.15, (priv.recall, plain.recall)
    # most oblivious fetches decode to the true (vector ‖ neighbors) record
    # (measured ~0.875 — drops are the FCFS overflow contract)
    assert priv.success_rate > 0.7, priv.success_rate


def test_report_and_outputs(tmp_path):
    vectors, graph, queries, gnd = _setup(n=1024, q=4)
    n, dim = vectors.shape
    m = graph.shape[1]
    out_f = str(tmp_path / "answers.txt")
    rep_f = str(tmp_path / "report.txt")
    res = run_private_search(
        PrivateSearchConfig(n=n, dim=dim, m=m, k=10, q=4, max_step=6,
                            parallel=2, build_graph=False, seed=3,
                            output_file=out_f, report_file=rep_f),
        vectors=vectors, graph=graph, queries=queries, gnd=gnd,
    )
    from pacmann.io.loaders import load_int_matrix

    saved = load_int_matrix(out_f, 4, 10)
    assert np.array_equal(saved, res.answers)
    text = open(rep_f).read()
    for field in ["Vector Num", "Preparation Time", "Recall",
                  "Online Communication Per Q"]:
        assert field in text
    assert res.report.avg_total_time_per_q_s >= res.avg_query_time_s


def test_benchmarking_mode_skips_prep():
    vectors, graph, queries, _ = _setup(n=1024, q=2)
    n, dim = vectors.shape
    res = run_private_search(
        PrivateSearchConfig(n=n, dim=dim, m=graph.shape[1], k=10, q=2,
                            max_step=4, parallel=2, benchmarking=True,
                            build_graph=False, seed=3),
        vectors=vectors, graph=graph, queries=queries,
    )
    # dummy prep: all fetches return zeros, so no answers are produced, but
    # the fixed access pattern runs to completion (private-search.go:189,404)
    assert res.prep_time_s < 5.0


def test_concurrent_matches_sequential_quality():
    """Lockstep concurrent search must match (or beat) sequential recall —
    the bigger PIR batches drop fewer fetches."""
    vectors, graph, queries, gnd = _setup()
    n, dim = vectors.shape
    m = graph.shape[1]
    base = dict(n=n, dim=dim, m=m, k=10, q=queries.shape[0],
                max_step=16, parallel=3, build_graph=False, seed=7)
    seq = run_private_search(
        PrivateSearchConfig(**base),
        vectors=vectors, graph=graph, queries=queries, gnd=gnd)
    conc = run_private_search(
        PrivateSearchConfig(**base, concurrent=8),
        vectors=vectors, graph=graph, queries=queries, gnd=gnd)
    assert conc.recall > seq.recall - 0.1, (conc.recall, seq.recall)
    assert conc.success_rate >= seq.success_rate - 0.05, (
        conc.success_rate, seq.success_rate)


def test_device_fused_driver_path():
    """engine=device-fused: whole search in one device program per group."""
    vectors, graph, queries, gnd = _setup(n=2048)
    n, dim = vectors.shape
    m = graph.shape[1]
    res = run_private_search(
        PrivateSearchConfig(n=n, dim=dim, m=m, k=10, q=queries.shape[0],
                            max_step=12, parallel=2, build_graph=False,
                            engine="device-fused", concurrent=1, seed=7),
        vectors=vectors, graph=graph, queries=queries, gnd=gnd,
    )
    assert res.recall > 0.45, res.recall


def test_driver_bvecs_input_builds_compact(tmp_path):
    """A .bvecs input file routes the graph build through the compact u8
    upload path and the whole private pipeline still runs."""
    import struct

    rng = np.random.default_rng(3)
    n, dim, m = 1024, 16, 8
    mat = rng.integers(0, 256, size=(n, dim), dtype=np.uint8)
    p = str(tmp_path / "vecs.bvecs")
    with open(p, "wb") as f:
        for row in mat:
            f.write(struct.pack("<i", dim))
            f.write(row.tobytes())

    cfg = PrivateSearchConfig(n=n, dim=dim, m=m, k=10, q=4, max_step=12,
                              parallel=2, build_graph=True, seed=9,
                              input_file=p)
    res = run_private_search(cfg)
    assert res.answers.shape == (4, 10)
    assert res.success_rate > 0.5
