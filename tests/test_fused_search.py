"""Fused private search (one device program) vs the host-orchestrated path:
same recall regime on the same graph/queries."""

import numpy as np

from pacmann.graph.build import build_graph
from pacmann.graph.recall import brute_force_knn, compute_recall
from pacmann.pir.device_engine import DevicePianoEngine
from pacmann.private.fused_search import FusedPrivateSearch
from pacmann.private.oracle import pack_vertex_db


def test_fused_search_end_to_end():
    rng = np.random.default_rng(8)
    n, d, m = 2048, 16, 8
    vectors = rng.random((n, d), dtype=np.float32)
    graph = np.asarray(build_graph(vectors, m, rounds=3, seed=8), np.int64)
    queries = rng.random((8, d), dtype=np.float32)
    gnd = brute_force_knn(vectors, queries, 10)

    raw = pack_vertex_db(vectors, graph)
    engine = DevicePianoEngine(n, 4 * (d + m), m, raw, 8)
    engine.preprocessing(rng=np.random.default_rng(1))

    sqrt_n = int(np.sqrt(n))
    sids = rng.choice(n, sqrt_n, replace=False)
    fs = FusedPrivateSearch(engine, sids, vectors[sids], graph[sids],
                            dim=d, m=m, n=n)
    # tiny per-partition budget at this scale: one query per fused call;
    # the wrapper refreshes hints proactively between calls
    out = [fs.search(queries[i : i + 1], k=10, max_step=16, parallel=3,
                     seed=4 + i) for i in range(8)]
    ids = np.concatenate(out)
    recall = compute_recall(gnd, ids, 10)
    # must land in the same regime as the host-orchestrated private path
    # (~0.7 at these settings; fused drops fewer fetches)
    assert recall > 0.55, recall

    # budget accounting advanced
    assert engine.queries_made_in_partition > 0
    fin = np.asarray(engine.state["finished"])
    assert fin.sum() > 0


def test_fused_search_mid_group_refresh():
    """A group whose sub-query need exceeds the per-partition budget is
    split into segments with a hint refresh between them (pir.go:525-533
    lifted to the group level); the search completes and stays in the
    normal recall regime instead of raising."""
    rng = np.random.default_rng(12)
    n, d, m = 1024, 8, 8
    vectors = rng.random((n, d), dtype=np.float32)
    graph = np.asarray(build_graph(vectors, m, rounds=3, seed=12), np.int64)
    raw = pack_vertex_db(vectors, graph)
    engine = DevicePianoEngine(n, 4 * (d + m), m, raw, 8)
    engine.preprocessing(rng=np.random.default_rng(3))
    sids = rng.choice(n, 32, replace=False)
    fs = FusedPrivateSearch(engine, sids, vectors[sids], graph[sids],
                            dim=d, m=m, n=n)
    # P=4, psize=256 -> budget 88/partition; Qn=2, parallel=3 -> quota=12,
    # so 16 steps need 192 sub-queries: the plan must split
    plan = fs.segment_plan(16, 12)
    assert sum(plan) == 16 and len(plan) >= 2, plan
    queries = rng.random((2, d), dtype=np.float32)
    gnd = brute_force_knn(vectors, queries, 10)
    out = fs.search(queries, k=10, max_step=16, parallel=3, seed=1)
    assert fs.refreshes >= 1
    recall = compute_recall(gnd, out, 10)
    assert recall > 0.55, recall


def test_fused_search_repeat_calls_share_budget():
    rng = np.random.default_rng(9)
    n, d, m = 1024, 8, 8
    vectors = rng.random((n, d), dtype=np.float32)
    graph = rng.integers(0, n, size=(n, m))
    raw = pack_vertex_db(vectors, graph)
    engine = DevicePianoEngine(n, 4 * (d + m), m, raw, 8)
    engine.preprocessing(rng=np.random.default_rng(2))
    sids = rng.choice(n, 32, replace=False)
    fs = FusedPrivateSearch(engine, sids, vectors[sids], graph[sids],
                            dim=d, m=m, n=n)
    queries = rng.random((4, d), dtype=np.float32)
    fs.search(queries, k=5, max_step=4, parallel=2, seed=0)
    used1 = engine.queries_made_in_partition
    worst = 4 * (4 * 2 * m // 4)  # max_step * quota
    # the host counter is the DEVICE-measured consumption: dedup'd and
    # dummy rows never spend budget, so it sits at or below the worst case
    assert 0 < used1 <= worst
    fin = np.asarray(engine.state["finished"])
    hist = np.asarray(engine.state["hist"])
    # resync = max(served, backup burn): admitted-then-denied rounds burn a
    # backup without serving, so the burn side can exceed `finished`
    assert used1 == int(max(fin.max(), hist.sum(axis=1).max()))
    # force the proactive refresh on the next call and check it is tallied
    # as maintenance and opens a fresh window
    engine.queries_made_in_partition = engine.params.max_query_num - 5
    fs.maintenance_s = 0.0
    fs.search(queries, k=5, max_step=4, parallel=2, seed=1)
    assert fs.maintenance_s > 0
    assert fs.last_maintenance_s > 0
    assert engine.queries_made_in_partition <= worst  # fresh window


def test_fused_search_cross_step_dedup_spares_budget():
    """Ids already fetched by an earlier step are never re-fetched (the
    reference serves them from its response cache without spending budget,
    pir.go:381-383): with every vertex pointing at the same m neighbors,
    only the first step's fetches consume device budget."""
    rng = np.random.default_rng(11)
    n, d, m = 1024, 8, 8
    vectors = rng.random((n, d), dtype=np.float32)
    graph = np.tile(np.arange(m, dtype=np.int64), (n, 1))
    raw = pack_vertex_db(vectors, graph)
    engine = DevicePianoEngine(n, 4 * (d + m), m, raw, 8)
    engine.preprocessing(rng=np.random.default_rng(5))
    sids = np.arange(100, 132)      # seeds distinct from the shared targets
    fs = FusedPrivateSearch(engine, sids, vectors[sids], graph[sids],
                            dim=d, m=m, n=n)
    queries = rng.random((2, d), dtype=np.float32)
    fs.search(queries, k=5, max_step=3, parallel=2, seed=0)
    worst = 3 * (2 * 2 * m // 4)    # 3 steps x quota 8
    used = engine.queries_made_in_partition
    # step 1 fetches the m shared ids once (in-step dedup across both
    # queries); steps 2-3 see only known ids -> all-dummy PIR rounds
    assert used <= m + 2, (used, worst)
    assert used < worst


def test_fused_table_free_identical_answers():
    """The fused program with a table-free engine (masks in pir state,
    online bitsliced PRF) returns the SAME answer ids as with the resident
    offset table, given identical preprocessing RNG and seeds."""
    rng = np.random.default_rng(21)
    n, d, m = 2048, 16, 8
    vectors = rng.random((n, d), dtype=np.float32)
    graph = np.asarray(build_graph(vectors, m, rounds=2, seed=21), np.int64)
    raw = pack_vertex_db(vectors, graph)
    queries = rng.random((2, d), dtype=np.float32)
    sids = rng.choice(n, 32, replace=False)
    outs = []
    for tf in (False, True):
        engine = DevicePianoEngine(n, 4 * (d + m), m, raw, 8, table_free=tf)
        engine.preprocessing(rng=np.random.default_rng(5))
        fs = FusedPrivateSearch(engine, sids, vectors[sids], graph[sids],
                                dim=d, m=m, n=n)
        outs.append(fs.search(queries, k=10, max_step=8, parallel=2,
                              seed=6))
    assert np.array_equal(outs[0], outs[1])


def _mk(seed, n=1024, d=8, m=8):
    rng = np.random.default_rng(seed)
    vectors = rng.random((n, d), dtype=np.float32)
    graph = np.asarray(build_graph(vectors, m, rounds=2, seed=seed),
                       np.int64)
    raw = pack_vertex_db(vectors, graph)
    engine = DevicePianoEngine(n, 4 * (d + m), m, raw, 8)
    engine.preprocessing(rng=np.random.default_rng(99))
    sids = np.arange(32)
    fs = FusedPrivateSearch(engine, sids, vectors[sids], graph[sids],
                            dim=d, m=m, n=n)
    return fs, rng


def test_fused_search_segmentation_invariant():
    """One compiled program serves every segment length (traced base /
    n_steps): a search split [2, 4] is bit-identical to the unsplit [6]
    when no refresh intervenes — the dynamic-trip-count path changes
    nothing about which sub-queries run or where results land."""
    fsA, rng = _mk(31)
    fsB, _ = _mk(31)
    queries = rng.random((2, 8), dtype=np.float32)
    outA = fsA.search(queries, k=5, max_step=6, parallel=2, seed=7)
    fsB.segment_plan = lambda ms, q, use_leftover=False: [2, 4]
    outB = fsB.search(queries, k=5, max_step=6, parallel=2, seed=7)
    assert np.array_equal(outA, outB)


def test_fused_search_leftover_budget_reuse():
    """Consecutive searches drain each hint window fully before refreshing
    (segment_plan use_leftover): the refresh count tracks consumed/budget —
    the protocol floor — instead of one refresh per search."""
    fs, rng = _mk(32)
    e = fs.engine
    refreshes = 0
    orig = e.preprocessing

    def counting(*a, **kw):
        nonlocal refreshes
        refreshes += 1
        return orig(*a, **kw)

    e.preprocessing = counting
    # P=4, budget 88/partition; Qn=2 parallel=2 m=8 -> quota 8/step,
    # max_step=4 -> worst 32/search: >= 2 searches per window
    n_searches = 5
    for i in range(n_searches):
        q = rng.random((2, 8), dtype=np.float32)
        out = fs.search(q, k=5, max_step=4, parallel=2, seed=10 + i)
        assert out.shape == (2, 5)
    assert refreshes < n_searches, refreshes
    assert refreshes >= 1


def test_ensure_budget_full_group_mode():
    """ensure_budget(min_steps=max_step) restores refresh-before-group:
    after it runs, a full search fits with zero mid-search refreshes, and
    an immediate second call does not refresh again (the clamp uses the
    same margin as the planner, so the mode is satisfiable)."""
    fs, rng = _mk(33)
    e = fs.engine
    q = rng.random((2, 8), dtype=np.float32)
    # force a nearly-drained window: only 2 of 4 steps fit
    e.queries_made_in_partition = 60
    fs.maintenance_s = 0.0
    fs.ensure_budget(4, 2, 2, min_steps=4)
    assert fs.maintenance_s > 0          # refreshed
    m0 = fs.maintenance_s
    fs.ensure_budget(4, 2, 2, min_steps=4)
    assert fs.maintenance_s == m0        # fresh window satisfies the mode
    fs.search(q, k=5, max_step=4, parallel=2, seed=2)
    assert fs.last_maintenance_s == 0.0  # no mid-search refresh


def test_fused_reach_steps_parity_with_host():
    """Fused mode's reach_steps (derived from the visited-table slot index,
    zero extra device work) must match the host twin's per-answer
    first-reached-step bookkeeping (search.go:210-233) for every answer the
    two paths agree on — same seeds-step-0 convention, same step indexing."""
    from pacmann.graph.beam_host import BasicGraphOracle, BeamSearcher

    rng = np.random.default_rng(41)
    n, d, m = 2048, 16, 8
    vectors = rng.random((n, d), dtype=np.float32)
    graph = np.asarray(build_graph(vectors, m, rounds=2, seed=41), np.int64)
    queries = rng.random((3, d), dtype=np.float32)
    sids = rng.choice(n, int(np.sqrt(n)), replace=False)

    raw = pack_vertex_db(vectors, graph)
    engine = DevicePianoEngine(n, 4 * (d + m), m, raw, 20)
    engine.preprocessing(rng=np.random.default_rng(1))
    fs = FusedPrivateSearch(engine, sids, vectors[sids], graph[sids],
                            dim=d, m=m, n=n)
    ids_f, steps_f = fs.search(queries, k=10, max_step=8, parallel=3,
                               seed=2, return_steps=True)
    assert ids_f.shape == steps_f.shape
    # valid answers carry a step in [0, max_step); padding stays -1
    assert np.all((steps_f >= 0) == (ids_f >= 0))
    assert steps_f.max() < 8

    # host twin on a plaintext oracle with the same start set
    oracle = BasicGraphOracle(vectors, graph)
    bs = BeamSearcher(oracle, np.random.default_rng(2))
    bs.start = (sids, vectors[sids], graph[sids])
    for qi in range(queries.shape[0]):
        ids_h, steps_h = bs.search_knn(queries[qi], 10, 8, 3)
        h_map = {int(i): int(s) for i, s in zip(ids_h, steps_h) if i >= 0}
        for i, s in zip(ids_f[qi], steps_f[qi]):
            if int(i) in h_map:
                assert h_map[int(i)] == int(s), (qi, i, s, h_map[int(i)])


def test_fused_split_route_bit_identical():
    """The big-tier chained-programs route (split_route=True: route /
    select / server scan / finish / update as five device programs per
    step) must be BIT-identical to the one-program scan — same answers,
    same reach steps, same device fetch stats, same protocol state. This
    is the route DBs above _PREP_SPLIT_DB_BYTES run (device_engine._online
    has the same split)."""
    outs = {}
    for split in (False, True):
        fs, rng = _mk(44)
        fs.split_route = split
        queries = np.random.default_rng(45).random((2, 8)).astype(np.float32)
        ids1, steps1 = fs.search(queries, k=5, max_step=6, parallel=2,
                                 seed=9, return_steps=True)
        # second search exercises leftover-window segmentation on the
        # chained route too
        ids2 = fs.search(queries, k=5, max_step=6, parallel=2, seed=10)
        outs[split] = dict(
            ids1=ids1, steps1=steps1, ids2=ids2,
            stats=fs.fetch_stats.copy(),
            consumed=fs.engine.queries_made_in_partition,
            state={k: np.asarray(v) for k, v in fs.engine.state.items()})
    a, b = outs[False], outs[True]
    assert np.array_equal(a["ids1"], b["ids1"])
    assert np.array_equal(a["steps1"], b["steps1"])
    assert np.array_equal(a["ids2"], b["ids2"])
    assert np.array_equal(a["stats"], b["stats"])
    assert a["consumed"] == b["consumed"]
    for key in a["state"]:
        assert np.array_equal(a["state"][key], b["state"][key]), key


def test_fused_split_route_mid_refresh_identical():
    """Split route with a mid-search hint refresh (multi-segment plan)
    stays identical to the fused scan under the same refresh schedule."""
    outs = {}
    for split in (False, True):
        rng = np.random.default_rng(46)
        n, d, m = 1024, 8, 8
        vectors = rng.random((n, d), dtype=np.float32)
        graph = np.asarray(build_graph(vectors, m, rounds=2, seed=46),
                           np.int64)
        raw = pack_vertex_db(vectors, graph)
        engine = DevicePianoEngine(n, 4 * (d + m), m, raw, 8)
        engine.preprocessing(rng=np.random.default_rng(5))
        sids = np.arange(32)
        fs = FusedPrivateSearch(engine, sids, vectors[sids], graph[sids],
                                dim=d, m=m, n=n)
        fs.split_route = split
        # Qn=2 parallel=3 m=8, P=4 -> quota 12/step; budget 88 -> the
        # 12-step search needs a mid-group refresh
        engine._rng = np.random.default_rng(7)  # identical refresh RNG
        q = np.random.default_rng(47).random((2, d)).astype(np.float32)
        out = fs.search(q, k=5, max_step=12, parallel=3, seed=11)
        assert fs.refreshes >= 1
        outs[split] = out
    assert np.array_equal(outs[False], outs[True])
