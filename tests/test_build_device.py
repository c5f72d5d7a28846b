"""Device graph-build pieces vs NumPy oracles: the degree-regularization
edge pipeline (_conn_lists_device) and the bootstrap cell-init invariants."""

import jax
import jax.numpy as jnp
import numpy as np

from pacmann.graph.build import (
    build_graph,
    _conn_lists_device,
    _kmeans_bootstrap,
    _prune_or_keep_device,
)


def test_conn_lists_device_matches_oracle():
    """Bidirectionalize + dedup + cap, with keep-prob forced to 1 (so the
    random sampling is inert and the result is deterministic)."""
    rng = np.random.default_rng(3)
    n, m, cap = 64, 4, 16
    pruned = rng.integers(0, n, size=(n, m)).astype(np.int32)
    pruned[pruned == np.arange(n)[:, None]] = -1  # some invalid slots
    pruned[0, :2] = -1

    # m' chosen so 1.5*m' >= any possible inbound -> keep prob 1 everywhere:
    # _conn_lists_device's keep prob uses the m it is given; pass m big.
    conn, counts = _conn_lists_device(
        jnp.asarray(pruned), jax.random.PRNGKey(0),
        n_real=n, m=10 * n, cap=cap)
    conn = np.asarray(conn)
    counts = np.asarray(counts)

    # oracle: per-vertex set of bidirectional neighbors
    want = [set() for _ in range(n)]
    for u in range(n):
        for v in pruned[u]:
            if v >= 0 and v != u:
                want[u].add(int(v))
                want[int(v)].add(u)
    for u in range(n):
        got = set(int(x) for x in conn[u] if x >= 0)
        expect = want[u] if len(want[u]) <= cap else None
        assert counts[u] == min(len(want[u]), cap), u
        if expect is not None:
            assert got == expect, u
        else:
            assert len(got) == cap and got <= want[u], u


def test_prune_or_keep_under_degree_untouched():
    """Vertices with <= m connections keep their full list verbatim."""
    rng = np.random.default_rng(4)
    n, d, m, cap = 32, 8, 4, 8
    v = rng.random((n, d)).astype(np.float32)
    conn = np.full((n, cap), -1, np.int32)
    counts = np.zeros(n, np.int32)
    for u in range(n):
        c = rng.choice([x for x in range(n) if x != u], size=3, replace=False)
        conn[u, :3] = c
        counts[u] = 3
    out = np.asarray(_prune_or_keep_device(
        jnp.asarray(v), jnp.asarray(conn), jnp.asarray(counts),
        m=m, block=n))
    assert np.array_equal(out[:, :3], conn[:, :3])
    assert np.all(out[:, 3:] == -1)


def test_kmeans_bootstrap_rows_are_cell_members():
    rng = np.random.default_rng(5)
    n, d, m, K = 512, 16, 8, 16
    v = rng.random((n, d)).astype(np.float32)
    init, labels, cent, ids_s, starts, sizes = _kmeans_bootstrap(
        jnp.asarray(v), jax.random.PRNGKey(1), K=K, m=m, iters=2,
        block=n, n_real=n)
    init = np.asarray(init)
    labels = np.asarray(labels)
    assert init.shape == (n, m)
    assert np.all(init >= 0) and np.all(init < n)
    # every initial neighbor shares the vertex's cell
    same = labels[init] == labels[:, None]
    assert float(same.mean()) > 0.99


def test_build_graph_compact_u8_matches_f32():
    """u8 host vectors (the bvecs compact-upload path) build the exact
    same graph as their eager-f32 form: u8 -> f32 widening is exact, so
    every distance — and therefore every edge decision — is identical."""
    from pacmann.graph.build import build_graph, choose_start_ids

    rng = np.random.default_rng(11)
    v_u8 = rng.integers(0, 256, size=(512, 24), dtype=np.uint8)
    g_u8 = build_graph(v_u8, 8, rounds=2, seed=3, quality_gate=False)
    g_f32 = build_graph(v_u8.astype(np.float32), 8, rounds=2, seed=3,
                        quality_gate=False)
    assert np.array_equal(g_u8, g_f32)

    s_u8 = choose_start_ids(v_u8, 16, seed=4)
    s_f32 = choose_start_ids(v_u8.astype(np.float32), 16, seed=4)
    assert np.array_equal(s_u8, s_f32)


def test_wide_round_sliced_matches_single():
    """The sliced wide round (the 4M worker-crash workaround: one program
    per slice + blocked pairwise merge, probe_wide_fault) selects the
    exact same candidate set as the single-program wide round: same
    distances, same ids, only top-k tie order may differ."""
    from pacmann.graph.build import _nn_round_device, _wide_round_sliced

    rng = np.random.default_rng(5)
    n, d, m, blk, out_m = 2048, 24, 16, 256, 24
    v = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    sqn = jnp.sum(v * v, axis=1)
    g = jnp.asarray(rng.integers(0, n, size=(n, m)).astype(np.int32))
    i1, d1 = _nn_round_device(v, sqn, g, jax.random.PRNGKey(3), nsn=2,
                              n_random=16, block=blk, n_real=n,
                              out_m=out_m, wide=True)
    i8, d8 = _wide_round_sliced(v, sqn, g, jax.random.PRNGKey(3),
                                n_random=16, block=blk, n_real=n,
                                out_m=out_m, parts=8)
    d1, d8, i1, i8 = map(np.asarray, (d1, d8, i1, i8))
    s1, s8 = np.sort(d1, axis=1), np.sort(d8, axis=1)
    fin = np.isfinite(s1)
    assert (np.isfinite(s8) == fin).all()
    assert np.allclose(s1[fin], s8[fin], atol=1e-4)
    for r in range(n):
        assert (set(i1[r][np.isfinite(d1[r])])
                == set(i8[r][np.isfinite(d8[r])]))


def test_precompiled_phases_build_the_same_graph():
    """build_graph's ahead-of-time compile pool (the "gpu" default) runs the
    same phase programs as the plain jitted calls: identical graphs."""
    rng = np.random.default_rng(12)
    vecs = rng.random((3000, 16), dtype=np.float32)
    a = build_graph(vecs, 8, rounds=2, seed=1, precompile=True)
    b = build_graph(vecs, 8, rounds=2, seed=1, precompile=False)
    assert np.array_equal(a, b)
