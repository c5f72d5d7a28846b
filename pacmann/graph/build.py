"""Vamana-style constant-degree graph construction on the device.

Replaces the reference's cgo/C++ NGT candidate generation + scalar
robustPrune (/root/reference/graphann/build_graph.go:96-511) with in-house
batched passes:

  1. Candidate generation: NN-descent rounds — each vertex scores its current
     neighbors, sampled neighbors-of-neighbors, sampled reverse edges, and a
     few random vertices, keeping the closest (the role NGT's 1.5*m search
     plays at build_graph.go:384). The ENTIRE round runs as one device
     program: the adjacency stays in device memory across rounds,
     reverse-edge sampling is a device sort, per-block candidate scoring is
     a lax.scan, and RNG is jax.random — nothing crosses the host boundary
     between rounds.
  2. Robust alpha-prune (DiskANN rule, alpha=1.2): the reference's greedy
     triangle test (build_graph.go:156-223) vectorized — per-vertex candidate
     pairwise-distance tiles + a masked sequential accept loop over the
     (sorted) candidate axis, scanned over vertex blocks on device.
  3. Degree regularization, exactly the reference pipeline
     (build_graph.go:414-484): bidirectionalize, keep edge u->v w.p.
     min(1.5m/inbound[v], 1), re-prune if > m, random-fill to exactly m.

Output: (n, m) int32 adjacency, every row exactly m distinct non-self edges.

Matrix products run at Precision.HIGHEST (_PREC): on the GPU a
default-precision f32 product may run in TF32 (~3 decimal digits). The
one-hot Lloyd sums must be exact, and the distance products keep the f32
reference's candidate order; recall is checked on the card (chip_smoke.py).
"""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

ALPHA = 1.2  # build_graph.go:357
_PREC = jax.lax.Precision.HIGHEST

# Host dtypes uploaded as-is and widened to f32 ON DEVICE. SIFT-style byte
# vectors (bvecs, u8) upload 4x smaller than the eager-f32 form — at 1M x 128
# that is 128 MB instead of 512 MB over the host link; u8/f16 -> f32 is
# exact, bf16 is the caller's explicit precision choice.
_COMPACT_DTYPES = ("uint8", "int8", "float16", "bfloat16")


def _compact_host(vectors) -> np.ndarray:
    """Normalize a host vector matrix for upload: narrow dtypes are kept
    (widened to f32 on device after transfer); everything else becomes
    float32 on host."""
    vectors = np.asarray(vectors)
    if vectors.dtype.name in _COMPACT_DTYPES:
        return np.ascontiguousarray(vectors)
    return np.asarray(vectors, np.float32)


# ---------------------------------------------------------------------------
# batched candidate scoring


def _select_topk_sorted(vectors, sqn, q, self_ids, cand, out_m):
    """Top-out_m distinct candidates by L2 (no self), sort-based dedup.

    cand (B, C) i32; returns ((B, out_m) ids, (B, out_m) dists). Distances
    via the dot identity (|c|^2 - 2 q.c + |q|^2); duplicates are masked
    by sorting the candidate axis and comparing neighbors — O(C log C)
    instead of the (B, C, C) equality tensor, which capped block sizes."""
    cv = vectors[cand]                                  # (B, C, d) gather
    dots = jnp.einsum("bcd,bd->bc", cv, q, precision=_PREC,
                      preferred_element_type=jnp.float32)
    dist = sqn[cand] - 2.0 * dots \
        + jnp.sum(q * q, axis=1, keepdims=True)         # (B, C)
    order = jnp.argsort(cand, axis=1)
    cs = jnp.take_along_axis(cand, order, axis=1)
    ds = jnp.take_along_axis(dist, order, axis=1)
    dup = jnp.concatenate(
        [jnp.zeros((cand.shape[0], 1), bool), cs[:, 1:] == cs[:, :-1]],
        axis=1)
    ds = jnp.where(dup | (cs == self_ids[:, None]), jnp.inf, ds)
    negd, idx = jax.lax.top_k(-ds, out_m)
    return jnp.take_along_axis(cs, idx, axis=1), -negd


def _reverse_sample_device(graph, key, nsn: int, n_real: int):
    """(npad, nsn) i32: for each directed edge u->v, v receives up to nsn
    random u's; empty slots filled with random real ids. Device sort by
    (target, random tiebreak) + within-group rank scatter."""
    npad, m = graph.shape
    E = npad * m
    k_tie, k_fill = jax.random.split(key)
    dst = graph.reshape(-1)
    src = jax.lax.iota(jnp.int32, E) // m
    tie = jax.random.bits(k_tie, (E,), jnp.uint32)
    dst_s, _, src_s = jax.lax.sort((dst, tie, src), num_keys=2)
    starts = jnp.searchsorted(dst_s, jnp.arange(npad, dtype=jnp.int32))
    rank = jnp.arange(E, dtype=jnp.int32) - starts[dst_s]
    slot = jnp.where(rank < nsn, rank, nsn)             # nsn = OOB -> dropped
    rev = jnp.full((npad, nsn), -1, jnp.int32).at[dst_s, slot].set(
        src_s, mode="drop")
    fill = jax.random.randint(k_fill, (npad, nsn), 0, n_real, jnp.int32)
    # padded vertices (id >= n_real) may appear as sources; replace them too
    return jnp.where((rev < 0) | (rev >= n_real), fill, rev)


def _merge_topk(ids_m, d_m, out_m):
    """Exact top-out_m distinct merge of concatenated per-slice top-k
    results: re-apply the sort-based dedup (a candidate can appear in
    several slices) and keep the out_m smallest. Correct because any
    member of the global distinct top-out_m is inside its own slice's
    distinct top-out_m. Sorted by (id, dist) — not id alone — so the
    finite copy of an id survives dedup even when another slice emitted
    the same id as inf-masked top-k filler."""
    cs, ds = jax.lax.sort((ids_m, d_m), dimension=1, num_keys=2)
    dup = jnp.concatenate(
        [jnp.zeros((ids_m.shape[0], 1), bool), cs[:, 1:] == cs[:, :-1]],
        axis=1)
    ds = jnp.where(dup, jnp.inf, ds)
    negd, idx = jax.lax.top_k(-ds, out_m)
    return jnp.take_along_axis(cs, idx, axis=1), -negd


@functools.partial(jax.jit, static_argnames=(
    "per", "n_random", "block", "n_real", "out_m"))
def _wide_slice_round(vectors, sqn, graph, key, j, *, per: int,
                      n_random: int, block: int, n_real: int, out_m: int):
    """One SLICE of the big-build wide round as its OWN compiled program.

    Builds past 2M vertices split the wide round (candidate width
    m+m^2+r) this way, a workaround kept from the first device this
    program ran on; whether the H100 needs it is open (ROADMAP). Each
    slice of the m^2 neighbor-of-neighbor columns is a SEPARATE program of
    descent-class shape (cand width m + m*per + r), with the slice index j
    TRACED (lax.dynamic_slice on the column axis) so ONE compile serves
    all slices. Every slice carries the same
    nbrs+rnd columns (the merge dedups them), so the union of slice
    candidate sets equals the single-program wide round's candidate set
    exactly and the merged result matches it up to top-k tie order.
    """
    npad, m = graph.shape
    nblocks = npad // block
    _, k_blocks = jax.random.split(key)  # match _nn_round_device's streams

    def body(_, b):
        ids = b * block + jnp.arange(block, dtype=jnp.int32)
        nbrs = jax.lax.dynamic_slice(graph, (b * block, 0), (block, m))
        kb = jax.random.fold_in(k_blocks, b)
        nn_all = graph[nbrs.reshape(-1)].reshape(block, m, m)
        nnj = jax.lax.dynamic_slice(
            nn_all, (0, 0, j * per), (block, m, per)).reshape(block, m * per)
        rnd = jax.random.randint(
            jax.random.fold_in(kb, 2), (block, n_random), 0, n_real,
            jnp.int32)
        cand = jnp.concatenate([nbrs, nnj, rnd], axis=1)
        q = jax.lax.dynamic_slice(
            vectors, (b * block, 0), (block, vectors.shape[1]))
        return _, _select_topk_sorted(vectors, sqn, q, ids, cand,
                                      min(out_m, cand.shape[1]))

    _, (sids, sd) = jax.lax.scan(body, None,
                                 jnp.arange(nblocks, dtype=jnp.int32))
    k = sids.shape[-1]
    return sids.reshape(npad, k), sd.reshape(npad, k)


@functools.partial(jax.jit, static_argnames=("out_m", "block"),
                   donate_argnums=(0, 1))
def _merge_topk_blocked(ids_a, d_a, ids_b, d_b, *, out_m: int, block: int):
    """Pairwise exact distinct-top-out_m merge (_merge_topk) as its own
    blocked program: the big-build wide round folds its per-slice results
    through this so no single program exceeds the descent-proven shape
    class. Progressive pairwise truncation to out_m is exact because any
    global distinct-top-out_m member is inside the running top-out_m at
    every prefix (same argument as _merge_topk's docstring). The running
    accumulator (a) is DONATED — at 4M each (npad, out_m) pool pair is
    ~2 GB."""
    npad = ids_a.shape[0]
    nblocks = npad // block

    def body(_, b):
        ia = jax.lax.dynamic_slice(
            ids_a, (b * block, 0), (block, ids_a.shape[1]))
        da = jax.lax.dynamic_slice(
            d_a, (b * block, 0), (block, d_a.shape[1]))
        ib = jax.lax.dynamic_slice(
            ids_b, (b * block, 0), (block, ids_b.shape[1]))
        db = jax.lax.dynamic_slice(
            d_b, (b * block, 0), (block, d_b.shape[1]))
        return _, _merge_topk(jnp.concatenate([ia, ib], axis=1),
                              jnp.concatenate([da, db], axis=1), out_m)

    _, (mi, md) = jax.lax.scan(body, None,
                               jnp.arange(nblocks, dtype=jnp.int32))
    return mi.reshape(npad, out_m), md.reshape(npad, out_m)


def _wide_round_sliced(vectors, sqn, graph, key, *, n_random: int,
                       block: int, n_real: int, out_m: int, parts: int,
                       run=None, verbose=False, el=None):
    """Big-build wide round: `parts` separate slice programs folded
    through the blocked pairwise merge. `run(name, fn, *args, **statics)`
    is build_graph's phase runner (AOT-compiled programs when present)."""
    if run is None:
        def run(name, fn, *args, **statics):
            return fn(*args, **statics)
    m = graph.shape[1]
    per = -(-m // parts)
    acc = None
    for j in range(parts):
        s = run("wide_slice", _wide_slice_round, vectors, sqn, graph, key,
                jnp.asarray(j, jnp.int32), per=per, n_random=n_random,
                block=block, n_real=n_real, out_m=out_m)
        acc = s if acc is None else run(
            "wide_merge", _merge_topk_blocked, acc[0], acc[1], s[0], s[1],
            out_m=out_m, block=block)
        del s  # 2 GB/pool at 4M: drop before the next slice runs
        if verbose:
            jax.block_until_ready(acc)
            print(f"wide slice {j + 1}/{parts} done"
                  + (f" {el()}" if el else ""), flush=True)
    return acc


@functools.partial(jax.jit, static_argnames=(
    "nsn", "n_random", "block", "n_real", "out_m", "wide"))
def _nn_round_device(vectors, sqn, graph, key, *, nsn: int, n_random: int,
                     block: int, n_real: int, out_m: int, wide: bool):
    """One full NN-descent round on device -> ((npad, out_m) ids, dists).

    wide=False: candidates = own neighbors + nsn sampled neighbors-of-
    neighbors each + nsn reverse edges + n_random randoms, keep top out_m=m.
    wide=True: the final widened pool — ALL m^2 neighbors-of-neighbors +
    randoms, keep top out_m=cand_size (prune pool; build_graph.go:384 role).
    Builds past 2M vertices use _wide_round_sliced instead (see
    _wide_slice_round's docstring).
    """
    npad, m = graph.shape
    nblocks = npad // block
    k_rev, k_blocks = jax.random.split(key)
    rev = None if wide else _reverse_sample_device(graph, k_rev, nsn, n_real)

    def body(_, b):
        ids = b * block + jnp.arange(block, dtype=jnp.int32)
        nbrs = jax.lax.dynamic_slice(graph, (b * block, 0), (block, m))
        kb = jax.random.fold_in(k_blocks, b)
        nn_all = graph[nbrs.reshape(-1)].reshape(block, m, m)
        if wide:
            nn = nn_all.reshape(block, m * m)
            parts = [nbrs, nn]
        else:
            pick = jax.random.randint(
                jax.random.fold_in(kb, 1), (block, m, nsn), 0, m, jnp.int32)
            nn = jnp.take_along_axis(nn_all, pick, axis=2).reshape(block, -1)
            revb = jax.lax.dynamic_slice(rev, (b * block, 0), (block, nsn))
            # neighbors-of-REVERSE-neighbors: the standard NN-descent local
            # join uses both edge directions; forward-only propagation
            # converges much more slowly at large n
            rpick = jax.random.randint(
                jax.random.fold_in(kb, 3), (block, nsn, nsn * 2), 0, m,
                jnp.int32)
            rnn = jnp.take_along_axis(
                graph[revb.reshape(-1)].reshape(block, nsn, m), rpick,
                axis=2).reshape(block, -1)
            parts = [nbrs, nn, revb, rnn]
        rnd = jax.random.randint(
            jax.random.fold_in(kb, 2), (block, n_random), 0, n_real,
            jnp.int32)
        cand = jnp.concatenate(parts + [rnd], axis=1)
        q = jax.lax.dynamic_slice(
            vectors, (b * block, 0), (block, vectors.shape[1]))
        return _, _select_topk_sorted(vectors, sqn, q, ids, cand, out_m)

    _, (new_ids, new_d) = jax.lax.scan(
        body, None, jnp.arange(nblocks, dtype=jnp.int32))
    return new_ids.reshape(npad, out_m), new_d.reshape(npad, out_m)


def _lloyd_sums(vectors, labels, *, K: int, block: int, n_real: int):
    """Per-cell vector sums + counts via blocked one-hot matmuls, exact at
    Precision.HIGHEST (each output is a sum of f32 vector entries)."""
    npad, d = vectors.shape
    nblocks = npad // block

    def body(carry, b):
        sums, cnts = carry
        q = jax.lax.dynamic_slice(vectors, (b * block, 0), (block, d))
        lab = jax.lax.dynamic_slice(labels, (b * block,), (block,))
        ids = b * block + jnp.arange(block, dtype=jnp.int32)
        w = (ids < n_real).astype(jnp.float32)
        oh = (lab[:, None] == jnp.arange(K, dtype=lab.dtype)[None, :]) \
            .astype(jnp.float32) * w[:, None]            # (block, K)
        return (sums + jnp.dot(oh.T, q, precision=_PREC),
                cnts + jnp.sum(oh, axis=0)), None

    (sums, cnts), _ = jax.lax.scan(
        body, (jnp.zeros((K, d), jnp.float32), jnp.zeros((K,), jnp.float32)),
        jnp.arange(nblocks, dtype=jnp.int32))
    return sums, cnts


@functools.partial(jax.jit, static_argnames=(
    "K", "m", "iters", "block", "n_real"))
def _kmeans_bootstrap(vectors, key, *, K: int, m: int, iters: int,
                      block: int, n_real: int):
    """Locality-seeded initial graph: a few Lloyd iterations partition the
    space into ~K cells, then every vertex's initial row is m random members
    of its own cell. NN-descent from a RANDOM graph must bootstrap each
    vertex's first nearby neighbor by luck (~cell_size/n per candidate) and
    stalls at large n (measured: 1.1 % true-NN overlap after 5 rounds at
    n=1e6); descent from a locality-seeded graph only has to refine.

    Returns (npad, m) i32 initial adjacency (self-entries possible; the
    scoring rounds mask them).
    """
    npad, d = vectors.shape
    k_init, k_tie, k_pick = jax.random.split(key, 3)
    cent = vectors[jax.random.randint(k_init, (K,), 0, n_real, jnp.int32)]

    def assign(cent):
        nblocks = npad // block

        def body(carry, b):
            q = jax.lax.dynamic_slice(vectors, (b * block, 0), (block, d))
            dots = jnp.dot(q, cent.T, precision=_PREC)    # (block, K)
            cn = jnp.sum(cent * cent, axis=1)
            lab = jnp.argmin(cn[None, :] - 2.0 * dots, axis=1)
            return carry, lab.astype(jnp.int32)

        _, labs = jax.lax.scan(body, None,
                               jnp.arange(nblocks, dtype=jnp.int32))
        return labs.reshape(npad)

    labels = assign(cent)
    for _ in range(iters):
        # Lloyd update as blocked one-hot matmuls instead of a colliding
        # .at[labels].add scatter over (n, d)
        sums, cnts = _lloyd_sums(vectors, labels, K=K, block=block,
                                 n_real=n_real)
        cent = jnp.where(cnts[:, None] > 0, sums / jnp.maximum(cnts, 1.0)[
            :, None], cent)
        labels = assign(cent)

    # group-major order with random tiebreak; per-vertex random members
    tie = jax.random.bits(k_tie, (npad,), jnp.uint32)
    # padded vertices get label K so they sort to the end and never pollute
    # real cells
    labels = jnp.where(jnp.arange(npad) < n_real, labels, K)
    lab_s, _, ids_s = jax.lax.sort(
        (labels, tie, jnp.arange(npad, dtype=jnp.int32)), num_keys=2)
    starts = jnp.searchsorted(lab_s, jnp.arange(K + 1, dtype=jnp.int32))
    sizes = jnp.diff(jnp.concatenate(
        [starts, jnp.array([npad], starts.dtype)]))   # (K+1,)
    l_of = labels
    cnt = jnp.maximum(sizes[l_of], 1)                    # (npad,)
    off = jax.random.randint(k_pick, (npad, m), 0, 1 << 30, jnp.int32)
    idx = starts[l_of][:, None] + off % cnt[:, None]
    init = ids_s[jnp.clip(idx, 0, npad - 1)]
    return init, labels, cent, ids_s, starts, sizes


@functools.partial(jax.jit, static_argnames=("L",))
def _ladder_candidates(labels, cent, ids_s, starts, sizes, key, *, L: int):
    """Kleinberg-style distance-stratified long-range candidates: for each
    vertex, one random member of the cell ranked 2^j (j=0..L-1) by centroid
    distance from its own cell. Uniform random long edges do not support
    efficient greedy routing at scale (recall degraded 65k -> 1M with far
    edges alone); a geometric ladder of scales does."""
    npad = labels.shape[0]
    K = cent.shape[0]
    cn = jnp.sum(cent * cent, axis=1)
    cd = cn[None, :] - 2.0 * jnp.dot(cent, cent.T, precision=_PREC)
    order = jnp.argsort(cd, axis=1)                      # row r: cells by dist
    ladder = jnp.minimum(2 ** jnp.arange(L), K - 1)      # ranks 1,2,4,...
    sel = order[:, ladder]                               # (K, L)
    cells = sel[jnp.minimum(labels, K - 1)]              # (npad, L)
    cnt = jnp.maximum(sizes[cells], 1)
    off = jax.random.randint(key, cells.shape, 0, 1 << 30, jnp.int32)
    idx = starts[cells] + off % cnt
    return ids_s[jnp.clip(idx, 0, npad - 1)]


@functools.partial(jax.jit, static_argnames=("n_real", "m", "cap"))
def _conn_lists_device(pruned, key, *, n_real: int, m: int, cap: int):
    """Degree-regularization edge pipeline on device (build_graph.go:414-452):
    bidirectionalize, keep edge x->y w.p. min(1.5m/inbound[y], 1), dedup,
    and scatter each vertex's survivors into a cap-bounded connection list
    (random subset for mega-hubs). Returns (conn (npad, cap) i32 -1-padded,
    counts (npad,) i32 = min(list length, cap)).

    Two device sorts instead of host lexsorts over 2*n*m edges. `pruned`
    rows >= n_real are ignored.
    """
    npad, mw = pruned.shape      # mw = row width; m only sets the keep prob
    E = npad * mw
    SENT = jnp.int32(n_real)  # sentinel group: dropped edges sort last
    k1, k2 = jax.random.split(key)
    rows = jax.lax.broadcasted_iota(jnp.int32, (npad, mw), 0)
    valid = (pruned >= 0) & (rows < n_real)
    src = rows.reshape(-1)
    dst = jnp.where(valid, pruned, -1).reshape(-1)
    bsrc = jnp.concatenate([src, jnp.where(dst < 0, SENT, dst)])
    bdst = jnp.concatenate([jnp.where(dst < 0, SENT, dst), src])
    bad = (bsrc >= n_real) | (bdst >= n_real) | (bsrc == bdst)
    bsrc = jnp.where(bad, SENT, bsrc)
    bdst_c = jnp.minimum(bdst, SENT)
    inbound = jnp.zeros(n_real + 1, jnp.float32).at[
        jnp.where(bad, SENT, bdst_c)].add(1.0)
    keepp = jnp.minimum(
        1.5 * m / jnp.maximum(inbound[bdst_c], 1.0), 1.0)
    u = jax.random.uniform(k1, (2 * E,))
    bsrc = jnp.where(u >= keepp, SENT, bsrc)
    # dedup: sort by (src, dst), mask consecutive duplicates
    s1, d1 = jax.lax.sort((bsrc, bdst_c), num_keys=2)
    dup = jnp.concatenate([
        jnp.zeros(1, bool), (s1[1:] == s1[:-1]) & (d1[1:] == d1[:-1])])
    s1 = jnp.where(dup, SENT, s1)
    # random within-group order, then rank -> capped scatter
    tie = jax.random.bits(k2, (2 * E,), jnp.uint32)
    s2, _, d2 = jax.lax.sort((s1, tie, d1), num_keys=2)
    starts = jnp.searchsorted(s2, jnp.arange(n_real + 1, dtype=jnp.int32))
    rank = jnp.arange(2 * E, dtype=jnp.int32) - starts[jnp.minimum(s2, SENT)]
    slot = jnp.where((rank < cap) & (s2 < n_real), rank, cap)
    conn = jnp.full((npad, cap + 1), -1, jnp.int32).at[
        jnp.minimum(s2, npad - 1), slot].set(d2, mode="drop")[:, :cap]
    sizes = jnp.diff(starts)                              # (n_real,)
    counts = jnp.zeros(npad, jnp.int32).at[:n_real].set(
        jnp.minimum(sizes, cap).astype(jnp.int32))
    return conn, counts


@functools.partial(jax.jit, static_argnames=("m", "block", "keep"))
def _prune_or_keep_device(vectors, conn, counts, *, m: int, block: int,
                          keep: int = 0):
    """Over-degree vertices get robust-pruned down to m; vertices with <= m
    connections keep their full list (build_graph.go:453-455 keeps
    under-degree lists untouched). Mega-hub pools are first narrowed to the
    4m NEAREST of their (random-capped) list — the greedy alpha-accept for
    m slots virtually never reaches past the ~4m closest, and the nearest
    bias measurably helps hub edge quality. -> (npad, m) i32, -1 padded."""
    npad, cap = conn.shape
    nblocks = npad // block
    sqn = jnp.sum(vectors * vectors, axis=1)
    ncap = min(cap, 4 * m)

    def body(carry, b):
        ids = b * block + jnp.arange(block, dtype=jnp.int32)
        cnd = jax.lax.dynamic_slice(conn, (b * block, 0), (block, cap))
        cnt = jax.lax.dynamic_slice(counts, (b * block,), (block,))
        q = jax.lax.dynamic_slice(
            vectors, (b * block, 0), (block, vectors.shape[1]))
        if ncap < cap:
            csel = jnp.where(cnd >= 0, cnd, ids[:, None])  # self = masked
            nar, nar_d = _select_topk_sorted(vectors, sqn, q, ids, csel,
                                             ncap)
            valid = jnp.isfinite(nar_d)
        else:
            nar = cnd
            valid = cnd >= 0
        pruned, _cnt2 = _robust_prune_batch(
            vectors, ids, jnp.maximum(nar, 0), valid, m, keep=keep)
        out = jnp.where((cnt <= m)[:, None], cnd[:, :m], pruned)
        return carry, out

    _, out = jax.lax.scan(body, None, jnp.arange(nblocks, dtype=jnp.int32))
    return out.reshape(npad, m)


@functools.partial(jax.jit, static_argnames=("n_real", "m", "cap", "block",
                                             "keep"))
def _degree_reg_device(vectors, pruned, key, *, n_real: int, m: int,
                       cap: int, block: int, keep: int):
    """Degree regularization + random fill as ONE program: the three
    phases run back-to-back with no host decision between them."""
    kr, kf = jax.random.split(key)
    conn, counts = _conn_lists_device(pruned, kr, n_real=n_real, m=m,
                                      cap=cap)
    out = _prune_or_keep_device(vectors, conn, counts, m=m, block=block,
                                keep=keep)
    return _random_fill_device(out, kf, m=m, block=block, n_real=n_real)


@functools.partial(jax.jit, static_argnames=("m", "block", "keep"))
def _prune_device(vectors, wide_ids, wide_d, *, m: int, block: int,
                  keep: int = 0):
    """Robust alpha-prune of the widened pools, scanned over vertex blocks
    on device -> (npad, m) i32 (-1 padded)."""
    npad = wide_ids.shape[0]
    nblocks = npad // block

    def body(carry, b):
        ids = b * block + jnp.arange(block, dtype=jnp.int32)
        cand = jax.lax.dynamic_slice(
            wide_ids, (b * block, 0), (block, wide_ids.shape[1]))
        dists = jax.lax.dynamic_slice(
            wide_d, (b * block, 0), (block, wide_d.shape[1]))
        valid = jnp.isfinite(dists)
        out, _cnt = _robust_prune_batch(
            vectors, ids, jnp.maximum(cand, 0), valid, m, keep=keep)
        return carry, out

    _, out = jax.lax.scan(body, None, jnp.arange(nblocks, dtype=jnp.int32))
    return out.reshape(npad, m)


# ---------------------------------------------------------------------------
# vectorized robust prune


@functools.partial(jax.jit, static_argnames=("m", "keep"))
def _robust_prune_batch(vectors, u_ids, cand_ids, cand_valid, m, keep=0):
    """Greedy alpha-accept per vertex (build_graph.go:156-223), vectorized.

    cand_ids: (B, C) candidate ids (padded); cand_valid: (B, C) mask.
    Returns (B, m) accepted ids, -1 padded, plus accept count.

    keep: the nearest `keep` DISTINCT candidates are accepted
    unconditionally (alpha applies only to the remaining slots). The pure
    alpha rule evicts near-duplicate directions, which on dense manifolds
    are exactly a vertex's true nearest neighbors — and the beam's final
    top-k can only see vertices that are out-neighbors of an expanded
    vertex, so evicted locals cap recall@k even when navigation is perfect
    (measured at 262k continuum: recall@1 1.00, recall@10 0.905 with
    keep=0). Reserving k-ish nearest slots restores the harvest while the
    remaining m-keep slots keep the alpha-diverse highways.
    """
    B, C = cand_ids.shape
    q = vectors[u_ids]                                   # (B, d)
    cv = vectors[cand_ids]                               # (B, C, d)
    d_u = jnp.sum((cv - q[:, None, :]) ** 2, axis=-1)    # dist to u
    d_u = jnp.where(cand_valid, d_u, jnp.inf)
    order = jnp.argsort(d_u, axis=1)                     # ascending
    cand_sorted = jnp.take_along_axis(cand_ids, order, axis=1)
    du_sorted = jnp.take_along_axis(d_u, order, axis=1)
    cv_sorted = jnp.take_along_axis(cv, order[:, :, None], axis=1)
    # pairwise distances among candidates via the dot identity —
    # materializing the (B, C, C, d) difference tensor OOMs at scale
    sq = jnp.sum(cv_sorted * cv_sorted, axis=-1)         # (B, C)
    cross = jnp.einsum("bcd,bed->bce", cv_sorted, cv_sorted, precision=_PREC,
                       preferred_element_type=jnp.float32)
    pd = jnp.maximum(sq[:, :, None] + sq[:, None, :] - 2.0 * cross, 0.0)
    if keep:
        # duplicate ids (pool sections overlap) must not consume reserved
        # slots: without alpha, a repeat of an accepted id is no longer
        # auto-blocked (pd=0 < du), so mask non-first occurrences explicitly
        eq = cand_sorted[:, :, None] == cand_sorted[:, None, :]
        dup = jnp.any(eq & jnp.tril(jnp.ones((C, C), bool), k=-1)[None],
                      axis=2)                            # (B, C)
    else:
        dup = jnp.zeros((B, C), bool)

    def body(i, carry):
        accepted, n_acc = carry                          # (B, C) bool, (B,)
        pd_i = jnp.take(pd, i, axis=2)                   # (B, C)
        du_i = jnp.take(du_sorted, i, axis=1)            # (B,)
        # blocked if any accepted w has alpha*d(w, v_i) < d(u, v_i)
        blocked = jnp.any(accepted & (ALPHA * pd_i < du_i[:, None]), axis=1)
        blocked = jnp.where(n_acc < keep, False, blocked) \
            | jnp.take(dup, i, axis=1)
        ok = (~blocked) & (n_acc < m) & jnp.isfinite(du_i)
        accepted = accepted.at[:, i].set(ok)
        return accepted, n_acc + ok.astype(jnp.int32)

    accepted, n_acc = jax.lax.fori_loop(
        0, C, body, (jnp.zeros((B, C), bool), jnp.zeros(B, jnp.int32))
    )

    # backfill from discarded, in distance order (build_graph.go:199-213)
    discarded = (~accepted) & jnp.isfinite(du_sorted)
    need = m - n_acc
    disc_rank = jnp.cumsum(discarded, axis=1) - 1         # rank among discarded
    take_disc = discarded & (disc_rank < need[:, None])
    final = accepted | take_disc

    # compact accepted-first ordering: accepted in distance order, then backfill
    key = jnp.where(accepted, 0, jnp.where(take_disc, 1, 2)) * C \
        + jnp.arange(C)[None, :]
    sel = jnp.argsort(jnp.where(final, key, 3 * C + jnp.arange(C)[None, :]),
                      axis=1)[:, :m]
    out = jnp.take_along_axis(cand_sorted, sel, axis=1)
    cnt = jnp.sum(final, axis=1)
    out = jnp.where(jnp.arange(m)[None, :] < cnt[:, None], out, -1)
    return out, cnt


# ---------------------------------------------------------------------------
# full pipeline


def build_graph(vectors: np.ndarray, m: int, *, rounds: int = 6,
                seed: int = 0, block: int = 2048,
                verbose: bool = False,
                quality_gate: bool | None = None,
                keep_nearest: int = 16,
                corridor_step: int = 16, corridor_par: int = 2,
                corridor_passes: int = 1,
                precompile: bool | None = None) -> np.ndarray:
    """vectors (n, d) float32 -> graph (n, m) int32.

    Phases 1-3 run as whole-phase device programs (adjacency resident in
    device memory, one dispatch per round); only the random-fill mop-up
    of straggler rows is host NumPy.

    quality_gate: run the post-build self-query probe and print hit rate /
    average steps, the reference's EvaluateGraphQuality call inside
    BuildGraph (build_graph.go:102,764-805). Defaults to `verbose` (every
    script build runs it; silent unit-test builds skip the extra searches).

    keep_nearest: reserved nearest-neighbor slots per vertex in the final
    prunes (see _robust_prune_batch) — the recall@k harvest edges.

    corridor_step/corridor_par: beam budget of the phase-2b self-search
    pass (search_paths_all) whose expansion corridor becomes the
    navigation-highway candidates — the in-house stand-in for NGT's
    per-vertex candidate search (build_graph.go:384). A larger budget
    yields longer approach corridors (more, and more diverse, highway
    candidates per vertex) at build time only; query-time cost is
    unchanged. Sweepable via scripts/e2e_scale.py --corridor.

    corridor_passes: run the corridor search this many times, each pass
    seeded from a DISJOINT random subset of the sqrt(n) start set, and
    concatenate the corridors (total width passes*step*par): corridor
    diversity without a bigger per-query visited table.

    precompile: compile every phase program ahead of time in a thread pool
    while earlier phases run (all shapes are known up front), so the cold
    compile bill shrinks toward the heaviest single program. Default: on
    for the "gpu" backend, where it measured 21 s against 51 s for a cold
    100k build (PERF.md). A failed compile or call raises; nothing falls
    back to a second call (phases donate buffers).
    """
    t_start = time.perf_counter()

    def _el():
        # elapsed + live/peak device memory where the backend reports it:
        # the per-phase prints double as the build's memory profile
        el = f"[{time.perf_counter() - t_start:.1f}s"
        ms = jax.local_devices()[0].memory_stats() or {}
        if "bytes_in_use" in ms:
            el += (f" mem {ms['bytes_in_use']/2**30:.1f}"
                   f"/{ms['peak_bytes_in_use']/2**30:.1f}G")
        return el + "]"

    rng = np.random.default_rng(seed)
    on_device = isinstance(vectors, jax.Array) and not isinstance(
        vectors, np.ndarray)
    if not on_device:
        vectors = _compact_host(vectors)
    n, d = vectors.shape
    blk = min(block, n)
    npad = -(-n // blk) * blk

    from pacmann.graph.beam import search_paths_all

    n_far = max(8, m // 2)
    cand_local = int(1.5 * m) + m - n_far
    K = max(16, min(4096, n // 256))
    Lad = max(2, min(12, int(np.log2(max(K - 1, 4)))))
    n_starts = min(n, int(np.sqrt(n)))
    cap = max(8 * m, 256)
    # corridor-phase block: the vmapped beam search carries a
    # cap-proportional visited table per query, so the block shrinks as
    # the corridor budget grows to hold the per-block state roughly
    # constant (kept from the first device; ROADMAP asks whether the H100
    # needs it)
    corr_cap = corridor_par + corridor_step * corridor_par * m
    blk_paths = min(blk, 1024 if corr_cap <= 1150
                    else 512 if corr_cap <= 2400 else 256)
    # builds past 2M vertices run the wide round as separate slice
    # programs (_wide_round_sliced); 1 keeps the <= 2M one-program form
    wparts = 1 if npad <= 2_000_000 else 8
    ns_pass = max(1, n_starts // corridor_passes)

    if precompile is None:
        from pacmann.utils.platform import backend

        precompile = backend() == "gpu"
    futs, pool = {}, None
    if precompile:
        import concurrent.futures

        f32, i32 = jnp.float32, jnp.int32
        sds = jax.ShapeDtypeStruct
        _k0 = jax.random.PRNGKey(0)
        vec_s = sds((npad, d), f32)
        sqn_s = sds((npad,), f32)
        key_s = sds(_k0.shape, _k0.dtype)
        graph_s = sds((npad, m), i32)
        km_kw = dict(K=K, m=m, iters=2, block=blk, n_real=n)
        wide_kw = dict(nsn=2, n_random=16, block=blk, n_real=n,
                       out_m=cand_local, wide=True)
        paths_kw = dict(n=n, m=m, max_step=corridor_step,
                        parallel=corridor_par, block=blk_paths)
        km_s = jax.eval_shape(
            functools.partial(_kmeans_bootstrap, **km_kw), vec_s, key_s)
        wide_s = jax.eval_shape(
            functools.partial(_nn_round_device, **wide_kw),
            vec_s, sqn_s, graph_s, key_s)
        lad_s = jax.eval_shape(
            functools.partial(_ladder_candidates, L=Lad), *km_s[1:], key_s)
        paths_s = jax.eval_shape(
            functools.partial(search_paths_all, **paths_kw),
            vec_s, graph_s, sds((ns_pass,), i32), key_s)
        dd = wide_s[1].dtype
        C2 = (wide_s[0].shape[1] + lad_s.shape[1] + n_far
              + paths_s.shape[1] * corridor_passes)
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=6)

        def _sub(name, fn, args, statics):
            futs[name] = pool.submit(
                lambda: fn.lower(*args, **statics).compile())

        _sub("kmeans", _kmeans_bootstrap, (vec_s, key_s), km_kw)
        _sub("descent", _nn_round_device, (vec_s, sqn_s, graph_s, key_s),
             dict(wide_kw, n_random=8, out_m=m, wide=False))
        if wparts > 1:
            _sub("wide_slice", _wide_slice_round,
                 (vec_s, sqn_s, graph_s, key_s, sds((), i32)),
                 dict(per=-(-m // wparts), n_random=16, block=blk,
                      n_real=n, out_m=cand_local))
            wi_s = sds((npad, cand_local), i32)
            wd_s = sds((npad, cand_local), dd)
            _sub("wide_merge", _merge_topk_blocked, (wi_s, wd_s, wi_s, wd_s),
                 dict(out_m=cand_local, block=blk))
        else:
            _sub("wide", _nn_round_device, (vec_s, sqn_s, graph_s, key_s),
                 wide_kw)
        _sub("ladder", _ladder_candidates, (*km_s[1:], key_s), dict(L=Lad))
        _sub("paths", search_paths_all,
             (vec_s, graph_s, sds((ns_pass,), i32), key_s), paths_kw)
        _sub("prune", _prune_device,
             (vec_s, sds((npad, C2), i32), sds((npad, C2), dd)),
             dict(m=m, block=blk, keep=keep_nearest))
        _sub("degreg", _degree_reg_device, (vec_s, graph_s, key_s),
             dict(n_real=n, m=m, cap=cap, block=blk, keep=keep_nearest))

    def _run(name, fn, *args, **statics):
        """The phase's AOT-compiled program when the pool built it, the
        jitted call otherwise. Compile and call failures raise."""
        if name in futs:
            return futs[name].result()(*args)
        return fn(*args, **statics)

    if on_device:
        # device-resident input (e.g. device-synthesized demo data): pad
        # on device, never round-trip the big array through the host
        vectors_dev = vectors.astype(jnp.float32)
        if npad != n:
            vectors_dev = jnp.concatenate(
                [vectors_dev,
                 jnp.broadcast_to(vectors_dev[:1], (npad - n, d))])
    else:
        vpad = vectors if npad == n else np.concatenate(
            [vectors, np.tile(vectors[:1], (npad - n, 1))])
        # narrow host dtypes (u8 bvecs, f16/bf16) cross the link as-is and
        # widen on device — see _compact_host
        vectors_dev = jnp.asarray(vpad).astype(jnp.float32)
    sqn = jnp.sum(vectors_dev * vectors_dev, axis=1)
    if verbose:
        vectors_dev.block_until_ready()
        print(f"vectors on device {_el()}", flush=True)

    # phase 1: NN-descent from a locality-seeded (k-means cell) graph,
    # fully device-resident
    key = jax.random.PRNGKey(seed)
    key, kb = jax.random.split(key)
    graph_dev, labels, cent, ids_s, cstarts, csizes = _run(
        "kmeans", _kmeans_bootstrap, vectors_dev, kb,
        K=K, m=m, iters=2, block=blk, n_real=n)
    if verbose:
        graph_dev.block_until_ready()
        print(f"kmeans bootstrap done (K={K}) {_el()}", flush=True)
    for r in range(rounds):
        key, sub = jax.random.split(key)
        graph_dev, rdist = _run(
            "descent", _nn_round_device, vectors_dev, sqn, graph_dev, sub,
            nsn=2, n_random=8, block=blk, n_real=n, out_m=m, wide=False)
        if verbose:
            # convergence probe: mean top-m distance over the real vertices
            md = float(jnp.mean(jnp.where(jnp.isfinite(rdist[:n]),
                                          rdist[:n], 0.0)))
            print(f"nn-descent round {r} done (mean top-{m} dist {md:.4f})"
                  f" {_el()}", flush=True)
    rdist = None  # 0.5 GB at 4M; only the verbose probe reads it

    # phase 2: candidate pool = widened final round + robust prune, on device.
    # The wide pool keeps the cand_size NEAREST candidates — on converged
    # graphs that is purely local, and a purely local graph is unnavigable
    # (beam search cannot route between well-separated clusters; measured
    # recall DROPS as NN-descent converges). So the prune pool = nearest
    # locals ‖ far random candidates appended UNFILTERED: the alpha-prune
    # accepts far candidates exactly when local slots run dry (a far v is
    # only blocked by accepted points near v), which is how DiskANN keeps
    # its highway edges.
    key, sub, sub2, sub3, sub4 = jax.random.split(key, 5)
    if wparts > 1:
        wide_ids, wide_d = _wide_round_sliced(
            vectors_dev, sqn, graph_dev, sub, n_random=16, block=blk,
            n_real=n, out_m=cand_local, parts=wparts, run=_run,
            verbose=verbose, el=_el)
    else:
        wide_ids, wide_d = _run(
            "wide", _nn_round_device, vectors_dev, sqn, graph_dev, sub,
            nsn=2, n_random=16, block=blk, n_real=n, out_m=cand_local,
            wide=True)
    if verbose:
        wide_d.block_until_ready()
        print(f"wide round done {_el()}", flush=True)
    far = jax.random.randint(sub2, (npad, n_far), 0, n, jnp.int32)
    far = jnp.where(far == jnp.arange(npad)[:, None], (far + 1) % n, far)
    # dist values below are only validity markers for the prune (it
    # recomputes true distances); far candidates are always valid
    far_d = jnp.zeros((npad, n_far), wide_d.dtype)

    # distance-stratified long-range candidates from the bootstrap cells
    key, sub5 = jax.random.split(key)
    ladder = _run("ladder", _ladder_candidates,
                  labels, cent, ids_s, cstarts, csizes, sub5, L=Lad)
    ladder_d = jnp.where(ladder != jnp.arange(npad)[:, None],
                         jnp.zeros((), wide_d.dtype), jnp.inf)
    if verbose:
        ladder.block_until_ready()
        print(f"ladder done {_el()}", flush=True)

    # 2a. temporary NAVIGABLE graph: alpha-prune of locals + far randoms +
    # the ladder (the alpha rule keeps far edges when local slots run dry).
    # The pool is padded with invalid (inf-distance) columns to the FINAL
    # pool's width so one compiled prune program serves both calls, output
    # unchanged (inf candidates sort last and are never accepted).
    # total corridor width across passes (search_paths_all width below)
    paths_w = corridor_step * corridor_par * corridor_passes
    pad_i = jnp.zeros((npad, paths_w), jnp.int32)
    pad_d = jnp.full((npad, paths_w), jnp.inf, wide_d.dtype)
    nav = _run(
        "prune", _prune_device, vectors_dev, jnp.concatenate([wide_ids, pad_i, ladder, far], axis=1),
        jnp.concatenate([wide_d, pad_d, ladder_d, far_d], axis=1),
        m=m, block=blk, keep=keep_nearest)
    nav_fill = jax.random.randint(sub3, nav.shape, 0, n, jnp.int32)
    nav_fill = jnp.where(nav_fill == jnp.arange(npad)[:, None],
                         (nav_fill + 1) % n, nav_fill)
    nav = jnp.where(nav < 0, nav_fill, nav)
    if verbose:
        nav.block_until_ready()
        print(f"nav graph done {_el()}", flush=True)

    # 2b. search-based candidates (the NGT/Vamana mechanism, SURVEY §7
    # step 4): beam-search every vertex's own vector over the nav graph and
    # keep the expansion corridor — connecting a vertex to its approach
    # path is what creates durable navigation highways
    starts = jnp.asarray(
        rng.choice(n, n_starts, replace=False), jnp.int32)
    # one corridor search per pass, each seeded from a disjoint random
    # start subset (the choice above is unordered, so contiguous slices
    # are random subsets); different seeds -> genuinely different
    # approach paths. All passes share ONE compiled program.
    paths = jnp.concatenate([
        _run("paths", search_paths_all, vectors_dev, nav,
             starts[i * ns_pass:(i + 1) * ns_pass],
             jax.random.fold_in(sub4, i),
             n=n, m=m, max_step=corridor_step, parallel=corridor_par,
             block=blk_paths)
        for i in range(corridor_passes)], axis=1)
    path_d = jnp.where(
        (paths >= 0) & (paths != jnp.arange(npad)[:, None]),
        jnp.zeros((), wide_d.dtype), jnp.inf)
    if verbose:
        paths.block_until_ready()
        print(f"path candidates done {_el()}", flush=True)

    # 2c. final pool = locals ‖ corridors ‖ ladder ‖ far -> alpha-prune
    pool_ids = jnp.concatenate([wide_ids, paths, ladder, far], axis=1)
    pool_d = jnp.concatenate([wide_d, path_d, ladder_d, far_d], axis=1)
    pruned_dev = _run("prune", _prune_device, vectors_dev, pool_ids, pool_d,
                      m=m, block=blk, keep=keep_nearest)
    if verbose:
        pruned_dev.block_until_ready()
        print(f"widen+prune done {_el()}", flush=True)

    # phase 3: reference degree regularization (build_graph.go:414-484),
    # edge pipeline + over-degree prune on device, random fill on host
    key, kr = jax.random.split(key)
    out_dev = _run("degreg", _degree_reg_device, vectors_dev, pruned_dev, kr,
                   n_real=n, m=m, cap=cap, block=blk, keep=keep_nearest)
    out = np.asarray(out_dev[:n]).astype(np.int64)
    if pool is not None:
        pool.shutdown()
    if verbose:
        print(f"degree regularization + fill done {_el()}", flush=True)
    graph = _random_fill(out, m, rng, verbose)  # host mop-up of stragglers
    graph = graph.astype(np.int32)
    if quality_gate is None:
        quality_gate = verbose
    if quality_gate:
        from pacmann.graph.recall import evaluate_graph_quality

        # the padded f32 copy is already on device — never re-upload the DB
        # (nor host-convert a compact u8/f16 input) just for the gate probe
        hit_rate, avg_steps = evaluate_graph_quality(
            vectors_dev[:n], graph, num_queries=min(100, n), seed=seed)
        print(f"graph quality gate: self-query hit rate {hit_rate:.3f}, "
              f"avg steps {avg_steps:.1f}", flush=True)
    return graph


@functools.partial(jax.jit, static_argnames=("K", "block", "n_real"))
def _lloyd_iter(vectors, cent, *, K: int, block: int, n_real: int):
    """One Lloyd iteration (assign + matmul update) as its own small
    program (one compile serves every iteration)."""
    npad, d = vectors.shape
    nblocks = npad // block

    def body(carry, b):
        q = jax.lax.dynamic_slice(vectors, (b * block, 0), (block, d))
        dots = jnp.dot(q, cent.T, precision=_PREC)
        cn = jnp.sum(cent * cent, axis=1)
        lab = jnp.argmin(cn[None, :] - 2.0 * dots, axis=1)
        return carry, lab.astype(jnp.int32)

    _, labs = jax.lax.scan(body, None, jnp.arange(nblocks, dtype=jnp.int32))
    labels = labs.reshape(npad)
    sums, cnts = _lloyd_sums(vectors, labels, K=K, block=block,
                             n_real=n_real)
    return jnp.where(cnts[:, None] > 0,
                     sums / jnp.maximum(cnts, 1.0)[:, None], cent)


@functools.partial(jax.jit, static_argnames=("block", "n_real"))
def _nearest_vertex_device(vectors, cent, *, block: int, n_real: int):
    """Nearest REAL vertex id per centroid: blocked running argmin."""
    npad, d = vectors.shape
    nblocks = npad // block
    K = cent.shape[0]

    def near_body(carry, b):
        best_d, best_i = carry
        q = jax.lax.dynamic_slice(vectors, (b * block, 0), (block, d))
        ids = b * block + jnp.arange(block, dtype=jnp.int32)
        qn = jnp.sum(q * q, axis=1)
        # cent-norm term omitted: constant per column, argmin-invariant
        dist = qn[:, None] - 2.0 * jnp.dot(q, cent.T, precision=_PREC)
        dist = jnp.where((ids < n_real)[:, None], dist, jnp.inf)
        bi = jnp.argmin(dist, axis=0)                    # (K,)
        bd = jnp.take_along_axis(dist, bi[None, :], axis=0)[0]
        take = bd < best_d
        return (jnp.where(take, bd, best_d),
                jnp.where(take, ids[bi], best_i)), None

    (_, bi), _ = jax.lax.scan(
        near_body,
        (jnp.full((K,), jnp.inf), jnp.zeros((K,), jnp.int32)),
        jnp.arange(nblocks, dtype=jnp.int32))
    return bi


def choose_start_ids(vectors: np.ndarray, n_starts: int, *,
                     iters: int = 3, seed: int = 0,
                     block: int = 4096) -> np.ndarray:
    """Coverage-optimized beam-search start vertices: k-means centroids'
    nearest real vertices, computed on device (a few Lloyd passes).

    The reference starts every search from the first sqrt(n) vertex ids
    (search.go:51-65) — effectively random coverage, so a query's nearest
    start can be far away and the beam burns steps descending before it
    can harvest neighbors. Centroid starts cut the descent depth (the
    start set is part of the index, not the query protocol: same count,
    same per-query cost, no privacy change — start vectors are client-held
    in the private path either way)."""
    n = vectors.shape[0]
    n_starts = min(n_starts, n)
    blk = min(block, n)
    npad = -(-n // blk) * blk
    if isinstance(vectors, np.ndarray):
        vectors = _compact_host(vectors)
        vpad = vectors if npad == n else np.concatenate(
            [vectors, np.tile(vectors[:1], (npad - n, 1))])
        v_dev = jnp.asarray(vpad).astype(jnp.float32)
    else:  # device-resident: pad without a host round trip
        v_dev = vectors.astype(jnp.float32)
        if npad != n:
            v_dev = jnp.concatenate(
                [v_dev, jnp.broadcast_to(v_dev[:1], (npad - n,
                                                     v_dev.shape[1]))])
    key = jax.random.PRNGKey(seed)
    cent = v_dev[jax.random.randint(key, (n_starts,), 0, n, jnp.int32)]
    for _ in range(iters):
        cent = _lloyd_iter(v_dev, cent, K=n_starts, block=blk, n_real=n)
    ids = np.asarray(
        _nearest_vertex_device(v_dev, cent, block=blk, n_real=n))
    # several centroids can resolve to the same nearest vertex; duplicate
    # starts waste seed slots and shrink coverage (the reference draws
    # DISTINCT random ids, private-search.go:505-528) — top up with random
    # distinct ids
    uniq = np.unique(ids)
    if uniq.size < n_starts:
        rng = np.random.default_rng(seed)
        pool = rng.permutation(n)
        extra = pool[~np.isin(pool, uniq, assume_unique=False)]
        ids = np.concatenate([uniq, extra[: n_starts - uniq.size]])
    return ids.astype(np.int64)


@functools.partial(jax.jit, static_argnames=("m", "block", "n_real"))
def _random_fill_device(out, key, *, m: int, block: int, n_real: int):
    """Device twin of the host _random_fill loop: resample -1 slots with
    uniform ids, kill self edges and within-row duplicates (blocked
    (B, m, m) pairwise equality — no sorts, no scatters), iterate, as one
    device program. Rows still deficient after 8 rounds (p ~ (m/n)^8) fall back
    to the host mop-up in _random_fill."""
    npad = out.shape[0]
    nblocks = npad // block
    tril = jnp.tril(jnp.ones((m, m), bool), k=-1)

    def body(carry, b):
        sub = jax.lax.dynamic_slice(out, (b * block, 0), (block, m))
        ids = b * block + jnp.arange(block, dtype=jnp.int32)

        def one(i, sub):
            k = jax.random.fold_in(jax.random.fold_in(key, b), i)
            fill = jax.random.randint(k, sub.shape, 0, n_real, jnp.int32)
            sub = jnp.where(sub < 0, fill, sub)
            sub = jnp.where(sub == ids[:, None], -1, sub)
            eq = (sub[:, :, None] == sub[:, None, :]) & (sub >= 0)[:, :, None]
            dup = jnp.any(eq & tril[None], axis=2)       # later occurrence
            return jnp.where(dup, -1, sub)

        return carry, jax.lax.fori_loop(0, 8, one, sub)

    _, filled = jax.lax.scan(body, None, jnp.arange(nblocks, dtype=jnp.int32))
    return filled.reshape(npad, m)


def _random_fill(out: "np.ndarray", m: int, rng,
                 verbose: bool = False) -> "np.ndarray":
    """Random-fill every under-degree row to exactly m distinct non-self
    edges (build_graph.go:457-475). Host NumPy: the deficit set is tiny."""
    n = out.shape[0]
    # random fill to exactly m (build_graph.go:457-475), vectorized:
    # resample empty slots, invalidate self/duplicates, retry (converges in
    # a couple of rounds when n >> m); a scalar fallback mops up stragglers
    need_rows = np.flatnonzero((out >= 0).sum(1) < m)
    if len(need_rows):
        sub = out[need_rows].copy()
        ids_col = need_rows[:, None]
        for _ in range(16):
            miss = sub < 0
            if not miss.any():
                break
            sub[miss] = rng.integers(0, n, size=int(miss.sum()))
            sub[sub == ids_col] = -1
            ordv = np.argsort(sub, axis=1, kind="stable")
            sv = np.take_along_axis(sub, ordv, axis=1)
            dup_s = np.zeros_like(sv, bool)
            dup_s[:, 1:] = (sv[:, 1:] == sv[:, :-1]) & (sv[:, 1:] >= 0)
            dup = np.zeros_like(dup_s)
            np.put_along_axis(dup, ordv, dup_s, axis=1)
            sub[dup] = -1
        out[need_rows] = sub
    for u in np.flatnonzero((out >= 0).sum(1) < m):  # rare stragglers
        have = set(int(x) for x in out[u] if x >= 0)
        while len(have) < m:
            v = int(rng.integers(0, n))
            if v != u:
                have.add(v)
        out[u] = sorted(have)[:m] if len(have) == m else list(have)[:m]

    if verbose:
        inb = np.bincount(out.reshape(-1), minlength=n)
        print(f"Min inbound: {inb.min()}, Max inbound: {inb.max()}")
    return out
