"""Fully-fused private search: beam traversal + PianoPIR online protocol as
ONE device program per query-group segment.

The host-orchestrated path (driver.py + DevicePianoEngine) still pays one
device dispatch per beam step (20+ round trips per query — dominant over any
real client/server link). Here the ENTIRE search runs inside a single jit:

  for step in seg_base..seg_base+seg_len (lax.scan):
    1. frontier pop: `parallel` best unexplored vertices per query
       (masked extract-min via top_k — the heap's extract-min,
       graphann/search.go:150-171)
    2. dedup (the reference's response-cache semantics,
       pianopir/pir.go:381-383): an id already in its query's visited
       table (fetched by an EARLIER step) is never re-fetched, and only
       the FIRST same-step occurrence of an id is routed to PIR;
       duplicates read the first's response. Neither spends quota or
       budget — their PIR rows become dummies (random offsets), which
       are indistinguishable to the server, so the access pattern stays
       oblivious while the budget window stretches
    3. oblivious fetch routing: the surviving neighbor ids are ranked
       within their batch-PIR partitions (one-hot cumsum); the first
       `quota` per partition become sub-queries, overflow is dropped to
       zeros — the reference's FCFS lossy contract (batch-pir.go:194-216)
       as a fixed-shape collision-free scatter
    4. PIR: `_pir_batch` serves quota sub-queries per partition (hit scan
       -> expansion -> server XOR scan -> unmask -> hint refresh), exactly
       the sequential protocol per partition
    5. entries decode to (vector ‖ neighbors) and update the visited table
       (dedup, all-zero-neighbor skip: search.go:187-207)

Concurrent queries share each step's PIR batch, so the per-partition quota
grows with the group size and the drop rate falls. Groups whose sub-query
need exceeds the per-partition budget are split into SEGMENTS with a hint
refresh between them — the reference's refresh-on-exhaustion semantics
(pir.go:525-533) lifted to the group level, which is what unlocks group
sizes past the single-budget ceiling (group 16 at SIFT1M). The FIRST
segment is sized to the budget left over from earlier searches (partial
windows are drained, never discarded), which pins amortized maintenance to
the protocol floor refresh_time * consumed/budget; the segment program has
a fixed physical length with traced base/n_steps, so one compile serves
every segment. Beam state stays on device across segments; answers = top-k
of each query's visited table. Only (Qn, k) ids leave the device.
"""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from pacmann.pir.device_engine import DevicePianoEngine, _pir_batch
from pacmann.pir.params import DEFAULT_PROGRAM_POINT

NEG_ID = jnp.int32(-1)
INF = jnp.float32(np.inf)


def _pop_parallel_batch(dist, explored, parallel):
    """(Qn, cap) -> slots (Qn, parallel), valid (Qn, parallel).

    One top_k per query group replaces a sequential argmin/mask loop (same
    extract-min semantics: top_k breaks ties by lowest index, exactly like
    repeated argmin)."""
    masked = jnp.where(explored, INF, dist)
    neg, idx = jax.lax.top_k(-masked, parallel)
    return idx.astype(jnp.int32), neg > -INF


def _first_occurrence(ids):
    B = ids.shape[0]
    eq = ids[:, None] == ids[None, :]
    lower = jnp.tril(jnp.ones((B, B), bool), k=-1)
    return ~jnp.any(eq & lower, axis=1)


@functools.partial(
    jax.jit, static_argnames=("parallel", "cap", "m"))
def _seed_beam(queries, start_ids, start_vecs, start_nbrs, *,
               parallel, cap, m):
    """Seed the visited tables from the start set (search.go:129-148)."""
    Qn = queries.shape[0]
    sdist = jnp.sum(
        (start_vecs[None, :, :] - queries[:, None, :]) ** 2, axis=-1)
    negd, sidx = jax.lax.top_k(-sdist, parallel)        # (Qn, parallel)
    ids = jnp.full((Qn, cap), NEG_ID)
    dist = jnp.full((Qn, cap), INF)
    nbrs = jnp.zeros((Qn, cap, m), jnp.int32)
    explored = jnp.ones((Qn, cap), bool)
    sl = jnp.arange(parallel)
    ids = ids.at[:, sl].set(start_ids[sidx].astype(jnp.int32))
    dist = dist.at[:, sl].set(-negd)
    nbrs = nbrs.at[:, sl].set(start_nbrs[sidx].astype(jnp.int32))
    explored = explored.at[:, sl].set(False)
    return ids, dist, nbrs, explored


@functools.partial(
    jax.jit, static_argnames=("Qn", "parallel", "m", "n", "quota", "P",
                              "S", "C"))
def _draw_step_randoms(keys, *, Qn, parallel, m, n, quota, P, S, C):
    """Pre-draw every step's PRNG values in ONE vectorized program.

    The per-step threefry graphs (split + randint + bits) are ~200
    StableHLO ops each; executed inside the scan body they add to the fixed
    per-step op count. One batched draw over all max_step keys costs a
    single wide kernel instead. vmap(split/randint/bits) over stacked
    keys is bit-identical to the former per-step calls (asserted by the
    fused-vs-host-twin and split-route identity tests).

    Returns (rand_ids_all (T, Qn, parallel, m) i32 — random padding for
    invalid pops — and rnd_all (T, quota, P, S) u32 — oblivious dummy
    offsets)."""
    ks = jax.vmap(jax.random.split)(keys)            # (T, 2, 2)
    rand_ids_all = jax.vmap(
        lambda k: jax.random.randint(
            k, (Qn, parallel, m), 0, n, dtype=jnp.int32))(ks[:, 0])
    rnd_all = jax.vmap(
        lambda k: jax.random.bits(
            k, (quota, P, S), jnp.uint32) % np.uint32(C))(ks[:, 1])
    return rand_ids_all, rnd_all


def _route_core(ids, dist, nbrs, explored, queries, rand_ids, rnd,
                *, psize, C, S, m, P, parallel, quota, n):
    """Steps 1-3 of a beam+PIR step: frontier pop, dedup, FCFS routing.

    Pure function shared VERBATIM by the one-program scan (_fused_segment)
    and the big-tier chained-programs route (_route_step) — bit-identity of
    the two routes follows from sharing this trace. rand_ids (Qn,
    parallel, m) i32 and rnd (quota, P, S) u32 are this step's pre-drawn
    PRNG values (see _draw_step_randoms). Returns the updated
    `explored` plus everything later phases need:
    (explored, fid (F,), known (Qn, parallel*m), is_first, keep, slot,
     fo_idx, has_first (F,), idx_q (quota, P), rnd (quota, P, S))."""
    Qn = queries.shape[0]
    F = Qn * parallel * m               # fetches per step
    cap = ids.shape[1]

    # 1. frontier pop
    slots, valid = _pop_parallel_batch(dist, explored, parallel)
    pop_hit = (jnp.arange(cap, dtype=jnp.int32)[None, None, :]
               == slots[:, :, None]) & valid[:, :, None]
    explored = explored | jnp.any(pop_hit, axis=1)
    popped = jnp.take_along_axis(
        nbrs, slots[:, :, None], axis=1)            # (Qn, parallel, m)
    fid = jnp.where(valid[:, :, None], popped, rand_ids).reshape(F)
    fid = jnp.clip(fid, 0, n - 1)

    # 2. dedup (reference cache semantics, pir.go:381-383):
    # (a) cross-step: an id already in this query's visited table was
    #     fetched by an earlier step — its (vector, neighbors) would be
    #     discarded by the `known` filter below anyway, so don't spend
    #     a PIR slot on it;
    # (b) in-step: of the remaining ("wanted") copies, only the FIRST
    #     goes to PIR; duplicates read the first's response.
    known = jax.vmap(
        lambda f, i: jnp.any(f[:, None] == i[None, :], axis=1)
    )(fid.reshape(Qn, parallel * m), ids)            # (Qn, parallel*m)
    wanted = ~known.reshape(F)
    eqm = (fid[:, None] == fid[None, :]) & wanted[None, :]
    has_first = jnp.any(eqm, axis=1)
    fo_idx = jnp.argmax(eqm, axis=1).astype(jnp.int32)
    is_first = (fo_idx == jnp.arange(F, dtype=jnp.int32)) & wanted

    # 3. partition routing with FCFS quota (batch-pir.go:178-216)
    pa = fid // psize                                # (F,)
    onehot = (pa[:, None] == jnp.arange(P)[None, :]) & is_first[:, None]
    rank = jnp.take_along_axis(
        jnp.cumsum(onehot, axis=0), pa[:, None], axis=1)[:, 0] - 1
    keep = is_first & (rank < quota)
    # scatter-free slot inversion: for each target slot (r, p), find
    # the fetch that routed there (dense argmax-match, no scatter with
    # data-dependent indices)
    slot = jnp.where(keep, rank * P + pa, -1)
    sl_iota = jnp.arange(quota * P, dtype=jnp.int32)
    match = slot[None, :] == sl_iota[:, None]        # (QP, F)
    src_f = jnp.argmax(match, axis=1).astype(jnp.int32)
    found = jnp.any(match, axis=1)
    local = (fid - pa * psize).astype(jnp.int32)
    idx_q = jnp.where(found, local[src_f], -1).reshape(quota, P)

    return (explored, fid, known, is_first, keep, slot, fo_idx, has_first,
            idx_q, rnd)


def _update_core(ids, dist, nbrs, explored, stats, queries, entries, oks,
                 fid, known, is_first, keep, slot, fo_idx, has_first,
                 step_idx, *, dim, m, k, P, parallel, quota):
    """Step 5 of a beam+PIR step: response fan-out, decode, visited-table
    update, fetch accounting. Shared verbatim by both routes (see
    _route_core). step_idx is a TRACED global step index."""
    Qn = queries.shape[0]
    Ep = k * 128
    entries_flat = jnp.concatenate(
        [entries.reshape(quota * P, Ep),
         jnp.zeros((1, Ep), jnp.uint32)])
    ok_flat = jnp.concatenate(
        [oks.reshape(quota * P), jnp.zeros(1, bool)])
    # every fetch reads its FIRST OCCURRENCE's response slot
    # (overflow/failed firsts resolve to the zero row)
    sfo = jnp.where(has_first, slot[fo_idx], -1)
    rslot = jnp.where(sfo >= 0, sfo, quota * P)
    res = entries_flat[rslot]                        # (F, Ep)
    res_ok = ok_flat[rslot] & keep[fo_idx] & has_first

    # decode + visited-table update (search.go:187-207)
    vec = jax.lax.bitcast_convert_type(
        res[:, :dim], jnp.float32)                   # (F, dim)
    nb = res[:, dim : dim + m].astype(jnp.int32)     # (F, m)

    q_of = jnp.repeat(jnp.arange(Qn), parallel * m)
    cdist = jnp.sum(
        (vec - queries[q_of]) ** 2, axis=-1)

    fid_q = fid.reshape(Qn, parallel * m)
    nb_q = nb.reshape(Qn, parallel * m, m)
    d_q = cdist.reshape(Qn, parallel * m)
    ok_q = res_ok.reshape(Qn, parallel * m)

    firstocc = jax.vmap(_first_occurrence)(fid_q)
    nonzero = jnp.any(nb_q != 0, axis=2)
    accept = ~known & firstocc & nonzero & ok_q

    # contiguous write window [base, base + parallel*m): a dynamic
    # update slice, not a scatter
    base = parallel + step_idx * (parallel * m)
    ids = jax.lax.dynamic_update_slice(
        ids, jnp.where(accept, fid_q, NEG_ID), (0, base))
    dist = jax.lax.dynamic_update_slice(
        dist, jnp.where(accept, d_q, INF), (0, base))
    nbrs = jax.lax.dynamic_update_slice(
        nbrs, jnp.where(accept[:, :, None], nb_q, 0), (0, base, 0))
    explored = jax.lax.dynamic_update_slice(
        explored, ~accept, (0, base))

    # fetch-success accounting (device-measured): distinct wanted
    # fetches, quota survivors, and PIR-served survivors. The drop
    # rate this exposes is the FCFS + hint-miss failure surface the
    # reference reports as its per-query success rate.
    stats = stats + jnp.stack(
        [jnp.sum(is_first, dtype=jnp.int32),
         jnp.sum(keep, dtype=jnp.int32),
         jnp.sum(oks, dtype=jnp.int32)])
    return ids, dist, nbrs, explored, stats


@functools.partial(
    jax.jit,
    static_argnames=("psize", "C", "S", "m", "P", "parallel", "quota", "n"),
    donate_argnames=("beam",),
)
def _route_step(beam, queries, rand_all, rnd_all, g, *, psize, C, S, m, P,
                parallel, quota, n):
    """Standalone jit of _route_core for the big-tier chained route.

    rand_all/rnd_all are the WHOLE search's pre-drawn PRNG arrays
    (_draw_step_randoms) and g the traced global step — the same
    clip+slice as the one-program scan body, so the two routes stay
    bit-identical."""
    ids, dist, nbrs, explored = beam
    T = rand_all.shape[0]
    gc = jnp.clip(g, 0, T - 1)
    (explored, fid, known, is_first, keep, slot, fo_idx, has_first,
     idx_q, rnd) = _route_core(
        ids, dist, nbrs, explored, queries, rand_all[gc], rnd_all[gc],
        psize=psize, C=C, S=S, m=m, P=P, parallel=parallel,
        quota=quota, n=n)
    return ((ids, dist, nbrs, explored),
            (fid, known, is_first, keep, slot, fo_idx, has_first),
            idx_q, rnd)


@functools.partial(
    jax.jit,
    static_argnames=("dim", "m", "k", "P", "parallel", "quota"),
    donate_argnames=("beam", "stats"),
)
def _update_step(beam, stats, queries, entries, oks, route_out, step_idx,
                 *, dim, m, k, P, parallel, quota):
    """Standalone jit of _update_core for the big-tier chained route."""
    ids, dist, nbrs, explored = beam
    fid, known, is_first, keep, slot, fo_idx, has_first = route_out
    ids, dist, nbrs, explored, stats = _update_core(
        ids, dist, nbrs, explored, stats, queries, entries, oks,
        fid, known, is_first, keep, slot, fo_idx, has_first, step_idx,
        dim=dim, m=m, k=k, P=P, parallel=parallel, quota=quota)
    return (ids, dist, nbrs, explored), stats


@functools.partial(
    jax.jit,
    static_argnames=("psize", "C", "R", "Hp", "S", "k", "max_q", "dpp",
                     "dim", "m", "P", "parallel", "quota", "n"),
    donate_argnames=("pir_state", "beam"),
)
def _fused_segment(db, pir_state, beam, queries, keys, base, n_steps,
                   *, psize, C, R, Hp, S, k, max_q, dpp, dim, m, P,
                   parallel, quota, n):
    """Run beam+PIR steps [base, base + n_steps) of a max_step search.

    The scan's PHYSICAL length is fixed at max_step (= keys.shape[0]) while
    `base` and `n_steps` are TRACED scalars: ONE compiled program serves
    every segment — any length, any position. Iterations outside the active
    window are skipped by a lax.cond (a cheap identity on the carry), which
    is what lets segment_plan size segments to the REMAINING hint budget
    (leftover-budget reuse) without a fresh XLA compile per segment length.
    Global step index g = base + i addresses the visited-table write window
    and the per-step PRNG key, so results are independent of segmentation."""
    ids, dist, nbrs, explored = beam
    max_step = keys.shape[0]
    bpar = pir_state["backup_parity"]
    Qn = queries.shape[0]
    # every step's PRNG values in one vectorized draw (the in-scan
    # threefry graphs were a large share of the per-step op overhead)
    rand_all, rnd_all = _draw_step_randoms(
        keys, Qn=Qn, parallel=parallel, m=m, n=n, quota=quota, P=P,
        S=S, C=C)

    def step_body(carry, step_idx, rand_ids, rnd):
        (ids, dist, nbrs, explored, pir_carry, stats) = carry

        (explored, fid, known, is_first, keep, slot, fo_idx, has_first,
         idx_q, rnd) = _route_core(
            ids, dist, nbrs, explored, queries, rand_ids, rnd,
            psize=psize, C=C, S=S, m=m, P=P, parallel=parallel,
            quota=quota, n=n)

        # 4. PIR protocol rounds — two-phase batched program (_pir_batch)
        pir_carry, entries, oks = _pir_batch(
            db, pir_state.get("table"),
            pir_state["repl_idx"], pir_state["repl_val"], bpar,
            pir_carry, idx_q, rnd,
            C=C, R=R, Hp=Hp, S=S, k=k, max_q=max_q, dpp=dpp,
            masks=pir_state.get("masks"))

        ids, dist, nbrs, explored, stats = _update_core(
            ids, dist, nbrs, explored, stats, queries, entries, oks,
            fid, known, is_first, keep, slot, fo_idx, has_first, step_idx,
            dim=dim, m=m, k=k, P=P, parallel=parallel, quota=quota)

        return (ids, dist, nbrs, explored, pir_carry, stats)

    def step_fn(carry, i):
        g = base + i
        gc = jnp.clip(g, 0, max_step - 1)
        carry = jax.lax.cond(
            i < n_steps,
            lambda c: step_body(c, g, rand_all[gc], rnd_all[gc]),
            lambda c: c,
            carry)
        return carry, None

    pir_carry = (pir_state["tag"], pir_state["prog"],
                 pir_state["primary_parity"], pir_state["slot_col"],
                 pir_state["hist"], pir_state["finished"])
    stats = jnp.zeros(3, jnp.int32)
    (ids, dist, nbrs, explored, pir_carry, stats), _ = jax.lax.scan(
        step_fn, (ids, dist, nbrs, explored, pir_carry, stats),
        jnp.arange(max_step, dtype=jnp.int32))

    tag, prog, ppar, slot_col, hist, finished = pir_carry
    new_state = dict(pir_state, tag=tag, prog=prog, primary_parity=ppar,
                     slot_col=slot_col, hist=hist, finished=finished)
    return new_state, (ids, dist, nbrs, explored), stats


@functools.partial(jax.jit, static_argnames=("topk", "parallel", "m"))
def _finish_topk(ids, dist, *, topk, parallel, m):
    """Top-k of the visited table -> (ids, reach_steps).

    The visited-table layout encodes each vertex's first-reached step for
    free (search.go:210-233's reach bookkeeping without any extra per-step
    gathers): slots [0, parallel) hold the seeds (step 0, matching the host
    twin's reach=0 for start vertices) and step g writes the contiguous
    window starting at parallel + g*parallel*m, so step = (slot - parallel)
    // (parallel*m) for every non-seed slot."""
    negd, slot = jax.lax.top_k(-dist, topk)
    valid = negd > -INF
    out = jnp.where(valid, jnp.take_along_axis(ids, slot, axis=1), NEG_ID)
    steps = jnp.maximum(slot - parallel, 0) // (parallel * m)
    steps = jnp.where(valid, steps.astype(jnp.int32), NEG_ID)
    return out, steps


class FusedPrivateSearch:
    """Host wrapper: fixed-size query groups through the fused program."""

    def __init__(self, engine: DevicePianoEngine, start_ids, start_vecs,
                 start_nbrs, dim: int, m: int, n: int):
        from pacmann.pir.sharded_engine import ChunkShardedPianoEngine

        if isinstance(engine, ChunkShardedPianoEngine):
            # its DB is sharded on the chunk axis, so the in-program server
            # scan would reduce across devices with XOR, which XLA's
            # collectives do not offer; the engine's own query() path does
            # it in shard_map (all_gather + local XOR fold)
            raise NotImplementedError(
                "FusedPrivateSearch needs a single-device or "
                "partition-sharded engine, not ChunkShardedPianoEngine")
        self.engine = engine
        self.dim, self.m, self.n = dim, m, n
        self.start_ids = jnp.asarray(start_ids, jnp.int32)
        self.start_vecs = jnp.asarray(start_vecs, jnp.float32)
        self.start_nbrs = jnp.asarray(start_nbrs, jnp.int32)
        self.refreshes = 0          # hint refreshes performed (any cause)
        # maintenance = hint-regeneration time, reported SEPARATELY from
        # query compute exactly like the reference report's two lines
        # ("avg compute per query" vs "amortized maintenance per query",
        # private-search-report.txt:16,19)
        self.maintenance_s = 0.0        # cumulative, incl. ensure_budget
        self.last_maintenance_s = 0.0   # refresh time inside the last search
        self.refresh_dummy = False      # benchmarking: zeroed-hint refresh
        # device-measured fetch accounting, cumulative over searches:
        # [distinct wanted fetches, quota survivors, PIR-served]
        self.fetch_stats = np.zeros(3, np.int64)
        # None = auto: big-tier DBs (> _PREP_SPLIT_DB_BYTES) run each beam
        # step as CHAINED device programs (route / select / server scan /
        # finish / update — data never leaves the device) instead of the
        # one-program scan (device_engine._online has the same split for
        # the raw batch path). True/False force a route; both are
        # bit-identical (they share _route_core/_update_core and
        # _pir_batch's phases — tested).
        self.split_route: bool | None = None

    def _use_split(self) -> bool:
        if self.split_route is not None:
            return self.split_route
        from pacmann.pir.device_engine import _PREP_SPLIT_DB_BYTES

        return (int(np.prod(self.engine.db.shape)) * 4
                > _PREP_SPLIT_DB_BYTES)

    def _refresh(self) -> float:
        t0 = time.perf_counter()
        if self.refresh_dummy:
            self.engine.dummy_preprocessing()
        else:
            self.engine.preprocessing()
        dt = time.perf_counter() - t0
        self.maintenance_s += dt
        self.refreshes += 1
        return dt

    def _steps_fit(self, quota: int) -> int:
        """Worst-case steps the REMAINING budget can serve (margin matches
        the refresh condition in search())."""
        e = self.engine
        if e.state is None:
            return 0
        return max(0, (e.params.max_query_num - 11
                       - e.queries_made_in_partition)) // max(quota, 1)

    def ensure_budget(self, max_step: int, n_queries: int, parallel: int,
                      min_steps: int = 1):
        """Refresh hints NOW if fewer than min_steps of the next such
        search fit the remaining budget — lets callers keep maintenance out
        of latency-critical paths (the reference runs maintenance between
        batches the same way, batch-pir.go:239-245). The default lets
        search() consume every leftover sub-query before refreshing
        (amortized maintenance at the protocol floor); min_steps=max_step
        restores refresh-before-group (zero mid-search refreshes, at the
        cost of discarding the leftover window)."""
        e = self.engine
        quota = n_queries * parallel * self.m // e.config.partition_num
        # cap by what a FRESH window can satisfy — same -11 margin as
        # _steps_fit, or min_steps=max_step could never be met and every
        # call would refresh
        min_steps = min(min_steps, max_step,
                        (e.params.max_query_num - 11) // max(quota, 1))
        if e.state is None or self._steps_fit(quota) < min_steps:
            self._refresh()

    def segment_plan(self, max_step: int, quota: int,
                     use_leftover: bool = False) -> list[int]:
        """Split max_step into segments each fitting the per-partition
        budget (pir.go:525-533's refresh-on-exhaustion, group-level).

        use_leftover sizes the FIRST segment to the budget remaining from
        earlier searches instead of assuming a fresh window, so partial
        windows are consumed rather than discarded — this is what brings
        amortized maintenance down to refresh_time * consumed/budget, the
        protocol floor. One compiled program serves every resulting length
        (see _fused_segment)."""
        p = self.engine.params
        per_budget = (p.max_query_num - 2) // max(quota, 1)
        if per_budget < 1:
            raise ValueError(
                f"one step consumes {quota} sub-queries/partition but the "
                f"budget is {p.max_query_num}; use a smaller group")
        lens = []
        left = max_step
        if use_leftover:
            first = min(left, self._steps_fit(quota))
            if first > 0:
                lens.append(first)
                left -= first
        while left > 0:
            lens.append(min(left, per_budget))
            left -= lens[-1]
        return lens

    def search(self, queries: np.ndarray, k: int, max_step: int,
               parallel: int, seed: int = 0, return_steps: bool = False):
        """-> (Q, k) int64 answer ids (-1 padded); with return_steps also
        the (Q, k) first-reached step of each answer (search.go:210-233)."""
        e = self.engine
        p = e.params
        P = e.config.partition_num
        Qn = queries.shape[0]
        F = Qn * parallel * self.m
        quota = F // P
        if quota < 1:
            raise ValueError("group too small: need Qn*parallel*m >= P")
        seg_lens = self.segment_plan(max_step, quota, use_leftover=True)

        cap = parallel + max_step * parallel * self.m
        beam = _seed_beam(
            jnp.asarray(queries, jnp.float32), self.start_ids,
            self.start_vecs, self.start_nbrs,
            parallel=parallel, cap=cap, m=self.m)
        keys = jax.random.split(jax.random.PRNGKey(seed), max_step)

        kw = dict(psize=e.config.partition_size, C=p.chunk_size,
                  R=p.max_query_per_chunk, Hp=p.primary_hint_num,
                  S=p.set_size, k=e.k, max_q=p.max_query_num,
                  dpp=DEFAULT_PROGRAM_POINT, dim=self.dim, m=self.m, P=P,
                  parallel=parallel, quota=quota, n=self.n)
        queries_d = jnp.asarray(queries, jnp.float32)
        self.last_maintenance_s = 0.0
        seg_stats = []
        base = 0
        use_split = self._use_split()
        if use_split:
            route_kw = dict(psize=kw["psize"], C=kw["C"], S=kw["S"], m=self.m,
                            P=P, parallel=parallel, quota=quota, n=self.n)
            sel_kw = dict(C=kw["C"], R=kw["R"], Hp=kw["Hp"], S=kw["S"],
                          k=kw["k"], dpp=kw["dpp"])
            upd_kw = dict(dim=self.dim, m=self.m, k=kw["k"], P=P,
                          parallel=parallel, quota=quota)
            stats_dev = jnp.zeros(3, jnp.int32)
            # the whole search's PRNG values, drawn once (same clip+slice
            # per step as the one-program scan — bit-identity)
            rand_all, rnd_all = _draw_step_randoms(
                keys, Qn=Qn, parallel=parallel, m=self.m, n=self.n,
                quota=quota, P=P, S=kw["S"], C=kw["C"])
        for seg in seg_lens:
            need = seg * quota
            # refresh when the WORST-CASE budget cannot cover this segment
            # (private-search.go:224-230's proactive margin); the estimate
            # is corrected to the device-measured truth after the search
            if (e.state is None
                    or e.queries_made_in_partition + need + 10
                    >= p.max_query_num):
                # Drain in-flight segment compute BEFORE the refresh timer
                # starts: device programs execute serially, so the sync at
                # the end of preprocessing() would otherwise absorb the
                # prior segment's remaining async compute into the
                # maintenance account (the drained time is query compute
                # and stays in the wall-clock compute term).
                if e.state is not None:
                    _ = np.asarray(e.state["finished"][-1])
                self.last_maintenance_s += self._refresh()
            if use_split:
                # big-tier route: the same step math as _fused_segment's
                # scan body, chained as five async device programs per step
                # (beam state and PIR state stay resident; dispatches
                # pipeline)
                from pacmann.pir.device_engine import (
                    _finish_step, _select_step, _server_answer)

                for i in range(seg):
                    g = base + i
                    beam, ro, idx_q, rnd = _route_step(
                        beam, queries_d, rand_all, rnd_all, jnp.int32(g),
                        **route_kw)
                    sel, qs = _select_step(
                        e.state, idx_q, rnd,
                        max_q=kw["max_q"], **sel_kw)
                    resp = _server_answer(e.db, qs, k=kw["k"])
                    e.state, entries, oks = _finish_step(
                        e.state, sel, resp, **sel_kw)
                    beam, stats_dev = _update_step(
                        beam, stats_dev, queries_d, entries, oks, ro,
                        jnp.int32(g), **upd_kw)
            else:
                e.state, beam, stats = _fused_segment(
                    e.db, e.state, beam, queries_d, keys,
                    jnp.int32(base), jnp.int32(seg), **kw)
                seg_stats.append(stats)
            # budget bookkeeping mirrors engine.query (batch-pir.go:239-245)
            e.queries_made_in_partition += need
            e.finished_batch_num += seg * (F // e.config.batch_size)
            base += seg
        if use_split:
            seg_stats.append(stats_dev)

        out_ids, out_steps = _finish_topk(
            beam[0], beam[1], topk=k, parallel=parallel, m=self.m)
        # one device_get for the answers AND the true per-partition budget
        # consumption: dedup'd / dummy rows never spend device budget, so
        # the measured `finished` is far below the worst-case estimate —
        # stretching each budget window over more searches (fewer refreshes).
        # Consumption = max(finished, per-partition backup burn): admitted-
        # then-denied rounds (ok_r & ~ok_q) burn a backup hint without
        # serving, so `finished` alone would understate near exhaustion and
        # stretch the window into extra hint-miss failures at the tail.
        out_np, steps_np, fin, hist, stat_np = jax.device_get(
            (out_ids, out_steps, e.state["finished"], e.state["hist"],
             seg_stats))
        e.queries_made_in_partition = int(
            max(fin.max(), hist.sum(axis=1).max()))
        self.fetch_stats += np.sum(stat_np, axis=0, dtype=np.int64)
        out_np = np.asarray(out_np).astype(np.int64)
        if return_steps:
            return out_np, np.asarray(steps_np).astype(np.int64)
        return out_np

    def budget_left(self) -> int:
        return self.engine.params.max_query_num \
            - self.engine.queries_made_in_partition

    def fetch_success_rate(self) -> float:
        """Served / distinct-wanted fetches (cumulative, device-measured)."""
        want = int(self.fetch_stats[0])
        return float(self.fetch_stats[2]) / want if want else 1.0
