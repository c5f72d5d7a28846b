"""Device-resident batch-PIR engine: protocol contracts with hint state in
device memory (TestBatchPIRBasic semantics, pir_test.go:60-202, plus the
budget/refresh behavior of TestPIRBasic, :9-58)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pacmann.pir.device_engine import DevicePianoEngine


def claim_select_np(slot_col, prog, chunk_q, off_q, real_q, *, C, dpp):
    """NumPy sequential twin of the Phase-A claim (pir.go:404-419 scanned
    round by round): round q takes the first eligible primary slot not
    claimed by an earlier round. The oracle for _pir_select's XLA owner
    fixpoint."""
    Q, P = chunk_q.shape
    Hp = slot_col.shape[2]
    hit = np.zeros((Q, P), np.int32)
    found = np.zeros((Q, P), bool)
    prog_set = prog != np.uint32(dpp)
    prog_chunk = (prog // np.uint32(C)).astype(np.int64)
    for p in range(P):
        claimed = np.zeros(Hp, bool)
        for q in range(Q):
            if not real_q[q, p]:
                continue
            ck = int(chunk_q[q, p])
            elig = ((slot_col[p, ck].astype(np.int64) == int(off_q[q, p]))
                    & (~prog_set[p] | (prog_chunk[p] != ck)) & ~claimed)
            idx = np.flatnonzero(elig)
            if idx.size:
                hit[q, p] = idx[0]
                found[q, p] = True
                claimed[idx[0]] = True
    return hit, found


def _rand_claim_case(rng, Q, P, S, Hp, C, contention=False):
    dpp = 0x7FFFFFFF
    slot_col = rng.integers(0, C, size=(P, S, Hp)).astype(np.uint16)
    prog = rng.integers(0, S * C, size=(P, Hp)).astype(np.uint32)
    unset = rng.random((P, Hp)) < 0.5
    prog[unset] = dpp
    if contention:
        # every round asks the same (chunk, offset): all rounds contest
        # one eligible slot set per partition
        chunk_q = np.full((Q, P), rng.integers(0, S), np.int32)
        off_q = np.full((Q, P), rng.integers(0, C), np.uint32)
    else:
        chunk_q = rng.integers(0, S, size=(Q, P)).astype(np.int32)
        off_q = rng.integers(0, C, size=(Q, P)).astype(np.uint32)
    real_q = rng.random((Q, P)) < 0.9
    return slot_col, prog, chunk_q, off_q, real_q, dpp


@pytest.mark.parametrize("Q,P,S,Hp,C", [(16, 4, 8, 480, 32),
                                        (8, 2, 4, 256, 64),
                                        (24, 3, 5, 896, 128),
                                        (32, 2, 4, 256, 16)])
@pytest.mark.parametrize("contention", [False, True])
def test_owner_fixpoint_claim_matches_sequential(Q, P, S, Hp, C, contention):
    """_pir_select's XLA owner-fixpoint claim reproduces the strictly
    sequential greedy claim (claim_select_np) — same hit slots, same
    failures — across shapes and contention, and claims are unique."""
    from pacmann.pir.device_engine import _pir_select

    rng = np.random.default_rng(7 + Q + Hp + contention)
    slot_col, prog, chunk_q, off_q, real_q, dpp = _rand_claim_case(
        rng, Q, P, S, Hp, C, contention)
    R, max_q = 4 * Q, 10 * Q       # budgets never bind: ok == found
    idx_q = np.where(real_q, chunk_q * C + off_q.astype(np.int64),
                     -1).astype(np.int32)
    T = Hp + S * R
    carry = (jnp.zeros((P, Hp), jnp.int32), jnp.asarray(prog),
             jnp.zeros((P, 1, 1), jnp.uint32), jnp.asarray(slot_col),
             jnp.zeros((P, S), jnp.int32), jnp.zeros((P,), jnp.int32))
    sel, _ = _pir_select(
        jnp.zeros((P, T, S), jnp.uint16), jnp.zeros((P, S, R), jnp.uint32),
        carry, jnp.asarray(idx_q),
        jnp.zeros((Q, P, S), jnp.uint32), C=C, R=R, Hp=Hp, S=S, k=1,
        max_q=max_q, dpp=dpp)
    hit, ok = np.asarray(sel[0]), np.asarray(sel[1])
    hit_np, found_np = claim_select_np(
        slot_col, prog, chunk_q, off_q, real_q, C=C, dpp=dpp)
    assert np.array_equal(ok, found_np)
    assert np.array_equal(np.where(ok, hit, 0), np.where(found_np, hit_np, 0))
    for p in range(P):
        taken = hit[ok[:, p], p]
        assert len(set(taken.tolist())) == len(taken)


def _mk(rng, n=8192, entry_bytes=32, batch=32, fail=20):
    raw = rng.integers(0, 2**32, size=(n, entry_bytes // 4), dtype=np.uint32)
    pir = DevicePianoEngine(n, entry_bytes, batch, raw, fail)
    pir.preprocessing(rng=np.random.default_rng(100))
    return raw, pir


def test_device_pack_matches_host_pack():
    """The on-device DB layout program must be bit-identical to the host
    _pack_partitions oracle, including non-divisible partition padding."""
    rng = np.random.default_rng(51)
    for n in (8192, 8000):
        raw = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
        pir = DevicePianoEngine(n, 32, 32, raw, 20)
        host = pir._pack_partitions(raw, 0, pir.config.partition_num)
        assert np.array_equal(np.asarray(pir.db), host), n


def test_device_spread_queries_exact():
    rng = np.random.default_rng(50)
    raw, pir = _mk(rng)
    c = pir.config
    ids = []
    for _ in range(2):
        ids += [int(i * c.partition_size + rng.integers(0, c.partition_size))
                for i in range(c.partition_num)]
    out = pir.query(ids)
    for r, idx in enumerate(ids):
        assert np.array_equal(out[r], raw[idx]), f"row {r} idx {idx}"


def test_device_duplicate_ids_in_batch():
    rng = np.random.default_rng(51)
    raw, pir = _mk(rng)
    ids = [7] * 32
    out = pir.query(ids)
    # quota rows answer exactly; the rest are served from the responses map
    assert np.array_equal(out[0], raw[7])
    assert np.array_equal(out[1], raw[7])


def test_device_overflow_dropped_to_zeros():
    """retries=0 is the strict single-round reference contract
    (batch-pir.go:229-235): FCFS overflow -> zeros."""
    rng = np.random.default_rng(52)
    raw, pir = _mk(rng)
    c = pir.config
    ids = list(range(32))  # all in partition 0
    out = pir.query(ids, retries=0)
    answered = 32 // c.partition_num
    for r in range(answered):
        assert np.array_equal(out[r], raw[ids[r]])
    for r in range(answered, 32):
        assert np.all(out[r] == 0)


def test_device_retry_round_serves_overflow():
    """The default one retry round re-issues FCFS overflow drops: a batch
    whose ids all collide into one partition still answers quota*(1+retries)
    of them exactly, and the REMAINING overflow is zeros. Device-measured
    budget consumption must match the real sub-queries served (dummy retry
    rows never spend budget)."""
    rng = np.random.default_rng(56)
    raw, pir = _mk(rng)
    c = pir.config
    assert pir.query_retries == 1
    ids = list(range(32))  # all in partition 0
    out = pir.query(ids)
    quota = 32 // c.partition_num
    served = 2 * quota      # two rounds' worth of this partition's FCFS
    for r in range(served):
        assert np.array_equal(out[r], raw[ids[r]]), r
    for r in range(served, 32):
        assert np.all(out[r] == 0), r
    # consumption = device truth: 2*quota sub-queries in partition 0 only
    fin = np.asarray(pir.state["finished"])
    assert fin[0] == served and fin[1:].sum() == 0
    assert pir.queries_made_in_partition == served


def test_device_retry_spread_batch_noop_budget():
    """A batch the first round fully serves still runs the (all-dummy)
    retry round — fixed server-visible pattern — but consumes no extra
    device budget, and answers stay exact."""
    rng = np.random.default_rng(57)
    raw, pir = _mk(rng)
    c = pir.config
    ids = [int(i * c.partition_size + rng.integers(0, c.partition_size))
           for i in range(c.partition_num)]
    out = pir.query(ids)
    for r, idx in enumerate(ids):
        assert np.array_equal(out[r], raw[idx]), r
    fin = np.asarray(pir.state["finished"])
    assert fin.max() <= 1  # one real sub-query per partition, no retry spend
    assert pir.queries_made_in_partition == int(fin.max())


def test_device_cache_hits_across_batches():
    rng = np.random.default_rng(53)
    raw, pir = _mk(rng)
    c = pir.config
    ids = [int(i * c.partition_size) for i in range(c.partition_num)] * 2
    pir.query(ids)
    fin_before = int(np.asarray(pir.state["finished"]).sum())
    pir.query(ids)  # all cached -> no budget consumed
    fin_after = int(np.asarray(pir.state["finished"]).sum())
    assert fin_after == fin_before


def test_device_budget_reprep():
    rng = np.random.default_rng(54)
    n, batch = 2048, 32
    raw = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    pir = DevicePianoEngine(n, 32, batch, raw, 20)
    pir.preprocessing(rng=np.random.default_rng(101))
    rounds = pir.params.max_query_num
    ok = 0
    for _ in range(rounds):
        ids = [int(rng.integers(0, n)) for _ in range(batch)]
        out = pir.query(ids)
        for r, idx in enumerate(ids):
            if np.array_equal(out[r], raw[idx]):
                ok += 1
    assert ok > rounds * batch * 0.65  # lossy FCFS bound (see test_batch_pir)


def _raw_online(pir, idx_q, rng):
    """Drive one _pir_batch directly (bypasses query()'s cache/dedup) so
    adversarial slot-contention batches can be constructed."""
    p = pir.params
    Q, P = idx_q.shape
    rand_offs = (rng.integers(0, 2**32, size=(Q, P, p.set_size),
                              dtype=np.uint64)
                 & np.uint64(p.chunk_mask)).astype(np.uint32)
    state, entries, oks = pir._online(np.asarray(idx_q, np.int32), rand_offs)
    pir.state = state  # old state buffers were donated
    E = pir.config.entry_bytes // 4
    return np.asarray(entries)[:, :, :E], np.asarray(oks)


def test_measured_comm_matches_analytic_model():
    """measure_comm mode materializes the client->server offset upload and
    the server->client entry download at a host boundary; the measured byte
    counts must equal the reference's analytic model (pir.go:539-544,
    batch-pir.go:258-264) exactly, and the answers must stay exact."""
    rng = np.random.default_rng(62)
    n, entry_bytes, batch = 8192, 32, 32
    raw = rng.integers(0, 2**32, size=(n, entry_bytes // 4), dtype=np.uint32)
    pir = DevicePianoEngine(n, entry_bytes, batch, raw, 20, measure_comm=True)
    pir.preprocessing(rng=np.random.default_rng(104))
    c, p = pir.config, pir.params

    batches = 3
    for b in range(batches):
        ids = [int(i * c.partition_size + rng.integers(0, c.partition_size))
               for i in range(c.partition_num)] * 2
        # retries=0: the analytic model counts one round per batch
        out = pir.query(ids, retries=0)
        for r, idx in enumerate(ids):
            assert np.array_equal(out[r], raw[idx]), (b, r)

    # analytic per-batch: QUERY_PER_PARTITION sub-queries per partition,
    # each uploading set_size u32 and downloading one entry
    up_model = 2 * c.partition_num * p.set_size * 4 * batches
    down_model = 2 * c.partition_num * entry_bytes * batches
    assert pir.uploaded_bytes == up_model, (pir.uploaded_bytes, up_model)
    assert pir.downloaded_bytes == down_model, (
        pir.downloaded_bytes, down_model)
    assert pir.comm_cost_per_batch_online() == (
        up_model + down_model) // batches


def test_phase_a_contention_matches_sequential_oracle():
    """Worst-case slot contention: every round of a batch asks the SAME
    (chunk, offset) in every partition, so all rounds contest one eligible
    slot set. The owner-fixpoint claim must reproduce the strictly
    SEQUENTIAL greedy outcome (pir.go:404-419 scanned round by round) —
    identical found/failed sets as the NumPy sequential twin at any
    contention depth — and successful rounds must stay exact."""
    from pacmann.pir.params import DEFAULT_PROGRAM_POINT

    rng = np.random.default_rng(60)
    n, batch, fail = 2048, 32, 20
    raw = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    pir = DevicePianoEngine(n, 32, batch, raw, fail)
    pir.preprocessing(rng=np.random.default_rng(102))
    c, p = pir.config, pir.params
    P = c.partition_num

    Q = 16  # far deeper contention than any real batch
    local = 17  # same local index in every partition, every round
    idx_q = np.full((Q, P), local, np.int32)
    # snapshot the claim inputs before the donated call
    slot_col = np.asarray(pir.state["slot_col"])
    prog = np.asarray(pir.state["prog"])
    entries, oks = _raw_online(pir, idx_q, rng)

    chunk_q = np.full((Q, P), local // p.chunk_size, np.int32)
    off_q = np.full((Q, P), local % p.chunk_size, np.uint32)
    _, found_np = claim_select_np(
        slot_col, prog, chunk_q, off_q, np.ones((Q, P), bool),
        C=p.chunk_size, dpp=DEFAULT_PROGRAM_POINT)
    # budgets don't bind here (all found ranks < R, Q << max_query_num),
    # so ok == sequential found, exactly
    assert np.array_equal(oks, found_np)
    # sanity: the contention is real — successes are capped by the number
    # of eligible slots (~Binomial(Hp, 1/C), mean 15 here), not by Q
    per_part = oks.sum(axis=0)
    assert per_part.min() >= 5, per_part
    # successful rounds are exact despite the contention
    for q in range(Q):
        for i in range(P):
            if oks[q, i]:
                assert np.array_equal(
                    entries[q, i], raw[i * c.partition_size + local]), (q, i)

    # state stays consistent: a normal follow-up batch answers exactly
    ids = [int(i * c.partition_size + 5) for i in range(P)]
    out = pir.query(ids)
    for r, idx in enumerate(ids):
        assert np.array_equal(out[r], raw[idx]), r


def test_protocol_miss_rate_within_failure_bound():
    """Protocol-level miss rate (no-hit-hint, pir.go:416-419) stays within
    the 2^-failLog2-derived bound: P(miss) ~ e^-(Hp/C) <= 2^-(fail+1).
    Uses one real sub-query per partition per batch (no FCFS drops, no
    contention) so every failure is a genuine hit-scan miss."""
    from pacmann.pir.device_engine import DevicePianoEngine

    rng = np.random.default_rng(61)
    n, batch, fail = 2048, 32, 2  # small fail -> measurable miss rate
    raw = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    pir = DevicePianoEngine(n, 32, batch, raw, fail)
    pir.preprocessing(rng=np.random.default_rng(103))
    c, p = pir.config, pir.params
    P, psize = c.partition_num, c.partition_size

    total = ok = 0
    batches = min(40, p.max_query_num - 2)
    for _ in range(batches):
        idx_q = rng.integers(0, psize, size=(1, P)).astype(np.int32)
        _, oks = _raw_online(pir, idx_q, rng)
        total += P
        ok += int(oks.sum())
    miss_rate = 1.0 - ok / total
    # expected ~ e^-(Hp/C) = e^-3 ~ 0.050; assert within 2.5x slack and
    # always within the protocol's 2^-fail bound
    assert miss_rate <= max(2.0 ** -fail, 2.5 * np.exp(-p.primary_hint_num
                                                       / p.chunk_size)), miss_rate


def test_device_nondivisible_padding():
    rng = np.random.default_rng(55)
    raw, pir = _mk(rng, n=8000)
    c = pir.config
    ids = [int(i * c.partition_size + rng.integers(0, min(
        c.partition_size, 8000 - i * c.partition_size)))
        for i in range(c.partition_num)]
    out = pir.query(ids)
    for r, idx in enumerate(ids):
        assert np.array_equal(out[r], raw[idx])


def test_fused_prep_matches_split_path():
    """The single-program offline path of the "gpu" backend (_prep_fused)
    must produce bit-identical state to the "cpu" path (host AES tables)
    given the same RNG stream. Called directly on the CPU backend."""
    from pacmann.ops import aes
    from pacmann.pir.device_engine import _prep_fused

    rng = np.random.default_rng(60)
    n, entry_bytes, batch = 4096, 32, 32
    raw = rng.integers(0, 2**32, size=(n, entry_bytes // 4), dtype=np.uint32)

    pir = DevicePianoEngine(n, entry_bytes, batch, raw, 20)
    pir.preprocessing(rng=np.random.default_rng(7))

    # replicate preprocessing's RNG draw order: repl_off, then one key/part
    p, c = pir.params, pir.config
    P = c.partition_num
    S, R, Hp, C = (p.set_size, p.max_query_per_chunk, p.primary_hint_num,
                   p.chunk_size)
    T = Hp + S * R
    rng2 = np.random.default_rng(7)
    repl_off = (rng2.integers(0, 2**32, size=(P, S, R), dtype=np.uint64)
                & np.uint64(p.chunk_mask)).astype(np.uint32)
    masks = np.stack([aes.expand_key_planes(rng2.bytes(16))
                      for _ in range(P)])
    table, parities, repl_val, slot_col = _prep_fused(
        pir.db, jnp.asarray(masks), jnp.asarray(repl_off),
        T=T, S=S, C=C, Hp=Hp, R=R, k=pir.k, chunk_mask=p.chunk_mask)

    assert np.array_equal(np.asarray(table), np.asarray(pir.state["table"]))
    assert np.array_equal(np.asarray(slot_col),
                          np.asarray(pir.state["slot_col"]))
    assert np.array_equal(np.asarray(parities[:, :Hp]),
                          np.asarray(pir.state["primary_parity"]))
    assert np.array_equal(np.asarray(parities[:, Hp:]),
                          np.asarray(pir.state["backup_parity"]))
    assert np.array_equal(np.asarray(repl_val),
                          np.asarray(pir.state["repl_val"]))


def test_table_free_bit_identical():
    """table_free=True (online bitsliced PRF, reference storage model
    pir.go:404-427) must answer bit-identically to the table engine and
    carry identical protocol state, given the same preprocessing RNG."""
    rng = np.random.default_rng(77)
    n, eb = 8192, 32
    raw = rng.integers(0, 2**32, size=(n, eb // 4), dtype=np.uint32)
    a = DevicePianoEngine(n, eb, 32, raw, 20)
    b = DevicePianoEngine(n, eb, 32, raw, 20, table_free=True)
    a.preprocessing(rng=np.random.default_rng(7))
    b.preprocessing(rng=np.random.default_rng(7))
    assert "table" not in b.state and "masks" in b.state
    assert b.extra_storage_size() < a.extra_storage_size()
    qrng = np.random.default_rng(8)
    for _ in range(3):
        ids = [int(i) for i in qrng.integers(0, n, 32)]
        # identical dummy-offset draws: same engine RNG stream
        a._rng = np.random.default_rng(9)
        b._rng = np.random.default_rng(9)
        oa = a.query(list(ids))
        ob = b.query(list(ids))
        assert np.array_equal(oa, ob)
    for key in ("tag", "prog", "slot_col", "hist", "finished",
                "primary_parity"):
        assert np.array_equal(
            np.asarray(a.state[key]), np.asarray(b.state[key])), key


def test_big_tier_two_program_prep_matches_fused():
    """The >4 GiB two-program offline phase (_prep_tables_big +
    _prep_scan_big, so phase-A transients free before phase B allocates)
    must produce exactly the single fused program's outputs — same
    tables, parities, replacement values and slot columns."""
    from pacmann.ops import aes
    from pacmann.pir import device_engine as de

    rng = np.random.default_rng(77)
    n, entry_bytes, batch = 4096, 16, 8
    raw = rng.integers(0, 2**32, size=(n, entry_bytes // 4), dtype=np.uint32)
    eng = de.DevicePianoEngine(n, entry_bytes, batch, raw, 8)
    p, P = eng.params, eng.config.partition_num
    S, R, Hp, C = (p.set_size, p.max_query_per_chunk,
                   p.primary_hint_num, p.chunk_size)
    T = Hp + S * R
    keys16 = [rng.bytes(16) for _ in range(P)]
    masks = jnp.asarray(np.stack([aes.expand_key_planes(k) for k in keys16]))
    repl_off = jnp.asarray(
        rng.integers(0, C, size=(P, S, R), dtype=np.uint32))

    f_table, f_par, f_repl, f_slot = de._prep_fused(
        eng.db, masks, repl_off, T=T, S=S, C=C, Hp=Hp, R=R, k=eng.k,
        chunk_mask=p.chunk_mask)
    table, slot_col = de._prep_tables_big(
        masks, T=T, S=S, C=C, Hp=Hp, chunk_mask=p.chunk_mask)
    par, repl = de._prep_scan_big(
        eng.db, table, repl_off, T=T, S=S, Hp=Hp, R=R, k=eng.k)

    assert np.array_equal(np.asarray(table), np.asarray(f_table))
    assert np.array_equal(np.asarray(slot_col), np.asarray(f_slot))
    assert np.array_equal(np.asarray(par), np.asarray(f_par))
    assert np.array_equal(np.asarray(repl), np.asarray(f_repl))


def test_finish_scatter_matches_dense():
    """The row-targeted scatter refresh and the dense streaming rewrite
    produce identical carries and entries — fuzzed over random state,
    unique hit slots, denial masks, and OOB-dropped failures."""
    import os

    from pacmann.pir.device_engine import _pir_finish

    rng = np.random.default_rng(15)
    for Q, P, S, Hp, C, R, k in [(6, 4, 8, 480, 32, 5, 1),
                                 (16, 3, 5, 896, 128, 7, 2)]:
        T = Hp + S * R
        Ep = k * 128
        tag = rng.integers(0, T, size=(P, Hp)).astype(np.int32)
        prog = rng.integers(0, S * C, size=(P, Hp)).astype(np.uint32)
        ppar = rng.integers(0, 2**32, size=(P, Hp, Ep), dtype=np.uint32)
        slot_col = rng.integers(0, C, size=(P, S, Hp)).astype(np.uint16)
        hist = rng.integers(0, R, size=(P, S)).astype(np.int32)
        finished = rng.integers(0, 50, size=(P,)).astype(np.int32)
        repl_val = rng.integers(0, 2**32, size=(P, S, R, Ep),
                                dtype=np.uint32)
        bpar = rng.integers(0, 2**32, size=(P, S * R, Ep), dtype=np.uint32)
        table = rng.integers(0, C, size=(P, T, S)).astype(np.uint16)
        # unique hit slots per partition (the reservation invariant)
        hit = np.stack(
            [rng.choice(Hp, size=Q, replace=False) for _ in range(P)],
            axis=1).astype(np.int32)
        ok_q = rng.random((Q, P)) < 0.7
        ok_r = ok_q | (rng.random((Q, P)) < 0.2)
        ig = rng.integers(0, R, size=(Q, P)).astype(np.int32)
        chunk = rng.integers(0, S, size=(Q, P)).astype(np.int32)
        idxu = rng.integers(0, S * C, size=(Q, P)).astype(np.uint32)
        resp = rng.integers(0, 2**32, size=(Q, P, Ep), dtype=np.uint32)
        carry = tuple(jnp.asarray(x) for x in
                      (tag, prog, ppar, slot_col, hist, finished))
        sel = (jnp.asarray(hit), jnp.asarray(ok_q), jnp.asarray(ok_r),
               jnp.asarray(ig), jnp.asarray(chunk), jnp.asarray(idxu),
               None)
        outs = {}
        for which in ("dense", "scatter"):
            os.environ["PACMANN_REFRESH_ROUTE"] = which
            try:
                outs[which] = jax.device_get(_pir_finish(
                    jnp.asarray(repl_val), jnp.asarray(bpar),
                    jnp.asarray(table), carry, sel, jnp.asarray(resp),
                    C=C, R=R, Hp=Hp, S=S, k=k, dpp=0x7FFFFFFF))
            finally:
                del os.environ["PACMANN_REFRESH_ROUTE"]
        for a, b in zip(jax.tree.leaves(outs["dense"]),
                        jax.tree.leaves(outs["scatter"])):
            assert np.array_equal(a, b), (Q, P)
