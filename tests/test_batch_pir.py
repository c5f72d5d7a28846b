"""Batch PIR contract — port of TestBatchPIRBasic
(/root/reference/pianopir/pir_test.go:60-202): exact answers when <=
QueryPerPartition ids land in each partition, dummy padding for short
partitions, and the explicit lossy contract — overflow queries beyond the
per-partition quota are dropped and answered with zeros. DB sizes scaled down
from the Go test's 1M x 128B for CPU speed."""

import numpy as np

from pacmann.pir.batch import SimpleBatchPianoPIR
from pacmann.pir.params import QUERY_PER_PARTITION, derive_batch_params


def _mk(rng, n=8192, entry_bytes=32, batch=32, fail=20):
    raw = rng.integers(0, 2**32, size=(n, entry_bytes // 4), dtype=np.uint32)
    pir = SimpleBatchPianoPIR(n, entry_bytes, batch, raw, fail)
    pir.preprocessing(rng=np.random.default_rng(100))
    return raw, pir


def test_batch_params():
    c = derive_batch_params(8192, 32, 32, 20)
    assert c.partition_num == 16          # BatchSize/2 (batch-pir.go:62)
    assert c.partition_size == 512


def test_batch_spread_queries_exact():
    rng = np.random.default_rng(20)
    raw, pir = _mk(rng)
    c = pir.config
    # one id in each of 16 partitions + 16 more (2 per partition = quota)
    ids = [int(i * c.partition_size + rng.integers(0, c.partition_size))
           for i in range(c.partition_num)] * 2
    out = pir.query(ids)
    for r, idx in enumerate(ids):
        assert np.array_equal(out[r], raw[idx]), f"row {r} idx {idx}"


def test_batch_overflow_dropped_to_zeros():
    rng = np.random.default_rng(21)
    raw, pir = _mk(rng)
    c = pir.config
    # all 32 ids in partition 0: quota = 32/16 = 2 answered, 30 dropped
    ids = [int(rng.integers(0, c.partition_size)) for _ in range(32)]
    # ensure distinct so cache can't answer dropped ones
    ids = list(dict.fromkeys(ids))
    while len(ids) < 32:
        x = int(rng.integers(0, c.partition_size))
        if x not in ids:
            ids.append(x)
    out = pir.query(ids)
    answered = 32 // c.partition_num  # FCFS (batch-pir.go:194-216)
    for r in range(answered):
        assert np.array_equal(out[r], raw[ids[r]])
    for r in range(answered, 32):
        assert np.all(out[r] == 0), f"row {r} should be dropped -> zeros"


def test_batch_short_batch_pads_with_dummies():
    rng = np.random.default_rng(22)
    raw, pir = _mk(rng)
    c = pir.config
    # 16 ids over 16 partitions: queryNumToMake = 1; every partition answers 1
    ids = [int(i * c.partition_size + 7) for i in range(c.partition_num)]
    out = pir.query(ids)
    for r, idx in enumerate(ids):
        assert np.array_equal(out[r], raw[idx])


def test_batch_auto_reprep_budget():
    rng = np.random.default_rng(23)
    n, entry_bytes, batch = 2048, 32, 32
    raw = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    pir = SimpleBatchPianoPIR(n, entry_bytes, batch, raw, 20)
    pir.preprocessing(rng=np.random.default_rng(101))
    max_q = pir.sub_pir[0].params.max_query_num
    c = pir.config
    # each batch consumes batch/partition_num = 2 from each partition budget
    rounds = max_q  # enough to trip the re-prep path at least once
    ok = 0
    for _ in range(rounds):
        ids = [int(rng.integers(0, n)) for _ in range(batch)]
        out = pir.query(ids)
        for r, idx in enumerate(ids):
            if np.array_equal(out[r], raw[idx]):
                ok += 1
    # Uniform-random ids over 16 partitions with a hard FCFS quota of 2 per
    # partition (batch-pir.go:194-216) answer E[min(Binom(32,1/16),2)]/2 ~ 73%
    # of queries in expectation; the rest are dropped to zeros by contract.
    # Assert we stay near that bound across hint refreshes.
    assert ok > rounds * batch * 0.65


def test_fcfs_success_matches_analytic_contract():
    """Measured served/wanted rate tracks the derivable FCFS + hint-miss
    model (expected_success_rate): quota-overflow drops follow
    E[min(Binom(B,1/P), quota)] (batch-pir.go:194-235) and survivors miss
    w.p. 2^-failLog2 (pir.go:416-419). A drift beyond tolerance means the
    routing, dedup, or budget logic silently regressed. retries=0 pins
    the strict single-round contract the model describes (the default one
    retry round re-serves drops and lifts success above it — covered by
    test_query_retry_*)."""
    from pacmann.pir.device_engine import DevicePianoEngine
    from pacmann.pir.params import expected_success_rate

    rng = np.random.default_rng(24)
    n, entry_bytes, batch = 8192, 32, 32
    raw = rng.integers(0, 2**32, size=(n, entry_bytes // 4), dtype=np.uint32)
    pir = DevicePianoEngine(n, entry_bytes, batch, raw, 20)
    pir.preprocessing(rng=np.random.default_rng(103))
    c = pir.config

    batches, served = 100, 0
    for _ in range(batches):
        # distinct uniform ids (the model's i.i.d.-assignment assumption)
        ids = rng.choice(n, size=batch, replace=False)
        pir.cache = {}  # keep every round a real protocol round
        out = pir.query([int(i) for i in ids], retries=0)
        for r, idx in enumerate(ids):
            if np.array_equal(out[r], raw[idx]):
                served += 1

    measured = served / (batches * batch)
    model = expected_success_rate(
        batch, c.partition_num, batch // c.partition_num, 20)
    # ~3200 Bernoulli samples at p~0.73: 5 sigma ~ 0.04
    assert abs(measured - model) < 0.05, (measured, model)


def test_expected_success_rate_edges():
    """Degenerate shapes of the analytic model: P=1 (the binomial pmf
    recursion would hit 0*inf) is exact min(q,B)/B; q >= B serves all."""
    import math

    from pacmann.pir.params import expected_success_rate

    v = expected_success_rate(10, 1, 3, 8)
    assert not math.isnan(v)
    assert abs(v - 0.3 * (1 - 2.0**-8)) < 1e-12
    assert abs(expected_success_rate(4, 1, 8, 30) - 1.0) < 1e-6
    assert expected_success_rate(0, 16, 2, 8) == 1.0
