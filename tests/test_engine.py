"""Fused batch-PIR engine: same protocol contracts as SimpleBatchPianoPIR
(TestBatchPIRBasic, /root/reference/pianopir/pir_test.go:60-202) with one
fused device scan per batch/prep."""

import numpy as np

from pacmann.pir.engine import FusedBatchPianoPIR


def _mk(rng, n=8192, entry_bytes=32, batch=32, fail=20):
    raw = rng.integers(0, 2**32, size=(n, entry_bytes // 4), dtype=np.uint32)
    pir = FusedBatchPianoPIR(n, entry_bytes, batch, raw, fail, device=False)
    pir.preprocessing(rng=np.random.default_rng(100))
    return raw, pir


def test_fused_spread_queries_exact():
    rng = np.random.default_rng(30)
    raw, pir = _mk(rng)
    c = pir.config
    ids = [int(i * c.partition_size + rng.integers(0, c.partition_size))
           for i in range(c.partition_num)] * 2
    out = pir.query(ids)
    for r, idx in enumerate(ids):
        assert np.array_equal(out[r], raw[idx]), f"row {r} idx {idx}"


def test_fused_overflow_dropped_to_zeros():
    rng = np.random.default_rng(31)
    raw, pir = _mk(rng)
    c = pir.config
    ids = list(range(32))  # all in partition 0, distinct
    out = pir.query(ids)
    answered = 32 // c.partition_num
    for r in range(answered):
        assert np.array_equal(out[r], raw[ids[r]])
    for r in range(answered, 32):
        assert np.all(out[r] == 0)


def test_fused_nondivisible_db_padding():
    """Non-divisible n: the fused engine zero-pads the last partition."""
    rng = np.random.default_rng(32)
    n = 8000  # 8000 / 16 = 500 per partition
    raw, pir = _mk(rng, n=n)
    c = pir.config
    ids = [int(i * c.partition_size + rng.integers(0, min(
        c.partition_size, n - i * c.partition_size)))
        for i in range(c.partition_num)]
    out = pir.query(ids)
    for r, idx in enumerate(ids):
        assert np.array_equal(out[r], raw[idx]), f"row {r} idx {idx}"


def test_fused_budget_reprep():
    rng = np.random.default_rng(33)
    n, batch = 2048, 32
    raw = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    pir = FusedBatchPianoPIR(n, 32, batch, raw, 20, device=False)
    pir.preprocessing(rng=np.random.default_rng(101))
    max_q = pir.params.max_query_num
    ok = 0
    rounds = max_q
    for _ in range(rounds):
        ids = [int(rng.integers(0, n)) for _ in range(batch)]
        out = pir.query(ids)
        for r, idx in enumerate(ids):
            if np.array_equal(out[r], raw[idx]):
                ok += 1
    # same ~73% bound as the lossy FCFS contract (see test_batch_pir)
    assert ok > rounds * batch * 0.65


def test_fused_matches_simple_interface():
    """Cost accessors agree with the per-partition implementation."""
    from pacmann.pir.batch import SimpleBatchPianoPIR

    rng = np.random.default_rng(34)
    n, eb, batch = 8192, 32, 32
    raw = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    fused = FusedBatchPianoPIR(n, eb, batch, raw, 20, device=False)
    simple = SimpleBatchPianoPIR(n, eb, batch, raw, 20, device=False)
    fused.preprocessing(rng=np.random.default_rng(1))
    simple.preprocessing(rng=np.random.default_rng(1))
    assert fused.local_storage_size() == simple.local_storage_size()
    assert fused.comm_cost_per_batch_online() == simple.comm_cost_per_batch_online()
    assert fused.support_batch_num == simple.support_batch_num
    assert fused.comm_cost_per_batch_offline == simple.comm_cost_per_batch_offline
