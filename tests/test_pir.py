"""PianoPIR protocol correctness — port of the reference's TestPIRBasic
(/root/reference/pianopir/pir_test.go:9-58): run the FULL MaxQueryNum budget
of random queries against a random DB and require exact equality, exercising
hint consumption, programming, replacement use, and refresh. Sizes are scaled
down from the Go test (18750 entries) to keep the CPU suite fast; parameter
derivation is size-generic so this covers the same code paths.
"""

import numpy as np
import pytest

from pacmann.pir.params import derive_piano_params
from pacmann.pir.piano import PianoPIR, QueryError


def _rand_db(rng, n, entry_u32):
    return rng.integers(0, 2**32, size=(n, entry_u32), dtype=np.uint32)


def test_params_sift1m_partition():
    """Parameter derivation parity on the canonical SIFT1M partition
    (n=62500, 640B entries, failLog2=8) — values hand-derived from
    pir.go:479-505,124-142."""
    p = derive_piano_params(62500, 640, 8)
    assert p.chunk_size == 512          # next pow2 >= 2*sqrt(62500)=500
    assert p.set_size == 124            # ceil(62500/512)=123 -> x4 -> 124
    assert p.max_query_num == int(np.sqrt(62500) * np.log(62500))  # 2760
    assert p.primary_hint_num == 3584   # ceil(ln2*9)=7 * 512
    assert p.max_query_per_chunk == 72  # 3*int(2760/124)=66 -> x8 -> 72

    # storage model spot check vs the reference formula
    assert p.local_storage_bytes() == (
        3584 * (8 + 640 + 8) + 124 * 72 * (8 + 640 + 8 + 640)
    )


def test_pir_full_budget_exact():
    rng = np.random.default_rng(7)
    n, entry_bytes = 4096, 32
    raw = _rand_db(rng, n, entry_bytes // 4)
    pir = PianoPIR(n, entry_bytes, raw, failure_prob_log2=40)
    pir.preprocessing(rng=np.random.default_rng(8))

    p = pir.params
    fails = 0
    for _ in range(p.max_query_num):
        idx = int(rng.integers(0, n))
        try:
            got = pir.query(idx)
        except QueryError:
            fails += 1
            continue
        assert np.array_equal(got, raw[idx]), f"mismatch at idx {idx}"
    # failLog2=40 -> essentially no failures
    assert fails == 0


def test_pir_repeated_idx_uses_cache():
    rng = np.random.default_rng(9)
    n, entry_bytes = 1024, 32
    raw = _rand_db(rng, n, entry_bytes // 4)
    pir = PianoPIR(n, entry_bytes, raw, failure_prob_log2=20)
    pir.preprocessing(rng=np.random.default_rng(10))
    idx = 123
    a = pir.query(idx)
    consumed = pir.client.state.finished
    b = pir.query(idx)  # cache hit: no budget consumed (pir.go:381-383)
    assert np.array_equal(a, b)
    assert pir.client.state.finished == consumed
    assert np.array_equal(a, raw[idx])


def test_pir_auto_reprep_after_exhaustion():
    rng = np.random.default_rng(11)
    n, entry_bytes = 1024, 32
    raw = _rand_db(rng, n, entry_bytes // 4)
    pir = PianoPIR(n, entry_bytes, raw, failure_prob_log2=20)
    pir.preprocessing(rng=np.random.default_rng(12))
    p = pir.params
    seen = 0
    # run 1.5x the budget; wrapper must re-prep transparently (pir.go:525-533)
    for i in range(int(p.max_query_num * 3 // 2)):
        idx = int(rng.integers(0, n))
        try:
            got = pir.query(idx)
            assert np.array_equal(got, raw[idx])
            seen += 1
        except QueryError:
            pass
    assert seen > p.max_query_num  # survived a refresh


def test_pir_out_of_range_raises():
    rng = np.random.default_rng(13)
    raw = _rand_db(rng, 256, 8)
    pir = PianoPIR(256, 32, raw, failure_prob_log2=20)
    pir.preprocessing(rng=np.random.default_rng(14))
    with pytest.raises(QueryError):
        pir.client.query(999999, pir.server)


def test_dummy_query_touches_server_only():
    rng = np.random.default_rng(15)
    raw = _rand_db(rng, 256, 8)
    pir = PianoPIR(256, 32, raw, failure_prob_log2=20)
    pir.preprocessing(rng=np.random.default_rng(16))
    before = pir.client.state.finished
    out = pir.query(0, real=False)
    assert np.all(out == 0)
    assert pir.client.state.finished == before
