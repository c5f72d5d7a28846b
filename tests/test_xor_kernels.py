"""XOR kernel family vs the NumPy oracle: chunk-streaming scan, flat
gather, and the partition-major variants used by the device engines."""

import numpy as np
import pytest

from pacmann.ops.xor_scan import (
    xor_gather_multi,
    xor_gather_parts,
    xor_gather_xla,
    xor_scan_np,
    xor_scan_parts,
    xor_scan_xla,
)


def _mk(rng, S=8, C=16, k=2):
    return rng.integers(0, 2**32, size=(S, C * k, 128), dtype=np.uint32)


def test_gather_matches_scan():
    rng = np.random.default_rng(0)
    db = _mk(rng)
    off = rng.integers(0, 16, size=(12, 8), dtype=np.uint32)
    skip = rng.random((12, 8)) < 0.3
    a = np.asarray(xor_scan_xla(db, off, skip, 2))
    b = np.asarray(xor_gather_xla(db, off, skip, 2))
    c = xor_scan_np(db, off, skip, 2)
    assert np.array_equal(a, c) and np.array_equal(b, c)


def test_parts_kernels_match_oracle():
    rng = np.random.default_rng(1)
    S, P, C, k = 8, 4, 16, 2
    db4 = rng.integers(0, 2**32, size=(S, P, C * k, 128), dtype=np.uint32)

    # single sub-query per partition
    off1 = rng.integers(0, C, size=(P, S), dtype=np.uint32)
    got1 = np.asarray(xor_gather_parts(db4, off1, k))
    for p in range(P):
        want = xor_scan_np(db4[:, p], off1[p][None], np.zeros((1, S), bool), k)[0]
        assert np.array_equal(got1[p], want), p

    # Q sub-queries per partition
    Q = 5
    offq = rng.integers(0, C, size=(Q, P, S), dtype=np.uint32)
    gotq = np.asarray(xor_gather_multi(db4, offq, k))
    for q in range(Q):
        for p in range(P):
            want = xor_scan_np(
                db4[:, p], offq[q, p][None], np.zeros((1, S), bool), k)[0]
            assert np.array_equal(gotq[q, p], want), (q, p)

    # hint-gen scan with skip masks
    B = 7
    offb = rng.integers(0, C, size=(P, B, S), dtype=np.uint32)
    skipb = rng.random((P, B, S)) < 0.25
    gotb = np.asarray(xor_scan_parts(db4, offb, skipb, k))
    for p in range(P):
        want = xor_scan_np(db4[:, p], offb[p], skipb[p], k)
        assert np.array_equal(gotb[p], want), p


@pytest.mark.parametrize("S,P,C,k,T", [
    (4, 2, 8, 2, 19),      # k > 1 entry rows, odd hint count
    (8, 1, 16, 1, 260),    # single partition, one row per entry
    (5, 3, 16, 3, 33),     # three rows per entry, odd chunk count
    (1, 2, 4, 2, 1),       # one chunk, one hint
])
@pytest.mark.parametrize("skip_p", [0.0, 0.3, 1.0])
def test_hint_scan_matches_oracle(S, P, C, k, T, skip_p):
    """The hint scan the engines run (device_engine._hint_scan, the
    lax.scan chunk stream) against the NumPy oracle, per partition, with
    skip masks from none to all."""
    from pacmann.pir.device_engine import _hint_scan

    rng = np.random.default_rng(S * 100 + T)
    db4 = rng.integers(0, 2**32, size=(S, P, C * k, 128), dtype=np.uint32)
    table = rng.integers(0, C, size=(P, T, S), dtype=np.uint32)
    skip = rng.random((P, T, S)) < skip_p
    got = np.asarray(_hint_scan(db4, table, skip, k))
    assert got.shape == (P, T, k * 128)
    for p in range(P):
        want = xor_scan_np(db4[:, p], table[p], skip[p], k)
        assert np.array_equal(got[p], want.reshape(T, k * 128)), p


@pytest.mark.parametrize("Q,P,S,C,k", [(1, 16, 7, 32, 2), (6, 4, 5, 8, 1),
                                       (13, 2, 3, 64, 3)])
def test_server_scan_matches_oracle(Q, P, S, C, k):
    """The online server scan (xor_gather_multi: one gather + XOR-reduce
    over chunks for Q sub-queries per partition) against the oracle."""
    rng = np.random.default_rng(Q + P + S)
    db4 = rng.integers(0, 2**32, size=(S, P, C * k, 128), dtype=np.uint32)
    qs = rng.integers(0, C, size=(Q, P, S), dtype=np.uint32)
    got = np.asarray(xor_gather_multi(db4, qs, k))
    for q in range(Q):
        for p in range(P):
            want = xor_scan_np(db4[:, p], qs[q, p][None],
                               np.zeros((1, S), bool), k)[0]
            assert np.array_equal(got[q, p], want), (q, p)


@pytest.mark.parametrize("chunks_per_step", [1, 2, 4, 8])
def test_scan_parts_chunk_blocking(chunks_per_step):
    """xor_scan_parts folding several chunks per scan step is the same XOR
    as one chunk per step (XOR is order-free)."""
    rng = np.random.default_rng(17)
    S, P, C, k, B = 8, 3, 16, 2, 21
    db4 = rng.integers(0, 2**32, size=(S, P, C * k, 128), dtype=np.uint32)
    off = rng.integers(0, C, size=(P, B, S), dtype=np.uint32)
    skip = rng.random((P, B, S)) < 0.3
    got = np.asarray(xor_scan_parts(db4, off, skip, k,
                                    chunks_per_step=chunks_per_step))
    for p in range(P):
        assert np.array_equal(got[p], xor_scan_np(db4[:, p], off[p],
                                                  skip[p], k)), p
    with pytest.raises(ValueError, match="must divide"):
        xor_scan_parts(db4, off, skip, k, chunks_per_step=3)
