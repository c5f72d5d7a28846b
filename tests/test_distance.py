"""Distance kernel equivalence vs scalar reference — port of the reference's
TestDistance (/root/reference/graphann/graphann_test.go:15-58, 1000 random
trials, tol 1e-4) and TestInnerProduct correctness (:221-247)."""

import numpy as np

from pacmann.ops import distance


def _np_l2(a, b):
    d = a.astype(np.float32) - b.astype(np.float32)
    return np.sum(d * d, axis=-1)


def test_l2_xla_vs_scalar():
    rng = np.random.default_rng(0)
    q = rng.random((37, 128), dtype=np.float32)
    p = rng.random((211, 128), dtype=np.float32)
    got = np.asarray(distance.l2_distance_xla(q, p))
    want = _np_l2(q[:, None, :], p[None, :, :])
    assert np.allclose(got, want, rtol=1e-4, atol=1e-3)


def test_l2_odd_dim():
    rng = np.random.default_rng(1)
    q = rng.random((5, 37), dtype=np.float32)   # dim not a multiple of 8
    p = rng.random((9, 37), dtype=np.float32)
    got = np.asarray(distance.l2_distance_xla(q, p))
    want = _np_l2(q[:, None, :], p[None, :, :])
    assert np.allclose(got, want, rtol=1e-4, atol=1e-3)


def test_l2_public_entry_is_exact_f32():
    """l2_distance runs its product at HIGHEST precision: on integer-valued
    inputs every partial sum is exact in f32, so the result must equal the
    integer distance exactly (a TF32 product would round the cross term)."""
    rng = np.random.default_rng(2)
    q = rng.integers(0, 256, size=(17, 96)).astype(np.float32)
    p = rng.integers(0, 256, size=(300, 96)).astype(np.float32)
    got = np.asarray(distance.l2_distance(q, p))
    want = _np_l2(q[:, None, :].astype(np.int64), p[None, :, :].astype(np.int64))
    assert np.array_equal(got, want.astype(np.float32))


def test_inner_product_wraps_like_u32():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2**16, size=(8, 128), dtype=np.uint32)
    b = rng.integers(0, 2**16, size=(12, 128), dtype=np.uint32)
    got = np.asarray(distance.inner_product_xla(a, b)).astype(np.uint32)
    want = (
        np.einsum("qd,bd->qb", a.astype(np.uint64), b.astype(np.uint64))
        & np.uint64(0xFFFFFFFF)
    ).astype(np.uint32)
    assert np.array_equal(got, want)


def test_l2_single():
    rng = np.random.default_rng(4)
    a = rng.random(128, dtype=np.float32)
    b = rng.random(128, dtype=np.float32)
    got = float(distance.l2_distance_single(a, b))
    assert np.isclose(got, _np_l2(a, b), rtol=1e-5)
