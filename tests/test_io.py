"""Loader/saver roundtrips — port of loader_test.go's format contracts
(/root/reference/graphann/loader_test.go:85-126 graph roundtrip; bvecs
header/value semantics of :9-83 exercised on synthetic files)."""

import struct

import numpy as np
import pytest

from pacmann.io import loaders


def _write_vecs(path, mat, fmt):
    with open(path, "wb") as f:
        for row in mat:
            f.write(struct.pack("<i", len(row)))
            if fmt == "b":
                f.write(bytes(int(x) for x in row))
            elif fmt == "f":
                f.write(struct.pack(f"<{len(row)}f", *row))
            else:
                f.write(struct.pack(f"<{len(row)}i", *row))


def test_bvecs_load(tmp_path):
    rng = np.random.default_rng(0)
    mat = rng.integers(0, 256, size=(10, 16))
    p = str(tmp_path / "x.bvecs")
    _write_vecs(p, mat, "b")
    out = loaders.load_bvecs(p, 10, 16)
    assert out.dtype == np.float32
    assert np.array_equal(out, mat.astype(np.float32))


def test_fvecs_load(tmp_path):
    rng = np.random.default_rng(1)
    mat = rng.random((7, 24)).astype(np.float32)
    p = str(tmp_path / "x.fvecs")
    _write_vecs(p, mat, "f")
    out = loaders.load_float32_matrix(p, 7, 24)
    assert np.array_equal(out, mat)


def test_ivecs_load(tmp_path):
    rng = np.random.default_rng(2)
    mat = rng.integers(0, 10000, size=(5, 10)).astype(np.int32)
    p = str(tmp_path / "x.ivecs")
    _write_vecs(p, mat, "i")
    out = loaders.load_int_matrix(p, 5, 10)
    assert np.array_equal(out, mat)


def test_dim_header_mismatch_raises(tmp_path):
    mat = np.zeros((3, 8), np.float32)
    p = str(tmp_path / "x.fvecs")
    _write_vecs(p, mat, "f")
    with pytest.raises(ValueError):
        loaders.load_fvecs(p, 3, 16)


@pytest.mark.parametrize("ext", [".npy", ".txt"])
def test_graph_save_load_roundtrip(tmp_path, ext):
    """loader_test.go:85-126."""
    rng = np.random.default_rng(3)
    graph = rng.integers(0, 1000, size=(50, 8)).astype(np.int32)
    p = str(tmp_path / ("g" + ext))
    loaders.save_int_matrix(p, graph)
    out = loaders.load_int_matrix(p, 50, 8)
    assert np.array_equal(out, graph)


def test_txt_float_matrix(tmp_path):
    rng = np.random.default_rng(4)
    mat = rng.random((6, 4)).astype(np.float32)
    p = str(tmp_path / "v.txt")
    with open(p, "w") as f:
        for row in mat:
            f.write(" ".join(f"{x:.8g}" for x in row) + "\n")
    out = loaders.load_float32_matrix(p, 6, 4)
    assert np.allclose(out, mat, atol=1e-6)
