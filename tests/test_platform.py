"""Backend routing, the compile-cache helper, and exact products under the
precision the graph build states."""

import numpy as np
import pytest

from pacmann.utils import platform


@pytest.mark.parametrize("name", ["cpu", "gpu"])
def test_backend_passes_supported(monkeypatch, name):
    monkeypatch.setattr(platform.jax, "default_backend", lambda: name)
    assert platform.backend() == name


@pytest.mark.parametrize("name", ["neuron", "METAL", "rocm"])
def test_backend_rejects_other_platforms(monkeypatch, name):
    monkeypatch.setattr(platform.jax, "default_backend", lambda: name)
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        platform.backend()


def test_backend_under_test_harness_is_cpu():
    assert platform.backend() == "cpu"


def _capture_config(monkeypatch):
    seen = {}
    monkeypatch.setattr(platform.jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    return seen


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    import os

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    seen = _capture_config(monkeypatch)
    path = platform.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert seen["jax_compilation_cache_dir"] == path


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    seen = _capture_config(monkeypatch)
    assert platform.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: no other directory is set in code
    assert "jax_compilation_cache_dir" not in seen


def test_gitignore_lists_the_cache_dir():
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lines = open(os.path.join(root, ".gitignore")).read().split()
    assert ".jax_cache/" in lines


@pytest.mark.parametrize("n,K,d,block", [(1000, 16, 128, 256),
                                         (777, 5, 33, 111),
                                         (4096, 64, 16, 4096)])
def test_lloyd_sums_exact(n, K, d, block):
    """The one-hot Lloyd sums (build._lloyd_sums) at the stated precision
    equal an exact integer sum: inputs are integers below 2^8 so every
    partial sum is representable in f32 — a TF32 or bf16 product would
    round the inputs and break equality."""
    import jax.numpy as jnp

    from pacmann.graph.build import _lloyd_sums

    rng = np.random.default_rng(n + K)
    npad = -(-n // block) * block
    vecs = rng.integers(0, 256, size=(npad, d)).astype(np.float32)
    vecs += 0.5 * (rng.random((npad, d)) < 0.5)   # halves need > 8 bits
    labels = rng.integers(0, K, size=npad).astype(np.int32)
    sums, cnts = _lloyd_sums(jnp.asarray(vecs), jnp.asarray(labels), K=K,
                             block=block, n_real=n)
    want = np.zeros((K, d), np.float64)
    np.add.at(want, labels[:n], vecs[:n].astype(np.float64))
    assert np.array_equal(np.asarray(sums, np.float64), want)
    assert np.array_equal(np.asarray(cnts),
                          np.bincount(labels[:n], minlength=K))


@pytest.mark.gpu
def test_gpu_prep_matches_host_oracle():
    """On the card, the device offline program (bitsliced AES tables, hint
    scan, replacement gathers) equals the host AES tables and the NumPy
    scan bit for bit."""
    from pacmann.ops import aes
    from pacmann.ops.xor_scan import xor_scan_np
    from pacmann.pir.device_engine import DevicePianoEngine

    rng = np.random.default_rng(5)
    n = 1 << 16
    raw = rng.integers(0, 2**32, size=(n, 40), dtype=np.uint32)
    eng = DevicePianoEngine(n, 160, 32, raw, 8)
    eng.preprocessing(rng=np.random.default_rng(1))
    p = eng.params
    keyrng = np.random.default_rng(1)
    keyrng.integers(0, 2**32, size=(eng.config.partition_num, p.set_size,
                                    p.max_query_per_chunk), dtype=np.uint64)
    key0 = keyrng.bytes(16)
    T = p.primary_hint_num + p.set_size * p.max_query_per_chunk
    want = aes.prf_offset_table_host(key0, T, p.set_size, p.chunk_mask)
    assert np.array_equal(np.asarray(eng.state["table"][0]), want)
    db0 = np.asarray(eng.db[:, 0])
    rows = np.arange(0, p.primary_hint_num, 97)
    par = xor_scan_np(db0, want[rows], np.zeros((len(rows), p.set_size),
                                                 bool), eng.k)
    got = np.asarray(eng.state["primary_parity"][0])[rows]
    assert np.array_equal(got, par.reshape(len(rows), -1))
