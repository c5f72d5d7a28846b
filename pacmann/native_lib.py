"""ctypes loader for the native host-tier kernels (native/pacmann_native.cpp).

Auto-builds the shared library with `make -C native` on first use when a
compiler is available; every wrapper has a documented NumPy fallback used by
callers when the library is missing, so the package works without a native
toolchain. The kernels cover the same hot spots as the reference's assembly
(pianopir/aes_amd64.s, graphann/l2_distance_amd64.s) — but only for the host
tier; device-resident compute lives in pacmann.ops.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libpacmann_native.so")

_lib = None
_load_failed = False


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR],
            check=True, capture_output=True, timeout=120,
        )
        return os.path.exists(_SO_PATH)
    except Exception:
        return False


def _stale() -> bool:
    """True when the source is newer than the built library."""
    src = os.path.join(_NATIVE_DIR, "pacmann_native.cpp")
    try:
        return os.path.getmtime(src) > os.path.getmtime(_SO_PATH)
    except OSError:
        return True


def load():
    """Return the ctypes library or None (after one build attempt)."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if (not os.path.exists(_SO_PATH) or _stale()) and not _build():
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        _load_failed = True
        return None

    # Refuse CPUs without AES-NI/AVX2/FMA: the kernels would SIGILL.
    try:
        lib.pacmann_cpu_supported.restype = ctypes.c_int
        if not lib.pacmann_cpu_supported():
            _load_failed = True
            return None
    except AttributeError:  # stale library predating the probe
        _load_failed = True
        return None

    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64

    lib.pacmann_expand_key.argtypes = [u8p, u8p]
    lib.pacmann_prf_eval_u64.argtypes = [u8p, u64p, u64p, u64p, i64]
    lib.pacmann_prf_offset_table.argtypes = [
        u8p, ctypes.c_uint64, i64, i64, ctypes.c_uint32, u32p]
    lib.pacmann_xor_scan.argtypes = [u32p, u32p, u8p, u32p, i64, i64, i64, i64]
    lib.pacmann_l2_batch.argtypes = [f32p, f32p, f32p, i64, i64, i64]
    lib.pacmann_inner_product_u32.argtypes = [u32p, u32p, u32p, i64, i64, i64]
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


# ---------------------------------------------------------------------------
# Wrappers (raise RuntimeError when the library is missing; callers that have
# a NumPy fallback check available() first).


def _require():
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def expand_key(key: bytes) -> np.ndarray:
    lib = _require()
    rk = np.empty(176, np.uint8)
    lib.pacmann_expand_key(np.frombuffer(key, np.uint8), rk)
    return rk


def prf_eval_u64(rk176: np.ndarray, tags: np.ndarray, xs: np.ndarray) -> np.ndarray:
    lib = _require()
    tags = np.ascontiguousarray(tags, np.uint64)
    xs = np.ascontiguousarray(xs, np.uint64)
    tags, xs = np.broadcast_arrays(tags, xs)
    flat_t = np.ascontiguousarray(tags.reshape(-1))
    flat_x = np.ascontiguousarray(xs.reshape(-1))
    out = np.empty(flat_t.shape[0], np.uint64)
    lib.pacmann_prf_eval_u64(rk176, flat_t, flat_x, out, flat_t.shape[0])
    return out.reshape(tags.shape)


def prf_offset_table(rk176: np.ndarray, tag0: int, T: int, S: int,
                     mask: int) -> np.ndarray:
    """(T, S) u32: PRF(tag0+t, s) & mask — the hint-gen offset table."""
    lib = _require()
    out = np.empty((T, S), np.uint32)
    lib.pacmann_prf_offset_table(rk176, tag0, T, S, mask, out)
    return out


def xor_scan(db: np.ndarray, offsets: np.ndarray, skip: np.ndarray,
             k: int) -> np.ndarray:
    """Same contract as ops.xor_scan.xor_scan_np: db (S, CK, 128) u32,
    offsets/skip (B, S) -> (B, k, 128) u32."""
    lib = _require()
    B, S = offsets.shape
    db = np.ascontiguousarray(db, np.uint32)
    offsets = np.ascontiguousarray(offsets, np.uint32)
    skip8 = np.ascontiguousarray(skip, np.uint8)
    out = np.empty((B, k * 128), np.uint32)
    lib.pacmann_xor_scan(db, offsets, skip8, out, B, S, db.shape[1], k)
    return out.reshape(B, k, 128)


def l2_batch(queries: np.ndarray, points: np.ndarray) -> np.ndarray:
    lib = _require()
    queries = np.ascontiguousarray(queries, np.float32)
    points = np.ascontiguousarray(points, np.float32)
    out = np.empty((queries.shape[0], points.shape[0]), np.float32)
    lib.pacmann_l2_batch(queries, points, out,
                         queries.shape[0], points.shape[0], queries.shape[1])
    return out


def inner_product_u32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _require()
    a = np.ascontiguousarray(a, np.uint32)
    b = np.ascontiguousarray(b, np.uint32)
    out = np.empty((a.shape[0], b.shape[0]), np.uint32)
    lib.pacmann_inner_product_u32(a, b, out, a.shape[0], b.shape[0], a.shape[1])
    return out
