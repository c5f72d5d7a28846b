"""XOR parity scans over the chunk-major PIR database.

Plain-XLA equivalent of the reference's two XOR hot loops:
  - online server scan: PrivateQuery XORs one PRF-selected entry per chunk
    (/root/reference/pianopir/pir.go:65-88) via AVX `xorSlices`
    (aes_amd64.s:133-157);
  - offline hint generation: every chunk is XORed into every primary/backup
    hint parity at its PRF offset (pir.go:303-352).

Both are the same computation — out[b] = XOR_s db[s, offsets[b, s]] with an
optional per-(b, s) skip mask — so one family of row-gather + XOR-reduce
forms serves both.

Shapes (see pir/layout.py): db (S, C*k, 128); offsets (B, S) u32 in [0, C);
skip (B, S) bool; out (B, k, 128) u32.
"""

import functools

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# lax.scan over chunks: one row gather per chunk, XOR into a resident
# accumulator.


@functools.partial(jax.jit, static_argnames=("k",))
def xor_scan_xla(db, offsets, skip, k: int):
    """out[b] = XOR_s (skip[b,s] ? 0 : db[s, offsets[b,s]*k : +k, :])."""
    B, S = offsets.shape

    def body(acc, inp):
        chunk, off_s, skip_s = inp
        rows = (off_s[:, None] * k + jnp.arange(k, dtype=jnp.uint32)).reshape(-1)
        g = jnp.take(chunk, rows.astype(jnp.int32), axis=0).reshape(B, k, 128)
        g = jnp.where(skip_s[:, None, None], jnp.uint32(0), g)
        return acc ^ g, None

    acc0 = jnp.zeros((B, k, 128), jnp.uint32)
    acc, _ = jax.lax.scan(body, acc0, (db, offsets.T, skip.T))
    return acc


def xor_scan_np(db, offsets, skip, k: int):
    """NumPy twin for tests. Same shapes/semantics as xor_scan_xla."""
    import numpy as np

    B, S = offsets.shape
    acc = np.zeros((B, k, 128), np.uint32)
    for s in range(S):
        rows = offsets[:, s].astype(np.int64)[:, None] * k + np.arange(k)
        g = db[s][rows.reshape(-1)].reshape(B, k, 128).copy()
        g[skip[:, s]] = 0
        acc ^= g
    return acc


@functools.partial(jax.jit, static_argnames=("k",))
def xor_gather_xla(db, offsets, skip, k: int):
    """Flat-gather XOR: materialize all (B, S, k) selected rows in one gather
    and XOR-reduce over chunks. Best for SMALL batches (online queries):
    one shallow op instead of an S-step scan. Memory = B*S*k*512 bytes.
    Same contract as xor_scan_xla."""
    B, S = offsets.shape
    CK = db.shape[1]
    flat = db.reshape(S * CK, 128)
    rows = (
        jnp.arange(S, dtype=jnp.int32)[None, :, None] * CK
        + offsets.astype(jnp.int32)[:, :, None] * k
        + jnp.arange(k, dtype=jnp.int32)[None, None, :]
    )
    g = jnp.take(flat, rows.reshape(-1), axis=0).reshape(B, S, k, 128)
    g = jnp.where(skip[:, :, None, None], jnp.uint32(0), g)
    return jax.lax.reduce(g, jnp.uint32(0), jax.lax.bitwise_xor, (1,))


@functools.partial(jax.jit, static_argnames=("k",))
def xor_gather_parts(db4, offsets, k: int):
    """Partition-major flat-gather XOR: db4 (S, P, C*k, 128) u32, offsets
    (P, S) u32 — ONE sub-query per partition. Returns (P, k, 128).
    This is the per-round server scan of the partition-sharded engine; with
    db4 sharded on its partition axis, it runs with zero collectives."""
    P, S = offsets.shape
    rows = (offsets.T.astype(jnp.int32)[:, :, None] * k
            + jnp.arange(k, dtype=jnp.int32)[None, None, :])   # (S, P, k)
    g = jnp.take_along_axis(db4, rows[..., None], axis=2)       # (S, P, k, 128)
    return jax.lax.reduce(g, jnp.uint32(0), jax.lax.bitwise_xor, (0,))


@functools.partial(jax.jit, static_argnames=("k",))
def xor_gather_multi(db4, offsets, k: int):
    """Partition-major flat-gather XOR for Q sub-queries per partition:
    db4 (S, P, C*k, 128), offsets (Q, P, S) u32 -> (Q, P, k, 128).
    One gather + XOR-reduce; working set Q*P*S*k*512 bytes."""
    Q, P, S = offsets.shape
    rows = (jnp.transpose(offsets, (2, 1, 0)).astype(jnp.int32)[:, :, :, None]
            * k + jnp.arange(k, dtype=jnp.int32))        # (S, P, Q, k)
    g = jnp.take_along_axis(
        db4, rows.reshape(S, P, Q * k)[..., None], axis=2)  # (S, P, Q*k, 128)
    g = g.reshape(S, P, Q, k, 128)
    red = jax.lax.reduce(g, jnp.uint32(0), jax.lax.bitwise_xor, (0,))
    return jnp.moveaxis(red, 0, 1)                        # (Q, P, k, 128)


@functools.partial(jax.jit, static_argnames=("k", "chunks_per_step"))
def xor_scan_parts(db4, offsets, skip, k: int, chunks_per_step: int = 1):
    """Partition-major chunk-streaming XOR scan (hint generation):
    db4 (S, P, C*k, 128); offsets (P, B, S) u32; skip (P, B, S) bool.
    Returns (P, B, k, 128). Each scan step gathers from `chunks_per_step`
    chunks of every partition (which must divide S), XOR-reduces them and
    folds the result into the accumulator, so the accumulator is read and
    written S / chunks_per_step times."""
    P, B, S = offsets.shape
    cps = chunks_per_step
    if S % cps:
        raise ValueError(f"chunks_per_step={cps} must divide S={S}")

    def body(acc, inp):
        chunk, off_s, skip_s = inp     # (cps, P, C*k, 128), (cps, P, B) x2
        rows = (off_s.astype(jnp.int32)[..., None] * k
                + jnp.arange(k, dtype=jnp.int32))        # (cps, P, B, k)
        g = jnp.take_along_axis(chunk, rows.reshape(cps, P, B * k)[..., None],
                                axis=2).reshape(cps, P, B, k, 128)
        g = jnp.where(skip_s[..., None, None], jnp.uint32(0), g)
        return acc ^ jax.lax.reduce(g, jnp.uint32(0), jax.lax.bitwise_xor,
                                    (0,)), None

    def steps(x):                      # (S, ...) -> (S/cps, cps, ...)
        return x.reshape((S // cps, cps) + x.shape[1:])

    acc0 = jnp.zeros((P, B, k, 128), jnp.uint32)
    acc, _ = jax.lax.scan(
        body, acc0,
        (steps(db4), steps(jnp.moveaxis(offsets, 2, 0)),
         steps(jnp.moveaxis(skip, 2, 0))))
    return acc


def xor_scan_host(db, offsets, skip, k: int):
    """Host-tier scan: native AVX2 kernel when built, NumPy otherwise."""
    from pacmann import native_lib

    if native_lib.available():
        return native_lib.xor_scan(db, offsets, skip, k)
    return xor_scan_np(db, offsets, skip, k)
