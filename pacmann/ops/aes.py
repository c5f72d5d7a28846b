"""Bitsliced AES-128 / AES-MMO PRF as plain u32 array ops (XLA).

The reference's AES-NI kernels (/root/reference/pianopir/aes_amd64.s:19-126,
util.go:147-165) are rebuilt as a table-free boolean circuit evaluated across
bit planes: N independent evaluations are packed 32-per-u32-word, the 128-bit
state becomes an (8 bits, 16 bytes, N/32 words) u32 tensor, and every AES
step is a short sequence of XOR/AND/permutation ops on (16, N/32) planes —
elementwise integer work that XLA fuses into a few loop kernels on the GPU.

The S-box is GF(2^8) inversion x^254 via the addition chain
x -> x^2 -> x^3 -> x^12 -> x^15 -> x^240 -> x^252 -> x^254 (4 bitsliced
carry-less multiplies); squarings and the affine layer are GF(2)-linear
matrices derived programmatically in ops/gf2.py. FIPS-197 vectors validate
the whole circuit (tests/test_aes.py).

PRF framing matches the reference exactly (util.go:157-165): input block =
LE64((tag<<35)+x) || 0^8; output = MMO lower bytes; offsets are always taken
mod a power-of-two ChunkSize <= 2^32, so the low-u32 extraction path is the
hot one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pacmann.ops import gf2
from pacmann.ops.aes_host import expand_key
from pacmann.ops.bitops import transpose32

# ---------------------------------------------------------------------------
# Host-side key material


def expand_key_planes(key: bytes) -> np.ndarray:
    """Round keys as broadcast masks: (11, 8, 16) u32, 0 or 0xFFFFFFFF."""
    rk = expand_key(key)  # (11, 16) u8
    bits = (rk[:, None, :] >> np.arange(8, dtype=np.uint8)[None, :, None]) & 1
    return (bits.astype(np.uint32) * np.uint32(0xFFFFFFFF)).astype(np.uint32)


# ---------------------------------------------------------------------------
# Bitsliced circuit pieces. State S: (8, 16, L) u32.


def _linear(m: np.ndarray, planes):
    """Apply a GF(2) matrix (rows=out bits) to a list of bit planes."""
    out = []
    for o in range(m.shape[0]):
        acc = None
        for i in range(m.shape[1]):
            if m[o, i]:
                acc = planes[i] if acc is None else acc ^ planes[i]
        if acc is None:
            acc = jnp.zeros_like(planes[0])
        out.append(acc)
    return out


def _gf_mul_planes(a, b):
    """Bitsliced GF(2^8) multiply of two 8-plane vectors."""
    z = [None] * 15
    for i in range(8):
        for j in range(8):
            t = a[i] & b[j]
            k = i + j
            z[k] = t if z[k] is None else z[k] ^ t
    return _linear(gf2.RED, z)


def _sbox_planes_chain(x):
    """Addition-chain S-box (x^254 via 4 carry-less multiplies). ~670 gates
    per byte position; kept as the independent correctness twin of the
    production Boyar-Peralta circuit below (tests/test_aes.py)."""
    t1 = _linear(gf2.SQ1, x)       # x^2
    t2 = _gf_mul_planes(t1, x)     # x^3
    t3 = _linear(gf2.SQ2, t2)      # x^12
    t4 = _gf_mul_planes(t3, t2)    # x^15
    t5 = _linear(gf2.SQ4, t4)      # x^240
    t6 = _gf_mul_planes(t5, t3)    # x^252
    t7 = _gf_mul_planes(t6, t1)    # x^254 = x^-1 (0 -> 0)
    y = _linear(gf2.AFFINE_M, t7)
    ones = jnp.uint32(0xFFFFFFFF)
    return [y[o] ^ ones if gf2.AFFINE_C_BITS[o] else y[o] for o in range(8)]


def _sbox_planes(x):
    """Boyar-Peralta S-box: 32 ANDs + ~150 XORs total (~4x fewer vector ops
    than the addition chain). Middle section transcribed from the public
    netlist; bottom linear layer solved over GF(2) at import (gf2.py)."""
    z = gf2.bp_middle(x)
    y = _linear(gf2.BP_BOTTOM_M, z)
    ones = jnp.uint32(0xFFFFFFFF)
    return [y[o] ^ ones if gf2.BP_BOTTOM_C[o] else y[o] for o in range(8)]


# Byte permutations (dest j takes source perm[j]).
_SHIFT_ROWS = np.array(
    [(r + 4 * ((c + r) % 4)) for c in range(4) for r in range(4)], dtype=np.int32
)
# Rotate rows within each column: dest byte (r, c) takes source ((r+k)%4, c).
def _col_rot(k):
    return np.array(
        [(((j % 4) + k) % 4 + 4 * (j // 4)) for j in range(16)], dtype=np.int32
    )

_ROT1, _ROT2, _ROT3 = _col_rot(1), _col_rot(2), _col_rot(3)


def _sub_bytes(S):
    planes = _sbox_planes([S[b] for b in range(8)])
    return jnp.stack(planes)


def _shift_rows(S):
    return S[:, _SHIFT_ROWS, :]


def _xtime(S):
    # y = 2*x in GF(2^8), per bit plane (taps of 0x1b at bits 0,1,3,4)
    return jnp.stack(
        [
            S[7],
            S[0] ^ S[7],
            S[1],
            S[2] ^ S[7],
            S[3] ^ S[7],
            S[4],
            S[5],
            S[6],
        ]
    )


def _mix_columns(S):
    XS = _xtime(S)
    # out_r = 2 a_r ^ 3 a_{r+1} ^ a_{r+2} ^ a_{r+3}  (rows mod 4, per column)
    return (
        XS
        ^ XS[:, _ROT1, :]
        ^ S[:, _ROT1, :]
        ^ S[:, _ROT2, :]
        ^ S[:, _ROT3, :]
    )


def _pack_words(words):
    """words: list of 4 (N,) u32 (LE block words) -> state (8, 16, L) u32."""
    parts = []
    for w in words:
        L = w.shape[0] // 32
        t = transpose32(w.reshape(L, 32))           # (L, 32); col p = bit p plane
        t = t.T.reshape(4, 8, -1)                   # [j, b] = col 8j+b
        parts.append(jnp.transpose(t, (1, 0, 2)))   # (8, 4, L)
    return jnp.concatenate(parts, axis=1)           # (8, 16, L)


def _unpack_word(S, word_idx):
    """Extract output word word_idx (bytes 4w..4w+3) -> (N,) u32."""
    blk = S[:, 4 * word_idx : 4 * word_idx + 4, :]   # (8, 4, L)
    arr = jnp.transpose(blk, (2, 1, 0)).reshape(-1, 32)  # col 8j+b
    return transpose32(arr).reshape(-1)


def _encrypt_state(key_masks, S):
    km = key_masks[:, :, :, None]
    S = S ^ km[0]
    for r in range(1, 10):
        S = _mix_columns(_shift_rows(_sub_bytes(S))) ^ km[r]
    return _shift_rows(_sub_bytes(S)) ^ km[10]


@jax.jit
def aes128_encrypt_words(key_masks, words):
    """Bitsliced AES-128. words: (4, N) u32 LE block words, N % 32 == 0."""
    S = _pack_words([words[i] for i in range(4)])
    S = _encrypt_state(key_masks, S)
    return jnp.stack([_unpack_word(S, i) for i in range(4)])


def _mmo_low32_body(key_masks, lo, hi):
    zeros = jnp.zeros_like(lo)
    S0 = _pack_words([lo, hi, zeros, zeros])
    S = _encrypt_state(key_masks, S0)
    S = S ^ S0  # Matyas-Meyer-Oseas feed-forward
    return _unpack_word(S, 0)


@functools.partial(jax.jit, static_argnames=())
def aes128_mmo_low32(key_masks, lo, hi):
    """PRF low-u32: MMO output bytes 0..3 (LE). lo/hi: (N,) u32, N % 32 == 0."""
    return _mmo_low32_body(key_masks, lo, hi)


def _mmo_low64_body(key_masks, lo, hi):
    zeros = jnp.zeros_like(lo)
    S0 = _pack_words([lo, hi, zeros, zeros])
    S = _encrypt_state(key_masks, S0) ^ S0
    return _unpack_word(S, 0), _unpack_word(S, 1)


aes128_mmo_low64 = jax.jit(_mmo_low64_body)


# ---------------------------------------------------------------------------
# Protocol-facing PRF helpers


def prf_input_words(tags, xs):
    """(tag<<35)+x as (lo, hi) u32 words; tag < 2^29, x < 2^32 so no carry.

    lo = x, hi = tag << 3  (bits 35.. of the u64 == bits 3.. of the high word).
    """
    tags = jnp.asarray(tags, dtype=jnp.uint32)
    xs = jnp.asarray(xs, dtype=jnp.uint32)
    return xs, tags << 3


# Fixed lane-block size: one compiled AES graph serves every call site.
PRF_BLOCK = 1 << 17


def prf_offset_table_host(key: bytes, T: int, S: int,
                          chunk_mask: int) -> np.ndarray:
    """Host offset table: offsets[t, s] = PRF(t, s) & mask, tags 0..T-1
    (the hint-table tag layout, pir.go:226-251) -> (T, S) u32 NumPy.

    The native AES-NI kernel when it is built, the NumPy AES otherwise.
    This is the "cpu" backend's table path and the oracle every device
    PRF program is checked against."""
    from pacmann import native_lib

    if native_lib.available():
        rk = native_lib.expand_key(key)
        return native_lib.prf_offset_table(rk, 0, T, S, chunk_mask)
    from pacmann.ops import aes_host

    rk = aes_host.expand_key(key)
    return (aes_host.prf_eval_u64(
        rk, np.arange(T, dtype=np.uint64)[:, None],
        np.arange(S, dtype=np.uint64)[None, :])
        & np.uint64(chunk_mask)).astype(np.uint32)


@functools.partial(jax.jit, static_argnames=("T", "S", "chunk_mask"))
def _prf_table_on_device(key_masks, T: int, S: int, chunk_mask: int):
    """One device program for the whole (T, S) table: the lane iota, PRF
    framing, bitsliced AES, and masking never touch the host. Only the
    2.8 KB key masks are transferred per call."""
    n = T * S
    pad = (n + 255) // 256 * 256  # transpose32 needs lanes % 32 == 0
    i = jax.lax.broadcasted_iota(jnp.uint32, (pad, 1), 0)[:, 0]
    tags = i // np.uint32(S)
    xs = i % np.uint32(S)
    out = _mmo_low32_body(key_masks, xs, tags << np.uint32(3))
    return (out[:n] & jnp.uint32(chunk_mask)).reshape(T, S)


@jax.jit
def prf_eval_fused(masks, tags, xs, chunk_mask):
    """Per-partition-keyed batched PRF: out[p, l] = PRF_p(tags[p,l],
    xs[p,l]) & chunk_mask, all partitions in ONE bitsliced program.

    The table-free client primitive (pir.go:404-427 evaluates the PRF
    online instead of storing the (T, S) offset table; this is that
    evaluation, batched): masks (P, 11, 8, 16) per-partition round-key
    planes, tags/xs (P, L) u32 with L % 32 == 0. The bitsliced circuit is
    plane-wise, so a partition axis rides along with per-partition key
    masks; packing 32 consecutive lanes per u32 keeps each
    partition's lanes in its own contiguous word rows, so the (8,16,P*L/32)
    state reshapes to (8,16,P,W) with no data movement. L is padded to a
    multiple of 32 internally (the bit-transpose packing granule)."""
    P, L0 = tags.shape
    L = -(-L0 // 32) * 32
    if L != L0:
        tags = jnp.pad(tags, ((0, 0), (0, L - L0)))
        xs = jnp.pad(xs, ((0, 0), (0, L - L0)))
    lo = xs.reshape(-1)
    hi = (tags << jnp.uint32(3)).reshape(-1)
    zeros = jnp.zeros_like(lo)
    S0 = _pack_words([lo, hi, zeros, zeros])        # (8, 16, P*L/32)
    W = L // 32
    S0 = S0.reshape(8, 16, P, W)
    km = jnp.transpose(masks, (1, 2, 3, 0))[:, :, :, :, None]  # (11,8,16,P,1)
    St = S0 ^ km[0]
    for r in range(1, 10):
        St = _mix_columns(_shift_rows(_sub_bytes(St))) ^ km[r]
    St = _shift_rows(_sub_bytes(St)) ^ km[10]
    St = St ^ S0                                     # MMO feed-forward
    blk = St[:, 0:4, :, :]                           # (8, 4, P, W)
    arr = jnp.transpose(blk, (2, 3, 1, 0)).reshape(-1, 32)
    out = transpose32(arr).reshape(P, L)[:, :L0]
    return out & jnp.uint32(chunk_mask)


@functools.partial(jax.jit, static_argnames=())
def _mmo_low32_block(key_masks, lo, hi):
    return _mmo_low32_body(key_masks, lo, hi)


def prf_offsets(key_masks, tags, xs, chunk_mask: int):
    """offset = PRF(longKey, tag, x) & (ChunkSize-1)  [pir.go:318, util.go:157].

    tags/xs: broadcastable u32 arrays; returns u32 array of the same shape.
    Flattens and evaluates bitsliced AES-MMO in fixed-size lane blocks.
    """
    # All slicing/padding happens host-side in NumPy: the only device work is
    # the fixed-shape jitted AES block (one compile serves every call).
    tags = np.asarray(tags, dtype=np.uint32)
    xs = np.asarray(xs, dtype=np.uint32)
    tags, xs = np.broadcast_arrays(tags, xs)
    shape = tags.shape
    n = int(np.prod(shape)) if shape else 1
    lo_full = np.ascontiguousarray(xs.reshape(-1))
    hi_full = np.ascontiguousarray(tags.reshape(-1)) << np.uint32(3)
    outs = []
    for start in range(0, n, PRF_BLOCK):
        m = min(PRF_BLOCK, n - start)
        lo = lo_full[start : start + m]
        hi = hi_full[start : start + m]
        if m < PRF_BLOCK:
            lo = np.pad(lo, (0, PRF_BLOCK - m))
            hi = np.pad(hi, (0, PRF_BLOCK - m))
        outs.append(np.asarray(_mmo_low32_block(key_masks, lo, hi))[:m])
    out = outs[0] if len(outs) == 1 else np.concatenate(outs)
    return (out[:n] & np.uint32(chunk_mask)).reshape(shape)
