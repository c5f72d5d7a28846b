"""Bit-level packing utilities for bitsliced kernels.

`transpose32` is the lane<->bitplane shuffle: a (..., 32)-word block is viewed
as a 32x32 bit matrix (row = word, column = bit position) and transposed with
5 masked-swap passes (Hacker's Delight 7-3), all as u32 vector ops — this is
how N independent PRF evaluations become 32-wide bit planes of u32 words.
"""

import jax.numpy as jnp
import numpy as np

_SWAPS = (
    (16, 0x0000FFFF),
    (8, 0x00FF00FF),
    (4, 0x0F0F0F0F),
    (2, 0x33333333),
    (1, 0x55555555),
)


def transpose32(a):
    """Transpose 32x32 bit blocks. a: (..., 32) uint32 -> (..., 32) uint32.

    Output word p holds, at bit i, the p-th bit of input word i. Involution.
    """
    for j, mask in _SWAPS:
        sh = a.shape[:-1]
        b = a.reshape(sh + (32 // (2 * j), 2, j))
        lo = b[..., 0, :]
        hi = b[..., 1, :]
        t = (lo >> j ^ hi) & jnp.uint32(mask)
        lo = lo ^ (t << j)
        hi = hi ^ t
        a = jnp.stack([lo, hi], axis=-2).reshape(sh + (32,))
    return a


def transpose32_np(a: np.ndarray) -> np.ndarray:
    """NumPy twin of transpose32 (host-side tests / reference)."""
    a = a.astype(np.uint32)
    for j, mask in _SWAPS:
        sh = a.shape[:-1]
        b = a.reshape(sh + (32 // (2 * j), 2, j))
        lo = b[..., 0, :].copy()
        hi = b[..., 1, :].copy()
        t = ((lo >> j) ^ hi) & np.uint32(mask)
        lo ^= t << j
        hi ^= t
        a = np.stack([lo, hi], axis=-2).reshape(sh + (32,))
    return a
