"""GF(2^8) host-side machinery for the bitsliced AES circuit.

The bitsliced S-box (ops/aes.py) computes x^254 = x^{-1} in GF(2^8) via an
addition chain whose squarings and final affine map are *linear over GF(2)*.
This module derives those 8x8 (and 8x15) bit-matrices programmatically from
the field definition, so the circuit is correct by construction; the FIPS-197
test vectors in tests/test_aes.py validate the whole pipeline.

Reference equivalence: the Go reference evaluates its PRF with AES-NI assembly
(/root/reference/pianopir/aes_amd64.s:19-126); the device has no AES
instruction, so the S-box becomes a boolean circuit over u32 lanes.
"""

import numpy as np

AES_POLY = 0x11B  # x^8 + x^4 + x^3 + x + 1


def gf_mul(a: int, b: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        if a & 0x100:
            a ^= AES_POLY
        b >>= 1
    return r


def gf_pow(a: int, e: int) -> int:
    r = 1
    while e:
        if e & 1:
            r = gf_mul(r, a)
        a = gf_mul(a, a)
        e >>= 1
    return r


def _linear_matrix(fn) -> np.ndarray:
    """8x8 GF(2) matrix M (rows=out bit, cols=in bit) for a linear map fn."""
    m = np.zeros((8, 8), dtype=np.uint8)
    for i in range(8):
        y = fn(1 << i)
        for o in range(8):
            m[o, i] = (y >> o) & 1
    return m

# Squaring is linear over GF(2); collapse repeated squarings into one matrix.
SQ1 = _linear_matrix(lambda x: gf_pow(x, 2))    # x -> x^2
SQ2 = _linear_matrix(lambda x: gf_pow(x, 4))    # x -> x^4
SQ4 = _linear_matrix(lambda x: gf_pow(x, 16))   # x -> x^16


def _reduction_matrix() -> np.ndarray:
    """8x15 matrix folding carry-less product coefficients z_0..z_14 mod poly."""
    m = np.zeros((8, 15), dtype=np.uint8)
    for k in range(15):
        v = 1 << k
        # reduce x^k mod AES_POLY
        for bit in range(14, 7, -1):
            if v & (1 << bit):
                v ^= AES_POLY << (bit - 8)
        for o in range(8):
            m[o, k] = (v >> o) & 1
    return m

RED = _reduction_matrix()

# AES affine layer: s = A*x ^ 0x63 applied after inversion.
_AFFINE_C = 0x63


def _affine(x: int) -> int:
    y = 0
    for o in range(8):
        b = 0
        for t in (0, 4, 5, 6, 7):
            b ^= (x >> ((o + t) % 8)) & 1
        y |= b << o
    return y ^ _AFFINE_C

AFFINE_M = _linear_matrix(lambda x: _affine(x) ^ _AFFINE_C)
AFFINE_C_BITS = tuple((_AFFINE_C >> o) & 1 for o in range(8))


def sbox_table() -> np.ndarray:
    """The AES S-box derived from the field (no hardcoded table)."""
    t = np.zeros(256, dtype=np.uint8)
    for x in range(256):
        inv = gf_pow(x, 254) if x else 0
        t[x] = _affine(inv)
    return t

SBOX = sbox_table()


# ---------------------------------------------------------------------------
# Boyar-Peralta 113-gate S-box (top linear + shared nonlinear middle).
#
# The addition-chain S-box above costs ~670 gates per byte position (4
# carry-less multiplies); the Boyar-Peralta circuit (Boyar & Peralta 2010,
# "A new combinational logic minimization technique with applications to
# cryptology") does it in 32 ANDs + ~81 XORs by computing the GF(2^8)
# inversion in a tower-field basis. We transcribe only the public top-linear
# and middle-nonlinear sections; the bottom linear layer (z0..z17 -> output
# bits, including the 0x63 affine constant) is SOLVED over GF(2) at import
# time against the field-derived SBOX table — so a transcription error in
# the netlist makes the solve inconsistent and import raises, and the final
# layer is correct by construction.


def bp_middle(x):
    """Top-linear + middle-nonlinear sections of the Boyar-Peralta S-box.

    x: list of 8 bit planes, x[b] = bit b (LSB-first, the aes.py state
    order). Works on any objects supporting ^ and & (NumPy or JAX arrays).
    Returns the 18 shared products z0..z17.
    """
    # BP convention: U0 is the MSB.
    U0, U1, U2, U3, U4, U5, U6, U7 = x[::-1]
    y14 = U3 ^ U5
    y13 = U0 ^ U6
    y9 = U0 ^ U3
    y8 = U0 ^ U5
    t0 = U1 ^ U2
    y1 = t0 ^ U7
    y4 = y1 ^ U3
    y12 = y13 ^ y14
    y2 = y1 ^ U0
    y5 = y1 ^ U6
    y3 = y5 ^ y8
    t1 = U4 ^ y12
    y15 = t1 ^ U5
    y20 = t1 ^ U1
    y6 = y15 ^ U7
    y10 = y15 ^ t0
    y11 = y20 ^ y9
    y7 = U7 ^ y11
    y17 = y10 ^ y11
    y19 = y10 ^ y8
    y16 = t0 ^ y11
    y21 = y13 ^ y16
    y18 = U0 ^ y16

    t2 = y12 & y15
    t3 = y3 & y6
    t4 = t3 ^ t2
    t5 = y4 & U7
    t6 = t5 ^ t2
    t7 = y13 & y16
    t8 = y5 & y1
    t9 = t8 ^ t7
    t10 = y2 & y7
    t11 = t10 ^ t7
    t12 = y9 & y11
    t13 = y14 & y17
    t14 = t13 ^ t12
    t15 = y8 & y10
    t16 = t15 ^ t12
    t17 = t4 ^ t14
    t18 = t6 ^ t16
    t19 = t9 ^ t14
    t20 = t11 ^ t16
    t21 = t17 ^ y20
    t22 = t18 ^ y19
    t23 = t19 ^ y21
    t24 = t20 ^ y18
    t25 = t21 ^ t22
    t26 = t21 & t23
    t27 = t24 ^ t26
    t28 = t25 & t27
    t29 = t28 ^ t22
    t30 = t23 ^ t24
    t31 = t22 ^ t26
    t32 = t31 & t30
    t33 = t32 ^ t24
    t34 = t23 ^ t33
    t35 = t27 ^ t33
    t36 = t24 & t35
    t37 = t36 ^ t34
    t38 = t27 ^ t36
    t39 = t29 & t38
    t40 = t25 ^ t39
    t41 = t40 ^ t37
    t42 = t29 ^ t33
    t43 = t29 ^ t40
    t44 = t33 ^ t37
    t45 = t42 ^ t41
    return [
        t44 & y15, t37 & y6, t33 & U7, t43 & y16, t40 & y1, t29 & y7,
        t42 & y11, t45 & y17, t41 & y10, t44 & y12, t37 & y3, t33 & y4,
        t43 & y13, t40 & y5, t29 & y2, t42 & y9, t45 & y14, t41 & y8,
    ]


def _solve_gf2(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Solve A w = b over GF(2) (A: (n, m) u8, b: (n,) u8); raises if
    inconsistent. Returns one solution w (m,)."""
    A = A.copy() % 2
    b = b.copy() % 2
    n, m = A.shape
    piv_col_of_row = []
    row = 0
    for col in range(m):
        sel = None
        for r in range(row, n):
            if A[r, col]:
                sel = r
                break
        if sel is None:
            continue
        A[[row, sel]] = A[[sel, row]]
        b[[row, sel]] = b[[sel, row]]
        mask = A[:, col].astype(bool).copy()
        mask[row] = False
        A[mask] ^= A[row]
        b[mask] ^= b[row]
        piv_col_of_row.append(col)
        row += 1
    if np.any(b[row:]):
        raise ValueError("GF(2) system inconsistent")
    w = np.zeros(m, dtype=np.uint8)
    for r, col in enumerate(piv_col_of_row):
        w[col] = b[r]
    return w


def _derive_bp_bottom():
    """Solve the BP bottom linear layer from the field-derived SBOX.

    Returns (M, C): M (8, 18) u8 with out bit o = XOR_j M[o,j] z_j ^ C[o],
    in LSB-first bit order. Raises if the transcribed netlist is wrong."""
    xs = np.arange(256, dtype=np.uint8)
    planes = [((xs >> b) & 1).astype(np.uint8) for b in range(8)]
    Z = np.stack(bp_middle(planes), axis=1)          # (256, 18)
    aug = np.concatenate([Z, np.ones((256, 1), np.uint8)], axis=1)
    M = np.zeros((8, 18), dtype=np.uint8)
    C = np.zeros(8, dtype=np.uint8)
    for o in range(8):
        target = ((SBOX >> o) & 1).astype(np.uint8)
        w = _solve_gf2(aug, target)
        M[o] = w[:18]
        C[o] = w[18]
        # the solve is exact on all 256 rows by construction; assert anyway
        got = (Z @ M[o] + C[o]) % 2
        if not np.array_equal(got, target):
            raise ValueError("BP bottom layer verification failed")
    return M, C


BP_BOTTOM_M, BP_BOTTOM_C = _derive_bp_bottom()
