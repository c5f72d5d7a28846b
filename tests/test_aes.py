"""AES-128 / MMO PRF correctness: FIPS-197 vectors + host/bitsliced agreement.

Mirrors the correctness half of the reference's TestAESPerf
(/root/reference/pianopir/pir_test.go:334-377); since our AES is a from-scratch
bitsliced circuit, we additionally pin it to the official FIPS-197 known-answer
test.
"""

import numpy as np
import pytest

from pacmann.ops import aes, aes_host, gf2
from pacmann.ops.bitops import transpose32_np


def test_sbox_known_values():
    # Spot values from FIPS-197 (S-box is derived, not hardcoded).
    assert gf2.SBOX[0x00] == 0x63
    assert gf2.SBOX[0x01] == 0x7C
    assert gf2.SBOX[0x53] == 0xED
    assert gf2.SBOX[0xFF] == 0x16


def test_fips197_host_encrypt():
    key = bytes(range(16))  # 000102...0f
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    ct = bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")
    rk = aes_host.expand_key(key)
    out = aes_host.aes128_encrypt(rk, np.frombuffer(pt, dtype=np.uint8))
    assert bytes(out.tobytes()) == ct


def test_fips197_bitsliced_encrypt():
    key = bytes(range(16))
    pt = np.frombuffer(
        bytes.fromhex("00112233445566778899aabbccddeeff"), dtype=np.uint8
    )
    ct = bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")
    km = aes.expand_key_planes(key)
    # replicate the same block across all 32 lanes
    words = np.zeros((4, 32), dtype=np.uint32)
    for i in range(4):
        words[i, :] = np.frombuffer(pt.tobytes(), dtype="<u4")[i]
    out = np.asarray(aes.aes128_encrypt_words(km, words))
    got = b"".join(int(out[i, 7]).to_bytes(4, "little") for i in range(4))
    assert got == ct
    # every lane identical
    for i in range(4):
        assert np.all(out[i] == out[i, 0])


def test_transpose_roundtrip_random():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2**32, size=(7, 32), dtype=np.uint32)
    assert np.array_equal(transpose32_np(transpose32_np(a)), a)


def test_bitsliced_vs_host_random_blocks():
    rng = np.random.default_rng(2)
    key = rng.bytes(16)
    n = 96
    blocks = rng.integers(0, 256, size=(n, 16), dtype=np.uint8)
    rk = aes_host.expand_key(key)
    want = aes_host.aes128_encrypt(rk, blocks)
    km = aes.expand_key_planes(key)
    words = np.ascontiguousarray(blocks).view("<u4").reshape(n, 4).T.copy()
    out = np.asarray(aes.aes128_encrypt_words(km, words))
    got = np.ascontiguousarray(out.T).astype("<u4").view(np.uint8).reshape(n, 16)
    assert np.array_equal(got, want)


def test_prf_mmo_low_words_match_host():
    rng = np.random.default_rng(3)
    key = rng.bytes(16)
    rk = aes_host.expand_key(key)
    km = aes.expand_key_planes(key)
    n = 64
    tags = rng.integers(0, 2**29, size=n, dtype=np.uint64)
    xs = rng.integers(0, 2**17, size=n, dtype=np.uint64)
    want = aes_host.prf_eval_u64(rk, tags, xs)
    lo, hi = aes.prf_input_words(tags.astype(np.uint32), xs.astype(np.uint32))
    glo, ghi = aes.aes128_mmo_low64(km, np.asarray(lo), np.asarray(hi))
    got = np.asarray(glo).astype(np.uint64) | (
        np.asarray(ghi).astype(np.uint64) << np.uint64(32)
    )
    assert np.array_equal(got, want)


def _host_table(key, T, S, mask):
    rk = aes_host.expand_key(key)
    return (aes_host.prf_eval_u64(
        rk, np.arange(T, dtype=np.uint64)[:, None],
        np.arange(S, dtype=np.uint64)[None, :])
        & np.uint64(mask)).astype(np.uint32)


def test_prf_table_on_device_matches_host():
    """The single-key table program (lax.map body of the engine's device
    tables) pinned to the host AES oracle on the CPU backend."""
    rng = np.random.default_rng(7)
    key = rng.bytes(16)
    km = aes.expand_key_planes(key)
    T, S, mask = 37, 12, 1023
    got = np.asarray(aes._prf_table_on_device(km, T, S, mask))
    assert np.array_equal(got, _host_table(key, T, S, mask))


@pytest.mark.parametrize("P,T,S,mask", [
    (1, 37, 12, 1023),
    (3, 21, 9, 255),
    (2, 64, 16, (1 << 16) - 1),
    (4, 5, 3, 1),
])
def test_device_prf_tables_match_host(P, T, S, mask):
    """The offline table program of the "gpu" backend
    (device_engine._prf_tables: the bitsliced circuit mapped over
    partitions) is bit-exact against the NumPy AES oracle, and so is the
    "cpu" backend's host table (native AES-NI when built)."""
    from pacmann.pir.device_engine import _prf_tables

    rng = np.random.default_rng(7 + P + T)
    keys = [rng.bytes(16) for _ in range(P)]
    masks = np.stack([aes.expand_key_planes(k) for k in keys])
    got = np.asarray(_prf_tables(masks, T=T, S=S, chunk_mask=mask))
    for p, key in enumerate(keys):
        want = _host_table(key, T, S, mask)
        assert np.array_equal(got[p], want), f"partition {p}"
        assert np.array_equal(aes.prf_offset_table_host(key, T, S, mask),
                              want), f"host partition {p}"


@pytest.mark.parametrize("P,L,mask", [(4, 96, 511), (1, 32, 65535),
                                      (3, 45, 127), (2, 7, 4095)])
def test_prf_eval_fused_matches_host(P, L, mask):
    """Per-partition-keyed batched PRF (table-free client primitive) vs
    the host AES oracle at arbitrary (tag, x) points, including lane counts
    that are not a multiple of the 32-lane packing granule."""
    rng = np.random.default_rng(11 + L)
    keys = [rng.bytes(16) for _ in range(P)]
    masks = np.stack([aes.expand_key_planes(k) for k in keys])
    tags = rng.integers(0, 1 << 20, size=(P, L)).astype(np.uint32)
    xs = rng.integers(0, 1 << 16, size=(P, L)).astype(np.uint32)
    got = np.asarray(aes.prf_eval_fused(masks, tags, xs, mask))
    for p, key in enumerate(keys):
        rk = aes_host.expand_key(key)
        want = (aes_host.prf_eval_u64(
            rk, tags[p].astype(np.uint64), xs[p].astype(np.uint64))
            & np.uint64(mask)).astype(np.uint32)
        assert np.array_equal(got[p], want), f"partition {p}"


@pytest.mark.parametrize("chunk_size", [512, 4096])
def test_prf_offsets_masking(chunk_size):
    rng = np.random.default_rng(4)
    key = rng.bytes(16)
    rk = aes_host.expand_key(key)
    km = aes.expand_key_planes(key)
    tags = np.arange(40, dtype=np.uint32)
    xs = np.arange(17, dtype=np.uint32)
    got = np.asarray(
        aes.prf_offsets(km, tags[:, None], xs[None, :], chunk_size - 1)
    )
    want = (
        aes_host.prf_eval_u64(
            rk, tags.astype(np.uint64)[:, None], xs.astype(np.uint64)[None, :]
        )
        & np.uint64(chunk_size - 1)
    ).astype(np.uint32)
    assert np.array_equal(got, want)


def test_bp_sbox_matches_chain_and_table():
    """Boyar-Peralta S-box circuit vs the addition-chain twin and the
    field-derived table, on random bit planes."""
    from pacmann.ops import gf2
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    vals = rng.integers(0, 256, size=(16, 64), dtype=np.uint8)
    planes = [jnp.asarray(((vals >> b) & 1).astype(np.uint32) *
                          np.uint32(0xFFFFFFFF)) for b in range(8)]
    got_bp = aes._sbox_planes(planes)
    got_chain = aes._sbox_planes_chain(planes)
    want = gf2.SBOX[vals]
    for o in range(8):
        bit = ((want >> o) & 1).astype(np.uint32) * np.uint32(0xFFFFFFFF)
        assert np.array_equal(np.asarray(got_bp[o]), bit), o
        assert np.array_equal(np.asarray(got_chain[o]), bit), o
