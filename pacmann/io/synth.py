"""Synthetic data made from a seed: the PIR database and continuum vectors.

No benchmark or smoke run downloads data, so every deployment shape is
filled from these generators. Both DB forms keep the properties the
protocol checks rely on: distinct first word per row (so a wrong row never
compares equal), valid f32 bit patterns in the vector words, and uniform
neighbour ids in the neighbour words (so the fused search's in-batch dedup
sees a realistic duplicate rate).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _raw_device(key, n, entry_u32, float_cols, nbr_cols):
    k1, k2, k3 = jax.random.split(key, 3)
    raw = jax.random.bits(k1, (n, entry_u32), dtype=jnp.uint32)
    if float_cols:
        f = jax.random.uniform(k2, (n, float_cols), jnp.float32)
        raw = raw.at[:, :float_cols].set(
            jax.lax.bitcast_convert_type(f, jnp.uint32))
    if nbr_cols:
        nb = jax.random.randint(k3, (n, nbr_cols), 0, n, jnp.int32)
        raw = raw.at[:, float_cols:float_cols + nbr_cols].set(
            nb.astype(jnp.uint32))
    return raw.at[:, 0].set(jnp.arange(n, dtype=jnp.uint32))


def synth_raw_device(n: int, entry_u32: int, seed: int = 0,
                     float_cols: int = 0, nbr_cols: int = 0):
    """(n, entry_u32) u32 DB made on the device from `seed`: the first
    `float_cols` words hold uniform [0, 1) f32 bit patterns, the next
    `nbr_cols` words uniform ids in [0, n), the rest random bits, and word 0
    is the row index (distinct rows). DevicePianoEngine packs a
    device-resident raw array without a host copy."""
    return _raw_device(jax.random.PRNGKey(seed), n, entry_u32, float_cols,
                       nbr_cols)


def synth_continuum(n: int, d: int, rng, latent: int = 16) -> np.ndarray:
    """Continuum latent-manifold data: points ON a latent-dim Gaussian
    manifold embedded in d dims (plus small ambient noise), with NO
    mixture structure. k-means cells become an arbitrary Voronoi
    tessellation of a continuum, so a query's true neighbours straddle
    cell boundaries and the nearest-centroid baseline collapses — the
    regime real SIFT exhibits (cluster recall 0.391,
    /root/reference/cluster-report.txt:3) — while graph search still
    navigates (low intrinsic dimension)."""
    basis = (rng.standard_normal((latent, d)) / np.sqrt(latent)) \
        .astype(np.float32)
    out = np.empty((n, d), np.float32)
    block = 1 << 16
    for b0 in range(0, n, block):
        b = min(block, n - b0)
        z = rng.standard_normal((b, latent)).astype(np.float32)
        out[b0:b0 + b] = (z @ basis
                          + 0.02 * rng.standard_normal((b, d)).astype(
                              np.float32))
    return out


@functools.partial(jax.jit, static_argnames=("n", "d", "latent"))
def _continuum_device(key, *, n, d, latent):
    kb, kz, kn = jax.random.split(key, 3)
    basis = jax.random.normal(kb, (latent, d), jnp.float32) \
        / jnp.sqrt(float(latent))
    z = jax.random.normal(kz, (n, latent), jnp.float32)
    return (jnp.dot(z, basis, precision=jax.lax.Precision.HIGHEST)
            + 0.02 * jax.random.normal(kn, (n, d), jnp.float32))


def synth_continuum_device(n: int, d: int, seed: int, latent: int = 16):
    """Device twin of synth_continuum (another RNG stream): the (n, d) f32
    data is made on the device and never crosses to the host."""
    return _continuum_device(jax.random.PRNGKey(seed), n=n, d=d,
                             latent=latent)
