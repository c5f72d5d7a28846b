"""Batched L2 / inner-product distances.

Plain-XLA replacement for the reference's SIMD assembly:
  L2DistanceSIMD (AVX2, 8 floats/iter)  -> one (Q, B) distance product
      /root/reference/graphann/l2_distance_amd64.s:4-36, build_graph.go:106-121
  InnerProduct (AVX-512 u32 dot)        -> int32 matmul (linear-scan baseline)
      l2_distance_amd64.s:39-68, graphann_test.go:221-284

Instead of one scalar distance per call, everything is batched: beam search
evaluates a (Q, B) tile of query x candidate distances as one matrix product
using ||q - c||^2 = ||q||^2 + ||c||^2 - 2 q.c, at HIGHEST precision (no TF32
on the GPU): f32 accumulation matches the Go implementation's float32
arithmetic.
"""

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# XLA path


@jax.jit
def l2_distance_xla(queries, points):
    """(Q, D) x (B, D) -> (Q, B) squared L2 distances, f32."""
    queries = queries.astype(jnp.float32)
    points = points.astype(jnp.float32)
    qn = jnp.sum(queries * queries, axis=-1, keepdims=True)      # (Q, 1)
    pn = jnp.sum(points * points, axis=-1, keepdims=True).T      # (1, B)
    cross = jax.lax.dot_general(
        queries,
        points,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,  # match the reference's exact f32
    )
    return jnp.maximum(qn + pn - 2.0 * cross, 0.0)


@jax.jit
def inner_product_xla(a, b):
    """(Q, D) x (B, D) -> (Q, B) dot products, int32 (wraps mod 2^32 like the
    reference's uint32 accumulation)."""
    return jax.lax.dot_general(
        a.astype(jnp.int32),
        b.astype(jnp.int32),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def l2_distance(queries, points):
    """Public entry: (Q, D) queries x (B, D) points -> (Q, B) squared L2."""
    return l2_distance_xla(queries, points)


def l2_distance_single(v1, v2):
    """Scalar twin of the reference's L2Dist (build_graph.go:106-114)."""
    v1 = jnp.asarray(v1, jnp.float32)
    v2 = jnp.asarray(v2, jnp.float32)
    d = v1 - v2
    return jnp.sum(d * d)
