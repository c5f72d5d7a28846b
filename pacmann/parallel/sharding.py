"""Device-mesh sharding for the PIR server engine and distance scans.

The reference's scaling axes (SURVEY.md §5) map onto a 1-D `jax.sharding.Mesh`:

  * XOR parity scans (the PIR server's entire online compute and the offline
    hint-generation pass, pir.go:65-88/303-352) shard the chunk axis: each
    device streams its local chunks and XORs PRF-selected rows into partial
    parities. XOR over disjoint chunk sets composes associatively, so partial
    parities combine with an **XOR all-reduce** across the devices — the
    bitwise analog of the reference's batch-partition parallelism
    (batch-pir.go:62-85), expressed as an all_gather + lane-wise XOR fold
    (one collective; XOR has no psum primitive).
  * Brute-force / candidate distance scans shard the DB-row axis: local
    (Q, B_local) distance tiles + local top-k, then a global top-k merge on
    gathered per-device candidates (the linear-scan baseline of
    graphann_test.go:221-284 at multi-chip scale).

Everything is jit-compatible `shard_map` code: no host round trips inside a
step. Used by the multi-chip dry run (__graft_entry__.py) and the scale tier.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pacmann.ops.distance import l2_distance_xla
from pacmann.ops.xor_scan import xor_scan_xla

AXIS = "shard"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    return Mesh(np.array(devs[:n_devices]), (AXIS,))


def _xor_allreduce(x, axis_name=AXIS):
    """XOR all-reduce: gather partials and fold. x: (..., ) u32."""
    g = jax.lax.all_gather(x, axis_name)          # (n_dev, ...)
    return jax.lax.reduce(g, jnp.uint32(0), jax.lax.bitwise_xor, (0,))


def sharded_xor_scan(mesh: Mesh, db, offsets, skip, k: int):
    """Chunk-sharded XOR scan with an XOR all-reduce across the mesh.

    db: (S, C*k, 128) u32 sharded on axis 0; offsets/skip: (B, S) replicated
    but consumed column-sharded. Returns (B, k, 128) u32, replicated.
    S must be divisible by mesh size.
    """
    n_dev = mesh.shape[AXIS]
    S = db.shape[0]
    assert S % n_dev == 0, (S, n_dev)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(AXIS, None, None), P(None, AXIS), P(None, AXIS)),
        out_specs=P(),
        check_vma=False,
    )
    def scan(db_loc, off_loc, skip_loc):
        partial = xor_scan_xla(db_loc, off_loc, skip_loc, k)
        return _xor_allreduce(partial)

    return scan(db, offsets, skip)


def shard_db(mesh: Mesh, db):
    """Place a chunk-major PIR DB with the chunk axis split across the mesh."""
    return jax.device_put(db, NamedSharding(mesh, P(AXIS, None, None)))


def sharded_l2_topk(mesh: Mesh, queries, vectors, k: int):
    """Row-sharded exact k-NN: local distance tile + local top-k, global merge.

    queries: (Q, D) replicated; vectors: (N, D) sharded on axis 0;
    returns (ids (Q, k) i32 global, dists (Q, k) f32).
    """
    n_dev = mesh.shape[AXIS]
    N = vectors.shape[0]
    assert N % n_dev == 0, (N, n_dev)
    n_loc = N // n_dev

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(AXIS, None)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def run(q, v_loc):
        d = l2_distance_xla(q, v_loc)                      # (Q, n_loc)
        negd, idx = jax.lax.top_k(-d, k)                   # local top-k
        base = jax.lax.axis_index(AXIS).astype(jnp.int32) * n_loc
        gids = idx.astype(jnp.int32) + base
        # gather all devices' candidates and merge
        all_negd = jax.lax.all_gather(negd, AXIS)          # (n_dev, Q, k)
        all_gids = jax.lax.all_gather(gids, AXIS)
        Q = q.shape[0]
        flat_negd = jnp.transpose(all_negd, (1, 0, 2)).reshape(Q, -1)
        flat_gids = jnp.transpose(all_gids, (1, 0, 2)).reshape(Q, -1)
        mneg, msel = jax.lax.top_k(flat_negd, k)
        mids = jnp.take_along_axis(flat_gids, msel, axis=1)
        return mids, -mneg

    return run(queries, vectors)


def replicate(mesh: Mesh, x):
    return jax.device_put(x, NamedSharding(mesh, P()))
