"""Multi-device sharding: XOR scan with an XOR all-reduce + distance top-k,
on the 8-virtual-device CPU mesh (conftest forces it). This is the device
analog of the reference's batch-partition parallelism (batch-pir.go:62-85) —
see SURVEY.md §5."""

import numpy as np

from pacmann.ops.xor_scan import xor_scan_np
from pacmann.parallel.sharding import (
    make_mesh,
    replicate,
    shard_db,
    sharded_l2_topk,
    sharded_xor_scan,
)
from pacmann.pir import layout


def test_sharded_xor_scan_matches_numpy():
    import jax

    assert jax.device_count() >= 8
    mesh = make_mesh(8)
    rng = np.random.default_rng(0)
    chunk_size, set_size, entry_u32 = 16, 32, 4
    db_size = chunk_size * set_size - 5  # exercise zero padding
    raw = rng.integers(0, 2**32, size=(db_size, entry_u32), dtype=np.uint32)
    packed = layout.pack_db(raw, chunk_size, set_size)
    k = layout.entry_rows(entry_u32)

    B = 24
    offsets = rng.integers(0, chunk_size, size=(B, set_size), dtype=np.uint32)
    skip = rng.random((B, set_size)) < 0.1

    got = np.asarray(sharded_xor_scan(
        mesh, shard_db(mesh, packed),
        replicate(mesh, offsets), replicate(mesh, skip), k))
    want = xor_scan_np(packed, offsets, skip, k)
    assert np.array_equal(got, want)


def test_sharded_l2_topk_matches_bruteforce():
    import jax

    mesh = make_mesh(8)
    rng = np.random.default_rng(1)
    N, D, Q, K = 512, 16, 6, 10
    vectors = rng.random((N, D)).astype(np.float32)
    queries = rng.random((Q, D)).astype(np.float32)

    v_sharded = jax.device_put(
        vectors,
        jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("shard", None)),
    )
    ids, dists = sharded_l2_topk(mesh, replicate(mesh, queries), v_sharded, K)
    ids = np.asarray(ids)

    d = ((queries[:, None, :] - vectors[None, :, :]) ** 2).sum(-1)
    want = np.argsort(d, axis=1, kind="stable")[:, :K]
    # compare as sets per query (ties may reorder)
    for qi in range(Q):
        assert set(ids[qi]) == set(want[qi]), qi
