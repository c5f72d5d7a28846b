"""Partition-sharded PIR engine on the 8-virtual-device CPU mesh: exact
answers and agreement with the single-device engine."""

import numpy as np

from pacmann.parallel.sharding import make_mesh
from pacmann.pir.device_engine import DevicePianoEngine
from pacmann.pir.sharded_engine import ShardedPianoEngine


def test_sharded_engine_exact_answers():
    import jax

    assert jax.device_count() >= 8
    mesh = make_mesh(8)
    rng = np.random.default_rng(70)
    n, eb, batch = 8192, 32, 32   # 16 partitions over 8 devices
    raw = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    pir = ShardedPianoEngine(n, eb, batch, raw, 20, mesh)
    pir.preprocessing(rng=np.random.default_rng(100))
    c = pir.config
    ids = []
    for _ in range(2):
        ids += [int(i * c.partition_size + rng.integers(0, c.partition_size))
                for i in range(c.partition_num)]
    out = pir.query(ids)
    for r, idx in enumerate(ids):
        assert np.array_equal(out[r], raw[idx]), f"row {r} idx {idx}"


def test_shard_native_prep_memory_locality():
    """The SIFT100M tier requires that no device ever holds more than its
    shard: the packed DB is assembled from per-device blocks and the
    offline phase runs under shard_map, so every addressable shard of the
    DB and of every large state leaf spans exactly P/n_dev partitions."""
    mesh = make_mesh(8)
    rng = np.random.default_rng(72)
    n, eb, batch = 8192, 32, 32   # 16 partitions over 8 devices
    raw = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    pir = ShardedPianoEngine(n, eb, batch, raw, 20, mesh)
    pir.preprocessing(rng=np.random.default_rng(101))
    P = pir.config.partition_num
    per = P // 8
    db_shards = pir.db.addressable_shards
    assert len(db_shards) == 8
    for s in db_shards:
        assert s.data.shape[1] == per, s.data.shape
    for name in ("table", "primary_parity", "backup_parity", "slot_col",
                 "repl_idx", "repl_val"):
        shards = pir.state[name].addressable_shards
        assert len(shards) == 8, name
        for s in shards:
            assert s.data.shape[0] == per, (name, s.data.shape)
    # and the engine still answers exactly
    ids = [int(i * pir.config.partition_size + 1) for i in range(P)]
    out = pir.query(ids)
    for r, idx in enumerate(ids):
        assert np.array_equal(out[r], raw[idx]), f"row {r}"


def test_sharded_table_free_matches_single_chip():
    """Table-free mode (state carries 'masks', no 'table') under shard_map:
    the spec pytree must mirror the live state dict, and answers must stay
    bit-identical to the single-chip table-free engine."""
    mesh = make_mesh(8)
    rng = np.random.default_rng(73)
    n, eb, batch = 4096, 32, 32
    raw = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    single = DevicePianoEngine(n, eb, batch, raw, 20, table_free=True)
    sharded = ShardedPianoEngine(n, eb, batch, raw, 20, mesh,
                                 table_free=True)
    single.preprocessing(rng=np.random.default_rng(6))
    sharded.preprocessing(rng=np.random.default_rng(6))
    assert "table" not in sharded.state and "masks" in sharded.state
    # the masks leaf is partition-sharded like every other state leaf
    shards = sharded.state["masks"].addressable_shards
    assert len(shards) == 8
    P = sharded.config.partition_num
    for s in shards:
        assert s.data.shape[0] == P // 8, s.data.shape
    ids = [int(i * single.config.partition_size + 3)
           for i in range(single.config.partition_num)] * 2
    single._rng = np.random.default_rng(9)
    sharded._rng = np.random.default_rng(9)
    a = single.query(ids)
    b = sharded.query(ids)
    assert np.array_equal(a, b)
    for r, idx in enumerate(ids):
        assert np.array_equal(a[r], raw[idx]), f"row {r}"


def test_sharded_matches_single_chip():
    """Same seeds -> identical state evolution and identical answers."""
    mesh = make_mesh(8)
    rng = np.random.default_rng(71)
    n, eb, batch = 4096, 32, 32
    raw = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    single = DevicePianoEngine(n, eb, batch, raw, 20)
    sharded = ShardedPianoEngine(n, eb, batch, raw, 20, mesh)
    single.preprocessing(rng=np.random.default_rng(5))
    sharded.preprocessing(rng=np.random.default_rng(5))
    ids = [int(i * single.config.partition_size + 3)
           for i in range(single.config.partition_num)] * 2
    # separate rngs so dummy offsets match
    single._rng = np.random.default_rng(9)
    sharded._rng = np.random.default_rng(9)
    a = single.query(ids)
    b = sharded.query(ids)
    assert np.array_equal(a, b)


def test_fused_search_over_sharded_engine_bit_identical():
    """The ENTIRE fused private search (beam + PIR protocol as one program)
    runs over the partition-sharded engine on a 4-device mesh and returns
    bit-identical answers to the single-chip engine — the multi-chip analog
    of a full query step, with the PIR state staying partition-sharded
    through the program."""
    from pacmann.private.fused_search import FusedPrivateSearch
    from pacmann.private.oracle import pack_vertex_db

    rng = np.random.default_rng(40)
    n, d, m = 1024, 8, 8
    vectors = rng.random((n, d), dtype=np.float32)
    graph = rng.integers(0, n, size=(n, m)).astype(np.int64)
    raw = pack_vertex_db(vectors, graph)
    mesh = make_mesh(4)

    def mk(engcls, *extra):
        e = engcls(n, 4 * (d + m), m, raw, 8, *extra)
        e.preprocessing(rng=np.random.default_rng(7))
        sids = np.arange(32)
        return FusedPrivateSearch(e, sids, vectors[sids], graph[sids],
                                  dim=d, m=m, n=n)

    fs_single = mk(DevicePianoEngine)
    fs_shard = mk(ShardedPianoEngine, mesh)
    q = rng.random((2, d), dtype=np.float32)
    out_single = fs_single.search(q, k=5, max_step=4, parallel=2, seed=3)
    out_shard = fs_shard.search(q, k=5, max_step=4, parallel=2, seed=3)
    assert np.array_equal(out_single, out_shard)
    st = fs_shard.engine.state
    assert "shard" in str(st["primary_parity"].sharding.spec)


def test_chunk_sharded_matches_single_chip():
    """ChunkShardedPianoEngine (P < n_devices: SetSize axis sharded,
    XOR all-reduce over the mesh) answers BIT-identically to the
    single-chip engine given the same preprocessing/query RNG, and its DB
    shards each hold exactly S/n_dev chunks."""
    from pacmann.pir.sharded_engine import ChunkShardedPianoEngine

    mesh = make_mesh(8)
    rng = np.random.default_rng(80)
    n, eb, batch = 4096, 32, 4   # P=2 partitions < 8 devices
    raw = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)

    single = DevicePianoEngine(n, eb, batch, raw, 20)
    single.preprocessing(rng=np.random.default_rng(100))
    sharded = ChunkShardedPianoEngine(n, eb, batch, raw, 20, mesh)
    sharded.preprocessing(rng=np.random.default_rng(100))

    S = sharded.params.set_size
    shards = sharded.db.addressable_shards
    assert len(shards) == 8
    for s in shards:
        assert s.data.shape[0] == S // 8, s.data.shape

    # identical offline state (chunk-sharded hint-gen == single-chip)
    for key in ("table", "slot_col", "primary_parity", "backup_parity",
                "repl_idx", "repl_val", "tag", "prog", "hist", "finished"):
        assert np.array_equal(np.asarray(single.state[key]),
                              np.asarray(sharded.state[key])), key

    # identical online answers + protocol state across several batches
    qrng = np.random.default_rng(8)
    for _ in range(3):
        ids = [int(i) for i in qrng.integers(0, n, batch)]
        single._rng = np.random.default_rng(9)
        sharded._rng = np.random.default_rng(9)
        oa = single.query(list(ids))
        ob = sharded.query(list(ids))
        assert np.array_equal(oa, ob)
    for key in ("tag", "prog", "slot_col", "hist", "finished",
                "primary_parity"):
        assert np.array_equal(np.asarray(single.state[key]),
                              np.asarray(sharded.state[key])), key
    assert (sharded.queries_made_in_partition
            == single.queries_made_in_partition)


def test_chunk_sharded_rejects_indivisible_mesh():
    from pacmann.pir.sharded_engine import ChunkShardedPianoEngine

    mesh = make_mesh(3)
    rng = np.random.default_rng(81)
    raw = rng.integers(0, 2**32, size=(4096, 8), dtype=np.uint32)
    try:
        ChunkShardedPianoEngine(4096, 32, 4, raw, 20, mesh)
        assert False, "expected ValueError"
    except ValueError as e:
        assert "divisible" in str(e)


def test_fused_search_refuses_chunk_sharded_engine():
    """The fused program cannot reduce a chunk-sharded DB across devices
    (XLA has no XOR all-reduce), so the wrapper refuses up front instead of
    failing inside XLA."""
    import pytest

    from pacmann.pir.sharded_engine import ChunkShardedPianoEngine
    from pacmann.private.fused_search import FusedPrivateSearch

    mesh = make_mesh(4)
    raw = np.random.default_rng(82).integers(0, 2**32, size=(4096, 8),
                                             dtype=np.uint32)
    eng = ChunkShardedPianoEngine(4096, 32, 4, raw, 20, mesh)
    with pytest.raises(NotImplementedError, match="partition-sharded"):
        FusedPrivateSearch(eng, np.arange(8), np.zeros((8, 4), np.float32),
                           np.zeros((8, 4), np.int64), dim=4, m=4, n=4096)
