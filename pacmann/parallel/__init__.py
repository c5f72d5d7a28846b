"""Device-mesh sharding: partition-parallel PIR, XOR all-reduce, top-k merge."""

from pacmann.parallel.sharding import (  # noqa: F401
    make_mesh,
    shard_db,
    sharded_l2_topk,
    sharded_xor_scan,
)
