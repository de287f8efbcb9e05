"""Sharding of the port (counterpart of rspt_tpu/parallel/): the block
codec over several shards, cards or processes (mesh.py), and the
cross-shard delta and xor scans (scans.py)."""

from .mesh import (AXIS, Mesh, ShardedHzrDecoder, ShardedHzrEncoder,
                   make_mesh, pad_blocks)
from .scans import make_sharded_scans

__all__ = ["AXIS", "Mesh", "ShardedHzrDecoder", "ShardedHzrEncoder",
           "make_mesh", "make_sharded_scans", "pad_blocks"]
