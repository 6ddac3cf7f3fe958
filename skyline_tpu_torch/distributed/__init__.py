"""Sharded streaming engine: per-card partition groups with a two-level
tournament merge. See ``distributed/sharded.py``."""

from skyline_tpu_torch.distributed.sharded import ShardedEngine, ShardedPartitionSet

__all__ = ["ShardedEngine", "ShardedPartitionSet"]
