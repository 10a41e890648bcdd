"""Checkpoint save and restore (the JAX package's ``ckpt/`` protocol over
named torch state)."""

from .checkpoint import (CheckpointManager, host_copies, named_leaves,
                         state_bytes)

__all__ = ["CheckpointManager", "host_copies", "named_leaves",
           "state_bytes"]
