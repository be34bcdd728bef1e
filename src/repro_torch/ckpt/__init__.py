"""Checkpoints: the block store (a copy of the reference's) and the
checkpoint engine over ``TransitBuffer``, in the reference's wire format."""
from .blockstore import BlockStore, make_blockstore
from .engine import CheckpointEngine

__all__ = ["BlockStore", "make_blockstore", "CheckpointEngine"]
