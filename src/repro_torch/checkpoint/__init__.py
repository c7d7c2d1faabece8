"""Checkpoints of the port (counterpart of ``repro.checkpoint``), in the
reference's on-disk format."""
from .ckpt import (CheckpointManager, Int4, latest_step, restore,
                   restore_tree, save)

__all__ = ["CheckpointManager", "Int4", "latest_step", "restore",
           "restore_tree", "save"]
