"""Checkpointing: manifest + per-leaf arrays, CRC32'd and fsync'd."""
from .manager import (CheckpointError, CheckpointManager,  # noqa: F401
                      CheckpointWriteError, LeafCorruptError,
                      LeafMismatchError, restore_tree, save_tree)
