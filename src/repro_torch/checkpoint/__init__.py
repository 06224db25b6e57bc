"""Checkpointing: atomic saves, async writer, retention, elastic reshard."""

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.reshard import reshard_tree, shardings_from_specs

__all__ = ["CheckpointManager", "reshard_tree", "shardings_from_specs"]
