"""Checkpointing: atomic saves, async writer, retention."""

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
