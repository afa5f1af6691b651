"""Checkpointing: atomic save/restore of trees of tensors."""

from .checkpoint import async_save, latest_step, restore, save

__all__ = ["save", "restore", "latest_step", "async_save"]
