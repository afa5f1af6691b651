"""Serving: the batched generate loop."""

from .engine import Engine

__all__ = ["Engine"]
