"""The paper's effective-throughput metric (the port's own copy)."""

from .metrics import a_eff, t_eff

__all__ = ["a_eff", "t_eff"]
