"""The reference's mesh axis, in the port: the processes of the default
``torch.distributed`` group.

The JAX package's collectives run inside ``shard_map`` over a named mesh
axis (``"sp"``, ``"model"``, ``"pod"``).  The port keeps those parameter
names (``axis_name``, ``axis``) so that a reader can match the two, but a
name stands for one thing only: the default group, whose processes each
hold one shard, in rank order.  Any non-empty ``str`` names it; anything
else (a tuple of axes, an empty name) raises ``ValueError``.  Without a
group the axis has size 1 and every function computes the one-shard
answer, as ``shard_map`` does over an axis of size 1.  All traffic goes
through :mod:`repro_torch.core.comm`.
"""

from __future__ import annotations

import torch

from ..core import comm


def check(axis_name) -> None:
    """Raise ``ValueError`` unless ``axis_name`` names the default group."""
    if not isinstance(axis_name, str) or not axis_name:
        raise ValueError(
            f"axis {axis_name!r}: the port maps one mesh-axis name (a non-empty str) to the "
            "processes of the default torch.distributed group; it has no other axes")


def size(axis_name) -> int:
    """``jax.lax.axis_size``: processes in the default group (1 without one)."""
    check(axis_name)
    return comm.world_size()


def index(axis_name) -> int:
    """``jax.lax.axis_index``: this process's rank (0 without a group)."""
    check(axis_name)
    return comm.rank()


def ppermute_shift(x: torch.Tensor, axis_name, by: int = 1, periodic: bool = False):
    """``ppermute`` with the table ``i -> i + by`` (modulo the axis size
    when ``periodic``): see :func:`repro_torch.core.comm.shift`."""
    check(axis_name)
    return comm.shift(x, by, periodic)


def psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Sum over the axis, the same bits on every process (``x`` itself
    without a group)."""
    check(axis_name)
    return comm.all_reduce(x, "sum") if comm.world_size() > 1 else x


def pmax(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Maximum over the axis (``x`` itself without a group)."""
    check(axis_name)
    return comm.all_reduce(x, "max") if comm.world_size() > 1 else x
