"""GPipe pipeline parallelism over the processes of the default group.

The port's twin of the JAX package's ``distributed/pipeline.py``.  Stage
``s`` lives on rank ``s`` of the default ``torch.distributed`` group (the
reference's mesh axis; see :mod:`.axis`); at every tick each stage runs
one microbatch and hands its activation to the next stage by a neighbour
shift (:func:`repro_torch.core.comm.shift`), the pattern of the stencil's
halo update.

Schedule: plain GPipe fill-drain, M microbatches over S stages in
M + S - 1 ticks (bubble fraction (S-1)/(M+S-1)).  A stage runs every tick,
on zeros in its bubbles, as the reference's does.
"""

from __future__ import annotations

import torch

from . import axis as _axis


def gpipe(stage_fn, stage_params, microbatches, *, axis: str = "pod"):
    """``y = stage_{S-1}(... stage_0(x))`` for each microbatch, S the
    group's size.

    stage_fn(params, x) -> y with x and y of one shape; stage_params: THIS
    process's stage (rank s holds stage s); microbatches: (M, ...), the
    same on every process.  Returns the (M, ...) outputs on every process
    (the last stage's, summed over the group with the others' zeros)."""
    S, r = _axis.size(axis), _axis.index(axis)
    xs = microbatches
    M = xs.shape[0]
    recv = torch.zeros_like(xs[0])
    outs = [None] * M
    for t in range(M + S - 1):
        cur = xs[min(t, M - 1)] if r == 0 else recv
        y = stage_fn(stage_params, cur)
        m = t - (S - 1)
        if m >= 0 and r == S - 1:
            outs[m] = y
        if t < M + S - 2:   # the last tick's hand-off has no reader
            recv = _axis.ppermute_shift(y, axis, 1)
    # only the last stage holds real outputs; broadcast through the sum of
    # a one-hot mask, as the reference does
    mine = torch.stack(outs) if r == S - 1 else torch.zeros_like(xs)
    return _axis.psum(mine, axis)


__all__ = ["gpipe"]
