"""Solve capture: record a solver's program without running the solve.

The reference steals a solver's traced jaxpr before it compiles.  Here
each solver the reference hooks (``solvers.cg``, ``multigrid_solve``,
``pseudo_transient``, the Stokes compiled Schur loop) starts with
:func:`capturing` — a no-op in production (one falsy test) — and, inside
a :func:`capture_solves` block, calls itself again under a fresh
:class:`~repro_torch.analysis.trace.Trace` through :func:`maybe_capture`:

* every tensor op runs on meta shadows (no device work, no CUDA kernel:
  the kernel wrappers record their launch plans instead), and the
  collectives are recorded, not sent;
* the loop's stopping test reads nothing: :func:`markers.loop_float`
  keeps the loop going for ``max(2, halo + 1)`` passes of its body (two,
  so an exchange missing "from iteration two onward" is caught), then ends
  it; a solver nested in the captured one (the Schur loop's velocity
  solves) runs its passes the same way;
* the solver returns right after its loop, before any host read of a
  residual, and :func:`maybe_capture` raises :class:`CaptureDone`
  carrying the trace.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator

from . import markers


class CaptureDone(Exception):
    """Raised by a solver's capture hook; carries the recorded trace."""

    def __init__(self, name: str, trace, halo: int):
        super().__init__(f"captured solver trace: {name}")
        self.name = name
        self.trace = trace
        self.halo = halo


_CAPTURE: list[object] = []


def capturing() -> bool:
    """True inside :func:`capture_solves` while no trace is recording yet
    (a solver reached under a recording trace is part of it)."""
    return bool(_CAPTURE) and markers.TRACE is None


@contextlib.contextmanager
def capture_solves() -> Iterator[None]:
    """Arm the solver capture hooks for the duration of the block."""
    token = object()
    _CAPTURE.append(token)
    try:
        yield
    finally:
        _CAPTURE.remove(token)


def maybe_capture(name: str, grid, inputs, run: Callable) -> None:
    """Solver-side hook: run ``run()`` (the solver again) under a new trace
    whose inputs are ``inputs``, then raise :class:`CaptureDone`."""
    from .trace import Trace
    device_type = grid.device.type if grid.device.type != "meta" else "cpu"
    trace = Trace(halo=grid.halo, device_type=_DEVICE.get("type") or device_type)
    with trace.recording(_tensors(inputs)):
        run()
    raise CaptureDone(name, trace, grid.halo)


def _tensors(tree) -> list:
    from ..core import locations as _loc
    out = []
    for t in tree:
        if t is not None:
            out.extend(_loc.tree_leaves(t))
    return out


# the device type kernel dispatch sees inside a capture, when the driver
# checks a meta-built app for another device (e.g. the "cuda" route)
_DEVICE: dict = {}


@contextlib.contextmanager
def as_device(device_type: str | None) -> Iterator[None]:
    """Captures in the block dispatch kernels as on ``device_type``."""
    prev = _DEVICE.get("type")
    _DEVICE["type"] = device_type
    try:
        yield
    finally:
        _DEVICE["type"] = prev


def capture(fn: Callable, *args, **kwargs) -> CaptureDone:
    """Run ``fn`` until its first solver capture hook fires; return the
    :class:`CaptureDone` (name, trace, halo)."""
    with capture_solves():
        try:
            fn(*args, **kwargs)
        except CaptureDone as done:
            return done
    raise RuntimeError(
        "no solver capture hook fired — the callable never reached "
        "solvers.cg / multigrid_solve / pseudo_transient / the Stokes Schur loop")
