"""Analyzer entry points: one-shot checks and the app-matrix sweep.

:func:`check` runs an arbitrary callable under a :class:`~.trace.Trace`
(meta shadows: nothing reaches a device, nothing is sent) and runs all
four rule families on what it recorded; :func:`capture_check` does the
same for a full app solve through the solvers' capture hooks
(:mod:`.capture`).  Neither launches a kernel or reads a value, so a check
is safe on a machine with no card and leaves the programs it certifies as
they were (pinned by ``tests/test_torch_analysis_zero_cost.py``).

:func:`sweep` runs the analyzer across the four flagship apps (Poisson /
Heat / TwoPhase / Stokes) over the reference's matrix (periodic x overlap
x ``use_kernel``; its two ``interpret`` targets are ``cuda`` targets here:
the CUDA kernels' dispatch, launch plans recorded, nothing launched), plus
``kernels/library`` (every kernel's launch plan at the main paths' and the
tests' shapes) and four ``group/`` targets (one app each on 2 gloo
processes of their own, :mod:`.group`).  Under a process group every
target runs in every process and the congruence rule compares their
collective sequences.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import capture, congruence, group, launchgrid, reductions_lint
from .findings import Report
from .trace import Trace


def analyze(trace: Trace) -> Report:
    """Run all four rule families over a recorded trace (staleness ran
    while it was recorded)."""
    rep = Report()
    rep.extend(congruence.run(trace))
    rep.extend(trace.findings.values())
    rep.extend(launchgrid.run(trace))
    rep.extend(reductions_lint.run(trace))
    return rep


def _leaves(args) -> list:
    from ..core import locations as _loc
    out = []
    for a in args:
        if isinstance(a, torch.Tensor) or _loc.is_field_node(a) or isinstance(a, (list, tuple)):
            out.extend(_loc.tree_leaves(a))
    return out


def check(fn: Callable, *args, halo: int = 1, device: str | None = None) -> Report:
    """Run ``fn(*args)`` under a trace and analyze it.

    ``args`` may be real or meta tensors (only shapes and dtypes are
    used); they are the program's inputs.  ``device`` is the device type
    the kernel dispatch sees (default: that of the first real tensor
    argument, else ``"cpu"``).
    """
    leaves = _leaves(args)
    if device is None:
        device = next((t.device.type for t in leaves if t.device.type != "meta"), "cpu")
    trace = Trace(halo=halo, device_type=device)
    with trace.recording(leaves):
        fn(*args)
    return analyze(trace)


def capture_check(fn: Callable, *args, **kwargs) -> Report:
    """Run ``fn`` until its solver capture hook fires; analyze the
    captured solve."""
    return analyze(capture.capture(fn, *args, **kwargs).trace)


# ---------------------------------------------------------------------------
# the app matrix
# ---------------------------------------------------------------------------

def heat_report(app, steps: int = 2) -> Report:
    """Analyze ``steps`` Heat3D steps (``Heat3D._step``: the kernel step and
    its ``update_halo``, or ``hide_communication``) from the app's fields."""
    T, Ci = app.init_fields()

    def run(T, Ci):
        for _ in range(steps):
            T = app._step(T, Ci)
        return T

    return check(run, T, Ci, halo=app.grid.halo, device=_kernel_device(app.grid))


def _kernel_device(grid) -> str:
    return capture._DEVICE.get("type") or ("cpu" if grid.device.type == "meta"
                                            else grid.device.type)


def targets(device="cpu", dims=(2, 2, 2)) -> dict[str, Callable[[], Report]]:
    """The reference's 20 app targets, ``kernels/library`` and the
    ``group/`` targets, as thunks.
    Apps are built on ``device`` with ``dims`` blocks (one per process under
    a group of 8: ``dims=None``).  A ``cuda`` target off the card builds its
    app on the meta device and dispatches as on the card."""
    from ..apps.heat3d import Heat3D
    from ..apps.poisson import Poisson3D
    from ..apps.stokes import Stokes3D
    from ..apps.twophase import TwoPhase3D

    def on(use_kernel):
        if use_kernel == "cuda" and torch.device(device).type != "cuda":
            return "meta", "cuda"
        return device, None

    def poisson(method, *, periodic=False, use_kernel="auto", overlap=False):
        def run():
            dev, as_dev = on(use_kernel)
            with capture.as_device(as_dev):
                app = Poisson3D(periodic=(periodic,) * 3, dims=dims, use_kernel=use_kernel,
                                device=dev)
                return capture_check(lambda: app.solve(method=method, overlap=overlap))
        return run

    def heat(*, hide, use_kernel="auto"):
        def run():
            dev, as_dev = on(use_kernel)
            with capture.as_device(as_dev):
                app = Heat3D(nx=16, ny=16, nz=16, hide=(8, 2, 2) if hide else None, dims=dims,
                             use_kernel=use_kernel, device=dev)
                return heat_report(app)
        return run

    def twophase(*, overlap):
        def run():
            app = TwoPhase3D(nx=12, ny=12, nz=12, overlap=overlap, method="mgcg", dims=dims,
                             device=device)
            S = app.init_fields()
            return capture_check(lambda: app.pressure_solve(S))
        return run

    def stokes(*, precond, variant="classic"):
        def run():
            app = Stokes3D(dims=dims, device=device)
            return capture_check(lambda: app.velocity_solve(precond=precond, maxiter=5,
                                                            variant=variant))
        return run

    def stokes_schur():
        def run():
            app = Stokes3D(dims=dims, device=device)
            return capture_check(lambda: app.solve(outer_maxiter=2, compiled=True))
        return run

    return {
        "poisson/cg[dirichlet]": poisson("cg"),
        "poisson/cg[dirichlet,overlap]": poisson("cg", overlap=True),
        "poisson/cg[periodic]": poisson("cg", periodic=True),
        "poisson/pipecg[dirichlet]": poisson("pipecg"),
        "poisson/pipecg[dirichlet,overlap]": poisson("pipecg", overlap=True),
        "poisson/pipecg[periodic]": poisson("pipecg", periodic=True),
        "poisson/mgcg[dirichlet]": poisson("mgcg"),
        "poisson/mgcg[periodic]": poisson("mgcg", periodic=True),
        "poisson/pipemgcg[dirichlet]": poisson("pipemgcg"),
        "poisson/mgcg[dirichlet,cuda]": poisson("mgcg", use_kernel="cuda"),
        "poisson/pt[dirichlet]": poisson("pt"),
        "heat/step[hide]": heat(hide=True),
        "heat/step[nohide]": heat(hide=False),
        "heat/step[hide,cuda]": heat(hide=True, use_kernel="cuda"),
        "twophase/pressure[direct]": twophase(overlap=False),
        "twophase/pressure[overlap]": twophase(overlap=True),
        "stokes/velocity[stress]": stokes(precond="stress"),
        "stokes/velocity[stress,pipelined]": stokes(precond="stress", variant="pipelined"),
        "stokes/velocity[noprecond]": stokes(precond=None),
        "stokes/schur[compiled]": stokes_schur(),
        "kernels/library": lambda: Report(launchgrid.check_kernel_library(_sms(device))),
        **{f"group/{name}": (lambda name=name: group.run(name, 2, str(device)))
           for name in GROUP_TARGETS},
    }


# one target per app, checked on 2 gloo processes of 4 blocks each
GROUP_TARGETS = ("poisson/mgcg[dirichlet]", "heat/step[hide]", "twophase/pressure[direct]",
                 "stokes/velocity[stress]")


def run_target(name: str, device="cpu", dims=(2, 2, 2)) -> Report:
    """One target of the matrix by its exact name."""
    return targets(device, dims)[name]()


def _sms(device) -> int:
    from ..kernels.plans import H100_SMS
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).multi_processor_count
    return H100_SMS


def sweep(targets_=None, device="cpu", dims=(2, 2, 2)) -> dict[str, Report]:
    """Analyze the app matrix; returns ``{target_name: Report}``.

    ``targets_``: optional iterable of substrings — only matching target
    names run (a ``group/`` target only when its filter names ``group``).
    Under a process group every process must run the same targets (the
    congruence rule compares them)."""
    out: dict[str, Report] = {}
    for name, thunk in targets(device, dims).items():
        if targets_ and not any(t in name and (t.startswith("group") or
                                               not name.startswith("group/"))
                                for t in targets_):
            continue
        out[name] = thunk()
    return out


def merged(reports: dict[str, Report]) -> Report:
    total = Report()
    for rep in reports.values():
        total.merge(rep)
    return total
