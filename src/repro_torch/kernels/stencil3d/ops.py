"""Public heat-diffusion step: the CUDA kernel or its plain version.

Dispatches through :mod:`repro_torch.kernels.dispatch`: ``"auto"`` launches
the kernel on a CUDA tensor and runs the plain version on a CPU tensor;
whatever the kernel does not take raises.  Both obey the pass-through ring
convention, so they compose with ``update_halo`` and
``hide_communication`` as the paper's ``step!`` does.
"""

from __future__ import annotations

from ...analysis import markers as _mk
from .. import dispatch
from .kernel import heat_step_cuda
from .ref import heat_step_ref


def heat_step(T, Ci, lam, dt, dx, dy, dz, *, use_kernel: str = "auto"):
    """One stencil step on ``(..., nx, ny, nz)``.  ``use_kernel``:
    ``'auto' | 'cuda' | 'ref'``."""
    # ghost demand for the analyzer (one falsy test outside a check)
    T = _mk.consume(T, radius=1, site="kernels.stencil3d.heat_step")
    if dispatch.resolve(use_kernel, T, where="stencil3d.heat_step") == "ref":
        return heat_step_ref(T, Ci, lam, dt, dx, dy, dz)
    return heat_step_cuda(T, Ci, lam, dt, dx, dy, dz)
