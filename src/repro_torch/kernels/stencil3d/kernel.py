"""Launcher of the CUDA heat-step kernel K1 (``csrc/heat_step.cu``).

Replaces the TPU kernel ``heat_step_pallas``.  The wrapper checks device,
dtype, rank and sizes, allocates the output with ``torch.empty``, launches
on the current CUDA stream without synchronising, and raises if the launch
was refused.  ``heat_step_cuda.launches`` counts the launches.  The grid
and block come from :func:`repro_torch.kernels.plans.cell_plan`, the plan
the analyzer checks; under an analyzer check the wrapper records that plan
and launches nothing.
"""

from __future__ import annotations

import ctypes
import math
import functools

import torch

from ...analysis import markers as _mk
from .. import _build
from ..plans import cell_plan

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_MAX_GRID_YZ = 65535


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load().repro_heat_step
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 8 + [ctypes.c_double] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _batched(x: torch.Tensor, name: str) -> torch.Tensor:
    """``(..., nx, ny, nz)`` as a ``(B, nx, ny, nz)`` view, never a copy."""
    if x.ndim < 3:
        raise ValueError(f"heat_step_cuda: {name} must be (..., nx, ny, nz), got {tuple(x.shape)}")
    return x.view(-1, *x.shape[-3:])


def heat_step_cuda(T, Ci, lam, dt, dx, dy, dz):
    """One heat step by the CUDA kernel; same contract as ``heat_step_ref``."""
    if _mk.TRACE is not None:   # an analyzer check: record the plan, launch nothing
        plan = cell_plan("K1 heat_step", math.prod(T.shape[:-3]), *T.shape[-3:])
        return _mk.TRACE.kernel(plan, (T, Ci))
    if T.device.type != "cuda" or Ci.device != T.device:
        raise ValueError(
            f"heat_step_cuda: T and Ci must be on one CUDA device, got {T.device} and {Ci.device}")
    if T.dtype not in DTYPE_CODES or Ci.dtype != T.dtype:
        raise ValueError(
            f"heat_step_cuda takes {tuple(DTYPE_CODES)} with Ci of T's dtype, "
            f"got {T.dtype} and {Ci.dtype}")
    if T.shape != Ci.shape:
        raise ValueError(f"heat_step_cuda: T {tuple(T.shape)} and Ci {tuple(Ci.shape)} differ")
    Tb, Cb = _batched(T, "T"), _batched(Ci, "Ci")
    nb, nx, ny, nz = Tb.shape
    out = torch.empty(T.shape, dtype=T.dtype, device=T.device)
    if out.numel() == 0:
        return out
    plan = cell_plan("K1 heat_step", nb, nx, ny, nz)
    if max(plan.grid[1:]) > _MAX_GRID_YZ:
        raise ValueError(f"heat_step_cuda: shape {tuple(Tb.shape)} exceeds the launch grid")
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream(T.device).cuda_stream
        err = _entry()(DTYPE_CODES[T.dtype], Tb.data_ptr(), Cb.data_ptr(), out.data_ptr(),
                       nb, nx, ny, nz, *Tb.stride(), *Cb.stride(),
                       float(lam), float(dt), float(dx * dx), float(dy * dy), float(dz * dz),
                       *plan.grid, *plan.block, stream)
    if err != 0:
        raise RuntimeError(f"heat_step_cuda: launch failed with CUDA error {err}")
    heat_step_cuda.launches += 1
    return out


heat_step_cuda.launches = 0
