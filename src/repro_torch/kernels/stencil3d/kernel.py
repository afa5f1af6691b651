"""Launcher of the CUDA heat-step kernel K1 (``csrc/heat_step.cu``).

Replaces the TPU kernel ``heat_step_pallas``.  The wrapper checks device,
dtype, rank and sizes, allocates the output with ``torch.empty``, launches
on the current CUDA stream without synchronising, and raises if the launch
was refused.  ``heat_step_cuda.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_TILE = (2, 4, 32)       # cells per thread block along x, y, z (heat_step.cu)
_MAX_GRID_YZ = 65535


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load().repro_heat_step
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 8 + [ctypes.c_double] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _batched(x: torch.Tensor, name: str) -> torch.Tensor:
    """``(..., nx, ny, nz)`` as a ``(B, nx, ny, nz)`` view, never a copy."""
    if x.ndim < 3:
        raise ValueError(f"heat_step_cuda: {name} must be (..., nx, ny, nz), got {tuple(x.shape)}")
    return x.view(-1, *x.shape[-3:])


def heat_step_cuda(T, Ci, lam, dt, dx, dy, dz):
    """One heat step by the CUDA kernel; same contract as ``heat_step_ref``."""
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
    if -(-ny // _TILE[1]) > _MAX_GRID_YZ or -(-nx // _TILE[0]) * nb > _MAX_GRID_YZ:
        raise ValueError(f"heat_step_cuda: shape {tuple(Tb.shape)} exceeds the launch grid")
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream(T.device).cuda_stream
        err = _entry()(DTYPE_CODES[T.dtype], Tb.data_ptr(), Cb.data_ptr(), out.data_ptr(),
                       nb, nx, ny, nz, *Tb.stride(), *Cb.stride(),
                       float(lam), float(dt), float(dx * dx), float(dy * dy), float(dz * dz),
                       stream)
    if err != 0:
        raise RuntimeError(f"heat_step_cuda: launch failed with CUDA error {err}")
    heat_step_cuda.launches += 1
    return out


heat_step_cuda.launches = 0
