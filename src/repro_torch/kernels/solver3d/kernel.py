"""Launchers of the CUDA solver kernels K2-K5 (``csrc/solver3d.cu``).

Replace the TPU kernels ``apply_pallas``, ``residual_pallas``,
``jacobi_pallas`` and ``cheb_pallas``: ``*_cuda`` for cell centers,
``*_face_cuda`` for the face locations (``sd`` the stagger dim, ``imask``
the location's interior mask).  Each wrapper checks device, dtype, rank and
sizes, allocates its outputs with ``torch.empty`` (the kernel writes every
cell, ring included), launches on the current CUDA stream without
synchronising, and raises if the launch was refused.
``<wrapper>.launches`` counts the launches.  The kernels multiply by a
host-computed ``1/h²`` where the plain version divides by ``h²``.  The grid
and block come from :func:`repro_torch.kernels.plans.cell_plan`, the plan
the analyzer checks; under an analyzer check a wrapper records that plan,
reads its ``u`` as a radius-1 stencil and launches nothing (its count stays).

The center wrappers take an optional Helmholtz ``shift`` field (``A u =
shift * u - div(c grad u)``, the two-phase pressure operator); the
smoothers' ``dia`` must already hold it.  ``<wrapper>.shifted_launches``
counts the launches that carried one.
"""

from __future__ import annotations

import ctypes
import math
import functools

import torch

from ...analysis import markers as _mk
from .. import _build
from ..plans import cell_plan

DTYPE_CODES = {torch.float32: 0, torch.float64: 2}
OPS = {"apply": 0, "residual": 1, "jacobi": 2, "cheb": 3}
_MAX_GRID_YZ = 65535


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load().repro_solver3d
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 2 + [ctypes.c_double] * 3 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(op: str, u, c, f=None, dia=None, d=None, m=None, s=None, *, sd=None, h2,
            omega=0.0, a=0.0, b=0.0, first=False):
    where = f"solver3d.{op}{'' if sd is None else '_face'}_cuda"
    if _mk.TRACE is not None:   # an analyzer check: record the plan, launch nothing
        u = _mk.consume(u, radius=1, site=f"kernels.solver3d.kernel.{op}")
        plan = cell_plan(f"K{OPS[op] + 2} solver3d.{op}", math.prod(u.shape[:-3]),
                         *u.shape[-3:])
        return _mk.TRACE.kernel(plan, (u, c, f, dia, d, m, s), 2 if op == "cheb" else 1)
    if sd not in (None, 0, 1, 2):
        raise ValueError(f"{where}: stagger dim {sd!r} is not 0, 1 or 2")
    if sd is not None and op != "apply" and m is None:
        raise ValueError(f"{where}: a face location needs its interior mask")
    if sd is not None and s is not None:
        raise ValueError(f"{where}: Helmholtz shifts are center only")
    inputs = {"u": u, "c": c, "f": f, "dia": dia, "d": d, "m": m, "s": s}
    given = {k: v for k, v in inputs.items() if v is not None}
    if u.device.type != "cuda" or any(v.device != u.device for v in given.values()):
        raise ValueError(f"{where}: inputs must lie on one CUDA device, got "
                         + ", ".join(f"{k} on {v.device}" for k, v in given.items()))
    if u.dtype not in DTYPE_CODES or any(v.dtype != u.dtype for v in given.values()):
        raise ValueError(f"{where} takes {tuple(DTYPE_CODES)} with every input of u's dtype, got "
                         + ", ".join(f"{k} {v.dtype}" for k, v in given.items()))
    if u.ndim < 3 or any(v.shape != u.shape for v in given.values()):
        raise ValueError(f"{where}: inputs must share one (..., nx, ny, nz) shape, got "
                         + ", ".join(f"{k} {tuple(v.shape)}" for k, v in given.items()))
    if len(h2) != 3:
        raise ValueError(f"{where}: the kernels are 3-D, got {len(h2)} spacings")
    views = {k: v.view(-1, *u.shape[-3:]) for k, v in given.items()}
    nb, nx, ny, nz = views["u"].shape
    out = torch.empty(u.shape, dtype=u.dtype, device=u.device)
    dout = torch.empty_like(out) if op == "cheb" else None
    if out.numel() == 0:
        return out if dout is None else (out, dout)
    plan = cell_plan(f"K{OPS[op] + 2} solver3d.{op}", nb, nx, ny, nz)
    if max(plan.grid[1:]) > _MAX_GRID_YZ:
        raise ValueError(f"{where}: shape {(nb, nx, ny, nz)} exceeds the launch grid")
    strides = (ctypes.c_longlong * 28)(*[st for k in inputs for st in (
        views[k].stride() if k in views else (0, 0, 0, 0))])
    h2s = (ctypes.c_double * 3)(*(float(h) for h in h2))

    def ptr(k):
        return views[k].data_ptr() if k in views else None

    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = _entry()(OPS[op], DTYPE_CODES[u.dtype], -1 if sd is None else sd, ptr("u"),
                       ptr("c"), ptr("f"), ptr("dia"), ptr("d"), ptr("m"), ptr("s"),
                       out.data_ptr(),
                       None if dout is None else dout.data_ptr(), nb, nx, ny, nz, strides, h2s,
                       float(omega), float(a), float(b), int(bool(first)), *plan.grid,
                       *plan.block, stream)
    if err != 0:
        raise RuntimeError(f"{where}: launch failed with CUDA error {err}")
    return out if dout is None else (out, dout)


def _count(wrapper, shift=None) -> None:
    if _mk.TRACE is not None:   # an analyzer check launched nothing
        return
    wrapper.launches += 1
    if shift is not None:
        wrapper.shifted_launches += 1


def apply_cuda(u, c, *, h2, shift=None):
    """K2: ``A u`` on the interior, zero ring; same contract as
    ``ref.apply_op_ref``."""
    out = _launch("apply", u, c, s=shift, h2=h2)
    _count(apply_cuda, shift)
    return out


def residual_cuda(u, c, f, *, h2, shift=None):
    """K3: ``f - A u`` on the interior, zero ring."""
    out = _launch("residual", u, c, f, s=shift, h2=h2)
    _count(residual_cuda, shift)
    return out


def jacobi_cuda(u, c, f, dia, *, omega, h2, shift=None):
    """K4: one damped-Jacobi sweep ``u + (omega * (f - A u)) / dia``, the
    ring of ``u`` passed through."""
    out = _launch("jacobi", u, c, f, dia, s=shift, h2=h2, omega=omega)
    _count(jacobi_cuda, shift)
    return out


def cheb_cuda(u, c, f, dia, d, *, a, b, h2, shift=None):
    """K5: one Chebyshev step -> ``(u, d)``; ``a=None`` is the first step,
    which does not read ``d`` (pass None or any tensor of u's shape)."""
    first = a is None
    out = _launch("cheb", u, c, f, dia, None if first else d, s=shift, h2=h2,
                  a=0.0 if first else a, b=b, first=first)
    _count(cheb_cuda, shift)
    return out


def apply_face_cuda(u, c, *, sd, h2):
    """K2 face: the raw, unmasked roll-form ``A u`` of a field staggered
    along ``sd``; same contract as ``ref.apply_op_ref(loc=<face>)``."""
    out = _launch("apply", u, c, sd=sd, h2=h2)
    _count(apply_face_cuda)
    return out


def residual_face_cuda(u, c, f, imask, *, sd, h2):
    """K3 face: ``(f - A u) * imask`` over the whole block."""
    out = _launch("residual", u, c, f, m=imask, sd=sd, h2=h2)
    _count(residual_face_cuda)
    return out


def jacobi_face_cuda(u, c, f, dia, imask, *, sd, omega, h2):
    """K4 face: ``u + (omega * ((f - A u) * imask)) / dia`` over the whole
    block."""
    out = _launch("jacobi", u, c, f, dia, m=imask, sd=sd, h2=h2, omega=omega)
    _count(jacobi_face_cuda)
    return out


def cheb_face_cuda(u, c, f, dia, imask, d, *, sd, a, b, h2):
    """K5 face: one Chebyshev step -> ``(u, d)`` over the whole block;
    ``a=None`` is the first step, which does not read ``d``."""
    first = a is None
    out = _launch("cheb", u, c, f, dia, None if first else d, imask, sd=sd, h2=h2,
                  a=0.0 if first else a, b=b, first=first)
    _count(cheb_face_cuda)
    return out


WRAPPERS = (apply_cuda, residual_cuda, jacobi_cuda, cheb_cuda,
            apply_face_cuda, residual_face_cuda, jacobi_face_cuda, cheb_face_cuda)
for _fn in WRAPPERS:
    _fn.launches = 0
for _fn in WRAPPERS[:4]:
    _fn.shifted_launches = 0
