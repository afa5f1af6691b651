"""Launchers of the CUDA kernel K6 (``csrc/swa.cu``), causal sliding-window
GQA flash attention, and of its backward (``csrc/swa_bwd.cu``).

:func:`swa_attention_cuda` replaces the TPU kernel ``swa_pallas`` and
computes the function of :func:`~repro_torch.kernels.swa.ref.swa_ref`:
q ``(B, H, T, D)``, k/v ``(B, Hkv, S, D)``, the queries being the last T
of the S keys.  Unlike ``swa_pallas`` it takes any T >= 1 and S >= T (the
kernel masks its ragged tiles), and any batch, head and time strides with
D contiguous: the model passes transposed views of its ``(B, T, H, D)``
projections.  The output is allocated ``(B, T, H, D)`` with
``torch.empty`` and returned as its ``(B, H, T, D)`` view.

The dtype alone picks the kernel, inside the C entry point, and both run on
the tensor cores: bfloat16 on ``wgmma``, float32 in 3xTF32 on ``mma.sync``
(each operand split into two TF32 parts, three products summed in
float32: float32's accuracy).  There is no other switch.  The bfloat16
kernel loads q, k and v through TMA tensor maps, which need 16-byte aligned
views with strides of 16-byte multiples: a bfloat16 view without them is
copied first into an aligned buffer (the model's views are never copied).
The float32 kernels read any view as it is (``cp.async`` in 16-byte pieces
where it is aligned, else in 4-byte ones).

It checks device, dtype (float32, bfloat16), shapes, strides and the
kernel's limits (D a multiple of 4, at most 256), raises on anything
else, launches on the current CUDA stream without synchronising, and
raises if the launch was refused.  ``swa_attention_cuda.launches`` counts
the launches, ``swa_attention_cuda.tc_launches`` those the C entry point
reports as tensor-core launches (every launch of either dtype).
:func:`c_plan` is the C entry point's launch plan, which ``chip_smoke.py``
holds against the analyzer's (:func:`repro_torch.kernels.plans.swa_plan`)
at every shape it launched.
Under an analyzer check the wrapper records that plan and launches nothing.

With ``return_lse=True`` (float32 only) the forward also returns each
row's log-sum-exp of the scaled logits, ``(B, H, T)`` float32, which
:func:`swa_backward_cuda` takes: the backward of the float32 kernel, three
launches on the current stream (Drow; dK/dV and dQ in 3xTF32 on the
tensor cores; no atomics), counted once per call in
``swa_backward_cuda.launches``.  Its plans are :func:`bwd_c_plan` and
:func:`repro_torch.kernels.plans.swa_bwd_plans`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...analysis import markers as _mk
from .. import _build, tma_ready
from ..plans import H100_SMS, swa_bwd_plans, swa_plan

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 256
_MAX_GRID_Y = 65535


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load().repro_swa_attention
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = _build.load().repro_swa_backward
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def c_plan(dtype: torch.dtype, B: int, H: int, T: int, D: int) -> tuple:
    """The C entry point's launch plan for (B, H, T) at head width D: blocks
    along x and y, threads per block, q rows per block."""
    fn = _build.load().repro_swa_plan
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 4)()
    err = fn(DTYPE_CODES[dtype], B, H, T, D, out)
    if err != 0:
        raise RuntimeError(f"repro_swa_plan failed with CUDA error {err}")
    return tuple(out)


def bwd_c_plan(B: int, H: int, Hkv: int, T: int, S: int, D: int) -> tuple:
    """The backward's C entry point's plans: for Drow, dK/dV and dQ, blocks
    along x and y, threads per block, rows per block."""
    fn = _build.load().repro_swa_bwd_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 12)()
    err = fn(B, H, Hkv, T, S, D, out)
    if err != 0:
        raise RuntimeError(f"repro_swa_bwd_plan failed with CUDA error {err}")
    return tuple(tuple(out[4 * i:4 * i + 4]) for i in range(3))


def _aligned_copy(t):
    """The values of a (B, H, T, D) view in a fresh (B, T, H, D8) buffer, D8
    the next multiple of 8, seen through the same (B, H, T, D) view."""
    B, H, T, D = t.shape
    buf = t.new_zeros(B, T, H, -(-D // 8) * 8)
    buf[..., :D] = t.transpose(1, 2)
    return buf[..., :D].transpose(1, 2)


def swa_attention_cuda(q, k, v, *, window: int, scale: float | None = None,
                       return_lse: bool = False):
    """K6 on the card; the contract of ``swa_ref`` for any T >= 1, S >= T.
    ``return_lse``: also return the rows' log-sum-exp (float32 only)."""
    where = "swa_attention_cuda"
    if _mk.TRACE is not None:   # an analyzer check: record the plan, launch nothing
        B, H, T, D = q.shape
        plan = swa_plan(q.dtype == torch.bfloat16, B, H, T, D, H100_SMS)
        if not return_lse:
            return _mk.TRACE.kernel(plan, (q, k, v))
        o, lse = _mk.TRACE.kernel(plan, (q, k, v), n_out=2)
        return o, lse[..., 0].float()
    if return_lse and q.dtype != torch.float32:
        raise ValueError(f"{where}: the log-sum-exp output is float32 only, got {q.dtype}")
    ins = {"q": q, "k": k, "v": v}
    if q.device.type != "cuda" or any(t.device != q.device for t in ins.values()):
        raise ValueError(f"{where}: inputs must lie on one CUDA device, got "
                         + ", ".join(f"{n} on {t.device}" for n, t in ins.items()))
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{where} takes q, k, v of one dtype in {tuple(DTYPE_CODES)}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"{where}: expected q (B,H,T,D), k/v (B,Hkv,S,D); "
                         + ", ".join(f"{n} {tuple(t.shape)}" for n, t in ins.items()))
    B, H, T, D = q.shape
    _, Hkv, S, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"{where}: shapes disagree: "
                         + ", ".join(f"{n} {tuple(t.shape)}" for n, t in ins.items()))
    if not (T >= 1 and S >= T):
        raise ValueError(f"{where}: needs T >= 1 queries, the last T of S >= T keys; "
                         f"got T={T}, S={S}")
    if not (0 < D <= MAX_D and D % 4 == 0):
        raise ValueError(f"{where}: the kernel takes D <= {MAX_D}, a multiple of 4, got D={D}")
    if window < 1:
        raise ValueError(f"{where}: window must be >= 1, got {window}")
    if B * H > _MAX_GRID_Y:
        raise ValueError(f"{where}: B*H={B * H} exceeds the launch grid")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError(f"{where}: the last axis of q, k and v must be contiguous")
    scale = D ** -0.5 if scale is None else float(scale)
    if q.dtype == torch.bfloat16:
        q, k, v = (t if tma_ready(t) else _aligned_copy(t) for t in (q, k, v))
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device) if return_lse else None
    if o.numel() == 0:
        return (o, lse) if return_lse else o
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *o.stride()[:3])
    kernel = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _entry()(DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       o.data_ptr(), B, H, Hkv, T, S, D, min(window, S), scale, strides, stream,
                       ctypes.byref(kernel), None if lse is None else lse.data_ptr())
    if err != 0:
        raise RuntimeError(f"{where}: launch failed with CUDA error {err}")
    swa_attention_cuda.launches += 1
    swa_attention_cuda.tc_launches += int(kernel.value == 1)
    return (o, lse) if return_lse else o


def swa_backward_cuda(q, k, v, o, do, lse, *, window: int, scale: float | None = None):
    """K6's backward on the card, float32: ``(dq, dk, dv)`` of
    :func:`swa_attention_cuda`'s output ``o`` for its gradient ``do``, with
    the ``lse`` that the forward returned.  Takes q, o, do (B, H, T, D) and
    k, v (B, Hkv, S, D) with any batch, head and time strides (``do`` is
    copied where its last axis is not contiguous); returns dq (B, H, T, D)
    and dk, dv (B, Hkv, S, D) as views of (B, T, H, D) and (B, S, Hkv, D)
    buffers, the layout of the model's projections."""
    where = "swa_backward_cuda"
    B, H, T, D = q.shape
    if _mk.TRACE is not None:   # an analyzer check: record the plans, launch nothing
        drow_p, dkdv_p, dq_p = swa_bwd_plans(B, H, k.shape[1], T, k.shape[2], D)
        _mk.TRACE.kernel(drow_p, (o, do))
        dk, dv = _mk.TRACE.kernel(dkdv_p, (k, v, q, do, lse), n_out=2)
        return _mk.TRACE.kernel(dq_p, (q, k, v, do, lse)), dk, dv
    ins = {"q": q, "k": k, "v": v, "o": o, "do": do, "lse": lse}
    if q.device.type != "cuda" or any(t.device != q.device for t in ins.values()):
        raise ValueError(f"{where}: inputs must lie on one CUDA device, got "
                         + ", ".join(f"{n} on {t.device}" for n, t in ins.items()))
    if any(t.dtype != torch.float32 for t in ins.values()):
        raise ValueError(f"{where} takes float32 only (the backward of K6's float32 kernel), "
                         "got " + ", ".join(f"{n} {t.dtype}" for n, t in ins.items()))
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"{where}: expected q (B,H,T,D), k/v (B,Hkv,S,D); "
                         + ", ".join(f"{n} {tuple(t.shape)}" for n, t in ins.items()))
    _, Hkv, S, _ = k.shape
    if (k.shape[0] != B or k.shape[3] != D or Hkv == 0 or H % Hkv or o.shape != q.shape
            or do.shape != q.shape or lse.shape != (B, H, T)):
        raise ValueError(f"{where}: shapes disagree: "
                         + ", ".join(f"{n} {tuple(t.shape)}" for n, t in ins.items()))
    if not (T >= 1 and S >= T and 0 < D <= MAX_D and D % 4 == 0 and window >= 1):
        raise ValueError(f"{where}: needs T >= 1, S >= T, D <= {MAX_D} a multiple of 4 and "
                         f"window >= 1; got T={T}, S={S}, D={D}, window={window}")
    if B * H > _MAX_GRID_Y:
        raise ValueError(f"{where}: B*H={B * H} exceeds the launch grid")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1 or o.stride(3) != 1:
        raise ValueError(f"{where}: the last axis of q, k, v and o must be contiguous")
    do = do if do.stride(3) == 1 else do.contiguous()
    lse = lse.contiguous()
    scale = D ** -0.5 if scale is None else float(scale)
    drow = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    dq = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((B, S, Hkv, D), dtype=k.dtype, device=k.device).transpose(1, 2)
    dv = torch.empty((B, S, Hkv, D), dtype=v.dtype, device=v.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 24)(*(n for t in (q, k, v, o, do, dq, dk, dv)
                                         for n in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_entry()(*(t.data_ptr() for t in (q, k, v, o, do, lse, drow, dq, dk, dv)),
                           B, H, Hkv, T, S, D, min(window, S), scale, strides, stream)
    if err != 0:
        raise RuntimeError(f"{where}: launch failed with CUDA error {err}")
    swa_backward_cuda.launches += 1
    return dq, dk, dv


swa_attention_cuda.launches = 0
swa_attention_cuda.tc_launches = 0
swa_backward_cuda.launches = 0
