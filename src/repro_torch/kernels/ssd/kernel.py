"""Launcher of the CUDA kernel K7 (``csrc/ssd.cu``), the intra-chunk block
of the Mamba-2 SSD scan, and the full SSD around it.

:func:`ssd_intra_chunk_cuda` replaces the TPU kernel
``ssd_intra_chunk_pallas``: same arguments and results as
:func:`~repro_torch.kernels.ssd.ref.ssd_intra_chunk_ref`.  It checks
device, dtypes, shapes, strides and the kernels' limits (:func:`check_args`:
L <= 64, N <= 128, P <= 64, N and P multiples of 4), raises on anything
else, allocates its outputs with ``torch.empty``, launches on the current
CUDA stream without synchronising, and raises if the launch was refused.

Which kernel runs is one explicit rule (:func:`kernel_for`), applied by the
C entry point, which reports its pick: bfloat16 with N and P multiples of 8
runs on the tensor cores (``wgmma``, TMA); float32, and bfloat16 with N or P
not a multiple of 8, on the CUDA cores (the first, float32 form).  There is
no other switch and no fallback.  The tensor-core kernel loads x, B and C
through TMA tensor maps, which need 16-byte aligned views with strides of
16-byte multiples: a view without them is copied first into a contiguous
buffer (the Mamba layer's views are never copied).
``ssd_intra_chunk_cuda.launches`` counts the launches,
``ssd_intra_chunk_cuda.tc_launches`` those on the tensor cores.
:func:`c_plan` is the C entry point's launch plan, which ``chip_smoke.py``
holds against the analyzer's (:func:`repro_torch.kernels.plans.ssd_plan`)
at every shape it launched.  Under an analyzer check the wrapper records
that plan and launches nothing.

:func:`ssd_kernel` is the counterpart of the reference's ``ssd_pallas``:
K7, then the inter-chunk recurrence and ``Y_off`` in PyTorch, which the
reference also keeps outside its kernel.  It takes grouped B/C as they are.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...analysis import markers as _mk
from .. import _build, tma_ready
from ..plans import H100_SMS, ssd_plan
from .ref import chunk_logdecay

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_L, MAX_N, MAX_P = 64, 128, 64
KERNELS = ("CUDA cores", "tensor cores")   # the C entry point's codes 0 and 1
_MAX_GRID_YZ = 65535


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load().repro_ssd_intra_chunk
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] * 2 + [ctypes.POINTER(ctypes.c_int)])
    fn.restype = ctypes.c_int
    return fn


def c_plan(dtype: torch.dtype, Ba: int, T: int, H: int, G: int, N: int, P: int, L: int) -> tuple:
    """The C entry point's launch plan: blocks along x, y and z, threads
    per block, heads per block."""
    fn = _build.load().repro_ssd_plan
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 5)()
    err = fn(DTYPE_CODES[dtype], Ba, T, H, G, N, P, L, out)
    if err != 0:
        raise RuntimeError(f"repro_ssd_plan failed with CUDA error {err}")
    return tuple(out)


def kernel_for(dtype: torch.dtype, N: int, P: int) -> str:
    """The kernel K7 runs on for x of ``dtype`` and widths N, P (the C entry
    point's rule): the tensor cores for bfloat16 with N and P multiples of
    8, the CUDA cores otherwise."""
    if dtype == torch.bfloat16 and N % 8 == 0 and P % 8 == 0:
        return KERNELS[1]
    return KERNELS[0]


def check_args(x, dt, A, B, C, chunk: int) -> None:
    """Raise ``ValueError`` on what neither kernel takes: dtypes, shapes, a
    chunk that is not a divisor of T in 1..64, widths past the kernels'
    limits, the launch grid, a last axis that is not contiguous."""
    where = "ssd_intra_chunk_cuda"
    ins = {"x": x, "dt": dt, "A": A, "B": B, "C": C}
    if x.dtype not in DTYPE_CODES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"{where} takes x, B, C of one dtype in {tuple(DTYPE_CODES)}, got "
                         f"{x.dtype}, {B.dtype}, {C.dtype}")
    if x.ndim != 4 or B.ndim != 4 or C.shape != B.shape or dt.ndim != 3 or A.ndim != 1:
        raise ValueError(f"{where}: expected x (Ba,T,H,P), dt (Ba,T,H), A (H,), B/C (Ba,T,G,N); "
                         + ", ".join(f"{k} {tuple(v.shape)}" for k, v in ins.items()))
    Ba, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if B.shape[:2] != (Ba, T) or dt.shape != (Ba, T, H) or A.shape != (H,) or G == 0 or H % G:
        raise ValueError(f"{where}: shapes disagree: "
                         + ", ".join(f"{k} {tuple(v.shape)}" for k, v in ins.items()))
    L = chunk
    if not 1 <= L <= MAX_L or T % L:
        raise ValueError(f"{where}: chunk L={L} must divide T={T} and lie in 1..{MAX_L}")
    if not (0 < N <= MAX_N and N % 4 == 0 and 0 < P <= MAX_P and P % 4 == 0):
        raise ValueError(f"{where}: the kernel takes N <= {MAX_N} and P <= {MAX_P}, both "
                         f"multiples of 4, got N={N}, P={P}")
    if H > _MAX_GRID_YZ or Ba > _MAX_GRID_YZ:
        raise ValueError(f"{where}: H={H} or Ba={Ba} exceeds the launch grid")
    if x.stride(3) != 1 or B.stride(3) != 1 or C.stride(3) != 1:
        raise ValueError(f"{where}: the last axis of x, B and C must be contiguous")


def ssd_intra_chunk_cuda(x, dt, A, B, C, *, chunk: int = 64):
    """K7 on the card; contract of ``ssd_intra_chunk_ref``."""
    where = "ssd_intra_chunk_cuda"
    if _mk.TRACE is not None:   # an analyzer check: record the plan, launch nothing
        Ba, T, H, P = x.shape
        G, N = B.shape[2], B.shape[3]
        plan = ssd_plan(kernel_for(x.dtype, N, P) == KERNELS[1], Ba, T, H, G, chunk, H100_SMS)
        y = _mk.TRACE.kernel(plan, (x, dt, B, C))
        states = y.new_empty((Ba, T // chunk, H, N, P), dtype=torch.float32)
        return y, states, chunk_logdecay(dt, A, chunk)
    ins = {"x": x, "dt": dt, "A": A, "B": B, "C": C}
    if x.device.type != "cuda" or any(v.device != x.device for v in ins.values()):
        raise ValueError(f"{where}: inputs must lie on one CUDA device, got "
                         + ", ".join(f"{k} on {v.device}" for k, v in ins.items()))
    check_args(x, dt, A, B, C, chunk)
    Ba, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    L = chunk
    want = kernel_for(x.dtype, N, P)
    if want == KERNELS[1]:
        x, B, C = (t if tma_ready(t) else t.clone(memory_format=torch.contiguous_format)
                   for t in (x, B, C))
    s = chunk_logdecay(dt, A, L)  # (Ba, nc, L, H) float32
    dtf = dt.float().contiguous()
    y = torch.empty((Ba, T, H, P), dtype=x.dtype, device=x.device)
    states = torch.empty((Ba, T // L, H, N, P), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, states, s
    strides = (ctypes.c_longlong * 9)(*x.stride()[:3], *B.stride()[:3], *C.stride()[:3])
    kernel = ctypes.c_int(-1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry()(DTYPE_CODES[x.dtype], x.data_ptr(), B.data_ptr(), C.data_ptr(),
                       dtf.data_ptr(), s.data_ptr(), y.data_ptr(), states.data_ptr(),
                       Ba, T, H, G, N, P, L, strides, stream, ctypes.byref(kernel))
    if err != 0:
        raise RuntimeError(f"{where}: launch failed with CUDA error {err}")
    if KERNELS[kernel.value] != want:
        raise RuntimeError(f"{where}: the C entry point ran the {KERNELS[kernel.value]} kernel, "
                           f"the rule says the {want} one")
    ssd_intra_chunk_cuda.launches += 1
    ssd_intra_chunk_cuda.tc_launches += int(kernel.value == 1)
    return y, states, s


ssd_intra_chunk_cuda.launches = 0
ssd_intra_chunk_cuda.tc_launches = 0


def ssd_kernel(x, dt, A, B, C, *, chunk: int = 64, h0=None):
    """Full SSD through K7 plus the inter-chunk recurrence in PyTorch.

    Contract of ``ref.ssd_ref`` (B/C grouped ``(Ba, T, G, N)``, G | H;
    ``G = H`` is per head).  Returns ``(y (Ba, T, H, P), h_final
    (Ba, H, N, P))`` in x's dtype; the recurrence runs in float32."""
    Ba, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    y_diag, states, s = ssd_intra_chunk_cuda(x, dt, A, B, C, chunk=chunk)
    nc, L = s.shape[1], s.shape[2]
    dA_chunk = torch.exp(s[:, :, -1, :])  # (Ba, nc, H)
    h = x.new_zeros(Ba, H, N, P, dtype=torch.float32) if h0 is None else h0.float()
    h_prevs = torch.empty_like(states)  # the state before each chunk
    for c in range(nc):
        h_prevs[:, c] = h
        h = h * dA_chunk[:, c, :, None, None] + states[:, c]
    # Y_off[t] = exp(s_t) C_t^T h_prev, head h reading group h // (H // G)
    Cc = C.reshape(Ba, nc, L, G, N).float()
    hp = h_prevs.view(Ba, nc, G, H // G, N, P)
    y_off = torch.einsum("bclgn,bcgrnp->bclgrp", Cc, hp).reshape(Ba, nc, L, H, P)
    y_off = y_off * torch.exp(s)[..., None]
    y = y_diag + y_off.reshape(Ba, T, H, P).to(x.dtype)
    return y.to(x.dtype), h.to(x.dtype)
