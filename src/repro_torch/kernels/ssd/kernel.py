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
C entry point, which reports its pick; both run on the tensor cores:
bfloat16 with N and P multiples of 8 on ``wgmma`` (TMA loads and stores);
float32, and bfloat16 with N or P not a multiple of 8, in 3xTF32 on
``mma.sync`` (float32's accuracy from three TF32 products).  There is no
other switch and no fallback.  The wgmma kernel loads x, B and C through
TMA tensor maps, which need 16-byte aligned views with strides of 16-byte
multiples: a view without them is copied first into a contiguous buffer
(the Mamba layer's views are never copied).
``ssd_intra_chunk_cuda.launches`` counts the launches,
``ssd_intra_chunk_cuda.by_kernel`` them by the kernel the C entry point
reported (keys :data:`KERNELS`).
:func:`c_plan` is the C entry point's launch plan, which ``chip_smoke.py``
holds against the analyzer's (:func:`repro_torch.kernels.plans.ssd_plan`)
at every shape it launched.  Under an analyzer check the wrapper records
that plan and launches nothing.

:func:`ssd_backward_cuda` launches K7's backward (``csrc/ssd_bwd.cu``,
float32, 3xTF32 on the tensor cores: two kernels, dC and then dX, ddt, ds,
dB): the gradient of the f32 forward's ``(y_diag, states)`` for ``x, dt,
s, B, C``, with the contract of
:func:`~repro_torch.kernels.ssd.ref.ssd_intra_chunk_backward_ref`.  It takes
every shape the forward's float32 kernel takes; the kernels write dB and dC
as one partial sum per slice of the heads a block takes (the C entry
point's rule, which :func:`bwd_c_plan` reports and this wrapper sizes the
partials by), which this wrapper sums over each group's slices;
``ssd_backward_cuda.launches`` counts its launches, :func:`bwd_c_plan` is
its C entry point's plan (:func:`repro_torch.kernels.plans.ssd_bwd_plan` the
analyzer's).  It is reached through :class:`_SsdCuda` only.

:func:`ssd_kernel` is the counterpart of the reference's ``ssd_pallas``:
the in-chunk decay ``s``, K7 behind :class:`_SsdCuda` (a
``torch.autograd.Function``: K7's forward, and K7's backward where autograd
asks for it), then the inter-chunk recurrence and ``Y_off`` in PyTorch,
which the reference also keeps outside its kernel.  It takes grouped B/C as
they are.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...analysis import markers as _mk
from .. import _build, tma_ready
from ..plans import H100_SMS, ssd_bwd_plan, ssd_plan
from .ref import chunk_logdecay

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_L, MAX_N, MAX_P = 64, 128, 64
KERNELS = ("3xTF32", "wgmma")   # the C entry point's codes 0 and 1, both on the tensor cores
_MAX_GRID_YZ = 65535


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load().repro_ssd_intra_chunk
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] * 2 + [ctypes.POINTER(ctypes.c_int)])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = _build.load().repro_ssd_backward
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
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


def bwd_c_plan(Ba: int, T: int, H: int, G: int, N: int, P: int, L: int) -> tuple:
    """The backward's C entry point's launch plan (both of its kernels) on
    the current device: blocks along x, y and z, threads per block, heads
    per block, bytes of dynamic shared memory of the larger kernel."""
    fn = _build.load().repro_ssd_bwd_plan
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 6)()
    err = fn(Ba, T, H, G, N, P, L, out)
    if err != 0:
        raise RuntimeError(f"repro_ssd_bwd_plan failed with CUDA error {err}")
    return tuple(out)


def kernel_for(dtype: torch.dtype, N: int, P: int) -> str:
    """The kernel K7 runs for x of ``dtype`` and widths N, P (the C entry
    point's rule): ``wgmma`` for bfloat16 with N and P multiples of 8,
    ``3xTF32`` otherwise.  Both run on the tensor cores."""
    if dtype == torch.bfloat16 and N % 8 == 0 and P % 8 == 0:
        return KERNELS[1]
    return KERNELS[0]


def check_args(x, dt, A, B, C, chunk: int, where: str = "ssd_intra_chunk_cuda") -> None:
    """Raise ``ValueError`` on what neither kernel takes: dtypes, shapes, a
    chunk that is not a divisor of T in 1..64, widths past the kernels'
    limits, the launch grid, a last axis that is not contiguous.  ``A`` is
    None for the backward, which takes ``s`` instead."""
    ins = {k: v for k, v in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)) if v is not None}
    if x.dtype not in DTYPE_CODES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"{where} takes x, B, C of one dtype in {tuple(DTYPE_CODES)}, got "
                         f"{x.dtype}, {B.dtype}, {C.dtype}")
    if (x.ndim != 4 or B.ndim != 4 or C.shape != B.shape or dt.ndim != 3
            or (A is not None and A.ndim != 1)):
        raise ValueError(f"{where}: expected x (Ba,T,H,P), dt (Ba,T,H), A (H,), B/C (Ba,T,G,N); "
                         + ", ".join(f"{k} {tuple(v.shape)}" for k, v in ins.items()))
    Ba, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if (B.shape[:2] != (Ba, T) or dt.shape != (Ba, T, H) or (A is not None and A.shape != (H,))
            or G == 0 or H % G):
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


def ssd_intra_chunk_cuda(x, dt, A, B, C, *, chunk: int = 64, s=None):
    """K7 on the card; contract of ``ssd_intra_chunk_ref``.  ``s``: the
    in-chunk log-decay ``chunk_logdecay(dt, A, chunk)`` (Ba, nc, L, H)
    float32 where the caller has it (:func:`ssd_kernel`, whose ``s`` carries
    autograd's gradient into dt and A); computed here otherwise."""
    where = "ssd_intra_chunk_cuda"
    if _mk.TRACE is not None:   # an analyzer check: record the plan, launch nothing
        Ba, T, H, P = x.shape
        G, N = B.shape[2], B.shape[3]
        plan = ssd_plan(kernel_for(x.dtype, N, P) == KERNELS[1], Ba, T, H, G, chunk, H100_SMS)
        y = _mk.TRACE.kernel(plan, (x, dt, B, C))
        states = y.new_empty((Ba, T // chunk, H, N, P), dtype=torch.float32)
        return y, states, chunk_logdecay(dt, A, chunk) if s is None else s
    ins = {"x": x, "dt": dt, "A": A, "B": B, "C": C}
    if x.device.type != "cuda" or any(v.device != x.device for v in ins.values()):
        raise ValueError(f"{where}: inputs must lie on one CUDA device, got "
                         + ", ".join(f"{k} on {v.device}" for k, v in ins.items()))
    check_args(x, dt, A, B, C, chunk)
    Ba, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    L = chunk
    if s is None:
        s = chunk_logdecay(dt, A, L)  # (Ba, nc, L, H) float32
    elif s.shape != (Ba, T // L, L, H) or s.dtype != torch.float32 or s.device != x.device:
        raise ValueError(f"{where}: s must be ({Ba}, {T // L}, {L}, {H}) float32 on "
                         f"{x.device}, got {tuple(s.shape)} {s.dtype} on {s.device}")
    want = kernel_for(x.dtype, N, P)
    if want == KERNELS[1]:
        x, B, C = (t if tma_ready(t) else t.clone(memory_format=torch.contiguous_format)
                   for t in (x, B, C))
    s = s.contiguous()
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
    ssd_intra_chunk_cuda.by_kernel[KERNELS[kernel.value]] += 1
    return y, states, s


ssd_intra_chunk_cuda.launches = 0
ssd_intra_chunk_cuda.by_kernel = dict.fromkeys(KERNELS, 0)


def ssd_backward_cuda(x, dt, s, B, C, dy, dstates):
    """K7's backward on the card, float32: ``(dx, ddt, ds, dB, dC)`` of
    :func:`ssd_intra_chunk_cuda`'s ``(y_diag, states)`` for their gradients
    ``dy`` (Ba, T, H, P) and ``dstates`` (Ba, nc, H, N, P), with the ``s``
    (Ba, nc, L, H) of the forward; the contract of
    ``ssd_intra_chunk_backward_ref``.  x, B, C and dy are read through
    their batch, time and head strides (dy is copied where its last axis is
    not contiguous); dx (Ba, T, H, P), ddt (Ba, T, H) and ds come out
    contiguous, dB and dC (Ba, T, G, N) summed over each group's heads."""
    where = "ssd_backward_cuda"
    Ba, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if _mk.TRACE is not None:   # an analyzer check: record the plan, launch nothing
        dx = _mk.TRACE.kernel(ssd_bwd_plan(Ba, T, H, G, s.shape[2], H100_SMS),
                              (x, dt, s, B, C, dy, dstates))
        return dx, dt.new_empty(dt.shape), s.new_empty(s.shape), B.new_empty(B.shape), \
            C.new_empty(C.shape)
    ins = {"x": x, "dt": dt, "s": s, "B": B, "C": C, "dy": dy, "dstates": dstates}
    if x.device.type != "cuda" or any(v.device != x.device for v in ins.values()):
        raise ValueError(f"{where}: inputs must lie on one CUDA device, got "
                         + ", ".join(f"{k} on {v.device}" for k, v in ins.items()))
    if any(v.dtype != torch.float32 for v in ins.values()):
        raise ValueError(f"{where} takes float32 only (the backward of K7's float32 kernel), "
                         "got " + ", ".join(f"{k} {v.dtype}" for k, v in ins.items()))
    L = s.shape[2] if s.ndim == 4 else 0
    check_args(x, dt, None, B, C, L, where)
    nc = T // L
    if s.shape != (Ba, nc, L, H) or dy.shape != x.shape or dstates.shape != (Ba, nc, H, N, P):
        raise ValueError(f"{where}: shapes disagree: "
                         + ", ".join(f"{k} {tuple(v.shape)}" for k, v in ins.items()))
    dy = dy if dy.stride(3) == 1 else dy.contiguous()
    dt, s, dstates = dt.contiguous(), s.contiguous(), dstates.contiguous()
    with torch.cuda.device(x.device):
        hs = bwd_c_plan(Ba, T, H, G, N, P, L)[4]
        slices = H // G // hs
        dx = torch.empty((Ba, T, H, P), dtype=x.dtype, device=x.device)
        ddt = torch.empty((Ba, T, H), dtype=torch.float32, device=x.device)
        ds = torch.empty((Ba, nc, L, H), dtype=torch.float32, device=x.device)
        dBp = torch.empty((Ba, T, G * slices, N), dtype=torch.float32, device=x.device)
        dCp = torch.empty_like(dBp)
        strides = (ctypes.c_longlong * 12)(*x.stride()[:3], *B.stride()[:3], *C.stride()[:3],
                                           *dy.stride()[:3])
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _bwd_entry()(*(t.data_ptr() for t in (x, B, C, dt, s, dy, dstates, dx, ddt, ds,
                                                     dBp, dCp)),
                           Ba, T, H, G, N, P, L, strides, stream)
    if err != 0:
        raise RuntimeError(f"{where}: launch failed with CUDA error {err}")
    ssd_backward_cuda.launches += 1
    if slices > 1:   # the slices' partial sums, in a fixed order
        dBp, dCp = (t.view(Ba, T, G, slices, N).sum(3) for t in (dBp, dCp))
    return dx, ddt, ds, dBp, dCp


ssd_backward_cuda.launches = 0


class _SsdCuda(torch.autograd.Function):
    """K7's forward and K7's backward: ``(x, dt, s, B, C) -> (y_diag,
    states)``; ``A`` comes along only for the forward's checks (its
    gradient reaches it through ``s``).  Saves the inputs; the backward
    (float32 only) recomputes C B^T, dY X^T, the decay and W.  Without
    gradients (serving) only the forward runs."""

    @staticmethod
    def forward(ctx, x, dt, s, B, C, A):
        y, states, _ = ssd_intra_chunk_cuda(x, dt, A, B, C, chunk=s.shape[2], s=s)
        ctx.save_for_backward(x, dt, s, B, C)
        return y, states

    @staticmethod
    def backward(ctx, dy, dstates):
        dx, ddt, ds, dB, dC = ssd_backward_cuda(*ctx.saved_tensors, dy, dstates)
        return dx, ddt, ds, dB, dC, None


def ssd_kernel(x, dt, A, B, C, *, chunk: int = 64, h0=None):
    """Full SSD through K7 plus the inter-chunk recurrence in PyTorch.

    Contract of ``ref.ssd_ref`` (B/C grouped ``(Ba, T, G, N)``, G | H;
    ``G = H`` is per head).  Returns ``(y (Ba, T, H, P), h_final
    (Ba, H, N, P))`` in x's dtype; the recurrence runs in float32.  The
    in-chunk decay ``s`` is computed here, in PyTorch, and K7 runs behind
    :class:`_SsdCuda`, so that autograd carries ``s``'s gradient into dt and
    A and K7's backward computes the block's."""
    Ba, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    s = chunk_logdecay(dt, A, chunk)
    y_diag, states = _SsdCuda.apply(x, dt, s, B, C, A)
    nc, L = s.shape[1], s.shape[2]
    dA_chunk = torch.exp(s[:, :, -1, :])  # (Ba, nc, H)
    h = x.new_zeros(Ba, H, N, P, dtype=torch.float32) if h0 is None else h0.float()
    h_prevs = []  # the state before each chunk
    for c in range(nc):
        h_prevs.append(h)
        h = h * dA_chunk[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)  # (Ba, nc, H, N, P)
    # Y_off[t] = exp(s_t) C_t^T h_prev, head h reading group h // (H // G)
    Cc = C.reshape(Ba, nc, L, G, N).float()
    hp = h_prevs.view(Ba, nc, G, H // G, N, P)
    y_off = torch.einsum("bclgn,bcgrnp->bclgrp", Cc, hp).reshape(Ba, nc, L, H, P)
    y_off = y_off * torch.exp(s)[..., None]
    y = y_diag + y_off.reshape(Ba, T, H, P).to(x.dtype)
    return y.to(x.dtype), h.to(x.dtype)
