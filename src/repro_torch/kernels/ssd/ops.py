"""Public SSD op: the kernel K7 on a CUDA tensor, the plain version on a
CPU tensor.

``use_kernel``: ``"auto" | "cuda" | "ref"`` through
:mod:`repro_torch.kernels.dispatch`, plus ``"naive"`` for the sequential
scan.  ``"ref"`` is ``ssd_chunked_ref``; ``"auto"`` on a CUDA tensor is
``ssd_kernel`` (K7), which raises on whatever it does not take.  K7 runs
there behind a ``torch.autograd.Function`` (``kernel._SsdCuda``): where
autograd asks for the block's gradient (training), K7's backward kernel
(``ssd_backward_cuda``, ``csrc/ssd_bwd.cu``, float32) computes it; the
in-chunk decay ``s``, the inter-chunk recurrence and ``Y_off`` stay in
PyTorch and its autograd.  bfloat16 with gradients wanted raises here,
naming float32.  A CPU tensor keeps the plain scan and plain autograd.
"""

from __future__ import annotations

import torch

from .. import dispatch
from .kernel import ssd_kernel
from .ref import ssd_chunked_ref, ssd_decode_step, ssd_ref


def pick_chunk(T: int, chunk: int) -> int:
    """The reference's chunk: ``chunk`` if it divides T, else the largest
    divisor of T not above ``min(chunk, T)``."""
    if T % chunk:
        chunk = max(c for c in range(1, min(chunk, T) + 1) if T % c == 0)
    return chunk


def ssd_scan(x, dt, A, B, C, *, chunk: int = 64, use_kernel: str = "auto", h0=None):
    """Selective-SSM scan (Mamba-2 SSD); see ``ref.ssd_ref`` for the
    contract.  B/C are grouped: (Ba, T, G, N)."""
    chunk = pick_chunk(x.shape[1], chunk)
    if use_kernel == "naive":
        return ssd_ref(x, dt, A, B, C, h0=h0)
    if dispatch.resolve(use_kernel, x, where="ssd.ssd_scan") == "ref":
        return ssd_chunked_ref(x, dt, A, B, C, chunk=chunk, h0=h0)
    if x.dtype != torch.float32 and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, A, B, C, h0)):
        raise NotImplementedError(
            f"ssd.ssd_scan: K7's backward kernel takes float32, got {x.dtype} with "
            "gradients required (train in float32, or use_kernel='ref')")
    return ssd_kernel(x, dt, A, B, C, chunk=chunk, h0=h0)


__all__ = ["ssd_scan", "ssd_decode_step", "pick_chunk"]
