"""Public SSD op: the kernel K7 on a CUDA tensor, the plain version on a
CPU tensor.

``use_kernel``: ``"auto" | "cuda" | "ref"`` through
:mod:`repro_torch.kernels.dispatch`, plus ``"naive"`` for the sequential
scan.  ``"ref"`` is ``ssd_chunked_ref``; ``"auto"`` on a CUDA tensor is
``ssd_kernel`` (K7), which raises on whatever it does not take.  K7 has no
backward kernel yet: on the CUDA route with grad mode on and an input that
requires grad, :func:`ssd_scan` raises ``NotImplementedError`` rather than
return a result without a gradient (``use_kernel="ref"`` stays the
caller's explicit choice).
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
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, dt, A, B, C, h0)):
        raise NotImplementedError(
            "ssd.ssd_scan: K7 has no backward kernel yet (ROADMAP.md, Queue A item 6: K7's "
            "backward comes next), so a Mamba layer does not train on the card; "
            "use_kernel='ref' takes the plain scan and its autograd")
    return ssd_kernel(x, dt, A, B, C, chunk=chunk, h0=h0)


__all__ = ["ssd_scan", "ssd_decode_step", "pick_chunk"]
