"""Int8 gradient all-reduce with error feedback.

The port's twin of the JAX package's ``optim/compress.py``, over the
processes of one mesh axis (:mod:`repro_torch.launch.mesh`) where the
reference runs inside ``shard_map`` over a named axis.  Error feedback
(Seide et al. 2014; Karimireddy et al. 2019) accumulates the quantization
residual locally, so that the compression's bias vanishes over steps:

    g_hat, new_err = compressed_psum_mean(g + err, "pod", mesh)

The arithmetic is the reference's: a per-block scale shared by every
process (the max of the local absmax over the axis, so that the integer
sum is exact), codes rounded half to even and clipped to +-127, an int32
sum, the mean and the residual.  The reference's docstring promises a 4x
cut of the traffic against bf16, but it sums the codes as int32: the
port keeps that arithmetic, so what a process sends is 4 bytes a value
(as float32) plus a float32 scale per block of 128 (``wire_bytes``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import comm
from ..distributed import sharding
from .quant import BLOCK, _nblocks


def _group(axis_name, mesh):
    mesh = mesh if mesh is not None else getattr(sharding.current(), "mesh", None)
    if mesh is None:
        raise ValueError(f"compressed_psum_mean over {axis_name!r}: pass the mesh, or install "
                         "sharding rules over one")
    return mesh.group(axis_name)


def compressed_psum_mean(x: torch.Tensor, axis_name, mesh=None):
    """Quantized mean all-reduce of ``x`` over the processes of the mesh
    axis ``axis_name`` (``mesh``: default the installed rules' mesh).

    Uses a SHARED per-block scale (the max over the axis of the local
    absmax) so that the integer sum is exact; returns ``(mean_estimate,
    residual)`` where residual = x - the decoded local contribution (feed
    it back into the next step's input).  Every process gets the same
    mean."""
    sub = _group(axis_name, mesh)
    n = x.shape[-1]
    nb = _nblocks(n)
    xb = F.pad(x.float(), (0, nb * BLOCK - n)).reshape(*x.shape[:-1], nb, BLOCK)
    local_amax = xb.abs().amax(dim=-1)
    amax = comm.max_over(local_amax, sub)                  # shared scale
    s = torch.where(amax == 0.0, torch.ones_like(amax), amax / 127.0)
    q = torch.clamp(torch.round(xb / s[..., None]), -127, 127)
    decoded_local = q * s[..., None]
    total = comm.sum_over(q.to(torch.int32), sub).float()
    mean = (total * s[..., None] / sub.size).reshape(*x.shape[:-1], nb * BLOCK)[..., :n]
    resid = (xb - decoded_local).reshape(*x.shape[:-1], nb * BLOCK)[..., :n]
    return mean.to(x.dtype), resid.to(x.dtype)


def wire_bytes(shape, processes: int) -> dict:
    """Bytes one process sends in :func:`compressed_psum_mean` of a float32
    tensor of ``shape`` over ``processes``, as ``core.comm`` moves them
    (an all-gather of the int32 codes for the exact sum, an all-reduce of
    the float32 block maxima), against a float32 sum all-reduce of the
    same tensor (an all-gather of it): ``{"compressed", "float32",
    "bf16_int8_claim"}``, the last the reference docstring's int8 codes
    against bf16."""
    n = 1
    for k in shape:
        n *= k
    blocks = n // shape[-1] * _nblocks(shape[-1])
    peers = processes - 1
    return {"compressed": peers * (4 * n + 4 * blocks), "float32": peers * 4 * n,
            "bf16_int8_claim": (peers * n, peers * 2 * n)}


__all__ = ["compressed_psum_mean", "wire_bytes"]
