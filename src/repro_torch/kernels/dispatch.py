"""The ``use_kernel`` contract of every kernel of the port.

    use_kernel = "auto" | "cuda" | "ref"

* ``"ref"`` — the plain PyTorch version, on any device.
* ``"auto"`` — the CUDA kernel for a CUDA tensor and the plain version for
  a CPU tensor, and nothing else.  A shape or dtype the kernel does not
  take raises on a CUDA tensor: there is no quiet fallback.
* ``"cuda"`` — the kernel is demanded; a tensor that is not on a CUDA
  device raises.
"""

from __future__ import annotations

import torch

from ..analysis import markers as _mk

MODES = ("auto", "cuda", "ref")


def resolve(use_kernel: str, x: torch.Tensor, *, where: str = "kernel") -> str:
    """``"cuda"`` or ``"ref"`` for a call on tensor ``x``."""
    if use_kernel not in MODES:
        raise ValueError(f"{where}: unknown use_kernel={use_kernel!r}; pick from {MODES}")
    if use_kernel == "ref":
        return "ref"
    dev = _mk.device_type(x)   # inside an analyzer check: the checked device
    if dev == "cuda":
        return "cuda"
    if use_kernel == "auto" and dev == "cpu":
        return "ref"
    raise ValueError(
        f"{where}: use_kernel={use_kernel!r} needs a CUDA tensor for the kernel, "
        f"got one on {x.device} (use 'ref' for the plain PyTorch version)")
