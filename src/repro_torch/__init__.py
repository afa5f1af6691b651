"""PyTorch/CUDA port of the implicit-global-grid stencil package.

The JAX package ``repro`` is the reference; this package computes the same
fields with PyTorch tensors and hand-written CUDA kernels on one NVIDIA
Hopper card.  All ``prod(dims)`` blocks of a field live on that card as
*virtual ranks*: a field is one contiguous tensor of shape
``(*dims, *local_shape)``, each block contiguous like a real rank's memory.

Public entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without CUDA and without an explicit device they raise.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
