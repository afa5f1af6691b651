"""Device selection shared by every public entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    Without CUDA and without an explicit device this raises: the port never
    carries on on the CPU unless the caller asked for it.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def synchronize(t: torch.Tensor) -> None:
    """Wait for the work queued on ``t``'s device (a no-op on the CPU)."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
