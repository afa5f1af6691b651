"""Device selection shared by every public entry point of the port."""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card: the
    current one, or under a ``torch.distributed`` group card ``LOCAL_RANK
    % device_count`` (the group rank where ``LOCAL_RANK`` is not set), so
    the processes of a node share its cards round robin.

    Without CUDA and without an explicit device this raises: the port never
    carries on on the CPU unless the caller asked for it.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    from .core import comm

    if comm.initialized():
        local = int(os.environ.get("LOCAL_RANK", comm.rank()))
        return torch.device("cuda", local % torch.cuda.device_count())
    return torch.device("cuda", torch.cuda.current_device())


def synchronize(t: torch.Tensor) -> None:
    """Wait for the work queued on ``t``'s device (a no-op on the CPU)."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
