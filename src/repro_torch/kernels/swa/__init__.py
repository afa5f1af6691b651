"""Sliding-window attention: K6 (``csrc/swa.cu``), its plain version and
dispatch."""

from .kernel import swa_attention_cuda
from .ops import sliding_window_attention, swa_attention
from .ref import swa_ref

__all__ = ["sliding_window_attention", "swa_attention", "swa_attention_cuda", "swa_ref"]
