"""Sliding-window attention: K6 (``csrc/swa.cu``) and its backward
(``csrc/swa_bwd.cu``), their plain versions and dispatch."""

from .kernel import swa_attention_cuda, swa_backward_cuda
from .ops import sliding_window_attention, swa_attention
from .ref import swa_backward_ref, swa_lse_ref, swa_ref

__all__ = ["sliding_window_attention", "swa_attention", "swa_attention_cuda",
           "swa_backward_cuda", "swa_backward_ref", "swa_lse_ref", "swa_ref"]
