"""The Mamba-2 SSD scan: K7 (``csrc/ssd.cu``) and its backward
(``csrc/ssd_bwd.cu``), their plain versions and dispatch."""

from .kernel import ssd_backward_cuda, ssd_intra_chunk_cuda, ssd_kernel
from .ops import pick_chunk, ssd_scan
from .ref import (ssd_chunked_ref, ssd_decode_step, ssd_intra_chunk_backward_ref,
                  ssd_intra_chunk_ref, ssd_ref)

__all__ = ["ssd_scan", "ssd_decode_step", "ssd_ref", "ssd_chunked_ref", "ssd_intra_chunk_ref",
           "ssd_intra_chunk_backward_ref", "ssd_intra_chunk_cuda", "ssd_backward_cuda",
           "ssd_kernel", "pick_chunk"]
