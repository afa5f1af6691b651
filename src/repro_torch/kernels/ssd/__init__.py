"""The Mamba-2 SSD scan: K7 (``csrc/ssd.cu``), its plain versions and
dispatch."""

from .kernel import ssd_intra_chunk_cuda, ssd_kernel
from .ops import pick_chunk, ssd_scan
from .ref import ssd_chunked_ref, ssd_decode_step, ssd_intra_chunk_ref, ssd_ref

__all__ = ["ssd_scan", "ssd_decode_step", "ssd_ref", "ssd_chunked_ref", "ssd_intra_chunk_ref",
           "ssd_intra_chunk_cuda", "ssd_kernel", "pick_chunk"]
