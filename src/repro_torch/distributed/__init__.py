"""Sequence-axis operators (one card; see :mod:`.seqpar`)."""

from .seqpar import seq_conv1d_causal

__all__ = ["seq_conv1d_causal"]
