"""Sequence-axis operators of the Mamba-2 layer.

The port's twin of the JAX package's ``distributed/seqpar.py``, on one card:
only :func:`seq_conv1d_causal` without a sequence axis.  The halo exchange
between sequence shards comes with the ``torch.distributed`` backend.
"""

from __future__ import annotations

import torch


def seq_conv1d_causal(x, w, axis_name: str | None = None):
    """Causal depthwise conv over the sequence.  x: (B, T, C); w: (K, C).

    Written as the reference's K-tap sum, in the same order, and not as
    ``F.conv1d``: a float32 convolution on the card runs through cuDNN in
    TF32 by default, and the prefill path would then differ from the decode
    step, which applies the same taps one token at a time.

    The left pad is always K-1 zeros.  The reference pads with
    ``zeros_like(x[:, :K-1])``, which has only T rows when T < K-1: its
    output there reads later tokens (T = 2) or is empty (T = 1).  For
    T >= K-1 the two are the same."""
    if axis_name is not None:
        raise NotImplementedError(
            "seq_conv1d_causal: a sharded sequence axis needs the torch.distributed backend "
            "(ROADMAP.md, Queue A); the port runs the whole sequence on one card")
    K = w.shape[0]
    T = x.shape[1]
    xx = torch.cat([x.new_zeros(x.shape[0], K - 1, *x.shape[2:]), x], dim=1)
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + xx[:, k : k + T] * w[K - 1 - k][None, None, :]
    return out
