"""Context parallelism: the paper's halo technique as a language-model feature.

The port's twin of the JAX package's ``distributed/context_parallel.py``.
The model's forward runs with the SEQUENCE sharded over the processes of
the default ``torch.distributed`` group (the reference's mesh axis; see
:mod:`.axis`), each process holding one contiguous shard of the tokens and
the whole, replicated parameters.  Per layer type:

* sliding-window attention -> one kv halo from the left neighbour
  (:func:`.seqpar.seq_sliding_window_attention`, K6 over T + W keys);
* full attention           -> ring attention (:func:`.ring.ring_attention`);
* Mamba conv               -> a K-1 token halo;
* Mamba SSD states         -> a log2(R)-step doubling scan (K7 on the shard).

Each process builds the same parameters (from the same seed, or through
``convert.params_from_reference``) and passes the whole token batch.
"""

from __future__ import annotations

import torch

from . import axis as _axis


def context_parallel_fwd(model, cfg, tokens, *, axis: str = "model", remat: str = "none",
                         use_kernel: str = "auto"):
    """This process's shard of the final hidden state, (B, T/R, d).

    tokens: (B, T), the whole batch on every process, T divisible by the
    group's size R.  The shard of rank r holds positions
    ``r T/R + arange(T/R)``."""
    from ..models import transformer as tf

    if cfg != model.cfg:
        raise ValueError(f"cfg {cfg.name!r} is not the model's config {model.cfg.name!r}")
    R, r = _axis.size(axis), _axis.index(axis)
    B, T = tokens.shape[:2]
    if T % R:
        raise ValueError(f"context parallelism: T={T} is not divisible by the {R} processes")
    T_l = T // R
    toks = tokens[:, r * T_l:(r + 1) * T_l].to(model.device)
    positions = r * T_l + torch.arange(T_l, device=model.device)
    h, _, _ = tf.fwd(model, toks, mode="train", positions=positions, seq_axis=axis, remat=remat,
                     use_kernel=use_kernel)
    return h


def context_parallel_logits(model, cfg, tokens, *, axis: str = "model", remat: str = "none",
                            use_kernel: str = "auto"):
    """Teacher-forced logits with the sequence sharded over the processes of
    the default group.

    tokens: (B, T) with T divisible by the group's size R, the whole batch
    on every process.  The parameters are replicated across the shards.
    Returns this process's shard of the logits, (B, T/R, padded_vocab)
    float32; without a group, all of them.  ``use_kernel`` as the model
    takes it (K6 and K7 on the card with ``"auto"``)."""
    from ..models import transformer as tf

    h = context_parallel_fwd(model, cfg, tokens, axis=axis, remat=remat, use_kernel=use_kernel)
    return tf.logits_fn(model, h)


__all__ = ["context_parallel_fwd", "context_parallel_logits"]
