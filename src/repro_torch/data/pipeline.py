"""Deterministic synthetic LM data: a batch is a pure function of (seed, step).

The port's twin of the JAX package's ``data/pipeline.py``.  Each batch is
drawn on its device by a ``torch.Generator`` of that device seeded with a
fixed function of (seed, step) (:func:`batch_seed`): no host-to-device
traffic, and a resume after a checkpoint restore is exact (the step index
is the pipeline's whole state).

The distribution is the reference's: Zipf-ish unigrams (a squared uniform
times V - 1, truncated), and short-range copies (with probability 0.5 a
token is the previous one + 1 mod V), so that the loss has signal and a
trained model beats the uniform floor; labels are the tokens shifted by
one, -100 at the last position.  The numbers are not JAX's: PyTorch's
generators cannot repeat the threefry stream of ``jax.random.fold_in``, so
the same (seed, step) gives other tokens in the two packages.  Tests that
hold the port against the reference feed both the reference's batches.

Under sharding rules every process draws the global batch of a step and
keeps its rows (:func:`local_rows`): those of its coordinate along the
batch's mesh axes, as the reference's ``batch`` axis splits them.
"""

from __future__ import annotations

import dataclasses

import torch

from .._device import resolve_device
from ..distributed import sharding

_MASK64 = (1 << 64) - 1


def batch_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed for (seed, step): splitmix64 of both."""
    z = ((int(seed) & 0xFFFFFFFF) << 32 | (int(step) & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15
    z &= _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


@dataclasses.dataclass(frozen=True)
class SyntheticLMData:
    """``batch_at(step)``: the batch of a step, on ``device`` (default the
    CUDA card; ``"cpu"`` for the plain path)."""

    vocab: int
    batch: int
    seq: int
    seed: int = 0
    device: str | None = None

    def batch_at(self, step):
        return synthetic_batch(self, step)


def synthetic_batch(d: SyntheticLMData, step) -> dict:
    """``{"tokens": (B, T) int64, "labels": (B, T) int64}`` for a step index
    (an int, or a 0-d tensor, read once to seed the generator)."""
    device = resolve_device(d.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(batch_seed(d.seed, int(step)))
    B, T, V = d.batch, d.seq, d.vocab
    u = torch.rand((B, T), generator=gen, device=device)
    toks = (u * u * (V - 1)).long()
    copy = torch.rand((B, T), generator=gen, device=device) < 0.5
    shifted = torch.roll(toks, 1, dims=1)
    shifted[:, 0] = 0
    toks = torch.where(copy, (shifted + 1) % V, toks)
    labels = torch.roll(toks, -1, dims=1)
    labels[:, -1] = -100   # next-token targets
    return {"tokens": toks, "labels": labels}


def batch_specs(cfg, batch: int, seq: int) -> dict:
    """A training batch's shapes and dtypes as meta tensors; image and
    encoder-decoder configs, whose front-end inputs the port does not have
    yet, raise."""
    if cfg.cross_source == "image" or cfg.encoder is not None:
        raise NotImplementedError(
            "front-end inputs (image and encoder-decoder configs): not in the port yet "
            "(ROADMAP.md, Queue A item 6)")
    spec = torch.empty((batch, seq), dtype=torch.long, device="meta")
    return {"tokens": spec, "labels": spec.clone()}


def local_rows(batch: dict) -> dict:
    """This process's rows of a global batch under the installed sharding
    rules (without rules the batch itself): the block of the leading axis
    that the ``batch`` rule gives its mesh coordinates."""
    rules = sharding.current()
    if rules is None:
        return batch
    out = {}
    for k, v in batch.items():
        sp = rules.spec("batch", *([None] * (v.ndim - 1)), shape=tuple(v.shape))
        n = v.shape[0] // sharding.entry_size(rules.mesh, sp[0])
        i = rules.mesh.index(sp[0])
        out[k] = v[i * n:(i + 1) * n]
    return out


def batch_logical_axes(cfg) -> dict:
    """The logical axes of a batch's arrays (the reference's names):
    ``batch`` splits the rows over the data axes (:func:`local_rows`)."""
    batch_specs(cfg, 1, 1)
    return {"tokens": ("batch", None), "labels": ("batch", None)}
