"""Minimal batched serving engine: prefill + greedy/temperature decode.

The port's twin of the JAX package's ``serve/engine.py``.  Caches are
per layer (``transformer.prefill``): KV caches of ``cache_len`` slots for
the global attention layers, KV ring buffers of ``min(window, cache_len)``
slots for the sliding-window layers, SSM and conv states for the Mamba
layers.  The engine drives prefill and one decode step per new token.
The ids and the positions stay on the device until the caller reads the
ids: no host read per token.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..models import transformer as tf


class Engine:
    """``Engine(cfg, model).generate(tokens, n_new)``.  ``model`` is a
    :class:`repro_torch.models.Model` of ``cfg`` on ``device`` (default the
    CUDA card; ``device="cpu"`` for the plain path).  ``use_kernel`` is
    passed to the kernels of prefill, the sliding-window attention K6 and
    the SSD scan K7 (``"auto" | "cuda" | "ref"``; the SSD scan also takes
    ``"naive"``).  ``cache_len`` (default ``cfg.max_seq``) is the length
    of the global attention layers' KV caches: prompt plus new tokens must
    fit in it (past it the reference's decode overwrites the last slot).
    The Mamba layers' caches do not depend on it."""

    def __init__(self, cfg, model, *, cache_len: int | None = None, device=None,
                 flight_dir: str | None = None, use_kernel: str = "auto"):
        if flight_dir is not None:
            raise NotImplementedError(
                "flight_dir: the port's flight recorder comes with its telemetry "
                "(ROADMAP.md, Queue A item 3)")
        self.device = resolve_device(device)
        if model.cfg != cfg:
            raise ValueError(f"the model is built for {model.cfg.name!r}, not {cfg.name!r}")
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the engine on {self.device}")
        self.cfg = cfg
        self.model = model
        self.cache_len = cache_len or cfg.max_seq
        self.use_kernel = use_kernel

    def generate(self, tokens, n_new: int, *, cross_inputs=None, temperature: float = 0.0,
                 generator: torch.Generator | None = None):
        """tokens: (B, T) prompt ids.  Returns (B, n_new) generated ids on the
        engine's device.  Greedy (argmax) at ``temperature=0``; otherwise
        sampled from ``softmax(logits / temperature)`` with ``generator``.
        The reference runs one more decode step after the last id; its
        logits are never used, so the port leaves it out."""
        if cross_inputs is not None:
            raise NotImplementedError(
                "cross_inputs belong to the encoder-decoder and vision configs "
                "(ROADMAP.md, Queue A item 6)")
        if temperature > 0.0 and generator is None:
            raise ValueError("temperature sampling needs an explicit torch.Generator")
        tokens = torch.as_tensor(tokens, device=self.device)
        T = tokens.shape[1]
        out = []
        with torch.inference_mode():
            logits, caches = tf.prefill(self.model, tokens, cache_len=self.cache_len,
                                        use_kernel=self.use_kernel)
            positions = torch.arange(T, T + n_new, device=self.device)
            for i in range(n_new):
                if temperature > 0.0:
                    probs = torch.softmax(logits / temperature, dim=-1)
                    cur = torch.multinomial(probs, 1, generator=generator)
                else:
                    cur = torch.argmax(logits, dim=-1, keepdim=True)
                out.append(cur)
                if i + 1 < n_new:
                    logits, caches = tf.decode_step(self.model, cur, positions[i], caches,
                                                    use_kernel=self.use_kernel)
        return torch.cat(out, dim=1) if out else tokens.new_zeros(tokens.shape[0], 0)
