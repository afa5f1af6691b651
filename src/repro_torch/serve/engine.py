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

import contextlib

import torch

from .. import telemetry as tele
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
    The Mamba layers' caches do not depend on it.  ``flight_dir`` installs a
    flight recorder (:func:`repro_torch.telemetry.flight`) for the duration
    of each ``generate`` call, which then records its ``serve.prefill`` and
    ``serve.decode`` spans; ``recorder`` is the last call's recorder (dump
    it with ``recorder.dump()``)."""

    def __init__(self, cfg, model, *, cache_len: int | None = None, device=None,
                 flight_dir: str | None = None, use_kernel: str = "auto"):
        self.flight_dir = flight_dir
        self.recorder = None
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
        B, T = tokens.shape
        out = []
        with self._observe() as rec, torch.inference_mode():
            self.recorder = rec
            with tele.region("serve.prefill", batch=B, prompt_len=T, sync=lambda: logits):
                logits, caches = tf.prefill(self.model, tokens, cache_len=self.cache_len,
                                            use_kernel=self.use_kernel)
            positions = torch.arange(T, T + n_new, device=self.device)
            with tele.region("serve.decode", batch=B, n_new=n_new, sync=lambda: out):
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
        return torch.cat(out, dim=1) if out else tokens.new_zeros(B, 0)

    def _observe(self):
        """Flight recorder for the duration of a generate() call (no-op when
        ``flight_dir`` is unset; joins a recorder that is already live)."""
        if self.flight_dir is None:
            return contextlib.nullcontext()
        return tele.flight(self.flight_dir, meta={"app": "serve", "cache_len": self.cache_len})
