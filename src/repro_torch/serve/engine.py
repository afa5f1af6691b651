"""Minimal batched serving engine: prefill + greedy/temperature decode.

The port's twin of the JAX package's ``serve/engine.py``.  Caches are
per layer (``transformer.prefill``): KV caches of ``cache_len`` slots for
the global attention layers, KV ring buffers of ``min(window, cache_len)``
slots for the sliding-window layers, SSM and conv states for the Mamba
layers.  The engine drives prefill and one decode step per new token.
The ids and the positions stay on the device until the caller reads the
ids: no host read per token.

``Engine(cfg, model, mesh=mesh)`` serves across the processes of a
``(data, model)`` mesh under the reference's rules (``launch/build.py``'s
prefill and decode cells): ``default_rules(mesh, batch_size=B,
seq_parallel=True)`` around prefill, ``default_rules(mesh, batch_size=B)``
around each decode step.  ``model`` is built under rules on that mesh
(its blocks); the engine gathers each weight's ``fsdp`` dimensions ONCE,
at construction (``transformer.serving_model``), keeping the
tensor-parallel split, so a process holds its heads', its ``d_ff``
columns', its experts' and its vocabulary block's weights whole.  This
is a layout choice, not a change of the result: ZeRO-3's gather of every
layer at every decode step would stage every weight through the host
(gloo) at every token.  Each process holds its rows and slots of the
caches (``transformer.cache_shardings``).
"""

from __future__ import annotations

import contextlib

import torch

from .. import telemetry as tele
from .._device import resolve_device
from ..core import comm
from ..distributed import sharding
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
    it with ``recorder.dump()``).

    ``mesh``: serve over the processes of this ``(data, model)`` mesh
    (collective: every process builds its engine; see the module's
    docstring), ``model`` built under rules on it."""

    def __init__(self, cfg, model, *, cache_len: int | None = None, device=None,
                 flight_dir: str | None = None, use_kernel: str = "auto", mesh=None):
        self.flight_dir = flight_dir
        self.recorder = None
        self.device = resolve_device(device)
        if model.cfg != cfg:
            raise ValueError(f"the model is built for {model.cfg.name!r}, not {cfg.name!r}")
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the engine on {self.device}")
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            if model.rules is None or model.rules.mesh is not mesh:
                raise ValueError("Engine(mesh=) serves a model built under rules on that mesh")
            model = tf.serving_model(model)
        self.model = model
        self.cache_len = cache_len or cfg.max_seq
        self.use_kernel = use_kernel

    def _rules(self, batch: int, prefill: bool):
        """The rules of ``launch/build.py``'s prefill (sequence-parallel) or
        decode cell for ``batch`` rows (None without a mesh)."""
        if self.mesh is None:
            return None
        return sharding.default_rules(self.mesh, batch_size=batch, seq_parallel=prefill)

    def _pick(self, logits, temperature: float, generator, rules):
        """The next ids of this process's rows from its block of the logits:
        greedy takes the argmax over the vocabulary blocks, the lowest id
        among equal maxima (``torch.argmax``'s rule), through the largest
        (value, id) pair of each block; sampling gathers the whole logits
        and draws with ``generator`` (the same draw on every process of the
        vocabulary's subgroup)."""
        vocab = None
        if rules is not None and logits.shape[-1] != self.cfg.padded_vocab:
            vocab = sharding.group_of(rules, "vocab")
        if temperature > 0.0:
            if vocab is not None:
                logits = comm.gather_over(logits, vocab, -1)
            probs = torch.softmax(logits / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)
        ids = torch.argmax(logits, dim=-1, keepdim=True)
        if vocab is None:
            return ids
        off = tf.vocab_offset(self.cfg, logits.shape[-1])
        # (value, id) in float64, exact for both; one gather of 2 numbers a row
        pair = torch.cat([logits.gather(-1, ids).double(), (ids + off).double()], dim=-1)
        pairs = comm.gather_over(pair[:, None], vocab, 1)   # (B, blocks, 2)
        val, idx = pairs[..., 0], pairs[..., 1]
        best = val.amax(dim=1, keepdim=True)
        pick = torch.where(val == best, idx, idx.new_full((), float("inf"))).amin(dim=1)
        return pick.long()[:, None]

    def generate(self, tokens, n_new: int, *, cross_inputs=None, temperature: float = 0.0,
                 generator: torch.Generator | None = None, logits: list | None = None):
        """tokens: (B, T) prompt ids.  Returns (B, n_new) generated ids on the
        engine's device.  Greedy (argmax) at ``temperature=0``; otherwise
        sampled from ``softmax(logits / temperature)`` with ``generator``.
        The reference runs one more decode step after the last id; its
        logits are never used, so the port leaves it out.  ``logits``: a
        list to which the logits of prefill and of every decode step are
        appended.

        With a mesh: ``tokens`` is the global prompt; the ids returned are
        this process's rows (B_local, n_new), the same on every process
        of ``model`` (and of ``data`` where the batch is not split), and the
        logits kept are its rows' block of the vocabulary."""
        if cross_inputs is not None:
            raise NotImplementedError(
                "cross_inputs belong to the encoder-decoder and vision configs "
                "(ROADMAP.md, Queue A item 6)")
        if temperature > 0.0 and generator is None:
            raise ValueError("temperature sampling needs an explicit torch.Generator")
        tokens = torch.as_tensor(tokens, device=self.device)
        B, T = tokens.shape
        pre, dec = self._rules(B, True), self._rules(B, False)
        out = []
        with self._observe() as rec, torch.inference_mode():
            self.recorder = rec
            with tele.region("serve.prefill", batch=B, prompt_len=T, sync=lambda: lg), \
                    sharding.axis_rules(pre):
                lg, caches = tf.prefill(self.model, tokens, cache_len=self.cache_len,
                                        use_kernel=self.use_kernel)
            if logits is not None:
                logits.append(lg)
            positions = torch.arange(T, T + n_new, device=self.device)
            with tele.region("serve.decode", batch=B, n_new=n_new, sync=lambda: out), \
                    sharding.axis_rules(dec):
                for i in range(n_new):
                    cur = self._pick(lg, temperature, generator, dec)
                    out.append(cur)
                    if i + 1 < n_new:
                        lg, caches = tf.decode_step(self.model, cur, positions[i], caches,
                                                    use_kernel=self.use_kernel)
                        if logits is not None:
                            logits.append(lg)
        return torch.cat(out, dim=1) if out else tokens.new_zeros(lg.shape[0], 0)

    def _observe(self):
        """Flight recorder for the duration of a generate() call (no-op when
        ``flight_dir`` is unset; joins a recorder that is already live)."""
        if self.flight_dir is None:
            return contextlib.nullcontext()
        return tele.flight(self.flight_dir, meta={"app": "serve", "cache_len": self.cache_len})
