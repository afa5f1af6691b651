"""Training loop with checkpoint/restart, a NaN guard and a straggler
watchdog.

The port's twin of the JAX package's ``train/trainer.py``:

* **Checkpoint/restart** — ``async_save`` every ``ckpt_every`` steps and a
  final ``save`` (the port's ``ckpt``, the reference's layout); on
  (re)start :meth:`Trainer.restore_or_init` resumes from the newest
  complete checkpoint.  The data is a pure function of the step, so the
  restart repeats the uninterrupted run.  bfloat16 moments are saved in
  float32 (NumPy has no bfloat16) and cast back on restore.
* **Straggler watchdog** — a step slower than ``straggler_factor`` times
  the EWMA of the step times (the first step, with its start-up, excluded)
  is counted and logged, and triggers an early checkpoint.
* **NaN guard** — a non-finite loss skips the update (the step returns new
  tensors, so the old ones stay) and counts; ``max_bad_steps``
  consecutive bad steps abort.

A step reads the host once, for the loss, which also ends its host-clock
time (``step_s``).  A sharded run (``shardings``: ``train.state_shardings``
of its mesh) saves the global leaves and restores its blocks.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from .. import ckpt as ckpt_mod
from ..core import comm


def _map(fn, tree, like=None):
    """``fn`` over the leaves of a tree of dicts (and over ``like``'s
    matching leaves beside them)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, None if like is None else like[k]) for k, v in tree.items()}
    return fn(tree) if like is None else fn(tree, like)


def _savable(state):
    return _map(lambda t: t.float() if t.dtype == torch.bfloat16 else t, state)


@dataclasses.dataclass
class Trainer:
    cfg: object                # ModelCfg
    train_step: object         # from make_train_step
    data: object               # SyntheticLMData-like with .batch_at(step)
    ckpt_dir: str | None = None
    ckpt_every: int = 200
    shardings: object = None   # train.state_shardings of a sharded run
    log_every: int = 10
    straggler_factor: float = 2.0
    max_bad_steps: int = 10
    _ewma: float | None = None
    straggler_events: int = 0
    bad_steps: int = 0
    step_s: list = dataclasses.field(default_factory=list)   # host seconds of each step run

    def restore_or_init(self, params, opt_state):
        """``(params, opt_state, step0)``: the newest checkpoint of
        ``ckpt_dir`` (tensors on the devices and in the dtypes of the given
        ones), or the given state and 0."""
        step0 = 0
        if self.ckpt_dir:
            last = ckpt_mod.latest_step(self.ckpt_dir)
            if last is not None:
                like = {"params": params, "opt": opt_state}
                state = ckpt_mod.restore(_savable(like), last, self.ckpt_dir,
                                         shardings=self.shardings)
                state = _map(lambda t, ref: t.to(ref.dtype), state, like)
                params, opt_state = state["params"], state["opt"]
                step0 = last
                print(f"[trainer] resumed from step {last}")
        return params, opt_state, step0

    def _save(self, params, opt_state, step: int, asynchronous: bool):
        state = _savable({"params": params, "opt": opt_state})
        if asynchronous:
            return ckpt_mod.async_save(state, step, self.ckpt_dir, shardings=self.shardings)
        return ckpt_mod.save(state, step, self.ckpt_dir, shardings=self.shardings)

    def run(self, params, opt_state, n_steps: int, *, step0: int = 0):
        """Runs steps ``step0 .. step0 + n_steps - 1``.  Returns (params,
        opt_state, the losses of the steps that updated)."""
        history = []
        pending = None
        for step in range(step0, step0 + n_steps):
            batch = self.data.batch_at(step)
            t0 = time.perf_counter()
            new_params, new_opt, metrics = self.train_step(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.step_s.append(dt)

            # straggler watchdog (the first step carries the start-up and is
            # left out of the EWMA)
            if step > step0:
                if self._ewma is None:
                    self._ewma = dt
                flagged = dt > self.straggler_factor * self._ewma and step > step0 + 2
                if flagged:
                    self.straggler_events += 1
                    print(f"[watchdog] step {step} took {dt:.3f}s "
                          f"(EWMA {self._ewma:.3f}s) — straggler flagged")
                else:
                    self._ewma = 0.9 * self._ewma + 0.1 * dt
                if self.ckpt_dir and comm.world_size() > 1:
                    # a save is collective: every process saves if any flagged
                    flagged = bool(comm.all_reduce(torch.tensor(float(flagged)), "max"))
                if flagged and self.ckpt_dir:
                    pending = self._save(params, opt_state, step, True)

            # NaN guard: skip the update
            if not math.isfinite(loss):
                self.bad_steps += 1
                print(f"[guard] non-finite loss at step {step}; update skipped "
                      f"({self.bad_steps}/{self.max_bad_steps})")
                if self.bad_steps >= self.max_bad_steps:
                    raise RuntimeError("too many consecutive non-finite steps")
                continue
            self.bad_steps = 0
            params, opt_state = new_params, new_opt

            if step % self.log_every == 0:
                print(f"[train] step {step} loss {loss:.4f} ({dt * 1000:.0f} ms/step)")
            history.append(loss)

            if self.ckpt_dir and step > 0 and step % self.ckpt_every == 0:
                pending = self._save(params, opt_state, step, True)
        if pending is not None:
            pending.result()
        if self.ckpt_dir:
            self._save(params, opt_state, step0 + n_steps, False)
        return params, opt_state, history
