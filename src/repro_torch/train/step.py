"""Train step: loss -> gradients (with microbatch accumulation) -> AdamW.

The port's twin of the JAX package's ``train/step.py``.  The parameters
are the port's ``{name: tensor}`` dict (``models.transformer.init_params``);
a step makes gradient-requiring aliases of them, takes the loss through
``transformer.loss_fn`` and its gradients with ``torch.autograd.grad``, and
returns new tensors from :func:`repro_torch.optim.update`.  With
``grad_accum > 1`` the microbatches run in turn, their gradients summed in
float32 and averaged, so activation memory scales with the microbatch.

Under installed sharding rules (the reference's ``with axis_rules(rules)``
around the step) the parameters and the optimizer state are this
process's blocks (``models.params.shard``) and the step takes the global
batch and keeps its rows (``data.local_rows``); ``grad_accum`` splits
those rows.  A leaf sharded by ``fsdp`` gets its gradient out of the
backward's reduce-scatter already summed over those axes; every leaf is
then summed over the batch axes its reduce-scatter did not cover (a
replicated leaf, a norm: all of them; ``params.grad_sum_axes``), so that
each process holds the gradient of the global loss for its block.  The
loss and ``xent`` reported are the global batch's.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import optim
from ..core import comm
from ..data import local_rows
from ..distributed import sharding
from ..models import params as pm
from ..models import transformer as tf
from ..optim import schedule as sched


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    opt: optim.AdamWCfg = optim.AdamWCfg()
    grad_accum: int = 1
    remat: str = "full"
    warmup: int = 100
    total_steps: int = 10000
    aux_weight: float = 0.01
    loss_chunk: int = 512
    use_kernel: str = "auto"   # K6's and K7's route (kernels/dispatch.py): auto | cuda | ref


def _split_micro(batch: dict, n: int) -> list:
    B = batch["tokens"].shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not split into {n} microbatches")
    return [{k: v[i * (B // n):(i + 1) * (B // n)] for k, v in batch.items()} for i in range(n)]


def value_and_grad(params: dict, cfg, tcfg: TrainCfg, batch: dict):
    """``(loss, {"xent", "aux"}, grads)`` of ``transformer.loss_fn`` at
    ``params`` on ``batch``; ``grads`` a dict like ``params`` (zeros for a
    parameter the loss does not reach)."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss, metrics = tf.loss_fn(leaves, cfg, batch, remat=tcfg.remat,
                               aux_weight=tcfg.aux_weight, loss_chunk=tcfg.loss_chunk,
                               use_kernel=tcfg.use_kernel)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(leaves.items(), grads)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    rules = sharding.current()
    if rules is None:
        return loss.detach(), metrics, grads
    # the gradients of the global loss, the reported loss the global batch's
    layout = tf.layout_of(cfg)
    for k, g in grads.items():
        axes = pm.grad_sum_axes(layout[k], rules)
        if axes:
            grads[k] = comm.sum_over(g, rules.mesh.group(axes))
    batch = sharding.group_of(rules, "batch")
    if batch is not None:
        metrics["xent"] = comm.sum_over(metrics["xent"], batch)
    return metrics["xent"] + tcfg.aux_weight * metrics["aux"], metrics, grads


def state_shardings(cfg, ocfg: optim.AdamWCfg, rules) -> dict:
    """Where each leaf of a training state ``{"params", "opt"}`` sits on
    the mesh of ``rules``: a ``models.params.Placement`` per parameter (its
    reference leaf's spec, read through the port's layout) and per moment
    (``optim.state_shardings``'s spec, in the reference leaf's layout),
    None for the step counter (the same on every process).  What
    ``ckpt.save``/``ckpt.restore`` take as ``shardings``."""
    layout = tf.layout_of(cfg)
    specs = optim.state_shardings(layout, ocfg, rules)

    def moment(sp):
        if isinstance(sp, dict):
            return {k: pm.Placement(v, rules) for k, v in sp.items()}
        return pm.Placement(sp, rules)

    return {"params": {n: pm.Placement(pm.spec(leaf, rules), rules, leaf)
                       for n, leaf in layout.items()},
            "opt": {"m": {n: moment(sp) for n, sp in specs["m"].items()},
                    "v": {n: moment(sp) for n, sp in specs["v"].items()},
                    "step": None}}


def make_train_step(cfg, tcfg: TrainCfg):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, metrics ``loss``, ``xent``, ``aux``, ``lr_scale`` and
    ``grad_norm`` as 0-d tensors on the device (with ``grad_accum > 1``,
    ``xent`` is the mean loss and ``aux`` 0, as in the reference)."""
    layout = tf.reference_layout(cfg)

    def train_step(params, opt_state, batch):
        batch = local_rows(batch)
        if tcfg.grad_accum == 1:
            loss, metrics, grads = value_and_grad(params, cfg, tcfg, batch)
        else:
            gsum, lsum = None, torch.zeros((), device=batch["tokens"].device)
            for mb in _split_micro(batch, tcfg.grad_accum):
                l, _, g = value_and_grad(params, cfg, tcfg, mb)
                gsum = ({k: v.float() for k, v in g.items()} if gsum is None
                        else {k: gsum[k] + g[k].float() for k in gsum})
                lsum = lsum + l
                del g
            grads = {k: v / tcfg.grad_accum for k, v in gsum.items()}
            loss = lsum / tcfg.grad_accum
            metrics = {"xent": loss, "aux": torch.zeros_like(loss)}
        lr_scale = sched.warmup_cosine(opt_state["step"], warmup=tcfg.warmup,
                                       total=tcfg.total_steps)
        params, opt_state, om = optim.update(grads, opt_state, params, tcfg.opt,
                                             lr_scale=lr_scale, layout=layout)
        return params, opt_state, dict(metrics, loss=loss, lr_scale=lr_scale, **om)

    return train_step
