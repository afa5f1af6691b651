"""Children of the sharded-training tests of the port: functions that
``tests/_dist.py::spawn`` runs in each process of a gloo group.

Each takes ``(rank, world, ...)`` and returns plain Python values (by
pickle).  The one-process runs they compare with are the port's own,
made in the same process without rules (every process does the same
float32 operations, so all of them hold the same one-process figures).
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

from repro_torch import ckpt, optim
from repro_torch.core import comm
from repro_torch.distributed.sharding import axis_rules, default_rules
from repro_torch.launch.mesh import Mesh
from repro_torch.models import params as pm
from repro_torch.models import transformer as tf
from repro_torch.optim import compress
from repro_torch.data import local_rows
from repro_torch.train import TrainCfg, make_train_step, value_and_grad

TCFG = dict(warmup=2, total_steps=50)


def smoke(module: str, ssm=None):
    """The module's SMOKE config in float32; ``ssm``: fields of its SSMCfg
    to replace (e.g. ``{"n_groups": 2}``)."""
    cfg = importlib.import_module(f"repro_torch.configs.{module}").SMOKE
    if ssm:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, **ssm))
    return dataclasses.replace(cfg, dtype="float32")


def tcfg(moments: str = "float32", grad_accum: int = 1, lr: float = 1e-3,
         aux_weight: float = 0.01) -> TrainCfg:
    return TrainCfg(opt=optim.AdamWCfg(lr=lr, moments=moments), grad_accum=grad_accum,
                    aux_weight=aux_weight, **TCFG)


def load_params(cfg, path):
    """The parameters saved in ``path`` (an ``.npz`` of the port's
    ``{name: array}``), or ``init_params`` from seed 0 where ``path`` is
    None."""
    if path is None:
        return tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    z = np.load(path)
    return {k: torch.from_numpy(z[k]) for k in z.files}


def load_batches(path, n: int, cfg, batch: int, seq: int) -> list:
    """``n`` global batches: from ``path`` (``tokens{s}``/``labels{s}``), or
    the port's synthetic data."""
    if path is None:
        from repro_torch.data import SyntheticLMData

        data = SyntheticLMData(vocab=cfg.vocab, batch=batch, seq=seq, seed=0, device="cpu")
        return [data.batch_at(s) for s in range(n)]
    z = np.load(path)
    return [{k: torch.from_numpy(z[f"{k}{s}"]).long() for k in ("tokens", "labels")}
            for s in range(n)]


def run_steps(cfg, tc, params, opt, batches, rules, start: int = 0):
    """Steps ``start ..`` over ``batches[start:]`` under ``rules`` (None:
    one process); returns (params, opt, [(loss, grad_norm)])."""
    step = make_train_step(cfg, tc)
    hist = []
    with axis_rules(rules):
        for b in batches[start:]:
            params, opt, m = step(params, opt, b)
            hist.append((float(m["loss"]), float(m["grad_norm"])))
    return params, opt, hist


def replicated_digest(params, layout, rules) -> dict:
    """``{name: bytes}`` of the leaves this process holds whole (no mesh
    axis splits them): these must be bitwise the same on every process."""
    out = {}
    for name, t in params.items():
        if all(e is None for e in pm.spec(layout[name], rules)):
            out[name] = t.numpy().tobytes()
    return out


def sharded_train(rank, world, module, mesh_shape, steps, moments="float32", params_path=None,
                  batches_path=None, batch=4, seq=16, grad_accum=1, ssm=None, aux_weight=0.01,
                  first_grads=False):
    """``steps`` steps on a (data, model) mesh against one process: the
    losses and grad norms of both, the local shapes, and digests of the
    replicated leaves.  ``first_grads``: also the gradients of the first
    step's loss on the mesh, gathered whole (``"grads"``, on rank 0)."""
    cfg = smoke(module, ssm)
    tc = tcfg(moments, grad_accum, aux_weight=aux_weight)
    layout = tf.reference_layout(cfg)
    params0 = load_params(cfg, params_path)
    batches = load_batches(batches_path, steps, cfg, batch, seq)
    _, _, one = run_steps(cfg, tc, params0, optim.init(params0, tc.opt, layout=layout),
                          batches, None)
    mesh = Mesh(mesh_shape, ("data", "model"))
    rules = default_rules(mesh, batch_size=batch)
    local = pm.shard(params0, rules, layout)
    with axis_rules(rules):
        opt = optim.init(local, tc.opt, layout=layout)
    grads = None
    if first_grads:
        with axis_rules(rules):
            _, _, g = value_and_grad(local, cfg, tc, local_rows(batches[0]))
        grads = pm.gather(g, rules, layout)   # collective
    p, o, hist = run_steps(cfg, tc, local, opt, batches, rules)
    shapes = {"params": {n: tuple(t.shape) for n, t in local.items()},
              "m": {n: (tuple(v["q"].shape), tuple(v["s"].shape)) if isinstance(v, dict)
                    else tuple(v.shape) for n, v in o["m"].items()}}
    whole = pm.gather(p, rules, layout)   # collective
    return {"one": one, "sharded": hist, "shapes": shapes,
            "replicated": replicated_digest(p, layout, rules),
            "whole": {n: t.numpy() for n, t in whole.items()} if rank == 0 else None,
            "grads": {n: t.numpy() for n, t in grads.items()} if rank == 0 and grads else None}


def elastic(rank, world, module, steps, ckpt_dir, params_path=None, batches_path=None,
            batch=8, seq=16, first=(2, 2), second=(1, 4)):
    """Steps ``0 .. steps/2 - 1`` on ``first``, a checkpoint, the rest on
    ``second`` from it (the reference's elastic resume), and the rest once
    more in one process from the same checkpoint."""
    cfg = smoke(module)
    tc = tcfg()
    layout = tf.reference_layout(cfg)
    params0 = load_params(cfg, params_path)
    batches = load_batches(batches_path, steps, cfg, batch, seq)
    half = steps // 2
    _, _, one = run_steps(cfg, tc, params0, optim.init(params0, tc.opt, layout=layout),
                          batches, None)
    rules_a = default_rules(Mesh(first, ("data", "model")), batch_size=batch)
    with axis_rules(rules_a):
        opt = optim.init(pm.shard(params0, rules_a, layout), tc.opt, layout=layout)
    p1, o1, h1 = run_steps(cfg, tc, pm.shard(params0, rules_a, layout), opt, batches[:half],
                           rules_a)
    state = {"params": p1, "opt": o1}
    ckpt.save(state, half, ckpt_dir, shardings=train_shardings(cfg, tc, rules_a))
    rules_b = default_rules(Mesh(second, ("data", "model")), batch_size=batch)
    like = {"params": pm.shard(params0, rules_b, layout)}
    with axis_rules(rules_b):
        like["opt"] = optim.init(like["params"], tc.opt, layout=layout)
    got = ckpt.restore(like, half, ckpt_dir, shardings=train_shardings(cfg, tc, rules_b))
    _, _, h2 = run_steps(cfg, tc, got["params"], got["opt"], batches, rules_b, start=half)
    whole = ckpt.restore({"params": params0,
                          "opt": optim.init(params0, tc.opt, layout=layout)}, half, ckpt_dir)
    _, _, h3 = run_steps(cfg, tc, whole["params"], whole["opt"], batches, None, start=half)
    return {"one": one, "first": h1, "second": h2, "one_from_ckpt": h3}


def train_shardings(cfg, tc, rules):
    from repro_torch.train import state_shardings

    return state_shardings(cfg, tc.opt, rules)


def compress_run(rank, world, g, steps=30):
    """``compressed_psum_mean`` over every process of ``g[rank]`` (one
    shot), and the time average of ``steps`` error-feedback rounds."""
    mesh = Mesh((world,), ("dp",))
    x = torch.from_numpy(g[rank])
    err = torch.zeros_like(x)
    mean1, resid1 = compress.compressed_psum_mean(x + err, "dp", mesh)
    acc = np.zeros_like(g[0])
    for i in range(steps):
        m, err = compress.compressed_psum_mean(x + err, "dp", mesh)
        acc += (m.numpy() - acc) / (i + 1)
    return {"mean": mean1.numpy(), "resid": resid1.numpy(), "acc": acc}


def launcher(rank, world, argv):
    from repro_torch.launch import train as launch

    hist = launch.main(list(argv))
    return {"hist": hist, "rank": comm.rank()}
