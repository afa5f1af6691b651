"""Training launcher: config (cut to ``--scale``), AdamW, Trainer.

The port's twin of the JAX package's ``launch/train.py``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --scale 0.05 --steps 50 [--moments int8] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
        --scale 1.0 --steps 6 --batch 4 --seq 2048
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch llama3.2-1b --scale 0.05 --steps 50 --dp 2 --tp 2 [--device cpu]

``--scale`` shrinks d_model/d_ff/vocab/layers for smoke-scale runs of the
assigned configs (1.0 = the real architecture), as the reference's does.
Training runs in float32.  ``--device`` is ``cuda`` (the card; the
kernels: attention through K6 and its backward kernel, Mamba layers
through K7 and its backward kernel) or ``cpu`` (the plain PyTorch path),
``--kernel`` the kernels' route (``auto | cuda | ref``).

``--dp`` and ``--tp`` (and ``--devices``, where given) train over a
``(data, model)`` mesh of processes (:mod:`repro_torch.launch.mesh`), as
the reference trains over a device mesh through GSPMD: the launcher joins
the group that ``torchrun`` describes (``--backend``, gloo by default:
several processes may share one card), or the caller's group, builds
``default_rules(mesh, batch_size=--batch)`` and trains each process's
blocks (ZeRO-3 with tensor parallelism, ``distributed/sharding.py``).
``dp * tp`` must be the group's size; nothing falls back to one process.
"""

from __future__ import annotations

import argparse
import dataclasses


def shrink(c, s: float):
    """The reference launcher's cut of a config to scale ``s`` (< 1)."""
    if c is None:
        return None
    kw = dict(
        d_model=max(64, int(c.d_model * s) // 16 * 16),
        d_ff=max(64, int(c.d_ff * s) // 16 * 16) if c.d_ff else 0,
        n_heads=max(2, int(c.n_heads * s)) if c.n_heads else 0,
        n_kv=max(1, min(c.n_kv, int(c.n_heads * s))) if c.n_kv else 0,
        vocab=max(512, int(c.vocab * s) // 128 * 128) if c.vocab else 0,
        stacks=tuple((p, max(1, int(r * s))) for p, r in c.stacks),
        encoder=shrink(c.encoder, s),
    )
    if c.n_heads:
        kw["head_dim"] = kw["d_model"] // kw["n_heads"]
    if c.ssm is not None:
        kw["ssm"] = dataclasses.replace(c.ssm, d_state=max(16, int(c.ssm.d_state * s)),
                                        head_dim=32, chunk=16)
    if c.moe is not None:
        kw["moe"] = dataclasses.replace(c.moe, n_experts=max(4, int(c.moe.n_experts * s)),
                                        d_ff=max(32, int(c.moe.d_ff * s) // 16 * 16),
                                        capacity_factor=4.0)
    return dataclasses.replace(c, **kw)


@dataclasses.dataclass
class Launch:
    """What :func:`build` sets up: the config, the train config, parameters,
    optimizer state, data and the Trainer (resumed from ``--ckpt-dir`` where
    it holds a checkpoint, from ``step0``)."""

    args: argparse.Namespace
    rules: object
    own_group: bool
    cfg: object
    tcfg: object
    params: dict
    opt_state: dict
    data: object
    trainer: object
    step0: int


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--moments", default="float32")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--kernel", default="auto", choices=["auto", "cuda", "ref"])
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="the group's backend where the launcher makes it (under torchrun)")
    return ap


def build(argv=None) -> Launch:
    """Parse ``argv`` and set the run up, as :func:`main` does before it
    trains."""
    args = parser().parse_args(argv)

    import torch

    from .. import optim
    from .._device import resolve_device
    from ..configs import base as cb
    from ..core import comm
    from ..data import SyntheticLMData
    from ..distributed.sharding import axis_rules, default_rules
    from ..models import params as pm
    from ..models import transformer as tf
    from ..train import TrainCfg, Trainer, make_train_step, state_shardings
    from .mesh import Mesh

    rules, own = None, False
    if args.devices > 1 or args.dp * args.tp > 1:
        own = comm.init_from_env(args.backend)
        world = comm.world_size()
        if args.dp * args.tp != world or args.devices not in (0, world):
            if own:
                comm.destroy()
            raise ValueError(f"--dp {args.dp} x --tp {args.tp} (--devices {args.devices}) for a "
                             f"group of {world} process(es): start dp x tp processes (torchrun "
                             "--nproc-per-node), or call from a group of that size")
        mesh = Mesh((args.dp, args.tp), ("data", "model"))
        rules = default_rules(mesh, batch_size=args.batch)
        print(f"[launch] rank {comm.rank()} of {world}, backend {comm.backend()}, mesh "
              f"{dict(mesh.shape)} at {mesh.coords}")

    device = resolve_device(None if args.device == "cuda" else "cpu")
    cfg = cb.get(args.arch)
    if args.scale < 1.0:
        cfg = shrink(cfg, args.scale)
    cfg = dataclasses.replace(cfg, dtype="float32")
    print(f"[launch] {args.arch} @ scale {args.scale}: "
          f"{cfg.param_count() / 1e6:.1f}M params, {cfg.n_layers} layers; device {device}")

    tcfg = TrainCfg(opt=optim.AdamWCfg(lr=5e-4, moments=args.moments),
                    grad_accum=args.grad_accum, remat="full",
                    warmup=10, total_steps=args.steps, use_kernel=args.kernel)
    layout = tf.reference_layout(cfg)
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                            torch.float32, device)
    shardings = None
    if rules is not None:   # each process keeps its blocks
        params = pm.shard(params, rules, layout)
        shardings = state_shardings(cfg, tcfg.opt, rules)
    with axis_rules(rules):
        opt_state = optim.init(params, tcfg.opt, layout=layout)
    data = SyntheticLMData(vocab=cfg.vocab, batch=args.batch, seq=args.seq, seed=0,
                           device=str(device))
    base_step = make_train_step(cfg, tcfg)

    def train_step(p, o, b):
        with axis_rules(rules):
            return base_step(p, o, b)

    trainer = Trainer(cfg=cfg, train_step=train_step, data=data, ckpt_dir=args.ckpt_dir,
                      log_every=10, shardings=shardings)
    params, opt_state, step0 = trainer.restore_or_init(params, opt_state)
    return Launch(args, rules, own, cfg, tcfg, params, opt_state, data, trainer, step0)


def main(argv=None) -> list:
    """Train; returns the losses of the steps run (the global batch's)."""
    run = build(argv)
    try:
        run.params, run.opt_state, hist = run.trainer.run(
            run.params, run.opt_state, run.args.steps - run.step0, step0=run.step0)
    finally:
        if run.own_group:
            from ..core import comm

            comm.destroy()
    if hist:
        print(f"[launch] loss {hist[0]:.4f} -> {hist[-1]:.4f} over {len(hist)} steps")
    return hist


if __name__ == "__main__":
    main()
