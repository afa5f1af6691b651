"""End-to-end driver on the PyTorch/CUDA port: train a ~100M-param LM for
a few hundred steps.

Run:  PYTHONPATH=src python examples/torch_train_lm.py            # quick (~25M)
      PYTHONPATH=src python examples/torch_train_lm.py --full     # ~110M, 300 steps
      PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 10
      PYTHONPATH=src torchrun --nproc-per-node 8 examples/torch_train_lm.py \
          --dp 4 --tp 2 [--device cpu]                            # DP x TP

The twin of ``examples/train_lm.py``: the same models, arguments and
printed lines, ``OK`` at the end.  It uses the port's whole training
substrate: synthetic data, AdamW with its schedule, gradient accumulation,
rematerialization, checkpoint/restart and the straggler watchdog.  On the
card (``--device cuda``, the default) every attention layer runs K6 and
its backward kernel; ``--device cpu`` (or ``--kernel ref``) takes the
plain PyTorch versions.  ``--dp`` and ``--tp`` train over a ``(data,
model)`` mesh of the processes ``torchrun`` starts (gloo by default, so
that several may share one card; ``--backend nccl`` with a card each):
ZeRO-3 with tensor parallelism under ``default_rules``, as the reference
example trains over a device mesh.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402

from _torch_group import add_device, device_arg, process_group, say  # noqa: E402


def model_cfg(full: bool):
    """The example's model: ~110M parameters with ``full``, else ~25M."""
    from repro_torch.configs.base import Layer, ModelCfg

    if full:
        return ModelCfg(
            name="repro-110m", d_model=768, n_heads=12, n_kv=4, head_dim=64,
            d_ff=2048, vocab=32768,
            stacks=(((Layer(mixer="attn"),), 12),), act="swiglu", rope_theta=1e4,
        )
    return ModelCfg(
        name="repro-25m", d_model=384, n_heads=6, n_kv=2, head_dim=64,
        d_ff=1024, vocab=8192,
        stacks=(((Layer(mixer="attn"),), 8),), act="swiglu", rope_theta=1e4,
    )


def train_cfg(steps: int, moments: str = "float32", kernel: str = "auto"):
    from repro_torch import optim
    from repro_torch.train import TrainCfg

    return TrainCfg(
        opt=optim.AdamWCfg(lr=6e-4, weight_decay=0.01, moments=moments),
        grad_accum=2, remat="full", warmup=20, total_steps=steps, use_kernel=kernel,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--moments", default="float32", choices=["float32", "bfloat16", "int8"])
    add_device(ap)
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="process-group backend under torchrun (default gloo)")
    args = ap.parse_args(argv)
    with process_group(args.backend) as world:
        return train(args, world)


def train(args, world: int) -> dict:
    import torch

    from repro_torch import optim
    from repro_torch._device import resolve_device
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed.sharding import axis_rules, default_rules
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import params as pm
    from repro_torch.models import transformer as tf
    from repro_torch.train import Trainer, make_train_step, state_shardings

    cfg = model_cfg(args.full)
    if args.full:
        batch, seq, steps = 16, 256, args.steps or 300
    else:
        batch, seq, steps = 16, 128, args.steps or 120

    rules = None
    if args.dp * args.tp > 1 or world > 1:
        if args.dp * args.tp != world:
            raise ValueError(f"--dp {args.dp} x --tp {args.tp} for {world} process(es): start "
                             "dp x tp processes (torchrun --nproc-per-node)")
        rules = default_rules(Mesh((args.dp, args.tp), ("data", "model")), batch_size=batch)

    device = resolve_device(device_arg(args))
    n_params = cfg.param_count()
    say(f"model {cfg.name}: {n_params / 1e6:.1f}M params, "
        f"{cfg.n_layers} layers; devices: {world} ({device})")

    tcfg = train_cfg(steps, args.moments, args.kernel)
    layout = tf.reference_layout(cfg)
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                            torch.float32, device)
    if rules is not None:   # each process keeps its blocks
        params = pm.shard(params, rules, layout)
    with axis_rules(rules):
        opt_state = optim.init(params, tcfg.opt, layout=layout)
    base_step = make_train_step(cfg, tcfg)

    def train_step(p, o, b):
        with axis_rules(rules):
            return base_step(p, o, b)

    data = SyntheticLMData(vocab=cfg.vocab, batch=batch, seq=seq, seed=0, device=str(device))
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")
    trainer = Trainer(cfg=cfg, train_step=train_step, data=data,
                      ckpt_dir=ckpt_dir, ckpt_every=max(50, steps // 4), log_every=10,
                      shardings=None if rules is None else state_shardings(cfg, tcfg.opt, rules))
    params, opt_state, step0 = trainer.restore_or_init(params, opt_state)
    params, opt_state, hist = trainer.run(params, opt_state, steps - step0, step0=step0)
    if hist:
        say(f"loss: {hist[0]:.4f} -> {hist[-1]:.4f} "
            f"(uniform floor = {np.log(cfg.vocab):.4f})")
        assert hist[-1] < hist[0], "training did not reduce the loss"
    say(f"straggler events: {trainer.straggler_events}; checkpoints in {ckpt_dir}")
    say("OK")
    return {"history": hist, "params": params, "straggler_events": trainer.straggler_events}


if __name__ == "__main__":
    main()
