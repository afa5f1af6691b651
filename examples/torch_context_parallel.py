"""Context parallelism on the PyTorch/CUDA port: a prefill sharded over processes.

Run:  PYTHONPATH=src python examples/torch_context_parallel.py --device cpu
      PYTHONPATH=src torchrun --nproc-per-node 4 examples/torch_context_parallel.py

The twin of ``examples/context_parallel.py``.  The paper's halo exchange on
the token grid: sliding-window attention takes a kv halo from the left
neighbour, full attention runs ring attention, Mamba layers pass conv
halos and chunk states.  Under ``torchrun`` each process joins a
``torch.distributed`` group (gloo by default, so that several processes
may share one card) and holds one shard of the sequence; every process
builds the same weights from one seed.  The sharded forward
(``repro_torch.distributed.context_parallel.context_parallel_logits``) is
held against the plain forward of the whole sequence on the SMOKE configs
of gemma3, mamba2 and jamba.  Without a group the one process holds the
whole sequence.  The attention runs on K6 and the SSD scan on K7 on a CUDA
card (``--kernel auto``), their plain versions on the CPU or with
``--kernel ref``.
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402

from _torch_group import add_common, device_arg, process_group, say  # noqa: E402

MODELS = ("gemma3_4b", "mamba2_1p3b", "jamba_v01_52b")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-shard", type=int, default=16, help="tokens of each process's shard")
    ap.add_argument("--batch", type=int, default=2)
    add_common(ap)
    args = ap.parse_args(argv)

    import importlib

    import torch

    from repro_torch._device import resolve_device
    from repro_torch.core import comm
    from repro_torch.distributed.context_parallel import context_parallel_logits
    from repro_torch.models import Model
    from repro_torch.models import transformer as tf

    errs = {}
    with process_group(args.backend) as world:
        dev = resolve_device(device_arg(args))
        if dev.type == "cuda" and world > 1 and comm.backend() == "nccl":
            torch.cuda.set_device(comm.rank() % torch.cuda.device_count())
            dev = torch.device("cuda", torch.cuda.current_device())
        say(f"processes: {world}, device: {dev}")
        r = comm.rank()
        for mod in MODELS:
            cfg = importlib.import_module(f"repro_torch.configs.{mod}").SMOKE
            cfg = dataclasses.replace(cfg, dtype="float32")
            gen = torch.Generator(device=dev).manual_seed(0)
            model = Model(cfg, generator=gen, dtype=torch.float32, device=dev)
            T = args.per_shard * world
            rng = np.random.RandomState(0)
            toks = torch.from_numpy(rng.randint(0, cfg.vocab, (args.batch, T))).to(dev)
            with torch.inference_mode():
                h, _, _ = tf.fwd(model, toks, mode="train", use_kernel=args.kernel)
                ref = tf.logits_fn(model, h)[:, r * args.per_shard:(r + 1) * args.per_shard]
                got = context_parallel_logits(model, cfg, toks, axis="sp", use_kernel=args.kernel)
            got, ref = got[..., :cfg.vocab], ref[..., :cfg.vocab]   # not the -1e30 pad rows
            err = (got - ref).abs().amax() / (ref.abs().amax() + 1e-9)
            err = float(comm.all_reduce(err, "max")) if world > 1 else float(err)
            say(f"  {cfg.name:16s} T={T} over {world} shards: rel err {err:.2e}")
            assert err < 1e-3, f"{cfg.name}: context-parallel logits differ by {err}"
            errs[cfg.name] = err
        say("OK")
    return {"world": world, "errors": errs}


if __name__ == "__main__":
    main()
