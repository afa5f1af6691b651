"""Children of the sharded-serving tests of the port: functions that
``tests/_dist.py::spawn`` runs in each process of a gloo group.

Each takes ``(rank, world, ...)`` and returns plain Python values (by
pickle): the ids of ``Engine(..., mesh=).generate``, the logits of prefill
and of every decode step and the caches after prefill, each gathered whole
(on rank 0), the local shape of every cache leaf, and the same run in one
process without rules (every process does the same float32 operations).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import comm
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import axis_rules, default_rules
from repro_torch.launch.mesh import Mesh
from repro_torch.models import Model
from repro_torch.models import params as pm
from repro_torch.models import transformer as tf
from repro_torch.serve import Engine

from _torch_sharded import load_params, smoke


def case_cfg(module: str, kv_quant: bool = False):
    cfg = smoke(module)
    return dataclasses.replace(cfg, kv_quant=True) if kv_quant else cfg


def _whole(t, sp, rules):
    """The whole tensor on rank 0 (None elsewhere) from this process's
    block ``t`` under the spec ``sp`` (collective)."""
    place = pm.Placement(sp, rules)
    out = place.assemble(comm.gather_to_first([place.outgoing(t)])[0])
    return None if out is None else out.numpy()


def serve_case(rank, world, module, mesh_shape, prompt, n_new, cache_len, kv_quant=False,
               params_path=None):
    """One case: ``prompt`` (B, T ids) through ``Engine.generate`` for
    ``n_new`` ids on a (data, model) mesh and in one process."""
    cfg = case_cfg(module, kv_quant)
    params0 = load_params(cfg, params_path)
    tokens = torch.as_tensor(np.asarray(prompt), dtype=torch.long)
    B = tokens.shape[0]
    one_logits = []
    one = Engine(cfg, Model(cfg, params0, device="cpu"), cache_len=cache_len, device="cpu")
    one_ids = one.generate(tokens, n_new, logits=one_logits)

    mesh = Mesh(mesh_shape, ("data", "model"))
    with axis_rules(default_rules(mesh)):
        model = Model(cfg, pm.shard(params0, default_rules(mesh), tf.layout_of(cfg)),
                      device="cpu")
    eng = Engine(cfg, model, mesh=mesh, cache_len=cache_len, device="cpu")
    logits = []
    ids = eng.generate(tokens, n_new, logits=logits)

    pre = default_rules(mesh, batch_size=B, seq_parallel=True)
    dec = default_rules(mesh, batch_size=B)
    with axis_rules(pre):
        _, caches = tf.prefill(eng.model, tokens, cache_len=cache_len)
    specs = tf.cache_shardings(cfg, dec, B, cache_len)
    local = [{n: tuple(t.shape) for n, t in c["mixer"].items()} for c in caches]
    whole = [{n: _whole(t.contiguous(), specs[i]["mixer"][n], dec)
              for n, t in c["mixer"].items()} for i, c in enumerate(caches)]
    rows = dec.spec("batch", None, shape=(B, 1))[0]
    vsp = tf.param_specs(cfg)["embed"]
    vocab = dec.spec(*vsp.axes, shape=vsp.shape)[0]
    steps = [_whole(lg.contiguous(), (rows, vocab), dec) for lg in logits]
    ids_all = _whole(ids.contiguous(), (rows, None), dec)
    # sampling draws from the gathered logits with the caller's generator
    sample = dict(temperature=1.0, generator=torch.Generator().manual_seed(3))
    sampled = eng.generate(tokens, n_new, **sample)
    one_sampled = one.generate(tokens, n_new, **dict(sample, generator=torch.Generator()
                                                     .manual_seed(3)))
    return {"ids": ids.numpy(), "ids_all": ids_all, "one_ids": one_ids.numpy(),
            "sampled": sampled.numpy(), "one_sampled": one_sampled.numpy(),
            "logits": steps if rank == 0 else None,
            "one_logits": [t.numpy() for t in one_logits] if rank == 0 else None,
            "caches": whole if rank == 0 else None, "local": local,
            "specs": [{n: tuple(map(_entry, sp)) for n, sp in c["mixer"].items()}
                      for c in specs]}


def _entry(e):
    return tuple(sharding.entry_axes(e))
