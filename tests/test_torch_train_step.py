"""The port's train step (``repro_torch.train.make_train_step``) against the
JAX package's, float32 on the CPU: the reference runs its jitted
``make_train_step`` for three steps on llama SMOKE with ``grad_accum`` 1
and 2 from the same parameters, on its own synthetic batches, in one child
process; the port is fed those parameters and batches.  Loss,
``grad_norm`` and ``lr_scale`` each step to 1e-5 relative and the
parameters after three steps to 1e-5 normwise per leaf (float32 sums in
another order)."""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _mp import run  # noqa: E402
from _torch_lm import SAVE_PARAMS, unflatten  # noqa: E402
from _torch_train import ALIAS, leaves  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.configs import llama3_2_1b  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.train import TrainCfg, make_train_step  # noqa: E402

CFG = dataclasses.replace(llama3_2_1b.SMOKE, dtype="float32")
ACCUM = (1, 2)
TCFG = dict(remat="full", warmup=2, total_steps=50)
LR = 1e-3

REFERENCE = ALIAS + SAVE_PARAMS + """
import dataclasses, importlib
from repro import optim
from repro.data import SyntheticLMData
from repro.models import params as pm, transformer as tf
from repro.train import TrainCfg, make_train_step

TMP = {tmp!r}
cfg = dataclasses.replace(importlib.import_module("repro.configs.llama3_2_1b").SMOKE,
                          dtype="float32")
params0 = pm.materialize(tf.param_specs(cfg), jax.random.PRNGKey(0), jnp.float32)
save_params(params0, TMP + "/params0.npz")
data = SyntheticLMData(vocab=cfg.vocab, batch=4, seq=16, seed=0)
batches = [data.batch_at(jnp.asarray(s)) for s in range(3)]
np.savez(TMP + "/batches.npz", **dict(
    ("%s%d" % (k, s), np.asarray(b[k])) for s, b in enumerate(batches) for k in b))
for accum in {accum!r}:
    tcfg = TrainCfg(opt=optim.AdamWCfg(lr={lr}), grad_accum=accum, **{tcfg!r})
    step = jax.jit(make_train_step(cfg, tcfg))
    params, opt = params0, optim.init(params0, tcfg.opt)
    hist = []
    for b in batches:
        params, opt, m = step(params, opt, b)
        hist.append([float(m[k]) for k in ("loss", "grad_norm", "lr_scale", "xent", "aux")])
    np.save(TMP + "/hist%d.npy" % accum, np.asarray(hist))
    save_params(params, TMP + "/params%d.npz" % accum)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_train_step")
    run(REFERENCE.format(tmp=str(tmp), accum=ACCUM, lr=LR, tcfg=TCFG), ndev=1)
    return tmp


@pytest.mark.parametrize("accum", ACCUM)
def test_train_step_three_steps_match_the_reference(reference, accum):
    tmp = reference
    params = convert.params_from_reference(CFG, unflatten(np.load(tmp / "params0.npz")))
    tcfg = TrainCfg(opt=optim.AdamWCfg(lr=LR), grad_accum=accum, **TCFG)
    opt = optim.init(params, tcfg.opt, layout=tf.reference_layout(CFG))
    step = make_train_step(CFG, tcfg)
    bz = np.load(tmp / "batches.npz")
    hist = []
    for s in range(3):
        batch = {k: torch.from_numpy(bz[f"{k}{s}"]).long() for k in ("tokens", "labels")}
        params, opt, m = step(params, opt, batch)
        assert all(m[k].shape == () for k in ("loss", "xent", "aux", "lr_scale", "grad_norm"))
        hist.append([float(m[k]) for k in ("loss", "grad_norm", "lr_scale", "xent", "aux")])
    np.testing.assert_allclose(hist, np.load(tmp / f"hist{accum}.npy"), rtol=1e-5, atol=1e-7)
    if accum > 1:   # the reference's metrics under accumulation
        assert all(h[3] == h[0] and h[4] == 0.0 for h in hist)
    got = leaves(convert.tree_to_reference(CFG, params))
    want = leaves(unflatten(np.load(tmp / f"params{accum}.npz")))
    assert set(got) == set(want)
    for k in want:
        err = np.linalg.norm((got[k].astype(np.float64) - want[k]).ravel())
        assert err <= 1e-5 * np.linalg.norm(want[k].ravel()) + 1e-12, (k, err)


def test_train_step_refuses_a_batch_that_does_not_split():
    params = tf.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    tcfg = TrainCfg(grad_accum=3)
    opt = optim.init(params, tcfg.opt, layout=tf.reference_layout(CFG))
    tokens = torch.zeros(4, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(CFG, tcfg)(params, opt, {"tokens": tokens, "labels": tokens})
