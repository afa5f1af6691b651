"""Helpers of the training tests of the port: the JAX package's
``value_and_grad`` of ``transformer.loss_fn`` on the SMOKE configs, run in
one child process, and the normwise comparison of gradient trees.

:func:`reference_grads` materializes each config's parameters
(``PRNGKey(2)``), takes ``jax.value_and_grad`` of ``tf.loss_fn`` (remat
``"full"``, ``aux_weight`` 0.01, ``loss_chunk`` 8 of T 16) on one batch
with some labels -100, and returns per config the parameter tree, the
gradient tree and (loss, xent, aux).  :func:`check` holds the port's
``loss_fn`` and its gradients under one remat policy against them.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

from _mp import run
from _torch_lm import SAVE_PARAMS, unflatten
from repro_torch import convert
from repro_torch.models import transformer as tf

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"
B, T, CHUNK, AUX_WEIGHT = 2, 16, 8, 0.01
POLICIES = ("none", "dots", "dots_no_batch")   # besides "full"
# float32 sums in another order through a few layers
GRAD_RTOL, LOSS_RTOL = 2e-5, 1e-5

GRADS = ALIAS + SAVE_PARAMS + """
import dataclasses, importlib
from repro.models import params as pm, transformer as tf

TMP = {tmp!r}
data = np.load(TMP + "/batch.npz")
batch = dict(tokens=jnp.asarray(data["tokens"], jnp.int32),
             labels=jnp.asarray(data["labels"], jnp.int32))
for mod in {modules!r}:
    cfg = dataclasses.replace(importlib.import_module("repro.configs." + mod).SMOKE,
                              dtype="float32")
    params = pm.materialize(tf.param_specs(cfg), jax.random.PRNGKey(2), jnp.float32)
    save_params(params, TMP + "/" + mod + "_params.npz")

    def f(p):
        return tf.loss_fn(p, cfg, batch, remat="full", aux_weight={aux}, loss_chunk={chunk})

    (loss, m), g = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    save_params(g, TMP + "/" + mod + "_grads.npz")
    np.savez(TMP + "/" + mod + "_out.npz", loss=np.asarray(loss), xent=np.asarray(m["xent"]),
             aux=np.asarray(m["aux"]))
print("OK")
"""


def smoke(mod):
    cfg = importlib.import_module(f"repro_torch.configs.{mod}").SMOKE
    return dataclasses.replace(cfg, dtype="float32")


def reference_grads(tmp, modules) -> tuple:
    """(batch as NumPy, {mod: (cfg, params tree, grads tree, {loss, xent, aux})})."""
    vocab = min(smoke(m).vocab for m in modules)
    rng = np.random.RandomState(4)
    tokens = rng.randint(0, vocab, (B, T))
    labels = rng.randint(0, vocab, (B, T))
    labels[0, -3:] = -100
    labels[1, 5] = -100
    np.savez(tmp / "batch.npz", tokens=tokens, labels=labels)
    run(GRADS.format(tmp=str(tmp), modules=tuple(modules), aux=AUX_WEIGHT, chunk=CHUNK), ndev=1)
    out = {}
    for mod in modules:
        out[mod] = (smoke(mod), unflatten(np.load(tmp / f"{mod}_params.npz")),
                    unflatten(np.load(tmp / f"{mod}_grads.npz")),
                    dict(np.load(tmp / f"{mod}_out.npz")))
    return {"tokens": tokens, "labels": labels}, out


def port_loss_and_grads(reference, mod, remat):
    """The port's loss, metrics and ``{name: gradient}`` on the reference's
    parameters and batch of ``mod``, under ``remat``."""
    batch, out = reference
    cfg, tree, _, _ = out[mod]
    params = {k: v.requires_grad_(True)
              for k, v in convert.params_from_reference(cfg, tree).items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = tf.loss_fn(params, cfg, tb, remat=remat, aux_weight=AUX_WEIGHT,
                               loss_chunk=CHUNK)
    grads = torch.autograd.grad(loss, list(params.values()))
    return cfg, loss.detach(), metrics, dict(zip(params, grads))


def check(reference, mod, remat):
    """loss, xent and aux within LOSS_RTOL of the reference's, and every
    gradient leaf (none left out) within GRAD_RTOL normwise."""
    _, out = reference
    _, _, want_grads, want = out[mod]
    cfg, loss, metrics, grads = port_loss_and_grads(reference, mod, remat)
    for name, got in (("loss", loss), ("xent", metrics["xent"].detach()),
                      ("aux", metrics["aux"].detach())):
        np.testing.assert_allclose(float(got), float(want[name]), rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=f"{mod} {remat} {name}")
    assert_trees_close(convert.tree_to_reference(cfg, grads), want_grads, GRAD_RTOL,
                       f"{mod} remat={remat}")


def leaves(tree, path=()):
    """``{"/"-joined path: array}`` of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in leaves(sub, path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in leaves(sub, path + (str(i),)).items()}
    return {"/".join(path): np.asarray(tree)}


def assert_trees_close(got, want, rtol: float, what: str) -> None:
    """Every leaf of ``want`` present in ``got`` (and no other), each within
    ``rtol`` normwise: ``|got - want|_2 <= rtol |want|_2`` (plus 1e-12
    for an all-zero leaf)."""
    g, w = leaves(got), leaves(want)
    assert set(g) == set(w), (what, sorted(set(g) ^ set(w)))
    for k in w:
        assert g[k].shape == w[k].shape, (what, k, g[k].shape, w[k].shape)
        err = np.linalg.norm((g[k].astype(np.float64) - w[k]).ravel())
        assert err <= rtol * np.linalg.norm(w[k].ravel()) + 1e-12, (what, k, err,
                                                                    np.linalg.norm(w[k]))
