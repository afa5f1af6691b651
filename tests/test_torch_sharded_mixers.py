"""Tensor parallelism of Mamba layers and expert parallelism of MoE layers
in the port's sharded training, against the JAX package's unsharded run
and the port's one process.

The port's parameters of each SMOKE config (``init_params``, seed 0) go to
the reference as its tree; the reference runs once, in two child
processes on threads (each a share of the configs), while 4 gloo
processes (``tests/_dist.py::spawn``) run every case in one group.  The
reference takes, per config, ``value_and_grad`` of its ``loss_fn`` (remat
``"full"``; the aux weight is an argument, so one compile serves both
weights) and AdamW's update (lr 1e-3, warmup 2 of 50) on each of
``STEPS`` batches: the steps of its ``train_step``, which also return the
gradients.  Its XLA compiles at optimization level 0 (its CPU time is in
compiling).

Each case runs ``STEPS`` steps on its mesh and in one process:

* every loss within 2e-4 relative of the reference's and of the port's
  one process, the first ``grad_norm`` within 1e-4 of the reference's;
* every gradient leaf of the first step, gathered whole on the mesh
  (``params.gather``) and read in the reference's layout, within 1e-4
  normwise of the reference's: a partial or doubly counted gradient (the
  gated norm's, the router's, the aux loss's) would show here;
* the leaves no mesh axis splits bitwise equal on every process after.

The cases: mamba2 on ``(2, 2)`` and ``(1, 4)`` (2 heads a process), with
two groups of B/C on ``(2, 2)``; jamba (Mamba, MoE and attention layers)
on ``(2, 2)``; granite on ``(2, 2)`` and ``(1, 4)`` (one expert a
process), and with ``aux_weight`` 1.0 on ``(2, 2)``; kimi (a shared
expert) on ``(2, 2)``.  Besides: jamba's elastic resume from ``(2, 2)`` to
``(1, 4)``, the launcher's mamba2-1.3b ``--scale 0.05`` over dp 2 x tp 2,
and the shapes that do not split, which raise before any collective.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _dist import spawn  # noqa: E402
from _mp import run  # noqa: E402
from _torch_lm import SAVE_PARAMS  # noqa: E402
import _torch_sharded as child  # noqa: E402
from _torch_train import assert_trees_close, leaves  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.distributed.sharding import AbstractMesh, axis_rules, default_rules  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
STEPS, BATCH, SEQ = 3, 4, 16
LOSS_RTOL, GNORM_RTOL, GRAD_RTOL = 2e-4, 1e-4, 1e-4
# config key: (module, SSMCfg fields replaced)
CONFIGS = {"mamba2": ("mamba2_1p3b", None), "mamba2_g2": ("mamba2_1p3b", {"n_groups": 2}),
           "jamba": ("jamba_v01_52b", None), "granite": ("granite_moe_3b", None),
           "kimi": ("kimi_k2", None)}
# case: (config key, aux weight, mesh)
CASES = {"mamba2-2x2": ("mamba2", 0.01, (2, 2)), "mamba2-1x4": ("mamba2", 0.01, (1, 4)),
         "mamba2_g2-2x2": ("mamba2_g2", 0.01, (2, 2)), "jamba-2x2": ("jamba", 0.01, (2, 2)),
         "granite-2x2": ("granite", 0.01, (2, 2)), "granite-1x4": ("granite", 0.01, (1, 4)),
         "granite_aux1-2x2": ("granite", 1.0, (2, 2)), "kimi-2x2": ("kimi", 0.01, (2, 2))}
# the reference's configs in two child processes side by side (compiles
# take its time: jamba's about as long as the other three together)
REFERENCE_SPLIT = (("jamba", "granite"), ("mamba2", "mamba2_g2", "kimi"))
LAUNCH = ["--arch", "mamba2-1.3b", "--scale", "0.05", "--steps", "3", "--seq", "32",
          "--device", "cpu"]

REFERENCE = """
os.environ["XLA_FLAGS"] += (" --xla_backend_optimization_level=0"
                            " --xla_llvm_disable_expensive_passes=true")
import jax.extend.core
jax.core.Primitive = jax.extend.core.Primitive
import dataclasses, importlib, sys
sys.path.insert(0, {tests!r})
from _torch_lm import unflatten
from repro import optim
from repro.models import transformer as tf
from repro.optim import schedule as sched
""" + SAVE_PARAMS + """
TMP = {tmp!r}
z = np.load(TMP + "/batches.npz")
batches = [dict(tokens=jnp.asarray(z["tokens%d" % s], jnp.int32),
                labels=jnp.asarray(z["labels%d" % s], jnp.int32)) for s in range({steps})]
ocfg = optim.AdamWCfg(lr=1e-3)
for key, mod, ssm, weights in {configs!r}:
    cfg = importlib.import_module("repro.configs." + mod).SMOKE
    if ssm:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, **ssm))
    cfg = dataclasses.replace(cfg, dtype="float32")
    params0 = jax.tree.map(jnp.asarray, unflatten(np.load(TMP + "/" + key + "_ref.npz")))

    def f(p, b, w, cfg=cfg):
        return tf.loss_fn(p, cfg, b, remat="full", aux_weight=w, loss_chunk=512)

    @jax.jit
    def step(p, o, b, w, f=f):
        (loss, _), g = jax.value_and_grad(f, has_aux=True)(p, b, w)
        lr_scale = sched.warmup_cosine(o["step"], warmup=2, total=50)
        p, o, om = optim.update(g, o, p, ocfg, lr_scale=lr_scale)
        return p, o, loss, om["grad_norm"], g

    for w in weights:
        params, opt, hist = params0, optim.init(params0, ocfg), []
        for s, b in enumerate(batches):
            params, opt, loss, gn, g = step(params, opt, b, jnp.float32(w))
            if s == 0:
                save_params(g, TMP + "/%s_%s_grads.npz" % (key, w))
            hist.append([float(loss), float(gn)])
        np.save(TMP + "/%s_%s_hist.npy" % (key, w), np.asarray(hist))
print("OK")
"""


def _cfg(key):
    module, ssm = CONFIGS[key]
    return child.smoke(module, ssm)


def port_rank(rank, world, tmp):
    """One process of the group: every case in turn, then jamba's elastic
    resume and the launcher."""
    out = {}
    for case, (key, w, mesh) in CASES.items():
        module, ssm = CONFIGS[key]
        out[case] = child.sharded_train(
            rank, world, module, mesh, STEPS, params_path=f"{tmp}/{key}_port.npz",
            batches_path=f"{tmp}/batches.npz", batch=BATCH, seq=SEQ, ssm=ssm, aux_weight=w,
            first_grads=True)
        out[case].pop("whole")
    out["elastic"] = child.elastic(rank, world, "jamba_v01_52b", 4, f"{tmp}/ckpt")
    out["launch"] = child.launcher(rank, world, LAUNCH + ["--dp", "2", "--tp", "2"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's child on a thread while the port's processes run."""
    tmp = tmp_path_factory.mktemp("torch_sharded_mixers")
    rng = np.random.RandomState(7)
    vocab = min(_cfg(k).vocab for k in CONFIGS)
    batches = {}
    for s in range(STEPS):
        labels = rng.randint(0, vocab, (BATCH, SEQ))
        labels[s % BATCH, -3:] = -100
        batches[f"tokens{s}"] = rng.randint(0, vocab, (BATCH, SEQ))
        batches[f"labels{s}"] = labels
    np.savez(tmp / "batches.npz", **batches)
    weights = {}
    for case, (key, w, _) in CASES.items():
        weights.setdefault(key, set()).add(w)
    for key in CONFIGS:
        cfg = _cfg(key)
        params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        np.savez(tmp / f"{key}_port.npz", **{k: v.numpy() for k, v in params.items()})
        np.savez(tmp / f"{key}_ref.npz", **leaves(convert.tree_to_reference(cfg, params)))
    failed = []

    def reference(keys):
        configs = [(key, *CONFIGS[key], sorted(weights[key])) for key in keys]
        try:
            run(REFERENCE.format(tests=TESTS, tmp=str(tmp), steps=STEPS, configs=configs), ndev=1)
        except BaseException as e:   # re-raised in the test process below
            failed.append(e)

    refs = [threading.Thread(target=reference, args=(keys,)) for keys in REFERENCE_SPLIT]
    for ref in refs:
        ref.start()
    try:
        port = spawn(4, "test_torch_sharded_mixers:port_rank", tmp, str(tmp), timeout=300,
                     group_timeout=120)
    finally:
        for ref in refs:
            ref.join()
    if failed:
        raise failed[0]
    return tmp, port


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.all(np.abs(got - want) <= rtol * np.abs(want)), (what, got, want)


def _reference(tmp, case):
    key, w, _ = CASES[case]
    return key, w, np.load(tmp / f"{key}_{w}_hist.npy")


@pytest.mark.parametrize("case", CASES)
def test_losses_match_the_reference_and_one_process(runs, case):
    tmp, port = runs
    _, _, hist = _reference(tmp, case)
    for r, p in enumerate(port):
        got, one = np.asarray(p[case]["sharded"]), np.asarray(p[case]["one"])
        _close(got[:, 0], hist[:, 0], LOSS_RTOL, f"{case} rank {r} loss vs the reference")
        _close(got[:, 0], one[:, 0], LOSS_RTOL, f"{case} rank {r} loss vs one process")
        _close(one[:, 0], hist[:, 0], LOSS_RTOL, f"{case} rank {r} one process vs the reference")
        _close(got[0, 1], hist[0, 1], GNORM_RTOL, f"{case} rank {r} first grad_norm")
    assert all(p[case]["sharded"] == port[0][case]["sharded"] for p in port), case


@pytest.mark.parametrize("case", CASES)
def test_first_step_gradients_match_the_reference(runs, case):
    """Every leaf of the first step's gradient on the mesh, gathered whole,
    within 1e-4 normwise of the reference's (none left out)."""
    from _torch_lm import unflatten

    tmp, port = runs
    key, w, _ = _reference(tmp, case)
    grads = {k: torch.from_numpy(v) for k, v in port[0][case]["grads"].items()}
    want = unflatten(np.load(tmp / f"{key}_{w}_grads.npz"))
    assert_trees_close(convert.tree_to_reference(_cfg(key), grads), want, GRAD_RTOL, case)


@pytest.mark.parametrize("case", CASES)
def test_replicated_leaves_stay_bitwise_equal(runs, case):
    _, port = runs
    rep = [p[case]["replicated"] for p in port]
    assert rep[0] and all(r == rep[0] for r in rep[1:]), case


def test_local_shapes_follow_the_rules(runs):
    """On (2, 2) a process holds half of ``out_proj``'s d_inner rows (its
    heads) and half of the experts; on (1, 4) a quarter."""
    _, port = runs
    mamba, gran = _cfg("mamba2"), _cfg("granite")
    d_in = mamba.ssm.expand * mamba.d_model
    for case, tp in (("mamba2-2x2", 2), ("mamba2-1x4", 4)):
        shapes = port[0][case]["shapes"]["params"]
        assert shapes["layers.0.mixer.out_proj.weight"][1] == d_in // tp, (case, shapes)
    for case, tp in (("granite-2x2", 2), ("granite-1x4", 4)):
        shapes = port[0][case]["shapes"]["params"]
        assert shapes["layers.0.ffn.wi"][0] == gran.moe.n_experts // tp, (case, shapes)


def test_jamba_elastic_resume_across_meshes(runs):
    """jamba: 2 steps on (2, 2), a checkpoint, 2 on (1, 4) from it, and 2 in
    one process from it, against the 4 steps of one process."""
    _, port = runs
    for r, p in enumerate(port):
        e = p["elastic"]
        one = [x[0] for x in e["one"]]
        _close([x[0] for x in e["first"] + e["second"]], one, LOSS_RTOL, f"rank {r} resumed")
        _close([x[0] for x in e["one_from_ckpt"]], one[2:], LOSS_RTOL, f"rank {r} one process")


def test_launcher_trains_mamba2_over_dp2_tp2(runs):
    from repro_torch.launch import train as launch

    _, port = runs
    one = launch.main(list(LAUNCH))
    hists = [p["launch"]["hist"] for p in port]
    assert [p["launch"]["rank"] for p in port] == [0, 1, 2, 3]
    assert all(h == hists[0] for h in hists)
    _close(hists[0], one, LOSS_RTOL, "launcher (2, 2) vs one process")


def _scaled_mamba2():
    from repro_torch.configs import base as cb
    from repro_torch.launch.train import shrink

    return shrink(cb.get("mamba2-1.3b"), 0.05)


def _six_experts():
    cfg = child.smoke("granite_moe_3b")
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=6))


def _groups_of_four():
    cfg = child.smoke("mamba2_1p3b", {"n_groups": 3})
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, expand=3))


@pytest.mark.parametrize("make,mesh,match", [
    (_scaled_mamba2, (1, 4), r"6 heads \(d_inner 192\) do not split over the mesh axes "
                             r"\('model',\) \(\{'data': 1, 'model': 4\}\)"),
    (_six_experts, (1, 4), r"6 experts do not split over the mesh axes \('model',\) "
                           r"\(\{'data': 1, 'model': 4\}\)"),
    (_groups_of_four, (1, 2), r"6 Mamba heads a process do not map onto whole groups of B/C "
                              r"\(3 groups of 4 heads\)"),
], ids=["mamba2-scale0.05-heads", "granite-experts", "mamba-groups"])
def test_shapes_that_do_not_split_raise(make, mesh, match):
    """Before any collective (no group here), naming the shapes and the mesh."""
    cfg = make()
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.zeros(4, 8, dtype=torch.long),
             "labels": torch.zeros(4, 8, dtype=torch.long)}
    rules = default_rules(AbstractMesh(mesh, ("data", "model")), batch_size=4)
    with axis_rules(rules), pytest.raises(NotImplementedError, match=match):
        tf.loss_fn(params, cfg, batch)
