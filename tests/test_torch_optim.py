"""The port's optimizer (``repro_torch.optim``) against the JAX package's
``optim``, float32 on the CPU, the reference in one child process:

* ``schedule.warmup_cosine`` at steps 0-120 equal to the reference's
  eager and jitted forms within 1.2e-7 absolute: the reference's two
  forms differ from each other by that much at about a third of the steps
  (XLA's fused cosine and division are not the eager ones, and
  ``1 + cos`` cancels near the end of the cosine);
* ``quant.quantize``: codes equal and scales to rtol 1e-6, p = 1 and 4, at
  last axes of 64, 128 and 300 (a padded last block, an all-zero block);
* AdamW: three updates with float32, bfloat16 and int8 moments on a
  llama-SMOKE tree (the reference's gradients, clip and decay on; its
  update jitted, as its train step is): the parameters within 1e-5
  normwise per leaf; float32 moments within 1e-5, bfloat16 moments within
  2^-8 normwise (a float32 value at a rounding edge rounds to the other
  neighbour, and a moment that cancels to near 0 carries that flip on; the
  reference's own jitted and eager forms differ by up to 6.6 bfloat16
  steps of such an entry); int8
  codes equal in at least 99.9 % of the entries and off by at most 1
  elsewhere, scales within 1e-4 (sums in another order move a block's
  maximum by ulps, and a code at a rounding edge by one);
* weight decay on the stacked norms (``ln1``) and not on ``final_norm``
  (ROADMAP.md, F14), and the reference's own optimizer tests on the port.
"""

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
from _torch_train import leaves  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.configs import llama3_2_1b  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import quant, schedule  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"
CFG = dataclasses.replace(llama3_2_1b.SMOKE, dtype="float32")
MODES = ("float32", "bfloat16", "int8")
LR_SCALES = (1.0, 0.5, 0.25)
OPT = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
QUANT_SHAPES = ((3, 64), (2, 5, 128), (4, 300))

REFERENCE = ALIAS + SAVE_PARAMS + """
import dataclasses, importlib
from repro import optim
from repro.models import params as pm, transformer as tf
from repro.optim import quant, schedule

TMP = {tmp!r}
steps = jnp.arange(121)
np.save(TMP + "/sched.npy", np.stack([np.stack([
    np.asarray(jax.vmap(lambda s: schedule.warmup_cosine(s, warmup=w, total=t))(steps)),
    np.asarray(jax.jit(jax.vmap(lambda s: schedule.warmup_cosine(s, warmup=w, total=t)))(steps))])
    for w, t in ((20, 120), (10, 50), (0, 100))]))
qin = np.load(TMP + "/quant_in.npz")
out = dict()
for name in qin.files:
    for p in (1, 4):
        qs = quant.quantize(jnp.asarray(qin[name]), p=p)
        out[name + "_p%d_q" % p] = np.asarray(qs["q"])
        out[name + "_p%d_s" % p] = np.asarray(qs["s"])
        out[name + "_p%d_back" % p] = np.asarray(quant.dequantize(qs, p=p))
np.savez(TMP + "/quant_out.npz", **out)

cfg = dataclasses.replace(importlib.import_module("repro.configs.llama3_2_1b").SMOKE,
                          dtype="float32")
params0 = pm.materialize(tf.param_specs(cfg), jax.random.PRNGKey(3), jnp.float32)
save_params(params0, TMP + "/params0.npz")
rng = np.random.RandomState(7)
grads = []
for i in range(3):
    g = jax.tree.map(lambda x: jnp.asarray(rng.randn(*x.shape) * 0.05, jnp.float32), params0)
    save_params(g, TMP + "/grads%d.npz" % i)
    grads.append(g)
up = lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x
for mode in {modes!r}:
    ocfg = optim.AdamWCfg(moments=mode, **{opt!r})
    params, state = params0, optim.init(params0, ocfg)
    update = jax.jit(lambda g, st, p, s: optim.update(g, st, p, ocfg, lr_scale=s))
    norms = []
    for g, s in zip(grads, {lr_scales!r}):
        params, state, m = update(g, state, params, jnp.float32(s))
        norms.append(float(m["grad_norm"]))
    save_params(params, TMP + "/" + mode + "_params.npz")
    save_params(jax.tree.map(up, state["m"]), TMP + "/" + mode + "_m.npz")
    save_params(jax.tree.map(up, state["v"]), TMP + "/" + mode + "_v.npz")
    np.save(TMP + "/" + mode + "_norms.npy", np.asarray(norms))
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_optim")
    rng = np.random.RandomState(11)
    qin = {}
    for shape in QUANT_SHAPES:
        x = (rng.randn(*shape) * 3.0).astype(np.float32)
        x[0, ..., :BLOCK_ZERO] = 0.0   # an all-zero first block in row 0
        qin["x" + "x".join(map(str, shape))] = x
    np.savez(tmp / "quant_in.npz", **qin)
    run(REFERENCE.format(tmp=str(tmp), modes=MODES, opt=OPT, lr_scales=LR_SCALES), ndev=1)
    return tmp, qin


BLOCK_ZERO = 64   # the zeroed prefix of row 0 (a whole block at a last axis of 64)


def test_warmup_cosine_equal_at_steps_0_to_120(reference):
    tmp, _ = reference
    want = np.load(tmp / "sched.npy")
    steps = torch.arange(121, dtype=torch.int32)
    for rows, (w, t) in zip(want, ((20, 120), (10, 50), (0, 100))):
        got = torch.stack([schedule.warmup_cosine(s, warmup=w, total=t) for s in steps])
        assert got.dtype == torch.float32 and got.shape == (121,)
        np.testing.assert_allclose(rows[0], rows[1], rtol=0, atol=1.2e-7)   # the spread
        for row in rows:   # the reference eager, then jitted
            np.testing.assert_allclose(got.numpy(), row, rtol=0, atol=1.2e-7)
    assert schedule.constant(steps[5]).item() == 1.0


@pytest.mark.parametrize("p", (1, 4))
@pytest.mark.parametrize("shape", QUANT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_quantize_codes_and_scales_equal_the_reference(reference, shape, p):
    tmp, qin = reference
    want = np.load(tmp / "quant_out.npz")
    name = "x" + "x".join(map(str, shape))
    qs = quant.quantize(torch.from_numpy(qin[name]), p=p)
    assert qs["q"].dtype == torch.int8 and qs["q"].shape == shape
    assert qs["s"].shape == (*shape[:-1], -(-shape[-1] // quant.BLOCK))
    np.testing.assert_array_equal(qs["q"].numpy(), want[f"{name}_p{p}_q"])
    np.testing.assert_allclose(qs["s"].numpy(), want[f"{name}_p{p}_s"], rtol=1e-6)
    if shape[-1] == BLOCK_ZERO:
        assert float(qs["s"][0, 0]) == 1.0   # an all-zero block takes the scale 1
    np.testing.assert_allclose(quant.dequantize(qs, p=p).numpy(), want[f"{name}_p{p}_back"],
                               rtol=1e-6, atol=1e-7)


def _port_run(tmp, mode):
    layout = tf.reference_layout(CFG)
    params = convert.params_from_reference(CFG, unflatten(np.load(tmp / "params0.npz")))
    ocfg = optim.AdamWCfg(moments=mode, **OPT)
    state = optim.init(params, ocfg, layout=layout)
    norms = []
    for i, s in enumerate(LR_SCALES):
        g = convert.params_from_reference(CFG, unflatten(np.load(tmp / f"grads{i}.npz")))
        params, state, m = optim.update(g, state, params, ocfg, lr_scale=s, layout=layout)
        norms.append(float(m["grad_norm"]))
    return params, state, norms


def _moment_leaves(tmp, mode, which):
    return leaves(unflatten(np.load(tmp / f"{mode}_{which}.npz")))


@pytest.mark.parametrize("mode", MODES)
def test_adamw_three_updates_match_the_reference(reference, mode):
    tmp, _ = reference
    params, state, norms = _port_run(tmp, mode)
    np.testing.assert_allclose(norms, np.load(tmp / f"{mode}_norms.npy"), rtol=1e-6)
    assert int(state["step"]) == 3 and state["step"].dtype == torch.int32
    got, want = leaves(convert.tree_to_reference(CFG, params)), leaves(
        unflatten(np.load(tmp / f"{mode}_params.npz")))
    assert set(got) == set(want)
    for k in want:
        err = np.linalg.norm(got[k] - want[k])
        assert err <= 1e-5 * np.linalg.norm(want[k]), (mode, k, err)
    ref = convert.opt_state_to_reference(CFG, state)
    for which in ("m", "v"):
        got, want = leaves(ref[which]), _moment_leaves(tmp, mode, which)
        assert set(got) == set(want), (which, sorted(set(got) ^ set(want)))
        for k in want:
            g, w = got[k], want[k]
            assert g.shape == w.shape, (k, g.shape, w.shape)
            if mode == "float32":
                assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w), (which, k)
            elif mode == "bfloat16":
                assert np.linalg.norm(g - w) <= 2.0 ** -8 * np.linalg.norm(w), (which, k)
            elif k.endswith("/q"):
                diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
                assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, (which, k, diff.max(),
                                                                        (diff == 0).mean())
            else:
                np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=f"{which} {k}")


def test_weight_decay_on_stacked_norms_not_on_final_norm():
    """The reference decays a leaf of two axes or more, its repeat axis
    counted: ``ln1`` (R, d) is decayed, ``final_norm`` (d,) is not."""
    layout = tf.reference_layout(CFG)
    params = tf.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    zero = {k: torch.zeros_like(v) for k, v in params.items()}
    ocfg = optim.AdamWCfg(lr=0.1, weight_decay=0.5)
    new, _, _ = optim.update(zero, optim.init(params, ocfg, layout=layout), params, ocfg,
                             layout=layout)
    assert layout["layers.0.ln1"].ndim == 2 and layout["final_norm"].ndim == 1
    torch.testing.assert_close(new["layers.0.ln1"], params["layers.0.ln1"] * (1 - 0.05),
                               rtol=1e-6, atol=0)
    assert torch.equal(new["final_norm"], params["final_norm"])
    torch.testing.assert_close(new["embed"], params["embed"] * (1 - 0.05), rtol=1e-6, atol=0)


def test_update_is_out_of_place_and_keeps_the_port_layout():
    layout = tf.reference_layout(CFG)
    params = tf.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    before = {k: v.clone() for k, v in params.items()}
    ocfg = optim.AdamWCfg(moments="int8")
    state = optim.init(params, ocfg, layout=layout)
    grads = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(1))
             for k, v in params.items()}
    new, new_state, m = optim.update(grads, state, params, ocfg, layout=layout)
    assert all(torch.equal(params[k], before[k]) for k in params)
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1
    assert {k: v.shape for k, v in new.items()} == {k: v.shape for k, v in params.items()}
    wq = "layers.0.mixer.wq.weight"   # (H Dh, d) in the port; moments (d, H, Dh)
    assert new_state["m"][wq]["q"].shape == (CFG.d_model, CFG.n_heads, CFG.head_dim)
    assert m["grad_norm"].shape == () and m["grad_norm"].device == params[wq].device


@pytest.mark.parametrize("mode", MODES)
def test_state_specs_match_init(mode):
    layout = tf.reference_layout(CFG)
    params = tf.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    ocfg = optim.AdamWCfg(moments=mode)
    specs, state = optim.state_specs(layout, ocfg), optim.init(params, ocfg, layout=layout)

    def sig(t):
        return {k: sig(v) for k, v in t.items()} if isinstance(t, dict) else (
            tuple(t.shape), t.dtype)

    assert sig(specs) == sig(state)
    assert all(t.device.type == "meta" for t in leaves_t(specs))


def leaves_t(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves_t(v)]
    return [tree]


def test_quant_roundtrip():
    """The reference's ``test_quant_roundtrip`` on the port."""
    rng = np.random.RandomState(0)
    for shape in [(7,), (3, 130), (2, 4, 256), (5, 128)]:
        x = torch.from_numpy((rng.randn(*shape) * 3.0).astype(np.float32))
        back = quant.dequantize(quant.quantize(x))
        err = (back - x).abs().max()
        assert err <= x.abs().max() / 127.0 + 1e-6, (shape, float(err))


def test_int8_adam_tracks_fp32():
    """The reference's ``test_int8_adam_tracks_fp32`` on the port: quantized
    moments follow float32 moments on a quadratic."""
    rng = np.random.RandomState(1)
    target = torch.from_numpy(rng.randn(4, 256).astype(np.float32))
    results = {}
    for mode in MODES:
        cfg = optim.AdamWCfg(lr=0.05, weight_decay=0.0, moments=mode)
        params = {"w": torch.zeros(4, 256)}
        state = optim.init(params, cfg)
        for _ in range(60):
            w = params["w"].detach().requires_grad_(True)
            (g,) = torch.autograd.grad(torch.mean((w - target) ** 2), [w])
            params, state, _ = optim.update({"w": g}, state, params, cfg)
        results[mode] = float(torch.mean((params["w"] - target) ** 2))
    assert results["float32"] < 1e-2
    assert results["int8"] < 3 * results["float32"] + 1e-2, results
    assert results["bfloat16"] < 3 * results["float32"] + 1e-2, results


def test_unknown_moments_raise():
    with pytest.raises(ValueError, match="moments"):
        optim.init({"w": torch.zeros(3)}, optim.AdamWCfg(moments="float16"))


def test_launcher_runs_on_the_cpu_and_refuses_sharding(capsys, tmp_path):
    """``python -m repro_torch.launch.train --arch llama3.2-1b --scale 0.05
    --steps 3 --device cpu`` runs (its ``main``, in this process); ``--dp 2``
    in one process raises (no fall-back to one process), and over 2 gloo
    processes ``--dp 2 --tp 1`` trains, every process with the same losses
    as the one-process run's first steps within float32's summation
    order."""
    from _dist import spawn
    from repro_torch.launch import train as launch

    hist = launch.main(["--arch", "llama3.2-1b", "--scale", "0.05", "--steps", "3",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[launch] llama3.2-1b @ scale 0.05: 0.8M params, 1 layers" in out
    assert "over 3 steps" in out and len(hist) == 3 and np.isfinite(hist).all()
    with pytest.raises(ValueError, match="dp 2"):
        launch.main(["--dp", "2", "--device", "cpu"])
    got = spawn(2, "_torch_sharded:launcher", tmp_path,
                ["--arch", "llama3.2-1b", "--scale", "0.05", "--steps", "3", "--dp", "2",
                 "--tp", "1", "--device", "cpu"], timeout=180)
    assert [g["rank"] for g in got] == [0, 1]
    for g in got:
        np.testing.assert_allclose(g["hist"], hist, rtol=2e-4)
