"""The port's context-parallel forward
(``repro_torch.distributed.context_parallel.context_parallel_logits``) on 4
processes of a gloo group against the JAX package's over a 4-device mesh.

The reference runs once, in a module-scoped child process (on a thread,
while the port runs once it has written the weights): the cases of
``tests/test_context_parallel.py`` (the ``SMOKE`` configs of gemma3,
mamba2 and jamba in float32, ``PRNGKey(0/1/2)`` weights, B 2, T 32 tokens
from ``RandomState(0/1/2)``), saving the weights, the plain forward's
logits and its context-parallel logits.  The weights reach the port
through ``convert.params_from_reference``; the port runs once in 4
processes (``tests/_dist.py::spawn``), each returning its shard of the
logits.  Tolerances are the reference test's: gemma3 3e-4, mamba2 and
jamba 5e-4, against both of the reference's logits.  Without a group the
port's context-parallel logits are the plain forward's.  The raises: T
not divisible by the processes, a config that is not the model's, a
window wider than the shard.  The example twin
``examples/torch_context_parallel.py`` runs in the same 4 processes.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "examples"))

from _dist import spawn  # noqa: E402
from _mp import run  # noqa: E402
from _torch_lm import SAVE_PARAMS, unflatten  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.distributed.context_parallel import context_parallel_logits  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"
R, B, T = 4, 2, 32
# name: (config module, seed of the weights and the tokens, tolerance)
CASES = {"gemma3": ("gemma3_4b", 0, 3e-4), "mamba2": ("mamba2_1p3b", 1, 5e-4),
         "jamba": ("jamba_v01_52b", 2, 5e-4)}

REFERENCE = ALIAS + SAVE_PARAMS + """
import dataclasses, importlib
from jax.sharding import Mesh
from repro.distributed.context_parallel import context_parallel_logits
from repro.models import params as pm, transformer as tf

TMP = {tmp!r}
mesh = Mesh(np.array(jax.devices()[:4]), ("sp",))
made = dict()
for name, (mod, seed, _) in {cases!r}.items():   # the weights and tokens first: the port waits
    cfg = importlib.import_module("repro.configs." + mod).SMOKE
    cfg = dataclasses.replace(cfg, dtype="float32")
    params = pm.materialize(tf.param_specs(cfg), jax.random.PRNGKey(seed), jnp.float32)
    save_params(params, TMP + "/" + name + "_params.npz")
    rng = np.random.RandomState(seed)
    toks = jnp.asarray(rng.randint(0, cfg.vocab, ({b}, {t})), jnp.int32)
    np.save(TMP + "/" + name + "_tokens.npy", np.asarray(toks))
    made[name] = cfg, params, toks
open(TMP + "/inputs.ready", "w").close()
for name, (cfg, params, toks) in made.items():
    h, _, _ = tf.fwd(params, cfg, toks, mode="train", remat="none")
    np.save(TMP + "/" + name + "_plain.npy", np.asarray(tf.logits_fn(params, cfg, h)))
    np.save(TMP + "/" + name + "_cp.npy",
            np.asarray(context_parallel_logits(params, cfg, toks, mesh, axis="sp")))
print("OK")
"""


def _cfg(name):
    mod = CASES[name][0]
    return dataclasses.replace(importlib.import_module(f"repro_torch.configs.{mod}").SMOKE,
                               dtype="float32")


def _model(name, trees):
    cfg = _cfg(name)
    return cfg, Model(cfg, convert.params_from_reference(cfg, trees[name]), device="cpu")


def port_rank(rank, world, trees, tokens):
    """One process of the group: its shard of each model's logits, what the
    raises say, and the example twin's figures."""
    out = {}
    for name in CASES:
        cfg, model = _model(name, trees)
        with torch.inference_mode():
            out[name] = context_parallel_logits(model, cfg, torch.from_numpy(tokens[name]),
                                                axis="sp").numpy()
    cfg, model = _model("gemma3", trees)
    errs = {}
    for what, toks in (("T % R", tokens["gemma3"][:, :30]), ("window", tokens["gemma3"][:, :16])):
        try:
            context_parallel_logits(model, cfg, torch.from_numpy(toks), axis="sp")
        except ValueError as e:
            errs[what] = str(e)
    out["errors"] = errs
    import torch_context_parallel
    out["example"] = torch_context_parallel.main(["--device", "cpu", "--per-shard", "8"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's child on a thread; the port's processes start once
    it has written the weights and tokens, while it computes its logits."""
    tmp = tmp_path_factory.mktemp("torch_context_parallel")
    failed = []

    def reference():
        try:
            run(REFERENCE.format(tmp=str(tmp), cases=CASES, b=B, t=T), ndev=4)
        except BaseException as e:   # re-raised in the test process below
            failed.append(e)

    child = threading.Thread(target=reference)
    child.start()
    deadline = time.monotonic() + 300
    while not (tmp / "inputs.ready").exists() and child.is_alive() \
            and time.monotonic() < deadline:
        time.sleep(0.1)
    if not (tmp / "inputs.ready").exists():
        child.join()
        raise failed[0] if failed else AssertionError("the reference wrote no inputs")
    trees = {n: unflatten(np.load(tmp / f"{n}_params.npz")) for n in CASES}
    tokens = {n: np.load(tmp / f"{n}_tokens.npy") for n in CASES}
    port = spawn(R, "test_torch_context_parallel:port_rank", tmp, trees, tokens)
    child.join()
    if failed:
        raise failed[0]
    ref = {n: {k: np.load(tmp / f"{n}_{k}.npy") for k in ("plain", "cp")} for n in CASES}
    return trees, tokens, ref, port


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("against", ["cp", "plain"])
def test_context_parallel_logits_match_reference(runs, name, against):
    _, _, ref, port = runs
    got = np.concatenate([p[name] for p in port], axis=1)
    assert got.shape == (B, T, _cfg(name).padded_vocab)
    tol = CASES[name][2]
    np.testing.assert_allclose(got, ref[name][against], rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(CASES))
def test_world_one_is_the_plain_forward(runs, name):
    trees, tokens, ref, _ = runs
    cfg, model = _model(name, trees)
    toks = torch.from_numpy(tokens[name])
    with torch.inference_mode():
        got = context_parallel_logits(model, cfg, toks, axis="sp")
        h, _, _ = tf.fwd(model, toks, mode="train")
        torch.testing.assert_close(got, tf.logits_fn(model, h), rtol=0, atol=0)
    tol = CASES[name][2]
    np.testing.assert_allclose(got.numpy(), ref[name]["plain"], rtol=tol, atol=tol)


def test_raises(runs):
    trees, tokens, _, port = runs
    for p in port:
        assert "T=30 is not divisible by the 4 processes" in p["errors"]["T % R"]
        # gemma3's window of 8 over 16 tokens: 4-token shards
        assert "window spans more than one neighbor shard" in p["errors"]["window"]
    cfg, model = _model("gemma3", trees)
    with pytest.raises(ValueError, match="not the model's config"):
        context_parallel_logits(model, _cfg("mamba2"), torch.from_numpy(tokens["gemma3"]))
    with pytest.raises(ValueError, match="mesh-axis name"):
        context_parallel_logits(model, cfg, torch.from_numpy(tokens["gemma3"]), axis=("a", "b"))


def test_example_twin_on_four_processes(runs):
    *_, port = runs
    for p in port:
        assert p["example"]["world"] == R
        assert set(p["example"]["errors"]) == {"gemma3-smoke", "mamba2-smoke", "jamba-smoke"}
        assert max(p["example"]["errors"].values()) < 1e-5
