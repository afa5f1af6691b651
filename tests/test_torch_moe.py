"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
``repro.models.moe.fwd`` on the same numpy inputs and weights, float32.

Cases: the SMOKE widths of granite-moe-3b (4 experts top-2, no shared
expert) and kimi-k2 (8 experts top-2, one shared expert); granite's width
at a ``capacity_factor`` of 0.5, which drops pairs; and router weights
whose columns come in equal pairs, so that every token's router logits tie
pairwise (the reference's ``jax.lax.top_k`` takes the lower expert first).
The reference runs once, in a module-scoped child process; beside its
output and aux loss it gives the expert ids of its ``top_k`` and the
dispatch's ``dest`` slots, computed by the reference's own ``dispatch_group``
steps.  Tolerances: outputs within rtol 1e-5 and atol 1e-5 (the outputs
are of order 1; the GEMMs' float32 sums over d and f run in another order
than XLA's, which leaves ~2e-6 where an output crosses 0), the aux loss
within 1e-6; expert ids, drop slots and capacities equal.
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
from repro_torch.configs.granite_moe_3b import SMOKE as GRANITE  # noqa: E402
from repro_torch.configs.kimi_k2 import SMOKE as KIMI  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.params import RefLeaf  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"

# name: (config module, capacity_factor or None, B, T, tied router columns)
CASES = {
    "granite": ("granite_moe_3b", None, 2, 12, False),
    "kimi_shared": ("kimi_k2", None, 2, 12, False),
    "granite_drops": ("granite_moe_3b", 0.5, 2, 40, False),
    "granite_ties": ("granite_moe_3b", None, 2, 12, True),
    "kimi_ties_drops": ("kimi_k2", 0.5, 3, 40, True),
}
SMOKES = {"granite_moe_3b": GRANITE, "kimi_k2": KIMI}
CAPACITY_T = (1, 2, 7, 12, 40, 1000, 2048)

REFERENCE = ALIAS + """
import dataclasses, importlib
from repro.models import moe

TMP = {tmp!r}
out = {{}}
for name, (mod, cf, B, T, _) in {cases!r}.items():
    cfg = importlib.import_module("repro.configs." + mod).SMOKE
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    d = np.load(TMP + "/" + name + ".npz")
    params = {{k: jnp.asarray(d[k]) for k in d.files if k != "x"}}
    x = jnp.asarray(d["x"])
    y, aux = moe.fwd(params, cfg, x)
    # the expert choice and the drop slots, by the reference's own steps
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    probs = jax.nn.softmax((x @ params["router"]).astype(jnp.float32), axis=-1)
    _, eid = jax.lax.top_k(probs, K)
    C = moe.capacity(T, cfg)
    dests = []
    for b in range(B):
        flat_eid = eid[b].reshape(-1)
        order = jnp.argsort(flat_eid, stable=True)
        sorted_eid = flat_eid[order]
        counts = jnp.zeros((E,), jnp.int32).at[flat_eid].add(1)
        starts = jnp.cumsum(counts) - counts
        pos = jnp.arange(T * K, dtype=jnp.int32) - starts[sorted_eid]
        dests.append(np.asarray(jnp.where(pos < C, sorted_eid * C + pos, E * C)))
    out[name + "/y"] = np.asarray(y)
    out[name + "/aux"] = np.asarray(aux)
    out[name + "/eid"] = np.asarray(eid)
    out[name + "/dest"] = np.stack(dests)
    out[name + "/C"] = np.asarray(C)
    out[name + "/caps"] = np.asarray([moe.capacity(t, cfg) for t in {caps!r}])
np.savez(TMP + "/ref.npz", **out)
print("OK")
"""


def _cfg(name):
    mod, cf, *_ = CASES[name]
    cfg = dataclasses.replace(SMOKES[mod], dtype="float32")
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg


def _inputs(name, seed):
    """x and the reference's MoE leaves, from numpy (std 0.2 so that the
    outputs are of order 1)."""
    mod, _, B, T, tied = CASES[name]
    cfg = _cfg(name)
    m, d = cfg.moe, cfg.d_model
    rng = np.random.RandomState(seed)
    leaves = {"x": rng.randn(B, T, d).astype(np.float32)}
    for key, spec in moe.specs(cfg).items():
        leaves[key] = (rng.randn(*spec.shape) * 0.2).astype(np.float32)
    if tied:  # expert 2i + 1 scores as expert 2i does: every token ties pairwise
        leaves["router"][:, 1::2] = leaves["router"][:, 0::2]
    return leaves


def _port(cfg, leaves):
    """The port's MoE module holding the reference's leaves (transformer's
    MOE_LEAVES layout)."""
    layer = moe.MoE(cfg)
    for key, arr in leaves.items():
        if key == "x":
            continue
        target, how = tf.MOE_LEAVES[key]
        value = RefLeaf((key,), None, arr.shape, how).from_ref(torch.from_numpy(arr))
        mod, _, leaf = target.rpartition(".")
        owner = layer.get_submodule(mod) if mod else layer
        setattr(owner, leaf, torch.nn.Parameter(value, requires_grad=False))
    return layer


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_moe")
    inputs = {}
    for seed, name in enumerate(CASES):
        inputs[name] = _inputs(name, seed)
        np.savez(tmp / f"{name}.npz", **inputs[name])
    run(REFERENCE.format(tmp=str(tmp), cases=CASES, caps=CAPACITY_T), ndev=1)
    ref = np.load(tmp / "ref.npz")
    return {name: {k.split("/")[1]: ref[k] for k in ref.files if k.startswith(name + "/")}
            for name in CASES}, inputs


@pytest.fixture(scope="module")
def port(reference):
    _, inputs = reference
    out = {}
    for name, leaves in inputs.items():
        cfg = _cfg(name)
        layer = _port(cfg, leaves)
        x = torch.from_numpy(leaves["x"])
        # the router's logits as fwd computes them, read by a forward hook;
        # from them route and dispatch give the expert ids and the slots
        logits = []
        hook = layer.router.register_forward_hook(lambda mod, args, y: logits.append(y))
        try:
            y, aux = moe.fwd(layer, cfg, x)
        finally:
            hook.remove()
        _, _, eid = moe.route(logits[0].float(), cfg.moe.top_k)
        dest, _, _ = moe.dispatch(eid, moe.capacity(x.shape[1], cfg), cfg.moe.n_experts)
        out[name] = {"y": y, "aux": aux, "dest": dest, "eid": eid}
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_output_and_aux_loss(reference, port, name):
    want, got = reference[0][name], port[name]
    assert got["y"].shape == want["y"].shape and got["y"].dtype == torch.float32
    np.testing.assert_allclose(got["y"].numpy(), want["y"], rtol=1e-5, atol=1e-5)
    assert abs(float(got["aux"]) - float(want["aux"])) <= 1e-6


@pytest.mark.parametrize("name", list(CASES))
def test_expert_choice_and_drop_slots_equal(reference, port, name):
    want, got = reference[0][name], port[name]
    cfg = _cfg(name)
    assert moe.capacity(CASES[name][3], cfg) == int(want["C"])
    assert np.array_equal(got["eid"].numpy(), want["eid"])
    assert np.array_equal(got["dest"].numpy(), want["dest"])
    E, C = cfg.moe.n_experts, int(want["C"])
    drops = int((want["dest"] == E * C).sum())
    if name.endswith("drops"):
        assert drops > 0, "the case was meant to drop pairs"
    else:
        assert drops == 0


def test_ties_take_the_lower_expert_first(reference, port):
    """Tied router columns: expert 2i and 2i + 1 have equal probabilities for
    every token, and the reference takes 2i first; so does the port, on every
    token (top-2 picks exactly one tied pair, in order)."""
    for name in ("granite_ties", "kimi_ties_drops"):
        eid = port[name]["eid"]
        assert torch.all(eid[..., 0] % 2 == 0) and torch.all(eid[..., 1] == eid[..., 0] + 1)
        assert np.array_equal(eid.numpy(), reference[0][name]["eid"])


@pytest.mark.parametrize("mod", list(SMOKES))
def test_capacity_rule(reference, mod):
    name = {"granite_moe_3b": "granite", "kimi_k2": "kimi_shared"}[mod]
    cfg = _cfg(name)
    assert [moe.capacity(t, cfg) for t in CAPACITY_T] == list(reference[0][name]["caps"])
    assert moe.capacity(1, cfg) == 8   # a decode step: C = 8


def test_no_moe_config_raises():
    cfg = dataclasses.replace(GRANITE, moe=None)
    with pytest.raises(ValueError, match="MoECfg"):
        moe.specs(cfg)
    with pytest.raises(ValueError, match="MoECfg"):
        moe.MoE(cfg)
