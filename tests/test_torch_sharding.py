"""The port's sharding rules (``repro_torch.distributed.sharding``) and the
layout they give the parameters and the optimizer state, against the JAX
package's ``distributed/sharding.py``.

The reference runs once, in a child process with 8 host devices:

* ``AxisRules.spec`` of ``default_rules`` on the meshes ``(2, 4)``,
  ``(4, 2)``, ``(8, 1)``, ``(1, 8)`` of ``(data, model)`` and ``(2, 2, 2)``
  of ``(pod, data, model)``, with ``batch_size`` below and above the data
  size and ``seq_parallel`` off and on, over every logical tuple of every
  registered config's parameter specs (stacked and not) and of the
  activations, at the configs' shapes and at shapes that make ``fit`` drop
  an axis: the port's spec must be ``tuple(reference spec)``;
* ``NamedSharding.shard_shape`` of llama SMOKE's parameters and of its
  int8 AdamW state (``optim.state_shardings``) on the meshes ``(2, 2)``,
  ``(4, 1)`` and ``(1, 4)``: the port's blocks (``params.local``, and the
  tensors of 4 gloo processes: ``shard``, ``optim.init`` under the rules)
  must have those shapes, the repeat axis left out.

``shard`` then ``gather`` round-trips bitwise on 4 processes, and ``shd``
raises on a wrong local shape.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _dist import spawn  # noqa: E402
from _mp import run  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import base as cb  # noqa: E402
from repro_torch.configs import llama3_2_1b  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.sharding import AbstractMesh, AxisRules, default_rules  # noqa: E402
from repro_torch.models import params as pm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"
MESHES = {"2x4": ((2, 4), ("data", "model")), "4x2": ((4, 2), ("data", "model")),
          "8x1": ((8, 1), ("data", "model")), "1x8": ((1, 8), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
RULES = {"small_batch": dict(batch_size=1), "large_batch": dict(batch_size=64),
         "no_batch": dict(), "seq_parallel": dict(batch_size=16, seq_parallel=True)}
SMALL_MESHES = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
SMOKE = dataclasses.replace(llama3_2_1b.SMOKE, dtype="float32")
ACTIVATIONS = (("batch", None), ("batch", None, "vocab"), ("batch", "seq", None),
               ("batch", None, "heads", None), ("cache_batch", "cache_seq", "kv_heads", None),
               ("cache_batch", "state_heads", None, None), ("embed", "fsdp"))


def _cases() -> list:
    """(logical axes, shape) of every leaf of every registered config (one
    repeat and stacked), of the activations, and the same with each dim
    set to 6 and to 3 (so that fit drops axes)."""
    out = set()
    for name in cb.names():
        for spec in pm.specs_list(tf.param_specs(cb.get(name))):
            out.add((spec.axes, spec.shape))
            out.add((spec.axes[1:], spec.shape[1:]))
    for axes in ACTIVATIONS:
        out.add((axes, (8, 4096, 128, 64)[:len(axes)]))
    for axes, shape in list(out):
        for k in (6, 3):
            out.add((axes, (k,) * len(shape)))
    return sorted(out, key=repr)


CASES = _cases()

REFERENCE = ALIAS + """
import dataclasses, importlib, json
from jax.sharding import Mesh
from repro import optim
from repro.distributed.sharding import default_rules
from repro.models import params as pm, transformer as tf

out = dict(spec=dict(), shapes=dict())
for mname, (shape, names) in {meshes!r}.items():
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)
    for rname, kw in {rules!r}.items():
        rules = default_rules(mesh, **kw)
        out["spec"][mname + "/" + rname] = [
            [list(e) if isinstance(e, tuple) else e for e in rules.spec(*axes, shape=shp)]
            for axes, shp in {cases!r}]
cfg = dataclasses.replace(importlib.import_module("repro.configs.llama3_2_1b").SMOKE,
                          dtype="float32")
specs = tf.param_specs(cfg)
flat = lambda tree: jax.tree_util.tree_flatten_with_path(tree)[0]
key = lambda path: "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
params = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), specs,
                      is_leaf=lambda x: isinstance(x, pm.ParamSpec))
state = optim.state_specs(specs, optim.AdamWCfg(moments="int8"))
for mname, shape in {small!r}.items():
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), ("data", "model"))
    rules = default_rules(mesh, batch_size=8)
    got = dict()
    for path, sh in flat(pm.shardings(specs, rules)):
        got["params/" + key(path)] = list(sh.shard_shape(
            dict(flat(params))[path].shape))
    st_sh = optim.state_shardings(specs, optim.AdamWCfg(moments="int8"), rules)
    st = dict(flat(state))
    for path, sh in flat(st_sh):
        if key(path) == "step":
            continue
        got["opt/" + key(path)] = list(sh.shard_shape(st[path].shape))
    out["shapes"][mname] = got
with open({path!r}, "w") as f:
    json.dump(out, f)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_sharding") / "ref.json")
    cases = [(list(a), list(s)) for a, s in CASES]
    run(REFERENCE.format(meshes=MESHES, rules=RULES, cases=cases, small=SMALL_MESHES,
                         path=path), ndev=8)
    with open(path) as f:
        return json.load(f)


def _json(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.mark.parametrize("rname", list(RULES))
@pytest.mark.parametrize("mname", list(MESHES))
def test_spec_matches_the_reference(reference, mname, rname):
    shape, names = MESHES[mname]
    rules = default_rules(AbstractMesh(shape, names), **RULES[rname])
    want = reference["spec"][f"{mname}/{rname}"]
    got = [_json(rules.spec(*axes, shape=shp)) for axes, shp in CASES]
    bad = [(c, g, w) for c, g, w in zip(CASES, got, want) if g != w]
    assert not bad, bad[:5]
    assert len(got) == len(CASES) > 100


def _one(leaf, shape: list) -> list:
    """A reference shard shape without the leaf's repeat axis."""
    return shape[1:] if leaf.r is not None else shape


@pytest.mark.parametrize("mname", list(SMALL_MESHES))
def test_local_shapes_match_the_reference_shard_shape(reference, mname):
    """Every leaf's block (one repeat of the reference leaf) and every int8
    moment's ``q``/``s`` block, from the rules alone."""
    want = reference["shapes"][mname]
    rules = default_rules(AbstractMesh(SMALL_MESHES[mname], ("data", "model")), batch_size=8)
    layout = tf.reference_layout(SMOKE)
    specs = optim.state_shardings(layout, optim.AdamWCfg(moments="int8"), rules)
    seen = set()
    for name, leaf in layout.items():
        path = "/".join(str(p) for p in leaf.path)
        assert list(pm.local(leaf, rules).shape) == _one(leaf, want[f"params/{path}"]), name
        (qs, _), (ss, _) = optim.quant.quant_specs(leaf.shape, pm.logical_axes(leaf))
        for moment in ("m", "v"):
            for part, shp in (("q", qs), ("s", ss)):
                got = sharding.local_shape(rules.mesh, specs[moment][name][part], shp)
                assert list(got) == _one(leaf, want[f"opt/{moment}/{path}/{part}"]), \
                    (name, moment, part)
        seen.add(path)
    assert len(seen) == len({k[len("params/"):] for k in want if k.startswith("params/")})


def _blocks(rank, world, shape):
    """One process of a mesh: its parameter blocks and int8 state blocks
    (shapes), and whether shard -> gather gives the parameters back
    bitwise."""
    from repro_torch.distributed.sharding import axis_rules
    from repro_torch.launch.mesh import Mesh

    rules = default_rules(Mesh(shape, ("data", "model")), batch_size=8)
    layout = tf.reference_layout(SMOKE)
    params = tf.init_params(SMOKE, torch.Generator().manual_seed(0), device="cpu")
    local = pm.shard(params, rules, layout)
    with axis_rules(rules):
        opt = optim.init(local, optim.AdamWCfg(moments="int8"), layout=layout)
    back = pm.gather(local, rules, layout)
    return {"params": {n: list(pm.local(layout[n], rules).to_ref(t).shape)
                       for n, t in local.items()},
            "opt": {n: [list(v["q"].shape), list(v["s"].shape)] for n, v in opt["m"].items()},
            "bitwise": all(torch.equal(back[n], params[n]) for n in params)}


def test_process_blocks_and_round_trip(reference, tmp_path):
    """On 4 gloo processes, per mesh: the tensors each process holds have
    the reference's shard shapes, and ``gather(shard(p)) == p`` bitwise."""
    layout = tf.reference_layout(SMOKE)
    for mname, shape in SMALL_MESHES.items():
        want = reference["shapes"][mname]
        for r, got in enumerate(spawn(4, "test_torch_sharding:_blocks", tmp_path, shape,
                                      timeout=120)):
            assert got["bitwise"], (mname, r)
            for name, leaf in layout.items():
                path = "/".join(str(p) for p in leaf.path)
                assert got["params"][name] == _one(leaf, want[f"params/{path}"]), (mname, r, name)
                assert got["opt"][name] == [_one(leaf, want[f"opt/m/{path}/q"]),
                                            _one(leaf, want[f"opt/m/{path}/s"])], (mname, r, name)


def test_a_mesh_must_be_the_group():
    """Without a group (one process) the production and test meshes raise;
    a mesh of one process holds it."""
    from repro_torch.launch import mesh

    for make in (mesh.make_production_mesh, mesh.make_test_mesh):
        for multi_pod in (False, True):
            with pytest.raises(ValueError, match="group has 1"):
                make(multi_pod=multi_pod)
    one = mesh.Mesh((1, 1), ("data", "model"))
    assert one.coords == {"data": 0, "model": 0} and one.group(("model", "data")).size == 1


def test_shd_checks_the_local_shape():
    rules = AxisRules(AbstractMesh((2, 4), ("data", "model")),
                      default_rules(AbstractMesh((2, 4), ("data", "model"))).rules)
    x = torch.zeros(4, 16, 32)
    assert sharding.shd(x, "batch", None, "vocab") is x   # no rules installed
    with sharding.axis_rules(rules):
        assert sharding.shd(x, "batch", None, "vocab", shape=(8, 16, 128)) is x
        assert sharding.shd(x, "batch", None, "vocab") is x
        with pytest.raises(ValueError, match="global shape"):
            sharding.shd(x, "batch", None, "vocab", shape=(8, 16, 32))
        with pytest.raises(ValueError, match="rank"):
            sharding.shd(x, "batch", None)
        # fit keeps no axis of a dimension it cannot split: the local shape is the global one
        assert sharding.shd(torch.zeros(3, 16), "batch", None, shape=(3, 16)).shape == (3, 16)
