"""Serving under sharding rules in the port (``Engine(cfg, model, mesh=)``:
sequence-parallel prefill, flash-decoding over a length-sharded KV cache,
tensor-parallel Mamba, attention and vocabulary, expert-parallel MoE)
against the JAX package's unsharded serving and the port's one process.

The port's parameters of each SMOKE config (``init_params``, seed 0) go to
the reference as its tree.  The reference runs, in child processes
(two, side by side, each a share of the configs) beside 4 gloo
processes (``tests/_dist.py::spawn``), per case: its
``Engine.generate`` (greedy ids), prefill and every decode step teacher-
forced on those ids (logits, and the caches after prefill), and its
``cache_shardings`` under ``default_rules`` on a 4-device mesh of the
case's shape (the shard shape of every cache leaf).  Its XLA compiles at
optimization level 0.  Each case runs on its mesh (``default_rules``,
``seq_parallel`` at prefill) and in one process:

* the greedy ids equal the reference's, on every process its rows; where
  every process holds the whole batch the ids sampled with the caller's generator equal one
  process's;
* the logits of prefill and of every decode step, gathered whole, within
  2e-5 (rtol = atol, the one-process tests' tolerance) of the
  reference's; under ``kv_quant`` within 1e-3 of its largest logit, as
  ``test_torch_kv_quant.py`` holds the one process;
* every cache leaf's local shape equals the reference's shard shape, and
  the caches gathered whole after prefill equal the reference's (the
  window layers' rings slot for slot; int8 within one unit).

The cases: gemma3 (window 8) with a 12-token prompt (longer than the
window; 6 tokens a process under sequence parallelism) on ``(2, 2)`` and
``(1, 4)``, with a 5-token one (shorter; T does not divide, so ``seq``
stays unsplit), with batch 1 on ``(2, 2)`` (``cache_seq`` over ``(data,
model)``), with a ``cache_len`` of 23 (the global layers' caches not split)
and of 22 at batch 1 (``cache_seq`` over ``data`` alone); mamba2 on ``(2,
2)``, ``(1, 4)`` and at batch 1; jamba (Mamba, attention and MoE layers)
and granite with ``kv_quant`` on ``(2, 2)`` and ``(1, 4)``.  Besides, the
raises that stay (train mode with ``seq_axis`` or with ``seq`` mapped
under rules) and what ``check_sharded`` refuses, before any collective.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _dist import spawn  # noqa: E402
from _mp import run  # noqa: E402
from _torch_lm import SAVE_PARAMS, unflatten  # noqa: E402
import _torch_serve as child  # noqa: E402
from _torch_train import leaves  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.distributed.sharding import AbstractMesh, axis_rules, default_rules  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
TOL, QUANT_TOL, NEW = 2e-5, 1e-3, 5
# config key: (module, kv_quant)
CONFIGS = {"gemma3": ("gemma3_4b", False), "mamba2": ("mamba2_1p3b", False),
           "jamba": ("jamba_v01_52b", False), "granite_q": ("granite_moe_3b", True)}
# case: (config key, mesh, batch, prompt length, cache_len)
CASES = {"gemma3-2x2": ("gemma3", (2, 2), 4, 12, 24), "gemma3-1x4": ("gemma3", (1, 4), 4, 12, 24),
         "gemma3-short-2x2": ("gemma3", (2, 2), 4, 5, 24),
         "gemma3-b1-2x2": ("gemma3", (2, 2), 1, 12, 24),
         "gemma3-len23-2x2": ("gemma3", (2, 2), 4, 12, 23),
         "gemma3-b1-len22-2x2": ("gemma3", (2, 2), 1, 12, 22),
         "mamba2-2x2": ("mamba2", (2, 2), 4, 12, 24), "mamba2-1x4": ("mamba2", (1, 4), 4, 12, 24),
         "mamba2-b1-2x2": ("mamba2", (2, 2), 1, 12, 24),
         "jamba-2x2": ("jamba", (2, 2), 4, 12, 24), "jamba-1x4": ("jamba", (1, 4), 4, 12, 24),
         "granite_q-2x2": ("granite_q", (2, 2), 4, 12, 24),
         "granite_q-1x4": ("granite_q", (1, 4), 4, 12, 24)}
# the reference's cases in two child processes side by side, by config
REFERENCE_SPLIT = (("gemma3",), ("mamba2", "jamba", "granite_q"))

REFERENCE = """
os.environ["XLA_FLAGS"] += (" --xla_backend_optimization_level=0"
                            " --xla_llvm_disable_expensive_passes=true")
import jax.extend.core
jax.core.Primitive = jax.extend.core.Primitive
import dataclasses, importlib, sys
sys.path.insert(0, {tests!r})
from _torch_lm import unflatten
from repro.distributed.sharding import default_rules
from repro.models import transformer as tf
from repro.serve import Engine
""" + SAVE_PARAMS + """
TMP = {tmp!r}
for case, key, mod, kv_quant, mesh, cache_len, new in {cases!r}:
    cfg = importlib.import_module("repro.configs." + mod).SMOKE
    cfg = dataclasses.replace(cfg, dtype="float32", kv_quant=kv_quant)
    params = jax.tree.map(jnp.asarray, unflatten(np.load(TMP + "/" + key + "_ref.npz")))
    prompt = jnp.asarray(np.load(TMP + "/" + case + "_prompt.npy"), jnp.int32)
    B, T = prompt.shape
    engine = Engine(cfg, params, cache_len=cache_len)
    ids = np.asarray(engine.generate(prompt, new))
    np.save(TMP + "/" + case + "_ids.npy", ids)
    # the engine's own prefill and decode step (compiled once), teacher-forced on its ids
    logits, caches = engine._prefill(params, prompt, None)
    save_params(caches, TMP + "/" + case + "_caches.npz")
    steps = [np.asarray(logits)]
    for i in range(new - 1):
        logits, caches = engine._decode(params, jnp.asarray(ids[:, i:i + 1]),
                                        jnp.asarray(T + i, jnp.int32), caches, None)
        steps.append(np.asarray(logits))
    np.save(TMP + "/" + case + "_logits.npy", np.stack(steps))
    rules = default_rules(jax.make_mesh(mesh, ("data", "model")), batch_size=B)
    shards = tf.cache_shardings(cfg, rules, B, cache_len, jnp.float32)
    specs = tf.cache_specs(cfg, B, cache_len, jnp.float32)
    shapes = jax.tree.map(lambda sh, sp: np.asarray(sh.shard_shape(sp.shape)), shards, specs)
    save_params(shapes, TMP + "/" + case + "_shard_shapes.npz")
print("OK")
"""


def _cfg(key):
    return child.case_cfg(*CONFIGS[key])


def port_rank(rank, world, tmp):
    out = {}
    for case, (key, mesh, _, _, cache_len) in CASES.items():
        module, kv_quant = CONFIGS[key]
        out[case] = child.serve_case(rank, world, module, mesh,
                                     np.load(f"{tmp}/{case}_prompt.npy"), NEW, cache_len,
                                     kv_quant, f"{tmp}/{key}_port.npz")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's child on a thread while the port's processes run."""
    import threading

    tmp = tmp_path_factory.mktemp("torch_sharded_serve")
    rng = np.random.RandomState(11)
    for key in CONFIGS:
        cfg = _cfg(key)
        params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        np.savez(tmp / f"{key}_port.npz", **{k: v.numpy() for k, v in params.items()})
        np.savez(tmp / f"{key}_ref.npz", **leaves(convert.tree_to_reference(cfg, params)))
    for case, (key, _, batch, prompt, _) in CASES.items():
        np.save(tmp / f"{case}_prompt.npy", rng.randint(0, _cfg(key).vocab, (batch, prompt)))
    failed = []

    def reference(keys):
        cases = [(case, key, *CONFIGS[key], mesh, cache_len, NEW)
                 for case, (key, mesh, _, _, cache_len) in CASES.items() if key in keys]
        try:
            run(REFERENCE.format(tests=TESTS, tmp=str(tmp), cases=cases), ndev=4)
        except BaseException as e:   # re-raised in the test process below
            failed.append(e)

    refs = [threading.Thread(target=reference, args=(keys,)) for keys in REFERENCE_SPLIT]
    for ref in refs:
        ref.start()
    try:
        port = spawn(4, "test_torch_sharded_serve:port_rank", tmp, str(tmp), timeout=300,
                     group_timeout=120)
    finally:
        for ref in refs:
            ref.join()
    if failed:
        raise failed[0]
    return tmp, port


def _layer(cfg, i):
    """The reference's cache path of the port's layer ``i``: (stack, layer
    of its pattern, repeat)."""
    base = 0
    for si, (pattern, repeat) in enumerate(cfg.stacks):
        if i < base + repeat * len(pattern):
            return si, (i - base) % len(pattern), (i - base) // len(pattern)
        base += repeat * len(pattern)
    raise IndexError(i)


@pytest.mark.parametrize("case", CASES)
def test_greedy_ids_equal_the_references(runs, case):
    tmp, port = runs
    want = np.load(tmp / f"{case}_ids.npy")
    np.testing.assert_array_equal(port[0][case]["ids_all"], want, err_msg=case)
    np.testing.assert_array_equal(port[0][case]["one_ids"], want, err_msg=f"{case} one process")
    mesh, batch = CASES[case][1], CASES[case][2]
    rows = batch // mesh[0] if batch % mesh[0] == 0 else batch
    for r, p in enumerate(port):   # process r holds its rows: rank r sits at (r // tp, r % tp)
        i = r // mesh[1] if rows < batch else 0
        np.testing.assert_array_equal(p[case]["ids"], want[i * rows:(i + 1) * rows],
                                      err_msg=f"{case} rank {r}")


@pytest.mark.parametrize("case", [c for c, (_, mesh, batch, _, _) in CASES.items()
                                  if mesh[0] == 1 or batch % mesh[0]])
def test_sampling_draws_as_one_process(runs, case):
    """Where every process holds the whole batch (on (1, 4), or batch 1),
    temperature sampling with the caller's generator draws one process's
    ids: the logits gathered over the vocabulary, the same draw on every
    process."""
    _, port = runs
    for r, p in enumerate(port):
        np.testing.assert_array_equal(p[case]["sampled"], p[case]["one_sampled"],
                                      err_msg=f"{case} rank {r}")


@pytest.mark.parametrize("case", CASES)
def test_logits_of_every_step_match_the_reference(runs, case):
    """Prefill's and every decode step's logits (the real vocabulary's
    columns), gathered whole, against the reference's."""
    tmp, port = runs
    cfg = _cfg(CASES[case][0])
    want = np.load(tmp / f"{case}_logits.npy")[..., :cfg.vocab]
    got = np.stack(port[0][case]["logits"])[..., :cfg.vocab]
    one = np.stack(port[0][case]["one_logits"])[..., :cfg.vocab]
    assert got.shape == want.shape == (NEW, CASES[case][2], cfg.vocab), (got.shape, want.shape)
    if cfg.kv_quant:
        for what, a in (("sharded", got), ("one process", one)):
            err = np.abs(a - want).max() / np.abs(want).max()
            assert err <= QUANT_TOL, (case, what, err)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=case)
        np.testing.assert_allclose(one, want, rtol=TOL, atol=TOL, err_msg=f"{case} one process")


@pytest.mark.parametrize("case", CASES)
def test_cache_blocks_follow_the_references_shardings(runs, case):
    """Every cache leaf's local shape on every process is the shard shape
    of the reference's ``cache_shardings`` (its repeat axis left out)."""
    tmp, port = runs
    cfg = _cfg(CASES[case][0])
    want = unflatten(np.load(tmp / f"{case}_shard_shapes.npz"))
    for r, p in enumerate(port):
        local = p[case]["local"]
        assert len(local) == len(cfg.layers_flat)
        for i, leaves_i in enumerate(local):
            si, j, _ = _layer(cfg, i)
            ref = want[si][j]["mixer"]
            assert set(leaves_i) == set(ref), (case, i)
            for name, shape in leaves_i.items():
                assert shape == tuple(int(n) for n in ref[name][1:]), (case, r, i, name, shape,
                                                                       ref[name])


@pytest.mark.parametrize("case", CASES)
def test_caches_after_prefill_equal_the_references(runs, case):
    """The caches gathered whole after prefill against the reference's: the
    window layers' rings slot for slot, int8 values within one unit."""
    tmp, port = runs
    cfg = _cfg(CASES[case][0])
    want = unflatten(np.load(tmp / f"{case}_caches.npz"))
    for i, c in enumerate(port[0][case]["caches"]):
        si, j, rep = _layer(cfg, i)
        for name, got in c.items():
            ref = want[si][j]["mixer"][name][rep]
            assert got.shape == ref.shape, (case, i, name, got.shape, ref.shape)
            if got.dtype == np.int8:
                assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1, (case, i)
            else:
                np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL,
                                           err_msg=f"{case} layer {i} {name}")


def _rules(mesh=(2, 2), names=("data", "model"), **kw):
    return default_rules(AbstractMesh(mesh, names), **kw)


def test_train_mode_with_seq_axis_or_seq_rules_raises():
    """No reference path runs context parallelism under installed rules, and
    train mode under rules that map ``seq`` comes with ``launch/``."""
    cfg = _cfg("gemma3")
    model = Model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.zeros(4, 8, dtype=torch.long)
    with axis_rules(_rules(batch_size=4)), pytest.raises(NotImplementedError,
                                                         match="no reference path"):
        tf.fwd(model, tokens, mode="train", seq_axis="sp")
    with axis_rules(_rules(batch_size=4, seq_parallel=True)), \
            pytest.raises(NotImplementedError, match=r"map seq over \('model',\).*Queue A item 6"):
        tf.fwd(model, tokens, mode="train")


@pytest.mark.parametrize("what,mesh,names,batch,prompt,cache_len,match", [
    ("prompt-longer-than-cache", (2, 2), ("data", "model"), 4, 30, 24,
     r"a prompt of 30 tokens is longer than the caches' 24 slots: .*'model': 2"),
    ("rows-split-otherwise", (2, 2, 1), ("pod", "data", "model"), 2, 8, 16,
     r"a batch of 2 rows splits over the mesh axes \('pod',\), the rows of the cache leaf 'k' "
     r"\(2, 8, 2, 16\) over \(\) \(\{'pod': 2, 'data': 2, 'model': 1\}\)"),
])
def test_check_sharded_refuses(what, mesh, names, batch, prompt, cache_len, match):
    """Before any collective (no group here), naming the shapes and the mesh."""
    rules = default_rules(AbstractMesh(mesh, names), batch_size=batch)
    with pytest.raises(NotImplementedError, match=match):
        tf.check_sharded(_cfg("gemma3"), rules, batch=batch, prompt=prompt, cache_len=cache_len)
