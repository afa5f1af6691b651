"""The port's Mamba-2 serving path (configs, params, the Mamba layer, the
model, ``Engine``, ``convert.params_from_reference``) against the JAX
package's ``models``/``serve`` at the ``SMOKE`` width of mamba2-1.3b, f32.

The reference materializes the parameters (``PRNGKey(1)``, as
``tests/test_models_smoke.py`` does) and runs the train forward, prefill,
decode and ``Engine.generate`` in a module-scoped child process; the
parameters reach the port through ``params_from_reference``.  Tolerances
(rtol = atol): train and prefill logits 2e-5, every decode step's logits
2e-5 (the reference's own test allows 2e-4 and 2e-3); caches 2e-5.  Greedy
ids are compared teacher-forced: at every step the port's logits, fed the
reference's ids, must pick the reference's next id, and
``Engine.generate`` must give the reference's ids.

The reference's causal conv reads later tokens when the prompt is shorter
than the conv's K-1 = 3 taps (``src/repro/distributed/seqpar.py:51-58``;
ROADMAP.md F9), so the short prompts are held against the reference's
train logits on the longer sequence (a causal model's first logits depend
on the first tokens only) and its pre-activation conv cache.
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
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as cb  # noqa: E402
from repro_torch.configs.mamba2_1p3b import CFG, SMOKE  # noqa: E402
from repro_torch.models import Model, ssm  # noqa: E402
from repro_torch.models import params as pm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"

B, T, TP, TG, NEW = 2, 12, 8, 20, 6
TOL = 2e-5
CFG32 = dataclasses.replace(SMOKE, dtype="float32", max_seq=24)

REFERENCE = ALIAS + SAVE_PARAMS + """
import dataclasses
from repro.configs.mamba2_1p3b import SMOKE
from repro.models import params as pm, transformer as tf
from repro.serve import Engine

TMP = {tmp!r}
cfg = dataclasses.replace(SMOKE, dtype="float32", max_seq=24)
params = pm.materialize(tf.param_specs(cfg), jax.random.PRNGKey(1), jnp.float32)
save_params(params, TMP + "/params.npz")

tokens = jnp.asarray(np.load(TMP + "/tokens.npy"), jnp.int32)
h, _, _ = tf.fwd(params, cfg, tokens, mode="train", remat="none")
np.save(TMP + "/train.npy", np.asarray(tf.logits_fn(params, cfg, h)))
logits, caches = tf.prefill(params, cfg, tokens[:, :{tp}], remat="none", cache_len=16)
np.save(TMP + "/prefill.npy", np.asarray(logits))
np.save(TMP + "/conv.npy", np.asarray(caches[0][0]["mixer"]["conv"]))
np.save(TMP + "/ssm.npy", np.asarray(caches[0][0]["mixer"]["ssm"]))
dec = []
for t in range({tp}, {t}):
    logits, caches = tf.decode_step(params, cfg, tokens[:, t:t + 1], jnp.asarray(t, jnp.int32),
                                    caches)
    dec.append(np.asarray(logits))
np.save(TMP + "/decode.npy", np.stack(dec))
_, c2 = tf.prefill(params, cfg, tokens[:, :2], remat="none")
np.save(TMP + "/conv_T2.npy", np.asarray(c2[0][0]["mixer"]["conv"]))

prompt = jnp.asarray(np.load(TMP + "/prompt.npy"), jnp.int32)
ids = np.asarray(Engine(cfg, params).generate(prompt, {new}))
np.save(TMP + "/ids.npy", ids)
gap = []   # the top-2 logit gap of each greedy step, teacher-forced on the reference's ids
logits, caches = tf.prefill(params, cfg, prompt)
for i in range({new}):
    top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
    gap.append(top2[:, 1] - top2[:, 0])
    logits, caches = tf.decode_step(params, cfg, jnp.asarray(ids[:, i:i + 1]),
                                    jnp.asarray({tg} + i, jnp.int32), caches)
np.save(TMP + "/gap.npy", np.stack(gap))
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_mamba2")
    rng = np.random.RandomState(1)
    np.save(tmp / "tokens.npy", rng.randint(0, SMOKE.vocab, (B, T)))
    np.save(tmp / "prompt.npy", rng.randint(0, SMOKE.vocab, (B, TG)))
    run(REFERENCE.format(tmp=str(tmp), tp=TP, t=T, tg=TG, new=NEW), ndev=1)
    tree = unflatten(np.load(tmp / "params.npz"))
    model = Model(CFG32, convert.params_from_reference(CFG32, tree), device="cpu")
    return tmp, tree, model


def _np(tmp, name):
    return np.load(tmp / f"{name}.npy")


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol, err_msg=what)


def test_train_and_prefill_logits(reference):
    tmp, _, model = reference
    tokens = torch.from_numpy(_np(tmp, "tokens"))
    h, caches, _ = tf.fwd(model, tokens, mode="train")
    assert caches is None
    full = tf.logits_fn(model, h)
    assert full.shape == (B, T, CFG32.padded_vocab) and full.dtype == torch.float32
    _close(full, _np(tmp, "train"), "train logits")
    assert torch.equal(model(tokens)[0], h)   # the module's forward is fwd
    logits, caches = tf.prefill(model, tokens[:, :TP])
    _close(logits, _np(tmp, "prefill"), "prefill logits")
    assert len(caches) == CFG32.n_layers
    _close(caches[0]["mixer"]["conv"], _np(tmp, "conv")[0], "conv cache")
    _close(caches[0]["mixer"]["ssm"], _np(tmp, "ssm")[0], "ssm cache")


def test_every_decode_step(reference):
    tmp, _, model = reference
    tokens = torch.from_numpy(_np(tmp, "tokens"))
    dec, full = _np(tmp, "decode"), _np(tmp, "train")
    _, caches = tf.prefill(model, tokens[:, :TP])
    for i, t in enumerate(range(TP, T)):
        logits, caches = tf.decode_step(model, tokens[:, t:t + 1], t, caches)
        _close(logits, dec[i], f"decode step {t}")
        _close(logits, full[:, t], f"decode step {t} vs train")


def test_prefill_then_decode_equals_longer_prefill(reference):
    _, _, model = reference
    tokens = torch.from_numpy(np.random.RandomState(5).randint(0, SMOKE.vocab, (B, 11)))
    for use_kernel in ("ref", "naive", "auto"):
        want, _ = tf.prefill(model, tokens, use_kernel=use_kernel)
        _, caches = tf.prefill(model, tokens[:, :10], use_kernel=use_kernel)
        got, _ = tf.decode_step(model, tokens[:, 10:], 10, caches)
        _close(got, want.numpy(), f"prefill(11) vs prefill(10) + decode, {use_kernel}")


@pytest.mark.parametrize("tq", [1, 2, 3])
def test_conv_cache_of_a_short_prompt(reference, tq):
    """Prompts of T <= K-1 tokens: the conv cache holds their pre-activation
    stream, zero-padded in front, and decoding on from it reproduces the
    reference's train logits of the longer sequence at every position."""
    tmp, _, model = reference
    tokens = torch.from_numpy(_np(tmp, "tokens"))
    full = _np(tmp, "train")
    logits, caches = tf.prefill(model, tokens[:, :tq])
    _close(logits, full[:, tq - 1], f"prefill({tq})")
    K = CFG32.ssm.conv_kernel
    for layer, c in enumerate(caches):
        conv = c["mixer"]["conv"]
        assert conv.shape == (B, K - 1, ssm._dims(CFG32)[2])
        assert torch.equal(conv[:, :K - 1 - tq], torch.zeros_like(conv[:, :K - 1 - tq]))
    if tq == 2:
        _close(caches[0]["mixer"]["conv"], _np(tmp, "conv_T2")[0], "conv cache at T=2")
    for t in range(tq, T):
        logits, caches = tf.decode_step(model, tokens[:, t:t + 1], t, caches)
        _close(logits, full[:, t], f"decode {t} after prefill({tq})")


def test_generate_greedy_ids(reference):
    tmp, _, model = reference
    prompt = torch.from_numpy(_np(tmp, "prompt"))
    ids, gap = torch.from_numpy(_np(tmp, "ids")), _np(tmp, "gap")
    # teacher-forced: fed the reference's ids, the port picks the reference's next id
    logits, caches = tf.prefill(model, prompt)
    for i in range(NEW):
        got = logits.argmax(-1)
        tie = gap[i] < 10 * TOL
        assert torch.equal(got[~torch.from_numpy(tie)], ids[:, i][~torch.from_numpy(tie)]), i
        logits, caches = tf.decode_step(model, ids[:, i:i + 1], TG + i, caches)
    assert gap.min() > 10 * TOL   # no near-tie: the whole sequences must agree
    eng = Engine(CFG32, model, device="cpu")
    out = eng.generate(prompt, NEW)
    assert out.shape == (B, NEW) and out.device.type == "cpu"
    assert torch.equal(out, ids)
    assert torch.equal(Engine(CFG32, model, device="cpu", use_kernel="ref").generate(prompt, NEW),
                       ids)


def test_generate_sampling_uses_the_generator(reference, tmp_path):
    _, _, model = reference
    eng = Engine(CFG32, model, device="cpu")
    prompt = torch.zeros(B, 4, dtype=torch.long)
    a = eng.generate(prompt, 5, temperature=0.8, generator=torch.Generator().manual_seed(3))
    b = eng.generate(prompt, 5, temperature=0.8, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.shape == (B, 5) and int(a.max()) < SMOKE.vocab
    with pytest.raises(ValueError, match="Generator"):
        eng.generate(prompt, 2, temperature=0.8)
    with pytest.raises(NotImplementedError, match="cross_inputs"):
        eng.generate(prompt, 2, cross_inputs={})
    # a flight recorder around generate changes no id
    flight = Engine(CFG32, model, device="cpu", flight_dir=str(tmp_path))
    c = flight.generate(prompt, 5, temperature=0.8, generator=torch.Generator().manual_seed(3))
    assert torch.equal(c, a) and flight.recorder is not None
    with pytest.raises(ValueError, match="lives on"):
        Engine(CFG32, model, device="meta")


def test_param_count_from_specs():
    assert CFG.param_count() == 1_344_576_512
    assert cb.get("mamba2-1.3b") is CFG and cb.names() == [
        "gemma-2b", "gemma3-4b", "granite-moe-3b-a800m", "jamba-v0.1-52b", "kimi-k2-1t-a32b",
        "llama3.2-1b", "mamba2-1.3b", "starcoder2-15b"]
    shapes = tf.parameter_shapes(CFG)   # the module skeleton, on the meta device
    assert sum(int(np.prod(s)) for s in shapes.values()) == CFG.param_count()
    assert len(shapes) == 2 + 48 * 9 and CFG.padded_vocab == 50688
    assert cb.get("jamba-v0.1-52b").name == "jamba-v0.1-52b"
    with pytest.raises(KeyError, match="later slice"):
        cb.get("llama-3.2-vision-90b")
    with pytest.raises(KeyError, match="unknown"):
        cb.get("no-such-model")


def test_leftover_or_missing_leaf_raises(reference):
    _, tree, _ = reference
    extra = dict(tree, bias=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="left over"):
        convert.params_from_reference(CFG32, extra)
    layer = dict(tree["stacks"][0]["layers"][0])
    layer["mixer"] = {k: v for k, v in layer["mixer"].items() if k != "D"}
    missing = dict(tree, stacks=[{"layers": [layer]}])
    with pytest.raises(ValueError, match="without a value"):
        convert.params_from_reference(CFG32, missing)
    layer["mixer"] = dict(tree["stacks"][0]["layers"][0]["mixer"], gate=np.zeros((2, 3)))
    with pytest.raises(ValueError, match="left over"):
        convert.params_from_reference(CFG32, dict(tree, stacks=[{"layers": [layer]}]))
    state = convert.params_from_reference(CFG32, tree)
    w = tree["stacks"][0]["layers"][0]["mixer"]["in_proj"][1]
    assert torch.equal(state["layers.1.mixer.in_proj.weight"], torch.from_numpy(w.T.copy()))
    with pytest.raises(ValueError, match="shape"):
        Model(CFG32, dict(state, final_norm=torch.zeros(3)), device="cpu")


def test_materialize_init_laws_and_generator():
    g = torch.Generator().manual_seed(0)
    specs = tf.param_specs(CFG32)
    tree = pm.materialize(specs, g, torch.float32, "cpu")
    mix = tree["stacks"][0]["layers"][0]["mixer"]
    assert torch.equal(mix["D"], torch.ones_like(mix["D"]))
    assert torch.equal(mix["A_log"], torch.zeros_like(mix["A_log"]))
    assert abs(float(mix["in_proj"].std()) - 0.02) < 2e-3
    assert pm.n_params(specs) == sum(t.numel() for t in pm.specs_list(tree))
    a = Model(CFG32, generator=torch.Generator().manual_seed(4), device="cpu")
    b = Model(CFG32, generator=torch.Generator().manual_seed(4), device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert not any(p.requires_grad for p in a.parameters())
    with pytest.raises(ValueError, match="Generator"):
        Model(CFG32, device="cpu")


def test_layers_the_port_lacks_raise():
    """Cross-attention raises; Mamba layers carry a dense FFN, or an MoE FFN
    once the config has a MoECfg (mamba2's SMOKE has none: ValueError)."""
    from repro_torch.configs.base import Layer, MoECfg
    cfg = dataclasses.replace(CFG32, stacks=(((Layer(mixer="attn", cross=True),), 1),))
    with pytest.raises(NotImplementedError, match="Queue A"):
        tf.param_specs(cfg)
    dense = dataclasses.replace(CFG32, stacks=(((Layer(mixer="mamba", ffn=True),), 1),),
                                d_ff=32)   # mamba2's SMOKE has d_ff 0
    assert set(tf.param_specs(dense)["stacks"][0]["layers"][0]) == {"ln1", "mixer", "ln2", "ffn"}
    moe = dataclasses.replace(CFG32, stacks=(((Layer(mixer="mamba", ffn=False, moe=True),), 1),))
    with pytest.raises(ValueError, match="MoECfg"):
        tf.param_specs(moe)
    moe = dataclasses.replace(moe, moe=MoECfg(n_experts=4, top_k=2, d_ff=16))
    tokens = torch.zeros(1, 5, dtype=torch.long)
    for c in (dense, moe):
        m = Model(c, generator=torch.Generator().manual_seed(0), device="cpu")
        assert torch.isfinite(tf.prefill(m, tokens)[0]).all()
