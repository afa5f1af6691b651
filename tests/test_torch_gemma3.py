"""The port's gemma3 serving path (global and sliding-window attention with
``qk_norm``, the GeGLU FFN, ``gemma_norm``, ``embed_scale``; the model,
``Engine``, ``convert.params_from_reference``) against the JAX package's
``models``/``serve`` at the ``SMOKE`` width of gemma3-4b, f32.

The reference materializes the parameters (``PRNGKey(1)``) and runs the
train forward, prefill at prompts of 5 (< window 8), 8 (= window) and 12
tokens with ``cache_len=24``, every decode step up to T = 20 from each,
and ``Engine.generate``, in a module-scoped child process; the parameters
reach the port through ``params_from_reference``.  On the CPU the port's
prefill attention is K6's plain version ``swa_ref`` (window = T for the
global layers), which computes the reference's banded ``_attend``.
Tolerances (rtol = atol): logits and caches 2e-5.  Greedy ids are
compared teacher-forced and then through ``Engine.generate``.
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
from repro_torch.configs.base import Layer  # noqa: E402
from repro_torch.configs.gemma3_4b import CFG, SMOKE, WINDOW  # noqa: E402
from repro_torch.models import Model, attention, layers  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"

B, T, TG, NEW, CACHE = 2, 20, 16, 6, 24
PROMPTS = (5, 8, 12)
TOL = 2e-5
CFG32 = dataclasses.replace(SMOKE, dtype="float32", max_seq=CACHE)

REFERENCE = ALIAS + SAVE_PARAMS + """
import dataclasses
from repro.configs.gemma3_4b import SMOKE
from repro.models import layers, params as pm, transformer as tf
from repro.serve import Engine

TMP = {tmp!r}
cfg = dataclasses.replace(SMOKE, dtype="float32", max_seq={cache})
params = pm.materialize(tf.param_specs(cfg), jax.random.PRNGKey(1), jnp.float32)
save_params(params, TMP + "/params.npz")

tokens = jnp.asarray(np.load(TMP + "/tokens.npy"), jnp.int32)
h, _, _ = tf.fwd(params, cfg, tokens, mode="train", remat="none")
np.save(TMP + "/train.npy", np.asarray(tf.logits_fn(params, cfg, h)))
for tp in {prompts}:
    logits, caches = tf.prefill(params, cfg, tokens[:, :tp], remat="none", cache_len={cache})
    np.save(TMP + f"/prefill{{tp}}.npy", np.asarray(logits))
    for j in range(3):
        for kv in ("k", "v"):
            np.save(TMP + f"/cache{{tp}}_{{j}}{{kv}}.npy", np.asarray(caches[0][j]["mixer"][kv]))
    dec = []
    for t in range(tp, {t}):
        logits, caches = tf.decode_step(params, cfg, tokens[:, t:t + 1],
                                        jnp.asarray(t, jnp.int32), caches)
        dec.append(np.asarray(logits))
    np.save(TMP + f"/decode{{tp}}.npy", np.stack(dec))

prompt = jnp.asarray(np.load(TMP + "/prompt.npy"), jnp.int32)
ids = np.asarray(Engine(cfg, params).generate(prompt, {new}))
np.save(TMP + "/ids.npy", ids)
gap = []   # the top-2 logit gap of each greedy step, teacher-forced on the reference's ids
logits, caches = tf.prefill(params, cfg, prompt, cache_len={cache})
for i in range({new}):
    top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
    gap.append(top2[:, 1] - top2[:, 0])
    logits, caches = tf.decode_step(params, cfg, jnp.asarray(ids[:, i:i + 1]),
                                    jnp.asarray({tg} + i, jnp.int32), caches)
np.save(TMP + "/gap.npy", np.stack(gap))

x2 = jnp.asarray(np.load(TMP + "/x2.npy"))
np.save(TMP + "/geglu.npy", np.asarray(layers.glu(x2, "geglu")))
np.save(TMP + "/swiglu.npy", np.asarray(layers.glu(x2, "swiglu")))
np.save(TMP + "/gelu.npy", np.asarray(layers.act_fn("gelu")(x2)))
xr = jnp.asarray(np.load(TMP + "/xr.npy"))
np.save(TMP + "/rope.npy", np.asarray(layers.rope(xr, jnp.arange(3, 3 + xr.shape[1]), 1e6)))
np.save(TMP + "/rope_bf16.npy", np.asarray(
    layers.rope(xr.astype(jnp.bfloat16), jnp.arange(xr.shape[1]), 1e4).astype(jnp.float32)))
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_gemma3")
    rng = np.random.RandomState(1)
    np.save(tmp / "tokens.npy", rng.randint(0, SMOKE.vocab, (B, T)))
    np.save(tmp / "prompt.npy", rng.randint(0, SMOKE.vocab, (B, TG)))
    np.save(tmp / "x2.npy", rng.randn(3, 5, 2, 7).astype(np.float32) * 2)
    np.save(tmp / "xr.npy", rng.randn(2, 6, 3, 16).astype(np.float32))
    run(REFERENCE.format(tmp=str(tmp), t=T, tg=TG, new=NEW, cache=CACHE, prompts=PROMPTS),
        ndev=1)
    tree = unflatten(np.load(tmp / "params.npz"))
    model = Model(CFG32, convert.params_from_reference(CFG32, tree), device="cpu")
    return tmp, tree, model


def _np(tmp, name):
    return np.load(tmp / f"{name}.npy")


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol, err_msg=what)


def test_train_logits(reference):
    tmp, _, model = reference
    tokens = torch.from_numpy(_np(tmp, "tokens"))
    h, caches, _ = tf.fwd(model, tokens, mode="train")
    assert caches is None
    full = tf.logits_fn(model, h)
    assert full.shape == (B, T, CFG32.padded_vocab) and full.dtype == torch.float32
    _close(full, _np(tmp, "train"), "train logits")
    assert torch.equal(model(tokens)[0], h)   # the module's forward is fwd


@pytest.mark.parametrize("tp", PROMPTS)
def test_prefill_logits_and_ring_caches(reference, tp):
    """Prompts shorter than, equal to and longer than the window: the window
    layers' caches are the zero-padded prompt or its last 8 tokens rolled
    into ring order, the global layers' the prompt padded to cache_len."""
    tmp, _, model = reference
    tokens = torch.from_numpy(_np(tmp, "tokens"))
    logits, caches = tf.prefill(model, tokens[:, :tp], cache_len=CACHE)
    _close(logits, _np(tmp, f"prefill{tp}"), f"prefill({tp}) logits")
    assert len(caches) == CFG32.n_layers
    for i, (layer, c) in enumerate(zip(CFG32.layers_flat, caches)):
        r, j = divmod(i, 3)
        for kv in ("k", "v"):
            want = _np(tmp, f"cache{tp}_{j}{kv}")[r]
            S = min(8, CACHE) if layer.mixer == "swa" else CACHE
            assert tuple(c["mixer"][kv].shape) == (B, S, CFG32.n_kv, CFG32.head_dim)
            _close(c["mixer"][kv], want, f"layer {i} {kv} cache after prefill({tp})")


@pytest.mark.parametrize("tp", PROMPTS)
def test_every_decode_step(reference, tp):
    tmp, _, model = reference
    tokens = torch.from_numpy(_np(tmp, "tokens"))
    dec, full = _np(tmp, f"decode{tp}"), _np(tmp, "train")
    _, caches = tf.prefill(model, tokens[:, :tp], cache_len=CACHE)
    for i, t in enumerate(range(tp, T)):
        given = [dict(c["mixer"]) for c in caches]
        logits, caches = tf.decode_step(model, tokens[:, t:t + 1], t, caches)
        _close(logits, dec[i], f"decode step {t} after prefill({tp})")
        _close(logits, full[:, t], f"decode step {t} vs train")
    # decode returns new cache tensors and leaves the given ones as they were
    assert all(g["k"] is not c["mixer"]["k"] for g, c in zip(given, caches))


def test_prefill_then_decode_equals_longer_prefill(reference):
    _, _, model = reference
    tokens = torch.from_numpy(np.random.RandomState(5).randint(0, SMOKE.vocab, (B, 11)))
    for use_kernel in ("ref", "auto"):
        want, _ = tf.prefill(model, tokens, use_kernel=use_kernel)
        _, caches = tf.prefill(model, tokens[:, :10], cache_len=16, use_kernel=use_kernel)
        got, _ = tf.decode_step(model, tokens[:, 10:], 10, caches)
        _close(got, want.numpy(), f"prefill(11) vs prefill(10) + decode, {use_kernel}")


def test_generate_greedy_ids(reference):
    tmp, _, model = reference
    prompt = torch.from_numpy(_np(tmp, "prompt"))
    ids, gap = torch.from_numpy(_np(tmp, "ids")), _np(tmp, "gap")
    # teacher-forced: fed the reference's ids, the port picks the reference's next id
    logits, caches = tf.prefill(model, prompt, cache_len=CACHE)
    for i in range(NEW):
        tie = torch.from_numpy(gap[i] < 10 * TOL)
        assert torch.equal(logits.argmax(-1)[~tie], ids[:, i][~tie]), i
        logits, caches = tf.decode_step(model, ids[:, i:i + 1], TG + i, caches)
    assert gap.min() > 10 * TOL   # no near-tie: the whole sequences must agree
    eng = Engine(CFG32, model, device="cpu")
    assert eng.cache_len == CACHE
    out = eng.generate(prompt, NEW)
    assert out.shape == (B, NEW) and out.device.type == "cpu"
    assert torch.equal(out, ids)
    assert torch.equal(Engine(CFG32, model, device="cpu", use_kernel="ref").generate(prompt, NEW),
                       ids)


def test_glu_gelu_and_rope_equal_the_reference(reference):
    tmp, _, _ = reference
    x2 = torch.from_numpy(_np(tmp, "x2"))
    _close(layers.glu(x2, "geglu"), _np(tmp, "geglu"), "geglu (tanh GELU)", tol=1e-6)
    _close(layers.glu(x2, "swiglu"), _np(tmp, "swiglu"), "swiglu", tol=1e-6)
    _close(layers.act_fn("gelu")(x2), _np(tmp, "gelu"), "gelu", tol=1e-6)
    # the exact GELU is not what the reference computes
    exact = torch.nn.functional.gelu(x2)
    assert (exact - torch.from_numpy(_np(tmp, "gelu"))).abs().max() > 1e-4
    xr = torch.from_numpy(_np(tmp, "xr"))
    _close(layers.rope(xr, torch.arange(3, 3 + xr.shape[1]), 1e6), _np(tmp, "rope"), "rope",
           tol=1e-5)
    got = layers.rope(xr.to(torch.bfloat16), torch.arange(xr.shape[1]), 1e4)
    assert got.dtype == torch.bfloat16
    _close(got, _np(tmp, "rope_bf16"), "rope bf16", tol=1e-2)
    with pytest.raises(ValueError):
        layers.glu(x2, "reglu")


def test_param_count_and_registry():
    assert CFG.param_count() == 3_879_925_248
    assert cb.get("gemma3-4b") is CFG and "gemma3-4b" not in cb.LATER
    assert CFG.n_layers == 34 and WINDOW == 1024
    assert sum(l.mixer == "swa" for l in CFG.layers_flat) == 29
    assert all(l.window == WINDOW for l in CFG.layers_flat if l.mixer == "swa")
    shapes = tf.parameter_shapes(CFG)   # the module skeleton, on the meta device
    assert sum(int(np.prod(s)) for s in shapes.values()) == CFG.param_count()
    assert shapes["layers.0.mixer.wq.weight"] == (8 * 256, 2560)
    assert shapes["layers.5.mixer.wo.weight"] == (2560, 8 * 256)
    assert shapes["layers.33.ffn.wi.weight"] == (2 * 10240, 2560)
    specs = tf.cache_specs(CFG, 4, 2080)
    assert tuple(specs[0]["mixer"]["k"].shape) == (4, 1024, 4, 256)
    assert tuple(specs[5]["mixer"]["v"].shape) == (4, 2080, 4, 256)
    assert attention.cache_len_hint(CFG, CFG.layers_flat[0]) == WINDOW
    assert attention.cache_len_hint(CFG, CFG.layers_flat[5]) == CFG.max_seq


def test_convert_maps_the_attention_and_ffn_leaves(reference):
    _, tree, _ = reference
    state = convert.params_from_reference(CFG32, tree)
    layer = tree["stacks"][0]["layers"][2]   # the global layer, repeat 1 -> layer 5
    d, H, Dh, f = CFG32.d_model, CFG32.n_heads, CFG32.head_dim, CFG32.d_ff
    wq, wo, wi = layer["mixer"]["wq"][1], layer["mixer"]["wo"][1], layer["ffn"]["wi"][1]
    assert torch.equal(state["layers.5.mixer.wq.weight"], torch.from_numpy(wq.reshape(d, H * Dh).T.copy()))
    assert torch.equal(state["layers.5.mixer.wo.weight"], torch.from_numpy(wo.reshape(H * Dh, d).T.copy()))
    assert torch.equal(state["layers.5.ffn.wi.weight"], torch.from_numpy(wi.reshape(d, 2 * f).T.copy()))
    assert torch.equal(state["layers.5.ln2"], torch.from_numpy(layer["ln2"][1]))
    assert torch.equal(state["layers.4.mixer.k_norm"],
                       torch.from_numpy(tree["stacks"][0]["layers"][1]["mixer"]["k_norm"][1]))
    bad = dict(layer, ffn=dict(layer["ffn"], bias=np.zeros((2, 3), np.float32)))
    layers_ = list(tree["stacks"][0]["layers"])
    layers_[2] = bad
    with pytest.raises(ValueError, match="left over"):
        convert.params_from_reference(CFG32, dict(tree, stacks=[{"layers": layers_}]))
    layers_[2] = {k: v for k, v in layer.items() if k != "ln2"}
    with pytest.raises(ValueError, match="without a value"):
        convert.params_from_reference(CFG32, dict(tree, stacks=[{"layers": layers_}]))


def test_what_the_attention_does_not_take_raises(reference):
    """Cross-attention and non-causal layers raise; an MoE layer needs a
    MoECfg (gemma3's SMOKE has none) and builds with one; an attention layer
    without an FFN and the int8 KV cache build."""
    _, _, model = reference
    tokens = torch.zeros(1, 4, dtype=torch.long)
    for layer in (Layer(mixer="attn", cross=True), Layer(mixer="attn", causal=False)):
        cfg = dataclasses.replace(CFG32, stacks=(((layer,), 1),))
        with pytest.raises(NotImplementedError, match="Queue A"):
            tf.param_specs(cfg)
    moe_cfg = dataclasses.replace(CFG32, stacks=(((Layer(mixer="swa", window=4, moe=True),), 1),))
    with pytest.raises(ValueError, match="MoECfg"):
        tf.param_specs(moe_cfg)
    moe_cfg = dataclasses.replace(moe_cfg, moe=cb.MoECfg(n_experts=4, top_k=2, d_ff=32))
    assert set(tf.param_specs(moe_cfg)["stacks"][0]["layers"][0]["ffn"]) == {"router", "wi", "wo"}
    moe_model = Model(moe_cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert torch.isfinite(tf.prefill(moe_model, tokens)[0]).all()
    bare = dataclasses.replace(CFG32, stacks=(((Layer(mixer="attn", ffn=False),), 1),))
    assert set(tf.param_specs(bare)["stacks"][0]["layers"][0]) == {"ln1", "mixer"}
    quant = dataclasses.replace(CFG32, kv_quant=True)
    assert tf.parameter_shapes(quant) == tf.parameter_shapes(CFG32)
    assert tf.cache_specs(quant, 1, 8)[0]["mixer"]["k"].dtype == torch.int8
    capped = dataclasses.replace(CFG32, attn_softcap=50.0)
    m = Model(capped, {k: v for k, v in model.state_dict().items()}, device="cpu")
    with pytest.raises(NotImplementedError, match="attn_softcap"):
        tf.prefill(m, tokens)
    x = torch.zeros(1, 4, CFG32.d_model)
    with pytest.raises(ValueError, match="seq_axis"):
        attention.fwd(model.layers[0].mixer, CFG32, CFG32.layers_flat[0], x, mode="prefill",
                      positions=torch.arange(4), seq_axis="seq")
    xr = torch.randn(1, 8, CFG32.d_model, generator=torch.Generator().manual_seed(3))
    for layer_index in (0, 2):   # without a group, seq_axis is the whole sequence
        blk, lay = model.layers[layer_index].mixer, CFG32.layers_flat[layer_index]
        plain, _ = attention.fwd(blk, CFG32, lay, xr, mode="train", positions=torch.arange(8))
        shard, _ = attention.fwd(blk, CFG32, lay, xr, mode="train", positions=torch.arange(8),
                                 seq_axis="seq")
        torch.testing.assert_close(shard, plain, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="decode"):
        attention.fwd(model.layers[0].mixer, CFG32, CFG32.layers_flat[0], x, mode="decode",
                      positions=torch.arange(4))
    with pytest.raises(ValueError, match="CUDA"):
        tf.prefill(model, tokens, use_kernel="cuda")
