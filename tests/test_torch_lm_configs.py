"""The port's language models at the SMOKE widths of six configs against the
JAX package's ``models``/``serve``, float32: granite-moe-3b (MoE attention
layers), jamba-v0.1-52b (Mamba layers with a dense and with an MoE FFN,
attention), kimi-k2 (a dense layer, then MoE layers with a shared expert),
starcoder2-15b (plain GELU MLP), gemma-2b (GeGLU, ``gemma_norm``,
``embed_scale``, MQA) and llama3.2-1b.

The reference materializes each config's parameters (``PRNGKey(1)``) and
runs the train forward (logits and the aux loss), prefill of an 8-token
prompt then 4 decode steps, and ``Engine.generate``, all in one
module-scoped child process; the parameters reach the port through
``convert.params_from_reference``.  Tolerances: logits rtol 1e-4 and atol
1e-5, the aux loss 1e-6; greedy ids equal.

The card cases at the bottom (marker ``cuda``) hold K6 at the head widths
of granite (64), jamba (128) and kimi (112, padded to 128) and K7 at
jamba's state width N 16 against their plain versions, at the prefill
shapes those models give the kernels.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _mp import run  # noqa: E402
from _torch_lm import SAVE_PARAMS, unflatten  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"

MODULES = ("granite_moe_3b", "jamba_v01_52b", "kimi_k2", "starcoder2_15b", "gemma_2b",
           "llama3_2_1b")
B, T, TP, NEW, CACHE = 2, 12, 8, 6, 16
RTOL, ATOL, AUX_TOL = 1e-4, 1e-5, 1e-6

REFERENCE = ALIAS + SAVE_PARAMS + """
import dataclasses, importlib
from repro.models import params as pm, transformer as tf
from repro.serve import Engine

TMP = {tmp!r}
tokens = jnp.asarray(np.load(TMP + "/tokens.npy"), jnp.int32)
for mod in {modules!r}:
    cfg = importlib.import_module("repro.configs." + mod).SMOKE
    cfg = dataclasses.replace(cfg, dtype="float32", max_seq={cache})
    params = pm.materialize(tf.param_specs(cfg), jax.random.PRNGKey(1), jnp.float32)
    save_params(params, TMP + "/" + mod + "_params.npz")
    out = {{}}
    h, _, aux = tf.fwd(params, cfg, tokens, mode="train", remat="none")
    out["train"] = np.asarray(tf.logits_fn(params, cfg, h))
    out["aux"] = np.asarray(aux)
    # prefill and decode through the engine's own jitted steps (tf.prefill and
    # tf.decode_step), compiled once and reused by generate
    eng = Engine(cfg, params, cache_len={cache})
    logits, caches = eng._prefill(params, tokens[:, :{tp}], None)
    out["prefill"] = np.asarray(logits)
    dec = []
    for t in range({tp}, {t}):
        logits, caches = eng._decode(params, tokens[:, t:t + 1], jnp.asarray(t, jnp.int32),
                                     caches, None)
        dec.append(np.asarray(logits))
    out["decode"] = np.stack(dec)
    out["ids"] = np.asarray(eng.generate(tokens[:, :{tp}], {new}))
    np.savez(TMP + "/" + mod + "_out.npz", **out)
print("OK")
"""


def _cfg(mod):
    smoke = importlib.import_module(f"repro_torch.configs.{mod}").SMOKE
    return dataclasses.replace(smoke, dtype="float32", max_seq=CACHE)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_lm_configs")
    vocab = min(_cfg(m).vocab for m in MODULES)
    tokens = np.random.RandomState(3).randint(0, vocab, (B, T))
    np.save(tmp / "tokens.npy", tokens)
    run(REFERENCE.format(tmp=str(tmp), modules=MODULES, cache=CACHE, tp=TP, t=T, new=NEW),
        ndev=1)
    out = {}
    for mod in MODULES:
        cfg = _cfg(mod)
        tree = unflatten(np.load(tmp / f"{mod}_params.npz"))
        model = Model(cfg, convert.params_from_reference(cfg, tree), device="cpu")
        out[mod] = (cfg, model, dict(np.load(tmp / f"{mod}_out.npz")), tree)
    return torch.from_numpy(tokens), out


def _close(got, want, what):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("mod", MODULES)
def test_forward_logits(reference, mod):
    tokens, out = reference
    cfg, model, want, _ = out[mod]
    h, caches, _ = tf.fwd(model, tokens, mode="train")
    assert caches is None
    logits = tf.logits_fn(model, h)
    assert logits.shape == (B, T, cfg.padded_vocab) and torch.isfinite(logits).all()
    _close(logits, want["train"], f"{mod} train logits")


@pytest.mark.parametrize("mod", MODULES)
def test_aux_loss_summed_over_layers(reference, mod):
    """The Switch loss of every MoE layer, summed (0 without MoE layers)."""
    tokens, out = reference
    cfg, model, want, _ = out[mod]
    _, _, aux = tf.fwd(model, tokens, mode="train")
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(float(aux) - float(want["aux"])) <= AUX_TOL
    assert (float(aux) > 0) == any(layer.moe for layer in cfg.layers_flat)


@pytest.mark.parametrize("mod", MODULES)
def test_prefill_then_four_decode_steps(reference, mod):
    tokens, out = reference
    cfg, model, want, _ = out[mod]
    logits, caches = tf.prefill(model, tokens[:, :TP], cache_len=CACHE)
    _close(logits, want["prefill"], f"{mod} prefill logits")
    for i, t in enumerate(range(TP, T)):
        logits, caches = tf.decode_step(model, tokens[:, t:t + 1], t, caches)
        _close(logits, want["decode"][i], f"{mod} decode step {t}")


@pytest.mark.parametrize("mod", MODULES)
def test_engine_greedy_ids(reference, mod):
    tokens, out = reference
    cfg, model, want, _ = out[mod]
    ids = Engine(cfg, model, device="cpu", cache_len=CACHE).generate(tokens[:, :TP], NEW)
    assert ids.shape == (B, NEW)
    assert np.array_equal(ids.numpy(), want["ids"]), (ids.numpy(), want["ids"])


def test_convert_maps_the_moe_leaves(reference):
    """kimi's MoE layer (repeat 1 of its second stack -> layer 2): the router
    and the shared experts transposed as nn.Linear weights, the experts' wi
    and wo as they are; a leaf left over or missing raises."""
    _, out = reference
    cfg, _, _, tree = out["kimi_k2"]
    m, d = cfg.moe, cfg.d_model
    state = convert.params_from_reference(cfg, tree)
    ffn = tree["stacks"][1]["layers"][0]["ffn"]
    S = m.n_shared * m.d_ff
    as_t = torch.from_numpy
    assert torch.equal(state["layers.2.ffn.router.weight"], as_t(ffn["router"][1].T.copy()))
    assert torch.equal(state["layers.2.ffn.wi"], as_t(ffn["wi"][1]))
    assert torch.equal(state["layers.2.ffn.wo"], as_t(ffn["wo"][1]))
    assert torch.equal(state["layers.2.ffn.shared_wi.weight"],
                       as_t(ffn["shared_wi"][1].reshape(d, 2 * S).T.copy()))
    assert torch.equal(state["layers.2.ffn.shared_wo.weight"], as_t(ffn["shared_wo"][1].T.copy()))
    assert "layers.0.ffn.wi.weight" in state   # layer 0 is dense
    stacks = [dict(st) for st in tree["stacks"]]
    layer = dict(stacks[1]["layers"][0])
    stacks[1] = {"layers": [dict(layer, ffn=dict(ffn, bias=np.zeros(3, np.float32)))]}
    with pytest.raises(ValueError, match="left over"):
        convert.params_from_reference(cfg, dict(tree, stacks=stacks))
    stacks[1] = {"layers": [dict(layer, ffn={k: v for k, v in ffn.items() if k != "shared_wo"})]}
    with pytest.raises(ValueError, match="without a value"):
        convert.params_from_reference(cfg, dict(tree, stacks=stacks))


# ---------------------------------------------------------------------------
# on the card: K6 and K7 at the shapes these models give them
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


K6_CASES = [  # B, H, Hkv, T, S, D (window = S: the global layers of these models)
    (2, 24, 8, 333, 333, 64), (1, 24, 8, 1000, 1000, 64),      # granite
    (2, 32, 8, 333, 333, 128), (1, 32, 8, 1000, 1000, 128),    # jamba
    (2, 64, 8, 333, 333, 112), (1, 64, 8, 1000, 1000, 112),    # kimi (padded to 128)
]
K7_CASES = [  # Ba, T, H, G, N, P, L: jamba's Mamba layers (d_inner 8192, P 64)
    (4, 2048, 128, 1, 16, 64, 64), (1, 1000, 128, 1, 16, 64, 50), (2, 200, 128, 1, 16, 64, 50),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", K6_CASES, ids=lambda c: "x".join(map(str, c)))
def test_k6_at_these_head_widths_vs_plain_on_card(cuda_device, case, dt):
    from repro_torch.kernels.swa import kernel as kswa
    from repro_torch.kernels.swa import swa_ref

    B, H, Hkv, T, S, D = case
    dtype = getattr(torch, dt)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn(B, T, H, D, generator=g, device=cuda_device).to(dtype).transpose(1, 2)
    k = torch.randn(B, S, Hkv, D, generator=g, device=cuda_device).to(dtype).transpose(1, 2)
    v = torch.randn(B, S, Hkv, D, generator=g, device=cuda_device).to(dtype).transpose(1, 2)
    tc0 = kswa.swa_attention_cuda.tc_launches
    got = kswa.swa_attention_cuda(q, k, v, window=S)
    torch.cuda.synchronize()
    assert kswa.swa_attention_cuda.tc_launches == tc0 + 1   # both dtypes: tensor cores
    want = swa_ref(q, k, v, window=S)
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err <= (2e-2 if dt == "bfloat16" else 1e-5), float(err)
    if dt == "bfloat16":
        fro = torch.linalg.vector_norm(got.float() - want.float()) / torch.linalg.vector_norm(
            want.float())
        assert fro <= 1e-2, float(fro)


@pytest.mark.cuda
@pytest.mark.parametrize("case", K7_CASES, ids=lambda c: "x".join(map(str, c)))
def test_k7_at_state_width_16_vs_plain_on_card(cuda_device, case):
    from repro_torch.kernels.ssd import kernel as kssd
    from repro_torch.kernels.ssd import ssd_intra_chunk_ref

    Ba, T_, H, G, N, P, L = case
    g = torch.Generator(device=cuda_device).manual_seed(2)
    w = H * P + 2 * G * N
    zx = torch.randn(Ba, T_, w, generator=g, device=cuda_device).to(torch.bfloat16)
    x = zx[..., :H * P].view(Ba, T_, H, P)
    Bm = zx[..., H * P:H * P + G * N].view(Ba, T_, G, N)
    Cm = zx[..., H * P + G * N:].view(Ba, T_, G, N)
    dt = torch.rand(Ba, T_, H, generator=g, device=cuda_device) * 0.2 + 0.01
    A = -torch.rand(H, generator=g, device=cuda_device) - 0.1
    assert kssd.kernel_for(torch.bfloat16, N, P) == "wgmma"
    w0 = kssd.ssd_intra_chunk_cuda.by_kernel["wgmma"]
    got = kssd.ssd_intra_chunk_cuda(x, dt, A, Bm, Cm, chunk=L)
    torch.cuda.synchronize()
    assert kssd.ssd_intra_chunk_cuda.by_kernel["wgmma"] == w0 + 1
    want = ssd_intra_chunk_ref(x, dt, A, Bm, Cm, chunk=L)
    for name, a, b in zip(("y_diag", "states", "s"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        tol = 1e-2 if name == "y_diag" else 1e-5
        err = (a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1.0)
        assert err <= tol, (name, float(err))
