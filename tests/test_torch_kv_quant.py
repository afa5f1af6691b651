"""The port's int8 KV cache (``cfg.kv_quant``) against the JAX package's, at
the SMOKE widths of llama3.2-1b and gemma3-4b (global and sliding-window
layers), float32.

The reference (``PRNGKey(0)`` parameters, as ``tests/test_kv_quant.py``
draws them) prefills an 8-token prompt into a 16-slot cache and decodes 4
tokens, with and without ``kv_quant``, in one module-scoped child process;
it also quantizes a set of given arrays with its ``_kv_quantize``.  Checks:

* ``_kv_quantize`` on the same arrays (a zero row, exact halves) gives the
  reference's int8 values and scales bitwise;
* after prefill, the int8 caches equal the reference's up to one unit at a
  few entries (the keys and values themselves differ by float32 rounding,
  which can move a value across a rounding boundary), the scales within
  rtol 1e-5, and the caches hold int8 and float32 as the reference's do;
* the quantised decode logits lie within 1e-3 (normwise) of the
  reference's quantised decode logits, and within the bound that
  ``tests/test_kv_quant.py`` sets (0.08 normwise, argmax agreement above
  0.9) of the port's own float cache's.
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
from repro_torch.models import Model, attention  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"

MODULES = ("llama3_2_1b", "gemma3_4b")
B, T, TP, CACHE = 2, 12, 8, 16
BOUND, AGREE = 0.08, 0.9     # tests/test_kv_quant.py's bound on the quantised decode
REF_TOL = 1e-3               # against the reference's quantised decode, normwise

REFERENCE = ALIAS + SAVE_PARAMS + """
import dataclasses, importlib
from repro.models import attention, params as pm, transformer as tf

TMP = {tmp!r}
arr = jnp.asarray(np.load(TMP + "/arr.npy"))
q, s = attention._kv_quantize(arr)
np.save(TMP + "/arr_q.npy", np.asarray(q))
np.save(TMP + "/arr_s.npy", np.asarray(s))
toks = jnp.asarray(np.load(TMP + "/tokens.npy"), jnp.int32)
for mod in {modules!r}:
    cfg = importlib.import_module("repro.configs." + mod).SMOKE
    cfg = dataclasses.replace(cfg, dtype="float32", max_seq=24)
    params = pm.materialize(tf.param_specs(cfg), jax.random.PRNGKey(0), jnp.float32)
    save_params(params, TMP + "/" + mod + "_params.npz")
    out = {{}}
    for name, c in (("fp", cfg), ("q", dataclasses.replace(cfg, kv_quant=True))):
        logits, caches = tf.prefill(params, c, toks[:, :{tp}], cache_len={cache}, remat="none")
        if name == "q":
            for si, stack in enumerate(caches):
                for j, layer in enumerate(stack):
                    for key, val in layer["mixer"].items():
                        out[f"cache/{{si}}/{{j}}/{{key}}"] = np.asarray(val)
        seq = []
        for t in range({tp}, {t}):
            logits, caches = tf.decode_step(params, c, toks[:, t:t + 1],
                                            jnp.asarray(t, jnp.int32), caches)
            seq.append(np.asarray(logits))
        out[name] = np.stack(seq)
    np.savez(TMP + "/" + mod + "_out.npz", **out)
print("OK")
"""


def _arrays():
    """Random keys, a row of zeros (scale 1) and rows with exact halves."""
    rng = np.random.RandomState(7)
    a = rng.randn(2, 5, 3, 16).astype(np.float32)
    a[0, 1, 2] = 0.0
    a[1, 2, 0] = np.arange(16, dtype=np.float32) - 7.5          # max 8.5 -> halves
    a[1, 3, 1] = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5] + [0] * 10, np.float32)
    return a


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_kv_quant")
    np.save(tmp / "arr.npy", _arrays())
    tokens = np.random.RandomState(0).randint(0, 128, (B, T))
    np.save(tmp / "tokens.npy", tokens)
    run(REFERENCE.format(tmp=str(tmp), modules=MODULES, cache=CACHE, tp=TP, t=T), ndev=1)
    models = {}
    for mod in MODULES:
        smoke = importlib.import_module(f"repro_torch.configs.{mod}").SMOKE
        cfg = dataclasses.replace(smoke, dtype="float32", max_seq=24)
        state = convert.params_from_reference(cfg, unflatten(np.load(tmp / f"{mod}_params.npz")))
        models[mod] = {name: Model(c, state, device="cpu") for name, c in
                       (("fp", cfg), ("q", dataclasses.replace(cfg, kv_quant=True)))}
        models[mod]["want"] = dict(np.load(tmp / f"{mod}_out.npz"))
    return tmp, torch.from_numpy(tokens), models


def test_quantizer_is_the_references_bitwise(reference):
    tmp = reference[0]
    q, s = attention._kv_quantize(torch.from_numpy(_arrays()))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.load(tmp / "arr_q.npy"))
    assert np.array_equal(s.numpy(), np.load(tmp / "arr_s.npy"))
    assert float(s[0, 1, 2]) == 1.0                     # a zero row keeps scale 1
    # halves round to even: 127 * (x / 127) for x = 0.5, 1.5, 2.5, -0.5, -1.5
    assert q[1, 3, 1, :6].tolist() == [127, 0, 2, 2, 0, -2]
    back = attention._kv_dequantize(q, s, torch.float32)
    assert back.dtype == torch.float32 and torch.allclose(back, torch.from_numpy(_arrays()),
                                                          atol=float(s.max()) / 2 + 1e-6)


@pytest.mark.parametrize("mod", MODULES)
def test_prefill_caches_are_the_references(reference, mod):
    _, tokens, models = reference
    m, want = models[mod]["q"], models[mod]["want"]
    _, caches = tf.prefill(m, tokens[:, :TP], cache_len=CACHE)
    cfg = m.cfg
    off_by_one = total = 0
    for i, c in enumerate(caches):
        # the reference's caches: stacks[si] holds layer j of the pattern with a repeat axis
        si, j, r = 0, i % len(cfg.stacks[0][0]), i // len(cfg.stacks[0][0])
        assert set(c["mixer"]) == {"k", "v", "k_s", "v_s"}
        for key in ("k", "v"):
            got, ref = c["mixer"][key], want[f"cache/{si}/{j}/{key}"][r]
            assert got.dtype == torch.int8 and got.shape == ref.shape
            d = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
            assert d.max() <= 1
            off_by_one += int((d == 1).sum())
            total += d.size
            gs, rs = c["mixer"][key + "_s"], want[f"cache/{si}/{j}/{key}_s"][r]
            assert gs.dtype == torch.float32
            np.testing.assert_allclose(gs.numpy(), rs, rtol=1e-5)
    assert off_by_one <= total * 1e-3, (off_by_one, total)


@pytest.mark.parametrize("mod", MODULES)
def test_decode_logits(reference, mod):
    _, tokens, models = reference
    want = models[mod]["want"]
    outs = {}
    for name in ("fp", "q"):
        m = models[mod][name]
        _, caches = tf.prefill(m, tokens[:, :TP], cache_len=CACHE)
        seq = []
        for t in range(TP, T):
            logits, caches = tf.decode_step(m, tokens[:, t:t + 1], t, caches)
            seq.append(logits.numpy())
        outs[name] = np.stack(seq)
    # the quantised decode against the reference's quantised decode
    err_ref = np.abs(outs["q"] - want["q"]).max() / np.abs(want["q"]).max()
    assert err_ref <= REF_TOL, err_ref
    np.testing.assert_allclose(outs["fp"], want["fp"], rtol=2e-5, atol=2e-5)
    # tests/test_kv_quant.py's bound, on the port's own two caches
    err = np.abs(outs["q"] - outs["fp"]).max() / np.abs(outs["fp"]).max()
    assert err < BOUND, err
    agree = (outs["q"].argmax(-1) == outs["fp"].argmax(-1)).mean()
    assert agree > AGREE, agree


def test_cache_specs_are_int8_with_float32_scales():
    from repro_torch.configs.llama3_2_1b import SMOKE
    cfg = dataclasses.replace(SMOKE, kv_quant=True)
    specs = tf.cache_specs(cfg, 2, 16)
    assert len(specs) == cfg.n_layers
    c = specs[0]["mixer"]
    assert c["k"].dtype == torch.int8 and tuple(c["k"].shape) == (2, 16, cfg.n_kv, cfg.head_dim)
    assert c["k_s"].dtype == torch.float32 and tuple(c["k_s"].shape) == (2, 16, cfg.n_kv)
