"""K6's plain version and ops (``repro_torch.kernels.swa``) against the JAX
package's sliding-window attention.

* ``swa_ref`` and the op's ``ref`` path against the reference's ``swa_ref``
  and ``swa_pallas(interpret=True)`` at every case of
  ``tests/test_kernel_swa.py`` (windows 4/16/64/10000 under three tilings,
  bf16, queries offset into a longer kv sequence, GQA 8 -> 2), and against
  ``_attend_swa`` at every case of ``tests/test_attend_swa.py``.  The
  reference runs once, in a child process; the inputs are made there with
  the reference tests' own seeds and read back.  Tolerances are the
  reference tests' own: 2e-5 in f32, 5e-2 in bf16 (rtol = atol).
* The op raises where ``swa_pallas`` raises (tiles that do not divide T or
  S); on a CPU tensor ``auto`` is the plain version and ``cuda`` raises.
* The ``cuda``-marked tests hold K6 against ``swa_ref`` on the card: the
  head widths of the tests (16-64) and of gemma3-4b (256), ragged T,
  queries offset into a longer kv sequence, window = S, f32 and bf16.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _mp import run  # noqa: E402
from repro_torch.kernels import swa  # noqa: E402
from repro_torch.kernels.swa import kernel as swa_kernel_mod  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"

WINDOW_CASES = [(w, bq, bk) for w in (4, 16, 64, 10_000) for bq, bk in ((16, 16), (32, 16), (16, 32))]
OFFSET_WINDOWS = (8, 48, 128)
ATTEND_CASES = [(64, 8, 16), (64, 16, 16), (128, 48, 32), (64, 64, 16), (64, 500, 16),
                (48, 10, 48)]
TOL = {"float32": 2e-5, "bfloat16": 5e-2}

REFERENCE = ALIAS + """
from repro.kernels.swa import swa_ref
from repro.kernels.swa.kernel import swa_pallas
from repro.models.attention import _attend_swa, _expand_kv

TMP = {tmp!r}
out = {{}}

def mk(B, H, Hkv, T, S, D, dtype, seed=0):   # tests/test_kernel_swa.py::_mk
    rng = np.random.RandomState(seed)
    q = jnp.asarray(rng.randn(B, H, T, D), dtype) * 0.3
    k = jnp.asarray(rng.randn(B, Hkv, S, D), dtype) * 0.3
    v = jnp.asarray(rng.randn(B, Hkv, S, D), dtype) * 0.3
    return q, k, v

def keep(name, q, k, v, **results):
    for n, a in dict(q=q, k=k, v=v, **results).items():
        out[name + "/" + n] = np.asarray(a.astype(jnp.float32))

q, k, v = mk(2, 4, 2, 64, 64, 32, jnp.float32)
for w, bq, bk in {window_cases}:
    keep(f"win{{w}}_{{bq}}_{{bk}}", q, k, v, ref=swa_ref(q, k, v, window=w),
         pallas=swa_pallas(q, k, v, window=w, bq=bq, bk=bk, interpret=True))
q, k, v = mk(1, 2, 1, 64, 64, 64, jnp.bfloat16)
keep("bf16", q, k, v, ref=swa_ref(q, k, v, window=32),
     pallas=swa_pallas(q, k, v, window=32, bq=16, bk=16, interpret=True))
q, k, v = mk(1, 4, 4, 16, 128, 32, jnp.float32, seed=3)
for w in {offset_windows}:
    keep(f"offset{{w}}", q, k, v, ref=swa_ref(q, k, v, window=w),
         pallas=swa_pallas(q, k, v, window=w, bq=16, bk=16, interpret=True))
B, H, Hkv, T, D = 1, 8, 2, 32, 16   # tests/test_kernel_swa.py::test_swa_gqa_mapping
rng = np.random.RandomState(7)
q = jnp.asarray(rng.randn(B, H, T, D), jnp.float32) * 0.3
k = jnp.concatenate([jnp.ones((B, 1, T, D), jnp.float32) * 0.1,
                     -jnp.ones((B, 1, T, D), jnp.float32) * 0.1], axis=1) + jnp.asarray(
    rng.randn(B, Hkv, T, D), jnp.float32) * 0.05
v = jnp.asarray(rng.randn(B, Hkv, T, D), jnp.float32)
keep("gqa", q, k, v, ref=swa_ref(q, k, v, window=16),
     pallas=swa_pallas(q, k, v, window=16, bq=16, bk=16, interpret=True))

for T, w, chunk in {attend_cases}:   # tests/test_attend_swa.py
    rng = np.random.RandomState(0)
    B, H, Hkv, D = 2, 4, 2, 16
    q = jnp.asarray(rng.randn(B, H, T, D), jnp.float32) * 0.4
    k = jnp.asarray(rng.randn(B, Hkv, T, D), jnp.float32) * 0.4
    v = jnp.asarray(rng.randn(B, Hkv, T, D), jnp.float32)
    got = _attend_swa(q.transpose(0, 2, 1, 3), _expand_kv(k.transpose(0, 2, 1, 3), H),
                      _expand_kv(v.transpose(0, 2, 1, 3), H), window=w,
                      positions=jnp.arange(T), q_chunk=chunk)
    keep(f"attend{{T}}_{{w}}_{{chunk}}", q, k, v, attend_swa=got.transpose(0, 2, 1, 3))

raised = []   # the tilings swa_pallas refuses
q, k, v = mk(1, 2, 1, 48, 100, 16, jnp.float32)
for bq, bk in ((32, 16), (16, 64), (48, 100)):
    try:
        swa_pallas(q, k, v, window=8, bq=bq, bk=bk, interpret=True)
        raised.append(0)
    except ValueError:
        raised.append(1)
out["raised"] = np.asarray(raised)
np.savez(TMP + "/swa.npz", **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_swa")
    run(REFERENCE.format(tmp=str(tmp), window_cases=WINDOW_CASES,
                         offset_windows=OFFSET_WINDOWS, attend_cases=ATTEND_CASES), ndev=1)
    return dict(np.load(tmp / "swa.npz"))


def _inputs(ref, name, dtype=torch.float32):
    return tuple(torch.from_numpy(ref[f"{name}/{n}"]).to(dtype) for n in ("q", "k", "v"))


def _close(got, want, dt="float32"):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dt], atol=TOL[dt])


def _check_all_paths(ref, name, window, dtype=torch.float32, bq=128, bk=128):
    dt = str(dtype).removeprefix("torch.")
    q, k, v = _inputs(ref, name, dtype)
    outs = {"swa_ref": swa.swa_ref(q, k, v, window=window),
            "op_ref": swa.sliding_window_attention(q, k, v, window=window, use_kernel="ref",
                                                   bq=bq, bk=bk),
            "op_auto": swa.sliding_window_attention(q, k, v, window=window, bq=bq, bk=bk),
            "dispatch": swa.swa_attention(q, k, v, window=window)}
    for who, got in outs.items():
        assert got.shape == q.shape and got.dtype == dtype, who
        for kind in ("ref", "pallas"):
            if f"{name}/{kind}" in ref:
                _close(got, ref[f"{name}/{kind}"], dt)
    assert torch.equal(outs["op_ref"], outs["swa_ref"]) and torch.equal(outs["op_auto"],
                                                                        outs["swa_ref"])


@pytest.mark.parametrize("case", WINDOW_CASES, ids=lambda c: "w{}_bq{}_bk{}".format(*c))
def test_windows(reference, case):
    w, bq, bk = case
    _check_all_paths(reference, f"win{w}_{bq}_{bk}", w, bq=bq, bk=bk)


def test_bf16(reference):
    _check_all_paths(reference, "bf16", 32, torch.bfloat16, bq=16, bk=16)


@pytest.mark.parametrize("window", OFFSET_WINDOWS)
def test_queries_offset_into_a_longer_kv_sequence(reference, window):
    _check_all_paths(reference, f"offset{window}", window, bq=16, bk=16)


def test_gqa_mapping(reference):
    _check_all_paths(reference, "gqa", 16, bq=16, bk=16)


@pytest.mark.parametrize("case", ATTEND_CASES, ids=lambda c: "T{}_w{}_c{}".format(*c))
def test_attend_swa_cases(reference, case):
    T, w, chunk = case
    name = f"attend{T}_{w}_{chunk}"
    q, k, v = _inputs(reference, name)
    want = reference[f"{name}/attend_swa"]
    _close(swa.swa_ref(q, k, v, window=w), want)
    _close(swa.swa_attention(q, k, v, window=w, use_kernel="ref"), want)


def test_op_raises_where_the_reference_raises(reference):
    assert reference["raised"].tolist() == [1, 1, 0]
    q, k, v = (torch.zeros(1, 2, 48, 16), torch.zeros(1, 1, 100, 16), torch.zeros(1, 1, 100, 16))
    for bq, bk in ((32, 16), (16, 64)):
        with pytest.raises(ValueError, match="!= 0"):
            swa.sliding_window_attention(q, k, v, window=8, bq=bq, bk=bk)
    assert swa.sliding_window_attention(q, k, v, window=8, bq=48, bk=100).shape == q.shape
    # the dispatch point beneath the op takes any T
    assert swa.swa_attention(q, k, v, window=8).shape == q.shape


def test_auto_on_cpu_is_plain_and_cuda_raises():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 4, 5, 8, generator=g), torch.randn(1, 2, 9, 8, generator=g),
               torch.randn(1, 2, 9, 8, generator=g))
    assert torch.equal(swa.swa_attention(q, k, v, window=3), swa.swa_ref(q, k, v, window=3))
    for call in (lambda: swa.swa_attention(q, k, v, window=3, use_kernel="cuda"),
                 lambda: swa.sliding_window_attention(q, k, v, window=3, use_kernel="cuda",
                                                      bq=5, bk=9),
                 lambda: swa.swa_attention_cuda(q, k, v, window=3)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="use_kernel"):
        swa.swa_attention(q, k, v, window=3, use_kernel="pallas")
    with pytest.raises(ValueError, match="multiple"):
        swa.swa_ref(q, k[:, :1].expand(1, 3, 9, 8), v[:, :1].expand(1, 3, 9, 8), window=3)


def test_window_of_s_is_causal_attention():
    g = torch.Generator().manual_seed(2)
    # float32 inputs: swa_ref takes its logits to float32, as the reference does
    q, k, v = (torch.randn(2, 4, 7, 8, generator=g) for _ in range(3))
    logits = (q @ k.transpose(-1, -2)) * 8 ** -0.5
    causal = torch.ones(7, 7, dtype=torch.bool).tril()
    want = torch.softmax(logits.masked_fill(~causal, -torch.inf), dim=-1) @ v
    for w in (7, 1000):
        torch.testing.assert_close(swa.swa_ref(q, k, v, window=w), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# on the card: K6 against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CARD_CASES = [  # B, H, Hkv, T, S, D, window
    (2, 4, 2, 64, 64, 32, 4), (2, 4, 2, 64, 64, 32, 10_000), (1, 8, 2, 32, 32, 16, 16),
    (1, 4, 4, 16, 128, 32, 48), (1, 2, 1, 1, 1, 64, 8), (2, 2, 1, 5, 5, 64, 3),
    (1, 8, 4, 50, 50, 256, 16), (1, 8, 4, 1000, 1000, 256, 1024), (1, 8, 4, 333, 1000, 256, 200),
    (2, 8, 4, 200, 200, 256, 200),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_k6_vs_plain_on_card(cuda_device, case, dt):
    B, H, Hkv, T, S, D, w = case
    dtype = getattr(torch, dt)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    # q, k, v as (B, T, H, D) projections seen through (B, H, T, D) views
    q = torch.randn(B, T, H, D, generator=g, device=cuda_device).to(dtype).transpose(1, 2)
    k = torch.randn(B, S, Hkv, D, generator=g, device=cuda_device).to(dtype).transpose(1, 2)
    v = torch.randn(B, S, Hkv, D, generator=g, device=cuda_device).to(dtype).transpose(1, 2)
    n0 = swa.swa_attention_cuda.launches
    got = swa.swa_attention_cuda(q, k, v, window=w)
    torch.cuda.synchronize()
    assert swa.swa_attention_cuda.launches == n0 + 1
    assert got.shape == q.shape and got.dtype == dtype and got.transpose(1, 2).is_contiguous()
    want = swa.swa_ref(q, k, v, window=w)
    tol = 1e-5 if dt == "float32" else 2e-2
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err <= tol, float(err)
    # contiguous (B, H, T, D) inputs, through the dispatch point
    got2 = swa.swa_attention(q.contiguous(), k.contiguous(), v.contiguous(), window=w)
    assert torch.equal(got2, got)


@pytest.mark.cuda
def test_k6_raises_on_what_it_does_not_take(cuda_device):
    def mk(B=1, H=2, Hkv=1, T=8, S=8, D=16, dtype=torch.float32):
        return (torch.zeros(B, H, T, D, dtype=dtype, device=cuda_device),
                torch.zeros(B, Hkv, S, D, dtype=dtype, device=cuda_device),
                torch.zeros(B, Hkv, S, D, dtype=dtype, device=cuda_device))
    for args, w, match in ((mk(D=512), 4, "D <="), (mk(D=18), 4, "multiple of 4"),
                           (mk(dtype=torch.float64), 4, "dtype"), (mk(H=3, Hkv=2), 4, "disagree"),
                           (mk(T=9), 4, "T >= 1"), (mk(), 0, "window")):
        with pytest.raises(ValueError, match=match):
            swa_kernel_mod.swa_attention_cuda(*args, window=w)
    q, k, v = mk(T=16, S=16)
    with pytest.raises(ValueError, match="contiguous"):
        swa_kernel_mod.swa_attention_cuda(q.transpose(2, 3), k, v, window=4)
