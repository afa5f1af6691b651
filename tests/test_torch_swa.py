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
* The bf16 tolerance of the tensor-core kernel.  A float64 NumPy model
  rounds where that kernel rounds (bf16 inputs, float32 logits scaled into
  log2 units, the online softmax over aligned tiles of 64 keys with float32
  m and l, P rounded to bf16 per tile, float32 accumulation, the output
  rounded once).  At the bf16 shapes of ``chip_smoke.K6_SHAPES`` that a CPU
  runs in seconds, the reference's ``swa_pallas(interpret=True)`` and
  ``swa_ref`` in bf16 and the port's ``swa_ref`` lie within 1e-2 of the
  model (half the card's 2e-2; the plain versions round the scaled q, the
  logits and the normalised P to bf16), and the model within 5e-3 of exact
  float64 attention; in relative Frobenius norm, which a few large outputs
  cannot dominate, the plain versions lie within 7.5e-3 of the model.  The
  pad widths (D 16 and 32 in a tile of 64 columns) change nothing: the zero
  columns add exact zeros.
* The ``cuda``-marked tests hold K6 against ``swa_ref`` on the card: the
  head widths of the tests (16-64) and of gemma3-4b (256), ragged T,
  queries offset into a longer kv sequence, window = S, the edges of the
  tensor-core kernel's tile rule, f32 and bf16, each dtype on its own kernel
  and both on the tensor cores (bf16 on wgmma, f32 in 3xTF32; bf16 also
  within 1e-2 relative Frobenius).  ``tests/test_torch_swa_tf32.py`` holds
  the f32 tolerance against a float64 model of the 3xTF32 rounding.
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


# the bf16 shapes of chip_smoke.K6_SHAPES that a CPU runs in seconds
# (B, H, Hkv, T, S, D, window)
BF16_CASES = [(2, 4, 2, 64, 64, 32, w) for w in (4, 16, 64, 10_000)] + [
    (1, 8, 2, 32, 32, 16, 16), (1, 4, 4, 16, 128, 32, 8), (1, 4, 4, 16, 128, 32, 48),
    (1, 4, 4, 16, 128, 32, 128), (1, 2, 1, 64, 64, 64, 32), (1, 8, 4, 1, 1, 256, 1024),
    (1, 8, 4, 5, 5, 256, 1024), (1, 8, 4, 50, 50, 256, 1024), (1, 8, 4, 333, 1000, 256, 200),
    (1, 2, 1, 5, 77, 64, 3)]
TC_TOL = 1e-2         # normwise, the plain versions against the kernel's model
TC_FRO_TOL = 7.5e-3   # relative Frobenius, the same (at most 5.0e-3 at these cases)
TC_EXACT_TOL = 5e-3   # normwise, the kernel's model against exact attention

BF16_REFERENCE = ALIAS + """
from repro.kernels.swa import swa_ref
from repro.kernels.swa.kernel import swa_pallas

def tile(n):   # the largest tile of at most 128 that divides n
    return max(b for b in range(1, min(n, 128) + 1) if n % b == 0)

out = {{}}
for i, (B, H, Hkv, T, S, D, w) in enumerate({cases}):
    rng = np.random.RandomState(100 + i)
    q, k, v = (jnp.asarray(rng.randn(*s), jnp.bfloat16)
               for s in ((B, H, T, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    res = dict(q=q, k=k, v=v, ref=swa_ref(q, k, v, window=w),
               pallas=swa_pallas(q, k, v, window=w, bq=tile(T), bk=tile(S), interpret=True))
    for n, a in res.items():
        out[f"c{{i}}/{{n}}"] = np.asarray(a.astype(jnp.float32))
np.savez({tmp!r} + "/swa_bf16.npz", **out)
print("OK")
"""


@pytest.fixture(scope="module")
def bf16_reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_swa_bf16")
    run(BF16_REFERENCE.format(tmp=str(tmp), cases=BF16_CASES), ndev=1)
    return dict(np.load(tmp / "swa_bf16.npz"))


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
# the bf16 tolerance: a float64 model of the tensor-core kernel's rounding
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634
KV_TILE = 64   # keys per kv tile of the tensor-core kernel


def _bf16(x):
    """float32 rounded to the nearest bf16 (ties to even), kept in float32."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000).astype(np.uint32).view(np.float32)


def _tc_model(q, k, v, window, dp=None):
    """float64 model of the tensor-core kernel: logits rounded to float32
    and scaled into log2 units in float32, masked to -1e30 before the row
    maximum; per aligned tile of 64 keys the float32 online softmax (m, l,
    alpha by exp2), P rounded to bf16, O += P V in float32; O / l rounded
    once to bf16.  ``dp`` zero-pads the head width as the kernel's tiles do."""
    B, H, T, D = q.shape
    _, Hkv, S, _ = k.shape
    if dp is not None:
        q, k, v = (np.pad(a, ((0, 0), (0, 0), (0, 0), (0, dp - D))) for a in (q, k, v))
    c = np.float32(np.float32(D ** -0.5) * np.float32(LOG2E))
    kr, vr = (np.repeat(a, H // Hkv, axis=1).astype(np.float64) for a in (k, v))
    q = q.astype(np.float64)
    w = min(window, S)
    qpos = np.arange(T)[:, None] + (S - T)
    m = np.full((B, H, T), -1e30, np.float32)
    l = np.zeros((B, H, T), np.float32)
    acc = np.zeros((B, H, T, q.shape[-1]), np.float32)
    for j0 in range(0, S, KV_TILE):
        kt, vt = kr[:, :, j0:j0 + KV_TILE], vr[:, :, j0:j0 + KV_TILE]
        kpos = np.arange(j0, j0 + kt.shape[2])[None, :]
        ok = (kpos <= qpos) & (kpos > qpos - w)
        s = np.where(ok, (q @ kt.swapaxes(-1, -2)).astype(np.float32) * c, np.float32(-1e30))
        mx = np.maximum(m, s.max(-1))
        alpha = np.exp2((m - mx).astype(np.float64)).astype(np.float32)
        p = np.where(ok, np.exp2((s - mx[..., None]).astype(np.float64)), 0.0).astype(np.float32)
        l = alpha * l + p.sum(-1, dtype=np.float32)
        acc = acc * alpha[..., None] + (_bf16(p).astype(np.float64) @ vt).astype(np.float32)
        m = mx
    inv = np.float32(1) / np.where(l == 0, np.float32(1), l)
    return _bf16(acc * inv[..., None])[..., :D]


def _exact(q, k, v, window):
    """Causal sliding-window attention in float64, no rounding."""
    B, H, T, D = q.shape
    _, Hkv, S, _ = k.shape
    kr, vr = (np.repeat(a, H // Hkv, axis=1).astype(np.float64) for a in (k, v))
    s = q.astype(np.float64) @ kr.swapaxes(-1, -2) * D ** -0.5
    qpos, kpos = np.arange(T)[:, None] + (S - T), np.arange(S)[None, :]
    s = np.where((kpos <= qpos) & (kpos > qpos - window), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ vr


def _normwise(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _frobenius(got, want):
    return float(np.linalg.norm((got - want).ravel()) / max(np.linalg.norm(want.ravel()), 1e-30))


@pytest.mark.parametrize("i", range(len(BF16_CASES)),
                         ids=["x".join(map(str, c)) for c in BF16_CASES])
def test_bf16_tolerance_against_a_model_of_the_tensor_core_kernel(bf16_reference, i):
    B, H, Hkv, T, S, D, w = BF16_CASES[i]
    q, k, v = (bf16_reference[f"c{i}/{n}"] for n in ("q", "k", "v"))
    model = _tc_model(q, k, v, w)
    assert model.shape == (B, H, T, D) and np.isfinite(model).all()
    port = swa.swa_ref(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), window=w)
    for who, got in (("swa_pallas", bf16_reference[f"c{i}/pallas"]),
                     ("reference swa_ref", bf16_reference[f"c{i}/ref"]),
                     ("port swa_ref", port.float().numpy())):
        assert _normwise(got, model) <= TC_TOL, who
        assert _frobenius(got, model) <= TC_FRO_TOL, who
    assert _normwise(model, _exact(q, k, v, w)) <= TC_EXACT_TOL


@pytest.mark.parametrize("D", [16, 32])
def test_bf16_pad_widths_add_nothing(bf16_reference, D):
    """D 16 and 32 run in the kernel's 64-column tiles: the model with the
    inputs zero-padded to 64 equals the unpadded one bitwise."""
    i = next(j for j, c in enumerate(BF16_CASES) if c[5] == D)
    q, k, v = (bf16_reference[f"c{i}/{n}"] for n in ("q", "k", "v"))
    w = BF16_CASES[i][-1]
    padded = _tc_model(q, k, v, w, dp=64)
    assert padded.shape == q.shape and np.array_equal(padded, _tc_model(q, k, v, w))
    assert _normwise(padded, bf16_reference[f"c{i}/pallas"]) <= TC_TOL


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
    # the edges of the tensor-core kernel's tile rule, in q tiles of 64 rows and (the
    # grid filling the card's SMs) of 128
    (6, 8, 4, 333, 1000, 256, 200), (1, 2, 1, 5, 77, 64, 3), (17, 8, 4, 5, 77, 64, 3),
]
CARD_FRO_TOL = 1e-2   # bf16, relative Frobenius: TC_FRO_TOL and the kernel's own rounding


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
    n0, tc0 = swa.swa_attention_cuda.launches, swa.swa_attention_cuda.tc_launches
    got = swa.swa_attention_cuda(q, k, v, window=w)
    torch.cuda.synchronize()
    assert swa.swa_attention_cuda.launches == n0 + 1
    # the dtype alone picks the kernel, both on the tensor cores: bf16 wgmma, f32 3xTF32
    assert swa.swa_attention_cuda.tc_launches == tc0 + 1
    assert got.shape == q.shape and got.dtype == dtype and got.transpose(1, 2).is_contiguous()
    want = swa.swa_ref(q, k, v, window=w)
    tol = 1e-5 if dt == "float32" else 2e-2
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err <= tol, float(err)
    if dt == "bfloat16":
        fro = torch.linalg.vector_norm(got.float() - want.float()) / torch.linalg.vector_norm(
            want.float())
        assert fro <= CARD_FRO_TOL, float(fro)
    # contiguous (B, H, T, D) inputs, through the dispatch point
    got2 = swa.swa_attention(q.contiguous(), k.contiguous(), v.contiguous(), window=w)
    assert torch.equal(got2, got)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 4, 8])
def test_k6_bf16_views_at_any_alignment(cuda_device, offset):
    """bf16 views that start 2, 8 or 16 bytes past an aligned address (the
    wrapper copies the first two into an aligned buffer for the tensor
    maps; the third is read in place) give the output of contiguous inputs,
    bitwise."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    B, H, Hkv, T, S, D, w = 1, 4, 2, 40, 70, 32, 24

    def view(heads, n):
        buf = torch.randn(B * n * heads * D + offset, generator=g, device=cuda_device)
        return buf.to(torch.bfloat16)[offset:].view(B, n, heads, D).transpose(1, 2)

    q, k, v = view(H, T), view(Hkv, S), view(Hkv, S)
    assert q.data_ptr() % 16 == 2 * offset % 16
    got = swa.swa_attention_cuda(q, k, v, window=w)
    want = swa.swa_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), window=w)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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
