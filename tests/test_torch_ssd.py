"""The port's SSD scan (K7's plain version, the chunked and naive scans,
the decode step and ``ssd_scan``'s dispatch) against the JAX package's
``kernels/ssd``.

* ``ssd_intra_chunk_ref`` against ``ssd_intra_chunk_pallas(interpret=True)``
  at (T, L) in {(32, 8), (40, 5), (64, 16)}, G in {1, 2}, f32 and bf16
  inputs; the port takes grouped B/C and the per-head form (G = H) alike.
  Tolerances (rtol = atol): f32 2e-5 (the same float32 products summed in
  another order); bf16 y_diag 1e-2 (the two frameworks may round one
  float32 result to neighbouring bf16 values, 2^-7 apart), the f32 states
  and s 2e-5 (bf16 inputs convert exactly).
* ``ssd_ref``, ``ssd_chunked_ref``, ``ssd_decode_step`` and
  ``ssd_scan(use_kernel="ref" | "naive")``, with and without ``h0``, f32,
  to 2e-5 (the reference's own chunked-vs-naive check allows 2e-4).
* On a CPU tensor ``auto`` runs the plain version and ``cuda`` raises; the
  ``cuda``-marked tests hold K7 against its plain version on the card, every
  launch on the tensor cores (``by_kernel``, the kernel the C entry point
  reported: bf16 with N and P multiples of 8 on wgmma, the rest in 3xTF32),
  from views that TMA reads as they are
  and from odd-width ones the wrapper copies; the 3xTF32 kernel's bf16 form
  (where the rule refuses wgmma) gives bitwise the f32 result of the same
  values, rounded.

The reference runs once in a module-scoped child process; arrays travel as
``.npy`` files made from a numpy seed.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _mp import run  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd_kernel_mod  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"

BA, H, P, N = 2, 4, 8, 16
K7_CASES = [(T, L, G, dt) for T, L in ((32, 8), (40, 5), (64, 16)) for G in (1, 2)
            for dt in ("float32", "bfloat16")]
# T, chunk requested, G, with h0
SCAN_CASES = [(32, 8, 1, False), (32, 8, 2, True), (40, 16, 2, True), (17, 64, 1, False)]
TOL = {"float32": 2e-5, "bfloat16": 1e-2}
F32 = 2e-5

REFERENCE = ALIAS + """
from repro.kernels.ssd.kernel import ssd_intra_chunk_pallas
from repro.kernels.ssd import ops, ref as R

TMP = {tmp!r}
def load(name, dt="float32"):
    return jnp.asarray(np.load(f"{{TMP}}/{{name}}.npy")).astype(dt)

for i, (T, L, G, dt) in enumerate({k7!r}):
    x, B, C = (load(f"k7_{{n}}_{{i}}", dt) for n in "xBC")
    dtv, A = load(f"k7_dt_{{i}}"), load(f"k7_A_{{i}}")
    rep = x.shape[2] // G
    y, st, s = ssd_intra_chunk_pallas(x, dtv, A, jnp.repeat(B, rep, axis=2),
                                      jnp.repeat(C, rep, axis=2), chunk=L, interpret=True)
    assert y.dtype == x.dtype and st.dtype == jnp.float32 and s.dtype == jnp.float32
    for n, v in (("y", y), ("st", st), ("s", s)):
        np.save(f"{{TMP}}/k7_out_{{n}}_{{i}}.npy", np.asarray(v.astype(jnp.float32)))

for i, (T, chunk, G, with_h0) in enumerate({scans!r}):
    x, dtv, A, B, C = (load(f"sc_{{n}}_{{i}}") for n in ("x", "dt", "A", "B", "C"))
    h0 = load(f"sc_h0_{{i}}") if with_h0 else None
    outs = {{"naive": R.ssd_ref(x, dtv, A, B, C, h0=h0),
             "scan_ref": ops.ssd_scan(x, dtv, A, B, C, chunk=chunk, use_kernel="ref", h0=h0),
             "scan_naive": ops.ssd_scan(x, dtv, A, B, C, chunk=chunk, use_kernel="naive", h0=h0)}}
    if T % chunk == 0:
        outs["chunked"] = R.ssd_chunked_ref(x, dtv, A, B, C, chunk=chunk, h0=h0)
    for k, (y, h) in outs.items():
        np.save(f"{{TMP}}/sc_{{k}}_y_{{i}}.npy", np.asarray(y))
        np.save(f"{{TMP}}/sc_{{k}}_h_{{i}}.npy", np.asarray(h))
    # one decode step from the prefix state, token T-1
    _, hp = R.ssd_ref(x[:, :-1], dtv[:, :-1], A, B[:, :-1], C[:, :-1], h0=h0)
    yt, ht = R.ssd_decode_step(hp, x[:, -1], dtv[:, -1], A, B[:, -1], C[:, -1])
    np.save(f"{{TMP}}/sc_dec_y_{{i}}.npy", np.asarray(yt))
    np.save(f"{{TMP}}/sc_dec_h_{{i}}.npy", np.asarray(ht))
print("OK")
"""


def _bf16_exact(a):
    """float32 values that bf16 holds exactly (both sides cast without rounding)."""
    return torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()


def _make(rng, T, G):
    x = rng.randn(BA, T, H, P).astype(np.float32)
    dt = (rng.rand(BA, T, H) * 0.2 + 0.01).astype(np.float32)
    A = (-np.abs(rng.rand(H)) - 0.1).astype(np.float32)
    B = (rng.randn(BA, T, G, N) * 0.4).astype(np.float32)
    C = (rng.randn(BA, T, G, N) * 0.4).astype(np.float32)
    return x, dt, A, B, C


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_ssd")
    rng = np.random.RandomState(0)
    for i, (T, L, G, dt) in enumerate(K7_CASES):
        x, d, A, B, C = _make(rng, T, G)
        for n, v in (("x", _bf16_exact(x)), ("dt", d), ("A", A), ("B", _bf16_exact(B)),
                     ("C", _bf16_exact(C))):
            np.save(tmp / f"k7_{n}_{i}.npy", v)
    for i, (T, chunk, G, with_h0) in enumerate(SCAN_CASES):
        for n, v in zip(("x", "dt", "A", "B", "C"), _make(rng, T, G)):
            np.save(tmp / f"sc_{n}_{i}.npy", v)
        np.save(tmp / f"sc_h0_{i}.npy", (rng.randn(BA, H, N, P) * 0.3).astype(np.float32))
    run(REFERENCE.format(tmp=str(tmp), k7=K7_CASES, scans=SCAN_CASES), ndev=1)
    return tmp


def _load(tmp, name, dtype=torch.float32):
    return torch.from_numpy(np.load(tmp / f"{name}.npy")).to(dtype)


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("i", range(len(K7_CASES)),
                         ids=[f"T{T}-L{L}-G{G}-{dt}" for T, L, G, dt in K7_CASES])
def test_intra_chunk_ref_vs_pallas_interpret(reference, i):
    T, L, G, dt = K7_CASES[i]
    dtype = getattr(torch, dt)
    x, B, C = (_load(reference, f"k7_{n}_{i}", dtype) for n in "xBC")
    dtv, A = _load(reference, f"k7_dt_{i}"), _load(reference, f"k7_A_{i}")
    rep = H // G
    for form, (b, c) in (("grouped", (B, C)),
                         ("per-head", (B.repeat_interleave(rep, 2), C.repeat_interleave(rep, 2)))):
        y, st, s = ssd.ssd_intra_chunk_ref(x, dtv, A, b, c, chunk=L)
        assert y.dtype == dtype and st.dtype == torch.float32 and s.dtype == torch.float32
        assert y.shape == (BA, T, H, P) and st.shape == (BA, T // L, H, N, P)
        assert s.shape == (BA, T // L, L, H)
        _close(y, np.load(reference / f"k7_out_y_{i}.npy"), TOL[dt], f"{form} y_diag")
        _close(st, np.load(reference / f"k7_out_st_{i}.npy"), F32, f"{form} states")
        _close(s, np.load(reference / f"k7_out_s_{i}.npy"), F32, f"{form} s")


@pytest.mark.parametrize("i", range(len(SCAN_CASES)),
                         ids=[f"T{T}-c{c}-G{G}-h0{h}" for T, c, G, h in SCAN_CASES])
def test_scans_and_decode_vs_reference(reference, i):
    T, chunk, G, with_h0 = SCAN_CASES[i]
    x, dtv, A, B, C = (_load(reference, f"sc_{n}_{i}") for n in ("x", "dt", "A", "B", "C"))
    h0 = _load(reference, f"sc_h0_{i}") if with_h0 else None
    outs = {"naive": ssd.ssd_ref(x, dtv, A, B, C, h0=h0),
            "scan_ref": ssd.ssd_scan(x, dtv, A, B, C, chunk=chunk, use_kernel="ref", h0=h0),
            "scan_naive": ssd.ssd_scan(x, dtv, A, B, C, chunk=chunk, use_kernel="naive", h0=h0),
            "scan_auto": ssd.ssd_scan(x, dtv, A, B, C, chunk=chunk, h0=h0)}
    if T % chunk == 0:
        outs["chunked"] = ssd.ssd_chunked_ref(x, dtv, A, B, C, chunk=chunk, h0=h0)
    for k, (y, h) in outs.items():
        want = "scan_ref" if k == "scan_auto" else k   # auto on a CPU tensor: the plain scan
        _close(y, np.load(reference / f"sc_{want}_y_{i}.npy"), F32, f"{k} y")
        _close(h, np.load(reference / f"sc_{want}_h_{i}.npy"), F32, f"{k} h")
    _, hp = ssd.ssd_ref(x[:, :-1], dtv[:, :-1], A, B[:, :-1], C[:, :-1], h0=h0)
    yt, ht = ssd.ssd_decode_step(hp, x[:, -1], dtv[:, -1], A, B[:, -1], C[:, -1])
    _close(yt, np.load(reference / f"sc_dec_y_{i}.npy"), F32, "decode y")
    _close(ht, np.load(reference / f"sc_dec_h_{i}.npy"), F32, "decode h")
    # the decode step continues the scan: its state is the full scan's
    _close(ht, outs["naive"][1].numpy(), F32, "decode h vs scan")


def test_chunk_choice_is_the_reference_rule():
    assert [ssd.pick_chunk(T, 64) for T in (2048, 1000, 20, 1, 7, 128)] == [64, 50, 20, 1, 7, 64]
    assert [ssd.pick_chunk(T, 8) for T in (20, 17, 12)] == [5, 1, 6]


def test_auto_on_cpu_is_plain_and_cuda_raises():
    rng = np.random.RandomState(3)
    x, dt, A, B, C = (torch.from_numpy(a) for a in _make(rng, 16, 2))
    y0, h0 = ssd.ssd_scan(x, dt, A, B, C, chunk=8)
    y1, h1 = ssd.ssd_chunked_ref(x, dt, A, B, C, chunk=8)
    assert torch.equal(y0, y1) and torch.equal(h0, h1)
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan(x, dt, A, B, C, chunk=8, use_kernel="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_intra_chunk_cuda(x, dt, A, B, C, chunk=8)
    with pytest.raises(ValueError, match="use_kernel"):
        ssd.ssd_scan(x, dt, A, B, C, chunk=8, use_kernel="pallas")


# ---------------------------------------------------------------------------
# on the card: K7 against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CARD_CASES = [  # Ba, T, H, G, N, P, L
    (2, 32, 4, 1, 16, 8, 8), (2, 40, 4, 2, 16, 8, 5), (1, 64, 8, 2, 128, 64, 64),
    (2, 1000, 4, 1, 128, 64, 50), (1, 7, 2, 1, 8, 4, 1), (1, 24, 4, 4, 32, 16, 3),
    (2, 7, 4, 1, 16, 8, 1), (2, 256, 64, 1, 128, 64, 64), (1, 200, 8, 2, 128, 64, 50),
    (1, 64, 4, 1, 120, 56, 16), (1, 40, 2, 1, 12, 8, 8),
]


def _card_inputs(case, dtype, width, dev):
    """x, dt, A, B, C with x, B, C strided slices of one projection, as the
    Mamba layer passes them; its row is a multiple of 8 elements ("aligned",
    the layer's case) or 3 more ("odd")."""
    Ba, T, H_, G, N_, P_, L = case
    g = torch.Generator(device=dev).manual_seed(1)
    w = H_ * P_ + 2 * G * N_
    zx = torch.randn(Ba, T, (w + 7) // 8 * 8 if width == "aligned" else w + 3, generator=g,
                     device=dev).to(dtype)
    x = zx[..., :H_ * P_].view(Ba, T, H_, P_)
    B = zx[..., H_ * P_:H_ * P_ + G * N_].view(Ba, T, G, N_)
    C = zx[..., H_ * P_ + G * N_:w].view(Ba, T, G, N_)
    dtv = torch.rand(Ba, T, H_, generator=g, device=dev) * 0.2 + 0.01
    A = -torch.rand(H_, generator=g, device=dev) - 0.1
    return x, dtv, A, B, C


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["aligned", "odd"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_k7_vs_plain_on_card(cuda_device, case, dt, width):
    Ba, T, H_, G, N_, P_, L = case
    dtype = getattr(torch, dt)
    x, dtv, A, B, C = _card_inputs(case, dtype, width, cuda_device)
    n0, b0 = ssd.ssd_intra_chunk_cuda.launches, dict(ssd.ssd_intra_chunk_cuda.by_kernel)
    got = ssd.ssd_intra_chunk_cuda(x, dtv, A, B, C, chunk=L)
    torch.cuda.synchronize()
    assert ssd.ssd_intra_chunk_cuda.launches == n0 + 1
    ran = "wgmma" if dtype == torch.bfloat16 and N_ % 8 == 0 and P_ % 8 == 0 else "3xTF32"
    assert ssd_kernel_mod.kernel_for(dtype, N_, P_) == ran
    assert {k: n - b0[k] for k, n in ssd.ssd_intra_chunk_cuda.by_kernel.items()} == \
        {k: int(k == ran) for k in ssd_kernel_mod.KERNELS}
    want = ssd.ssd_intra_chunk_ref(x, dtv, A, B, C, chunk=L)
    for name, a, b in zip(("y_diag", "states", "s"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        tol = 1e-2 if (name == "y_diag" and dt == "bfloat16") else 1e-5
        scale = b.float().abs().max().clamp_min(1.0)
        err = (a.float() - b.float()).abs().max() / scale
        assert err <= tol, (name, float(err))
    # the full scan through K7 against the chunked plain scan
    y, h = ssd.ssd_scan(x, dtv, A, B, C, chunk=L, use_kernel="cuda")
    y0, h0 = ssd.ssd_scan(x, dtv, A, B, C, chunk=L, use_kernel="ref")
    tol = 2e-2 if dt == "bfloat16" else 1e-5
    for a, b in ((y, y0), (h, h0)):
        assert ((a.float() - b.float()).abs().max() / b.float().abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in CARD_CASES if c[5] % 8 or c[4] % 8],
                         ids=lambda c: "x".join(map(str, c)))
def test_k7_cuda_core_kernel_is_one_arithmetic(cuda_device, case):
    """f32 runs the 3xTF32 kernel on the tensor cores, deterministically;
    where the rule keeps bf16 off wgmma, its 3xTF32 launch gives bitwise the
    f32 launch's states on the same (upcast) values, and its y_diag
    rounded."""
    L = case[-1]
    x, dtv, A, B, C = _card_inputs(case, torch.bfloat16, "aligned", cuda_device)
    assert ssd_kernel_mod.kernel_for(torch.bfloat16, case[4], case[5]) == "3xTF32"
    t0 = ssd.ssd_intra_chunk_cuda.by_kernel["3xTF32"]
    y16, st16, _ = ssd.ssd_intra_chunk_cuda(x, dtv, A, B, C, chunk=L)
    up = [t.float() for t in (x, B, C)]
    y32, st32, _ = ssd.ssd_intra_chunk_cuda(up[0], dtv, A, up[1], up[2], chunk=L)
    y32b, st32b, _ = ssd.ssd_intra_chunk_cuda(up[0], dtv, A, up[1], up[2], chunk=L)
    torch.cuda.synchronize()
    assert ssd.ssd_intra_chunk_cuda.by_kernel["3xTF32"] == t0 + 3
    assert torch.equal(y32, y32b) and torch.equal(st32, st32b)
    assert torch.equal(st16, st32) and torch.equal(y16, y32.bfloat16())


@pytest.mark.cuda
def test_k7_raises_on_what_it_does_not_take(cuda_device):
    def mk(T=16, H_=2, G=1, N_=16, P_=8, dtype=torch.float32):
        return (torch.zeros(1, T, H_, P_, dtype=dtype, device=cuda_device),
                torch.zeros(1, T, H_, device=cuda_device), torch.zeros(H_, device=cuda_device),
                torch.zeros(1, T, G, N_, dtype=dtype, device=cuda_device),
                torch.zeros(1, T, G, N_, dtype=dtype, device=cuda_device))
    for args, chunk, match in ((mk(T=128), 128, "chunk"), (mk(), 5, "chunk"),
                               (mk(N_=256), 8, "N <="), (mk(P_=6), 8, "P"),
                               (mk(dtype=torch.float64), 8, "dtype"), (mk(G=3, H_=4), 8, "shapes")):
        with pytest.raises(ValueError, match=match):
            ssd_kernel_mod.ssd_intra_chunk_cuda(*args, chunk=chunk)
