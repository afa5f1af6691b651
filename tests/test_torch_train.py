"""The port's training path on the CPU against the JAX package: the chunked
loss, K6's backward (plain version), the data and the Trainer (the train
step against the reference's: ``test_torch_train_step.py``).

The reference runs once, in a child process, for:

* ``cross_entropy_chunked`` with labels -100, a padded vocab, a soft cap,
  a chunk that divides T and one that does not (the whole-T fall-back):
  the value to 1e-6 relative, the gradients of h and of the output matrix
  to 1e-5 normwise;
* ``jax.grad`` of its ``kernels/swa/ref.py::swa_ref`` with GQA, a window
  below T and ragged T: ``swa_backward_ref`` to 1e-5 normwise (and to
  autograd of the port's ``swa_ref`` to 1e-5).

The Trainer's scenarios are the reference's
(``tests/test_fault_tolerance.py:42,63``, ``tests/test_substrate.py``),
plus a resume that is bitwise on the CPU.  K6's autograd route and the
raises of the CUDA routes are exercised with the wrappers replaced by
counting plain versions.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _mp import run  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import llama3_2_1b, mamba2_1p3b  # noqa: E402
from repro_torch.data import SyntheticLMData, batch_specs, synthetic_batch  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.swa import ops as swa_ops  # noqa: E402
from repro_torch.kernels.swa import swa_backward_ref, swa_ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.train import TrainCfg, Trainer, make_train_step, value_and_grad  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"
CFG = dataclasses.replace(llama3_2_1b.SMOKE, dtype="float32")
XENT_CASES = (  # B, T, d, V, n_valid, chunk, softcap
    (2, 12, 16, 64, 50, 4, 0.0), (2, 12, 16, 64, 50, 5, 0.0), (3, 8, 8, 40, 40, 8, 3.0),
    (2, 10, 16, 64, 57, 512, 2.0))
SWA_CASES = (  # B, H, Hkv, T, S, D, window
    (2, 4, 2, 13, 13, 8, 5), (1, 6, 2, 9, 20, 16, 7), (2, 4, 1, 33, 33, 4, 33))

REFERENCE = ALIAS + """
from repro.kernels.swa.ref import swa_ref
from repro.models.layers import cross_entropy_chunked

TMP = {tmp!r}
xin = np.load(TMP + "/xent_in.npz")
out = dict()
for i, (B, T, d, V, nv, chunk, cap) in enumerate({xent!r}):
    h, w, lab = (jnp.asarray(xin["%s%d" % (n, i)]) for n in ("h", "w", "l"))
    f = lambda h, w: cross_entropy_chunked(h, w, lab, chunk=chunk, logit_softcap=cap,
                                           n_valid=nv)
    val, (gh, gw) = jax.value_and_grad(f, argnums=(0, 1))(h, w)
    out["val%d" % i], out["gh%d" % i], out["gw%d" % i] = (np.asarray(x) for x in (val, gh, gw))
np.savez(TMP + "/xent_out.npz", **out)

sin = np.load(TMP + "/swa_in.npz")
out = dict()
for i, (B, H, Hkv, T, S, D, w) in enumerate({swa!r}):
    q, k, v, do = (jnp.asarray(sin["%s%d" % (n, i)]) for n in ("q", "k", "v", "do"))
    o, vjp = jax.vjp(lambda q, k, v: swa_ref(q, k, v, window=w), q, k, v)
    out["dq%d" % i], out["dk%d" % i], out["dv%d" % i] = (np.asarray(x) for x in vjp(do))
np.savez(TMP + "/swa_out.npz", **out)

print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_train")
    rng = np.random.RandomState(21)
    xin = {}
    for i, (B, T, d, V, nv, chunk, cap) in enumerate(XENT_CASES):
        xin[f"h{i}"] = rng.randn(B, T, d).astype(np.float32)
        xin[f"w{i}"] = (rng.randn(d, V) * 0.5).astype(np.float32)
        lab = rng.randint(0, nv, (B, T))
        lab[0, :3] = -100
        lab[-1, -1] = -100
        xin[f"l{i}"] = lab.astype(np.int32)
    np.savez(tmp / "xent_in.npz", **xin)
    sin = {}
    for i, (B, H, Hkv, T, S, D, w) in enumerate(SWA_CASES):
        for n, shape in (("q", (B, H, T, D)), ("k", (B, Hkv, S, D)), ("v", (B, Hkv, S, D)),
                         ("do", (B, H, T, D))):
            sin[f"{n}{i}"] = rng.randn(*shape).astype(np.float32)
    np.savez(tmp / "swa_in.npz", **sin)
    run(REFERENCE.format(tmp=str(tmp), xent=XENT_CASES, swa=SWA_CASES), ndev=1)
    return tmp, xin, sin


def _normwise(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.linalg.norm((got - want).ravel())
    assert err <= rtol * np.linalg.norm(want.ravel()) + 1e-12, (what, err, np.linalg.norm(want))


# ---------------------------------------------------------------------------
# the chunked loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(XENT_CASES)))
def test_cross_entropy_chunked_matches_the_reference(reference, i):
    tmp, xin, _ = reference
    want = np.load(tmp / "xent_out.npz")
    B, T, d, V, nv, chunk, cap = XENT_CASES[i]
    h = torch.from_numpy(xin[f"h{i}"]).requires_grad_(True)
    w = torch.from_numpy(xin[f"w{i}"]).requires_grad_(True)
    lab = torch.from_numpy(xin[f"l{i}"])
    val = layers.cross_entropy_chunked(h, w, lab, chunk=chunk, logit_softcap=cap, n_valid=nv)
    assert val.dtype == torch.float32 and val.shape == ()
    np.testing.assert_allclose(float(val.detach()), float(want[f"val{i}"]), rtol=1e-6)
    gh, gw = torch.autograd.grad(val, (h, w))
    _normwise(gh, want[f"gh{i}"], 1e-5, "dh")
    _normwise(gw, want[f"gw{i}"], 1e-5, "dw")


def test_cross_entropy_recomputes_each_chunk_in_the_backward(monkeypatch):
    """Each chunk's logits come from one call in the forward and one more in
    the backward (checkpointed), and the loss ignores -100 labels."""
    calls = []
    real = layers._chunk_xent

    def counted(hb, *a):
        calls.append(hb.shape[1])
        return real(hb, *a)

    monkeypatch.setattr(layers, "_chunk_xent", counted)
    g = torch.Generator().manual_seed(0)
    h = torch.randn(2, 12, 8, generator=g, requires_grad=True)
    w = torch.randn(8, 20, generator=g)
    lab = torch.randint(0, 20, (2, 12), generator=g)
    val = layers.cross_entropy_chunked(h, w, lab, chunk=4)
    assert calls == [4, 4, 4]
    val.backward()
    assert calls == [4, 4, 4] * 2
    all_ignored = layers.cross_entropy_chunked(h, w, torch.full_like(lab, -100), chunk=4)
    assert float(all_ignored.detach()) == 0.0


# ---------------------------------------------------------------------------
# K6's backward, plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(SWA_CASES)))
def test_swa_backward_ref_matches_jax_grad_and_autograd(reference, i):
    tmp, _, sin = reference
    want = np.load(tmp / "swa_out.npz")
    B, H, Hkv, T, S, D, w = SWA_CASES[i]
    q, k, v, do = (torch.from_numpy(sin[f"{n}{i}"]) for n in ("q", "k", "v", "do"))
    got = swa_backward_ref(q, k, v, do, window=w)
    for name, g in zip(("dq", "dk", "dv"), got):
        _normwise(g, want[f"{name}{i}"], 1e-5, name)
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    auto = torch.autograd.grad(swa_ref(qa, ka, va, window=w), (qa, ka, va), do)
    for name, g, a in zip(("dq", "dk", "dv"), got, auto):
        _normwise(g, a, 1e-5, name)


class _Counting:
    """K6's wrappers replaced by plain versions that count their calls."""

    def __init__(self):
        self.fwd = self.bwd = 0

    def attention(self, q, k, v, *, window, scale=None, return_lse=False):
        self.fwd += 1
        o = swa_ref(q, k, v, window=window, scale=scale)
        if not return_lse:
            return o
        D, g = q.shape[-1], q.shape[1] // k.shape[1]
        s = (D ** -0.5) if scale is None else scale
        logits = torch.einsum("bhtd,bhsd->bhts", q * s, torch.repeat_interleave(k, g, 1))
        T, S = q.shape[2], k.shape[2]
        qpos = torch.arange(T)[:, None] + (S - T)
        kpos = torch.arange(S)[None, :]
        mask = (kpos <= qpos) & (kpos > qpos - window)
        return o, torch.logsumexp(torch.where(mask, logits, -torch.inf), dim=-1)

    def backward(self, q, k, v, o, do, lse, *, window, scale=None):
        self.bwd += 1
        assert lse.shape == q.shape[:3] and o.shape == q.shape
        return swa_backward_ref(q, k, v, do, window=window, scale=scale)


def _cuda_resolve(use_kernel, x, where=""):
    return "ref" if use_kernel == "ref" else "cuda"


@pytest.fixture
def cuda_route(monkeypatch):
    """``dispatch.resolve`` says "cuda" (but "ref" for "ref"), and K6's
    wrappers are the counting plain versions."""
    monkeypatch.setattr(dispatch, "resolve", _cuda_resolve)
    fake = _Counting()
    monkeypatch.setattr(swa_ops, "swa_attention_cuda", fake.attention)
    monkeypatch.setattr(swa_ops, "swa_backward_cuda", fake.backward)
    return fake


def test_k6_autograd_route_gives_the_plain_gradients(cuda_route):
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 4, 11, 8, generator=g, requires_grad=True)
    k = torch.randn(2, 2, 11, 8, generator=g, requires_grad=True)
    v = torch.randn(2, 2, 11, 8, generator=g, requires_grad=True)
    do = torch.randn(2, 4, 11, 8, generator=g)
    o = swa_ops.swa_attention(q, k, v, window=4)
    assert (cuda_route.fwd, cuda_route.bwd) == (1, 0) and o.grad_fn is not None
    got = torch.autograd.grad(o, (q, k, v), do)
    assert (cuda_route.fwd, cuda_route.bwd) == (1, 1)
    want = torch.autograd.grad(swa_ref(q, k, v, window=4), (q, k, v), do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    with torch.no_grad():   # no gradient wanted: the forward alone, no LSE
        swa_ops.swa_attention(q, k, v, window=4)
    assert (cuda_route.fwd, cuda_route.bwd) == (2, 1)
    with pytest.raises(NotImplementedError, match="float32"):
        swa_ops.swa_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), window=4)


@pytest.mark.parametrize("remat, per_layer", (("full", 2), ("dots", 2), ("none", 1)))
def test_k6_launches_per_step_under_each_remat(cuda_route, remat, per_layer):
    """A checkpointed layer runs K6's forward again in the backward: two
    forward launches a layer under "full" and "dots" (K6 is no matmul),
    one under "none"; one backward launch a layer."""
    params = tf.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    batch = synthetic_batch(SyntheticLMData(CFG.vocab, 2, 16, device="cpu"), 0)
    step = make_train_step(CFG, TrainCfg(remat=remat, warmup=1, total_steps=5))
    _, _, m = step(params, optim.init(params, optim.AdamWCfg(),
                                      layout=tf.reference_layout(CFG)), batch)
    assert np.isfinite(float(m["loss"]))
    assert (cuda_route.fwd, cuda_route.bwd) == (per_layer * CFG.n_layers, CFG.n_layers)


def test_mamba_training_on_the_cuda_route_raises(monkeypatch):
    """K7's autograd route: a Mamba layer that trains on the CUDA route goes
    through ``_SsdCuda`` (K7's forward and backward, here their counting
    plain versions), with the gradients of use_kernel="ref"; bfloat16 with
    gradients wanted raises, naming float32 (the backward kernel's type)."""
    from repro_torch.kernels.ssd import kernel as kssd
    from repro_torch.kernels.ssd import ssd_intra_chunk_backward_ref, ssd_intra_chunk_ref

    cfg = dataclasses.replace(mamba2_1p3b.SMOKE, dtype="float32")
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = synthetic_batch(SyntheticLMData(cfg.vocab, 2, 16, device="cpu"), 0)
    n = {"fwd": 0, "bwd": 0}

    def fwd(*a, s=None, **k):   # the plain version recomputes s
        n["fwd"] += 1
        return ssd_intra_chunk_ref(*a, **k)

    def bwd(*a):
        n["bwd"] += 1
        return ssd_intra_chunk_backward_ref(*a)

    monkeypatch.setattr(dispatch, "resolve", _cuda_resolve)
    monkeypatch.setattr(kssd, "ssd_intra_chunk_cuda", fwd)
    monkeypatch.setattr(kssd, "ssd_backward_cuda", bwd)
    tcfg = TrainCfg(remat="none")
    loss, _, got = value_and_grad(params, cfg, tcfg, batch)
    assert n == {"fwd": cfg.n_layers, "bwd": cfg.n_layers}
    want_loss, _, want = value_and_grad(params, cfg, dataclasses.replace(tcfg, use_kernel="ref"),
                                        batch)
    assert n == {"fwd": cfg.n_layers, "bwd": cfg.n_layers}
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=0)
    for k in want:
        _normwise(got[k], want[k].numpy(), 1e-5, k)
    bf = {k: v.bfloat16().requires_grad_(True) for k, v in params.items()}
    with pytest.raises(NotImplementedError, match="float32"):
        tf.loss_fn(bf, dataclasses.replace(cfg, dtype="bfloat16"), batch)


# ---------------------------------------------------------------------------
# the data
# ---------------------------------------------------------------------------

def test_data_determinism_and_shift():
    """The reference's ``test_data_determinism_and_shift`` on the port."""
    d = SyntheticLMData(vocab=100, batch=4, seq=16, seed=3, device="cpu")
    b1, b2, b3 = d.batch_at(7), d.batch_at(torch.tensor(7)), d.batch_at(8)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert torch.equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])
    assert bool((b1["labels"][:, -1] == -100).all())
    assert int(b1["tokens"].max()) < 100
    assert not torch.equal(SyntheticLMData(100, 4, 16, seed=4, device="cpu").batch_at(7)["tokens"],
                           b1["tokens"])


@pytest.mark.parametrize("vocab, batch, seq, step", ((100, 1, 2, 0), (3000, 4, 33, 1 << 20),
                                                    (517, 3, 17, 12345), (128, 2, 9, 999)))
def test_data_pipeline_pure_function_of_step(vocab, batch, seq, step):
    """The reference's property (``tests/test_property.py:119``) at fixed
    draws, and the distribution's copy structure."""
    d = SyntheticLMData(vocab=vocab, batch=batch, seq=seq, seed=1, device="cpu")
    b1, b2 = d.batch_at(step), d.batch_at(step)
    assert torch.equal(b1["tokens"], b2["tokens"])
    t = b1["tokens"]
    assert t.shape == (batch, seq) and int(t.min()) >= 0 and int(t.max()) < vocab
    assert torch.equal(b1["labels"][:, :-1], t[:, 1:])
    specs = batch_specs(CFG, batch, seq)
    assert {k: (v.shape, v.dtype) for k, v in specs.items()} == {
        k: (v.shape, v.dtype) for k, v in b1.items()}


def test_data_statistics():
    """Half the tokens are the previous *drawn* token + 1, as in the
    reference, so a quarter follow the previous token of the batch (whose
    own draw was kept); the draws favour small ids (squared uniform: mean
    (V - 1) / 3)."""
    b = SyntheticLMData(vocab=1000, batch=64, seq=256, seed=0, device="cpu").batch_at(0)
    t = b["tokens"]
    copies = (t[:, 1:] == (t[:, :-1] + 1) % 1000).float().mean()
    assert 0.22 < float(copies) < 0.29
    assert float(t.float().mean()) < 999 / 2


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def _toy(**tcfg):
    tcfg = TrainCfg(opt=optim.AdamWCfg(lr=1e-3), **{**dict(warmup=2, total_steps=50), **tcfg})
    params = tf.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    opt = optim.init(params, tcfg.opt, layout=tf.reference_layout(CFG))
    data = SyntheticLMData(vocab=CFG.vocab, batch=4, seq=16, seed=0, device="cpu")
    return params, opt, make_train_step(CFG, tcfg), data


def test_nan_guard_skips_update():
    """The reference's ``test_nan_guard_skips_update``: a poisoned step is
    left out of the history, its update skipped, the count reset after."""
    params, opt, step, data = _toy()
    calls = {"n": 0}
    seen = []

    def poisoned_step(p, o, b):
        calls["n"] += 1
        seen.append(p)
        np_, no_, m = step(p, o, b)
        if calls["n"] == 3:
            m = dict(m, loss=torch.tensor(float("nan")))
        return np_, no_, m

    tr = Trainer(cfg=CFG, train_step=poisoned_step, data=data, ckpt_dir=None, log_every=100,
                 max_bad_steps=5)
    _, o2, hist = tr.run(params, opt, 6)
    assert len(hist) == 5 and all(np.isfinite(hist))
    assert tr.bad_steps == 0
    assert seen[3] is seen[2]   # the step after the poisoned one sees the same params
    assert int(o2["step"]) == 5


def test_max_bad_steps_aborts():
    params, opt, step, data = _toy()

    def nan_step(p, o, b):
        np_, no_, m = step(p, o, b)
        return np_, no_, dict(m, loss=torch.tensor(float("nan")))

    tr = Trainer(cfg=CFG, train_step=nan_step, data=data, max_bad_steps=3, log_every=100)
    with pytest.raises(RuntimeError, match="non-finite"):
        tr.run(params, opt, 5)
    assert tr.bad_steps == 3


def test_watchdog_flags_straggler(tmp_path):
    """The reference's ``test_watchdog_flags_straggler``; with a checkpoint
    directory the straggler also triggers an early checkpoint.  The sixth
    step sleeps 1.5 s, or three times the slowest step measured after the
    first where that is longer (the EWMA the watchdog holds it against is
    never above that step, so a loaded machine cannot hide the straggler)."""
    params, opt, step, data = _toy()
    calls = {"n": 0}

    def slow_step(p, o, b):
        calls["n"] += 1
        out = step(p, o, b)
        if calls["n"] == 6:
            time.sleep(max(1.5, 3 * max(tr.step_s[1:])))
        return out

    tr = Trainer(cfg=CFG, train_step=slow_step, data=data, ckpt_dir=str(tmp_path),
                 ckpt_every=1000, log_every=100, straggler_factor=2.0)
    tr.run(params, opt, 8)
    assert tr.straggler_events >= 1
    assert (tmp_path / "step_00000005").is_dir() and (tmp_path / "step_00000008").is_dir()


@pytest.mark.parametrize("moments", ("float32", "bfloat16", "int8"))
def test_train_step_and_trainer_smoke(tmp_path, moments):
    """The reference's ``test_train_step_and_trainer_smoke`` (25 steps,
    grad_accum 2, the loss falls, resume at 25), with each moment kind."""
    tcfg = TrainCfg(opt=optim.AdamWCfg(lr=1e-3, moments=moments), grad_accum=2, remat="full",
                    warmup=5, total_steps=100)
    params = tf.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    opt = optim.init(params, tcfg.opt, layout=tf.reference_layout(CFG))
    data = SyntheticLMData(vocab=CFG.vocab, batch=4, seq=16, seed=0, device="cpu")
    tr = Trainer(cfg=CFG, train_step=make_train_step(CFG, tcfg), data=data,
                 ckpt_dir=str(tmp_path), ckpt_every=10, log_every=100)
    p2, o2, hist = tr.run(params, opt, 25)
    assert len(hist) == 25 and hist[-1] < hist[0], (hist[0], hist[-1])
    p3, o3, s3 = tr.restore_or_init(params, opt)
    assert s3 == 25 and int(o3["step"]) == 25
    assert all(torch.equal(p3[k], p2[k]) for k in p2)
    dtypes = lambda t: {k: dtypes(v) for k, v in t.items()} if isinstance(t, dict) else t.dtype
    assert dtypes(o3) == dtypes(o2)


def test_resume_is_bitwise_on_the_cpu(tmp_path):
    """Ten steps, a checkpoint, a new Trainer that resumes to 15: the same
    losses and parameters as fifteen steps without a stop, bit for bit."""
    params, opt, step, data = _toy()
    pf, of, hist = Trainer(cfg=CFG, train_step=step, data=data, log_every=100).run(
        params, opt, 15)
    tr = Trainer(cfg=CFG, train_step=step, data=data, ckpt_dir=str(tmp_path), log_every=100)
    _, _, h1 = tr.run(params, opt, 10)
    tr2 = Trainer(cfg=CFG, train_step=step, data=data, ckpt_dir=str(tmp_path), log_every=100)
    p, o, s0 = tr2.restore_or_init(params, opt)
    assert s0 == 10
    pr, orr, h2 = tr2.run(p, o, 5, step0=s0)
    assert h1 + h2 == hist
    assert all(torch.equal(pr[k], pf[k]) for k in pf)
    assert all(torch.equal(orr["m"][k], of["m"][k]) and torch.equal(orr["v"][k], of["v"][k])
               for k in pf)
