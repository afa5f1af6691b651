"""The port's sequence-parallel operators (``repro_torch.distributed.seqpar``,
``ring``, ``pipeline``) on 4 processes of a gloo group against the JAX
package's ``shard_map`` versions over a 4-device mesh, on the same numpy
inputs made from a seed.

The reference runs once, in a module-scoped child process
(``tests/_mp.py::run``; the cases of ``tests/test_distributed.py`` and
``tests/test_pipeline.py`` over a 4-wide axis).  The port runs once in 4
processes (``tests/_dist.py::spawn``), each returning its shards.
Tolerances are the reference tests': conv halo 1e-5, sliding-window and
ring attention 2e-5, ``lse_combine_decode`` 2e-5, GPipe 1e-5 (tanh stages)
and 2e-5 (transformer stages).  ``seq_ssd_scan``'s y and the last rank's
state are held at 3e-4 against the reference's whole-sequence ``ssd_ref``:
the reference's own sharded scan raises a ``ShardingTypeError`` inside its
``shard_map`` on jax 0.9 (ROADMAP.md F18), and its test means to compare
with ``ssd_ref``.  Without a group (world 1) each operator equals its
whole-sequence form; the raises: a halo wider than the shard, a window
wider than the shard, a bfloat16 ring, an axis the port cannot map.  The
gradient of the sharded conv (through ``comm.shift``'s autograd) equals
the whole sequence's.  Under an analyzer check the group's ring attention
is clean (every shift recorded with its peers and paired), and the
congruence rule flags a shift whose partner expects another rank.
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
from repro_torch import analysis, convert  # noqa: E402
from repro_torch.analysis import congruence  # noqa: E402
from repro_torch.configs.base import Layer, ModelCfg  # noqa: E402
from repro_torch.distributed import pipeline, ring, seqpar  # noqa: E402
from repro_torch.kernels.ssd import ssd_scan  # noqa: E402
from repro_torch.kernels.swa import swa_ref  # noqa: E402
from repro_torch.models import Model, blocks  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"
R = 4
TOY = ModelCfg(name="pp-toy", d_model=32, n_heads=4, n_kv=2, head_dim=8, d_ff=64, vocab=64,
               stacks=(((Layer(mixer="attn"),), 4),))
KV_LEN = (100, 77)


def inputs() -> dict:
    """Every case's numpy inputs, from the seeds of the reference's tests."""
    d = {}
    rng = np.random.RandomState(0)
    d["conv_x"] = rng.randn(2, 64, 6).astype(np.float32)
    d["conv_w"] = rng.randn(4, 6).astype(np.float32)
    rng = np.random.RandomState(1)   # B, H, Hkv, T, D, W = 2, 4, 2, 64, 16, 12
    d["swa_q"] = (rng.randn(2, 4, 64, 16) * 0.4).astype(np.float32)
    d["swa_k"] = (rng.randn(2, 2, 64, 16) * 0.4).astype(np.float32)
    d["swa_v"] = rng.randn(2, 2, 64, 16).astype(np.float32)
    rng = np.random.RandomState(2)   # B, H, Hkv, T, D = 1, 4, 2, 64, 16
    d["ring_q"] = (rng.randn(1, 4, 64, 16) * 0.4).astype(np.float32)
    d["ring_k"] = (rng.randn(1, 2, 64, 16) * 0.4).astype(np.float32)
    d["ring_v"] = rng.randn(1, 2, 64, 16).astype(np.float32)
    for name, seed, G in (("ssd", 3, 1), ("ssd_g2", 5, 2)):   # Ba, T, H, N, P = 2, 64, 4, 8, 16
        rng = np.random.RandomState(seed)
        d[f"{name}_x"] = rng.randn(2, 64, 4, 16).astype(np.float32)
        d[f"{name}_dt"] = (rng.rand(2, 64, 4) * 0.2 + 0.01).astype(np.float32)
        d[f"{name}_A"] = (-np.abs(rng.rand(4)) - 0.1).astype(np.float32)
        d[f"{name}_B"] = (rng.randn(2, 64, G, 8) * 0.4).astype(np.float32)
        d[f"{name}_C"] = (rng.randn(2, 64, G, 8) * 0.4).astype(np.float32)
    rng = np.random.RandomState(4)   # B, H, Hkv, S, D = 2, 4, 2, 128, 16
    d["lse_q"] = (rng.randn(2, 4, 16) * 0.4).astype(np.float32)
    d["lse_k"] = (rng.randn(2, 128, 2, 16) * 0.4).astype(np.float32)
    d["lse_v"] = rng.randn(2, 128, 2, 16).astype(np.float32)
    rng = np.random.RandomState(0)   # S, M, B, D = 4, 6, 2, 16
    d["pp_W"] = (rng.randn(4, 16, 16) * 0.3).astype(np.float32)
    d["pp_x"] = rng.randn(6, 2, 16).astype(np.float32)
    rng = np.random.RandomState(1)   # M, B, T = 5, 2, 8
    d["pt_x"] = (rng.randn(5, 2, 8, 32) * 0.3).astype(np.float32)
    d["grad_g"] = np.random.RandomState(6).randn(2, 64, 6).astype(np.float32)
    return d


REFERENCE = ALIAS + SAVE_PARAMS + """
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs.base import Layer, ModelCfg
from repro.distributed.pipeline import gpipe
from repro.distributed.ring import lse_combine_decode, ring_attention
from repro.distributed.seqpar import seq_conv1d_causal, seq_sliding_window_attention
from repro.kernels.ssd import ssd_ref
from repro.models import blocks, params as pm, transformer as tf

TMP = {tmp!r}
d = dict(np.load(TMP + "/inputs.npz"))
j = lambda name: jnp.asarray(d[name])
mesh = Mesh(np.array(jax.devices()[:4]), ("sp",))
seq = P(None, "sp", None)
out = dict()

x, w = j("conv_x"), j("conv_w")
out["conv"] = jax.jit(jax.shard_map(lambda x: seq_conv1d_causal(x, w, axis_name="sp"),
                                    mesh=mesh, in_specs=seq, out_specs=seq))(x)

hs = P(None, None, "sp", None)
out["swa"] = jax.jit(jax.shard_map(
    lambda q, k, v: seq_sliding_window_attention(q, k, v, window=12, axis_name="sp"),
    mesh=mesh, in_specs=(hs,) * 3, out_specs=hs))(j("swa_q"), j("swa_k"), j("swa_v"))
out["ring"] = jax.jit(jax.shard_map(
    lambda q, k, v: ring_attention(q, k, v, axis_name="sp"),
    mesh=mesh, in_specs=(hs,) * 3, out_specs=hs))(j("ring_q"), j("ring_k"), j("ring_v"))

for name in ("ssd", "ssd_g2"):
    y, h = ssd_ref(j(name + "_x"), j(name + "_dt"), j(name + "_A"), j(name + "_B"),
                   j(name + "_C"))
    out[name + "_y"], out[name + "_h"] = y, h

Sl = 128 // 4
kv_len = jnp.asarray({kv_len!r}, jnp.int32)
out["lse"] = jax.jit(jax.shard_map(
    lambda q, k, v, kl: lse_combine_decode(
        q, k, v, jnp.clip(kl[:, None] - jax.lax.axis_index("sp") * Sl, 0, Sl)[:, 0],
        axis_name="sp"),
    mesh=mesh, in_specs=(P(), P(None, "sp"), P(None, "sp"), P()),
    out_specs=P()))(j("lse_q"), j("lse_k"), j("lse_v"), kv_len)

pmesh = Mesh(np.array(jax.devices()[:4]), ("pod",))
out["pp"] = gpipe(lambda W, x: jnp.tanh(x @ W), j("pp_W"), j("pp_x"), pmesh, axis="pod")

cfg = ModelCfg(name="pp-toy", d_model=32, n_heads=4, n_kv=2, head_dim=8, d_ff=64, vocab=64,
               stacks=(((Layer(mixer="attn"),), 4),))
params = pm.materialize(tf.param_specs(cfg), jax.random.PRNGKey(0), jnp.float32)
save_params(params, TMP + "/toy_params.npz")
positions = jnp.arange(8)

def stage_fn(p, x):
    y, _, _ = blocks.layer_fwd(p["layers"][0], cfg, Layer(mixer="attn"), x, mode="train",
                               positions=positions)
    return y

out["pt"] = gpipe(stage_fn, params["stacks"][0], j("pt_x"), pmesh, axis="pod")
np.savez(TMP + "/reference.npz", **{{k: np.asarray(v) for k, v in out.items()}})
print("OK")
"""


def _t(d, name):
    return torch.from_numpy(d[name])


def _shard(a, r, axis=1):
    n = a.shape[axis] // R
    return a.narrow(axis, r * n, n)


def _toy_model(tree):
    return Model(TOY, convert.params_from_reference(TOY, tree), device="cpu")


def _toy_stage(block, x):
    return blocks.layer_fwd(block, TOY, TOY.layers_flat[0], x, mode="train",
                            positions=torch.arange(x.shape[1]))[0]


def port_rank(rank, world, d, tree):
    """One process of the group: every case's shard (or what it raised)."""
    torch.manual_seed(0)
    out = {}
    x, w = _shard(_t(d, "conv_x"), rank), _t(d, "conv_w")
    out["conv"] = seqpar.seq_conv1d_causal(x, w, axis_name="sp")
    q, k, v = (_shard(_t(d, f"swa_{n}"), rank, 2) for n in "qkv")
    out["swa"] = seqpar.seq_sliding_window_attention(q, k, v, window=12, axis_name="sp")
    q, k, v = (_shard(_t(d, f"ring_{n}"), rank, 2) for n in "qkv")
    out["ring"] = ring.ring_attention(q, k, v, axis_name="sp")
    out["ring_plain_kernel"] = ring.ring_attention(q, k, v, axis_name="sp", use_kernel="ref")
    for name in ("ssd", "ssd_g2"):
        args = [_shard(_t(d, f"{name}_{n}"), rank) for n in ("x", "dt")] + [_t(d, f"{name}_A")]
        args += [_shard(_t(d, f"{name}_{n}"), rank) for n in ("B", "C")]
        out[f"{name}_y"], out[f"{name}_h"] = seqpar.seq_ssd_scan(*args, chunk=4, axis_name="sp")
    Sl = 128 // R
    kl = torch.clamp(torch.tensor(KV_LEN) - rank * Sl, 0, Sl)
    out["lse"] = ring.lse_combine_decode(_t(d, "lse_q"), _shard(_t(d, "lse_k"), rank),
                                         _shard(_t(d, "lse_v"), rank), kl, axis_name="sp")
    out["pp"] = pipeline.gpipe(lambda W, x: torch.tanh(x @ W), _t(d, "pp_W")[rank],
                               _t(d, "pp_x"), axis="pod")
    model = _toy_model(tree)
    with torch.inference_mode():
        out["pt"] = pipeline.gpipe(_toy_stage, model.layers[rank], _t(d, "pt_x"), axis="pod")
    # the conv's gradient through comm.shift's autograd
    xg = _shard(_t(d, "conv_x"), rank).requires_grad_()
    (seqpar.seq_conv1d_causal(xg, w, axis_name="sp") * _shard(_t(d, "grad_g"), rank)).sum() \
        .backward()
    out["conv_grad"] = xg.grad
    # raises under a group: a halo wider than the shard, a window wider than it
    errs = {}
    for what, fn in (("halo", lambda: seqpar.halo_left(x, 17, "sp")),
                     ("window", lambda: seqpar.seq_sliding_window_attention(
                         *(_shard(_t(d, f"swa_{n}"), rank, 2) for n in "qkv"), window=17,
                         axis_name="sp"))):
        try:
            fn()
        except ValueError as e:
            errs[what] = str(e)
    out = {k: v.detach().numpy() for k, v in out.items()}
    out["errors"] = errs
    # the analyzer records each shift with its peers and pairs them across the group
    rep = analysis.check(lambda x: ring.ring_attention(x, x[:, :2], x[:, :2], axis_name="sp"),
                         _shard(_t(d, "ring_q"), rank, 2))
    out["analysis"] = [f.message for f in rep.findings]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_seqpar")
    d = inputs()
    np.savez(tmp / "inputs.npz", **d)
    run(REFERENCE.format(tmp=str(tmp), kv_len=KV_LEN), ndev=4)
    ref = dict(np.load(tmp / "reference.npz"))
    tree = unflatten(np.load(tmp / "toy_params.npz"))
    port = spawn(R, "test_torch_seqpar:port_rank", tmp, d, tree)
    return d, ref, tree, port


def _whole(port, name, axis=1):
    return np.concatenate([p[name] for p in port], axis=axis)


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("name,axis,tol", [
    ("conv", 1, 1e-5), ("swa", 2, 2e-5), ("ring", 2, 2e-5), ("ring_plain_kernel", 2, 2e-5)])
def test_sharded_against_reference_shard_map(runs, name, axis, tol):
    d, ref, _, port = runs
    want = ref["ring" if name == "ring_plain_kernel" else name]
    _close(_whole(port, name, axis), want, tol, name)


@pytest.mark.parametrize("name", ["ssd", "ssd_g2"])
def test_seq_ssd_scan_against_whole_sequence_ssd_ref(runs, name):
    """F18: the reference's sharded scan fails on jax 0.9; its ``ssd_ref``
    over the whole sequence is what its test compares with."""
    _, ref, _, port = runs
    _close(_whole(port, f"{name}_y"), ref[f"{name}_y"], 3e-4, "y")
    _close(port[-1][f"{name}_h"], ref[f"{name}_h"], 3e-4, "last rank's state")


def test_lse_combine_decode(runs):
    _, ref, _, port = runs
    for r, p in enumerate(port):   # every process holds the combined output
        _close(p["lse"], ref["lse"], 2e-5, f"rank {r}")


@pytest.mark.parametrize("name,tol", [("pp", 1e-5), ("pt", 2e-5)])
def test_gpipe_matches_reference(runs, name, tol):
    _, ref, _, port = runs
    for r, p in enumerate(port):
        _close(p[name], ref[name], tol, f"rank {r}")


def test_gpipe_matches_sequential_stages(runs):
    d, _, tree, port = runs
    model = _toy_model(tree)
    want = _t(d, "pt_x")
    with torch.inference_mode():
        for block in model.layers:
            want = torch.stack([_toy_stage(block, m) for m in want])
    _close(port[0]["pt"], want.numpy(), 2e-5, "sequential")


def test_sharded_conv_gradient_equals_whole(runs):
    d, _, _, port = runs
    x = _t(d, "conv_x").requires_grad_()
    (seqpar.seq_conv1d_causal(x, _t(d, "conv_w")) * _t(d, "grad_g")).sum().backward()
    _close(_whole(port, "conv_grad"), x.grad.numpy(), 1e-5, "dx")


def test_group_raises(runs):
    *_, port = runs
    for p in port:
        assert "halo width 17 > local sequence 16" in p["errors"]["halo"]
        assert "window spans more than one neighbor shard" in p["errors"]["window"]


def test_analyzer_pairs_shifts(runs):
    """Under a check every process records its ring's 3 shifts of K and V
    with their peers; the group's sequences agree and every shift's
    partner expects it, so the check is clean.  A table in which rank 0
    sends to a rank that expects another source is a finding."""
    *_, port = runs
    for p in port:
        assert p["analysis"] == []

    def shift(src, dst):
        return dict(op="shift", dtype="float32", shape=(2,), peers=(src, dst), reduce=None,
                    site="core.comm.shift")

    good = [[shift((r - 1) % 3, (r + 1) % 3)] for r in range(3)]
    assert congruence.compare_sequences(good) == []
    bad = [[shift(2, 1)], [shift(2, 2)], [shift(1, 0)]]
    msgs = [f.message for f in congruence.compare_sequences(bad)]
    assert any("shift at position 0: rank 0 pairs with rank 1" in m for m in msgs), msgs


# ---- world 1: no group, the whole sequence -----------------------------------

def test_world_one_equals_whole_sequence(runs):
    d, ref, _, _ = runs
    x, w = _t(d, "conv_x"), _t(d, "conv_w")
    torch.testing.assert_close(seqpar.seq_conv1d_causal(x, w, axis_name="sp"),
                               seqpar.seq_conv1d_causal(x, w), rtol=0, atol=0)
    q, k, v = (_t(d, f"swa_{n}") for n in "qkv")
    _close(seqpar.seq_sliding_window_attention(q, k, v, window=12, axis_name="sp").numpy(),
           ref["swa"], 2e-5, "swa")
    torch.testing.assert_close(
        seqpar.seq_sliding_window_attention(q, k, v, window=12, axis_name="sp"),
        swa_ref(q, k, v, window=12), rtol=0, atol=0)
    q, k, v = (_t(d, f"ring_{n}") for n in "qkv")
    _close(ring.ring_attention(q, k, v, axis_name="sp").numpy(), ref["ring"], 2e-5, "ring")
    args = [_t(d, f"ssd_{n}") for n in ("x", "dt", "A", "B", "C")]
    y, h = seqpar.seq_ssd_scan(*args, chunk=4, axis_name="sp")
    y1, h1 = ssd_scan(*args, chunk=4)
    torch.testing.assert_close(y, y1, rtol=0, atol=0)
    torch.testing.assert_close(h, h1.float(), rtol=0, atol=0)
    _close(y.numpy(), ref["ssd_y"], 3e-4, "ssd y")


def test_world_one_decode_and_gpipe(runs):
    d, _, _, _ = runs
    q, k, v = _t(d, "lse_q"), _t(d, "lse_k"), _t(d, "lse_v")
    got = ring.lse_combine_decode(q, k, v, torch.tensor(KV_LEN), axis_name="sp")
    for b, L in enumerate(KV_LEN):
        want = swa_ref(q[b:b + 1, :, None], k[b:b + 1, :L].transpose(1, 2),
                       v[b:b + 1, :L].transpose(1, 2), window=10 ** 9)[0, :, 0]
        _close(got[b].numpy(), want.numpy(), 2e-5, f"batch {b}")
    W, xs = _t(d, "pp_W"), _t(d, "pp_x")
    torch.testing.assert_close(pipeline.gpipe(lambda W, x: torch.tanh(x @ W), W[0], xs,
                                              axis="pod"), torch.tanh(xs @ W[0]),
                               rtol=0, atol=0)


def test_world_one_raises(runs):
    d, *_ = runs
    x = _t(d, "conv_x")
    with pytest.raises(ValueError, match="halo width 65 > local sequence 64"):
        seqpar.halo_left(x, 65, "sp")
    q, k, v = (_t(d, f"swa_{n}") for n in "qkv")
    with pytest.raises(ValueError, match="window spans more than one neighbor shard"):
        seqpar.seq_sliding_window_attention(q, k, v, window=65, axis_name="sp")
    q, k, v = (_t(d, f"ring_{n}").bfloat16() for n in "qkv")
    with pytest.raises(NotImplementedError, match="log-sum-exp.*Queue B"):
        ring.ring_attention(q, k, v, axis_name="sp")
    assert ring.ring_attention(q, k, v, axis_name="sp", use_kernel="ref").dtype == torch.bfloat16
    for bad in (("sp", "tp"), "", None):
        with pytest.raises(ValueError, match="mesh-axis name"):
            seqpar.halo_left(x, 3, bad)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ring.ring_attention(*(_t(d, f"ring_{n}") for n in "qkv"), axis_name="sp",
                            use_kernel="cuda")


# ---- on the card: the kernels behind the sequence-parallel operators --------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _normwise(got, want):
    return float(torch.linalg.vector_norm(got.float() - want.float())
                 / torch.linalg.vector_norm(want.float()))


@pytest.mark.cuda
def test_operators_reach_their_kernels_on_card(cuda_device):
    """Without a group, on CUDA tensors: the halo'd window attention and
    the ring's diagonal step launch K6 (the ring with its LSE), the
    sharded SSD scan launches K7; each equals its plain version."""
    from repro_torch.kernels.ssd import kernel as kssd
    from repro_torch.kernels.swa import kernel as kswa

    d = inputs()
    q, k, v = (_t(d, f"swa_{n}").to(cuda_device) for n in "qkv")
    n0 = kswa.swa_attention_cuda.launches
    got = seqpar.seq_sliding_window_attention(q, k, v, window=12, axis_name="sp")
    assert kswa.swa_attention_cuda.launches == n0 + 1
    assert _normwise(got, swa_ref(q, k, v, window=12)) <= 1e-5
    q, k, v = (_t(d, f"ring_{n}").to(cuda_device) for n in "qkv")
    got = ring.ring_attention(q, k, v, axis_name="sp")
    assert kswa.swa_attention_cuda.launches == n0 + 2
    assert _normwise(got, swa_ref(q, k, v, window=64)) <= 1e-5
    with pytest.raises(NotImplementedError, match="B5"):
        ring.ring_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), axis_name="sp")
    args = [_t(d, f"ssd_{n}").to(cuda_device) for n in ("x", "dt", "A", "B", "C")]
    n7 = kssd.ssd_intra_chunk_cuda.launches
    y, h = seqpar.seq_ssd_scan(*args, chunk=4, axis_name="sp")
    assert kssd.ssd_intra_chunk_cuda.launches == n7 + 1
    y1, h1 = ssd_scan(*args, chunk=4, use_kernel="ref")
    assert _normwise(y, y1) <= 1e-5 and _normwise(h, h1) <= 1e-5
