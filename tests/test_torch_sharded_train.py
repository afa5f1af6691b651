"""Sharded training of the port (ZeRO-3 with tensor parallelism over a
``(data, model)`` mesh of gloo processes) against the JAX package's
unsharded run and the port's one process.

The reference runs once, in a child process on a thread: llama SMOKE in
float32 with ``PRNGKey(0)`` weights, its ``SyntheticLMData`` (batch 8,
seq 16, seed 0), ``AdamWCfg(lr=1e-3)``, warmup 2 of 50, four jitted
unsharded steps, as ``tests/test_fault_tolerance.py:83``
(``test_elastic_resume_across_meshes``) runs them.  Once it has written
the weights and batches, 4 gloo processes (``tests/_dist.py::spawn``) run,
in one group:

* 4 steps on ``(2, 2)``: every loss within 2e-4 relative of the
  reference's and of the port's one process, the first ``grad_norm``
  within 1e-4; the leaves no mesh axis splits bitwise equal on every
  process afterwards;
* the elastic resume: 2 steps on ``(2, 2)``, a checkpoint, 2 steps on
  ``(1, 4)`` from it, and 2 in one process from it: the last loss within
  2e-4 of the reference's 4-step loss, as that test asks;
* int8 moments on ``(2, 2)`` against one process (the port's), 3 steps;
* mamba2 SMOKE under ``dp 4`` against one process, 2 steps;
* ``launch.main([... "--dp", "2", "--tp", "2", "--device", "cpu"])`` in
  each of the 4 ranks: the same losses on every rank, those of
  ``launch.main`` without sharding within 2e-4.

``tp > 1`` on a Mamba or an MoE layer passes the rules' check where the
shapes split, and raises ``NotImplementedError`` naming the shapes and the
mesh where they do not (no group needed: the check comes before any
collective); ``tests/test_torch_sharded_mixers.py`` trains those layers
over the mesh.
"""

from __future__ import annotations

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _dist import spawn  # noqa: E402
from _mp import run  # noqa: E402
from _torch_lm import SAVE_PARAMS, unflatten  # noqa: E402
import _torch_sharded as child  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import mamba2_1p3b  # noqa: E402
from repro_torch.distributed.sharding import AbstractMesh, axis_rules, default_rules  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"
STEPS, BATCH, SEQ = 4, 8, 16
LOSS_RTOL, GNORM_RTOL = 2e-4, 1e-4
LAUNCH = ["--arch", "llama3.2-1b", "--scale", "0.05", "--steps", "3", "--device", "cpu"]

REFERENCE = ALIAS + SAVE_PARAMS + """
import dataclasses, importlib
from repro import optim
from repro.data import SyntheticLMData
from repro.models import params as pm, transformer as tf
from repro.train import TrainCfg, make_train_step

TMP = {tmp!r}
cfg = dataclasses.replace(importlib.import_module("repro.configs.llama3_2_1b").SMOKE,
                          dtype="float32")
params = pm.materialize(tf.param_specs(cfg), jax.random.PRNGKey(0), jnp.float32)
save_params(params, TMP + "/params0.npz")
data = SyntheticLMData(vocab=cfg.vocab, batch={batch}, seq={seq}, seed=0)
batches = [data.batch_at(jnp.asarray(s)) for s in range({steps})]
np.savez(TMP + "/batches.npz", **dict(
    ("%s%d" % (k, s), np.asarray(b[k])) for s, b in enumerate(batches) for k in b))
open(TMP + "/inputs.ready", "w").close()
tcfg = TrainCfg(opt=optim.AdamWCfg(lr=1e-3), warmup=2, total_steps=50)
step = jax.jit(make_train_step(cfg, tcfg))
opt = optim.init(params, tcfg.opt)
hist = []
for b in batches:
    params, opt, m = step(params, opt, b)
    hist.append([float(m["loss"]), float(m["grad_norm"])])
np.save(TMP + "/hist.npy", np.asarray(hist))
print("OK")
"""


def port_rank(rank, world, tmp):
    """One process of the group: every sharded case in turn."""
    params, batches = f"{tmp}/port_params.npz", f"{tmp}/batches.npz"
    common = dict(params_path=params, batches_path=batches, batch=BATCH, seq=SEQ)
    out = {"f32": child.sharded_train(rank, world, "llama3_2_1b", (2, 2), STEPS, **common),
           "elastic": child.elastic(rank, world, "llama3_2_1b", STEPS, f"{tmp}/ckpt", **common),
           "int8": child.sharded_train(rank, world, "llama3_2_1b", (2, 2), 3, "int8",
                                       **common),
           "mamba": child.sharded_train(rank, world, "mamba2_1p3b", (4, 1), 2),
           "launch": child.launcher(rank, world, LAUNCH + ["--dp", "2", "--tp", "2"])}
    for case in ("f32", "int8", "mamba"):
        out[case].pop("whole")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's child on a thread; the port's processes start once
    it has written the weights and the batches."""
    tmp = tmp_path_factory.mktemp("torch_sharded_train")
    failed = []

    def reference():
        try:
            run(REFERENCE.format(tmp=str(tmp), batch=BATCH, seq=SEQ, steps=STEPS), ndev=1)
        except BaseException as e:   # re-raised in the test process below
            failed.append(e)

    ref = threading.Thread(target=reference)
    ref.start()
    deadline = time.monotonic() + 300
    while not (tmp / "inputs.ready").exists() and ref.is_alive() \
            and time.monotonic() < deadline:
        time.sleep(0.1)
    if not (tmp / "inputs.ready").exists():
        ref.join()
        raise failed[0] if failed else AssertionError("the reference wrote no inputs")
    cfg = child.smoke("llama3_2_1b")
    state = convert.params_from_reference(cfg, unflatten(np.load(tmp / "params0.npz")))
    np.savez(tmp / "port_params.npz", **{k: v.numpy() for k, v in state.items()})
    port = spawn(4, "test_torch_sharded_train:port_rank", tmp, str(tmp), timeout=240,
                 group_timeout=120)
    ref.join()
    if failed:
        raise failed[0]
    return np.load(tmp / "hist.npy"), port


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.all(np.abs(got - want) <= rtol * np.abs(want)), (what, got, want)


def test_two_by_two_matches_the_reference_and_one_process(runs):
    hist, port = runs
    for r, p in enumerate(port):
        got, one = np.asarray(p["f32"]["sharded"]), np.asarray(p["f32"]["one"])
        _close(got[:, 0], hist[:, 0], LOSS_RTOL, f"rank {r} loss vs the reference")
        _close(got[:, 0], one[:, 0], LOSS_RTOL, f"rank {r} loss vs one process")
        _close(got[0, 1], hist[0, 1], GNORM_RTOL, f"rank {r} first grad_norm")
        _close(one[:, 0], hist[:, 0], LOSS_RTOL, f"rank {r} one process vs the reference")
    assert all(p["f32"]["sharded"] == port[0]["f32"]["sharded"] for p in port)


def test_replicated_leaves_stay_bitwise_equal(runs):
    _, port = runs
    for case in ("f32", "int8", "mamba"):
        rep = [p[case]["replicated"] for p in port]
        assert rep[0] and all(r == rep[0] for r in rep[1:]), case


def test_elastic_resume_across_meshes(runs):
    """(2, 2) -> checkpoint -> (1, 4) and -> one process: the 4th loss
    within 2e-4 of the reference's unsharded 4-step loss."""
    hist, port = runs
    for r, p in enumerate(port):
        e = p["elastic"]
        _close(e["second"][-1][0], hist[-1, 0], LOSS_RTOL, f"rank {r} (1, 4) after the resume")
        _close(e["one_from_ckpt"][-1][0], hist[-1, 0], LOSS_RTOL, f"rank {r} one process")
        _close([x[0] for x in e["first"] + e["second"]], [x[0] for x in e["one"]], LOSS_RTOL,
               f"rank {r} against one process")


def test_int8_moments_on_two_by_two(runs):
    _, port = runs
    for r, p in enumerate(port):
        got, one = np.asarray(p["int8"]["sharded"]), np.asarray(p["int8"]["one"])
        _close(got[:, 0], one[:, 0], LOSS_RTOL, f"rank {r} int8 loss")
        _close(got[:, 1], one[:, 1], GNORM_RTOL, f"rank {r} int8 grad_norm")


def test_mamba2_under_dp4(runs):
    _, port = runs
    for r, p in enumerate(port):
        got, one = np.asarray(p["mamba"]["sharded"]), np.asarray(p["mamba"]["one"])
        _close(got[:, 0], one[:, 0], LOSS_RTOL, f"rank {r} mamba2 loss")
        _close(got[0, 1], one[0, 1], GNORM_RTOL, f"rank {r} mamba2 grad_norm")
        # dp 4: each process holds a quarter of every fsdp leaf
        shapes = p["mamba"]["shapes"]["params"]
        assert shapes["embed"][1] == mamba2_1p3b.SMOKE.d_model // 4


def test_launcher_trains_over_four_processes(runs):
    from repro_torch.launch import train as launch

    _, port = runs
    one = launch.main(list(LAUNCH))
    hists = [p["launch"]["hist"] for p in port]
    assert [p["launch"]["rank"] for p in port] == [0, 1, 2, 3]
    assert all(h == hists[0] for h in hists)
    _close(hists[0], one, LOSS_RTOL, "launcher (2, 2) vs one process")


def test_serving_under_rules_raises():
    """Serving under rules runs on the model of ``serving_model`` (its
    weights gathered once, as ``Engine(..., mesh=)`` builds it): a model
    built without rules raises before any collective."""
    cfg = child.smoke("llama3_2_1b")
    model = tf.Model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    rules = default_rules(AbstractMesh((2, 1), ("data", "model")), batch_size=2)
    with axis_rules(rules), pytest.raises(ValueError, match="serving_model"):
        tf.prefill(model, torch.zeros(2, 4, dtype=torch.long))


@pytest.mark.parametrize("module,item", [("mamba2_1p3b", "item 7"),
                                         ("jamba_v01_52b", "item 7"),
                                         ("granite_moe_3b", "item 8")])
def test_tensor_parallel_mamba_and_moe_raise(module, item):
    """ROADMAP.md Queue A items 7 (Mamba) and 8 (MoE): under (1, 2) rules
    the SMOKE config's shapes split and the check passes; under (1, 3)
    they do not and the check raises, naming the first shape it reads that
    does not split (mamba2, jamba: 8 Mamba heads; granite: 4 query heads)
    and the mesh."""
    cfg = child.smoke(module)
    tf.check_sharded(cfg, default_rules(AbstractMesh((1, 2), ("data", "model")), batch_size=2))
    rules = default_rules(AbstractMesh((1, 3), ("data", "model")), batch_size=2)
    with pytest.raises(NotImplementedError, match=r"do not split over the mesh axes "
                                                  r"\('model',\) \(\{'data': 1, 'model': 3\}\)"):
        tf.check_sharded(cfg, rules)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# B, H, Hkv, T, D of K6 on a tensor-parallel process at a global batch of
# 4 x 2048: llama3.2-1b at tp 2 (dp 2: 2 rows) and tp 4 (dp 1: 4 rows),
# granite-moe-3b-a800m at tp 2 (12 query heads, the 4 kv heads they use)
LOCAL_HEADS = ((2, 16, 4, 2048, 64), (4, 8, 2, 2048, 64), (2, 12, 4, 2048, 64))
# Ba, T, H, P, N, G, L of K7 on a tensor-parallel process: mamba2-1.3b at
# tp 2 (dp 2) and tp 4 (dp 1) of 4 x 2048, and jamba's SMOKE width at tp 2
LOCAL_SSD_HEADS = ((2, 2048, 32, 64, 128, 1, 64), (4, 2048, 16, 64, 128, 1, 64),
                   (2, 32, 4, 16, 16, 1, 8))
CARD_TOL = 1e-5   # normwise, float32 (3xTF32) against the plain version


@pytest.mark.cuda
@pytest.mark.parametrize("case", LOCAL_HEADS, ids=lambda c: "x".join(map(str, c)))
def test_k6_at_the_local_head_shapes_on_card(case):
    """K6's float32 forward with its LSE and its backward at a process's
    local heads (global causal: window = T) against ``swa_lse_ref`` and
    ``swa_backward_ref``; a local head count the kernel does not take
    raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.swa import kernel as kswa
    from repro_torch.kernels.swa import swa_backward_ref, swa_lse_ref

    B, H, Hkv, T, D = case
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, T, H, D, generator=g, device=dev).transpose(1, 2)
    k = torch.randn(B, T, Hkv, D, generator=g, device=dev).transpose(1, 2)
    v = torch.randn(B, T, Hkv, D, generator=g, device=dev).transpose(1, 2)
    do = torch.randn(B, T, H, D, generator=g, device=dev).transpose(1, 2)
    n0 = (kswa.swa_attention_cuda.launches, kswa.swa_backward_cuda.launches)
    o, lse = kswa.swa_attention_cuda(q, k, v, window=T, return_lse=True)
    grads = kswa.swa_backward_cuda(q, k, v, o, do, lse, window=T)
    torch.cuda.synchronize()
    assert (kswa.swa_attention_cuda.launches, kswa.swa_backward_cuda.launches) == \
        (n0[0] + 1, n0[1] + 1)
    o_ref, lse_ref = swa_lse_ref(q, k, v, window=T)
    want = (o_ref, lse_ref) + tuple(swa_backward_ref(q, k, v, do, window=T))
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), (o, lse) + tuple(grads), want):
        err = float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
        assert torch.isfinite(a).all() and err <= CARD_TOL, (name, err)
    with pytest.raises(ValueError, match="disagree"):
        kswa.swa_attention_cuda(q[:, :H - 1], k, v, window=T)


@pytest.mark.cuda
@pytest.mark.parametrize("case", LOCAL_SSD_HEADS, ids=lambda c: "x".join(map(str, c)))
def test_k7_at_the_local_head_shapes_on_card(case):
    """K7's float32 forward (3xTF32) and its backward at a tensor-parallel
    process's local heads against ``ssd_intra_chunk_ref`` and
    ``ssd_intra_chunk_backward_ref``, normwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.ssd import kernel as kssd
    from repro_torch.kernels.ssd import ssd_intra_chunk_backward_ref, ssd_intra_chunk_ref
    from repro_torch.kernels.ssd.ref import chunk_logdecay

    Ba, T, H, P, N, G, L = case
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    zx = torch.randn(Ba, T, H * P + 2 * G * N, generator=g, device=dev)
    x = zx[..., :H * P].view(Ba, T, H, P)
    B = zx[..., H * P:H * P + G * N].view(Ba, T, G, N)
    C = zx[..., H * P + G * N:].view(Ba, T, G, N)
    dt = torch.nn.functional.softplus(torch.randn(Ba, T, H, generator=g, device=dev) - 2.0)
    A = -torch.exp(torch.rand(H, generator=g, device=dev))
    s = chunk_logdecay(dt, A, L)
    dy = torch.randn(Ba, T, H, P, generator=g, device=dev)
    dS = torch.randn(Ba, T // L, H, N, P, generator=g, device=dev)
    n0 = (kssd.ssd_intra_chunk_cuda.by_kernel["3xTF32"], kssd.ssd_backward_cuda.launches)
    got = kssd.ssd_intra_chunk_cuda(x, dt, A, B, C, chunk=L, s=s)
    grads = kssd.ssd_backward_cuda(x, dt, s, B, C, dy, dS)
    torch.cuda.synchronize()
    assert (kssd.ssd_intra_chunk_cuda.by_kernel["3xTF32"], kssd.ssd_backward_cuda.launches) == \
        (n0[0] + 1, n0[1] + 1)
    want = ssd_intra_chunk_ref(x, dt, A, B, C, chunk=L)[:2] + \
        tuple(ssd_intra_chunk_backward_ref(x, dt, s, B, C, dy, dS))
    for name, a, b in zip(("y_diag", "states", "dx", "ddt", "ds", "dB", "dC"),
                          tuple(got[:2]) + tuple(grads), want):
        err = float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
        assert torch.isfinite(a).all() and err <= CARD_TOL, (name, err)
