"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1 heat step, K2-K5 solver operators on
cell centers, with and without a Helmholtz shift, and on faces, K6
sliding-window attention, K7 SSD intra-chunk block, and the backwards of
K6 and K7) from the sources in this checkout and holds each against its
plain PyTorch version on the card.  Then it drives these paths through the kernels:

* the paper's Fig.-1 heat solver (``repro_torch.apps.Heat3D``) at 512^3
  cells on one rank and at 8 x 256^3 on eight virtual ranks, with and
  without stream-overlapped communication hiding;
* the variable-coefficient Poisson solve (``repro_torch.apps.Poisson3D``):
  every method at 18^3 global cells against the reference's iteration
  counts and the NumPy oracle, then mgcg, pipemgcg, Chebyshev multigrid
  (to 1e-8 on one rank, 20 cycles on 8 x 258^3) and 100 CG iterations at
  514^3 f64 on one rank and on 8 x 258^3;
* the staggered Stokes flagship (``repro_torch.apps.Stokes3D``): every
  velocity preconditioner, Schur-CG (the face preconditioner in both outer
  loops, the stress one in the compiled loop) and Uzawa (its first 8 of 52
  outer iterations) at 14^3 global cells against the reference's iteration
  counts, the NumPy oracle (Uzawa's cut: the reference's divergence ratio
  there) and the face-kernel launch counts the cycle code implies; face
  multigrid on each face location; then the velocity solves at 386^3 f64
  on one rank and on 8 x 194^3, and the first 3 outer iterations of a
  Schur-CG solve at 386^3 (held to their H100 reading);
* the Mamba-2 serving path (``repro_torch.serve.Engine``): the SSD
  intra-chunk kernel K7 against its plain version at the prefill shapes
  of mamba2-1.3b, bf16 on its wgmma kernel and f32 on its 3xTF32 kernel
  (both on the tensor cores), then timed; the SMOKE width in f32 (K7 against the plain scan,
  the prefill/decode relation, the same greedy ids), then mamba2-1.3b at
  full width and depth in bf16 with random weights: two ``generate`` calls
  (4 x 2048 prompt tokens + 32 new, 1 x 1000 + 16), 48 K7 launches each,
  all on the tensor cores, timed, with a device-time breakdown of one
  prefill, and four layers of the full width in f32 and in bf16 against
  the plain path;
* the gemma3 serving path (global and sliding-window attention, GeGLU
  FFN): K6 against its plain version at the reference tests' cases, ragged
  prompts and gemma3-4b's prefill shapes, bf16 on its wgmma kernel and f32
  on its 3xTF32 kernel (both on the tensor cores), then timed beside the
  plain version and
  ``scaled_dot_product_attention`` (a yardstick only); the
  SMOKE width in f32 (K6 against the plain path, every decode step, the
  same greedy ids); gemma3-4b at full width and depth in bf16 with random
  weights: two ``generate`` calls (4 x 2048 prompt tokens + 32 new,
  1 x 1000 + 16, cache_len = prompt + new), 34 K6 launches each, all on the
  tensor cores, and none in decode, timed, with device-time breakdowns of one prefill and one decode
  step, and four layers of the full width in f32 against the plain path;
* the two-phase flagship (``repro_torch.apps.TwoPhase3D``), last: the
  shifted K2-K5 against their plain versions at every level of its
  hierarchies in f32 and f64, then timed; every method and variant at
  16x12x12 on 8 ranks against the reference's per-step iterations (every
  K2-K4 launch shifted), periodic 1 against 8 ranks, the explicit
  integrator against its oracle with and without hide, the overlap
  operator against the plain one; then the main path, 514^3 f64 on 1 and
  8 ranks, its kernel counts taken around it alone: explicit with and
  without hide, cg and mgcg at the default dt, mgcg with overlap; after
  it, one mgcg step's device time by kind, the overlap operator
  against the in-place one, and a cg solve with the shifted Chebyshev
  cycle (K5's launches are those of this solve);
* then the Gross-Pitaevskii app, 2-D and 1-D grids, checkpoints and the
  solver telemetry: GrossPitaevskii3D at 514^3 complex64 on 8 blocks and
  on one (against each other and the single-block oracle; a small case
  against the CPU), 2-D diffusion on 8 x 4096^2 f64 (hide against
  update_halo bitwise; a small case against NumPy) and a 1-D periodic
  ring; a Poisson mgcg state at 8 x 258^3 checkpointed (save, async_save,
  restore timed) and resumed on 8 x 258^3 and on 1 x 514^3; the comm
  counts of cg, pipecg and mgcg (live against CommStats.totals); one mgcg
  solve with a session and watch() on and off (bitwise iterate, equal
  launch and profiler counts); the 8-rank NaN story (flight records, diag,
  resume from the checkpoint); Heat3D with hide under a session; and
  mamba2-1.3b through Engine(flight_dir=).  The launches of K1 and K2-K4
  center on these paths join their entries of the kernels line
  (``launches_slice9``);
* the example twins and MoE serving (slice 12): each
  ``examples/torch_*.py`` at its default size in a subprocess (the five,
  the training twin among them, cut to 30 of its 120 steps, started
  together; each must end with ``OK``); K6 at the head widths 64, 128 and
  112 (padded to 128) and K7 at the state width 16 against their
  plain versions at the prefill shapes of the models below, timed beside
  the plain versions (and K6 beside SDPA); then, each after its SMOKE width
  in f32 against the plain path (the same greedy ids), in bf16 with random
  weights through ``Engine.generate``: granite-moe-3b-a800m whole (4 x 2048
  + 32 and 1 x 1000 + 16; 32 K6 launches a call), jamba-v0.1-52b at full
  width cut to one period of 8 of its 32 layers (4 x 2048 + 32; 7 K7 and
  1 K6 launch a call) and kimi-k2 at full width cut to its first 2 of 61
  layers (1 x 1000 + 8; 2 K6 launches a call), every launch on the tensor
  cores; the expert-capacity drops of one prefill, time to first token and
  decode ms per token; a granite prefill's and decode step's device time
  by kind and one MoE layer split into its expert GEMMs and its dispatch;
  granite's decode with the int8 KV cache against the bf16 cache's;
* training (slice 13, phases ``k6_backward`` to ``train_restart``): K6's
  float32 backward (``swa_bwd.cu``) against its plain version at
  llama3.2-1b's training shape, gemma3's window shape, the two example
  models' shapes and a ragged SMOKE shape (two runs bitwise; K6's output
  bitwise with and without its LSE), timed beside the plain version and
  SDPA's backward (a yardstick only); llama3.2-1b whole in float32 set up
  by ``repro_torch.launch.train`` at 4 x 2048 tokens, its first step's
  loss, grad_norm and every gradient held against ``use_kernel="ref"``,
  then 6 steps through ``Trainer.run`` (falling loss, ms a step, tokens/s,
  peak memory, share of the float32 peak, K6's launches per step against
  the prediction); a checkpoint restart of the model of
  ``examples/torch_train_lm.py`` (which runs at its default size with the
  other twins, phase ``examples``) against an uninterrupted run;
* Mamba training (slice 15, phases ``k7_backward`` to
  ``train_jamba_smoke``): K7's float32 backward (``ssd_bwd.cu``, 3xTF32 on
  the tensor cores) against
  its plain version at mamba2-1.3b's training shape, jamba's N 16, the
  launcher's ``--scale`` cut, a ragged L 50, two groups and the SMOKE
  width (two runs bitwise), timed beside its plain version with K7's
  float32 forward; mamba2-1.3b whole in float32 set up by the launcher at
  4 x 2048 tokens as llama3.2-1b is (first step against
  ``use_kernel="ref"``, 6 steps, K7's launches per step against the
  prediction: 96 forward, 48 backward); one step of jamba's SMOKE config
  (K6's and K7's backward and the MoE layer in one model) against the
  plain path;
* context parallelism and GPipe (slice 17, phase ``context_parallel``): K6
  in float32 with its log-sum-exp at the halo'd shard's shape (2048
  queries, the last of 3072 keys, window 1024), rank 0's and the ring's
  diagonal step, and K7 at one shard's shape, against their plain
  versions; mamba2-1.3b whole and gemma3-4b cut to its first 6 layers (one
  period of its 5:1 pattern), float32, B 1, T 8192, run whole in this
  process and then sharded over 4 gloo processes sharing the card
  (``context_parallel_fwd``/``context_parallel_logits``: conv and kv
  halos, ring attention, the SSD state scan): hidden state and logits
  within 1e-3 normwise of one process, 48 K7 / 5 + 1 K6 launches a process,
  the sharded forward timed against the one-process one (median of 3);
  llama3.2-1b's 16 layers as 4 GPipe stages of 4 (4 microbatches of 1 x
  2048) against the layers in sequence, 28 K6 launches a process.  The
  processes' launches join the kernels line (``launches_context_parallel``,
  ``launches_gpipe``);
* sharded training (slice 18, phase ``sharded_train``): K6's float32
  forward with its LSE and its backward at a tensor-parallel process's
  local heads (tp 2: 2 x 2048, 16 q / 4 kv heads; tp 4: 4 x 2048, 8 / 2)
  and K7's forward and backward at a dp-4 process's row, against their
  plain versions; llama3.2-1b cut to 4 of its 16 layers (full width, f32,
  the launcher's TrainCfg, 4 x 2048) for 3 steps through the launcher in
  this process and over dp 2 x tp 2 of 4 gloo processes sharing the card
  (ZeRO-3 with tensor parallelism under ``default_rules``): every step's
  loss within 2e-4 relative, the first grad norm within 1e-4; the elastic
  resume (a sharded checkpoint after step 2, the launcher on dp 1 x tp 4
  restores its blocks and runs step 3, within 2e-4 of one process);
  mamba2-1.3b cut to 4 of 48 layers, 2 steps under dp 4 against one
  process; ``compressed_psum_mean`` over the 4 processes (its one-shot
  and error-feedback bounds), timed against a float32 sum all-reduce.
  K6's and K7's launches, as predicted a process, join the kernels line
  (``launches_sharded_train``) with each kernel's numbers at these shapes
  (``sharded_train_local``);
* serving under sharding rules (slice 20, phase ``sharded_serve``, in the
  same 4 processes after their training cells): gemma3-4b (6 of 34
  layers) and mamba2-1.3b (4 of 48) at full width through
  ``Engine(..., mesh=)`` over dp 2 x tp 2, bf16 at 4 x 2048 + 16 and f32
  at 1 x 1000 + 16 (``cache_seq`` over (data, model)), against one process
  with the same weights: the f32 cells' ids equal and every step's logits
  within 1e-5 normwise, the bf16 cells' first-token logits within 2e-2;
  time to first token, decode ms a token, bytes a process sends, peak a
  process; K6 and K7 at the local shapes against their plain versions,
  their launches joining the kernels line (``launches_sharded_serve``,
  ``sharded_serve_local``);
* the grid across processes (phase ``dist``): the one-process runs
  here, then 8 processes of a gloo group on this card, one block each
  (Heat3D 8 x 256^3 f32 100 steps with hide and without, every block and
  the gathered field bitwise the one-process run, 7 / 1 K1 launches a
  step per process; Poisson3D mgcg at 8 x 130^3 f64, its first 8 of 18
  iterations, against the one-process run), 2 gloo processes of 4 blocks (Heat3D bitwise, one
  TwoPhase3D mgcg step with the one-process count), NCCL with one process
  (Heat3D bitwise), and NCCL across min(cards, 4) cards where the host has
  several.  gloo stages the halos through the host: its times measure no
  link.  Stokes3D at 14^3 (the ``"stress"`` velocity solve cut to 3 of
  its 7 iterations on 8 gloo processes, a Schur solve cut to 2 of its 10
  outer iterations on 2 gloo processes of 4 blocks and on the NCCL process,
  each against the same cut in one process; the ``"face"`` velocity solve
  on the NCCL process with the reference's count), and
  Gross-Pitaevskii at 18^3 bitwise on 8, 2 and the NCCL process.  The
  processes' launches join the kernels line (``launches_dist``);
* last, alone, the port's analyzer (phase ``analysis``): a Poisson3D mgcg
  solve bitwise with equal launches around a capture of itself, the
  sweep's one-process targets clean with every launch counter unchanged,
  and the launch plans of K1-K7 and of K6's and K7's backwards at every
  shape this script launched.

Times come from CUDA events or from host clocks around synchronised work.
Every phase prints one line; any failure raises and exits non-zero.  The
line before the last is a JSON object describing each kernel; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA card it exits 1 and
prints no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12       # H100 SXM TF32 on the tensor cores, dense
TF32_PRODUCTS = 3              # a float32 product in 3xTF32 takes three TF32 products
HEAT_FLOP_PER_CELL = 16        # interior cell of heat_step.cu, see its header
TOL = {torch.float32: 1e-6, torch.bfloat16: 2e-2, torch.float64: 1e-12}
COEFS = (1.3, 0.01, 0.7, 0.9, 1.1)   # lam, dt, dx, dy, dz of the kernel checks
T_START = time.perf_counter()


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def fail(msg: str):
    raise RuntimeError(msg)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def heat_bound(n_cells: int, n_interior: int, itemsize: int) -> tuple[float, str]:
    """Least time (ms) for one heat step: bytes (T, Ci read, T written) over
    the memory rate, or its operations over the float32 rate."""
    t_bytes = 3 * n_cells * itemsize / HBM_BYTES_PER_S * 1e3
    t_ops = HEAT_FLOP_PER_CELL * n_interior / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def interior_cells(shape) -> int:
    *lead, nx, ny, nz = shape
    return math.prod(lead) * max(nx - 2, 0) * max(ny - 2, 0) * max(nz - 2, 0)


def check_kernel(kernel, ref, T, Ci, tol: float, where: str) -> float:
    """Kernel against its plain version on the same inputs; ring bitwise."""
    got = kernel(T, Ci, *COEFS)
    torch.cuda.synchronize()
    want = ref(T, Ci, *COEFS)
    if got.shape != T.shape or got.dtype != T.dtype:
        fail(f"{where}: kernel gave {tuple(got.shape)} {got.dtype}")
    g, w = got.double(), want.double()
    err = (g - w).abs().max().item()
    if not torch.allclose(g, w, rtol=tol, atol=tol):
        fail(f"{where}: kernel differs from the plain version, max |err| {err} > {tol}")
    for ax in (-3, -2, -1):
        for idx in (0, T.shape[ax] - 1):
            if not torch.equal(got.select(ax, idx), T.select(ax, idx)):
                fail(f"{where}: ring plane {idx} of axis {ax} not passed through bitwise")
    return err


def breakdown(run, steps: int, top: int = 5) -> dict:
    """Device time by kernel name and the device's idle share over ``run()``
    (which does ``steps`` steps or iterations), from the profiler's CUDA
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ev = sorted(((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.device_type == DeviceType.CUDA), key=lambda x: x[0])
    if not ev:
        return {"device_time": "not measured"}
    busy, end = 0.0, -math.inf
    for s, e, _ in ev:  # length of the union of the device intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name: dict = {}
    for s, e, name in ev:
        by_name[name[:40]] = by_name.get(name[:40], 0.0) + (e - s) / steps / 1e3
    best = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"ms_per_step_by_kernel": json.dumps({k: round(v, 4) for k, v in best}).replace(" ", ""),
            "device_busy_ms_per_step": busy / steps / 1e3,
            "wall_ms_per_step": wall_us / steps / 1e3,
            "idle_share": 1 - busy / wall_us}


# ---------------------------------------------------------------------------
# the solver slice: K2-K5 and the Poisson path
# ---------------------------------------------------------------------------

F64_FLOP_PER_S = 34e12         # H100 SXM float64 outside the tensor cores (data sheet)
SOLVER_REPLACES = {"apply": "src/repro/kernels/solver3d/kernel.py:278",
                   "residual": "src/repro/kernels/solver3d/kernel.py:298",
                   "jacobi": "src/repro/kernels/solver3d/kernel.py:321",
                   "cheb": "src/repro/kernels/solver3d/kernel.py:347"}
# words moved per cell (each input read once, each output written once; K5
# reads no d on its first step) and f64 operations per interior cell
# (counted from solver3d.cu: 34 for A u, +1 residual, +3 Jacobi, +6 Chebyshev)
SOLVER_WORDS = {"apply": 3, "residual": 4, "jacobi": 5, "cheb": 7, "cheb_first": 6}
SOLVER_FLOP_PER_CELL = {"apply": 34, "residual": 35, "jacobi": 38, "cheb": 41, "cheb_first": 38}
SOLVER_TOL = {torch.float32: 1e-6, torch.float64: 1e-12}   # normwise: |k - p| <= tol max|p|
OMEGA = 6.0 / 7.0
# the reference's iteration counts at Poisson3D(nx=10, dims=(2,2,2)) f64, tol 1e-8
# (tests/test_convergence_regression.py pins cg/mgcg/pipecg/pipemgcg)
MG_CUT_CYCLES = 20   # mg-Chebyshev cycles at 8 x 258^3 (to 1e-8 it takes 876)
# what those cycles give on an H100 (bitwise across runs): the relres after
# them, and the mean contraction a cycle over the last 10 of them, at which
# the solve would reach 1e-8 in 875.5 cycles; the check allows reductions in
# another order and no other change of the V-cycle
MG_CUT_RELRES, MG_CUT_RELRES_RTOL = 1.7597633625760127, 1e-6
MG_CUT_RATE = (0.975, 0.981)   # read: 0.97805
PATH_ITERATIONS = {
    "dirichlet": {"cg": 54, "mgcg": 12, "pipecg": 55, "pipemgcg": 13, "pt": 167, "mg": 20,
                  "mg-chebyshev": 18},
    "periodic": {"cg": 26, "mgcg": 10, "pipecg": 27, "mg": 17},
}


def solver_bound(op: str, n_cells: int, n_interior: int, itemsize: int = 8):
    """Least time (ms) of one launch: its bytes over the memory rate, or its
    f64 operations over the f64 rate, whichever is larger."""
    t_bytes = SOLVER_WORDS[op] * n_cells * itemsize / HBM_BYTES_PER_S * 1e3
    t_ops = SOLVER_FLOP_PER_CELL[op] * n_interior / F64_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def solver_calls(sk, inputs, h2, spacing):
    """{name: (kernel call, plain call, ring value)} for K2-K5 on ``inputs``
    ``(u, c, f, dia, d)``, or ``(u, c, f, dia, d, shift)`` for the shifted
    kernels (``dia`` then holds the shift); K5 both on its first step (no d)
    and on a later one."""
    u, c, f, dia, d, *rest = inputs
    s = rest[0] if rest else None
    return {
        "apply": (lambda: sk.apply_cuda(u, c, h2=h2, shift=s),
                  lambda: sk.apply_op_ref(u, c, spacing, shift=s), (0,)),
        "residual": (lambda: sk.residual_cuda(u, c, f, h2=h2, shift=s),
                     lambda: sk.residual_op_ref(u, c, f, spacing, shift=s), (0,)),
        "jacobi": (lambda: sk.jacobi_cuda(u, c, f, dia, omega=OMEGA, h2=h2, shift=s),
                   lambda: sk.jacobi_sweep_ref(u, c, f, dia, omega=OMEGA, spacing=spacing,
                                               shift=s), (u,)),
        "cheb_first": (lambda: sk.cheb_cuda(u, c, f, dia, None, a=None, b=1.25, h2=h2, shift=s),
                       lambda: sk.cheb_sweep_ref(u, c, f, dia, d, a=None, b=1.25,
                                                 spacing=spacing, shift=s), (u, 0)),
        "cheb": (lambda: sk.cheb_cuda(u, c, f, dia, d, a=0.3, b=0.9, h2=h2, shift=s),
                 lambda: sk.cheb_sweep_ref(u, c, f, dia, d, a=0.3, b=0.9, spacing=spacing,
                                           shift=s), (u, 0)),
    }


def check_solver_kernels(sk, inputs, spacing, tol: float, where: str) -> dict:
    """Each of K2-K5 (shifted if ``inputs`` carry a shift) against its plain
    version on the same inputs: normwise within ``tol``, the ring bitwise.
    Returns max |err| per kernel."""
    h2 = tuple(s * s for s in spacing)
    u = inputs[0]
    ring = torch.ones(u.shape[-3:], dtype=torch.bool, device=u.device)
    ring[1:-1, 1:-1, 1:-1] = False
    ring = ring.expand(u.shape)
    errs = {}
    for name, (kern, plain, ring_values) in solver_calls(sk, inputs, h2, spacing).items():
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for g, w, rv in zip(got, want, ring_values):
            if g.shape != u.shape or g.dtype != u.dtype:
                fail(f"{where} {name}: kernel gave {tuple(g.shape)} {g.dtype}")
            e = (g.double() - w.double()).abs().max().item()
            scale = max(w.double().abs().max().item(), 1.0)
            if not e <= tol * scale:
                fail(f"{where} {name}: kernel differs from the plain version, "
                     f"max |err| {e} > {tol} * {scale}")
            want_ring = rv[ring] if torch.is_tensor(rv) else torch.zeros_like(g[ring])
            if not torch.equal(g[ring], want_ring):
                fail(f"{where} {name}: ring cells not written as the plain version does")
            err = max(err, e)
        errs[name] = err
        del got, want
    return errs


def solver_inputs(sk, shape, dtype, rand, spacing, shifted: bool = False):
    """Seeded ``(u, c, f, dia, d)``; with ``shifted``, also a positive shift
    of the order of the operator's diagonal, held by ``dia`` as well."""
    u, c, f, d = rand(shape, dtype), rand(shape, dtype) + 0.5, rand(shape, dtype), rand(shape, dtype)
    dia = sk.full_diag(c, spacing)
    if not shifted:
        return u, c, f, dia, d
    s = (rand(shape, dtype) + 0.5) * (6.0 / min(spacing) ** 2)
    dia[..., 1:-1, 1:-1, 1:-1] += s[..., 1:-1, 1:-1, 1:-1]
    return u, c, f, dia, d, s


def launch_counts(sk) -> dict:
    return {k: getattr(sk, f"{k}_cuda").launches for k in ("apply", "residual", "jacobi", "cheb")}


def zero_counts(sk) -> None:
    for k in ("apply", "residual", "jacobi", "cheb"):
        getattr(sk, f"{k}_cuda").launches = 0


def expected_launches(method: str, k: int, levels: int) -> dict:
    """Launches of K2-K5 that a solve of ``k`` iterations makes, counted from
    the solvers' code: one K2 per operator application; per V-cycle one K3
    per level but the coarsest and the sweeps of make_v_cycle (mgcg's
    preconditioner: 1 + 1 Jacobi sweeps, 50 coarse; mg: 2 + 2, 100 coarse)."""
    segments = -(-k // 50)   # pipelined: replacement every 50 iterations
    if method in ("cg", "pt"):
        return {"apply": k + 1, "residual": 0, "jacobi": 0, "cheb": 0}
    if method == "pipecg":
        return {"apply": 1 + 4 * segments + k, "residual": 0, "jacobi": 0, "cheb": 0}
    if method in ("mgcg", "pipemgcg"):
        cycles = k + 1 if method == "mgcg" else k + 2 * segments
        apply = k + 1 if method == "mgcg" else 1 + 4 * segments + k
        return {"apply": apply, "residual": cycles * (levels - 1),
                "jacobi": cycles * ((levels - 1) * 2 + 50), "cheb": 0}
    sweeps = (levels - 1) * 4
    if method == "mg":
        return {"apply": 0, "residual": 1 + k * levels, "jacobi": k * (sweeps + 100), "cheb": 0}
    if method == "mg-chebyshev":
        return {"apply": 0, "residual": 1 + k * levels, "jacobi": k * 100, "cheb": k * sweeps}
    raise ValueError(method)


def solve(app, method: str, **kw):
    if method == "mg-chebyshev":
        return app.solve("mg", smoother="chebyshev", **kw)
    return app.solve(method, **kw)


def solver_phases(dev, rand) -> list:
    from repro_torch.apps import Poisson3D
    from repro_torch.kernels import solver3d as sk
    from repro_torch.solvers import level_spacings

    # ---- 7. K2-K5 against their plain versions -----------------------------
    errs = {}
    for dtype in (torch.float32, torch.float64):
        for shape in ((1, 10, 10, 10), (8, 34, 18, 66)):
            sp = (0.5, 0.7, 1.1)
            inputs = solver_inputs(sk, shape, dtype, rand, sp)
            e = check_solver_kernels(sk, inputs, sp, SOLVER_TOL[dtype], f"{dtype} {shape}")
            errs[f"{str(dtype)[6:]}:{shape}".replace(" ", "")] = max(e.values())
        # strided views, as a slab of a field
        sp = (0.5, 0.7, 1.1)
        inputs = tuple(t[..., 3:15, :, 5:30] for t in
                       solver_inputs(sk, (2, 2, 2, 18, 10, 34), dtype, rand, sp))
        e = check_solver_kernels(sk, inputs, sp, SOLVER_TOL[dtype], f"{dtype} strided")
        errs[f"{str(dtype)[6:]}:strided"] = max(e.values())
    # the main path's own shapes: every level of both full-size hierarchies
    # (1 x 514^3 ... 1 x 6^3 and 8 x 258^3 ... 8 x 6^3) at that level's spacing
    main_errs, level_errs = {}, {}
    for cfg in (dict(nx=514, ny=514, nz=514, dims=(1, 1, 1)),
                dict(nx=258, ny=258, nz=258, dims=(2, 2, 2))):
        app = Poisson3D(**cfg)
        grids = app.grid.hierarchy()
        for g, sp in zip(grids, level_spacings(app.grid, grids, app.spacing)):
            name = f"{math.prod(g.dims)}x{g.local_shape[0]}^3"
            inputs = solver_inputs(sk, g.shape, torch.float64, rand, sp)
            e = check_solver_kernels(sk, inputs, sp, SOLVER_TOL[torch.float64], f"{name} f64")
            level_errs[name] = max(e.values())
            main_errs = {k: max(v, main_errs.get(k, 0.0)) for k, v in e.items()}
            del inputs
        del app
        torch.cuda.empty_cache()
    say("solver_kernels", small=json.dumps(errs).replace(" ", ""),
        main_path_levels=json.dumps(level_errs).replace(" ", ""),
        main_path_max=json.dumps(main_errs).replace(" ", ""), status="ok")

    # ---- 8. the Poisson path at small size: counts, oracle, launches ------
    rows = []
    for bc, per in (("dirichlet", (False, False, False)), ("periodic", (True, True, True))):
        app = Poisson3D(nx=10, ny=10, nz=10, dims=(2, 2, 2), periodic=per)
        G = app.oracle(tol=1e-12)
        levels = len(app.grid.hierarchy())
        for method, want_k in PATH_ITERATIONS[bc].items():
            zero_counts(sk)
            u, info = solve(app, method, tol=1e-8)
            got = launch_counts(sk)
            k = info.iterations
            if k != want_k:
                fail(f"{bc} {method}: {k} iterations, the reference takes {want_k}")
            want = expected_launches(method, k, levels)
            if got != want:
                fail(f"{bc} {method}: kernel launches {got}, the solver's code makes {want}")
            err = float(np.abs(app.grid.gather(u) - G).max() / np.abs(G).max())
            rn = app.residual_norm(u)
            if not (info.converged and err < 1e-4 and rn < 2e-8 and np.isfinite(err)):
                fail(f"{bc} {method}: relres {info.relres}, residual_norm {rn}, "
                     f"oracle rel err {err}")
            rows.append(f"{bc[:3]}:{method}={k}")
            say("poisson_path", bc=bc, method=method, iterations=k, relres=info.relres,
                residual_norm=rn, oracle_rel_err=err,
                launches=json.dumps(got).replace(" ", ""),
                k2_per_iteration=got["apply"] / k)
        del app
    say("poisson_path", iterations_equal_reference=" ".join(rows))

    # ---- 9. the loop's cost per iteration where launches dominate ---------
    for method in ("cg", "pipecg", "mgcg"):
        app = Poisson3D(nx=18, ny=18, nz=18, dims=(1, 1, 1))
        solve(app, method, tol=0.0, maxiter=10)
        _, info = solve(app, method, tol=0.0, maxiter=100)
        prof = breakdown(lambda: solve(app, method, tol=0.0, maxiter=20), 20, top=3)
        say("loop_cost", grid="1x18^3 f64", method=method, ms_per_iteration=1e3 * info.s_per_iter(),
            **prof)
        del app

    # ---- 10. full size: 514^3 f64 on one rank and on 8 x 258^3 -------------
    zero_counts(sk)
    runs = []
    for name, cfg in (("1x514^3", dict(nx=514, ny=514, nz=514, dims=(1, 1, 1))),
                      ("8x258^3", dict(nx=258, ny=258, nz=258, dims=(2, 2, 2)))):
        app = Poisson3D(**cfg)
        if app.grid.global_shape != (514, 514, 514):
            fail(f"{name}: global shape {app.grid.global_shape}")
        # the standalone V-cycle is not grid-independent (1 rank: 24 cycles at
        # 130^3, 44 at 258^3, ~200 at 514^3; slower still on 8 blocks), so mg
        # gets room for the cycles it takes to reach 1e-8 on one block; on 8
        # blocks (host-bound: 85 s for its 876 cycles) it runs MG_CUT_CYCLES
        # cycles, to keep the whole script in its budget, held to their
        # reading (MG_CUT_RELRES, MG_CUT_RATE)
        mg_kw = (dict(tol=1e-8, maxiter=2000) if cfg["dims"] == (1, 1, 1)
                 else dict(tol=0.0, maxiter=MG_CUT_CYCLES))
        for method, kw in (("mgcg", dict(tol=1e-8)), ("pipemgcg", dict(tol=1e-8)),
                           ("mg-chebyshev", mg_kw), ("cg", dict(tol=0.0, maxiter=100))):
            torch.cuda.synchronize()
            n0 = launch_counts(sk)
            u, info = solve(app, method, **kw)
            n1 = launch_counts(sk)
            rn = app.residual_norm(u)
            tol = kw["tol"]
            if tol > 0 and not (info.converged and rn <= tol):
                fail(f"{name} {method}: relres {info.relres}, recomputed {rn} > {tol}")
            if not math.isfinite(rn):
                fail(f"{name} {method}: non-finite residual")
            cut = {}
            if tol == 0 and method == "mg-chebyshev":
                h = info.residuals
                rate = (h[-1] / h[-11]) ** 0.1
                cut = {"contraction": rate,
                       "predicted_cycles_to_1e-8": len(h) + math.log(1e-8 / h[-1]) / math.log(rate)}
                if (info.iterations != MG_CUT_CYCLES
                        or abs(info.relres / MG_CUT_RELRES - 1) > MG_CUT_RELRES_RTOL
                        or not MG_CUT_RATE[0] <= rate <= MG_CUT_RATE[1]):
                    fail(f"{name} {method}: {info.iterations} cycles, relres {info.relres} "
                         f"(want {MG_CUT_RELRES} to rtol {MG_CUT_RELRES_RTOL}), contraction "
                         f"{rate} a cycle (want {MG_CUT_RATE})")
            per_it = {k: (n1[k] - n0[k]) / info.iterations for k in n1}
            say("poisson_full", config=name, method=method, iterations=info.iterations,
                seconds=info.wall_s, ms_per_iteration=1e3 * info.s_per_iter(),
                t_eff_GBps=app.t_eff(info), relres=info.relres, residual_norm=rn, **cut,
                launches_per_iteration=json.dumps(per_it).replace(" ", ""))
            runs.append((name, method, info.iterations))
            del u
        del app
        torch.cuda.empty_cache()
    launches = launch_counts(sk)
    for k, n in launches.items():
        if n == 0:
            fail(f"the Poisson path at full size never launched the {k} kernel")
    say("poisson_full", launches=json.dumps(launches).replace(" ", ""),
        peak_GB=torch.cuda.max_memory_allocated() / 1e9)

    # ---- 11. breakdown: ten mgcg iterations at 1 x 514^3 (one setup) -------
    app = Poisson3D(nx=514, ny=514, nz=514, dims=(1, 1, 1))
    solve(app, "mgcg", tol=0.0, maxiter=1)
    say("breakdown", config="1x514^3 mgcg",
        **breakdown(lambda: solve(app, "mgcg", tol=0.0, maxiter=10), 10, top=8))
    del app
    torch.cuda.empty_cache()

    # ---- 12. each kernel alone at 514^3 f64, in turns ----------------------
    h = 1.0 / 513
    sp = (h, h, h)
    h2 = tuple(s * s for s in sp)
    inputs = solver_inputs(sk, (1, 514, 514, 514), torch.float64, rand, sp)
    n = inputs[0].numel()
    n_in = interior_cells(inputs[0].shape)
    calls = solver_calls(sk, inputs, h2, sp)
    ops = ("apply", "residual", "jacobi", "cheb_first", "cheb")
    t = {op: [] for op in ops}
    for _ in range(2):
        for op in ops:
            t[op].append(cuda_time_ms(calls[op][0], reps=20))
    entries = []
    for op in ops:
        plain = cuda_time_ms(calls[op][1], reps=3, warm=1)
        ms = min(t[op])
        bound, bound_by = solver_bound(op, n, n_in)
        say("solver_kernel", op=op, shape="1x514^3", dtype="float64", ms_runs=t[op],
            plain_ms=plain, bound_ms=bound, bound_by=bound_by, share_of_bound=bound / ms,
            achieved_GBps=SOLVER_WORDS[op] * n * 8 / ms / 1e6)
        if op == "cheb_first":
            continue
        entries.append({
            "name": op, "route": "cuda",
            "source": "src/repro_torch/kernels/solver3d/csrc/solver3d.cu",
            "replaces": SOLVER_REPLACES[op], "launches": launches[op],
            "max_abs_err": main_errs[op] if op != "cheb" else max(main_errs["cheb"],
                                                                   main_errs["cheb_first"]),
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None})
    del inputs, calls
    torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# the staggered slice: K2-K5 face and the Stokes path
# ---------------------------------------------------------------------------

FACE_LOCS = ("xface", "yface", "zface")
FACE_OPS = ("apply", "residual", "jacobi", "cheb")
FACE_REPLACES = {"apply": "src/repro/kernels/solver3d/kernel.py:236",
                 "residual": "src/repro/kernels/solver3d/kernel.py:242",
                 "jacobi": "src/repro/kernels/solver3d/kernel.py:250",
                 "cheb": "src/repro/kernels/solver3d/kernel.py:258"}
# words per cell (inputs read once, outputs written once; the mask is an
# input of K3-K5) and f64 operations per cell, counted from solver3d.cu's
# face_au (35 for A u: 6 own-dim, 13 per cross dim, 3 to sum and negate;
# +2 residual, +3 Jacobi, +5 Chebyshev, +3 on its first step)
FACE_WORDS = {"apply": 3, "residual": 5, "jacobi": 6, "cheb": 8, "cheb_first": 7}
FACE_FLOP_PER_CELL = {"apply": 35, "residual": 37, "jacobi": 40, "cheb": 42, "cheb_first": 40}
# The reference's iteration counts at Stokes3D(nx=8, ny=8, nz=8, dims=(2,2,2)) f64
# (14^3 global), velocity solves at tol=1e-8: classic "face" 17, "stress" 7,
# None 77 and stripped "face" 11 are tests/test_convergence_regression.py's and
# the tentpole issue's table; "center" 18, pipelined "stress" 8 / "face" 18 and
# free slip "stress" 19 are tests/test_torch_stokes.py's reference run; pipelined
# None 78 / "center" 19 and stripped pipelined "face" 12 a run of the same
# reference code on the CPU (jax 0.9.0, 8 fake devices).
STOKES_VELOCITY = {
    # name: (stress, bc, precond, variant, iterations)
    "face": ("full", "noslip", "face", "classic", 17),
    "stress": ("full", "noslip", "stress", "classic", 7),
    "none": ("full", "noslip", None, "classic", 77),
    "center": ("full", "noslip", "center", "classic", 18),
    "face_pipelined": ("full", "noslip", "face", "pipelined", 18),
    "stress_pipelined": ("full", "noslip", "stress", "pipelined", 8),
    "none_pipelined": ("full", "noslip", None, "pipelined", 78),
    "center_pipelined": ("full", "noslip", "center", "pipelined", 19),
    "stripped_face": ("stripped", "noslip", "face", "classic", 11),
    "stripped_face_pipelined": ("stripped", "noslip", "face", "pipelined", 12),
    "freeslip_stress": ("full", "freeslip", "stress", "classic", 19),
}
# solve(tol=1e-6): (outer, total inner, first inner), the reference's
# compiled=False loop (tests/test_torch_stokes_schur.py, test_torch_stokes_uzawa.py
# reference runs).  Schur-CG runs "face" in both outer loops and "stress" in the
# compiled one, solve()'s default (not "stress" in the host loop: the four took
# 80-103 s of host-bound solves).  Uzawa runs the first UZAWA_CUT of its 52
# outer iterations (57-88 s whole), held to the reference's counts and
# ||div V|| / ||div V_1|| there (UZAWA_CUT_RELRES_DIV, RELRES_RTOL); the cuts keep
# the script in its time.
UZAWA_CUT = 8
UZAWA_CUT_RELRES_DIV = 0.0814311550332909   # tests/test_torch_stokes_uzawa.py holds both
RELRES_RTOL = 1e-6
STOKES_SOLVES = {
    "schur_face": (dict(method="schur", precond="face", compiled=False), (10, 193, 17)),
    "schur_face_compiled": (dict(method="schur", precond="face", compiled=True), (10, 193, 17)),
    "schur_stress_compiled": (dict(method="schur", precond="stress", compiled=True),
                              (10, 84, 7)),
    "uzawa_cut": (dict(method="uzawa", compiled=False, outer_maxiter=UZAWA_CUT),
                  (UZAWA_CUT, 50, 7)),
}
# multigrid_solve cycles on each face location at tol=1e-10, the reference's
# configuration of tests/test_solvers.py:572-610 (tests/test_torch_face_mg.py's
# reference run)
FACE_MG_CYCLES = {(loc, sm): k for loc in FACE_LOCS for sm, k in (("jacobi", 23), ("chebyshev", 21))}


def face_bound(op: str, n_cells: int, itemsize: int = 8):
    """Least time (ms) of one face launch: bytes over the memory rate or f64
    operations over the f64 rate, whichever is larger."""
    t_bytes = FACE_WORDS[op] * n_cells * itemsize / HBM_BYTES_PER_S * 1e3
    t_ops = FACE_FLOP_PER_CELL[op] * n_cells / F64_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def face_inputs(sk, grid, loc, rand, spacing, dtype=None):
    """Random u, c (> 0.5), f, d on ``grid`` with the location's real interior
    mask and its masked diagonal."""
    from repro_torch.core import locations as L

    dtype = dtype or grid.dtype
    u, c, f, d = (rand(grid.shape, dtype) for _ in range(4))
    c = c + 0.5
    m = L.interior_mask(grid, loc, dtype)
    return dict(u=u, c=c, f=f, d=d, m=m, dia=sk.full_diag(c, spacing, loc, m))


def face_calls(sk, x, loc, spacing):
    """{name: (kernel call, plain call)} for K2-K5 face on the inputs ``x``;
    K5 on its first step and on a later one."""
    from repro_torch.core import locations as L

    sd, h2 = L.stagger_dim(loc), tuple(s * s for s in spacing)
    u, c, f, d, m, dia = (x[k] for k in ("u", "c", "f", "d", "m", "dia"))
    return {
        "apply": (lambda: sk.apply_face_cuda(u, c, sd=sd, h2=h2),
                  lambda: sk.apply_op_ref(u, c, spacing, loc)),
        "residual": (lambda: sk.residual_face_cuda(u, c, f, m, sd=sd, h2=h2),
                     lambda: sk.residual_op_ref(u, c, f, spacing, loc, imask=m)),
        "jacobi": (lambda: sk.jacobi_face_cuda(u, c, f, dia, m, sd=sd, omega=OMEGA, h2=h2),
                   lambda: sk.jacobi_sweep_ref(u, c, f, dia, omega=OMEGA, spacing=spacing,
                                               loc=loc, imask=m)),
        "cheb_first": (lambda: sk.cheb_face_cuda(u, c, f, dia, m, None, sd=sd, a=None, b=1.25,
                                                 h2=h2),
                       lambda: sk.cheb_sweep_ref(u, c, f, dia, d, a=None, b=1.25, spacing=spacing,
                                                 loc=loc, imask=m)),
        "cheb": (lambda: sk.cheb_face_cuda(u, c, f, dia, m, d, sd=sd, a=0.3, b=0.9, h2=h2),
                 lambda: sk.cheb_sweep_ref(u, c, f, dia, d, a=0.3, b=0.9, spacing=spacing,
                                           loc=loc, imask=m)),
    }


def check_face_kernels(sk, x, loc, spacing, tol: float, where: str) -> dict:
    """Each face kernel against its plain version on the same inputs: every
    cell normwise within ``tol`` (the wrapped ring and dead plane included),
    the masked cells of K3-K5 bitwise.  Returns max |err| per kernel."""
    u, masked = x["u"], (x["m"] == 0).expand(x["u"].shape)
    errs = {}
    for name, (kern, plain) in face_calls(sk, x, loc, spacing).items():
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for g, w in zip(got, want):
            if g.shape != u.shape or g.dtype != u.dtype or not g.is_contiguous():
                fail(f"{where} {loc} {name}: kernel gave {tuple(g.shape)} {g.dtype}")
            e = (g.double() - w.double()).abs().max().item()
            scale = max(w.double().abs().max().item(), 1.0)
            if not e <= tol * scale:
                fail(f"{where} {loc} {name}: kernel differs from the plain version, "
                     f"max |err| {e} > {tol} * {scale}")
            if name != "apply" and not torch.equal(g[masked], w[masked]):
                fail(f"{where} {loc} {name}: masked cells not bitwise equal to the plain version")
            err = max(err, e)
        errs[name] = err
        del got, want
    return errs


def face_counts(sk) -> dict:
    return {k: getattr(sk, f"{k}_face_cuda").launches for k in FACE_OPS}


def center_counts(sk) -> dict:
    return {k: getattr(sk, f"{k}_cuda").launches for k in FACE_OPS}


def diff(a: dict, b: dict) -> dict:
    return {k: a[k] - b[k] for k in a}


def cycle_launches(cycles: int, levels: int, leaves: int = 3, sweeps: int = 2,
                   coarse: int = 50) -> dict:
    """K2-K5 launches of ``cycles`` V-cycles of CyclePreconditioner's default
    (Jacobi, nu_pre = nu_post = 1, 50 coarse sweeps) on each of ``leaves``
    fields: per cycle and leaf one K3 and ``sweeps`` K4 on every level but
    the coarsest, ``coarse`` K4 there."""
    return {"apply": 0, "residual": leaves * cycles * (levels - 1),
            "jacobi": leaves * cycles * (sweeps * (levels - 1) + coarse), "cheb": 0}


def cg_cycles(variant: str, k: int) -> int:
    """Preconditioner applications of a CG solve of ``k`` iterations: one per
    iteration plus one (classic), or plus two per segment of 50 (pipelined)."""
    return k + 1 if variant == "classic" else k + 2 * -(-k // 50)


def cg_applies(variant: str, k: int) -> int:
    """Operator applications of a CG solve of ``k`` iterations."""
    return k + 1 if variant == "classic" else 1 + 4 * -(-k // 50) + k


def oracle_errors(app, V, P) -> tuple[float, float]:
    """The reference's criterion (tests/test_apps.py): velocity and interior
    pressure against Stokes3D.oracle(tol=1e-9), relative to their largest
    values."""
    from repro_torch import fields

    Vx, Vy, Vz, Po = app.oracle(tol=1e-9)
    ref = {"vx": Vx[:-1, :, :], "vy": Vy[:, :-1, :], "vz": Vz[:, :, :-1]}
    scale = max(np.abs(r).max() for r in ref.values())
    verr = max(np.abs(fields.gather(V[k]) - ref[k]).max() / scale for k in ref)
    inner = (slice(1, -1),) * 3
    gp, rp = app.grid.gather(P.data)[inner], Po[inner]
    return float(verr), float(np.abs(gp - rp).max() / np.abs(rp).max())


SOLVER_KINDS = (("face_kernels", ("_face_kernel<",)),
                ("center_kernels", ("apply_kernel<", "residual_kernel<", "jacobi_kernel<",
                                    "cheb_kernel<")),
                ("roll", ("roll",)), ("reduce", ("reduce",)),
                ("copy", ("copy", "Copy", "Memcpy")), ("elementwise", ("elementwise",)))


def categories(run, steps: int, kinds=SOLVER_KINDS) -> dict:
    """Device time per step by kind (by default the solver kernels, PyTorch's
    elementwise and reduction kernels, copies, the exchange's rolls; the first
    kind whose key is in a kernel's name) and the idle share, from the
    profiler's CUDA activity over ``run()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ev = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
          if e.device_type == DeviceType.CUDA]
    if not ev:
        return {"device_time": "not measured"}
    by_kind: dict = {}
    busy, end = 0.0, -math.inf
    kernels = sum(1 for *_, name in ev if not any(k in name for k in ("Memcpy", "Memset")))
    for s_, e_, name in sorted(ev):
        kind = next((k for k, keys in kinds if any(key in name for key in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + (e_ - s_) / steps / 1e3
        if e_ > end:
            busy += e_ - max(s_, end)
            end = e_
    return {"ms_per_iteration_by_kind": json.dumps({k: round(v, 3) for k, v in
                                                    sorted(by_kind.items())}).replace(" ", ""),
            "device_busy_ms_per_iteration": busy / steps / 1e3,
            "wall_ms_per_iteration": wall_us / steps / 1e3, "idle_share": 1 - busy / wall_us,
            "kernels_per_iteration": kernels / steps}


FULL = (("1x386^3", 386, (1, 1, 1)), ("8x194^3", 194, (2, 2, 2)))   # the flagship's configs
# the 1 x 386^3 Schur-CG solve runs its first SCHUR_CUT_OUTER outer iterations
# (to 1e-6 it takes 14 outer and 347 inner, 41 s), to keep the whole script
# under its 1000 s once the sharded_serve cells joined it; held to what they
# give on an H100 (bitwise across runs): the inner iterations and the
# divergence residual after them, to rtol 1e-6 (reductions in another order)
SCHUR_CUT_OUTER, SCHUR_CUT_INNER = 3, 116
SCHUR_CUT_RELRES_DIV, SCHUR_CUT_RTOL = 0.058274622783511136, 1e-6


def face_kernel_checks(sk, rand, full=FULL) -> dict:
    """Phase 13: K2-K5 face against their plain versions; returns the max
    |err| per kernel over the main path's level shapes."""
    from repro_torch.core import init_global_grid
    from repro_torch.solvers import level_spacings

    errs = {}
    for dtype in (torch.float32, torch.float64):
        for dims, local in (((1, 1, 1), (9, 7, 11)), ((2, 2, 2), (10, 6, 8)),
                            ((1, 1, 1), (34, 18, 66))):
            g = init_global_grid(*local, dims=dims, dtype=dtype)
            sp = (0.5, 0.7, 1.1)
            for loc in FACE_LOCS:
                x = face_inputs(sk, g, loc, rand, sp)
                e = check_face_kernels(sk, x, loc, sp, SOLVER_TOL[dtype], f"{dtype} {g.shape}")
                errs[f"{str(dtype)[6:]}:{g.shape}:{loc}".replace(" ", "")] = max(e.values())
                view = {k: v[..., 1:7, :, 2:6] for k, v in x.items()}   # a strided view
                e = check_face_kernels(sk, view, loc, sp, SOLVER_TOL[dtype], f"{dtype} strided")
                errs[f"{str(dtype)[6:]}:strided:{loc}"] = max(e.values())
    # the main path's own shapes: every level of both full-size hierarchies
    main_errs, level_errs = {}, {}
    for _, n, dims in full:
        g0 = init_global_grid(n, n, n, dims=dims, dtype=torch.float64)
        grids = g0.hierarchy()
        h = 1.0 / (g0.nx_g() - 1)
        for g, sp in zip(grids, level_spacings(g0, grids, (h, h, h))):
            for loc in FACE_LOCS:
                x = face_inputs(sk, g, loc, rand, sp)
                e = check_face_kernels(sk, x, loc, sp, SOLVER_TOL[torch.float64],
                                       f"{math.prod(dims)}x{g.local_shape[0]}^3")
                name = f"{math.prod(dims)}x{g.local_shape[0]}^3"
                level_errs[name] = max(level_errs.get(name, 0.0), max(e.values()))
                main_errs = {k: max(v, main_errs.get(k, 0.0)) for k, v in e.items()}
                del x
        torch.cuda.empty_cache()
    say("face_kernels", small=json.dumps(errs).replace(" ", ""),
        main_path_levels=json.dumps(level_errs).replace(" ", ""),
        main_path_max=json.dumps(main_errs).replace(" ", ""), status="ok")
    return main_errs


def stokes_small(sk) -> None:
    """Phase 14: the Stokes path at the reference's size (14^3 global on 8
    blocks): iteration counts, launch counts, the oracle."""
    from repro_torch import fields
    from repro_torch.apps import Stokes3D

    apps = {}

    def app_for(stress, bc):
        if (stress, bc) not in apps:
            apps[stress, bc] = Stokes3D(nx=8, ny=8, nz=8, dims=(2, 2, 2), stress=stress, bc=bc)
        return apps[stress, bc]

    levels = len(app_for("full", "noslip").grid.hierarchy())
    rows = []
    for name, (stress, bc, precond, variant, want_k) in STOKES_VELOCITY.items():
        app = app_for(stress, bc)
        f0, c0 = face_counts(sk), center_counts(sk)
        V, info = app.velocity_solve(precond=precond, tol=1e-8, variant=variant)
        fl, cl = diff(face_counts(sk), f0), diff(center_counts(sk), c0)
        k = info.iterations
        if k != want_k:
            fail(f"stokes {name}: {k} iterations, the reference takes {want_k}")
        cycles = cg_cycles(variant, k)
        want_f = cycle_launches(cycles, levels) if precond == "face" else cycle_launches(0, levels)
        if stress == "stripped":
            want_f["apply"] = 3 * cg_applies(variant, k)
        want_c = cycle_launches(cycles, levels) if precond == "center" else cycle_launches(0, levels)
        if fl != want_f or cl != want_c:
            fail(f"stokes {name}: face launches {fl} / center launches {cl}, the cycle code makes "
                 f"{want_f} / {want_c}")
        rm, _ = app.residuals(V, fields.zeros(app.grid, "center"))
        if not (info.converged and rm <= 1e-8):
            fail(f"stokes {name}: relres {info.relres}, recomputed {rm}")
        rows.append(f"{name}={k}")
        say("stokes_small", solve=name, iterations=k, relres=info.relres, recomputed=rm,
            face_launches=json.dumps(fl).replace(" ", ""),
            center_launches=json.dumps(cl).replace(" ", ""))
    app = app_for("full", "noslip")
    for name, (kw, want) in STOKES_SOLVES.items():
        f0 = face_counts(sk)
        t0 = time.perf_counter()
        V, P, info = app.solve(tol=1e-6, **kw)
        seconds = time.perf_counter() - t0
        fl = diff(face_counts(sk), f0)
        got = (info.outer_iterations, info.inner_iterations, info.first_inner_iterations)
        if got != want:
            fail(f"stokes {name}: (outer, inner, first) {got}, the reference takes {want}")
        cycles = info.inner_iterations + info.outer_iterations + 2
        want_f = cycle_launches(cycles if kw.get("precond") == "face" else 0, levels)
        if fl != want_f:
            fail(f"stokes {name}: face launches {fl}, the cycle code makes {want_f}")
        if "outer_maxiter" in kw:   # cut: the reference's divergence ratio at the cut
            verr = perr = None
            if abs(info.relres_div / UZAWA_CUT_RELRES_DIV - 1) > RELRES_RTOL:
                fail(f"stokes {name}: relres_div {info.relres_div}, the reference's "
                     f"{UZAWA_CUT_RELRES_DIV} (rtol {RELRES_RTOL})")
        else:
            verr, perr = oracle_errors(app, V, P)
            if not (info.converged and info.relres_momentum < 1e-4 and verr < 1e-4
                    and perr < 1e-4):
                fail(f"stokes {name}: {info}, oracle errors {verr} {perr}")
        rows.append(f"{name}={got}".replace(" ", ""))
        say("stokes_small", solve=name, compiled=kw["compiled"], outer=got[0], inner=got[1],
            first_inner=got[2], relres_div=info.relres_div,
            relres_momentum=info.relres_momentum, oracle_v_err=verr, oracle_p_err=perr,
            seconds=seconds, face_launches=json.dumps(fl).replace(" ", ""))
    del apps, app
    say("stokes_small", iterations_equal_reference=" ".join(rows))


def face_mg_small(sk) -> None:
    """Phase 15: face multigrid at the reference's configuration (K5 face on
    a solver path)."""
    from repro_torch import fields, solvers
    from repro_torch.core import init_global_grid

    g = init_global_grid(10, 10, 10, dims=(2, 2, 2), dtype=torch.float64)
    rng = np.random.RandomState(0)
    c = fields.Field(g, g.update_halo(
        fields.scatter(g, 1.0 + 0.5 * rng.rand(*g.global_shape)).data), "center")
    mg_levels = len(g.hierarchy())
    for loc in FACE_LOCS:
        b = fields.from_global_fn(
            g, lambda ix, iy, iz: torch.sin(ix * 0.3) + torch.cos(iy * 0.2 + iz * 0.1), loc)
        b = b * (fields.interior_mask(g, loc) * fields.valid_mask(g, loc))
        for smoother in ("jacobi", "chebyshev"):
            f0 = face_counts(sk)
            x, info = solvers.multigrid_solve(g, c, b, (0.1, 0.1, 0.1), tol=1e-10,
                                              smoother=smoother)
            fl = diff(face_counts(sk), f0)
            k = info.iterations
            if k != FACE_MG_CYCLES[loc, smoother]:
                fail(f"face mg {loc} {smoother}: {k} cycles, the reference takes "
                     f"{FACE_MG_CYCLES[loc, smoother]}")
            sweeps = (mg_levels - 1) * 4
            want_f = {"apply": 0, "residual": 1 + k * mg_levels,
                      "jacobi": k * (100 + (sweeps if smoother == "jacobi" else 0)),
                      "cheb": k * sweeps if smoother == "chebyshev" else 0}
            if fl != want_f or x.loc != loc or not (info.converged and info.relres <= 1e-10):
                fail(f"face mg {loc} {smoother}: launches {fl} (want {want_f}), {info}")
            say("face_mg_small", loc=loc, smoother=smoother, cycles=k, relres=info.relres,
                face_launches=json.dumps(fl).replace(" ", ""))
    del g, c, b, x


def stokes_full(sk, full=FULL) -> None:
    """Phase 16: the flagship at full width, 386^3 f64 on 1 and 8 ranks."""
    from repro_torch import fields
    from repro_torch.apps import Stokes3D

    shape = None
    for name, n, dims in full:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        app = Stokes3D(nx=n, ny=n, nz=n, dims=dims)
        shape = shape or app.grid.global_shape
        if app.grid.global_shape != shape:
            fail(f"{name}: global shape {app.grid.global_shape}, not {shape}")
        P0 = fields.zeros(app.grid, "center")
        for precond in ("face", "stress"):
            torch.cuda.synchronize()
            f0 = face_counts(sk)
            V, info = app.velocity_solve(precond=precond, tol=1e-8)
            fl = diff(face_counts(sk), f0)
            rm, dn = app.residuals(V, P0)
            if not (info.converged and rm <= 1e-8 and math.isfinite(dn)):
                fail(f"{name} {precond}: relres {info.relres}, recomputed {rm}")
            say("stokes_full", config=name, precond=precond, iterations=info.iterations,
                seconds=info.wall_s, ms_per_iteration=1e3 * info.s_per_iter(),
                t_eff_GBps=app.t_eff(info), relres=info.relres, recomputed=rm,
                face_launches_per_iteration=json.dumps(
                    {k: v / info.iterations for k, v in fl.items()}).replace(" ", ""),
                peak_GB=torch.cuda.max_memory_allocated() / 1e9)
            del V
        if dims == (1, 1, 1):
            t0 = time.perf_counter()
            V, P, info = app.solve(tol=1e-6, method="schur", precond="face",
                                   outer_maxiter=SCHUR_CUT_OUTER)
            seconds = time.perf_counter() - t0
            rm, dn = app.residuals(V, P)
            if not (info.outer_iterations == SCHUR_CUT_OUTER
                    and info.inner_iterations == SCHUR_CUT_INNER
                    and abs(info.relres_div / SCHUR_CUT_RELRES_DIV - 1) <= SCHUR_CUT_RTOL
                    and rm < 1e-4):
                fail(f"{name} schur cut to {SCHUR_CUT_OUTER} outer iterations: {info} (want "
                     f"{SCHUR_CUT_INNER} inner, relres_div {SCHUR_CUT_RELRES_DIV} to rtol "
                     f"{SCHUR_CUT_RTOL}), recomputed momentum residual {rm}")
            say("stokes_full", config=name, solve="schur face", outer_cut=SCHUR_CUT_OUTER,
                outer=info.outer_iterations,
                inner=info.inner_iterations, seconds=seconds,
                ms_per_inner_iteration=1e3 * seconds / info.inner_iterations,
                relres_div=info.relres_div, relres_momentum=info.relres_momentum,
                recomputed_momentum=rm, div_norm=dn,
                peak_GB=torch.cuda.max_memory_allocated() / 1e9)
            del V, P
            for precond, its in (("face", 5), ("stress", 2)):
                app.velocity_solve(precond=precond, tol=0.0, maxiter=1)
                say("breakdown", config=f"{name} velocity {precond}",
                    **categories(lambda: app.velocity_solve(precond=precond, tol=0.0,
                                                            maxiter=its), its))
        del app, P0


def stokes_phases(rand) -> list:
    from repro_torch.kernels import solver3d as sk

    # ---- 13. K2-K5 face against their plain versions ------------------------
    main_errs = face_kernel_checks(sk, rand)
    # ---- 14-16. the staggered path: every count zeroed just before, read after
    for w in sk.WRAPPERS:
        w.launches = 0
    stokes_small(sk)
    face_mg_small(sk)
    stokes_full(sk)
    path = face_counts(sk)
    for k, v in path.items():
        if v == 0:
            fail(f"the staggered path never launched the {k} face kernel")
    say("stokes_path", face_launches=json.dumps(path).replace(" ", ""),
        center_launches=json.dumps(center_counts(sk)).replace(" ", ""),
        peak_GB=torch.cuda.max_memory_allocated() / 1e9)
    torch.cuda.empty_cache()

    # ---- 17. each face kernel alone at 386^3 f64, in turns -----------------
    return face_kernel_times(sk, rand, path, main_errs)


def face_kernel_times(sk, rand, path, main_errs, n_side: int = 386) -> list:
    """Phase 17: each face kernel alone on one 386^3 f64 block, each location
    in turn; returns the kernels' JSON entries (the slowest location)."""
    from repro_torch.core import init_global_grid

    g = init_global_grid(n_side, n_side, n_side, dtype=torch.float64)
    h = 1.0 / (n_side - 1)
    sp = (h, h, h)
    n = math.prod(g.shape)
    ops = ("apply", "residual", "jacobi", "cheb_first", "cheb")
    best = {op: 0.0 for op in ops}
    plain = {op: 0.0 for op in ops}
    for loc in FACE_LOCS:
        x = face_inputs(sk, g, loc, rand, sp)
        calls = face_calls(sk, x, loc, sp)
        t = {op: [] for op in ops}
        for _ in range(2):
            for op in ops:
                t[op].append(cuda_time_ms(calls[op][0], reps=20))
        for op in ops:
            p_ms = cuda_time_ms(calls[op][1], reps=3, warm=1)
            bound, bound_by = face_bound(op, n)
            say("face_kernel", op=op, loc=loc, shape=f"1x{n_side}^3", dtype="float64",
                ms_runs=t[op],
                plain_ms=p_ms, bound_ms=bound, bound_by=bound_by, share_of_bound=bound / min(t[op]),
                achieved_GBps=FACE_WORDS[op] * n * 8 / min(t[op]) / 1e6)
            best[op] = max(best[op], min(t[op]))   # the slowest location
            plain[op] = max(plain[op], p_ms)
        del x, calls
        torch.cuda.empty_cache()
    entries = []
    for op in FACE_OPS:
        bound, bound_by = face_bound(op, n)
        entries.append({
            "name": f"{op}_face", "route": "cuda",
            "source": "src/repro_torch/kernels/solver3d/csrc/solver3d.cu",
            "replaces": FACE_REPLACES[op], "launches": path[op],
            "max_abs_err": main_errs[op] if op != "cheb" else max(main_errs["cheb"],
                                                                   main_errs["cheb_first"]),
            "ms": best[op], "plain_ms": plain[op], "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None})
    return entries


# ---------------------------------------------------------------------------
# the serving slice: K7 and the Mamba-2 path
# ---------------------------------------------------------------------------

BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense (data sheet)
K7_REPLACES = "src/repro/kernels/ssd/kernel.py:57"
# K7's tolerances, normwise (max |kernel - plain| <= tol * max |plain|): f32 is
# the summation order of L <= 64 and N <= 128 float32 terms; bf16 y_diag is one
# bf16 rounding of a float32 result (the two sides may land on neighbouring
# bf16 values, 2^-7 apart); the states are float32 from exactly converted inputs
K7_TOL = {"float32": {"y_diag": 1e-5, "states": 1e-5, "s": 0.0},
          "bfloat16": {"y_diag": 1e-2, "states": 1e-5, "s": 0.0}}
# Ba, T, H, P, N, G, L: the main path's prefill (4 x 2048 tokens of mamba2-1.3b),
# a 1000-token prompt (L = 50), one-token chunks, two groups, the SMOKE width,
# and jamba-v0.1-52b's Mamba layers at their 4 x 2048 prefill (N 16)
K7_MAIN = (4, 2048, 64, 64, 128, 1, 64)
K7_WIDTHS = {"jamba N16 4x2048": (4, 2048, 128, 64, 16, 1, 64)}
K7_SHAPES = (K7_MAIN, (1, 1000, 64, 64, 128, 1, 50), (2, 7, 64, 64, 128, 1, 1),
             (2, 64, 8, 16, 16, 2, 8), (2, 20, 8, 16, 16, 1, 5), *K7_WIDTHS.values())
SERVE_TOL = 1e-4   # f32 logits, normwise: K7 against the chunked plain scan, summation order
# bf16 logits of the 4-layer full-width model, normwise, K7 against the plain
# path: the two round the SSD's output at different places (K7's y_diag is
# bf16 before Y_off is added; the plain scan rounds C B^T to bf16), and bf16
# keeps 8 significant bits.  A CPU model of K7's plan (tests/test_torch_ssd_tc.py)
# put the two paths 7.8e-3 apart at 1 x 1000 tokens, half of the 1.6e-2 between
# the plain path in bf16 and in f32 on the same weights; 2e-2 is 2.5 times that
K7_BF16_LOGIT_TOL = 2e-2


def k7_inputs(shape, dtype, gen, dev):
    """x, B, C as strided slices of one projection, as the Mamba layer passes
    them; dt as softplus gives it, A = -exp(A_log)."""
    Ba, T, H, P, N, G, L = shape
    w = H * P + 2 * G * N
    zx = torch.randn(Ba, T, w + H, generator=gen, device=dev).to(dtype)
    x = zx[..., :H * P].view(Ba, T, H, P)
    B = zx[..., H * P:H * P + G * N].view(Ba, T, G, N)
    C = zx[..., H * P + G * N:w].view(Ba, T, G, N)
    dt = torch.nn.functional.softplus(
        torch.randn(Ba, T, H, generator=gen, device=dev) - 2.0)
    A = -torch.exp(torch.rand(H, generator=gen, device=dev))
    return x, dt, A, B, C


def k7_bound(shape, itemsize: int, per_head: bool = False) -> tuple[float, str, float]:
    """Least time (ms) of one K7 launch: inputs x, B, C, dt read once and
    y_diag, states, s written once over the memory rate, or the products
    the causal block needs (C B^T once per group and W X on the L (L + 1) / 2
    entries of the lower triangle, B'^T X whole) over the rate of the
    kernel's products (bf16 on the tensor cores; float32 as three TF32
    products on the tensor cores, 3 x FLOP over the TF32 peak, as
    ``k6_bound`` and ``k7b_bound`` count it).  ``per_head``: B and C read,
    and C B^T formed, once per head.  Also returns the float32 CUDA-core
    floor of the same products."""
    Ba, T, H, P, N, G, L = shape
    g = H if per_head else G
    tri = L * (L + 1) // 2
    nbytes = (Ba * T * H * P * itemsize * 2 + 2 * Ba * T * g * N * itemsize
              + Ba * T * H * 4 * 2 + Ba * (T // L) * H * N * P * 4)
    flop = Ba * (T // L) * (g * 2 * tri * N + H * (2 * tri * P + 2 * N * P * L))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flop / BF16_FLOP_PER_S if itemsize == 2
             else TF32_PRODUCTS * flop / TF32_FLOP_PER_S) * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return (*bound, flop / F32_FLOP_PER_S * 1e3)


def kernel_resources(lib, log) -> dict:
    """Per kernel of the library: registers and spill bytes from nvcc's
    ``-Xptxas -v`` log, and the count of TF32 tensor-core instructions
    (``HMMA`` ... ``TF32``) in its SASS (``cuobjdump -sass``; ``None`` where
    cuobjdump is missing).  Keys: the kernel's name and template arguments,
    cut out of the mangled symbol."""
    from repro_torch.kernels import _build

    def short(sym):
        m = re.search(r"\d+((?:ssd|swa)_\w+?)(E|I)(.*)", sym)
        if not m:
            return None
        if m.group(2) != "I":
            return m.group(1)
        targs = m.group(3).split("EEv")[0] + "E"   # the template arguments
        args = re.findall(r"Li(\d+)E", targs) or ["bf16" if "bfloat16" in targs else "f32"]
        return m.group(1) + f"<{','.join(args)}>"

    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = short(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if fn and m:
            out.setdefault(fn, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if fn and m:
            out.setdefault(fn, {})["registers"] = int(m.group(1))
            fn = None
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = (subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                           timeout=300).stdout if tool.exists() else None)
    for info in out.values():
        info["hmma_tf32"] = None if sass is None else 0
    fn = None
    for ln in (sass or "").splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = short(m.group(1))
        elif fn in out and "HMMA" in ln and "TF32" in ln:
            out[fn]["hmma_tf32"] += 1
    return out


def k7_phase(kssd, dev, gen) -> dict:
    """Phase 18: K7 against its plain version at every listed shape, f32 and
    bf16, each launch on the tensor cores and on the kernel the rule picks
    (bf16 on wgmma at every listed shape, f32 in 3xTF32; the wrapper raises
    where the C entry point's pick differs from the rule); then the kernel
    and the plain version timed in turns at the main paths' shapes
    (mamba2-1.3b's in bf16 and f32; jamba's, bf16).  Returns
    the max |err| of y_diag at the main paths' shapes, each shape's, and
    the times."""
    from repro_torch.kernels.ssd import ssd_intra_chunk_ref

    main_err, max_abs = 0.0, {}
    for shape in K7_SHAPES:
        for dt_name in ("bfloat16", "float32"):
            ins = k7_inputs(shape, getattr(torch, dt_name), gen, dev)
            b0 = dict(kssd.ssd_intra_chunk_cuda.by_kernel)
            got = kssd.ssd_intra_chunk_cuda(*ins, chunk=shape[-1])
            torch.cuda.synchronize()
            ran = "wgmma" if dt_name == "bfloat16" else "3xTF32"
            moved = {k: n - b0[k] for k, n in kssd.ssd_intra_chunk_cuda.by_kernel.items()}
            if moved != {k: int(k == ran) for k in kssd.KERNELS}:
                fail(f"K7 {shape} {dt_name}: launches by the kernel the C entry point "
                     f"reported {moved}, expected one on {ran}")
            want = ssd_intra_chunk_ref(*ins, chunk=shape[-1])
            errs = {}
            for name, a, b in zip(("y_diag", "states", "s"), got, want):
                if a.shape != b.shape or a.dtype != b.dtype:
                    fail(f"K7 {shape} {dt_name}: {name} is {tuple(a.shape)} {a.dtype}, "
                         f"expected {tuple(b.shape)} {b.dtype}")
                d = (a.float() - b.float()).abs().max().item()
                scale = b.float().abs().max().item()
                norm = d / scale if scale > 0 else d
                if not math.isfinite(norm) or norm > K7_TOL[dt_name][name]:
                    fail(f"K7 {shape} {dt_name}: {name} differs from the plain version, "
                         f"normwise {norm} > {K7_TOL[dt_name][name]}")
                errs[name] = (norm, d)
            if shape[-1] in (64, 50) and dt_name == "bfloat16":
                main_err = max(main_err, errs["y_diag"][1])
                max_abs[shape] = errs["y_diag"][1]
            say("ssd_kernel", shape="Ba,T,H,P,N,G,L=" + ",".join(map(str, shape)), dtype=dt_name,
                kernel=repr(ran), **{f"{k}_normwise": v[0] for k, v in errs.items()},
                **{f"{k}_max_abs": v[1] for k, v in errs.items()},
                tol=json.dumps(K7_TOL[dt_name]).replace(" ", ""))
            del ins, got, want
    # timed in turns at the main paths' shapes: plain, kernel, kernel, plain
    out = {"main_err": main_err}
    cases = [("mamba2", K7_MAIN, dt) for dt in ("bfloat16", "float32")]
    cases += [(case, shape, "bfloat16") for case, shape in K7_WIDTHS.items()]
    for case, shape, dt_name in cases:
        ins = k7_inputs(shape, getattr(torch, dt_name), gen, dev)
        L = shape[-1]
        k_ms, p_ms = [], []
        for who in ("plain", "kernel", "kernel", "plain"):
            if who == "plain":
                p_ms.append(cuda_time_ms(lambda: ssd_intra_chunk_ref(*ins, chunk=L), reps=3,
                                         warm=1))
            else:
                k_ms.append(cuda_time_ms(lambda: kssd.ssd_intra_chunk_cuda(*ins, chunk=L),
                                         reps=20))
        item = 2 if dt_name == "bfloat16" else 4
        bound, bound_by, f32_floor = k7_bound(shape, item)
        per_head, _, _ = k7_bound(shape, item, per_head=True)
        device_ms = graph_ms(lambda: kssd.ssd_intra_chunk_cuda(*ins, chunk=L))
        say("ssd_kernel_time", case=case, shape="Ba,T,H,P,N,G,L=" + ",".join(map(str, shape)),
            dtype=dt_name, kernel=repr(kssd.kernel_for(ins[0].dtype, shape[4], shape[3])),
            bc_form="grouped (G=1), C B^T once per group", ms_runs=k_ms, kernel_graph_ms=device_ms,
            plain_ms_runs=p_ms, bound_ms=bound, bound_by=bound_by,
            bound_ms_per_head_bc=per_head, share_of_bound=bound / min(k_ms),
            share_of_bound_graph=bound / device_ms, f32_cuda_core_floor_ms=f32_floor)
        if case == "mamba2":
            out[dt_name] = (min(k_ms), min(p_ms), bound, bound_by)
        else:
            out[case] = {"ms": min(k_ms), "plain_ms": min(p_ms), "library_ms": None,
                         "bound_ms": bound, "bound_by": bound_by, "max_abs_err": max_abs[shape]}
        del ins
    torch.cuda.empty_cache()
    return out


def logit_err(a, b, vocab: int) -> float:
    """Normwise difference of two logit arrays over the real vocabulary (the
    pad rows hold -1e30)."""
    a, b = a[..., :vocab].float(), b[..., :vocab].float()
    return (a - b).abs().max().item() / b.abs().max().item()


def mamba_small(kssd, dev) -> None:
    """Phase 19: the SMOKE width in f32 on the card, K7 against the chunked
    plain scan, the prefill/decode relation, and the same greedy ids."""
    import dataclasses

    from repro_torch.configs.mamba2_1p3b import SMOKE
    from repro_torch.models import Model
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Engine

    cfg = dataclasses.replace(SMOKE, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(1)
    model = Model(cfg, generator=gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (2, 21), generator=gen, device=dev)
    n0, t0 = kssd.ssd_intra_chunk_cuda.launches, kssd.ssd_intra_chunk_cuda.by_kernel["3xTF32"]
    lk, _ = tf.prefill(model, tokens[:, :20])
    if kssd.ssd_intra_chunk_cuda.launches - n0 != cfg.n_layers:
        fail(f"SMOKE prefill launched K7 {kssd.ssd_intra_chunk_cuda.launches - n0} times")
    if kssd.ssd_intra_chunk_cuda.by_kernel["3xTF32"] - t0 != cfg.n_layers:
        fail("an f32 launch of K7 did not run on the 3xTF32 kernel")
    lr, _ = tf.prefill(model, tokens[:, :20], use_kernel="ref")
    e_ref = logit_err(lk, lr, cfg.vocab)
    full, _ = tf.prefill(model, tokens)
    _, caches = tf.prefill(model, tokens[:, :20])
    step, _ = tf.decode_step(model, tokens[:, 20:], 20, caches)
    e_dec = logit_err(step, full, cfg.vocab)
    ids_k = Engine(cfg, model).generate(tokens[:, :20], 8)
    ids_r = Engine(cfg, model, use_kernel="ref").generate(tokens[:, :20], 8)
    if not (e_ref <= SERVE_TOL and e_dec <= SERVE_TOL and torch.equal(ids_k, ids_r)):
        fail(f"SMOKE on the card: K7 vs plain {e_ref}, prefill/decode {e_dec}, "
             f"ids equal {torch.equal(ids_k, ids_r)}")
    say("mamba2_small", cfg="SMOKE f32", prompt="2x20 (L=5)", k7_vs_plain_normwise=e_ref,
        prefill_vs_decode_normwise=e_dec, tol=SERVE_TOL, greedy_ids_equal=True, status="ok")


def generate_timed(eng, prompt, n_new: int):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = eng.generate(prompt, n_new)
    torch.cuda.synchronize()
    return ids, time.perf_counter() - t0


def generate_metrics(eng, p, n_new: int) -> dict:
    """Through Engine.generate: n_new=1 is prefill and the first id (the
    time to first token, median of 3); the rest are decode steps (the better
    of 2 full calls)."""
    torch.cuda.reset_peak_memory_stats()
    t1 = sorted(generate_timed(eng, p, 1)[1] for _ in range(3))[1]
    tn = sorted(generate_timed(eng, p, n_new)[1] for _ in range(2))[0]
    return {"ttft_ms": t1 * 1e3, "prefill_tokens_per_s": p.numel() / t1,
            "decode_ms_per_token": (tn - t1) / (n_new - 1) * 1e3, "generate_ms": tn * 1e3,
            "peak_GB": torch.cuda.max_memory_allocated() / 1e9}


def on_kernel(w, k7_kernel: str) -> int:
    """A K6 or K7 wrapper's launches of the kernel its dtype asks for, as
    the C entry point reported them: K6's on the tensor cores
    (``tc_launches``), K7's on ``k7_kernel`` (``by_kernel``)."""
    return w.by_kernel[k7_kernel] if hasattr(w, "by_kernel") else w.tc_launches


def generate_counted(phase: str, engines, prompts, runs, wrappers, vocab: int) -> list:
    """The main path (bf16): ``Engine.generate`` at each of ``runs`` (name,
    batch, prompt, new), the wrappers' counts zeroed just before and read
    just after, the ids checked for shape and range.  Returns, per call,
    each wrapper's (launches, launches of its bf16 kernel: K6's on the
    tensor cores, K7's on wgmma)."""
    for w in wrappers:
        w.launches = 0
        if hasattr(w, "by_kernel"):
            w.by_kernel = dict.fromkeys(w.by_kernel, 0)
        else:
            w.tc_launches = 0
    per_call = []
    for name, b, _, n_new in runs:
        before = [(w.launches, on_kernel(w, "wgmma")) for w in wrappers]
        ids = engines[name].generate(prompts[name], n_new)
        torch.cuda.synchronize()
        per_call.append([(w.launches - n, on_kernel(w, "wgmma") - c)
                         for w, (n, c) in zip(wrappers, before)])
        if ids.shape != (b, n_new) or int(ids.max()) >= vocab or int(ids.min()) < 0:
            fail(f"{phase} {name}: ids {tuple(ids.shape)}, range "
                 f"{int(ids.min())}..{int(ids.max())}")
    return per_call


def generate_times(phase: str, engines, prompts, runs) -> None:
    """Time to first token and decode ms per token of each run
    (:func:`generate_metrics`)."""
    for name, _, t, n_new in runs:
        say(phase, prompt=name, new_tokens=n_new, cache_len=engines[name].cache_len,
            **generate_metrics(engines[name], prompts[name], n_new))


def mamba_full(kssd, dev) -> tuple[int, int]:
    """Phase 20: mamba2-1.3b at full width and depth, bf16, through
    Engine.generate; returns K7's launches on this (main) path and those of
    them on the tensor cores."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.configs.base import Layer
    from repro_torch.models import Model
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Engine

    cfg = get("mamba2-1.3b")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = Model(cfg, generator=gen)
    torch.cuda.synchronize()
    say("mamba2_full", cfg=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=f"{cfg.vocab}->{cfg.padded_vocab}", params=sum(p.numel() for p in model.parameters()),
        dtype=cfg.dtype, materialize_s=time.perf_counter() - t0)
    eng = Engine(cfg, model)
    engines = {name: eng for name, *_ in SERVE_RUNS}
    prompts = {name: torch.randint(0, cfg.vocab, (b, t), generator=gen, device=dev)
               for name, b, t, _ in SERVE_RUNS}
    # the main path: two generate calls, counts zeroed just before, read just after
    per_call = generate_counted("mamba2_full", engines, prompts, SERVE_RUNS,
                                (kssd.ssd_intra_chunk_cuda,), cfg.vocab)
    launches = kssd.ssd_intra_chunk_cuda.launches
    wgmma_launches = kssd.ssd_intra_chunk_cuda.by_kernel["wgmma"]
    if per_call != [[(cfg.n_layers, cfg.n_layers)]] * len(SERVE_RUNS):
        fail(f"K7 (launches, wgmma launches) per generate call {per_call}; expected "
             f"{cfg.n_layers} each, all bf16 on the wgmma kernel")
    # decode launches no K7; logits finite
    with torch.inference_mode():
        logits, caches = tf.prefill(model, prompts["4x2048"])
        n0 = kssd.ssd_intra_chunk_cuda.launches
        step, caches = tf.decode_step(model, logits.argmax(-1, keepdim=True), 2048, caches)
        dec_launches = kssd.ssd_intra_chunk_cuda.launches - n0
    if dec_launches or not (torch.isfinite(logits[:, :cfg.vocab]).all()
                            and torch.isfinite(step[:, :cfg.vocab]).all()):
        fail(f"decode launched K7 {dec_launches} times, or non-finite logits")
    say("mamba2_full", k7_launches_per_generate=[c[0][0] for c in per_call],
        k7_tensor_core_launches_per_generate=[c[0][1] for c in per_call],
        k7_launches_in_decode=dec_launches, logits_finite=True)
    del logits, caches, step
    # timed through Engine.generate: n_new=1 is prefill and the first id (the
    # time to first token); the rest are decode steps
    generate_times("mamba2_full", engines, prompts, SERVE_RUNS)
    # where one prefill's device time goes
    kinds = (("k7", ("ssd_chunk_kernel", "ssd_chunk_kernel_tc")),
             ("matmul", ("gemm", "Gemm", "gemv", "nvjet", "xmma", "cutlass")),
             ("reduce", ("reduce",)), ("copy", ("copy", "Copy", "Memcpy", "cat")),
             ("elementwise", ("elementwise", "Elementwise")))
    p = prompts["4x2048"]
    with torch.inference_mode():
        tf.prefill(model, p)
        say("breakdown", config="mamba2-1.3b prefill 4x2048 bf16",
            **categories(lambda: tf.prefill(model, p), 1, kinds))
        logits, caches = tf.prefill(model, p)
        cur = logits.argmax(-1, keepdim=True)
        tf.decode_step(model, cur, 2048, caches)
        say("breakdown", config="mamba2-1.3b decode step, batch 4, bf16",
            **categories(lambda: tf.decode_step(model, cur, 2048, caches), 1, kinds))
        del logits, caches
        # the inter-chunk recurrence and Y_off around K7, one layer's shape, CUDA events
        ins = k7_inputs(K7_MAIN, torch.bfloat16, gen, dev)
        full_ms = cuda_time_ms(lambda: kssd.ssd_kernel(*ins, chunk=64), reps=10)
        k7_ms = cuda_time_ms(lambda: kssd.ssd_intra_chunk_cuda(*ins, chunk=64), reps=10)
    say("breakdown", config="one layer's SSD at 4x2048", ssd_scan_ms=full_ms, k7_ms=k7_ms,
        inter_chunk_and_y_off_ms=full_ms - k7_ms, per_prefill_ms=cfg.n_layers * full_ms)
    del model, eng, engines, ins
    torch.cuda.empty_cache()

    # four layers of the full width in f32: K7 against the plain scan, and the
    # prefill/decode relation, at a 1000-token prompt (L = 50)
    cfg4 = dataclasses.replace(cfg, stacks=(((Layer(mixer="mamba", ffn=False),), 4),),
                               dtype="float32")
    m4 = Model(cfg4, generator=torch.Generator(device=dev).manual_seed(2))
    tok = torch.randint(0, cfg.vocab, (2, 1001), generator=gen, device=dev)
    with torch.inference_mode():
        lk, caches = tf.prefill(m4, tok[:, :1000])
        lr, _ = tf.prefill(m4, tok[:, :1000], use_kernel="ref")
        step, _ = tf.decode_step(m4, tok[:, 1000:], 1000, caches)
        longer, _ = tf.prefill(m4, tok)
    e_ref, e_dec = logit_err(lk, lr, cfg.vocab), logit_err(step, longer, cfg.vocab)
    if not (e_ref <= SERVE_TOL and e_dec <= SERVE_TOL):
        fail(f"4 layers f32: K7 vs plain {e_ref}, prefill/decode {e_dec} > {SERVE_TOL}")
    say("mamba2_full", check="4 layers full width f32, prompt 2x1000", k7_vs_plain_normwise=e_ref,
        prefill_vs_decode_normwise=e_dec, tol=SERVE_TOL, status="ok")
    del m4, caches, step, longer
    # the same four layers in bf16 (the f32 weights rounded): prefill logits
    # through K7 on the tensor cores against the plain path
    m4 = Model(dataclasses.replace(cfg4, dtype="bfloat16"),
               generator=torch.Generator(device=dev).manual_seed(2))
    with torch.inference_mode():
        w0 = kssd.ssd_intra_chunk_cuda.by_kernel["wgmma"]
        lk16, _ = tf.prefill(m4, tok[:, :1000])
        wg_n = kssd.ssd_intra_chunk_cuda.by_kernel["wgmma"] - w0
        lr16, _ = tf.prefill(m4, tok[:, :1000], use_kernel="ref")
    e16, e_round = logit_err(lk16, lr16, cfg.vocab), logit_err(lr16, lr, cfg.vocab)
    if wg_n != 4 or not e16 <= K7_BF16_LOGIT_TOL:
        fail(f"4 layers bf16: K7 vs plain {e16} (tol {K7_BF16_LOGIT_TOL}), "
             f"{wg_n} wgmma launches of 4")
    say("mamba2_full", check="4 layers full width bf16, prompt 2x1000",
        k7_vs_plain_normwise=e16, plain_bf16_vs_plain_f32_normwise=e_round,
        tol=K7_BF16_LOGIT_TOL, wgmma_launches=wg_n, status="ok")
    del m4
    torch.cuda.empty_cache()
    return launches, wgmma_launches


def serving_phases(dev) -> list:
    import importlib

    kssd = importlib.import_module("repro_torch.kernels.ssd.kernel")
    gen = torch.Generator(device=dev).manual_seed(3)
    # ---- 18. K7 against its plain version, then timed -----------------------
    k7 = k7_phase(kssd, dev, gen)
    # ---- 19-20. the serving path: the count zeroed just before, read after --
    kssd.ssd_intra_chunk_cuda.launches = 0
    mamba_small(kssd, dev)
    launches, wgmma_launches = mamba_full(kssd, dev)
    ms, plain_ms, bound, bound_by = k7["bfloat16"]
    return [{"name": "ssd_intra_chunk", "route": "cuda",
             "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu", "replaces": K7_REPLACES,
             "launches": launches, "wgmma_launches": wgmma_launches, "max_abs_err": k7["main_err"],
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
             "library_ms": None, "widths": {case: k7[case] for case in K7_WIDTHS}}]


# ---------------------------------------------------------------------------
# the gemma3 slice: K6 and the attention serving path
# ---------------------------------------------------------------------------

K6_REPLACES = "src/repro/kernels/swa/kernel.py:90"
# K6's tolerances, normwise (max |kernel - plain| <= tol * max |plain|): f32 is
# the summation order of up to D + S float32 terms and the online softmax's
# rescaling; in bf16 the plain version rounds q * scale, the logits and the
# normalised probabilities to bf16 where the tensor-core kernel keeps the
# logits float32 and rounds the unnormalised probabilities (the CPU tests of
# tests/test_torch_swa.py hold both against a float64 model of the kernel's
# rounding)
K6_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# and, in bf16, the relative Frobenius error ||kernel - plain|| / ||plain||,
# which no few large outputs can hide: the plain version lies within 7.5e-3
# (at most 5.0e-3) of the float64 model of the kernel's rounding at every CPU
# case of tests/test_torch_swa.py, so 1e-2 is twice the most that rounding
# alone gave there
K6_FRO_TOL = 1e-2
# chosen by the dtype alone: bf16 wgmma, f32 3xTF32, both on the tensor cores
K6_KERNEL = {"float32": "tensor cores", "bfloat16": "tensor cores"}
# B, H, Hkv, T, S, D, window: the cases of tests/test_kernel_swa.py (windows
# 4/16/64/10000, GQA 8 -> 2, queries offset into a longer kv sequence, its bf16
# case), ragged T of 1, 5, 50, 1000 and 1500 at gemma3-4b's heads, the edges
# of the tensor-core kernel's tile rule (T 5 of S 77 at window 3, T 333 of S
# 1000 at window 200; each in q tiles of 64 and of 128 rows, the launcher
# taking 128 when the grid fills the card's SMs), and the main paths' prefill
# shapes: gemma3-4b's 4 x 2048 (window 1024 and window = S) and 1 x 1000, and
# those of the MoE models' global layers at their head widths (64, 128, and
# 112 padded to 128)
K6_MAIN = (4, 8, 4, 2048, 2048, 256, 1024)
K6_GLOBAL = (4, 8, 4, 2048, 2048, 256, 2048)
K6_WIDTHS = {"granite D64 4x2048": (4, 24, 8, 2048, 2048, 64, 2048),
             "granite D64 1x1000": (1, 24, 8, 1000, 1000, 64, 1000),
             "jamba D128 4x2048": (4, 32, 8, 2048, 2048, 128, 2048),
             "kimi D112 1x1000": (1, 64, 8, 1000, 1000, 112, 1000)}
K6_PATH = (K6_MAIN, K6_GLOBAL, (1, 8, 4, 1000, 1000, 256, 1024), (1, 8, 4, 1000, 1000, 256, 1000),
           *K6_WIDTHS.values())
K6_SHAPES = tuple((2, 4, 2, 64, 64, 32, w) for w in (4, 16, 64, 10000)) + (
    (1, 8, 2, 32, 32, 16, 16), (1, 4, 4, 16, 128, 32, 8), (1, 4, 4, 16, 128, 32, 48),
    (1, 4, 4, 16, 128, 32, 128), (1, 2, 1, 64, 64, 64, 32), (1, 8, 4, 1, 1, 256, 1024),
    (1, 8, 4, 5, 5, 256, 1024), (1, 8, 4, 50, 50, 256, 1024), (2, 8, 4, 1500, 1500, 256, 1024),
    (1, 8, 4, 333, 1000, 256, 200), (6, 8, 4, 333, 1000, 256, 200), (1, 2, 1, 5, 77, 64, 3),
    (17, 8, 4, 5, 77, 64, 3)) + K6_PATH
SERVE_RUNS = (("4x2048", 4, 2048, 32), ("1x1000", 1, 1000, 16))   # name, batch, prompt, new


def k6_inputs(shape, dtype, gen, dev):
    """q (B, H, T, D), k/v (B, Hkv, S, D) as views of (B, T, H, D)
    projections, as the attention layer passes them."""
    B, H, Hkv, T, S, D, _ = shape
    q = torch.randn(B, T, H, D, generator=gen, device=dev).to(dtype).transpose(1, 2)
    k = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dtype).transpose(1, 2)
    v = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dtype).transpose(1, 2)
    return q, k, v


def k6_bound(shape, itemsize: int) -> tuple[float, str, float]:
    """Least time (ms) of one K6 launch: q, k, v read once and the output
    written once over the memory rate, or 4 D operations per unmasked
    (query, key) pair of these shapes over the rate of the kernel's
    products (bf16 on the tensor cores; float32 as three TF32 products on
    the tensor cores, 3 x FLOP over the TF32 peak).  Also returns the
    float32 CUDA-core floor of the same operations."""
    B, H, Hkv, T, S, D, window = shape
    w = min(window, S)
    pairs = int(np.minimum(np.arange(T) + (S - T) + 1, w).sum())
    flop = 4 * D * pairs * B * H
    t_bytes = (2 * B * H * T * D + 2 * B * Hkv * S * D) * itemsize / HBM_BYTES_PER_S * 1e3
    t_ops = (flop / BF16_FLOP_PER_S if itemsize == 2
             else TF32_PRODUCTS * flop / TF32_FLOP_PER_S) * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return (*bound, flop / F32_FLOP_PER_S * 1e3)


def graph_ms(fn, reps: int = 20) -> float:
    """Device time (ms) per call of ``fn``: ``reps`` calls captured in one
    CUDA graph and replayed, so no host time lies between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    ms = cuda_time_ms(graph.replay, reps=5) / reps
    del graph
    return ms


def normwise(got, want) -> tuple[float, float]:
    d = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return (d / scale if scale > 0 else d), d


def frobenius(got, want) -> float:
    """||got - want||_F / ||want||_F (the difference's norm where want is 0)."""
    d = torch.linalg.vector_norm(got.float() - want.float()).item()
    scale = torch.linalg.vector_norm(want.float()).item()
    return d / scale if scale > 0 else d


def k6_phase(kswa, dev, gen) -> dict:
    """Phase 21: K6 against its plain version at every listed shape, bf16
    (the wgmma kernel; normwise and relative Frobenius) and f32 (the 3xTF32
    kernel), each launch checked to have run on the tensor cores; then K6, the plain version
    and one library call timed in turns at the main paths' shapes (gemma3's
    4 x 2048 at window 1024 and global, bf16 and f32; its 1 x 1000 and the
    MoE models' shapes, bf16).  Returns the max |err| over the main paths'
    bf16 shapes, each shape's, and the times."""
    from repro_torch.kernels.swa import swa_ref

    main_err = main_norm = main_fro = 0.0
    max_abs = {}
    for shape in K6_SHAPES:
        for dt_name in ("bfloat16", "float32"):
            q, k, v = k6_inputs(shape, getattr(torch, dt_name), gen, dev)
            n0 = kswa.swa_attention_cuda.tc_launches
            got = kswa.swa_attention_cuda(q, k, v, window=shape[-1])
            torch.cuda.synchronize()
            ran = "tensor cores" if kswa.swa_attention_cuda.tc_launches == n0 + 1 else "CUDA cores"
            if ran != K6_KERNEL[dt_name]:
                fail(f"K6 {shape} {dt_name}: ran on the {ran}, expected the {K6_KERNEL[dt_name]}")
            want = swa_ref(q, k, v, window=shape[-1])
            if got.shape != want.shape or got.dtype != want.dtype:
                fail(f"K6 {shape} {dt_name}: gave {tuple(got.shape)} {got.dtype}")
            norm, d = normwise(got, want)
            if not math.isfinite(norm) or norm > K6_TOL[dt_name]:
                fail(f"K6 {shape} {dt_name}: differs from the plain version, normwise {norm} > "
                     f"{K6_TOL[dt_name]}")
            fro = frobenius(got, want)
            if dt_name == "bfloat16" and not fro <= K6_FRO_TOL:
                fail(f"K6 {shape} {dt_name}: differs from the plain version, relative "
                     f"Frobenius {fro} > {K6_FRO_TOL}")
            if shape in K6_PATH and dt_name == "bfloat16":
                main_err, main_norm = max(main_err, d), max(main_norm, norm)
                main_fro, max_abs[shape] = max(main_fro, fro), d
            say("swa_kernel", shape="B,H,Hkv,T,S,D,window=" + ",".join(map(str, shape)),
                dtype=dt_name, kernel=repr(ran), normwise=norm, max_abs=d, frobenius=fro,
                tol=K6_TOL[dt_name], frobenius_tol=K6_FRO_TOL if dt_name == "bfloat16" else None)
            del q, k, v, got, want
    say("swa_kernel", main_path_bf16_max_abs=main_err, main_path_bf16_normwise=main_norm,
        main_path_bf16_frobenius=main_fro, status="ok")
    # timed in turns at the main path's shapes: plain, kernel, library, kernel, plain, library
    import torch.nn.functional as F

    out = {"main_err": main_err, "max_abs": max_abs}
    for name, shape in (("window", K6_MAIN), ("global", K6_GLOBAL), ("1x1000", K6_PATH[2]),
                        *K6_WIDTHS.items()):
        B, H, Hkv, T, S, D, w = shape
        for dt_name in ("bfloat16", "float32") if name in ("window", "global") else ("bfloat16",):
            q, k, v = k6_inputs(shape, getattr(torch, dt_name), gen, dev)
            if w < T:
                qpos = torch.arange(T, device=dev)[:, None] + (S - T)
                kpos = torch.arange(S, device=dev)[None, :]
                band = (kpos <= qpos) & (kpos > qpos - w)
                lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=band,  # noqa: E731
                                                             enable_gqa=True)
            else:
                lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,  # noqa: E731
                                                             enable_gqa=True)
            lib_err, _ = normwise(lib(), kswa.swa_attention_cuda(q, k, v, window=w))
            if lib_err > K6_TOL[dt_name]:
                fail(f"K6 {name} {dt_name}: the library call computes another function "
                     f"({lib_err})")
            times = {"plain": [], "kernel": [], "library": []}
            for who in ("plain", "kernel", "library", "kernel", "plain", "library"):
                fn = {"plain": lambda: swa_ref(q, k, v, window=w), "library": lib,
                      "kernel": lambda: kswa.swa_attention_cuda(q, k, v, window=w)}[who]
                times[who].append(cuda_time_ms(fn, reps=5 if who == "plain" else 20,
                                               warm=1 if who == "plain" else 3))
            item = 2 if dt_name == "bfloat16" else 4
            bound, bound_by, f32_floor = k6_bound(shape, item)
            ms = min(times["kernel"])
            device_ms = graph_ms(lambda: kswa.swa_attention_cuda(q, k, v, window=w))
            say("swa_kernel_time", case=name, shape="B,H,Hkv,T,S,D,window=" + ",".join(
                map(str, shape)), dtype=dt_name, ms_runs=times["kernel"],
                kernel_graph_ms=device_ms,
                plain_ms_runs=times["plain"], library_ms_runs=times["library"],
                library="scaled_dot_product_attention(" + ("band mask" if w < T
                                                           else "is_causal") + ", enable_gqa)",
                library_vs_kernel_normwise=lib_err, bound_ms=bound, bound_by=bound_by,
                share_of_bound=bound / ms, f32_cuda_core_floor_ms=f32_floor,
                share_of_f32_floor=f32_floor / ms)
            out[(name, dt_name)] = (ms, min(times["plain"]), min(times["library"]), bound,
                                    bound_by)
            del q, k, v
    torch.cuda.empty_cache()
    return out


def serve_small(phase: str, smoke, kswa, kssd, dev) -> None:
    """A config's SMOKE width in f32 on the card, its kernels (K6 in 3xTF32 on
    the tensor cores, and K7 for Mamba layers, 3xTF32 on the tensor cores) against the
    plain path:
    train-mode logits; prefill logits at prompts of 5, 8 and 12 tokens
    (below, at and above gemma3's window of 8), each prefill launching K6
    once per attention layer and K7 once per Mamba layer; every decode step
    after each against the plain path's and, where the config has no MoE
    layer, against the train-mode logits (an MoE layer's capacity follows
    the tokens of the call, so a decode step may keep pairs that the whole
    sequence drops); the same greedy ids through Engine.generate."""
    import dataclasses

    from repro_torch.models import Model
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Engine

    cfg = dataclasses.replace(smoke, dtype="float32", max_seq=32)
    gen = torch.Generator(device=dev).manual_seed(1)
    model = Model(cfg, generator=gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (2, 21), generator=gen, device=dev)
    wrappers = (kswa.swa_attention_cuda, kssd.ssd_intra_chunk_cuda)
    want = [sum(layer.mixer in ("attn", "swa") for layer in cfg.layers_flat),
            sum(layer.mixer == "mamba" for layer in cfg.layers_flat)]
    h, _, _ = tf.fwd(model, tokens, mode="train", use_kernel="ref")
    full = tf.logits_fn(model, h)
    h, _, _ = tf.fwd(model, tokens, mode="train")
    e_train = logit_err(tf.logits_fn(model, h), full, cfg.vocab)
    e_pre = e_dec = 0.0
    n_all = [w.launches for w in wrappers]
    tc0 = [on_kernel(w, "3xTF32") for w in wrappers]
    for tp in (5, 8, 12):
        n0 = [w.launches for w in wrappers]
        lk, ck = tf.prefill(model, tokens[:, :tp], cache_len=24)
        got = [w.launches - n for w, n in zip(wrappers, n0)]
        if got != want:
            fail(f"{phase}: a prefill launched K6/K7 {got} times, expected {want}")
        lr, cr = tf.prefill(model, tokens[:, :tp], cache_len=24, use_kernel="ref")
        e_pre = max(e_pre, logit_err(lk, lr, cfg.vocab))
        for t in range(tp, 21):
            n0 = [w.launches for w in wrappers]
            sk, ck = tf.decode_step(model, tokens[:, t:t + 1], t, ck)
            sr, cr = tf.decode_step(model, tokens[:, t:t + 1], t, cr, use_kernel="ref")
            if [w.launches for w in wrappers] != n0:
                fail(f"{phase}: a decode step launched K6 or K7")
            e_dec = max(e_dec, logit_err(sk, sr, cfg.vocab))
            if cfg.moe is None:
                e_dec = max(e_dec, logit_err(sk, full[:, t], cfg.vocab))
    ids_k = Engine(cfg, model, cache_len=24).generate(tokens[:, :12], 8)
    ids_r = Engine(cfg, model, cache_len=24, use_kernel="ref").generate(tokens[:, :12], 8)
    ran = [(w.launches - n, on_kernel(w, "3xTF32") - c) for w, n, c in zip(wrappers, n_all, tc0)]
    if ran[0][1] != ran[0][0] or ran[1][1] != ran[1][0]:
        fail(f"{phase}: (launches, launches on the f32 kernel) of K6 and K7 in f32 {ran}; "
             "every launch of either runs on the tensor cores, K7's on its 3xTF32 kernel")
    if not (max(e_train, e_pre, e_dec) <= SERVE_TOL and torch.equal(ids_k, ids_r)):
        fail(f"{phase} on the card: kernels vs plain train {e_train}, prefill {e_pre}, decode "
             f"{e_dec}, ids equal {torch.equal(ids_k, ids_r)}")
    say(phase, cfg=f"{smoke.name} f32", prompts="2x5,2x8,2x12",
        kernels_vs_plain_train_normwise=e_train, kernels_vs_plain_prefill_normwise=e_pre,
        decode_vs_plain_normwise=e_dec, tol=SERVE_TOL, greedy_ids_equal=True,
        kernels="'K6 and K7 tensor cores (3xTF32)'", status="ok")


def gemma3_full(kswa, dev) -> int:
    """Phase 23: gemma3-4b at full width and depth, bf16, through
    Engine.generate (cache_len = prompt + new tokens); returns K6's launches
    on this (main) path."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.models import Model
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Engine

    cfg = get("gemma3-4b")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = Model(cfg, generator=gen)
    torch.cuda.synchronize()
    n_swa = sum(l.mixer == "swa" for l in cfg.layers_flat)
    say("gemma3_full", cfg=cfg.name, layers=cfg.n_layers, window_layers=n_swa,
        global_layers=cfg.n_layers - n_swa, d_model=cfg.d_model, heads=f"{cfg.n_heads}x"
        f"{cfg.head_dim} kv {cfg.n_kv}", d_ff=cfg.d_ff, vocab=cfg.vocab,
        params=sum(p.numel() for p in model.parameters()), dtype=cfg.dtype,
        materialize_s=time.perf_counter() - t0)
    prompts = {name: torch.randint(0, cfg.vocab, (b, t), generator=gen, device=dev)
               for name, b, t, _ in SERVE_RUNS}
    engines = {name: Engine(cfg, model, cache_len=t + n) for name, _, t, n in SERVE_RUNS}
    # the main path: two generate calls, counts zeroed just before, read just after
    per_call = generate_counted("gemma3_full", engines, prompts, SERVE_RUNS,
                                (kswa.swa_attention_cuda,), cfg.vocab)
    launches = kswa.swa_attention_cuda.launches
    if per_call != [[(cfg.n_layers, cfg.n_layers)]] * len(SERVE_RUNS):
        fail(f"K6 (launches, tensor-core launches) per generate call {per_call}; expected "
             f"{cfg.n_layers} each, all bf16 on the tensor cores")
    # decode launches no K6; logits finite; the caches' shapes
    name, b, t, n_new = SERVE_RUNS[0]
    p, S = prompts[name], t + n_new
    with torch.inference_mode():
        logits, caches = tf.prefill(model, p, cache_len=S)
        n0 = kswa.swa_attention_cuda.launches
        step, caches = tf.decode_step(model, logits.argmax(-1, keepdim=True), t, caches)
        dec_launches = kswa.swa_attention_cuda.launches - n0
    shapes = sorted({tuple(c["mixer"]["k"].shape) for c in caches})
    want = sorted({(b, min(cfg.layers_flat[0].window, S), cfg.n_kv, cfg.head_dim),
                   (b, S, cfg.n_kv, cfg.head_dim)})
    if dec_launches or shapes != want or not (torch.isfinite(logits).all()
                                              and torch.isfinite(step).all()):
        fail(f"decode launched K6 {dec_launches} times, cache shapes {shapes} (expected "
             f"{want}), or non-finite logits")
    say("gemma3_full", k6_launches_per_generate=[c[0][0] for c in per_call],
        k6_tensor_core_launches_per_generate=[c[0][1] for c in per_call],
        k6_launches_in_decode=dec_launches, cache_shapes=repr(shapes).replace(" ", ""),
        logits_finite=True)
    del logits, caches, step
    # timed through Engine.generate: n_new=1 is prefill and the first id (the
    # time to first token); the rest are decode steps
    generate_times("gemma3_full", engines, prompts, SERVE_RUNS)
    # where one prefill's and one decode step's device time goes
    kinds = (("k6", ("swa_kernel",)),
             ("matmul", ("gemm", "Gemm", "gemv", "nvjet", "xmma", "cutlass")),
             ("reduce", ("reduce",)), ("copy", ("copy", "Copy", "Memcpy", "cat", "index")),
             ("elementwise", ("elementwise", "Elementwise")))
    with torch.inference_mode():
        tf.prefill(model, p, cache_len=S)
        say("breakdown", config=f"gemma3-4b prefill {name} bf16",
            **categories(lambda: tf.prefill(model, p, cache_len=S), 1, kinds))
        logits, caches = tf.prefill(model, p, cache_len=S)
        cur = logits.argmax(-1, keepdim=True)
        tf.decode_step(model, cur, t, caches)
        say("breakdown", config=f"gemma3-4b decode step, batch {b}, cache {S}, bf16",
            **categories(lambda: tf.decode_step(model, cur, t, caches), 1, kinds))
        del logits, caches
    del model, engines
    torch.cuda.empty_cache()

    # four layers of the full width in f32 (3 window, 1 global): K6 against the
    # plain path, and the prefill/decode relation, at a 1500-token prompt
    swa_l, attn_l = cfg.layers_flat[0], cfg.layers_flat[5]
    cfg4 = dataclasses.replace(cfg, stacks=(((swa_l,) * 3 + (attn_l,), 1),), dtype="float32")
    m4 = Model(cfg4, generator=torch.Generator(device=dev).manual_seed(2))
    tok = torch.randint(0, cfg.vocab, (2, 1501), generator=gen, device=dev)
    with torch.inference_mode():
        lk, caches = tf.prefill(m4, tok[:, :1500], cache_len=1501)
        lr, _ = tf.prefill(m4, tok[:, :1500], cache_len=1501, use_kernel="ref")
        step, _ = tf.decode_step(m4, tok[:, 1500:], 1500, caches)
        longer, _ = tf.prefill(m4, tok, use_kernel="ref")
    e_ref, e_dec = logit_err(lk, lr, cfg.vocab), logit_err(step, longer, cfg.vocab)
    if not (e_ref <= SERVE_TOL and e_dec <= SERVE_TOL):
        fail(f"4 layers f32: K6 vs plain {e_ref}, prefill/decode {e_dec} > {SERVE_TOL}")
    say("gemma3_full", check="4 layers (3 window, 1 global) full width f32, prompt 2x1500",
        k6_vs_plain_normwise=e_ref, prefill_vs_decode_normwise=e_dec, tol=SERVE_TOL,
        status="ok")
    del m4
    torch.cuda.empty_cache()
    return launches


def gemma3_phases(dev) -> list:
    import importlib

    from repro_torch.configs.gemma3_4b import SMOKE

    kswa = importlib.import_module("repro_torch.kernels.swa.kernel")
    kssd = importlib.import_module("repro_torch.kernels.ssd.kernel")
    gen = torch.Generator(device=dev).manual_seed(4)
    # ---- 21. K6 against its plain version, then timed -----------------------
    k6 = k6_phase(kswa, dev, gen)
    # ---- 22-23. the attention serving path: the counts zeroed just before ---
    kswa.swa_attention_cuda.launches = kswa.swa_attention_cuda.tc_launches = 0
    serve_small("gemma3_small", SMOKE, kswa, kssd, dev)
    launches = gemma3_full(kswa, dev)
    ms, plain_ms, library_ms, bound, bound_by = k6[("window", "bfloat16")]
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    widths = {case: {**dict(zip(keys, k6[(case, "bfloat16")])),
                     "max_abs_err": k6["max_abs"][shape]} for case, shape in K6_WIDTHS.items()}
    return [{"name": "swa_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/swa/csrc/swa.cu", "replaces": K6_REPLACES,
             "launches": launches, "max_abs_err": k6["main_err"], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
             "library_ms": library_ms, "widths": widths}]


# ---------------------------------------------------------------------------
# the two-phase slice: K2-K5 center with a Helmholtz shift, TwoPhase3D
# ---------------------------------------------------------------------------

CALL_LIMIT_S = 1200.0          # the card call's limit on the whole script, build included
SHIFT_OPS = ("apply", "residual", "jacobi", "cheb")
# a shifted launch reads the shift once more (K2 4 words, K3 5, K4 6, K5 8 /
# 7) and multiplies it by u0 (one operation more)
SHIFT_WORDS = {op: w + 1 for op, w in SOLVER_WORDS.items()}
SHIFT_FLOP_PER_CELL = {op: n + 1 for op, n in SOLVER_FLOP_PER_CELL.items()}
# the reference's per-step pressure iterations at TwoPhase3D(nx=16, ny=12,
# nz=12, dims=(2, 2, 2), tol=1e-8), 5 steps (tests/test_convergence_regression.py
# pins the classic ones; the pipelined ones from the reference on the CPU)
TWOPHASE_ITERATIONS = {("cg", "classic"): [9] * 5, ("mgcg", "classic"): [5, 5, 5, 4, 4],
                       ("cg", "pipelined"): [10] * 5, ("mgcg", "pipelined"): [6, 6, 6, 5, 5]}
TWOPHASE_FULL = (("1x514^3", 514, (1, 1, 1)), ("8x258^3", 258, (2, 2, 2)))   # 135.8M cells
TWOPHASE_KINDS = (("K2", ("apply_kernel<",)), ("K3", ("residual_kernel<",)),
                  ("K4", ("jacobi_kernel<",)), ("K5", ("cheb_kernel<",))) + SOLVER_KINDS[2:]


def shift_bound(op: str, n_cells: int, n_interior: int, itemsize: int = 8):
    """Least time (ms) of one shifted launch: bytes or f64 operations."""
    t_bytes = SHIFT_WORDS[op] * n_cells * itemsize / HBM_BYTES_PER_S * 1e3
    t_ops = SHIFT_FLOP_PER_CELL[op] * n_interior / F64_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def shift_counts(sk) -> dict:
    """(launches, shifted launches) of K2-K5 center."""
    return {k: (getattr(sk, f"{k}_cuda").launches, getattr(sk, f"{k}_cuda").shifted_launches)
            for k in SHIFT_OPS}


def shift_diff(a: dict, b: dict) -> dict:
    return {k: (a[k][0] - b[k][0], a[k][1] - b[k][1]) for k in a}


def remaining_s() -> float:
    return CALL_LIMIT_S - (time.perf_counter() - T_START)


def shift_kernel_phase(sk, rand, full=TWOPHASE_FULL, n_time: int = 514) -> dict:
    """Phase 24: shifted K2-K5 against their plain versions in f32 and f64 at
    small shapes, strided views and every level of the two-phase
    hierarchies the full-size runs build; then each alone at the finest
    level, in turns.  Returns max |err| per kernel and the times."""
    from repro_torch.apps import TwoPhase3D
    from repro_torch.solvers import level_spacings

    errs, level_errs, main_errs = {}, {}, {}
    n0 = shift_counts(sk)
    for dtype in (torch.float32, torch.float64):
        sp = (0.5, 0.7, 1.1)
        for shape in ((1, 10, 10, 10), (8, 34, 18, 66)):
            inputs = solver_inputs(sk, shape, dtype, rand, sp, shifted=True)
            e = check_solver_kernels(sk, inputs, sp, SOLVER_TOL[dtype], f"shift {dtype} {shape}")
            errs[f"{str(dtype)[6:]}:{shape}".replace(" ", "")] = max(e.values())
        inputs = tuple(t[..., 3:15, :, 5:30] for t in solver_inputs(
            sk, (2, 2, 2, 18, 10, 34), dtype, rand, sp, shifted=True))
        e = check_solver_kernels(sk, inputs, sp, SOLVER_TOL[dtype], f"shift {dtype} strided")
        errs[f"{str(dtype)[6:]}:strided"] = max(e.values())
        # the main path's own shapes: every level of both two-phase hierarchies
        for name, n, dims in full:
            app = TwoPhase3D(nx=n, ny=n, nz=n, dims=dims, method="mgcg", dtype=dtype)
            grids = app.grid.hierarchy()
            for g, hs in zip(grids, level_spacings(app.grid, grids, app.spacing)):
                level = f"{str(dtype)[6:]}:{math.prod(g.dims)}x{g.local_shape[0]}^3"
                inputs = solver_inputs(sk, g.shape, dtype, rand, hs, shifted=True)
                e = check_solver_kernels(sk, inputs, hs, SOLVER_TOL[dtype], f"shift {level}")
                level_errs[level] = max(e.values())
                if dtype == torch.float64:
                    main_errs = {k: max(v, main_errs.get(k, 0.0)) for k, v in e.items()}
                del inputs
            del app
            torch.cuda.empty_cache()
    launched = shift_diff(shift_counts(sk), n0)
    if any(n != ns or n == 0 for n, ns in launched.values()):
        fail(f"shifted checks: launches (all, shifted) {launched}")
    say("shift_kernel", small=json.dumps(errs).replace(" ", ""),
        main_path_levels=json.dumps(level_errs).replace(" ", ""),
        main_path_max=json.dumps(main_errs).replace(" ", ""),
        shifted_launches=json.dumps({k: v[1] for k, v in launched.items()}).replace(" ", ""),
        status="ok")

    # each shifted kernel alone at the finest level (1 x 514^3 f64), in turns
    h = 10.0 / (n_time - 1)
    sp = (h, h, h)
    inputs = solver_inputs(sk, (1, n_time, n_time, n_time), torch.float64, rand, sp,
                           shifted=True)
    n = inputs[0].numel()
    n_in = interior_cells(inputs[0].shape)
    calls = solver_calls(sk, inputs, tuple(x * x for x in sp), sp)
    ops = ("apply", "residual", "jacobi", "cheb_first", "cheb")
    t = {op: [] for op in ops}
    for _ in range(2):
        for op in ops:
            t[op].append(cuda_time_ms(calls[op][0], reps=20))
    times = {}
    for op in ops:
        plain = cuda_time_ms(calls[op][1], reps=3, warm=1)
        ms = min(t[op])
        bound, bound_by = shift_bound(op, n, n_in)
        say("shift_kernel", op=op, shape=f"1x{n_time}^3", dtype="float64", ms_runs=t[op],
            plain_ms=plain, bound_ms=bound, bound_by=bound_by, share_of_bound=bound / ms,
            achieved_GBps=SHIFT_WORDS[op] * n * 8 / ms / 1e6)
        times[op] = (ms, plain, bound, bound_by)
    del inputs, calls
    torch.cuda.empty_cache()
    return {"errs": main_errs, "times": times}


def path_launches(method: str, variant: str, its, levels: int) -> dict:
    """K2-K5 launches of an implicit TwoPhase3D run with per-step counts
    ``its`` (every one of them shifted): the solver code's counts per solve
    (``expected_launches``); one K2 per operator application, with or
    without overlap."""
    name = ("pipe" if variant == "pipelined" else "") + method
    out = {k: 0 for k in SHIFT_OPS}
    for k in its:
        for op, v in expected_launches(name, k, levels).items():
            out[op] += v
    return out


def twophase_small(sk) -> None:
    """Phase 25: the two-phase path at the reference's test sizes: per-step
    iterations equal to the reference's with every K2-K4 launch shifted,
    periodic 1 against 8 ranks, the explicit integrator against its oracle
    with and without hide, the overlap operator (``hide_apply``) against the plain one."""
    from repro_torch import fields
    from repro_torch.apps import TwoPhase3D
    from repro_torch.apps.twophase_ops import pressure_apply

    kw = dict(nx=16, ny=12, nz=12, dims=(2, 2, 2), tol=1e-8)
    for (method, variant), want in TWOPHASE_ITERATIONS.items():
        app = TwoPhase3D(**kw, method=method, variant=variant)
        levels = len(app.grid.hierarchy())
        n0 = shift_counts(sk)
        S, infos = app.run(5)
        got = shift_diff(shift_counts(sk), n0)
        its = [i.iterations for i in infos]
        if its != want or not all(i.converged for i in infos):
            fail(f"twophase {method} {variant}: iterations {its}, the reference takes {want}")
        exp = path_launches(method, variant, its, levels)
        if {k: v[0] for k, v in got.items()} != exp or any(n != ns for n, ns in got.values()):
            fail(f"twophase {method} {variant}: launches (all, shifted) {got}, the solver's "
                 f"code makes {exp}, all shifted")
        Pe_o, phi_o = app.oracle(5)
        Pe, phi = fields.gather(S.Pe), fields.gather(S.phi)
        err_pe = float(np.abs(Pe - Pe_o).max() / np.abs(Pe_o).max())
        err_phi = float(np.abs(phi - phi_o).max())
        # tol=1e-8 per solve against the oracle's 1e-12
        if not (np.isfinite(Pe).all() and err_pe < 1e-6 and err_phi < 1e-10):
            fail(f"twophase {method} {variant}: oracle errors Pe {err_pe}, phi {err_phi}")
        say("twophase_small", method=method, variant=variant, iterations=its,
            launches=json.dumps({k: v[0] for k, v in got.items()}).replace(" ", ""),
            all_shifted=True, oracle_rel_err_Pe=err_pe, oracle_err_phi=err_phi)

    # periodic (T, T, F) mgcg: 1 rank at 18^3 against 8 ranks at 10^3
    per = (True, True, False)
    S8, i8 = TwoPhase3D(nx=10, ny=10, nz=10, dims=(2, 2, 2), method="mgcg", tol=1e-10,
                        periodic=per).run(3)
    S1, i1 = TwoPhase3D(nx=18, ny=18, nz=18, dims=(1, 1, 1), method="mgcg", tol=1e-10,
                        periodic=per).run(3)
    its8, its1 = [i.iterations for i in i8], [i.iterations for i in i1]
    d_pe = float(np.abs(fields.gather(S8.Pe) - fields.gather(S1.Pe)).max())
    d_phi = float(np.abs(fields.gather(S8.phi) - fields.gather(S1.phi)).max())
    if its8 != [5, 5, 5] or its1 != [5, 5, 5] or not (d_pe < 1e-12 and d_phi < 1e-12):
        fail(f"periodic mgcg: 8 ranks {its8}, 1 rank {its1}, max |dPe| {d_pe}, |dphi| {d_phi}")
    say("twophase_small", periodic="TTF", method="mgcg", iterations_8=its8, iterations_1=its1,
        max_abs_dPe=d_pe, max_abs_dphi=d_phi)

    # the explicit integrator against its oracle, with and without hide
    out = {}
    for hide in ((2, 2, 2), None):
        app = TwoPhase3D(nx=16, ny=12, nz=12, dims=(2, 2, 2), hide=hide)
        S, _ = app.run(5)
        Pe_o, phi_o = app.oracle(5)
        e_pe = float(np.abs(fields.gather(S.Pe) - Pe_o).max())
        e_phi = float(np.abs(fields.gather(S.phi) - phi_o).max())
        moved = float(np.abs(fields.gather(S.phi) - fields.gather(app.init_fields().phi)).max())
        if not (e_pe < 1e-11 and e_phi < 1e-11 and moved > 1e-8):
            fail(f"explicit hide={hide}: oracle errors {e_pe} / {e_phi}, phi moved {moved}")
        out[hide] = S
        say("twophase_small", method="explicit", hide=hide, oracle_max_abs_err_Pe=e_pe,
            oracle_max_abs_err_phi=e_phi)
    if not all(torch.equal(out[(2, 2, 2)][k].data, out[None][k].data) for k in ("Pe", "phi")):
        fail("explicit: hide_step differs from update_halo(step) bitwise")

    # the overlap operator (``hide_apply``) against the plain one, then cg with overlap=True
    app = TwoPhase3D(nx=10, ny=10, nz=10, dims=(2, 2, 2), method="cg", overlap=True)
    g = app.grid
    S = app.init_fields()
    k, diag, _ = app._assemble(S.Pe, S.phi)
    u = g.from_global_fn(lambda ix, iy, iz: torch.sin(
        0.3 * ix.double() + 0.2 * iy.double() + 0.1 * iz.double()))
    u0 = u.clone()
    n0 = shift_counts(sk)
    hidden = pressure_apply(g, u, k, diag, app.spacing, hide=True)
    plain = pressure_apply(g, u.clone(), k, diag, app.spacing)
    got = shift_diff(shift_counts(sk), n0)
    if not (torch.equal(hidden, plain) and torch.equal(u, u0)) or got["apply"] != (2, 2):
        fail(f"overlap pressure operator: equal {torch.equal(hidden, plain)}, u untouched "
             f"{torch.equal(u, u0)}, K2 launches (all, shifted) {got['apply']} (want 1 + 1)")
    n0 = shift_counts(sk)
    S, infos = app.run(2)
    got = shift_diff(shift_counts(sk), n0)
    its = [i.iterations for i in infos]
    exp = path_launches("cg", "classic", its, 1)
    if its != [7, 8] or got["apply"] != (exp["apply"], exp["apply"]):
        fail(f"cg overlap: iterations {its} (want [7, 8]), K2 launches {got['apply']} "
             f"(want {exp['apply']}, all shifted)")
    say("twophase_small", method="cg", overlap=True, iterations=its, k2_launches=got["apply"][0],
        overlap_vs_plain="bitwise")


def twophase_full(sk, full=TWOPHASE_FULL, steps: int = 20, warm: int = 3,
                  implicit_steps: int = 3) -> dict:
    """Phase 26, the main path: the flagship at a size that fills the card,
    f64 on 1 and 8 ranks (the same 514^3 global grid): the explicit
    integrator with and without hide, then cg and mgcg at the default dt
    (10x the explicit limit), mgcg with overlap on 8 ranks.  Every count is
    zeroed just before these runs and read just after them; returns the
    counts (launches, shifted launches) of K2-K5 center and the face ones."""
    from repro_torch.apps import TwoPhase3D

    # the depth this phase can afford: cut when the call's limit comes close
    # (its full depth takes about 150 s on the card)
    if remaining_s() < 420:
        steps, warm, implicit_steps = 5, 1, 1
        say("twophase_full", cut=f"steps={steps} warm={warm} implicit_steps={implicit_steps}",
            remaining_s=remaining_s())
    shape = None
    torch.cuda.synchronize()
    for w in sk.WRAPPERS:
        w.launches = 0
    for w in sk.WRAPPERS[:4]:
        w.shifted_launches = 0
    for name, n, dims in full:
        for hide in ((8, 2, 2), None):
            torch.cuda.empty_cache()
            app = TwoPhase3D(nx=n, ny=n, nz=n, dims=dims, hide=hide)
            shape = shape or app.grid.global_shape
            if app.grid.global_shape != shape:
                fail(f"{name}: global shape {app.grid.global_shape}, not {shape}")
            S, _ = app.run(warm)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            S, _ = app.run(steps, S)
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1) / steps
            if not (torch.isfinite(S.Pe.data).all() and torch.isfinite(S.phi.data).all()):
                fail(f"{name} explicit hide={hide}: non-finite fields")
            say("twophase_full", config=name, method="explicit", hide=hide,
                widths=app._hide_widths, steps=steps, ms_per_step=ms,
                t_eff_GBps=app.t_eff(ms / 1e3))
            del app, S
        for method, kw in (("cg", {}), ("mgcg", {}), ("mgcg", dict(overlap=True))):
            if kw and dims == (1, 1, 1):
                continue      # overlap only where there is an exchange
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            app = TwoPhase3D(nx=n, ny=n, nz=n, dims=dims, method=method, **kw)
            S = app.init_fields()
            nsteps = implicit_steps if not kw else min(2, implicit_steps)
            its, step_s, solve_s, per_it = [], [], [], []
            for _ in range(nsteps):
                torch.cuda.synchronize()
                n0 = shift_counts(sk)
                t0 = time.perf_counter()
                S, info = app.step(S)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                got = shift_diff(shift_counts(sk), n0)
                if not info.converged or any(n != ns for n, ns in got.values()):
                    fail(f"{name} {method} {kw}: {info}, launches (all, shifted) {got}")
                its.append(info.iterations)
                solve_s.append(info.wall_s)
                per_it.append({k: v[0] / info.iterations for k, v in got.items()})
            Pe, phi = S.Pe.data, S.phi.data
            if not (torch.isfinite(Pe).all() and phi.min() >= 1e-4 and phi.max() <= 0.25):
                fail(f"{name} {method} {kw}: fields out of range")
            say("twophase_full", config=name, method=method, overlap=bool(kw), iterations=its,
                step_s=step_s, solve_s=solve_s,
                ms_per_iteration=[1e3 * s / k for s, k in zip(solve_s, its)],
                launches_per_iteration=json.dumps(per_it[-1]).replace(" ", ""),
                all_shifted=True, t_eff_GBps=app.t_eff(sum(step_s) / len(step_s)),
                peak_GB=torch.cuda.max_memory_allocated() / 1e9)
            del app, S, Pe, phi
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return {"center": shift_counts(sk), "face": face_counts(sk)}


def twophase_measure(sk, full=TWOPHASE_FULL) -> int:
    """Phase 27, after the main path's counts were read: one mgcg step's
    device time by kind; on 8 ranks the overlap operator (``hide_apply``)
    against the in-place one, then one cg solve with the shifted Chebyshev cycle as the
    preconditioner, K5's only launches on this slice.  Returns K5's
    launches in that solve, counted around it alone."""
    from repro_torch import solvers
    from repro_torch.apps import TwoPhase3D
    from repro_torch.apps.twophase_ops import pressure_apply

    cheb = 0
    for name, n, dims in full:
        torch.cuda.empty_cache()
        app = TwoPhase3D(nx=n, ny=n, nz=n, dims=dims, method="mgcg")
        S, _ = app.step(app.init_fields())       # warm
        say("breakdown", config=f"{name} twophase mgcg step",
            **categories(lambda: app.step(S), 1, kinds=TWOPHASE_KINDS))
        if dims == (1, 1, 1):
            del app, S
            continue
        # hide_apply (K2 on a halo-updated clone of u, u untouched) against
        # the in-place application and the clone alone; in turns
        k, diag, rhs = app._assemble(S.Pe, S.phi)
        u = S.Pe.data.clone()
        forms = {"hide_apply": lambda: pressure_apply(app.grid, u, k, diag, app.spacing,
                                                      hide=True),
                 "in_place": lambda: pressure_apply(app.grid, u, k, diag, app.spacing),
                 "clone_of_u": lambda: u.clone()}
        t = {f: [] for f in forms}
        for _ in range(2):
            for f, fn in forms.items():
                t[f].append(cuda_time_ms(fn, reps=20))
        ms = {f: min(v) for f, v in t.items()}
        say("twophase_full", config=name, operator="pressure_apply",
            ms_runs=json.dumps(t).replace(" ", ""),
            hide_over_in_place=ms["hide_apply"] / ms["in_place"])
        del u
        # the shifted Chebyshev cycle (K5) as the pressure preconditioner
        M = solvers.CyclePreconditioner(app.grid, app.spacing, helmholtz_shift=True,
                                        smoother="chebyshev")
        torch.cuda.synchronize()
        n0 = shift_counts(sk)
        x, info = solvers.cg(app.grid, app.apply_A, rhs, x0=S.Pe, tol=app.tol, apply_M=M,
                             args=(k, diag))
        torch.cuda.synchronize()
        got = shift_diff(shift_counts(sk), n0)
        if not info.converged or got["cheb"][1] == 0 or any(n != ns for n, ns in got.values()):
            fail(f"{name} chebyshev-cycle solve: {info}, launches {got}")
        cheb += got["cheb"][1]
        say("twophase_full", config=name, solve="cg + shifted chebyshev cycle",
            iterations=info.iterations, seconds=info.wall_s,
            launches=json.dumps({k_: v[0] for k_, v in got.items()}).replace(" ", ""))
        del x, k, diag, rhs, M, app, S
    torch.cuda.empty_cache()
    return cheb


def twophase_phases(rand) -> list:
    from repro_torch.kernels import solver3d as sk

    # ---- 24. shifted K2-K5 against their plain versions, then timed ---------
    res = shift_kernel_phase(sk, rand)
    # ---- 25. the two-phase path at the reference's test sizes ---------------
    twophase_small(sk)
    # ---- 26. the main path at full size: counts zeroed just before, read after
    path = twophase_full(sk)
    center = path["center"]
    for k in ("apply", "residual", "jacobi"):
        n, ns = center[k]
        if ns == 0 or n != ns:
            fail(f"the two-phase path: {k} launched {n} times, {ns} shifted")
    if center["cheb"] != (0, 0) or any(path["face"].values()):
        fail(f"the two-phase path launched K5 {center['cheb']} or face kernels {path['face']}")
    say("twophase_path", shifted_launches=json.dumps({k: v[1] for k, v in center.items()}
                                                     ).replace(" ", ""),
        face_launches=json.dumps(path["face"]).replace(" ", ""))
    # ---- 27. breakdown, hide_apply's cost, K5's own solve ------
    cheb = twophase_measure(sk)
    entries = []
    for op in SHIFT_OPS:
        ms, plain, bound, bound_by = res["times"][op]
        err = res["errs"][op] if op != "cheb" else max(res["errs"]["cheb"],
                                                       res["errs"]["cheb_first"])
        entry = {
            "name": f"{op}_shift", "route": "cuda",
            "source": "src/repro_torch/kernels/solver3d/csrc/solver3d.cu",
            "replaces": SOLVER_REPLACES[op], "launches": center[op][1], "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None}
        if op == "cheb":
            # not on TwoPhase3D's path (its cycle smooths with Jacobi): the
            # launches of the 8-rank cg solve with the shifted Chebyshev cycle
            entry["launches"] = cheb
            entry["launches_in"] = "cg + shifted chebyshev cycle, 8x258^3 (phase 27)"
        entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# Gross-Pitaevskii, 2-D/1-D grids, checkpoints and the solver telemetry
# ---------------------------------------------------------------------------

GP_FULL = (("8x258^3", 258, (2, 2, 2)), ("1x514^3", 514, (1, 1, 1)))   # 514^3 complex64
# The app's RK4 step dt = 2 / (3/dx^2 + V_max + g) takes the kinetic term as
# 3/dx^2, half its largest eigenvalue 6/dx^2: |lambda dt| reaches 4 > 2.83
# where 3/dx^2 outweighs the trap, and the default domain (lx 12) blows up
# at 514^3 (ROADMAP F12).  lx 60 makes the trap term (V_max 675) large
# enough that |lambda dt| <= 2.49 at 514^3.
GP_LX = 60.0
POISSON_FULL = {"8x258^3": (258, (2, 2, 2)), "1x514^3": (514, (1, 1, 1))}   # 514^3 f64
GRID2D_LOCAL = 4096          # dims (4, 2): 16378 x 8190 global cells, f64


def gp_phase(full=GP_FULL, steps: int = 20, warm: int = 2, small: int = 10) -> None:
    """Phase 28: GrossPitaevskii3D, complex64 through update_halo: a small
    case on the card against the same case on the CPU, then 514^3 on 8
    blocks and on one, against each other and the port's own oracle."""
    from repro_torch.apps import GrossPitaevskii3D

    kw = dict(nx=small, ny=small, nz=small, dims=(2, 2, 2))
    card = GrossPitaevskii3D(**kw)
    host = GrossPitaevskii3D(**kw, device="cpu")
    err = float(np.abs(card.grid.gather(card.run(10)) - host.grid.gather(host.run(10))).max())
    if not err <= 1e-5:
        fail(f"GP 8x{small}^3: card against CPU max |err| {err}")
    say("gp", config=f"8x{small}^3", steps=10, card_vs_cpu_max_abs_err=err)
    fields, apps = {}, {}
    for name, n, dims in full:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        app = GrossPitaevskii3D(nx=n, ny=n, nz=n, dims=dims, lx=GP_LX)
        psi = app.init_fields()
        n0 = app.norm(psi)
        psi = app.run(warm, psi)
        box = [psi]
        ms = cuda_time_ms(lambda: box.__setitem__(0, app.run(steps, box[0])), 1, 0) / steps
        G = app.grid.gather(box[0])
        n1 = float(np.sum(np.abs(G) ** 2) * app.dx ** 3)
        drift = abs(n1 - n0) / n0
        if G.dtype != np.complex64 or not np.isfinite(G).all() or not drift < 0.05:
            fail(f"GP {name}: dtype {G.dtype}, finite {np.isfinite(G).all()}, drift {drift}")
        fields[name], apps[name] = G, app
        say("gp", config=name, global_shape=app.grid.global_shape, dtype="complex64", lx=app.lx,
            dt=app.dt, steps=steps, ms_per_step=ms, norm_drift=drift,
            peak_GB=torch.cuda.max_memory_allocated() / 1e9)
        del box, psi
    (a, A), (b, B) = fields.items()
    err = float(np.abs(A - B).max())
    if not err <= 1e-5:
        fail(f"GP {a} against {b}: max |err| {err}")
    apps.pop(a)
    oracle = apps[b].oracle(warm + steps)
    oerr = max(float(np.abs(G - oracle).max()) for G in fields.values())
    if not oerr <= 1e-5:
        fail(f"GP against the single-block oracle: max |err| {oerr}")
    say("gp", blocks_vs_one_max_abs_err=err, bitwise=bool(np.array_equal(A, B)),
        vs_oracle_max_abs_err=oerr)
    del apps, fields, oracle
    torch.cuda.empty_cache()


def grid2d_phase(local: int = GRID2D_LOCAL, steps: int = 6) -> None:
    """Phase 29: 2-D diffusion on dims (4, 2) in f64, hide (width (2, 2))
    against update_halo bitwise; the NumPy oracle at a small size; a 1-D
    periodic ring's halos."""
    from repro_torch.core import init_global_grid
    from repro_torch.stencil import fd2d

    def step(T):
        out = T.clone()
        out[..., 1:-1, 1:-1] = fd2d.inn(T) + 0.1 * (fd2d.d2_xi(T) + fd2d.d2_yi(T))
        return out

    def evolve(grid, T, n, hide):
        for _ in range(n):
            T = grid.hide(step, (T,), width=(2, 2)) if hide else grid.update_halo(step(T))
        return T

    # small: against the NumPy oracle
    grid = init_global_grid(10, 8, None, dims=(4, 2), dtype=torch.float64)
    G = np.random.RandomState(0).rand(*grid.global_shape)
    T0 = grid.scatter(G)
    Tp, Th = evolve(grid, T0.clone(), steps, False), evolve(grid, T0.clone(), steps, True)
    for _ in range(steps):
        Gn = G.copy()
        i = G[1:-1, 1:-1]
        Gn[1:-1, 1:-1] = i + 0.1 * (G[2:, 1:-1] - 2 * i + G[:-2, 1:-1]
                                    + G[1:-1, 2:] - 2 * i + G[1:-1, :-2])
        G = Gn
    err = float(np.abs(grid.gather(Tp) - G).max())
    if not (torch.equal(Tp, Th) and err < 1e-12):
        fail(f"2-D 4x2 blocks of 10x8: hide bitwise {torch.equal(Tp, Th)}, oracle err {err}")
    # full: 8 blocks of local^2
    grid = init_global_grid(local, local, None, dims=(4, 2), dtype=torch.float64)

    def fn(ix, iy):
        x, y = ix.double(), iy.double()
        return torch.sin(1e-3 * x) * torch.cos(7e-4 * y) + 1e-2 * ((7 * ix + 13 * iy) % 17)

    T0 = grid.from_global_fn(fn)
    box = {}
    ms = {}
    for hide in (False, True, True, False):
        box[hide] = T0.clone()
        t = cuda_time_ms(lambda: box.__setitem__(hide, evolve(grid, box[hide], steps, hide)),
                         1, 0) / steps
        ms.setdefault(hide, []).append(t)
    if not torch.equal(box[False], box[True]):
        fail(f"2-D {grid.shape}: hide differs from update_halo(step) bitwise")
    if not (torch.isfinite(box[True]).all() and not torch.equal(box[True], T0)):
        fail("2-D: non-finite or unchanged field")
    # 1-D periodic ring: every halo plane is its neighbour's send plane
    ring = init_global_grid(10, None, None, dims=(8,), periodic=(True,), dtype=torch.float64)
    b = ring.update_halo(ring.scatter(np.random.RandomState(1).rand(*ring.global_shape))).cpu()
    n, D = ring.local_shape[0], ring.dims[0]
    ok = all(bool(b[i][0] == b[(i - 1) % D][n - 2]) and bool(b[i][-1] == b[(i + 1) % D][1])
             for i in range(D))
    if not ok:
        fail("1-D periodic ring: halo planes differ from the neighbours' send planes")
    cells = math.prod(grid.global_shape)
    say("grid2d", config=f"8x{local}^2", global_shape=grid.global_shape, dtype="float64",
        steps=steps, hide_vs_plain="bitwise", ms_per_step_plain=ms[False],
        ms_per_step_hide=ms[True], small_oracle_max_abs_err=err, ring_1d="exact",
        t_eff_GBps=[2 * cells * 8 / (m * 1e6) for m in ms[False]])   # T read and written
    del box, T0, grid
    torch.cuda.empty_cache()


def ckpt_phase(full=POISSON_FULL, loose: float = 1e-3, tight: float = 1e-8) -> dict:
    """Phase 30: Poisson3D mgcg on 8 x 258^3 stopped at 1e-3, a checkpoint
    of {u, G = gather(u), iteration} (save, async_save, restore timed), then
    warm solves to 1e-8 from scatter(G) on the same layout and on 1 x 514^3
    (another block layout) against cold ones.  Returns the Poisson apps."""
    import shutil
    import tempfile

    from repro_torch import ckpt
    from repro_torch.apps import Poisson3D

    apps = {name: Poisson3D(nx=n, ny=n, nz=n, dims=dims) for name, (n, dims) in full.items()}
    (first, app), (second, other) = apps.items()
    u, half = app.solve("mgcg", tol=loose)
    state = {"u": u, "G": app.grid.gather(u), "iteration": half.iterations}
    nbytes = u.numel() * u.element_size() + state["G"].nbytes
    d = tempfile.mkdtemp(prefix="ckpt_")
    try:
        free = shutil.disk_usage(d).free
        if free < 3 * nbytes:
            fail(f"checkpoint: {free / 1e9:.2f} GB free under {d}, the state needs 3 x "
                 f"{nbytes / 1e9:.2f} GB")
        t0 = time.perf_counter()
        ckpt.save(state, 1, d)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fut = ckpt.async_save(state, 2, d)
        block_s = time.perf_counter() - t0
        fut.result(timeout=600)
        async_s = time.perf_counter() - t0
        if ckpt.latest_step(d) != 2:
            fail(f"checkpoint: latest step {ckpt.latest_step(d)}")
        t0 = time.perf_counter()
        back = ckpt.restore({"u": app.grid.zeros(), "G": np.zeros(app.grid.global_shape),
                             "iteration": 0}, 2, d)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    G = back["G"].numpy()
    if not (torch.equal(back["u"], u) and np.array_equal(G, state["G"])
            and int(back["iteration"]) == half.iterations):
        fail("checkpoint: the restored state differs from the saved one")
    say("ckpt", config=first, state_GB=nbytes / 1e9, loose_iterations=half.iterations,
        save_s=save_s, save_GBps=nbytes / save_s / 1e9, async_blocking_s=block_s,
        async_total_s=async_s, async_GBps=nbytes / async_s / 1e9, restore_s=restore_s,
        restore_GBps=nbytes / restore_s / 1e9)
    for name, a in apps.items():
        u_cold, cold = a.solve("mgcg", tol=tight)
        u_warm, warm = a.solve("mgcg", tol=tight, x0=a.grid.scatter(G))
        gc, gw = a.grid.gather(u_cold), a.grid.gather(u_warm)
        rel = float(np.abs(gw - gc).max() / np.abs(gc).max())
        if not (warm.converged and warm.iterations < cold.iterations and rel <= 1e-6):
            fail(f"checkpoint restart on {name}: warm {warm.iterations} (converged "
                 f"{warm.converged}), cold {cold.iterations}, rel diff {rel}")
        say("ckpt", restart_on=name, cold_iterations=cold.iterations,
            warm_iterations=warm.iterations, warm_vs_cold_rel=rel)
        del u_cold, u_warm
    del u, state, back, G, other
    torch.cuda.empty_cache()
    return apps


def kernel_count(run) -> dict:
    """What the profiler sees of run(): the CUDA runtime's kernel-launch
    calls and the aten operators issued (both exact and repeatable), and
    the device operations recorded (kernels, copies, fills; the tracer
    drops a few of some 45k from one profile to the next, so this one is
    printed, not compared)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {"launch_calls": 0, "aten_ops": 0, "device_ops": 0}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out["device_ops"] += 1
        elif e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                        "cuLaunchKernelEx"):
            out["launch_calls"] += 1
        elif e.name.startswith("aten::"):
            out["aten_ops"] += 1
    return out


def counters_phase(app, maxiter: int = 20) -> None:
    """Phase 31: comm counts of 8 x 258^3 f64 solves under a session: cg and
    pipecg at the analytic numbers, and for cg, pipecg and mgcg the live
    count of the whole solve equal to comm.totals(k, replacements)."""
    from repro_torch import telemetry as tele

    g = app.grid
    # 2 h prod(face) itemsize per dim (3 * 2 * 1 * 258^2 * 8 = 3,195,072 bytes at 8 x 258^3)
    halo = sum(tele.halo_slab_bytes(g.local_shape, d, g.halo, 8) for d in range(3))
    name = f"{math.prod(g.dims)}x{g.local_shape[0]}^3"
    for method, kw in (("cg", dict(tol=0.0, maxiter=maxiter)),
                       ("pipecg", dict(tol=0.0, maxiter=maxiter)),
                       ("mgcg", dict(tol=1e-8))):
        with tele.session():
            _, info = app.solve(method, **kw)
        with tele.counting() as col:       # no session: the solve counts into col
            _, again = app.solve(method, **kw)
        c = info.comm
        live = col.total().as_dict()
        want = c.totals(info.iterations, info.replacements).as_dict()
        per = c.per_iteration
        if live != want or again.iterations != info.iterations:
            fail(f"{method}: live count {live} != comm.totals {want}")
        if method != "mgcg":
            ar = 2 if method == "cg" else 1
            sc = 2 if method == "cg" else 3
            if (per.all_reduces, per.all_reduce_scalars, per.halo_exchanges,
                    per.halo_bytes) != (ar, sc, 3, halo):
                fail(f"{method}: per iteration {per.as_dict()}")
        say("counters", config=name, method=method, iterations=info.iterations,
            replacements=info.replacements,
            per_iteration=json.dumps(per.as_dict()).replace(" ", ""),
            setup_halo_bytes=c.setup.halo_bytes, live_total_equals_totals=True,
            total_halo_GB=want["halo_bytes"] / 1e9)


def telemetry_phase(app, sk, nan_app=None, heat_steps: int = 100, heat_local: int = 256,
                    heat_dims=(2, 2, 2), mamba: str = "mamba2-1.3b",
                    prompt: tuple = (1, 1000), n_new: int = 16) -> int:
    """Phase 32: telemetry on and off around one mgcg solve (bitwise equal
    iterates, equal launch and profiler counts, both wall times),
    heartbeats, the 8-rank NaN story (flight records, diag, resume from a
    checkpoint), Heat3D with hide under a session, and Engine(flight_dir=).
    Returns K1's launches here."""
    import contextlib
    import glob
    import io
    import os
    import shutil
    import tempfile

    from repro_torch import ckpt
    from repro_torch import telemetry as tele
    from repro_torch.apps import Heat3D
    from repro_torch.configs import get
    from repro_torch.kernels.stencil3d import heat_step_cuda
    from repro_torch.models import Model
    from repro_torch.serve import Engine
    from repro_torch.telemetry import diag

    # -- overhead: the same solve off, on, on, off
    t0 = time.perf_counter()
    runs = {False: [], True: []}
    for on in (False, True, True, False):
        sink = tele.MemorySink()
        with contextlib.ExitStack() as ctx:
            if on:
                ctx.enter_context(tele.session(sink=sink))
                ctx.enter_context(tele.watch(heartbeat_every=5))
            torch.cuda.synchronize()
            n0 = launch_counts(sk)
            u, info = app.solve("mgcg", tol=1e-8)
            n1 = launch_counts(sk)
        runs[on].append((u, info, diff(n1, n0), sink))
    u_off, i_off, l_off, _ = runs[False][0]
    u_on, i_on, l_on, sink = runs[True][0]
    if not (torch.equal(u_off, u_on) and l_off == l_on and i_on.iterations == i_off.iterations):
        fail(f"telemetry on/off: bitwise {torch.equal(u_off, u_on)}, launches {l_on} / {l_off}")
    hb = [e["iteration"] for e in sink.events if e["type"] == "heartbeat"]
    if hb != list(range(5, i_on.iterations + 1, 5)):
        fail(f"heartbeats at {hb} for {i_on.iterations} iterations")
    finals = sorted(e["rank"] for e in sink.events if e["type"] == "health")
    if finals != list(range(8)) or i_on.status != tele.SolveStatus.CONVERGED:
        fail(f"final-health events of ranks {finals}, status {i_on.status}")
    wall = {on: [r[1].wall_s for r in runs[on]] for on in runs}
    del runs, u_on, u_off
    # the profiler's launch and operator counts over three mgcg iterations
    # (some 9k launches; a whole solve profiles ten times longer)
    ops = {False: [], True: []}
    for on in (False, True):
        with contextlib.ExitStack() as ctx:
            if on:
                ctx.enter_context(tele.session())
                ctx.enter_context(tele.watch(heartbeat_every=1))
            ops[on].append(kernel_count(lambda: app.solve("mgcg", tol=0.0, maxiter=3)))
    exact = [{k: o[k] for k in ("launch_calls", "aten_ops")} for o in ops[True] + ops[False]]
    if any(o != exact[0] for o in exact):
        fail(f"profiler counts with telemetry {ops[True]}, without {ops[False]}")
    say("telemetry", config=f"{math.prod(app.grid.dims)}x{app.grid.local_shape[0]}^3 mgcg",
        iterations=i_on.iterations, iterate="bitwise", profiled_iterations=3,
        launches=json.dumps(l_on).replace(" ", ""),
        profiler=json.dumps(exact[0]).replace(" ", ""),
        profiler_device_ops_on=[o["device_ops"] for o in ops[True]],
        profiler_device_ops_off=[o["device_ops"] for o in ops[False]],
        wall_s_off=wall[False], wall_s_on=wall[True],
        on_over_off=min(wall[True]) / min(wall[False]), heartbeats=len(hb),
        final_health_events=len(finals), seconds=time.perf_counter() - t0)

    # -- the NaN story on 8 ranks: flight records, diag, resume
    nan_app = nan_app or app
    t0 = time.perf_counter()
    out = tempfile.mkdtemp(prefix="flight_")
    try:
        fdir = os.path.join(out, "flight")
        c_good = nan_app.c
        with tele.session(), tele.observe(heartbeat=5, flight_dir=fdir):
            x, good = nan_app.solve("mgcg", tol=1e-8)
            ckpt.save({"x": x}, 1, out)
            c = c_good.clone()
            n = nan_app.grid.local_shape[0]
            c[1, 0, 0, n // 2, n // 2, n // 2] = float("nan")    # an interior cell of block 1
            nan_app.c = c
            _, bad = nan_app.solve("mgcg", tol=1e-8)
        nan_app.c = c_good
        if good.status != tele.SolveStatus.CONVERGED or \
                bad.status != tele.SolveStatus.DIVERGED_NONFINITE or bad.iterations > 1:
            fail(f"NaN story: good {good.status}, bad {bad.status} at {bad.iterations}")
        files = sorted(glob.glob(os.path.join(fdir, "flight-rank*.jsonl")))
        nranks = math.prod(nan_app.grid.dims)
        if [os.path.basename(p) for p in files] != [f"flight-rank{r:04d}.jsonl"
                                                    for r in range(nranks)]:
            fail(f"NaN story: flight files {files}")
        for p in files:
            with open(p) as f:
                lines = [json.loads(ln) for ln in f]
            h = lines[0]
            if h["type"] != "flight_header" or h["reason"] != "status:DIVERGED_NONFINITE" \
                    or h["n_events"] != len(lines) - 1 or "host_peak_rss_kb" not in h["memory"]:
                fail(f"NaN story: header {h}")
            if not any(e["type"] == "health" and e["status"] == "DIVERGED_NONFINITE"
                       for e in lines[1:]):
                fail(f"NaN story: no failing health event in {p}")
        trace_path = os.path.join(out, "trace.json")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = diag.main([fdir, "--out", trace_path])
        with open(trace_path) as f:
            pids = {e["pid"] for e in json.load(f)["traceEvents"]}
        if rc != 0 or "imbalance" not in buf.getvalue() or pids != set(range(nranks)):
            fail(f"diag: rc {rc}, pids {pids}")
        state = ckpt.restore({"x": x}, 1, out)
        _, resumed = nan_app.solve("mgcg", tol=1e-8, x0=state["x"])
        if resumed.status != tele.SolveStatus.CONVERGED or resumed.iterations > 5:
            fail(f"resume: {resumed.status} after {resumed.iterations} iterations")
        say("nan_story", config=f"{nranks}x{n}^3", good_iterations=good.iterations,
            bad_status=bad.status.name, bad_iterations=bad.iterations, flight_files=len(files),
            memory=json.dumps(h["memory"]).replace(" ", ""), diag_pids=sorted(pids),
            resumed_iterations=resumed.iterations, seconds=time.perf_counter() - t0)
        del x, state
    finally:
        shutil.rmtree(out, ignore_errors=True)

    # -- Heat3D with hide under a session, against the same run without
    t0 = time.perf_counter()
    heat_step_cuda.launches = 0
    ms = {}
    for on in (False, True, True, False):
        happ = Heat3D(nx=heat_local, ny=heat_local, nz=heat_local, dims=heat_dims,
                      hide=(16, 2, 2))
        T, Ci = happ.init_fields()
        T, _ = happ.run(2, T, Ci)
        sink = tele.MemorySink()
        with contextlib.ExitStack() as ctx:
            if on:
                s = ctx.enter_context(tele.session(sink=sink))
            t = cuda_time_ms(lambda: happ.run(heat_steps, T, Ci), 1, 0) / heat_steps
            if on:
                (span,) = [e for e in sink.events if e["name"] == "heat3d.run"]
                s.metric("t_eff_gbs", happ.t_eff(span["dur"] / heat_steps))
        if on and not [e for e in sink.events if e["type"] == "metric"]:
            fail("Heat3D under a session: no t_eff metric")
        ms.setdefault(on, []).append(t)
        del happ, T, Ci
    launches = heat_step_cuda.launches
    if launches != 4 * (2 + heat_steps) * 7:
        fail(f"Heat3D with hide under a session: {launches} K1 launches")
    if not min(ms[True]) <= 1.2 * min(ms[False]):
        fail(f"Heat3D: {ms[True]} ms a step under a session against {ms[False]}")
    say("telemetry", config=f"Heat3D {math.prod(heat_dims)}x{heat_local}^3 hide",
        ms_per_step_off=ms[False], ms_per_step_on=ms[True], span="heat3d.run",
        t_eff_metric=True, k1_launches=launches, seconds=time.perf_counter() - t0)

    # -- serving: Engine(flight_dir=) gives the same ids, its dump the spans
    t0 = time.perf_counter()
    cfg = get(mamba)
    dev = app.c.device
    gen = torch.Generator(device=dev).manual_seed(0)
    model = Model(cfg, generator=gen)
    tokens = torch.randint(0, cfg.vocab, prompt, generator=gen, device=dev)
    plain = Engine(cfg, model, cache_len=prompt[1] + n_new).generate(tokens, n_new)
    out = tempfile.mkdtemp(prefix="serve_flight_")
    try:
        eng = Engine(cfg, model, cache_len=prompt[1] + n_new, flight_dir=out)
        ids = eng.generate(tokens, n_new)
        (path,) = eng.recorder.dump(reason="manual")
        with open(path) as f:
            spans = {e.get("name"): e["dur"] for e in map(json.loads, f)
                     if e.get("type") == "span"}
    finally:
        shutil.rmtree(out, ignore_errors=True)
    if not torch.equal(ids, plain) or set(spans) != {"serve.prefill", "serve.decode"}:
        fail(f"Engine(flight_dir=): ids equal {torch.equal(ids, plain)}, spans {sorted(spans)}")
    say("telemetry", config=f"{cfg.name} {prompt[0]}x{prompt[1]}+{n_new}", ids="equal",
        span_s=json.dumps(spans).replace(" ", ""), seconds=time.perf_counter() - t0)
    del model, eng, tokens
    torch.cuda.empty_cache()
    return launches


def slice9_phases(sk, full=POISSON_FULL) -> tuple[dict, int]:
    """Phases 28-32.  Returns the launches of K2-K5 center during the
    checkpoint and telemetry phases (counts zeroed just before, read just
    after) and K1's during the Heat3D session run."""
    gp_phase()
    grid2d_phase()
    torch.cuda.synchronize()
    zero_counts(sk)
    apps = ckpt_phase(full)
    app8 = apps["8x258^3"] if "8x258^3" in apps else next(iter(apps.values()))
    counters_phase(app8)
    k1 = telemetry_phase(app8, sk)
    torch.cuda.synchronize()
    center = launch_counts(sk)
    del apps, app8
    torch.cuda.empty_cache()
    for k in ("apply", "residual", "jacobi"):
        if center[k] == 0:
            fail(f"the checkpoint and telemetry phases never launched the {k} kernel")
    say("slice9", center_launches=json.dumps(center).replace(" ", ""), k1_launches=k1,
        elapsed_s=time.perf_counter() - T_START)
    return center, k1


# ---------------------------------------------------------------------------
# slice 12: the example twins, and MoE serving (granite, jamba, kimi)
# ---------------------------------------------------------------------------

EXAMPLES = ("torch_quickstart", "torch_stokes", "torch_twophase", "torch_gross_pitaevskii",
            "torch_train_lm")
EXAMPLE_LIMIT_S = 300
# the training twin runs 30 of its default 120 steps (its model at its
# default size; its checkpoint at the end), so that it ends with the other
# twins and the script keeps its time limit with slice 15's phases
EXAMPLE_TRAIN_STEPS = 30
JAMBA_RUNS = (("4x2048", 4, 2048, 32),)
KIMI_RUNS = (("1x1000", 1, 1000, 8),)
KV_QUANT_BOUND, KV_QUANT_AGREE = 0.08, 0.9   # tests/test_kv_quant.py's bound
MOE_KINDS = (("k6", ("swa_kernel",)), ("k7", ("ssd_chunk_kernel",)),
             ("matmul", ("gemm", "Gemm", "gemv", "nvjet", "xmma", "cutlass")),
             ("sort", ("sort", "Sort", "radix", "Radix")),
             ("index_scatter_gather", ("index", "Index", "scatter", "Scatter", "gather",
                                       "Gather")),
             ("reduce", ("reduce",)), ("copy", ("copy", "Copy", "Memcpy", "cat")),
             ("elementwise", ("elementwise", "Elementwise")))


def examples_phase() -> None:
    """Phase 35: each examples/torch_*.py at its default size on the card,
    the five in subprocesses started together (the training twin with a
    fresh checkpoint directory, EXAMPLE_TRAIN_STEPS steps); each must exit 0
    with OK as its last line."""
    import os
    import shutil
    import tempfile

    root = Path(__file__).resolve().parent
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_lm_")
    extra = {"torch_train_lm": ["--ckpt-dir", ckpt, "--steps", str(EXAMPLE_TRAIN_STEPS)]}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, str(root / "examples" / f"{name}.py"),
                                     *extra.get(name, [])],
                                    cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True, env=dict(os.environ))
             for name in EXAMPLES}
    outs = {}
    try:
        for name, p in procs.items():
            outs[name] = (p.communicate(timeout=max(1.0, EXAMPLE_LIMIT_S
                                                   - (time.perf_counter() - t0)))[0],
                          p.returncode, time.perf_counter() - t0)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(ckpt, ignore_errors=True)
    for name, (text, rc, seconds) in outs.items():
        lines = text.strip().splitlines()
        if rc != 0 or not lines or lines[-1] != "OK":
            fail(f"examples/{name}.py: exit {rc}, output:\n{text[-3000:]}")
        say("examples", example=f"examples/{name}.py", rc=rc, done_after_s=seconds,
            printed=json.dumps([ln for ln in lines[1:-1] if not ln.startswith("[train]")]))


def count_drops(model, run) -> dict:
    """``run()`` with a forward hook on every MoE layer's router: from the
    logits it sees, ``route`` and ``dispatch`` give the pairs dropped at
    capacity (``pos >= C``), the pairs routed, and C, summed over the
    layers."""
    from repro_torch.models import moe as moe_mod

    cfg = model.cfg
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    stats = {"dropped": 0, "pairs": 0, "layers": 0, "capacity": None, "by_layer": []}

    def record(router, args, logits):
        C = moe_mod.capacity(logits.shape[1], cfg)
        _, _, eid = moe_mod.route(logits.float(), K)
        dest, _, _ = moe_mod.dispatch(eid, C, E)
        dropped = int((dest == E * C).sum())
        stats["dropped"] += dropped
        stats["pairs"] += dest.numel()
        stats["layers"] += 1
        stats["capacity"] = C
        stats["by_layer"].append(round(dropped / dest.numel(), 4))

    hooks = [block.ffn.router.register_forward_hook(record)
             for block, layer in zip(model.layers, cfg.layers_flat) if layer.moe]
    try:
        with torch.inference_mode():
            run()
    finally:
        for hook in hooks:
            hook.remove()
    return stats


def moe_full(name: str, cfg, runs, kswa, kssd, dev, seed: int):
    """A config at full width (its depth as given) in bf16 with random weights
    from ``seed``: the main path, ``Engine.generate`` at each of ``runs``
    (cache_len = prompt + new), K6 and K7 counts zeroed just before and read
    just after, every launch on the tensor cores; the drop count of one
    prefill; time to first token and decode ms per token.  Returns (model,
    prompts, K6 launches, K7 launches)."""
    from repro_torch.models import Model
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Engine

    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = Model(cfg, generator=gen)
    torch.cuda.synchronize()
    n_attn = sum(layer.mixer in ("attn", "swa") for layer in cfg.layers_flat)
    n_mamba = sum(layer.mixer == "mamba" for layer in cfg.layers_flat)
    n_moe = sum(bool(layer.moe) for layer in cfg.layers_flat)
    params = sum(p.numel() for p in model.parameters())
    say(f"{name}", cfg=cfg.name, layers=cfg.n_layers, attention_layers=n_attn,
        mamba_layers=n_mamba, moe_layers=n_moe, d_model=cfg.d_model,
        heads=f"{cfg.n_heads}x{cfg.head_dim}_kv{cfg.n_kv}", d_ff=cfg.d_ff,
        experts=f"{cfg.moe.n_experts}_top{cfg.moe.top_k}_shared{cfg.moe.n_shared}_ff"
        f"{cfg.moe.d_ff}", vocab=cfg.vocab, params=params,
        weights_GB=sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9,
        dtype=cfg.dtype, materialize_s=time.perf_counter() - t0)
    prompts = {rn: torch.randint(0, cfg.vocab, (b, t), generator=gen, device=dev)
               for rn, b, t, _ in runs}
    engines = {rn: Engine(cfg, model, cache_len=t + n) for rn, _, t, n in runs}
    # the main path: the counts zeroed just before, read just after
    per_call = generate_counted(name, engines, prompts, runs,
                                (kswa.swa_attention_cuda, kssd.ssd_intra_chunk_cuda), cfg.vocab)
    k6, k7 = kswa.swa_attention_cuda.launches, kssd.ssd_intra_chunk_cuda.launches
    want = [[(n_attn, n_attn), (n_mamba, n_mamba)]] * len(runs)
    if per_call != want:
        fail(f"{name}: (K6, K7) (launches, tensor-core launches) per generate call {per_call}, "
             f"expected {want}")
    # one prefill's dispatch: the pairs dropped at capacity; logits finite
    rn, b, t, n_new = runs[0]
    holder = {}

    def prefill():
        holder["logits"], _ = tf.prefill(model, prompts[rn], cache_len=t + n_new)

    drops = count_drops(model, prefill)
    if not torch.isfinite(holder.pop("logits")[:, :cfg.vocab]).all():
        fail(f"{name}: non-finite prefill logits")
    say(f"{name}", k6_per_generate=[c[0][0] for c in per_call],
        k7_per_generate=[c[1][0] for c in per_call], all_on_tensor_cores=True,
        prefill=rn, capacity_C=drops["capacity"], pairs_routed=drops["pairs"],
        pairs_dropped=drops["dropped"], dropped_share=drops["dropped"] / max(drops["pairs"], 1),
        dropped_share_by_moe_layer=json.dumps(drops["by_layer"]).replace(" ", ""),
        moe_layers_seen=drops["layers"], logits_finite=True)
    generate_times(name, engines, prompts, runs)
    return model, prompts, k6, k7


def granite_breakdown(model, prompt, dev) -> None:
    """Where a granite 4x2048 prefill's and a decode step's device time goes:
    by kernel kind (profiler) with the idle share, and one MoE layer split
    into its expert GEMMs and the rest of its dispatch (CUDA events)."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import glu

    cfg = model.cfg
    T = prompt.shape[1]
    with torch.inference_mode():
        tf.prefill(model, prompt, cache_len=T + 32)
        say("breakdown", config=f"granite prefill {prompt.shape[0]}x{T} bf16",
            **categories(lambda: tf.prefill(model, prompt, cache_len=T + 32), 1, MOE_KINDS))
        logits, caches = tf.prefill(model, prompt, cache_len=T + 32)
        cur = logits.argmax(-1, keepdim=True)
        tf.decode_step(model, cur, T, caches)
        say("breakdown", config=f"granite decode step, batch {prompt.shape[0]}, bf16",
            **categories(lambda: tf.decode_step(model, cur, T, caches), 1, MOE_KINDS))
        del logits, caches
        m, layer = cfg.moe, model.layers[0].ffn
        for what, n_tok in (("prefill", T), ("decode", 1)):
            x = torch.randn(prompt.shape[0], n_tok, cfg.d_model, device=dev,
                            dtype=torch.bfloat16)
            C = moe_mod.capacity(n_tok, cfg)
            xe = torch.randn(m.n_experts, prompt.shape[0] * C, cfg.d_model, device=dev,
                             dtype=torch.bfloat16)
            whole = cuda_time_ms(lambda: moe_mod.fwd(layer, cfg, x), reps=10)
            wi = layer.wi.flatten(2)
            gemms = cuda_time_ms(lambda: torch.bmm(glu(torch.bmm(xe, wi).unflatten(
                -1, (2, m.d_ff)), cfg.act), layer.wo), reps=10)
            wbytes = (layer.wi.numel() + layer.wo.numel()) * 2
            say("breakdown", config=f"one granite MoE layer, {what}, batch {prompt.shape[0]}",
                moe_layer_ms=whole, expert_gemms_ms=gemms, dispatch_and_combine_ms=whole - gemms,
                capacity_C=C, expert_weight_bytes=wbytes,
                expert_weights_read_ms_at_3p35TBps=wbytes / HBM_BYTES_PER_S * 1e3,
                per_forward_ms=whole * cfg.n_layers)


def kv_quant_check(model, prompt, n_new: int, dev) -> None:
    """granite 1 x 1000 + n_new with the int8 KV cache: teacher-forced decode
    logits within tests/test_kv_quant.py's bound of the bf16 cache's, and
    both caches' bytes."""
    import dataclasses

    from repro_torch.models import Model
    from repro_torch.models import transformer as tf

    cfg = model.cfg
    quant = Model(dataclasses.replace(cfg, kv_quant=True),
                  {k: v for k, v in model.state_dict().items()})
    T, S = prompt.shape[1], prompt.shape[1] + n_new
    outs, nbytes = {}, {}
    with torch.inference_mode():
        for name, m in (("bf16", model), ("int8", quant)):
            logits, caches = tf.prefill(m, prompt, cache_len=S)
            nbytes[name] = sum(t.numel() * t.element_size() for c in caches
                               for t in c["mixer"].values())
            if name == "bf16":
                ids = [logits.argmax(-1, keepdim=True)]
            seq = []
            for i in range(n_new):
                logits, caches = tf.decode_step(m, ids[i], T + i, caches)
                seq.append(logits[:, :cfg.vocab].float())
                if name == "bf16":
                    ids.append(logits.argmax(-1, keepdim=True))
            outs[name] = torch.stack(seq)
    err = ((outs["int8"] - outs["bf16"]).abs().max() / outs["bf16"].abs().max()).item()
    agree = (outs["int8"].argmax(-1) == outs["bf16"].argmax(-1)).float().mean().item()
    if not (err < KV_QUANT_BOUND and agree > KV_QUANT_AGREE):
        fail(f"granite kv_quant: decode logits {err} from the bf16 cache's (bound "
             f"{KV_QUANT_BOUND}), argmax agreement {agree} (bound {KV_QUANT_AGREE})")
    say("granite_kv_quant", prompt=f"1x{T}", new_tokens=n_new, cache_len=S,
        decode_logits_normwise_vs_bf16_cache=err, argmax_agreement=agree,
        bound=KV_QUANT_BOUND, cache_bytes_bf16=nbytes["bf16"], cache_bytes_int8=nbytes["int8"],
        int8_over_bf16=nbytes["int8"] / nbytes["bf16"], status="ok")
    del quant


def moe_phases(dev) -> dict:
    """Phases 35-38: the example twins; granite-moe-3b-a800m whole,
    jamba-v0.1-52b at full width (one period of 8 of its 32 layers) and
    kimi-k2 at full width (its first 2 of 61 layers), each after its SMOKE
    width in f32 against the plain path (K6 and K7 at these models' shapes
    were held against their plain versions and timed in phases 18 and 21).
    Returns the launches of each model's main path."""
    import dataclasses
    import importlib

    from repro_torch.configs import get
    from repro_torch.configs.granite_moe_3b import SMOKE as GRANITE
    from repro_torch.configs.jamba_v01_52b import SMOKE as JAMBA
    from repro_torch.configs.kimi_k2 import SMOKE as KIMI

    kswa = importlib.import_module("repro_torch.kernels.swa.kernel")
    kssd = importlib.import_module("repro_torch.kernels.ssd.kernel")
    t_start = time.perf_counter()
    examples_phase()
    t_examples = time.perf_counter() - t_start
    out = {}

    # granite-moe-3b-a800m, whole
    serve_small("granite_small", GRANITE, kswa, kssd, dev)
    model, prompts, k6, _ = moe_full("granite_full", get("granite-moe-3b-a800m"), SERVE_RUNS,
                                     kswa, kssd, dev, seed=0)
    out["granite"] = {"k6": k6}
    granite_breakdown(model, prompts["4x2048"], dev)
    kv_quant_check(model, prompts["1x1000"], SERVE_RUNS[1][3], dev)
    del model, prompts
    torch.cuda.empty_cache()

    # jamba-v0.1-52b at full width, one period of its layers
    serve_small("jamba_small", JAMBA, kswa, kssd, dev)
    jamba = get("jamba-v0.1-52b")
    jamba = dataclasses.replace(jamba, stacks=((jamba.stacks[0][0], 1),))
    model, _, k6, k7 = moe_full("jamba_width", jamba, JAMBA_RUNS, kswa, kssd, dev, seed=1)
    out["jamba"] = {"k6": k6, "k7": k7}
    del model
    torch.cuda.empty_cache()

    # kimi-k2 at full width, its dense layer 0 and one MoE layer
    serve_small("kimi_small", KIMI, kswa, kssd, dev)
    kimi = get("kimi-k2-1t-a32b")
    kimi = dataclasses.replace(kimi, stacks=tuple((pattern, 1) for pattern, _ in kimi.stacks))
    model, _, k6, _ = moe_full("kimi_width", kimi, KIMI_RUNS, kswa, kssd, dev, seed=2)
    out["kimi"] = {"k6": k6}
    del model
    torch.cuda.empty_cache()
    say("slice12", examples_s=t_examples, new_phases_s=time.perf_counter() - t_start,
        elapsed_s=time.perf_counter() - T_START)
    return out


# ---------------------------------------------------------------------------
# slice 13: training (phase train)
# ---------------------------------------------------------------------------

# K6's backward checked against its plain version (B, H, Hkv, T, S, D,
# window): llama3.2-1b's training shape, gemma3's window layers (ragged T),
# the two models of examples/torch_train_lm.py, the llama SMOKE width
K6B_SHAPES = ((4, 32, 8, 2048, 2048, 64, 2048), (2, 8, 4, 1500, 1500, 256, 1024),
              (8, 6, 2, 128, 128, 64, 128), (8, 12, 4, 256, 256, 64, 256),
              (2, 8, 2, 13, 13, 8, 13))
K6B_MAIN = K6B_SHAPES[0]
K6B_TOL = 1e-5          # dq, dk, dv normwise (Frobenius) against swa_backward_ref, float32
TRAIN_ARGV = ("--arch", "llama3.2-1b", "--scale", "1.0", "--steps", "6", "--batch", "4",
              "--seq", "2048")
# the first step on the kernel path against use_kernel="ref" on the card:
# float32 both, K6's online softmax and its backward's tile sums against the
# plain softmax and einsums (other summation orders)
TRAIN_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "leaf": 1e-4}
TRAIN_SIZE = (1_236_338_688, 16)   # llama3.2-1b's parameters and layers
RESTART_STEPS = (4, 6)   # stop and checkpoint at 4, resume to 6


def k6b_bound(shape) -> tuple[float, str, float, float]:
    """Least time (ms) of K6's backward: q, o, dO, the LSE, k and v read once
    and dq, dk, dv written once over the memory rate, or 10 D FLOP per
    unmasked (query, key) pair (the five products S, dP, dV, dK, dQ) as
    three TF32 products each over the TF32 peak (3xTF32, the kernels'
    arithmetic).  Also returns the GFLOP and the float32 CUDA-core floor of
    the same FLOP."""
    B, H, Hkv, T, S, D, window = shape
    pairs = int(np.minimum(np.arange(T) + (S - T) + 1, min(window, S)).sum())
    flop = 10 * D * pairs * B * H
    words = 4 * B * H * T * D + B * H * T + 4 * B * Hkv * S * D
    t_bytes = words * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = TF32_PRODUCTS * flop / TF32_FLOP_PER_S * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return (*bound, flop / 1e9, flop / F32_FLOP_PER_S * 1e3)


def k6b_phase(kswa, dev) -> dict:
    """Phase 39 (k6_backward): K6's backward against ``swa_backward_ref`` at
    every K6B_SHAPES entry (float32; normwise dq, dk, dv; two runs bitwise),
    K6's float32 forward with and without its LSE output bitwise; then at
    llama3.2-1b's shape, each in turns (kernel, plain, SDPA, SDPA, plain,
    kernel): the backward, its plain version and SDPA's float32 backward
    through autograd (the yardstick), and the float32 forward with its LSE,
    the plain version and SDPA's forward.  Returns the kernels-line
    numbers."""
    import torch.nn.functional as F

    from repro_torch.kernels.swa import swa_backward_ref, swa_ref

    gen = torch.Generator(device=dev).manual_seed(13)
    main_err = None
    for shape in K6B_SHAPES:
        B, H, Hkv, T, S, D, w = shape
        q, k, v = k6_inputs(shape, torch.float32, gen, dev)
        do = torch.randn(B, T, H * D, generator=gen, device=dev).view(B, T, H, D).transpose(1, 2)
        o0 = kswa.swa_attention_cuda(q, k, v, window=w)
        o, lse = kswa.swa_attention_cuda(q, k, v, window=w, return_lse=True)
        got = kswa.swa_backward_cuda(q, k, v, o, do, lse, window=w)
        again = kswa.swa_backward_cuda(q, k, v, o, do, lse, window=w)
        torch.cuda.synchronize()
        want = swa_backward_ref(q, k, v, do, window=w)
        errs = {n: frobenius(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        if not torch.equal(o0, o):
            fail(f"K6 f32 at {shape}: the output changes when the LSE is written")
        if any(not torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"K6 backward at {shape}: two runs differ")
        if max(errs.values()) > K6B_TOL or not all(torch.isfinite(a).all() for a in got):
            fail(f"K6 backward at {shape}: normwise errors {errs} above {K6B_TOL}")
        if shape == K6B_MAIN:
            main_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        say("k6_backward", shape="x".join(map(str, shape)), dtype="float32",
            normwise=json.dumps(errs).replace(" ", ""), bitwise_rerun=True, o_with_lse="bitwise")
        del q, k, v, do, o0, o, lse, got, again, want
    torch.cuda.empty_cache()

    # timed at llama3.2-1b's training shape, in turns
    B, H, Hkv, T, S, D, w = K6B_MAIN
    q, k, v = k6_inputs(K6B_MAIN, torch.float32, gen, dev)
    do = torch.randn(B, T, H * D, generator=gen, device=dev).view(B, T, H, D).transpose(1, 2)
    o, lse = kswa.swa_attention_cuda(q, k, v, window=w, return_lse=True)
    lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True, enable_gqa=True)

    def sdpa_bwd():
        torch.autograd.grad(lo, (lq, lk, lv), do, retain_graph=True)

    bwd = {
        "kernel": lambda: kswa.swa_backward_cuda(q, k, v, o, do, lse, window=w),
        "plain": lambda: swa_backward_ref(q, k, v, do, window=w), "library": sdpa_bwd}
    fwd = {
        "kernel": lambda: kswa.swa_attention_cuda(q, k, v, window=w, return_lse=True),
        "plain": lambda: swa_ref(q, k, v, window=w),
        "library": lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                          enable_gqa=True)}
    runs = {"kernel": [], "plain": [], "library": []}
    fwd_runs = {"kernel": [], "plain": [], "library": []}
    for fns, out in ((bwd, runs), (fwd, fwd_runs)):
        for name in ("kernel", "plain", "library", "library", "plain", "kernel"):
            out[name].append(cuda_time_ms(fns[name], reps=5 if name == "plain" else 10, warm=2))
    bound, bound_by, gflop, floor = k6b_bound(K6B_MAIN)
    fbound, fbound_by, ffloor = k6_bound(K6B_MAIN, 4)
    ms, fms = min(runs["kernel"]), min(fwd_runs["kernel"])
    say("k6_backward_time", shape="x".join(map(str, K6B_MAIN)), dtype="float32",
        ms_runs=runs["kernel"], plain_ms_runs=runs["plain"], sdpa_backward_ms_runs=runs["library"],
        bound_ms=bound, bound_by=bound_by, bound_kind="3xTF32", gflop=gflop,
        share_of_bound=bound / ms, f32_cuda_core_floor_ms=floor, share_of_f32_floor=floor / ms,
        launches_per_call=3)
    say("k6_forward_f32_train", shape="x".join(map(str, K6B_MAIN)), with_lse=True,
        ms_runs=fwd_runs["kernel"], plain_ms_runs=fwd_runs["plain"],
        sdpa_ms_runs=fwd_runs["library"], bound_ms=fbound, bound_by=fbound_by,
        bound_kind="3xTF32", share_of_bound=fbound / fms, f32_cuda_core_floor_ms=ffloor,
        share_of_f32_floor=ffloor / fms)
    del q, k, v, do, o, lse, lq, lk, lv, lo
    torch.cuda.empty_cache()
    return {"name": "swa_backward", "route": "cuda",
            "source": "src/repro_torch/kernels/swa/csrc/swa_bwd.cu",
            "replaces": "src/repro/kernels/swa/kernel.py:129",
            "pallas_counterpart": "none: the reference differentiates its plain attention; "
                                  "this is the backward of K6, whose pallas_call is that line",
            "launches": 0, "max_abs_err": main_err, "ms": ms, "plain_ms": min(runs["plain"]),
            "bound_ms": bound, "bound_by": bound_by, "library_ms": min(runs["library"]),
            "f32_cuda_core_floor_ms": floor,
            "f32_forward_train": {"ms": fms, "plain_ms": min(fwd_runs["plain"]),
                                  "library_ms": min(fwd_runs["library"]), "bound_ms": fbound,
                                  "f32_cuda_core_floor_ms": ffloor}}


def train_compare(run, wrappers, model: str) -> dict:
    """The first step's loss, grad_norm and every gradient leaf on the
    kernel path against use_kernel="ref" on the card, from the launcher's
    parameters and its step-0 batch.  Each of ``wrappers`` (the path's
    kernels, forward and backward) must launch on the kernel path and not
    on the plain one."""
    import dataclasses

    from repro_torch import optim
    from repro_torch.train import value_and_grad

    batch = run.data.batch_at(0)
    out = {}
    for route in ("auto", "ref"):
        c0 = [w.launches for w in wrappers]
        loss, _, grads = value_and_grad(run.params, run.cfg,
                                        dataclasses.replace(run.tcfg, use_kernel=route), batch)
        out[route] = (float(loss), float(optim.global_norm(grads)), grads,
                      [w.launches - c for w, c in zip(wrappers, c0)])
        del grads
    (lk, nk, gk, fk), (lr, nr, gr, fr) = out["auto"], out["ref"]
    if not all(fk) or any(fr):
        fail(f"train {model}: the kernel path launched {[w.__name__ for w in wrappers]} {fk} "
             f"times, the plain path {fr}")
    leaf = {n: frobenius(gk[n], gr[n]) for n in gr}
    worst = max(leaf, key=leaf.get)
    errs = {"loss": abs(lk - lr) / abs(lr), "grad_norm": abs(nk - nr) / nr, "leaf": leaf[worst]}
    if any(errs[k] > TRAIN_TOL[k] for k in errs) or not (math.isfinite(lk) and nk > 0):
        fail(f"train {model}: kernel path vs plain path {errs} (worst leaf {worst}), "
             f"tolerances {TRAIN_TOL}")
    say("train_vs_plain", model=model, step=0, loss_kernel=lk, loss_plain=lr,
        grad_norm_kernel=nk, grad_norm_plain=nr, rel_err=json.dumps(errs).replace(" ", ""),
        worst_leaf=worst, leaves=len(leaf), kernel_launches=fk,
        tolerances=json.dumps(TRAIN_TOL).replace(" ", ""))
    del out, gk, gr
    torch.cuda.empty_cache()
    return errs


TRAIN_KINDS = (("k6_backward", ("swa_bwd",)), ("k6_forward", ("swa_kernel",)),
               ("k7_backward", ("ssd_bwd",)), ("k7_forward", ("ssd_chunk_kernel",)),
               ("matmul", ("gemm", "Gemm", "gemv", "nvjet", "xmma", "cutlass")),
               ("reduce", ("reduce",)), ("copy", ("copy", "Copy", "Memcpy", "cat")),
               ("elementwise", ("elementwise", "Elementwise")))


def train_split(run, step: int) -> dict:
    """One more step (after the counted ones) split by the host clock into
    the loss and its gradients, and the AdamW update (each synchronised),
    and one step's device time by kind from the profiler."""
    from repro_torch import optim
    from repro_torch.models import transformer as tf
    from repro_torch.optim import schedule
    from repro_torch.train import value_and_grad

    batch = run.data.batch_at(step)
    t0 = time.perf_counter()
    _, _, grads = value_and_grad(run.params, run.cfg, run.tcfg, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    lr = schedule.warmup_cosine(run.opt_state["step"], warmup=run.tcfg.warmup,
                                total=run.tcfg.total_steps)
    optim.update(grads, run.opt_state, run.params, run.tcfg.opt, lr_scale=lr,
                 layout=tf.reference_layout(run.cfg))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del grads
    kinds = categories(lambda: run.trainer.train_step(run.params, run.opt_state, batch), 1,
                       TRAIN_KINDS)
    return {"loss_and_grad_ms": (t1 - t0) * 1e3, "adamw_update_ms": (t2 - t1) * 1e3,
            **{k.replace("iteration", "step"): v for k, v in kinds.items()}}


def train_whole(phase: str, argv, size, wrappers, flop_fn) -> dict:
    """A model trained whole on the card: set up by the launcher from
    ``argv`` (its parameter count and layers must be ``size``), its first
    step held against the plain path, then its steps through
    ``Trainer.run`` with the ``wrappers``' counts set to 0 just before and
    read just after.  The forward kernel (``wrappers[0]``) must launch twice
    a layer a step (once more when remat "full" recomputes it in the
    backward), the backward kernel once.  ``flop_fn(cfg, n_params, B, T)``
    gives the model FLOPs a step.  Returns the launches and errors."""
    from repro_torch.launch import train as launch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = launch.build(list(argv))
    name, n_params, layers = run.args.arch, run.cfg.param_count(), run.cfg.n_layers
    if (n_params, layers) != size:
        fail(f"train: {name} has {n_params} parameters in {layers} layers, expected {size}")
    setup_s = time.perf_counter() - t0
    errs = train_compare(run, wrappers, name)
    steps, B, T = run.args.steps, run.args.batch, run.args.seq
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run.params, run.opt_state, hist = run.trainer.run(run.params, run.opt_state, steps)
    torch.cuda.synchronize()
    fwd, bwd = (w.launches for w in wrappers)
    predicted = (2 * layers * steps, layers * steps)
    if (fwd, bwd) != predicted:
        fail(f"train {name}: forward/backward kernels launched {fwd}/{bwd} times in {steps} "
             f"steps, predicted {predicted}")
    if len(hist) != steps or not all(map(math.isfinite, hist)) or not hist[-1] < hist[0]:
        fail(f"train {name}: losses {hist} (the last must be below the first)")
    step_ms = float(np.median(run.trainer.step_s[1:5])) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    split = train_split(run, steps)
    flop = flop_fn(run.cfg, n_params, B, T)
    say(phase, model=name, params=n_params, layers=layers,
        batch=B, seq=T, dtype="float32", remat=run.tcfg.remat, moments=run.tcfg.opt.moments,
        losses=hist, step_ms_median_2_5=step_ms, step_ms=[s * 1e3 for s in run.trainer.step_s],
        tokens_per_s=B * T / (step_ms / 1e3), max_memory_allocated_gb=peak_gb,
        model_tflop_per_step=flop / 1e12, share_of_f32_peak=flop / (step_ms / 1e3) / F32_FLOP_PER_S,
        forward_kernel=wrappers[0].__name__, forward_launches=fwd, backward_launches=bwd,
        launches_per_step=f"{fwd // steps}/{bwd // steps}", predicted_per_step=
        f"{predicted[0] // steps}/{predicted[1] // steps}", setup_s=setup_s, **split)
    del run
    torch.cuda.empty_cache()
    return {"forward": fwd, "backward": bwd, **errs}


def train_llama(kswa) -> dict:
    """Phase 40 (train_llama): llama3.2-1b whole (16 layers, d 2048,
    1,236,338,688 parameters, float32) set up by the launcher at batch
    4 x 2048 (AdamW lr 5e-4, remat "full", float32 moments), its first
    step held against the plain path, then 6 steps through ``Trainer.run``
    with K6's launches as predicted (its forward twice a layer, its backward
    once)."""
    def flop(cfg, n_params, B, T):
        pairs = T * (T + 1) // 2
        return 6 * n_params * B * T + 12 * cfg.head_dim * cfg.n_heads * pairs * B * cfg.n_layers

    return train_whole("train_llama", TRAIN_ARGV, TRAIN_SIZE,
                       (kswa.swa_attention_cuda, kswa.swa_backward_cuda), flop)


def train_restart(dev) -> tuple[int, int]:
    """Phase 41 (train_restart): examples/torch_train_lm.py's quick model
    (its own run, which must end with OK, is phase 35's): RESTART_STEPS[0]
    steps and a checkpoint, a new Trainer that resumes to RESTART_STEPS[1],
    against as many steps without a stop.  Returns K6's forward and backward launches of these runs."""
    import os
    import shutil
    import tempfile

    import torch_train_lm as ex

    from repro_torch import optim
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels.swa import kernel as kswa
    from repro_torch.models import transformer as tf
    from repro_torch.train import Trainer, make_train_step

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    stop, total = RESTART_STEPS
    cfg, tcfg = ex.model_cfg(False), ex.train_cfg(total)
    f0, b0 = kswa.swa_attention_cuda.launches, kswa.swa_backward_cuda.launches

    def trainer(ckpt):
        data = SyntheticLMData(vocab=cfg.vocab, batch=16, seq=128, seed=0, device=dev.type)
        return Trainer(cfg=cfg, train_step=make_train_step(cfg, tcfg), data=data,
                       ckpt_dir=ckpt, log_every=1000)

    def start():
        params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.float32,
                                dev)
        return params, optim.init(params, tcfg.opt, layout=tf.reference_layout(cfg))

    t0 = time.perf_counter()
    p_full, _, h_full = trainer(None).run(*start(), total)
    ckpt = os.path.join(tmp, "restart")
    _, _, h1 = trainer(ckpt).run(*start(), stop)
    tr = trainer(ckpt)
    params, opt, s0 = tr.restore_or_init(*start())
    p_res, _, h2 = tr.run(params, opt, total - s0, step0=s0)
    got, want = np.asarray(h1 + h2), np.asarray(h_full)
    bitwise = bool(np.array_equal(got, want)) and all(torch.equal(p_res[k], p_full[k])
                                                      for k in p_full)
    rel = float(np.abs(got - want).max() / np.abs(want).max()) if len(got) == len(want) else 1.0
    if s0 != stop or len(got) != total or rel > 1e-6:
        fail(f"train restart: resumed at {s0}, losses {got} against {want}")
    shutil.rmtree(tmp, ignore_errors=True)
    launches = (kswa.swa_attention_cuda.launches - f0, kswa.swa_backward_cuda.launches - b0)
    say("train_restart", model=cfg.name, stop=stop, total=total, resumed_at=s0,
        losses_bitwise=bitwise, max_rel_diff=rel, seconds=time.perf_counter() - t0,
        k6_launches=f"{launches[0]}/{launches[1]}")
    return launches


# K7's backward (Ba, T, H, P, N, G, L), float32: mamba2-1.3b's training shape,
# jamba-v0.1-52b's Mamba layers (N 16), the launcher's --scale 0.05 cut of
# mamba2-1.3b (P 32, L 16), a ragged chunk (L 50), two groups, the SMOKE width
K7B_SHAPES = ((4, 2048, 64, 64, 128, 1, 64), (4, 2048, 128, 64, 16, 1, 64),
              (8, 128, 6, 32, 16, 1, 16), (1, 1000, 64, 64, 128, 1, 50),
              (2, 64, 8, 16, 16, 2, 8), (2, 16, 8, 16, 16, 1, 8))
K7B_MAIN = K7B_SHAPES[0]
K7B_TOL = 1e-5   # dx, ddt, ds, dB, dC normwise (Frobenius) against the plain version, float32
K7B_NAMES = ("dx", "ddt", "ds", "dB", "dC")
MAMBA_ARGV = ("--arch", "mamba2-1.3b", "--scale", "1.0", "--steps", "6", "--batch", "4",
              "--seq", "2048")
MAMBA_SIZE = (1_344_576_512, 48)   # mamba2-1.3b's parameters and layers


def k7b_bound(shape) -> tuple[float, str, float, float, float]:
    """Least time (ms) of K7's backward: x, dY, dS, B, C, dt and s read once
    and dx, ddt, ds, dB and dC (grouped) written once over the memory rate,
    or the products the causal block needs (C B^T once per group; dY X^T,
    W^T dY, M B and M^T C per head; all on the L (L + 1) / 2 entries of the
    lower triangle; the two dS products per head whole) as three TF32
    products each over the TF32 peak (3xTF32: the rate this card offers for
    products of float32 accuracy, the convention of ``k6b_bound``).  Also
    returns the GFLOP, the float32 CUDA-core floor of the same FLOP and
    that floor with the products counted per head on whole L x L squares
    (the first, CUDA-core form's arithmetic)."""
    Ba, T, H, P, N, G, L = shape
    cells, tri = Ba * (T // L) * H, L * (L + 1) // 2
    flop = Ba * (T // L) * G * 2 * tri * N + cells * (2 * tri * (2 * N + 2 * P) + 4 * L * N * P)
    square = cells * (2 * L * L * (3 * N + 2 * P) + 4 * L * N * P)
    words = 3 * Ba * T * H * P + 4 * Ba * T * G * N + 4 * Ba * T * H + Ba * T * H * N * P // L
    t_bytes = words * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = TF32_PRODUCTS * flop / TF32_FLOP_PER_S * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return (*bound, flop / 1e9, flop / F32_FLOP_PER_S * 1e3, square / F32_FLOP_PER_S * 1e3)


def k7b_inputs(shape, gen, dev):
    """K7's float32 inputs as the Mamba layer passes them, its ``s``, and
    the cotangents of y_diag and the states."""
    from repro_torch.kernels.ssd.ref import chunk_logdecay

    Ba, T, H, P, N, G, L = shape
    x, dt, A, B, C = k7_inputs(shape, torch.float32, gen, dev)
    dy = torch.randn(Ba, T, H, P, generator=gen, device=dev)
    dS = torch.randn(Ba, T // L, H, N, P, generator=gen, device=dev)
    return x, dt, A, B, C, chunk_logdecay(dt, A, L), dy, dS


def k7b_phase(kssd, dev) -> dict:
    """Phase 42 (k7_backward): K7's backward against
    ``ssd_intra_chunk_backward_ref`` at every K7B_SHAPES entry (float32;
    dx, ddt, ds, dB, dC normwise; two runs bitwise); then at mamba2-1.3b's
    training shape, in turns (kernel, plain, plain, kernel), the backward
    and its plain version (and the backward's device time by kernel, from
    the profiler), and K7's float32 forward and its plain version.
    Returns the kernels-line entry."""
    from repro_torch.kernels.ssd import ssd_intra_chunk_backward_ref, ssd_intra_chunk_ref

    gen = torch.Generator(device=dev).manual_seed(19)
    main_err = None
    for shape in K7B_SHAPES:
        x, dt, A, B, C, s, dy, dS = k7b_inputs(shape, gen, dev)
        got = kssd.ssd_backward_cuda(x, dt, s, B, C, dy, dS)
        again = kssd.ssd_backward_cuda(x, dt, s, B, C, dy, dS)
        torch.cuda.synchronize()
        want = ssd_intra_chunk_backward_ref(x, dt, s, B, C, dy, dS)
        for n, a, b in zip(K7B_NAMES, got, want):
            if a.shape != b.shape or a.dtype != b.dtype or not torch.isfinite(a).all():
                fail(f"K7 backward at {shape}: {n} is {tuple(a.shape)} {a.dtype}, expected "
                     f"{tuple(b.shape)} {b.dtype}, finite")
        if not all(torch.linalg.vector_norm(b) > 0 for b in want):
            fail(f"K7 backward at {shape}: a plain gradient is 0; the check would be empty")
        errs = {n: frobenius(a, b) for n, a, b in zip(K7B_NAMES, got, want)}
        if any(not torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"K7 backward at {shape}: two runs differ")
        if max(errs.values()) > K7B_TOL:
            fail(f"K7 backward at {shape}: normwise errors {errs} above {K7B_TOL}")
        if shape == K7B_MAIN:
            main_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        say("k7_backward", shape="Ba,T,H,P,N,G,L=" + ",".join(map(str, shape)), dtype="float32",
            normwise=json.dumps(errs).replace(" ", ""), bitwise_rerun=True)
        del x, dt, A, B, C, s, dy, dS, got, again, want
    torch.cuda.empty_cache()

    # timed at mamba2-1.3b's training shape, in turns
    x, dt, A, B, C, s, dy, dS = k7b_inputs(K7B_MAIN, gen, dev)
    L = K7B_MAIN[-1]
    fns = {"bwd": lambda: kssd.ssd_backward_cuda(x, dt, s, B, C, dy, dS),
           "bwd_plain": lambda: ssd_intra_chunk_backward_ref(x, dt, s, B, C, dy, dS),
           "fwd": lambda: kssd.ssd_intra_chunk_cuda(x, dt, A, B, C, chunk=L),
           "fwd_plain": lambda: ssd_intra_chunk_ref(x, dt, A, B, C, chunk=L)}
    runs = {k: [] for k in fns}
    for pair in (("bwd", "bwd_plain"), ("fwd", "fwd_plain")):
        for name in (pair[0], pair[1], pair[1], pair[0]):
            plain = name.endswith("plain")
            runs[name].append(cuda_time_ms(fns[name], reps=3 if plain else 10,
                                           warm=1 if plain else 3))
    bound, bound_by, gflop, floor, square = k7b_bound(K7B_MAIN)
    fbound, fbound_by, ffloor = k7_bound(K7B_MAIN, 4)
    ms, fms = min(runs["bwd"]), min(runs["fwd"])
    Ba, T, H, P, N, G, _ = K7B_MAIN
    plan = kssd.bwd_c_plan(Ba, T, H, G, N, P, L)
    # the backward's device time by kernel (its two kernels and the wrapper's
    # sum of the slices' dB and dC partials), over 5 calls
    split = categories(lambda: [fns["bwd"]() for _ in range(5)], 5,
                       (("dc", ("ssd_bwd_dc",)), ("dxdb", ("ssd_bwd_dxdb",))))
    say("k7_backward_time", shape="Ba,T,H,P,N,G,L=" + ",".join(map(str, K7B_MAIN)),
        dtype="float32", ms_runs=runs["bwd"], plain_ms_runs=runs["bwd_plain"],
        device_ms_by_kernel=split.get("ms_per_iteration_by_kind", "not measured"), bound_ms=bound,
        bound_by=bound_by, bound_kind="3xTF32", gflop=gflop, share_of_bound=bound / ms,
        f32_cuda_core_floor_ms=floor, share_of_f32_floor=floor / ms,
        f32_floor_whole_squares_ms=square, smem_bytes=plan[5], grid=plan[:3],
        heads_per_block=plan[4], launches_per_call=1)
    say("k7_forward_f32_train", shape="Ba,T,H,P,N,G,L=" + ",".join(map(str, K7B_MAIN)),
        ms_runs=runs["fwd"], plain_ms_runs=runs["fwd_plain"], bound_ms=fbound,
        bound_by=fbound_by, share_of_bound=fbound / fms, f32_cuda_core_floor_ms=ffloor,
        share_of_f32_floor=ffloor / fms)
    del x, dt, A, B, C, s, dy, dS
    torch.cuda.empty_cache()
    return {"name": "ssd_backward", "route": "cuda",
            "source": "src/repro_torch/kernels/ssd/csrc/ssd_bwd.cu",
            "replaces": "src/repro/kernels/ssd/kernel.py:88",
            "pallas_counterpart": "none: the reference differentiates its plain chunked scan; "
                                  "this is the backward of K7, whose pallas_call is that line",
            "launches": 0, "max_abs_err": main_err, "ms": ms, "plain_ms": min(runs["bwd_plain"]),
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "f32_cuda_core_floor_ms": floor, "f32_floor_whole_squares_ms": square,
            "f32_forward_train": {"ms": fms, "plain_ms": min(runs["fwd_plain"]),
                                  "library_ms": None, "bound_ms": fbound,
                                  "f32_cuda_core_floor_ms": ffloor}}


def train_mamba(kssd) -> dict:
    """Phase 43 (train_mamba): mamba2-1.3b whole (48 layers, d 2048, 64
    heads x 64, N 128, 1,344,576,512 parameters, float32) set up by the
    launcher at 4 x 2048 as llama3.2-1b is, its first step held against the
    plain path, then 6 steps through ``Trainer.run`` with K7's launches as
    predicted (its forward twice a layer under remat "full", its backward
    once)."""
    return train_whole("train_mamba", MAMBA_ARGV, MAMBA_SIZE,
                       (kssd.ssd_intra_chunk_cuda, kssd.ssd_backward_cuda),
                       lambda cfg, n_params, B, T: 6 * n_params * B * T)


def train_jamba_smoke(dev) -> tuple[int, int]:
    """Phase 44 (train_jamba_smoke): one loss-and-gradient step of jamba's
    SMOKE config (Mamba layers with a dense and an MoE FFN, an attention
    layer) in float32 on the card, the kernel path (K6's and K7's forward
    and backward) against use_kernel="ref": the loss, grad_norm and every
    leaf within TRAIN_TOL.  Returns K7's forward and backward launches."""
    import dataclasses
    from types import SimpleNamespace

    from repro_torch.configs.jamba_v01_52b import SMOKE
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels.ssd import kernel as kssd
    from repro_torch.kernels.swa import kernel as kswa
    from repro_torch.models import transformer as tf
    from repro_torch.train import TrainCfg

    cfg = dataclasses.replace(SMOKE, dtype="float32")
    run = SimpleNamespace(
        cfg=cfg, tcfg=TrainCfg(),
        params=tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.float32, dev),
        data=SyntheticLMData(vocab=cfg.vocab, batch=2, seq=32, seed=0, device=dev.type))
    wrappers = (kswa.swa_attention_cuda, kswa.swa_backward_cuda, kssd.ssd_intra_chunk_cuda,
                kssd.ssd_backward_cuda)
    c0 = [w.launches for w in wrappers]
    train_compare(run, wrappers, cfg.name)
    moved = [w.launches - c for w, c in zip(wrappers, c0)]
    return moved[2], moved[3]


def train_phases(dev) -> dict:
    """Phases 39-44 (slices 13 and 15: training): k6_backward, train_llama,
    train_restart, k7_backward, train_mamba, train_jamba_smoke.  Returns the
    K6 and K7 backwards' entries of the kernels line, their launches those
    of llama3.2-1b's and mamba2-1.3b's 6 steps, and the forward launches of
    training (K6: llama and the restart check; K7: mamba2 and jamba's
    SMOKE)."""
    from repro_torch.kernels.ssd import kernel as kssd
    from repro_torch.kernels.swa import kernel as kswa

    examples = str(Path(__file__).resolve().parent / "examples")
    if examples not in sys.path:
        sys.path.insert(0, examples)
    t0 = time.perf_counter()
    entry = k6b_phase(kswa, dev)
    llama = train_llama(kswa)
    restart = train_restart(dev)
    entry["launches"] = llama["backward"]
    entry["launches_restart_check"] = restart[1]
    t1 = time.perf_counter()
    k7_entry = k7b_phase(kssd, dev)
    mamba = train_mamba(kssd)
    jamba = train_jamba_smoke(dev)
    k7_entry["launches"] = mamba["backward"]
    k7_entry["launches_jamba_smoke"] = jamba[1]
    say("slice15", seconds=time.perf_counter() - t1, k7_forward_launches_train=mamba["forward"],
        k7_backward_launches_train=mamba["backward"], jamba_smoke_k7=f"{jamba[0]}/{jamba[1]}")
    say("slice13", seconds=time.perf_counter() - t0, k6_forward_launches_train=llama["forward"],
        k6_backward_launches_train=llama["backward"], elapsed_s=time.perf_counter() - T_START)
    return {"entries": [entry, k7_entry], "k6_forward": llama["forward"] + restart[0],
            "k7_forward": mamba["forward"] + jamba[0]}


# ---------------------------------------------------------------------------
# slice 17: context parallelism and GPipe across processes (phase
# context_parallel)
# ---------------------------------------------------------------------------

CP_WORLD = 4                 # gloo processes sharing the card, one sequence shard each
CP_SHARD = 2048              # tokens a process: B 1, T = 4 x 2048 = 8192
# name: (config, layers kept (None: all), seed of the weights and tokens)
CP_MODELS = {"mamba2": ("mamba2-1.3b", None, 0), "gemma3": ("gemma3-4b", 6, 1)}
CP_TOL = 1e-3                # normwise (Frobenius), sharded against one process
CP_LOGIT_ROWS = 1024         # gemma3: each shard's first rows (the halo'd ones) and its last
CP_RUNS = 3                  # timed forwards, median
# B, H, Hkv, T, S, D, window of K6 on this path (f32 with its LSE): the halo'd
# window layers of ranks 1-3 (S = T + W), rank 0's, and the ring's diagonal step
CP_K6 = ((1, 8, 4, 2048, 3072, 256, 1024), (1, 8, 4, 2048, 2048, 256, 1024),
         (1, 8, 4, 2048, 2048, 256, 2048))
CP_K7 = (1, 2048, 64, 64, 128, 1, 64)   # K7 on one shard of mamba2-1.3b (Ba, T, H, P, N, G, L)
CP_PIPE = ("llama3.2-1b", 4, 2048, 2)   # config, microbatches of 1 x 2048 tokens, seed
CP_PIPE_TOL = 1e-6           # GPipe against the layers in sequence, normwise


def cp_config(name: str):
    """The float32 config of a context-parallel cell (gemma3-4b cut to one
    period of its 5:1 pattern: 5 window layers and 1 global)."""
    import dataclasses

    from repro_torch.configs import get

    cfg_name, layers, _ = CP_MODELS[name]
    cfg = dataclasses.replace(get(cfg_name), dtype="float32")
    if layers is not None:
        pattern = cfg.stacks[0][0]
        if len(pattern) != layers:
            fail(f"{cfg_name}: its first period has {len(pattern)} layers, not {layers}")
        cfg = dataclasses.replace(cfg, stacks=((pattern, 1),))
    return cfg


def cp_build(name: str, dev):
    """The cell's model and its (1, T) tokens from its seed: the same on
    every process of the card."""
    from repro_torch.models import Model

    cfg = cp_config(name)
    gen = torch.Generator(device=dev).manual_seed(CP_MODELS[name][2])
    model = Model(cfg, generator=gen, dtype=torch.float32, device=dev)
    tokens = torch.randint(0, cfg.vocab, (1, CP_WORLD * CP_SHARD), generator=gen, device=dev)
    return cfg, model, tokens


def cp_logit_rows(name: str) -> torch.Tensor:
    """The rows of a shard whose logits are compared: all of them (mamba2),
    or the first CP_LOGIT_ROWS and the last (gemma3's vocab of 262144)."""
    if name == "mamba2":
        return torch.arange(CP_SHARD)
    return torch.cat([torch.arange(CP_LOGIT_ROWS), torch.tensor([CP_SHARD - 1])])


def host_ms(fn, sync_all=None) -> float:
    """Host-clock ms of ``fn()`` from a synchronised start to its synchronised
    end (``sync_all``: a barrier of the group before the start)."""
    if sync_all is not None:
        sync_all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def cp_timed(run, sync_all, runs: int) -> dict:
    """``runs`` timed ``run()`` calls started together (host ms each), with
    ``comm.shift`` timed on the host: its calls and the host ms inside them
    a run (the wait for this process's kernels before a staged copy, the
    copies, the wait for the peers)."""
    from repro_torch.core import comm

    shift, calls, inside = comm.shift, [0], [0.0]

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = shift(*args, **kw)
        inside[0] += (time.perf_counter() - t0) * 1e3
        calls[0] += 1
        return out

    comm.shift = timed
    try:
        ms = [host_ms(run, sync_all) for _ in range(runs)]
    finally:
        comm.shift = shift
    return {"ms": ms, "shift_calls": calls[0] / runs, "shift_host_ms": inside[0] / runs}


def cp_model_check(name: str, ref_dir: str) -> dict:
    """One process of the group: its shard of the cell's forward through
    ``context_parallel_fwd`` and the logits, K6's and K7's launches counted
    around it (zeroed just before, read just after), the hidden state and
    the logits against the one-process run's (``ref_dir``: the parent's
    hidden state of the whole sequence; the one-process logits of the
    compared rows are ``logits_fn`` of its rows), then CP_RUNS timed
    ``context_parallel_logits`` calls started together (``cp_timed``)."""
    import os

    from repro_torch.core import comm
    from repro_torch.distributed.context_parallel import (context_parallel_fwd,
                                                          context_parallel_logits)
    from repro_torch.kernels.ssd import kernel as kssd
    from repro_torch.kernels.swa import kernel as kswa
    from repro_torch.models import transformer as tf

    from repro_torch._device import resolve_device

    dev = resolve_device(None)   # the card, shared by the group's processes
    cfg, model, tokens = cp_build(name, dev)
    r = comm.rank()
    k6, k7 = kswa.swa_attention_cuda, kssd.ssd_intra_chunk_cuda
    comm.barrier()
    k6.launches = k6.tc_launches = k7.launches = 0
    by0 = dict(k7.by_kernel)
    with torch.inference_mode():
        h = context_parallel_fwd(model, cfg, tokens, axis="sp")
        logits = tf.logits_fn(model, h)
    torch.cuda.synchronize()
    launches = {"k6": k6.launches, "k6_tensor_core": k6.tc_launches, "k7": k7.launches,
                "k7_3xtf32": k7.by_kernel["3xTF32"] - by0["3xTF32"]}
    h_one = torch.load(os.path.join(ref_dir, f"{name}_hidden.pt"))[:, r * CP_SHARD:
                                                                   (r + 1) * CP_SHARD].to(dev)
    rows = cp_logit_rows(name).to(dev)
    with torch.inference_mode():
        want = tf.logits_fn(model, h_one.index_select(1, rows))[..., :cfg.vocab]
    got = logits.index_select(1, rows)[..., :cfg.vocab]
    out = {"launches": launches, "hidden_normwise": frobenius(h, h_one),
           "logits_normwise": frobenius(got, want),
           "hidden_max_abs": float((h - h_one).abs().max()),
           "logits_max_abs": float((got - want).abs().max()),
           "finite": bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
           "logits_shape": list(logits.shape)}
    del h, logits, got, want, h_one

    def run():
        with torch.inference_mode():
            context_parallel_logits(model, cfg, tokens, axis="sp")

    out.update(cp_timed(run, comm.barrier, CP_RUNS))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def cp_pipe_stage(cfg, positions):
    """GPipe's ``stage_fn(params, x)`` for a stage of ``cfg``'s layers,
    ``params`` a list of (block, layer spec)."""
    from repro_torch.models import blocks

    def stage(params, x):
        for block, layer in params:
            x = blocks.layer_fwd(block, cfg, layer, x, mode="train", positions=positions)[0]
        return x

    return stage


def cp_pipe_setup(dev):
    """llama3.2-1b in float32 from its seed and the microbatches (M, 1, T, d)."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.models import Model

    name, M, T, seed = CP_PIPE
    cfg = dataclasses.replace(get(name), dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = Model(cfg, generator=gen, dtype=torch.float32, device=dev)
    xs = torch.randn(M, 1, T, cfg.d_model, generator=gen, device=dev)
    return cfg, model, xs


def cp_gpipe_check(ref_dir: str) -> dict:
    """One process of the group: stage r of llama3.2-1b (layers 4r..4r+3)
    under ``gpipe``, K6's launches counted around it, the outputs against
    the parent's layers applied in sequence; then timed."""
    import os

    from repro_torch.core import comm
    from repro_torch.distributed.pipeline import gpipe
    from repro_torch.kernels.swa import kernel as kswa

    from repro_torch._device import resolve_device

    dev = resolve_device(None)
    cfg, model, xs = cp_pipe_setup(dev)
    S, r = comm.world_size(), comm.rank()
    per = cfg.n_layers // S
    params = [(model.layers[i], cfg.layers_flat[i]) for i in range(r * per, (r + 1) * per)]
    stage = cp_pipe_stage(cfg, torch.arange(xs.shape[2], device=dev))
    k6 = kswa.swa_attention_cuda
    comm.barrier()
    k6.launches = 0
    with torch.inference_mode():
        got = gpipe(stage, params, xs, axis="pod")
    torch.cuda.synchronize()
    launches = k6.launches
    want = torch.load(os.path.join(ref_dir, "gpipe_sequential.pt")).to(dev)
    out = {"launches": launches, "normwise": frobenius(got, want),
           "bitwise": bool(torch.equal(got, want)), "finite": bool(torch.isfinite(got).all())}
    del got, want

    def run():
        with torch.inference_mode():
            gpipe(stage, params, xs, axis="pod")

    out["ms"] = [host_ms(run, comm.barrier) for _ in range(CP_RUNS)]
    return out


CP_CHECKS = {"cp_mamba2": lambda ref_dir: cp_model_check("mamba2", ref_dir),
             "cp_gemma3": lambda ref_dir: cp_model_check("gemma3", ref_dir),
             "cp_gpipe": cp_gpipe_check}


def cp_kernel_checks(kswa, kssd, dev) -> dict:
    """K6 (float32, with its LSE) at every shape of this path and K7 at the
    shard's shape against their plain versions on the card; K6 at the halo
    shape timed in turns with its plain version and SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd import ssd_intra_chunk_ref
    from repro_torch.kernels.swa import swa_lse_ref

    gen = torch.Generator(device=dev).manual_seed(31)
    out = {"k6_max_abs": 0.0}
    for shape in CP_K6:
        w = shape[-1]
        q, k, v = k6_inputs(shape, torch.float32, gen, dev)
        tc0 = kswa.swa_attention_cuda.tc_launches
        o, lse = kswa.swa_attention_cuda(q, k, v, window=w, return_lse=True)
        torch.cuda.synchronize()
        if kswa.swa_attention_cuda.tc_launches != tc0 + 1:
            fail(f"context_parallel: K6 at {shape} did not run on the tensor cores")
        wo, wl = swa_lse_ref(q, k, v, window=w)
        (eo, do), (el, dl) = normwise(o, wo), normwise(lse, wl)
        if not (eo <= K6_TOL["float32"] and el <= K6_TOL["float32"]):
            fail(f"context_parallel: K6 at {shape} differs from its plain version: output "
                 f"{eo}, LSE {el} normwise > {K6_TOL['float32']}")
        out["k6_max_abs"] = max(out["k6_max_abs"], do)
        say("cp_kernel", kernel="K6 f32 with LSE", shape="B,H,Hkv,T,S,D,W=" +
            ",".join(map(str, shape)), out_normwise=eo, lse_normwise=el, out_max_abs=do,
            lse_max_abs=dl, tol=K6_TOL["float32"])
        if shape == CP_K6[0]:
            k_ms, p_ms, l_ms = [], [], []
            for who in ("kernel", "plain", "library", "library", "plain", "kernel"):
                if who == "kernel":
                    k_ms.append(cuda_time_ms(lambda: kswa.swa_attention_cuda(
                        q, k, v, window=w, return_lse=True), reps=10))
                elif who == "plain":
                    p_ms.append(cuda_time_ms(lambda: swa_lse_ref(q, k, v, window=w), reps=3,
                                             warm=1))
                else:   # SDPA on the band mask of the halo'd shard, a yardstick
                    T, S = shape[3], shape[4]
                    qp = torch.arange(T, device=dev)[:, None] + (S - T)
                    kp = torch.arange(S, device=dev)[None, :]
                    band = (kp <= qp) & (kp > qp - w)
                    l_ms.append(cuda_time_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=band, enable_gqa=True), reps=10))
            bound, bound_by, floor = k6_bound(shape, 4)
            out["k6_halo"] = {"ms": min(k_ms), "plain_ms": min(p_ms), "library_ms": min(l_ms),
                              "bound_ms": bound, "bound_by": bound_by}
            say("cp_kernel_time", kernel="K6 f32 with LSE", shape="B,H,Hkv,T,S,D,W=" +
                ",".join(map(str, shape)), ms_runs=k_ms, plain_ms_runs=p_ms,
                sdpa_band_ms_runs=l_ms, bound_ms=bound, bound_by=bound_by,
                share_of_bound=bound / min(k_ms), f32_cuda_core_floor_ms=floor)
        del q, k, v, o, lse, wo, wl
    ins = k7_inputs(CP_K7, torch.float32, gen, dev)
    b0 = dict(kssd.ssd_intra_chunk_cuda.by_kernel)
    got = kssd.ssd_intra_chunk_cuda(*ins, chunk=CP_K7[-1])
    torch.cuda.synchronize()
    if kssd.ssd_intra_chunk_cuda.by_kernel["3xTF32"] != b0["3xTF32"] + 1:
        fail("context_parallel: K7 at the shard's shape did not run its 3xTF32 kernel")
    want = ssd_intra_chunk_ref(*ins, chunk=CP_K7[-1])
    errs = {n: normwise(a, b) for n, a, b in zip(("y_diag", "states", "s"), got, want)}
    for n, (e, _) in errs.items():
        if not e <= K7_TOL["float32"][n]:
            fail(f"context_parallel: K7 at {CP_K7} {n} differs from its plain version, "
                 f"normwise {e} > {K7_TOL['float32'][n]}")
    out["k7_max_abs"] = errs["y_diag"][1]
    say("cp_kernel", kernel="K7 f32", shape="Ba,T,H,P,N,G,L=" + ",".join(map(str, CP_K7)),
        **{f"{n}_normwise": e for n, (e, _) in errs.items()},
        **{f"{n}_max_abs": d for n, (_, d) in errs.items()},
        tol=json.dumps(K7_TOL["float32"]).replace(" ", ""))
    del ins, got, want
    torch.cuda.empty_cache()
    return out


def context_parallel_phase(card: str, kswa, kssd, dev, before_spawn=None) -> dict:
    """Phase 45 (context_parallel): K6 and K7 at this path's shapes against
    their plain versions; mamba2-1.3b whole and gemma3-4b cut to 6 layers,
    float32, B 1, T 8192, run whole in this process (the one-process
    reference, its hidden state saved for the children; timed), then in
    CP_WORLD gloo processes sharing the card, one 2048-token shard each,
    through ``context_parallel_fwd``/``context_parallel_logits`` (started
    after ``before_spawn()``, where given): the hidden
    state and the logits within CP_TOL normwise of one process, K6's and
    K7's launches per process (gemma3 5 + 1, mamba2 48) all kernel
    launches, the sharded forward timed against the one-process one;
    llama3.2-1b's 16 layers as 4 GPipe stages of 4 (4 microbatches of
    1 x 2048) against the layers in sequence.  gloo stages every exchange
    through the host: the times measure no link.  Returns the launches and
    the kernels-line numbers."""
    import shutil
    import tempfile

    from repro_torch.models import transformer as tf

    t_phase = time.perf_counter()
    kern = cp_kernel_checks(kswa, kssd, dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cp_")
    one = {}
    try:
        for name in CP_MODELS:
            cfg, model, tokens = cp_build(name, dev)

            def whole():
                with torch.inference_mode():
                    h, _, _ = tf.fwd(model, tokens, mode="train")
                    return h, tf.logits_fn(model, h)

            h, logits = whole()   # warm; the reference of the children's check
            if not torch.isfinite(logits[..., :cfg.vocab]).all():
                fail(f"context_parallel: {cfg.name}'s one-process logits are not finite")
            torch.save(h.cpu(), f"{tmp}/{name}_hidden.pt")
            del h, logits
            one[name] = {"ms": [host_ms(whole) for _ in range(CP_RUNS)],
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                         "layers": cfg.n_layers}
            del model, tokens
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        cfg, model, xs = cp_pipe_setup(dev)
        stage = cp_pipe_stage(cfg, torch.arange(xs.shape[2], device=dev))
        params = list(zip(model.layers, cfg.layers_flat))

        def sequential():
            with torch.inference_mode():
                return torch.stack([stage(params, x) for x in xs])

        seq = sequential()
        torch.save(seq.cpu(), f"{tmp}/gpipe_sequential.pt")
        one["gpipe"] = {"ms": [host_ms(sequential) for _ in range(CP_RUNS)],
                        "layers": cfg.n_layers}
        del model, xs, params, seq
        torch.cuda.empty_cache()
        if before_spawn is not None:
            before_spawn()
        t0 = time.perf_counter()
        got = dist_spawn(CP_WORLD, "gloo", tuple(CP_CHECKS), tmp,
                         args={name: {"ref_dir": tmp} for name in CP_CHECKS})
        spawn_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for name in CP_MODELS:
        res = [g[f"cp_{name}"] for g in got]
        mixers = [layer.mixer for layer in cp_config(name).layers_flat]
        # one K6 launch an attention layer (a halo'd window or the ring's
        # diagonal), one K7 launch a Mamba layer
        exp = {"k6": len(mixers) - mixers.count("mamba"), "k7": mixers.count("mamba")}
        for r, x in enumerate(res):
            n = x["launches"]
            if (n["k6"], n["k7"]) != (exp["k6"], exp["k7"]) or n["k6_tensor_core"] != n["k6"] \
                    or n["k7_3xtf32"] != n["k7"]:
                fail(f"context_parallel {name}: rank {r} launched K6/K7 {n}, expected {exp}, "
                     "every launch a tensor-core one")
            if not x["finite"] or max(x["hidden_normwise"], x["logits_normwise"]) > CP_TOL:
                fail(f"context_parallel {name}: rank {r} hidden {x['hidden_normwise']}, logits "
                     f"{x['logits_normwise']} normwise from one process (> {CP_TOL}), or not "
                     "finite")
        sharded = sorted(max(x["ms"][i] for x in res) for i in range(CP_RUNS))[CP_RUNS // 2]
        say("context_parallel", cell=f"{CP_MODELS[name][0]} {one[name]['layers']} layers f32 "
            f"B1 T{CP_WORLD * CP_SHARD}", processes=CP_WORLD, link="gloo staging through "
            "host on one card (measures no link)", card=repr(card),
            hidden_normwise=max(x["hidden_normwise"] for x in res),
            logits_normwise=max(x["logits_normwise"] for x in res),
            hidden_max_abs=max(x["hidden_max_abs"] for x in res),
            logits_max_abs=max(x["logits_max_abs"] for x in res), bound=CP_TOL,
            logit_rows="all" if name == "mamba2" else f"first {CP_LOGIT_ROWS} and last a shard",
            k6_launches_per_process=res[0]["launches"]["k6"],
            k7_launches_per_process=res[0]["launches"]["k7"],
            sharded_ms_median=sharded, sharded_ms_by_rank=json.dumps(
                [x["ms"] for x in res]).replace(" ", ""),
            one_process_ms_median=sorted(one[name]["ms"])[CP_RUNS // 2],
            one_process_ms_runs=one[name]["ms"], one_process_peak_gb=one[name]["peak_gb"],
            peak_gb_by_rank=[x["peak_gb"] for x in res])
        say("context_parallel_breakdown", cell=CP_MODELS[name][0], card=repr(card),
            shifts_per_forward=[x["shift_calls"] for x in res],
            host_ms_inside_shifts_per_forward=[x["shift_host_ms"] for x in res],
            host_ms_per_forward=[sorted(x["ms"])[CP_RUNS // 2] for x in res])
    res = [g["cp_gpipe"] for g in got]
    ticks = CP_PIPE[1] + CP_WORLD - 1
    per_stage = one["gpipe"]["layers"] // CP_WORLD
    for r, x in enumerate(res):
        if x["launches"] != ticks * per_stage or not x["finite"] or x["normwise"] > CP_PIPE_TOL:
            fail(f"context_parallel gpipe: rank {r} launched K6 {x['launches']} times (expected "
                 f"{ticks * per_stage}), normwise {x['normwise']} from the layers in sequence")
    say("context_parallel", cell=f"{CP_PIPE[0]} f32, {CP_WORLD} GPipe stages of {per_stage} "
        f"layers, {CP_PIPE[1]} microbatches of 1 x {CP_PIPE[2]}", card=repr(card),
        link="gloo staging through host on one card (measures no link)",
        normwise=max(x["normwise"] for x in res), bitwise=all(x["bitwise"] for x in res),
        bound=CP_PIPE_TOL, k6_launches_per_process=res[0]["launches"], ticks=ticks,
        gpipe_ms_median=sorted(max(x["ms"][i] for x in res) for i in range(CP_RUNS))[CP_RUNS // 2],
        sequential_ms_median=sorted(one["gpipe"]["ms"])[CP_RUNS // 2])
    launches = {"k6": sum(g["cp_gemma3"]["launches"]["k6"] for g in got),
                "k7": sum(g["cp_mamba2"]["launches"]["k7"] for g in got),
                "k6_gpipe": sum(x["launches"] for x in res)}
    say("context_parallel", status="ok", elapsed_s=time.perf_counter() - t_phase,
        spawn_s=spawn_s, k6_launches=launches["k6"], k6_gpipe_launches=launches["k6_gpipe"],
        k7_launches=launches["k7"], elapsed_total_s=time.perf_counter() - T_START)
    return {**launches, **kern}


# ---------------------------------------------------------------------------
# slice 18: sharded training over a (data, model) process mesh (phase
# sharded_train)
# ---------------------------------------------------------------------------

SH_WORLD = 4                 # gloo processes sharing the card
SH_BATCH, SH_SEQ = 4, 2048   # the global batch of every cell
# cell: (config, layers kept, steps, (dp, tp)); full width, depth cut so that
# four processes staging ZeRO-3's gathers through the host fit the phase's
# 130 s.  mamba2-1.3b runs under dp 4 and over dp 2 x tp 2 (its Mamba layers
# tensor-parallel, slice 19), granite-moe-3b-a800m over dp 2 x tp 2 (its
# experts split, 20 a process)
SH_MODELS = {"llama": ("llama3.2-1b", 4, 3, (2, 2)), "mamba": ("mamba2-1.3b", 4, 2, (4, 1)),
             "mamba_tp": ("mamba2-1.3b", 4, 2, (2, 2)),
             "granite": ("granite-moe-3b-a800m", 4, 2, (2, 2))}
# the one-process run a cell is held against, where it shares another's
# (same config, batch and steps: run once)
SH_ONE = {"mamba_tp": "mamba"}
SH_ELASTIC = (2, (1, 4))     # llama: saved after 2 steps on (2, 2), step 3 on (1, 4)
SH_TOL = {"loss": 2e-4, "grad_norm": 1e-4}   # relative, sharded against one process
# K6 (B, H, Hkv, T, S, D, window) on a process's local heads, global causal:
# llama tp 2 (dp 2, 2 rows) and tp 4 (the elastic step's mesh, 4 rows),
# granite tp 2 (12 query heads, the 4 kv heads they use); the first and the
# last timed
SH_K6 = ((2, 16, 4, 2048, 2048, 64, 2048), (4, 8, 2, 2048, 2048, 64, 2048),
         (2, 12, 4, 2048, 2048, 64, 2048))
# K7 (Ba, T, H, P, N, G, L): mamba2-1.3b on a process's row under dp 4, on
# its local heads at tp 2 (dp 2, 2 rows) and at tp 4 (4 rows); the first
# two timed
SH_K7 = ((1, 2048, 64, 64, 128, 1, 64), (2, 2048, 32, 64, 128, 1, 64),
         (4, 2048, 16, 64, 128, 1, 64))
SH_COMPRESS = (1024, 2, 4096)   # one llama3.2-1b wi block under (2, 2): d/2 x 2 x d_ff/2
SH_EF_ROUNDS = 4             # error-feedback rounds of the same gradient
SH_RUNS = 2                  # timed compressed and plain all-reduces each, in turns


def sh_config(key: str) -> str:
    """Register the cell's config cut to its layers (full width) under a
    name of its own, which the launcher's ``--arch`` takes; returns it."""
    import dataclasses

    from repro_torch.configs import base as cb

    name, layers, _, _ = SH_MODELS[key]
    cfg = cb.get(name)
    pattern = cfg.stacks[0][0]
    cut = dataclasses.replace(cfg, name=f"{name}-{layers}l", stacks=((pattern, layers),))
    cb.register(cut)
    return cut.name


def sh_argv(key: str, mesh=None, ckpt_dir=None) -> list:
    _, _, steps, _ = SH_MODELS[key]
    argv = ["--arch", sh_config(key), "--scale", "1.0", "--steps", str(steps), "--batch",
            str(SH_BATCH), "--seq", str(SH_SEQ)]
    if mesh is not None:
        argv += ["--dp", str(mesh[0]), "--tp", str(mesh[1])]
    if ckpt_dir is not None:
        argv += ["--ckpt-dir", ckpt_dir]
    return argv


class CommMeter:
    """Host ms spent inside ``core.comm``'s collectives of sharded training
    and the bytes of this process's data they deliver to other processes
    (an all-gather or all-reduce: its tensor to each of the others; a
    reduce-scatter: the blocks it sends; the checkpoint's gather: its
    tensor to process 0), while installed."""

    NAMES = ("_parts", "_reduce_scatter", "max_over", "gather_to_first")

    def __init__(self):
        from repro_torch.core import comm

        self.comm, self.saved, self.ms, self.bytes, self.calls = comm, {}, 0.0, 0, 0

    def _sent(self, name, args) -> int:
        if name == "gather_to_first":   # (t, sub) items, sent to process 0
            return sum(t.nbytes for t, sub in args[0]
                       if self.comm.rank() != 0 and 0 in sub.ranks)
        t, sub = args[:2]
        n = sub.size
        return t.nbytes * (n - 1) // n if name == "_reduce_scatter" else t.nbytes * (n - 1)

    def _wrap(self, name, fn):
        def timed(*args):
            sent = self._sent(name, args)
            t0 = time.perf_counter()
            out = fn(*args)
            self.ms += (time.perf_counter() - t0) * 1e3
            self.bytes += sent
            self.calls += 1
            return out

        return timed

    def __enter__(self):
        for name in self.NAMES:
            self.saved[name] = getattr(self.comm, name)
            setattr(self.comm, name, self._wrap(name, self.saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.comm, name, fn)

    def take(self) -> dict:
        out = {"host_ms": self.ms, "bytes": self.bytes, "calls": self.calls}
        self.ms, self.bytes, self.calls = 0.0, 0, 0
        return out


def sh_steps(run, n: int, step0: int = 0) -> dict:
    """``n`` steps of a launcher's run through ``Trainer.run``, the step's
    metrics (loss, grad_norm) recorded from its train step."""
    seen = []
    step = run.trainer.train_step

    def recording(p, o, b):
        out = step(p, o, b)
        seen.append((float(out[2]["loss"]), float(out[2]["grad_norm"])))
        return out

    run.trainer.train_step = recording
    s0 = len(run.trainer.step_s)
    try:
        run.params, run.opt_state, hist = run.trainer.run(run.params, run.opt_state, n,
                                                          step0=step0)
    finally:
        run.trainer.train_step = step
    if len(hist) != n or not all(map(math.isfinite, hist)):
        fail(f"sharded_train: {run.args.arch} steps {step0}..{step0 + n - 1} gave {hist}")
    return {"loss": [a for a, _ in seen], "grad_norm": [b for _, b in seen],
            "step_ms": [s * 1e3 for s in run.trainer.step_s[s0:]]}


def sh_counters():
    from repro_torch.kernels.ssd import kernel as kssd
    from repro_torch.kernels.swa import kernel as kswa

    return (kswa.swa_attention_cuda, kswa.swa_backward_cuda, kssd.ssd_intra_chunk_cuda,
            kssd.ssd_backward_cuda)


def sh_launches(start) -> dict:
    """K6's and K7's launches since ``start`` (the counters' values then)."""
    k6, k6b, k7, k7b = sh_counters()
    return {"k6": k6.launches - start[0], "k6_backward": k6b.launches - start[1],
            "k7": k7.launches - start[2], "k7_backward": k7b.launches - start[3],
            "k6_tensor_core": k6.tc_launches - start[4],
            "k7_3xtf32": k7.by_kernel["3xTF32"] - start[5]}


def sh_zero() -> tuple:
    """Every counter of the path set to 0 (the per-kernel splits read as
    differences); returns the starting values for :func:`sh_launches`."""
    k6, k6b, k7, k7b = sh_counters()
    k6.launches = k6b.launches = k7.launches = k7b.launches = k6.tc_launches = 0
    return (0, 0, 0, 0, 0, k7.by_kernel["3xTF32"])


def sh_wait(go: str) -> float:
    """Wait for the parent's one-process runs (its file ``go``): the
    processes start up while the parent runs them.  Returns how many
    seconds after ``go`` this process was ready (0 if it waited)."""
    import dataclasses
    import os

    from repro_torch.configs.llama3_2_1b import SMOKE
    from repro_torch.models import transformer as tf
    from repro_torch.train import TrainCfg, value_and_grad

    # a SMOKE loss and gradient on the CPU, while the parent works: the
    # path's lazy imports (torch.utils.checkpoint imports torch._dynamo at
    # its first call: seconds a process, four at once) out of the first step
    cfg = dataclasses.replace(SMOKE, dtype="float32")
    tokens = torch.zeros(1, 8, dtype=torch.long)
    value_and_grad(tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), cfg,
                   TrainCfg(), {"tokens": tokens, "labels": tokens})
    deadline = time.perf_counter() + DIST_SPAWN_LIMIT_S
    late = os.path.exists(go)
    while not os.path.exists(go):
        if time.perf_counter() > deadline:
            fail(f"sharded_train: the parent did not start the group ({go})")
        time.sleep(0.05)
    return time.time() - os.path.getmtime(go) if late else 0.0


def sh_llama(ckpt_dir: str, go: str) -> dict:
    """One process of the group: llama3.2-1b cut to 4 layers through the
    launcher on (2, 2) (2 steps, a sharded checkpoint, step 3), then the
    elastic resume: the launcher on (1, 4) with ``--ckpt-dir`` restores its
    blocks of that checkpoint and runs step 3.  K6's launches counted around
    the runs (zeroed just before, read just after), the collectives metered
    around the steps."""
    from repro_torch import ckpt
    from repro_torch.core import comm
    from repro_torch.launch import train as launch

    late_s = sh_wait(go)
    t0 = time.perf_counter()
    run = launch.build(sh_argv("llama", SH_MODELS["llama"][3]))
    build_s = time.perf_counter() - t0
    shapes = {n: list(t.shape) for n, t in list(run.params.items())[:4]}
    comm.barrier()
    torch.cuda.reset_peak_memory_stats()
    start = sh_zero()
    with CommMeter() as meter:
        first = sh_steps(run, SH_ELASTIC[0])
        steps_comm = meter.take()
        t0 = time.perf_counter()
        # the Trainer's periodic save: the blocks gathered to process 0 now,
        # the files written on its thread while step 3 runs
        pending = ckpt.async_save({"params": run.params, "opt": run.opt_state},
                                  SH_ELASTIC[0], ckpt_dir, shardings=run.trainer.shardings)
        save_s, save_comm = time.perf_counter() - t0, meter.take()
        third = sh_steps(run, SH_MODELS["llama"][2] - SH_ELASTIC[0], step0=SH_ELASTIC[0])
        third_comm = meter.take()
        t0 = time.perf_counter()
        pending.result()
        write_wait_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = sh_launches(start)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del run
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    resumed = launch.build(sh_argv("llama", SH_ELASTIC[1], ckpt_dir))
    restore_s = time.perf_counter() - t0
    if resumed.step0 != SH_ELASTIC[0]:
        fail(f"sharded_train: the (1, 4) launcher resumed at {resumed.step0}")
    resumed.trainer.ckpt_dir = None   # no final save: the check is the step
    start = sh_zero()
    elastic = sh_steps(resumed, SH_MODELS["llama"][2] - SH_ELASTIC[0], step0=SH_ELASTIC[0])
    torch.cuda.synchronize()
    elastic_launches = sh_launches(start)
    del resumed
    torch.cuda.empty_cache()
    steps = {k: first[k] + third[k] for k in first}
    return {"steps": steps, "elastic": elastic, "launches": launches,
            "elastic_launches": elastic_launches, "peak_gb": peak, "shapes": shapes,
            "comm_steps": steps_comm, "comm_third": third_comm, "comm_save": save_comm,
            "save_s": save_s, "write_wait_s": write_wait_s, "restore_s": restore_s,
            "build_s": build_s, "late_s": late_s}


def sh_cell(key: str) -> dict:
    """One process of the group: the cell ``key`` through the launcher on
    its mesh (mamba2-1.3b under dp 4: its row of the batch; over dp 2 x tp
    2: its rows and its heads; granite: its rows and its experts), K6's and
    K7's launches counted, the collectives metered around the steps."""
    from repro_torch.core import comm
    from repro_torch.launch import train as launch

    run = launch.build(sh_argv(key, SH_MODELS[key][3]))
    comm.barrier()
    torch.cuda.reset_peak_memory_stats()
    start = sh_zero()
    with CommMeter() as meter:
        steps = sh_steps(run, SH_MODELS[key][2])
        metered = meter.take()
    torch.cuda.synchronize()
    out = {"steps": steps, "launches": sh_launches(start), "comm_steps": metered,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del run
    torch.cuda.empty_cache()
    return out


def sh_compress() -> dict:
    """One process of the group: ``compressed_psum_mean`` over a 1-D mesh of
    every process, of a gradient the size of one llama ``wi`` block (this
    process's from its seed): the one-shot error against the exact mean
    (every process's gradient rebuilt from its seed), the error-feedback
    time average over SH_EF_ROUNDS rounds, and host ms of the compressed
    mean against a float32 sum all-reduce of the same tensor."""
    from repro_torch._device import resolve_device
    from repro_torch.core import comm
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim import compress

    dev = resolve_device(None)
    world = comm.world_size()
    mesh = Mesh((world,), ("dp",))
    grads = [torch.randn(SH_COMPRESS, generator=torch.Generator(device=dev).manual_seed(100 + r),
                         device=dev) for r in range(world)]
    exact = torch.stack(grads).mean(0)
    x = grads[comm.rank()]
    amax = max(float(g.abs().max()) for g in grads)
    del grads
    err = torch.zeros_like(x)
    mean1, _ = compress.compressed_psum_mean(x, "dp", mesh)
    q_err = float((mean1 - exact).abs().max())
    acc = torch.zeros_like(x)
    for i in range(SH_EF_ROUNDS):
        m, err = compress.compressed_psum_mean(x + err, "dp", mesh)
        acc += (m - acc) / (i + 1)
    ef_err = float((acc - exact).abs().max())
    sub = mesh.group("dp")
    ms = {"compressed": [], "plain": []}
    for who in ("compressed", "plain", "plain", "compressed")[:2 * SH_RUNS]:
        fn = (lambda: compress.compressed_psum_mean(x, "dp", mesh)) if who == "compressed" \
            else (lambda: comm.sum_over(x, sub) / world)
        ms[who].append(host_ms(fn, comm.barrier))
    return {"q_err": q_err, "amax_over_127": amax / 127.0, "ef_err": ef_err,
            "ef_rounds": SH_EF_ROUNDS, "ms": ms, "mean_digest": float(mean1.double().sum()),
            "wire_bytes": compress.wire_bytes(SH_COMPRESS, world)}


SH_CHECKS = {"sh_llama": sh_llama, "sh_mamba": lambda: sh_cell("mamba"),
             "sh_mamba_tp": lambda: sh_cell("mamba_tp"), "sh_granite": lambda: sh_cell("granite"),
             "sh_compress": lambda: sh_compress()}


def sh_kernel_checks(kswa, kssd, dev) -> dict:
    """K6's float32 forward (with its LSE) and backward at the local-head
    shapes, and K7's forward and backward at a dp-4 process's row and at
    the tensor-parallel local heads, against their plain versions; the
    tp-2 K6 shapes (llama, granite) and the first two K7 shapes timed in
    turns with the plain versions (and SDPA for K6).  Returns the largest
    errors and, per timed shape, its times and bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd import ssd_intra_chunk_backward_ref, ssd_intra_chunk_ref
    from repro_torch.kernels.swa import swa_backward_ref, swa_lse_ref

    gen = torch.Generator(device=dev).manual_seed(37)
    out = {"k6_max_abs": 0.0, "k6b_max_abs": 0.0, "k7_max_abs": 0.0, "k7b_max_abs": 0.0,
           "k6_time": {}, "k6b_time": {}, "k7_time": {}, "k7b_time": {}}
    for shape in SH_K6:
        B, H, Hkv, T, S, D, w = shape
        q, k, v = k6_inputs(shape, torch.float32, gen, dev)
        do = torch.randn(B, T, H * D, generator=gen, device=dev).view(B, T, H, D).transpose(1, 2)
        tc0 = kswa.swa_attention_cuda.tc_launches
        o, lse = kswa.swa_attention_cuda(q, k, v, window=w, return_lse=True)
        got = kswa.swa_backward_cuda(q, k, v, o, do, lse, window=w)
        torch.cuda.synchronize()
        if kswa.swa_attention_cuda.tc_launches != tc0 + 1:
            fail(f"sharded_train: K6 at {shape} did not run on the tensor cores")
        wo, wl = swa_lse_ref(q, k, v, window=w)
        want = swa_backward_ref(q, k, v, do, window=w)
        errs = {"o": frobenius(o, wo), "lse": frobenius(lse, wl),
                **{n: frobenius(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}}
        if max(errs.values()) > K6B_TOL:
            fail(f"sharded_train: K6 at the local heads {shape}: normwise {errs} > {K6B_TOL}")
        out["k6_max_abs"] = max(out["k6_max_abs"], float((o - wo).abs().max()))
        out["k6b_max_abs"] = max(out["k6b_max_abs"],
                                 max(float((a - b).abs().max()) for a, b in zip(got, want)))
        say("sh_kernel", kernel="K6 f32 with LSE and its backward", shape="B,H,Hkv,T,S,D,W=" +
            ",".join(map(str, shape)), normwise=json.dumps(errs).replace(" ", ""), tol=K6B_TOL)
        if shape in (SH_K6[0], SH_K6[-1]):
            runs = {"kernel": [], "plain": [], "library": [], "bwd": [], "bwd_plain": []}
            fns = {"kernel": lambda: kswa.swa_attention_cuda(q, k, v, window=w, return_lse=True),
                   "plain": lambda: swa_lse_ref(q, k, v, window=w),
                   "library": lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                     enable_gqa=True),
                   "bwd": lambda: kswa.swa_backward_cuda(q, k, v, o, do, lse, window=w),
                   "bwd_plain": lambda: swa_backward_ref(q, k, v, do, window=w)}
            for who in ("kernel", "plain", "library", "bwd", "bwd_plain", "bwd_plain", "bwd",
                        "library", "plain", "kernel"):
                plain = who.endswith("plain")
                runs[who].append(cuda_time_ms(fns[who], reps=3 if plain else 10,
                                              warm=1 if plain else 3))
            bound, bound_by, _ = k6_bound(shape, 4)
            bbound, bbound_by, _, _ = k6b_bound(shape)
            name = ",".join(map(str, shape))
            out["k6_time"][name] = {"ms": min(runs["kernel"]), "plain_ms": min(runs["plain"]),
                                    "library_ms": min(runs["library"]), "bound_ms": bound,
                                    "bound_by": bound_by}
            out["k6b_time"][name] = {"ms": min(runs["bwd"]), "plain_ms": min(runs["bwd_plain"]),
                                     "bound_ms": bbound, "bound_by": bbound_by}
            say("sh_kernel_time", kernel="K6 f32 with LSE / backward", shape="B,H,Hkv,T,S,D,W="
                + ",".join(map(str, shape)), ms_runs=runs["kernel"],
                plain_ms_runs=runs["plain"], sdpa_ms_runs=runs["library"],
                backward_ms_runs=runs["bwd"], backward_plain_ms_runs=runs["bwd_plain"],
                bound_ms=bound, backward_bound_ms=bbound,
                share_of_bound=bound / min(runs["kernel"]),
                backward_share_of_bound=bbound / min(runs["bwd"]))
        del q, k, v, do, o, lse, got, want, wo, wl
        torch.cuda.empty_cache()
    for shape in SH_K7:
        L = shape[-1]
        x, dt, A, Bm, C, s, dy, dS = k7b_inputs(shape, gen, dev)
        b0 = kssd.ssd_intra_chunk_cuda.by_kernel["3xTF32"]
        got = kssd.ssd_intra_chunk_cuda(x, dt, A, Bm, C, chunk=L)
        gotb = kssd.ssd_backward_cuda(x, dt, s, Bm, C, dy, dS)
        torch.cuda.synchronize()
        if kssd.ssd_intra_chunk_cuda.by_kernel["3xTF32"] != b0 + 1:
            fail(f"sharded_train: K7 at {shape} did not run its 3xTF32 kernel")
        want = ssd_intra_chunk_ref(x, dt, A, Bm, C, chunk=L)
        wantb = ssd_intra_chunk_backward_ref(x, dt, s, Bm, C, dy, dS)
        errs = {n: normwise(a, b)[0] for n, a, b in zip(("y_diag", "states", "s"), got, want)}
        errb = {n: frobenius(a, b) for n, a, b in zip(K7B_NAMES, gotb, wantb)}
        if any(errs[n] > K7_TOL["float32"][n] for n in errs) or max(errb.values()) > K7B_TOL:
            fail(f"sharded_train: K7 at {shape}: forward {errs}, backward {errb} normwise")
        out["k7_max_abs"] = max(out["k7_max_abs"], float((got[0] - want[0]).abs().max()))
        out["k7b_max_abs"] = max(out["k7b_max_abs"],
                                 max(float((a - b).abs().max()) for a, b in zip(gotb, wantb)))
        timed = {}
        if shape in SH_K7[:2]:
            fns = {"fwd": lambda: kssd.ssd_intra_chunk_cuda(x, dt, A, Bm, C, chunk=L),
                   "fwd_plain": lambda: ssd_intra_chunk_ref(x, dt, A, Bm, C, chunk=L),
                   "bwd": lambda: kssd.ssd_backward_cuda(x, dt, s, Bm, C, dy, dS),
                   "bwd_plain": lambda: ssd_intra_chunk_backward_ref(x, dt, s, Bm, C, dy, dS)}
            runs = {n: [] for n in fns}
            for who in ("fwd", "fwd_plain", "bwd", "bwd_plain", "bwd_plain", "bwd", "fwd_plain",
                        "fwd"):
                plain = who.endswith("plain")
                runs[who].append(cuda_time_ms(fns[who], reps=3 if plain else 10,
                                              warm=1 if plain else 3))
            fbound, fbound_by, _ = k7_bound(shape, 4)
            bbound, bbound_by, _, _, _ = k7b_bound(shape)
            name = ",".join(map(str, shape))
            out["k7_time"][name] = {"ms": min(runs["fwd"]), "plain_ms": min(runs["fwd_plain"]),
                                    "bound_ms": fbound, "bound_by": fbound_by}
            out["k7b_time"][name] = {"ms": min(runs["bwd"]), "plain_ms": min(runs["bwd_plain"]),
                                     "bound_ms": bbound, "bound_by": bbound_by}
            timed = dict(ms_runs=runs["fwd"], plain_ms_runs=runs["fwd_plain"],
                         backward_ms_runs=runs["bwd"], backward_plain_ms_runs=runs["bwd_plain"],
                         bound_ms=fbound, backward_bound_ms=bbound)
        say("sh_kernel", kernel="K7 f32 and its backward", shape="Ba,T,H,P,N,G,L=" +
            ",".join(map(str, shape)), forward_normwise=json.dumps(errs).replace(" ", ""),
            backward_normwise=json.dumps(errb).replace(" ", ""), **timed)
        del x, dt, A, Bm, C, s, dy, dS, got, gotb, want, wantb
        torch.cuda.empty_cache()
    return out


def sh_one_process(key: str) -> dict:
    """The cell in this process (no mesh): the launcher's run, its steps'
    losses and grad norms, ms a step, peak memory, K6's/K7's launches."""
    from repro_torch.launch import train as launch

    run = launch.build(sh_argv(key))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = sh_zero()
    out = sh_steps(run, SH_MODELS[key][2])
    torch.cuda.synchronize()
    out["launches"] = sh_launches(start)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del run
    torch.cuda.empty_cache()
    return out


def sh_entries(sh, swa, ssd, swa_bwd, ssd_bwd) -> None:
    """Add the phase's launches and local-shape numbers to the kernels line:
    ``sharded_train_local`` the first timed shape (llama's tp-2 heads, a
    dp-4 row of mamba2), ``sharded_train_tp`` the second (granite's tp-2
    heads, mamba2's tp-2 heads)."""
    for entry, count, timed, err in ((swa, "k6", "k6_time", "k6_max_abs"),
                                     (swa_bwd, "k6_backward", "k6b_time", "k6b_max_abs"),
                                     (ssd, "k7", "k7_time", "k7_max_abs"),
                                     (ssd_bwd, "k7_backward", "k7b_time", "k7b_max_abs")):
        entry["launches_sharded_train"] = sh[count]
        entry["launches"] += sh[count]
        for key, (shape, numbers) in zip(("sharded_train_local", "sharded_train_tp"),
                                         sh[timed].items()):
            entry[key] = {"shape": shape, "dtype": "float32", "max_abs_err": sh[err], **numbers}


def sh_rel(a, b) -> float:
    return abs(a - b) / abs(b)


def sh_start() -> dict:
    """Start the phase's SH_WORLD processes: they import, join their group
    and warm up, then wait for the go file (``sh_wait``).  Returns what
    :func:`sharded_train_phase` and :func:`sh_stop` take."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_sh_")
    go = f"{tmp}/go"
    group = dist_start(SH_WORLD, "gloo", tuple(SH_CHECKS) + tuple(SV_CHECKS), tmp,
                       args={"sh_llama": {"ckpt_dir": f"{tmp}/ckpt", "go": go},
                             **{k: {"out": tmp} for k in SV_CHECKS}})
    return {"tmp": tmp, "go": go, "group": group}


def sh_stop(started: dict) -> None:
    """End the processes of :func:`sh_start` still running (a check here
    failed) and remove their directory."""
    import shutil

    for p in started["group"][0] if started.get("group") is not None else ():
        if p.poll() is None:
            p.kill()
            p.wait()
    started["group"] = None
    shutil.rmtree(started["tmp"], ignore_errors=True)


def sharded_train_phase(card: str, kswa, kssd, dev, started: dict | None = None) -> dict:
    """Phase 46 (sharded_train): ZeRO-3 with tensor parallelism over a
    ``(data, model)`` mesh of SH_WORLD gloo processes sharing the card.
    (a) K6 at the local-head shapes and K7 at a dp-4 row against their
    plain versions; (b) llama3.2-1b cut to 4 layers (full width, f32, the
    launcher's TrainCfg, 4 x 2048) for 3 steps in this process and over
    dp 2 x tp 2, every step's loss within SH_TOL, the first grad norm too,
    and the elastic resume (saved after step 2 on (2, 2), step 3 on
    (1, 4)); (c) mamba2-1.3b cut to 4 layers, 2 steps under dp 4 and over
    dp 2 x tp 2 (tensor-parallel Mamba layers) against one run in this
    process; (d) granite-moe-3b-a800m cut to 4 layers, 2 steps in this
    process and over dp 2 x tp 2 (expert parallelism); (e)
    ``compressed_psum_mean`` over the 4 processes.  K6's and K7's launches
    counted a process (all on the tensor cores, as predicted: the forward
    twice a layer a step under remat "full", the backward once).  Returns
    the launches and the kernel numbers.  ``started``: the processes of
    :func:`sh_start`, started earlier (default: started here)."""
    t_phase = time.perf_counter()
    started = started or sh_start()
    try:
        # the processes start up (imports, the group, a warm-up) while this
        # one checks the kernels and runs the cells alone; they begin at go
        kern = sh_kernel_checks(kswa, kssd, dev)
        kern_sv = sv_kernel_checks(card, kswa, kssd, dev)
        one = {key: sh_one_process(key) for key in SH_MODELS if key not in SH_ONE}
        t0 = time.perf_counter()
        open(started["go"], "w").close()
        # the serving cells' one-process runs while the processes train
        one_sv = sv_one_process(dev)
        got, started["group"] = dist_wait(*started["group"]), None
        spawn_s = time.perf_counter() - t0
        files = sv_load(started["tmp"], SH_WORLD)
    finally:
        sh_stop(started)

    def layers(key):
        return SH_MODELS[key][1]

    def predicted(key, steps):
        return 2 * layers(key) * steps, layers(key) * steps

    def kernel_of(key):   # the mixers' kernel: K7 for mamba2, K6 for the others
        return ("k7", "k7_backward") if key.startswith("mamba") else ("k6", "k6_backward")

    total = {"k6": 0, "k6_backward": 0, "k7": 0, "k7_backward": 0}
    for key in one:
        n, (fwd, bwd) = one[key]["launches"], kernel_of(key)
        if (n[fwd], n[bwd]) != predicted(key, SH_MODELS[key][2]):
            fail(f"sharded_train: one process of {key} launched {n}")
        total[fwd] += n[fwd]
        total[bwd] += n[bwd]
    cells = [key for key in SH_MODELS if key != "llama"]
    errs = {}
    for r, g in enumerate(got):
        x = g["sh_llama"]
        for what, res, key, steps in (
                ("llama (2, 2)", x["launches"], "llama", 3),
                ("llama (1, 4)", x["elastic_launches"], "llama", 1),
                *((f"{key} {SH_MODELS[key][3]}", g[f"sh_{key}"]["launches"], key,
                   SH_MODELS[key][2]) for key in cells)):
            fwd, bwd = kernel_of(key)
            on_tc = res["k6_tensor_core"] == res["k6"] and res["k7_3xtf32"] == res["k7"]
            if (res[fwd], res[bwd]) != predicted(key, steps) or not on_tc:
                fail(f"sharded_train {what}: rank {r} launched {res}, predicted "
                     f"{predicted(key, steps)} (K6 forward/backward or K7), all on the tensor "
                     "cores")
            total[fwd] += res[fwd]
            total[bwd] += res[bwd]
        for key, res in (("llama", x["steps"]), *((key, g[f"sh_{key}"]["steps"]) for key in cells)):
            want = one[SH_ONE.get(key, key)]
            rel = [sh_rel(a, b) for a, b in zip(res["loss"], want["loss"])]
            gn = sh_rel(res["grad_norm"][0], want["grad_norm"][0])
            errs[key] = max(errs.get(key, 0.0), max(rel))
            errs[key + "_grad_norm"] = max(errs.get(key + "_grad_norm", 0.0), gn)
            if len(rel) != SH_MODELS[key][2] or max(rel) > SH_TOL["loss"] or \
                    gn > SH_TOL["grad_norm"]:
                fail(f"sharded_train {key}: rank {r} losses {res['loss']} / grad norm "
                     f"{res['grad_norm'][0]} against one process {want['loss']} / "
                     f"{want['grad_norm'][0]}: {rel}, {gn} above {SH_TOL}")
        el = sh_rel(x["elastic"]["loss"][0], one["llama"]["loss"][SH_ELASTIC[0]])
        errs["elastic"] = max(errs.get("elastic", 0.0), el)
        if el > SH_TOL["loss"]:
            fail(f"sharded_train: rank {r}'s step 3 after the resume on (1, 4) "
                 f"{x['elastic']['loss']} vs one process {one['llama']['loss']}: {el}")
        c = g["sh_compress"]
        if not (c["q_err"] <= c["amax_over_127"] + 1e-6
                and c["ef_err"] < max(c["q_err"], 1e-4) + 1e-6):
            fail(f"sharded_train compress: rank {r} one-shot {c['q_err']} (bound "
                 f"{c['amax_over_127']}), error-feedback average {c['ef_err']}")
    if len({g["sh_compress"]["mean_digest"] for g in got}) != 1:
        fail("sharded_train compress: the processes' means differ")
    for key in SH_MODELS:
        res = [g[f"sh_{key}"] for g in got]
        st = [r["steps"]["step_ms"] for r in res]
        meter = [r["comm_steps"] for r in res]
        n_steps = SH_ELASTIC[0] if key == "llama" else SH_MODELS[key][2]
        cfg_name, n_layers, steps, mesh = SH_MODELS[key]
        alone = one[SH_ONE.get(key, key)]
        say("sharded_train", cell=f"{cfg_name} {n_layers} layers f32 {SH_BATCH}x{SH_SEQ}",
            mesh=f"dp{mesh[0]}xtp{mesh[1]}", processes=SH_WORLD, card=repr(card),
            link="gloo staging through host on one card (measures no link)",
            losses_one_process=alone["loss"], losses_sharded=res[0]["steps"]["loss"],
            grad_norm_one_process=alone["grad_norm"][0],
            grad_norm_sharded=res[0]["steps"]["grad_norm"][0],
            max_rel_err_loss=errs[key], max_rel_err_grad_norm=errs[key + "_grad_norm"],
            tol=json.dumps(SH_TOL).replace(" ", ""),
            step_ms_one_process=alone["step_ms"],
            step_ms_sharded_by_rank=json.dumps(st).replace(" ", ""),
            step_ms_sharded_median=float(np.median([max(s[i] for s in st)
                                                    for i in range(1, len(st[0]))])),
            host_share_in_collectives=[m["host_ms"] / sum(s[:n_steps])
                                       for m, s in zip(meter, st)],
            bytes_sent_per_step_by_rank=[m["bytes"] // n_steps for m in meter],
            collective_calls_per_step=[m["calls"] // n_steps for m in meter],
            max_memory_allocated_gb_by_rank=[r["peak_gb"] for r in res],
            max_memory_allocated_gb_one_process=alone["peak_gb"],
            launches_per_process=json.dumps(res[0]["launches"]).replace(" ", ""))
    x = [g["sh_llama"] for g in got]
    say("sharded_train_elastic", saved_after=SH_ELASTIC[0], first_mesh="dp2xtp2",
        second_mesh=f"dp{SH_ELASTIC[1][0]}xtp{SH_ELASTIC[1][1]}",
        loss_step3_resumed=x[0]["elastic"]["loss"][0],
        loss_step3_one_process=one["llama"]["loss"][SH_ELASTIC[0]],
        max_rel_err=errs["elastic"], save_s_by_rank=[r["save_s"] for r in x],
        write_wait_s_by_rank=[r["write_wait_s"] for r in x],
        build_s_by_rank=[r["build_s"] for r in x],
        ready_after_go_s_by_rank=[r["late_s"] for r in x],
        restore_s_by_rank=[r["restore_s"] for r in x],
        save_bytes_sent_by_rank=[r["comm_save"]["bytes"] for r in x],
        step_ms_resumed_by_rank=[r["elastic"]["step_ms"] for r in x],
        local_shapes_rank0=json.dumps(x[0]["shapes"]).replace(" ", ""))
    c = [g["sh_compress"] for g in got]
    say("sharded_train_compress", shape=SH_COMPRESS, processes=SH_WORLD, card=repr(card),
        one_shot_max_err=max(r["q_err"] for r in c), bound_amax_over_127=c[0]["amax_over_127"],
        error_feedback_max_err=max(r["ef_err"] for r in c), rounds=SH_EF_ROUNDS,
        compressed_host_ms_by_rank=[r["ms"]["compressed"] for r in c],
        plain_sum_host_ms_by_rank=[r["ms"]["plain"] for r in c],
        wire_bytes=json.dumps(c[0]["wire_bytes"]).replace(" ", ""))
    sv = sv_report(card, got, files, one_sv, {"kernels": kern_sv})
    elapsed = time.perf_counter() - t_phase
    say("sharded_train", status="ok", elapsed_s=elapsed, spawn_s=spawn_s,
        launches=json.dumps(total).replace(" ", ""),
        serve_launches=json.dumps({k: sv[k] for k in ("k6", "k7")}).replace(" ", ""),
        elapsed_total_s=time.perf_counter() - T_START)
    return {**total, **kern, "sv": sv}


# ---------------------------------------------------------------------------
# slice 20: serving under sharding rules (phase sharded_serve)
# ---------------------------------------------------------------------------

SV_MESH = (2, 2)
# cell: (config, layers kept, batch, prompt, new ids, dtype); full width, the
# depth cut as sharded_train cuts it (gemma3-4b: its first 6 layers, 5 window
# and 1 global), random weights from seed 0, cache_len = prompt + new.  The
# batch-1 cells run with cache_seq over (data, model): 254 slots a process
SV_CELLS = {"gemma3_bf16": ("gemma3-4b", 6, 4, 2048, 16, "bfloat16"),
            "gemma3_f32_b1": ("gemma3-4b", 6, 1, 1000, 16, "float32"),
            "mamba2_bf16": ("mamba2-1.3b", 4, 4, 2048, 16, "bfloat16"),
            "mamba2_f32_b1": ("mamba2-1.3b", 4, 1, 1000, 16, "float32")}
# logits normwise against one process: bf16 the first token's (the kernel
# rounds at other places once the heads and tokens are split), f32 every step's
SV_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
SV_TTFT_RUNS, SV_DECODE_RUNS = 3, 2
# K6 (B, H, Hkv, T, S, D, window) and K7 (Ba, T, H, P, N, G, L) at the local
# shapes of the cells' prefill: gemma3-4b's 4 query and 2 kv heads a process
# (tp 2), window 1024 and global; mamba2-1.3b's 32 heads a process.  The first
# of each dtype timed
SV_K6 = (((2, 4, 2, 2048, 2048, 256, 1024), "bfloat16"),
         ((2, 4, 2, 2048, 2048, 256, 2048), "bfloat16"),
         ((1, 4, 2, 1000, 1000, 256, 1024), "float32"),
         ((1, 4, 2, 1000, 1000, 256, 1000), "float32"))
SV_K7 = (((2, 2048, 32, 64, 128, 1, 64), "bfloat16"), ((1, 1000, 32, 64, 128, 1, 50), "float32"))


def sv_setup(key: str, dev):
    """The cell's config (cut, in its dtype), its prompt (seed 5) and the
    number of ids to generate."""
    import dataclasses

    from repro_torch.configs import base as cb

    name, layers, batch, prompt, new, dtype = SV_CELLS[key]
    cfg = cb.get(name)
    pattern = cfg.stacks[0][0]
    cfg = dataclasses.replace(cfg, name=f"{name}-{layers}l", dtype=dtype,
                              stacks=((pattern, layers // len(pattern)),))
    tokens = torch.randint(0, cfg.vocab, (batch, prompt),
                           generator=torch.Generator().manual_seed(5))
    return cfg, tokens.to(dev), new


def sv_model(cfg, dev):
    """The cell's weights (seed 0 on the card), whole, or this process's
    blocks where rules are installed."""
    from repro_torch.models import Model

    return Model(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                 dtype=getattr(torch, cfg.dtype), device=dev)


def sv_timed(eng, prompt, n_new: int, meter=None, logits=None, caches=None) -> dict:
    """``eng.generate(prompt, n_new)`` by the host clock, synchronised: the
    whole call and its prefill (``transformer.prefill`` wrapped for the
    call), the collectives of each (``meter``), and the local shape of every
    cache leaf after prefill (into ``caches``)."""
    from repro_torch.models import transformer as tf

    marks, orig = {}, tf.prefill

    def prefill(*args, **kw):
        out = orig(*args, **kw)
        torch.cuda.synchronize()
        marks["t"] = time.perf_counter()
        if meter is not None:
            marks["comm"] = meter.take()
        if caches is not None:
            caches.extend({n: list(t.shape) for n, t in c["mixer"].items()} for c in out[1])
        return out

    tf.prefill = prefill
    try:
        t0 = time.perf_counter()
        ids = eng.generate(prompt, n_new, logits=logits)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        tf.prefill = orig
    out = {"ids": ids, "ms": (t1 - t0) * 1e3, "prefill_ms": (marks["t"] - t0) * 1e3}
    if meter is not None:
        out.update(comm_prefill=marks["comm"], comm_decode=meter.take())
    return out


def sv_cell(key: str, out: str) -> dict:
    """One process of the group: the cell ``key`` served over dp 2 x tp 2.
    The model is built under rules (its blocks), ``Engine(..., mesh=)``
    gathers its weights once; then the main path, counted (K6/K7 launches
    zeroed just before, read just after) and metered, with every step's
    logits kept (this process's block: the first token's in bf16, every
    step's in f32, written to ``out``); then ``generate(prompt, 1)``
    SV_TTFT_RUNS times and ``generate(prompt, n)`` SV_DECODE_RUNS times by
    the host clock, each after a barrier."""
    from repro_torch._device import resolve_device
    from repro_torch.core import comm
    from repro_torch.distributed.sharding import axis_rules, default_rules
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serve import Engine

    dev = resolve_device(None)
    cfg, prompt, n_new = sv_setup(key, dev)
    mesh = Mesh(SV_MESH, ("data", "model"))   # collective: the same meshes on every process
    t0 = time.perf_counter()
    with axis_rules(default_rules(mesh)):
        model = sv_model(cfg, dev)
    eng = Engine(cfg, model, mesh=mesh, cache_len=prompt.shape[1] + n_new, device=dev)
    del model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    build_s = time.perf_counter() - t0
    comm.barrier()
    torch.cuda.reset_peak_memory_stats()
    logits, caches = [], []
    start = sh_zero()
    with CommMeter() as meter:
        meter.take()
        main = sv_timed(eng, prompt, n_new, meter, logits, caches)
    torch.cuda.synchronize()
    launches = sh_launches(start)
    peak = torch.cuda.max_memory_allocated() / 1e9
    kept = logits[:1] if cfg.dtype == "bfloat16" else logits
    torch.save({"ids": main["ids"].cpu(), "logits": [t.float().cpu() for t in kept]},
               f"{out}/{key}_rank{comm.rank()}.pt")
    ttft, full = [], []
    for n, runs in ((1, ttft), (n_new, full)):
        for _ in range(SV_TTFT_RUNS if n == 1 else SV_DECODE_RUNS):
            comm.barrier()
            runs.append(sv_timed(eng, prompt, n)["ms"])
    del eng
    torch.cuda.empty_cache()
    return {"launches": launches, "peak_gb": peak, "build_s": build_s, "caches": caches,
            "comm_prefill": main["comm_prefill"], "comm_decode": main["comm_decode"],
            "main_ms": main["ms"], "ttft_ms": ttft, "generate_ms": full, "n_new": n_new}


SV_CHECKS = {f"sv_{key}": (lambda key=key, out=None: sv_cell(key, out)) for key in SV_CELLS}


def sv_kernel_checks(card: str, kswa, kssd, dev) -> dict:
    """K6 and K7 at the cells' local shapes against their plain versions
    (K6: normwise, and the relative Frobenius in bf16; each launch on the
    kernel its dtype picks); the first shape of each dtype timed in turns
    with the plain version (and SDPA for K6)."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd import ssd_intra_chunk_ref
    from repro_torch.kernels.swa import swa_ref

    gen = torch.Generator(device=dev).manual_seed(43)
    out = {"k6": {}, "k7": {}}
    timed = set()
    for shape, dt_name in SV_K6:
        B, H, Hkv, T, S, D, w = shape
        q, k, v = k6_inputs(shape, getattr(torch, dt_name), gen, dev)
        n0 = kswa.swa_attention_cuda.tc_launches
        got = kswa.swa_attention_cuda(q, k, v, window=w)
        torch.cuda.synchronize()
        if kswa.swa_attention_cuda.tc_launches != n0 + 1:
            fail(f"sharded_serve: K6 at {shape} {dt_name} did not run on the tensor cores")
        want = swa_ref(q, k, v, window=w)
        norm, d = normwise(got, want)
        fro = frobenius(got, want)
        if not norm <= K6_TOL[dt_name] or (dt_name == "bfloat16" and not fro <= K6_FRO_TOL):
            fail(f"sharded_serve: K6 at the local heads {shape} {dt_name}: normwise {norm}, "
                 f"Frobenius {fro} (tol {K6_TOL[dt_name]}, {K6_FRO_TOL})")
        name = ",".join(map(str, shape))
        entry = {"shape": name, "dtype": dt_name, "max_abs_err": d, "normwise": norm}
        if dt_name not in timed:
            timed.add(dt_name)
            if w < T:
                qpos = torch.arange(T, device=dev)[:, None] + (S - T)
                kpos = torch.arange(S, device=dev)[None, :]
                band = (kpos <= qpos) & (kpos > qpos - w)
                lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=band,  # noqa: E731
                                                             enable_gqa=True)
            else:
                lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,  # noqa: E731
                                                             enable_gqa=True)
            runs = {"plain": [], "kernel": [], "library": []}
            for who in ("plain", "kernel", "library", "kernel", "plain", "library"):
                fn = {"plain": lambda: swa_ref(q, k, v, window=w), "library": lib,
                      "kernel": lambda: kswa.swa_attention_cuda(q, k, v, window=w)}[who]
                runs[who].append(cuda_time_ms(fn, reps=5 if who == "plain" else 20,
                                              warm=1 if who == "plain" else 3))
            bound, bound_by, _ = k6_bound(shape, 2 if dt_name == "bfloat16" else 4)
            entry.update(ms=min(runs["kernel"]), plain_ms=min(runs["plain"]),
                         library_ms=min(runs["library"]), bound_ms=bound, bound_by=bound_by)
            say("sv_kernel_time", kernel="K6", shape="B,H,Hkv,T,S,D,window=" + name,
                dtype=dt_name, card=repr(card), ms_runs=runs["kernel"], plain_ms_runs=runs["plain"],
                sdpa_ms_runs=runs["library"], bound_ms=bound, bound_by=bound_by,
                share_of_bound=bound / min(runs["kernel"]))
        out["k6"][name] = entry
        say("sv_kernel", kernel="K6", shape="B,H,Hkv,T,S,D,window=" + name, dtype=dt_name,
            normwise=norm, frobenius=fro, max_abs=d, tol=K6_TOL[dt_name])
        del q, k, v, got, want
    for shape, dt_name in SV_K7:
        L = shape[-1]
        ins = k7_inputs(shape, getattr(torch, dt_name), gen, dev)
        ran = "wgmma" if dt_name == "bfloat16" else "3xTF32"
        b0 = kssd.ssd_intra_chunk_cuda.by_kernel[ran]
        got = kssd.ssd_intra_chunk_cuda(*ins, chunk=L)
        torch.cuda.synchronize()
        if kssd.ssd_intra_chunk_cuda.by_kernel[ran] != b0 + 1:
            fail(f"sharded_serve: K7 at {shape} {dt_name} did not run its {ran} kernel")
        want = ssd_intra_chunk_ref(*ins, chunk=L)
        errs = {n: normwise(a, b)[0] for n, a, b in zip(("y_diag", "states", "s"), got, want)}
        if any(not errs[n] <= K7_TOL[dt_name][n] for n in errs):
            fail(f"sharded_serve: K7 at the local heads {shape} {dt_name}: {errs} normwise")
        runs = {"plain": [], "kernel": []}
        for who in ("plain", "kernel", "kernel", "plain"):
            fn = (lambda: ssd_intra_chunk_ref(*ins, chunk=L)) if who == "plain" else \
                (lambda: kssd.ssd_intra_chunk_cuda(*ins, chunk=L))
            runs[who].append(cuda_time_ms(fn, reps=3 if who == "plain" else 20,
                                          warm=1 if who == "plain" else 3))
        bound, bound_by, _ = k7_bound(shape, 2 if dt_name == "bfloat16" else 4)
        name = ",".join(map(str, shape))
        out["k7"][name] = {"shape": name, "dtype": dt_name,
                           "max_abs_err": float((got[0] - want[0]).abs().max()),
                           "ms": min(runs["kernel"]), "plain_ms": min(runs["plain"]),
                           "library_ms": None, "bound_ms": bound, "bound_by": bound_by}
        say("sv_kernel", kernel="K7", shape="Ba,T,H,P,N,G,L=" + name, dtype=dt_name,
            card=repr(card), normwise=json.dumps(errs).replace(" ", ""), ms_runs=runs["kernel"],
            plain_ms_runs=runs["plain"], bound_ms=bound, bound_by=bound_by,
            share_of_bound=bound / min(runs["kernel"]))
        del ins, got, want
    torch.cuda.empty_cache()
    return out


def sv_one_process(dev) -> dict:
    """Each cell in this process (no mesh, the same weights and prompt):
    its ids, and its logits (the first token's in bf16, every step's in
    f32)."""
    from repro_torch.serve import Engine

    out = {}
    for key in SV_CELLS:
        cfg, prompt, n_new = sv_setup(key, dev)
        eng = Engine(cfg, sv_model(cfg, dev), cache_len=prompt.shape[1] + n_new, device=dev)
        logits = []
        ids = eng.generate(prompt, n_new, logits=logits)
        kept = logits[:1] if cfg.dtype == "bfloat16" else logits
        out[key] = {"ids": ids.cpu(), "logits": [t.float().cpu() for t in kept]}
        del eng, logits
        torch.cuda.empty_cache()
    return out


def sv_load(tmp: str, world: int) -> dict:
    """Each cell's files of the processes (rank order)."""
    return {key: [torch.load(f"{tmp}/{key}_rank{r}.pt") for r in range(world)]
            for key in SV_CELLS}


def sv_whole(blocks: list, batch: int) -> torch.Tensor:
    """A step's logits whole from the processes' blocks: rank r at (r // tp,
    r % tp) holds rows block r // tp (rows split over data where the batch
    divides it, else all) and vocabulary block r % tp."""
    dp, tp = SV_MESH
    split = batch % dp == 0
    rows = [torch.cat([blocks[d * tp + m] for m in range(tp)], dim=-1)
            for d in (range(dp) if split else (0,))]
    return torch.cat(rows, dim=0)


def sv_report(card: str, got: list, files: dict, one: dict, kern: dict) -> dict:
    """The cells' checks against one process and their figures: the f32
    cells' ids EQUAL and every step's logits within SV_TOL; the bf16
    cells' first-token logits within SV_TOL, their ids' agreement printed;
    K6 / K7 launches a process as predicted (a layer's kernel once a
    prefill, none in decode), all on the tensor cores; the cache blocks the
    rules give.  Returns the launches summed over the processes."""
    dp, tp = SV_MESH
    total = {"k6": 0, "k7": 0}
    for key, (name, layers, batch, prompt, new, dtype) in SV_CELLS.items():
        res = [g[f"sv_{key}"] for g in got]
        ranks = files[key]
        kernel = "k7" if name.startswith("mamba") else "k6"
        k7_tf32 = 0 if dtype == "bfloat16" else layers if kernel == "k7" else 0
        for r, x in enumerate(res):
            n = x["launches"]
            on_tc = n["k6_tensor_core"] == n["k6"] and n["k7_3xtf32"] == k7_tf32
            if n[kernel] != layers or n["k6" if kernel == "k7" else "k7"] or not on_tc:
                fail(f"sharded_serve {key}: rank {r} launched {n}, predicted {layers} "
                     f"{kernel.upper()} a prefill, all on the tensor cores")
            total[kernel] += n[kernel]
        # ids: each process's rows against one process's
        want_ids = one[key]["ids"]
        rows = batch // dp if batch % dp == 0 else batch
        agree = []
        for r, f in enumerate(ranks):
            d = r // tp if batch % dp == 0 else 0
            agree.append(float((f["ids"] == want_ids[d * rows:(d + 1) * rows]).float().mean()))
        steps = [sv_whole([f["logits"][i] for f in ranks], batch)
                 for i in range(len(ranks[0]["logits"]))]
        errs = [logit_err(a, b, sv_vocab(name)) for a, b in zip(steps, one[key]["logits"])]
        if dtype == "float32" and min(agree) < 1.0:
            fail(f"sharded_serve {key}: ids differ from one process's ({agree})")
        if not max(errs) <= SV_TOL[dtype] or len(errs) != (1 if dtype == "bfloat16" else new):
            fail(f"sharded_serve {key}: logits normwise {errs} against one process "
                 f"(tol {SV_TOL[dtype]})")
        ttft = float(np.median([max(x["ttft_ms"][i] for x in res) for i in range(SV_TTFT_RUNS)]))
        gen = min(max(x["generate_ms"][i] for x in res) for i in range(SV_DECODE_RUNS))
        caches = res[0]["caches"]
        say("sharded_serve", cell=f"{name} {layers} layers {dtype} {batch}x{prompt}+{new}",
            mesh=f"dp{dp}xtp{tp}", processes=SH_WORLD, card=repr(card),
            link="gloo staging through host on one card (measures no link)",
            ttft_ms_median=ttft, ttft_ms_by_run_max_rank=[max(x["ttft_ms"][i] for x in res)
                                                          for i in range(SV_TTFT_RUNS)],
            prompt_tokens_per_s=batch * prompt / ttft * 1e3,
            decode_ms_per_token=(gen - ttft) / (new - 1),
            generate_ms_by_run_max_rank=[max(x["generate_ms"][i] for x in res)
                                         for i in range(SV_DECODE_RUNS)],
            logits_normwise_vs_one_process=errs if dtype == "float32" else errs[0],
            tol=SV_TOL[dtype], ids_agreement_by_rank=agree,
            prefill_bytes_sent_by_rank=[x["comm_prefill"]["bytes"] for x in res],
            prefill_collectives_by_rank=[x["comm_prefill"]["calls"] for x in res],
            decode_bytes_sent_per_step_by_rank=[x["comm_decode"]["bytes"] // (new - 1)
                                                for x in res],
            decode_collectives_per_step=[x["comm_decode"]["calls"] / (new - 1) for x in res],
            decode_host_ms_in_collectives_per_step=[x["comm_decode"]["host_ms"] / (new - 1)
                                                    for x in res],
            max_memory_allocated_gb_by_rank=[x["peak_gb"] for x in res],
            engine_build_s_by_rank=[x["build_s"] for x in res],
            cache_rank0_layers_0_and_last=json.dumps([caches[0], caches[-1]]).replace(" ", ""),
            launches_per_process=json.dumps(res[0]["launches"]).replace(" ", ""))
    return {**total, **kern}


def sv_vocab(name: str) -> int:
    from repro_torch.configs import base as cb

    return cb.get(name).vocab


def sv_entries(sv, swa, ssd) -> None:
    """Add the phase's launches (summed over the processes) and the kernels'
    numbers at the local shapes to the kernels line: ``sharded_serve_local``
    the bf16 shape timed, ``sharded_serve_local_f32`` the f32 one."""
    for entry, count in ((swa, "k6"), (ssd, "k7")):
        entry["launches_sharded_serve"] = sv[count]
        entry["launches"] += sv[count]
        for item in sv["kernels"][count].values():
            if "ms" in item:
                key = "sharded_serve_local" + ("" if item["dtype"] == "bfloat16" else "_f32")
                entry[key] = {k: v for k, v in item.items() if k != "normwise"}


def sharded_serve_phase(card: str, kswa, kssd, dev) -> dict:
    """Phase sharded_serve alone (``--only sharded_serve``): the kernels at
    the local shapes and the cells in this process, then the cells in
    SH_WORLD gloo processes of their own (started first; they wait for the
    go file).  In the whole script the cells run in sharded_train's
    processes after its cells (:func:`sharded_train_phase`)."""
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sv_")
    started = {"tmp": tmp, "go": f"{tmp}/go"}
    started["group"] = dist_start(SH_WORLD, "gloo", tuple(SV_CHECKS), tmp,
                                  args={k: {"out": tmp} for k in SV_CHECKS}, go=started["go"])
    try:
        kern = sv_kernel_checks(card, kswa, kssd, dev)
        one = sv_one_process(dev)
        open(started["go"], "w").close()
        got, started["group"] = dist_wait(*started["group"]), None
        files = sv_load(tmp, SH_WORLD)
    finally:
        sh_stop(started)
    sv = sv_report(card, got, files, one, {"kernels": kern})
    say("sharded_serve", status="ok", elapsed_s=time.perf_counter() - t_phase,
        launches=json.dumps({k: sv[k] for k in ("k6", "k7")}).replace(" ", ""),
        elapsed_total_s=time.perf_counter() - T_START)
    return sv


# ---------------------------------------------------------------------------
# slice 10: the grid across processes (phase dist)
# ---------------------------------------------------------------------------

DIST_HEAT = dict(nx=256, ny=256, nz=256, dims=(2, 2, 2))                    # 8 x 256^3 f32
DIST_POISSON = dict(nx=130, ny=130, nz=130, dims=(2, 2, 2))                # 8 x 130^3 f64
DIST_TWOPHASE = dict(nx=130, ny=130, nz=130, dims=(2, 2, 2), method="mgcg")
DIST_STEPS, DIST_WARM = 100, 2
DIST_HIDE = (16, 2, 2)
DIST_GROUP_TIMEOUT_S = 180     # a missing peer is an error after this, not a hang
DIST_SPAWN_LIMIT_S = 420       # one spawn of processes, start-up included


def dist_heat_start(app):
    """The dist phase's seeded Heat3D start: a Gaussian bump on 1.7."""
    def fn(ix, iy, iz):
        x, y, z = ix.double() * app.dx, iy.double() * app.dy, iz.double() * app.dz
        return 1.7 + torch.exp(-((x - 0.5) ** 2 + (y - 0.45) ** 2 + (z - 0.55) ** 2) / 0.02)
    return app.grid.from_global_fn(fn)


def block_digests(grid, T) -> dict:
    """SHA-256 of every block's cells (halos included), by global block rank."""
    import hashlib

    a = T.detach().cpu().numpy()
    return {str(r): hashlib.sha256(np.ascontiguousarray(a[idx]).tobytes()).hexdigest()
            for r, idx in zip(grid.topo.block_ranks(), np.ndindex(*grid.local_dims))}


def dist_heat(hide, gather: bool = False) -> dict:
    """Heat3D at 8 x 256^3 from the seeded start, DIST_WARM + DIST_STEPS
    steps; the timed steps' K1 launches and ms per step, the block digests
    and (``gather``) the digest of the gathered field.  The same code runs
    in every process of a group and, without a group, in the parent."""
    import hashlib

    from repro_torch.apps import Heat3D
    from repro_torch.core import comm
    from repro_torch.kernels.stencil3d import heat_step_cuda

    app = Heat3D(**DIST_HEAT, hide=hide)
    T, Ci = dist_heat_start(app), app.grid.full(1.0 / app.c0)
    T, _ = app.run(DIST_WARM, T, Ci)
    comm.barrier()
    heat_step_cuda.launches = 0
    t0 = time.perf_counter()
    T, _ = app.run(DIST_STEPS, T, Ci)
    comm.barrier()
    ms = (time.perf_counter() - t0) * 1e3 / DIST_STEPS
    out = {"launches": heat_step_cuda.launches, "ms_per_step": ms,
           "digests": block_digests(app.grid, T), "local_dims": app.grid.local_dims}
    if gather:
        out["gather"] = hashlib.sha256(app.grid.gather(T).tobytes()).hexdigest()
    if not torch.isfinite(T).all():
        fail(f"Heat3D hide={hide}: non-finite field")
    return out


def dist_poisson() -> dict:
    """Poisson3D mgcg at 8 x 130^3 f64, its first DIST_MGCG_CUT iterations
    (of the 18 it takes to 1e-8): iterations, history, the K2-K5 launches
    of this process and ms per iteration."""
    from repro_torch.apps import Poisson3D
    from repro_torch.core import comm
    from repro_torch.kernels import solver3d as sk

    app = Poisson3D(**DIST_POISSON)
    comm.barrier()
    zero_counts(sk)
    u, info = app.solve("mgcg", tol=0.0, maxiter=DIST_MGCG_CUT)
    comm.barrier()
    return {"iterations": info.iterations, "residuals": [float(v) for v in info.residuals],
            "relres": info.relres, "launches": launch_counts(sk),
            "ms_per_iteration": info.wall_s * 1e3 / max(info.iterations, 1)}


def dist_twophase() -> dict:
    """One TwoPhase3D mgcg step at 8 x 130^3 f64: its pressure iterations and
    this process's shifted K2-K4 launches."""
    from repro_torch.apps import TwoPhase3D
    from repro_torch.kernels import solver3d as sk

    app = TwoPhase3D(**DIST_TWOPHASE)
    before = shift_counts(sk)
    t0 = time.perf_counter()
    S, infos = app.run(1)
    ms = (time.perf_counter() - t0) * 1e3
    if not torch.isfinite(S.Pe.data).all():
        fail("TwoPhase3D: non-finite pressure")
    d = shift_diff(shift_counts(sk), before)
    if any(n != shifted for n, shifted in d.values()):
        fail(f"TwoPhase3D: unshifted K2-K5 launches in the pressure solve: {d}")
    return {"iterations": [i.iterations for i in infos], "ms_per_step": ms,
            "launches": {k: n for k, (n, _) in d.items()}}


DIST_STOKES = dict(nx=8, ny=8, nz=8, dims=(2, 2, 2))            # 14^3 f64, 2x2x2 blocks
# iterations of the dist phase's velocity solves at 14^3: "face" to 1e-8 (the
# reference's 17), "stress" cut to the first 3 of its 7, and of its mgcg
# solve at 8 x 130^3, cut to the first 8 of its 18 (the group runs are
# host-bound: 17.8 s and 14 s on 8 gloo processes in run B of PR 27)
DIST_STOKES_VELOCITY = {"stress": 3, "face": 17}
DIST_MGCG_CUT = 8
DIST_SCHUR_CUT = 2   # the group runs' Schur solve stops after 2 of its 10 outer iterations
DIST_GP = dict(nx=10, ny=10, nz=10, dims=(2, 2, 2))                # 18^3 complex64
DIST_GP_STEPS = 10
DIST_F5 = 1e-10   # fields relative to their largest value (F5: partial sums in another order)


def dist_stokes_velocity(precond: str) -> dict:
    """A Stokes3D velocity solve at 14^3 f64 (tol 1e-8, or the first
    DIST_STOKES_VELOCITY iterations where that is fewer than the
    reference's): iterations, history, the gathered velocity and this
    process's face K2-K5 launches."""
    from repro_torch import fields
    from repro_torch.apps import Stokes3D
    from repro_torch.kernels import solver3d as sk

    app = Stokes3D(**DIST_STOKES)
    before = face_counts(sk)
    t0 = time.perf_counter()
    cut = precond == "stress"
    V, info = app.velocity_solve(precond=precond, tol=0.0 if cut else 1e-8,
                                 maxiter=DIST_STOKES_VELOCITY[precond] if cut else 2000)
    return {"precond": precond, "iterations": info.iterations,
            "ms": (time.perf_counter() - t0) * 1e3,
            "residuals": [float(v) for v in info.residuals],
            "fields": {k: fields.gather(V[k]).tolist() for k in ("vx", "vy", "vz")},
            "face_launches": diff(face_counts(sk), before)}


def dist_stokes_schur() -> dict:
    """A Stokes3D Schur-CG solve (compiled schedule, "stress") at 14^3, tol
    1e-6, cut to its first DIST_SCHUR_CUT outer iterations: counts, the
    divergence residual and the gathered pressure."""
    from repro_torch import fields
    from repro_torch.apps import Stokes3D

    app = Stokes3D(**DIST_STOKES)
    t0 = time.perf_counter()
    V, P, info = app.solve(tol=1e-6, method="schur", precond="stress",
                           outer_maxiter=DIST_SCHUR_CUT)
    return {"outer": info.outer_iterations, "inner": info.inner_iterations,
            "relres_div": info.relres_div, "relres_momentum": info.relres_momentum,
            "ms": (time.perf_counter() - t0) * 1e3, "P": fields.gather(P).tolist()}


def dist_gp() -> dict:
    """GrossPitaevskii3D on 18^3 complex64 blocks, DIST_GP_STEPS RK4 steps:
    digests of the gathered potential and field (bitwise across layouts)."""
    import hashlib

    from repro_torch.apps import GrossPitaevskii3D

    app = GrossPitaevskii3D(**DIST_GP)
    t0 = time.perf_counter()
    psi = app.run(DIST_GP_STEPS)
    G = app.grid.gather(psi)
    if G.shape != (18, 18, 18) or not np.isfinite(G).all():
        fail(f"GP: gathered field {G.shape}, finite {bool(np.isfinite(G).all())}")
    return {"psi": hashlib.sha256(G.tobytes()).hexdigest(),
            "V": hashlib.sha256(app.grid.gather(app._V).tobytes()).hexdigest(),
            "ms": (time.perf_counter() - t0) * 1e3}


DIST_CHECKS = {
    "heat_hide": lambda: dist_heat(DIST_HIDE),
    "heat_plain": lambda: dist_heat(None, gather=True),
    "poisson": dist_poisson,
    "twophase": dist_twophase,
    "stokes_stress": lambda: dist_stokes_velocity("stress"),
    "stokes_face": lambda: dist_stokes_velocity("face"),
    "stokes_schur_cut": dist_stokes_schur,
    "gp": dist_gp,
}


def dist_child() -> int:
    """One process of a dist spawn: joins the group the parent described in
    ``CHIP_SMOKE_DIST``, runs its checks on the kernels the parent built,
    and writes what they return as JSON."""
    import datetime
    import os

    import torch.distributed as dist

    job = json.loads(os.environ["CHIP_SMOKE_DIST"])
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build

    if not _build.library_path().exists():
        fail("the kernels' library is missing: the parent builds it before spawning")
    rank, world = job["rank"], job["world"]
    if job["backend"] == "nccl":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    dist.init_process_group(job["backend"], init_method="file://" + job["rendezvous"],
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=DIST_GROUP_TIMEOUT_S))
    torch.backends.cuda.matmul.allow_tf32 = False
    deadline = time.perf_counter() + DIST_SPAWN_LIMIT_S
    while job.get("go") and not os.path.exists(job["go"]):
        if time.perf_counter() > deadline:
            fail(f"dist: the parent did not start the group ({job['go']})")
        time.sleep(0.05)
    checks = {**DIST_CHECKS, **CP_CHECKS, **SH_CHECKS, **SV_CHECKS}
    out = {name: checks[name](**job["args"].get(name, {})) for name in job["checks"]}
    with open(os.path.join(job["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def dist_start(world: int, backend: str, checks, tmp: str, args=None, go=None):
    """Start ``checks`` in ``world`` processes of a ``backend`` group on this
    host (``args``: keyword arguments of each check by name; ``go``: a file
    the processes wait for, once in their group, before their checks);
    returns what :func:`dist_wait` takes."""
    import os

    job_dir = os.path.join(tmp, f"{backend}{world}")
    os.makedirs(job_dir)
    here = str(Path(__file__).resolve().parent)
    cmd = [sys.executable, "-c",
           f"import sys; sys.path.insert(0, {here!r}); import chip_smoke; "
           "sys.exit(chip_smoke.dist_child())"]
    procs, logs = [], []
    for r in range(world):
        job = {"rank": r, "world": world, "backend": backend, "checks": list(checks),
               "args": args or {}, "rendezvous": os.path.join(job_dir, "rendezvous"),
               "out": job_dir, "go": go}
        env = dict(os.environ, LOCAL_RANK=str(r), OMP_NUM_THREADS="1",
                   CHIP_SMOKE_DIST=json.dumps(job))
        log = open(os.path.join(job_dir, f"log{r}.txt"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs, logs, job_dir, backend


def dist_wait(procs, logs, job_dir: str, backend: str) -> list:
    """Each rank's results of a :func:`dist_start`.  Every process started is
    ended before this returns; any failure fails the script."""
    import os

    world = len(procs)
    # within the call's limit whatever happens: a hung group is killed
    deadline = time.perf_counter() + min(DIST_SPAWN_LIMIT_S, remaining_s() - 30)
    try:
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.perf_counter(), 1.0))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        for r, log in enumerate(logs):
            log.seek(0)
            print(f"--- {backend} rank {r} rc={rcs[r]} ---\n{log.read()[-3000:]}", flush=True)
        fail(f"dist: {world} {backend} processes ended with {rcs}")
    for log in logs:
        log.close()
    out = []
    for r in range(world):
        with open(os.path.join(job_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def dist_spawn(world: int, backend: str, checks, tmp: str, args=None) -> list:
    """Run ``checks`` in ``world`` processes of a ``backend`` group on this
    host (``args``: keyword arguments of each check by name); returns each
    rank's results.  Every process started is ended before this returns;
    any failure fails the script."""
    return dist_wait(*dist_start(world, backend, checks, tmp, args))


def dist_phase(card: str, during_start=None) -> dict:
    """Phase 33 (dist): the grid across processes on this host.  The
    one-process runs first, in this process (no group); then 8 gloo
    processes of one block each (Heat3D hide and plain bitwise, the
    gathered field bitwise, the first DIST_MGCG_CUT mgcg iterations' counts,
    the Stokes3D "stress" velocity solve's first DIST_STOKES_VELOCITY
    iterations within F5's tolerance, GP bitwise), NCCL
    with one process of 8 blocks (Heat3D, the Stokes3D velocity solves,
    the Schur solve cut to its first DIST_SCHUR_CUT outer iterations and GP
    bitwise against this process), 2 gloo processes of 4 blocks (Heat3D
    bitwise, a TwoPhase3D mgcg step's counts, the cut Schur solve's counts
    and pressure within F5's tolerance of this process's, GP bitwise), and
    NCCL
    across min(cards, 4)
    cards where there are several.  The three groups on this card start up
    together after the one-process runs, while this process runs
    ``during_start()`` (where given); each begins at its own go file.
    Returns K1's, K2-K5's, shifted and
    face K2-K5's launches in the group runs (summed over the processes;
    each check zeroes and reads the counts around its own run)."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    one = {name: fn() for name, fn in DIST_CHECKS.items()}
    for name, precond in (("stokes_stress", "stress"), ("stokes_face", "face")):
        if one[name]["iterations"] != DIST_STOKES_VELOCITY[precond]:   # "face": the reference's
            fail(f"dist one process: Stokes velocity {precond} took {one[name]['iterations']} "
                 f"iterations, the reference {DIST_STOKES_VELOCITY[precond]}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    say("dist", config="one process", card=repr(card),
        heat_ms_per_step_hide=one["heat_hide"]["ms_per_step"],
        heat_ms_per_step_plain=one["heat_plain"]["ms_per_step"],
        mgcg_iterations=one["poisson"]["iterations"],
        mgcg_ms_per_iteration=one["poisson"]["ms_per_iteration"],
        twophase_mgcg_iterations=one["twophase"]["iterations"],
        stokes_velocity_ms=json.dumps({one[n]["precond"]: one[n]["ms"] for n in
                                       ("stokes_stress", "stokes_face")}).replace(" ", ""),
        gp_ms=one["gp"]["ms"])

    def same_heat(name, got, where):
        for r, res in enumerate(got):
            want = {k: one[name]["digests"][k] for k in res[name]["digests"]}
            if res[name]["digests"] != want:
                fail(f"dist {where}: {name} of rank {r} differs from the one-process run")
        if sorted(k for res in got for k in res[name]["digests"]) \
                != sorted(one[name]["digests"]):
            fail(f"dist {where}: the processes do not hold every block once")
        per_step = 7 if name == "heat_hide" else 1
        for r, res in enumerate(got):
            if res[name]["launches"] != per_step * DIST_STEPS:
                fail(f"dist {where}: rank {r} launched K1 {res[name]['launches']} times in "
                     f"{DIST_STEPS} steps, expected {per_step * DIST_STEPS}")

    def same_counts(name, got, where):
        for r, res in enumerate(got):
            if res[name]["iterations"] != one[name]["iterations"]:
                fail(f"dist {where}: {name} of rank {r} took {res[name]['iterations']} "
                     f"iterations, one process {one[name]['iterations']}")
            for k in ("apply", "residual", "jacobi"):
                if res[name]["launches"][k] == 0:
                    fail(f"dist {where}: rank {r} never launched the {k} kernel")

    def close(a, b, bitwise):
        if bitwise:
            return a == b
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and float(np.abs(a - b).max()) <= DIST_F5 * float(
            np.abs(b).max())

    def same_stokes(got, where, bitwise=False):
        """Counts equal; fields within F5's tolerance of one process's
        (bitwise for a group of one process)."""
        for r, res in enumerate(got):
            for name in ("stokes_stress", "stokes_face"):
                if name not in res:
                    continue
                g, want = res[name], one[name]
                if g["iterations"] != want["iterations"]:
                    fail(f"dist {where}: Stokes {name} of rank {r} took {g['iterations']} "
                         f"iterations, one process {want['iterations']}")
                if not np.allclose(g["residuals"], want["residuals"], rtol=1e-6, atol=1e-9):
                    fail(f"dist {where}: Stokes {name} history of rank {r} differs")
                for k, w in want["fields"].items():
                    if not close(g["fields"][k], w, bitwise):
                        fail(f"dist {where}: Stokes {name} {k} of rank {r} differs from one "
                             "process")
            if "stokes_schur_cut" in res:   # the first DIST_SCHUR_CUT outer iterations
                g, want = res["stokes_schur_cut"], one["stokes_schur_cut"]
                if (g["outer"], g["inner"]) != (want["outer"], want["inner"]) \
                        or g["outer"] != DIST_SCHUR_CUT:
                    fail(f"dist {where}: cut Schur counts of rank {r} {g['outer']}/{g['inner']}, "
                         f"one process {want['outer']}/{want['inner']}")
                if not close(g["P"], want["P"], bitwise):
                    fail(f"dist {where}: cut Schur pressure of rank {r} differs from one process")
            if "gp" in res and {k: res["gp"][k] for k in ("psi", "V")} \
                    != {k: one["gp"][k] for k in ("psi", "V")}:
                fail(f"dist {where}: GP of rank {r} differs from one process (bitwise)")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    ops = ("apply", "residual", "jacobi", "cheb")
    launches = {"heat": 0, "center": dict.fromkeys(ops, 0), "shift": dict.fromkeys(ops, 0),
                "face": dict.fromkeys(ops, 0)}

    def tally(got):
        for res in got:
            launches["heat"] += sum(res[n]["launches"] for n in ("heat_hide", "heat_plain")
                                    if n in res)
            for n, kind in (("poisson", "center"), ("twophase", "shift")):
                for k, v in res.get(n, {}).get("launches", {}).items():
                    launches[kind][k] += v
            for n in ("stokes_stress", "stokes_face"):
                for k, v in res.get(n, {}).get("face_launches", {}).items():
                    launches["face"][k] += v
    go = {name: f"{tmp}/go_{name}" for name in ("g8", "n1", "g2")}
    pending = {}

    def run(name):
        open(go[name], "w").close()
        return dist_wait(*pending.pop(name))

    try:
        # the groups start up (imports, the card, the group) together, while
        # this process runs during_start; then one after the other
        pending["g8"] = dist_start(8, "gloo", ("heat_hide", "heat_plain", "poisson",
                                               "stokes_stress", "gp"), tmp, go=go["g8"])
        pending["n1"] = dist_start(1, "nccl", ("heat_hide", "stokes_stress", "stokes_face",
                                               "stokes_schur_cut", "gp"), tmp, go=go["n1"])
        pending["g2"] = dist_start(2, "gloo", ("heat_hide", "twophase", "stokes_schur_cut", "gp"),
                                   tmp, go=go["g2"])
        if during_start is not None:
            during_start()
        # ---- 8 gloo processes, one block each ------------------------------
        t0 = time.perf_counter()
        g8 = run("g8")
        same_heat("heat_hide", g8, "8 gloo")
        same_heat("heat_plain", g8, "8 gloo")
        if g8[0]["heat_plain"]["gather"] != one["heat_plain"]["gather"]:
            fail("dist 8 gloo: the gathered Heat3D field differs from the one-process run")
        same_counts("poisson", g8, "8 gloo")
        same_stokes(g8, "8 gloo")
        tally(g8)
        say("dist", config="8 gloo processes x 1 block, Heat3D 8x256^3 f32", card=repr(card),
            link="gloo staging through host on one card (measures no link)",
            hide_ms_per_step=max(r["heat_hide"]["ms_per_step"] for r in g8),
            hide_ms_per_step_one_process=one["heat_hide"]["ms_per_step"],
            plain_ms_per_step=max(r["heat_plain"]["ms_per_step"] for r in g8),
            plain_ms_per_step_one_process=one["heat_plain"]["ms_per_step"],
            k1_launches_per_process_hide=g8[0]["heat_hide"]["launches"] // DIST_STEPS,
            k1_launches_per_process_plain=g8[0]["heat_plain"]["launches"] // DIST_STEPS,
            blocks="bitwise", gathered="bitwise")
        say("dist", config="8 gloo processes x 1 block, Poisson3D mgcg 8x130^3 f64",
            card=repr(card), link="gloo staging through host on one card (measures no link)",
            iterations=g8[0]["poisson"]["iterations"],
            iterations_one_process=one["poisson"]["iterations"],
            ms_per_iteration=max(r["poisson"]["ms_per_iteration"] for r in g8),
            ms_per_iteration_one_process=one["poisson"]["ms_per_iteration"],
            k2_k5_launches_per_process=json.dumps(g8[0]["poisson"]["launches"]).replace(" ", ""),
            k2_k5_launches_one_process=json.dumps(one["poisson"]["launches"]).replace(" ", ""))
        say("dist", config="8 gloo processes x 1 block, Stokes3D 14^3 f64 and GP 18^3 c64",
            card=repr(card), link="gloo staging through host on one card (measures no link)",
            stokes_stress_iterations=g8[0]["stokes_stress"]["iterations"],
            stokes_stress_ms=max(r["stokes_stress"]["ms"] for r in g8),
            stokes_stress_ms_one_process=one["stokes_stress"]["ms"],
            stokes_fields=f"within {DIST_F5} of their largest value", gp="bitwise",
            gp_ms=max(r["gp"]["ms"] for r in g8), gp_ms_one_process=one["gp"]["ms"],
            spawn_s=time.perf_counter() - t0)
        # ---- NCCL, one process of 8 blocks --------------------------------
        t0 = time.perf_counter()
        n1 = run("n1")
        same_heat("heat_hide", n1, "1 nccl")
        same_stokes(n1, "1 nccl", bitwise=True)
        tally(n1)
        say("dist", config="1 nccl process x 8 blocks", card=repr(card), heat="bitwise",
            stokes_velocity="bitwise", gp="bitwise",
            heat_hide_ms_per_step=n1[0]["heat_hide"]["ms_per_step"],
            heat_hide_ms_per_step_one_process=one["heat_hide"]["ms_per_step"],
            stokes_schur_cut=f"{n1[0]['stokes_schur_cut']['outer']}/"
                             f"{n1[0]['stokes_schur_cut']['inner']}",
            stokes_schur_cut_ms=n1[0]["stokes_schur_cut"]["ms"],
            face_launches=json.dumps(n1[0]["stokes_face"]["face_launches"]).replace(" ", ""),
            spawn_s=time.perf_counter() - t0)
        # ---- 2 gloo processes, 4 blocks each --------------------------------
        t0 = time.perf_counter()
        g2 = run("g2")
        same_heat("heat_hide", g2, "2 gloo")
        same_counts("twophase", g2, "2 gloo")
        same_stokes(g2, "2 gloo")
        if g2[0]["heat_hide"]["local_dims"] != [1, 2, 2]:
            fail(f"dist 2 gloo: local blocks {g2[0]['heat_hide']['local_dims']}")
        tally(g2)
        say("dist", config="2 gloo processes x 4 blocks", card=repr(card),
            link="gloo staging through host on one card (measures no link)",
            heat_hide_ms_per_step=max(r["heat_hide"]["ms_per_step"] for r in g2),
            heat_hide_ms_per_step_one_process=one["heat_hide"]["ms_per_step"],
            heat="bitwise", twophase_mgcg_iterations=g2[0]["twophase"]["iterations"],
            twophase_mgcg_iterations_one_process=one["twophase"]["iterations"],
            twophase_ms_per_step=max(r["twophase"]["ms_per_step"] for r in g2),
            twophase_ms_per_step_one_process=one["twophase"]["ms_per_step"],
            k2_k5_launches_per_process=json.dumps(g2[0]["twophase"]["launches"]).replace(" ", ""),
            stokes_schur_cut=f"{g2[0]['stokes_schur_cut']['outer']}/"
                             f"{g2[0]['stokes_schur_cut']['inner']}",
            stokes_schur_cut_ms=max(r["stokes_schur_cut"]["ms"] for r in g2),
            stokes_schur_cut_ms_one_process=one["stokes_schur_cut"]["ms"], gp="bitwise",
            spawn_s=time.perf_counter() - t0)
        # ---- NCCL across cards -------------------------------------------
        cards = torch.cuda.device_count()
        if cards > 1:
            world = min(cards, 4)
            t0 = time.perf_counter()
            nn = dist_spawn(world, "nccl", ("heat_hide", "poisson"), tmp)
            same_heat("heat_hide", nn, f"{world} nccl")
            same_counts("poisson", nn, f"{world} nccl")
            tally(nn)
            say("dist", config=f"{world} nccl processes, one card each", card=repr(card),
                heat="bitwise", heat_hide_ms_per_step=max(r["heat_hide"]["ms_per_step"]
                                                          for r in nn),
                mgcg_iterations=nn[0]["poisson"]["iterations"], spawn_s=time.perf_counter() - t0)
        else:
            say("dist", config="nccl across cards", status="not run",
                reason=f"this host has {cards} card; the phase needs 2 or more")
    finally:
        for procs, *_ in pending.values():   # a check here failed: end the waiting groups
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    say("dist", status="ok", elapsed_s=time.perf_counter() - t_phase,
        k1_launches=launches["heat"],
        k2_k5_launches=json.dumps(launches["center"]).replace(" ", ""),
        k2_k5_shifted_launches=json.dumps(launches["shift"]).replace(" ", ""),
        k2_k5_face_launches=json.dumps(launches["face"]).replace(" ", ""))
    return launches


ANALYSIS_POISSON = dict(nx=130, ny=130, nz=130, dims=(2, 2, 2))    # 8 x 130^3 f64
CELL_LAUNCHES: set = set()   # (kernel, nb, nx, ny, nz) of every K1-K5 launch of this process
SWA_LAUNCHES: set = set()    # (dtype code, B, H, T, D) of every K6 launch of this process
SSD_LAUNCHES: set = set()    # (dtype code, Ba, T, H, G, N, P, L) of every K7 launch
SWA_BWD_LAUNCHES: set = set()   # (B, H, Hkv, T, S, D) of every launch of K6's backward
SSD_BWD_LAUNCHES: set = set()   # (Ba, T, H, G, N, P, L) of every launch of K7's backward


def record_launch_shapes() -> None:
    """Record the shape of every K1-K7 launch of this process: K1-K5's
    wrappers make their launch plan with ``cell_plan`` and K6's and K7's
    reach their C entry point through ``_entry``, each looked up at every
    call."""
    from repro_torch.kernels import plans
    from repro_torch.kernels.solver3d import kernel as sk3
    from repro_torch.kernels.ssd import kernel as kssd
    from repro_torch.kernels.stencil3d import kernel as hk
    from repro_torch.kernels.swa import kernel as kswa

    def recording(kernel, nb, nx, ny, nz):
        CELL_LAUNCHES.add((kernel, nb, nx, ny, nz))
        return plans.cell_plan(kernel, nb, nx, ny, nz)

    sk3.cell_plan = hk.cell_plan = recording

    def record_entry(module, shapes: set, shape, attr: str = "_entry"):
        entry = getattr(module, attr)

        def recorded():
            fn = entry()

            def launch(*args):
                err = fn(*args)
                if err == 0:
                    shapes.add(shape(args))
                return err
            return launch
        setattr(module, attr, recorded)

    # the C entry points' arguments: K6 (code, q, k, v, o, B, H, Hkv, T, S, D, ...),
    # K7 (code, x, B, C, dt, s, y, states, Ba, T, H, G, N, P, L, ...), K6's
    # backward (q, k, v, o, dO, lse, drow, dq, dk, dv, B, H, Hkv, T, S, D, ...),
    # K7's backward (x, B, C, dt, s, dY, dS, dx, ddt, ds, dB, dC, Ba, T, H, G,
    # N, P, L, ...)
    record_entry(kswa, SWA_LAUNCHES, lambda a: (a[0], a[5], a[6], a[8], a[10]))
    record_entry(kssd, SSD_LAUNCHES, lambda a: (a[0], *a[8:15]))
    record_entry(kswa, SWA_BWD_LAUNCHES, lambda a: tuple(a[10:16]), attr="_bwd_entry")
    record_entry(kssd, SSD_BWD_LAUNCHES, lambda a: tuple(a[12:19]), attr="_bwd_entry")


def kernel_counters() -> dict:
    """Every launch counter of every kernel wrapper."""
    from repro_torch.kernels.solver3d import kernel as sk3
    from repro_torch.kernels.ssd import kernel as kssd
    from repro_torch.kernels.stencil3d import kernel as hk
    from repro_torch.kernels.swa import kernel as kswa

    out = {w.__name__: w.launches for w in sk3.WRAPPERS}
    out.update({f"{w.__name__}.shifted": w.shifted_launches for w in sk3.WRAPPERS[:4]})
    out["heat_step_cuda"] = hk.heat_step_cuda.launches
    for w in (kswa.swa_attention_cuda, kssd.ssd_intra_chunk_cuda):
        out[w.__name__] = w.launches
    out["swa_attention_cuda.tc"] = kswa.swa_attention_cuda.tc_launches
    out.update({f"ssd_intra_chunk_cuda.{k}": n
                for k, n in kssd.ssd_intra_chunk_cuda.by_kernel.items()})
    out["swa_backward_cuda"] = kswa.swa_backward_cuda.launches
    out["ssd_backward_cuda"] = kssd.ssd_backward_cuda.launches
    return out


def analysis_phase(card: str) -> dict:
    """Phase 34 (analysis): the port's analyzer on the card.  A Poisson3D
    mgcg solve at 8 x 130^3 f64 before and after a capture of the same
    solve: the same iterate (SHA-256), iterations and K2-K5 launches.  The
    sweep's 21 one-process targets with the apps on the card (every kernel
    route "cuda": launch plans recorded, nothing launched): every target
    clean and every launch counter unchanged.  Then the launch plans of K1-K7 and
    K6's and K7's backwards at every shape this process launched: each
    covers its output once, and K6's, K7's and their backwards' equal their
    C entry points' own.  Returns the phase's numbers."""
    import hashlib

    from repro_torch.analysis import driver, launchgrid
    from repro_torch.apps import Poisson3D
    from repro_torch.kernels import plans
    from repro_torch.kernels.ssd import kernel as kssd
    from repro_torch.kernels.swa import kernel as kswa

    t_phase = time.perf_counter()
    app = Poisson3D(**ANALYSIS_POISSON)

    def solve():
        c0 = kernel_counters()
        u, info = app.solve("mgcg", tol=1e-8)
        torch.cuda.synchronize()
        moved = {k: v for k, v in diff(kernel_counters(), c0).items() if v}
        return hashlib.sha256(u.cpu().numpy().tobytes()).hexdigest(), info.iterations, moved

    before = solve()
    c0 = kernel_counters()
    t0 = time.perf_counter()
    rep = driver.capture_check(lambda: app.solve("mgcg", tol=1e-8))
    capture_s = time.perf_counter() - t0
    # the four group/ targets (2 gloo processes each, ~40 s of start-up) run
    # in the CPU tests (tests/test_torch_analysis_group.py), not here
    t0 = time.perf_counter()
    reports = {n: driver.run_target(n, device="cuda") for n in driver.targets()
               if not n.startswith("group/")}
    sweep_s = time.perf_counter() - t0
    if kernel_counters() != c0:
        fail(f"analysis: a check moved a launch counter: {diff(kernel_counters(), c0)}")
    bad = {n: [str(f) for f in r] for n, r in reports.items() if r}
    if rep or bad:
        fail(f"analysis: findings on the card: mgcg capture {[str(f) for f in rep]}, sweep {bad}")
    after = solve()
    if after != before:
        fail(f"analysis: the mgcg solve after a check differs: {before[1:]} vs {after[1:]}")
    # launch plans at every shape this process launched
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_plans = 0
    for kernel, *shape in sorted(CELL_LAUNCHES):
        f = launchgrid.check_plan(plans.cell_plan(kernel, *shape))
        n_plans += 1
        if f:
            fail(f"analysis: {kernel} plan at {shape}: {[str(x) for x in f]}")
    codes = {v: k for k, v in kswa.DTYPE_CODES.items()}
    for code, B, H, T, D in sorted(SWA_LAUNCHES):
        py = plans.swa_plan(code == 1, B, H, T, D, sms)
        c = kswa.c_plan(codes[code], B, H, T, D)
        if (py.grid[0], py.grid[1], py.block[0], py.tile[2]) != c or launchgrid.check_plan(py):
            fail(f"analysis: K6 plan at {(code, B, H, T, D)}: python "
                 f"{py.grid, py.block, py.tile}, C {c}")
        n_plans += 1
    for shape in sorted(SWA_BWD_LAUNCHES):
        py = plans.swa_bwd_plans(*shape)
        c = kswa.bwd_c_plan(*shape)
        if (tuple((p.grid[0], p.grid[1], p.block[0], p.tile[2]) for p in py) != c
                or any(launchgrid.check_plan(p) for p in py)):
            fail(f"analysis: K6 backward plans at {shape}: python "
                 f"{[(p.grid, p.block, p.tile) for p in py]}, C {c}")
        n_plans += len(py)
    codes = {v: k for k, v in kssd.DTYPE_CODES.items()}
    for code, Ba, T, H, G, N, P, L in sorted(SSD_LAUNCHES):
        tc = kssd.kernel_for(codes[code], N, P) == kssd.KERNELS[1]
        py = plans.ssd_plan(tc, Ba, T, H, G, L, sms)
        c = kssd.c_plan(codes[code], Ba, T, H, G, N, P, L)
        if (*py.grid, py.block[0], py.tile[2]) != c or launchgrid.check_plan(py):
            fail(f"analysis: K7 plan at {(code, Ba, T, H, G, N, P, L)}: python "
                 f"{py.grid, py.block, py.tile}, C {c}")
        n_plans += 1
    for Ba, T, H, G, N, P, L in sorted(SSD_BWD_LAUNCHES):
        py = plans.ssd_bwd_plan(Ba, T, H, G, L, sms)
        c = kssd.bwd_c_plan(Ba, T, H, G, N, P, L)
        if (*py.grid, py.block[0], py.tile[2]) != c[:5] or launchgrid.check_plan(py):
            fail(f"analysis: K7 backward plan at {(Ba, T, H, G, N, P, L)}: python "
                 f"{py.grid, py.block, py.tile}, C {c}")
        n_plans += 1
    library = len(plans.library_plans(sms))
    out = {"targets": len(reports), "sweep_s": sweep_s, "capture_s": capture_s,
           "plans": n_plans}
    say("analysis", card=repr(card), targets=len(reports), findings=0, sweep_s=sweep_s,
        group_targets="in the CPU tests", mgcg_capture_s=capture_s,
        mgcg_before_after="bitwise", mgcg_iterations=before[1],
        mgcg_launches=json.dumps(before[2]).replace(" ", ""), launch_counters="unchanged",
        launched_plans_checked=n_plans, library_plans=library,
        elapsed_s=time.perf_counter() - t_phase, status="ok")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.apps import Heat3D
    from repro_torch.kernels import _build
    from repro_torch.kernels.stencil3d import heat_step_cuda, heat_step_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record_launch_shapes()
    dev = torch.device("cuda", 0)
    card = gpu_line()
    print(card, flush=True)

    # ---- 1. toolchain ---------------------------------------------------
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    say("toolchain", card=repr(card), torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=repr(nvcc), python=sys.version.split()[0])

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log = _build.log_path().read_text()
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    say("build", seconds=f"{time.perf_counter() - t0:.2f}", library=lib.name,
        ptxas=repr("; ".join(regs)))
    say("kernel_resources", **{k.replace("<", "[").replace(">", "]").replace(",", "_"):
                               json.dumps(v).replace(" ", "")
                               for k, v in sorted(kernel_resources(lib, log).items())})
    if sys.argv[1:] in (["--only", "sharded_train"], ["--only", "sharded_serve"]):
        # the phase alone, for its own checks (sharded_train runs the serving cells too)
        from repro_torch.kernels.ssd import kernel as kssd
        from repro_torch.kernels.swa import kernel as kswa

        if sys.argv[2] == "sharded_serve":
            print(json.dumps({"sharded_serve": sharded_serve_phase(card, kswa, kssd, dev)}))
        else:
            print(json.dumps({"sharded_train": sharded_train_phase(card, kswa, kssd, dev)}))
        return 0

    # ---- 3. kernels against their plain versions --------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(shape, dtype):
        return torch.rand(shape, generator=gen, device=dev, dtype=torch.float64).to(dtype)

    errs = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        for shape in ((1, 8, 8, 8), (8, 34, 18, 66)):
            errs[(str(dtype), shape)] = check_kernel(
                heat_step_cuda, heat_step_ref, rand(shape, dtype), rand(shape, dtype),
                TOL[dtype], f"{dtype} {shape}")
        F, C = rand((2, 2, 2, 40, 36, 34), dtype), rand((2, 2, 2, 40, 36, 34), dtype)
        errs[(str(dtype), "slab")] = check_kernel(
            heat_step_cuda, heat_step_ref, F[:, :, :, 3:24, :, 5:30], C[:, :, :, 3:24, :, 5:30],
            TOL[dtype], f"{dtype} strided slab")
    # the main path's own shapes: whole fields, hide's shell slabs and interior
    main_err = 0.0
    big = rand((8, 256, 256, 256), torch.float32), rand((8, 256, 256, 256), torch.float32)
    for name, sl in (("8x256^3", np.s_[...]), ("x-shell", np.s_[:, 0:18]),
                     ("y-shell", np.s_[:, :, 252:256]), ("interior", np.s_[:, 16:240, 2:254, 2:254])):
        e = check_kernel(heat_step_cuda, heat_step_ref, big[0][sl], big[1][sl], 1e-6, name)
        main_err = max(main_err, e)
    del big
    one = rand((1, 512, 512, 512), torch.float32), rand((1, 512, 512, 512), torch.float32)
    main_err = max(main_err, check_kernel(heat_step_cuda, heat_step_ref, *one, 1e-6, "512^3"))
    say("kernels", heat_step=json.dumps({f"{k[0][6:]}:{k[1]}".replace(" ", ""): v
                                          for k, v in errs.items()}).replace(" ", ""),
        main_path_max_abs_err=main_err, status="ok")

    # ---- 4. the path at small size: oracle and hide on/off bitwise --------
    def gaussian(grid, app):
        def fn(ix, iy, iz):
            x, y, z = ix.double() * app.dx, iy.double() * app.dy, iz.double() * app.dz
            return 1.7 + torch.exp(-((x - 0.5) ** 2 + (y - 0.45) ** 2 + (z - 0.55) ** 2) / 0.02)
        return grid.from_global_fn(fn)

    nt = 20
    runs = {}
    for hide in ((16, 2, 2), None):
        app = Heat3D(nx=64, ny=64, nz=64, dims=(2, 2, 2), hide=hide)
        T0, Ci = gaussian(app.grid, app), app.grid.full(1.0 / app.c0)
        heat_step_cuda.launches = 0
        T, _ = app.run(nt, T0, Ci)
        per_step = heat_step_cuda.launches / nt
        if per_step != (7 if hide else 1):
            fail(f"hide={hide}: {per_step} kernel launches per step, expected {7 if hide else 1}")
        runs[hide] = (app, T0, Ci, T, per_step)
    app, T0, Ci, T_hide, _ = runs[(16, 2, 2)]
    T_plain = runs[None][3]
    if not torch.equal(T_hide, T_plain):
        fail("hide_communication result differs from update_halo(step) bitwise")
    G = app.oracle(nt, app.grid.gather(T0), app.grid.gather(Ci))
    got = app.grid.gather(T_hide)
    oracle_err = float(np.abs(got - G).max())
    if got.shape != G.shape or not np.isfinite(got).all() or oracle_err > 1e-5:
        fail(f"Heat3D differs from the f64 NumPy oracle: max |err| {oracle_err}")
    if float(np.abs(G - app.grid.gather(T0)).max()) < 1e-3:
        fail("the start field did not evolve; the oracle check would be empty")
    say("path", app="Heat3D", dims=(2, 2, 2), local="64^3", steps=nt,
        oracle_max_abs_err=oracle_err, hide_vs_plain="bitwise",
        launches_per_step_hide=runs[(16, 2, 2)][4], launches_per_step_plain=runs[None][4])

    # ---- 5. full size: the main path, timed -------------------------------
    configs = (("1x512^3", dict(nx=512, ny=512, nz=512, dims=(1, 1, 1), hide=None)),
               ("8x256^3 hide", dict(nx=256, ny=256, nz=256, dims=(2, 2, 2), hide=(16, 2, 2))),
               ("8x256^3 plain", dict(nx=256, ny=256, nz=256, dims=(2, 2, 2), hide=None)))
    steps, warm = 100, 5
    step_ms = {}
    heat_step_cuda.launches = 0
    for name, cfg in configs:
        app = Heat3D(**cfg)
        T, Ci = gaussian(app.grid, app), app.grid.full(1.0 / app.c0)
        T, _ = app.run(warm, T, Ci)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        T, _ = app.run(steps, T, Ci)
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1) / steps
        if not torch.isfinite(T).all():
            fail(f"{name}: non-finite field")
        n = math.prod(app.grid.shape)
        bound, _ = heat_bound(n, interior_cells(app.grid.shape), 4)
        step_ms[name] = ms
        say("full", config=name, ms_per_step=ms, t_eff_GBps=app.t_eff(ms / 1e3),
            k1_bound_ms=bound, share_of_bound=bound / ms)
        del app, T, Ci
    launches = heat_step_cuda.launches
    if launches != (warm + steps) * (1 + 7 + 1):
        fail(f"main path launched the heat-step kernel {launches} times")
    say("hide", on_ms=step_ms["8x256^3 hide"], off_ms=step_ms["8x256^3 plain"],
        on_over_off=step_ms["8x256^3 hide"] / step_ms["8x256^3 plain"])
    for name, cfg in configs[1:]:
        app = Heat3D(**cfg)
        T, Ci = app.init_fields()
        app.run(2, T, Ci)
        say("breakdown", config=name, **breakdown(lambda: app.run(10, T, Ci), 10))
        del app

    # ---- 6. the kernel alone at the main path's shapes, in turns ----------
    T, Ci = one
    big = rand((8, 256, 256, 256), torch.float32), rand((8, 256, 256, 256), torch.float32)
    times = {"512^3": [], "8x256^3": []}
    for name in ("512^3", "8x256^3", "8x256^3", "512^3"):
        a, b = one if name == "512^3" else big
        times[name].append(cuda_time_ms(lambda: heat_step_cuda(a, b, *COEFS), reps=50))
    plain_ms = cuda_time_ms(lambda: heat_step_ref(T, Ci, *COEFS), reps=10)
    ms = min(times["512^3"])
    bound, bound_by = heat_bound(T.numel(), interior_cells(T.shape), 4)
    say("k1", shape=tuple(T.shape), dtype="float32", ms_runs=times["512^3"],
        ms_runs_8x256=times["8x256^3"], plain_ms=plain_ms, bound_ms=bound,
        share_of_bound=bound / ms, achieved_GBps=3 * T.numel() * 4 / ms / 1e6)

    k1 = {"name": "heat_step", "route": "cuda",
          "source": "src/repro_torch/kernels/stencil3d/csrc/heat_step.cu",
          "replaces": "src/repro/kernels/stencil3d/kernel.py:63",
          "launches": launches, "max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
    del one, big, T, Ci, a, b
    torch.cuda.empty_cache()

    solver_entries = solver_phases(dev, rand)
    face_entries = stokes_phases(rand)
    ssd_entries = serving_phases(dev)
    swa_entries = gemma3_phases(dev)
    torch.cuda.empty_cache()
    shift_entries = twophase_phases(rand)
    torch.cuda.empty_cache()
    from repro_torch.kernels import solver3d as sk
    center, heat = slice9_phases(sk)
    # the launches of the checkpoint and telemetry phases' own paths join
    # the center K2-K5 entries; those of the Heat3D session run join K1's
    k1["launches"] += heat
    k1["launches_slice9"] = heat
    for e in solver_entries:
        e["launches"] += center[e["name"]]
        e["launches_slice9"] = center[e["name"]]
    # the example twins and the MoE serving paths: K6's launches of the three
    # models' generate calls join its entry, K7's of jamba's join K7's (the
    # kernels' numbers at these models' shapes stand in their "widths")
    torch.cuda.empty_cache()
    moe = moe_phases(dev)
    swa, ssd = swa_entries[0], ssd_entries[0]
    swa["launches_moe"] = {m: moe[m]["k6"] for m in ("granite", "jamba", "kimi")}
    swa["launches"] += sum(swa["launches_moe"].values())
    ssd["launches_moe"] = {"jamba": moe["jamba"]["k7"]}
    ssd["launches"] += moe["jamba"]["k7"]
    # training (slices 13 and 15): K6's float32 forward launches of
    # llama3.2-1b's steps and the restart check join its entry, K7's of
    # mamba2-1.3b's steps and jamba's SMOKE step join K7's; each backward
    # has its own
    torch.cuda.empty_cache()
    train = train_phases(dev)
    swa["launches_train"] = train["k6_forward"]
    swa["launches"] += train["k6_forward"]
    ssd["launches_train"] = train["k7_forward"]
    ssd["launches"] += train["k7_forward"]
    # context parallelism and GPipe (slice 17): K6's launches in gemma3-4b's
    # sharded forward and in the GPipe stages, K7's in mamba2-1.3b's, summed
    # over the processes, join their entries
    from repro_torch.kernels.ssd import kernel as kssd
    from repro_torch.kernels.swa import kernel as kswa

    torch.cuda.empty_cache()
    # the sharded_train phase's processes start up (imports, their group, a
    # warm-up on the CPU) beside the context_parallel phase's, then wait
    started = {}
    try:
        cp = context_parallel_phase(card, kswa, kssd, dev,
                                    before_spawn=lambda: started.update(sh_start()))
        torch.cuda.empty_cache()
        sh = sharded_train_phase(card, kswa, kssd, dev, started)
    finally:
        if started:
            sh_stop(started)
    swa["launches_context_parallel"] = cp["k6"]
    swa["launches_gpipe"] = cp["k6_gpipe"]
    swa["launches"] += cp["k6"] + cp["k6_gpipe"]
    swa["context_parallel_halo"] = {"shape": "B,H,Hkv,T,S,D,W=" + ",".join(map(str, CP_K6[0])),
                                    "dtype": "float32", "max_abs_err": cp["k6_max_abs"],
                                    **cp["k6_halo"]}
    ssd["launches_context_parallel"] = cp["k7"]
    ssd["launches"] += cp["k7"]
    ssd["max_abs_err_context_parallel"] = cp["k7_max_abs"]
    # sharded training (slice 18): K6's and K7's launches (forward and
    # backward) in the processes of the mesh and in the one-process runs
    # beside them join their entries, with each kernel at the local shapes
    sh_entries(sh, swa, ssd, *train["entries"])
    # serving under sharding rules (slice 20): K6's launches in gemma3-4b's
    # prefills, K7's in mamba2-1.3b's, summed over the processes, with each
    # kernel at the local shapes
    sv_entries(sh["sv"], swa, ssd)
    # the processes of the dist phase: Heat3D's K1, Poisson's K2-K5 and the
    # two-phase step's shifted K2-K5, summed over the processes.  The
    # analyzer's phase runs while its groups start up, after every launch of
    # this process (its launch plans cover them all); its mgcg solves'
    # launches are checked equal around a capture, not added to the counts
    dist = dist_phase(card, during_start=lambda: analysis_phase(card))
    k1["launches"] += dist["heat"]
    k1["launches_dist"] = dist["heat"]
    for e in solver_entries:
        e["launches"] += dist["center"][e["name"]]
        e["launches_dist"] = dist["center"][e["name"]]
    for e in shift_entries:
        op = e["name"][:-len("_shift")]
        e["launches"] += dist["shift"][op]
        e["launches_dist"] = dist["shift"][op]
    for e in face_entries:
        op = e["name"][:-len("_face")]
        e["launches"] += dist["face"][op]
        e["launches_dist"] = dist["face"][op]

    print(json.dumps({"kernels": [k1] + solver_entries + face_entries + ssd_entries
                      + swa_entries + shift_entries + train["entries"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
