"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, drives the paper's
Fig.-1 heat solver (``repro_torch.apps.Heat3D``) through the kernel at 512^3
cells on one rank and at 8 x 256^3 on eight virtual ranks with and without
stream-overlapped communication hiding, and times it with CUDA events.

Every phase prints one line; any failure raises and exits non-zero.  The
line before the last is a JSON object describing each kernel; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA card it exits 1 and
prints no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
HEAT_FLOP_PER_CELL = 16        # interior cell of heat_step.cu, see its header
TOL = {torch.float32: 1e-6, torch.bfloat16: 2e-2, torch.float64: 1e-12}
COEFS = (1.3, 0.01, 0.7, 0.9, 1.1)   # lam, dt, dx, dy, dz of the kernel checks


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


def breakdown(app, T, Ci, steps: int = 10) -> dict:
    """Device time by kernel name and the device's idle share over a few
    steps, from the profiler's CUDA activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    app.run(2, T, Ci)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        app.run(steps, T, Ci)
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"ms_per_step_by_kernel": json.dumps({k: round(v, 4) for k, v in top}).replace(" ", ""),
            "device_busy_ms_per_step": busy / steps / 1e3,
            "idle_share": 1 - busy / wall_us}


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
    dev = torch.device("cuda", 0)
    card = gpu_line()

    # ---- 1. toolchain ---------------------------------------------------
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    say("toolchain", card=repr(card), torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=repr(nvcc), python=sys.version.split()[0])

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    regs = [ln.strip() for ln in _build.log_path().read_text().splitlines() if "registers" in ln]
    say("build", seconds=f"{time.perf_counter() - t0:.2f}", library=lib.name,
        ptxas=repr("; ".join(regs)))

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
        say("breakdown", config=name, **breakdown(app, *app.init_fields()))
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

    print(json.dumps({"kernels": [{
        "name": "heat_step", "route": "cuda",
        "source": "src/repro_torch/kernels/stencil3d/csrc/heat_step.cu",
        "replaces": "src/repro/kernels/stencil3d/kernel.py:63",
        "launches": launches, "max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
