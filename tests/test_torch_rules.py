"""Rules of the port: it stands alone, runs on CUDA by default, never falls
back quietly.

* no file of ``src/repro_torch/`` nor ``chip_smoke.py`` imports ``jax`` or
  the JAX package ``repro``;
* every ``repro_torch`` module imports with ``jax`` and ``repro`` blocked;
* the entry points raise without CUDA unless a device is given;
* ``use_kernel="cuda"`` on a CPU tensor raises, and no module that
  launches a kernel (the heat step, the solver ops, multigrid, the solvers
  and apps above them, the staggered fields and the Stokes app, the SSD
  scan and the Mamba-2 model and engine above it, the sliding-window
  attention and the attention layers above it) holds a ``try``.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import solvers  # noqa: E402
from repro_torch import fields  # noqa: E402
from repro_torch.apps import Heat3D, Poisson3D, Stokes3D  # noqa: E402
from repro_torch.core import init_global_grid  # noqa: E402
from repro_torch.kernels import solver3d  # noqa: E402
from repro_torch.kernels.stencil3d import heat_step, ops  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(
        ".__init__") for p in PKG.rglob("*.py"))


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {n}"


def test_every_module_imports_with_jax_blocked():
    code = ("import importlib, sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "print('imported', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert len(_modules()) >= 15


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_global_grid(8, 8, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        Heat3D()
    # an explicit CPU device is the only way to run on the CPU
    assert init_global_grid(8, 8, 8, device="cpu").device.type == "cpu"
    assert Heat3D(device="cpu").grid.device.type == "cpu"


def test_cuda_mode_on_cpu_tensor_raises():
    T = torch.zeros(6, 6, 6)
    with pytest.raises(ValueError, match="CUDA"):
        heat_step(T, T, 1.0, 0.1, 1.0, 1.0, 1.0, use_kernel="cuda")
    app = Heat3D(nx=8, ny=8, nz=8, use_kernel="cuda", device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        app.run(1)


def test_heat_step_has_no_try_around_the_launch():
    fn = next(n for n in ast.walk(ast.parse(Path(ops.__file__).read_text()))
              if isinstance(n, ast.FunctionDef) and n.name == "heat_step")
    assert not [n for n in ast.walk(fn) if isinstance(n, (ast.Try, ast.TryStar))]
    assert "heat_step_cuda" in ast.unparse(fn)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert [p.name for p in _build.sources()] == ["solver3d.cu", "ssd.cu", "ssd_bwd.cu",
                                                  "heat_step.cu", "swa.cu", "swa_bwd.cu"]
    assert _build.library_path().parent == tmp_path / "build"


def test_solver_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Poisson3D()
    app = Poisson3D(device="cpu")
    assert app.grid.device.type == "cpu" and app.c.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        Stokes3D()
    with pytest.raises(RuntimeError, match="CUDA"):
        fields.zeros(init_global_grid(8, 8, 8), "xface")
    st = Stokes3D(nx=8, ny=8, nz=8, device="cpu")
    assert st.eta.device.type == "cpu" and st.F.vz.device.type == "cpu"


@pytest.mark.parametrize("stress", ["full", "stripped"])
def test_stokes_cuda_mode_on_cpu_tensor_raises(stress):
    app = Stokes3D(nx=8, ny=8, nz=8, stress=stress, use_kernel="cuda", device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        app.velocity_solve(precond="face", maxiter=2)
    with pytest.raises(ValueError, match="CUDA"):
        solvers.multigrid_solve(app.grid, app.eta, app.F.vx, app.spacing, use_kernel="cuda",
                                maxiter=1)
    u, m = app.F.vy.data, fields.interior_mask(app.grid, "yface")
    for op in (lambda: solver3d.apply_op(u, u, spacing=app.spacing, loc="yface",
                                         use_kernel="cuda"),
               lambda: solver3d.residual_op(u, u, u, spacing=app.spacing, loc="yface", imask=m,
                                            use_kernel="cuda"),
               lambda: solver3d.jacobi_sweep(u, u, u, u, omega=0.5, spacing=app.spacing,
                                             loc="yface", imask=m, use_kernel="cuda"),
               lambda: solver3d.cheb_sweep(u, u, u, u, u, a=None, b=1.0, spacing=app.spacing,
                                           loc="yface", imask=m, use_kernel="cuda")):
        with pytest.raises(ValueError, match="CUDA"):
            op()


@pytest.mark.parametrize("method", ["cg", "pipecg", "mgcg", "pipemgcg", "pt", "mg"])
def test_solver_cuda_mode_on_cpu_tensor_raises(method):
    app = Poisson3D(use_kernel="cuda", device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        app.solve(method, maxiter=2)
    g, u = app.grid, app.b
    with pytest.raises(ValueError, match="CUDA"):
        solvers.multigrid_solve(g, app.c, u, app.spacing, use_kernel="cuda", maxiter=1)
    with pytest.raises(ValueError, match="CUDA"):
        solvers.cg(g, lambda x, c: solvers.poisson_apply(g, x, c, app.spacing, use_kernel="cuda"),
                   u, args=(app.c,), maxiter=1)
    for op in (lambda: solver3d.apply_op(u, u, spacing=app.spacing, use_kernel="cuda"),
               lambda: solver3d.residual_op(u, u, u, spacing=app.spacing, use_kernel="cuda"),
               lambda: solver3d.jacobi_sweep(u, u, u, u, omega=0.5, spacing=app.spacing,
                                             use_kernel="cuda"),
               lambda: solver3d.cheb_sweep(u, u, u, u, u, a=None, b=1.0, spacing=app.spacing,
                                           use_kernel="cuda")):
        with pytest.raises(ValueError, match="CUDA"):
            op()


@pytest.mark.parametrize("module", [
    "kernels/solver3d/ops.py", "kernels/solver3d/kernel.py", "solvers/multigrid.py",
    "solvers/cg.py", "solvers/preconditioner.py", "solvers/pseudo_transient.py",
    "solvers/transfers.py", "solvers/reductions.py", "apps/poisson.py", "apps/stokes.py",
    "fields/field.py", "fields/ops.py", "stencil/mac.py", "core/boundary.py",
    "core/locations.py"])
def test_solver_path_has_no_try_around_a_launch(module):
    tree = ast.parse((PKG / module).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, (ast.Try, ast.TryStar))]
    if module == "kernels/solver3d/ops.py":   # the one module that launches K2-K5
        src = ast.unparse(tree)
        for k in ("apply_cuda", "residual_cuda", "jacobi_cuda", "cheb_cuda", "apply_face_cuda",
                  "residual_face_cuda", "jacobi_face_cuda", "cheb_face_cuda"):
            assert f"{k}(" in src, k


def test_serving_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs.mamba2_1p3b import SMOKE
    from repro_torch.models import Model
    from repro_torch.models import params as pm
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(SMOKE, generator=g)
    with pytest.raises(RuntimeError, match="CUDA"):
        pm.materialize(tf.param_specs(SMOKE), g, torch.float32)
    model = Model(SMOKE, generator=g, dtype=torch.float32, device="cpu")
    assert model.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(SMOKE, model)
    assert Engine(SMOKE, model, device="cpu").generate(torch.zeros(1, 4, dtype=torch.long),
                                                       2).shape == (1, 2)


def test_serving_cuda_mode_on_cpu_tensor_raises():
    from repro_torch.configs.mamba2_1p3b import SMOKE
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.models import Model
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Engine

    model = Model(SMOKE, generator=torch.Generator().manual_seed(0), dtype=torch.float32,
                  device="cpu")
    tokens = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="CUDA"):
        Engine(SMOKE, model, device="cpu", use_kernel="cuda").generate(tokens, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tf.prefill(model, tokens, use_kernel="cuda")
    x = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(x, torch.ones(1, 8, 2), -torch.ones(2), torch.zeros(1, 8, 1, 4),
                 torch.zeros(1, 8, 1, 4), chunk=4, use_kernel="cuda")


@pytest.mark.parametrize("module", [
    "kernels/ssd/ops.py", "kernels/ssd/kernel.py", "kernels/ssd/ref.py", "models/ssm.py",
    "models/blocks.py", "models/transformer.py", "serve/engine.py",
    "distributed/seqpar.py"])
def test_serving_path_has_no_try_around_a_launch(module):
    tree = ast.parse((PKG / module).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, (ast.Try, ast.TryStar))]
    if module == "kernels/ssd/ops.py":   # the one place that picks K7 or its plain version
        assert "ssd_kernel(" in ast.unparse(tree)


def test_gemma3_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs.gemma3_4b import SMOKE
    from repro_torch.models import Model
    from repro_torch.serve import Engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(SMOKE, generator=g)
    model = Model(SMOKE, generator=g, dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(SMOKE, model)
    ids = Engine(SMOKE, model, device="cpu").generate(torch.zeros(1, 4, dtype=torch.long), 2)
    assert ids.shape == (1, 2) and ids.device.type == "cpu"


def test_gemma3_cuda_mode_on_cpu_tensor_raises():
    from repro_torch.configs.gemma3_4b import SMOKE
    from repro_torch.kernels.swa import sliding_window_attention, swa_attention
    from repro_torch.models import Model
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Engine

    model = Model(SMOKE, generator=torch.Generator().manual_seed(0), dtype=torch.float32,
                  device="cpu")
    tokens = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="CUDA"):
        Engine(SMOKE, model, device="cpu", use_kernel="cuda").generate(tokens, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tf.fwd(model, tokens, mode="train", use_kernel="cuda")
    q, kv = torch.zeros(1, 4, 8, 16), torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        swa_attention(q, kv, kv, window=4, use_kernel="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        sliding_window_attention(q, kv, kv, window=4, use_kernel="cuda")


@pytest.mark.parametrize("module", [
    "kernels/swa/ops.py", "kernels/swa/kernel.py", "kernels/swa/ref.py", "models/attention.py",
    "models/layers.py", "configs/gemma3_4b.py"])
def test_attention_path_has_no_try_around_a_launch(module):
    tree = ast.parse((PKG / module).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, (ast.Try, ast.TryStar))]
    src = ast.unparse(tree)
    if module == "kernels/swa/ops.py":   # the one place that picks K6 or its plain version
        assert "swa_attention_cuda(" in src
    if module == "models/attention.py":   # train and prefill go through that dispatch point
        assert "swa_attention(" in src and "scaled_dot_product_attention" not in src
