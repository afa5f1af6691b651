"""The example twins ``examples/torch_*.py`` on the CPU (``--device cpu``), at
tiny sizes, against the JAX package's examples.

* Each twin passes the check its reference example makes (the heat field
  against the single-array oracle, the Stokes solves converged, the
  porosity wave rising with every implicit solve converged, the
  Gross-Pitaevskii norm drift under 10 %) and prints ``OK``.
* The figures each twin prints agree with those its reference example's
  ``main()`` prints at the same arguments (run in two child processes,
  with float64 enabled as ``examples/stokes.py`` enables it):
  iteration counts equal, every other figure within a relative tolerance
  stated per line (the printed digits, or float32 rounding).
* From a non-constant start (``--bump``; the reference example's start is
  the constant 1.7, which a heat step keeps), ``torch_quickstart.py``'s
  field, ``T[center]`` and mean agree within rtol 1e-5 with the
  reference's ``Heat3D`` run directly from the same start.
* ``torch_quickstart.py`` on 2 processes of a gloo group (started as
  ``tests/_dist.py`` starts them) gives bitwise the field of one process
  that holds the same 2 blocks.
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.append(EXAMPLES)   # after every other entry: it holds quickstart.py, stokes.py, ...

from _dist import spawn  # noqa: E402
from _mp import run  # noqa: E402

import torch_gross_pitaevskii  # noqa: E402
import torch_quickstart  # noqa: E402
import torch_stokes  # noqa: E402
import torch_twophase  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"

# twin module, the reference example's module, tiny arguments
ARGS = {
    "quickstart": (torch_quickstart, ["--nx", "16", "--nt", "20"]),
    "twophase": (torch_twophase, ["--nx", "16", "--nt", "3"]),
    "gross_pitaevskii": (torch_gross_pitaevskii, ["--nx", "12", "--nt", "10"]),
    "stokes": (torch_stokes, []),
}
# per example, the printed lines both write (by their first words) and the
# relative tolerance of their non-integer figures (integers compare equal)
LINES = {
    "quickstart": {"implicit global grid": 0.0, "after": 1e-5},
    "twophase": {"global grid": 1e-3, "implicit pressure solves": 0.0,
                 "porosity anomaly": 1e-3, "|Pe|_max": 1e-3},
    "gross_pitaevskii": {"norm:": 1e-5, "|psi|_max": 1e-3},
    # residuals are printed with 2 digits: within 1/20 of each other
    "stokes": {"global grid": 0.0, "velocity solve": 0.0, "stokes (schur-cg)": 5e-2,
               "vx valid global shape": 1e-3},
}

REFERENCE = ALIAS + """
import contextlib, importlib, io, sys
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, {examples!r})
for name, argv in {args!r}.items():
    sys.argv = [name + ".py"] + argv
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        importlib.import_module(name).main()
    open({tmp!r} + "/" + name + ".txt", "w").write(buf.getvalue())
"""
# the reference example starts from the constant 1.7, which a heat step keeps;
# its Heat3D from the twin's --bump start (1.7 plus a Gaussian), called directly
REFERENCE_BUMP = """
from repro.apps.heat3d import Heat3D
app = Heat3D(nx={nx}, ny={nx}, nz={nx}, hide=(16, 2, 2), use_kernel="ref")
def bump(ix, iy, iz):
    x, y, z = ix * app.dx, iy * app.dy, iz * app.dz
    return 1.7 + jnp.exp(-((x - 0.5) ** 2 + (y - 0.45) ** 2 + (z - 0.55) ** 2) / 0.02)
T, _ = app.run({nt}, app.grid.from_global_fn(bump), app.grid.full(1.0 / app.c0))
np.save({tmp!r} + "/quickstart_bump.npy", app.grid.gather(T))
"""

BUMP = {"nx": 16, "nt": 20}   # the quickstart's tiny arguments, from the bump start

NUMBER = re.compile(r"-?\d+(?:\.\d*)?(?:e[-+]?\d+)?")


def _figures(text: str, example: str) -> dict:
    """``{line prefix: [number tokens]}`` of the compared lines."""
    out = {}
    for line in text.splitlines():
        for prefix in LINES[example]:
            if line.startswith(prefix):
                out[prefix] = NUMBER.findall(line[len(prefix):])
    return out


def _agree(got: list, want: list, rtol: float) -> bool:
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if re.fullmatch(r"-?\d+", w):
            if int(g) != int(w):
                return False
        elif abs(float(g) - float(w)) > rtol * max(abs(float(w)), 1e-300):
            return False
    return True


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference examples' output (in a child process, run on a thread
    while the twins run here) and each twin's main() at the tiny arguments,
    --device cpu: ({name: printed text}, {name: (return value, printed
    text)})."""
    import contextlib
    import io
    import threading

    tmp = tmp_path_factory.mktemp("torch_examples")
    failed = []

    def reference_job(names):
        code = REFERENCE.format(examples=EXAMPLES, tmp=str(tmp),
                                args={name: ARGS[name][1] for name in names})
        if "quickstart" in names:
            code += REFERENCE_BUMP.format(nx=BUMP["nx"], nt=BUMP["nt"], tmp=str(tmp))
        try:
            run(code + 'print("OK")\n', ndev=1)
        except BaseException as e:  # re-raised in the test process below
            failed.append(e)

    groups = {}

    def group_job(hide):
        try:
            groups[hide] = spawn(2, "test_torch_examples:quickstart_rank",
                                 tmp_path_factory.mktemp("group"), _group_argv(hide))
        except BaseException as e:
            failed.append(e)

    # the reference's Stokes example alone takes most of the time: its own
    # child; the 2-process runs of the quickstart twin meanwhile
    jobs = [threading.Thread(target=reference_job, args=(names,))
            for names in (["stokes"], [n for n in ARGS if n != "stokes"])]
    jobs += [threading.Thread(target=group_job, args=(hide,)) for hide in (True, False)]
    for job in jobs:
        job.start()
    twins = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(2)   # leave the cores to the reference's child processes
    try:
        for name, (mod, argv) in ARGS.items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                result = mod.main(argv + ["--device", "cpu"])
            twins[name] = (result, buf.getvalue())
        with contextlib.redirect_stdout(io.StringIO()):
            bumped = torch_quickstart.main(_bump_argv())
    finally:
        torch.set_num_threads(threads)
        for job in jobs:
            job.join()
    if failed:
        raise failed[0]
    return ({name: (tmp / f"{name}.txt").read_text() for name in ARGS}, twins, groups,
            (bumped, np.load(tmp / "quickstart_bump.npy")))


@pytest.fixture(scope="module")
def twins(runs):
    return runs[1]


@pytest.fixture(scope="module")
def reference(runs):
    return runs[0]


def _bump_argv() -> list:
    return ["--nx", str(BUMP["nx"]), "--nt", str(BUMP["nt"]), "--device", "cpu", "--bump"]


def test_quickstart_oracle(runs, twins):
    result, text = twins["quickstart"]
    assert result["oracle_err"] < 1e-4 and text.rstrip().endswith("OK")
    # the bump start evolves, and still meets the oracle
    bumped = runs[3][0]
    assert bumped["oracle_err"] < 1e-4 and bumped["center"] > 1.8


def test_quickstart_bump_matches_the_reference(runs):
    """From the non-constant start, the twin's T[center], mean and field
    against the reference's Heat3D run from the same start."""
    bumped, want = runs[3]
    got = bumped["field"]
    assert got.shape == want.shape
    assert float(np.abs(want - want.flat[0]).max()) > 1e-3   # the field is not constant
    centre = want[tuple(s // 2 for s in want.shape)]
    np.testing.assert_allclose(bumped["center"], centre, rtol=1e-5)
    np.testing.assert_allclose(bumped["mean"], want.mean(), rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_stokes_solves_converge(twins):
    result, text = twins["stokes"]
    assert result["relres_div"] <= 1e-6 and text.rstrip().endswith("OK")
    assert result["vx_shape"] == (9, 10, 10) and np.isfinite(result["vx_max"])


def test_twophase_wave_rises(twins):
    result, text = twins["twophase"]
    z0, z1 = result["z"]
    assert z1 > z0 and len(result["iters"]) == 3 and text.rstrip().endswith("OK")


def test_gross_pitaevskii_norm(twins):
    result, text = twins["gross_pitaevskii"]
    n0, n1 = result["norm"]
    assert abs(n1 - n0) / n0 < 0.1 and text.rstrip().endswith("OK")


@pytest.mark.parametrize("name", list(ARGS))
def test_printed_figures_match_the_reference_example(reference, twins, name):
    got, want = _figures(twins[name][1], name), _figures(reference[name], name)
    assert set(want) == set(LINES[name]), (name, reference[name])
    assert set(got) == set(want), (name, twins[name][1])
    for prefix, rtol in LINES[name].items():
        assert _agree(got[prefix], want[prefix], rtol), (name, prefix, got[prefix], want[prefix])


QUICK_GROUP = ["--device", "cpu", "--nx", "12", "--nt", "8", "--dims", "2,1,1", "--bump"]


def _group_argv(hide: bool) -> list:
    return QUICK_GROUP + ([] if hide else ["--no-hide"])


def quickstart_rank(rank, world, argv):
    """One process of the group: the twin's gathered field."""
    return torch_quickstart.main(argv)["field"]


@pytest.mark.parametrize("hide", [True, False], ids=["hide", "no_hide"])
def test_quickstart_on_two_gloo_processes_equals_one(runs, hide):
    one = torch_quickstart.main(_group_argv(hide))["field"]
    fields = runs[2][hide]
    assert len(fields) == 2
    for f in fields:
        assert np.array_equal(f, one)
    assert float(np.abs(one - one.flat[0]).max()) > 1e-3   # the field is not constant
