"""Heat3D (paper Fig. 1) over 8 gloo processes, one block each, against the
JAX package's and against the port in one process.

From the seeded T and Ci of ``tests/test_torch_heat3d.py``, 10 steps at
``dims=(2, 2, 2)`` (and at ``dims=None``, which under 8 processes is the
same layout), local 16^3, with communication hiding on and off: the field
of every block is BITWISE the one-process port's run (the step is the same
arithmetic on every cell and the exchange only copies), and within rtol
1e-6 of the reference's, the tolerance of ``tests/test_torch_heat3d.py``.
The reference runs once in a child process with 8 fake CPU devices.
"""

from __future__ import annotations

import os
import sys
import threading

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _dist import spawn  # noqa: E402
from _mp import run  # noqa: E402
from repro_torch.apps import Heat3D  # noqa: E402
from test_torch_heat3d import HIDES, NT, REFERENCE, _fields  # noqa: E402

RUNS = {"hide": ((2, 2, 2), HIDES["hide"]), "plain": ((2, 2, 2), HIDES["plain"]),
        "hide_default_dims": (None, HIDES["hide"])}


def heat_runs(rank: int, world: int, Tg, Cg) -> dict:
    """What each process runs: every case of ``RUNS``, gathered."""
    out = {}
    for name, (dims, hide) in RUNS.items():
        app = Heat3D(nx=16, ny=16, nz=16, dims=dims, hide=hide, device="cpu")
        g = app.grid
        T0, Ci = g.scatter(Tg), g.scatter(Cg)
        T, _ = app.run(NT, T0, Ci)
        out[name] = dict(dims=g.dims, local_dims=g.local_dims, shape=tuple(T.shape),
                         stacked=g.to_stacked(T), gather=g.gather(T))
        if name == "plain":   # the oracle on gathered arrays, and from its default start
            out[name]["oracle"] = app.oracle(NT, g.gather(T0), g.gather(Ci))
            out[name]["oracle_default"] = app.oracle(NT)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_heat")
    Tg, Cg = _fields()
    np.save(tmp / "T.npy", Tg)
    np.save(tmp / "Ci.npy", Cg)
    ref_err = []

    def reference():
        try:
            run(REFERENCE.format(tmp=str(tmp), hides=HIDES, nt=NT), ndev=8)
        except BaseException as e:   # re-raised in the test thread
            ref_err.append(e)

    t = threading.Thread(target=reference)
    t.start()
    per_rank = spawn(8, "test_torch_dist_heat:heat_runs", tmp, Tg, Cg, timeout=240)
    t.join()
    if ref_err:
        raise ref_err[0]
    return tmp, per_rank


@pytest.mark.parametrize("name", list(RUNS))
def test_bitwise_the_one_process_port(runs, name):
    _, per_rank = runs
    dims, hide = RUNS[name]
    Tg, Cg = _fields()
    app = Heat3D(nx=16, ny=16, nz=16, dims=(2, 2, 2), hide=hide, device="cpu")
    g = app.grid
    T, _ = app.run(NT, g.scatter(Tg), g.scatter(Cg))
    want = g.to_stacked(T)
    for r, got in enumerate(per_rank):
        assert got[name]["dims"] == (2, 2, 2) and got[name]["local_dims"] == (1, 1, 1)
        assert got[name]["shape"] == (1, 1, 1, 16, 16, 16)
        np.testing.assert_array_equal(got[name]["stacked"], want, err_msg=f"rank {r}")
        np.testing.assert_array_equal(got[name]["gather"], g.gather(T), err_msg=f"rank {r}")


@pytest.mark.parametrize("name", list(HIDES))
def test_within_the_reference(runs, name):
    tmp, per_rank = runs
    ref = np.load(tmp / f"run_{name}.npy")
    np.testing.assert_allclose(per_rank[0][name]["stacked"], ref, rtol=1e-6)


def test_oracle_on_gathered_arrays(runs):
    tmp, per_rank = runs
    Tg, Cg = _fields()
    app = Heat3D(nx=16, ny=16, nz=16, dims=(2, 2, 2), device="cpu")
    for got in per_rank:
        got = got["plain"]
        np.testing.assert_array_equal(got["oracle"], app.oracle(NT, Tg, Cg))
        np.testing.assert_array_equal(got["oracle_default"], np.load(tmp / "oracle.npy"))
        np.testing.assert_allclose(got["gather"], got["oracle"], rtol=1e-5, atol=1e-5)
