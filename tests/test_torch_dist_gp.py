"""GrossPitaevskii3D over gloo processes against the port in one process
and against the JAX package.

An 18^3 global grid of complex64 blocks (2x2x2 blocks of 10^3), 10 RK4
steps through ``GrossPitaevskii3D.run`` in every process, on 8 processes
of one block each and on 2 processes of 4 blocks each.  GP reads no global
reduction while it steps (only halo exchanges of complex slabs, and the
potential from global indices), so everything is BITWISE: the gathered
potential, the initial and final fields and the norm equal those of the
same blocks in one process and of one 18^3 block, on every process.  The
reference's run of the same case on 8 fake devices
(``tests/test_torch_gross_pitaevskii.py``'s, in a child process beside the
spawned ones) holds the gathered fields by that file's rules: the
potential and start field within 1e-6 of their largest value, the field
after 10 steps within 1e-5.
"""

from __future__ import annotations

import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _dist import spawn  # noqa: E402
from _mp import run  # noqa: E402
from test_torch_gross_pitaevskii import REFERENCE, TOL  # noqa: E402

STEPS = 10


def gp_run(rank: int, world: int, dims) -> dict:
    """``dims=None``: one 10^3 block per process; otherwise the blocks of
    ``dims`` spread over the processes (one 18^3 block for (1, 1, 1))."""
    from repro_torch.apps import GrossPitaevskii3D
    n = 18 if dims == (1, 1, 1) else 10
    app = GrossPitaevskii3D(nx=n, ny=n, nz=n, dims=dims, device="cpu")
    g = app.grid
    psi0 = app.init_fields()
    out = {"V": g.gather(app._V), "psi0": g.gather(psi0), "shape": tuple(psi0.shape)}
    psi = app.run(STEPS, psi0)
    out["psi"] = g.gather(psi)
    out["norm"] = app.norm(psi)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's run, started here and read after the processes'."""
    tmp = str(tmp_path_factory.mktemp("dist_gp_reference"))
    with ThreadPoolExecutor(1) as ex:
        yield tmp, ex.submit(run, REFERENCE.format(tmp=tmp, nt=STEPS), ndev=8)


@pytest.fixture(scope="module")
def one():
    return {"blocks": gp_run(0, 1, (2, 2, 2)), "single": gp_run(0, 1, (1, 1, 1))}


@pytest.mark.parametrize("world,dims,shape", [(8, None, (1, 1, 1, 10, 10, 10)),
                                              (2, (2, 2, 2), (1, 2, 2, 10, 10, 10))],
                         ids=["8x1", "2x4"])
def test_gp_bitwise_across_processes(tmp_path, reference, one, world, dims, shape):
    res = spawn(world, "test_torch_dist_gp:gp_run", tmp_path, dims)
    for r, got in enumerate(res):
        assert got["shape"] == shape
        for want in (one["blocks"], one["single"]):
            for key in ("V", "psi0", "psi", "norm"):
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"rank {r} {key}")
    assert np.isfinite(res[0]["psi"]).all() and res[0]["psi"].dtype == np.complex64
    assert not np.array_equal(res[0]["psi"], res[0]["psi0"])
    # the JAX package's run of the same case on 8 devices
    tmp, out = reference
    assert json.loads(out.result().strip().splitlines()[-1])["dtype"] == "complex64"
    for key, tol in (("V", 1e-6), ("psi0", 1e-6)):
        want = np.load(f"{tmp}/{key}.npy")
        assert np.abs(res[0][key] - want).max() <= tol * np.abs(want).max(), key
    assert np.abs(res[0]["psi"] - np.load(f"{tmp}/psi.npy")).max() < TOL
