"""TwoPhase3D over 8 gloo processes, one block each, and over 2 processes
of 4 blocks, against the JAX package's and against the port in one
process.

At the reference's 16x12x12 local, ``dims=(2, 2, 2)``, 5 steps (the cases
of ``tests/test_torch_twophase.py``):

* explicit, through ``hide_step`` and through ``update_halo``: BITWISE the
  one-process port, within 1e-11 of the reference (that file's tolerance)
  and equal to ``app.oracle(5)``, which every process runs on the
  gathered arrays;
* implicit ``mgcg`` (the Helmholtz-shifted cycle): per-step iterations
  EQUAL to the reference's [5, 5, 5, 4, 4] and the one-process port's,
  histories within rtol 1e-6 or atol a tenth of tol of both, ``Pe`` to
  1e-12 of its largest value and ``phi`` to 1e-14 (that file's
  tolerances).
"""

from __future__ import annotations

import json
import os
import sys
import threading

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _dist import spawn  # noqa: E402
from _mp import run  # noqa: E402
from repro_torch import fields  # noqa: E402
from repro_torch.apps import TwoPhase3D  # noqa: E402
from test_torch_twophase import CASES as ALL_CASES  # noqa: E402
from test_torch_twophase import ITERATIONS, REFERENCE, TOL  # noqa: E402

CASES = {name: ALL_CASES[name] for name in ("explicit", "explicit_hide", "mgcg")}


def twophase_runs(rank: int, world: int, cases: dict) -> dict:
    """What each process runs (with ``world == 1`` and no group, the
    one-process port)."""
    out = {}
    for name, (kw, nt) in cases.items():
        app = TwoPhase3D(**kw, device="cpu")
        S, infos = app.run(nt)
        out[name] = dict(iterations=[i.iterations for i in infos],
                         residuals=[i.residuals for i in infos],
                         Pe=fields.gather(S.Pe), phi=fields.gather(S.phi),
                         stacked=app.grid.to_stacked(S.Pe.data), local_dims=app.grid.local_dims)
        if not infos:
            out[name]["oracle"] = app.oracle(nt)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_twophase")
    ref = {}

    def reference():
        try:
            run(REFERENCE.format(tmp=str(tmp), cases=CASES, configs=()), ndev=8, timeout=900)
        except BaseException as e:   # re-raised in the test thread
            ref["error"] = e

    t = threading.Thread(target=reference)
    t.start()
    eight = spawn(8, "test_torch_dist_twophase:twophase_runs", tmp, CASES, timeout=300)
    two = spawn(2, "test_torch_dist_twophase:twophase_runs", tmp, CASES, timeout=300)
    t.join()
    if "error" in ref:
        raise ref["error"]
    meta = json.loads((tmp / "meta.json").read_text())
    return tmp, meta, {"8x1": eight, "2x4": two}, twophase_runs(0, 1, CASES)


@pytest.mark.parametrize("layout", ["8x1", "2x4"])
@pytest.mark.parametrize("name", ["explicit", "explicit_hide"])
def test_explicit_bitwise_the_one_process_port(runs, layout, name):
    tmp, _, spread, one = runs
    for r, got in enumerate(spread[layout]):
        got = got[name]
        assert got["local_dims"] == {"8x1": (1, 1, 1), "2x4": (1, 2, 2)}[layout]
        np.testing.assert_array_equal(got["stacked"], one[name]["stacked"], err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["Pe"], one[name]["Pe"])
        np.testing.assert_array_equal(got["phi"], one[name]["phi"])
        np.testing.assert_array_equal(got["oracle"][0], got["Pe"])
        np.testing.assert_array_equal(got["oracle"][1], got["phi"])
    np.testing.assert_allclose(spread[layout][0][name]["Pe"], np.load(tmp / f"Pe_{name}.npy"),
                               rtol=0, atol=1e-11)
    np.testing.assert_allclose(spread[layout][0][name]["phi"], np.load(tmp / f"phi_{name}.npy"),
                               rtol=0, atol=1e-11)


@pytest.mark.parametrize("layout", ["8x1", "2x4"])
def test_mgcg_counts_equal_the_reference(runs, layout):
    tmp, meta, spread, one = runs
    want = meta["mgcg"]
    for got in spread[layout]:
        got = got["mgcg"]
        assert got["iterations"] == want["iterations"] == ITERATIONS["mgcg"] \
            == one["mgcg"]["iterations"]
        for h, h_ref, h_one in zip(got["residuals"], want["residuals"], one["mgcg"]["residuals"]):
            np.testing.assert_allclose(h, h_ref, rtol=1e-6, atol=0.1 * TOL)
            np.testing.assert_allclose(h, h_one, rtol=1e-6, atol=0.1 * TOL)
        for key, tol in (("Pe", 1e-12), ("phi", 1e-14)):
            ref = np.load(tmp / f"{key}_mgcg.npy")
            assert np.abs(got[key] - ref).max() <= tol * np.abs(ref).max(), key
            assert np.abs(got[key] - one["mgcg"][key]).max() <= tol * np.abs(ref).max(), key
