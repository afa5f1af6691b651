"""The grid across processes: ``update_halo``, ``hide_communication``, the
masks and the global reductions of the port over a ``torch.distributed``
gloo group, held against the port in one process at the same global
``dims`` (no group).

Three process layouts, each run once in a gloo group (``tests/_dist.py``):

* ``2x1``: 2 processes, one block each (``dims=(2, 1, 1)``; ``(2, 1)`` and
  ``(2,)`` on rank-2 and rank-1 grids);
* ``8x1``: 8 processes, one block each (``(2, 2, 2)``, ``(4, 2)``, ``(8,)``);
* ``2x4``: 2 processes, 4 blocks each (``(4, 2, 1)``, ``(4, 2)``, ``(8,)``).

From the same seeded field tensor of every block (random halos included),
each process takes its blocks, and the field tensor of every block is
gathered after the call.  It must be BITWISE the one-process result (the
exchange only copies values): ``update_halo`` for every periodic mix,
halo width 1 and 2, every staggering location (through
``fields.update_halo``), on rank-3, -2 and -1 grids (two processes along a
periodic dim included); ``hide_communication`` of the heat step for every
periodic mix; the ownership, interior, validity and solve masks, global
indices and rank tests.  The reductions: ``dot``/``norm_l2``/``masked_mean``
within 1e-14 relative of the one-process value (the partials of the
processes are added in another order), ``norm_linf``/``field_min``/
``field_max`` bitwise, ``gather`` bitwise and ``gather``∘``scatter`` the
identity.  The guards: a ``dims`` that cannot be split over the processes,
or a ``procs`` that does not divide it, raises; and a peer that never joins, or joins and never exchanges, fails within
the group timeout with a non-zero exit instead of hanging.
"""

from __future__ import annotations

import itertools
import os
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _dist import SpawnError, spawn  # noqa: E402
from repro_torch import fields  # noqa: E402
from repro_torch.core import init_global_grid  # noqa: E402
from repro_torch.core.topology import procs_for  # noqa: E402
from repro_torch.kernels.stencil3d import heat_step_ref  # noqa: E402
from repro_torch.solvers import reductions as red  # noqa: E402

LAYOUTS = {
    "2x1": (2, {3: (2, 1, 1), 2: (2, 1), 1: (2,)}),
    "8x1": (8, {3: (2, 2, 2), 2: (4, 2), 1: (8,)}),
    "2x4": (2, {3: (4, 2, 1), 2: (4, 2), 1: (8,)}),
}
LOCAL = {3: (7, 6, 5), 2: (7, 6), 1: (7,)}
LOCS = {3: ("center", "xface", "yface", "zface"), 2: ("center", "xface", "yface"),
        1: ("center", "xface")}


def _grid(nd, dims, per, w=1, dtype=torch.float64):
    local = list(LOCAL[nd]) + [None] * (3 - nd)
    return init_global_grid(*local, dims=dims, periodic=per, overlap=2 * w, dtype=dtype,
                            device="cpu")


def _seeded(grid, key: str) -> np.ndarray:
    """The field tensor of every block, from a seed of the case."""
    seed = sum(ord(c) * (i + 1) for i, c in enumerate(key)) % (2 ** 31)
    return np.random.RandomState(seed).rand(*grid.full_shape)


def _own(grid, full: np.ndarray) -> torch.Tensor:
    """This process's blocks of the field tensor of every block."""
    box = tuple(slice(o, o + m) for o, m in zip(grid.topo.offset, grid.local_dims))
    return torch.from_numpy(np.ascontiguousarray(full[box]))


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _pers(nd):
    return list(itertools.product((False, True), repeat=nd))


# ---------------------------------------------------------------------------
# what each process runs (also what the one-process reference runs)
# ---------------------------------------------------------------------------

def halo_cases(layout: str) -> dict:
    """``update_halo`` through ``fields.update_halo`` (and the bare form for
    centers), keyed ``nd|periodic|width|loc``: the stacked blocks after."""
    out = {}
    for nd, dims in LAYOUTS[layout][1].items():
        for per in _pers(nd):
            for w in (1, 2):
                grid = _grid(nd, dims, per, w)
                for loc in LOCS[nd]:
                    key = f"{nd}|{per}|{w}|{loc}"
                    A = _own(grid, _seeded(grid, key)).clone()
                    fields.update_halo(grid, fields.Field(grid, A, loc))
                    out[key] = grid.to_stacked(A)
                key = f"{nd}|{per}|{w}|bare"
                A = _own(grid, _seeded(grid, key)).clone()
                grid.update_halo(A)
                out[key] = grid.to_stacked(A)
    return out


def hide_cases(layout: str) -> dict:
    """``grid.hide`` of the heat step for every periodic mix (rank 3)."""
    out = {}
    dims = LAYOUTS[layout][1][3]
    for per in _pers(3):
        grid = _grid(3, dims, per, dtype=torch.float32)
        key = f"hide|{per}"
        full = _seeded(grid, key).astype(np.float32)
        T, Ci = _own(grid, full).clone(), _own(grid, full[::-1].copy()).clone()

        def step(T, Ci):
            return heat_step_ref(T, Ci, 1.3, 0.01, 0.7, 0.9, 1.1)

        out[key] = grid.to_stacked(grid.hide(step, (T, Ci), width=(2, 2, 1)))
    return out


def mask_cases(layout: str) -> dict:
    """Masks, global indices and rank tests of every block (rank 3)."""
    out = {}
    dims = LAYOUTS[layout][1][3]
    for per in _pers(3):
        grid = _grid(3, dims, per)
        k = f"{per}"
        out[f"owned|{k}"] = grid.to_stacked(red.owned_mask(grid))
        out[f"interior|{k}"] = grid.to_stacked(red.interior_mask(grid))
        out[f"solve|{k}"] = grid.to_stacked(red.solve_mask(grid))
        for loc in LOCS[3]:
            for name in ("valid_mask", "owned_mask", "interior_mask", "solve_mask"):
                m = getattr(fields, name)(grid, loc)
                out[f"{name}|{loc}|{k}"] = grid.to_stacked(m)
        for d in range(3):
            ones = grid.ones()
            out[f"first{d}|{k}"] = grid.to_stacked(ones * grid.topo.is_first(d))
            out[f"last{d}|{k}"] = grid.to_stacked(ones * grid.topo.is_last(d))
            out[f"coords{d}|{k}"] = grid.to_stacked(grid.coords(d, 0.5, 1.0))
    return out


def reduction_cases(layout: str) -> dict:
    """The global reductions, gather and gather(scatter) (rank 3)."""
    out = {}
    dims = LAYOUTS[layout][1][3]
    for per in ((False,) * 3, (True, False, True), (True,) * 3):
        grid = _grid(3, dims, per)
        k = f"{per}"
        a = _own(grid, _seeded(grid, "a" + k))
        b = _own(grid, _seeded(grid, "b" + k)) - 0.5
        m = red.solve_mask(grid)
        out[f"dot|{k}"] = red.dot(grid, a, b).item()
        out[f"dotm|{k}"] = red.dot(grid, a, b, m).item()
        out[f"l2|{k}"] = red.norm_l2(grid, b).item()
        out[f"mean|{k}"] = red.masked_mean(grid, b, m).item()
        out[f"many|{k}"] = [t.item() for t in red.tree_dot_many(grid, [(a, b), (b, b)], m)]
        out[f"linf|{k}"] = red.norm_linf(grid, b).item()
        out[f"min|{k}"] = red.field_min(grid, b).item()
        out[f"max|{k}"] = red.field_max(grid, b).item()
        out[f"gather|{k}"] = grid.gather(b)
        G = np.random.RandomState(7).rand(*grid.global_shape)
        out[f"roundtrip|{k}"] = (G, grid.gather(grid.scatter(G)))
        out[f"scatter|{k}"] = grid.to_stacked(grid.scatter(G))
    return out


def guard_cases() -> dict:
    """What a layout that does not divide raises, and the default dims."""
    out = {"default_dims": _grid(3, None, (False,) * 3).dims}
    for name, kw in (("dims", dict(dims=(3, 1, 1))), ("few", dict(dims=(1, 1, 1)))):
        try:
            init_global_grid(6, 6, 6, device="cpu", **kw)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def run_layout(rank: int, world: int, layout: str):
    res = {"halo": halo_cases(layout), "hide": hide_cases(layout), "mask": mask_cases(layout),
           "red": reduction_cases(layout)}
    if layout == "2x1":
        res["guard"] = guard_cases()
    return res


def stall(rank: int, world: int, seconds: float):
    """Rank 0 exchanges halos with rank 1, which joined the group but never
    takes part; rank 0 must fail within the group timeout."""
    if rank == 1:
        time.sleep(seconds)
        return None
    grid = _grid(3, (2, 1, 1), (False,) * 3)
    t0 = time.monotonic()
    try:
        grid.update_halo(grid.ones())
    except Exception:
        print(f"exchange failed after {time.monotonic() - t0:.1f} s", flush=True)
        raise
    return None


# ---------------------------------------------------------------------------
# the runs, once per layout
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_halo")
    out = {}
    for layout, (world, _) in LAYOUTS.items():
        per_rank = spawn(world, "test_torch_dist_halo:run_layout", tmp, layout, timeout=240)
        # every process sees the same whole grid and the same reductions
        assert all(_same(r, per_rank[0]) for r in per_rank[1:])
        out[layout] = per_rank[0]
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("nd", [3, 2, 1])
def test_update_halo_bitwise(runs, layout, nd):
    got = runs[layout]["halo"]
    want = {k: v for k, v in halo_cases(layout).items() if k.startswith(f"{nd}|")}
    assert want and all(k in got for k in want)
    for key, v in want.items():
        assert got[key].dtype == v.dtype and got[key].shape == v.shape, key
        np.testing.assert_array_equal(got[key], v, err_msg=key)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_hide_communication_bitwise(runs, layout):
    got, want = runs[layout]["hide"], hide_cases(layout)
    assert got.keys() == want.keys()
    for key, v in want.items():
        np.testing.assert_array_equal(got[key], v, err_msg=key)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_masks_and_coordinates_are_global(runs, layout):
    got, want = runs[layout]["mask"], mask_cases(layout)
    assert got.keys() == want.keys()
    for key, v in want.items():
        np.testing.assert_array_equal(got[key], v, err_msg=key)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_reductions_across_processes(runs, layout):
    got, want = runs[layout]["red"], reduction_cases(layout)
    for key, v in want.items():
        kind = key.split("|")[0]
        if kind in ("dot", "dotm", "l2", "mean"):
            assert got[key] == pytest.approx(v, rel=1e-14, abs=0), key
        elif kind == "many":
            assert got[key] == pytest.approx(v, rel=1e-14, abs=0), key
        elif kind in ("linf", "min", "max"):
            assert got[key] == v, key
        elif kind == "roundtrip":
            G, back = got[key]
            np.testing.assert_array_equal(back, G, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], v, err_msg=key)


def test_layout_guards(runs):
    g = runs["2x1"]["guard"]
    assert g["default_dims"] == (2, 1, 1)      # dims=None: one block per process
    assert g["dims"] is not None and "cannot be split" in g["dims"]
    assert g["few"] is not None and "cannot be split" in g["few"]


@pytest.mark.parametrize("dims,nprocs,want", [
    ((2, 2, 2), 8, (2, 2, 2)), ((2, 2, 2), 2, (2, 1, 1)), ((4, 2, 1), 2, (2, 1, 1)),
    ((4, 2, 1), 8, (4, 2, 1)), ((1, 4, 2), 4, (1, 4, 1)), ((8,), 2, (2,)), ((4, 2), 1, (1, 1)),
])
def test_default_process_layout(dims, nprocs, want):
    assert procs_for(dims, nprocs) == want


def test_layout_that_does_not_divide_raises():
    with pytest.raises(ValueError, match="cannot be split"):
        procs_for((3, 1, 1), 2)
    from repro_torch.core.topology import CartesianTopology
    with pytest.raises(ValueError, match="does not divide"):
        CartesianTopology(dims=(2, 2, 1), periodic=(False,) * 3, procs=(1, 1, 2))
    topo = CartesianTopology(dims=(4, 2, 2), periodic=(True, False, False), procs=(2, 1, 2),
                             pcoord=(1, 0, 1))
    assert topo.local_dims == (2, 2, 1) and topo.offset == (2, 0, 1)
    assert topo.block_ranks() == [9, 11, 13, 15]
    assert topo.neighbour(0, +1) == topo.neighbour(0, -1) == 1   # periodic, two processes
    assert topo.neighbour(2, +1) is None and topo.neighbour(2, -1) == 2
    assert topo.coord(0).flatten().tolist() == [2, 3]


@pytest.mark.parametrize("joins", [False, True], ids=["never_joins", "never_exchanges"])
def test_missing_peer_fails_within_the_group_timeout(tmp_path, joins):
    t0 = time.monotonic()
    with pytest.raises(SpawnError) as e:
        if joins:
            spawn(2, "test_torch_dist_halo:stall", tmp_path, 12.0, group_timeout=4, timeout=90)
        else:
            spawn(2, "test_torch_dist_halo:stall", tmp_path, 0.0, group_timeout=4, timeout=90,
                  ranks=[0])
    assert e.value.rcs[0] not in (0, None)
    assert time.monotonic() - t0 < 60
    if joins:
        assert "exchange failed after" in str(e.value)
