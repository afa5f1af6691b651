"""Mutation corpus: the port's analyzer must CATCH each planted bug class,
with the rule and severity the JAX package's analyzer gives its own
mutant (``tests/test_analysis_mutants.py``).

* M1-M3 are planted in a kernel launch plan (a clamped neighbour block
  index, a tile that neither divides its extent nor is guarded, an output
  map that ignores the block).  The reference cannot run its BlockSpec
  mutants on jax 0.9 (ROADMAP F13), so these are held to the rule and the
  messages its test asserts.
* M4, M5 and M9-M13 run here and in the reference (one child process with
  8 fake devices, started first and read last); their (rule, severity)
  sets must be equal.
* M6-M8 run on gloo processes (``tests/_dist.py``): one process issues a
  bare all-reduce the others skip (a rank-dependent branch), and exchanges
  whose neighbour table has a hole or sends two processes' slabs to one.
  Each must be reported by every process, within the group timeout, and
  never hang; the union of the processes' (rule, severity) sets must equal
  the reference's.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from _dist import spawn
from _mp import PRELUDE, SRC
from _torch_analysis import REFERENCE_PRELUDE, rule_set
from repro_torch import analysis
from repro_torch.analysis import markers
from repro_torch.analysis.launchgrid import LaunchPlan

REFERENCE = REFERENCE_PRELUDE + """
import repro
from jax.sharding import PartitionSpec as P
from repro import analysis
from repro.analysis import markers
from repro.core import init_global_grid
from repro.kernels.solver3d import ref
from repro.solvers import reductions as red

def rules(rep):
    return sorted({(f.rule, f.severity) for f in rep})

out = {}
def m4(u):
    return jax.lax.fori_loop(0, 10, lambda k, u: markers.consume(u, radius=1, site="mutant.step"), u)
out["M4"] = rules(analysis.check(m4, jnp.zeros((6, 6, 6)), halo=1))
def m5(u):
    u = markers.exchange_out(u, width=1, site="mutant.halo")
    u = markers.consume(u, radius=1, site="mutant.op1")
    return analysis.stencil_read(u, radius=2, site="mutant.wide_op")
out["M5"] = rules(analysis.check(m5, jnp.zeros((8, 8, 8)), halo=1))

mesh = jax.make_mesh((4, 2), ("x", "y"))
spec = P("x", "y")
v = jnp.zeros((8, 8))
def mcheck(f, in_specs=(spec,), out_specs=spec, args=(v,)):
    sm = jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False)
    return analysis.check(sm, *args)
def branch_local(u, p):
    return jax.lax.cond(p > 0, lambda u: jax.lax.psum(jnp.sum(u), ("x",)), jnp.sum, u)
out["M6"] = rules(mcheck(branch_local, in_specs=(spec, P()), out_specs=P(), args=(v, jnp.zeros(()))))
out["M7"] = rules(mcheck(lambda u: jax.lax.ppermute(u, "x", [(0, 1), (1, 2)])))
out["M8"] = rules(mcheck(lambda u: jax.lax.ppermute(u, "x", [(0, 1), (2, 1)])))

g = init_global_grid(10, 10, 10, dims=(2, 2, 2), dtype=jnp.float64)
def gcheck(f, *args, out_specs=P()):
    sm = jax.shard_map(f, mesh=g.mesh, in_specs=(g.spec,) * len(args), out_specs=out_specs,
                       check_vma=False)
    return analysis.check(sm, *args)
u = jnp.zeros(g.stacked_shape, jnp.float64)
out["M9"] = rules(gcheck(lambda A: red.psum(g.topo, jnp.sum(A * 1.0)), u))
names = tuple(g.mesh.axis_names)
out["M10"] = rules(gcheck(lambda A: jax.lax.psum(jnp.sum(A * red.owned_mask(g, dtype=A.dtype)), names), u))
uf = jnp.zeros(g.stacked_shape, jnp.float32)
out["M11"] = rules(gcheck(lambda A: red.psum(g.topo, jnp.sum(A * red.owned_mask(g, dtype=A.dtype))), uf))
c = jnp.ones(tuple(g.local_shape), jnp.float64)
def m12(u):
    u = g.update_halo(g.update_halo(u))
    return ref.poisson_stencil(u, c, (1.0, 1.0, 1.0))
out["M12"] = rules(gcheck(m12, u, out_specs=g.spec))
def m13(u):
    return jax.lax.fori_loop(0, 10, lambda k, u: u - 0.1 * ref.poisson_stencil(u, c, (1.0, 1.0, 1.0)), u)
out["M13"] = rules(gcheck(m13, u, out_specs=g.spec))
def m13_fixed(u):
    def body(k, u):
        u = g.update_halo(u)
        return u - 0.1 * ref.poisson_stencil(u, c, (1.0, 1.0, 1.0))
    return jax.lax.fori_loop(0, 10, body, u)
out["M13_fixed"] = rules(gcheck(m13_fixed, u, out_specs=g.spec))
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    """The reference's mutants, in a child started when the module starts
    (``tests/_mp.py``'s prelude, 8 fake devices) and read when needed."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-c", PRELUDE.format(ndev=8) + textwrap.dedent(REFERENCE)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    box = {}

    def result():
        if "out" not in box:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-6000:]
            line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
            box["out"] = {k: [tuple(p) for p in v] for k, v in json.loads(line[7:]).items()}
        return box["out"]

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


# ---------------------------------------------------------------------------
# M1-M3: launch-plan mutants
# ---------------------------------------------------------------------------

def _launch(plan):
    """A kernel wrapper with a planted plan (under a check it records the
    plan and launches nothing, as the port's wrappers do)."""
    def wrapper(x):
        return markers.TRACE.kernel(plan, (x,))
    return wrapper


def _plan(tile, grid, out_map, in_map=None, shape=(16, 8, 8)):
    return LaunchPlan("mutant", grid=grid, block=(32, 1, 1), shape=shape, tile=tile,
                      guard=(False,) * 3, out_map=out_map,
                      in_maps=() if in_map is None else (("in0", in_map),))


def test_mutant_clamped_index_map_caught():
    # The historical bug: clamping the neighbour index silently re-reads
    # the first block instead of the neighbour (wrap) block.
    plan = _plan((4, 8, 8), (4, 1, 1), lambda gx, gy, gz: (gx, 0, 0),
                 lambda gx, gy, gz: (np.maximum(gx - 1, 0), 0, 0))
    rep = analysis.check(_launch(plan), torch.zeros(16, 8, 8))
    assert rep.by_rule("pallas-blockspec") and rep.errors()
    assert any("duplicated block" in f.message or "non-uniform" in f.message
               for f in rep.by_rule("pallas-blockspec"))
    # the wrap read (i - 1) mod nb is a true neighbour: clean
    ok = _plan((4, 8, 8), (4, 1, 1), lambda gx, gy, gz: (gx, 0, 0),
               lambda gx, gy, gz: ((gx - 1) % 4, 0, 0))
    assert not analysis.check(_launch(ok), torch.zeros(16, 8, 8))


def test_mutant_nontiling_block_caught():
    plan = _plan((5, 8, 8), (3, 1, 1), lambda gx, gy, gz: (gx, 0, 0))
    rep = analysis.check(_launch(plan), torch.zeros(16, 8, 8))
    assert rep.by_rule("pallas-blockspec") and rep.errors()
    assert any("does not tile" in f.message for f in rep.errors())


def test_mutant_noniterating_output_map_caught():
    # The output map ignores the block: every block writes block 0.
    plan = _plan((4, 8, 8), (4, 1, 1), lambda gx, gy, gz: (0 * gx, 0, 0))
    rep = analysis.check(_launch(plan), torch.zeros(16, 8, 8))
    assert rep.by_rule("pallas-blockspec") and rep.errors()


# ---------------------------------------------------------------------------
# M4, M5, M9-M13: the port's mutants against the reference's
# ---------------------------------------------------------------------------

def _grid(dtype=torch.float64):
    from repro_torch.core import init_global_grid
    return init_global_grid(10, 10, 10, dims=(2, 2, 2), dtype=dtype, device="cpu")


def port_mutants() -> dict:
    from repro_torch.core import comm
    from repro_torch.kernels.solver3d import ref
    from repro_torch.solvers import reductions as red

    out = {}

    def m4(u):
        for _ in range(10):   # steps the stencil, never exchanges
            u = markers.consume(u, radius=1, site="mutant.step")
        return u
    out["M4"] = analysis.check(m4, torch.zeros(6, 6, 6), halo=1)

    def m5(u):   # a radius-2 stencil behind a width-1 exchange
        u = markers.exchange_out(u, width=1, site="mutant.halo")
        u = markers.consume(u, radius=1, site="mutant.op1")
        return analysis.stencil_read(u, radius=2, site="mutant.wide_op")
    out["M5"] = analysis.check(m5, torch.zeros(8, 8, 8), halo=1)

    g = _grid()
    u = g.zeros()
    # M9: blessed reduction, no ownership mask
    out["M9"] = analysis.check(lambda A: red.psum(g.topo, torch.sum(A * 1.0)), u)
    # M10: a bare comm.all_reduce, bypassing solvers.reductions
    out["M10"] = analysis.check(
        lambda A: comm.all_reduce(torch.sum(A * red.owned_mask(g, A.dtype)), "sum"), u)
    # M11: a float32 accumulator in a global sum
    gf = _grid(torch.float32)
    out["M11"] = analysis.check(
        lambda A: red.psum(gf.topo, torch.sum(A * red.owned_mask(gf, A.dtype))), gf.zeros())
    c = torch.ones(g.shape, dtype=torch.float64)

    def m12(u):   # the exchange doubled
        u = g.update_halo(g.update_halo(u))
        return ref.poisson_stencil(u, c, (1.0, 1.0, 1.0))
    out["M12"] = analysis.check(m12, u.clone())

    def m13(u):   # 10 damped sweeps with the per-iteration exchange deleted
        for _ in range(10):
            u = u - 0.1 * ref.poisson_stencil(u, c, (1.0, 1.0, 1.0))
        return u
    out["M13"] = analysis.check(m13, u.clone())

    def m13_fixed(u):
        for _ in range(10):
            u = g.update_halo(u)
            u = u - 0.1 * ref.poisson_stencil(u, c, (1.0, 1.0, 1.0))
        return u
    out["M13_fixed"] = analysis.check(m13_fixed, u.clone())
    return out


@pytest.fixture(scope="module")
def port():
    return port_mutants()


@pytest.mark.parametrize("name", ["M4", "M5", "M9", "M10", "M11", "M12", "M13", "M13_fixed"])
def test_mutant_matches_reference(reference, port, name):
    got, want = rule_set(port[name]), reference()[name]
    assert got == want, (name, got, want, [str(f) for f in port[name]])


def test_mutant_messages(port):
    assert port["M4"].errors() and port["M5"].by_rule("halo-staleness")
    assert any("mask" in f.message.lower() for f in port["M9"].by_rule("reduction-exactness"))
    assert any("bare" in f.message for f in port["M10"].by_rule("reduction-exactness"))
    assert [f.severity for f in port["M11"]] == ["warning"]
    assert port["M12"].by_rule("redundant-exchange") and not port["M12"].errors()
    assert port["M13"].by_rule("halo-staleness") and not port["M13_fixed"]


# ---------------------------------------------------------------------------
# M6-M8: collective congruence on gloo processes
# ---------------------------------------------------------------------------

def group_mutant(rank: int, world: int, which: str):
    """One mutant in each process of the group; returns the findings and
    the seconds the check took."""
    from repro_torch.core import comm, init_global_grid
    from repro_torch.core.topology import CartesianTopology

    t0 = time.monotonic()
    if which == "M6":
        g = init_global_grid(6, 6, 6, dtype=torch.float64, device="cpu")

        def branch_local(u):   # only rank 0 enters the (bare) all-reduce, as the reference's
            if comm.rank() == 0:
                comm.all_reduce(torch.sum(u), "sum")
            return u
        rep = analysis.check(branch_local, g.zeros())
    else:
        orig = CartesianTopology.neighbour

        def partial(self, dim, shift):   # a hole: process 2 has no high partner
            if dim == 0 and shift > 0 and self.pcoord[0] == 2:
                return None
            return orig(self, dim, shift)

        def dup(self, dim, shift):   # every process sends high to rank 1
            return 1 if dim == 0 and shift > 0 else orig(self, dim, shift)

        CartesianTopology.neighbour = partial if which == "M7" else dup
        g = init_global_grid(6, 6, 6, dims=(4, 1, 1), periodic=(True, True, True), device="cpu")
        rep = analysis.check(lambda u: g.update_halo(u), g.zeros())
    return rule_set(rep), [f.message for f in rep], time.monotonic() - t0


@pytest.mark.parametrize("which,world", [("M6", 2), ("M6", 8), ("M7", 4), ("M8", 4)])
def test_group_mutant_reported_not_hung(tmp_path, reference, which, world):
    res = spawn(world, "test_torch_analysis_mutants:group_mutant", tmp_path, which,
                timeout=120, group_timeout=60)
    want = reference()[which]
    # the group's report is the union of its processes' (the reference
    # traces every branch in one program; here each process runs its own)
    assert sorted(set().union(*(set(r[0]) for r in res))) == want, (res, want)
    for rules, messages, seconds in res:
        assert ("collective-congruence", "error") in rules, messages
        assert seconds < 60
    messages = res[0][1]
    if which == "M6":
        assert any("different collective sequences" in m for m in messages), messages
    else:
        word = "partial" if which == "M7" else "destination"
        assert any(word in m for m in messages), messages
