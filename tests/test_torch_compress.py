"""``repro_torch.optim.compress.compressed_psum_mean`` on 8 gloo processes
against the JAX package's under ``shard_map`` over 8 host devices, on the
inputs of the reference's ``tests/test_substrate.py:56``
(``test_compressed_psum_error_feedback``): ``RandomState(2)``, per-rank
gradients ``(8, 4, 200)``.  The one-shot mean and residual, and the time
average of 30 error-feedback rounds, equal the reference's within 1e-6;
the reference test's two bounds hold for the port (the one-shot error at
most amax / 127, the error-feedback average within that error of the
exact mean).  ``wire_bytes`` states what the int32 sum sends."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _dist import spawn  # noqa: E402
from _mp import run  # noqa: E402
from repro_torch.optim import compress  # noqa: E402

ALIAS = "import jax.extend.core\njax.core.Primitive = jax.extend.core.Primitive\n"
ROUNDS = 30

REFERENCE = ALIAS + """
from jax.sharding import PartitionSpec as P
from repro.optim.compress import compressed_psum_mean

mesh = jax.make_mesh((8,), ("dp",))
rng = np.random.RandomState(2)
g = jnp.asarray(rng.randn(8, 4, 200), jnp.float32)

def _body(g, e):
    m, r = compressed_psum_mean(g[0] + e[0], "dp")
    return m, r[None]

f = jax.jit(jax.shard_map(
    _body, mesh=mesh, in_specs=(P("dp"), P("dp")), out_specs=(P(), P("dp"))))
mean1, resid = f(g, jnp.zeros_like(g))
acc = np.zeros(g.shape[1:], np.float32)
err = jnp.zeros_like(g)
for i in range({rounds}):
    m, err = f(g, err)
    acc += (np.asarray(m) - acc) / (i + 1)
np.savez({path!r}, g=np.asarray(g), mean=np.asarray(mean1), resid=np.asarray(resid), acc=acc)
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_compress")
    run(REFERENCE.format(rounds=ROUNDS, path=str(tmp / "ref.npz")), ndev=8)
    ref = np.load(tmp / "ref.npz")
    g = ref["g"]
    port = spawn(8, "_torch_sharded:compress_run", tmp, g, ROUNDS, timeout=120)
    return ref, port


def test_one_shot_matches_the_reference(runs):
    ref, port = runs
    for r, p in enumerate(port):
        np.testing.assert_allclose(p["mean"], ref["mean"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(p["resid"], ref["resid"][r], rtol=0, atol=1e-6)


def test_error_feedback_matches_the_reference_and_its_bounds(runs):
    ref, port = runs
    g = ref["g"]
    exact = g.mean(0)
    q_err = np.abs(port[0]["mean"] - exact).max()
    assert q_err <= np.abs(g).max() / 127.0 + 1e-6, q_err
    for p in port:
        np.testing.assert_allclose(p["acc"], ref["acc"], rtol=0, atol=1e-6)
        assert np.abs(p["acc"] - exact).max() < max(q_err, 1e-4) + 1e-6


def test_no_mesh_raises_and_wire_bytes():
    with pytest.raises(ValueError, match="mesh"):
        compress.compressed_psum_mean(torch.zeros(3, 200), "dp")
    wb = compress.wire_bytes((4, 200), 8)
    # int32 codes weigh what float32 values do: the compressed sum sends more
    assert wb["compressed"] > wb["float32"] == 7 * 4 * 800
