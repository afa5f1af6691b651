"""The port's training loss and its gradients against the JAX package's
``jax.value_and_grad(transformer.loss_fn)``, float32 on the CPU: the
other four of the eight SMOKE configs the port registers (the first four
and the contract in ``test_torch_train_grads.py``).

The reference's gradient tree and the port's (``convert.tree_to_reference``
of the gradients of the port's ``{name: tensor}`` parameters) must have the
same leaves, each within 2e-5 normwise (float32 sums in another order
through a few layers); the loss, xent and aux within 1e-5 relative.  Each
of the four remat policies must give those numbers.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _torch_train import POLICIES, check, leaves, reference_grads, smoke  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import params as pm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

MODULES = ("jamba_v01_52b", "kimi_k2", "gemma_2b", "starcoder2_15b")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_grads(tmp_path_factory.mktemp("torch_train_grads2"), MODULES)


@pytest.mark.parametrize("mod", MODULES)
def test_loss_and_every_gradient_leaf(reference, mod):
    check(reference, mod, "full")


@pytest.mark.parametrize("remat", POLICIES)
@pytest.mark.parametrize("mod", MODULES)
def test_remat_policies_give_the_same_numbers(reference, mod, remat):
    check(reference, mod, remat)


@pytest.mark.parametrize("mod", ("mamba2_1p3b", "gemma3_4b", "gemma_2b", "granite_moe_3b",
                                 "jamba_v01_52b", "kimi_k2", "llama3_2_1b", "starcoder2_15b"))
def test_tree_to_reference_round_trip_is_bitwise(mod):
    """tree -> the port's state -> tree gives every leaf back bit for bit
    (eight SMOKE configs, parameters drawn by the port's init law)."""
    cfg = smoke(mod)
    tree = pm.tree_map(lambda t: t.numpy(), pm.materialize(
        tf.param_specs(cfg), torch.Generator().manual_seed(5), torch.float32, "cpu"))
    back = convert.tree_to_reference(cfg, convert.params_from_reference(cfg, tree))
    want, got = leaves(tree), leaves(back)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
