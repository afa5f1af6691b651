"""The port's training loss and its gradients against the JAX package's
``jax.value_and_grad(transformer.loss_fn)``, float32 on the CPU: four of
the eight SMOKE configs the port registers (the other four in
``test_torch_train_grads2.py``; the reference's child process takes
3-11 s a config).

The reference's gradient tree and the port's (``convert.tree_to_reference``
of the gradients of the port's ``{name: tensor}`` parameters) must have the
same leaves, each within 2e-5 normwise (float32 sums in another order
through a few layers); the loss, xent and aux within 1e-5 relative.  Each
of the four remat policies must give those numbers.
"""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from _torch_train import POLICIES, check, port_loss_and_grads, reference_grads  # noqa: E402

MODULES = ("llama3_2_1b", "gemma3_4b", "mamba2_1p3b", "granite_moe_3b")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_grads(tmp_path_factory.mktemp("torch_train_grads"), MODULES)


@pytest.mark.parametrize("mod", MODULES)
def test_loss_and_every_gradient_leaf(reference, mod):
    check(reference, mod, "full")


@pytest.mark.parametrize("remat", POLICIES)
@pytest.mark.parametrize("mod", MODULES)
def test_remat_policies_give_the_same_numbers(reference, mod, remat):
    check(reference, mod, remat)


def test_unknown_remat_raises(reference):
    with pytest.raises(ValueError, match="remat"):
        port_loss_and_grads(reference, "llama3_2_1b", "everything")
