"""Carry the JAX package's state into the port's layout and back.

For this system the state is the fields: the reference stores each as one
array of stacked local blocks (``grid.stacked_shape``); the port stores it
as a ``(*dims, *local_shape)`` tensor on its grid's device.  Staggered
fields travel as :class:`~repro_torch.fields.Field` (a location with the
tensor) and :class:`~repro_torch.fields.FieldSet` (named Fields), e.g. the
Stokes viscosity ``eta``, forcing ``F``, pressure ``P`` and velocity ``V``.

For the language models the state is the parameters:
:func:`params_from_reference` turns the JAX package's parameter tree into
the state dict of a :class:`repro_torch.models.Model`, and
:func:`tree_to_reference` turns the port's ``{name: tensor}`` dicts
(parameters, gradients) back into the reference's stacked tree;
:func:`opt_state_to_reference` does the same for the AdamW state.
"""

from __future__ import annotations

import numpy as np

import torch

from .core.grid import ImplicitGlobalGrid
from .fields import Field, FieldSet
from .models import params as pm
from .models import transformer


def fields_from_reference(grid: ImplicitGlobalGrid, *stacked):
    """Stacked NumPy arrays (the reference's layout) -> field tensors
    (one tensor if one array was given)."""
    out = tuple(grid.from_stacked(a) for a in stacked)
    return out[0] if len(out) == 1 else out


def fields_to_reference(grid: ImplicitGlobalGrid, *fields) -> tuple[np.ndarray, ...] | np.ndarray:
    """Field tensors -> stacked NumPy arrays in the reference's layout."""
    out = tuple(grid.to_stacked(t) for t in fields)
    return out[0] if len(out) == 1 else out


def field_from_reference(grid: ImplicitGlobalGrid, stacked, loc: str = "center") -> Field:
    """One stacked array of the reference (a ``repro.fields.Field``'s
    ``data``) -> a Field at ``loc``."""
    return Field(grid, grid.from_stacked(stacked), loc)


def fieldset_from_reference(grid: ImplicitGlobalGrid, **named) -> FieldSet:
    """``name=(stacked array, loc)`` pairs -> a FieldSet, in the given order."""
    return FieldSet(**{k: field_from_reference(grid, a, loc) for k, (a, loc) in named.items()})


def field_to_reference(field: Field) -> tuple[np.ndarray, str]:
    """A Field -> (stacked NumPy array, location)."""
    return field.grid.to_stacked(field.data), field.loc


def fieldset_to_reference(fset: FieldSet) -> dict:
    """A FieldSet -> ``{name: (stacked array, loc)}``, in its order."""
    return {k: field_to_reference(f) for k, f in fset.items()}


def params_from_reference(cfg, tree) -> dict:
    """The JAX package's parameter tree of ``cfg`` with NumPy leaves
    (``stacks[i]["layers"][j][name]`` with a leading repeat axis,
    ``embed``, ``final_norm``) -> the state dict of
    ``repro_torch.models.Model(cfg, state)``, as CPU tensors.  Every leaf
    maps to one parameter (transposed where the port keeps an
    ``nn.Linear`` weight); a leaf left over or missing raises."""
    leaf = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    state = transformer.state_from_tree(cfg, pm.tree_map(leaf, tree))
    transformer.check_state(cfg, state)
    return state


def _numpy(t) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _restack(cfg, per_leaf: dict):
    """``{name: one repeat of its reference leaf}`` (a tensor, or a dict of
    tensors such as int8 ``{"q", "s"}``) -> the reference's stacked tree of
    NumPy arrays."""
    layout = transformer.reference_layout(cfg)
    missing, extra = sorted(set(layout) - set(per_leaf)), sorted(set(per_leaf) - set(layout))
    if missing or extra:
        raise ValueError(f"parameters without a value {missing}, values left over {extra}")
    groups: dict = {}
    for name, leaf in layout.items():
        groups.setdefault(leaf.path, []).append((leaf.r, per_leaf[name]))

    def stack(vals):
        if isinstance(vals[0], dict):
            return {k: stack([v[k] for v in vals]) for k in vals[0]}
        return np.stack([_numpy(v) for v in vals])

    def one(val):
        return {k: one(v) for k, v in val.items()} if isinstance(val, dict) else _numpy(val)

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v, path + (i,)) for i, v in enumerate(node)]
        items = groups[path]
        if items[0][0] is None:
            return one(items[0][1])
        return stack([v for _, v in sorted(items, key=lambda rv: rv[0])])

    return build(transformer.param_specs(cfg), ())


def tree_to_reference(cfg, state: dict) -> dict:
    """The port's parameters of ``cfg`` (a ``{name: tensor}`` dict: a
    :class:`~repro_torch.models.Model`'s state, ``init_params``' dict or
    the gradients of one) -> the JAX package's stacked tree with NumPy
    leaves (bfloat16 as float32), the inverse of
    :func:`params_from_reference`."""
    layout = transformer.reference_layout(cfg)
    return _restack(cfg, {n: layout[n].to_ref(t) if n in layout else t for n, t in state.items()})


def opt_state_to_reference(cfg, opt_state: dict) -> dict:
    """The port's AdamW state for the parameters of ``cfg`` (moments kept in
    the reference leaves' layout, see ``repro_torch.optim.adamw``) -> the
    reference's ``{"m": tree, "v": tree, "step"}``, int8 moments as
    ``{"q", "s"}`` leaves."""
    return {"m": _restack(cfg, opt_state["m"]), "v": _restack(cfg, opt_state["v"]),
            "step": _numpy(opt_state["step"])}
