"""Staggering locations — the canonical table and the location-aware masks.

A grid array carries a *location*: ``center`` (entry ``i`` at node ``i``)
or ``xface``/``yface``/``zface`` (entry ``i`` along the staggered dim at the
face ``i + 1/2``; the trailing plane is a dead plane).  Under this
shape-uniform convention the halo exchange is location-independent; it only
rejects unknown names.  ``STAGGER_DIM`` maps each location to the grid
dimension it is staggered along.

The mask builders return a field ``(*dims, *local_shape)``: every block
gets the mask of its own rank coordinate.  They take any grid object with
the :class:`repro_torch.core.grid.ImplicitGlobalGrid` interface.

``repro_torch.fields.Field`` and ``FieldSet`` are recognised here by
duck-typed markers (:func:`is_field_node`, :func:`is_field_set`), so the
solvers can take staggered systems without importing ``fields``.
:func:`tree_leaves`, :func:`tree_map` (over tensors) and :func:`node_map`
(over Fields) walk such a *tree*: a tensor, a ``Field``, a ``FieldSet`` or
a tuple/list of them.
"""

from __future__ import annotations

import torch

LOCATIONS = ("center", "xface", "yface", "zface")
STAGGER_DIM = {"center": None, "xface": 0, "yface": 1, "zface": 2}


def stagger_dim(loc: str) -> int | None:
    """Grid dimension a location is staggered along (None for center)."""
    if loc not in STAGGER_DIM:
        raise ValueError(f"unknown location {loc!r}; expected one of {LOCATIONS}")
    return STAGGER_DIM[loc]


def face_location(dim: int) -> str:
    """Face location staggered along grid dimension ``dim``."""
    return ("xface", "yface", "zface")[dim]


def loc_of(x, default: str = "center") -> str:
    """Location of a field-like object (a ``Field`` or anything with a
    ``loc`` attribute); ``default`` for bare tensors."""
    return getattr(x, "loc", default)


def is_field_node(x) -> bool:
    """True for a ``repro_torch.fields.Field``."""
    return bool(getattr(x, "_staggered_tree", False)) and hasattr(x, "loc")


def is_field_set(x) -> bool:
    """True for a ``repro_torch.fields.FieldSet``."""
    return bool(getattr(x, "_staggered_tree", False)) and not hasattr(x, "loc")


def data_of(x):
    """Underlying tensor of a field-like object (identity for tensors)."""
    return x.data if is_field_node(x) else x


def tree_leaves(t) -> list:
    """The tensors of a tree, in order (a FieldSet in its key order)."""
    if is_field_node(t):
        return [t.data]
    if is_field_set(t) or isinstance(t, (list, tuple)):
        return [leaf for node in t for leaf in tree_leaves(node)]
    return [t]


def node_map(fn, tree, *rest):
    """``fn`` over the Fields (and bare tensors) of structure-matching trees,
    each Field handed over whole."""
    if is_field_set(tree):
        return type(tree)(**{k: node_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()})
    if isinstance(tree, (list, tuple)):
        return type(tree)(node_map(fn, *nodes) for nodes in zip(tree, *rest))
    return fn(tree, *rest)


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of structure-matching trees; the result has
    the structure of ``tree`` (Fields keep their grid and location)."""
    if is_field_node(tree):
        return tree.with_data(fn(tree.data, *(data_of(r) for r in rest)))
    if is_field_set(tree):
        return type(tree)(**{k: tree_map(fn, v, *(r[k] for r in rest))
                             for k, v in tree.items()})
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *nodes) for nodes in zip(tree, *rest))
    return fn(tree, *(data_of(r) for r in rest))


def valid_mask(grid, loc: str, dtype=None) -> torch.Tensor:
    """1.0 on real points of ``loc`` (excludes the staggered dead plane)."""
    dtype = dtype or grid.dtype
    m = grid.ones(dtype)
    sd = stagger_dim(loc)
    if sd is not None:
        gidx = grid.local_global_indices()
        m = m * (gidx[sd] < grid.n_g(sd) - 1).to(dtype)
    return m


def interior_mask(grid, loc: str, dtype=None) -> torch.Tensor:
    """1.0 on the unknowns of a field at ``loc``.

    Along a non-staggered Dirichlet dim the boundary ring is the global
    ``[0, w)`` / ``[N - w, N)``; along a staggered Dirichlet dim the
    boundary faces are ``[0, w)`` and ``[N - 1 - w, N - 1)`` (the dead plane
    ``N - 1`` is excluded too).  ``w`` is the grid halo width.  Periodic
    dims have no pinned planes, so they are left unmasked.
    """
    dtype = dtype or grid.dtype
    w = grid.halo
    m = grid.ones(dtype)
    gidx = grid.local_global_indices()
    sd = stagger_dim(loc)
    for d in range(grid.ndims):
        if grid.topo.periodic[d]:
            continue
        hi = grid.n_g(d) - w - (1 if d == sd else 0)
        m = m * ((gidx[d] >= w) & (gidx[d] < hi)).to(dtype)
    return m
