"""Checkpoint save/restore of trees of tensors (mid-solve restart).

Layout, the reference's: ``<dir>/step_<N>/manifest.json`` plus one ``.npy``
per leaf, named by the leaf's path — dict keys (sorted) and sequence
indices joined by ``__`` (``root`` for a bare leaf); a
``repro_torch.fields.Field`` adds ``0`` (its one child) and a ``FieldSet``
the index of each component, as the reference's pytree paths do.  Files
written by either package restore in the other.

Saves are atomic (a ``.tmp`` directory, then a rename), and the newest
complete checkpoint wins (:func:`latest_step`).  :func:`async_save` copies
device to host before it returns and writes the files on a worker thread.

A field restores onto another block layout through its deduplicated
global array: save ``grid.gather(u)``, restore it, and ``grid2.scatter(G)``
builds the field on any ``dims`` (the reference's own path).

Under a ``torch.distributed`` group the files are those of the same state
held by one process.  A field leaf — a ``Field``, or a bare tensor of the
shape ``grid.shape`` of the ``grid=`` passed — is gathered into the field
tensor of every block, ``(*dims, *local)`` (collective: every process
saves), and process 0 alone writes the files; every other leaf is taken
to be the same on every process (a gathered array, a step counter) and is
written as process 0 holds it.  Every process then waits for the others.
:func:`restore` reads on every process, and each takes its own blocks of a
field leaf.  So a state saved on 8 processes restores on one process with
the same ``dims``, and through its gathered array on any other layout.

A state sharded over a process mesh (sharded training; ``shardings=``, a
tree of ``models.params.Placement`` beside the state, as
``train.state_shardings`` builds it for ``{"params", "opt"}``) is saved as
its global leaves: the processes that hold distinct blocks of a leaf send
them to process 0, which assembles the whole array and writes it, the
files a one-process run of the same state writes.  :func:`restore` with
``shardings=`` (of the mesh to resume on) reads each file and keeps this
process's block; so a checkpoint written on one mesh resumes on another,
or in one process without ``shardings``: the reference's elastic resume.
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import os
import re
import shutil

import numpy as np
import torch

from ..core import comm
from ..core import locations as _loc
from ..models import params as pm


@functools.cache
def _executor() -> concurrent.futures.ThreadPoolExecutor:
    """The writers of :func:`async_save`: two threads, made at first use."""
    return concurrent.futures.ThreadPoolExecutor(max_workers=2)


def _flatten(tree, path=()):
    """``[(path, leaf), ...]`` in the reference's pytree order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, path + (i,))]
    if _loc.is_field_set(tree):
        return [kv for i, (_, v) in enumerate(tree.items()) for kv in _flatten(v, path + (i,))]
    if _loc.is_field_node(tree):
        return [(path + (0,), tree.data)]
    return [(path, tree)]


def _unflatten(like, leaves):
    """Rebuild the structure of ``like`` from an iterator of leaves."""
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if _loc.is_field_set(like):
        return type(like)(**{k: _unflatten(v, leaves) for k, v in like.items()})
    if _loc.is_field_node(like):
        return like.with_data(next(leaves))
    return next(leaves)


def _field_grids(tree, grid=None) -> list:
    """For each leaf of :func:`_flatten`, the grid of a field leaf (a
    ``Field``'s own, or ``grid`` for a bare tensor of shape ``grid.shape``),
    else None."""
    if isinstance(tree, dict):
        return [g for k in sorted(tree) for g in _field_grids(tree[k], grid)]
    if isinstance(tree, (list, tuple)):
        return [g for v in tree for g in _field_grids(v, grid)]
    if _loc.is_field_set(tree):
        return [g for _, v in tree.items() for g in _field_grids(v, grid)]
    if _loc.is_field_node(tree):
        return [tree.grid]
    if grid is not None and isinstance(tree, torch.Tensor) and tuple(tree.shape) == grid.shape:
        return [grid]
    return [None]


def _leaf_name(path) -> str:
    return "__".join(str(p) for p in path) or "root"


def _to_host(x, own: bool = False) -> np.ndarray:
    """A host copy of a leaf that no later write to ``x`` can reach
    (``own``: ``x`` is a host tensor no one else holds, taken as it is)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves have no NumPy dtype; cast them before saving")
        return (x if own else x.detach().to("cpu", copy=True)).numpy()
    return np.array(x, copy=True)


def _placements(state, shardings) -> list:
    """For each leaf of :func:`_flatten`, its ``Placement`` (or device, or
    None) from a tree beside the state."""
    n = len(_flatten(state))
    if shardings is None or isinstance(shardings, (str, torch.device)):
        return [shardings] * n
    out = [v for _, v in _flatten(shardings)]
    if len(out) != n:
        raise ValueError(f"shardings has {len(out)} leaves, the state {n}")
    return out


def _host_leaves(state, grid=None, shardings=None):
    """Host copies of the leaves, a field leaf of a grid spread over
    processes gathered into the field tensor of every block, a sharded leaf
    assembled on process 0 (collective; the others keep none): every
    sharded leaf's blocks travel to process 0 at once."""
    leaves = _flatten(state)
    placements = _placements(state, shardings)
    sharded = [i for i, pl in enumerate(placements) if isinstance(pl, pm.Placement)]
    arrived = comm.gather_to_first([placements[i].outgoing(leaves[i][1]) for i in sharded]) \
        if sharded else []
    whole = {i: placements[i].assemble(parts) for i, parts in zip(sharded, arrived)}
    out = []
    for i, ((p, x), g) in enumerate(zip(leaves, _field_grids(state, grid))):
        if g is not None and g.distributed:
            x = g.all_blocks(x)
        if i in whole:   # assembled here: a fresh host tensor, not copied again
            x = whole[i]
            if x is None:
                continue
        out.append((_leaf_name(p), _to_host(x, own=i in whole)))
    return out


def _path(step: int, ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save(state, step: int, ckpt_dir: str, grid=None, shardings=None) -> str:
    """Synchronous save.  Returns the checkpoint path.  Under a process
    group every process calls it (``grid``, ``shardings``: see the module
    docstring)."""
    leaves = _host_leaves(state, grid, shardings)
    if comm.rank() == 0:
        _write(leaves, step, ckpt_dir)
    comm.barrier()
    return _path(step, ckpt_dir)


class GroupSave:
    """The future of :func:`async_save`: process 0's write, or nothing to
    wait for on the others.  :meth:`result` is collective: it waits for the
    write, then for every process of the group (if there is one)."""

    def __init__(self, future, path: str):
        self._future, self._path = future, path

    def result(self, timeout=None) -> str:
        if self._future is not None:
            self._future.result(timeout=timeout)
        comm.barrier()
        return self._path


def async_save(state, step: int, ckpt_dir: str, grid=None, shardings=None):
    """Device-to-host copy now (and, under a process group, the gather of
    the field leaves and of the sharded ones); file IO on a worker thread.
    Returns a :class:`GroupSave`."""
    leaves = _host_leaves(state, grid, shardings)
    future = _executor().submit(_write, leaves, step, ckpt_dir) if comm.rank() == 0 else None
    return GroupSave(future, _path(step, ckpt_dir))


def _write(host_leaves, step: int, ckpt_dir: str) -> str:
    final = _path(step, ckpt_dir)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    names = []
    for name, arr in host_leaves:
        np.save(os.path.join(tmp, name + ".npy"), arr)
        names.append({"name": name, "dtype": str(arr.dtype), "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": names,
                   "treedef": [n["name"] for n in names]}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def _shape(like) -> tuple:
    if isinstance(like, (torch.Tensor, np.ndarray)):
        return tuple(like.shape)
    return tuple(np.shape(like))


def restore(state_like, step: int, ckpt_dir: str, shardings=None, grid=None):
    """Restore into the structure of ``state_like`` (shapes must match);
    every leaf comes back as a tensor with the stored dtype.  A field leaf
    of a grid spread over processes (see the module docstring) takes this
    process's blocks of the stored field tensor of every block.

    ``shardings`` is the reference's target shardings: a tree matching
    ``state_like`` (or one value for every leaf) of ``torch.device``s, of
    ``models.params.Placement``s (each a leaf's spec on a mesh, from
    ``train.state_shardings``: this process keeps its block of the stored
    global leaf), or of None.  Without a device
    a leaf lands on the device of its ``state_like`` tensor, and on the CPU
    where ``state_like`` holds a NumPy array or a Python number.
    """
    path = _path(step, ckpt_dir)
    leaves = _flatten(state_like)
    grids = _field_grids(state_like, grid)
    devices = _placements(state_like, shardings)
    out = []
    for (p, like), dev, g in zip(leaves, devices, grids):
        arr = np.load(os.path.join(path, _leaf_name(p) + ".npy"), mmap_mode="r")
        if isinstance(dev, pm.Placement):
            block = dev.block(arr)
            if tuple(block.shape) != _shape(like):
                raise ValueError(f"{_leaf_name(p)}: this process's block of ckpt {arr.shape} is "
                                 f"{tuple(block.shape)} != target {_shape(like)}")
            out.append(block.to(like.device if isinstance(like, torch.Tensor) else "cpu"))
            continue
        arr = np.array(arr)
        if g is not None and g.distributed:
            if tuple(arr.shape) != g.full_shape:
                raise ValueError(f"{_leaf_name(p)}: ckpt {arr.shape} != field {g.full_shape}")
            arr = np.ascontiguousarray(arr[tuple(
                slice(o, o + m) for o, m in zip(g.topo.offset, g.local_dims))])
        if tuple(arr.shape) != _shape(like):
            raise ValueError(f"{_leaf_name(p)}: ckpt {arr.shape} != target {_shape(like)}")
        if dev is None:
            dev = like.device if isinstance(like, torch.Tensor) else "cpu"
        out.append(torch.from_numpy(arr).to(dev))
    return _unflatten(state_like, iter(out))
