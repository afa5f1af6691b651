"""Logical-axis sharding rules for the LM zoo, over a process mesh.

The port's twin of the JAX package's ``distributed/sharding.py``.  Model
code names the axes of its tensors with *logical* names; a rule set maps
each name to mesh axes (MaxText style), and :meth:`AxisRules.spec` gives,
for a tensor's logical axes and global shape, one entry per dimension:
None (replicated), a mesh-axis name, or a tuple of names (the first axis
major).  The reference hands that spec to GSPMD; the port's processes each
hold the block of every tensor that the spec assigns their mesh
coordinates (:mod:`repro_torch.launch.mesh`), and the model code gathers
and sums through :mod:`repro_torch.core.comm` where GSPMD would insert the
collectives.  With no rule set installed, :func:`shd` does nothing and
the same model code runs in one process.

Default rule set for the meshes ``(data, model)`` / ``(pod, data, model)``:

    batch      -> (pod, data)      data parallelism
    fsdp       -> (pod, data, model) minus what a TP dimension took: ZeRO-3
    vocab / heads / ffn / experts -> model   tensor parallelism
    kv_heads   -> None             kv heads rarely divide the model axis
    cache_seq  -> model (+data when batch < data axis)  flash-decoding split
    seq        -> model            sequence parallelism (when asked)
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Sequence

_state = threading.local()


class AbstractMesh:
    """A mesh's axis names and sizes, without processes (what the rules
    read; :class:`repro_torch.launch.mesh.Mesh` adds the processes).
    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh``'s
    does."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} vs axis names {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def current():
    """The installed :class:`AxisRules`, or None."""
    return getattr(_state, "rules", None)


class AxisRules:
    """Mapping logical axis name -> mesh axis (str | tuple | None)."""

    def __init__(self, mesh, rules: dict[str, object]):
        self.mesh = mesh
        self.rules = dict(rules)

    def spec(self, *logical: str | None, shape: Sequence[int] | None = None) -> tuple:
        """The entry of each dimension: None, a mesh-axis name or a tuple
        of names.

        Two passes, as the reference's: single-axis rules (TP dims such as
        heads/ffn/vocab) reserve their mesh axis first, then multi-axis
        rules (fsdp/batch) take what remains, so that ZeRO over ``model``
        never steals the TP axis.  With ``shape``, mesh axes that do not
        divide a dimension are dropped (the longest divisible prefix is
        kept)."""
        resolved: list = [None] * len(logical)
        used: set = set()
        names = self.mesh.axis_names

        def fit(axes, dim):
            axes = tuple(a for a in axes if a not in used and a in names)
            if dim is not None:
                kept, prod = [], 1
                for a in axes:
                    if dim % (prod * self.mesh.shape[a]) == 0:
                        kept.append(a)
                        prod *= self.mesh.shape[a]
                    else:
                        break
                axes = tuple(kept)
            return axes

        order = sorted(range(len(logical)),
                       key=lambda i: isinstance(self.rules.get(logical[i] or ""), (tuple, list)))
        for i in order:
            name = logical[i]
            axes = self.rules.get(name) if name else None
            if axes is None:
                continue
            if isinstance(axes, str):
                axes = (axes,)
            axes = fit(axes, shape[i] if shape is not None else None)
            used.update(axes)
            if len(axes) == 1:
                resolved[i] = axes[0]
            elif axes:
                resolved[i] = tuple(axes)
        return tuple(resolved)

    def axes_of(self, name: str) -> tuple:
        """The mesh axes (of this mesh) that the rule for ``name`` maps to."""
        axes = self.rules.get(name)
        if axes is None:
            return ()
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in axes if a in self.mesh.axis_names)


def entry_axes(entry) -> tuple:
    """A spec entry as a tuple of mesh axes (None -> ())."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def entry_size(mesh, entry) -> int:
    """Processes a dimension is split over: the product of its axes' sizes."""
    return math.prod(mesh.shape[a] for a in entry_axes(entry))


def local_shape(mesh, spec: tuple, shape: Sequence[int]) -> tuple:
    """The block of ``shape`` that one process holds under ``spec``."""
    out = []
    for entry, n in zip(spec, shape):
        k = entry_size(mesh, entry)
        if n % k:
            raise ValueError(f"dimension {n} does not split over {entry} ({k} processes)")
        out.append(n // k)
    return tuple(out)


def split_axes(rules, logical: Sequence, shape: Sequence[int], dim: int, what: str) -> tuple:
    """The mesh axes that split dimension ``dim`` of a tensor of
    ``logical`` axes and global ``shape`` under ``rules`` (those ``fit``
    keeps).  Raises ``NotImplementedError`` ``"{what} over the mesh axes
    ..."`` where they leave out an axis of more than one process that the
    rule of the dimension's logical name maps to (the dimension does not
    divide it)."""
    mesh = rules.mesh
    axes = entry_axes(rules.spec(*logical, shape=shape)[dim])
    want = tuple(a for a in rules.axes_of(logical[dim]) if mesh.shape[a] > 1)
    if set(want) - set(axes):
        raise NotImplementedError(f"{what} over the mesh axes {want} ({dict(mesh.shape)})")
    return axes


def subgroup(rules, axes: tuple):
    """This process's subgroup over ``axes`` of the rules' mesh, or None
    (no rules, or a subgroup of one process)."""
    if rules is None:
        return None
    sub = rules.mesh.group(axes)
    return None if sub.size == 1 else sub


def group_of(rules, name: str):
    """The process subgroup of the mesh axes (more than one process each)
    that the rule for ``name`` maps to, or None (no rules, or none such)."""
    if rules is None:
        return None
    axes = tuple(a for a in rules.axes_of(name) if rules.mesh.shape[a] > 1)
    return rules.mesh.group(axes) if axes else None


@contextlib.contextmanager
def axis_rules(rules: AxisRules | None):
    """Install ``rules`` for the block (None: none), as the reference's."""
    prev = current()
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def shd(x, *logical: str | None, shape: Sequence[int] | None = None):
    """Check ``x``'s layout against the logical axes (a no-op without
    installed rules); returns ``x``.

    GSPMD constrains a tensor to the spec; the port's tensor is already
    this process's block, so the check is that its local shape is the
    global shape divided as the spec says.  ``shape``: the global shape
    (default: the local shape times the processes every rule's axes
    span, which holds where ``fit`` keeps them all).  Raises ``ValueError``
    on a wrong rank or a wrong local shape."""
    rules = current()
    if rules is None:
        return x
    if x.ndim != len(logical):
        raise ValueError(f"rank {x.ndim} != {len(logical)} logical axes {logical}")
    mesh = rules.mesh
    if shape is None:
        full = rules.spec(*logical)
        shape = tuple(n * entry_size(mesh, e) for n, e in zip(x.shape, full))
    want = local_shape(mesh, rules.spec(*logical, shape=shape), shape)
    if tuple(x.shape) != want:
        raise ValueError(f"a tensor of logical axes {logical} and global shape {tuple(shape)} "
                         f"is {want} a process under {rules.spec(*logical, shape=shape)}, "
                         f"got {tuple(x.shape)}")
    return x


def default_rules(mesh, *, batch_size: int | None = None,
                  seq_parallel: bool = False) -> AxisRules:
    """Production rule set; adapts cache sharding to small-batch decode."""
    has_pod = "pod" in mesh.axis_names
    batch_axes = ("pod", "data") if has_pod else ("data",)
    data_size = mesh.shape["data"] * (mesh.shape["pod"] if has_pod else 1)
    small_batch = batch_size is not None and batch_size < data_size
    rules = {
        "batch": batch_axes,
        # ZeRO-3 + TP hybrid: params/grads/opt-state shard over the model
        # axis too wherever the param has no TP-sharded dim (spec()'s
        # axis-reuse filter drops "model" where TP took it on another dim)
        "fsdp": (*batch_axes, "model"),
        "vocab": "model",
        "heads": "model",
        "kv_heads": None,
        "ffn": "model",
        "experts": "model",
        "embed": None,
        "seq": "model" if seq_parallel else None,
        # flash-decoding: shard the KV-cache length; fold the (idle) data
        # axes in when the batch can't fill them
        "cache_seq": (*batch_axes, "model") if small_batch else ("model",),
        "cache_batch": None if small_batch else batch_axes,
        "state_heads": "model",
    }
    return AxisRules(mesh, rules)


__all__ = ["AbstractMesh", "AxisRules", "axis_rules", "current", "default_rules", "entry_axes",
           "entry_size", "group_of", "local_shape", "shd", "split_axes", "subgroup"]
