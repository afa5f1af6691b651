"""Parameter specs: shapes, logical axes and init law, in one tree.

The port's twin of the JAX package's ``models/params.py``.  A model builds
a tree (dicts and lists) of :class:`ParamSpec`; from it come the parameter
count (:func:`n_params`, no allocation) and random weights
(:func:`materialize`).  The ``axes`` of a spec are the reference's
logical axes: under a rule set (:mod:`repro_torch.distributed.sharding`)
they give each leaf's spec over a process mesh, the reference's
``shardings`` of the stacked leaf without its repeat axis, read in the
reference leaf's layout (:class:`RefLeaf`).  :func:`shard` keeps each
process's block of every parameter and :func:`gather` is its inverse;
:func:`fsdp_gather` is the model's gather of one weight before its layer
runs (ZeRO-3: the ``fsdp`` dimensions; the tensor-parallel ones stay
split); :class:`Placement` places a stored array for the checkpoints.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .._device import resolve_device
from ..core import comm
from ..distributed.sharding import entry_axes, entry_size, local_shape

STD = {"normal": 0.02, "small_normal": 0.006}
DRAW_CHUNK = 1 << 30   # values drawn at once by materialize (4 GiB in float32)


@dataclasses.dataclass(frozen=True)
class RefLeaf:
    """Where one of the port's parameters sits in the reference's parameter
    tree: ``path`` of the leaf (dict keys and list indices), ``r`` the
    index along its leading repeat axis (None: a leaf without one),
    ``shape`` one repeat's shape, ``n_in`` how many leading axes of it are
    the input of the port's ``nn.Linear`` (0: the port keeps the leaf's own
    layout; otherwise the port's weight is the leaf flattened to
    ``(in, out)`` and transposed), ``axes`` the logical axes of one repeat
    (the reference spec's, its repeat axis left out; empty: none named)."""

    path: tuple
    r: int | None
    shape: tuple[int, ...]
    n_in: int = 0
    axes: tuple = ()

    @property
    def ndim(self) -> int:
        """The reference leaf's number of axes, its repeat axis included."""
        return len(self.shape) + (self.r is not None)

    def to_ref(self, t: torch.Tensor) -> torch.Tensor:
        """The port's tensor -> one repeat of the reference leaf."""
        return t.T.reshape(self.shape) if self.n_in else t

    @property
    def port_shape(self) -> tuple:
        """The shape of the port's tensor of one repeat."""
        if not self.n_in:
            return tuple(self.shape)
        return (math.prod(self.shape[self.n_in:]), math.prod(self.shape[:self.n_in]))

    def from_ref(self, a: torch.Tensor) -> torch.Tensor:
        """One repeat of the reference leaf -> the port's tensor."""
        if not self.n_in:
            return a
        return a.reshape(math.prod(self.shape[:self.n_in]), -1).T.contiguous()


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones | small_normal
    std: float | None = None  # override for normal

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def tree_map(fn, tree):
    """``fn`` on every leaf of a tree of dicts and lists (a spec tree:
    the leaves are :class:`ParamSpec`; a parameter tree: tensors)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def specs_list(tree) -> list[ParamSpec]:
    """The leaves in the tree's order (dict keys in insertion order)."""
    out: list = []
    tree_map(out.append, tree)
    return out


def stack(spec: ParamSpec, n: int) -> ParamSpec:
    """Prepend a layer-stacking axis (never sharded)."""
    return ParamSpec((n, *spec.shape), (None, *spec.axes), spec.init, spec.std)


def stack_tree(tree, n: int):
    return tree_map(lambda s: stack(s, n), tree)


def n_params(tree) -> int:
    return int(sum(math.prod(s.shape) for s in specs_list(tree)))


def materialize(tree, generator: torch.Generator, dtype, device=None):
    """Random tensors for every spec, drawn from ``generator`` in the tree's
    order: normal (std 0.02 or the spec's), small_normal (std 0.006) drawn
    in float32 pieces of at most ``DRAW_CHUNK`` values and cast to
    ``dtype``; zeros and ones.  ``generator`` must
    live on ``device`` (``None``: the CUDA card)."""
    device = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        raise TypeError("materialize needs an explicit torch.Generator")
    if generator.device.type != device.type:
        raise ValueError(f"the generator lives on {generator.device}, the tensors on {device}")
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype

    def init_one(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dtype, device=device)
        std = s.std if s.std is not None else STD[s.init]
        # drawn in float32 pieces of DRAW_CHUNK values, each cast into place,
        # so that no float32 copy of a leaf larger than one piece (an MoE
        # layer's experts) is ever held
        n = math.prod(s.shape)
        out = torch.empty(s.shape, dtype=dtype, device=device)
        flat = out.view(-1)
        for i in range(0, n, DRAW_CHUNK):
            m = min(DRAW_CHUNK, n - i)
            flat[i:i + m] = torch.randn(m, generator=generator, dtype=torch.float32,
                                        device=device).mul_(std)
        return out

    return tree_map(init_one, tree)


# ---------------------------------------------------------------------
# sharding over a process mesh (ZeRO-3 with tensor parallelism)
# ---------------------------------------------------------------------

def logical_axes(leaf: RefLeaf) -> tuple:
    """The logical axes of one repeat of the leaf (None for each where none
    are named)."""
    return leaf.axes if leaf.axes else (None,) * len(leaf.shape)


def spec(leaf: RefLeaf, rules) -> tuple:
    """The leaf's spec under ``rules``, one entry per axis of one repeat of
    the reference leaf: the reference's ``shardings`` entry of the stacked
    leaf without its (never sharded) repeat axis."""
    return rules.spec(*logical_axes(leaf), shape=leaf.shape)


def local(leaf: RefLeaf, rules) -> RefLeaf:
    """The leaf as one process holds it: its block of one repeat."""
    return dataclasses.replace(leaf, shape=local_shape(rules.mesh, spec(leaf, rules), leaf.shape))


def served(leaf: RefLeaf, rules, whole: bool = False) -> RefLeaf:
    """The leaf as :func:`fsdp_gather` gives it to one process: its
    ``fsdp`` dimensions whole, the others its block (``whole``: every
    dimension whole)."""
    sp = spec(leaf, rules)
    shape = tuple(n if whole or name == "fsdp" else n // entry_size(rules.mesh, e)
                  for name, e, n in zip(logical_axes(leaf), sp, leaf.shape))
    return dataclasses.replace(leaf, shape=shape)


def block_slices(sp: tuple, shape, mesh, index=None) -> tuple:
    """The slices of ``shape`` that the process at mesh ``index`` (a
    function of the axes, default this process's :meth:`Mesh.index`)
    holds under ``sp``."""
    index = mesh.index if index is None else index
    out = []
    for entry, n in zip(sp, shape):
        k = math.prod(mesh.shape[a] for a in entry_axes(entry))
        b = n // k
        i = index(entry)
        out.append(slice(i * b, (i + 1) * b))
    return tuple(out)


def _gathered(ref: torch.Tensor, sp: tuple, mesh, dims) -> torch.Tensor:
    for i in dims:
        ref = comm.gather_over(ref, mesh.group(sp[i]), i)
    return ref


def shard(params: dict, rules, layout: dict) -> dict:
    """Each process's block of every parameter (``params`` whole, in the
    port's layout; ``layout`` from ``transformer.reference_layout``): the
    block of the reference leaf's layout that the spec gives this
    process's coordinates, in the port's layout of that block."""
    out = {}
    for name, t in params.items():
        leaf = layout[name]
        block = leaf.to_ref(t)[block_slices(spec(leaf, rules), leaf.shape, rules.mesh)]
        out[name] = local(leaf, rules).from_ref(block.contiguous())
    return out


def gather(params: dict, rules, layout: dict) -> dict:
    """The inverse of :func:`shard`: every parameter whole on every process
    (collective: all-gathers over each sharded dimension's subgroup)."""
    out = {}
    for name, t in params.items():
        leaf, sp = layout[name], spec(layout[name], rules)
        ref = _gathered(local(leaf, rules).to_ref(t), sp, rules.mesh,
                        [i for i, e in enumerate(sp) if e is not None])
        out[name] = leaf.from_ref(ref.contiguous())
    return out


def fsdp_axes(leaf: RefLeaf, rules) -> tuple:
    """The mesh axes a leaf's ``fsdp`` dimensions are split over: what
    :func:`fsdp_gather` gathers, and what its backward's reduce-scatter
    sums the gradient over."""
    sp = spec(leaf, rules)
    return tuple(a for name, e in zip(logical_axes(leaf), sp) if name == "fsdp"
                 for a in entry_axes(e))


def fsdp_gather(t: torch.Tensor, leaf: RefLeaf, rules, partial_over: tuple = (),
                whole: bool = False) -> torch.Tensor:
    """ZeRO-3's gather of one weight before its layer: this process's block
    ``t`` with its ``fsdp`` dimensions all-gathered (the tensor-parallel
    ones stay split; ``whole``: every dimension gathered), in the port's
    layout.  Differentiable: the gradient leaves through the gather's
    reduce-scatter, summed over those axes.

    ``partial_over``: mesh axes over which this process's gradient of the
    weight is a partial one (a weight replicated inside the
    tensor-parallel region, such as ``q_norm``, or the kv projections,
    whose heads are shared out): where the gather does not sum over them,
    the weight passes through ``comm.copy_to``, whose backward does."""
    if rules is None:
        return t
    mesh, sp = rules.mesh, spec(leaf, rules)
    dims = [i for i, name in enumerate(logical_axes(leaf))
            if sp[i] is not None and (whole or name == "fsdp")]
    out = t
    if dims:
        ref = _gathered(local(leaf, rules).to_ref(t), sp, mesh, dims)
        out = dataclasses.replace(leaf, shape=tuple(ref.shape)).from_ref(ref)
    done = tuple(a for i in dims for a in entry_axes(sp[i]))
    extra = tuple(a for a in partial_over if a not in done and mesh.shape[a] > 1)
    return comm.copy_to(out, mesh.group(extra)) if extra else out


def grad_sum_axes(leaf: RefLeaf, rules) -> tuple:
    """The mesh axes over which a leaf's gradient is still to be summed
    after the backward: the batch axes its ``fsdp`` reduce-scatter did not
    cover (a replicated leaf: all of them)."""
    done = fsdp_axes(leaf, rules)
    return tuple(a for a in rules.axes_of("batch")
                 if a not in done and rules.mesh.shape[a] > 1)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one stored array sits on a mesh: ``sp`` its spec in the layout
    of one repeat of the reference leaf, ``leaf`` the :class:`RefLeaf`
    when the array is the port's tensor of that leaf (None: the array is
    in the reference leaf's layout, as the optimizer's moments are)."""

    sp: tuple
    rules: object
    leaf: RefLeaf | None = None

    def block(self, a) -> torch.Tensor:
        """This process's block of the whole array ``a`` (NumPy, a memory
        map of which only the block is read where no transposition is
        needed, or torch)."""
        mesh = self.rules.mesh
        if self.leaf is None:
            b = a[block_slices(self.sp, a.shape, mesh)]
            return torch.from_numpy(np.ascontiguousarray(b)) if isinstance(b, np.ndarray) \
                else b.contiguous()
        t = torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a
        ref = self.leaf.to_ref(t)[block_slices(self.sp, self.leaf.shape, mesh)]
        loc = dataclasses.replace(self.leaf, shape=tuple(ref.shape))
        return loc.from_ref(ref.contiguous())

    def outgoing(self, t: torch.Tensor):
        """``(block, subgroup)`` that :meth:`assemble` needs of this
        process's tensor ``t``: its block in the reference leaf's layout and
        the processes that hold distinct blocks (rank 0's subgroup over the
        spec's axes)."""
        mesh = self.rules.mesh
        if self.leaf is not None:
            t = dataclasses.replace(
                self.leaf, shape=local_shape(mesh, self.sp, self.leaf.shape)).to_ref(t)
        return t.contiguous(), mesh.group(tuple(a for e in self.sp for a in entry_axes(e)))

    def assemble(self, parts):
        """The whole array on rank 0 from the blocks ``comm.gather_to_first``
        brought it for :meth:`outgoing` (None on the other processes)."""
        if parts is None:
            return None
        mesh = self.rules.mesh
        axes = tuple(a for e in self.sp for a in entry_axes(e))
        full_shape = tuple(n * math.prod(mesh.shape[a] for a in entry_axes(e))
                           for n, e in zip(parts[0].shape, self.sp))
        out = torch.empty(full_shape, dtype=parts[0].dtype)
        sizes = [mesh.shape[a] for a in axes]
        for k, part in enumerate(parts):
            coords = dict(zip(axes, np.unravel_index(k, sizes) if sizes else ()))

            def index(entry, coords=coords):
                i = 0
                for a in entry_axes(entry):
                    i = i * mesh.shape[a] + int(coords[a])
                return i

            out[block_slices(self.sp, full_shape, mesh, index)] = part.cpu()
        return out if self.leaf is None else self.leaf.from_ref(out)
