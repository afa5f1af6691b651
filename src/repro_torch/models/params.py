"""Parameter specs: shapes, logical axes and init law, in one tree.

The port's twin of the JAX package's ``models/params.py``.  A model builds
a tree (dicts and lists) of :class:`ParamSpec`; from it come the parameter
count (:func:`n_params`, no allocation) and random weights
(:func:`materialize`).  The port runs on one card, so nothing is sharded;
the ``axes`` field stays so that the tree keeps the reference's shape.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .._device import resolve_device

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
    ``(in, out)`` and transposed)."""

    path: tuple
    r: int | None
    shape: tuple[int, ...]
    n_in: int = 0

    @property
    def ndim(self) -> int:
        """The reference leaf's number of axes, its repeat axis included."""
        return len(self.shape) + (self.r is not None)

    def to_ref(self, t: torch.Tensor) -> torch.Tensor:
        """The port's tensor -> one repeat of the reference leaf."""
        return t.T.reshape(self.shape) if self.n_in else t

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
