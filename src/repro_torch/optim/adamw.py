"""AdamW with selectable moment storage: float32 | bfloat16 | int8 (blockwise).

The port's twin of the JAX package's ``optim/adamw.py``.  Functional, as
the reference is: :func:`update` returns new tensors and leaves the ones
it was given as they are, so a caller can drop a step (the Trainer's NaN
guard does).  The step counter, the clip factor and the bias corrections
stay 0-d tensors on the device: an update reads nothing to the host.

The parameters are the port's ``{name: tensor}`` dict.  ``layout`` (from
:func:`repro_torch.models.transformer.reference_layout`) says, for each
name, where the tensor sits in the reference's stacked parameter tree
(:class:`repro_torch.models.params.RefLeaf`).  The optimizer keeps every
moment in the reference leaf's layout, one repeat of it: ``wq``'s moments
are ``(d, H, Dh)`` where the port's weight is ``(H Dh, d)``.  So the int8
blocks run along the reference leaf's last axis, and the codes are the
reference's.  Weight decay goes to every parameter whose *reference* leaf
has two axes or more: the reference stacks each layer's leaves along a
repeat axis, so its per-layer norms and Mamba vectors are decayed and
only ``final_norm`` is not (ROADMAP.md, F14; the port reproduces it).
Without a ``layout`` every tensor is its own reference leaf.

Under installed sharding rules (:mod:`repro_torch.distributed.sharding`)
every leaf is this process's block: the parameters, the gradients and
the moments each hold the block that :func:`state_shardings` gives (the
reference's ``state_shardings``); int8 moments keep the whole leaf's
blocks of 128 (``quant.QuantShard``).  :func:`global_norm` sums over the
processes and counts each element of a replicated leaf once, so that
``grad_clip`` scales every process's update alike, and a replicated
leaf, whose gradient every process holds alike, stays bitwise the same on
each.
"""

from __future__ import annotations

import dataclasses

import torch


from ..core import comm
from ..distributed import sharding
from ..models import params as pm
from ..models.params import RefLeaf
from . import quant

MOMENTS = ("float32", "bfloat16", "int8")


@dataclasses.dataclass(frozen=True)
class AdamWCfg:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moments: str = "float32"     # float32 | bfloat16 | int8


def _leaf(layout, name, t) -> RefLeaf:
    return RefLeaf((name,), None, tuple(t.shape)) if layout is None else layout[name]


def _moment_specs(leaf: RefLeaf, cfg: "AdamWCfg", rules):
    """A moment's spec (int8: ``{"q", "s"}``'s), as the reference's
    ``state_shardings`` gives it."""
    if cfg.moments == "int8":
        (qs, qa), (ss, sa) = quant.quant_specs(leaf.shape, pm.logical_axes(leaf))
        return {"q": rules.spec(*qa, shape=qs), "s": rules.spec(*sa, shape=ss)}
    return pm.spec(leaf, rules)


def _quant_shard(leaf: RefLeaf, rules):
    """How this process's block of an int8 moment sits in the whole leaf
    (None without rules)."""
    if rules is None:
        return None
    mesh = rules.mesh
    (qs, qa), (ss, sa) = quant.quant_specs(leaf.shape, pm.logical_axes(leaf))
    q_sp, s_sp = rules.spec(*qa, shape=qs), rules.spec(*sa, shape=ss)
    extra = []
    for dim, (eq, es) in enumerate(zip(q_sp[:-1], s_sp[:-1])):
        eq, es = sharding.entry_axes(eq), sharding.entry_axes(es)
        if es == eq:
            continue
        if es[:len(eq)] != eq:
            raise NotImplementedError(f"{leaf.path}: int8 scales split as {s_sp}, the codes as "
                                      f"{q_sp}")
        extra.append((dim, mesh.group(es[len(eq):])))
    last = q_sp[-1]
    n_local = leaf.shape[-1] // sharding.entry_size(mesh, last)
    return quant.QuantShard(off=mesh.index(last) * n_local, n=leaf.shape[-1],
                            last=mesh.group(last), extra=tuple(extra))


def _check(cfg: AdamWCfg) -> None:
    if cfg.moments not in MOMENTS:
        raise ValueError(f"moments={cfg.moments!r}; pick from {MOMENTS}")


def _store(x, mode: str, p: int = 1, shard=None):
    if mode == "float32":
        return x
    if mode == "bfloat16":
        return x.to(torch.bfloat16)
    return quant.quantize(x, p=p, shard=shard)


def _load(x, mode: str, p: int = 1, shard=None):
    if mode == "int8":
        return quant.dequantize(x, p=p, shard=shard)
    return x.float()


def init(params: dict, cfg: AdamWCfg, layout: dict | None = None) -> dict:
    """Zero moments (m with the linear code, v with the power-4 code in
    int8) in the reference leaves' layout, and the step counter 0 (under
    sharding rules: this process's blocks)."""
    _check(cfg)
    device = next(iter(params.values())).device
    rules = sharding.current() if layout is not None else None

    def zeros(name, p, code):
        leaf = _leaf(layout, name, p)
        shape = pm.local(leaf, rules).shape if rules is not None else leaf.shape
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        return _store(z, cfg.moments, p=code,
                      shard=_quant_shard(leaf, rules) if cfg.moments == "int8" else None)

    return {"m": {n: zeros(n, p, 1) for n, p in params.items()},
            "v": {n: zeros(n, p, 4) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: dict, layout: dict | None = None):
    """The 2-norm of every tensor of a ``{name: tensor}`` dict together.

    Under sharding rules, with the ``layout`` of the tree's leaves, the
    tensors are this process's blocks: each process adds the squares of
    the blocks it owns (those it holds at coordinate 0 of every mesh axis
    the leaf is not split over, so a replicated element counts once) and
    a sum over every process gives all of them the same value."""
    rules = sharding.current() if layout is not None else None
    if rules is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree.values()))
    mesh = rules.mesh
    total = None
    for name, x in tree.items():
        split = {a for e in pm.spec(layout[name], rules) for a in sharding.entry_axes(e)}
        if any(mesh.coords[a] for a in mesh.axis_names if a not in split):
            continue
        part = torch.sum(torch.square(x.float()))
        total = part if total is None else total + part
    if total is None:
        total = torch.zeros((), device=next(iter(tree.values())).device)
    return torch.sqrt(comm.sum_over(total, mesh.group(mesh.axis_names)))


@torch.no_grad()
def update(grads: dict, state: dict, params: dict, cfg: AdamWCfg, lr_scale=1.0,
           layout: dict | None = None):
    """Returns (new_params, new_state, {"grad_norm"}): the gradients clipped
    to a global norm of ``grad_clip``, bias-corrected moments, decoupled
    decay, step ``lr * lr_scale``."""
    _check(cfg)
    rules = sharding.current() if layout is not None else None
    step = state["step"] + 1
    gnorm = global_norm(grads, layout)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) if cfg.grad_clip else 1.0
    stepf = step.float()
    c1, c2 = 1 - cfg.b1 ** stepf, 1 - cfg.b2 ** stepf
    new_p, new_m, new_v = {}, {}, {}
    for name, p in params.items():
        full = _leaf(layout, name, p)
        leaf = pm.local(full, rules) if rules is not None else full
        qsh = _quant_shard(full, rules) if cfg.moments == "int8" else None
        g = leaf.to_ref(grads[name]).float() * clip
        mf = _load(state["m"][name], cfg.moments, p=1, shard=qsh)
        vf = _load(state["v"][name], cfg.moments, p=4, shard=qsh)
        mf = cfg.b1 * mf + (1 - cfg.b1) * g
        vf = cfg.b2 * vf + (1 - cfg.b2) * g * g
        upd = (mf / c1) / (torch.sqrt(vf / c2) + cfg.eps)
        pf = leaf.to_ref(p).float()
        if cfg.weight_decay and leaf.ndim >= 2:   # see the module docstring (F14)
            upd = upd + cfg.weight_decay * pf
        new_p[name] = leaf.from_ref((pf - cfg.lr * lr_scale * upd).to(p.dtype))
        new_m[name] = _store(mf, cfg.moments, p=1, shard=qsh)
        new_v[name] = _store(vf, cfg.moments, p=4, shard=qsh)
    return new_p, {"m": new_m, "v": new_v, "step": step}, {"grad_norm": gnorm}


def state_shardings(layout: dict, cfg: AdamWCfg, rules) -> dict:
    """The spec of every leaf of the optimizer state under ``rules``, the
    reference's ``state_shardings``: each moment as its parameter's
    reference leaf (int8: ``q`` so, ``s`` with its block axis unsharded),
    the step counter replicated (``()``)."""
    _check(cfg)
    one = {n: _moment_specs(leaf, cfg, rules) for n, leaf in layout.items()}
    return {"m": one, "v": dict(one), "step": ()}


def state_specs(layout: dict, cfg: AdamWCfg) -> dict:
    """The optimizer state's shapes and dtypes as meta tensors (no memory),
    for the parameters of ``layout``."""
    _check(cfg)

    def one(leaf):
        if cfg.moments == "int8":
            (qs, _), (ss, _) = quant.quant_specs(leaf.shape, (None,) * len(leaf.shape))
            return {"q": torch.empty(qs, dtype=torch.int8, device="meta"),
                    "s": torch.empty(ss, dtype=torch.float32, device="meta")}
        dt = torch.bfloat16 if cfg.moments == "bfloat16" else torch.float32
        return torch.empty(leaf.shape, dtype=dt, device="meta")

    return {"m": {n: one(l) for n, l in layout.items()},
            "v": {n: one(l) for n, l in layout.items()},
            "step": torch.empty((), dtype=torch.int32, device="meta")}
