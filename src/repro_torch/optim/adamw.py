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
"""

from __future__ import annotations

import dataclasses

import torch

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


def _check(cfg: AdamWCfg) -> None:
    if cfg.moments not in MOMENTS:
        raise ValueError(f"moments={cfg.moments!r}; pick from {MOMENTS}")


def _store(x, mode: str, p: int = 1):
    if mode == "float32":
        return x
    if mode == "bfloat16":
        return x.to(torch.bfloat16)
    return quant.quantize(x, p=p)


def _load(x, mode: str, p: int = 1):
    if mode == "int8":
        return quant.dequantize(x, p=p)
    return x.float()


def init(params: dict, cfg: AdamWCfg, layout: dict | None = None) -> dict:
    """Zero moments (m with the linear code, v with the power-4 code in
    int8) in the reference leaves' layout, and the step counter 0."""
    _check(cfg)
    device = next(iter(params.values())).device

    def zeros(name, p, code):
        z = torch.zeros(_leaf(layout, name, p).shape, dtype=torch.float32, device=device)
        return _store(z, cfg.moments, p=code)

    return {"m": {n: zeros(n, p, 1) for n, p in params.items()},
            "v": {n: zeros(n, p, 4) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: dict):
    """The 2-norm of every tensor of a ``{name: tensor}`` dict together."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree.values()))


@torch.no_grad()
def update(grads: dict, state: dict, params: dict, cfg: AdamWCfg, lr_scale=1.0,
           layout: dict | None = None):
    """Returns (new_params, new_state, {"grad_norm"}): the gradients clipped
    to a global norm of ``grad_clip``, bias-corrected moments, decoupled
    decay, step ``lr * lr_scale``."""
    _check(cfg)
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) if cfg.grad_clip else 1.0
    stepf = step.float()
    c1, c2 = 1 - cfg.b1 ** stepf, 1 - cfg.b2 ** stepf
    new_p, new_m, new_v = {}, {}, {}
    for name, p in params.items():
        leaf = _leaf(layout, name, p)
        g = leaf.to_ref(grads[name]).float() * clip
        mf = _load(state["m"][name], cfg.moments, p=1)
        vf = _load(state["v"][name], cfg.moments, p=4)
        mf = cfg.b1 * mf + (1 - cfg.b1) * g
        vf = cfg.b2 * vf + (1 - cfg.b2) * g * g
        upd = (mf / c1) / (torch.sqrt(vf / c2) + cfg.eps)
        pf = leaf.to_ref(p).float()
        if cfg.weight_decay and leaf.ndim >= 2:   # see the module docstring (F14)
            upd = upd + cfg.weight_decay * pf
        new_p[name] = leaf.from_ref((pf - cfg.lr * lr_scale * upd).to(p.dtype))
        new_m[name] = _store(mf, cfg.moments, p=1)
        new_v[name] = _store(vf, cfg.moments, p=4)
    return new_p, {"m": new_m, "v": new_v, "step": step}, {"grad_norm": gnorm}


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
