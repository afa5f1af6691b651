"""Full model: embeddings, the layers, logits, prefill/decode.

The port's twin of the JAX package's ``models/transformer.py``.  The
reference scans homogeneous stacks of layers (``lax.scan`` over a leading
repeat axis, with rematerialization for training); the port holds the
layers one by one in an ``nn.ModuleList``, in ``cfg.layers_flat`` order,
and loops over them.  Its decode caches are a list with one entry per
layer.  The parameter tree of :func:`param_specs` keeps the reference's
stacked shape, so that the same tree is counted, materialized and
converted; :func:`state_from_tree` maps it onto the modules.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .._device import resolve_device
from . import blocks
from . import params as pm
from .layers import rms_norm
from .params import ParamSpec, stack_tree

# reference leaf -> port parameter, and how many leading axes of the leaf
# are the input of the port's nn.Linear (0: kept as it is).  An nn.Linear
# keeps (out, in) where the reference keeps (in..., out...): the leaf is
# flattened to (in, out) and transposed.
MIXER_LEAVES = {"in_proj": ("in_proj.weight", 1), "out_proj": ("out_proj.weight", 1),
                "conv_w": ("conv_w", 0), "conv_b": ("conv_b", 0), "A_log": ("A_log", 0),
                "D": ("D", 0), "dt_bias": ("dt_bias", 0), "norm_w": ("norm_w", 0),
                "wq": ("wq.weight", 1), "wk": ("wk.weight", 1), "wv": ("wv.weight", 1),
                "wo": ("wo.weight", 2), "q_norm": ("q_norm", 0), "k_norm": ("k_norm", 0)}
FFN_LEAVES = {"wi": ("wi.weight", 1), "wo": ("wo.weight", 1)}
# an MoE FFN: the router and the shared experts as nn.Linear, the experts'
# wi (E, d, 2, f) and wo (E, f, d) as they are
MOE_LEAVES = {"router": ("router.weight", 1), "wi": ("wi", 0), "wo": ("wo", 0),
              "shared_wi": ("shared_wi.weight", 1), "shared_wo": ("shared_wo.weight", 1)}


def _to_port(arr, n_in: int):
    """One layer's reference leaf -> the port's parameter (see MIXER_LEAVES
    and MOE_LEAVES)."""
    if not n_in:
        return arr
    return arr.reshape(math.prod(arr.shape[:n_in]), -1).T.contiguous()


def param_specs(cfg) -> dict:
    d = cfg.d_model
    out: dict = {}
    if cfg.vocab:
        out["embed"] = ParamSpec((cfg.padded_vocab, d), ("vocab", "fsdp"))
    out["stacks"] = [
        stack_tree({"layers": [blocks.layer_specs(cfg, l) for l in pattern]}, repeat)
        for pattern, repeat in cfg.stacks
    ]
    out["final_norm"] = ParamSpec((d,), (None,), "zeros" if cfg.gemma_norm else "ones")
    if cfg.vocab and not cfg.tie_embeddings:
        out["head"] = ParamSpec((d, cfg.padded_vocab), ("fsdp", "vocab"))
    if cfg.encoder is not None:
        raise NotImplementedError(
            "encoder-decoder configs are not in the port yet (ROADMAP.md, Queue A item 6)")
    return out


def state_from_tree(cfg, tree) -> dict:
    """The reference's parameter tree (tensors in :func:`param_specs`'
    layout: ``stacks[i]["layers"][j][name]`` with a leading repeat axis,
    ``embed``, ``final_norm``) -> the :class:`Model`'s state dict.

    Every leaf maps to one parameter, transposed where the port keeps an
    ``nn.Linear`` weight; a leaf left over raises (:func:`check_state`
    raises on a parameter left without a leaf or a shape that disagrees)."""
    tree = dict(tree)
    state: dict = {}
    for name in ("embed", "final_norm", "head"):
        if name in tree:
            state[name] = tree.pop(name)
    stacks = list(tree.pop("stacks", []))
    if tree:
        raise ValueError(f"leaves of the tree left over: {sorted(tree)}")
    if len(stacks) != len(cfg.stacks):
        raise ValueError(f"the tree has {len(stacks)} stacks, the config {len(cfg.stacks)}")
    base = 0
    for (pattern, repeat), st in zip(cfg.stacks, stacks):
        st = dict(st)
        layers = st.pop("layers", None)
        if st or layers is None or len(layers) != len(pattern):
            raise ValueError(f"stack holds {sorted(st)} and {layers and len(layers)} layers, "
                             f"expected 'layers' with {len(pattern)}")
        for j, leaf in enumerate(layers):
            leaf = dict(leaf)
            norms = {n: leaf.pop(n) for n in ("ln1", "ln2") if n in leaf}
            ffn_table = MOE_LEAVES if pattern[j].moe else FFN_LEAVES
            groups = {g: (dict(leaf.pop(g, {})), table)
                      for g, table in (("mixer", MIXER_LEAVES), ("ffn", ffn_table))}
            if leaf:
                raise ValueError(f"layer leaves left over: {sorted(leaf)}")
            for g, (sub, table) in groups.items():
                for name, arr in sub.items():
                    if name not in table:
                        raise ValueError(f"{g} leaf left over: {name!r}")
                    if arr.shape[0] != repeat:
                        raise ValueError(f"{g} leaf {name!r} has {arr.shape[0]} repeats, "
                                         f"expected {repeat}")
            for r in range(repeat):
                pre = f"layers.{base + r * len(pattern) + j}."
                for name, arr in norms.items():
                    state[pre + name] = arr[r]
                for g, (sub, table) in groups.items():
                    for name, arr in sub.items():
                        target, n_in = table[name]
                        state[f"{pre}{g}.{target}"] = _to_port(arr[r], n_in)
        base += repeat * len(pattern)
    return state


def _skeleton(module: nn.Module, cfg) -> None:
    """Register the model's parameters on the meta device (no memory)."""
    specs = param_specs(cfg)
    for name in ("embed", "final_norm", "head"):
        if name in specs:
            module.register_parameter(name, nn.Parameter(
                torch.empty(specs[name].shape, device="meta"), requires_grad=False))
    module.layers = nn.ModuleList(blocks.Block(cfg, l) for l in cfg.layers_flat)


def parameter_shapes(cfg) -> dict:
    """``{name: shape}`` of every parameter of ``Model(cfg)``, no allocation."""
    m = nn.Module()
    _skeleton(m, cfg)
    return {n: tuple(p.shape) for n, p in m.named_parameters()}


def check_state(cfg, state: dict) -> None:
    """Raise unless ``state`` holds exactly the model's parameters, each of
    its shape."""
    own = parameter_shapes(cfg)
    missing, extra = sorted(set(own) - set(state)), sorted(set(state) - set(own))
    if missing or extra:
        raise ValueError(f"state: parameters without a value {missing}, values left over {extra}")
    for name, value in state.items():
        if tuple(value.shape) != own[name]:
            raise ValueError(f"state: {name} has shape {tuple(value.shape)}, expected {own[name]}")


class Model(nn.Module):
    """The port's language model for ``cfg`` (layers it implements only).

    ``state``: a state dict (from :func:`state_from_tree` or
    ``convert.params_from_reference``), used in its own dtype; without one
    the weights are drawn by :func:`~repro_torch.models.params.materialize`
    from ``generator``, in ``dtype`` (default ``cfg.dtype``).  Runs on ``device`` (default the
    CUDA card; ``device="cpu"`` for the plain path).  The parameters do
    not require gradients: the port serves; training comes later."""

    def __init__(self, cfg, state: dict | None = None, *, generator: torch.Generator | None = None,
                 dtype=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        _skeleton(self, cfg)
        if state is None:
            if generator is None:
                raise ValueError("Model needs a state or an explicit torch.Generator for "
                                 "random weights")
            dtype = dtype or getattr(torch, cfg.dtype)
            state = state_from_tree(cfg, pm.materialize(param_specs(cfg), generator, dtype, device))
        check_state(cfg, state)
        for name, value in state.items():
            mod, _, leaf = name.rpartition(".")
            setattr(self.get_submodule(mod) if mod else self, leaf,
                    nn.Parameter(torch.as_tensor(value, device=device), requires_grad=False))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def forward(self, tokens, *, mode: str = "train", caches=None, use_kernel: str = "auto"):
        return fwd(self, tokens, mode=mode, caches=caches, use_kernel=use_kernel)


def embed_tokens(model: Model, cfg, tokens):
    x = model.embed[tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def fwd(model: Model, inputs, *, mode, positions=None, caches=None, cache_len=None,
        use_kernel: str = "auto"):
    """Backbone forward.

    inputs: int tokens (B, T) if cfg.vocab else embeddings (B, T, d).
    positions: (T,) absolute positions, an int tensor on the model's device
    (default ``arange(T)``; decode: ``[pos]``).  caches: list (one entry per
    layer) of cache dicts, or None.  cache_len: the attention layers' cache
    length at prefill (default T).  Returns (hidden (B, T, d), new_caches,
    aux)."""
    cfg = model.cfg
    x = embed_tokens(model, cfg, inputs) if cfg.vocab else inputs
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    new_caches = [] if (caches is not None or mode == "prefill") else None
    aux = x.new_zeros((), dtype=torch.float32)
    for i, (layer, block) in enumerate(zip(cfg.layers_flat, model.layers)):
        x, c, a = blocks.layer_fwd(block, cfg, layer, x, mode=mode, positions=positions,
                                   cache=None if caches is None else caches[i],
                                   cache_len=cache_len, use_kernel=use_kernel)
        aux = aux + a
        if new_caches is not None:
            new_caches.append(c)
    x = rms_norm(x, model.final_norm, cfg.norm_eps, scale_plus_one=cfg.gemma_norm)
    return x, new_caches, aux


def lm_head_matrix(model: Model):
    return model.embed.T if model.cfg.tie_embeddings else model.head


def logits_fn(model: Model, h):
    """float32 logits; the pad rows of ``padded_vocab`` are set to -1e30."""
    cfg = model.cfg
    logits = (h @ lm_head_matrix(model)).float()
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    if cfg.padded_vocab != cfg.vocab:  # mask the padding rows
        valid = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
        logits = torch.where(valid, logits, logits.new_full((), -1e30))
    return logits


# ---------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------

def cache_specs(cfg, batch: int, cache_len: int, dtype=torch.bfloat16) -> list:
    """Per layer, the decode cache's shapes and dtype as meta tensors."""
    return [blocks.layer_cache_specs(cfg, l, batch, cache_len, dtype) for l in cfg.layers_flat]


def prefill(model: Model, tokens, *, cache_len=None, use_kernel: str = "auto"):
    """Process the prompt; returns (last-token logits (B, V), caches).
    ``cache_len``: the length of the global attention layers' KV caches
    (default the prompt's; a window layer keeps ``min(window, cache_len)``
    slots)."""
    h, caches, _ = fwd(model, tokens, mode="prefill", cache_len=cache_len,
                       use_kernel=use_kernel)
    logits = logits_fn(model, h[:, -1:])
    return logits[:, 0], caches


def decode_step(model: Model, token, pos, caches, *, use_kernel: str = "auto"):
    """One decode step.  token: (B, 1) ids; pos: its position, an int or a
    0-d tensor (unused by the Mamba layers).  Returns (logits (B, V),
    caches)."""
    pos = torch.as_tensor(pos, dtype=torch.long, device=token.device).reshape(1)
    h, caches, _ = fwd(model, token, mode="decode", positions=pos, caches=caches,
                       use_kernel=use_kernel)
    return logits_fn(model, h)[:, -1], caches
