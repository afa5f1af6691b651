"""Full model: embeddings, the layers, logits, the loss, prefill/decode.

The port's twin of the JAX package's ``models/transformer.py``.  The
reference scans homogeneous stacks of layers (``lax.scan`` over a leading
repeat axis, with rematerialization for training); the port holds the
layers one by one in an ``nn.ModuleList``, in ``cfg.layers_flat`` order,
and loops over them.  Its decode caches are a list with one entry per
layer.  The parameter tree of :func:`param_specs` keeps the reference's
stacked shape, so that the same tree is counted, materialized and
converted; :func:`state_from_tree` maps it onto the modules and
:func:`reference_layout` says where each of the port's parameters sits in
it.

Serving (:class:`Model`, :func:`prefill`, :func:`decode_step`) builds no
autograd graph: the model's parameters do not require gradients and
prefill and decode run under ``torch.inference_mode()``.  Training
(:func:`loss_fn`) takes the parameters as a ``{name: tensor}`` dict and
runs the same forward on them through ``torch.func.functional_call``, each
layer under ``torch.utils.checkpoint`` as ``remat`` says
(:data:`REMAT_POLICIES`).

Under installed sharding rules (:mod:`repro_torch.distributed.sharding`),
in training, the parameters are each process's blocks
(``params.shard``) and the batch its rows: every layer's ``fsdp``
dimensions are gathered just before it runs, inside its checkpoint, so
that remat ``"full"`` gathers again in the backward rather than keeping
the whole weights (ZeRO-3); the embedding is gathered once a step and
split by vocabulary, each process looking up the ids in its range and a
sum over the vocabulary's processes joining the rows; the same table is
the tied head of the vocabulary-parallel loss.

Serving under rules (:func:`prefill`, :func:`decode_step`, as the
reference's ``launch/build.py`` installs them: ``seq_parallel`` at
prefill) runs on the model of :func:`serving_model`, whose weights have
their ``fsdp`` dimensions gathered once (the tensor-parallel split kept),
so that no step gathers a weight.  Prefill takes the global prompt and
keeps this process's rows; under sequence parallelism the hidden state
between layers is this process's block of the tokens.  Every process keeps
its block of each cache leaf (:func:`cache_shardings`), and the logits are
its rows' block of the vocabulary.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from .._device import resolve_device
from ..core import comm
from ..data.pipeline import local_rows
from ..distributed import sharding
from . import attention, blocks, moe, ssm
from . import params as pm
from .layers import cross_entropy_chunked, rms_norm
from .params import ParamSpec, RefLeaf, stack_tree

# reference leaf -> port parameter, and how many leading axes of the leaf
# are the input of the port's nn.Linear (0: kept as it is).  An nn.Linear
# keeps (out, in) where the reference keeps (in..., out...): the leaf is
# flattened to (in, out) and transposed (RefLeaf.from_ref).
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


def _saving(*ops):
    """A checkpoint ``context_fn`` that saves the outputs of ``ops`` and
    recomputes everything else."""
    ops = frozenset(ops)

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


_aten = torch.ops.aten
# remat policy -> the ``context_fn`` of each layer's non-reentrant checkpoint
# (None: no checkpoint).  The reference's jax policies: "full" saves nothing
# (nothing_saveable), "dots" every matmul output (checkpoint_dots), and
# "dots_no_batch" those of the products without a batch axis.
REMAT_POLICIES = {
    "none": None,
    "full": noop_context_fn,
    "dots": _saving(_aten.mm.default, _aten.addmm.default, _aten.bmm.default),
    "dots_no_batch": _saving(_aten.mm.default, _aten.addmm.default),
}


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


def _flat(tree, path=()) -> dict:
    """``{path: leaf}`` of a tree of dicts and lists (paths of keys and list
    indices, as :class:`RefLeaf` keeps them)."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _flat(sub, path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, sub in enumerate(tree) for p, v in _flat(sub, path + (i,)).items()}
    return {path: tree}


def state_from_tree(cfg, tree) -> dict:
    """The reference's parameter tree (tensors in :func:`param_specs`'
    layout: ``stacks[i]["layers"][j][name]`` with a leading repeat axis,
    ``embed``, ``final_norm``) -> the :class:`Model`'s state dict, as
    :func:`reference_layout` maps it.

    Every leaf maps to one parameter, transposed where the port keeps an
    ``nn.Linear`` weight; a leaf left over, or one with another number of
    repeats, raises (:func:`check_state` raises on a parameter left without
    a leaf or a shape that disagrees)."""
    by_path: dict = {}
    for name, leaf in reference_layout(cfg).items():
        by_path.setdefault(leaf.path, []).append((name, leaf))
    flat = _flat(tree)
    extra = sorted("/".join(map(str, p)) for p in flat if p not in by_path)
    if extra:
        raise ValueError(f"leaves of the tree left over: {extra}")
    state: dict = {}
    for path, arr in flat.items():
        entries = by_path[path]
        if entries[0][1].r is not None and arr.shape[0] != len(entries):
            raise ValueError(f"leaf {'/'.join(map(str, path))} has {arr.shape[0]} repeats, "
                             f"expected {len(entries)}")
        for name, leaf in entries:
            state[name] = leaf.from_ref(arr if leaf.r is None else arr[leaf.r])
    return state


def reference_layout(cfg) -> dict:
    """``{name: RefLeaf}``: for each of the port's parameters, its leaf of
    the reference's tree (:func:`param_specs`), its repeat index there and
    how the port's tensor maps onto one repeat of the leaf
    (:class:`~repro_torch.models.params.RefLeaf`)."""
    specs = param_specs(cfg)
    out = {name: RefLeaf((name,), None, specs[name].shape, axes=specs[name].axes)
           for name in ("embed", "final_norm", "head") if name in specs}
    base = 0
    for si, (pattern, repeat) in enumerate(cfg.stacks):
        for j, leaf in enumerate(specs["stacks"][si]["layers"]):
            ffn_table = MOE_LEAVES if pattern[j].moe else FFN_LEAVES
            for r in range(repeat):
                pre = f"layers.{base + r * len(pattern) + j}."
                for key, sub in leaf.items():
                    path = ("stacks", si, "layers", j, key)
                    if isinstance(sub, ParamSpec):   # ln1, ln2
                        out[pre + key] = RefLeaf(path, r, sub.shape[1:], axes=sub.axes[1:])
                        continue
                    table = MIXER_LEAVES if key == "mixer" else ffn_table
                    for name, spec in sub.items():
                        target, n_in = table[name]
                        out[f"{pre}{key}.{target}"] = RefLeaf(path + (name,), r, spec.shape[1:],
                                                              n_in, spec.axes[1:])
        base += repeat * len(pattern)
    return out


# train mode under rules that map "seq" (the reference's dry-run train cells of
# launch/build.py) comes with the port of launch/ ...
SERVE_SHARDED = "ROADMAP.md, Queue A item 6 (launch/: train mode under rules that map seq)"
# ... and no reference path runs context parallelism under installed rules
# (its distributed/context_parallel.py runs with the parameters replicated)
SEQ_AXIS_SHARDED = ("seq_axis (context parallelism) under sharding rules: no reference path "
                    "combines them; context parallelism runs with the parameters replicated")
# reference_layout, made once per config (the sharded paths read it every step)
layout_of = functools.lru_cache(maxsize=None)(reference_layout)


def init_params(cfg, generator: torch.Generator, dtype=torch.float32, device=None) -> dict:
    """Random parameters to train: the reference's init law
    (:func:`~repro_torch.models.params.materialize` from ``generator``) in
    the port's ``{name: tensor}`` layout, the dict :func:`loss_fn` and the
    optimizer take (and a :class:`Model` serves)."""
    device = resolve_device(device)
    return state_from_tree(cfg, pm.materialize(param_specs(cfg), generator, dtype, device))


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


def state_shapes(cfg, rules=None, served: bool = False) -> dict:
    """``{name: shape}`` of every parameter as a :class:`Model` holds it:
    whole (no rules), this process's blocks under ``rules``
    (``params.local``), or, ``served``, each weight with its ``fsdp``
    dimensions gathered (a Mamba layer's ``in_proj`` whole;
    ``params.served``)."""
    if rules is None:
        return parameter_shapes(cfg)
    out = {}
    for name, leaf in layout_of(cfg).items():
        if served:
            out[name] = pm.served(leaf, rules, whole=name.endswith(WHOLE)).port_shape
        else:
            out[name] = pm.local(leaf, rules).port_shape
    return out


def check_state(cfg, state: dict, rules=None, served: bool = False) -> None:
    """Raise unless ``state`` holds exactly the model's parameters, each of
    its shape (:func:`state_shapes`)."""
    own = state_shapes(cfg, rules, served)
    missing, extra = sorted(set(own) - set(state)), sorted(set(state) - set(own))
    if missing or extra:
        raise ValueError(f"state: parameters without a value {missing}, values left over {extra}")
    for name, value in state.items():
        if tuple(value.shape) != tuple(own[name]):
            raise ValueError(f"state: {name} has shape {tuple(value.shape)}, expected "
                             f"{tuple(own[name])}")


# the weight a tensor-parallel Mamba layer gathers whole (ssm._local)
WHOLE = "mixer.in_proj.weight"


class Model(nn.Module):
    """The port's language model for ``cfg`` (layers it implements only).

    ``state``: a state dict (from :func:`state_from_tree` or
    ``convert.params_from_reference``), used in its own dtype; without one
    the weights are drawn by :func:`~repro_torch.models.params.materialize`
    from ``generator``, in ``dtype`` (default ``cfg.dtype``).  Runs on ``device`` (default the
    CUDA card; ``device="cpu"`` for the plain path).  The parameters do
    not require gradients (serving; training takes a ``{name: tensor}``
    dict, :func:`loss_fn`).

    Built under installed sharding rules (``self.rules``), the model holds
    this process's blocks (``params.shard`` of the whole state; random
    weights are drawn whole and sharded); ``served``: the state holds the
    weights of :func:`serving_model` (each ``fsdp`` dimension gathered)."""

    def __init__(self, cfg, state: dict | None = None, *, generator: torch.Generator | None = None,
                 dtype=None, device=None, served: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.rules = sharding.current()
        self.served = served
        if served and (self.rules is None or state is None):
            raise ValueError("a served model is built from the gathered weights of "
                             "serving_model, under sharding rules")
        _skeleton(self, cfg)
        if state is None:
            if generator is None:
                raise ValueError("Model needs a state or an explicit torch.Generator for "
                                 "random weights")
            dtype = dtype or getattr(torch, cfg.dtype)
            state = state_from_tree(cfg, pm.materialize(param_specs(cfg), generator, dtype, device))
            if self.rules is not None:
                state = pm.shard(state, self.rules, layout_of(cfg))
        check_state(cfg, state, self.rules, served)
        for name, value in state.items():
            mod, _, leaf = name.rpartition(".")
            setattr(self.get_submodule(mod) if mod else self, leaf,
                    nn.Parameter(torch.as_tensor(value, device=device), requires_grad=False))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def forward(self, tokens, *, mode: str = "train", caches=None, use_kernel: str = "auto"):
        return fwd(self, tokens, mode=mode, caches=caches, use_kernel=use_kernel)


def embed_tokens(model: Model, cfg, tokens, table=None):
    """The token embeddings; ``F.embedding``, whose backward sums the rows
    of repeated tokens in a fixed order (an index's ``index_put_`` does
    not on the CPU), so that a training step is deterministic.  ``table``:
    the embedding to use (default ``model.embed``); under sharding rules
    it holds this process's rows of a vocabulary split over the
    ``vocab`` axes: a process looks up the ids in its range (zeros
    elsewhere) and a sum over those processes joins the rows."""
    table = model.embed if table is None else table
    vocab = sharding.group_of(sharding.current(), "vocab")
    if vocab is None:
        x = F.embedding(tokens, table)
    else:
        V = table.shape[0]
        ids = tokens - vocab.index * V
        mine = (ids >= 0) & (ids < V)
        x = F.embedding(ids.clamp(0, V - 1), table)
        x = comm.sum_over(torch.where(mine[..., None], x, x.new_zeros(())), vocab)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def _checkpointed(block, cfg, layer, x, positions, seq_axis, use_kernel: str, context_fn):
    """One train-mode layer under a non-reentrant checkpoint.  The layer's
    parameters go in as inputs of the checkpointed function and reach the
    block through ``functional_call``, so that the recomputation in the
    backward sees the same tensors as the forward."""
    names, vals = zip(*block.named_parameters())

    def run(x, *vals):
        return torch.func.functional_call(
            block, dict(zip(names, vals)), (x,),
            dict(cfg=cfg, layer=layer, positions=positions, seq_axis=seq_axis,
                 use_kernel=use_kernel))

    return checkpoint(run, x, *vals, use_reentrant=False, context_fn=context_fn)


def _partial_over(cfg, layer, rules) -> dict:
    """``{parameter name in the block: mesh axes}`` of a layer's weights
    whose gradient a tensor-parallel process holds in part (see
    ``params.fsdp_gather``): the kv projections and qk norms of attention
    over the heads' axes, the replicated leaves of a Mamba layer and its
    ``in_proj`` (of which a process uses its heads' columns) over its
    heads' axes, an MoE router over the experts' axes."""
    if layer.mixer == "mamba":
        mixer = dict.fromkeys(ssm.TP_PARTIAL + ("in_proj.weight",), ssm.tp_axes(cfg, rules))
    else:
        mixer = dict.fromkeys(attention.TP_PARTIAL, attention.tp_axes(cfg, layer, rules))
    out = {f"mixer.{n}": axes for n, axes in mixer.items()}
    if layer.moe:
        out["ffn.router.weight"] = moe.ep_axes(cfg, rules)
    return out


def _sharded(block, cfg, layer, index: int, x, positions, use_kernel: str, context_fn, rules):
    """One train-mode layer under sharding rules: its parameters (this
    process's blocks) go in as the inputs of the (checkpointed) function,
    which gathers their ``fsdp`` dimensions before the layer runs, so that
    the recomputation in the backward gathers again; a Mamba layer's
    ``in_proj`` is gathered whole.  The weights of :func:`_partial_over`
    take ``partial_over`` those axes (see ``params.fsdp_gather``)."""
    layout = layout_of(cfg)
    names, vals = zip(*block.named_parameters())
    leaves = [layout[f"layers.{index}.{n}"] for n in names]
    partial = _partial_over(cfg, layer, rules)
    extra = [(partial.get(n, ()), n == "mixer.in_proj.weight") for n in names]

    def run(x, *vals):
        # the rules again: the backward's recomputation may run on another
        # thread (autograd's device threads), where the installed ones are not
        with sharding.axis_rules(rules):
            full = [pm.fsdp_gather(v, leaf, rules, p, whole)
                    for v, leaf, (p, whole) in zip(vals, leaves, extra)]
            return torch.func.functional_call(
                block, dict(zip(names, full)), (x,),
                dict(cfg=cfg, layer=layer, positions=positions, use_kernel=use_kernel))

    if context_fn is None:
        return run(x, *vals)
    return checkpoint(run, x, *vals, use_reentrant=False, context_fn=context_fn)


def _seq_group(rules, shape):
    """The subgroup that splits the tokens of activations of global
    ``shape`` (B, T, d) under ``rules`` (``seq``: sequence parallelism), or
    None (``seq`` unmapped, or T does not divide: ``fit`` drops it)."""
    entry = rules.spec("batch", "seq", None, shape=shape)[1]
    return sharding.subgroup(rules, sharding.entry_axes(entry))


def check_sharded(cfg, rules, **serving) -> None:
    """Raise before any collective, alike on every process, where ``rules``
    split a layer's shape that does not split over the mesh
    (``blocks.check_sharded``; ``serving``: its keywords ``batch``,
    ``prompt``, ``cache_len``)."""
    if rules is not None:
        for layer in cfg.layers_flat:
            blocks.check_sharded(cfg, layer, rules, **serving)


def embed_table(model, cfg):
    """The embedding a step uses: ``model.embed``, with its ``fsdp``
    dimension gathered under sharding rules (its vocabulary stays split)."""
    return pm.fsdp_gather(model.embed, layout_of(cfg)["embed"], sharding.current())


def _check_served(model, mode: str) -> None:
    if not getattr(model, "served", False):
        raise ValueError(f"{mode} under sharding rules runs on the model of serving_model "
                         "(its weights gathered once), not on one of blocks")


def fwd(model: Model, inputs, *, mode, positions=None, caches=None, cache_len=None,
        batch: int | None = None, seq_axis=None, use_kernel: str = "auto", remat: str = "full",
        table=None):
    """Backbone forward.

    inputs: int tokens (B, T) if cfg.vocab else embeddings (B, T, d).
    positions: (T,) absolute positions, an int tensor on the model's device
    (default ``arange(T)``; decode: ``[pos]``).  caches: list (one entry per
    layer) of cache dicts, or None.  cache_len: the attention layers' cache
    length at prefill (default T).  seq_axis: the inputs are this process's
    shard of a sequence sharded over the default group's processes, at
    absolute ``positions`` (context parallelism; train mode;
    :mod:`repro_torch.distributed.context_parallel`).  remat: a key of
    :data:`REMAT_POLICIES`;
    it applies to train mode with grad mode on and parameters that require
    grad (training), each layer checkpointed alone.  table: the embedding
    (default :func:`embed_table`).  Under sharding rules, in train mode,
    each layer runs through :func:`_sharded`; prefill and decode
    (serving) take the model of :func:`serving_model`, this process's rows
    of the inputs, and ``batch``/``cache_len``, the global batch and cache
    length; under ``seq`` rules the layers run sequence-parallel and the
    hidden state returned is gathered whole.  Returns (hidden (B, T, d),
    new_caches, aux)."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat={remat!r}; pick from {tuple(REMAT_POLICIES)}")
    cfg = model.cfg
    rules = sharding.current()
    serving = rules is not None and mode != "train"
    if rules is not None and seq_axis is not None:
        raise NotImplementedError(SEQ_AXIS_SHARDED)
    if rules is not None and mode == "train" and any(
            rules.mesh.shape[a] > 1 for a in rules.axes_of("seq")):
        raise NotImplementedError(f"train mode under sharding rules that map seq over "
                                  f"{rules.axes_of('seq')}: not in the port yet ({SERVE_SHARDED})")
    shapes = {}
    if serving:
        _check_served(model, mode)
        shapes = dict(batch=batch, prompt=inputs.shape[1] if mode == "prefill" else None,
                      cache_len=cache_len)
    check_sharded(cfg, rules, **shapes)
    if cfg.vocab and table is None:
        table = embed_table(model, cfg) if rules is not None and not serving else model.embed
    x = embed_tokens(model, cfg, inputs, table) if cfg.vocab else inputs
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    sp = _seq_group(rules, (batch, *x.shape[1:])) if serving else None
    if sp is not None:   # sequence parallelism: this process's block of the tokens
        n = x.shape[1] // sp.size
        x = x[:, sp.index * n:(sp.index + 1) * n]
    new_caches = [] if (caches is not None or mode == "prefill") else None
    aux = x.new_zeros((), dtype=torch.float32)
    training = (mode == "train" and torch.is_grad_enabled()
                and any(p.requires_grad for p in model.parameters()))
    context_fn = REMAT_POLICIES[remat] if training else None
    for i, (layer, block) in enumerate(zip(cfg.layers_flat, model.layers)):
        if rules is not None and not serving:
            x, a = _sharded(block, cfg, layer, i, x, positions, use_kernel, context_fn, rules)
            c = None
        elif context_fn is not None:
            x, a = _checkpointed(block, cfg, layer, x, positions, seq_axis, use_kernel,
                                 context_fn)
            c = None
        else:
            x, c, a = blocks.layer_fwd(block, cfg, layer, x, mode=mode, positions=positions,
                                       cache=None if caches is None else caches[i],
                                       cache_len=cache_len, batch=batch, seq_axis=seq_axis,
                                       seq_group=sp, use_kernel=use_kernel)
        aux = aux + a
        if new_caches is not None:
            new_caches.append(c)
    x = rms_norm(x, model.final_norm, cfg.norm_eps, scale_plus_one=cfg.gemma_norm)
    if sp is not None:
        x = comm.gather_over(x, sp, 1)
    return x, new_caches, aux


def lm_head_matrix(model: Model):
    return model.embed.T if model.cfg.tie_embeddings else model.head


def vocab_offset(cfg, V: int) -> int:
    """The first id of this process's block of ``V`` logits: 0 for the
    whole vocabulary, else its index in the installed rules' ``vocab``
    subgroup times ``V``."""
    vocab = sharding.group_of(sharding.current(), "vocab") if V != cfg.padded_vocab else None
    return 0 if vocab is None else vocab.index * V


def logits_fn(model: Model, h):
    """float32 logits; the pad rows of ``padded_vocab`` are set to -1e30.
    Under sharding rules (a served model): this process's block of the
    vocabulary, its pad rows found from its offset (:func:`vocab_offset`)."""
    cfg = model.cfg
    logits = (h @ lm_head_matrix(model)).float()
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    if cfg.padded_vocab != cfg.vocab:  # mask the padding rows
        V = logits.shape[-1]
        off = vocab_offset(cfg, V)
        valid = torch.arange(off, off + V, device=logits.device) < cfg.vocab
        logits = torch.where(valid, logits, logits.new_full((), -1e30))
    return logits


# ---------------------------------------------------------------------
# training
# ---------------------------------------------------------------------

def encode_cross_states(model, cfg, batch, *, remat: str = "full"):
    """The cross-attention states of a batch: None for the configs the port
    runs; image and encoder-decoder configs raise (ROADMAP.md, Queue A)."""
    if cfg.encoder is not None or cfg.cross_source == "image":
        raise NotImplementedError(
            "cross-attention states (image and encoder-decoder configs): not in the port yet "
            "(ROADMAP.md, Queue A item 6)")
    return None


class _Trainable(nn.Module):
    """The parameters of ``Model(cfg)`` on the meta device (the same names),
    with the loss as its forward: :func:`loss_fn` calls it through
    ``torch.func.functional_call`` with the real tensors."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        _skeleton(self, cfg)

    def forward(self, batch, *, remat, aux_weight, loss_chunk, use_kernel):
        cfg = self.cfg
        encode_cross_states(self, cfg, batch, remat=remat)
        rules = sharding.current()
        check_sharded(cfg, rules)
        sharding.shd(batch["tokens"], "batch", None)
        table = embed_table(self, cfg) if cfg.vocab else None
        h, _, aux = fwd(self, batch["tokens"], mode="train", remat=remat,
                        use_kernel=use_kernel, table=table)
        if cfg.tie_embeddings:
            w_out = table.T
        else:
            w_out = pm.fsdp_gather(self.head, layout_of(cfg)["head"], rules)
        loss = cross_entropy_chunked(h, w_out, batch["labels"], chunk=loss_chunk,
                                     logit_softcap=cfg.logit_softcap, n_valid=cfg.vocab)
        return loss + aux_weight * aux, {"xent": loss, "aux": aux}


@functools.lru_cache(maxsize=None)
def _trainable(cfg) -> _Trainable:
    return _Trainable(cfg)


def loss_fn(params: dict, cfg, batch: dict, *, remat: str = "full", aux_weight: float = 0.01,
            loss_chunk: int = 512, use_kernel: str = "auto"):
    """The training loss of ``params`` (a ``{name: tensor}`` dict with every
    parameter of ``Model(cfg)``, e.g. from :func:`init_params`; those that
    require grad get gradients) on ``batch`` = {"tokens" (B, T), "labels"
    (B, T), -100 ignored}.  Returns ``(xent + aux_weight * aux, {"xent",
    "aux"})``, ``aux`` the MoE load-balance loss summed over the layers.
    Under sharding rules ``params`` are this process's blocks, ``batch``
    its rows, and ``xent`` its share of the loss (see
    ``layers.cross_entropy_chunked``); ``aux`` is the whole batch's."""
    return torch.func.functional_call(
        _trainable(cfg), params, (batch,),
        dict(remat=remat, aux_weight=aux_weight, loss_chunk=loss_chunk, use_kernel=use_kernel),
        strict=True)


# ---------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------

def cache_specs(cfg, batch: int, cache_len: int, dtype=torch.bfloat16) -> list:
    """Per layer, the decode cache's shapes and dtype as meta tensors."""
    return [blocks.layer_cache_specs(cfg, l, batch, cache_len, dtype) for l in cfg.layers_flat]


def cache_shardings(cfg, rules, batch: int, cache_len: int) -> list:
    """Per layer, ``{"mixer": {leaf: spec}}``: the spec of every cache leaf
    under ``rules`` (mesh axes that do not divide a dimension dropped), the
    twin of the reference's ``cache_shardings`` without its repeat axis.
    A process holds the block of each leaf that the spec gives its mesh
    coordinates."""
    return [{"mixer": {name: rules.spec(*blocks.CACHE_AXES[name], shape=tuple(t.shape))
                       for name, t in c["mixer"].items()}}
            for c in cache_specs(cfg, batch, cache_len, torch.float32)]


class Caches(list):
    """The decode caches, one entry per layer, with the global ``batch``
    and ``cache_len`` they were made for (under sharding rules each entry
    holds this process's blocks, and decode reads these to place them)."""

    def __init__(self, caches, *, batch: int | None, cache_len: int | None):
        super().__init__(caches)
        self.batch, self.cache_len = batch, cache_len


@torch.no_grad()
def serving_model(model: Model) -> Model:
    """The model that serves under the rules ``model`` was built under:
    each weight with its ``fsdp`` dimensions gathered (the tensor-parallel
    split kept; a Mamba layer's ``in_proj`` whole), once, so that prefill
    and decode gather no weight (ZeRO-3 at every decode step would stage
    every layer's blocks through the host at every token).  Collective;
    ``model`` itself where it has no rules or serves already."""
    rules = model.rules
    if rules is None or model.served:
        return model
    layout = layout_of(model.cfg)
    state = {name: pm.fsdp_gather(p, layout[name], rules, whole=name.endswith(WHOLE))
             for name, p in model.named_parameters()}
    with sharding.axis_rules(rules):
        return Model(model.cfg, state, device=model.device, served=True)


@torch.inference_mode()
def prefill(model: Model, tokens, *, cache_len=None, use_kernel: str = "auto"):
    """Process the prompt; returns (last-token logits (B, V), caches).
    ``cache_len``: the length of the global attention layers' KV caches
    (default the prompt's; a window layer keeps ``min(window, cache_len)``
    slots).  Under sharding rules (the model of :func:`serving_model`):
    ``tokens`` is the global prompt, of which this process keeps its rows
    of ``batch``; the logits are those rows' block of the vocabulary
    ``(B_local, V / tp)`` and the caches this process's blocks."""
    B, T = tokens.shape
    cache_len = cache_len or T
    if sharding.current() is not None:
        _check_served(model, "prefill")
        tokens = local_rows({"tokens": tokens})["tokens"]
    h, caches, _ = fwd(model, tokens, mode="prefill", cache_len=cache_len, batch=B,
                       use_kernel=use_kernel)
    logits = logits_fn(model, h[:, -1:])
    return logits[:, 0], Caches(caches, batch=B, cache_len=cache_len)


@torch.inference_mode()
def decode_step(model: Model, token, pos, caches, *, use_kernel: str = "auto"):
    """One decode step.  token: (B, 1) ids; pos: its position, an int or a
    0-d tensor (unused by the Mamba layers).  Returns (logits (B, V),
    caches).  Under sharding rules: ``token`` is this process's rows (what
    its rows' logits picked) and ``caches`` the :class:`Caches` of
    :func:`prefill`; the logits are its block, as prefill's."""
    pos = torch.as_tensor(pos, dtype=torch.long, device=token.device).reshape(1)
    batch = getattr(caches, "batch", None)
    cache_len = getattr(caches, "cache_len", None)
    if sharding.current() is not None:
        if batch is None:
            raise ValueError("decode under sharding rules takes the Caches of prefill")
        sharding.shd(token, "batch", None, shape=(batch, 1))
    h, caches, _ = fwd(model, token, mode="decode", positions=pos, caches=caches,
                       cache_len=cache_len, batch=batch, use_kernel=use_kernel)
    return logits_fn(model, h)[:, -1], Caches(caches, batch=batch, cache_len=cache_len)
