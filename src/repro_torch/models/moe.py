"""Mixture-of-Experts FFN with sort-based capacity dispatch.

The port's twin of the JAX package's ``models/moe.py``.  Each sequence is
a routing group with its own capacity ``C`` (:func:`capacity`, from the
tokens of this call), and the dispatch is the reference's, with the batch
axis written out where the reference ``vmap``s:

    router logits (float32) -> softmax -> top-k (ties: the lower expert
    first, as ``jax.lax.top_k``) -> gates renormalised -> the (token, k)
    pairs stably sorted by expert -> position in expert = index - the
    exclusive-cumsum start of its expert -> ``dest = e * C + pos``, or the
    drop slot ``E * C`` when ``pos >= C`` -> a (B, E, C, d) buffer ->
    batched expert GEMMs through the GLU -> a weighted scatter-add combine
    (``index_add_`` in the sorted order).

Shared (always-on) experts add a dense GLU FFN of ``n_shared * d_ff``.
The Switch load-balance loss ``E * sum_e f_e P_e`` is returned beside the
output.  No TPU kernel sits inside the reference's MoE (its expert GEMMs
are ``jnp.einsum``); here they are ``torch.bmm`` over the expert axis.

Under installed sharding rules (train mode) the experts are split over
the mesh axes of ``experts`` (expert parallelism, :func:`ep_group`): the
rules split the batch over the data axes only, so every process of that
subgroup holds the same tokens and routes them alike (the same top-k,
capacity and drops); each applies its ``E / ep`` experts to the pairs
routed to them, and the partial outputs are summed over the subgroup
(``comm.sum_over``; the input through ``comm.copy_to``): no all-to-all.
The shared experts are column- and row-parallel over the same processes
(the ``ffn`` axes of ``shared_wi``, which must be the experts'), as the
dense FFN is.  The aux loss is whole on every process of the subgroup;
its gradient is taken on the first process alone, so that the sums over
the subgroup count it once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core import comm
from ..distributed import sharding
from .layers import glu, row_join
from .params import ParamSpec


def _moe_cfg(cfg):
    if cfg.moe is None:
        raise ValueError(f"config {cfg.name!r} has a layer with moe=True but no MoECfg "
                         "(cfg.moe is None)")
    return cfg.moe


def specs(cfg) -> dict:
    m = _moe_cfg(cfg)
    d, E, f = cfg.d_model, m.n_experts, m.d_ff
    out = {
        "router": ParamSpec((d, E), ("fsdp", None), std=0.006),
        "wi": ParamSpec((E, d, 2, f), ("experts", "fsdp", None, None)),
        "wo": ParamSpec((E, f, d), ("experts", None, "fsdp")),
    }
    if m.n_shared:
        out["shared_wi"] = ParamSpec((d, 2, m.n_shared * f), ("fsdp", None, "ffn"))
        out["shared_wo"] = ParamSpec((m.n_shared * f, d), ("ffn", "fsdp"))
    return out


def capacity(n_tokens: int, cfg) -> int:
    """Slots per expert and sequence: ``int(K T cf / E) + 1`` rounded up to
    a multiple of 8, at least 8 (T the tokens of this call)."""
    m = cfg.moe
    c = int(m.top_k * n_tokens * m.capacity_factor / m.n_experts) + 1
    return max(8, -(-c // 8) * 8)  # round up to 8


class MoE(nn.Module):
    """The layer's parameters: ``router`` an ``nn.Linear`` (weight ``(E,
    d)``, the reference's ``(d, E)`` leaf transposed); the experts' ``wi``
    ``(E, d, 2, f)`` (gate, then up) and ``wo`` ``(E, f, d)`` as the
    reference keeps them; the shared experts as ``nn.Linear``
    ``shared_wi`` ``(2 S f, d)`` and ``shared_wo`` ``(d, S f)``, laid out
    as :class:`~.blocks.FFN` lays out a gated FFN.  Built on the meta
    device; the model assigns the real tensors."""

    def __init__(self, cfg):
        super().__init__()
        m = _moe_cfg(cfg)
        d, E, f = cfg.d_model, m.n_experts, m.d_ff
        meta = {"device": "meta"}
        self.router = nn.Linear(d, E, bias=False, **meta)
        self.wi = nn.Parameter(torch.empty(E, d, 2, f, **meta), requires_grad=False)
        self.wo = nn.Parameter(torch.empty(E, f, d, **meta), requires_grad=False)
        if m.n_shared:
            self.shared_wi = nn.Linear(d, 2 * m.n_shared * f, bias=False, **meta)
            self.shared_wo = nn.Linear(m.n_shared * f, d, bias=False, **meta)


def ep_axes(cfg, rules) -> tuple:
    """The mesh axes an MoE layer's experts are split over under ``rules``
    (() without rules); raises, naming the shapes and the mesh, where the
    experts, or the shared experts' ``n_shared * d_ff``, do not split over
    every axis of their rule."""
    if rules is None:
        return ()
    m, mesh, sp = _moe_cfg(cfg), rules.mesh, specs(cfg)
    wi = sp["wi"]
    axes = sharding.split_axes(rules, wi.axes, wi.shape, 0, f"{m.n_experts} experts do not split")
    if m.n_shared:
        what = f"the shared experts' n_shared x d_ff = {m.n_shared * m.d_ff}"
        swi = sp["shared_wi"]
        shared = sharding.split_axes(rules, swi.axes, swi.shape, 2, f"{what} does not split")
        if {a for a in shared if mesh.shape[a] > 1} != {a for a in axes if mesh.shape[a] > 1}:
            raise NotImplementedError(f"{what} splits over the mesh axes {shared}, the experts "
                                      f"over {axes} ({dict(mesh.shape)}): not one subgroup")
    return axes


def ep_group(cfg, rules):
    """The subgroup of :func:`ep_axes` (None: no rules, or one process)."""
    return sharding.subgroup(rules, ep_axes(cfg, rules))


def route(logits, k: int):
    """Softmax over the experts and the top ``k`` of each token, the lower
    expert first among equal probabilities (``jax.lax.top_k``'s order; a
    stable descending sort, the same on the CPU and on the card).
    Returns (probs, renormalised gates, expert ids)."""
    probs = torch.softmax(logits, dim=-1)
    top, eid = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eid = top[..., :k], eid[..., :k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return probs, gate, eid


def dispatch(eid, C: int, E: int):
    """Per sequence, the (token, k) pairs of ``eid`` (B, T, K) stably sorted
    by expert.  Returns ``dest`` (B, T K): the pair's slot ``e C + pos`` in
    the (E C) buffer, ``E C`` where ``pos >= C`` (dropped); ``sorted_tok``
    (B, T K): its token; ``order`` (B, T K): its index among the flat pairs."""
    B, T, K = eid.shape
    flat = eid.reshape(B, T * K)
    order = torch.argsort(flat, dim=-1, stable=True)
    sorted_eid = torch.gather(flat, 1, order)
    counts = torch.zeros(B, E, dtype=torch.long, device=eid.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, dim=-1) - counts
    pos = torch.arange(T * K, device=eid.device) - torch.gather(starts, 1, sorted_eid)
    dest = torch.where(pos < C, sorted_eid * C + pos, E * C)
    return dest, order // K, order


def fwd(moe: MoE, cfg, x, seq_group=None):
    """x: (B, T, d) -> (out (B, T, d), aux loss float32 0-d).  The router
    is called as a module, so a forward hook on ``moe.router`` sees the
    layer's input and logits (from which :func:`route` and :func:`dispatch`
    give its slots and drops).  ``seq_group``: under sequence parallelism
    (prefill) x holds every token and the output keeps this process's
    block of them (``layers.row_join``)."""
    m = cfg.moe
    B, T, d = x.shape
    E, K = m.n_experts, m.top_k
    rules = sharding.current()
    ep = ep_group(cfg, rules)
    if ep is not None:   # the tokens are the same on every process of ep
        x = comm.copy_to(x, ep)

    logits = moe.router(x).float()  # (B, T, E)
    probs, gate, eid = route(logits, K)

    # Switch aux loss: E * sum_e f_e * P_e (global statistics: under sharding
    # rules the counts and probabilities are summed over the batch's
    # processes, each of which then holds the whole batch's aux loss)
    flat_eid = eid.reshape(-1)
    token_frac = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, flat_eid, torch.ones(flat_eid.shape, dtype=torch.float32, device=x.device))
    batch = sharding.group_of(rules, "batch")
    if batch is None:
        token_frac = token_frac / (B * T * K)
        prob_frac = probs.mean(dim=(0, 1))
    else:
        n = B * T * batch.size
        token_frac = comm.sum_over(token_frac, batch) / (n * K)
        prob_frac = comm.sum_over(probs.sum(dim=(0, 1)), batch) / n
    aux = E * torch.sum(token_frac * prob_frac)
    if ep is not None and ep.index:   # its gradient once over ep: on the first process
        aux = aux.detach()

    C = capacity(T, cfg)
    dest, sorted_tok, order = dispatch(eid, C, E)
    w_sorted = torch.gather(gate.reshape(B, T * K), 1, order)
    # this process's experts [e0, e0 + El): their slots; every other pair
    # (routed elsewhere, or dropped) to the slot past them
    El = moe.wi.shape[0]
    lo = (0 if ep is None else ep.index * El) * C
    dest = torch.where((dest >= lo) & (dest < lo + El * C), dest - lo, El * C)

    # the (B, El C) buffer, one row more for the other pairs (cut off after)
    rows = torch.arange(B, device=x.device)[:, None]
    buf = x.new_zeros(B, El * C + 1, d)
    buf[rows, dest] = x[rows, sorted_tok]
    eb = buf[:, :El * C].reshape(B, El, C, d)

    # the expert GEMMs, batched over the experts: (El, B C, d) @ (El, d, 2f)
    xe = eb.transpose(0, 1).reshape(El, B * C, d)
    h = glu(torch.bmm(xe, moe.wi.flatten(2)).unflatten(-1, (2, m.d_ff)), cfg.act)
    ob = torch.bmm(h, moe.wo).reshape(El, B, C, d).transpose(0, 1).reshape(B, El * C, d)

    # combine: each pair's output (zero for a pair not in ob), weighted,
    # added into its token in the sorted order
    ob = torch.cat([ob, ob.new_zeros(B, 1, d)], dim=1)
    vals = ob[rows, dest] * w_sorted[..., None].to(x.dtype)
    idx = (rows * T + sorted_tok).reshape(-1)
    out = x.new_zeros(B * T, d).index_add_(0, idx, vals.reshape(-1, d)).reshape(B, T, d)

    if m.n_shared:   # column- and row-parallel over the same processes (ep_axes)
        hs = glu(F.linear(x, moe.shared_wi.weight).unflatten(-1, (2, -1)), cfg.act)
        out = out + F.linear(hs, moe.shared_wo.weight)
    # the processes' partial outputs summed
    return row_join(out, ep, seq_group), aux
