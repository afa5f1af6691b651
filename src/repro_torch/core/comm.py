"""The process-group backend of the implicit global grid.

A field's blocks may live in several processes of a ``torch.distributed``
process group, the paper's one rank per GPU: each process holds the
contiguous box of blocks that :class:`repro_torch.core.topology.
CartesianTopology` assigns it.  This module is the ONLY place that calls
``torch.distributed``:

* :func:`sendrecv` — the neighbour exchange of one halo slab per
  direction along one grid dimension (``batch_isend_irecv``);
* :func:`shift` — the one-directional permute of the sequence axis
  (``ppermute`` by a fixed offset): every process sends to the one ``by``
  ranks up and receives from the one ``by`` ranks down, for the halos,
  ring rotations and pipeline hand-offs of :mod:`repro_torch.distributed`;
* :func:`all_reduce` — sum, max and min of the reductions' partials;
* :func:`all_gather` — every process's tensor, for ``gather``;
* over a :class:`Subgroup` (the processes of one mesh axis, or of a tuple
  of axes, :mod:`repro_torch.launch.mesh`): :func:`gather_over` (an
  all-gather along a dimension), :func:`reduce_scatter_over` (its
  transpose), :func:`sum_over` and :func:`max_over` (all-reduces) and
  :func:`copy_to` (the identity whose backward sums) — the collectives of
  sharded training (:mod:`repro_torch.distributed.sharding`), each a
  ``torch.autograd.Function`` where a train step differentiates through
  it; :func:`new_groups` makes the subgroups;
* :func:`init_from_env` — join the group that ``torchrun`` describes;
* :func:`barrier`, and what a process needs to know of the group
  (:func:`initialized`, :func:`world_size`, :func:`rank`);
* :func:`exchange_through_store` — bytes of every process through the
  group's key-value store (no collective: a process that never publishes
  is a timeout, not a hang), for the analyzer's cross-process check.

Under an analyzer check (:mod:`repro_torch.analysis`) the
communicating functions record what they would send and return meta
tensors of the right shape: nothing is sent.

The group is the default one the caller made with
``torch.distributed.init_process_group``, and its backend is the caller's
choice: ``nccl`` between cards, ``gloo`` on the CPU and for several
processes sharing one card.  Nothing here picks, changes or falls back to
another backend.  gloo's point-to-point and collective calls take CPU
tensors only, so under gloo a CUDA tensor is staged through host memory:
copied to the host, sent, received into host buffers and copied back.
That is how gloo moves device data, not a fallback, and it makes the host
wait for the device at every exchange.  Without a group (or with a group
of one process) none of these functions is reached by the grid.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time

import torch

from ..analysis import markers as _mk

# Tags of the two directions of one exchange.  gloo matches messages by
# tag; NCCL ignores tags and matches the messages between a pair of ranks
# in the order they were issued, so :func:`sendrecv` issues the
# low-going pair before the high-going one on every process.
_TAG_LOW, _TAG_HIGH = 1, 2
# The tag of :func:`shift`'s one message a process sends and receives.
_TAG_SHIFT = 3
# The tags of :func:`reduce_scatter_over`'s messages (one to each member)
# and of the subgroup collectives' exchange of every member's tensor
# (``_parts``); :func:`gather_to_first` tags item i ``_TAG_GATHER + i``.
_TAG_SCATTER, _TAG_PARTS, _TAG_GATHER = 4, 5, 1 << 16


def _dist():
    import torch.distributed as dist
    return dist


def initialized() -> bool:
    """True when a default process group exists."""
    try:
        dist = _dist()
    except ImportError:  # a build without distributed support
        return False
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Processes in the default group (1 without one)."""
    return _dist().get_world_size() if initialized() else 1


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return _dist().get_rank() if initialized() else 0


def backend() -> str | None:
    """The default group's backend (``"gloo"``, ``"nccl"``), None without one."""
    return str(_dist().get_backend()) if initialized() else None


def _staged(t: torch.Tensor) -> bool:
    """Whether ``t`` must travel through host memory (gloo and a CUDA tensor)."""
    return t.device.type == "cuda" and backend() == "gloo"


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor the backend can send: a host copy under staging."""
    return t.detach().contiguous().to("cpu") if _staged(t) else t.detach().contiguous()


def _buffer(like: torch.Tensor) -> torch.Tensor:
    return torch.empty(like.shape, dtype=like.dtype,
                       device="cpu" if _staged(like) else like.device)


def sendrecv(to_low: torch.Tensor | None, to_high: torch.Tensor | None,
             low: int | None, high: int | None):
    """One exchange along a grid dimension: ``to_low`` goes to process
    ``low`` and ``to_high`` to process ``high`` (None where there is no
    neighbour); returns ``(from_low, from_high)``, what those processes
    sent this way, on the tensors' device (None where there is none).

    ``low`` and ``high`` may be the same process (two processes along a
    periodic dimension): each direction has its own tag, and the
    low-going send and receive are issued before the high-going ones.
    """
    if _mk.TRACE is not None:
        return _mk.TRACE.sendrecv(to_low, to_high, low, high)
    dist = _dist()
    like = to_low if to_low is not None else to_high
    ops, from_low, from_high = [], None, None
    if low is not None:
        ops.append(dist.P2POp(dist.isend, _wire(to_low), low, tag=_TAG_LOW))
    if high is not None:
        from_high = _buffer(like)
        ops.append(dist.P2POp(dist.irecv, from_high, high, tag=_TAG_LOW))
    if high is not None:
        ops.append(dist.P2POp(dist.isend, _wire(to_high), high, tag=_TAG_HIGH))
    if low is not None:
        from_low = _buffer(like)
        ops.append(dist.P2POp(dist.irecv, from_low, low, tag=_TAG_HIGH))
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()
    dev = like.device
    return tuple(None if t is None else t.to(dev) for t in (from_low, from_high))


def _shift_peers(by: int, periodic: bool) -> tuple:
    """``(source, destination)`` of this process in a :func:`shift` by
    ``by``: the ranks ``by`` below and ``by`` above it, taken modulo the
    group's size when ``periodic``, else None where they fall outside."""
    n, r = world_size(), rank()
    if periodic:
        return (r - by) % n, (r + by) % n
    src, dst = r - by, r + by
    return (src if 0 <= src < n else None), (dst if 0 <= dst < n else None)


def _shift(t: torch.Tensor, by: int, periodic: bool) -> torch.Tensor:
    src, dst = _shift_peers(by, periodic)
    if _mk.TRACE is not None:
        return _mk.TRACE.shift(t, src, dst)
    if src == dst == rank():   # itself: no group, or a periodic shift by a multiple of it
        return t.clone()
    dist = _dist()
    ops, got = [], None
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, _wire(t), dst, tag=_TAG_SHIFT))
    if src is not None:
        got = _buffer(t)
        ops.append(dist.P2POp(dist.irecv, got, src, tag=_TAG_SHIFT))
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()
    return torch.zeros_like(t) if got is None else got.to(t.device)


class _Shift(torch.autograd.Function):
    """A shift's gradient is the shift back: what went to rank r + by
    returns from it."""

    @staticmethod
    def forward(ctx, t, by, periodic):
        ctx.by, ctx.periodic = by, periodic
        return _shift(t, by, periodic)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, -ctx.by, ctx.periodic), None, None


def shift(t: torch.Tensor, by: int = 1, periodic: bool = False) -> torch.Tensor:
    """``ppermute`` by a fixed offset: this process sends ``t`` to rank
    ``rank + by`` and returns what rank ``rank - by`` sent, on ``t``'s
    device (ranks modulo the group's size when ``periodic``).  A process
    with no source gets zeros, as ``ppermute`` gives; without a group the
    process is its own neighbour (``t`` when periodic, zeros when not).
    Every process of the group calls it with the same ``by`` and
    ``periodic``.  Differentiable: the gradient travels back by ``-by``."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _Shift.apply(t, int(by), bool(periodic))
    return _shift(t, int(by), bool(periodic))


def all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    """``t`` of every process, in rank order (every process passes a tensor
    of the same shape and dtype).  Under staging the results stay on the
    host."""
    if _mk.TRACE is not None:
        _mk.TRACE.collective("all_gather", t, site="core.comm.all_gather")
        return [t.clone() for _ in range(world_size())]
    dist = _dist()
    w = _wire(t)
    out = [torch.empty_like(w) for _ in range(world_size())]
    dist.all_gather(out, w)
    return out


def all_reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """``op`` in {"sum", "max", "min"} of ``x`` over the processes, as a new
    tensor on ``x``'s device.

    A sum gathers the partials of every process and reduces them on each
    process by the same call on the same tensor, so every process reads
    the same bits: the solvers' stopping tests read these values on each
    process, and a one-ulp disagreement between processes would send them
    on different iteration counts.  Max and min are exact in any order.
    """
    if _mk.TRACE is not None:
        _mk.TRACE.collective("all_reduce", x, reduce_op=op, site="core.comm.all_reduce")
        return x.clone()
    if op == "sum":
        return torch.stack(all_gather(x)).sum(0).to(x.device)
    dist = _dist()
    ops = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
    if op not in ops:
        raise ValueError(f"unknown reduction {op!r}; expected sum, max or min")
    w = _wire(x).clone()
    dist.all_reduce(w, op=ops[op])
    return w.to(x.device)


# ---------------------------------------------------------------------------
# subgroups: the collectives of sharded training
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Subgroup:
    """Processes of the default group that act together: those of one mesh
    axis, or of a tuple of axes, that share this process's other
    coordinates.  ``ranks``: their default-group ranks in the order of
    their index along the axes (the first axis major); ``handle``: the
    backend's group (None for the default group itself, or a group of
    one process, which communicates nothing)."""

    ranks: tuple
    handle: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def index(self) -> int:
        """This process's index in :attr:`ranks`."""
        return self.ranks.index(rank())


def new_groups(partition) -> Subgroup:
    """Make the backend groups of ``partition`` (disjoint tuples of
    default-group ranks, each in index order, together every process) and
    return this process's :class:`Subgroup`.  ``new_group`` is collective
    over the default group, so every process calls this with the same
    partition, in the same order as every other call of it; a part of one
    process, or the whole group, makes no backend group."""
    mine = None
    for members in partition:
        members = tuple(int(r) for r in members)
        handle = None
        if 1 < len(members) < world_size():
            handle = _dist().new_group(sorted(members))
        if rank() in members:
            mine = Subgroup(members, handle)
    if mine is None:
        raise ValueError(f"rank {rank()} is in no part of {list(partition)}")
    return mine


def _parts(t: torch.Tensor, sub: Subgroup) -> list:
    """``t`` of every member of ``sub``, in its index order (host tensors
    under staging): each member sends its ``t`` to every other one,
    point-to-point under one tag, all messages at once (gloo's all-gather
    took 1.8 times as long for two processes on one host)."""
    dist = _dist()
    w, me = _wire(t), sub.index
    out, ops = [], []
    for k, peer in enumerate(sub.ranks):
        if k == me:
            out.append(w)
            continue
        out.append(_buffer(t))
        ops.append(dist.P2POp(dist.isend, w, peer, sub.handle, tag=_TAG_PARTS))
        ops.append(dist.P2POp(dist.irecv, out[-1], peer, sub.handle, tag=_TAG_PARTS))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def _gather(t: torch.Tensor, sub: Subgroup, dim: int) -> torch.Tensor:
    if _mk.TRACE is not None:
        _mk.TRACE.collective("gather_over", t, peers=sub.ranks, site="core.comm.gather_over")
        return torch.cat([t] * sub.size, dim)
    return torch.cat([p.to(t.device) for p in _parts(t, sub)], dim)


def _sum(t: torch.Tensor, sub: Subgroup) -> torch.Tensor:
    """The members' ``t`` added one after another in index order: every
    member does the same additions and reads the same bits."""
    if _mk.TRACE is not None:
        _mk.TRACE.collective("sum_over", t, peers=sub.ranks, reduce_op="sum",
                             site="core.comm.sum_over")
        return t.clone()
    parts = _parts(t, sub)
    acc = parts[0].to(t.device, copy=True)
    for p in parts[1:]:
        acc.add_(p.to(t.device))
    return acc


def _reduce_scatter(t: torch.Tensor, sub: Subgroup, dim: int) -> torch.Tensor:
    """Member k's block k (of ``sub.size`` equal blocks along ``dim``),
    summed over the members in index order.  Point-to-point messages under
    one tag (gloo has no reduce-scatter): each member sends every other
    member that one's block of its ``t`` and adds what it receives."""
    n = sub.size
    if t.shape[dim] % n:
        raise ValueError(f"reduce-scatter of {t.shape[dim]} along dim {dim} over {n} processes")
    if _mk.TRACE is not None:
        _mk.TRACE.collective("reduce_scatter_over", t, peers=sub.ranks, reduce_op="sum",
                             site="core.comm.reduce_scatter_over")
        return t.narrow(dim, 0, t.shape[dim] // n).clone()
    dist = _dist()
    blocks, me = t.chunk(n, dim), sub.index
    ops, got = [], {}
    for k, peer in enumerate(sub.ranks):
        if k != me:
            ops.append(dist.P2POp(dist.isend, _wire(blocks[k]), peer, sub.handle,
                                  tag=_TAG_SCATTER))
            got[k] = _buffer(blocks[me])
            ops.append(dist.P2POp(dist.irecv, got[k], peer, sub.handle, tag=_TAG_SCATTER))
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()
    acc = None
    for k in range(n):
        part = blocks[me] if k == me else got[k].to(t.device)
        acc = part.clone() if acc is None else acc.add_(part)
    return acc.contiguous()


class _GatherOver(torch.autograd.Function):
    """All-gather along ``dim``; its gradient is the reduce-scatter."""

    @staticmethod
    def forward(ctx, t, sub, dim):
        ctx.sub, ctx.dim = sub, dim
        return _gather(t, sub, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.sub, ctx.dim), None, None


class _ReduceScatterOver(torch.autograd.Function):
    """Reduce-scatter along ``dim``; its gradient is the all-gather."""

    @staticmethod
    def forward(ctx, t, sub, dim):
        ctx.sub, ctx.dim = sub, dim
        return _reduce_scatter(t, sub, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.sub, ctx.dim), None, None


class _SumOver(torch.autograd.Function):
    """A sum all-reduce whose backward is the identity: each member's
    partial enters the sum once, so the sum's gradient is its own."""

    @staticmethod
    def forward(ctx, t, sub):
        return _sum(t, sub)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    """The identity whose backward is a sum all-reduce: a tensor that every
    member holds whole and uses for its own part (a column-parallel
    input) gets the sum of the members' partial gradients."""

    @staticmethod
    def forward(ctx, t, sub):
        ctx.sub = sub
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.sub), None


def _grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def gather_over(t: torch.Tensor, sub: Subgroup, dim: int = 0) -> torch.Tensor:
    """The members' ``t`` concatenated along ``dim`` in index order (every
    member passes the same shape), on ``t``'s device.  Differentiable: the
    gradient is :func:`reduce_scatter_over` of the incoming one."""
    if sub.size == 1:
        return t
    return _GatherOver.apply(t, sub, dim) if _grad(t) else _gather(t, sub, dim)


def reduce_scatter_over(t: torch.Tensor, sub: Subgroup, dim: int = 0) -> torch.Tensor:
    """Block ``sub.index`` of ``t`` along ``dim`` summed over the members.
    Differentiable: the gradient is :func:`gather_over`."""
    if sub.size == 1:
        return t
    return _ReduceScatterOver.apply(t, sub, dim) if _grad(t) else _reduce_scatter(t, sub, dim)


def sum_over(t: torch.Tensor, sub: Subgroup) -> torch.Tensor:
    """Sum of the members' ``t``, the same bits on every member.
    Differentiable with the identity as backward (the row-parallel output's
    join, the vocabulary-parallel loss's partial sums)."""
    if sub.size == 1:
        return t
    return _SumOver.apply(t, sub) if _grad(t) else _sum(t, sub)


def copy_to(t: torch.Tensor, sub: Subgroup) -> torch.Tensor:
    """``t`` itself; its gradient is summed over the members (see
    :class:`_CopyTo`)."""
    if sub.size == 1 or not _grad(t):
        return t
    return _CopyTo.apply(t, sub)


def max_over(t: torch.Tensor, sub: Subgroup) -> torch.Tensor:
    """Elementwise maximum of the members' ``t`` (exact in any order; no
    gradient)."""
    if sub.size == 1:
        return t
    if _mk.TRACE is not None:
        _mk.TRACE.collective("max_over", t, peers=sub.ranks, reduce_op="max",
                             site="core.comm.max_over")
        return t.detach().clone()
    dist = _dist()
    w = _wire(t).clone()
    dist.all_reduce(w, op=dist.ReduceOp.MAX, group=sub.handle)
    return w.to(t.device)


def gather_to_first(items) -> list:
    """For each ``(t, sub)`` of ``items``, the members' ``t`` in index order
    on rank 0 (the checkpoint's writer), None elsewhere: only a subgroup
    that holds rank 0, at its index 0, communicates; its other members
    send it their ``t``.  Every message of every item is posted at once
    (point-to-point, item ``i`` under tag ``_TAG_GATHER + i``), so that the
    transfers overlap; host tensors under staging."""
    out, ops = [], []
    dist = _dist() if _mk.TRACE is None else None
    for i, (t, sub) in enumerate(items):
        if 0 not in sub.ranks:
            out.append(None)
            continue
        if sub.ranks[0] != 0:
            raise ValueError(f"gather_to_first: rank 0 must come first in {sub.ranks}")
        if _mk.TRACE is not None:
            _mk.TRACE.collective("gather_to_first", t, peers=sub.ranks,
                                 site="core.comm.gather_to_first")
            out.append([t.clone() for _ in sub.ranks] if rank() == 0 else None)
            continue
        if rank() != 0:
            ops.append(dist.P2POp(dist.isend, _wire(t), 0, tag=_TAG_GATHER + i))
            out.append(None)
            continue
        parts = [t] + [_buffer(t) for _ in sub.ranks[1:]]
        ops += [dist.P2POp(dist.irecv, buf, peer, tag=_TAG_GATHER + i)
                for buf, peer in zip(parts[1:], sub.ranks[1:])]
        out.append(parts)
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()
    return out


def init_from_env(backend: str) -> bool:
    """Join the group that ``torchrun`` describes (``WORLD_SIZE`` above 1 in
    the environment, ``MASTER_ADDR``/``MASTER_PORT``, ``RANK``) with the
    caller's ``backend``, unless a group exists already (the caller's).
    Returns True when this call made the group (:func:`destroy` ends it)."""
    if initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    _dist().init_process_group(backend)
    return True


def destroy() -> None:
    """End the default group (a no-op without one)."""
    if initialized():
        _dist().destroy_process_group()


def barrier() -> None:
    """Wait for every process of the default group (a no-op without one)."""
    if _mk.TRACE is not None:
        _mk.TRACE.collective("barrier", site="core.comm.barrier")
        return
    if initialized():
        _dist().barrier()


def exchange_through_store(key: str, payload: bytes, timeout: float) -> list:
    """Every process's ``payload`` (this one's included), in rank order,
    through the default group's key-value store under ``key``; None for a
    process that did not publish within ``timeout`` seconds.  No
    collective is issued, so processes that disagree cannot hang here."""
    store = _dist().distributed_c10d._get_default_store()
    store.set(f"{key}/{rank()}", payload)
    deadline = time.monotonic() + timeout
    out = []
    for r in range(world_size()):
        k = f"{key}/{r}"
        try:
            left = max(deadline - time.monotonic(), 0.001)
            store.wait([k], datetime.timedelta(seconds=left))
            out.append(store.get(k))
        except RuntimeError:   # the store's timeout (DistStoreError is one)
            out.append(None)
    return out


__all__ = ["Subgroup", "all_gather", "all_reduce", "backend", "barrier", "copy_to", "destroy",
           "exchange_through_store", "gather_over", "gather_to_first", "init_from_env",
           "initialized", "max_over", "new_groups", "rank", "reduce_scatter_over", "sendrecv",
           "shift", "sum_over", "world_size"]
