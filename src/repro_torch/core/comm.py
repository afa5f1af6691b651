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
* :func:`barrier`, and what a process needs to know of the group
  (:func:`initialized`, :func:`world_size`, :func:`rank`);
* :func:`exchange_through_store` — bytes of every process through the
  group's key-value store (no collective: a process that never publishes
  is a timeout, not a hang), for the analyzer's cross-process check.

Under an analyzer check (:mod:`repro_torch.analysis`) the five
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

import datetime
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


__all__ = ["all_gather", "all_reduce", "backend", "barrier", "exchange_through_store",
           "initialized", "rank", "sendrecv", "shift", "world_size"]
