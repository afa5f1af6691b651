"""Communication hiding — the paper's ``@hide_communication`` on CUDA streams.

Each time step is split as the paper does it: (1) compute the thin boundary
shell of the output, (2) exchange the halos of those fresh boundary values
on a high-priority side stream, (3) compute the much larger interior on the
current stream at the same time.  The reference could only expose this
dependence structure to XLA's scheduler; here the streams are explicit.  On
the CPU the same three phases run in sequence.  Under a process group the
exchange of step (2) includes the point-to-point messages to neighbouring
processes (:mod:`.comm`), issued from the side stream.

``hide_communication(topo, step_fn, inputs, width, halo)`` is bitwise equal
to ``update_halo(topo, step_fn(*inputs))``.  Conventions:

* ``step_fn(*inputs) -> out`` (tensor or tuple), acting on the trailing
  ``ndims`` local axes with the block axes as a batch, every output the same
  shape as every input;
* the output's outer ring passes through the matching input: output ``k``
  keeps the ring of ``inputs[k]``;
* ``step_fn`` is shape-polymorphic (it also runs on slabs).

``hide_apply(topo, op_fn, u, *extra, halo)`` is the dual for a solver's
operator, which needs fresh halos of its *input*: it equals
``op_fn(update_halo(topo, u), *extra)`` and leaves ``u`` as it was.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..analysis import markers as _mk
from .halo import update_halo
from .topology import CartesianTopology


def hide_communication(
    topo: CartesianTopology,
    step_fn: Callable,
    inputs: Sequence[torch.Tensor],
    width: int | Sequence[int] = 2,
    halo: int = 1,
):
    """Boundary-first step with the halo exchange overlapped (fields
    ``(*local_dims, *local)``).

    ``width[d]`` is the boundary-shell thickness along grid dim ``d`` (the
    paper's ``@hide_communication (16, 2, 2)`` tuple), clamped to >= halo so
    the halo send slabs lie inside the freshly computed shell.
    """
    inputs = tuple(inputs)
    nd = topo.ndims
    ref = inputs[0]
    if ref.ndim != 2 * nd:
        raise ValueError(
            f"hide_communication expects fields (*dims, *local) of rank {2 * nd}, "
            f"got rank {ref.ndim}")
    h = int(halo)
    if isinstance(width, int):
        width = (width,) * nd
    w = tuple(max(int(wd), h) for wd in width)
    shape = tuple(ref.shape[nd:])
    for d in range(nd):
        if shape[d] < 2 * (w[d] + h):
            raise ValueError(
                f"local extent {shape[d]} too small for shell width {w[d]} + halo {h}")

    def run(slabs):
        res = step_fn(*slabs)
        return tuple(res) if isinstance(res, (tuple, list)) else (res,)

    # ---- 1. boundary shell: two face slabs per grid dim ----------------
    # Each slab spans the full extent of the other dims.  Its output is
    # copied from the ring up to the shell's inner edge, so the ring passes
    # through the step (output k keeps the ring of inputs[k]); corners are
    # written again by later faces with the same values.
    outs = None
    for d in range(nd):
        ax, n, wd = nd + d, shape[d], w[d]
        lo = run(tuple(A.narrow(ax, 0, 2 * h + wd) for A in inputs))
        hi = run(tuple(A.narrow(ax, n - 2 * h - wd, 2 * h + wd) for A in inputs))
        if outs is None:
            outs = [torch.empty(inputs[k].shape, dtype=lo[k].dtype, device=lo[k].device)
                    for k in range(len(lo))]
        for k in range(len(outs)):
            outs[k].narrow(ax, 0, h + wd).copy_(lo[k].narrow(ax, 0, h + wd))
            outs[k].narrow(ax, n - h - wd, h + wd).copy_(hi[k].narrow(ax, h, h + wd))

    blocks = (slice(None),) * nd
    interior_in = tuple(
        A[blocks + tuple(slice(w[d], shape[d] - w[d]) for d in range(nd))] for A in inputs)
    sl_local = blocks + tuple(slice(h, shape[d] - 2 * w[d] - h) for d in range(nd))
    sl_global = blocks + tuple(slice(w[d] + h, shape[d] - w[d] - h) for d in range(nd))

    def interior():
        int_out = run(interior_in)
        for k in range(len(outs)):
            outs[k][sl_global].copy_(int_out[k][sl_local])

    if ref.device.type == "cuda" and _mk.TRACE is None:
        # ---- 2. exchange of the fresh shell on a high-priority stream ----
        # The exchange reads the send slabs [h, 2h) / [n-2h, n-h) inside
        # the shell and writes the halo planes; the interior writes only
        # [w+h, n-w-h) in every dim.  The two touch disjoint cells.  NCCL
        # messages are ordered after the side stream's work and the side
        # stream waits for them.  gloo stages the slabs through host
        # memory: the host waits for the shell inside this block, so the
        # interior is issued only after the exchange and nothing overlaps
        # (correct, and the order of events is the same).
        cur = torch.cuda.current_stream(ref.device)
        side = torch.cuda.Stream(device=ref.device, priority=-1)
        shell_done = cur.record_event()
        with torch.cuda.stream(side):
            side.wait_event(shell_done)
            update_halo(topo, *outs, width=h)
            for t in outs:
                t.record_stream(side)
            exchanged = side.record_event()
        # ---- 3. interior on the current stream, concurrently -----------
        interior()
        cur.wait_event(exchanged)
    else:   # the CPU, and an analyzer check (which records the same three phases)
        update_halo(topo, *outs, width=h)
        interior()
    # Contract for the analyzer: the exchange above sent the fresh boundary
    # shell, written BEFORE it, so the output's ghosts are fresh although
    # the interior write lands after it (which the plain min-rule can't see).
    if _mk.TRACE is not None:
        for A in outs:
            _mk.exchange_out(A, width=h, site="core.hide.hide_communication.contract",
                             contract=True)
    return outs[0] if len(outs) == 1 else tuple(outs)


def hide_apply(topo: CartesianTopology, op_fn: Callable, u: torch.Tensor, *extra: torch.Tensor,
               halo: int = 1) -> torch.Tensor:
    """Operator application with fresh halos of its input (fields
    ``(*dims, *local)``): ``op_fn(update_halo(topo, u, width=halo), *extra)``,
    but ``u`` itself is not written, as the reference's functional form.

    The exchange goes into a copy of ``u`` and the operator runs once on it.
    On one card the exchange is a copy between blocks of the same tensor,
    so there is nothing to hide it behind: the overlapped form (the bulk on
    stale halos on the current stream; the exchange into a copy and the
    shells ``[h, 2h)`` / ``[n-2h, n-h)`` recomputed on a side stream) was
    slower than this one on an H100 (``PERF.md``, the two-phase findings).
    Under a process group the exchange crosses processes; the overlapped
    form for that case is not written yet (``ROADMAP.md``).
    """
    nd = topo.ndims
    if u.ndim != 2 * nd:
        raise ValueError(
            f"hide_apply expects fields (*dims, *local) of rank {2 * nd}, got rank {u.ndim}")
    ub = update_halo(topo, u.clone(), width=int(halo))
    # the exchanged copy is the operand the contract names (an analyzer
    # marker; the redundancy rule does not pair it with a later exchange)
    _mk.exchange_out(ub, width=int(halo), site="core.hide.hide_apply.contract", contract=True)
    return op_fn(ub, *extra)
