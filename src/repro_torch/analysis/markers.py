"""Recording points of the analyzer, called by the instrumented layers.

The JAX package binds an identity primitive that its rules read back out
of a jaxpr.  Eager PyTorch has no program to read, so the port records
events while a check runs the code: the layers below call these functions
in the places where the reference binds its markers, and each is ONE falsy
test of :data:`TRACE` outside a check (no tensor op, no host read, nothing
allocated), pinned by ``tests/test_torch_analysis_zero_cost.py``.  Inside a
check :data:`TRACE` is the active :class:`repro_torch.analysis.trace.Trace`,
which runs every tensor op on meta shadows and keeps, per tensor, what
the reference keeps per jaxpr variable.

Marker kinds (the reference's):

``exchange_in`` / ``exchange_out``
    Around each array's halo exchange in ``update_halo``.  ``exchange_out``
    raises ghost validity to the exchanged ``width``; ``exchange_in`` on an
    array whose last event was an ``exchange_out`` of equal or wider
    coverage, with no write or stencil read since, is a redundant
    back-to-back exchange (perf).  ``contract=True`` marks an exchange a protocol asserts
    (``hide_communication``'s output, ``hide_apply``'s operand, a solver's
    returned iterate): the redundancy rule does not pair it.

``consume``
    On the input of a stencil; declares the ghost demand ``radius``.  The
    staleness rule checks demand against validity; what the stencil
    computes from it has ``radius`` fewer fresh planes.

``reduce``
    On the operand of the blessed all-reduce wrappers of
    :mod:`repro_torch.solvers.reductions`.

``mask``
    On the outputs of ``owned_mask`` / ``interior_mask``, so the reduction
    lint can prove a global sum was ownership-masked.

The solver loops read their stopping test through :func:`loop_float` /
:func:`loop_bool` and the right-hand side norm through :func:`host`: the
same host read outside a check; inside a capture no read at all, the
capture decides how many passes of the loop body run.
"""

from __future__ import annotations

# The active trace (``repro_torch.analysis.trace.Trace``) or None.
TRACE = None


def exchange_in(x, *, width: int, site: str):
    if TRACE is None:
        return x
    TRACE.exchange_in(x, int(width), site)
    return x


def exchange_out(x, *, width: int, site: str, contract: bool = False):
    if TRACE is None:
        return x
    TRACE.exchange_out(x, int(width), site, bool(contract))
    return x


def consume(x, *, radius: int, site: str):
    """``x``, or inside a check an alias of it whose ghost validity is
    ``radius`` planes less (what a stencil computes from it)."""
    if TRACE is None:
        return x
    return TRACE.consume(x, int(radius), site)


def blessed_reduce(x, *, op: str, site: str):
    if TRACE is None:
        return x
    TRACE.tag(x, "reduce")
    return x


def mask(x, *, mask_kind: str, site: str):
    if TRACE is None:
        return x
    TRACE.tag(x, "mask")
    return x


def stencil_read(x, radius: int, site: str = "user.stencil_read"):
    """Declare that the enclosing computation reads ``radius`` ghost
    planes of ``x``.  The instrumented stencils call this internally; user
    code with hand-rolled stencils can call it too so the staleness rule
    covers custom operators."""
    return consume(x, radius=radius, site=site)


def host(t) -> float:
    """``float(t)``: a solver's host read outside its loop (the rhs norm);
    1.0 inside a capture, which reads nothing."""
    if TRACE is None:
        return float(t)
    return 1.0


def loop_float(t, *, site: str, first: bool = False) -> float:
    """``float(t)``: the residual a solver loop's stopping test reads.
    Inside a capture: +inf until the loop body at ``site`` has run its
    passes, then -inf (the loop ends); ``first`` is the read before the
    loop."""
    if TRACE is None:
        return float(t)
    return float("inf") if TRACE.loop_pass(site, first) else float("-inf")


def loop_bool(t, *, site: str, first: bool = False) -> bool:
    """``bool(t)``: a loop condition read on the host; inside a capture,
    True until the body at ``site`` has run its passes."""
    if TRACE is None:
        return bool(t)
    return TRACE.loop_pass(site, first)


def device_type(x) -> str:
    """The device type a kernel dispatch should see for ``x``: inside a
    check, tensors are meta shadows of tensors on the check's device."""
    t = x.device.type
    if t == "meta" and TRACE is not None:
        return TRACE.device_type
    return t
