"""The event trace of one check, and the dispatch mode that records it.

The JAX package's rules walk a jaxpr.  Here a check RUNS the code once
under :class:`Trace`: a ``TorchDispatchMode`` sees every aten op and runs it
on a meta shadow of its operands, so no op reaches a device, no kernel is
launched and no value is read (a host read raises :class:`HostReadError`).
Tensors that existed before the check get a meta shadow of their storage
(views share it); writes into them land in the shadow, so the real tensors
are left as they were.

Per storage (what the reference keeps per jaxpr variable) the trace keeps:

* ghost validity — how many ghost planes are fresh.  Inputs and tensors
  made before the check start at the grid's halo width; every op gives its
  outputs the minimum over its tensor inputs (0-d scalars included, as in
  the reference); an in-place write lowers the written storage to the
  minimum of its own and its inputs'; ``exchange_out`` raises it to the
  exchanged width; a ``consume`` alias reads ``radius`` planes less;
* provenance tags — ``"reduce"`` (a blessed all-reduce operand),
  ``"mask"`` (an ownership/interior mask), ``"const"`` (a field of rank
  >= 2 made before the check and not an input: the reference's constant
  terminal), ``"big:<dtype>"`` (a local reduction over a field of rank >=
  2), joined by union through every op: the forward form of the
  reference's backward cone;
* a write counter and the last exchange, for the redundancy rule.

The recorded events are the collectives (op, dtype, shape, peers, the
operand's tags), the halo exchanges' peer tables and the kernels' launch
plans; the rules of :mod:`.congruence`, :mod:`.reductions_lint` and
:mod:`.launchgrid` read them afterwards.  The staleness rule
(:mod:`.staleness`) runs as the ops run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

from . import markers, staleness

aten = torch.ops.aten

# ops that read only their input's shape and dtype: fresh outputs, no provenance
_SHAPE_ONLY = {aten.empty_like, aten.zeros_like, aten.ones_like, aten.full_like, aten.rand_like,
               aten.randn_like, aten.new_empty, aten.new_zeros, aten.new_ones, aten.new_full,
               aten.new_empty_strided}
# local reductions: an input of rank >= 2 reduced to fewer elements
_REDUCTIONS = {aten.sum, aten.nansum, aten.mean, aten.prod, aten.amax, aten.amin, aten.max,
               aten.min, aten.argmax, aten.argmin, aten.linalg_vector_norm, aten.norm}


_META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class _OpInfo:
    mutated: tuple        # (index, name) of arguments the op writes
    views: bool           # an output aliases an input
    shape_only: bool
    reduction: bool


_INFO: dict = {}


def _op_info(func) -> _OpInfo:
    info = _INFO.get(func)
    if info is None:
        sch = func._schema
        info = _INFO[func] = _OpInfo(
            mutated=tuple((i, a.name) for i, a in enumerate(sch.arguments)
                          if a.alias_info is not None and a.alias_info.is_write),
            views=any(r.alias_info is not None and not r.alias_info.is_write
                      for r in sch.returns),
            shape_only=func.overloadpacket in _SHAPE_ONLY,
            reduction=func.overloadpacket in _REDUCTIONS)
    return info


def _tensors(seq) -> list:
    out = []
    for a in seq:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _sig(seq) -> tuple:
    """What a functional op's output shapes, strides and dtypes depend on."""
    out = []
    for a in seq:
        if isinstance(a, torch.Tensor):
            out.append((tuple(a.shape), a.stride(), a.dtype))
        elif isinstance(a, (list, tuple)):
            out.append(_sig(a))
        elif isinstance(a, float):
            out.append(float)
        elif isinstance(a, complex):
            out.append(complex)
        else:
            out.append(a)
    return tuple(out)


def _spec(out):
    if isinstance(out, torch.Tensor):
        return ("t", tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        return ("s", type(out), tuple(_spec(o) for o in out))
    return ("v", out)


def _make(spec):
    if spec[0] == "t":
        return torch.empty_strided(spec[1], spec[2], dtype=spec[3], device=_META)
    if spec[0] == "s":
        return spec[1](_make(s) for s in spec[2])
    return spec[1]


class HostReadError(RuntimeError):
    """A value was read on the host inside a check (it holds no values)."""


@dataclasses.dataclass
class _Storage:
    valid: int
    tags: frozenset
    writes: int = 0
    last_exchange: tuple | None = None   # (width, site, contract, writes)


class Trace:
    """Everything one check records.  ``halo`` is the validity of inputs
    and of tensors made before the check; ``device_type`` the device the
    checked code would run on (kernel dispatch sees it for meta tensors).
    A captured loop body runs ``passes`` times: a stale read shows by the
    pass after validity reaches 0, and never fewer than two."""

    def __init__(self, halo: int = 1, device_type: str = "cpu"):
        self.halo = int(halo)
        self.device_type = device_type
        self.passes = max(2, self.halo + 1)
        self.collectives: list[dict] = []
        self.tables: list[dict] = []
        self.launches: list = []
        self.findings: dict = {}          # (rule, site) -> the latest Finding
        self._st: dict[int, _Storage] = {}
        self._bases: dict = {}            # (real storage, dtype) -> meta base
        self._keep: list = []             # real tensors shadowed (their storages stay unique)
        self._over: dict = {}             # id(alias) -> (weakref, validity, writes)
        self._loops: dict[str, int] = {}
        self._cache: dict = {}            # functional op signature -> output spec

    # ------------------------------------------------------------------
    # shadows and per-storage state
    # ------------------------------------------------------------------
    @staticmethod
    def _key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def shadow(self, t: torch.Tensor) -> torch.Tensor:
        """The meta tensor standing for ``t`` (``t`` itself if meta)."""
        if t.device.type == "meta":
            return t
        key = (self._key(t), t.dtype)
        with _disable_current_modes():
            base = self._bases.get(key)
            if base is None:
                n = t.untyped_storage().nbytes() // t.element_size()
                base = torch.empty(max(n, 1), dtype=t.dtype, device="meta")
                self._bases[key] = base
                self._keep.append(t)
                self._st[self._key(base)] = self._fresh_state(t.ndim)
            return base.as_strided(t.size(), t.stride(), t.storage_offset())

    def _fresh_state(self, ndim: int) -> _Storage:
        return _Storage(self.halo, frozenset({"const"}) if ndim >= 2 else frozenset())

    def state(self, t: torch.Tensor) -> _Storage:
        s = self.shadow(t)
        k = self._key(s)
        st = self._st.get(k)
        if st is None:   # a meta tensor made before the check
            st = self._st[k] = self._fresh_state(s.ndim)
        return st

    def valid(self, t: torch.Tensor) -> int:
        s = self.shadow(t)
        st = self.state(s)
        o = self._over.get(id(s))
        if o is not None and o[0]() is s and o[2] == st.writes:
            return o[1]
        return st.valid

    def register_inputs(self, tensors) -> None:
        """Program inputs: fresh at the halo width, not mask evidence."""
        for t in tensors:
            if isinstance(t, torch.Tensor):
                st = self.state(t)
                st.tags = st.tags - {"const"}

    def tag(self, t: torch.Tensor, name: str) -> None:
        st = self.state(t)
        st.tags = st.tags | {name}

    def add(self, f) -> None:
        """Record a finding; a later one with the same rule and site (a
        later pass of a loop body, closer to the fixpoint) replaces it."""
        self.findings.pop((f.rule, f.site), None)
        self.findings[(f.rule, f.site)] = f

    # ------------------------------------------------------------------
    # the dispatch mode's transfer function
    # ------------------------------------------------------------------
    def dispatch(self, func, args, kwargs):
        if func is aten._local_scalar_dense.default:
            raise HostReadError(
                "a value was read on the host inside an analyzer check; checks run on "
                "meta shadows and hold no values")
        info = _op_info(func)
        back = {}                      # id(shadow) -> the caller's tensor

        def sh(a):
            if isinstance(a, torch.Tensor):
                s = self.shadow(a)
                back[id(s)] = a
                return s
            if isinstance(a, (list, tuple)):
                return type(a)(sh(x) for x in a)
            return _META if isinstance(a, torch.device) else a

        margs = tuple(sh(a) for a in args)
        mkwargs = {k: sh(v) for k, v in kwargs.items()}
        ins = _tensors(margs) + _tensors(tuple(mkwargs.values()))
        out = self._run(func, info, margs, mkwargs, ins)
        if info.shape_only:
            ins = []
        v = min((self.valid(a) for a in ins), default=self.halo)
        tags = frozenset().union(*(self.state(a).tags for a in ins))
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        if (info.reduction and ins and ins[0].ndim >= 2 and outs
                and outs[0].numel() < ins[0].numel()):
            tags = tags | {f"big:{ins[0].dtype}"}
        written = set()
        for i, name in info.mutated:
            val = margs[i] if i < len(margs) else mkwargs.get(name)
            for t in _tensors(val if isinstance(val, (list, tuple)) else (val,)):
                st = self.state(t)
                vin = min((self.valid(o) for o in ins if o is not t), default=self.halo)
                st.valid = min(st.valid, vin)
                st.tags = st.tags | tags
                st.writes += 1
                written.add(self._key(t))
        if not written or info.views:
            in_keys = {self._key(a): a for a in ins}
            for o in outs:
                k = self._key(o)
                if k in written:
                    continue
                src = in_keys.get(k)
                if src is not None:          # a view: the storage keeps its state
                    ov = self._over.get(id(src))
                    if ov is not None and ov[0]() is src:
                        self._over[id(o)] = (weakref.ref(o), ov[1], ov[2])
                    continue
                self._st[k] = _Storage(v, tags)
        # an in-place op returns its operand: hand back the caller's tensor
        if isinstance(out, torch.Tensor):
            return back.get(id(out), out)
        if isinstance(out, (list, tuple)):
            return type(out)(back.get(id(o), o) if isinstance(o, torch.Tensor) else o
                             for o in out)
        return out

    def _run(self, func, info, margs, mkwargs, ins):
        """``func`` on the meta shadows.  A functional op's outputs depend
        only on its inputs' shapes, strides and dtypes and its non-float
        arguments: after the first call with a signature they are made
        with ``empty_strided`` (the meta kernels run in Python and are the
        cost of a check); an in-place op's result is its operand."""
        if info.mutated and not info.views and func._schema.returns:
            i, name = info.mutated[0]
            if len(info.mutated) == 1 and not isinstance(
                    margs[i] if i < len(margs) else mkwargs.get(name), (list, tuple)):
                return margs[i] if i < len(margs) else mkwargs.get(name)
        if info.views or info.mutated:
            return func(*margs, **mkwargs)
        try:
            key = (func, _sig(margs), _sig(tuple(mkwargs.items())))
            hash(key)
        except TypeError:
            return func(*margs, **mkwargs)
        spec = self._cache.get(key)
        if spec is None:
            out = func(*margs, **mkwargs)
            self._cache[key] = _spec(out)
            return out
        return _make(spec)

    # ------------------------------------------------------------------
    # markers
    # ------------------------------------------------------------------
    def exchange_in(self, x, width: int, site: str) -> None:
        staleness.exchange_in(self, self.state(x), width, site)

    def exchange_out(self, x, width: int, site: str, contract: bool) -> None:
        st = self.state(x)
        st.valid = max(st.valid, width)
        st.writes += 1   # the exchange wrote the ring: every consume alias of it is fresh again
        st.last_exchange = (width, site, contract, st.writes)

    def consume(self, x, radius: int, site: str):
        s = self.shadow(x)
        v = self.valid(s)
        staleness.consume(self, v, radius, site)
        # a stencil read its exchange: a later exchange of this storage is
        # not back-to-back (the operator's exchange of a solver's iterate,
        # which the reference's functional exchange leaves unexchanged)
        self.state(s).last_exchange = None
        with _disable_current_modes():
            a = s.as_strided(s.size(), s.stride(), s.storage_offset())
        self._over[id(a)] = (weakref.ref(a), max(v - radius, 0), self.state(s).writes)
        return a

    def loop_pass(self, site: str, first: bool) -> bool:
        if first:
            self._loops[site] = 0
            return True
        n = self._loops.get(site, 0) + 1
        self._loops[site] = n
        return n < self.passes

    # ------------------------------------------------------------------
    # collectives, peer tables and kernel launches: recorded, not run
    # ------------------------------------------------------------------
    def collective(self, op: str, x=None, *, peers=(), reduce_op=None, site: str = "") -> None:
        self.collectives.append(dict(
            op=op, dtype=None if x is None else str(x.dtype),
            shape=None if x is None else tuple(x.shape), peers=tuple(peers),
            reduce=reduce_op, site=site,
            tags=frozenset() if x is None else self.state(x).tags))

    def sendrecv(self, to_low, to_high, low, high):
        like = to_low if to_low is not None else to_high
        self.collectives.append(dict(op="sendrecv", dtype=str(like.dtype),
                                     shape=tuple(like.shape), peers=(low, high), reduce=None,
                                     site="core.comm.sendrecv", tags=frozenset()))
        # what arrives is a neighbour's slab: as fresh as what this one sends
        return (None if low is None else to_high.clone(),
                None if high is None else to_low.clone())

    def shift(self, x, src, dst):
        self.collectives.append(dict(op="shift", dtype=str(x.dtype), shape=tuple(x.shape),
                                     peers=(src, dst), reduce=None, site="core.comm.shift",
                                     tags=frozenset()))
        # what arrives is a neighbour's tensor of this shape; zeros without a source
        return x.clone() if src is not None else torch.zeros_like(x)

    def table(self, **entry) -> None:
        self.tables.append(entry)

    def kernel(self, plan, inputs, n_out: int = 1):
        """A kernel launch under a check: its plan is recorded and its
        outputs are meta tensors as fresh as the least fresh input (the
        reference's rule for a ``pallas_call``)."""
        self.launches.append(plan)
        ins = [t for t in inputs if t is not None]
        v = min(self.valid(t) for t in ins)
        tags = frozenset().union(*(self.state(t).tags for t in ins))
        with _disable_current_modes():
            outs = [torch.empty(ins[0].shape, dtype=ins[0].dtype, device="meta")
                    for _ in range(n_out)]
        for o in outs:
            self._st[self._key(o)] = _Storage(v, tags)
        return outs[0] if n_out == 1 else tuple(outs)

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def recording(self, inputs=()):
        """Run the enclosed code under this trace."""
        if markers.TRACE is not None:
            raise RuntimeError("an analyzer check is already recording in this thread")
        markers.TRACE = self
        try:
            with _Mode(self):
                self.register_inputs(inputs)
                yield self
        finally:
            markers.TRACE = None


class _Mode(TorchDispatchMode):
    def __init__(self, trace: Trace):
        super().__init__()
        self.trace = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return self.trace.dispatch(func, args, kwargs or {})
