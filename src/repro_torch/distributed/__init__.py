"""Distribution layer: the ``shard_map`` collectives of the JAX package's
``distributed/`` over the processes of a ``torch.distributed`` group
(halo sequence parallelism, ring attention, the flash-decoding combine,
context parallelism, GPipe pipelining).  The reference's mesh axis is the
default group (:mod:`.axis`); all traffic goes through
:mod:`repro_torch.core.comm`.  The GSPMD sharding rules (``sharding.py``)
are not ported yet."""

from . import axis, context_parallel, pipeline, ring, seqpar

__all__ = ["axis", "context_parallel", "pipeline", "ring", "seqpar"]
