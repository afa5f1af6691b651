"""Distribution layer: the JAX package's ``distributed/`` over the processes
of a ``torch.distributed`` group.  The ``shard_map`` collectives (halo
sequence parallelism, ring attention, the flash-decoding combine, context
parallelism, GPipe pipelining) take the default group as the reference's
mesh axis (:mod:`.axis`); the GSPMD sharding rules (:mod:`.sharding`) map
logical axes onto a process mesh (``repro_torch.launch.mesh``) for sharded
training.  All traffic goes through :mod:`repro_torch.core.comm`."""

from . import axis, context_parallel, pipeline, ring, seqpar, sharding

__all__ = ["axis", "context_parallel", "pipeline", "ring", "seqpar", "sharding"]
