"""The optimizer (the JAX package's ``optim/``): AdamW with float32,
bfloat16 or int8 moments and their specs over a mesh
(``state_shardings``), the int8 block code, the learning-rate schedules,
and the int8 compressed all-reduce with error feedback (``compress``)."""

from . import compress, quant, schedule
from .adamw import AdamWCfg, global_norm, init, state_shardings, state_specs, update

__all__ = ["AdamWCfg", "init", "update", "global_norm", "state_shardings", "state_specs",
           "compress", "quant", "schedule"]
