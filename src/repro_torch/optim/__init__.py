"""The optimizer: AdamW with float32, bfloat16 or int8 moments, the int8
block code and the learning-rate schedules (the JAX package's ``optim/``
but for ``compress.py``, which comes with the sharding slice)."""

from . import quant, schedule
from .adamw import AdamWCfg, global_norm, init, state_specs, update

__all__ = ["AdamWCfg", "init", "update", "global_norm", "state_specs", "quant", "schedule"]
