"""The port's LM models: the Mamba-2 path (``ssm``, ``blocks``,
``transformer``), its parameter specs and layers."""

from . import blocks, layers, params, ssm, transformer
from .transformer import Model

__all__ = ["blocks", "layers", "params", "ssm", "transformer", "Model"]
