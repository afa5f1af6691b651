"""Architecture configs the port runs (dataclasses only, no weights)."""

from . import base
from .base import Layer, ModelCfg, MoECfg, SSMCfg, get, names

__all__ = ["base", "ModelCfg", "MoECfg", "SSMCfg", "Layer", "get", "names"]
