"""The port's LM models: the Mamba-2 path (``ssm``), global and
sliding-window attention (``attention``), the MoE FFN (``moe``), the dense
FFN and the residual blocks (``blocks``), the model (``transformer``), its
parameter specs and layers."""

from . import attention, blocks, layers, moe, params, ssm, transformer
from .transformer import Model

__all__ = ["attention", "blocks", "layers", "moe", "params", "ssm", "transformer", "Model"]
