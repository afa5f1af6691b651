from .kernel import heat_step_cuda
from .ops import heat_step
from .ref import heat_step_ref

__all__ = ["heat_step", "heat_step_cuda", "heat_step_ref"]
