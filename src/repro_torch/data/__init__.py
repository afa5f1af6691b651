"""Synthetic language-model data (the JAX package's ``data/``)."""

from .pipeline import (SyntheticLMData, batch_logical_axes, batch_specs, local_rows,
                       synthetic_batch)

__all__ = ["SyntheticLMData", "synthetic_batch", "batch_specs", "batch_logical_axes",
           "local_rows"]
