"""The distributed-correctness analyzer of the port.

Four rule families over what a check records while it runs the code on
meta shadows (:mod:`.trace`) — collective congruence (peer tables, and the
processes' collective sequences compared through the group's store),
halo-staleness dataflow, the hand-written kernels' launch plans, and
reduction exactness — with typed findings, a baseline/suppression file in
the JAX package's format, and a CLI (``python -m repro_torch.analysis``)
that sweeps the app matrix.  The counterpart of the JAX package's
``repro.analysis``, which walks a jaxpr instead.

Import side effects are kept near zero: the layers of the port import only
:mod:`.markers` (and :mod:`.capture`), each call of which is one falsy test
outside a check; the rest loads on first attribute access.
"""

from __future__ import annotations

_LAZY = {
    "check": ("driver", "check"),
    "capture_check": ("driver", "capture_check"),
    "analyze": ("driver", "analyze"),
    "sweep": ("driver", "sweep"),
    "merged": ("driver", "merged"),
    "Finding": ("findings", "Finding"),
    "Report": ("findings", "Report"),
    "Baseline": ("findings", "Baseline"),
    "CaptureDone": ("capture", "CaptureDone"),
    "capture_solves": ("capture", "capture_solves"),
    "stencil_read": ("markers", "stencil_read"),
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(f".{mod_name}", __name__)
    value = getattr(mod, attr)
    globals()[name] = value
    return value
