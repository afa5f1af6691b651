"""The paper's effective-memory-throughput metric.

Iterative stencil codes are memory-bound, so the figure of merit is how
fast the *necessary* data moves:

    T_eff = A_eff / t_it,    A_eff = (2 * D_u + D_k) * n_cells * itemsize

— every *unknown* field (updated each iteration) is read and written once,
every *known* field (coefficients) read once; halo duplicates, temporaries
and any extra traffic an implementation incurs are not counted.  ``T_eff``
therefore lower-bounds the achieved memory throughput.
"""

from __future__ import annotations


def a_eff(n_cells: int, n_unknown_fields: int, n_known_fields: int,
          itemsize: int) -> int:
    """Effective bytes moved per iteration: ``(2 D_u + D_k) * n * size``."""
    return (2 * int(n_unknown_fields) + int(n_known_fields)) \
        * int(n_cells) * int(itemsize)


def t_eff(a_eff_bytes: float, t_it_s: float) -> float:
    """Effective memory throughput in GB/s (paper convention)."""
    if t_it_s <= 0:
        return float("nan")
    return float(a_eff_bytes) / float(t_it_s) / 1e9
