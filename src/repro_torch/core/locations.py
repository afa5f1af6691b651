"""Staggering locations — the canonical table the halo exchange checks.

A grid array carries a *location*: ``center`` (entry ``i`` at node ``i``)
or ``xface``/``yface``/``zface`` (entry ``i`` along the staggered dim at the
face ``i + 1/2``; the trailing plane is a dead plane).  Under this
shape-uniform convention the halo exchange is location-independent; it only
rejects unknown names.  ``STAGGER_DIM`` maps each location to the grid
dimension it is staggered along.  Mask builders wait for the solver layer.
"""

from __future__ import annotations

LOCATIONS = ("center", "xface", "yface", "zface")
STAGGER_DIM = {"center": None, "xface": 0, "yface": 1, "zface": 2}
