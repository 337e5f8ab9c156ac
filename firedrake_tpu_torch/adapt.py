"""Adaptive refinement (the JAX package's adapt.py: conforming
newest-vertex-bisection refinement of marked cells).  Not ported yet: both
entry points raise, naming their ROADMAP.md item, so that a script that
swaps its import line stops here with a reason."""
from __future__ import annotations

_ITEM = "is not ported yet: ROADMAP.md queue 1, item 18"


def refine_marked(mesh, markers):
    raise NotImplementedError(f"refine_marked (adaptive refinement) {_ITEM}")


def adapt(mesh, indicator, refine_fraction=0.5, **kwargs):
    raise NotImplementedError(f"adapt (adaptive refinement) {_ITEM}")
