from .reference_cell import ReferenceCell, by_name, simplex
from .quadrature import QuadratureRule, make_quadrature
from .finite_element import FiniteElement, VectorElement, TensorElement
from .lagrange import (Lagrange, DiscontinuousLagrange, make_scalar_element)
from .trace import HDivTrace, BrokenElement

__all__ = [
    "ReferenceCell", "by_name", "simplex",
    "QuadratureRule", "make_quadrature",
    "FiniteElement", "VectorElement", "TensorElement",
    "Lagrange", "DiscontinuousLagrange", "make_scalar_element",
    "HDivTrace", "BrokenElement",
]
