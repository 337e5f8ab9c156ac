"""Function / Cofunction / Constant containers.

Reference: firedrake/function.py:213 (Function over a pyop2.Dat),
firedrake/cofunction.py:22, firedrake/constant.py:43.  Here the dat is a
flat torch tensor of length V.dim — node-major, component-minor — on the
device set with ``set_device`` (float64 unless assigned otherwise)."""
from __future__ import annotations

import numpy as np
import torch

from .language.core import Coefficient, ConstantBase
from .functionspace import FunctionSpace
from .device import as_tensor, get_device


class Function(Coefficient):
    """A field in a FunctionSpace; usable directly in forms."""

    def __init__(self, V: FunctionSpace, val=None, name: str | None = None,
                 dtype=None):
        if isinstance(V, Function):   # Function(Function) copies
            other = V
            V = other.function_space()
            super().__init__(V)
            self.dat = as_tensor(other.dat).clone()
            self.name = name or f"{other.name}_copy"
            return
        if type(V).__name__ == "MixedFunctionSpace":
            raise NotImplementedError("mixed spaces are not ported yet")
        super().__init__(V)
        self.name = name or f"f_{self.count}"
        if val is not None:
            v = as_tensor(val).reshape(-1)
            if v.numel() != V.dim:
                raise ValueError(f"value of size {v.numel()} for a space "
                                 f"of dimension {V.dim}")
            self.dat = v
        else:
            self.dat = torch.zeros(V.dim, dtype=dtype or torch.float64,
                                   device=get_device())

    @property
    def dat(self):
        return self._dat

    @dat.setter
    def dat(self, value):
        self._dat = as_tensor(value).reshape(-1)

    # ------------------------------------------------------------- access
    def function_space(self):
        return self.space

    def copy(self, deepcopy=True):
        return Function(self)

    def zero(self):
        self.dat = torch.zeros_like(self.dat)
        return self

    # ------------------------------------------------------------- assign
    def assign(self, expr, subset=None):
        """u.assign(v), u.assign(2*v + w), u.assign(scalar) — pointwise on
        dats (reference: firedrake/assign.py:35 CoefficientCollector)."""
        val = _eval_pointwise(expr, self.space)
        if isinstance(val, (int, float)):
            self.dat = torch.full((self.space.dim,), float(val),
                                  dtype=torch.float64, device=get_device())
        else:
            self.dat = val
        return self

    def interpolate(self, expr):
        from .interpolation import interpolate_onto
        interpolate_onto(expr, self)
        return self

    def project(self, expr, **kwargs):
        """The L2 projection of expr into this Function's space."""
        from .projection import project
        return project(expr, self, **kwargs)

    # ----------------------------------------------- not yet ported
    def sub(self, i):
        _unported("Function.sub", 14)

    def split(self):
        _unported("Function.split", 14)

    @property
    def subfunctions(self):
        _unported("Function.subfunctions", 14)

    def at(self, *args, **kwargs):
        _unported("Function.at (point evaluation)", 18)

    def __call__(self, arg):
        # u('+') / u('-') restrict, as for every Coefficient
        if isinstance(arg, str) and arg in ("+", "-"):
            return super().__call__(arg)
        _unported("Function(x) (point evaluation)", 18)

    def vector(self):
        _unported("Function.vector", 18)

    def riesz_representation(self, riesz_map="L2"):
        _unported("Function.riesz_representation", 17)

    def __repr__(self):
        return f"Function({self.name!r}, {self.space!r})"

    def __str__(self):
        return self.name


class Cofunction(Function):
    """Dual-space container (assembled 1-forms). Reference:
    firedrake/cofunction.py:22."""
    pass


class Constant(ConstantBase):
    """Spatially constant value (scalar or shaped).
    Reference: firedrake/constant.py:43."""

    def __init__(self, value, domain=None, name=None):
        super().__init__(value)
        self.name = name or f"c_{self.count}"


def _unported(what, item):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md queue "
                              f"1, item {item}")


def _eval_pointwise(expr, V):
    """Evaluate expr as a linear combination over dats for fast assign."""
    from .language.core import (ScalarValue, Sum, Product, Division, Zero)
    if isinstance(expr, (int, float)):
        return float(expr)
    if isinstance(expr, ScalarValue):
        return expr.value
    if isinstance(expr, Zero):
        return 0.0
    if isinstance(expr, ConstantBase):
        v = expr.values()
        if v.shape == ():
            return float(v)
        return as_tensor(np.tile(np.asarray(v).reshape(-1), V.num_nodes))
    if isinstance(expr, Function):
        if expr.space is not V and expr.space != V:
            raise ValueError("assign requires matching function spaces; "
                             "use interpolate")
        return expr.dat.clone()
    if isinstance(expr, (Sum, Product, Division)):
        a = _eval_pointwise(expr.operands[0], V)
        b = _eval_pointwise(expr.operands[1], V)
        if isinstance(expr, Sum):
            return a + b
        if isinstance(expr, Product):
            return a * b
        return a / b
    raise NotImplementedError(
        f"assign cannot evaluate {type(expr).__name__} pointwise; "
        "use interpolate")
