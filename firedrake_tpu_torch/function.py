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
    """A field in a FunctionSpace; usable directly in forms.  On a
    MixedFunctionSpace, Function(W) and Cofunction(W) make a
    MixedFunction."""

    def __new__(cls, V, *args, **kwargs):
        from .mixed import MixedFunctionSpace
        if cls in (Function, Cofunction) and isinstance(
                V, MixedFunctionSpace):
            obj = super().__new__(MixedFunction)
            # Python calls __init__ only when isinstance(obj, cls);
            # MixedFunction is not a Cofunction subclass, so init here
            if not isinstance(obj, cls):
                obj.__init__(V, *args, **kwargs)
            return obj
        return super().__new__(cls)

    def __init__(self, V: FunctionSpace, val=None, name: str | None = None,
                 dtype=None):
        if isinstance(V, Function):   # Function(Function) copies
            other = V
            V = other.function_space()
            super().__init__(V)
            self.dat = as_tensor(other.dat).clone()
            self.name = name or f"{other.name}_copy"
            return
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
        # tape the state hand-off of time loops (pyadjoint assign block)
        from .adjoint.tape import annotate_tape
        if annotate_tape() and isinstance(expr, Function):
            from .adjoint.tape import AssignBlock, get_working_tape
            get_working_tape().add_block(AssignBlock(self, expr))
        return self

    def interpolate(self, expr):
        from .interpolation import interpolate_onto
        interpolate_onto(expr, self)
        return self

    def project(self, expr, **kwargs):
        """The L2 projection of expr into this Function's space."""
        from .projection import project
        return project(expr, self, **kwargs)

    # ------------------------------------------- components (UFL split)
    def split(self):
        """A Function on a plain space is its own only component."""
        return (self,)

    @property
    def subfunctions(self):
        return (self,)

    def sub(self, i):
        if i != 0:
            raise IndexError(f"component {i} of a Function on a plain "
                             "space")
        return self

    # ----------------------------------------------- not yet ported
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
        """Primal/dual conversion (reference: cofunction.py:412
        RieszMap): 'l2' copies the dat; 'L2' and 'H1' apply the Gram
        matrix of the mass (+ stiffness) inner product to a Function, and
        solve with it (host sparse LU, as the JAX package) for a
        Cofunction."""
        if riesz_map == "l2":
            out = (Function if isinstance(self, Cofunction)
                   else Cofunction)(self.space)
            out.dat = self.dat.clone()
            return out
        if riesz_map not in ("L2", "H1"):
            raise NotImplementedError(f"riesz map {riesz_map!r}")
        from .assemble import assemble
        from .language import TestFunction, TrialFunction, inner, dx, grad
        u, v = TrialFunction(self.space), TestFunction(self.space)
        a = inner(u, v) * dx
        if riesz_map == "H1":
            a = a + inner(grad(u), grad(v)) * dx
        M = assemble(a)
        if isinstance(self, Cofunction):
            from .solving import direct_solve
            out = Function(self.space)
            out.dat = direct_solve(M, self.dat)
        else:
            out = Cofunction(self.space)
            out.dat = M.matvec(self.dat)
        return out

    def __repr__(self):
        return f"Function({self.name!r}, {self.space!r})"

    def __str__(self):
        return self.name


class Cofunction(Function):
    """Dual-space container (assembled 1-forms). Reference:
    firedrake/cofunction.py:22."""
    pass


class MixedFunction(Function):
    """Function on a MixedFunctionSpace: a tuple of per-field Functions
    sharing one logical concatenated dof vector (reference: pyop2
    MixedDat, firedrake Function.subfunctions).  ``dat`` concatenates the
    parts' device tensors; assigning it splits the value into them."""

    def __init__(self, W, val=None, name=None, dtype=None):
        Coefficient.__init__(self, W)
        self.name = name or f"w_{self.count}"
        self.parts = tuple(Function(V, name=f"{self.name}[{i}]",
                                    dtype=dtype)
                           for i, V in enumerate(W.subspaces))
        if val is not None:
            self.dat = val

    @property
    def dat(self):
        return torch.cat([p.dat for p in self.parts])

    @dat.setter
    def dat(self, value):
        W = self.space
        v = as_tensor(value).reshape(-1)
        if v.numel() != W.dim:
            raise ValueError(f"value of size {v.numel()} for a mixed space "
                             f"of dimension {W.dim}")
        for p, off in zip(self.parts, W.offsets):
            p.dat = v[int(off):int(off) + p.space.dim]

    def split(self):
        return self.parts

    @property
    def subfunctions(self):
        return self.parts

    def sub(self, i):
        return self.parts[i]

    def __getitem__(self, idx):
        """Flat value-component indexing, the ufl mixed-element
        convention: subspace components concatenate, so w[2] on
        RT1 x DG0 is the DG scalar and w[0], w[1] are the RT vector's
        components (reference: ufl MixedElement extract_component)."""
        single = idx[0] if (isinstance(idx, tuple)
                            and len(idx) == 1) else idx
        if isinstance(single, (int, np.integer)):
            i = int(single)
            for p in self.parts:
                vs = p.space.value_shape
                n = int(np.prod(vs)) if vs else 1
                if i < n:
                    return p[i] if vs else p
                i -= n
            raise IndexError(f"component {int(single)} out of range")
        return super().__getitem__(idx)

    def assign(self, other):
        if isinstance(other, MixedFunction):
            for p, q in zip(self.parts, other.parts):
                p.dat = q.dat.clone()
            return self
        if isinstance(other, (int, float)):
            for p in self.parts:
                p.assign(other)
            return self
        raise NotImplementedError("mixed assign of expressions")

    def copy(self, deepcopy=True):
        out = MixedFunction(self.space, name=f"{self.name}_copy")
        out.assign(self)
        return out

    def zero(self):
        for p in self.parts:
            p.zero()
        return self


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
