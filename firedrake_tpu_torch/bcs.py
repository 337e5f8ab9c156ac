"""Strong (Dirichlet) boundary conditions, and boundary conditions given by
an equation on the boundary (EquationBC).

Reference: firedrake/bcs.py:259 DirichletBC (node lists from facet closures
:129, application :404), :470 EquationBC.  Nodes come from the
FunctionSpaceData closure computation on the host; values are
materialized as a full-length dof vector (zero off the boundary), so
application is an indexed write on the device."""
from __future__ import annotations

import numpy as np
import torch

from .functionspace import FunctionSpace
from .language.core import Expr, ConstantBase
from .device import as_tensor, to_numpy


class DirichletBC:
    def __init__(self, V: FunctionSpace, g, sub_domain, sub=None):
        from .functionspace import ComponentFunctionSpace
        if isinstance(V, ComponentFunctionSpace):
            sub = V.component if sub is None else sub
            V = V.parent_space
        self.function_space_obj = V
        self.g = g
        self.sub_domain = sub_domain
        self.sub_component = sub   # component index for VectorFunctionSpace
        self._nodes = None

    def function_space(self):
        return self.function_space_obj

    @property
    def nodes(self) -> np.ndarray:
        """Scalar node indices on the boundary."""
        if self._nodes is None:
            self._nodes = self.function_space_obj.boundary_nodes(
                self.sub_domain)
        return self._nodes

    @property
    def dof_indices(self) -> np.ndarray:
        """Flat dof indices (expanded over components)."""
        V = self.function_space_obj
        bs = V.block_size
        n = self.nodes.astype(np.int64)
        if bs == 1:
            idx = n
        elif self.sub_component is not None:
            idx = n * bs + self.sub_component
        else:
            idx = (n[:, None] * bs + np.arange(bs)[None, :]).reshape(-1)
        return idx.astype(np.int32)

    def value_vector(self) -> np.ndarray:
        """Host dof vector with g on the bc dofs, 0 elsewhere."""
        from .function import Function
        V = self.function_space_obj
        out = np.zeros(V.dim)
        idx = self.dof_indices
        g = self.g
        if isinstance(g, (int, float)):
            out[idx] = float(g)
        elif isinstance(g, ConstantBase):
            v = np.asarray(g.values()).reshape(-1)
            if v.size == 1:
                out[idx] = float(v[0])
            else:
                # per-component constant on a vector space
                out[idx] = np.tile(v, V.num_nodes)[idx]
        elif isinstance(g, Function):
            out[idx] = to_numpy(g.dat)[idx]
        elif isinstance(g, Expr):
            f = Function(V)
            f.interpolate(g)
            out[idx] = to_numpy(f.dat)[idx]
        elif g in ("x", None):
            pass
        else:
            raise TypeError(f"unsupported bc value {type(g)}")
        return out

    def apply(self, arr, u=None):
        """Set bc dofs of arr to g (or to g - u for residuals); returns a
        new tensor."""
        arr = as_tensor(arr)
        idx = torch.as_tensor(self.dof_indices.astype(np.int64),
                              device=arr.device)
        vals = as_tensor(self.value_vector()).to(arr.dtype)[idx]
        if u is not None:
            vals = vals - as_tensor(u).to(arr.dtype)[idx]
        return arr.index_put((idx,), vals)

    def zero(self, arr):
        arr = as_tensor(arr)
        idx = torch.as_tensor(self.dof_indices.astype(np.int64),
                              device=arr.device)
        return arr.index_fill(0, idx, 0.0)

    def __repr__(self):
        return (f"DirichletBC({self.function_space_obj.name}, "
                f"{self.sub_domain})")


def homogenize(bc: DirichletBC) -> DirichletBC:
    """The same condition with value 0."""
    return DirichletBC(bc.function_space_obj, 0.0, bc.sub_domain,
                       bc.sub_component)


class EquationBC:
    """Boundary condition given by an equation on the boundary subdomain:
    the residual and Jacobian rows of the boundary dofs are replaced by
    those of the boundary form (reference: firedrake/bcs.py:470
    EquationBC).  Taken by the nonlinear solve."""

    def __init__(self, eq, u, sub_domain, bcs=None, J=None, V=None):
        from .language.measure import Equation, Form
        from .language.calculus import derivative
        if isinstance(eq, Equation):
            F = eq.lhs
            if isinstance(eq.rhs, Form) and not eq.rhs.empty():
                F = F - eq.rhs
        else:
            F = eq
        self.F = F
        self.u = u
        self.sub_domain = sub_domain
        self.function_space_obj = V if V is not None \
            else u.function_space()
        self.J = J if J is not None else derivative(F, u)

    def function_space(self):
        return self.function_space_obj

    @property
    def dof_indices(self) -> np.ndarray:
        """Flat dof indices of the nodes on the subdomain's facets
        (expanded over components)."""
        V = self.function_space_obj
        idx = V.boundary_nodes(self.sub_domain).astype(np.int64)
        bs = V.block_size
        if bs > 1:
            idx = (idx[:, None] * bs + np.arange(bs)[None, :]).reshape(-1)
        return idx.astype(np.int32)

    def __repr__(self):
        return (f"EquationBC({self.function_space_obj.name}, "
                f"{self.sub_domain})")


def as_bcs(bcs):
    """Normalize a user-supplied ``bcs`` argument: None, a solitary BC,
    or an iterable of BCs -> tuple (reference: firedrake/solving.py
    _extract_bcs accepts a bare DirichletBC)."""
    if bcs is None:
        return ()
    if isinstance(bcs, (DirichletBC, EquationBC)):
        return (bcs,)
    return tuple(bcs)
