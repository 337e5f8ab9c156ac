"""Matrix-free operators (reference role: firedrake's
matrix_free/operators.py ImplicitMatrix).

A `MatrixFreeOperator` fills the assembled operator's duck type (matvec,
diagonal, with_dirichlet, shape, dtype, copy) without storing entries:
`matvec` is one rank-1 assembly of action(a, x) (the stencil route on
structured meshes, else the gather route), whose element
vectors come from K1's action terms (compiler/cell_eval.py), and
`diagonal` is a diagonal-only assembly of a.  A P2-tet operator at 17M
dofs would hold ~65 channel planes; the matrix-free one holds dof
vectors only, which is what lets the multigrid levels of the 16M-dof
solve stay matrix-free.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor, to_numpy


def is_matfree(A):
    return isinstance(A, (MatrixFreeOperator, DirichletMatrixFree))


def action_assembler(a):
    """(FormAssembler of action(a, w), w) for the bilinear form a: made
    once per form object and kept on the form itself, so that repeated
    operators over one form (a Newton solve's Jacobian, step after step)
    share one action form, one input coefficient w and one assembly plan,
    and all of them go when the form goes.  Keyed by what a FormAssembler
    reads when it is built (assemble.build_key)."""
    from ..language.calculus import action
    from ..function import Function
    from ..assemble import FormAssembler, build_key
    key = build_key()
    cache = a.__dict__.setdefault("_action_assemblers", {})
    if key not in cache:
        w = Function(a.arguments()[1].space, name="mf_x")
        cache[key] = (FormAssembler(action(a, w)), w)
    return cache[key]


class MatrixFreeOperator:
    """y = A @ x evaluated by assembling action(a, x)."""

    def __init__(self, a):
        args = a.arguments()
        if len(args) != 2:
            raise ValueError("MatrixFreeOperator needs a bilinear form")
        self.row_space = args[0].space
        self.col_space = args[1].space
        if self.row_space.dim != self.col_space.dim:
            raise NotImplementedError("matrix-free rectangular operators")
        self._a = a
        self._asm1, self._w = action_assembler(a)
        self._asm2 = None                    # built lazily for diagonal
        self._mesh = self.row_space.mesh_obj
        # coefficient and Constant values are read once, here, as in the
        # JAX package; the coordinates through the mesh's device copy
        self._coeff_dats = {c.count: as_tensor(c.dat)
                            for c in self._asm1.coefficients
                            if c is not self._w}
        self._consts = {c.count: as_tensor(c.values())
                        for c in self._asm1.constants}
        self._diag = None

    @property
    def shape(self):
        n = self.row_space.dim
        return (n, n)

    @property
    def dtype(self):
        return self._mesh.device_coordinates().dtype

    def matvec(self, x):
        cd = dict(self._coeff_dats)
        cd[self._w.count] = x
        return self._asm1._evaluate(self._mesh.device_coordinates(), cd,
                                    self._consts)

    __matmul__ = matvec

    def diagonal(self):
        if self._diag is None:
            from ..assemble import FormAssembler
            if self._asm2 is None:
                self._asm2 = FormAssembler(self._a)
            self._diag = self._asm2.assemble_diagonal()
        return self._diag

    def with_dirichlet(self, bc_rows, symmetric=True):
        return DirichletMatrixFree(self, bc_rows)

    def copy(self):
        return self

    def __repr__(self):
        return f"MatrixFreeOperator({self.shape})"


class DirichletMatrixFree:
    """P A P + (I - P) over a MatrixFreeOperator, with P zero on the
    Dirichlet rows: those rows and columns become the identity."""

    def __init__(self, base, bc_rows, mask=None):
        self.base = base
        m = (torch.zeros(base.shape[0], dtype=torch.bool) if mask is None
             else mask.cpu().clone())
        m[np.asarray(to_numpy(bc_rows), dtype=np.int64)] = True
        self._mask = as_tensor(m)
        self.row_space = base.row_space
        self.col_space = base.col_space

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    def matvec(self, x):
        y = self.base.matvec(torch.where(self._mask, 0.0, x))
        return torch.where(self._mask, x, y)

    __matmul__ = matvec

    def diagonal(self):
        return torch.where(self._mask, 1.0, self.base.diagonal())

    def with_dirichlet(self, bc_rows, symmetric=True):
        return DirichletMatrixFree(self.base, bc_rows, self._mask)

    def copy(self):
        return self

    def __repr__(self):
        return f"DirichletMatrixFree({self.shape})"
