"""L2-transformed optimization functionals (the port's copy of
``firedrake_tpu/adjoint/transformed.py``).

Reference: firedrake/adjoint/transformed_functional.py (L2RieszMap :19,
L2TransformedFunctional :141 — the factorization of section 4.1 of
doi:10.1137/18M1175239).  An optimization problem J(m) over a finite
element control space is re-posed over the coefficients of an
L2-ORTHONORMAL basis of a DG space containing it:

    J~(m~) = J( Pi( C^{-T} m~ ) ),    C C^T = M_D  (DG mass matrix)

so the Euclidean (l2) inner product that first-order optimizers use on
the raw coefficient vector IS the L2 inner product on functions —
gradient-descent/LBFGS convergence becomes mesh-independent.

The DG mass matrix is block-diagonal per cell with every dof in exactly
one cell, so C is the batch of per-cell Cholesky factors and C^{-T}/C^{-1}
actions are one batched ``torch.linalg.solve_triangular`` (the JAX
package computes them outside any kernel too) + a dof gather and a
unique-index write — no global factorization."""
from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor
from ..function import Function
from ..language import TestFunction, TrialFunction, inner, dx


class L2RieszMap:
    """L2 Riesz map on a space: dual -> primal via the mass solve
    (reference: transformed_functional.py:19 L2RieszMap)."""

    def __init__(self, target, constant_jacobian=True):
        self.target = target
        self.constant_jacobian = constant_jacobian

    def __call__(self, u):
        return u.riesz_representation("L2")


class L2Cholesky:
    """Per-cell Cholesky of a DG space's mass matrix: C C^T = M_D.

    DG dofs live in exactly one cell, so the global factor is the
    batch of cell factors in the cell dof ordering."""

    def __init__(self, space):
        from .covariance import _cell_mass_factors
        self._H, cmap = _cell_mass_factors(space)        # (C, n, n)
        counts = np.bincount(cmap.reshape(-1), minlength=space.dim)
        if not (counts == 1).all():
            raise ValueError(
                "L2TransformedFunctional needs a DG space (each dof in "
                "exactly one cell); got shared dofs")
        self.cmap = torch.as_tensor(cmap.astype(np.int64),
                                    device=self._H.device)
        self.dim = space.dim

    def _cellwise(self, dat, fn):
        """fn on the (C, n, 1) cell blocks of dat, written back to the
        cells' dofs (each dof in one cell)."""
        y = fn(as_tensor(dat)[self.cmap][..., None])[..., 0]
        out = y.new_zeros(self.dim)
        out[self.cmap.reshape(-1)] = y.reshape(-1)
        return out

    def C_T_inv(self, dat):
        """x = C^{-T} v (orthonormal coefficients -> DG dofs)."""
        return self._cellwise(dat, lambda x: torch.linalg.solve_triangular(
            self._H.transpose(1, 2), x, upper=True))

    def C_inv(self, dat):
        """x = C^{-1} v (dual DG coefficients -> orthonormal dual)."""
        return self._cellwise(dat, lambda x: torch.linalg.solve_triangular(
            self._H, x, upper=False))

    def C_T(self, dat):
        """v = C^T x (DG dofs -> orthonormal coefficients)."""
        return self._cellwise(dat, lambda x: self._H.transpose(1, 2) @ x)


class L2TransformedFunctional:
    """J composed with the L2-orthonormal change of basis (reference:
    transformed_functional.py:141).

    Controls must live in a DG space (pass space_D or use a DG control
    directly); non-DG controls are projected L2-orthogonally from the
    DG space, with the projection's adjoint applied in derivative().
    """

    def __init__(self, functional, control, *, space_D=None,
                 riesz_map=None, alpha=0.0, tape=None):
        from .tape import ReducedFunctional, Control
        if not isinstance(control, Control):
            control = Control(control)
        self._J = ReducedFunctional(functional, [control], tape=tape)
        self._control = control
        S = control.coefficient.function_space()
        self._space = S
        self._space_D = space_D if space_D is not None else S
        self._chol = L2Cholesky(self._space_D)
        self._identity = self._space_D is S
        self._alpha = float(alpha)
        if not self._identity:
            from ..assemble import assemble
            # mixed mass B[s, d] = <phi_s, psi_d>: Pi m_D solves
            # M_S x = B m_D
            uD = TrialFunction(self._space_D)
            vS = TestFunction(S)
            self._B = assemble(inner(uD, vS) * dx)
            uS, vS2 = TrialFunction(S), TestFunction(S)
            self._MS = assemble(inner(uS, vS2) * dx)
        # transformed initial guess: m~ = C^T m_D (inverse of C^{-T}); a
        # non-DG control is interpolated into the DG space first
        if self._identity:
            mD = control.coefficient.dat
        else:
            mD = Function(self._space_D).interpolate(
                control.coefficient).dat
        self.m_t = Function(self._space_D, val=self._chol.C_T(mD))

    # ------------------------------------------------------------ eval
    def _primal(self, mt_dat):
        """m = Pi(C^{-T} m~) in the control space; also returns m_D."""
        mD = self._chol.C_T_inv(mt_dat)
        if self._identity:
            return mD, mD
        from ..solving import direct_solve
        return direct_solve(self._MS, self._B.matvec(mD)), mD

    def __call__(self, mt):
        m, mD = self._primal(as_tensor(getattr(mt, "dat", mt)))
        J = self._J([m])
        if self._alpha and not self._identity:
            # + alpha/2 ||m_D - Pi(m_D)||^2_{L2}
            PmD = Function(self._space_D).interpolate(
                Function(self._space, val=m))
            dd = (mD - PmD.dat)[self._chol.cmap][..., None]
            H = self._chol._H
            ML = H @ H.transpose(1, 2)
            J = J + 0.5 * self._alpha * float(torch.sum(dd * (ML @ dd)))
        return J

    def derivative(self):
        """Gradient in the transformed (l2 == L2-orthonormal) basis."""
        g_dat = self._J.derivative().dat      # dual coefficients on S
        if not self._identity:
            from ..solving import direct_solve
            # Pi^T: g_D = B^T M_S^{-1} g_S
            g_dat = self._B.transpose_matvec(direct_solve(self._MS, g_dat))
        return Function(self._space_D, val=self._chol.C_inv(g_dat))

    @property
    def controls(self):
        return [self.m_t]
