"""Covariance operators, white-noise sampling, and CovarianceMat (the
port's copy of ``firedrake_tpu/adjoint/covariance.py``; CovariancePC is
in solvers/pcs.py).

Reference: firedrake/adjoint/covariance_operator.py:28-998 and
firedrake/preconditioners/covariance.py:6-119.

* :class:`WhiteNoiseGenerator` — samples w ~ N(0, M) (M the mass
  matrix) by the Croci et al. 2018 broken-space trick: per-cell
  Cholesky factors H_e of the LOCAL mass matrices, w = sum_e R_e^T
  H_e z_e with z iid standard normal (drawn by numpy on the host, so a
  seed gives the JAX package's samples).  The factors come from one
  batched ``torch.linalg.cholesky`` over Slate's (C, n, n) cell tensors;
  the cell contributions are summed by the gather route's fixed-order
  plan (``assemble._accumulation``), where the JAX package scatter-adds.

* :class:`AutoregressiveCovariance` — the m-th order autoregressive
  (Matern-family) operator B = lam (K^{-1} M)^m M^{-1} lam realized by
  m implicit diffusion steps (Mirouze & Weaver 2010), matching
  covariance_operator.py:701-934; each apply composes the Krylov solves
  of solvers/composition.build_ksp.

* :class:`CovarianceMat` — the operator of a Krylov solve over a
  covariance (preconditioners/covariance.py:6): CovariancePC applies
  whichever of {action, inverse} the Mat does not, so `B y = r` solves
  converge in O(1) iterations.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..language import (TestFunction, TrialFunction, dx, inner, grad,
                        avg, outer, FacetNormal, dS)
from ..function import Function, Cofunction, Constant
from ..assemble import assemble
from ..device import as_tensor


# -- autoregressive-function parameters (covariance_operator.py:423-477)

def lengthscale_m(Lar: float, m: int):
    """Lengthscale parameter of the m-th order autoregressive function
    with Daley lengthscale `Lar`."""
    return Lar / math.sqrt(2 * m - 3)


def lambda_m(Lar: float, m: int):
    """Normalisation factor of the m-th order autoregressive kernel."""
    L = lengthscale_m(Lar, m)
    num = (2 ** (2 * m - 1)) * math.factorial(m - 1) ** 2
    den = math.factorial(2 * m - 2)
    return L * num / den


def kappa_m(Lar: float, m: int):
    """Diffusion coefficient for the autoregressive operator."""
    return lengthscale_m(Lar, m) ** 2


def diffusion_form(u, v, kappa, formulation="CG", cell_size=None):
    """One Backward-Euler diffusion step's bilinear form
    (covariance_operator.py:937-998): 'CG' mass+stiffness, 'IP' the
    interior-penalty analogue for discontinuous spaces."""
    if formulation == "CG":
        return inner(u, v) * dx + inner(kappa * grad(u), grad(v)) * dx
    if formulation == "IP":
        mesh = v.space.mesh_obj
        n = FacetNormal(mesh)
        from ..language import CellDiameter
        h = cell_size if cell_size is not None else CellDiameter(mesh)
        alpha = 4.0 / avg(h)
        ju = outer(u, n)("+") + outer(u, n)("-")
        jv = outer(v, n)("+") + outer(v, n)("-")
        return (inner(u, v) * dx + kappa * (
            inner(grad(u), grad(v)) * dx
            - inner(ju, avg(grad(v))) * dS
            - inner(avg(grad(u)), jv) * dS
            + alpha * inner(ju, jv) * dS))
    raise ValueError(f"unknown diffusion formulation {formulation!r}")


def _cell_mass_factors(V):
    """(H, cmap): the lower Cholesky factors of every cell's local mass
    matrix, H_e H_e^T = M_e (C, n, n) on the device, and the cells' dof
    map (C, n) in the same local order."""
    from ..slate import _local_form_tensor
    u, v = TrialFunction(V), TestFunction(V)
    M_loc = as_tensor(_local_form_tensor(inner(u, v) * dx).cell)
    cmap = np.asarray(V.cell_dof_map if hasattr(V, "cell_dof_map")
                      else V.cell_node_map)
    return torch.linalg.cholesky(M_loc), cmap.reshape(M_loc.shape[0], -1)


class WhiteNoiseGenerator:
    """Samples w ~ N(0, M) in V* (and, with apply_riesz, M^{-1} w in V).

    E[w w^T] = sum_e R_e^T H_e H_e^T R_e = M exactly, for H_e the
    Cholesky factor of the per-cell mass matrix (Croci et al. 2018;
    reference covariance_operator.py:337-418).
    """

    def __init__(self, V, rng=None, seed: int | None = None):
        from ..assemble import _accumulation
        self.V = V
        self._np_rng = rng if rng is not None \
            else np.random.default_rng(seed)
        self._H, cmap = _cell_mass_factors(V)
        self._sum = _accumulation(cmap.reshape(-1).astype(np.int64), V.dim,
                                  self._H.device)
        self._mass = None

    def _scatter(self, z):
        return self._sum(torch.einsum("cij,cj->ci", self._H, z).reshape(-1))

    def function_space(self):
        return self.V

    @property
    def rng(self):
        return self._np_rng

    def sample(self, *, rng=None, tensor=None, apply_riesz=False):
        g = rng if rng is not None else self._np_rng
        w = self._scatter(as_tensor(g.standard_normal(
            tuple(self._H.shape[:2]))))
        if apply_riesz:
            if self._mass is None:
                from ..solvers.composition import OpCtx, build_ksp
                u, v = TrialFunction(self.V), TestFunction(self.V)
                M = assemble(inner(u, v) * dx)
                self._mass = build_ksp(
                    OpCtx(mat=M, space=self.V),
                    {"ksp_type": "cg", "pc_type": "jacobi",
                     "ksp_rtol": 1e-12}, "")
            w = self._mass(w)
            out = tensor if tensor is not None else Function(self.V)
        else:
            out = tensor if tensor is not None else Cofunction(self.V)
        out.dat = w
        return out


class CovarianceOperatorBase:
    """B: V* -> V and B^{-1}: V -> V*
    (reference covariance_operator.py:480-620)."""

    def function_space(self):
        raise NotImplementedError

    def rng(self):
        raise NotImplementedError

    def sample(self, *, rng=None, tensor=None):
        raise NotImplementedError

    def apply_action(self, x, *, tensor=None):
        raise NotImplementedError

    def apply_inverse(self, x, *, tensor=None):
        raise NotImplementedError

    def norm(self, x):
        """||x||^2_{B^{-1}} = x^T B^{-1} x."""
        bx = self.apply_inverse(x)
        return float(torch.dot(_dat(x), _dat(bx)))


def _dat(x):
    return as_tensor(x.dat if hasattr(x, "dat") else x)


class AutoregressiveCovariance(CovarianceOperatorBase):
    """m-th order autoregressive covariance via m implicit diffusion
    steps (reference covariance_operator.py:701-934).

        B     = lam (K^{-1} M)^m M^{-1} lam
        B^-1  = (1/lam) K (M^{-1} K)^{m-1} (1/lam)
        B^1/2 z = lam (K^{-1} M)^{m/2} M^{-1} (M^{1/2} z)

    with K one Backward-Euler diffusion step, M the mass matrix and
    lam = sigma*sqrt(lambda_m) the unit-variance normalisation.  The K
    and M solves are build_ksp solvers (default CG + Jacobi to rtol
    1e-12; ``solver_parameters`` for K, ``mass_parameters`` for M).
    """

    def __init__(self, V, L, sigma=1.0, m: int = 2, rng=None,
                 seed=None, form=None, weight=None, bcs=None,
                 solver_parameters=None, mass_parameters=None):
        from ..bcs import as_bcs
        from ..solvers.composition import OpCtx, build_ksp
        if L < 0:
            raise ValueError("correlation lengthscale must be positive")
        if m < 0 or (m % 2) != 0:
            raise ValueError("iteration count m must be even and >= 0")
        self.V = V
        self._rng = rng or WhiteNoiseGenerator(V, seed=seed)
        self.stddev = float(sigma)
        self.lengthscale = float(L)
        self.iterations = int(m)
        if m == 0:
            return
        u, v = TrialFunction(V), TestFunction(V)
        if form is None or isinstance(form, str):
            self.kappa = kappa_m(L, m)
            self.lam = lambda_m(L, m)
            self._weight = float(sigma) * math.sqrt(self.lam)
            K = diffusion_form(u, v, Constant(self.kappa),
                               formulation=form or "CG")
        else:
            K = form
            self._weight = float(weight) if weight is not None else 1.0
        Mform = inner(u, v) * dx
        self._K = assemble(K, bcs=bcs)
        self._M = assemble(Mform)
        sp = dict(solver_parameters
                  or {"ksp_type": "cg", "pc_type": "jacobi",
                      "ksp_rtol": 1e-12, "ksp_max_it": 2000})
        mp = dict(mass_parameters
                  or {"ksp_type": "cg", "pc_type": "jacobi",
                      "ksp_rtol": 1e-12, "ksp_max_it": 2000})
        self._Ksolve = build_ksp(OpCtx(mat=self._K, space=V, form=K,
                                       bcs=as_bcs(bcs)), sp)
        self._Msolve = build_ksp(OpCtx(mat=self._M, space=V, form=Mform),
                                 mp)

    def _action(self, xd):
        """lam (K^{-1} M)^m M^{-1} lam : V* -> V."""
        u = self._weight * self._Msolve(xd)
        for _ in range(self.iterations):
            u = self._Ksolve(self._M.matvec(u))
        return self._weight * u

    def _inverse(self, xd):
        """(1/lam) K (M^{-1} K)^{m-1} (1/lam) : V -> V*."""
        u = xd / self._weight
        for _ in range(self.iterations - 1):
            u = self._Msolve(self._K.matvec(u))
        return self._K.matvec(u) / self._weight

    def _half_action(self, wd):
        """lam (K^{-1} M)^{m/2} applied to a primal field."""
        u = wd
        for _ in range(self.iterations // 2):
            u = self._Ksolve(self._M.matvec(u))
        return self._weight * u

    def _half_inverse(self, xd):
        """(M^{-1} K)^{m/2} (1/lam) x, for the efficient norm."""
        u = xd / self._weight
        for _ in range(self.iterations // 2):
            u = self._Msolve(self._K.matvec(u))
        return u

    def function_space(self):
        return self.V

    def rng(self):
        return self._rng

    def sample(self, *, rng=None, tensor=None):
        tensor = tensor if tensor is not None else Function(self.V)
        w = (rng or self._rng).sample(apply_riesz=True)
        if self.iterations == 0:
            tensor.dat = self.stddev * _dat(w)
            return tensor
        tensor.dat = self._half_action(_dat(w))
        return tensor

    def apply_action(self, x, *, tensor=None):
        tensor = tensor if tensor is not None else Function(self.V)
        if self.iterations == 0:
            cx = x.riesz_representation("L2") if hasattr(x, "dat") else x
            tensor.dat = (self.stddev ** 2) * _dat(cx)
            return tensor
        tensor.dat = self._action(_dat(x))
        return tensor

    def apply_inverse(self, x, *, tensor=None):
        tensor = tensor if tensor is not None else Cofunction(self.V)
        if self.iterations == 0:
            cx = x.riesz_representation("L2") if hasattr(x, "dat") else x
            tensor.dat = _dat(cx) / (self.stddev ** 2)
            return tensor
        tensor.dat = self._inverse(_dat(x))
        return tensor

    def norm(self, x):
        """||x||^2_{B^{-1}} via m/2 mass solves: ||(M^{-1}K)^{m/2}
        (1/lam) x||^2_M (covariance_operator.py:882-894)."""
        xd = _dat(x)
        if self.iterations == 0:
            u, v = TrialFunction(self.V), TestFunction(self.V)
            M = getattr(self, "_M", None) or assemble(inner(u, v) * dx)
            return float(torch.dot(xd, M.matvec(xd))) / self.stddev ** 2
        u = self._half_inverse(xd)
        return float(torch.dot(u, self._M.matvec(u)))


class MixedCovarianceOperator(CovarianceOperatorBase):
    """Block-diagonal covariance over a MixedFunctionSpace: one
    sub-covariance per field (covariance_operator.py:623-698)."""

    def __init__(self, W, subcovariances):
        self.W = W
        self.subs = tuple(subcovariances)
        dims = [c.function_space().dim for c in self.subs]
        if sum(dims) != W.dim:
            raise ValueError("subcovariance dims do not tile the mixed "
                             f"space: {dims} vs {W.dim}")
        off = np.cumsum([0] + dims)
        self._slices = [slice(int(a), int(b))
                        for a, b in zip(off[:-1], off[1:])]

    def function_space(self):
        return self.W

    def rng(self):
        return self.subs[0].rng()

    def _blockwise(self, x, op, out):
        xd = _dat(x)
        out.dat = torch.cat([_dat(getattr(c, op)(xd[s]))
                             for c, s in zip(self.subs, self._slices)])
        return out

    def apply_action(self, x, *, tensor=None):
        return self._blockwise(
            x, "apply_action", tensor or Function(self.W))

    def apply_inverse(self, x, *, tensor=None):
        return self._blockwise(
            x, "apply_inverse", tensor or Cofunction(self.W))

    def sample(self, *, rng=None, tensor=None):
        out = tensor if tensor is not None else Function(self.W)
        out.dat = torch.cat([_dat(c.sample(rng=rng)) for c in self.subs])
        return out

    def norm(self, x):
        xd = _dat(x)
        return sum(c.norm(xd[s]) for c, s in zip(self.subs, self._slices))


class CovarianceMat:
    """Operator wrapper selecting B or B^{-1} as the matvec
    (reference CovarianceMatCtx, covariance_operator.py:1001-1087) —
    pass as `A` (or OpCtx.mat) to a Krylov solve over the covariance."""

    ACTION = "action"
    INVERSE = "inverse"

    def __init__(self, covariance, operation=None):
        op = operation or self.ACTION
        if op not in (self.ACTION, self.INVERSE):
            raise ValueError(f"unknown operation {op!r}")
        self.covariance = covariance
        self.operation = op
        n = covariance.function_space().dim
        self.shape = (n, n)
        if op == self.ACTION:
            self.matvec = covariance._action
        else:
            self.matvec = covariance._inverse

    def diagonal(self):
        raise ValueError("CovarianceMat has no assembled diagonal; "
                         "precondition with CovariancePC")
