"""Krylov solvers on torch tensors (the PETSc KSP analogue).

Matvec-callback based, like the JAX package.  The JAX package runs each
solve as one lax.while_loop program; here the loop is Python, and the
convergence test reads the residual norm back to the host once per
iteration (one device sync per iteration).  CUDA graphs would remove
that sync; they are later work.

Convergence: ||r||_2 <= max(rtol * ||r0||, atol), iteration cap max_it —
the JAX package's test (the true residual norm).  Richardson and
Chebyshev with rtol 0 skip the test and its host reads (see _Test).
GMRES and FGMRES test the rotated residual |g_j| of the least-squares
problem, as the JAX package does; their Hessenberg column comes to the
host once per Arnoldi step, and the Givens rotations and the triangular
solve run there in float64 (Python floats and numpy), so that the
iteration counts follow the JAX package's whatever the device.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch


class KSPResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: float
    converged: bool


def _tolcheck(rnorm, r0norm, rtol, atol):
    return rnorm <= max(rtol * r0norm, atol)


_dot = torch.dot


def _norm(v):
    return torch.sqrt(torch.dot(v, v))


class _Test:
    """The convergence test of cg for the stationary methods.  With
    rtol 0 (the multigrid smoothers' setting: PETSc runs them with no
    convergence test) it reads nothing back: exactly max_it steps run,
    and the result's residual_norm is None."""

    def __init__(self, r, rtol, atol):
        self.rtol, self.atol = rtol, atol
        self.skip = rtol == 0
        self.r0norm = self.rnorm = None if self.skip else float(_norm(r))

    def update(self, r):
        if not self.skip:
            self.rnorm = float(_norm(r))

    def converged(self):
        return not self.skip and _tolcheck(self.rnorm, self.r0norm,
                                           self.rtol, self.atol)

    def done(self, it, max_it):
        return it >= max_it or self.converged()

    def result(self, x, it):
        return KSPResult(x, it, self.rnorm, self.skip or self.converged())


def cg(op: Callable, b, x0=None, pc: Callable = None, rtol=1e-7,
       atol=1e-50, max_it=10000) -> KSPResult:
    """Preconditioned conjugate gradients."""
    pc = pc or (lambda r: r)
    x = b * 0.0 if x0 is None else x0
    r = b - op(x)
    z = pc(r)
    p = z
    gamma = _dot(r, z)
    r0norm = float(_norm(r))
    rnorm = r0norm
    it = 0
    while not _tolcheck(rnorm, r0norm, rtol, atol) and it < max_it:
        Ap = op(p)
        alpha = gamma / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = pc(r)
        gamma_new = _dot(r, z)
        beta = gamma_new / gamma
        p = z + beta * p
        gamma = gamma_new
        it += 1
        rnorm = float(_norm(r))
    return KSPResult(x, it, rnorm, _tolcheck(rnorm, r0norm, rtol, atol))


def richardson(op: Callable, b, x0=None, pc: Callable = None, rtol=1e-7,
               atol=1e-50, max_it=10000, damping=1.0) -> KSPResult:
    """x <- x + damping * pc(b - A x)."""
    pc = pc or (lambda r: r)
    x = b * 0.0 if x0 is None else x0
    r = b - op(x)
    test = _Test(r, rtol, atol)
    it = 0
    while not test.done(it, max_it):
        x = x + damping * pc(r)
        r = b - op(x)
        it += 1
        test.update(r)
    return test.result(x, it)


def chebyshev(op: Callable, b, x0=None, pc: Callable = None, rtol=1e-7,
              atol=1e-50, max_it=10000, emin=0.1, emax=1.1) -> KSPResult:
    """Chebyshev iteration on eigenvalue bounds [emin, emax] of pc∘op —
    the classic MG smoother (PETSc KSPCHEBYSHEV).  The bounds are host
    floats, so the recurrence's scalars cost no device work."""
    pc = pc or (lambda r: r)
    x = b * 0.0 if x0 is None else x0
    theta = (emax + emin) / 2
    delta = (emax - emin) / 2
    r = b - op(x)
    test = _Test(r, rtol, atol)
    p, alpha = b * 0.0, 1.0
    it = 0
    while not test.done(it, max_it):
        z = pc(r)
        beta = 0.0 if it == 0 else (delta * alpha / 2) ** 2
        alpha = 1.0 / theta if it == 0 else 1.0 / (theta - beta / alpha)
        p = z + beta * p
        x = x + alpha * p
        r = b - op(x)
        it += 1
        test.update(r)
    return test.result(x, it)


def bicgstab(op: Callable, b, x0=None, pc: Callable = None, rtol=1e-7,
             atol=1e-50, max_it=10000) -> KSPResult:
    """Right-preconditioned BiCGStab (PETSc KSPBCGS)."""
    pc = pc or (lambda r: r)
    x = b * 0.0 if x0 is None else x0
    r = b - op(x)
    rhat = r
    p, v = b * 0.0, b * 0.0
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    r0norm = float(_norm(r))
    rnorm = r0norm
    it = 0
    while not _tolcheck(rnorm, r0norm, rtol, atol) and it < max_it:
        rho_new = _dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = pc(p)
        v = op(phat)
        alpha = rho_new / _dot(rhat, v)
        s = r - alpha * v
        shat = pc(s)
        t = op(shat)
        omega = _dot(t, s) / _dot(t, t)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        it += 1
        rnorm = float(_norm(r))
    return KSPResult(x, it, rnorm, _tolcheck(rnorm, r0norm, rtol, atol))


class _Givens:
    """The least-squares side of one GMRES cycle, on the host in float64:
    the rotated Hessenberg columns, the rotations and g, the rotated
    right-hand side (the JAX package's real arithmetic, in its order)."""

    def __init__(self, beta, m):
        self.cs, self.sn = [], []
        self.g = [beta] + [0.0] * m
        self.H = np.zeros((m + 1, m))

    def add_column(self, hcol):
        """Rotate the new column hcol (length j + 2) by the earlier
        rotations, make the rotation that zeroes its last entry, and
        apply it to g."""
        j = len(self.cs)
        hc = list(hcol)
        for k in range(j):
            c, s = self.cs[k], self.sn[k]
            t = c * hc[k] + s * hc[k + 1]
            hc[k + 1] = -s * hc[k] + c * hc[k + 1]
            hc[k] = t
        a1 = abs(hc[j])
        denom = math.sqrt(a1 * a1 + hc[j + 1] * hc[j + 1])
        sign1 = hc[j] / a1 if a1 > 0 else 1.0
        c = a1 / denom if denom > 0 else 1.0
        s = sign1 * hc[j + 1] / denom if denom > 0 else 0.0
        self.cs.append(c)
        self.sn.append(s)
        hc[j] = c * hc[j] + s * hc[j + 1]
        hc[j + 1] = 0.0
        self.H[:j + 2, j] = hc
        g = self.g
        g[j + 1] = -s * g[j]
        g[j] = c * g[j]

    def solve(self):
        """y of the j x j upper-triangular system H y = g."""
        from scipy.linalg import solve_triangular
        j = len(self.cs)
        return solve_triangular(self.H[:j, :j], np.asarray(self.g[:j]),
                                lower=False)


def _arnoldi_column(V, j, w):
    """Modified Gram-Schmidt of w against V[0..j]: returns the new basis
    vector and the column (h_0j .. h_j+1,j) as host floats, read in one
    transfer."""
    h = []
    for k in range(j + 1):
        hk = _dot(V[k], w)
        w = w - hk * V[k]
        h.append(hk)
    hj1 = _norm(w)
    h.append(hj1)
    vnext = torch.where(hj1 > 0, w / hj1, w)
    return vnext, torch.stack(h).tolist()


def _gmres_cycles(op, b, x, r0norm, rtol, atol, max_it, m, left_pc,
                  right_pc):
    """Restarted (F)GMRES cycles from x until the rotated residual meets
    the test or max_it iterations have run; returns (x, iterations,
    rotated residual)."""
    tol = max(rtol * r0norm, atol)
    rnorm, total = r0norm, 0
    while not _tolcheck(rnorm, r0norm, rtol, atol) and total < max_it:
        r = left_pc(b - op(x))
        beta = float(_norm(r))
        V = torch.zeros((m + 1,) + tuple(b.shape), dtype=b.dtype,
                        device=b.device)
        V[0] = r / beta if beta > 0 else r
        Z = [] if right_pc is not None else None
        lsq = _Givens(beta, m)
        j = 0
        while j < m and abs(lsq.g[j]) > tol:
            if Z is not None:
                z = right_pc(V[j])
                Z.append(z)
                w = op(z)
            else:
                w = left_pc(op(V[j]))
            V[j + 1], hcol = _arnoldi_column(V, j, w)
            lsq.add_column(hcol)
            j += 1
        if j:
            y = torch.as_tensor(lsq.solve(), dtype=b.dtype,
                                device=b.device)
            basis = torch.stack(Z) if Z is not None else V[:j]
            x = x + basis.T @ y
        rnorm = abs(lsq.g[j])
        total += j
    return x, total, rnorm


def gmres(op: Callable, b, x0=None, pc: Callable = None, rtol=1e-7,
          atol=1e-50, max_it=10000, restart=30) -> KSPResult:
    """Restarted GMRES with left preconditioning, modified Gram-Schmidt
    and Givens rotations (PETSc KSPGMRES).  The test reads the rotated
    (preconditioned) residual; the result carries the true one."""
    pc = pc or (lambda r: r)
    x = b * 0.0 if x0 is None else x0
    r0norm = float(_norm(pc(b - op(x))))
    x, it, rnorm = _gmres_cycles(op, b, x, r0norm, rtol, atol, max_it,
                                 restart, pc, None)
    return KSPResult(x, it, float(_norm(b - op(x))),
                     _tolcheck(rnorm, r0norm, rtol, atol))


def fgmres(op: Callable, b, x0=None, pc: Callable = None, rtol=1e-7,
           atol=1e-50, max_it=10000, restart=30) -> KSPResult:
    """Flexible GMRES (right preconditioning, the preconditioned basis Z
    kept; PETSc KSPFGMRES): the preconditioner may change from one
    application to the next (an inner Krylov solve)."""
    pc = pc or (lambda r: r)
    x = b * 0.0 if x0 is None else x0
    r0norm = float(_norm(b - op(x)))
    x, it, rnorm = _gmres_cycles(op, b, x, r0norm, rtol, atol, max_it,
                                 restart, lambda r: r, pc)
    return KSPResult(x, it, float(_norm(b - op(x))),
                     _tolcheck(rnorm, r0norm, rtol, atol))


def minres(op: Callable, b, x0=None, pc: Callable = None, rtol=1e-7,
           atol=1e-50, max_it=10000) -> KSPResult:
    """MINRES as GMRES restarted every 60 steps, as in the JAX package
    (no short-recurrence Lanczos version there either)."""
    return gmres(op, b, x0=x0, pc=pc, rtol=rtol, atol=atol, max_it=max_it,
                 restart=60)


KSP_METHODS = {"cg": cg, "bicgstab": bicgstab, "bcgs": bicgstab,
               "gmres": gmres, "fgmres": fgmres, "minres": minres,
               "richardson": richardson, "chebyshev": chebyshev}
