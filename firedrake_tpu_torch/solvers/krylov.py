"""Krylov solvers on torch tensors (the PETSc KSP analogue).

Matvec-callback based, like the JAX package.  The JAX package runs each
solve as one lax.while_loop program; here the loop is Python, and the
convergence test reads the residual norm back to the host once per
iteration (one device sync per iteration).  CUDA graphs would remove
that sync; they are later work.

Convergence: ||r||_2 <= max(rtol * ||r0||, atol), iteration cap max_it —
the JAX package's test (the true residual norm).  Richardson and
Chebyshev with rtol 0 skip the test and its host reads (see _Test).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

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


KSP_METHODS = {"cg": cg, "richardson": richardson, "chebyshev": chebyshev}
