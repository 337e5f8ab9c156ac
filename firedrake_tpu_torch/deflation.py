"""Deflation for finding multiple solutions of nonlinear PDEs (the port's
copy of ``firedrake_tpu/deflation.py``; reference: firedrake/deflation.py,
the shifted deflation operator of doi:10.1137/140984798).

The Newton direction from the unmodified linear solve is rescaled by

    tau = 1 / (1 - E'(y)·dy / M(y)),

where M(y) = prod_r (||y - y_r||^-p + shift) is the deflation operator
over the known roots y_r and E' its Frechet derivative: deflation never
touches the Jacobian.  The Newton loop (solving.py
NonlinearVariationalSolver) reads appctx["deflation"] after each linear
solve, scales the update by tau and appends each converged solution, so
repeated ``solver.solve()`` calls walk through distinct roots.  M and E'
are assembled functionals on the device; ``tau`` returns one host float.
"""
from __future__ import annotations

import torch

from .device import as_tensor

__all__ = ["Deflation", "DeflatedSNES"]

#: Marker so `"snes_type": "deflated"` reads naturally in options trees
#: (the dispatch is via appctx["deflation"], as in the reference).
DeflatedSNES = "deflated"


class Deflation:
    """Shifted deflation operator M(y) = prod_r (d(y,y_r)^{-p/2} + shift)
    with d the squared distance functional (default L2:
    ``inner(x - y, x - y)*dx``).  Reference: deflation.py:164-227."""

    def __init__(self, roots=None, power=2, shift=1, op=None):
        self.power = power
        self.shift = shift
        self.roots = list(roots) if roots else []
        if op is None:
            from .language import inner
            from .language.measure import dx
            op = lambda x, y: inner(x - y, x - y) * dx   # noqa: E731
        self.op = op

    def append(self, root):
        self.roots.append(root)

    def __iter__(self):
        return iter(self.roots)

    def __len__(self):
        return len(self.roots)

    def evaluate(self, y):
        """M(y) at the current guess (deflation.py:189-199)."""
        from .assemble import assemble
        m = 1.0
        for root in self.roots:
            normsq = float(assemble(self.op(y, root)))
            m *= normsq ** (-self.power / 2.0) + float(self.shift)
        return m

    def deriv(self, y):
        """E'(y) as a dof vector on the device (deflation.py:201-227):
        with f_r = n_r^{-p/2} + shift and eta = prod f_r,
        E' = sum_r (eta/f_r) * (-p/2) n_r^{-p/2-1} * d n_r/dy."""
        from .assemble import assemble
        from .language.calculus import derivative
        p = float(self.power)
        out = None
        normsqs, dnormsqs = [], []
        for root in self.roots:
            form = self.op(y, root)
            normsqs.append(float(assemble(form)))
            dnormsqs.append(as_tensor(assemble(derivative(form, y)).dat))
        factors = [n ** (-p / 2.0) + float(self.shift) for n in normsqs]
        eta = 1.0
        for f in factors:
            eta *= f
        for n, f, dn in zip(normsqs, factors, dnormsqs):
            term = (eta / f) * (-p / 2.0) * n ** (-p / 2.0 - 1.0) * dn
            out = term if out is None else out + term
        return out

    def tau(self, u_func, du):
        """Newton-update scaling (deflation.py compute_tau).  `du` is the
        additive update (u <- u + du); the reference's dy is the
        subtractive PETSc one (x <- x - dy), so its -deriv·dy is our
        +deriv·du: solving (M J + F M'^T) du_defl = -M F by
        Sherman-Morrison gives du_defl = du / (1 - (M'·du)/M)."""
        if not self.roots:
            return 1.0
        m = self.evaluate(u_func)
        deriv = self.deriv(u_func)
        Edy = float(torch.dot(deriv, as_tensor(du).to(deriv.dtype)))
        return 1.0 / (1.0 - Edy / m)
