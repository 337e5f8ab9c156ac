"""Optimization drivers over ReducedFunctionals (the port's copy of
``firedrake_tpu/adjoint/optimization.py``).

Reference surface: firedrake/adjoint/__init__.py:30 re-exports
pyadjoint's minimize/MinimizationProblem and the UFL constraint classes
(firedrake/adjoint/ufl_constraints.py:140 UFLInequalityConstraint /
UFLEqualityConstraint).  Controls flatten to one numpy vector on the
host, scipy.optimize drives (L-BFGS-B / SLSQP / trust-constr), and every
J/grad evaluation replays the tape on the device; one host copy of the
control and of the gradient per evaluation.
"""
from __future__ import annotations

import numpy as np

from ..device import to_numpy
from ..language.core import ConstantBase
from .tape import _paused

__all__ = ["minimize", "maximize", "MinimizationProblem",
           "MinimizationSolver", "EqualityConstraint",
           "InequalityConstraint", "UFLEqualityConstraint",
           "UFLInequalityConstraint"]


# ------------------------------------------------------------- constraints
class Constraint:
    """pyadjoint constraint protocol: function(m) -> residual array
    (>= 0 feasible for inequality, == 0 for equality), jacobian(m) ->
    list over controls of per-component gradient arrays."""

    def function(self, m):
        raise NotImplementedError

    def jacobian(self, m):
        raise NotImplementedError

    def length(self):
        return 1


class EqualityConstraint(Constraint):
    is_equality = True


class InequalityConstraint(Constraint):
    is_equality = False


class _UFLConstraint(Constraint):
    """Scalar constraint c(m) = assemble(form) with the Gateaux
    derivative assembled symbolically (reference:
    firedrake/adjoint/ufl_constraints.py — assembles the UFL derivative
    of the constraint form wrt the control)."""

    def __init__(self, form, control):
        from ..language.measure import Form
        if not isinstance(form, Form):
            raise TypeError("UFL constraint needs a 0-form")
        self.form = form
        self.control = control
        self.c = control.coefficient

    def function(self, m):
        from ..assemble import assemble
        with _paused():
            self.c.dat = np.asarray(m, dtype=float)
            return np.array([float(assemble(self.form))])

    def jacobian(self, m):
        from ..assemble import assemble
        from ..language.calculus import derivative
        with _paused():
            self.c.dat = np.asarray(m, dtype=float)
            dc = assemble(derivative(self.form, self.c))
            return [to_numpy(dc.dat).copy()]


class UFLEqualityConstraint(_UFLConstraint):
    is_equality = True


class UFLInequalityConstraint(_UFLConstraint):
    is_equality = False


# ----------------------------------------------------------------- problem
class MinimizationProblem:
    """Reference: pyadjoint MinimizationProblem re-exported by
    firedrake.adjoint."""

    def __init__(self, reduced_functional, bounds=None, constraints=None):
        self.reduced_functional = reduced_functional
        self.bounds = bounds
        if constraints is None:
            constraints = []
        elif isinstance(constraints, Constraint):
            constraints = [constraints]
        self.constraints = list(constraints)


# ------------------------------------------------------------------ driver
def _ctrl_sizes(rf):
    return [np.size(c.coefficient.values()) if isinstance(
        c.coefficient, ConstantBase) else c.coefficient.dat.numel()
        for c in rf.controls]


def _pack(values):
    return np.concatenate(
        [np.asarray(to_numpy(getattr(v, "dat", v)), dtype=float)
         .reshape(-1)
         for v in (values if isinstance(values, (list, tuple))
                   else [values])])


def _unpack(x, rf):
    from ..function import Function, Constant
    out, off = [], 0
    for ctrl, n in zip(rf.controls, _ctrl_sizes(rf)):
        c = ctrl.coefficient
        piece = x[off:off + n]
        off += n
        if isinstance(c, ConstantBase):
            out.append(Constant(piece if n > 1 else float(piece[0])))
        else:
            out.append(Function(c.function_space(), val=piece.copy()))
    return out


def _bounds_vector(bounds, rf, sizes):
    """pyadjoint bound spec: (lb, ub) per control (scalars, Functions,
    or None) -> scipy (n, 2) array."""
    if bounds is None:
        return None
    n = sum(sizes)
    lo = np.full(n, -np.inf)
    hi = np.full(n, np.inf)
    bspec = bounds
    if len(rf.controls) == 1 and len(bspec) == 2 and not \
            isinstance(bspec[0], (list, tuple)):
        bspec = [bspec]
    off = 0
    for (b, sz) in zip(bspec, sizes):
        lb, ub = b
        if lb is not None:
            lo[off:off + sz] = to_numpy(getattr(lb, "dat", lb)).reshape(-1)
        if ub is not None:
            hi[off:off + sz] = to_numpy(getattr(ub, "dat", ub)).reshape(-1)
        off += sz
    return np.stack([lo, hi], axis=1)


def minimize(rf, method=None, bounds=None, constraints=None, tol=None,
             scale=1.0, options=None, callback=None, **kwargs):
    """Minimize a ReducedFunctional with scipy.optimize (reference:
    pyadjoint.optimization.minimize re-exported at
    firedrake/adjoint/__init__.py:30).  Returns the optimal control
    Function (or list for multiple controls); its ``_opt_result`` is
    scipy's result."""
    import scipy.optimize as sopt
    if isinstance(rf, MinimizationProblem):
        prob = rf
        rf = prob.reduced_functional
        bounds = prob.bounds if bounds is None else bounds
        constraints = prob.constraints if constraints is None \
            else constraints
    sizes = _ctrl_sizes(rf)

    def J(x):
        vals = _unpack(x, rf)
        return scale * rf(vals if len(vals) > 1 else vals[0])

    def dJ(x):
        J(x)                        # replay so the tape matches x
        g = rf.derivative()
        return scale * _pack(g if isinstance(g, list) else [g])

    scon = []
    if constraints:
        cons = (constraints if isinstance(constraints, (list, tuple))
                else [constraints])
        for con in cons:
            scon.append(dict(
                type="eq" if getattr(con, "is_equality", True) else "ineq",
                fun=lambda x, con=con: np.asarray(
                    con.function(x[:sizes[0]])).reshape(-1),
                jac=lambda x, con=con: np.concatenate(
                    [j.reshape(1, -1) for j in con.jacobian(x[:sizes[0]])],
                    axis=1)))
    if method is None:
        method = ("SLSQP" if scon
                  else ("L-BFGS-B" if bounds is not None else "BFGS"))
    x0 = _pack([c.coefficient for c in rf.controls])
    res = sopt.minimize(
        J, x0, jac=dJ, method=method, tol=tol,
        bounds=_bounds_vector(bounds, rf, sizes),
        constraints=scon, options=options, callback=callback, **kwargs)
    out = _unpack(res.x, rf)
    rf(out if len(out) > 1 else out[0])       # leave tape at optimum
    result = out if len(out) > 1 else out[0]
    result._opt_result = res
    return result


def maximize(rf, **kwargs):
    kwargs["scale"] = -abs(kwargs.get("scale", 1.0))
    return minimize(rf, **kwargs)


class MinimizationSolver:
    """solve() driver over a MinimizationProblem (the ROLSolver/TAOSolver
    role, reference firedrake/adjoint/__init__.py:30; backend scipy)."""

    def __init__(self, problem: MinimizationProblem, parameters=None):
        self.problem = problem
        self.parameters = dict(parameters or {})

    def solve(self):
        return minimize(self.problem,
                        method=self.parameters.get("method"),
                        tol=self.parameters.get("tol"),
                        options=self.parameters.get("options"))
