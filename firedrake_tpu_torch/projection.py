"""L2 projection by a mass solve (reference: firedrake/projection.py:55)."""
from __future__ import annotations

from .language import TestFunction, TrialFunction, inner, dx
from .function import Function
from .solving import LinearVariationalProblem, LinearVariationalSolver

#: the JAX package's default projection solve
DEFAULT_PARAMS = {"ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": 1e-12}


def _problem(expr, V, bcs, name=None):
    f = V if isinstance(V, Function) else Function(V, name=name)
    V = f.function_space()
    u, v = TrialFunction(V), TestFunction(V)
    return LinearVariationalProblem(inner(u, v) * dx, inner(expr, v) * dx,
                                    f, bcs=bcs)


def project(expr, V, bcs=None, solver_parameters=None, name=None):
    """The L2 projection of expr into V (a space, or a Function to fill);
    returns the Function."""
    problem = _problem(expr, V, bcs, name)
    LinearVariationalSolver(
        problem, solver_parameters=solver_parameters or DEFAULT_PARAMS
    ).solve()
    return problem.u


class Projector:
    """A projection set up once and repeated by project() (reference:
    projection.py ProjectorBase)."""

    def __init__(self, expr, V, bcs=None, solver_parameters=None):
        self.expr = expr
        self.problem = _problem(expr, V, bcs)
        self.f = self.problem.u
        self.solver = LinearVariationalSolver(
            self.problem,
            solver_parameters=solver_parameters or DEFAULT_PARAMS)

    def project(self):
        self.solver.solve()
        return self.f
