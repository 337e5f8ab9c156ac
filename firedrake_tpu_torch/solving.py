"""solve() dispatch + the linear variational solver.

Reference: firedrake/solving.py:34 (solve), firedrake/variational_solver.py
(LinearVariationalSolver :293).  PETSc KSP is replaced by the Krylov
loops of solvers/krylov.py; the `solver_parameters` dict API is kept.

Ported so far: linear problems, assembled (mat_type aij) or matrix-free
(mat_type matfree, assembly/matfree.py), with Dirichlet conditions,
solved by CG, Richardson or Chebyshev (or preonly) with the PCs of
solvers/composition.py: none, jacobi, lu, ksp, mg (geometric multigrid)
and patch; preonly + lu is a host sparse LU.  Nonlinear problems (and
their matrix-free Newton step), nullspaces, hybridization, SCPC,
fieldsplit and distributed solves raise NotImplementedError.
"""
from __future__ import annotations

import numpy as np
import torch

from .language.measure import Form, Equation
from .bcs import DirichletBC, as_bcs
from .assemble import assemble
from .solvers.krylov import KSP_METHODS
from .solvers.preconditioners import identity_pc
from .device import as_tensor

__all__ = ["solve", "LinearVariationalProblem", "LinearVariationalSolver"]

DEFAULT_KSP_PARAMS = {
    "ksp_type": "gmres",
    "pc_type": "jacobi",
    "ksp_rtol": 1e-7,
    "ksp_atol": 1e-50,
    "ksp_max_it": 10000,
}


def flatten_parameters(params, sep="_"):
    """PETSc-style nested solver_parameters: a dict value is a subtree
    whose keys get the parent key as prefix."""
    out = {}
    for k, v in (params or {}).items():
        if isinstance(v, dict):
            for ik, iv in flatten_parameters(v, sep).items():
                out[k + sep + ik] = iv
        else:
            out[k] = v
    return out


def _merged_params(solver_parameters):
    p = dict(DEFAULT_KSP_PARAMS)
    p.update(flatten_parameters(solver_parameters))
    return p


def _bc_data(bcs, n):
    """(bc_idx int array, g full vector) — Dirichlet bcs only."""
    bcs = tuple(b for b in as_bcs(bcs) if isinstance(b, DirichletBC))
    if not bcs:
        return np.zeros(0, dtype=np.int32), np.zeros(n)
    idx = np.unique(np.concatenate([bc.dof_indices for bc in bcs]))
    g = np.zeros(n)
    for bc in bcs:
        gv = bc.value_vector()
        g[bc.dof_indices] = gv[bc.dof_indices]
    return idx.astype(np.int32), g


def _run_ksp(op, b, params, pc=None, x0=None):
    ksp_type = params.get("ksp_type", "cg")
    meth = KSP_METHODS.get(ksp_type)
    if meth is None:
        raise NotImplementedError(f"ksp_type {ksp_type!r} is not ported "
                                  f"yet; available: {sorted(KSP_METHODS)}")
    return meth(op, b, x0=x0, pc=pc or identity_pc,
                rtol=params.get("ksp_rtol", 1e-7),
                atol=params.get("ksp_atol", 1e-50),
                max_it=int(params.get("ksp_max_it", 10000)))


class LinearVariationalProblem:
    """Reference: variational_solver.py:259-290 (wraps a x = L)."""

    def __init__(self, a, L, u, bcs=None, aP=None,
                 form_compiler_parameters=None, constant_jacobian=False):
        self.a = a
        # NB: don't write `L == 0` — Form.__eq__ builds an Equation.
        if L is None or (isinstance(L, (int, float)) and L == 0) \
                or (isinstance(L, Form) and L.empty()):
            L = None
        self.L = L
        self.u = u
        self.bcs = as_bcs(bcs)
        self.constant_jacobian = constant_jacobian


_UNPORTED = {"hybridization", "scpc", "ilu", "fieldsplit"}


def direct_solve(A, b):
    """Host sparse LU of the assembled operator (the PETSc `preonly` +
    `lu` role at the outermost level); the solution goes back to b's
    device."""
    from scipy.sparse.linalg import spsolve
    x = spsolve(A.to_scipy().tocsc(), b.detach().cpu().numpy())
    return torch.as_tensor(x, dtype=b.dtype, device=b.device)


class LinearVariationalSolver:
    def __init__(self, problem: LinearVariationalProblem, *,
                 solver_parameters=None, options_prefix=None, appctx=None,
                 nullspace=None, **kwargs):
        self.problem = problem
        self.params = _merged_params(solver_parameters)
        self.nullspace = nullspace
        self.appctx = appctx or {}
        self._mat = None

    def solve(self):
        p = self.problem
        params = self.params
        mat_type = params.get("mat_type", "aij")
        if params.get("pc_type") in _UNPORTED or params.get("distributed") \
                or mat_type not in ("aij", "matfree"):
            raise NotImplementedError(
                f"pc_type {params.get('pc_type')!r} / distributed / "
                f"mat_type {mat_type!r} solves are not ported yet; ported: "
                "mat_type 'aij' or 'matfree' with pc_type none, jacobi, "
                "lu, ksp, mg or patch")
        if self.nullspace is not None:
            raise NotImplementedError("nullspaces are not ported yet")
        V = p.u.function_space()
        n = V.dim
        bc_idx, g = _bc_data(p.bcs, n)
        gj = as_tensor(g)

        b = (as_tensor(assemble(p.L).dat) if p.L is not None
             else torch.zeros_like(gj))
        if self._mat is not None and p.constant_jacobian:
            A0 = self._mat
        elif mat_type == "matfree":
            # action-assembly operator (reference: matrix_free/
            # operators.py ImplicitMatrix), duck-typed like the assembled
            # one, so jacobi, chebyshev and mg compose with it unchanged
            from .assembly.matfree import MatrixFreeOperator
            A0 = MatrixFreeOperator(p.a)
        else:
            A0 = assemble(p.a)
        if p.constant_jacobian:
            self._mat = A0
        if len(bc_idx):
            idx = torch.as_tensor(bc_idx.astype(np.int64),
                                  device=b.device)
            bvec = (b - A0.matvec(gj)).index_put((idx,), gj[idx])
            A = A0.with_dirichlet(bc_idx)
        else:
            bvec, A = b, A0
        if params.get("ksp_type") == "preonly" and \
                params.get("pc_type") in ("lu", "cholesky"):
            if mat_type == "matfree":
                raise ValueError("pc_type 'lu' needs an assembled "
                                 "operator; got mat_type 'matfree'")
            p.u.dat = direct_solve(A, bvec)
            self.ksp_iterations = 1
            self.converged = True
            return
        from .solvers.composition import OpCtx, build_pc
        ctx = OpCtx(mat=A, space=V, form=p.a, bcs=p.bcs,
                    appctx=self.appctx)
        # the GMG hierarchy (level operators, smoothers) is built once per
        # solver and reused by later solves, as in the JAX package
        if params.get("pc_type") == "mg":
            if not hasattr(self, "_gmg"):
                self._gmg = build_pc(ctx, params, "")
            pc = self._gmg
        else:
            pc = build_pc(ctx, params, "")
        if params.get("ksp_type") == "preonly":
            p.u.dat = pc(bvec)
            self.ksp_iterations = 1
            self.converged = True
            return
        res = _run_ksp(A.matvec, bvec, params, pc=pc,
                       x0=as_tensor(p.u.dat))
        p.u.dat = res.x
        self.ksp_iterations = res.iterations
        self.converged = res.converged
        if not self.converged:
            import warnings
            warnings.warn(f"linear solve did not converge: "
                          f"rnorm={res.residual_norm:.3e} after "
                          f"{self.ksp_iterations} its")


def solve(*args, **kwargs):
    """solve(a == L, u, bcs=..., solver_parameters=...) (reference:
    firedrake/solving.py:34).  Returns u."""
    if not isinstance(args[0], Equation):
        raise NotImplementedError("solve(A, x, b) is not ported yet")
    eq, u = args[0], args[1]
    if {a.number for a in eq.lhs.arguments()} != {0, 1}:
        raise NotImplementedError("nonlinear solves (Newton) are not "
                                  "ported yet")
    problem = LinearVariationalProblem(eq.lhs, eq.rhs, u,
                                       bcs=kwargs.get("bcs"))
    solver = LinearVariationalSolver(
        problem, solver_parameters=kwargs.get("solver_parameters"),
        appctx=kwargs.get("appctx"), nullspace=kwargs.get("nullspace"))
    solver.solve()
    return u
