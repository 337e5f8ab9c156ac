"""solve() dispatch, the linear and nonlinear variational solvers and
LinearSolver.

Reference: firedrake/solving.py:34 (solve), firedrake/variational_solver.py
(LinearVariationalSolver :293, NonlinearVariationalSolver :309-461),
firedrake/solving_utils.py:138 (_SNESContext), firedrake/linear_solver.py.
PETSc SNES and KSP are replaced by the Newton loop below and the Krylov
loops of solvers/krylov.py; the `solver_parameters` dict API is kept.

Ported: linear problems, assembled (mat_type aij) or matrix-free
(mat_type matfree, assembly/matfree.py), with Dirichlet conditions and
nullspaces (nullspace.py), by CG, GMRES, FGMRES, BiCGStab, MINRES,
Richardson or Chebyshev (or preonly) with the PCs of
solvers/composition.py; preonly + lu is a host sparse LU.  Nonlinear
problems by Newton (newtonls; line searches basic, none, bt, l2) with an
assembled or matrix-free Jacobian, Dirichlet conditions and EquationBCs
(whose Newton steps are a host sparse LU, as in the JAX package), and
snes_type python (solvers/snes.py).  On mixed spaces the operator is a
BlockMatrix (mixed.py): preonly + lu factors its host CSR copy; a Krylov
method runs its matvec on the device under any PC of
solvers/composition.py (fieldsplit, vanka, python PCs among them).
``pc_type`` hybridization (solvers/hybridization.py) and scpc
(solvers/scpc.py) condense per cell through Slate (slate.py) and solve
the trace or interface system by host LU or a Krylov method on the
device.  Nonlinear multigrid: ``snes_type`` fas (over a MeshHierarchy)
and pfas or PMGSNES (over degree levels), solvers/fas.py; nonlinear
vertex-star patch relaxation before each Newton step (``npc_snes_type``
patch), its patch solves through K2.  Deflation and distributed solves
raise NotImplementedError naming their ROADMAP.md item.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .language.measure import Form, Equation
from .language.calculus import derivative
from .bcs import DirichletBC, EquationBC, as_bcs
from .assemble import assemble
from .function import Function
from .solvers.krylov import KSP_METHODS
from .solvers.preconditioners import identity_pc
from .solvers.composition import OpCtx, build_pc
from .device import as_tensor, to_numpy

__all__ = ["solve", "LinearVariationalProblem", "LinearVariationalSolver",
           "NonlinearVariationalProblem", "NonlinearVariationalSolver",
           "LinearSolver"]

DEFAULT_KSP_PARAMS = {
    "ksp_type": "gmres",
    "pc_type": "jacobi",
    "ksp_rtol": 1e-7,
    "ksp_atol": 1e-50,
    "ksp_max_it": 10000,
}
DEFAULT_SNES_PARAMS = {
    "snes_type": "newtonls",
    "snes_rtol": 1e-8,
    "snes_atol": 1e-50,
    "snes_max_it": 50,
    "snes_linesearch_type": "basic",
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


def _merged_params(solver_parameters, nonlinear=False):
    p = dict(DEFAULT_KSP_PARAMS)
    if nonlinear:
        p.update(DEFAULT_SNES_PARAMS)
    p.update(flatten_parameters(solver_parameters))
    return p


def _split_bcs(bcs):
    bcs = as_bcs(bcs)
    return (tuple(b for b in bcs if isinstance(b, DirichletBC)),
            tuple(b for b in bcs if isinstance(b, EquationBC)))


def _bc_data(bcs, n):
    """(bc_idx int array, g full vector) — Dirichlet bcs only."""
    bcs = _split_bcs(bcs)[0]
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
    kw = dict(rtol=params.get("ksp_rtol", 1e-7),
              atol=params.get("ksp_atol", 1e-50),
              max_it=int(params.get("ksp_max_it", 10000)))
    # the JAX package reads ksp_gmres_restart for gmres only (fgmres keeps
    # its default of 30 here)
    if ksp_type == "gmres":
        kw["restart"] = int(params.get("ksp_gmres_restart", 30))
    return meth(op, b, x0=x0, pc=pc or identity_pc, **kw)


def _with_nullspace(op, b, nullspace):
    """The operator and right-hand side with the nullspace projected out
    (the PETSc MatNullSpace role): op(x) = P A P x + (x - P x), b = P b."""
    if nullspace is None or nullspace.is_trivial():
        return op, b

    def projected(x):
        px = nullspace.orthogonalize(x)
        return nullspace.orthogonalize(op(px)) + (x - px)

    return projected, nullspace.orthogonalize(b)


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
        python_type = params.get("pc_python_type", "")
        if (params.get("pc_type") == "hybridization"
                or python_type.endswith("HybridizationPC")):
            if params.get("distributed"):
                raise NotImplementedError(
                    "distributed hybridization (parallel/dhybrid.py) is "
                    "not ported yet: ROADMAP.md queue 1, item 20")
            from .solvers.hybridization import solve_hybridization
            self.ksp_iterations, self.converged = solve_hybridization(
                p, params, appctx=self.appctx)
            return
        if (params.get("pc_type") == "scpc"
                or python_type.endswith("SCPC")):
            from .solvers.scpc import solve_scpc
            self.ksp_iterations, self.converged = solve_scpc(
                p, params, appctx=self.appctx)
            return
        if params.get("distributed"):
            raise NotImplementedError("distributed solves are not ported "
                                      "yet: ROADMAP.md queue 1, item 20")
        if mat_type not in ("aij", "matfree"):
            raise NotImplementedError(
                f"mat_type {mat_type!r} is not ported; ported: 'aij' and "
                "'matfree'")
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
                params.get("pc_type") in ("lu", "cholesky", "ilu"):
            if mat_type == "matfree":
                raise ValueError("pc_type 'lu' needs an assembled "
                                 "operator; got mat_type 'matfree'")
            p.u.dat = direct_solve(A, bvec)
            self.ksp_iterations = 1
            self.converged = True
            return
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
        op, bvec = _with_nullspace(A.matvec, bvec, self.nullspace)
        res = _run_ksp(op, bvec, params, pc=pc, x0=as_tensor(p.u.dat))
        p.u.dat = res.x
        self.ksp_iterations = res.iterations
        self.converged = res.converged
        if not self.converged:
            warnings.warn(f"linear solve did not converge: "
                          f"rnorm={res.residual_norm:.3e} after "
                          f"{self.ksp_iterations} its")


# --------------------------------------------------------------- nonlinear
class NonlinearVariationalProblem:
    """F(u; v) = 0 for u (reference: variational_solver.py
    NonlinearVariationalProblem); J defaults to the Gateaux derivative of
    F."""

    def __init__(self, F, u, bcs=None, J=None, Jp=None,
                 form_compiler_parameters=None):
        self.F = F
        self.u = u
        self.bcs = as_bcs(bcs)
        self.J = J if J is not None else derivative(F, u)


class NonlinearVariationalSolver:
    """Newton with line search, the PETSc SNES newtonls analogue
    (reference: solving_utils.py:138 _SNESContext; the function and
    Jacobian callbacks :527, :561).

    After solve(): ``snes_iterations``, ``converged``, and ``history``, one
    dict per Newton step with the residual norm before the step, the
    linear solve's iteration count and the step's deflation factor tau (1
    without appctx["deflation"]; deflation.py)."""

    def __init__(self, problem, *, solver_parameters=None,
                 options_prefix=None, appctx=None, nullspace=None,
                 pre_jacobian_callback=None, pre_function_callback=None,
                 **kwargs):
        self.problem = problem
        self.params = _merged_params(solver_parameters, nonlinear=True)
        self.appctx = appctx or {}
        # the nonlinear patch smoother's patches and sum plan, made once
        self._npc_patches = None

    def _residual(self, uvec):
        """F(u) with the EquationBC rows replaced by the boundary forms'
        and the Dirichlet rows by u - g."""
        p = self.problem
        p.u.dat = uvec
        r = as_tensor(assemble(p.F).dat)
        for ebc in _split_bcs(p.bcs)[1]:
            eidx = as_tensor(ebc.dof_indices.astype(np.int64))
            r = r.index_put((eidx,), as_tensor(assemble(ebc.F).dat)[eidx])
        idx, g = self._dirichlet
        if len(idx):
            r = r.index_put((idx,), uvec[idx] - g[idx])
        return r

    def solve(self):
        p = self.problem
        params = self.params
        V = p.u.function_space()
        bc_idx, g = _bc_data(p.bcs, V.dim)
        idx = as_tensor(bc_idx.astype(np.int64))
        self._dirichlet = (idx, as_tensor(g))
        spt = params.get("snes_python_type", "")
        if params.get("snes_type") in ("fas", "pfas") \
                or spt.endswith("PMGSNES"):
            # FAS nonlinear multigrid (PETSc SNESFAS): h-levels from the
            # MeshHierarchy, or degree levels for 'pfas' (the reference
            # PMGSNES)
            from .solvers.fas import FASSolver
            mode = "p" if (params.get("snes_type") == "pfas"
                           or spt.endswith("PMGSNES")) else "h"
            fas = FASSolver(p.F, p.u, bcs=p.bcs, params=params, mode=mode)
            fas.solve()
            self.snes_iterations = fas.iterations
            self.converged = fas.converged
            if not self.converged:
                warnings.warn(f"FAS did not converge after "
                              f"{fas.iterations} cycles")
            return
        if params.get("snes_type") == "python":
            # SNES-level python types: AuxiliaryOperatorSNES subclasses
            from .solvers.snes import (resolve_snes_python,
                                       AuxiliaryOperatorSNES)
            spt = params.get("snes_python_type", "")
            cls = resolve_snes_python(spt)
            if not issubclass(cls, AuxiliaryOperatorSNES):
                raise TypeError(f"snes_python_type {spt!r} must "
                                "subclass AuxiliaryOperatorSNES")
            obj = cls()
            self.snes_iterations = obj.solve(p, params, appctx=self.appctx)
            self.converged = obj.converged
            return
        rtol = params.get("snes_rtol", 1e-8)
        atol = params.get("snes_atol", 1e-50)
        stol = params.get("snes_stol", 1e-8)
        max_it = int(params.get("snes_max_it", 50))
        ls = params.get("snes_linesearch_type", "basic")
        mat_type = params.get("mat_type", "aij")
        npc = params.get("npc_snes_type")
        deflation = self.appctx.get("deflation")

        # the initial guess on the constraint manifold
        u = as_tensor(p.u.dat)
        if len(idx):
            u = u.index_put((idx,), self._dirichlet[1][idx])
        r = self._residual(u)
        r0 = float(torch.linalg.vector_norm(r))
        rnorm = r0
        self.snes_iterations = 0
        self.history = []
        stalled = False
        for it in range(max_it):
            if rnorm <= max(rtol * r0, atol) or r0 == 0.0:
                break
            if npc == "patch":
                # left nonlinear preconditioning (PETSc npc_snes_type,
                # the reference's PatchSNES): vertex-star relaxation
                # before the global step
                u = self._patch_smooth(u, bc_idx, params)
                r = self._residual(u)
                rnorm = float(torch.linalg.vector_norm(r))
                if rnorm <= max(rtol * r0, atol):
                    self.snes_iterations = it + 1
                    break
            du, its = self._newton_step(u, r, bc_idx, params, mat_type)
            tau = 1.0
            if deflation is not None and len(deflation):
                # deflated Newton (deflation.py): scale du by tau so the
                # iteration cannot reconverge to a known root
                p.u.dat = u
                tau = deflation.tau(p.u, du)
                du = tau * du
            # snes_stol: a step too small relative to the iterate
            if float(torch.linalg.vector_norm(du)) <= stol * max(
                    float(torch.linalg.vector_norm(u)), 1e-30):
                stalled = True
                break
            self.history.append(dict(rnorm=rnorm, ksp_iterations=its,
                                     tau=tau))
            t = 1.0
            u_new = u + du
            r_new = self._residual(u_new)
            if ls not in ("basic", "none"):     # backtracking: bt, l2
                for _ in range(7):
                    if float(torch.linalg.vector_norm(r_new)) < rnorm:
                        break
                    t *= 0.5
                    u_new = u + t * du
                    r_new = self._residual(u_new)
            u, r = u_new, r_new
            rnorm = float(torch.linalg.vector_norm(r))
            self.snes_iterations = it + 1
        p.u.dat = u
        self.converged = stalled or rnorm <= max(rtol * r0, atol)
        if self.converged and deflation is not None:
            # record the solution just found (reference DeflatedSNES.solve)
            deflation.append(Function(p.u))
        if not self.converged:
            warnings.warn(f"Newton did not converge: |r|={rnorm:.3e} "
                          f"after {self.snes_iterations} iterations")

    def _patch_smooth(self, u, bc_idx, params):
        """Vertex-star nonlinear relaxation (the reference's PatchSNES):
        each sweep assembles the residual and the Jacobian once and takes
        one damped Newton step on every star patch at once, the patches
        without the Dirichlet dofs (so u stays on the constraint
        manifold).  The patch matrices are gathered from the Jacobian on
        its device and solved through K2; the corrections are summed in a
        fixed order and averaged by the overlap counts."""
        from .assemble import _accumulation_device
        from .ops.batched_inverse import batched_inv
        from .solvers.preconditioners import patch_matrices, star_patches
        p = self.problem
        V = p.u.function_space()
        sweeps = int(params.get("npc_snes_max_it", 1))
        damp = float(params.get("npc_snes_linesearch_damping", 1.0))
        if self._npc_patches is None:
            idx, mask = star_patches(V, exclude=bc_idx)
            idx_t, mask_t = as_tensor(idx), as_tensor(mask)
            acc = _accumulation_device(
                torch.where(mask_t > 0, idx_t, V.dim).reshape(-1), V.dim)
            counts = np.bincount(idx[mask > 0], minlength=V.dim)
            self._npc_patches = (idx, mask, idx_t, mask_t, acc,
                                 as_tensor(np.maximum(counts, 1.0)))
        idx, mask, idx_t, mask_t, acc, counts = self._npc_patches
        for _ in range(sweeps):
            r = self._residual(u)
            Apinv = batched_inv(patch_matrices(assemble(p.J), idx, mask))
            if not bool(torch.isfinite(Apinv).all()):
                raise ArithmeticError(
                    "npc patch: a patch Jacobian has no inverse without "
                    f"pivoting ({idx.shape[0]} patches of up to "
                    f"{idx.shape[1]} dofs)")
            dp = torch.einsum("pij,pj->pi", Apinv, r[idx_t] * mask_t)
            u = u - damp * acc((dp * mask_t).reshape(-1)).to(u.dtype) \
                / counts
        return u

    def _jacobian(self, bc_idx, mat_type):
        """The Jacobian at the current iterate with identity Dirichlet
        rows: assembled, or matrix-free (the action of J through
        MatrixFreeOperator, whose action form is made once per J)."""
        J = self.problem.J
        if mat_type == "matfree":
            from .assembly.matfree import MatrixFreeOperator
            A = MatrixFreeOperator(J)
        else:
            A = assemble(J)
        return A.with_dirichlet(bc_idx) if len(bc_idx) else A

    def _newton_step(self, u, r, bc_idx, params, mat_type):
        """(du, linear iterations) of J du = -r at u."""
        p = self.problem
        p.u.dat = u
        V = p.u.function_space()
        ebcs = _split_bcs(p.bcs)[1]
        if ebcs:
            if mat_type == "matfree":
                raise ValueError("EquationBC needs an assembled Jacobian; "
                                 "got mat_type 'matfree'")
            return _equation_bc_step(assemble(p.J), ebcs, bc_idx, r), 1
        A = self._jacobian(bc_idx, mat_type)
        if mat_type != "matfree" and params.get("ksp_type") == "preonly" \
                and params.get("pc_type") in ("lu", "cholesky", "ilu"):
            return direct_solve(A, -r), 1
        pc_params = params
        if mat_type == "matfree":
            # as in the JAX package: the matrix-free Krylov operator has no
            # assembled diagonal, so jacobi falls back to no PC
            ctx = OpCtx(matvec=A.matvec, space=V, form=p.J, bcs=p.bcs,
                        appctx=self.appctx)
            if params.get("pc_type", "none") == "jacobi":
                pc_params = dict(params, pc_type="none")
        else:
            ctx = OpCtx(mat=A, space=V, form=p.J, bcs=p.bcs,
                        appctx=self.appctx)
        pc = build_pc(ctx, pc_params, "")
        if params.get("ksp_type") == "preonly":
            return pc(-r), 1
        res = _run_ksp(A.matvec, -r, params, pc=pc)
        return res.x, res.iterations


def _equation_bc_step(J, ebcs, bc_idx, r):
    """The Newton step with EquationBC rows: the Jacobian's boundary rows
    replaced by the boundary forms' and the Dirichlet rows by identity
    rows, solved by a host sparse LU (scipy), as the JAX package does."""
    from scipy.sparse.linalg import spsolve
    Js = J.to_scipy().tolil()
    for ebc in ebcs:
        Jb = assemble(ebc.J).to_scipy().tolil()
        eidx = np.asarray(ebc.dof_indices)
        Js[eidx] = Jb[eidx]
    if len(bc_idx):
        Js[bc_idx] = 0.0
        Js[bc_idx, bc_idx] = 1.0
    du = spsolve(Js.tocsc(), to_numpy(-r))
    return torch.as_tensor(du, dtype=r.dtype, device=r.device)


class LinearSolver:
    """Solve with an assembled operator (reference:
    firedrake/linear_solver.py).  After solve(): ``ksp_iterations`` and
    ``converged``."""

    def __init__(self, A, *, P=None, solver_parameters=None, appctx=None,
                 **kwargs):
        self.A = A
        self.params = _merged_params(solver_parameters)
        self.appctx = appctx or {}

    def solve(self, x: Function, b):
        bvec = as_tensor(b.dat if isinstance(b, Function) else b)
        A = self.A
        if self.params.get("ksp_type") == "preonly":
            x.dat = direct_solve(A, bvec)
            self.ksp_iterations, self.converged = 1, True
            return
        # a BlockMatrix's space is its mixed test space (fieldsplit, vanka)
        ctx = OpCtx(mat=A, space=getattr(A, "row_space",
                                         getattr(A, "W_test", None)),
                    bcs=getattr(A, "bcs", ()), appctx=self.appctx)
        pc = build_pc(ctx, self.params, "")
        res = _run_ksp(A.matvec, bvec, self.params, pc=pc)
        x.dat = res.x
        self.ksp_iterations = res.iterations
        self.converged = res.converged


# ------------------------------------------------------------------ solve()
def solve(*args, **kwargs):
    """solve(a == L, u, bcs=...), solve(F == 0, u, bcs=...) or
    solve(A, x, b) (reference: firedrake/solving.py:34).  Returns u (or
    x)."""
    if not isinstance(args[0], Equation):
        A, x, b = args[:3]
        LinearSolver(A, solver_parameters=kwargs.get("solver_parameters"),
                     appctx=kwargs.get("appctx")).solve(x, b)
        return x
    eq, u = args[0], args[1]
    bcs = kwargs.get("bcs")
    sp = kwargs.get("solver_parameters")
    appctx = kwargs.get("appctx")
    is_linear = {a.number for a in eq.lhs.arguments()} == {0, 1}
    if is_linear:
        problem = LinearVariationalProblem(eq.lhs, eq.rhs, u, bcs=bcs)
        solver = LinearVariationalSolver(
            problem, solver_parameters=sp, appctx=appctx,
            nullspace=kwargs.get("nullspace"))
    else:
        F = eq.lhs
        if isinstance(eq.rhs, Form) and not eq.rhs.empty():
            F = F - eq.rhs
        problem = NonlinearVariationalProblem(F, u, bcs=bcs,
                                              J=kwargs.get("J"))
        solver = NonlinearVariationalSolver(problem, solver_parameters=sp,
                                            appctx=appctx)
    solver.solve()
    from .adjoint.tape import annotate_tape, get_working_tape, SolveBlock
    if annotate_tape():
        # the residual form F(u) = 0 (JAX solving.py:678-690)
        if is_linear:
            from .language.calculus import action
            F = action(eq.lhs, u) - (eq.rhs if isinstance(eq.rhs, Form)
                                     else Form(()))
        get_working_tape().add_block(SolveBlock(F, u, bcs, sp, appctx))
    return u
