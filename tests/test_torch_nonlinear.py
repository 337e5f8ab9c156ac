"""Nonlinear solves of the port against the JAX package: Newton with an
assembled or a matrix-free Jacobian (tests/regression/test_nonlinear.py's
problems, a backtracking line search, and chip_smoke.py's newton_p1_1m
problem at UnitSquareMesh(8) with GMG), two steps of demos/burgers.py at
n = 4, the EquationBC cases of tests/regression/test_equation_bc.py,
snes_type python (AuxiliaryOperatorSNES), and the options that belong to
other ROADMAP.md items.

Newton iteration counts must be equal; solutions agree within 1e-12 of
their largest entry (max norm).  K1's family covers every cell integral
of the newton_p1_1m problem (residual, Jacobian and its action), so the
torch lowerer is not used there."""
import numpy as np
import pytest
import torch
import jax

import firedrake_tpu as J
import firedrake_tpu_torch as T
from firedrake_tpu_torch.compiler import cell_eval as K

RTOL = 1e-12


#: the JAX package's reference programs are compiled with XLA's
#: optimisations off, which cuts the time of these tests by ~18% on 6 CPU
#: workers (most of it is compiling); the results agree within the same
#: tolerances.  The module's executables are dropped with it, so that no
#: later module runs them.
NO_OPT = "jax_disable_most_optimizations"


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    T.set_device("cpu")
    opt = jax.config.read(NO_OPT)
    jax.config.update(NO_OPT, True)
    yield
    jax.config.update(NO_OPT, opt)
    jax.clear_caches()
    torch.set_num_threads(n)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(ours, ref, rtol=RTOL):
    ours, ref = _np(ours), _np(ref)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max()
    assert err <= rtol * max(np.abs(ref).max(), 1e-300), err


def _nonlinear_poisson(fd, n, params, mesh=None):
    """-div((1 + u^2) grad u) = 1, u = 0 on the boundary (the reference's
    test_nonlinear_poisson_newton problem)."""
    mesh = mesh or fd.UnitSquareMesh(n, n)
    V = fd.FunctionSpace(mesh, "CG", 1)
    u, v = fd.Function(V), fd.TestFunction(V)
    F = fd.inner((1 + u * u) * fd.grad(u), fd.grad(v)) * fd.dx \
        - fd.inner(fd.Constant(1.0), v) * fd.dx
    bc = fd.DirichletBC(V, 0.0, "on_boundary")
    solver = fd.NonlinearVariationalSolver(
        fd.NonlinearVariationalProblem(F, u, bcs=[bc]),
        solver_parameters=params)
    solver.solve()
    return solver, u


def _newton_p1(fd, mat_type):
    """chip_smoke.py's newton_p1_1m problem on MeshHierarchy(
    UnitSquareMesh(4), 1): -lap u + u^2 = f, f from u = s = sin(pi x)
    sin(pi y), u = 0 on the boundary, u0 = 0, CG + GMG."""
    mesh = fd.MeshHierarchy(fd.UnitSquareMesh(4, 4), 1).meshes[-1]
    V = fd.FunctionSpace(mesh, "CG", 1)
    x, y = fd.SpatialCoordinate(mesh)
    s = fd.sin(fd.pi * x) * fd.sin(fd.pi * y)
    f = fd.Function(V).interpolate(2 * fd.pi ** 2 * s + s * s)
    u, v = fd.Function(V), fd.TestFunction(V)
    F = fd.inner(fd.grad(u), fd.grad(v)) * fd.dx + u * u * v * fd.dx \
        - f * v * fd.dx
    solver = fd.NonlinearVariationalSolver(
        fd.NonlinearVariationalProblem(
            F, u, bcs=fd.DirichletBC(V, 0, "on_boundary")),
        solver_parameters={"snes_rtol": 1e-10, "ksp_type": "cg",
                           "ksp_rtol": 1e-8, "pc_type": "mg",
                           "mat_type": mat_type})
    solver.solve()
    return solver, u


CASES = {
    "poisson_gmres_jacobi": lambda fd: _nonlinear_poisson(
        fd, 8, {"snes_rtol": 1e-10, "ksp_rtol": 1e-12}),
    "poisson_cg_aij": lambda fd: _nonlinear_poisson(
        fd, 6, {"snes_rtol": 1e-10, "ksp_rtol": 1e-12, "ksp_type": "cg",
                "mat_type": "aij"}),
    "poisson_cg_matfree": lambda fd: _nonlinear_poisson(
        fd, 6, {"snes_rtol": 1e-10, "ksp_rtol": 1e-12, "ksp_type": "cg",
                "mat_type": "matfree"}),
    "poisson_bt": lambda fd: _nonlinear_poisson(
        fd, 6, {"snes_rtol": 1e-10, "ksp_rtol": 1e-12,
                "snes_linesearch_type": "bt"}),
    "newton_p1_gmg_aij": lambda fd: _newton_p1(fd, "aij"),
    "newton_p1_gmg_matfree": lambda fd: _newton_p1(fd, "matfree"),
}


#: the JAX package's runs, one per problem: both of the port's Jacobians
#: on the GMG problem are held to its assembled one (compiling the JAX
#: package's GMG Newton solve takes seconds per step)
_JAX = {}
_JAX_CASE = {"newton_p1_gmg_matfree": "newton_p1_gmg_aij",
             "poisson_cg_matfree": "poisson_cg_aij"}


def _jax_run(case):
    ref = _JAX_CASE.get(case, case)
    if ref not in _JAX:
        _JAX[ref] = CASES[ref](J)
    return _JAX[ref]


@pytest.mark.parametrize("case", sorted(CASES))
def test_newton_matches_jax(case):
    sj, uj = _jax_run(case)
    K.lowerer_evals = 0
    st, ut = CASES[case](T)
    assert st.converged and bool(sj.converged)
    assert st.snes_iterations == sj.snes_iterations
    assert len(st.history) == st.snes_iterations
    _close(ut.dat, uj.dat)
    if case.startswith("newton_p1"):
        assert K.lowerer_evals == 0


def test_newton_matfree_matches_assembled():
    """The reference's test_nonlinear_matfree_matches_assembled, on the
    port alone: both Jacobians give one solution."""
    _, ua = CASES["poisson_cg_aij"](T)
    _, um = CASES["poisson_cg_matfree"](T)
    _close(um.dat, ua.dat, 1e-10)


def test_action_form_is_kept_on_the_jacobian(monkeypatch):
    """The matrix-free Jacobian's action form and assembler are made once
    per Jacobian form and held by that form, not by a module-level
    cache, and made anew when a switch the assembler reads changes."""
    from firedrake_tpu_torch.assembly.matfree import MatrixFreeOperator
    V = T.FunctionSpace(T.UnitSquareMesh(4, 4), "CG", 1)
    u, v = T.Function(V), T.TestFunction(V)
    Jf = T.derivative(T.inner(T.grad(u), T.grad(v)) * T.dx
                      + u * u * v * T.dx, u)
    a, b = MatrixFreeOperator(Jf), MatrixFreeOperator(Jf)
    assert a._asm1 is b._asm1 and a._w is b._w
    assert len(Jf.__dict__["_action_assemblers"]) == 1
    assert all(K.family_spec(ci) is not None for ci in a._asm1._compiled)
    monkeypatch.setenv("FDTPU_GATHER_ACC", "sorted")
    assert MatrixFreeOperator(Jf)._asm1 is not a._asm1


def _burgers(fd, steps=2, n=4):
    """demos/burgers.py at n = 4 for two steps: (Newton iterations per
    step, solution, energies)."""
    mesh = fd.UnitSquareMesh(n, n)
    V = fd.VectorFunctionSpace(mesh, "CG", 2)
    X = fd.SpatialCoordinate(mesh)
    u_, u = fd.Function(V), fd.Function(V)
    v = fd.TestFunction(V)
    u_.interpolate(fd.as_vector([fd.sin(fd.pi * X[0]), 0.0]))
    u.assign(u_)
    nu = fd.Constant(0.0001)
    dt = 1.0 / n
    F = (fd.inner((u - u_) / dt, v) + fd.inner(fd.dot(u, fd.nabla_grad(u)), v)
         + nu * fd.inner(fd.grad(u), fd.grad(v))) * fd.dx
    energies = [fd.assemble(fd.inner(u, u) * fd.dx)]
    its = []
    for _ in range(steps):
        solver = fd.NonlinearVariationalSolver(
            fd.NonlinearVariationalProblem(F, u),
            solver_parameters={"snes_rtol": 1e-8, "ksp_rtol": 1e-10})
        solver.solve()
        assert solver.converged
        its.append(solver.snes_iterations)
        u_.assign(u)
        energies.append(fd.assemble(fd.inner(u, u) * fd.dx))
    return its, u, energies


def test_burgers_two_steps():
    ij, uj, ej = _burgers(J)
    it, ut, et = _burgers(T)
    assert it == ij
    _close(ut.dat, uj.dat)
    np.testing.assert_allclose(et, ej, rtol=RTOL)
    assert et[2] < et[1] < et[0]


def _equation_bc(fd, case):
    mesh = fd.UnitSquareMesh(8, 8)
    V = fd.FunctionSpace(mesh, "CG", 1)
    X = fd.SpatialCoordinate(mesh)
    u, v = fd.Function(V), fd.TestFunction(V)
    F = fd.inner(fd.grad(u), fd.grad(v)) * fd.dx
    if case == "weak_dirichlet":
        exact = 1 + X[0]
        bcs = [fd.EquationBC(fd.inner(u - exact, v) * fd.ds == 0, u,
                             "on_boundary")]
    else:
        exact = X[1]
        bcs = [fd.EquationBC(fd.inner(u - X[1], v) * fd.ds(1) == 0, u, 1),
               fd.DirichletBC(V, fd.Function(V).interpolate(X[1]),
                              (2, 3, 4))]
    solver = fd.NonlinearVariationalSolver(
        fd.NonlinearVariationalProblem(F, u, bcs=bcs),
        solver_parameters={"snes_rtol": 1e-12, "ksp_type": "preonly",
                           "pc_type": "lu"})
    solver.solve()
    return solver, u, fd.errornorm(exact, u), bcs[0]


@pytest.mark.parametrize("case", ["weak_dirichlet", "with_dirichlet"])
def test_equation_bc_matches_jax(case):
    sj, uj, ej, bj = _equation_bc(J, case)
    st, ut, et, bt = _equation_bc(T, case)
    assert np.array_equal(bt.dof_indices, np.asarray(bj.dof_indices))
    assert st.snes_iterations == sj.snes_iterations
    assert st.converged
    _close(ut.dat, uj.dat)
    assert et < 1e-8


def test_solve_F_eq_0_and_homogenize():
    """solve(F == 0, u) dispatches to Newton (held to the JAX package's
    NonlinearVariationalSolver on the same problem); homogenize keeps the
    boundary and zeroes the value."""
    sj, uj = _jax_run("poisson_cg_aij")
    mesh = T.UnitSquareMesh(6, 6)
    V = T.FunctionSpace(mesh, "CG", 1)
    u, v = T.Function(V), T.TestFunction(V)
    F = T.inner((1 + u * u) * T.grad(u), T.grad(v)) * T.dx \
        - T.inner(T.Constant(1.0), v) * T.dx
    bc = T.DirichletBC(V, 2.0, "on_boundary")
    T.solve(F == 0, u, bcs=T.homogenize(bc),
            solver_parameters={"snes_rtol": 1e-10, "ksp_rtol": 1e-12,
                               "ksp_type": "cg"})
    _close(u.dat, uj.dat)
    for fd, b in ((J, J.DirichletBC(J.FunctionSpace(J.UnitSquareMesh(6, 6),
                                                    "CG", 1), 2.0,
                                    "on_boundary")), (T, bc)):
        h = fd.homogenize(b)
        assert h.sub_domain == b.sub_domain
        assert np.array_equal(np.asarray(h.dof_indices), bc.dof_indices)
        assert np.abs(np.asarray(h.value_vector())).max() == 0.0
        assert np.asarray(b.value_vector()).max() == 2.0


class _MassAux(T.AuxiliaryOperatorSNES):
    """The Laplacian as the auxiliary operator of the nonlinear Poisson
    problem."""

    def form(self, snes, test, trial):
        return T.inner(T.grad(trial), T.grad(test)) * T.dx, None


class _MassAuxJ(J.AuxiliaryOperatorSNES):
    def form(self, snes, test, trial):
        return J.inner(J.grad(trial), J.grad(test)) * J.dx, None


def test_auxiliary_operator_snes_matches_jax():
    import sys
    mod = sys.modules[__name__]
    out = []
    for fd, cls in ((J, "_MassAuxJ"), (T, "_MassAux")):
        params = {"snes_type": "python",
                  "snes_python_type": f"{mod.__name__}.{cls}",
                  "snes_rtol": 1e-8, "snes_max_it": 30}
        solver, u = _nonlinear_poisson(fd, 6, params)
        assert solver.converged
        out.append((solver.snes_iterations, _np(u.dat)))
    assert out[0][0] == out[1][0]
    _close(out[1][1], out[0][1])


# nonlinear multigrid and the patch smoother are ported
# (test_torch_multilevel.py), and so is deflation (test_torch_ddm.py):
# under each of them it runs as in the JAX package: the FAS branches
# return before Newton's loop and leave the deflation alone, Newton with
# or without the patch smoother scales its steps and records the root
@pytest.mark.parametrize("params, appctx", [
    ({"snes_type": "fas"}, {"deflation": object()}),
    ({"snes_type": "pfas"}, {"deflation": object()}),
    ({"snes_type": "python", "snes_python_type": "firedrake.PMGSNES"},
     {"deflation": object()}),
    ({"npc_snes_type": "patch"}, {"deflation": object()}),
    ({}, {"deflation": object()}),
])
def test_other_items_raise(params, appctx, monkeypatch):
    from firedrake_tpu_torch.solvers import fas
    mesh = T.UnitSquareMesh(2, 2)
    V = T.FunctionSpace(mesh, "CG", 1)
    u, v = T.Function(V), T.TestFunction(V)
    F = (u * u - 1.0) * v * T.dx
    deflation = T.Deflation()
    appctx = dict(appctx, deflation=deflation)
    modes = []

    class _FAS:
        def __init__(self, *args, mode, **kw):
            modes.append(mode)

        def solve(self):
            self.iterations, self.converged = 0, True
    monkeypatch.setattr(fas, "FASSolver", _FAS)
    u.dat = torch.full((V.dim,), 0.5, dtype=torch.float64)
    T.solve(F == 0, u, solver_parameters=params, appctx=appctx)
    if "snes_type" in params:
        assert len(modes) == 1 and len(deflation) == 0
    else:
        assert not modes and len(deflation) == 1
        assert float((deflation.roots[0].dat - 1.0).abs().max()) < 1e-8
