"""The Krylov layer of the port against the JAX package: GMRES, FGMRES,
BiCGStab and MINRES on a symmetric positive definite and a non-symmetric
operator (UnitSquareMesh(8), P1), with and without Jacobi, GMRES also
restarted every 5 steps; LinearSolver and solve(A, x, b); a Neumann
Poisson solve with a constant nullspace (VectorSpaceBasis); project,
Projector and Function.project; RestrictedFunctionSpace.

Iteration counts must be equal; solutions agree within 1e-12 of their
largest entry (max norm)."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
import jax

import firedrake_tpu as J
import firedrake_tpu_torch as T

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
    # one BLAS thread: with six test workers, numpy's OpenBLAS threads
    # (one per host core in each worker) made its dense linear algebra
    # ~20x slower
    with threadpool_limits(limits=1, user_api="blas"):
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


def _forms(fd, kind, n=8):
    mesh = fd.UnitSquareMesh(n, n)
    V = fd.FunctionSpace(mesh, "CG", 1)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    x, y = fd.SpatialCoordinate(mesh)
    f = fd.Function(V).interpolate(fd.sin(fd.pi * x) * fd.cos(y) + 1)
    a = (fd.inner(fd.grad(u), fd.grad(v)) + u * v) * fd.dx
    if kind == "nonsym":
        # advection-diffusion: not symmetric
        a = a + fd.inner(fd.dot(fd.Constant([4.0, 2.0]), fd.grad(u)), v) \
            * fd.dx
    bc = fd.DirichletBC(V, 0.0, (1, 3))
    return V, a, fd.inner(f, v) * fd.dx, bc


def _linear(fd, kind, params):
    V, a, L, bc = _forms(fd, kind)
    uh = fd.Function(V)
    solver = fd.LinearVariationalSolver(
        fd.LinearVariationalProblem(a, L, uh, bcs=bc),
        solver_parameters=params)
    solver.solve()
    return solver, uh


METHODS = [(m, pc, {}) for m in ("gmres", "fgmres", "bicgstab", "minres")
           for pc in ("none", "jacobi")] + [("gmres", "jacobi",
                                              {"ksp_gmres_restart": 5})]


@pytest.mark.parametrize("kind", ["spd", "nonsym"])
@pytest.mark.parametrize("method, pc, extra", METHODS, ids=[
    f"{m}-{pc}" + ("-restart5" if extra else "")
    for m, pc, extra in METHODS])
def test_krylov_matches_jax(kind, method, pc, extra):
    params = {"ksp_type": method, "pc_type": pc, "ksp_rtol": 1e-10,
              **extra}
    sj, uj = _linear(J, kind, params)
    st, ut = _linear(T, kind, params)
    assert bool(sj.converged) and st.converged
    assert st.ksp_iterations == int(sj.ksp_iterations)
    _close(ut.dat, uj.dat)


def test_gmres_restart_is_read():
    """ksp_gmres_restart reaches the outer GMRES: restarting every 5
    steps takes more iterations than the default 30 on the
    non-symmetric operator."""
    base = {"ksp_type": "gmres", "pc_type": "none", "ksp_rtol": 1e-10}
    s30, _ = _linear(T, "nonsym", base)
    s5, _ = _linear(T, "nonsym", dict(base, ksp_gmres_restart=5))
    assert s5.ksp_iterations > s30.ksp_iterations


def _assembled(fd):
    V, a, L, bc = _forms(fd, "spd")
    return V, fd.assemble(a, bcs=bc), fd.assemble(L, bcs=bc)


@pytest.mark.parametrize("params", [
    {"ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": 1e-10},
    {"ksp_type": "preonly", "pc_type": "lu"},
])
def test_linear_solver_matches_jax(params):
    out = []
    for fd in (J, T):
        V, A, b = _assembled(fd)
        x = fd.Function(V)
        solver = fd.LinearSolver(A, solver_parameters=params)
        solver.solve(x, b)
        out.append((int(solver.ksp_iterations) if hasattr(
            solver, "ksp_iterations") else 1, _np(x.dat)))
    assert out[0][0] == out[1][0]
    _close(out[1][1], out[0][1])


def test_solve_A_x_b_matches_jax():
    out = []
    for fd in (J, T):
        V, A, b = _assembled(fd)
        x = fd.Function(V)
        assert fd.solve(A, x, b, solver_parameters={"ksp_rtol": 1e-10}) \
            is x
        out.append(_np(x.dat))
    _close(out[1], out[0])


def _neumann(fd):
    """The reference's test_neumann_poisson_nullspace at
    UnitSquareMesh(8)."""
    mesh = fd.UnitSquareMesh(8, 8)
    V = fd.FunctionSpace(mesh, "CG", 1)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    X = fd.SpatialCoordinate(mesh)
    f = fd.Function(V).interpolate(fd.cos(2 * fd.pi * X[0]))
    uh = fd.Function(V)
    s = fd.LinearVariationalSolver(
        fd.LinearVariationalProblem(fd.inner(fd.grad(u), fd.grad(v)) * fd.dx,
                                    fd.inner(f, v) * fd.dx, uh),
        solver_parameters={"ksp_type": "cg", "pc_type": "jacobi",
                           "ksp_rtol": 1e-11},
        nullspace=fd.VectorSpaceBasis(constant=True))
    s.solve()
    return s, uh


def test_nullspace_matches_jax():
    sj, uj = _neumann(J)
    st, ut = _neumann(T)
    assert st.converged
    assert st.ksp_iterations == int(sj.ksp_iterations)
    _close(ut.dat, uj.dat)
    assert abs(float(ut.dat.sum())) < 1e-8      # the constant is removed
    basis = T.VectorSpaceBasis(vecs=[T.Function(ut.function_space()).assign(
        1.0)])
    _close(basis.orthogonalize(ut.dat), ut.dat, 1e-10)
    # the same basis as one field of a mixed space
    V = ut.function_space()
    mixed = T.MixedVectorSpaceBasis(V * V, [None, basis])
    x = torch.cat([ut.dat, ut.dat])
    _close(mixed.orthogonalize(x), x, 1e-10)


def _projections(fd):
    mesh = fd.UnitSquareMesh(6, 6)
    V = fd.FunctionSpace(mesh, "CG", 2)
    x, y = fd.SpatialCoordinate(mesh)
    expr = fd.exp(x) * fd.sin(fd.pi * y)
    p1 = fd.project(expr, V)
    p2 = fd.Projector(expr, fd.Function(V)).project()
    p3 = fd.Function(V)
    p3.project(expr)
    return p1, p2, p3


def test_projection_matches_jax():
    for ours, ref in zip(_projections(T), _projections(J)):
        _close(ours.dat, ref.dat)


def test_restricted_space_matches_jax():
    out = []
    for fd in (J, T):
        mesh = fd.UnitSquareMesh(6, 6)
        V = fd.FunctionSpace(mesh, "CG", 2)
        Vr = fd.RestrictedFunctionSpace(V, boundary_set=["on_boundary"])
        u, v = fd.TrialFunction(Vr), fd.TestFunction(Vr)
        ur = fd.Function(Vr)
        s = fd.LinearVariationalSolver(
            fd.LinearVariationalProblem(
                fd.inner(fd.grad(u), fd.grad(v)) * fd.dx, v * fd.dx, ur),
            solver_parameters={"ksp_type": "cg", "pc_type": "jacobi",
                               "ksp_rtol": 1e-10})
        s.solve()
        out.append((int(s.ksp_iterations), _np(ur.dat)))
    assert out[0][0] == out[1][0]
    _close(out[1][1], out[0][1])
