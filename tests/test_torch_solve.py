"""End to end: the README problem (UnitSquareMesh(16, 16), P1, CG +
Jacobi) and Dirichlet Poisson (UnitSquareMesh(8, 8), P2) solved by both
packages from the same state, handed to the port through interop.

Iteration counts must be equal; a difference of one is tolerated because
the two packages reduce the CG dot products in different orders, which
can move the f64 residual norm across the rtol threshold by one
iteration.  Solutions agree to 1e-8 relative in the 2-norm at ksp_rtol
1e-10."""
import numpy as np
import pytest
import torch

import firedrake_tpu as J
import firedrake_tpu_torch as T
from firedrake_tpu_torch.interop import load_reference_state

PARAMS = {"ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": 1e-10}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    T.set_device("cpu")
    yield
    torch.set_num_threads(n)


def _readme(fd, f_dat=None):
    mesh = fd.UnitSquareMesh(16, 16)
    V = fd.FunctionSpace(mesh, "CG", 1)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    x, y = fd.SpatialCoordinate(mesh)
    f = fd.Function(V)
    if f_dat is None:
        f.interpolate((1 + 8 * fd.pi ** 2) * fd.cos(2 * fd.pi * x)
                      * fd.cos(2 * fd.pi * y))
    a = (fd.inner(fd.grad(u), fd.grad(v)) + fd.inner(u, v)) * fd.dx
    L = fd.inner(f, v) * fd.dx
    return mesh, V, f, a, L, None


def _poisson(fd, f_dat=None):
    mesh = fd.UnitSquareMesh(8, 8)
    V = fd.FunctionSpace(mesh, "CG", 2)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    x, y = fd.SpatialCoordinate(mesh)
    f = fd.Function(V)
    if f_dat is None:
        f.interpolate(2 * fd.pi ** 2 * fd.sin(fd.pi * x)
                      * fd.sin(fd.pi * y))
    a = fd.inner(fd.grad(u), fd.grad(v)) * fd.dx
    L = fd.inner(f, v) * fd.dx
    return mesh, V, f, a, L, fd.DirichletBC(V, 0, "on_boundary")


@pytest.mark.parametrize("problem", [_readme, _poisson])
def test_solve_matches_jax(problem):
    mj, Vj, fj, aj, Lj, bcj = problem(J)
    uj = J.Function(Vj)
    sj = J.LinearVariationalSolver(
        J.LinearVariationalProblem(aj, Lj, uj, bcs=bcj),
        solver_parameters=PARAMS)
    sj.solve()

    mt, Vt, ft, at, Lt, bct = problem(T, f_dat=True)
    load_reference_state({mt: np.asarray(mj.coordinates.dat),
                          ft: np.asarray(fj.dat)},
                         cell_node_maps={Vt: Vj.cell_node_map})
    ut = T.Function(Vt)
    T.solve(at == Lt, ut, bcs=bct, solver_parameters=PARAMS)
    st = T.LinearVariationalSolver(
        T.LinearVariationalProblem(at, Lt, T.Function(Vt), bcs=bct),
        solver_parameters=PARAMS)
    st.solve()

    assert st.converged and bool(sj.converged)
    assert abs(st.ksp_iterations - int(sj.ksp_iterations)) <= 1
    ref = np.asarray(uj.dat)
    ours = ut.dat.numpy()
    assert np.linalg.norm(ours - ref) <= 1e-8 * np.linalg.norm(ref)
    assert torch.equal(ut.dat, st.problem.u.dat)


def test_interop_checks_shapes_and_numbering():
    mesh = T.UnitSquareMesh(3, 3)
    V = T.FunctionSpace(mesh, "CG", 2)
    f, c = T.Function(V), T.Constant(1.0)
    with pytest.raises(ValueError, match="dof vector"):
        load_reference_state({f: np.zeros(V.dim + 1)})
    with pytest.raises(ValueError, match="Constant"):
        load_reference_state({c: np.zeros(2)})
    bad = np.array(V.cell_node_map)
    bad[0, [0, 1]] = bad[0, [1, 0]]
    with pytest.raises(ValueError, match="numbering"):
        load_reference_state({}, cell_node_maps={V: bad})
    load_reference_state({f: np.arange(V.dim, dtype=float), c: 2.5})
    assert f.dat.dtype == torch.float64 and float(f.dat[3]) == 3.0
    assert float(c.values()) == 2.5


def test_unported_solver_options_raise():
    mesh = T.UnitSquareMesh(2, 2)
    V = T.FunctionSpace(mesh, "CG", 1)
    u, v = T.TrialFunction(V), T.TestFunction(V)
    a, L = u * v * T.dx, v * T.dx
    with pytest.raises(NotImplementedError, match="item 20"):
        T.solve(a == L, T.Function(V), solver_parameters={
            "ksp_type": "cg", "pc_type": "hybridization", "distributed": 2})
    # GTMGPC is ported: it resolves, and asks for its appctx callbacks, as
    # in the JAX package (held in tests/test_torch_interpolation.py)
    with pytest.raises(ValueError, match="get_coarse_space"):
        T.solve(a == L, T.Function(V), solver_parameters={
            "ksp_type": "cg", "pc_type": "python",
            "pc_python_type": "firedrake.GTMGPC"})
    # CovariancePC is ported: it resolves, and asks for a covariance
    # operator (held in tests/test_torch_adjoint.py)
    with pytest.raises(TypeError, match="CovarianceMat"):
        T.solve(a == L, T.Function(V), solver_parameters={
            "ksp_type": "cg", "pc_type": "python",
            "pc_python_type": "firedrake.CovariancePC"})
    # fieldsplit is ported: a plain space is refused as in the JAX package
    with pytest.raises(ValueError, match="mixed space"):
        T.solve(a == L, T.Function(V), solver_parameters={
            "ksp_type": "cg", "pc_type": "fieldsplit"})


def test_make_pc_jacobi_matches_build_pc(monkeypatch):
    from firedrake_tpu_torch.solvers import composition
    from firedrake_tpu_torch.solvers.preconditioners import make_pc
    from firedrake_tpu_torch.solvers.composition import OpCtx, build_pc
    # the substitution warns once per (type, prefix) and process: another
    # module run before this one in the same worker may have warned
    monkeypatch.setattr(composition, "_warned_substitutions", set())
    mesh = T.UnitSquareMesh(3, 3)
    V = T.FunctionSpace(mesh, "CG", 1)
    u, v = T.TrialFunction(V), T.TestFunction(V)
    A = T.assemble((T.inner(T.grad(u), T.grad(v)) + u * v) * T.dx)
    r = torch.as_tensor(np.random.default_rng(3).standard_normal(V.dim))
    z1 = make_pc("jacobi", A)(r)
    z2 = build_pc(OpCtx(mat=A), {"pc_type": "jacobi"})(r)
    torch.testing.assert_close(z1, z2, rtol=1e-15, atol=0)
    assert torch.equal(make_pc("none")(r), r)
    with pytest.warns(UserWarning, match="ubstituting point-Jacobi"):
        z3 = make_pc("ilu", A)(r)
    assert torch.equal(z3, z1)
    with pytest.raises(NotImplementedError):
        make_pc("bddc", A)
