"""Matrix-free operators (assembly/matfree.py), K1's action terms and
matrix-free multigrid in the port against the JAX package.

The same numpy inputs from a seed go through both packages.  Tolerances:
float64 1e-12 relative to the largest entry; float32 kernels (FDTPU_PREC
=f32) 2e-6, the bound of tests/unit/test_pallas_eval.py:44; solutions
1e-10 relative, and iteration counts equal.  The miniature of the 16M-dof
solve is MeshHierarchy(UnitCubeMesh(2), 2), P2 (4,913 dofs), with
mg_matfree_threshold 200: levels 1 and 2 (729 and 4,913 dofs) are
matrix-free, level 0 (125 dofs) is assembled for the LU coarse solve."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import firedrake_tpu as J
import firedrake_tpu_torch as T
from firedrake_tpu.assemble import _assembler_cache as j_cache
from firedrake_tpu.assembly.matfree import MatrixFreeOperator as JMF
from firedrake_tpu_torch.assemble import _assembler_cache as t_cache
from firedrake_tpu_torch.assemble import FormAssembler as TFA
from firedrake_tpu_torch.assembly.matfree import (MatrixFreeOperator,
                                                   DirichletMatrixFree)
from firedrake_tpu_torch.compiler import cell_eval as K


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    T.set_device("cpu")
    yield
    torch.set_num_threads(n)


def _close(ours, ref, rtol):
    ours = ours.numpy() if torch.is_tensor(ours) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max()
    assert err <= rtol * np.abs(ref).max(), err


MESHES = {
    "p1_square": (lambda fd: fd.UnitSquareMesh(4, 3), 1),
    "p2_square": (lambda fd: fd.UnitSquareMesh(3, 4), 2),
    "p2_cube": (lambda fd: fd.MeshHierarchy(fd.UnitCubeMesh(2, 2, 2),
                                            1).meshes[-1], 2),
}


def _operator(fd, name, constant=True):
    make, degree = MESHES[name]
    V = fd.FunctionSpace(make(fd), "CG", degree)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    k = fd.Constant(1.75) if constant else 1.0
    return V, (k * fd.inner(fd.grad(u), fd.grad(v)) + u * v) * fd.dx


@pytest.mark.parametrize("name", sorted(MESHES))
def test_matvec_and_diagonal_match_jax(name):
    Vj, aj = _operator(J, name)
    Vt, at = _operator(T, name)
    x = np.random.default_rng(3).standard_normal(Vj.dim)
    Aj, At = JMF(aj), MatrixFreeOperator(at)
    assert At.shape == Aj.shape and At.dtype == torch.float64
    _close(At.matvec(torch.as_tensor(x)), Aj.matvec(jnp.asarray(x)), 1e-12)
    _close(At.diagonal(), Aj.diagonal(), 1e-12)
    # the assembled operator of the port: the same action and diagonal
    A = T.assemble(at)
    _close(At @ torch.as_tensor(x), A.matvec(torch.as_tensor(x)), 1e-12)
    assert torch.equal(At.diagonal(), A.diagonal())


def test_f32_matvec_matches_jax(monkeypatch):
    monkeypatch.setenv("FDTPU_PREC", "f32")
    j_cache.clear()
    t_cache.clear()
    try:
        Vj, aj = _operator(J, "p2_cube")
        Vt, at = _operator(T, "p2_cube")
        x = np.random.default_rng(4).standard_normal(Vj.dim)
        Aj, At = JMF(aj), MatrixFreeOperator(at)
        y = At.matvec(torch.as_tensor(x))
        assert y.dtype == torch.float64              # f64 accumulation
        _close(y, Aj.matvec(jnp.asarray(x)), 2e-6)
        _close(At.diagonal(), Aj.diagonal(), 2e-6)
    finally:
        j_cache.clear()
        t_cache.clear()


def test_dirichlet_matfree_matches_jax():
    Vj, aj = _operator(J, "p2_square")
    Vt, at = _operator(T, "p2_square")
    rows = np.asarray(J.DirichletBC(Vj, 0.0, 1).dof_indices)
    more = np.asarray(J.DirichletBC(Vj, 0.0, 3).dof_indices)
    assert np.array_equal(rows, T.DirichletBC(Vt, 0.0, 1).dof_indices)
    x = np.random.default_rng(5).standard_normal(Vj.dim)
    Dj = JMF(aj).with_dirichlet(jnp.asarray(rows))
    Dt = MatrixFreeOperator(at).with_dirichlet(rows)
    assert isinstance(Dt, DirichletMatrixFree)
    _close(Dt.matvec(torch.as_tensor(x)), Dj.matvec(jnp.asarray(x)), 1e-12)
    _close(Dt.diagonal(), Dj.diagonal(), 1e-12)
    D2j, D2t = Dj.with_dirichlet(jnp.asarray(more)), Dt.with_dirichlet(more)
    _close(D2t.matvec(torch.as_tensor(x)), D2j.matvec(jnp.asarray(x)),
           1e-12)
    # P A P + (I - P): the assembled operator with the same rows
    A = T.assemble(at, bcs=T.DirichletBC(Vt, 0.0, 1))
    _close(Dt.matvec(torch.as_tensor(x)), A.matvec(torch.as_tensor(x)),
           1e-12)


def _action_form(fd, cell, degree, constant, seed):
    mesh = (fd.UnitSquareMesh(3, 2) if cell == "tri"
            else fd.UnitCubeMesh(2, 1, 2))
    V = fd.FunctionSpace(mesh, "CG", degree)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    z = fd.Function(V)
    z.dat = np.random.default_rng(seed).standard_normal(V.dim)
    if constant:
        a = (fd.Constant(2.5) * fd.inner(fd.grad(u), fd.grad(v))
             - 0.5 * fd.Constant(3.0) * u * v) * fd.dx
    else:
        a = (fd.inner(fd.grad(u), fd.grad(v)) + u * v) * fd.dx
    return fd.action(a, z)


ACTIONS = [(c, d, k) for c in ("tri", "tet") for d in (1, 2)
           for k in (False, True)]


@pytest.mark.parametrize("cell,degree,constant", ACTIONS)
def test_action_terms_match_jax(cell, degree, constant):
    from firedrake_tpu.compiler.kernels import CompiledIntegral as CJ
    fj = _action_form(J, cell, degree, constant, degree)
    ft = _action_form(T, cell, degree, constant, degree)
    ta = TFA(ft)
    tc, tco, tcv = ta._inputs()
    (it,), (ci,) = fj.integrals(), ta._compiled
    kb = jax.jit(CJ(it, fj.arguments()[0], None, fj.mesh())
                 .cell_kernel_batched())
    spec = K.family_spec(ci)
    assert spec is not None and spec.mode == K.ACT
    cv = tuple(tcv[c.count] for c in ci.constants)
    for t in range(ta._stencil.ntypes):
        ce, ws = ta._stencil.gather_cell_inputs(t, tc, tco, ci)
        ref = np.asarray(kb(jnp.asarray(ce.numpy()),
                            tuple(jnp.asarray(w.numpy()) for w in ws),
                            tuple(jnp.asarray(c.numpy()) for c in cv)))
        _close(K.cell_eval(spec, ce, ws, cv), ref, 1e-12)
        f32 = K.cell_eval_plain(spec, ce.float(),
                                tuple(w.float() for w in ws),
                                tuple(c.float() for c in cv))
        assert f32.dtype == torch.float32
        _close(f32.double(), ref, 2e-6)


def test_family_accepts_action_terms():
    mesh = T.UnitCubeMesh(1, 1, 1)
    V = T.FunctionSpace(mesh, "CG", 2)
    u, v = T.TrialFunction(V), T.TestFunction(V)
    z, w = T.Function(V), T.Function(V)
    k = T.Constant(2.0)
    gg = T.inner(T.grad(u), T.grad(v))
    forms = {
        # action(a, z) of the north star's operator
        "stiffness": (gg * T.dx, K.ACT, [(K.ACTION, 1.0, 0, 0)]),
        "helmholtz": ((gg + u * v) * T.dx, K.ACT,
                      [(K.ACTION, 1.0, 0, 0), (K.LOAD, 1.0, 0, 1)]),
        "constant": (-3.0 * k * gg * T.dx, K.ACT, [(K.ACTION, -3.0, 1, 0)]),
        # a coefficient besides z: the quadrature variant
        "weighted": (w * gg * T.dx, K.QUAD, [(K.ACTION, 1.0, 0, 1)]),
    }
    for name, (a, mode, want) in forms.items():
        (ci,) = TFA(T.action(a, z))._compiled
        spec = K.family_spec(ci)
        assert spec is not None, name
        assert spec.mode == mode, name
        assert spec.zidx == [c.count for c in ci.coefficients].index(
            z.count), name
        assert [(kind, lit, len(kidx), len(cidx))
                for kind, lit, kidx, cidx in spec.terms] == want, name
    # the operand on another element, or a second operand: not in the family
    V1 = T.FunctionSpace(mesh, "CG", 1)
    z1 = T.Function(V1)
    for f in (T.inner(T.grad(z1), T.grad(v)) * T.dx,
              (T.inner(T.grad(z), T.grad(v))
               + T.inner(T.grad(w), T.grad(v))) * T.dx):
        (ci,) = TFA(f)._compiled
        assert K.family_spec(ci) is None


def test_interpolation_in_cell_chunks(monkeypatch):
    """The 16M set-up interpolates over cell chunks (the point-wise
    lowering's intermediates would take 42 GB at once): chunks that do not
    divide the cells give the unchunked values, and the JAX package's."""
    from firedrake_tpu_torch import interpolation as TI

    def run(fd):
        mesh = fd.UnitCubeMesh(3, 2, 2)
        V = fd.FunctionSpace(mesh, "CG", 2)
        x, y, z = fd.SpatialCoordinate(mesh)
        return fd.Function(V).interpolate(fd.sin(fd.pi * x) * fd.cos(y)
                                          + x * y * z).dat
    whole = run(T)
    TI._interp_cache.clear()
    monkeypatch.setattr(TI, "CELL_CHUNK", 7)
    chunked = run(T)
    torch.testing.assert_close(chunked, whole, rtol=1e-14, atol=0)
    _close(chunked, np.asarray(run(J)), 1e-12)


def _north_star(fd, nbase, levels, degree):
    """The 16M-dof configuration's problem (chip_smoke gmg_p2_tet_16m) on
    a small hierarchy: -lap u = 3 pi^2 sin sin sin, u = 0 on the
    boundary, f interpolated into V."""
    hier = fd.MeshHierarchy(fd.UnitCubeMesh(nbase, nbase, nbase), levels)
    mesh = hier.meshes[-1]
    V = fd.FunctionSpace(mesh, "CG", degree)
    x, y, z = fd.SpatialCoordinate(mesh)
    f = fd.Function(V).interpolate(3 * fd.pi ** 2 * fd.sin(fd.pi * x)
                                   * fd.sin(fd.pi * y) * fd.sin(fd.pi * z))
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    a = fd.inner(fd.grad(u), fd.grad(v)) * fd.dx
    return V, a, fd.inner(f, v) * fd.dx, fd.DirichletBC(V, 0, "on_boundary")


def _solve(fd, problem, params):
    V, a, L, bc = problem
    uh = fd.Function(V)
    s = fd.LinearVariationalSolver(
        fd.LinearVariationalProblem(a, L, uh, bcs=bc),
        solver_parameters={"ksp_type": "cg", "ksp_rtol": 1e-10,
                           "pc_type": "mg", **params})
    s.solve()
    return s, uh


def test_north_star_miniature_matches_jax(monkeypatch):
    params = {"mg_matfree_threshold": 200}
    pj = _north_star(J, 2, 2, 2)
    pt = _north_star(T, 2, 2, 2)
    assert pt[0].dim == 4913
    # the JAX solve as one jitted program (its path at 16M dofs): fewer
    # compilations than op by op
    monkeypatch.setenv("FDTPU_HOIST_MIN", "1000")
    sj, uj = _solve(J, pj, params)
    K.lowerer_evals = 0
    st, ut = _solve(T, pt, params)
    assert K.lowerer_evals == 0              # every form through K1
    levels = st._gmg.levels
    assert [type(lv["A"]).__name__ for lv in levels] == [
        "StencilMatrix", "DirichletMatrixFree", "DirichletMatrixFree"]
    assert st.converged and bool(sj.converged)
    assert st.ksp_iterations == int(sj.ksp_iterations)
    _close(ut.dat, np.asarray(uj.dat), 1e-10)


def test_matfree_gmg_matches_assembled():
    problem = _north_star(T, 2, 2, 1)
    s1, u1 = _solve(T, problem, {})
    s2, u2 = _solve(T, problem, {"mg_matfree_threshold": 100})
    assert [type(lv["A"]).__name__ for lv in s2._gmg.levels][1:] == [
        "DirichletMatrixFree", "DirichletMatrixFree"]
    assert s1.converged and s2.converged
    _close(u2.dat, u1.dat, 1e-10)
    # mg_fine_mat_type matfree: only the finest level
    s3, u3 = _solve(T, problem, {"mg_fine_mat_type": "matfree"})
    assert [type(lv["A"]).__name__ for lv in s3._gmg.levels] == [
        "StencilMatrix", "StencilMatrix", "DirichletMatrixFree"]
    _close(u3.dat, u1.dat, 1e-10)


def test_mat_type_matfree_solve_matches_jax():
    def run(fd, params):
        V, a, L, bc = _north_star(fd, 2, 1, 2)
        uh = fd.Function(V)
        s = fd.LinearVariationalSolver(
            fd.LinearVariationalProblem(a, L, uh, bcs=bc),
            solver_parameters={"ksp_type": "cg", "ksp_rtol": 1e-10,
                               "pc_type": "jacobi", **params})
        s.solve()
        return s, uh
    sj, uj = run(J, {"mat_type": "matfree"})
    st, ut = run(T, {"mat_type": "matfree"})
    sa, ua = run(T, {})
    assert st.ksp_iterations == int(sj.ksp_iterations) == sa.ksp_iterations
    _close(ut.dat, np.asarray(uj.dat), 1e-10)
    _close(ut.dat, ua.dat, 1e-10)
    with pytest.raises(ValueError, match="needs an assembled operator"):
        run(T, {"mat_type": "matfree", "ksp_type": "preonly",
                "pc_type": "lu"})
