"""Geometric multigrid in the port against the JAX package: hierarchies
(bit for bit), grid transfers, the stationary smoothers, the vertex-star
patch smoother and whole CG + GMG solves on UnitSquareMesh(4) + 2 levels
and, with patch levels over gather-route operators, on
MeshHierarchy(UnitDiskMesh(1), 2).

Device results are held to 1e-14 (transfers: the same slices and sums),
1e-12 (smoothers and patch solves, relative to the largest entry) and
1e-10 (solutions, relative); iteration counts must be equal."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
import jax

import firedrake_tpu as J
import firedrake_tpu_torch as T
from firedrake_tpu.mg.transfer import LevelTransfer as JLevelTransfer
from firedrake_tpu.ops import batched_inverse as JBI
from firedrake_tpu.solvers import krylov as JK
from firedrake_tpu.solvers import preconditioners as JP
from firedrake_tpu_torch.assembly.stencil import StencilMatrix
from firedrake_tpu_torch.mg.transfer import LevelTransfer
from firedrake_tpu_torch.ops import batched_inverse as BI
from firedrake_tpu_torch.solvers import krylov as TK
from firedrake_tpu_torch.solvers import preconditioners as TP


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


def _close(ours, ref, rtol):
    ours = ours.numpy() if torch.is_tensor(ours) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max()
    assert err <= rtol * np.abs(ref).max(), err


def _square(fd):
    return fd.MeshHierarchy(fd.UnitSquareMesh(4, 4), 2)


@pytest.mark.parametrize("kind", ["square", "cube"])
def test_hierarchy_bit_equal(kind):
    def build(fd):
        if kind == "square":
            return _square(fd)
        return fd.MeshHierarchy(fd.UnitCubeMesh(2, 2, 2), 1)
    hj, ht = build(J), build(T)
    assert len(hj) == len(ht)
    for mj, mt in zip(hj, ht):
        assert np.array_equal(np.asarray(mj.coordinates.dat),
                              np.asarray(mt.coordinates.dat))
        assert np.array_equal(mj.topology.cell_vertices,
                              mt.topology.cell_vertices)
        assert np.array_equal(mj.facet_markers, mt.facet_markers)
        if mj is not hj[0]:
            assert np.array_equal(mj._c2f_cells, mt._c2f_cells)


def _level_spaces(fd, deg):
    h = _square(fd)
    return [fd.FunctionSpace(m, "CG", deg) for m in h]


@pytest.mark.parametrize("route", ["structured", "cellwise"])
@pytest.mark.parametrize("deg", [1, 2])
def test_transfers_match(deg, route):
    Vj, Vt = _level_spaces(J, deg), _level_spaces(T, deg)
    rng = np.random.default_rng(deg)
    for i in range(len(Vj) - 1):
        if route == "structured":
            tj = J.mg.transfer.get_transfer(Vj[i], Vj[i + 1])
            tt = T.mg.transfer.get_transfer(Vt[i], Vt[i + 1])
            assert type(tt).__name__ == type(tj).__name__ \
                == "StructuredTransfer"
        else:
            tj = JLevelTransfer(Vj[i], Vj[i + 1])
            tt = LevelTransfer(Vt[i], Vt[i + 1])
        xc = rng.standard_normal(Vt[i].dim)
        xf = rng.standard_normal(Vt[i + 1].dim)
        _close(tt.prolong_fn(torch.as_tensor(xc)), tj.prolong_fn(xc),
               1e-14)
        _close(tt.restrict_fn(torch.as_tensor(xf)), tj.restrict_fn(xf),
               1e-14)
        _close(tt.inject_fn(torch.as_tensor(xf)), tj.inject_fn(xf), 1e-14)


def test_public_transfers():
    Vt = _level_spaces(T, 1)
    fc, ff = T.Function(Vt[0]), T.Function(Vt[1])
    x, y = T.SpatialCoordinate(Vt[0].mesh())
    fc.interpolate(1 + 2 * x - y)
    T.prolong(fc, ff)
    x, y = T.SpatialCoordinate(Vt[1].mesh())
    exact = T.Function(Vt[1]).interpolate(1 + 2 * x - y)
    _close(ff.dat, exact.dat.numpy(), 1e-14)
    back = T.Function(Vt[0])
    T.inject(ff, back)
    _close(back.dat, fc.dat.numpy(), 1e-14)
    T.restrict(ff, back)
    assert back.dat.shape == (Vt[0].dim,)


def _poisson(fd, V, bc=True):
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    bcs = [fd.DirichletBC(V, 0.0, "on_boundary")] if bc else []
    return fd.inner(fd.grad(u), fd.grad(v)) * fd.dx, bcs


def _shared_matrices(deg):
    """The JAX operator and a port StencilMatrix holding the same channel
    values, so that solver components can be compared on one matrix."""
    Vj, Vt = _level_spaces(J, deg)[-1], _level_spaces(T, deg)[-1]
    aj, bcj = _poisson(J, Vj)
    at, bct = _poisson(T, Vt)
    Aj = J.assemble(aj, bcs=bcj)
    At = T.assemble(at, bcs=bct)
    assert At.offsets == list(Aj.offsets)
    At = StencilMatrix(At.plan, torch.tensor(np.asarray(Aj.channels)),
                       At.row_space, At.col_space, At.bcs)
    return Vj, Vt, Aj, At


@pytest.mark.parametrize("rtol", [0.0, 1e-3])
def test_stationary_methods_match(rtol):
    Vj, Vt, Aj, At = _shared_matrices(1)
    b = np.random.default_rng(5).standard_normal(Vt.dim)
    dinv_j = 1.0 / np.asarray(Aj.diagonal())
    dinv_t = 1.0 / At.diagonal()
    for name, kw in (("chebyshev", dict(emin=0.3, emax=2.1)),
                     ("richardson", dict(damping=0.8))):
        rj = getattr(JK, name)(Aj.matvec, b, pc=lambda r: dinv_j * r,
                               rtol=rtol, max_it=7, **kw)
        rt = getattr(TK, name)(At.matvec, torch.as_tensor(b),
                               pc=lambda r: dinv_t * r, rtol=rtol,
                               max_it=7, **kw)
        assert rt.iterations == int(rj.iterations)
        _close(rt.x, rj.x, 1e-12)
        if rtol:
            assert rt.converged == bool(rj.converged)
            assert abs(rt.residual_norm - float(rj.residual_norm)) \
                <= 1e-12 * float(rj.residual_norm)


@pytest.mark.parametrize("deg", [1, 2])
def test_star_patch_matches(deg, monkeypatch):
    Vj, Vt, Aj, At = _shared_matrices(deg)
    seen = {}
    real_inv = JBI.batched_inv

    def spy_inv(A, **kw):
        seen["Ap"] = np.asarray(A)
        return real_inv(A, **kw)
    monkeypatch.setattr(JBI, "batched_inv", spy_inv)
    pcj = JP.make_star_patch(Aj, Vj)
    cells = dict(zip(pcj.__code__.co_freevars,
                     (c.cell_contents for c in pcj.__closure__)))
    idx, mask = TP.star_patches(Vt)
    assert np.array_equal(idx, np.asarray(cells["idx_j"]))
    assert np.array_equal(mask, np.asarray(cells["mask_j"]))
    assert np.array_equal(TP.patch_matrices(At, idx, mask).numpy(),
                          seen["Ap"])

    n0 = BI.kernel_launches
    pct = TP.make_star_patch(At, Vt)
    assert BI.kernel_launches == n0        # CPU tensors: the plain version
    r = np.random.default_rng(7).standard_normal(Vt.dim)
    _close(pct(torch.as_tensor(r)), pcj(r), 1e-12)


# (degree, options, allowed difference in iterations).  Richardson(0.8)
# with the additive star patch (tests/regression/test_solver_composition.py
# :211) is not a convergent smoother: every dof lies in up to 7 patches, so
# 0.8 * sum of patch inverses overshoots, and CG needs ~94 iterations whose
# count rounding moves: the JAX package itself counts 94, 95, 95 and 96 when
# f is perturbed by 0, 1e-15, 1e-14 and 1e-13 relative.  The two smoothers
# that converge must agree exactly.
TREES = {
    "p1_cheb_jacobi": (1, {}, 0),
    "p2_cheb_patch": (2, {"mg_levels_pc_type": "patch"}, 0),
    "p1_rich_patch": (1, {"mg_levels_ksp_type": "richardson",
                          "mg_levels_ksp_max_it": 1,
                          "mg_levels_ksp_richardson_scale": 0.8,
                          "mg_levels_pc_type": "patch"}, 3),
}


def _gmg_solve(fd, deg, opts):
    mesh = _square(fd).meshes[-1]
    V = fd.FunctionSpace(mesh, "CG", deg)
    a, bcs = _poisson(fd, V)
    x, y = fd.SpatialCoordinate(mesh)
    f = fd.Function(V).interpolate(2 * fd.pi ** 2 * fd.sin(fd.pi * x)
                                   * fd.sin(fd.pi * y))
    uh = fd.Function(V)
    solver = fd.LinearVariationalSolver(
        fd.LinearVariationalProblem(a, fd.inner(f, fd.TestFunction(V))
                                    * fd.dx, uh, bcs=bcs),
        solver_parameters={"ksp_type": "cg", "ksp_rtol": 1e-10,
                           "pc_type": "mg", **opts})
    solver.solve()
    return solver, np.asarray(uh.dat)


@pytest.mark.parametrize("tree", sorted(TREES))
def test_gmg_solve_matches(tree):
    deg, opts, slack = TREES[tree]
    sj, uj = _gmg_solve(J, deg, opts)
    st, ut = _gmg_solve(T, deg, opts)
    assert st.converged and bool(sj.converged)
    assert abs(st.ksp_iterations - int(sj.ksp_iterations)) <= slack
    _close(ut, uj, 1e-10)


def _disk_patch_solve(fd):
    """CG + GMG with Chebyshev/vertex-star patch levels, P2 on the
    unstructured MeshHierarchy(UnitDiskMesh(1), 2): the level operators
    are gather-route Matrix objects, whose entries the patch PC reads."""
    mesh = fd.MeshHierarchy(fd.UnitDiskMesh(1), 2).meshes[-1]
    V = fd.FunctionSpace(mesh, "CG", 2)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    x, y = fd.SpatialCoordinate(mesh)
    uh = fd.Function(V)
    solver = fd.LinearVariationalSolver(
        fd.LinearVariationalProblem(
            fd.inner(fd.grad(u), fd.grad(v)) * fd.dx,
            fd.inner(1 + x * y, v) * fd.dx, uh,
            bcs=fd.DirichletBC(V, 0, "on_boundary")),
        solver_parameters={"ksp_type": "cg", "ksp_rtol": 1e-10,
                           "pc_type": "mg",
                           "mg_levels_ksp_type": "chebyshev",
                           "mg_levels_pc_type": "patch"})
    solver.solve()
    return solver, np.asarray(uh.dat)


def test_gmg_patch_on_unstructured_hierarchy():
    sj, uj = _disk_patch_solve(J)
    st, ut = _disk_patch_solve(T)
    assert int(sj.ksp_iterations) == 6
    assert st.converged and st.ksp_iterations == 6
    _close(ut, uj, 1e-12)


def test_unported_hierarchies_and_levels_raise():
    # quad and extruded hierarchies are ported
    # (tests/test_torch_tensor_product.py, tests/test_torch_extrusion.py);
    # non-nested ones still raise naming their item
    assert len(T.MeshHierarchy(T.UnitSquareMesh(2, 2, quadrilateral=True),
                               1)) == 2
    assert [m._layers for m in T.mg.mesh.ExtrudedMeshHierarchy(
        _square(T), layers=2)] == [2] * len(_square(T))
    with pytest.raises(NotImplementedError, match="item 18"):
        T.NonNestedHierarchy(T.UnitSquareMesh(2, 2), T.UnitSquareMesh(3, 3))
    mesh = _square(T).meshes[-1]
    V = T.FunctionSpace(mesh, "CG", 1)
    a, bcs = _poisson(T, V)
    # matrix-free levels are ported; an LU coarse solve cannot factor one
    with pytest.raises(ValueError, match="needs an assembled operator"):
        T.solve(a == T.TestFunction(V) * T.dx, T.Function(V), bcs=bcs,
                solver_parameters={"ksp_type": "cg", "pc_type": "mg",
                                   "mg_matfree_threshold": 1})
