"""Mixed spaces and H(div)/H(curl) elements in the port against the JAX
package: element tabulations and dof sign/transform tables bit for bit,
MixedFunctionSpace, MixedFunction and split, block assembly
(MixedFormAssembler) into a BlockMatrix, Piola-mapped cell and facet
integrals, DirichletBC on W.sub(i), MixedVectorSpaceBasis, interpolation
into RT/BDM/N1curl, solves on a BlockMatrix (host LU; GMRES and CG on
the device) and demos/poisson_mixed.py at n = 8; the cases of
tests/regression/test_mixed.py and test_hdiv.py at small meshes.

Tolerances: float64 results within 1e-12 max|ref| (the port evaluates
cell integrals cell-last, the JAX package per cell); host tables bit for
bit; iteration counts equal."""
import math
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
import jax

import firedrake_tpu as J
import firedrake_tpu_torch as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LU = {"ksp_type": "preonly", "pc_type": "lu"}


#: the JAX package's reference programs are compiled with XLA's
#: optimisations off, which cuts the time of these tests by ~18% on 6 CPU
#: workers (most of it is compiling); the results agree within the same
#: tolerances.  The module's executables are dropped with it, so that no
#: later module runs them.
NO_OPT = "jax_disable_most_optimizations"


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    # two torch threads: six test workers share the host's cores, and
    # more threads per worker slow the many small torch operations down
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
    if torch.is_tensor(x):
        return x.numpy()
    if hasattr(x, "to_scipy"):
        return x.to_scipy().toarray()
    return np.asarray(x)


def _close(ours, ref, rtol=1e-12):
    ours, ref = _np(ours), _np(ref)
    assert np.shape(ours) == np.shape(ref)
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(ours - ref).max() <= rtol * scale, \
        np.abs(ours - ref).max() / scale


def run_demo(name, fd, subs=()):
    """Execute demos/<name>.py with ``fd``'s import line (the port's
    adds set_device("cpu")) and the given text substitutions."""
    path = os.path.join(ROOT, "demos", name + ".py")
    src = open(path).read()
    for a, b in subs:
        assert a in src, a
        src = src.replace(a, b)
    if fd is T:
        src = src.replace("from firedrake_tpu import *",
                          "from firedrake_tpu_torch import *\n"
                          "set_device('cpu')")
    ns = {"__name__": "demo"}
    exec(compile(src, path, "exec"), ns)
    return ns


def _taylor_hood(fd):
    mesh = fd.UnitSquareMesh(4, 4)
    return fd.MixedFunctionSpace([fd.VectorFunctionSpace(mesh, "CG", 2),
                                  fd.FunctionSpace(mesh, "CG", 1)])


def _rt_dg(fd, n=4, family="RT", quad=False):
    mesh = fd.UnitSquareMesh(n, n, quadrilateral=quad)
    return mesh, fd.FunctionSpace(mesh, family, 1) * fd.FunctionSpace(
        mesh, "DG", 0)


# ------------------------------------------------------- element tables
@pytest.mark.parametrize("family, degree, cell", [
    ("RT", 1, "tri"), ("BDM", 1, "tri"), ("N1curl", 1, "tri"),
    ("RT", 1, "tet"), ("N1curl", 1, "tet"), ("RT", 2, "tet"),
    ("BDFM", 2, "tri"), ("RTCF", 1, "quad")])
def test_element_tables_bit_for_bit(family, degree, cell):
    """Tabulations, dof counts, sign tables and entity transforms."""
    out = []
    for fd in (J, T):
        mesh = {"tri": lambda: fd.UnitSquareMesh(3, 3),
                "tet": lambda: fd.UnitCubeMesh(2, 2, 2),
                "quad": lambda: fd.UnitSquareMesh(2, 2, quadrilateral=True),
                }[cell]()
        V = fd.FunctionSpace(mesh, family, degree)
        pts = np.random.default_rng(0).uniform(
            0, 0.3, (5, mesh.topological_dimension))
        s = V.sdata
        out.append((V.dim, V.element.mapping, V.has_dof_signs,
                    s.has_dof_transforms,
                    np.asarray(V.cell_dof_map),
                    np.asarray(s.cell_dof_signs) if V.has_dof_signs
                    else None,
                    np.asarray(s.cell_dof_transforms)
                    if s.has_dof_transforms else None,
                    V.element.tabulate(pts, 1)))
    (a, b) = out
    assert a[:4] == b[:4]
    for x, y in zip(a[4:7], b[4:7]):
        assert (x is None and y is None) or np.array_equal(x, y)
    assert all(np.array_equal(x, y) for x, y in zip(a[7], b[7]))


# ------------------------------------------------- spaces and functions
def test_mixed_space_structure_and_split():
    W = _taylor_hood(T)
    V, Q = W.subspaces
    assert W.dim == V.dim + Q.dim == _taylor_hood(J).dim
    assert W.num_sub_spaces == 2 and W.sub(0).dim == V.dim
    assert W.sub(1).offset == V.dim
    assert (V * Q).dim == W.dim and ((V * Q) * V).num_sub_spaces == 3
    w = T.Function(W)
    assert isinstance(w, T.MixedFunction)
    assert isinstance(T.Cofunction(W), T.MixedFunction)
    u, p = w.subfunctions
    assert w.split() == (u, p) and w.sub(1) is p
    assert T.split(w) == (u, p)
    v, q = T.TestFunctions(W)
    assert (v.part, q.part, v.number) == (0, 1, 0)
    assert [a.part for a in T.split(T.TrialFunction(W))] == [0, 1]
    X = T.SpatialCoordinate(W.mesh())
    u.interpolate(T.as_vector([1.0 + 0 * X[0], 2.0 + 0 * X[1]]))
    p.assign(3.0)
    d = w.dat.numpy()
    assert (d[:V.dim:2] == 1.0).all() and (d[1:V.dim:2] == 2.0).all()
    assert (d[V.dim:] == 3.0).all()
    w.dat = np.arange(W.dim, dtype=float)
    assert p.dat[0] == V.dim
    # a plain Function is its own only component
    f = T.Function(V)
    assert f.split() == (f,) and f.subfunctions == (f,) and f.sub(0) is f


def test_mixed_block_assembly_matches_jax():
    """MixedFormAssembler: absent off-diagonal blocks, every block and
    the monolithic operator at 1e-12, the device matvec against the host
    CSR, and the right-hand side's concatenated vector."""
    out = {}
    for fd in (J, T):
        W = _taylor_hood(fd)
        u, p = fd.TrialFunctions(W)
        v, q = fd.TestFunctions(W)
        X = fd.SpatialCoordinate(W.mesh())
        A = fd.assemble((fd.inner(fd.grad(u), fd.grad(v)) + p * q
                         - p * fd.div(v)) * fd.dx)
        b = fd.assemble((fd.inner(fd.as_vector([X[1], X[0]]), v)
                         + fd.sin(X[0]) * q) * fd.dx)
        out[fd] = A, b
    (Aj, bj), (At, bt) = out[J], out[T]
    assert sorted(At.blocks) == sorted(Aj.blocks) == [(0, 0), (0, 1),
                                                      (1, 1)]
    for k in At.blocks:
        _close(At.blocks[k], Aj.blocks[k])
    _close(At, Aj)
    _close(At.M[1, 0].values, np.zeros((At.W_test.subspaces[1].dim,
                                        At.W_trial.subspaces[0].dim)))
    x = np.random.default_rng(0).standard_normal(At.shape[1])
    y = At.matvec(torch.as_tensor(x)).numpy()
    assert np.abs(y - At.to_scipy() @ x).max() < 1e-12
    assert isinstance(bt, T.MixedFunction)
    _close(bt.dat, bj.dat)


def test_mixed_diagonal_and_tensor():
    """assemble(diagonal=True) of a mixed form is the operator's
    diagonal (zero on a field without a diagonal block), and ``tensor``
    is filled in place; the JAX package raises AttributeError on the
    first and ignores the second (ROADMAP.md queue 3)."""
    mesh, W = _rt_dg(T)
    sigma, u = T.TrialFunctions(W)
    tau, v = T.TestFunctions(W)
    a = (T.dot(sigma, tau) + T.div(tau) * u + T.div(sigma) * v) * T.dx
    A = T.assemble(a)
    d = T.assemble(a, diagonal=True)
    assert isinstance(d, T.MixedFunction)
    assert np.abs(d.dat.numpy() - A.to_scipy().diagonal()).max() < 1e-15
    assert (d.dat.numpy()[W.subspaces[0].dim:] == 0).all()
    B = T.assemble(T.dot(sigma, tau) * 2.0 * T.dx + T.div(tau) * u * T.dx
                   + T.div(sigma) * v * T.dx, tensor=A)
    assert B is A and abs(A.to_scipy().diagonal()
                          - 2 * d.dat.numpy()).max() < 1e-14
    L = T.assemble(v * T.dx)
    b = T.Function(W)
    assert T.assemble(v * T.dx, tensor=b) is b
    _close(b.dat, L.dat)


# ---------------------------------------------------------- H(div) forms
def _hdiv_forms(fd):
    """RT1 and N1curl on triangles: Piola-mapped mass, div and curl cell
    integrals, and facet integrals (jump of the normal component on dS,
    the tangential trace on ds) of arguments and coefficients."""
    mesh = fd.UnitSquareMesh(3, 3)
    n = fd.FacetNormal(mesh)
    X = fd.SpatialCoordinate(mesh)
    out = []
    for fam in ("RT", "N1curl"):
        S = fd.FunctionSpace(mesh, fam, 1)
        s, t = fd.TrialFunction(S), fd.TestFunction(S)
        g = fd.project(fd.as_vector([fd.sin(X[1]), X[0] * X[1]]), S,
                       solver_parameters=LU)
        d = fd.div if fam == "RT" else fd.curl
        out += [fd.assemble((fd.dot(s, t) + d(s) * d(t)) * fd.dx),
                fd.assemble(fd.inner(fd.jump(s, n), fd.jump(t, n)) * fd.dS
                            + fd.dot(s, n) * fd.dot(t, n) * fd.ds),
                fd.assemble((fd.dot(g, t) + d(g) * d(t)) * fd.dx
                            + fd.dot(g('+'), t('+')) * fd.dS).dat,
                fd.assemble(fd.jump(g, n) ** 2 * fd.dS),
                fd.assemble(d(g) * fd.dx), g.dat]
    return out


def test_hdiv_cell_and_facet_forms_match_jax():
    ref, ours = _hdiv_forms(J), _hdiv_forms(T)
    for a, b in zip(ours, ref):
        if isinstance(b, float):
            assert abs(a - b) <= 1e-12 * max(abs(b), 1.0)
        else:
            _close(a, b)
    assert ours[3] < 1e-20          # RT1 normal components are continuous


@pytest.mark.parametrize("family, cube", [("RT", False), ("BDM", False),
                                          ("N1curl", False), ("RT", True),
                                          ("N1curl", True)])
def test_interpolate_into_moment_spaces_matches_jax(family, cube):
    """Interpolation into RT/BDM/N1curl (dual evaluation of the Piola
    pullback), and of a Piola-mapped coefficient into a Lagrange space."""
    out = []
    for fd in (J, T):
        mesh = fd.UnitCubeMesh(2, 2, 2) if cube else fd.UnitSquareMesh(4, 4)
        X = fd.SpatialCoordinate(mesh)
        e = fd.as_vector([fd.sin(X[0]) * X[1], X[0] ** 2 + fd.cos(X[1])]
                         + ([X[2] * X[0]] if cube else []))
        f = fd.Function(fd.FunctionSpace(mesh, family, 1)).interpolate(e)
        h = fd.Function(fd.VectorFunctionSpace(mesh, "CG", 1)).interpolate(f)
        out.append((f.dat, h.dat))
    for a, b in zip(out[1], out[0]):
        _close(a, b)


@pytest.mark.parametrize("family", ["RT", "BDM"])
def test_project_representable_fields(family):
    mesh = T.UnitSquareMesh(3, 3)
    S = T.FunctionSpace(mesh, family, 1)
    X = T.SpatialCoordinate(mesh)
    for e in (T.as_vector([1.0 + 0 * X[0], 2.0 + 0 * X[1]]),
              T.as_vector([X[0], X[1]])):
        g = T.project(e, S, solver_parameters=LU)
        assert T.errornorm(e, g) < 1e-12


def test_hdiv_normal_continuity():
    mesh = T.UnitSquareMesh(4, 4)
    S = T.FunctionSpace(mesh, "RT", 1)
    X = T.SpatialCoordinate(mesh)
    g = T.project(T.as_vector([T.sin(X[1]), T.cos(X[0])]), S,
                  solver_parameters=LU)
    assert T.assemble(T.div(g) * T.div(g) * T.dx) < 10.0


def test_higher_order_hdiv_hcurl_rates():
    """RT2 and N1curl2 on triangles: projection rates, continuous normal
    (RT) and tangential (N1curl: cell curls sum to the boundary
    circulation) components."""
    for fam in ("RT", "N1curl"):
        errs = []
        for n in (4, 8):
            mesh = T.UnitSquareMesh(n, n)
            V = T.FunctionSpace(mesh, fam, 2)
            X = T.SpatialCoordinate(mesh)
            e = T.as_vector([T.sin(X[0]) * X[1] ** 2, X[0] ** 3 + T.cos(X[1])])
            f = T.project(e, V)
            errs.append(T.errornorm(e, f))
            nrm = T.FacetNormal(mesh)
            if fam == "RT":
                assert T.assemble(T.jump(f, nrm) ** 2 * T.dS) < 1e-20
            else:
                t = T.as_vector([-nrm[1], nrm[0]])
                assert abs(T.assemble(T.curl(f) * T.dx)
                           - T.assemble(T.dot(f, t) * T.ds)) < 1e-9
        assert np.log2(errs[0] / errs[1]) > 1.8, (fam, errs)


# ---------------------------------------------------------------- solves
def test_poisson_mixed_demo_matches_jax():
    """demos/poisson_mixed.py at UnitSquareMesh(8, 8) through both
    packages (preonly + lu on the BlockMatrix)."""
    subs = [("UnitSquareMesh(16, 16)", "UnitSquareMesh(8, 8)"),
            ("assert err < 0.05", "assert err < 0.1")]
    ref = run_demo("poisson_mixed", J, subs)
    ours = run_demo("poisson_mixed", T, subs)
    _close(ours["w"].dat, ref["w"].dat)
    assert abs(ours["err"] - ref["err"]) < 1e-12


def test_rt_tetrahedra_matches_jax():
    out = []
    for fd in (J, T):
        mesh = fd.UnitCubeMesh(2, 2, 2)
        S = fd.FunctionSpace(mesh, "RT", 1)
        V = fd.FunctionSpace(mesh, "DG", 0)
        X = fd.SpatialCoordinate(mesh)
        c = fd.as_vector([1.0 + 0 * X[0], 2.0 + 0 * X[1], -1.0 + 0 * X[2]])
        g = fd.project(c, S, solver_parameters=LU)
        W = fd.MixedFunctionSpace([S, V])
        sigma, u = fd.TrialFunctions(W)
        tau, v = fd.TestFunctions(W)
        ex = fd.sin(math.pi * X[0]) * fd.sin(math.pi * X[1]) \
            * fd.sin(math.pi * X[2])
        f = fd.Function(V).interpolate(3 * math.pi ** 2 * ex)
        w = fd.Function(W)
        fd.solve((fd.dot(sigma, tau) + fd.div(tau) * u + fd.div(sigma) * v)
                 * fd.dx == -fd.inner(f, v) * fd.dx, w, solver_parameters=LU)
        out.append((g.dat, w.dat, fd.errornorm(c, g),
                    fd.errornorm(ex, w.subfunctions[1])))
    (gj, wj, ecj, euj), (gt, wt, ect, eut) = out
    _close(gt, gj)
    _close(wt, wj)
    assert ect < 1e-10 and eut < 0.35 and abs(eut - euj) < 1e-12


def test_rtcf_quads_mixed_poisson_matches_jax():
    out = []
    for fd in (J, T):
        mesh, W = _rt_dg(fd, 4, "RTCF", quad=True)
        sigma, u = fd.TrialFunctions(W)
        tau, v = fd.TestFunctions(W)
        X = fd.SpatialCoordinate(mesh)
        w = fd.Function(W)
        fd.solve((fd.inner(sigma, tau) + fd.inner(u, fd.div(tau))
                  + fd.inner(fd.div(sigma), v)) * fd.dx
                 == -fd.inner(X[0] * X[1], v) * fd.dx, w,
                 solver_parameters=LU)
        out.append(w.dat)
    _close(out[1], out[0])


def test_stokes_poiseuille_dirichlet_on_sub_matches_jax():
    """Taylor-Hood Stokes with DirichletBC(W.sub(0), ...): the velocity
    is exact; the pressure agrees up to its free constant."""
    out = []
    for fd in (J, T):
        W = _taylor_hood(fd)
        V, Q = W.subspaces
        u, p = fd.TrialFunctions(W)
        v, q = fd.TestFunctions(W)
        X = fd.SpatialCoordinate(W.mesh())
        uex = fd.as_vector([X[1] * (1 - X[1]), 0.0])
        bc = fd.DirichletBC(W.sub(0), fd.Function(V).interpolate(uex),
                            (1, 2, 3, 4))
        w = fd.Function(W)
        fd.solve((fd.inner(fd.grad(u), fd.grad(v)) - p * fd.div(v)
                  - q * fd.div(u)) * fd.dx
                 == fd.inner(fd.Constant([0.0, 0.0]), v) * fd.dx, w,
                 bcs=[bc], solver_parameters=LU)
        uh, ph = w.subfunctions
        pd = _np(ph.dat)
        out.append((uh.dat, pd - pd.mean(), fd.errornorm(uex, uh),
                    bc.dof_indices))
    (uj, pj, ej, ij), (ut, pt, et, it) = out
    assert np.array_equal(it, ij) and it.min() == 0
    assert et < 1e-8
    _close(ut, uj, 1e-10)
    _close(pt, pj, 1e-10)


def test_mixed_nonlinear_derivative():
    W = _taylor_hood(T)
    w = T.Function(W)
    u, p = T.split(w)
    v, q = T.TestFunctions(W)
    F = (T.inner(T.grad(u), T.grad(v)) + p * p * q - q) * T.dx
    assert {a.number for a in T.derivative(F, w).arguments()} == {0, 1}
    w.subfunctions[1].assign(0.5)
    T.solve(F == 0, w, solver_parameters=dict(LU, snes_rtol=1e-10))
    assert np.allclose(w.subfunctions[1].dat.numpy(), 1.0, atol=1e-8)
    assert np.allclose(w.subfunctions[0].dat.numpy(), 0.0, atol=1e-8)


def _krylov(fd, ksp, pc, shift):
    mesh, W = _rt_dg(fd, 3, "BDM")
    sigma, u = fd.TrialFunctions(W)
    tau, v = fd.TestFunctions(W)
    X = fd.SpatialCoordinate(mesh)
    if shift:      # symmetric positive definite: block-diagonal masses
        a = (fd.dot(sigma, tau) + u * v) * fd.dx
    else:
        a = (fd.dot(sigma, tau) + u * v + fd.div(tau) * u
             - fd.div(sigma) * v) * fd.dx
    L = (fd.sin(X[0]) * v + fd.dot(fd.as_vector([X[1], 1.0]), tau)) * fd.dx
    w = fd.Function(W)
    s = fd.LinearVariationalSolver(
        fd.LinearVariationalProblem(a, L, w),
        solver_parameters={"ksp_type": ksp, "pc_type": pc,
                           "ksp_rtol": 1e-10})
    s.solve()
    return w.dat, int(s.ksp_iterations)


@pytest.mark.parametrize("ksp, pc, shift", [("gmres", "jacobi", False),
                                            ("gmres", "none", False),
                                            ("cg", "jacobi", True)])
def test_krylov_on_block_matrix_matches_jax(ksp, pc, shift):
    (xj, ij), (xt, it) = _krylov(J, ksp, pc, shift), _krylov(T, ksp, pc,
                                                            shift)
    assert it == ij
    _close(xt, xj, 1e-10)


def test_mixed_vector_space_basis_matches_jax():
    out = []
    for fd in (J, T):
        mesh, W = _rt_dg(fd)
        basis = fd.MixedVectorSpaceBasis(
            W, [W.sub(0), fd.VectorSpaceBasis(constant=True)])
        b = np.random.default_rng(4).standard_normal(W.dim)
        x = basis.orthogonalize(b if fd is J else torch.as_tensor(b))
        out.append(x)
        if fd is T:
            assert not basis.is_trivial()
            assert T.MixedVectorSpaceBasis(W, [W.sub(0), W.sub(1)]) \
                .is_trivial()
            n0 = W.subspaces[0].dim
            assert abs(float(x[n0:].sum())) < 1e-12
            assert torch.equal(x[:n0], torch.as_tensor(b[:n0]))
    _close(out[1], out[0])
