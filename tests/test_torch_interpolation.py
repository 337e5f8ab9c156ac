"""Interpolation operators, HiptmairPC, GTMGPC, non-nested hierarchies and
TransferManager of the port against the JAX package, on the CPU.

The same inputs (meshes, seeded numpy vectors) go through both packages.
Host arrays (sparsity patterns, located cells) equal bit for bit; values
the device computes within 1e-12 (f64) of max|ref|; CG counts equal.  The
JAX package's Krylov solves (Hiptmair's and GTMG's counts, the GTMG
hybridized solves) run in big-stack threads started with the module, so
XLA compiles them beside the port's tests; a test waits for its own."""
import threading

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
import jax
import jax.numpy as jnp

import firedrake_tpu as J
import firedrake_tpu_torch as T
from firedrake_tpu import interpolation as JI
from firedrake_tpu_torch import interpolation as TI
from firedrake_tpu_torch.device import to_numpy

NO_OPT = "jax_disable_most_optimizations"


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    T.set_device("cpu")
    opt = jax.config.read(NO_OPT)
    jax.config.update(NO_OPT, True)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    jax.config.update(NO_OPT, opt)
    jax.clear_caches()
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(to_numpy(x), dtype=np.float64)


def _close(ours, ref, tol=1e-12):
    ours, ref = _np(ours), np.asarray(ref, dtype=np.float64)
    assert ours.shape == ref.shape
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(ours - ref).max() <= tol * scale, \
        np.abs(ours - ref).max() / scale


def _same_matrix(a, b):
    """The port's Matrix b against the JAX package's a: the sparsity bit
    for bit, the values within 1e-12."""
    for name in ("coo_rows", "coo_cols", "indptr"):
        assert np.array_equal(getattr(a.sparsity, name),
                              getattr(b.sparsity, name)), name
    _close(b.data, a.data)


class _BigStack:
    """fn() started now in a thread with a 512 MB stack (XLA:CPU compiles
    nested while-loop programs recursively); ``result()`` waits."""

    def __init__(self, fn):
        self.out = []
        old = threading.stack_size(512 * 1024 * 1024)
        self.thread = threading.Thread(target=lambda: self.out.append(fn()))
        try:
            self.thread.start()
        finally:
            threading.stack_size(old)

    def result(self):
        self.thread.join()
        assert self.out, "the solve raised (see the thread's traceback)"
        return self.out[0]


# ------------------------------------------------------------ the problems
def _riesz(fd, case):
    """test_hiptmair.py's _riesz: (a, L, bcs, f) of an H(curl) or H(div)
    Riesz map with the constant f on UnitSquareMesh(6); case = (mesh,
    family, bcs)."""
    _, family, with_bcs = case
    mesh = fd.UnitSquareMesh(6, 6)
    V = fd.FunctionSpace(mesh, family, 1)
    d = fd.curl if family == "N1curl" else fd.div
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    a = fd.inner(d(u), d(v)) * fd.dx + fd.inner(u, v) * fd.dx
    f = fd.Constant((1.0, 2.0))
    L = fd.inner(f, v) * fd.dx
    bcs = [fd.DirichletBC(V, f, "on_boundary")] if with_bcs else []
    return V, a, L, bcs, f


def _hip_params(fd):
    pkg = "firedrake_tpu" if fd is J else "firedrake"
    return {"pc_type": "python", "pc_python_type": f"{pkg}.HiptmairPC"}


def _pc_and_system(fd, case):
    """test_hiptmair.py's _its set-up: the operator with its bc rows, the
    masked right-hand side and one HiptmairPC."""
    comp = __import__(f"{fd.__name__}.solvers.composition",
                      fromlist=["OpCtx"])
    V, a, L, bcs, _ = _riesz(fd, case)
    A = fd.assemble(a, bcs=bcs)
    maskf = np.ones(V.dim)
    for bc in bcs:
        maskf[bc.dof_indices] = 0.0
    b = _np(fd.assemble(L).dat) * maskf
    ctx = comp.OpCtx(mat=A, space=V, form=a, bcs=bcs)
    return A, b, comp.build_pc(ctx, _hip_params(fd), ""), V


def _cg_count(fd, A, b, pc):
    krylov = __import__(f"{fd.__name__}.solvers.krylov",
                        fromlist=["KSP_METHODS"])
    vec = jnp.asarray(b) if fd is J else torch.as_tensor(b)
    res = krylov.KSP_METHODS["cg"](A.matvec, vec, pc=pc, rtol=1e-8,
                                   max_it=300)
    return int(res.iterations)


HIP_CASES = [("square", "N1curl", True), ("square", "N1curl", False),
             ("square", "RT", True)]
RNG_SEED = 5


def _jax_hiptmair(case):
    A, b, pc, V = _pc_and_system(J, case)
    r = np.random.default_rng(RNG_SEED).standard_normal(V.dim)
    return np.asarray(pc(jnp.asarray(r))), _cg_count(J, A, b, pc)


def _gtmg_appctx(fd, mesh):
    P1 = fd.FunctionSpace(mesh, "CG", 1)
    return {"get_coarse_space": lambda: P1,
            "get_coarse_operator": lambda: fd.inner(
                fd.grad(fd.TrialFunction(P1)),
                fd.grad(fd.TestFunction(P1))) * fd.dx,
            "coarse_space_bcs": fd.DirichletBC(P1, 0.0, "on_boundary")}


def _mixed_poisson(fd, n=6):
    """test_gtmg.py's mixed Poisson: RT1 x DG0 by hybridization, the trace
    by CG + GTMGPC with a P1 coarse space.  (error, CG count, u)."""
    mesh = fd.UnitSquareMesh(n, n)
    x = fd.SpatialCoordinate(mesh)
    RT = fd.FunctionSpace(mesh, "RT", 1)
    DG = fd.FunctionSpace(mesh, "DG", 0)
    W = fd.MixedFunctionSpace([RT, DG])
    sigma, u = fd.TrialFunctions(W)
    tau, v = fd.TestFunctions(W)
    f = fd.Function(DG)
    f.interpolate(-2 * (x[0] - 1) * x[0] - 2 * (x[1] - 1) * x[1])
    a = (fd.inner(sigma, tau) - fd.inner(u, fd.div(tau))
         + fd.inner(fd.div(sigma), v)) * fd.dx
    L = fd.inner(f, v) * fd.dx
    w = fd.Function(W)
    pkg = "firedrake_tpu" if fd is J else "firedrake"
    params = {"pc_type": "hybridization",
              "hybridization": {"ksp_type": "cg", "ksp_rtol": 1e-10,
                                "pc_type": "python",
                                "pc_python_type": f"{pkg}.GTMGPC"}}
    solver = fd.LinearVariationalSolver(
        fd.LinearVariationalProblem(a, L, w), solver_parameters=params,
        appctx=_gtmg_appctx(fd, mesh))
    solver.solve()
    uh = w.subfunctions[1]
    exact = fd.Function(DG)
    exact.interpolate(x[0] * (1 - x[0]) * x[1] * (1 - x[1]))
    return (fd.errornorm(exact, uh), int(solver.ksp_iterations),
            _np(uh.dat))


def _gtmg_standin(fd):
    """test_gtmg.py's stand-in: GTMG on the P1 Laplacian with itself as the
    coarse space; (operator, rhs, pc)."""
    comp = __import__(f"{fd.__name__}.solvers.composition",
                      fromlist=["OpCtx"])
    mesh = fd.UnitSquareMesh(8, 8)
    P1 = fd.FunctionSpace(mesh, "CG", 1)
    aP = fd.inner(fd.grad(fd.TrialFunction(P1)),
                  fd.grad(fd.TestFunction(P1))) * fd.dx
    bcs = [fd.DirichletBC(P1, 0.0, "on_boundary")]
    A = fd.assemble(aP, bcs=bcs)
    maskf = np.ones(P1.dim)
    maskf[bcs[0].dof_indices] = 0.0
    b = np.random.default_rng(3).standard_normal(P1.dim) * maskf
    appctx = {"get_coarse_space": lambda: P1,
              "get_coarse_operator": lambda: aP, "coarse_space_bcs": bcs}
    ctx = comp.OpCtx(mat=A, space=P1, form=aP, bcs=bcs, appctx=appctx)
    pkg = "firedrake_tpu" if fd is J else "firedrake"
    return A, b, comp.build_pc(ctx, {"pc_type": "python",
                                     "pc_python_type": f"{pkg}.GTMGPC"}, "")


def _jax_gtmg_standin():
    A, b, pc = _gtmg_standin(J)
    return np.asarray(pc(jnp.asarray(b))), _cg_count(J, A, b, pc)


OPERATOR_CASES = [("N1curl", 1, "grad"), ("N1curl", 2, "grad"),
                  ("RT", 1, "perp")]


@pytest.fixture(scope="module", autouse=True)
def jax_runs(_cpu):
    """The JAX package's programs, started as the module starts."""
    runs = {("hip",) + c: _BigStack(lambda c=c: _jax_hiptmair(c))
            for c in HIP_CASES}
    runs.update({("op",) + c: _BigStack(lambda c=c: _operator_matrix(J, *c))
                 for c in OPERATOR_CASES})
    runs["manager"] = _BigStack(lambda: _transfer_manager(J, "N1curl"))
    runs["gtmg"] = _BigStack(lambda: _mixed_poisson(J))
    runs["gtmg_standin"] = _BigStack(_jax_gtmg_standin)
    yield runs
    for r in runs.values():
        r.thread.join()


# ------------------------------------------------------ operator matrices
def _operator_matrix(fd, target, degree, kind):
    mesh = fd.UnitSquareMesh(3, 2)
    V = fd.FunctionSpace(mesh, target, degree)
    g = fd.grad(fd.TrialFunction(fd.FunctionSpace(mesh, "CG", degree)))
    e = g if kind == "grad" else fd.as_vector([g[1], -g[0]])
    return (JI if fd is J else TI).operator_matrix(e, V)


@pytest.mark.parametrize("case", OPERATOR_CASES,
                         ids=["cg1_n1curl1", "cg2_n1curl2", "cg1_rt1_perp"])
def test_operator_matrix_matches_jax(case, jax_runs):
    """The discrete gradient CG_k -> N1curl_k and the 2D perp-gradient
    CG1 -> RT1."""
    _same_matrix(jax_runs[("op",) + case].result(),
                 _operator_matrix(T, *case))


def _interp_case(fd, branch):
    """(Interpolator, source Function, target space) of one branch."""
    mesh = fd.UnitSquareMesh(4, 3)
    X = fd.SpatialCoordinate(mesh)
    if branch == "vector":
        Vs = fd.VectorFunctionSpace(mesh, "CG", 2)
        Vd = fd.VectorFunctionSpace(mesh, "CG", 1)
        u = fd.Function(Vs).interpolate(fd.as_vector([X[0] ** 2, X[1]]))
        return fd.Interpolator(fd.TrialFunction(Vs), Vd), u, Vd
    Vs = fd.FunctionSpace(mesh, "CG", 2)
    u = fd.Function(Vs).interpolate(X[0] ** 2 + X[1])
    if branch == "same_mesh":
        Vd = fd.FunctionSpace(mesh, "CG", 1)
    elif branch == "cross_mesh":
        Vd = fd.FunctionSpace(fd.UnitSquareMesh(5, 5), "CG", 2)
    else:
        pts = np.random.default_rng(1).uniform(0, 1, (7, 2))
        Vd = fd.FunctionSpace(fd.VertexOnlyMesh(mesh, pts), "DG", 0)
    return fd.Interpolator(fd.TrialFunction(Vs), Vd), u, Vd


@pytest.mark.parametrize("branch", ["same_mesh", "vector", "cross_mesh",
                                    "vom"])
def test_interpolator_matches_jax(branch):
    """assemble(), interpolate and its adjoint (through I^T kept as a
    matrix of its own) on every target branch."""
    got = []
    for fd in (J, T):
        I, u, Vd = _interp_case(fd, branch)
        M = I.assemble()
        w = fd.Cofunction(Vd)
        w.dat = np.random.default_rng(2).standard_normal(Vd.dim)
        got.append((M, I.interpolate(u).dat,
                    I.interpolate(w, adjoint=True).dat, w, u))
    (Mj, fj, aj, wj, uj), (Mt, ft, at, wt, ut) = got
    _same_matrix(Mj, Mt)
    _close(ft, fj)
    _close(at, aj)
    # <I u, w> == <u, I^T w>
    assert abs(float(_np(wt.dat) @ _np(ft)) - float(_np(at) @ _np(ut.dat))) \
        < 1e-12


def test_transpose_is_its_own_matrix():
    """Matrix.transpose: the pattern of A^T, its values A's, bit for bit on
    the CPU; its matvec is transpose_matvec's product."""
    _, u, Vd = _interp_case(T, "cross_mesh")
    M = T.Interpolator(u, Vd).assemble()
    MT = M.transpose()
    ref = M.to_scipy().T.tocsr()
    ref.sort_indices()
    got = MT.to_scipy()
    assert np.array_equal(got.indptr, ref.indptr)
    assert np.array_equal(got.indices, ref.indices)
    assert np.array_equal(got.data, ref.data)
    y = torch.as_tensor(np.random.default_rng(4).standard_normal(Vd.dim))
    _close(MT.matvec(y), _np(M.transpose_matvec(y)), 1e-14)


# -------------------------------------------- cross-mesh and point location
def test_cross_mesh_scalar_matrix_matches_jax():
    """Nodes of a wider mesh located in a smaller one: the nearest-cell
    extrapolation (one k-d tree query, one batched inversion) picks the
    JAX package's cells."""
    mats = []
    for fd, mod in ((J, JI), (T, TI)):
        Vs = fd.FunctionSpace(fd.UnitSquareMesh(4, 3), "CG", 2)
        Vd = fd.FunctionSpace(fd.RectangleMesh(5, 4, 1.3, 1.1), "CG", 1)
        mats.append(mod.cross_mesh_scalar_matrix(Vs, Vd))
    _same_matrix(*mats)


def test_locate_robust_extrapolates_and_refuses():
    pts = np.concatenate([np.random.default_rng(6).uniform(-0.01, 1.01,
                                                           (40, 2)),
                          [[1.5, 0.2], [0.5, 1.02]]])
    got = []
    for fd, mod in ((J, JI), (T, TI)):
        mesh = fd.UnitSquareMesh(4, 4)
        with pytest.raises(fd.PointNotInDomainError, match=r"\[1\.5"):
            mod._locate_robust(mesh, pts)
        got.append(mod._locate_robust(mesh, pts, allow_extrapolate=True))
    (cj, rj), (ct, rt) = got
    assert np.array_equal(cj, ct)
    _close(rt, rj)


# ------------------------------------------------- non-nested and manager
@pytest.mark.parametrize("vector", [False, True])
def test_nonnested_transfer_matches_jax(vector):
    """prolong, restrict and inject between two non-nested levels."""
    got = []
    rng = np.random.default_rng(7)
    for fd in (J, T):
        mh = fd.NonNestedHierarchy(fd.UnitSquareMesh(4, 4),
                                   fd.UnitSquareMesh(6, 5))
        FS = fd.VectorFunctionSpace if vector else fd.FunctionSpace
        Vc, Vf = FS(mh[0], "CG", 1), FS(mh[1], "CG", 1)
        if not got:
            xc, xf = rng.standard_normal(Vc.dim), rng.standard_normal(Vf.dim)
        t = __import__(f"{fd.__name__}.mg.transfer",
                       fromlist=["get_transfer"]).get_transfer(Vc, Vf)
        conv = jnp.asarray if fd is J else torch.as_tensor
        got.append([t.prolong_fn(conv(xc)), t.restrict_fn(conv(xf)),
                    t.inject_fn(conv(xf))])
    for ours, ref in zip(got[1], got[0]):
        _close(ours, np.asarray(ref))


def _nonnested_poisson(params):
    """test_nonnested.py's Poisson problem on the finest of three
    non-nested meshes, solved with ``params``: (CG count, solution)."""
    mh = T.NonNestedHierarchy(T.UnitSquareMesh(3, 3), T.UnitSquareMesh(5, 5),
                              T.UnitSquareMesh(8, 8))
    V = T.FunctionSpace(mh.finest, "CG", 1)
    u, v = T.TrialFunction(V), T.TestFunction(V)
    x, y = T.SpatialCoordinate(mh.finest)
    uh = T.Function(V)
    solver = T.LinearVariationalSolver(
        T.LinearVariationalProblem(
            T.inner(T.grad(u), T.grad(v)) * T.dx,
            2 * (x * (1 - x) + y * (1 - y)) * v * T.dx, uh,
            bcs=[T.DirichletBC(V, 0.0, "on_boundary")]),
        solver_parameters=params)
    solver.solve()
    return int(solver.ksp_iterations), _np(uh.dat)


def test_nonnested_gmg_matches_single_level():
    """test_nonnested.py's three-level GMG solve against the single-level
    Jacobi solve (the JAX package's own test; its transfers are held
    above)."""
    its, u = _nonnested_poisson({"ksp_type": "cg", "pc_type": "mg",
                                 "ksp_rtol": 1e-12})
    _, u_ref = _nonnested_poisson({"ksp_type": "cg", "pc_type": "jacobi",
                                   "ksp_rtol": 1e-13})
    assert its < 12
    assert np.abs(u - u_ref).max() < 1e-8


def _transfer_manager(fd, family):
    mh = fd.MeshHierarchy(fd.UnitSquareMesh(2, 2), 1)
    X = fd.SpatialCoordinate(mh[0])
    Xf = fd.SpatialCoordinate(mh[1])
    if family == "CG":
        Vc, Vf = (fd.FunctionSpace(m, "CG", 2) for m in mh)
        ec, ef = X[0] * X[1], Xf[0] ** 2
    else:
        Vc, Vf = (fd.FunctionSpace(m, "N1curl", 1) for m in mh)
        ec = fd.as_vector([1 + X[1], X[0]])
        ef = fd.as_vector([Xf[1], 2.0 - Xf[0]])
    tm = fd.TransferManager()
    fine = tm.prolong(fd.Function(Vc).interpolate(ec), fd.Function(Vf))
    coarse = tm.inject(fd.Function(Vf).interpolate(ef), fd.Function(Vc))
    return _np(fine.dat), _np(coarse.dat)


@pytest.mark.parametrize("family", ["CG", "N1curl"])
def test_transfer_manager_matches_jax(family, jax_runs):
    """TransferManager.prolong and inject: straight through the level
    transfers on a nodal space, through the vector DG embedding on
    N1curl."""
    ref = (jax_runs["manager"].result() if family == "N1curl"
           else _transfer_manager(J, family))
    for ours, r in zip(_transfer_manager(T, family), ref):
        _close(ours, r)


# ----------------------------------------------------------------- Hiptmair
@pytest.mark.parametrize("case", HIP_CASES,
                         ids=["hcurl_bcs", "hcurl_no_bcs", "hdiv_bcs"])
def test_hiptmair_matches_jax(case, jax_runs):
    """One HiptmairPC application on a seeded vector, and CG's count on
    test_hiptmair.py's _its problem."""
    A, b, pc, V = _pc_and_system(T, case)
    r = np.random.default_rng(RNG_SEED).standard_normal(V.dim)
    z = pc(torch.as_tensor(r))
    its = _cg_count(T, A, b, pc)
    zj, its_j = jax_runs[("hip",) + case].result()
    _close(z, zj)
    assert its == its_j


def test_hiptmair_solve_is_the_riesz_map():
    """CG + HiptmairPC through solve(): the Riesz map of a constant is the
    constant (test_hiptmair.py's gate)."""
    V, a, L, bcs, f = _riesz(T, ("square", "N1curl", True))
    uh = T.Function(V)
    T.solve(a == L, uh, bcs=bcs,
            solver_parameters={"ksp_type": "cg", "ksp_rtol": 1e-11,
                               **_hip_params(T)})
    assert T.errornorm(f, uh) < 1e-6


def test_hiptmair_potential_operator_is_in_k1_family():
    """The H(curl) potential form, made by replacing the fine form's
    arguments by gradients, is inner(grad p, grad q): K1's family takes it
    (no silent fall back to the lowerer)."""
    from firedrake_tpu_torch.compiler.cell_eval import family_spec, GRADGRAD
    from firedrake_tpu_torch.solvers import hiptmair
    V, a, _, bcs, _ = _riesz(T, ("square", "N1curl", True))
    beta = hiptmair._kill_arg_derivatives(a)
    args = hiptmair._form_arguments(a)
    Vc = T.FunctionSpace(V.mesh(), "CG", 1)
    pf = T.replace(beta, {args[0]: T.grad(T.TestFunction(Vc)),
                          args[1]: T.grad(T.TrialFunction(Vc))})
    cis = T.FormAssembler(pf, use_stencil=False)._compiled
    specs = [family_spec(ci) for ci in cis]
    assert specs and all(s is not None for s in specs)
    assert [t[0] for t in specs[0].terms] == [GRADGRAD]


# --------------------------------------------------------------------- GTMG
def test_gtmg_hybridized_matches_jax(jax_runs):
    """test_gtmg.py's mixed Poisson at n = 6: the trace CG count, the DG0
    solution and its error."""
    err, its, u = _mixed_poisson(T)
    err_j, its_j, u_j = jax_runs["gtmg"].result()
    assert its == its_j
    _close(u, u_j)
    assert abs(err - err_j) <= 1e-12 * err_j
    assert err < 4e-3


def test_gtmg_application_matches_jax(jax_runs):
    """One GTMG application and CG's count on the stand-in problem (the
    coarse space equals the fine one: a handful of iterations)."""
    A, b, pc = _gtmg_standin(T)
    z = pc(torch.as_tensor(b))
    its = _cg_count(T, A, b, pc)
    zj, its_j = jax_runs["gtmg_standin"].result()
    _close(z, zj)
    assert its == its_j <= 3
