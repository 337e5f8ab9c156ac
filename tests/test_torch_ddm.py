"""BDDC, deflated Newton and the eigensolvers in the port against the JAX
package, on the cases of tests/regression/test_bddc.py,
test_deflation.py and test_aux_components.py at their sizes.

- sfc_cell_order and BDDC's host tables (Lpad, the weights, the interior,
  interface and free masks, the constraint ids, n_pi): bit for bit.
- One BDDC application to a seeded vector within 1e-12 max|ref|, and the
  CG iteration counts equal (rtol 1e-10): P1 and P2 Poisson at 16^2 with
  16 subdomains, elasticity with 9, the cube with 8, primal_markers (the
  JAX package's BDDC compiled with XLA's optimisations on, as its own
  tests compile it; see _jax_bddc).
- BDDC's saddle blocks K need pivots: K2's pivoted plain version within
  1e-13 max|inv| of torch.linalg.inv there, the unpivoted one off by more
  than 1e-3.
- Deflation: the same roots within 1e-10 max|ref| and the same Newton
  counts.
- Eigenvalues: the scipy backend within 1e-10 relative of the JAX
  package's, the device LOBPCG within 1e-6.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import firedrake_tpu as J
import firedrake_tpu_torch as T

#: the JAX package's reference programs are compiled with XLA's
#: optimisations off (the results agree within the same tolerances); the
#: module's executables are dropped with it
NO_OPT = "jax_disable_most_optimizations"


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    # two torch threads: six test workers share the host's cores
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


def _close(ours, ref, rtol):
    ours, ref = _np(ours), _np(ref)
    assert ours.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(ours - ref).max() <= rtol * scale, \
        np.abs(ours - ref).max() / scale


# ------------------------------------------------------------------ BDDC
BDDC = {"pc_type": "python", "pc_python_type": "firedrake.BDDCPC"}


def _bddc_case(fd, name):
    """(V, a, bcs, subdomains, appctx) of a test_bddc.py case."""
    if name == "elasticity_9":
        V = fd.VectorFunctionSpace(fd.UnitSquareMesh(16, 16), "CG", 1)
        u, v = fd.TrialFunction(V), fd.TestFunction(V)

        def eps(w):
            return fd.sym(fd.grad(w))

        a = (2.0 * fd.inner(eps(u), eps(v))
             + fd.inner(fd.div(u), fd.div(v))) * fd.dx
        return V, a, [fd.DirichletBC(V, fd.Constant((0.0, 0.0)), 1)], 9, {}
    mesh, deg, ns = {"p1_16": (fd.UnitSquareMesh(16, 16), 1, 16),
                     "p2_16": (fd.UnitSquareMesh(16, 16), 2, 16),
                     "markers_p2_16": (fd.UnitSquareMesh(16, 16), 2, 16),
                     "cube_p1_6": (fd.UnitCubeMesh(6, 6, 6), 1, 8)}[name]
    V = fd.FunctionSpace(mesh, "CG", deg)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    bcs = [fd.DirichletBC(V, 0.0, "on_boundary")]
    appctx = {}
    if name.startswith("markers"):
        appctx["primal_markers"] = np.setdiff1d(
            np.arange(0, V.dim, 97), np.asarray(bcs[0].dof_indices))[:8]
    return V, fd.inner(fd.grad(u), fd.grad(v)) * fd.dx, bcs, ns, appctx


BDDC_CASES = ["p1_16", "p2_16", "elasticity_9", "cube_p1_6",
              "markers_p2_16"]


def _bddc_run(fd, name):
    """The PC object, one application to a seeded vector, and the CG
    iterations at rtol 1e-10, in package fd."""
    comp = __import__(f"{fd.__name__}.solvers.composition",
                      fromlist=["OpCtx"])
    pcs = __import__(f"{fd.__name__}.solvers.pcs", fromlist=["BDDCPC"])
    krylov = __import__(f"{fd.__name__}.solvers.krylov",
                        fromlist=["KSP_METHODS"])
    V, a, bcs, ns, appctx = _bddc_case(fd, name)
    A = fd.assemble(a, bcs=bcs)
    mask = np.ones(V.dim)
    for bc in bcs:
        mask[np.asarray(bc.dof_indices)] = 0.0
    b = np.random.default_rng(7).standard_normal(V.dim) * mask
    b = jnp.asarray(b) if fd is J else torch.as_tensor(b)
    ctx = comp.OpCtx(mat=A, space=V, form=a, bcs=bcs, appctx=appctx)
    pc = pcs.BDDCPC()
    pc.initialize_ctx(ctx, {**BDDC, "bddc_subdomains": ns}, "")
    z = _np(pc.apply(b))
    res = krylov.KSP_METHODS["cg"](A.matvec, b, pc=pc.apply, rtol=1e-10,
                                   max_it=500)
    return pc, z, int(res.iterations)


_JAX_BDDC = {}


def _jax_bddc(name):
    """The JAX package's run of a case, compiled as tests/regression/
    test_bddc.py compiles it (XLA's optimisations on): BDDC's late CG
    residuals move with the rounding (elasticity's residual after 27
    iterations is 1.004e-10 with them and 5.5e-11 without, so the count
    is 28 or 27; the port's is 1.43e-10, 28)."""
    if name not in _JAX_BDDC:
        opt = jax.config.read(NO_OPT)
        jax.config.update(NO_OPT, False)
        try:
            _JAX_BDDC[name] = _bddc_run(J, name)
        finally:
            jax.config.update(NO_OPT, opt)
    return _JAX_BDDC[name]


@pytest.mark.parametrize("mesh", ["square", "cube"])
def test_sfc_cell_order_bit_for_bit(mesh):
    from firedrake_tpu.parallel.partition import sfc_cell_order as js
    from firedrake_tpu_torch.parallel.partition import sfc_cell_order as ts

    def make(fd):
        return (fd.UnitSquareMesh(16, 12) if mesh == "square"
                else fd.UnitCubeMesh(5, 6, 4))
    assert np.array_equal(ts(make(T)), js(make(J)))


@pytest.mark.parametrize("name", BDDC_CASES)
def test_bddc_host_tables_bit_for_bit(name):
    from firedrake_tpu_torch.solvers.bddc import _host_tables
    jpc = _jax_bddc(name)[0]
    V, _, bcs, ns, appctx = _bddc_case(T, name)
    t = _host_tables(V, bcs, ns, appctx.get("primal_markers"))
    assert t.n_pi == jpc._npi and t.ndof == jpc._ndof
    assert np.array_equal(t.Lpad, np.asarray(jpc._Lpad))
    assert np.array_equal(t.cpad, np.asarray(jpc._cpad))
    for ours, ref in ((t.Dw, jpc._Dw), (t.interior, jpc._imaskf),
                      (t.gamma, jpc._gmaskf), (~t.bc_mask, jpc._freeg)):
        assert np.array_equal(np.asarray(ours, dtype=np.float64),
                              np.asarray(ref))


@pytest.mark.parametrize("name", BDDC_CASES)
def test_bddc_application_and_cg_iterations(name):
    _, zj, itj = _jax_bddc(name)
    _, zt, itt = _bddc_run(T, name)
    _close(zt, zj, 1e-12)
    assert itt == itj


def test_bddc_saddle_blocks_need_pivots(monkeypatch):
    """On the P1 case's K blocks Gauss-Jordan without pivoting is finite
    but wrong; with partial pivoting it agrees with LAPACK."""
    from firedrake_tpu_torch.ops import batched_inverse as BI
    seen = []
    inv = BI.batched_inv

    def keep(A, pivot=False):
        if pivot:
            seen.append(A.clone())
        return inv(A, pivot)
    monkeypatch.setattr(BI, "batched_inv", keep)
    _bddc_run(T, "p1_16")
    (K,) = seen
    assert tuple(K.shape[:2]) == (16, K.shape[-1]) and K.shape[-1] > 32
    ref = torch.linalg.inv(K)
    scale = float(ref.abs().max())
    piv = BI.batched_inv_plain(K, pivot=True)
    assert float((piv - ref).abs().max()) <= 1e-13 * scale
    plain = BI.batched_inv_plain(K)
    assert bool(torch.isfinite(plain).all())
    assert float((plain - ref).abs().max()) > 1e-3 * scale


def test_bddc_solve_path_matches_lu():
    """End to end through solve() (test_bddc.py test_bddc_solve_path,
    P3 at 12^2): the BDDC-preconditioned CG solution within 1e-8 of the
    LU one, and BDDCPC resolved by name."""
    from firedrake_tpu_torch.solvers import composition, pcs
    assert composition._resolve_python_pc("firedrake.BDDCPC") is \
        pcs.BDDCPC
    mesh = T.UnitSquareMesh(12, 12)
    V = T.FunctionSpace(mesh, "CG", 3)
    u, v = T.TrialFunction(V), T.TestFunction(V)
    x, y = T.SpatialCoordinate(mesh)
    f = T.Function(V).interpolate(x * y)
    a = (T.inner(T.grad(u), T.grad(v)) + T.inner(u, v)) * T.dx
    L = T.inner(f, v) * T.dx
    bcs = [T.DirichletBC(V, 0.0, "on_boundary")]
    u_lu, uh = T.Function(V), T.Function(V)
    T.solve(a == L, u_lu, bcs=bcs,
            solver_parameters={"ksp_type": "preonly", "pc_type": "lu"})
    T.solve(a == L, uh, bcs=bcs,
            solver_parameters={"ksp_type": "cg", "ksp_rtol": 1e-11, **BDDC})
    assert T.errornorm(u_lu, uh) < 1e-8


# ------------------------------------------------------------- deflation
def _bratu_roots(fd):
    """test_deflation.py test_bratu_two_solutions: 1D Bratu at lambda =
    2, P3, two deflated solves from one guess."""
    mesh = fd.UnitIntervalMesh(10)
    V = fd.FunctionSpace(mesh, "CG", 3)
    x = fd.SpatialCoordinate(mesh)[0]
    u = fd.Function(V)
    guess = fd.Function(V).interpolate(6 * x * (1 - x))
    v = fd.TestFunction(V)
    F = -fd.inner(fd.grad(u), fd.grad(v)) * fd.dx \
        + fd.Constant(2) * fd.inner(fd.exp(u), v) * fd.dx
    problem = fd.NonlinearVariationalProblem(
        F, u, fd.DirichletBC(V, 0, "on_boundary"))
    deflation = fd.Deflation(op=lambda a, b: fd.inner(a - b, a - b) * fd.dx)
    solver = fd.NonlinearVariationalSolver(
        problem, solver_parameters={
            "snes_type": "deflated", "snes_linesearch_type": "basic",
            "ksp_type": "preonly", "pc_type": "lu", "snes_max_it": 100},
        appctx={"deflation": deflation})
    its = []
    for _ in range(2):
        u.dat = guess.dat
        solver.solve()
        assert solver.converged
        its.append(solver.snes_iterations)
    first, second = deflation.roots
    assert fd.norm(first - second) > 1
    return its, [_np(r.dat) for r in deflation.roots]


def _pointwise_roots(fd):
    """test_deflation.py test_deflation_pointwise_roots: u^2 = 1 from
    u = 0.5 twice."""
    V = fd.FunctionSpace(fd.UnitSquareMesh(4, 4), "CG", 1)
    u, v = fd.Function(V), fd.TestFunction(V)
    deflation = fd.Deflation()
    solver = fd.NonlinearVariationalSolver(
        fd.NonlinearVariationalProblem((u * u - 1) * v * fd.dx, u),
        solver_parameters={"ksp_type": "preonly", "pc_type": "lu",
                           "snes_max_it": 100},
        appctx={"deflation": deflation})
    its = []
    for _ in range(2):
        u.dat = 0.5 * np.ones(V.dim) if fd is J else \
            torch.full((V.dim,), 0.5, dtype=torch.float64)
        solver.solve()
        assert solver.converged
        its.append(solver.snes_iterations)
    assert len(deflation) == 2
    return its, [_np(r.dat) for r in deflation.roots]


@pytest.mark.parametrize("case", [_bratu_roots, _pointwise_roots],
                         ids=["bratu_1d_p3", "pointwise"])
def test_deflated_newton_matches_jax(case):
    its_j, roots_j = case(J)
    its_t, roots_t = case(T)
    assert its_t == its_j
    for rt, rj in zip(roots_t, roots_j):
        _close(rt, rj, 1e-10)


def test_deflation_tau_matches_jax():
    """tau for one known root at a guess, against the JAX package's."""
    out = []
    for fd in (J, T):
        V = fd.FunctionSpace(fd.UnitSquareMesh(3, 3), "CG", 2)
        X = fd.SpatialCoordinate(V.mesh())
        root = fd.Function(V).interpolate(X[0] * X[1])
        y = fd.Function(V).interpolate(fd.sin(X[0]) + X[1])
        du = np.linspace(-1.0, 1.0, V.dim)
        d = fd.Deflation([root], power=2, shift=1)
        out.append((d.tau(y, du if fd is J else torch.as_tensor(du)),
                    d.evaluate(y)))
    assert abs(out[1][0] - out[0][0]) <= 1e-12 * abs(out[0][0])
    assert abs(out[1][1] - out[0][1]) <= 1e-12 * abs(out[0][1])


# ----------------------------------------------------------- eigensolvers
def _eigenvalues(fd, n, k, params):
    V = fd.FunctionSpace(fd.UnitSquareMesh(n, n), "CG", 1)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    ep = fd.LinearEigenproblem(fd.inner(fd.grad(u), fd.grad(v)) * fd.dx,
                               fd.inner(u, v) * fd.dx,
                               bcs=[fd.DirichletBC(V, 0.0, "on_boundary")])
    es = fd.LinearEigensolver(ep, n_evals=k, solver_parameters=params)
    nconv = es.solve()
    return np.array([es.eigenvalue(i) for i in range(k)]), nconv, es


def test_eigensolver_scipy_matches_jax():
    """test_aux_components.py test_laplace_eigenvalues (16^2, 3 smallest)
    and an eigenfunction on the full space."""
    ref, nj, _ = _eigenvalues(J, 16, 3, None)
    ours, nt, es = _eigenvalues(T, 16, 3, None)
    assert nt == nj >= 3
    assert np.abs(ours - ref).max() <= 1e-10 * np.abs(ref).max()
    fr, fi = es.eigenfunction(0)
    assert fr.dat.shape == (fr.function_space().dim,)
    assert float(fi.dat.abs().max()) == 0.0
    assert abs(ours[0] - 2 * np.pi ** 2) < 0.5


def test_eigensolver_lobpcg_matches_jax():
    """test_aux_components.py test_device_lobpcg_eigensolver (12^2, 4
    smallest, lumped mass, eps_max_it 400)."""
    params = {"eps_backend": "lobpcg", "eps_which": "SM", "eps_max_it": 400}
    ref, _, _ = _eigenvalues(J, 12, 4, params)
    ours, _, _ = _eigenvalues(T, 12, 4, params)
    assert np.abs(ours - ref).max() <= 1e-6 * np.abs(ref).max()
    exact = np.pi ** 2 * np.array([2.0, 5.0, 5.0, 8.0])
    assert (np.abs(ours - exact) / exact).max() < 0.02


def test_lobpcg_standard_matches_jax_on_a_matrix():
    """lobpcg_standard alone on a seeded SPD matrix with a spectral gap:
    the top-3 eigenvalues as the JAX package's and numpy's, and the
    iteration count as the JAX package's."""
    from jax.experimental.sparse.linalg import lobpcg_standard as jl
    from firedrake_tpu_torch.eigensolver import lobpcg_standard as tl
    rng = np.random.default_rng(4)
    Q = np.linalg.qr(rng.standard_normal((60, 60)))[0]
    w = np.concatenate([[10.0, 9.0, 8.0], np.linspace(0.1, 1.0, 57)])
    A = (Q * w) @ Q.T
    X0 = np.linalg.qr(np.random.RandomState(0).randn(60, 3))[0]
    tj, _, ij = jl(lambda X: jnp.asarray(A) @ X, jnp.asarray(X0), m=100)
    At = torch.as_tensor(A)
    tt, U, it = tl(lambda X: At @ X, torch.as_tensor(X0), m=100)
    assert np.abs(tt.numpy() - np.asarray(tj)).max() <= 1e-12 * 10
    assert np.abs(tt.numpy() - w[:3]).max() <= 1e-10
    assert it == int(ij)
    assert float((At @ U - U * tt).abs().max()) <= 1e-8
