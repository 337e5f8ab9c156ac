"""Fieldsplit, the python PC table and the Vanka patch in the port against
the JAX package: each preconditioner's application to one seeded vector
on the same Taylor-Hood Stokes operator (UnitSquareMesh(4), P2-P1, with
the same Dirichlet rows), the Vanka patches bit for bit, the option table
(substitutions, aliases, refusals), and three whole solves with the
JAX package's iteration counts (tests/regression/test_solver_composition
.py's Stokes with mg inside a Schur fieldsplit, Stokes with Vanka, and
the Re = 50 lid-driven cavity with PCD).

Tolerances: PC applications and patch matrices within 1e-12 max|ref|;
patch lists bit for bit; whole solves within 1e-7 (Stokes, fgmres at
rtol 1e-8) and 1e-8 (Newton at snes_rtol 1e-8) max|ref|."""
import importlib
import threading
import warnings

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
import jax

import firedrake_tpu as J
import firedrake_tpu_torch as T

#: the JAX package's reference programs are compiled with XLA's
#: optimisations off (the results agree within the same tolerances); the
#: module's executables are dropped with it
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
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(ours, ref, rtol):
    ours, ref = _np(ours), _np(ref)
    assert ours.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(ours - ref).max() <= rtol * scale, \
        np.abs(ours - ref).max() / scale


def _mod(fd, name):
    return importlib.import_module(f"{fd.__name__}.{name}")


class _BigStack:
    """fn() started now in a thread with a 512 MB stack: XLA:CPU compiles
    nested while-loop programs (fgmres around inner Krylov solves)
    recursively (tests/regression/test_solver_composition.py big_stack).
    Its compilation releases the GIL, so the JAX package's whole solves
    compile beside the tests that run meanwhile; ``result()`` waits."""

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


# --------------------------------------------------------------- problems
def _stokes(fd, n=4, eps=0.0, mesh=None):
    """Taylor-Hood Stokes with Poiseuille data (test_solver_composition
    stokes_problem); eps > 0 adds -eps p q to the pressure block."""
    mesh = mesh or fd.UnitSquareMesh(n, n)
    V = fd.VectorFunctionSpace(mesh, "CG", 2)
    Q = fd.FunctionSpace(mesh, "CG", 1)
    W = V * Q
    u, p = fd.TrialFunctions(W)
    v, q = fd.TestFunctions(W)
    a = (fd.inner(fd.grad(u), fd.grad(v)) - p * fd.div(v)
         - q * fd.div(u)) * fd.dx
    if eps:
        a = a - eps * p * q * fd.dx
    X = fd.SpatialCoordinate(mesh)
    uex = fd.as_vector([X[1] * (1 - X[1]), 0.0])
    L = fd.inner(fd.Constant([0.0, 0.0]), v) * fd.dx
    bcs = [fd.DirichletBC(W.sub(0), fd.Function(V).interpolate(uex),
                          (1, 2, 3, 4))]
    return dict(mesh=mesh, V=V, Q=Q, W=W, a=a, L=L, bcs=bcs, uex=uex)


def _operator(fd, p):
    """The assembled block operator with the Dirichlet rows, as the linear
    solver builds it."""
    idx, _ = _mod(fd, "solving")._bc_data(p["bcs"], p["W"].dim)
    return fd.assemble(p["a"]).with_dirichlet(idx)


def _poisson(fd):
    mesh = fd.UnitSquareMesh(6, 6)
    V = fd.FunctionSpace(mesh, "CG", 1)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    a = (2.0 * fd.inner(fd.grad(u), fd.grad(v)) + u * v) * fd.dx
    return dict(V=V, a=a, bcs=[fd.DirichletBC(V, 0.0, "on_boundary")])


class LaplacePC(T.AuxiliaryOperatorPC):
    """The port's copy of test_solver_composition.py's LaplacePC."""

    def form(self, pc, test, trial):
        a = (T.inner(T.grad(trial), T.grad(test)) + trial * test) * T.dx
        return a, ()


_AUX = {"firedrake_tpu": "tests.regression.test_solver_composition."
        "LaplacePC", "firedrake_tpu_torch": f"{__name__}.LaplacePC"}


_CTX = {}


def _ctx(fd, kind):
    """(OpCtx, dim) of one operator kind, the same in both packages; made
    once per module (a PC only reads its context)."""
    key = (fd.__name__, kind)
    if key not in _CTX:
        _CTX[key] = _make_ctx(fd, kind)
    return _CTX[key]


def _make_ctx(fd, kind):
    comp = _mod(fd, "solvers.composition")
    if kind in ("stokes", "stokes_eps"):
        p = _stokes(fd, eps=0.1 if kind == "stokes_eps" else 0.0)
        A = _operator(fd, p)
        return comp.OpCtx(mat=A, space=p["W"], form=p["a"], bcs=p["bcs"]), \
            p["W"].dim
    if kind in ("mass", "pcd"):
        p = _stokes(fd)
        appctx = {"mu": 0.5}
        if kind == "pcd":
            w = fd.Function(p["W"])
            w.dat = np.random.default_rng(7).standard_normal(p["W"].dim)
            appctx = {"Re": 50.0, "state": w, "velocity_space": 0}
        return comp.OpCtx(space=p["Q"], appctx=appctx), p["Q"].dim
    p = _poisson(fd)
    if kind == "poisson_matfree":
        A = fd.assemble(p["a"], bcs=p["bcs"])
        return comp.OpCtx(matvec=A.matvec, space=p["V"], form=p["a"],
                          bcs=p["bcs"]), p["V"].dim
    A = fd.assemble(p["a"], bcs=p["bcs"])
    return comp.OpCtx(mat=A, space=p["V"], form=p["a"], bcs=p["bcs"]), \
        p["V"].dim


_LU0 = {"fieldsplit_0_ksp_type": "preonly", "fieldsplit_0_pc_type": "lu"}
_SCHUR = dict(_LU0, pc_type="fieldsplit", pc_fieldsplit_type="schur",
              fieldsplit_1_ksp_type="preonly",
              fieldsplit_1_pc_type="jacobi")
_PYTHON = {"pc_type": "python"}

PC_CASES = {
    **{f"fieldsplit_{t}": ("stokes_eps", dict(
        _LU0, pc_type="fieldsplit", pc_fieldsplit_type=t,
        fieldsplit_1_pc_type="jacobi"))
       for t in ("additive", "multiplicative", "symmetric_multiplicative")},
    **{f"schur_{f}_{s}": ("stokes_eps", dict(
        _SCHUR, pc_fieldsplit_schur_fact_type=f,
        pc_fieldsplit_schur_precondition=s))
       for f in ("diag", "lower", "upper", "full")
       for s in ("a11", "selfp", "full")},
    # S applied matrix-free inside an inner GMRES (its pc dropped to none)
    "schur_full_full_gmres": ("stokes_eps", dict(
        _SCHUR, pc_fieldsplit_schur_precondition="full",
        fieldsplit_1_ksp_type="gmres", fieldsplit_1_ksp_rtol=1e-6)),
    "composite_additive": ("poisson", {
        "pc_type": "composite", "pc_composite_pcs": "jacobi,lu"}),
    "composite_multiplicative": ("poisson", {
        "pc_type": "composite", "pc_composite_type": "multiplicative",
        "pc_composite_pcs": "jacobi,lu"}),
    "massinv": ("mass", dict(_PYTHON,
                             pc_python_type="firedrake.MassInvPC")),
    "pcd": ("pcd", dict(_PYTHON, pc_python_type="firedrake.PCDPC")),
    "assembled": ("poisson_matfree", dict(
        _PYTHON, pc_python_type="firedrake.AssembledPC")),
    "auxiliary": ("poisson", dict(_PYTHON, pc_python_type=None)),
    "vanka": ("stokes", {"pc_type": "vanka"}),
}


@pytest.mark.parametrize("case", sorted(PC_CASES))
def test_pc_application_matches_jax(case):
    kind, params = PC_CASES[case]
    out = []
    for fd in (J, T):
        prm = dict(params)
        if prm.get("pc_python_type", "") is None:
            prm["pc_python_type"] = _AUX[fd.__name__]
        ctx, n = _ctx(fd, kind)
        pc = _mod(fd, "solvers.composition").build_pc(ctx, prm)
        r = np.random.default_rng(3).standard_normal(n)
        out.append(_np(pc(jax.numpy.asarray(r) if fd is J
                          else torch.as_tensor(r))))
    assert np.isfinite(out[1]).all()
    _close(out[1], out[0], 1e-12)


# ------------------------------------------------------------------ Vanka
@pytest.fixture(scope="module")
def vanka_pair():
    """The JAX package's patches and host CSR (captured at its
    _batched_patch_pc) and the port's padded lists, on one operator."""
    seen = {}
    jp = _mod(J, "solvers.preconditioners")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jp, "_batched_patch_pc",
                   lambda Asp, patches: seen.update(Asp=Asp,
                                                    patches=patches))
        ctx, _ = _ctx(J, "stokes")
        jp.make_vanka_patch(ctx.mat, ctx.space)
    ctx, _ = _ctx(T, "stokes")
    idx, mask = _mod(T, "solvers.preconditioners").vanka_patches(
        ctx.mat, ctx.space, 1)
    return seen, ctx.mat, idx, mask


def test_vanka_patches_bit_for_bit(vanka_pair):
    seen, A, idx, mask = vanka_pair
    ours = [list(row[m > 0]) for row, m in zip(idx, mask)]
    assert ours == seen["patches"]
    # the structural pattern, explicit zeros included, is the JAX one's
    Asp, Bsp = A.to_scipy(), seen["Asp"]
    assert np.array_equal(Asp.indptr, Bsp.indptr)
    assert np.array_equal(Asp.indices, Bsp.indices)
    assert idx.shape == (A.W_test.subspaces[1].dim, 39)


def test_vanka_patch_matrices_and_k2(vanka_pair):
    seen, A, idx, mask = vanka_pair
    pre = _mod(T, "solvers.preconditioners")
    Ap = pre.patch_matrices(A, idx, mask)
    K = idx.shape[1]
    ref = np.zeros((len(seen["patches"]), K, K))
    for i, p in enumerate(seen["patches"]):
        ref[i] = np.eye(K)
        ref[i, :len(p), :len(p)] = seen["Asp"][np.ix_(p, p)].toarray()
    _close(Ap, ref, 1e-12)
    from firedrake_tpu.ops.batched_inverse import batched_inv as jinv
    from firedrake_tpu_torch.ops.batched_inverse import batched_inv
    _close(batched_inv(Ap), jinv(jax.numpy.asarray(ref)), 1e-12)


def test_vanka_needs_a_nonzero_leading_pivot():
    """With the pressure first (W = Q * V) the seed field is the velocity
    and each patch starts at a zero pivot: K2 does not pivot, so the port
    raises where the JAX package's host inverse returns no finite
    inverse."""
    mesh = T.UnitSquareMesh(2, 2)
    Q = T.FunctionSpace(mesh, "CG", 1)
    W = Q * T.VectorFunctionSpace(mesh, "CG", 2)
    p, u = T.TrialFunctions(W)
    q, v = T.TestFunctions(W)
    a = (T.inner(T.grad(u), T.grad(v)) - p * T.div(v) - q * T.div(u)) \
        * T.dx
    ctx = T.solvers.composition.OpCtx(mat=T.assemble(a), space=W)
    with pytest.raises(ArithmeticError, match="pivoting"):
        T.solvers.composition.build_pc(ctx, {"pc_type": "vanka"})


def test_patch_pc_sums_in_a_fixed_order():
    ctx, n = _ctx(T, "stokes")
    pc = T.solvers.composition.build_pc(ctx, {"pc_type": "vanka"})
    r = torch.as_tensor(np.random.default_rng(5).standard_normal(n))
    assert torch.equal(pc(r), pc(r))


@pytest.mark.parametrize("slots", ["star", "vanka", "crowded"])
def test_patch_plan_built_by_torch_is_the_host_plan(slots):
    """The patch PC's accumulation plan, sorted by torch where the patch
    lists lie, holds the host plan's (assemble._accumulation) tables entry
    for entry: vertex stars of P2, Vanka patches, and slots crowded past
    the tables' limit (the sorted reduction)."""
    asm = _mod(T, "assemble")
    pre = _mod(T, "solvers.preconditioners")
    if slots == "crowded":
        n = 5
        pos = np.random.default_rng(2).integers(0, n + 1, 300)
    else:
        if slots == "star":
            V = T.FunctionSpace(T.UnitSquareMesh(8, 8), "CG", 2)
            (idx, mask), n = pre.star_patches(V), V.dim
        else:
            ctx, n = _ctx(T, "stokes")
            idx, mask = pre.vanka_patches(ctx.mat, ctx.space, 1)
        pos = np.where(mask > 0, idx, n).reshape(-1)
    host = asm._accumulation(pos, n, torch.device("cpu"))
    ours = asm._accumulation_device(torch.as_tensor(pos), n)
    assert type(ours) is type(host)
    for name, want in vars(host).items():
        got = getattr(ours, name)
        assert (got is None and want is None) or (
            got.dtype == want.dtype and torch.equal(got, want)), name


def test_linear_solver_on_a_block_matrix():
    """solve(A, x, b) with an assembled BlockMatrix: the mixed test space
    and the appctx reach the PC (vanka; a Schur fieldsplit with MassInvPC
    and appctx["mu"]); the velocity within 1e-9 of the LU solve's."""
    p = _stokes(T)
    idx, g = _mod(T, "solving")._bc_data(p["bcs"], p["W"].dim)
    A0 = T.assemble(p["a"])
    b = -A0.matvec(torch.as_tensor(g))
    b[idx] = torch.as_tensor(g)[idx]
    A = A0.with_dirichlet(idx)
    ref = T.Function(p["W"])
    T.solve(p["a"] == p["L"], ref, bcs=p["bcs"], solver_parameters={
        "ksp_type": "preonly", "pc_type": "lu"})
    for sp in ({"ksp_type": "fgmres", "ksp_rtol": 1e-11,
                "pc_type": "vanka"},
               {"ksp_type": "fgmres", "ksp_rtol": 1e-11,
                "pc_type": "fieldsplit", "pc_fieldsplit_type": "schur",
                "fieldsplit_0_pc_type": "lu",
                "fieldsplit_1_pc_type": "python",
                "fieldsplit_1_pc_python_type": "firedrake.MassInvPC"}):
        x = T.Function(p["W"])
        T.solve(A, x, b, solver_parameters=sp, appctx={"mu": 0.5})
        # the pressure is defined up to a constant: the velocity is held
        _close(x.subfunctions[0].dat, ref.subfunctions[0].dat, 1e-9)


# ------------------------------------------------------------- the table
def test_substitutions_warn_once_per_type_and_prefix():
    comp = T.solvers.composition
    comp._warned_substitutions.clear()
    ctx, _ = _ctx(T, "poisson")
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        for pc_type in ("bjacobi", "sor", "ilu", "icc", "sor"):
            pc = comp.build_pc(ctx, {"pc_type": pc_type})
        comp.build_pc(ctx, {"sub_pc_type": "sor"}, "sub_")
    msgs = [str(w.message) for w in got if "ubstituting" in str(w.message)]
    assert len(msgs) == 5
    jac = comp.build_pc(ctx, {"pc_type": "jacobi"})
    r = torch.ones(ctx.dim, dtype=torch.float64)
    assert torch.equal(pc(r), jac(r))


def test_gamg_is_mg_and_refusals_name_their_item():
    comp = T.solvers.composition
    assert comp._PCS["gamg"] is comp._PCS["mg"]
    ctx, _ = _ctx(T, "poisson")
    with pytest.raises(NotImplementedError, match="hypre"):
        comp.build_pc(ctx, {"pc_type": "hypre"})
    # the multilevel and patch python PCs resolve to their modules'
    # classes (held to the JAX package in test_torch_multilevel.py)
    for name, mod in (("FDMPC", "fdm"), ("P1PC", "fdm"),
                      ("ASMLinesmoothPC", "asm"), ("ASMExtrudedStarPC", "asm"),
                      ("ASMGridLinePC", "asm"),
                      ("FacetSplitPC", "facet_split"),
                      ("CovariancePC", "pcs")):
        assert comp._resolve_python_pc(f"firedrake.{name}") is getattr(
            importlib.import_module(f"firedrake_tpu_torch.solvers.{mod}"),
            name)
    for name, item in (("HiptmairPC", 18), ("GTMGPC", 18)):
        with pytest.raises(NotImplementedError, match=f"item {item}\\b"):
            comp.build_pc(ctx, {"pc_type": "python",
                                "pc_python_type": f"firedrake.{name}"})
    with pytest.raises(NotImplementedError, match="NoSuchPC"):
        comp.build_pc(ctx, {"pc_type": "python",
                            "pc_python_type": "firedrake.NoSuchPC"})
    with pytest.raises(ImportError, match="cannot resolve"):
        comp.build_pc(ctx, {"pc_type": "python",
                            "pc_python_type": "no_such_module.APC"})
    # BDDC is a python PC, as in the JAX package, which has no pc_type
    # 'bddc' either: that refusal names item 18's PCs; the line smoother
    # needs an extruded mesh
    assert comp._resolve_python_pc("firedrake.BDDCPC") is \
        importlib.import_module("firedrake_tpu_torch.solvers.bddc").BDDCPC
    with pytest.raises(NotImplementedError, match="'bddc'.*item 18"):
        comp.build_pc(ctx, {"pc_type": "bddc"})
    with pytest.raises(ValueError, match="extruded mesh"):
        comp.build_pc(ctx, {"pc_type": "linesmooth"})


# ----------------------------------------------------------- whole solves
MG_SP = {"ksp_type": "fgmres", "ksp_rtol": 1e-8, "pc_type": "fieldsplit",
         "pc_fieldsplit_type": "schur",
         "pc_fieldsplit_schur_fact_type": "full",
         "fieldsplit_0_ksp_type": "preonly", "fieldsplit_0_pc_type": "mg",
         "fieldsplit_0_mg_levels_ksp_type": "chebyshev",
         "fieldsplit_0_mg_levels_ksp_max_it": 3,
         "fieldsplit_1_pc_type": "python",
         "fieldsplit_1_pc_python_type": "firedrake.MassInvPC"}
VANKA_SP = {"ksp_type": "fgmres", "ksp_rtol": 1e-8, "ksp_max_it": 500,
            "pc_type": "vanka"}
PCD_SP = {"snes_rtol": 1e-8, "snes_max_it": 30, "ksp_type": "fgmres",
          "ksp_rtol": 1e-8, "ksp_max_it": 400, "pc_type": "fieldsplit",
          "pc_fieldsplit_type": "schur",
          "pc_fieldsplit_schur_fact_type": "full",
          "fieldsplit_0_ksp_type": "preonly", "fieldsplit_0_pc_type": "lu",
          "fieldsplit_1_ksp_type": "gmres", "fieldsplit_1_ksp_rtol": 1e-4,
          "fieldsplit_1_ksp_max_it": 100, "fieldsplit_1_pc_type": "python",
          "fieldsplit_1_pc_python_type": "firedrake.PCDPC"}


def _stokes_solve(fd, params, mg):
    p = (_stokes(fd, mesh=fd.MeshHierarchy(fd.UnitSquareMesh(4, 4),
                                           2).meshes[-1])
         if mg else _stokes(fd, 6))
    w = fd.Function(p["W"])
    solver = fd.LinearVariationalSolver(
        fd.LinearVariationalProblem(p["a"], p["L"], w, bcs=p["bcs"]),
        solver_parameters=params)
    solver.solve()
    return _np(w.dat), solver.ksp_iterations, \
        fd.errornorm(p["uex"], w.subfunctions[0])


def _cavity(fd, n=8, Re=50.0):
    """test_solver_composition.py navier_stokes_cavity, through the
    solver object (its Newton history)."""
    mesh = fd.UnitSquareMesh(n, n)
    V = fd.VectorFunctionSpace(mesh, "CG", 2)
    Q = fd.FunctionSpace(mesh, "CG", 1)
    W = V * Q
    w = fd.Function(W)
    u, p = fd.split(w)
    v, q = fd.TestFunctions(W)
    F = ((1.0 / Re) * fd.inner(fd.grad(u), fd.grad(v))
         + fd.inner(fd.dot(u, fd.nabla_grad(u)), v)
         - p * fd.div(v) - q * fd.div(u)) * fd.dx
    X = fd.SpatialCoordinate(mesh)
    lid = fd.as_vector([1.0 + 0 * X[0], 0.0 * X[1]])
    bcs = [fd.DirichletBC(W.sub(0), fd.Function(V).interpolate(lid), 4),
           fd.DirichletBC(W.sub(0), fd.Constant([0.0, 0.0]), (1, 2, 3))]
    solver = fd.NonlinearVariationalSolver(
        fd.NonlinearVariationalProblem(F, w, bcs=bcs),
        solver_parameters=PCD_SP,
        appctx={"Re": Re, "state": w, "velocity_space": 0, "mu": 1 / Re})
    solver.solve()
    return w, solver


@pytest.fixture(scope="module", autouse=True)
def jax_solves(_cpu, vanka_pair):
    """The JAX package's three whole solves, started as the module's tests
    start (after vanka_pair, which patches the JAX package while it
    captures the patches) and compiled beside them."""
    solves = {
        "mg_in_fieldsplit": _BigStack(lambda: _stokes_solve(J, MG_SP, True)),
        "vanka": _BigStack(lambda: _stokes_solve(J, VANKA_SP, False)),
        "cavity": _BigStack(lambda: _cavity(J))}
    yield solves
    for s in solves.values():
        s.thread.join()


@pytest.fixture(scope="module", params=["mg_in_fieldsplit", "vanka"])
def stokes_pair(request, jax_solves):
    """One Stokes solve through each package: (solution, iterations,
    errornorm) of the JAX package's, then the port's."""
    params, mg = {"mg_in_fieldsplit": (MG_SP, True),
                  "vanka": (VANKA_SP, False)}[request.param]
    ref = jax_solves[request.param].result()
    return request.param, ref, _stokes_solve(T, params, mg)


def test_stokes_iterations_match_jax(stokes_pair):
    name, ref, ours = stokes_pair
    assert ours[1] == ref[1] == {"mg_in_fieldsplit": 30, "vanka": 50}[name]


def test_stokes_solutions_match_jax(stokes_pair):
    _, ref, ours = stokes_pair
    _close(ours[0], ref[0], 1e-7)
    assert ours[2] < 1e-6


@pytest.fixture(scope="module")
def cavity_pair(jax_solves):
    return jax_solves["cavity"].result(), _cavity(T)


def test_navier_stokes_pcd_newton_steps_match_jax(cavity_pair):
    (_, sj), (_, st) = cavity_pair
    assert st.snes_iterations == sj.snes_iterations == 4
    assert st.converged


def test_navier_stokes_pcd_flow_matches_jax(cavity_pair):
    (wj, _), (wt, _) = cavity_pair
    _close(wt.dat, wj.dat, 1e-8)
    ud = _np(wt.subfunctions[0].dat).reshape(-1, 2)
    assert 0.9 < np.abs(ud[:, 0]).max() < 1.3
    assert ud[:, 1].max() > 0.02
