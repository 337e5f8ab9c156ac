"""The adjoint of the port (firedrake_tpu_torch.adjoint: the tape,
ReducedFunctional's gradient and Hessian action, minimize, the covariance
operators and CovariancePC, the L2-transformed and ensemble functionals)
against the JAX package and against itself.

Against the JAX package (five tapes and one covariance operator, computed
once in one big-stack thread started with the module, and single
assemblies): the source inversion's gradient at UnitSquareMesh(8), a
two-step heat loop's gradient (solve + assign, the initial condition as
the control), a Constant control's gradient, a Hessian action
(test_hessian_linear_exact's problem), the L2-transformed functional's
value and gradient on a CG control, AutoregressiveCovariance's action,
inverse, norm and seeded sample, StencilMatrix.transpose_matvec on a
non-symmetric operator, the Riesz maps and one white-noise sample.
Against the port itself: Taylor rates, the adjoint solve through the
forward solve's CG + GMG and through a PC that reads the solve's appctx,
an adjoint solve that does not converge, disk checkpointing, minimize,
covariance round trips, the transformed and ensemble functionals and
demos/poisson_inversion.py.

Tolerances: gradients, Hessian actions, Riesz maps and the covariance
operators within 1e-10 of max|ref| (f64); transpose_matvec within 1e-12
of max|ref|."""
import math
import os
import threading

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
import jax

import firedrake_tpu as J
import firedrake_tpu_torch as T
import firedrake_tpu.adjoint as JA
import firedrake_tpu_torch.adjoint as TA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-10

#: the JAX package's programs are compiled with XLA's optimisations off
NO_OPT = "jax_disable_most_optimizations"
ALPHA = 1e-6
TIGHT = {"ksp_rtol": 1e-12}


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    # two torch threads: six test workers share the host's cores
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


@pytest.fixture(autouse=True)
def _fresh_tape():
    # the port's tape only: the JAX package's is its thread's (below)
    TA.set_working_tape(TA.Tape())
    TA.pause_annotation()
    yield
    TA.set_working_tape(TA.Tape())
    TA.pause_annotation()


def _np(x):
    x = getattr(x, "dat", x)
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(ours, ref, rtol=RTOL):
    ours, ref = _np(ours), _np(ref)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max()
    assert err <= rtol * max(np.abs(ref).max(), 1e-300), err


def _pkg(fd):
    return JA if fd is J else TA


# --------------------------------------------------------------- problems
def _inversion(fd, n=8, params=None, mesh=None):
    """demos/poisson_inversion.py's functional at f = x y:
    J = 1/2 ||u(f) - u_obs||^2 + alpha/2 ||f||^2, -lap u = f, u = 0 on
    the boundary; taped on a fresh tape."""
    adj = _pkg(fd)
    mesh = mesh or fd.UnitSquareMesh(n, n)
    V = fd.FunctionSpace(mesh, "CG", 1)
    X = fd.SpatialCoordinate(mesh)
    bcs = [fd.DirichletBC(V, 0.0, "on_boundary")]
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    a = fd.inner(fd.grad(u), fd.grad(v)) * fd.dx
    f_true = fd.Function(V).interpolate(
        fd.sin(math.pi * X[0]) * fd.sin(2 * math.pi * X[1]))
    u_obs = fd.Function(V)
    fd.solve(a == f_true * v * fd.dx, u_obs, bcs=bcs,
             solver_parameters=params)
    f = fd.Function(V).interpolate(X[0] * X[1])
    tape = adj.set_working_tape(adj.Tape())
    adj.continue_annotation()
    w = fd.Function(V)
    fd.solve(a == f * v * fd.dx, w, bcs=bcs, solver_parameters=params)
    Jv = fd.assemble(0.5 * (w - u_obs) ** 2 * fd.dx
                     + 0.5 * ALPHA * f ** 2 * fd.dx)
    adj.pause_annotation()
    rf = adj.ReducedFunctional(Jv, adj.Control(f), tape=tape)
    h = fd.Function(V).interpolate(0.1 + X[0] * (1 - X[0]))
    return dict(V=V, f=f, J=Jv, rf=rf, h=h, tape=tape)


def _heat(fd, n=4, steps=2):
    """Backward Euler with solve(F == 0) and assign, as
    tests/adjoint/test_adjoint.py::test_time_dependent_adjoint; the
    initial condition is the control."""
    adj = _pkg(fd)
    mesh = fd.UnitSquareMesh(n, n)
    V = fd.FunctionSpace(mesh, "CG", 1)
    X = fd.SpatialCoordinate(mesh)
    dt = 0.05
    v = fd.TestFunction(V)
    bcs = [fd.DirichletBC(V, 0.0, "on_boundary")]
    u0 = fd.Function(V).interpolate(
        fd.sin(math.pi * X[0]) * fd.sin(math.pi * X[1]))
    adj.continue_annotation()
    u_prev = fd.Function(V)
    u_prev.assign(u0)
    u = fd.Function(V)
    for _ in range(steps):
        F = ((u - u_prev) / dt * v
             + fd.inner(fd.grad(u), fd.grad(v))) * fd.dx
        fd.solve(F == 0, u, bcs=bcs)
        u_prev.assign(u)
    Jv = fd.assemble(u * u * fd.dx)
    adj.pause_annotation()
    h = fd.Function(V).interpolate(
        0.1 * X[0] * (1 - X[0]) * X[1] * (1 - X[1]))
    return dict(u0=u0, rf=adj.ReducedFunctional(Jv, adj.Control(u0)),
                h=h)


def _constant_gradient(fd):
    """dJ/dc of J = ||u||^2, -lap u = c (test_constant_control_gradient
    at UnitSquareMesh(4))."""
    adj = _pkg(fd)
    V = fd.FunctionSpace(fd.UnitSquareMesh(4, 4), "CG", 1)
    v = fd.TestFunction(V)
    c = fd.Constant(2.0)
    adj.continue_annotation()
    u = fd.Function(V)
    fd.solve((fd.inner(fd.grad(u), fd.grad(v)) - c * v) * fd.dx == 0, u,
             bcs=[fd.DirichletBC(V, 0.0, "on_boundary")])
    Jv = fd.assemble(u * u * fd.dx)
    adj.pause_annotation()
    return np.array([float(Jv),
                     float(adj.ReducedFunctional(Jv, adj.Control(c))
                           .derivative())])


def _hessian(fd):
    """tests/adjoint/test_hessian.py::test_hessian_linear_exact's Hessian
    action: -lap u = m at UnitSquareMesh(5), J = 1/2 ||u - d||^2."""
    adj = _pkg(fd)
    mesh = fd.UnitSquareMesh(5, 5)
    V = fd.FunctionSpace(mesh, "CG", 1)
    X = fd.SpatialCoordinate(mesh)
    m = fd.Function(V).interpolate(X[0] * X[1] + 1.0)
    u = fd.Function(V)
    v = fd.TestFunction(V)
    d = fd.Function(V).interpolate(
        fd.sin(math.pi * X[0]) * fd.sin(math.pi * X[1]))
    adj.continue_annotation()
    fd.solve((fd.inner(fd.grad(u), fd.grad(v)) - fd.inner(m, v)) * fd.dx
             == 0, u, bcs=[fd.DirichletBC(V, 0.0, "on_boundary")],
             solver_parameters={"ksp_rtol": 1e-13, "snes_rtol": 1e-13,
                                "snes_atol": 1e-14})
    Jv = fd.assemble(0.5 * fd.inner(u - d, u - d) * fd.dx)
    adj.pause_annotation()
    h = fd.Function(V).interpolate(0.3 + X[0] * (1 - X[0]) * X[1])
    return V, h, adj.ReducedFunctional(Jv, adj.Control(m)).hessian(h)


#: tests/adjoint/test_covariance.py's operator
COVARIANCE = dict(L=0.2, sigma=1.3, m=4, seed=3)


def _covariance(fd):
    """B's action and inverse on x = sin(0.37 i), x^T B^-1 x by norm(),
    and the first seeded sample, at UnitSquareMesh(6) P1."""
    V = fd.FunctionSpace(fd.UnitSquareMesh(6, 6), "CG", 1)
    B = _pkg(fd).AutoregressiveCovariance(V, **COVARIANCE)
    x = fd.Function(V, val=np.sin(np.arange(V.dim) * 0.37))
    return dict(action=_np(B.apply_action(x)),
                inverse=_np(B.apply_inverse(x)),
                norm=np.array([B.norm(x)]), sample=_np(B.sample()))


def _transformed(fd, family):
    """L2TransformedFunctional of J = 1/2 ||m - d||^2 on a `family` P1
    control over DG1 at UnitSquareMesh(4): J~ and its gradient at the
    transformed initial guess plus a seeded direction (a fresh tape)."""
    adj = _pkg(fd)
    mesh = fd.UnitSquareMesh(4, 4)
    X = fd.SpatialCoordinate(mesh)
    V = fd.FunctionSpace(mesh, family, 1)
    D = fd.FunctionSpace(mesh, "DG", 1)
    d = fd.Function(V).interpolate(X[0] + X[1] ** 2)
    m = fd.Function(V).interpolate(X[0] * X[1])
    adj.set_working_tape(adj.Tape())
    adj.continue_annotation()
    Jv = fd.assemble(0.5 * fd.inner(m - d, m - d) * fd.dx)
    adj.pause_annotation()
    tf = adj.L2TransformedFunctional(
        Jv, adj.Control(m), space_D=None if family == "DG" else D)
    h = np.random.default_rng(5).standard_normal(D.dim)
    mt = fd.Function(D, val=_np(tf.controls[0]) + 0.1 * h)
    return dict(tf=tf, d=d, m=m, D=D, J0=float(Jv),
                value=np.array([tf(mt)]), gradient=_np(tf.derivative()))


def _jax_task(task):
    if task == "inversion":
        p = _inversion(J)
        return np.concatenate([[float(p["J"])], _np(p["rf"].derivative())])
    if task == "heat":
        return _np(_heat(J)["rf"].derivative())
    if task == "constant":
        return _constant_gradient(J)
    if task == "hessian":
        return _np(_hessian(J)[2])
    if task == "covariance":
        return _covariance(J)
    out = _transformed(J, "CG")
    return {k: out[k] for k in ("value", "gradient")}


#: the JAX package's tapes, in the order the tests below read them; one
#: thread runs them all (the JAX package's annotation switch and working
#: tape are module state, so its tapes cannot be recorded side by side)
JAX_TASKS = ("inversion", "heat", "constant", "hessian", "transformed")
#: the JAX package's results that record no tape, in a thread of their own
JAX_UNTAPED = ("covariance",)


class _Tasks(threading.Thread):
    """The JAX package's results, computed in one thread started with the
    module's tests, with a big stack (XLA:CPU's compiler recurses deeply,
    as tests/conftest.py says of the main thread); ``get(task)`` waits
    for that task."""

    def __init__(self, tasks):
        super().__init__()
        self.tasks, self.out = tasks, {}
        self.done = threading.Condition()
        old = threading.stack_size(512 * 1024 * 1024)
        try:
            self.start()
        finally:
            threading.stack_size(old)

    def run(self):
        try:
            for task in self.tasks:
                if task not in JAX_UNTAPED:
                    JA.set_working_tape(JA.Tape())
                    JA.pause_annotation()
                out = _jax_task(task)
                with self.done:
                    self.out[task] = out
                    self.done.notify_all()
        finally:
            with self.done:
                self.tasks = ()
                self.done.notify_all()

    def get(self, task):
        with self.done:
            self.done.wait_for(lambda: task in self.out
                               or task not in self.tasks)
        assert task in self.out, f"{task} raised (see the thread's traceback)"
        return self.out[task]


@pytest.fixture(scope="module", autouse=True)
def jax_refs(_cpu):
    """jax_refs(task) -> the JAX package's result (waits for it)."""
    runs = {task: run for run in (_Tasks(JAX_TASKS), _Tasks(JAX_UNTAPED))
            for task in run.tasks}
    yield lambda task: runs[task].get(task)
    for run in set(runs.values()):
        run.join()


# ------------------------------------------------------ against the port
def test_taylor_rates():
    """Gradient Taylor remainders of order 2 on the inversion and on the
    heat loop, and order 3 with the Hessian action."""
    p = _inversion(T, params=TIGHT)
    assert TA.taylor_test(p["rf"], p["f"], p["h"]) > 1.9
    Hh = p["rf"].hessian(p["h"])
    assert TA.taylor_test(p["rf"], p["f"], p["h"], Hm=Hh, eps0=1.0) > 2.7
    q = _heat(T)
    assert TA.taylor_test(q["rf"], q["u0"], q["h"]) > 1.9


_GMG = {"ksp_type": "cg", "pc_type": "mg", "ksp_rtol": 1e-12}


def test_adjoint_solve_uses_the_forward_solver_parameters():
    """With CG + GMG given to the forward solve, the adjoint and
    second-order solves run CG + GMG too (a handful of iterations, where
    CG + Jacobi takes dozens) and give the direct solve's gradient and
    Hessian action within the solver's tolerance."""
    from firedrake_tpu_torch import solving
    mesh = T.MeshHierarchy(T.UnitSquareMesh(4, 4), 2)[-1]
    p = _inversion(T, params=_GMG, mesh=mesh)
    runs, run_ksp = [], solving._run_ksp

    def logged(*a, **kw):
        runs.append(run_ksp(*a, **kw))
        return runs[-1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(solving, "_run_ksp", logged)
        g = p["rf"].derivative()
        Hh = p["rf"].hessian(p["h"])
    # one adjoint solve, then the tangent, adjoint and second-order ones;
    # CG + Jacobi takes ~50 iterations to rtol 1e-12 on this 289-dof grid
    assert len(runs) == 4
    assert all(r.converged and r.iterations <= 15 for r in runs)
    lu = _inversion(T, params={"ksp_type": "preonly", "pc_type": "lu"},
                    mesh=mesh)
    _close(g, lu["rf"].derivative(), 1e-9)
    _close(Hh, lu["rf"].hessian(lu["h"]), 1e-9)


class AppctxLaplacePC(T.AuxiliaryOperatorPC):
    """kappa grad.grad with kappa read from the solve's appctx, the
    operator's own Dirichlet rows (LU inside): raises without appctx."""

    def form(self, pc, test, trial):
        kappa = self.get_appctx(pc)["kappa"]
        return (kappa * T.inner(T.grad(trial), T.grad(test)) * T.dx,
                self._ctx.bcs)


def test_adjoint_solve_and_replay_get_the_forward_appctx():
    """A forward solve whose PC reads appctx: the adjoint and
    second-order solves and the replay build that PC with the same
    appctx (one CG iteration each: the PC is the operator's inverse) and
    give the direct solve's gradient, Hessian action and J."""
    from firedrake_tpu_torch import solving
    sp = {"ksp_type": "cg", "ksp_rtol": 1e-12, "pc_type": "python",
          "pc_python_type": f"{__name__}.AppctxLaplacePC"}
    mesh = T.UnitSquareMesh(6, 6)
    V = T.FunctionSpace(mesh, "CG", 1)
    X = T.SpatialCoordinate(mesh)
    kappa = T.Constant(1.0)
    bcs = [T.DirichletBC(V, 0.0, "on_boundary")]
    u, v = T.TrialFunction(V), T.TestFunction(V)
    a = kappa * T.inner(T.grad(u), T.grad(v)) * T.dx
    d = T.Function(V).interpolate(T.sin(math.pi * X[0]) * X[1])
    out = {}
    lu = {"ksp_type": "preonly", "pc_type": "lu"}
    for name, params, ctx in (("python", sp, {"kappa": kappa}),
                              ("lu", lu, None)):
        f = T.Function(V).interpolate(X[0] * X[1])
        tape = TA.set_working_tape(TA.Tape())
        TA.continue_annotation()
        w = T.Function(V)
        T.solve(a == f * v * T.dx, w, bcs=bcs, solver_parameters=params,
                appctx=ctx)
        Jv = T.assemble(0.5 * (w - d) ** 2 * T.dx)
        TA.pause_annotation()
        rf = TA.ReducedFunctional(Jv, TA.Control(f), tape=tape)
        runs, run_ksp = [], solving._run_ksp

        def logged(*a, **kw):
            runs.append(run_ksp(*a, **kw))
            return runs[-1]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(solving, "_run_ksp", logged)
            out[name] = (_np(rf.derivative()).copy(),
                         _np(rf.hessian(d)).copy(),
                         rf(T.Function(V).interpolate(X[0] + X[1])))
        out[name + "_runs"] = runs
    # the adjoint, tangent, adjoint and second-order solves, the replay
    assert len(out["python_runs"]) == 5 and not out["lu_runs"]
    assert all(r.converged and r.iterations == 1
               for r in out["python_runs"])
    for ours, ref in zip(out["python"], out["lu"]):
        _close(np.atleast_1d(ours), np.atleast_1d(ref))


def test_unconverged_adjoint_solve_raises(monkeypatch):
    """An adjoint solve that does not converge raises, naming its
    iterations: under the forward solve's parameters, and under the JAX
    package's default Krylov solve (above DIRECT_ROWS rows; lowered here
    so that a small problem takes that path)."""
    starved = {"ksp_type": "cg", "pc_type": "none", "ksp_max_it": 2,
               "ksp_rtol": 1e-12}
    with pytest.warns(UserWarning, match="did not converge"):
        p = _inversion(T, params=starved)
    with pytest.raises(RuntimeError, match="did not converge: 2 iter"):
        p["rf"].derivative()
    tape = __import__("firedrake_tpu_torch.adjoint.tape",
                      fromlist=["x"])
    monkeypatch.setattr(tape, "DIRECT_ROWS", 0)
    monkeypatch.setattr(tape, "DEFAULT_ADJOINT_KSP",
                        dict(tape.DEFAULT_ADJOINT_KSP, ksp_max_it=3,
                             ksp_gmres_restart=3))
    p = _inversion(T)
    with pytest.raises(RuntimeError, match="gmres.*3 iterations"):
        p["rf"].derivative()


def test_disk_checkpointing_gives_the_same_gradient(tmp_path):
    """tests/adjoint/test_hessian.py::test_disk_checkpointing_gradient:
    four steps, snapshots in device memory and on disk."""
    def run():
        q = _heat(T, steps=4)
        return _np(q["rf"].derivative()).copy()

    g_ram = run()
    tape = TA.set_working_tape(TA.Tape())
    snapdir = tape.enable_disk_checkpointing(str(tmp_path / "tape"))
    g_disk = run()
    assert len(os.listdir(snapdir)) > 0
    assert np.abs(g_ram - g_disk).max() < 1e-14


def test_minimize_with_bounds():
    """min 1/2 ||m - d||^2 with m <= 1/2 clips d (L-BFGS-B on the host,
    the functional and gradient replayed by the port)."""
    V = T.FunctionSpace(T.UnitSquareMesh(4, 4), "CG", 1)
    X = T.SpatialCoordinate(V.mesh())
    d = T.Function(V).interpolate(X[0])
    m = T.Function(V)
    TA.continue_annotation()
    Jv = T.assemble(0.5 * T.inner(m - d, m - d) * T.dx)
    TA.pause_annotation()
    rf = TA.ReducedFunctional(Jv, TA.Control(m))
    ub = T.Function(V).assign(0.5)
    mopt = TA.minimize(rf, method="L-BFGS-B", bounds=(None, ub), tol=1e-12)
    expect = np.minimum(_np(d), 0.5)
    assert np.abs(_np(mopt) - expect).max() < 1e-4
    assert mopt._opt_result.success


@pytest.fixture(scope="module")
def cov(_cpu):
    V = T.FunctionSpace(T.UnitSquareMesh(6, 6), "CG", 1)
    return V, TA.AutoregressiveCovariance(V, **COVARIANCE)


def test_covariance_round_trip_and_norm(cov):
    V, B = cov
    x = T.Function(V, val=np.sin(np.arange(V.dim) * 0.37))
    y = B.apply_action(B.apply_inverse(x))
    assert np.abs(_np(y) - _np(x)).max() < 1e-7
    direct = float(_np(x) @ _np(B.apply_inverse(x)))
    assert abs(B.norm(x) - direct) / abs(direct) < 1e-8


def test_covariance_pc_converges_in_three(cov):
    """CG on B y = r preconditioned by CovariancePC (which applies
    B^-1), by name through the options table."""
    from firedrake_tpu_torch.solvers.composition import OpCtx, build_ksp
    V, B = cov
    mat = TA.CovarianceMat(B, TA.CovarianceMat.ACTION)
    solve = build_ksp(OpCtx(mat=mat, space=V),
                      {"ksp_type": "cg", "ksp_rtol": 1e-10,
                       "pc_type": "python",
                       "pc_python_type": "firedrake.CovariancePC"})
    r = torch.as_tensor(np.sin(np.arange(V.dim) * 0.11))
    res = solve._full(r)
    assert res.converged and res.iterations <= 3
    assert np.abs(_np(res.x) - _np(B.apply_inverse(r))).max() < 1e-6


def test_l2_transformed_functional():
    """On a DG control the transformed gradient is C^-1 M (m - d) =
    C^T (m - d); on a CG control the value is J's and the gradient (the
    projection's adjoint through the gather Matrix's transpose_matvec)
    matches a central difference of the quadratic J~."""
    for family in ("DG", "CG"):
        p = _transformed(T, family)
        tf, mt = p["tf"], p["tf"].controls[0]
        # at the initial guess: J at the control's recorded value
        _close(np.array([tf(mt)]), np.array([p["J0"]]))
        g = _np(tf.derivative())
        if family == "DG":
            _close(g, tf._chol.C_T(p["m"].dat - p["d"].dat))
            continue
        h = np.random.default_rng(0).standard_normal(p["D"].dim)
        eps = 1e-3
        fd_ = (tf(mt.dat + eps * torch.as_tensor(h))
               - tf(mt.dat - eps * torch.as_tensor(h))) / (2 * eps)
        assert abs(fd_ - g @ h) <= 1e-8 * abs(fd_)


def test_ensemble_reduced_functional_weighted_sum():
    V = T.FunctionSpace(T.UnitSquareMesh(3, 3), "CG", 1)
    X = T.SpatialCoordinate(V.mesh())
    m = T.Function(V).interpolate(1.0 + X[1])
    rfs = []
    for i in range(2):
        tape = TA.set_working_tape(TA.Tape())
        u, v = T.Function(V), T.TestFunction(V)
        d = T.Function(V).interpolate(T.sin(X[0] + 0.5 * i) * X[1])
        TA.continue_annotation()
        T.solve((T.inner(T.grad(u), T.grad(v)) + T.inner(u, v)
                 - T.inner(m, v)) * T.dx == 0, u,
                solver_parameters={"ksp_rtol": 1e-13})
        Jv = T.assemble(0.5 * T.inner(u - d, u - d) * T.dx)
        TA.pause_annotation()
        rfs.append(TA.ReducedFunctional(Jv, TA.Control(m), tape=tape))
    erf = TA.EnsembleReducedFunctional(rfs, ensemble=object(),
                                       scale=[0.25, 0.75])
    assert abs(erf(m) - (0.25 * rfs[0](m) + 0.75 * rfs[1](m))) < 1e-14
    gsum = (0.25 * _np(rfs[0].derivative())
            + 0.75 * _np(rfs[1].derivative()))
    assert np.abs(_np(erf.derivative()) - gsum).max() < 1e-13


def test_adjoint_module_is_callable():
    """After `import firedrake_tpu_torch.adjoint`, T.adjoint is that
    module and still the form adjoint when called."""
    assert T.adjoint is TA
    V, a = _advection(T, 1)
    y = torch.as_tensor(np.random.default_rng(7).standard_normal(V.dim))
    via_module = T.assemble(T.adjoint(a)).matvec(y)
    via_calculus = T.assemble(
        T.language.calculus.adjoint(a)).matvec(y)
    assert torch.equal(via_module, via_calculus)


def test_poisson_inversion_demo_runs_through_the_port(capsys):
    """demos/poisson_inversion.py with only its import lines swapped (and
    the CPU asked for): its own assertion holds."""
    src = open(os.path.join(ROOT, "demos", "poisson_inversion.py")).read()
    swapped = src.replace(
        "from firedrake_tpu import *",
        "from firedrake_tpu_torch import *\nset_device('cpu')").replace(
        "from firedrake_tpu.adjoint import",
        "from firedrake_tpu_torch.adjoint import")
    assert swapped.count("firedrake_tpu_torch") == 2
    exec(compile(swapped, "poisson_inversion.py", "exec"), {})
    assert "source inversion converging" in capsys.readouterr().out


# ------------------------------------------------- against the JAX package
def test_inversion_gradient_matches_jax(jax_refs):
    """The demo's functional and gradient at UnitSquareMesh(8): no solver
    parameters, so both packages solve the adjoint system by host LU."""
    p = _inversion(T)
    ref = jax_refs("inversion")
    g = p["rf"].derivative()
    assert isinstance(g, T.Cofunction)
    _close(np.array([float(p["J"])]), ref[:1])
    _close(g, ref[1:])


def test_time_loop_gradient_matches_jax(jax_refs):
    """Two backward-Euler steps (SolveBlock + AssignBlock) at
    UnitSquareMesh(4): each step's snapshot restored in the sweep."""
    _close(_heat(T)["rf"].derivative(), jax_refs("heat"))


def test_constant_control_matches_jax(jax_refs):
    _close(_constant_gradient(T), jax_refs("constant"))


def test_hessian_action_matches_jax_and_dense(jax_refs):
    """The Hessian action (TLM sweep, then the first- and second-order
    reverse sweeps) against the JAX package and, as in
    test_hessian_linear_exact, against H = (A^-1 M)^T M (A^-1 M)."""
    V, h, Hh = _hessian(T)
    _close(Hh, jax_refs("hessian"))
    u, v = T.TrialFunction(V), T.TestFunction(V)
    bc = T.DirichletBC(V, 0.0, "on_boundary")
    A = T.assemble(T.inner(T.grad(u), T.grad(v)) * T.dx, bcs=[bc]).to_dense()
    M = T.assemble(T.inner(u, v) * T.dx).to_dense()
    Mbc = M.copy()
    Mbc[bc.dof_indices, :] = 0.0
    Tm = np.linalg.solve(A, Mbc)
    _close(Hh, Tm.T @ (M @ (Tm @ _np(h))))


def _advection(fd, degree):
    """A non-symmetric operator on the stencil route: diffusion plus
    advection by a constant wind, with a Dirichlet row set."""
    mesh = fd.UnitSquareMesh(5, 4)
    V = fd.FunctionSpace(mesh, "CG", degree)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    b = fd.Constant((1.0, -0.7))
    a = (0.1 * fd.inner(fd.grad(u), fd.grad(v))
         + fd.inner(b, fd.grad(u)) * v + 0.3 * u * v) * fd.dx
    return V, a


@pytest.mark.parametrize("degree", [1, 2])
def test_stencil_transpose_matvec_matches_jax(degree):
    y = np.random.default_rng(degree).standard_normal(
        _advection(J, degree)[0].dim)
    out = {}
    for fd in (J, T):
        V, a = _advection(fd, degree)
        A = fd.assemble(a)
        assert type(A).__name__ == "StencilMatrix"
        yt = (jax.numpy.asarray(y) if fd is J else torch.as_tensor(y))
        out[fd] = (_np(A.transpose_matvec(yt)),
                   _np(fd.assemble(fd.adjoint(a)).matvec(yt)),
                   A.to_dense())
    tm, adj_mv, dense = out[T]
    _close(tm, out[J][0], 1e-12)
    _close(tm, dense.T @ y, 1e-12)
    _close(adj_mv, tm, 1e-12)
    assert np.abs(dense - dense.T).max() > 0.1      # really non-symmetric


@pytest.mark.parametrize("riesz", ["l2", "L2", "H1"])
def test_riesz_representation_matches_jax(riesz):
    """Function -> Cofunction applies the Gram matrix; Cofunction ->
    Function solves with it (host LU in both packages)."""
    out = {}
    for fd in (J, T):
        V = fd.FunctionSpace(fd.UnitSquareMesh(4, 3), "CG", 2)
        X = fd.SpatialCoordinate(V.mesh())
        f = fd.Function(V).interpolate(fd.sin(3 * X[0]) + X[1] ** 2)
        c = fd.Cofunction(V)
        c.dat = f.dat
        dual, primal = (f.riesz_representation(riesz),
                        c.riesz_representation(riesz))
        assert isinstance(dual, fd.Cofunction)
        assert not isinstance(primal, fd.Cofunction)
        out[fd] = (_np(dual), _np(primal))
    for ours, ref in zip(out[T], out[J]):
        _close(ours, ref)


def test_covariance_matches_jax(jax_refs):
    """AutoregressiveCovariance (m = 4): B x, B^-1 x, x^T B^-1 x and one
    seeded sample against the JAX package (every solve CG + Jacobi to
    rtol 1e-12 in both)."""
    ours, ref = _covariance(T), jax_refs("covariance")
    for key in ("action", "inverse", "norm", "sample"):
        _close(ours[key], ref[key])


def test_l2_transformed_functional_matches_jax(jax_refs):
    """J~ and its transformed gradient on a CG control (the L2 projection
    from DG1, its adjoint and the per-cell Cholesky factors)."""
    ours, ref = _transformed(T, "CG"), jax_refs("transformed")
    _close(ours["value"], ref["value"])
    _close(ours["gradient"], ref["gradient"])


def test_white_noise_sample_matches_jax():
    """One seeded sample: the same normal draws, summed by the gather
    plan here and scatter-added in the JAX package."""
    out = []
    for fd, adj in ((J, JA), (T, TA)):
        V = fd.FunctionSpace(fd.UnitSquareMesh(5, 4), "CG", 2)
        out.append(_np(adj.WhiteNoiseGenerator(V, seed=42).sample()))
    _close(out[1], out[0], 1e-12)
