"""Hybridization (pc_type hybridization) in the port against the JAX
package: one RT1 x DG0 solve, the hybrid system it condenses (broken
RT1 x DG0 x HDiv Trace 0) through Slate's one-sided facet localisation,
and demos/hybridized_poisson.py (RT2 x DG1), all on UnitSquareMesh(16),
each run once through each package in a module-scoped fixture shared by
the asserts.  A JAX hybridized solve costs ~20 s of compilation on the
CPU; the JAX package's three runs go side by side in threads started
with the module (~24 s for the three against ~43 s one after another).  The source term of the RT1
case is the JAX package's, carried into the port by interop, as are a
trace and a broken Function; the JAX solution is carried back into a
port MixedFunction.

Tolerances: the solutions within 1e-10 max|ref| of the JAX package's and
of the port's monolithic LU; local tensors within 1e-12; the demo's L2
error within 1e-10 of the JAX demo's."""
import math
import os
import threading
from importlib import import_module

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
import jax

import firedrake_tpu as J
import firedrake_tpu_torch as T
from firedrake_tpu import slate as JS
from firedrake_tpu_torch import slate as TS
from firedrake_tpu_torch.interop import load_reference_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the demo's mesh, UnitSquareMesh(N), for every case
N = 16
LU = {"ksp_type": "preonly", "pc_type": "lu"}
HYB = {"ksp_type": "preonly", "pc_type": "hybridization",
       "hybridization": {"ksp_type": "preonly"}}


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


def _elements(fd):
    return import_module(fd.__name__ + ".elements")


def _np(x):
    if torch.is_tensor(x):
        return x.numpy()
    if hasattr(x, "to_scipy"):
        return x.to_scipy().toarray()
    if hasattr(x, "dat"):
        return _np(x.dat)
    return np.asarray(x)


def _close(ours, ref, rtol):
    ours, ref = _np(ours), _np(ref)
    assert np.shape(ours) == np.shape(ref)
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(ours - ref).max() <= rtol * scale, \
        np.abs(ours - ref).max() / scale


def _rt1(fd, n=N):
    mesh = fd.UnitSquareMesh(n, n)
    W = fd.FunctionSpace(mesh, "RT", 1) * fd.FunctionSpace(mesh, "DG", 0)
    sigma, u = fd.TrialFunctions(W)
    tau, v = fd.TestFunctions(W)
    f = fd.Function(W.subspaces[1])
    a = (fd.dot(sigma, tau) - u * fd.div(tau) - fd.div(sigma) * v) * fd.dx
    return W, f, a, -fd.inner(f, v) * fd.dx


def _jax_rt1():
    Wj, fj, aj, Lj = _rt1(J)
    X = J.SpatialCoordinate(Wj.mesh())
    fj.interpolate(2 * math.pi ** 2 * J.sin(math.pi * X[0])
                   * J.sin(math.pi * X[1]))
    wj = J.Function(Wj)
    J.solve(aj == Lj, wj, solver_parameters=HYB)
    return Wj, fj, wj


def _jax_hybrid():
    """The JAX package's hybrid system with seeded trace and broken
    Functions, and the local tensors of every expression, evaluated
    with one shared cache."""
    pj = _hybrid_system(J)
    rng = np.random.default_rng(3)
    pj["lam"].dat = rng.standard_normal(pj["Tr"].dim)
    pj["sig"].dat = rng.standard_normal(pj["Sb"].dim)
    cache = {}
    return pj, {k: JS._eval_local(e, cache).cell
                for k, e in pj["exprs"].items()}


@pytest.fixture(scope="module", autouse=True)
def jax_runs(_cpu):
    """jax_runs(name) -> the JAX package's side of a fixture below (waits
    for it); each runs in a big-stack thread started with the module
    (XLA:CPU's compiler recurses deeply, as tests/conftest.py says of the
    main thread)."""
    tasks = {"rt1": _jax_rt1, "hybrid": _jax_hybrid,
             "demo": lambda: run_demo(J)}
    out = {}

    def run(name):
        out[name] = tasks[name]()
    old = threading.stack_size(512 * 1024 * 1024)
    try:
        threads = {name: threading.Thread(target=run, args=(name,))
                   for name in tasks}
        for t in threads.values():
            t.start()
    finally:
        threading.stack_size(old)

    def get(name):
        threads[name].join()
        assert name in out, f"{name} raised (see its thread's traceback)"
        return out[name]
    yield get
    for t in threads.values():
        t.join()


@pytest.fixture(scope="module")
def rt1_pair(jax_runs):
    Wj, fj, wj = jax_runs("rt1")
    Wt, ft, at, Lt = _rt1(T)
    load_reference_state({ft: np.asarray(fj.dat)},
                         cell_node_maps={Wt.subspaces[1]:
                                         Wj.subspaces[1].cell_node_map})
    wt = T.Function(Wt)
    T.solve(at == Lt, wt, solver_parameters=HYB)
    return dict(Wj=Wj, wj=wj, Wt=Wt, wt=wt, a=at, L=Lt)


def test_hybridized_rt1_matches_jax(rt1_pair):
    for i in (0, 1):
        _close(rt1_pair["wt"].subfunctions[i].dat,
               rt1_pair["wj"].subfunctions[i].dat, 1e-10)


def test_hybridized_rt1_matches_port_lu(rt1_pair):
    w = T.Function(rt1_pair["Wt"])
    T.solve(rt1_pair["a"] == rt1_pair["L"], w, solver_parameters=LU)
    _close(rt1_pair["wt"].dat, w.dat, 1e-10)


def test_interop_carries_the_mixed_solution(rt1_pair):
    """The JAX package's solution on W = RT1 x DG0, numbering checked
    space by space, loaded into a port MixedFunction."""
    w = T.Function(rt1_pair["Wt"])
    Wj = rt1_pair["Wj"]
    load_reference_state(
        {w: np.asarray(rt1_pair["wj"].dat)},
        cell_node_maps={rt1_pair["Wt"]: [V.cell_node_map
                                         for V in Wj.subspaces]})
    for p, q in zip(w.subfunctions, rt1_pair["wj"].subfunctions):
        assert np.array_equal(_np(p.dat), np.asarray(q.dat))
    _close(w.dat, rt1_pair["wt"].dat, 1e-10)
    with pytest.raises(ValueError, match="4 maps for the 2 subspaces"):
        load_reference_state({}, cell_node_maps={
            rt1_pair["Wt"]: [V.cell_node_map for V in Wj.subspaces] * 2})


# ------------------------------------------- the hybrid system's condensation
def _hybrid_system(fd, n=N):
    """Broken RT1 x DG0 x Trace0 on UnitSquareMesh(n) (the JAX
    test_slate_static_condensation_matches_monolithic), with a Function on
    the trace and one on the broken flux space: the system the RT1
    solve above condenses."""
    el = _elements(fd)
    mesh = fd.UnitSquareMesh(n, n)
    Sb = fd.FunctionSpace(mesh, el.BrokenElement(
        el.make_scalar_element("triangle", "RT", 1)))
    V = fd.FunctionSpace(mesh, "DG", 0)
    Tr = fd.FunctionSpace(mesh, "HDiv Trace", 0)
    W = fd.MixedFunctionSpace([Sb, V, Tr])
    sigma, u, lam = fd.TrialFunctions(W)
    tau, v, mu = fd.TestFunctions(W)
    X = fd.SpatialCoordinate(mesh)
    nrm = fd.FacetNormal(mesh)
    f = fd.Function(V).interpolate(
        2 * math.pi ** 2 * fd.sin(math.pi * X[0]) * fd.sin(math.pi * X[1]))
    a = ((fd.dot(sigma, tau) - u * fd.div(tau) - fd.div(sigma) * v) * fd.dx
         + fd.inner(lam("+"), fd.jump(tau, nrm)) * fd.dS
         + fd.inner(lam, fd.dot(tau, nrm)) * fd.ds
         + fd.inner(mu("+"), fd.jump(sigma, nrm)) * fd.dS
         + fd.inner(mu, fd.dot(sigma, nrm)) * fd.ds)
    L = -fd.inner(f, v) * fd.dx
    A, F = fd.Tensor(a), fd.Tensor(L)
    lam_f, sig_f = fd.Function(Tr), fd.Function(Sb)
    exprs = {
        "A": A,
        "S": A.blocks[2, 2] - A.blocks[2, :2] * A.blocks[:2, :2].inv
        * A.blocks[:2, 2],
        "E": -(A.blocks[2, :2] * A.blocks[:2, :2].inv * F.blocks[:2]),
        # K^T lam and the flux mass on a broken function
        "K^T lam": A.blocks[0, 2] * fd.AssembledVector(lam_f),
        "M sigma": A.blocks[0, 0] * fd.AssembledVector(sig_f)}
    return dict(W=W, Tr=Tr, Sb=Sb, a=a, L=L, lam=lam_f, sig=sig_f,
                exprs=exprs, bc=fd.DirichletBC(Tr, 0.0, "on_boundary"))


@pytest.fixture(scope="module")
def hybrid_pair(jax_runs):
    """Both packages' hybrid systems, the trace and broken Functions of
    the JAX package carried into the port by interop, and the JAX local
    tensors of every expression (_jax_hybrid)."""
    pj, ref = jax_runs("hybrid")
    pt = _hybrid_system(T)
    load_reference_state(
        {pt[k]: np.asarray(pj[k].dat) for k in ("lam", "sig")},
        cell_node_maps={pt["Tr"]: pj["Tr"].cell_node_map,
                        pt["Sb"]: pj["Sb"].cell_node_map})
    return pt, ref


@pytest.mark.parametrize("name", ["A", "S", "E", "K^T lam", "M sigma"])
def test_hybrid_local_tensors_match_jax(hybrid_pair, name):
    """The packed three-field local tensor, its condensation S = A22 -
    A2:2 A:2:2^-1 A:22 and E through Slate's one-sided facet
    localisation, and contractions with the carried Functions."""
    pt, ref = hybrid_pair
    _close(TS._eval_local(pt["exprs"][name], {}).cell, ref[name], 1e-12)


def test_hybrid_condensation_matches_monolithic(hybrid_pair):
    """The condensed trace solve equals the port's monolithic LU of the
    three-field system."""
    pt = hybrid_pair[0]
    S = T.assemble_slate(pt["exprs"]["S"], bcs=[pt["bc"]])
    rhs = _np(T.assemble_slate(pt["exprs"]["E"])).copy()
    rhs[pt["bc"].nodes] = 0.0
    lam = np.linalg.solve(_np(S), rhs)
    w = T.Function(pt["W"])
    T.solve(pt["a"] == pt["L"], w,
            bcs=[T.DirichletBC(pt["W"].sub(2), 0.0, "on_boundary")],
            solver_parameters=LU)
    _close(lam, w.subfunctions[2].dat, 1e-10)


def run_demo(fd):
    """Execute demos/hybridized_poisson.py with ``fd``'s import line (the
    port's adds set_device("cpu")); its own assert err < 5e-3 holds or
    this raises."""
    path = os.path.join(ROOT, "demos", "hybridized_poisson.py")
    src = open(path).read()
    if fd is T:
        line = "from firedrake_tpu import *"
        assert line in src
        src = src.replace(line, "from firedrake_tpu_torch import *\n"
                                "set_device('cpu')")
    ns = {"__name__": "demo"}
    exec(compile(src, path, "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def demo_pair(jax_runs):
    return jax_runs("demo"), run_demo(T)


def test_hybridized_demo_error_matches_jax(demo_pair):
    ref, ours = demo_pair
    assert ours["err"] < 5e-3
    assert abs(ours["err"] - ref["err"]) <= 1e-10 * ref["err"]


def test_hybridized_demo_solution_matches_jax(demo_pair):
    ref, ours = demo_pair
    assert ours["u_h"].dat.device.type == "cpu"
    for name in ("sigma_h", "u_h"):
        _close(ours[name].dat, ref[name].dat, 1e-10)
