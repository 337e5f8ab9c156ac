"""DG advection in the port against the JAX package: fml label algebra,
par_loop in every access mode, VertexBasedLimiter, demos/DG_advection.py
through both packages, and VTK output byte for byte.

Tolerances: float64 results within 1e-12 max|ref|; VTK files identical.
The periodic limiter cases are held to the analytic bounds [0, 1]: the
JAX package's
tests/acceptance/test_vertex_based_limiter.py::test_step_function_loop
[periodic-interval] and [periodic-square-tri] fail because that loop
limits the stage input D1 after its last stage, never the output D it
checks; the limiter itself keeps every value within its vertex bounds on
periodic meshes, as held here."""
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
import jax
import jax.numpy as jnp

import firedrake_tpu as J
import firedrake_tpu_torch as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(ours, ref, rtol=1e-12):
    ours, ref = _np(ours), _np(ref)
    assert np.shape(ours) == np.shape(ref)
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(ours - ref).max() <= rtol * scale, \
        np.abs(ours - ref).max() / scale


def run_demo(name, fd, subs=()):
    """Execute demos/<name>.py with ``fd``'s import line (the port's
    adds set_device("cpu")); returns the script's namespace."""
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


# ---------------------------------------------------------------- fml
def _fml_forms(fd):
    from importlib import import_module
    fml = import_module(fd.__name__ + ".fml")
    mesh = fd.UnitSquareMesh(3, 3)
    V = fd.FunctionSpace(mesh, "CG", 1)
    X = fd.SpatialCoordinate(mesh)
    u = fd.Function(V).interpolate(X[0] * X[1] + 1.0)
    v = fd.TestFunction(V)
    time_derivative = fml.Label("time_derivative")
    diffusion = fml.Label("diffusion")
    lf = (time_derivative(fml.subject(fd.inner(u, v) * fd.dx, u))
          + diffusion(fml.subject(fd.inner(fd.grad(u), fd.grad(v))
                                  * fd.dx, u)))
    only_diff = lf.label_map(lambda t: t.has_label(diffusion),
                             map_if_false=fml.drop)
    w = fd.Function(V).interpolate(X[0] - 2.0 * X[1])
    replaced = lf.label_map(fml.all_terms, fml.replace_subject(w))
    lab = fml.Label("foo", value=41)
    term = lab(fml.Term(fd.inner(u, v) * fd.dx), 42)
    removed = lab.remove(term)
    scaled = (2.0 * lf - only_diff).form
    return dict(
        counts=(len(lf.terms), len(only_diff.terms),
                len(lf.form.integrals()), term.get(lab),
                removed.has_label(lab), w in replaced.form.coefficients()),
        vectors=[fd.assemble(f).dat for f in
                 (lf.form, only_diff.form, replaced.form, scaled)])


def test_fml_label_algebra_matches_jax():
    ref, ours = _fml_forms(J), _fml_forms(T)
    assert ours["counts"] == ref["counts"] == (2, 1, 2, 42, False, True)
    for a, b in zip(ours["vectors"], ref["vectors"]):
        _close(a, b)


# ----------------------------------------------------------- par_loop
def _par_loop(fd, mode):
    """One par_loop in ``mode`` on UnitSquareMesh(4): P1 (shared dofs)
    and DG1 fields made from a seeded numpy draw."""
    xp = jnp if fd is J else torch
    mesh = fd.UnitSquareMesh(4, 4)
    P1 = fd.FunctionSpace(mesh, "CG", 1)
    rng = np.random.default_rng(3)
    r = fd.Function(P1, val=rng.standard_normal(P1.dim))
    g = fd.Function(P1, val=rng.standard_normal(P1.dim))
    acc = getattr(fd, mode)
    if mode == "READ":
        s = fd.Function(fd.FunctionSpace(mesh, "DG", 1))
        # the written DG1 field reads the shared P1 values
        fd.par_loop(lambda r, s: {"s": 3.0 * r - 1.0}, fd.dx,
                    {"r": (r, acc), "s": (s, fd.WRITE)})
        return s.dat
    if mode in ("WRITE", "RW"):
        # every cell writes the same value to a shared dof
        fd.par_loop(lambda g, r: {"g": 2.0 * r + (g if mode == "RW"
                                                  else 0.0)},
                    fd.dx, {"g": (g, acc), "r": (r, fd.READ)})
        return g.dat
    # INC/MIN/MAX: per-cell values differ, the reduction decides
    fd.par_loop(lambda g, r: {"g": xp.ones_like(r) * r.mean()
                              + xp.arange(3, dtype=r.dtype)},
                fd.dx, {"g": (g, acc), "r": (r, fd.READ)})
    return g.dat


@pytest.mark.parametrize("mode", ["READ", "WRITE", "RW", "INC", "MIN",
                                  "MAX"])
def test_par_loop_access_modes_match_jax(mode):
    _close(_par_loop(T, mode), _par_loop(J, mode))


def test_par_loop_inc_counts_valency():
    V = T.FunctionSpace(T.UnitSquareMesh(3, 3), "CG", 1)
    g = T.Function(V).assign(2.0)
    T.par_loop(lambda u: {"u": u * 2}, T.dx, {"u": (g, T.RW)})
    assert torch.all(g.dat == 4.0)
    h = T.Function(V)
    T.par_loop(lambda u, c: {"c": torch.ones_like(c)}, T.dx,
               {"u": (g, T.READ), "c": (h, T.INC)})
    valency = np.zeros(V.dim)
    np.add.at(valency, V.cell_dof_map.reshape(-1), 1.0)
    assert np.array_equal(h.dat.numpy(), valency)


# ------------------------------------------------------------ limiter
def _mesh(fd, name):
    return {"interval": lambda: fd.UnitIntervalMesh(12),
            "square-tri": lambda: fd.UnitSquareMesh(5, 5),
            "disk": lambda: fd.UnitDiskMesh(1),
            "cube-tet": lambda: fd.UnitCubeMesh(2, 2, 2),
            "periodic-interval": lambda: fd.PeriodicUnitIntervalMesh(30),
            "periodic-square-tri": lambda: fd.PeriodicUnitSquareMesh(8, 8),
            }[name]()


def _dg1(fd, mesh):
    el = fd.BrokenElement(
        mesh.coordinates.function_space().ufl_element().sub_elements[0])
    return fd.FunctionSpace(mesh, el)


def _limited(fd, name):
    mesh = _mesh(fd, name)
    V = _dg1(fd, mesh)
    X = fd.SpatialCoordinate(mesh)
    step = fd.Function(V).interpolate(fd.conditional(X[0] < 0.5, 1., 0.))
    rnd = fd.Function(V, val=np.random.default_rng(5).standard_normal(
        V.dim))
    lim = fd.VertexBasedLimiter(V)
    lim.apply(step)
    lim.apply(rnd)
    return step.dat, rnd.dat


@pytest.mark.parametrize("name", ["interval", "square-tri", "disk",
                                  "cube-tet"])
def test_limiter_matches_jax(name):
    for a, b in zip(_limited(T, name), _limited(J, name)):
        _close(a, b)


def _vertex_bounds(V, dat):
    """(lo, hi) per cell vertex: min/max of the adjacent cell means."""
    mesh = V.mesh_obj
    cv = mesh.topology.cell_vertices
    means = dat[V.cell_dof_map].mean(axis=1)
    hi = np.full(mesh.num_vertices, -np.inf)
    lo = np.full(mesh.num_vertices, np.inf)
    np.maximum.at(hi, cv.ravel(), np.repeat(means, cv.shape[1]))
    np.minimum.at(lo, cv.ravel(), np.repeat(means, cv.shape[1]))
    return lo[cv], hi[cv], means


@pytest.mark.parametrize("name", ["periodic-interval",
                                  "periodic-square-tri"])
def test_limiter_periodic_analytic_bounds(name):
    """On periodic meshes: a limited random field stays within its
    vertex bounds and keeps its cell means; a limited step function
    stays in [0, 1]; an SSPRK3 upwind loop that limits every stage
    output keeps the advected step in [0, 1] for a full period (the
    loop of the JAX package's failing test_step_function_loop, with
    the stage output limited)."""
    mesh = _mesh(T, name)
    V = _dg1(T, mesh)
    lim = T.VertexBasedLimiter(V)
    r = T.Function(V, val=np.random.default_rng(1).standard_normal(V.dim))
    lo, hi, means = _vertex_bounds(V, r.dat.numpy())
    lim.apply(r)
    lv = r.dat.numpy()[V.cell_dof_map]
    assert (lv <= hi + 1e-14).all() and (lv >= lo - 1e-14).all()
    assert np.abs(lv.mean(axis=1) - means).max() < 1e-14

    x = T.SpatialCoordinate(mesh)
    D = T.Function(V).interpolate(T.conditional(T.real(x[0]) < 0.5, 1., 0.))
    lim.apply(D)
    assert D.dat.min() >= 0.0 and D.dat.max() <= 1.0
    gdim = mesh.geometric_dimension
    u = T.Function(T.VectorFunctionSpace(mesh, "CG", 1)).interpolate(
        T.as_vector([1.0] + [0.0] * (gdim - 1)))
    steps = 30 if gdim == 1 else 16
    dt = 1.0 / steps
    phi, Dt = T.TestFunction(V), T.TrialFunction(V)
    n = T.FacetNormal(mesh)
    un = 0.5 * (T.dot(u, n) + abs(T.dot(u, n)))
    arhs = T.inner(Dt, phi) * T.dx - dt * (
        T.inner(-u * Dt, T.grad(phi)) * T.dx
        + T.inner(un('+') * Dt('+') - un('-') * Dt('-'), T.jump(phi))
        * T.dS)
    D1, dD1 = T.Function(V), T.Function(V)
    solver = T.LinearVariationalSolver(
        T.LinearVariationalProblem(T.inner(Dt, phi) * T.dx,
                                   T.action(arhs, D1), dD1),
        solver_parameters={"ksp_type": "cg", "ksp_rtol": 1e-12})
    mass0 = T.assemble(D * T.dx)
    for _ in range(steps):
        D1.assign(D)
        solver.solve()
        D1.assign(dD1)
        lim.apply(D1)
        solver.solve()
        D1.assign(0.75 * D + 0.25 * dD1)
        lim.apply(D1)
        solver.solve()
        D.assign((1.0 / 3.0) * D + (2.0 / 3.0) * dD1)
        lim.apply(D)
        assert D.dat.min() >= -1e-10 and D.dat.max() <= 1.0 + 1e-10
    assert abs(T.assemble(D * T.dx) - mass0) < 1e-10


# -------------------------------------------------------- the demo
def test_dg_advection_demo_matches_jax():
    ref = run_demo("DG_advection", J)
    ours = run_demo("DG_advection", T)
    _close(ours["q"].dat, ref["q"].dat)
    assert abs(ours["mass"] - ours["mass0"]) < 1e-10
    assert abs(ours["mass"] - ref["mass"]) < 1e-12
    assert ours["q"].dat.max() <= 1.0 + 1e-8


# ---------------------------------------------------------------- VTK
def _vtk_bytes(fd, tmp, family, degree, quad, name):
    mesh = fd.UnitSquareMesh(3, 3, quadrilateral=quad)
    V = fd.FunctionSpace(mesh, family, degree)
    f = fd.Function(V, name="u", val=np.random.default_rng(2)
                    .standard_normal(V.dim))
    out = fd.VTKFile(str(tmp / name / "out.pvd"))
    out.write(f, time=0.5)
    out.write(f)
    return [(tmp / name / f).read_bytes()
            for f in ("out.pvd", "out_0.vtu", "out_1.vtu")]


@pytest.mark.parametrize("family, degree, quad", [
    ("CG", 1, False), ("DG", 1, False), ("CG", 2, False), ("CG", 2, True),
    ("CG", 3, False)])
def test_vtk_output_byte_identical(tmp_path, family, degree, quad):
    """P1 and DG1 take the vertex writer, P2 triangles the quadratic
    cells, P2 quads and P3 the Lagrange lattices of io/vtk_lagrange.py."""
    assert (_vtk_bytes(T, tmp_path, family, degree, quad, "t")
            == _vtk_bytes(J, tmp_path, family, degree, quad, "j"))


def test_helmholtz_demo_vtk_write_runs(tmp_path):
    out = str(tmp_path / "helmholtz.pvd")
    ns = run_demo("helmholtz", T, [
        ("/tmp/helmholtz_out/helmholtz.pvd", out),
        ('if __name__ == "__main__":', "if True:")])
    assert ns["err"] < 0.003
    vtu = (tmp_path / "helmholtz_0.vtu").read_bytes()
    # the same values written by the JAX package's writer
    mesh = J.UnitSquareMesh(64, 64)
    uh = J.Function(J.FunctionSpace(mesh, "CG", 1), name="u",
                    val=ns["uh"].dat.numpy())
    J.VTKFile(str(tmp_path / "ref.pvd")).write(uh)
    assert vtu == (tmp_path / "ref_0.vtu").read_bytes()
