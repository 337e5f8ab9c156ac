"""Extruded meshes in the port: column numbering, the column plan
(assembly/columns.py) and its ``ColumnMatrix``, prism facet integrals by
facet class, variable-layer (ragged) meshes, extruded and semi-coarsened
hierarchies with GMG over column-plan levels, Slate on prisms, and
demos/extruded_shallow_water.py, against the JAX package (the cases of
tests/extrusion/).

Tolerances: host tables (dof maps, column layouts) bit for bit; float64
results within 1e-12 max|ref| of the JAX package or of the port's own
gather route (FDTPU_NO_COLUMN=1); iteration counts equal.  Q3 on
extruded quads is column-numbered in the port and not in the JAX package
(its vertical match misses the GLL nodes): there the port's matrix is
held to the JAX package's through the port's node permutation."""
import os
import re

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
import jax

import firedrake_tpu as J
import firedrake_tpu_torch as T
from firedrake_tpu_torch.assembly.columns import ColumnMatrix
from firedrake_tpu_torch.assemble import FormAssembler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
    if hasattr(x, "dat"):
        return _np(x.dat)
    return np.asarray(x)


def _close(ours, ref, rtol=1e-12):
    ours, ref = _np(ours), _np(ref)
    assert np.shape(ours) == np.shape(ref)
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(ours - ref).max() <= rtol * scale, \
        np.abs(ours - ref).max() / scale


def _mesh(fd, kind, n=2, nlay=3):
    if kind == "quad":
        return fd.ExtrudedMesh(fd.UnitIntervalMesh(n), nlay)
    if kind == "hex":
        return fd.ExtrudedMesh(fd.UnitSquareMesh(n, n, quadrilateral=True),
                               nlay)
    return fd.ExtrudedMesh(fd.UnitSquareMesh(n, n), nlay)


def _column_forms(fd, kind, deg):
    """tests/extrusion/test_column_path.py's forms."""
    m = _mesh(fd, kind)
    V = fd.FunctionSpace(m, "CG", deg)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    X = fd.SpatialCoordinate(m)
    d = m.geometric_dimension
    f = fd.Function(V).interpolate(X[0] + X[d - 1] ** 2)
    a = (fd.inner(fd.grad(u), fd.grad(v)) + f * fd.inner(u, v)) * fd.dx
    return V, a, f * v * fd.dx


def _no_column(fn):
    os.environ["FDTPU_NO_COLUMN"] = "1"
    try:
        return fn()
    finally:
        del os.environ["FDTPU_NO_COLUMN"]


COLUMN_CASES = [("quad", 1), ("quad", 2), ("quad", 3), ("hex", 1),
                ("hex", 2), ("prism", 1), ("prism", 2)]
#: the cases held to the JAX package's operator as well (each JAX program
#: compiles for ~1-2 s; degree 1 on quads and prisms is held to the
#: port's gather route alone)
JAX_COLUMN_CASES = [("quad", 2), ("quad", 3), ("hex", 1), ("hex", 2),
                    ("prism", 2)]


@pytest.fixture(scope="module")
def jax_columns():
    """The JAX package's numbering of each column case and, for
    JAX_COLUMN_CASES, its operator as a host array in its own numbering
    (one program per case, built once; the vectors are held to the port's
    gather route, which other files hold to the JAX package)."""
    out = {}
    for kind, deg in COLUMN_CASES:
        V, a, _ = _column_forms(J, kind, deg)
        out[kind, deg] = (V.sdata.column_numbered,
                          np.asarray(V.cell_node_map),
                          J.assemble(a).to_scipy().toarray()
                          if (kind, deg) in JAX_COLUMN_CASES else None)
    return out


# --------------------------------------------------------- numbering
@pytest.mark.parametrize("kind,deg", COLUMN_CASES)
def test_column_numbering_matches_jax(kind, deg, jax_columns):
    """Where the JAX package column-numbers a space, the port's cell node
    map and column layout are the same arrays; Q3 on quads (GLL nodes)
    is column-numbered in the port alone, and its numbering is the JAX
    package's through the port's node permutation."""
    V = T.FunctionSpace(_mesh(T, kind), "CG", deg)
    jnum, jmap, _ = jax_columns[kind, deg]
    col = V.sdata.column
    assert V.sdata.column_numbered and col.Hd == deg * 3 + 1
    assert V.num_nodes == col.nbase * col.Hd
    nlay = 3
    c = np.arange(V.cell_node_map.shape[0])
    pred = (col.base_map[c // nlay][:, col.sb] * col.Hd
            + (c % nlay)[:, None] * col.kz + col.sz[None, :])
    assert np.array_equal(V.cell_node_map.astype(np.int64), pred)
    if jnum:
        assert np.array_equal(V.cell_node_map, jmap)
        Vj = J.FunctionSpace(_mesh(J, kind), "CG", deg)
        cj = Vj.sdata.column
        assert np.array_equal(col.sb, cj.sb)
        assert np.array_equal(col.sz, cj.sz)
    else:
        assert (kind, deg) == ("quad", 3)
        assert np.array_equal(V.sdata.node_perm[jmap], V.cell_node_map)


# --------------------------------------------------------- column plan
@pytest.mark.parametrize("kind,deg", COLUMN_CASES)
def test_column_plan_matches_gather_and_jax(kind, deg, jax_columns):
    """The column plan's ColumnMatrix and vector against the port's gather
    route (FDTPU_NO_COLUMN=1) and the JAX package; matvec, transpose,
    diagonal and the dense forms against scipy."""
    V, a, L = _column_forms(T, kind, deg)
    assert FormAssembler(a)._column is not None
    A, b = T.assemble(a), T.assemble(L)
    assert isinstance(A, ColumnMatrix)
    A0, b0 = _no_column(lambda: (T.assemble(a), T.assemble(L)))
    assert not isinstance(A0, ColumnMatrix)
    S = A0.to_scipy()
    _close(A.to_scipy().toarray(), S.toarray())
    _close(b, b0)
    jnum, _, Aj = jax_columns[kind, deg]
    # the JAX package's numbering: the port's, or (Q3 on quads, not
    # column-numbered there) the generic one the port permuted
    p = np.arange(V.dim) if jnum else V.sdata.node_perm
    if Aj is not None:
        _close(A.to_scipy().toarray()[np.ix_(p, p)], Aj)
    x = np.random.default_rng(7).standard_normal(V.dim)
    xt = torch.as_tensor(x)
    _close(A.matvec(xt), S @ x)
    _close(A.transpose_matvec(xt), S.T @ x)
    _close(A.diagonal(), S.diagonal())
    _close(A.to_dense_device(), A.to_dense(), rtol=0)
    assert A.nnz >= S.nnz


def test_column_bcs_and_solve_hex():
    """Dirichlet rows on a ColumnMatrix (``with_dirichlet``) on the
    extruded markers ("top", "bottom", a base id) against the gather
    route, and a CG + Jacobi solve that reproduces a linear field
    exactly."""
    m = _mesh(T, "hex", 3, 3)
    V = T.FunctionSpace(m, "CG", 1)
    X = T.SpatialCoordinate(m)
    g = T.Function(V).interpolate(1 + X[0] + 2 * X[2])
    u, v = T.TrialFunction(V), T.TestFunction(V)
    a = T.inner(T.grad(u), T.grad(v)) * T.dx
    bcs = [T.DirichletBC(V, 0.0, "top"), T.DirichletBC(V, 0.0, "bottom"),
           T.DirichletBC(V, 0.0, 1)]
    _close(T.assemble(a, bcs=bcs).to_scipy().toarray(),
           _no_column(lambda: T.assemble(a, bcs=bcs)).to_scipy().toarray())
    bc = T.DirichletBC(V, g, "on_boundary")
    A = T.assemble(T.inner(T.grad(u), T.grad(v)) * T.dx, bcs=[bc])
    assert isinstance(A, ColumnMatrix)
    A0 = _no_column(lambda: T.assemble(
        T.inner(T.grad(u), T.grad(v)) * T.dx, bcs=[bc]))
    _close(A.to_scipy().toarray(), A0.to_scipy().toarray())
    uh = T.Function(V)
    T.solve(T.inner(T.grad(u), T.grad(v)) * T.dx
            == T.inner(T.Constant(0.0), v) * T.dx, uh, bcs=[bc],
            solver_parameters={"ksp_type": "cg", "pc_type": "jacobi",
                               "ksp_rtol": 1e-12})
    assert T.errornorm(1 + X[0] + 2 * X[2], uh) < 1e-9


# --------------------------------------------------------- prism facets
def _prism_facet_values(fd):
    m = fd.ExtrudedMesh(fd.UnitSquareMesh(3, 3), 3)
    V = fd.FunctionSpace(m, "CG", 2)
    x, y, z = fd.SpatialCoordinate(m)
    f = fd.Function(V).interpolate(x + y * z)
    g = fd.Function(V).interpolate(x * z + y ** 2)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    one = fd.Function(fd.FunctionSpace(m, "DG", 0)).assign(2.0)
    scalars = [fd.assemble(f * fd.ds_v + g * fd.ds_t),
               fd.assemble(fd.jump(g) * fd.avg(f) * fd.dS
                           + fd.avg(one) * fd.dS)]
    return (np.array(scalars, dtype=float),
            _np(fd.assemble(f * fd.inner(u, v) * fd.ds)),
            _np(fd.assemble(fd.inner(fd.jump(u), fd.jump(v)) * fd.dS
                            + fd.avg(f) * fd.inner(fd.avg(u), fd.avg(v))
                            * fd.dS)))


def test_prism_facet_integrals_both_classes():
    """ds (triangle caps and quad sides), ds_b/ds_t/ds_v and dS on a
    prism mesh: 0- and 2-forms against the JAX package, each facet class
    compiled apart; exact boundary integrals of x."""
    ours, ref = _prism_facet_values(T), _prism_facet_values(J)
    for o, r in zip(ours, ref):
        _close(o, r)
    # exact values: int x ds over the unit prism column, caps and sides
    m = T.ExtrudedMesh(T.UnitSquareMesh(3, 3), 3)
    X = T.SpatialCoordinate(m)
    xf = T.Function(T.FunctionSpace(m, "CG", 1)).interpolate(X[0])
    for M, want in ((T.ds, 3.0), (T.ds_b, 0.5), (T.ds_t, 0.5),
                    (T.ds_v, 2.0)):
        assert abs(T.assemble(xf * M) - want) < 1e-12


def test_only_uniform_extrusion():
    """Another extrusion_type raises (the JAX package ignores it and
    extrudes uniformly)."""
    with pytest.raises(NotImplementedError, match="uniform"):
        T.ExtrudedMesh(T.UnitIntervalMesh(2), 2, extrusion_type="radial")
    J.ExtrudedMesh(J.UnitIntervalMesh(2), 2, extrusion_type="radial")


# --------------------------------------------------------- ragged columns
def _ragged(fd):
    base = fd.UnitSquareMesh(2, 2)
    layers = np.array([[0, 2], [1, 2], [0, 3], [0, 1], [1, 1], [0, 2],
                       [2, 1], [0, 3]])
    m = fd.ExtrudedMesh(base, layers, layer_height=0.25)
    V = fd.FunctionSpace(m, "CG", 1)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    X = fd.SpatialCoordinate(m)
    f = fd.Function(V).interpolate(1 + X[0] * X[2])
    return (V, _np(fd.assemble((fd.inner(fd.grad(u), fd.grad(v))
                                + f * u * v) * fd.dx)),
            _np(fd.assemble(f * v * fd.dx + f * v * fd.ds)),
            fd.assemble(f * fd.dx))


def test_variable_layer_mesh():
    """Ragged columns take the gather route (no column numbering) and
    agree with the JAX package."""
    V, A, b, s = _ragged(T)
    Vj, Aj, bj, sj = _ragged(J)
    assert not V.sdata.column_numbered
    assert np.array_equal(V.cell_node_map, Vj.cell_node_map)
    _close(A, Aj)
    _close(b, bj)
    assert abs(s - sj) <= 1e-12 * abs(sj)


# --------------------------------------------------------- hierarchies
@pytest.mark.parametrize("semi", [False, True])
def test_extruded_hierarchy_transfers_exact(semi):
    """Prolong is exact on linears across extruded (horizontal and
    vertical) and semi-coarsened (vertical) levels, inject recovers the
    coarse field, restrict is prolong's transpose; the prolonged values
    equal the JAX package's."""
    def build(fd):
        if semi:
            h = fd.SemiCoarsenedExtrudedHierarchy(fd.UnitSquareMesh(2, 2),
                                                  nref=2, base_layer=1)
        else:
            h = fd.ExtrudedMeshHierarchy(
                fd.MeshHierarchy(fd.UnitSquareMesh(2, 2), 1), height=1.0,
                base_layer=2)
        Vc = fd.FunctionSpace(h[-2], "CG", 1)
        Vf = fd.FunctionSpace(h[-1], "CG", 1)
        Xc = fd.SpatialCoordinate(h[-2])
        fc = fd.Function(Vc).interpolate(1 + 2 * Xc[0] - Xc[1] + 3 * Xc[2])
        ff = fd.Function(Vf)
        fd.prolong(fc, ff)
        return h, Vc, Vf, fc, ff

    h, Vc, Vf, fc, ff = build(T)
    hj, _, _, _, ffj = build(J)
    assert [m._layers for m in h] == [m._layers for m in hj]
    Xf = T.SpatialCoordinate(h[-1])
    assert T.errornorm(1 + 2 * Xf[0] - Xf[1] + 3 * Xf[2], ff) < 1e-12
    _close(ff, ffj)
    fc2 = T.Function(Vc)
    T.inject(ff, fc2)
    _close(fc2, fc, rtol=1e-15)
    from firedrake_tpu_torch.mg.transfer import get_transfer
    t = get_transfer(Vc, Vf)
    rng = np.random.default_rng(0)
    xc = torch.as_tensor(rng.standard_normal(Vc.dim))
    yf = torch.as_tensor(rng.standard_normal(Vf.dim))
    lhs = float(torch.dot(t.prolong_fn(xc), yf))
    rhs = float(torch.dot(xc, t.restrict_fn(yf)))
    assert abs(lhs - rhs) < 1e-12 * abs(lhs)


def _gmg(fd):
    """tests/extrusion/test_extruded_hierarchy.py's GMG solve on a
    two-level extruded hex hierarchy."""
    bh = fd.MeshHierarchy(fd.UnitSquareMesh(2, 2, quadrilateral=True), 1)
    m = fd.ExtrudedMeshHierarchy(bh, height=1.0, base_layer=2)[-1]
    V = fd.FunctionSpace(m, "CG", 1)
    X = fd.SpatialCoordinate(m)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    lap = -2 * (X[1] * (1 - X[1]) * X[2] * (1 - X[2])
                + X[0] * (1 - X[0]) * X[2] * (1 - X[2])
                + X[0] * (1 - X[0]) * X[1] * (1 - X[1]))
    f = fd.Function(V).interpolate(-lap)
    uh = fd.Function(V)
    solver = fd.LinearVariationalSolver(
        fd.LinearVariationalProblem(
            fd.inner(fd.grad(u), fd.grad(v)) * fd.dx, fd.inner(f, v) * fd.dx,
            uh, bcs=[fd.DirichletBC(V, 0.0, "on_boundary")]),
        solver_parameters={"ksp_type": "cg", "pc_type": "mg",
                           "ksp_rtol": 1e-10})
    solver.solve()
    return solver, uh


def test_gmg_on_extruded_hex_hierarchy():
    """CG + GMG over column-plan levels (every level a ColumnMatrix):
    the iterations equal the JAX package's, the solution within 1e-10."""
    solver, uh = _gmg(T)
    sj, uj = _gmg(J)
    assert solver.ksp_iterations == sj.ksp_iterations
    _close(uh, uj, rtol=1e-10)
    levels = [lv["A"] for lv in solver._gmg.levels]
    assert len(levels) == 2
    assert all(isinstance(A, ColumnMatrix) for A in levels)


# --------------------------------------------------------- slate on prisms
def _slate_local(fd, mesh):
    """Slate's localised two-sided BDM x DG0 coupling over dS (both facet
    classes): the per-cell tensors."""
    from importlib import import_module
    S = import_module(fd.__name__ + ".slate")
    V = fd.FunctionSpace(mesh, "CG", 1)
    W = fd.FunctionSpace(mesh, fd.HDiv(fd.TensorProductElement(
        fd.FiniteElement("BDM", "triangle", 1),
        fd.FiniteElement("DG", "interval", 0))))
    n = fd.FacetNormal(mesh)
    form = fd.avg(fd.TestFunction(V)) * fd.jump(fd.TrialFunction(W), n) \
        * fd.dS
    return V, W, form, _np(S._eval_local(S.Tensor(form, axes=[V, W]),
                                         {}).cell)


def test_slate_prism_facets():
    """tests/extrusion/test_prism_slate_facets.py's cases: the localised
    coupling against the JAX package's and, scattered, against the port's
    global assembly; Slate's cell + ds operator against the global one;
    a rank-0 dS functional twice the global one (each facet visited from
    both cells)."""
    mesh = T.ExtrudedMesh(T.UnitSquareMesh(2, 2), 2, layer_height=0.5)
    V, W, form, loc = _slate_local(T, mesh)
    _close(loc, _slate_local(J, J.ExtrudedMesh(J.UnitSquareMesh(2, 2), 2,
                                               layer_height=0.5))[3])
    # H(div)-conforming: the global coupling is round-off, and the
    # scattered one-sided tensors cancel to the same
    M = np.zeros((V.dim, W.dim))
    rows, cols = V.cell_dof_map, W.cell_dof_map
    for c in range(mesh.num_cells):
        M[np.ix_(rows[c], cols[c])] += loc[c]
    assert np.abs(M - _np(T.assemble(form))).max() \
        <= 1e-12 * np.abs(loc).max()
    u, v = T.TrialFunction(V), T.TestFunction(V)
    a = T.inner(u, v) * T.dx + T.inner(u, v) * T.ds
    _close(T.assemble_slate(T.Tensor(a)), T.assemble(a))
    X = T.SpatialCoordinate(mesh)
    f = T.Function(V).interpolate(1 + X[0] + X[1] * X[2])
    val = T.assemble_slate(T.Tensor(T.avg(f) * T.dS))
    assert abs(val - 2.0 * T.assemble(T.avg(f) * T.dS)) <= 1e-12 * val


# --------------------------------------------------------- the demo
def _demo_source(fd_name, power, layers, steps):
    with open(os.path.join(ROOT, "demos", "extruded_shallow_water.py")) as f:
        src = f.read()
    src = src.replace("from firedrake_tpu import *",
                      f"from {fd_name} import *")
    src = re.sub(r"^power = 3", f"power = {power}", src, flags=re.M)
    src = re.sub(r"^layers = 3", f"layers = {layers}", src, flags=re.M)
    src = src.replace("T = 0.25", f"T = {steps} * 0.0125")
    return src


def test_shallow_water_demo():
    """demos/extruded_shallow_water.py through the port with its import
    line changed: the demo's own energy assertion on its mesh, over 4 of
    its 20 steps; and two Strang steps on UnitSquareMesh(2) x 2 layers
    held to the JAX package (energies and p within 1e-12)."""
    ns = {}
    exec(compile(_demo_source("firedrake_tpu_torch", 3, 3, 4),
                 "extruded_shallow_water.py", "exec"), ns)
    assert ns["drift"] < 0.02 and ns["p_plot"].dat.device.type == "cpu"
    small = {}
    for name in ("firedrake_tpu_torch", "firedrake_tpu"):
        small[name] = {}
        exec(compile(_demo_source(name, 1, 2, 2),
                     "extruded_shallow_water.py", "exec"), small[name])
    t, j = small["firedrake_tpu_torch"], small["firedrake_tpu"]
    assert abs(t["E1"] - j["E1"]) <= 1e-12 * abs(j["E1"])
    _close(t["p_0"], j["p_0"])
    _close(t["p_plot"], j["p_plot"], rtol=1e-10)
