"""Tensor-product cells in the port: the HDiv prism element and the ufl
spec API (elements/tensor_product.py), HDiv(BDM1 x DG0) spaces and forms
on prisms, the sum-factorised Q_k plan (compiler/spectral.py) and quad
and hex hierarchies, against the JAX package (the cases of
tests/unit/test_spectral.py and tests/extrusion/).

Tolerances: host tables (element tabulations, signs, dof maps) bit for
bit; float64 results within 1e-12 max|ref| of the JAX package or of the
port's direct lowerer (FDTPU_SPECTRAL=0)."""
import os
from importlib import import_module

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
import jax

import firedrake_tpu as J
import firedrake_tpu_torch as T

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


def _tp(fd):
    return import_module(fd.__name__ + ".elements.tensor_product")


# --------------------------------------------------------- the element
@pytest.mark.parametrize("fam,deg,vdeg", [("RT", 1, 0), ("BDM", 1, 0),
                                          ("BDM", 1, 1)])
def test_hdiv_prism_tables_bit_for_bit(fam, deg, vdeg):
    """HDivPrism's tabulation (values and gradients), dual quadrature,
    entity dofs, facet signs under every quad orientation, and the sign
    of each stored facet order: the JAX package's arrays."""
    e, ej = (_tp(fd).HDivPrism(fam, deg, vdegree=vdeg) for fd in (T, J))
    assert (e.ndof, e.family) == (ej.ndof, ej.family)
    pts = np.random.default_rng(1).random((7, 3)) * [0.5, 0.5, 1.0]
    for k, t in e.tabulate(pts, 1).items():
        assert np.array_equal(t, ej.tabulate(pts, 1)[k])
    for a, b in zip(e.dual_quadrature(), ej.dual_quadrature()):
        assert np.array_equal(a, b)
    assert e.entity_dofs == ej.entity_dofs
    for lf in range(5):
        assert e.local_facet_sign(lf) == ej.local_facet_sign(lf)
        for o in range(24):
            assert np.array_equal(e.facet_dof_signs(o, entity=lf),
                                  ej.facet_dof_signs(o, entity=lf))


def test_spec_api_resolves_as_jax():
    """FiniteElement, EnrichedElement (MINI), TensorProductElement and
    HDiv resolve to the JAX package's elements; unsupported products raise
    NotImplementedError in both."""
    p2, p2j = (fd.FiniteElement("CG", "triangle", 2).resolve()
               for fd in (T, J))
    assert (p2.family, p2.ndof) == (p2j.family, p2j.ndof)
    assert np.array_equal(p2.nodes, p2j.nodes)
    mini, minij = ((fd.FiniteElement("CG", "triangle", 1)
                    + fd.FiniteElement("B", "triangle", 3)).resolve()
                   for fd in (T, J))
    assert mini.family == minij.family
    pts = np.random.default_rng(2).random((5, 2)) * 0.5
    for k, t in mini.tabulate(pts, 1).items():
        assert np.array_equal(t, minij.tabulate(pts, 1)[k])
    assert repr(T.EnrichedElement(T.FiniteElement("CG", "triangle", 1),
                                  T.FiniteElement("B", "triangle", 3))) \
        == repr(J.EnrichedElement(J.FiniteElement("CG", "triangle", 1),
                                  J.FiniteElement("B", "triangle", 3)))
    for fd in (T, J):
        with pytest.raises(NotImplementedError):
            fd.HDiv(fd.TensorProductElement(
                fd.FiniteElement("CG", "triangle", 1),
                fd.FiniteElement("DG", "interval", 0)))


# --------------------------------------------------------- HDiv on prisms
def _hdiv_prism(fd):
    mesh = fd.ExtrudedMesh(fd.UnitSquareMesh(2, 2), 2)
    W = fd.FunctionSpace(mesh, fd.HDiv(fd.TensorProductElement(
        fd.FiniteElement("BDM", "triangle", 1),
        fd.FiniteElement("DG", "interval", 0))))
    X = fd.FunctionSpace(mesh, "DG", 0, vfamily="DG", vdegree=0)
    u, w = fd.TrialFunction(W), fd.TestFunction(W)
    x, y, z = fd.SpatialCoordinate(mesh)
    p = fd.Function(X).interpolate(fd.sin(4 * x) * fd.cos(2 * y) + z)
    return (W, _np(fd.assemble(fd.dot(w, u) * fd.dx)),
            _np(fd.assemble(fd.div(w) * fd.TrialFunction(X) * fd.dx)),
            _np(fd.assemble(fd.dot(w, fd.as_vector([y, -x, 0]))
                            * fd.dx + fd.div(w) * p * fd.dx)))


def test_hdiv_prism_space_and_forms():
    """HDiv(BDM1 x DG0) on prisms: the dof map and the dof signs bit for
    bit; the mass matrix, the div block and a vector with a Piola-mapped
    source within 1e-12 of the JAX package."""
    W, M, D, b = _hdiv_prism(T)
    Wj, Mj, Dj, bj = _hdiv_prism(J)
    assert W.dim == Wj.dim
    assert np.array_equal(W.cell_dof_map, Wj.cell_dof_map)
    assert np.array_equal(W.cell_dof_signs, np.asarray(Wj.cell_dof_signs))
    _close(M, Mj)
    _close(D, Dj)
    _close(b, bj)


# --------------------------------------------------------- spectral plan
def _perturbed(fd, hexa, scale=0.08, seed=3):
    mesh = (fd.UnitCubeMesh(2, 2, 2, hexahedral=True) if hexa
            else fd.UnitSquareMesh(4, 4, quadrilateral=True))
    rng = np.random.default_rng(seed)
    g = mesh.geometric_dimension
    xy = _np(mesh.coordinates.dat).reshape(-1, g).copy()
    inner = np.all((xy > 1e-9) & (xy < 1 - 1e-9), axis=1)
    xy[inner] += (rng.random(xy[inner].shape) - 0.5) * scale
    mesh.coordinates.dat = xy.reshape(-1)
    return mesh


def _spectral_forms(fd, mesh, deg):
    V = fd.FunctionSpace(mesh, "CG", deg)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    X = fd.SpatialCoordinate(mesh)
    c = fd.Function(fd.FunctionSpace(mesh, "CG", 1)).interpolate(
        1.0 + X[0] * X[1])
    a = (c * fd.inner(fd.grad(u), fd.grad(v)) + u * v) * fd.dx
    return a, fd.sin(X[0]) * v * fd.dx


def _assemble(fd, form, spectral):
    """The gather route, with FDTPU_SPECTRAL set to ``spectral``."""
    keep = {k: os.environ.get(k) for k in ("FDTPU_SPECTRAL",
                                           "FDTPU_NO_STENCIL")}
    os.environ.update(FDTPU_SPECTRAL=spectral, FDTPU_NO_STENCIL="1")
    try:
        if fd is J:
            J.assemble.__globals__["_assembler_cache"].clear()
        return _np(fd.assemble(form))
    finally:
        for k, v in keep.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


SPECTRAL_CASES = [(False, 2), (False, 3), (True, 2), (True, 3)]


@pytest.mark.parametrize("hexa,deg", SPECTRAL_CASES)
def test_spectral_matches_direct_and_jax(hexa, deg):
    """The sum-factorised plan against the port's direct lowerer and the
    JAX package's spectral plan (Q3 hexes: the direct lowerer alone) on
    perturbed (non-affine) Q2/Q3 quads and hexes with a variable
    coefficient."""
    mesh = _perturbed(T, hexa)
    a, L = _spectral_forms(T, mesh, deg)
    A1, A2 = _assemble(T, a, "0"), _assemble(T, a, "")
    _close(A2, A1)
    _close(_assemble(T, L, ""), _assemble(T, L, "0"))
    if (hexa, deg) != (True, 3):       # ~3 s of JAX compilation
        aj, _ = _spectral_forms(J, _perturbed(J, hexa), deg)
        _close(A2, _assemble(J, aj, ""))


def test_spectral_selection():
    """Q3 cell integrals on quads take the spectral plan by default and
    Q1 does not; FDTPU_SPECTRAL=1 forces it at Q1, =0 turns it off; the
    plan's evaluations count as lowerer evaluations."""
    from firedrake_tpu_torch.assemble import FormAssembler
    from firedrake_tpu_torch.compiler import cell_eval
    mesh = _perturbed(T, False)
    for deg, flag, expect in ((3, "", True), (1, "", False),
                              (1, "1", True), (3, "0", False)):
        os.environ["FDTPU_SPECTRAL"] = flag
        try:
            asm = FormAssembler(_spectral_forms(T, mesh, deg)[0],
                                use_stencil=False)
        finally:
            del os.environ["FDTPU_SPECTRAL"]
        assert (asm._statics[0]["spectral"] is not None) == expect
        n = cell_eval.lowerer_evals
        asm.assemble()
        assert cell_eval.lowerer_evals == n + 1


def test_spectral_q4_periodic_helmholtz():
    """The card case spectral_q4_periodic_256 at n = 4: Q4 Helmholtz on a
    periodic quad mesh (not structured: the gather route, the spectral
    plan chosen without a switch), CG + Jacobi; the error falls at the
    rate of Q4 from n = 4 to 8."""
    errs = []
    for n in (4, 8):
        mesh = T.PeriodicUnitSquareMesh(n, n, quadrilateral=True)
        V = T.FunctionSpace(mesh, "CG", 4)
        u, v = T.TrialFunction(V), T.TestFunction(V)
        X = T.SpatialCoordinate(mesh)
        ex = T.sin(2 * T.pi * X[0]) * T.sin(2 * T.pi * X[1])
        uh = T.Function(V)
        a = (T.inner(T.grad(u), T.grad(v)) + u * v) * T.dx
        asm = T.FormAssembler(a)
        assert asm._stencil is None and asm._statics[0]["spectral"]
        T.solve(a == (1 + 8 * T.pi ** 2) * ex * v * T.dx, uh,
                solver_parameters={"ksp_type": "cg", "pc_type": "jacobi",
                                   "ksp_rtol": 1e-12})
        errs.append(float((uh.dat - T.Function(V).interpolate(ex).dat)
                          .abs().max()))
    assert errs[1] < errs[0] / 20, errs


# --------------------------------------------------------- hierarchies
def _plain_copy(fd, m):
    """The quad mesh ``m`` rebuilt without its grid metadata, so that it
    refines by _refine_quad."""
    geom = import_module(fd.__name__ + ".mesh.geometry")
    topo = import_module(fd.__name__ + ".mesh.topology")
    return geom.Mesh(topo.MeshTopology(m.topology.cell_vertices,
                                       m.num_vertices, "quadrilateral"),
                     m._vertex_coords)


@pytest.mark.parametrize("kind", ["quads", "quads_unstructured", "hexes"])
def test_quad_hex_hierarchy_transfers_exact(kind):
    """MeshHierarchy on structured quads and hexes (grid-numbered levels)
    and on unstructured quads (_refine_quad): prolong of Q1 and Q2 exact
    on linears over two levels; on quads the fine values equal the JAX
    package's."""
    def build(fd):
        m0 = {"quads": lambda: fd.UnitSquareMesh(2, 2, quadrilateral=True),
              "quads_unstructured": lambda: _plain_copy(
                  fd, fd.UnitSquareMesh(2, 2, quadrilateral=True)),
              "hexes": lambda: fd.UnitCubeMesh(1, 1, 1, hexahedral=True)
              }[kind]()
        h = fd.MeshHierarchy(m0, 2)
        out = []
        for deg in (1, 2):
            Vs = [fd.FunctionSpace(m, "CG", deg) for m in h]
            X = fd.SpatialCoordinate(h[0])
            f = fd.Function(Vs[0]).interpolate(1 + 2 * X[0] - X[1])
            for V in Vs[1:]:
                g = fd.Function(V)
                fd.prolong(f, g)
                f = g
            out.append(f)
        return h, out

    h, fs = build(T)
    Xf = T.SpatialCoordinate(h[-1])
    for f in fs:
        assert T.errornorm(1 + 2 * Xf[0] - Xf[1], f) < 1e-12
    if kind != "hexes":
        for f, fj in zip(fs, build(J)[1]):
            _close(f, fj)
