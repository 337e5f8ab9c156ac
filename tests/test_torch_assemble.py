"""Stencil assembly of the port against the JAX package: channel planes,
assemble(L), assemble(a, diagonal=True) and StencilMatrix.matvec for P1
and P2 Helmholtz, with and without a DirichletBC, in float64 (rtol 1e-12,
atol 1e-12 * max|ref| for entries that cancel to zero) and with float32
kernels under FDTPU_PREC=f32 (rtol 1e-6, the bound of
tests/unit/test_pallas_eval.py:102, atol 1e-6 * max|ref|)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import firedrake_tpu as J
import firedrake_tpu_torch as T
from firedrake_tpu.assemble import _assembler_cache as j_cache
from firedrake_tpu_torch.assemble import _assembler_cache as t_cache


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    T.set_device("cpu")
    yield
    torch.set_num_threads(n)


def _problem(fd, degree, n=4):
    mesh = fd.UnitSquareMesh(n, n - 1)
    V = fd.FunctionSpace(mesh, "CG", degree)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    x, y = fd.SpatialCoordinate(mesh)
    f = fd.Function(V).interpolate((1 + 8 * fd.pi ** 2)
                                   * fd.cos(2 * fd.pi * x)
                                   * fd.cos(2 * fd.pi * y))
    a = (fd.inner(fd.grad(u), fd.grad(v)) + fd.inner(u, v)) * fd.dx
    L = fd.inner(f, v) * fd.dx
    bc = fd.DirichletBC(V, fd.Constant(0.5), "on_boundary")
    return V, a, L, bc


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(ours, ref, rtol):
    ours, ref = _np(ours), _np(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("with_bc", [False, True])
def test_matrix_vector_diagonal_match_jax(degree, with_bc):
    Vj, aj, Lj, bcj = _problem(J, degree)
    Vt, at, Lt, bct = _problem(T, degree)
    bj, bt = (bcj, bct) if with_bc else (None, None)
    Aj, At = J.assemble(aj, bcs=bj), T.assemble(at, bcs=bt)
    assert At.offsets == Aj.offsets
    _close(At.channels, Aj.channels, 1e-12)
    x = np.random.default_rng(degree).standard_normal(Vj.dim)
    _close(At.matvec(torch.as_tensor(x)), Aj.matvec(jnp.asarray(x)), 1e-12)
    _close(T.assemble(Lt, bcs=bt).dat, J.assemble(Lj, bcs=bj).dat, 1e-12)
    if not with_bc:
        _close(T.assemble(at, diagonal=True).dat,
               J.assemble(aj, diagonal=True).dat, 1e-12)
        _close(At.diagonal(), Aj.diagonal(), 1e-12)
        sj, st = Aj.to_scipy(), At.to_scipy()
        assert np.array_equal(sj.indptr, st.indptr)
        assert np.array_equal(sj.indices, st.indices)
        _close(st.data, sj.data, 1e-12)


def test_f32_kernels_match_jax(monkeypatch):
    monkeypatch.setenv("FDTPU_PREC", "f32")
    j_cache.clear()
    t_cache.clear()
    try:
        Vj, aj, Lj, _ = _problem(J, 1, n=6)
        Vt, at, Lt, _ = _problem(T, 1, n=6)
        Aj, At = J.assemble(aj), T.assemble(at)
        assert At.channels.dtype == torch.float64   # f64 accumulation
        _close(At.channels, Aj.channels, 1e-6)
        _close(T.assemble(Lt).dat, J.assemble(Lj).dat, 1e-6)
    finally:
        j_cache.clear()
        t_cache.clear()


def test_gather_inputs_bit_equal():
    Vj, aj, _, _ = _problem(J, 2)
    Vt, at, _, _ = _problem(T, 2)
    from firedrake_tpu.assemble import FormAssembler as JFA
    from firedrake_tpu_torch.assemble import FormAssembler as TFA
    ja, ta = JFA(aj), TFA(at)
    tc, tco, _ = ta._inputs()
    jc = jnp.asarray(ja.mesh.coordinates.dat)
    for t in range(ta._stencil.ntypes):
        cj, _ = ja._stencil.gather_cell_inputs(t, jc, {}, ja._compiled[0])
        ct, _ = ta._stencil.gather_cell_inputs(t, tc, tco, ta._compiled[0])
        assert np.array_equal(np.asarray(cj), ct.numpy())


def test_unported_routes_raise():
    """What the port still refuses raises NotImplementedError naming its
    ROADMAP.md item.  The cases this test first held to raising (0-forms,
    facet integrals, rows and columns on two grids, unstructured meshes)
    now take the gather route (tests/test_torch_gather.py)."""
    mesh = T.UnitSquareMesh(2, 2)
    V = T.FunctionSpace(mesh, "CG", 1)
    assert isinstance(T.assemble(T.Function(V) * T.dx), float)  # 0-form
    assert isinstance(T.assemble(T.TestFunction(V) * T.ds),      # facets
                      T.Cofunction)
    V2 = T.FunctionSpace(mesh, "CG", 2)      # rows and columns on two grids
    assert isinstance(T.assemble(T.TrialFunction(V) * T.TestFunction(V2)
                                 * T.dx), T.Matrix)
    m = T.UnitDiskMesh(1)                                     # unstructured
    W = T.FunctionSpace(m, "CG", 1)
    assert isinstance(T.assemble(T.TestFunction(W) * T.dx), T.Cofunction)
    with pytest.raises(NotImplementedError, match="item 17"):  # complex
        T.assemble(T.Constant(1j) * T.TestFunction(V) * T.dx)
    ext = T.ExtrudedMesh(T.UnitIntervalMesh(2), 2)            # extruded
    with pytest.raises(NotImplementedError, match="item 15"):
        T.FunctionSpace(ext, "CG", 1)
    from firedrake_tpu_torch.assemble import FormAssembler as TFA
    Q = T.FunctionSpace(T.UnitSquareMesh(2, 2, quadrilateral=True), "CG", 2)
    with pytest.raises(NotImplementedError, match="item 14"):  # spectral
        TFA(T.TrialFunction(Q) * T.TestFunction(Q) * T.dx, use_stencil=False)


def test_function_assign_and_bc_zero_match_jax():
    Vj, _, _, bcj = _problem(J, 2)
    Vt, _, _, bct = _problem(T, 2)
    g = np.random.default_rng(7).standard_normal(Vj.dim)
    fj, ft = J.Function(Vj, val=g), T.Function(Vt, val=g)
    hj, ht = J.Function(fj), T.Function(ft)           # copies
    hj.assign(2.0 * fj + J.Constant(0.25))
    ht.assign(2.0 * ft + T.Constant(0.25))
    _close(ht.dat, hj.dat, 0)
    _close(ft.dat, g, 0)                               # copy left f alone
    _close(bct.zero(ht.dat), bcj.zero(hj.dat), 0)
    _close(bct.apply(ht.dat), bcj.apply(hj.dat), 0)
    z = ht.copy().zero()
    assert not z.dat.any() and ht.dat.any()


def test_moved_mesh_matches_jax():
    """mesh.coordinates.dat = moved vertices, in both packages: the
    assembled operator and load before and after the move, and the host
    cell volumes after it (rtol 1e-12).  The port copies the coordinates
    to the device once per assignment and reuses that copy."""
    disp = 0.03 * np.random.default_rng(3).standard_normal((81, 2))
    out = {}
    for fd in (J, T):
        mesh = fd.UnitSquareMesh(8, 8)
        V = fd.FunctionSpace(mesh, "CG", 1)
        u, v = fd.TrialFunction(V), fd.TestFunction(V)
        x, y = fd.SpatialCoordinate(mesh)
        f = fd.Function(V).interpolate(fd.cos(2 * fd.pi * x) * y)
        a = (fd.inner(fd.grad(u), fd.grad(v)) + fd.inner(u, v)) * fd.dx
        L = fd.inner(f, v) * fd.dx
        before = (fd.assemble(a).channels, fd.assemble(L).dat)
        X = np.asarray(mesh.coordinates.dat).reshape(-1, 2)
        mesh.coordinates.dat = (X + disp * X * (1 - X)).reshape(-1)
        if fd is T:
            c1 = mesh.device_coordinates()
            assert mesh.device_coordinates() is c1      # reused
        after = (fd.assemble(a).channels, fd.assemble(L).dat)
        if fd is T:
            assert mesh.device_coordinates() is c1      # not copied again
        out[fd] = before + after + (mesh.cell_volumes,)
    for ours, ref in zip(out[T], out[J]):
        _close(ours, ref, 1e-12)
    assert not np.allclose(_np(out[T][0]), _np(out[T][2]))   # it moved


def test_coordinates_take_a_tensor():
    """A tensor assigned to mesh.coordinates.dat reaches the host geometry
    on its first read, and the assembly on the device."""
    m1, m2 = T.UnitSquareMesh(4, 4), T.UnitSquareMesh(4, 4)
    X = np.asarray(m1.coordinates.dat) * 1.5
    m1.coordinates.dat = X
    m2.coordinates.dat = torch.as_tensor(X)
    assert m2._pending_coords is not None               # lazy until read
    assert np.array_equal(m2.cell_volumes, m1.cell_volumes)
    assert m2._pending_coords is None
    assert np.array_equal(m2._vertex_coords, m1._vertex_coords)
    forms = [T.inner(T.TestFunction(T.FunctionSpace(m, "CG", 1)),
                     T.Constant(1.0)) * T.dx for m in (m1, m2)]
    _close(T.assemble(forms[1]).dat, T.assemble(forms[0]).dat, 0)


def test_grad_of_a_literal_factor():
    """grad(pi * w) and grad(pi * x[0]): the gradient of the literal is a
    Zero of the outer gradient's dimension (the JAX package raises a
    shape mismatch here).  Held to the JAX package's hand-expanded
    pi * grad(w), and to analytic values: grad(x) is the identity in the
    port (the JAX package evaluates it as the reference Jacobian)."""
    rng = np.random.default_rng(5)
    vals = rng.standard_normal(25)
    out = {}
    for fd, expand in ((J, True), (T, False)):
        mesh = fd.UnitSquareMesh(4, 4)
        V = fd.FunctionSpace(mesh, "CG", 1)
        w = fd.Function(V, val=vals)
        v = fd.TestFunction(V)
        g = fd.pi * fd.grad(w) if expand else fd.grad(fd.pi * w)
        out[fd] = fd.assemble(fd.inner(g, fd.grad(v)) * fd.dx).dat
    _close(out[T], out[J], 1e-12)
    mesh = T.UnitSquareMesh(4, 4)
    V = T.FunctionSpace(mesh, "CG", 2)
    x, y = T.SpatialCoordinate(mesh)
    v = T.TestFunction(V)
    _close(T.assemble(T.grad(T.pi * x)[0] * v * T.dx).dat,
           T.assemble(T.pi * v * T.dx).dat, 1e-14)
    assert abs(T.assemble(T.grad(T.pi * x)[1] * T.dx)) < 1e-15
    got = T.Function(V).interpolate(T.grad(T.pi * x * y)[1])
    _close(got.dat, T.Function(V).interpolate(T.pi * x).dat, 1e-14)
    # errornorm's error u - u_h carries a literal -1; x*y is in P2
    uh = T.Function(V).interpolate(x * y)
    assert T.errornorm(x * y, uh, "H1") < 1e-13
    assert abs(T.norm(x * y + 0 * uh, "H1") ** 2 - (2 / 3 + 1 / 9)) < 1e-13


def test_split_of_a_plain_function():
    V = T.FunctionSpace(T.UnitSquareMesh(2, 2), "CG", 1)
    u = T.Function(V)
    (s,) = T.split(u)
    assert s is u
    v = T.TestFunction(V)
    (s,) = T.split(v)
    assert s is v
