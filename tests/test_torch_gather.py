"""The gather route of the port against the JAX package: Sparsity and the
native COO builder, 0/1/2-forms on unstructured meshes (UnitDiskMesh),
exterior facet integrals with FacetNormal and boundary ids, the interior
facet forms of tests/regression/test_dg.py (jump, avg, SIPG) on
triangles and tets, DirichletBC through Matrix.with_dirichlet, norm and
errornorm, K1's Discontinuous Lagrange family and two small solves.

Tolerances: float64 results within 1e-12 max|ref| (the packages sum in
different orders: the port's cell integrals come from K1's plain version
or the batched lowerer, its vectors from gather tables where the JAX
package segment-sums), float32 kernels (FDTPU_PREC=f32) within 2e-6
normwise; host arrays bit for bit; iteration counts equal."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
import jax
import jax.numpy as jnp

import firedrake_tpu as J
import firedrake_tpu_torch as T
from firedrake_tpu.assemble import _assembler_cache as j_cache
from firedrake_tpu.assembly.sparsity import Sparsity as JSparsity
from firedrake_tpu_torch.assemble import (_assembler_cache as t_cache,
                                          FormAssembler)
from firedrake_tpu_torch.assembly.sparsity import Sparsity as TSparsity
from firedrake_tpu_torch import native
from firedrake_tpu_torch.compiler import cell_eval as K


#: the JAX package's reference programs are compiled with XLA's
#: optimisations off, which cuts the time of these tests by ~18% on 6 CPU
#: workers (most of it is compiling); the results agree within the same
#: tolerances.  The module's executables are dropped with it, so that no
#: later module runs them.
NO_OPT = "jax_disable_most_optimizations"


@pytest.fixture(autouse=True, scope="module")
def _cpu():
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
        (np.abs(ours - ref).max(), scale)


def _normwise(ours, ref, rtol=2e-6):
    ours, ref = _np(ours), _np(ref)
    assert np.linalg.norm(ours - ref) <= rtol * np.linalg.norm(ref)


def _disk(fd, level, family, degree):
    mesh = fd.UnitDiskMesh(level)
    V = fd.FunctionSpace(mesh, family, degree)
    x, y = fd.SpatialCoordinate(mesh)
    f = fd.Function(V).interpolate(fd.cos(x) * y + 2)
    return mesh, V, f, x, y


def test_matrix_entries_equal_scipy():
    """Matrix.entries gathers A[rows, cols] from the CSR values, bit for
    bit equal to the scipy matrix, 0 where the sparsity has no entry."""
    mesh = T.UnitDiskMesh(2)
    V = T.FunctionSpace(mesh, "CG", 2)
    u, v = T.TrialFunction(V), T.TestFunction(V)
    A = T.assemble((T.inner(T.grad(u), T.grad(v)) + u * v) * T.dx)
    assert "keys" not in A._tables          # made by the first lookup only
    S = A.to_scipy()
    rng = np.random.default_rng(4)
    rows = rng.integers(0, V.dim, (40, 7))
    cols = rng.integers(0, V.dim, (40, 7))
    cols[:, 0] = rows[:, 0]                     # diagonal entries too
    got = A.entries(torch.as_tensor(rows), torch.as_tensor(cols)).numpy()
    want = np.asarray(S[rows.reshape(-1), cols.reshape(-1)]).reshape(
        rows.shape)
    assert np.array_equal(got, want)
    assert (got == 0).any() and (got != 0).any()


# ------------------------------------------------------- sparsity, native
def test_native_coo_sort_unique_matches_numpy():
    rng = np.random.default_rng(0)
    keys = rng.integers(-3, 500, 4000).astype(np.int64)
    keys[rng.integers(0, 4000, 50)] = -1          # sentinels
    u1, p1, o1 = native.coo_sort_unique(keys)
    u2, p2, o2 = native.coo_sort_unique_plain(keys)
    assert np.array_equal(u1, u2) and np.array_equal(p1, p2)
    assert np.array_equal(o1, o2)
    assert p1.dtype == p2.dtype == np.int32
    assert (p1[keys < 0] == len(u1)).all()
    assert np.array_equal(o1, np.argsort(keys, kind="stable"))


def test_accumulation_order_from_the_sparsity():
    """The rank-2 accumulation takes its order from the Sparsity's key
    sort (no second argsort): every kept value sits in it once, sorted
    by its CSR position, and the tables sum what a scatter-add sums."""
    from firedrake_tpu_torch.assemble import _accumulation
    mesh, V, f, x, y = _disk(T, 2, "CG", 2)
    u, v = T.TrialFunction(V), T.TestFunction(V)
    n = T.FacetNormal(mesh)
    a = f * u * v * T.dx + T.inner(T.jump(u, n), T.jump(v, n)) * T.dS
    asm = FormAssembler(a)
    s = asm.sparsity
    assert s.key_order is None                 # consumed by the build
    parts = [pos.reshape(st["n"], -1).T.reshape(-1) if st["cell_last"]
             else pos for st, pos in zip(asm._statics, s.block_positions)]
    pos = np.concatenate(parts)
    m = V.cell_dof_map
    assert TSparsity(V.dim, V.dim, [(m, m)]).key_order.dtype == np.int64
    vals = torch.as_tensor(np.random.default_rng(1).standard_normal(
        len(pos)))
    ref = torch.zeros(s.nnz, dtype=torch.float64).index_add_(
        0, torch.as_tensor(pos, dtype=torch.int64), vals)
    for acc in (asm._acc, _accumulation(pos, s.nnz, "cpu")):
        _close(acc(vals), ref)


def test_sparsity_bit_equal():
    """Blocks of a P2 cell map and a doubled (interior facet) map, with a
    sentinel row out of range: every array of the two Sparsity classes."""
    mesh = T.UnitDiskMesh(2)
    V = T.FunctionSpace(mesh, "CG", 2)
    m = V.cell_dof_map
    topo = mesh.topology
    f = topo.interior_facets
    cp, cm = topo.facet_cells[f, 0], topo.facet_cells[f, 1]
    dbl = np.hstack([m[cp], m[cm]])
    rows = m.copy()
    rows[0, 0] = V.dim                               # restricted dof
    blocks = [(rows, m), (dbl, dbl)]
    sj, st = JSparsity(V.dim, V.dim, blocks), TSparsity(V.dim, V.dim, blocks)
    assert sj.nnz == st.nnz
    for name in ("coo_rows", "coo_cols", "indptr", "diag_positions",
                 "row_lengths"):
        a, b = getattr(sj, name), getattr(st, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for a, b in zip(sj.block_positions, st.block_positions):
        assert np.array_equal(a, b)
    for a, b in zip(sj.ell, st.ell):
        assert np.array_equal(a, b)


# ------------------------------------------------------ forms on the disk
def _forms(fd, degree):
    mesh, V, f, x, y = _disk(fd, 3, "CG", degree)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    n = fd.FacetNormal(mesh)
    a = (fd.inner(fd.grad(u), fd.grad(v)) + u * v) * fd.dx \
        + f * u * v * fd.ds
    L = f * v * fd.dx + fd.inner(fd.grad(f), n) * v * fd.ds
    s = f * f * fd.dx + x * fd.ds
    return V, a, L, s


@pytest.mark.parametrize("degree", [1, 2])
def test_ranks_012_on_the_disk_match_jax(degree):
    Vj, aj, Lj, sj = _forms(J, degree)
    Vt, at, Lt, st = _forms(T, degree)
    Aj, At = J.assemble(aj), T.assemble(at)
    assert isinstance(At, T.Matrix)
    _close(At.data, Aj.data)
    _close(T.assemble(Lt).dat, J.assemble(Lj).dat)
    assert abs(T.assemble(st) - J.assemble(sj)) <= 1e-12 * abs(
        J.assemble(sj))
    # the Matrix's operations against the JAX package's Matrix
    x = np.random.default_rng(degree).standard_normal(Vj.dim)
    xt = torch.as_tensor(x)
    _close(At.matvec(xt), Aj.matvec(jnp.asarray(x)))
    _close(At.diagonal(), Aj.diagonal())
    _close(At.transpose_matvec(xt), Aj.transpose_matvec(jnp.asarray(x)))
    _close(T.assemble(at, diagonal=True).dat,
           J.assemble(aj, diagonal=True).dat)
    assert np.array_equal(At.to_dense(), At.copy().to_scipy().toarray())


def test_f32_kernels_match_jax(monkeypatch):
    monkeypatch.setenv("FDTPU_PREC", "f32")
    j_cache.clear()
    t_cache.clear()
    try:
        Vj, aj, Lj, sj = _forms(J, 1)
        Vt, at, Lt, st = _forms(T, 1)
        _normwise(T.assemble(at).data, J.assemble(aj).data)
        _normwise(T.assemble(Lt).dat, J.assemble(Lj).dat)
        assert abs(T.assemble(st) - J.assemble(sj)) <= 2e-6 * abs(
            J.assemble(sj))
    finally:
        j_cache.clear()
        t_cache.clear()


@pytest.mark.parametrize("sorted_acc", [False, True])
def test_forced_gather_equals_stencil(monkeypatch, sorted_acc):
    """use_stencil=False on a structured mesh: the CSR matrix and vector
    equal the stencil route's (and the JAX package's gather route), with
    the gather tables and with FDTPU_GATHER_ACC=sorted."""
    if sorted_acc:
        monkeypatch.setenv("FDTPU_GATHER_ACC", "sorted")

    def problem(fd):
        mesh = fd.UnitSquareMesh(8, 8)
        V = fd.FunctionSpace(mesh, "CG", 1)
        u, v = fd.TrialFunction(V), fd.TestFunction(V)
        x, y = fd.SpatialCoordinate(mesh)
        f = fd.Function(V).interpolate(1 + x * y)
        return (fd.inner(fd.grad(u), fd.grad(v)) + f * u * v) * fd.dx, \
            f * v * fd.dx
    at, Lt = problem(T)
    gather = FormAssembler(at, use_stencil=False)
    assert gather._stencil is None
    assert type(gather._acc).__name__ == ("_Sorted" if sorted_acc
                                          else "_Tables")
    Ag, As = gather.assemble(), FormAssembler(at).assemble()
    _close(Ag, As.to_scipy().toarray())
    bg = FormAssembler(Lt, use_stencil=False).assemble()
    _close(bg.dat, FormAssembler(Lt).assemble().dat)
    if not sorted_acc:
        aj, _ = problem(J)
        from firedrake_tpu.assemble import FormAssembler as JFA
        _close(Ag.data, JFA(aj, use_stencil=False).assemble().data)


def test_no_stencil_env_forces_the_gather_route(monkeypatch):
    monkeypatch.setenv("FDTPU_NO_STENCIL", "1")
    V = T.FunctionSpace(T.UnitSquareMesh(3, 3), "CG", 1)
    u, v = T.TrialFunction(V), T.TestFunction(V)
    assert isinstance(T.assemble(u * v * T.dx), T.Matrix)


def test_exterior_facets_by_boundary_id():
    """ds(1)..ds(4) of UnitSquareMesh with FacetNormal, rank 0 and 1."""
    out = {}
    for fd in (J, T):
        mesh = fd.UnitSquareMesh(4, 5)
        V = fd.FunctionSpace(mesh, "CG", 2)
        v = fd.TestFunction(V)
        x, y = fd.SpatialCoordinate(mesh)
        n = fd.FacetNormal(mesh)
        g = fd.Function(V).interpolate(x * x + 3 * y)
        L = sum((k * fd.inner(fd.grad(g), n) * v * fd.ds(k)
                 for k in (1, 2, 3)), fd.Constant(2.0) * v * fd.ds(4))
        s = sum((k * fd.dot(fd.as_vector([x, y * y]), n) * fd.ds(k)
                 for k in (1, 2, 3, 4)), g * fd.ds((1, 3)))
        out[fd] = (fd.assemble(L).dat, fd.assemble(s))
    _close(out[T][0], out[J][0])
    assert abs(out[T][1] - out[J][1]) <= 1e-12 * abs(out[J][1])


# ----------------------------------------------------- interior facets
def _mesh(fd, name):
    return {"square": lambda: fd.UnitSquareMesh(4, 4),
            "disk": lambda: fd.UnitDiskMesh(2),
            "cube": lambda: fd.UnitCubeMesh(2, 2, 2)}[name]()


@pytest.mark.parametrize("mesh_name", ["square", "disk", "cube"])
def test_interior_facet_forms_match_jax(mesh_name):
    """The dS forms of tests/regression/test_dg.py: SIPG (rank 2), the
    upwind-style jump(v) * avg(f) load (rank 1) and jump/avg functionals
    (rank 0), on DG1 with a discontinuous coefficient."""
    out = {}
    for fd in (J, T):
        mesh = _mesh(fd, mesh_name)
        V = fd.FunctionSpace(mesh, "DG", 1)
        u, v = fd.TrialFunction(V), fd.TestFunction(V)
        n = fd.FacetNormal(mesh)
        h = fd.CellDiameter(mesh)
        alpha = fd.Constant(10.0)
        w = fd.Function(V)
        w.dat = np.random.default_rng(5).uniform(0.5, 1.5, V.dim)
        a = fd.inner(fd.grad(u), fd.grad(v)) * fd.dx \
            - fd.inner(fd.avg(fd.grad(u)), fd.jump(v, n)) * fd.dS \
            - fd.inner(fd.jump(u, n), fd.avg(fd.grad(v))) * fd.dS \
            + alpha / fd.avg(h) * fd.inner(fd.jump(u, n), fd.jump(v, n)) \
            * fd.dS \
            - fd.inner(fd.grad(u), v * n) * fd.ds \
            - fd.inner(u * n, fd.grad(v)) * fd.ds \
            + alpha / h * fd.inner(u, v) * fd.ds
        L = fd.jump(v) * fd.avg(w) * fd.dS + w("-") * v("+") * fd.dS
        s = (fd.jump(w) * fd.jump(w) + fd.avg(w) * fd.FacetArea(mesh)) \
            * fd.dS
        out[fd] = (fd.assemble(a).data, fd.assemble(L).dat,
                   fd.assemble(s))
    _close(out[T][0], out[J][0])
    _close(out[T][1], out[J][1])
    assert abs(out[T][2] - out[J][2]) <= 1e-12 * abs(out[J][2])


def test_marked_interior_facets_match_jax():
    """dS(id) over facets marked by their midpoints, and dS(-1) (the
    reference's UNMARKED, our marker 0)."""
    out = {}
    for fd in (J, T):
        mesh = fd.UnitDiskMesh(2)
        mesh.mark_facets(lambda m: 1 if m[0] < 0 else (2 if m[1] < 0
                                                       else 0))
        V = fd.FunctionSpace(mesh, "DG", 1)
        v = fd.TestFunction(V)
        w = fd.Function(V)
        w.dat = np.random.default_rng(8).uniform(0.5, 1.5, V.dim)
        L = fd.jump(v) * fd.avg(w) * fd.dS(1) + v("-") * fd.dS((2, -1))
        s = fd.jump(w) ** 2 * fd.dS(2) + w("+") * fd.dS(1)
        out[fd] = (fd.assemble(L).dat, fd.assemble(s))
    _close(out[T][0], out[J][0])
    assert abs(out[T][1] - out[J][1]) <= 1e-12 * abs(out[J][1])


def test_interior_facet_kernel_needs_restrictions():
    mesh = T.UnitSquareMesh(2, 2)
    V = T.FunctionSpace(mesh, "DG", 1)
    v = T.TestFunction(V)
    with pytest.raises(ValueError, match="restricted"):
        T.assemble(v * T.dS)


# ------------------------------------------------------- bcs and norms
def test_dirichlet_through_with_dirichlet():
    out = {}
    for fd in (J, T):
        mesh, V, f, x, y = _disk(fd, 2, "CG", 2)
        u, v = fd.TrialFunction(V), fd.TestFunction(V)
        bc = fd.DirichletBC(V, fd.Constant(0.5), "on_boundary")
        A = fd.assemble(fd.inner(fd.grad(u), fd.grad(v)) * fd.dx, bcs=bc)
        b = fd.assemble(f * v * fd.dx, bcs=bc)
        out[fd] = (A, b.dat)
    _close(out[T][0].data, out[J][0].data)
    _close(out[T][1], out[J][1])
    Ad = out[T][0].to_dense()
    rows = T.DirichletBC(out[T][0].row_space, 0.0, "on_boundary").dof_indices
    assert np.array_equal(Ad[rows][:, rows], np.eye(len(rows)))
    # values assigned anew reach the matvec (its ELL copy is remade)
    A = out[T][0]
    z = torch.ones(A.shape[0], dtype=torch.float64)
    A.matvec(z)
    A.data = 2 * A.data
    _close(A.matvec(z), 2 * torch.as_tensor(Ad @ z.numpy()))


def test_norm_and_errornorm():
    out = {}
    for fd in (J, T):
        mesh, V, f, x, y = _disk(fd, 3, "CG", 1)
        out[fd] = [fd.norm(f), fd.norm(f, "H1"), fd.norm(f, "h1_semi"),
                   fd.norm(f, "linf"), fd.errornorm(fd.cos(x) * y + 2, f),
                   fd.errornorm(x * x, f)]
    for a, b in zip(out[T], out[J]):
        assert abs(a - b) <= 1e-12 * abs(b)


# -------------------------------------------------- K1's DG widening
@pytest.mark.parametrize("cell", ["triangle", "tetrahedron"])
def test_k1_family_takes_discontinuous_lagrange(cell):
    """DG1/DG2 tabulate as CG1/CG2 node for node, so their cell integrals
    are K1's: its plain version agrees with the batched lowerer; an
    element whose tabulation differs is left to the lowerer."""
    mesh = T.UnitDiskMesh(1) if cell == "triangle" else \
        T.UnitCubeMesh(1, 1, 1)
    for deg in (1, 2):
        V = T.FunctionSpace(mesh, "DG", deg)
        u, v = T.TrialFunction(V), T.TestFunction(V)
        w = T.Function(V)
        w.dat = np.random.default_rng(deg).uniform(0.5, 1.5, V.dim)
        asm = FormAssembler((T.inner(T.grad(u), T.grad(v)) + w * u * v)
                            * T.dx, use_stencil=False)
        (ci,), (st,) = asm._compiled, asm._statics
        spec = K.family_spec(ci)
        assert spec is not None
        coords, coeffs, consts = asm._inputs()
        ce = coords[st["coords_map"]]
        ws = tuple(coeffs[c.count][st["coeff_maps"][c.count]]
                   for c in ci.coefficients)
        _close(K.cell_eval_plain(spec, ce, ws, ()),
               ci.cell_kernel_batched()(ce, ws, ()))
    elem = V.element
    K._LAGRANGE_LIKE.clear()
    orig = elem.tabulate
    try:
        elem.tabulate = lambda pts, order: {
            d: t[:, ::-1] for d, t in orig(pts, order).items()}
        assert not K._lagrange_like(elem)
    finally:
        del elem.tabulate
        K._LAGRANGE_LIKE.clear()


def test_cell_last_route_equals_the_vmapped_cell_kernel():
    """The route's cell integrals (K1's plain version on cell-last
    gathers) against the per-cell kernel vmapped over the cells, the JAX
    route's way."""
    mesh, V, f, x, y = _disk(T, 2, "CG", 2)
    u, v = T.TrialFunction(V), T.TestFunction(V)
    asm = FormAssembler((T.inner(T.grad(u), T.grad(v)) + f * u * v) * T.dx)
    (ci,), (st,) = asm._compiled, asm._statics
    coords, coeffs, consts = asm._inputs()
    loc = asm._local_values(ci, st, coords, coeffs, ())     # (ni, nj, C)
    cmap = st["coords_map"].permute(2, 0, 1)
    w = coeffs[f.count][st["coeff_maps"][f.count].T]
    kern = ci.cell_kernel()
    ref = torch.func.vmap(lambda c, w: kern(c, (w,), ()))(coords[cmap], w)
    _close(loc.permute(2, 0, 1), ref)


# -------------------------------------------------------- small solves
def _neumann(fd):
    mesh = fd.UnitDiskMesh(3)
    V = fd.FunctionSpace(mesh, "CG", 1)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    x, y = fd.SpatialCoordinate(mesh)
    pi = np.pi
    u_ex = fd.cos(pi * x) * fd.cos(pi * y)
    grad_ex = fd.as_vector([-pi * fd.sin(pi * x) * fd.cos(pi * y),
                            -pi * fd.cos(pi * x) * fd.sin(pi * y)])
    f = fd.Function(V).interpolate((1 + 2 * pi ** 2) * u_ex)
    n = fd.FacetNormal(mesh)
    a = (fd.inner(fd.grad(u), fd.grad(v)) + u * v) * fd.dx
    L = f * v * fd.dx + fd.inner(grad_ex, n) * v * fd.ds
    return V, a, L, u_ex


def _sipg(fd):
    mesh = fd.UnitDiskMesh(2)
    V = fd.FunctionSpace(mesh, "DG", 1)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    x, y = fd.SpatialCoordinate(mesh)
    n = fd.FacetNormal(mesh)
    h = fd.CellDiameter(mesh)
    alpha = fd.Constant(10.0)
    a = fd.inner(fd.grad(u), fd.grad(v)) * fd.dx \
        - fd.inner(fd.avg(fd.grad(u)), fd.jump(v, n)) * fd.dS \
        - fd.inner(fd.jump(u, n), fd.avg(fd.grad(v))) * fd.dS \
        + alpha / fd.avg(h) * fd.inner(fd.jump(u, n), fd.jump(v, n)) * fd.dS \
        - fd.inner(fd.grad(u), v * n) * fd.ds \
        - fd.inner(u * n, fd.grad(v)) * fd.ds \
        + alpha / h * fd.inner(u, v) * fd.ds
    return V, a, fd.Constant(4.0) * v * fd.dx, 1 - x ** 2 - y ** 2


@pytest.mark.parametrize("problem", [_neumann, _sipg])
def test_small_solves_match_jax(problem):
    """Neumann Helmholtz on UnitDiskMesh(3) and SIPG DG1 on
    UnitDiskMesh(2), CG + Jacobi: equal iteration counts, solutions within
    1e-9 (the solves stop at rtol 1e-10), errornorm within 1e-9."""
    out = {}
    params = {"ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": 1e-10}
    for fd in (J, T):
        V, a, L, u_ex = problem(fd)
        uh = fd.Function(V)
        solver = fd.LinearVariationalSolver(
            fd.LinearVariationalProblem(a, L, uh), solver_parameters=params)
        solver.solve()
        out[fd] = (solver.ksp_iterations, _np(uh.dat),
                   fd.errornorm(u_ex, uh))
    assert out[T][0] == out[J][0]
    _close(out[T][1], out[J][1], 1e-9)
    assert abs(out[T][2] - out[J][2]) <= 1e-9 * out[J][2]
