"""Slate, the HDiv trace and broken elements, hybridization and static
condensation (SCPC) in the port: Slate's local tensors and their algebra
(inv, solve, .T, blocks, DiagonalTensor, Reciprocal, Factorization), one-
and two-sided facet integrals and the global assembly of each against the
JAX package on UnitSquareMesh(3) DG1 (the cases of
tests/regression/test_slate.py and test_slate_two_sided.py); trace spaces'
dof maps and facet mass matrices bit for bit and to 1e-12.  Without JAX: the
hybridized and SCPC solves against the port's own monolithic LU, K2's
plain version against torch.linalg.inv on the packed hybridized blocks,
and the packing order that keeps K2's pivots nonzero.  The hybridized
solves through the JAX package are in test_torch_hybridization.py, the
SCPC solve and the hybrid system's Slate condensation in
test_torch_condensation.py.

Tolerances: float64 results within 1e-12 max|ref| of the JAX package (the
port evaluates cell integrals cell-last and sums in another order); the
solves within 1e-10 of the port's LU (1e-8 with an inner CG at rtol
1e-12); host tables bit for bit."""
import math
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
from firedrake_tpu_torch.ops.batched_inverse import batched_inv_plain

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


def _close(ours, ref, rtol=1e-12):
    ours, ref = _np(ours), _np(ref)
    assert np.shape(ours) == np.shape(ref)
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(ours - ref).max() <= rtol * scale, \
        np.abs(ours - ref).max() / scale


# ------------------------------------------------ Slate algebra and forms
def _dg1_problem(fd):
    """UnitSquareMesh(3) DG1 and a Function on it."""
    mesh = fd.UnitSquareMesh(3, 3)
    V = fd.FunctionSpace(mesh, "DG", 1)
    f = fd.Function(V)
    return mesh, V, f


def _slate_cases(fd, mesh, V, f):
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    n = fd.FacetNormal(mesh)
    mass = fd.inner(u, v) * fd.dx
    stiff = fd.inner(fd.grad(u), fd.grad(v)) * fd.dx
    ip = fd.inner(fd.jump(u), fd.jump(v)) * fd.dS
    asym = fd.inner(fd.jump(u, n), fd.avg(fd.grad(v))) * fd.dS
    A, K, L = fd.Tensor(mass), fd.Tensor(stiff), fd.Tensor(f * v * fd.dx)
    W = V * fd.FunctionSpace(mesh, "DG", 0)
    (u0, u1), (v0, v1) = fd.TrialFunctions(W), fd.TestFunctions(W)
    M = fd.Tensor((u0 * v0 + u1 * v1 + u0 * v1 + 2.0 * u1 * v0) * fd.dx)
    return {
        "mass": A,
        "load": L,
        "inv": A.inv,
        "inv_times_load": A.inv * L,
        "solve": A.solve(L),
        "transpose_of_sum": (A + K).T,
        "product_with_inverse": A * A.inv,
        "action": A * fd.AssembledVector(f),
        "difference": K - A,
        "diagonal": fd.DiagonalTensor(K),
        "reciprocal": fd.Reciprocal(L),
        "factorization": (A + K).solve(L, decomposition="LLT"),
        "one_sided_facets": fd.Tensor(u("+") * v("+") * fd.dS
                                      + u * v * fd.ds),
        "jump_jump": fd.Tensor(ip),
        "sipg": fd.Tensor(stiff - fd.inner(fd.avg(fd.grad(u)), fd.jump(v, n))
                          * fd.dS - fd.inner(fd.jump(u, n),
                                             fd.avg(fd.grad(v))) * fd.dS
                          + 12.0 * ip),
        "two_sided_rank1": fd.Tensor(fd.avg(f) * fd.jump(v) * fd.dS),
        "two_sided_linear": fd.Tensor(ip) + A - fd.Tensor(asym).T,
        "two_sided_functional": fd.Tensor(fd.avg(f) * fd.jump(f) * fd.dS),
        "mixed_block": M.blocks[1, 0],
        "mixed_block_inverse": M.blocks[:1, :1].inv * M.blocks[0, 1],
        "mixed_schur": M.blocks[1, 1] - M.blocks[1, 0]
        * M.blocks[0, 0].inv * M.blocks[0, 1],
    }


@pytest.fixture(scope="module")
def slate_pair():
    vals = np.random.default_rng(7).uniform(0.5, 1.5, 54)
    out = []
    for fd in (J, T):
        mesh, V, f = _dg1_problem(fd)
        out.append((mesh, V, f))
    (mj, Vj, fj), (mt, Vt, ft) = out
    fj.dat = vals
    load_reference_state({ft: np.asarray(fj.dat)},
                         cell_node_maps={Vt: Vj.cell_node_map})
    return _slate_cases(J, mj, Vj, fj), _slate_cases(T, mt, Vt, ft)


#: held to the JAX package; "one_sided_facets" and "sipg" are held to the
#: port's direct assembly below (each facet integrand costs the JAX
#: package seconds of compilation; the hybrid system holds the one-sided
#: localisation to the JAX package)
CASES = ["mass", "load", "inv", "inv_times_load", "solve",
         "transpose_of_sum", "product_with_inverse", "action", "difference",
         "diagonal", "reciprocal", "factorization", "jump_jump",
         "two_sided_rank1", "two_sided_linear", "two_sided_functional",
         "mixed_block", "mixed_block_inverse", "mixed_schur"]


@pytest.mark.parametrize("name", CASES)
def test_slate_matches_jax(slate_pair, name, monkeypatch):
    """Local tensors (cell part and cross-cell facet-pair blocks) and the
    global assembly of each expression.  The JAX package's assembly
    reuses its local evaluation (one shared cache) to save it the time."""
    ej, et = slate_pair[0][name], slate_pair[1][name]
    cache, local = {}, JS._eval_local
    monkeypatch.setattr(JS, "_eval_local", lambda e, _c: local(e, cache))
    lj, lt = JS._eval_local(ej, cache), TS._eval_local(et, {})
    _close(lt.cell, lj.cell)
    assert len(lt.cross) == len(lj.cross)
    for (rj, cj, vj), (rt, ct, vt) in zip(lj.cross, lt.cross):
        assert np.array_equal(rj, rt) and np.array_equal(cj, ct)
        _close(vt, vj)
    gj, gt = J.assemble_slate(ej), T.assemble_slate(et)
    if isinstance(gj, float):
        assert isinstance(gt, float)
        assert abs(gt - gj) <= 1e-12 * max(abs(gj), 1.0)
    else:
        _close(gt, gj)


@pytest.mark.parametrize("name", ["mass", "one_sided_facets", "jump_jump",
                                  "sipg", "two_sided_rank1"])
def test_slate_matches_direct_assembly(slate_pair, name):
    """Tensor(form) assembles to assemble(form): two-sided integrals
    through the facet-pair blocks, the full SIPG operator (symmetric, as
    the form is).  A one-sided dS integrand is visited from both cells,
    each as '+' (the hybridizable reading), so u('+') v('+') dS assembles
    to the direct assembly of (u('+') v('+') + u('-') v('-')) dS."""
    t = slate_pair[1][name]
    ours = T.assemble_slate(t)
    form = t.form
    if name == "one_sided_facets":
        v, u = sorted(form.arguments(), key=lambda a: a.number)
        form = ((u("+") * v("+") + u("-") * v("-")) * T.dS
                + u * v * T.ds)
    _close(ours, T.assemble(form))
    if name == "sipg":
        D = _np(ours)
        assert np.abs(D - D.T).max() < 1e-12 * np.abs(D).max()


def test_cell_local_algebra_on_cross_raises(slate_pair):
    A = slate_pair[1]["jump_jump"]
    for expr in (A.inv, A.solve(slate_pair[1]["load"]), A * A):
        with pytest.raises(NotImplementedError, match="cross-cell"):
            TS._eval_local(expr, {})


# ------------------------------------------------------------ trace spaces
@pytest.mark.parametrize("cell, degree", [("tri", 0), ("tri", 1),
                                          ("tri", 2), ("tet", 0),
                                          ("tet", 1)])
def test_trace_space_tables_bit_for_bit(cell, degree):
    """Dof counts and maps, sign and transform tables, facet tabulations
    and the boundary nodes of HDiv Trace spaces."""
    out = []
    for fd in (J, T):
        mesh = (fd.UnitSquareMesh(3, 3) if cell == "tri"
                else fd.UnitCubeMesh(2, 2, 2))
        V = fd.FunctionSpace(mesh, "HDiv Trace", degree)
        s = V.sdata
        el = V.element
        pts = np.random.default_rng(1).uniform(
            0, 0.3, (4, mesh.topological_dimension))
        tab = [el.tabulate_facet(lf, pts, 1)[d]
               for lf in range(len(el.cell.facets)) for d in (0, 1)]
        out.append([np.asarray([V.dim, el.ndof, V.has_dof_signs,
                                s.has_dof_transforms]),
                    np.asarray(V.cell_dof_map),
                    np.asarray(s.cell_dof_signs) if V.has_dof_signs
                    else np.zeros(0),
                    np.asarray(s.cell_dof_transforms)
                    if s.has_dof_transforms else np.zeros(0),
                    np.asarray(fd.DirichletBC(V, 0.0, "on_boundary").nodes),
                    *tab])
    for a, b in zip(*out):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_broken_space_dof_map_bit_for_bit():
    maps = []
    for fd in (J, T):
        el = _elements(fd)
        mesh = fd.UnitSquareMesh(3, 3)
        Sb = fd.FunctionSpace(mesh, el.BrokenElement(
            el.make_scalar_element("triangle", "RT", 2)))
        maps.append((Sb.dim, np.asarray(Sb.cell_dof_map),
                     bool(getattr(Sb, "has_dof_signs", False))))
    assert maps[0][0] == maps[1][0] == 9 * 2 * 8
    assert np.array_equal(maps[0][1], maps[1][1])
    assert maps[0][2] == maps[1][2] == False  # noqa: E712


@pytest.mark.parametrize("cell, degree", [("tri", 0), ("tri", 1),
                                          ("tet", 1)])
def test_trace_facet_mass_matches_jax(cell, degree):
    """The trace mass matrix and a load vector over dS + ds (the JAX
    test_trace_space_facet_mass, test_trace_p1_facet_mass and the tet
    chart gluing of test_hybridization_3d.py)."""
    res = []
    for fd in (J, T):
        mesh = (fd.UnitSquareMesh(3, 3) if cell == "tri"
                else fd.UnitCubeMesh(2, 2, 2))
        V = fd.FunctionSpace(mesh, "HDiv Trace", degree)
        lam, mu = fd.TrialFunction(V), fd.TestFunction(V)
        x = fd.SpatialCoordinate(mesh)
        g = x[0] + 2 * x[1]
        M = fd.assemble(fd.inner(lam("+"), mu("+")) * fd.dS
                        + fd.inner(lam, mu) * fd.ds)
        b = fd.assemble(fd.inner(g, mu("+")) * fd.dS
                        + fd.inner(g, mu) * fd.ds)
        res.append((M, b, mesh))
    (Mj, bj, mj), (Mt, bt, mt) = res
    _close(Mt, Mj)
    _close(bt, bj)
    if cell == "tri":
        # the Legendre block diag(|e|, |e|/3, ...) per edge
        fv = mt.topology.facet_vertices
        L = np.linalg.norm(mt._vertex_coords[fv[:, 1]]
                           - mt._vertex_coords[fv[:, 0]], axis=1)
        D = np.diag(np.repeat(L, degree + 1)
                    / np.tile(2 * np.arange(degree + 1) + 1, len(L)))
        assert np.abs(_np(Mt) - D).max() < 1e-12


def test_trace_cell_integral_raises():
    V = T.FunctionSpace(T.UnitSquareMesh(2, 2), "HDiv Trace", 0)
    with pytest.raises(ValueError, match="no cell tabulation"):
        T.assemble(T.TrialFunction(V) * T.TestFunction(V) * T.dx)


# ------------------------------------------------ the solves, without JAX
def _mixed_poisson(n, family, degree, vdegree, dim=2):
    if dim == 2:
        mesh = T.UnitSquareMesh(n, n)
    else:
        mesh = T.UnitCubeMesh(n, n, n)
    W = T.FunctionSpace(mesh, family, degree) * T.FunctionSpace(
        mesh, "DG", vdegree)
    sigma, u = T.TrialFunctions(W)
    tau, v = T.TestFunctions(W)
    X = T.SpatialCoordinate(mesh)
    src = T.sin(math.pi * X[0]) * T.sin(math.pi * X[1]) + (
        X[2] * X[2] if dim == 3 else 0.0)
    f = T.Function(W.subspaces[1]).interpolate(2 * math.pi ** 2 * src)
    a = (T.dot(sigma, tau) - u * T.div(tau) - T.div(sigma) * v) * T.dx
    return W, a, -T.inner(f, v) * T.dx


def _solve(W, a, L, params):
    w = T.Function(W)
    s = T.LinearVariationalSolver(T.LinearVariationalProblem(a, L, w),
                                  solver_parameters=params)
    s.solve()
    return w, s


@pytest.mark.parametrize("n, family, degree, vdegree, dim", [
    (4, "RT", 1, 0, 2), (4, "RT", 2, 1, 2), (4, "BDM", 1, 0, 2),
    (3, "BDM", 2, 1, 2), (2, "RT", 1, 0, 3)])
def test_hybridized_equals_monolithic_lu(n, family, degree, vdegree, dim):
    W, a, L = _mixed_poisson(n, family, degree, vdegree, dim)
    wh, sh = _solve(W, a, L, HYB)
    wr, _ = _solve(W, a, L, LU)
    assert sh.ksp_iterations == 1 and sh.converged
    for i in (0, 1):
        _close(wh.subfunctions[i].dat, wr.subfunctions[i].dat, 1e-10)


def test_hybridized_trace_cg_equals_lu():
    """The trace system by CG + Jacobi on the device (rtol 1e-12) as the
    hybridization_ options ask, flattened or nested."""
    W, a, L = _mixed_poisson(4, "RT", 2, 1)
    wr, _ = _solve(W, a, L, HYB)
    for params in ({"ksp_type": "preonly", "pc_type": "hybridization",
                    "hybridization": {"ksp_type": "cg", "pc_type": "jacobi",
                                      "ksp_rtol": 1e-12}},
                   {"pc_type": "python",
                    "pc_python_type": "firedrake.HybridizationPC",
                    "hybridization_ksp_type": "cg",
                    "hybridization_pc_type": "jacobi",
                    "hybridization_ksp_rtol": 1e-12}):
        wc, sc = _solve(W, a, L, params)
        assert sc.converged and 1 < sc.ksp_iterations < 100
        _close(wc.dat, wr.dat, 1e-8)


def _scpc_problem(deg, n, g=None):
    mesh = T.UnitSquareMesh(n, n)
    V = T.FunctionSpace(mesh, "CG", deg)
    u, v = T.TrialFunction(V), T.TestFunction(V)
    X = T.SpatialCoordinate(mesh)
    f = 2 * math.pi ** 2 * T.sin(math.pi * X[0]) * T.sin(math.pi * X[1])
    bcval = 0.0 if g is None else T.Function(V).interpolate(X[0] + X[1])
    return (V, T.inner(T.grad(u), T.grad(v)) * T.dx, f * v * T.dx,
            [T.DirichletBC(V, bcval, "on_boundary")])


@pytest.mark.parametrize("deg, params", [
    (3, {"ksp_type": "preonly", "pc_type": "scpc"}),
    (4, {"ksp_type": "preonly", "pc_type": "scpc"}),
    (5, {"pc_type": "python", "pc_python_type": "firedrake.SCPC"})])
def test_scpc_equals_lu(deg, params):
    V, a, L, bcs = _scpc_problem(deg, 4)
    us, uc = T.Function(V), T.Function(V)
    T.solve(a == L, us, bcs=bcs, solver_parameters=LU)
    T.solve(a == L, uc, bcs=bcs, solver_parameters=params)
    _close(uc.dat, us.dat, 1e-10)


def test_scpc_inner_cg_nonzero_bc():
    V, a, L, bcs = _scpc_problem(3, 5, g=True)
    us, uc = T.Function(V), T.Function(V)
    T.solve(a == L, us, bcs=bcs, solver_parameters=LU)
    s = T.LinearVariationalSolver(
        T.LinearVariationalProblem(a, L, uc, bcs=bcs),
        solver_parameters={"ksp_type": "preonly", "pc_type": "scpc",
                           "condensed_field": {"ksp_type": "cg",
                                               "pc_type": "jacobi",
                                               "ksp_rtol": 1e-13}})
    s.solve()
    assert s.converged and s.ksp_iterations > 1
    _close(uc.dat, us.dat, 1e-10)


def test_scpc_without_interior_dofs_raises():
    V, a, L, bcs = _scpc_problem(2, 2)
    with pytest.raises(ValueError, match="no cell-interior dofs"):
        T.solve(a == L, T.Function(V), bcs=bcs,
                solver_parameters={"pc_type": "scpc"})


def test_hybridization_rejects_other_flux_spaces_and_distributed():
    V = T.FunctionSpace(T.UnitSquareMesh(2, 2), "CG", 1)
    W = V * V
    s, q = T.TrialFunctions(W)
    t, v = T.TestFunctions(W)
    with pytest.raises(NotImplementedError, match="RT/BDM"):
        T.solve((s * t + q * v) * T.dx == v * T.dx, T.Function(W),
                solver_parameters={"pc_type": "hybridization"})
    W, a, L = _mixed_poisson(2, "RT", 1, 0)
    with pytest.raises(NotImplementedError, match="item 20\\b"):
        _solve(W, a, L, dict(HYB, distributed=2))


# ----------------------------------------------- K2 on the packed blocks
def _packed_hybrid_blocks(degree):
    """The broken local operators that hybridization inverts per cell,
    packed as Slate packs them: (A (nc, n, n), flux dofs per cell)."""
    from firedrake_tpu_torch.solvers.hybridization import _broken_problem
    W, a, L = _mixed_poisson(4, "RT", degree, degree - 1)
    a_b, _, Wd, _ = _broken_problem(a, L, W)
    A = TS._eval_local(T.Tensor(a_b, axes=(Wd, Wd)), {}).cell
    return A, Wd.subspaces[0].element.ndof, a_b, Wd


@pytest.mark.parametrize("degree", [1, 2])
def test_k2_plain_equals_linalg_inv_on_hybridized_blocks(degree):
    A, nsig, _, _ = _packed_hybrid_blocks(degree)
    n = nsig + degree * (degree + 1) // 2
    assert A.shape == (32, n, n)
    X = batched_inv_plain(A)
    _close(X, torch.linalg.inv(A), 1e-12)


def test_flux_block_is_packed_first():
    """K2 does not pivot: the broken mixed matrix [[M, -B^T], [-B, 0]]
    has a zero DG block, and its pivots stay nonzero only because the
    flux dofs come first.  The packed tensor holds the flux mass block in
    its leading rows and columns and a zero trailing block; packed the
    other way round, the first pivot is zero."""
    A, nsig, a_b, Wd = _packed_hybrid_blocks(1)
    from firedrake_tpu_torch.mixed import extract_block
    mass = TS._local_form_tensor(extract_block(a_b, 0, 0)).cell
    assert torch.equal(A[:, :nsig, :nsig], mass)
    assert torch.all(torch.diagonal(A[:, :nsig, :nsig], dim1=1, dim2=2) > 0)
    assert torch.equal(A[:, nsig:, nsig:], torch.zeros_like(A[:, nsig:,
                                                              nsig:]))
    assert torch.isfinite(batched_inv_plain(A)).all()
    perm = torch.cat([torch.arange(nsig, A.shape[-1]), torch.arange(nsig)])
    swapped = A[:, perm][:, :, perm]
    assert not torch.isfinite(batched_inv_plain(swapped)).all()
