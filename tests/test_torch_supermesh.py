"""Supermesh mixed mass matrices and conservative projection of the port
against the JAX package, on the CPU.

The port clips every candidate pair at once on its device in 2D
(``supermesh.clip_batch``), where the JAX package loops over pairs; it
is held here to the per-pair transcription, which is the JAX package's
arithmetic bit for bit.  Sparsity patterns equal bit for bit; matrix
values and projections within 1e-12 of max|ref| (f64).  The 3D meshes
are smaller than the JAX tests' (the JAX package's host loops take ~20 s
over those tets); the cells and the code paths are the same."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
import jax

import firedrake_tpu as J
import firedrake_tpu_torch as T
from firedrake_tpu import supermesh as JS
from firedrake_tpu_torch import supermesh as TS
from firedrake_tpu_torch.device import to_numpy

NO_OPT = "jax_disable_most_optimizations"


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    T.set_device("cpu")
    opt = jax.config.read(NO_OPT)
    jax.config.update(NO_OPT, True)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    jax.config.update(NO_OPT, opt)
    jax.clear_caches()
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(to_numpy(x), dtype=np.float64)


def _close(ours, ref, tol=1e-12):
    ours, ref = _np(ours), np.asarray(ref, dtype=np.float64)
    assert ours.shape == ref.shape
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(ours - ref).max() <= tol * scale, \
        np.abs(ours - ref).max() / scale


#: (mesh A, mesh B, degree A, degree B, vector) per cell kind
CASES = {
    "tri": (lambda fd: fd.UnitSquareMesh(8, 8),
            lambda fd: fd.UnitSquareMesh(5, 7), 1, 2, False),
    "quad": (lambda fd: fd.UnitSquareMesh(6, 6, quadrilateral=True),
             lambda fd: fd.UnitSquareMesh(4, 5, quadrilateral=True), 1, 2,
             False),
    "tet": (lambda fd: fd.UnitCubeMesh(1, 2, 2),
            lambda fd: fd.UnitCubeMesh(2, 1, 2), 1, 1, False),
    "hex": (lambda fd: fd.UnitCubeMesh(1, 2, 2, hexahedral=True),
            lambda fd: fd.UnitCubeMesh(2, 1, 3, hexahedral=True), 1, 1,
            False),
    "vector": (lambda fd: fd.UnitSquareMesh(6, 6),
               lambda fd: fd.UnitSquareMesh(4, 5), 1, 2, True),
}


def _spaces(fd, kind):
    mA, mB, dA, dB, vec = CASES[kind]
    FS = fd.VectorFunctionSpace if vec else fd.FunctionSpace
    return FS(mA(fd), "CG", dA), FS(mB(fd), "CG", dB)


@pytest.mark.parametrize("kind", list(CASES))
def test_mixed_mass_matrix_matches_jax(kind):
    """assemble_mixed_mass_matrix on triangles, quads, tets, hexes and a
    vector space; its entries sum to the domain's measure."""
    mats = [mod.assemble_mixed_mass_matrix(*_spaces(fd, kind))
            for fd, mod in ((J, JS), (T, TS))]
    for name in ("coo_rows", "coo_cols", "indptr"):
        assert np.array_equal(getattr(mats[0].sparsity, name),
                              getattr(mats[1].sparsity, name)), name
    _close(mats[1].data, mats[0].data)
    bs = 2 if CASES[kind][4] else 1
    assert abs(float(_np(mats[1].data).sum()) - bs) < 1e-12


def _projections(fd, mod, kind):
    """supermesh_project of a field both spaces hold exactly and of one
    they do not; (the two projections, their sources)."""
    VA, VB = _spaces(fd, kind)
    XB = fd.SpatialCoordinate(VB.mesh())
    if CASES[kind][4]:
        exprs = (fd.as_vector([XB[0] + XB[1], 2 - XB[1]]),
                 fd.as_vector([fd.sin(XB[0]), XB[1] ** 3]))
    else:
        exprs = (XB[0] - 3 * XB[1], fd.sin(XB[0]) * XB[1] ** 2)
    fs = [fd.Function(VB).interpolate(e) for e in exprs]
    return [mod.supermesh_project(f, VA) for f in fs], fs


@pytest.mark.parametrize("kind", ["tri", "quad", "vector"])
def test_supermesh_project_matches_jax(kind):
    """The projections equal the JAX package's; they reproduce a linear
    field and conserve every component's integral."""
    (uj, _), _ = _projections(J, JS, kind)
    (ut, ut2), (ft, ft2) = _projections(T, TS, kind)
    _close(ut.dat, np.asarray(uj.dat))
    for c in range(2 if CASES[kind][4] else 1):
        pick = (lambda w: w[c]) if CASES[kind][4] else (lambda w: w)
        assert abs(T.assemble(pick(ut2) * T.dx)
                   - T.assemble(pick(ft2) * T.dx)) < 1e-12
    XA = T.SpatialCoordinate(ut.function_space().mesh())
    exact = (T.as_vector([XA[0] + XA[1], 2 - XA[1]]) if CASES[kind][4]
             else XA[0] - 3 * XA[1])
    assert T.errornorm(exact, ut) < 1e-10


def _random_convex(rng, n, k):
    """n random ccw convex polygons of k vertices (triangles, or
    quadrilaterals from sorted angles on a jittered circle), some of them
    sharing vertices with the clip polygons below."""
    c = rng.uniform(0.3, 0.7, (n, 1, 2))
    ang = np.sort(rng.uniform(0, 2 * np.pi, (n, k)), axis=1)
    r = rng.uniform(0.1, 0.3, (n, 1))
    return c + r[..., None] * np.stack([np.cos(ang), np.sin(ang)], -1)


@pytest.mark.parametrize("ka, kb", [(3, 3), (4, 4), (3, 4)])
def test_batched_clipping_matches_per_pair(ka, kb):
    """clip_batch on 400 seeded pairs (disjoint, overlapping, nested, and
    pairs sharing an edge) against the per-pair transcription, and that
    against the JAX package's intersect_polys bit for bit."""
    rng = np.random.default_rng(11)
    A = _random_convex(rng, 400, ka)
    B = _random_convex(rng, 400, kb)
    B[:40, 0], B[:40, 1] = A[:40, 1], A[:40, 0]       # a shared edge
    B[40:60] = A[40:60, :kb] if kb <= ka else B[40:60]
    poly, cnt = TS.clip_batch(torch.as_tensor(A),
                              torch.full((400,), ka), torch.as_tensor(B),
                              torch.full((400,), kb))
    poly, cnt = poly.numpy(), cnt.numpy()
    met = 0
    for i in range(400):
        ref = TS.intersect_polys(list(A[i]), list(B[i]))
        jref = JS.intersect_polys(list(A[i]), list(B[i]))
        assert len(ref) == len(jref) and all(
            np.array_equal(p, q) for p, q in zip(ref, jref))
        assert cnt[i] == len(ref)
        if len(ref):
            met += 1
            assert np.abs(poly[i, :len(ref)] - np.array(ref)).max() <= 1e-12
    assert 50 < met < 400
