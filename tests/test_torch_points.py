"""Point evaluation, VertexOnlyMesh, cross-mesh interpolation and HDF5
checkpoints of the port against the JAX package.

Point location must pick the JAX package's cell, also where a point lies
on a facet or a vertex (inside several cells within the tolerance): every
point set holds the mesh's vertices and facet midpoints beside seeded
points inside and outside.  Located cells equal; values within 1e-12 of
max|u| (f64; the port inverts on the device in another rounding).  Spaces:
P1, P2, DG1, vector P2, RT1 and N1curl on affine triangles, Q1, Q2, DQ1
and vector Q2 on quads, P1, P2 and DG1 on a P2-coordinate (curved) mesh,
P1, P2 and DG1 on an immersed manifold (triangles in 3D).  Checkpoint
files written by either package load in the other bit for bit."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
import jax

import firedrake_tpu as J
import firedrake_tpu_torch as T
from firedrake_tpu.pointeval import _locate as j_locate
from firedrake_tpu_torch.pointeval import _locate as t_locate
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


def _mesh(pkg, kind):
    if kind == "affine":
        return pkg.UnitSquareMesh(5, 4)
    if kind == "quad":
        return pkg.UnitSquareMesh(4, 3, quadrilateral=True)
    if kind == "manifold":
        return pkg.UnitIcosahedralSphereMesh(1)
    base = pkg.UnitSquareMesh(4, 4)
    X = pkg.SpatialCoordinate(base)
    Vc = pkg.VectorFunctionSpace(base, "CG", 2)
    return pkg.Mesh(pkg.Function(Vc).interpolate(pkg.as_vector(
        [X[0] + 0.06 * pkg.sin(np.pi * X[0]) * pkg.sin(np.pi * X[1]),
         X[1] + 0.04 * X[0] * X[1] * (1 - X[1])])))


def _points(mesh, seed):
    """Every vertex, every facet midpoint and seeded points in and around
    the domain (on the sphere's surface, its cells' centroids pushed a
    little off it and a point far off)."""
    rng = np.random.default_rng(seed)
    vc = mesh._vertex_coords
    fv = np.asarray(mesh.topology.facet_vertices)
    mids = vc[fv].mean(axis=1)
    g = vc.shape[1]
    if g == 3:
        cen = vc[mesh.topology.cell_vertices].mean(axis=1)
        return np.concatenate([vc, mids, cen * 1.01, [[0.0, 0.0, 3.0]]])
    return np.concatenate([vc, mids, rng.uniform(-0.1, 1.1, (60, g))])


SPACES = {
    "affine": [("CG", 1), ("CG", 2), ("DG", 1), ("VCG", 2), ("RT", 1),
               ("N1curl", 1)],
    "quad": [("CG", 1), ("CG", 2), ("DG", 1), ("VCG", 2)],
    "curved": [("CG", 1), ("CG", 2), ("DG", 1)],
    "manifold": [("CG", 1), ("CG", 2), ("DG", 1)],
}


def _space(pkg, mesh, fam, deg):
    if fam == "VCG":
        return pkg.VectorFunctionSpace(mesh, "CG", deg)
    return pkg.FunctionSpace(mesh, fam, deg)


def _pair(kind, fam, deg, seed=1):
    """The same random Function in both packages."""
    out = []
    for pkg in (J, T):
        mesh = _mesh(pkg, kind)
        V = _space(pkg, mesh, fam, deg)
        out.append((mesh, V))
    (mj, Vj), (mt, Vt) = out
    w = np.random.default_rng(seed).standard_normal(Vj.dim)
    return mj, J.Function(Vj, val=w), mt, T.Function(Vt, val=w)


def _close(ours, ref, rtol=1e-12):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    assert np.array_equal(np.isnan(ours), np.isnan(ref))
    scale = np.nanmax(np.abs(ref))
    assert np.nanmax(np.abs(ours - ref)) <= rtol * scale


@pytest.mark.parametrize("kind", list(SPACES))
def test_located_cells_match_jax(kind):
    mj, mt = _mesh(J, kind), _mesh(T, kind)
    pts = _points(mj, seed=len(kind))
    cj, rj = j_locate(mj, pts)
    ct, rt = t_locate(mt, pts)
    assert np.array_equal(cj, ct)
    assert (ct >= 0).sum() > 0.8 * len(pts)
    _close(to_numpy(rt), rj, rtol=1e-10)


@pytest.mark.parametrize("kind, fam, deg", [
    (k, f, d) for k, sp in SPACES.items() for f, d in sp])
def test_at_matches_jax(kind, fam, deg):
    mj, uj, mt, ut = _pair(kind, fam, deg)
    pts = _points(mj, seed=3)
    _close(ut.at(pts, dont_raise=True), uj.at(pts, dont_raise=True))
    cells, refs = j_locate(mj, pts)
    from firedrake_tpu.pointeval import eval_at_cells as j_eval
    from firedrake_tpu_torch.pointeval import eval_at_cells as t_eval
    _close(t_eval(ut, cells, refs), j_eval(uj, cells, refs))


def test_at_call_forms_and_errors():
    """u.at(p), u.at(x, y), u((x, y)) and u.vector() give the JAX
    package's values; an outside point raises PointNotInDomainError."""
    mj, uj, mt, ut = _pair("affine", "CG", 2)
    p = (0.3, 0.7)
    for call in (lambda u: u.at(p), lambda u: u.at(*p), lambda u: u(p),
                 lambda u: u.at([p, (0.1, 0.2)])):
        _close(call(ut), call(uj))
    assert np.array_equal(to_numpy(ut.vector()), np.asarray(uj.vector()))
    for pkg, u in ((J, uj), (T, ut)):
        with pytest.raises(pkg.PointNotInDomainError):
            u.at((1.5, 0.5))


def _vom_pair(points, behaviour="ignore"):
    out = []
    for pkg in (J, T):
        mesh = pkg.UnitSquareMesh(6, 6)
        X = pkg.SpatialCoordinate(mesh)
        u = pkg.Function(pkg.FunctionSpace(mesh, "CG", 2)).interpolate(
            X[0] ** 2 + pkg.sin(X[1]))
        w = pkg.Function(pkg.VectorFunctionSpace(mesh, "CG", 1)).interpolate(
            pkg.as_vector([X[1], 2 * X[0]]))
        vom = pkg.VertexOnlyMesh(mesh, points,
                                 missing_points_behaviour=behaviour)
        out.append((pkg, mesh, u, w, vom))
    return out


VOM_POINTS = np.concatenate([
    np.random.default_rng(5).uniform(-0.2, 1.2, (40, 2)),
    [[0.5, 0.5], [0.0, 0.0], [1 / 3, 0.5], [1.0, 1.0 / 6]]])


def test_vom_missing_point_behaviours():
    inside = VOM_POINTS[((VOM_POINTS >= 0) & (VOM_POINTS <= 1)).all(1)]
    for pkg in (J, T):
        mesh = pkg.UnitSquareMesh(6, 6)
        with pytest.raises(pkg.PointNotInDomainError):
            pkg.VertexOnlyMesh(mesh, VOM_POINTS)
        with pytest.warns(UserWarning, match="not in the parent mesh"):
            vm = pkg.VertexOnlyMesh(mesh, VOM_POINTS,
                                    missing_points_behaviour="warn")
        assert vm.num_cells == len(inside)
        assert pkg.VertexOnlyMesh(mesh, inside).num_cells == len(inside)
    (_, _, _, _, vj), (_, _, _, _, vt) = _vom_pair(VOM_POINTS)
    assert np.array_equal(vj.cells, vt.cells)
    assert np.array_equal(vj.input_found, vt.input_found)
    assert np.array_equal(np.asarray(vj.coordinates.dat),
                          to_numpy(vt.coordinates.dat))


def test_vom_interpolation_and_input_ordering():
    got = {}
    for pkg, mesh, u, w, vom in _vom_pair(VOM_POINTS):
        X = pkg.SpatialCoordinate(mesh)
        P0 = pkg.FunctionSpace(vom, "DG", 0)
        P0v = pkg.VectorFunctionSpace(vom, "DG", 0)
        g = pkg.Function(P0).interpolate(u)
        h = pkg.Function(P0).interpolate(pkg.sin(X[0]) * u + 2.0
                                         + pkg.Constant(0.5) * abs(X[1]))
        gv = pkg.Function(P0v).interpolate(w)
        dot = pkg.Function(P0).interpolate(pkg.dot(w, w) + w[1])
        io = pkg.FunctionSpace(vom.input_ordering, "DG", 0)
        back = pkg.Function(io).interpolate(g)
        # and back from the input ordering to the found points
        again = pkg.Function(P0).interpolate(back)
        got[pkg] = [np.asarray(to_numpy(f.dat))
                    for f in (g, h, gv, dot, back, again)]
    for a, b in zip(got[T], got[J]):
        _close(a, b)
    assert np.isnan(got[T][4]).sum() == len(VOM_POINTS) - len(got[T][0])


def test_vom_inner_of_vectors():
    """inner(w, w) of a vector Function at a vertex mesh's points: the
    JAX package's einsum ("p...,p...->p") raises ValueError in numpy; the
    port gives dot(w, w)."""
    (_, _, _, wj, vj), (_, _, _, wt, vt) = _vom_pair(VOM_POINTS)
    with pytest.raises(ValueError, match="einstein sum"):
        J.Function(J.FunctionSpace(vj, "DG", 0)).interpolate(J.inner(wj, wj))
    ref = J.Function(J.FunctionSpace(vj, "DG", 0)).interpolate(J.dot(wj, wj))
    got = T.Function(T.FunctionSpace(vt, "DG", 0)).interpolate(T.inner(wt, wt))
    _close(to_numpy(got.dat), np.asarray(ref.dat))


def test_vom_to_vom_and_point_integrals():
    """A transfer between unrelated vertex meshes (points matched by
    coordinates, NaN where unmatched) and dx on a vertex mesh: rank 0 and
    rank 1."""
    pts_b = np.concatenate([VOM_POINTS[::-3], [[0.123, 0.456]]])
    got = {}
    for pkg, mesh, u, w, vom in _vom_pair(VOM_POINTS):
        vb = pkg.VertexOnlyMesh(mesh, pts_b, missing_points_behaviour="warn")
        g = pkg.Function(pkg.FunctionSpace(vom, "DG", 0)).interpolate(u)
        Pb = pkg.FunctionSpace(vb, "DG", 0)
        gb = pkg.Function(Pb).interpolate(g)
        y = pkg.Function(pkg.FunctionSpace(vom, "DG", 0), val=np.linspace(
            0, 1, vom.num_cells))
        J0 = pkg.assemble((g - y) ** 2 * pkg.dx)
        q = pkg.TestFunction(pkg.FunctionSpace(vom, "DG", 0))
        J1 = pkg.assemble((g - y) * q * pkg.dx + 2.0 * q * pkg.dx)
        got[pkg] = (to_numpy(gb.dat), J0, to_numpy(J1.dat))
    _close(got[T][0], got[J][0])
    assert np.isnan(got[T][0][-1])
    assert abs(got[T][1] - got[J][1]) <= 1e-12 * abs(got[J][1])
    assert isinstance(got[T][1], float)
    _close(got[T][2], got[J][2])


@pytest.mark.parametrize("fam, deg, vector", [("CG", 1, False),
                                              ("DG", 1, False),
                                              ("CG", 2, True)])
def test_cross_mesh_interpolation_matches_jax(fam, deg, vector):
    got = {}
    for pkg in (J, T):
        src = pkg.UnitSquareMesh(5, 5)
        X = pkg.SpatialCoordinate(src)
        if vector:
            Vs = pkg.VectorFunctionSpace(src, "CG", 2)
            f = pkg.Function(Vs).interpolate(pkg.as_vector([X[0] * X[1],
                                                            X[0] ** 2]))
            Vd = pkg.VectorFunctionSpace(pkg.UnitSquareMesh(7, 3), fam, deg)
        else:
            f = pkg.Function(pkg.FunctionSpace(src, "CG", 2)).interpolate(
                pkg.cos(X[0]) * X[1])
            Vd = pkg.FunctionSpace(pkg.RectangleMesh(7, 3, 1.2, 1.0), fam,
                                   deg)
        got[pkg] = to_numpy(pkg.Function(Vd).interpolate(f).dat)
    _close(got[T], got[J])


# ------------------------------------------------------------ checkpoints
def _ckpt_case(pkg):
    mesh = pkg.UnitSquareMesh(4, 3, name="ckmesh")
    cen = mesh._vertex_coords[mesh.topology.cell_vertices].mean(axis=1)
    mesh.mark_cells(np.where(cen[:, 0] < 0.5, 3, 4))
    X = pkg.SpatialCoordinate(mesh)
    u = pkg.Function(pkg.FunctionSpace(mesh, "CG", 2), name="u").interpolate(
        X[0] * X[1] + 1)
    v = pkg.Function(pkg.VectorFunctionSpace(mesh, "DG", 1),
                     name="v").interpolate(pkg.as_vector([X[1], -X[0]]))
    W = pkg.MixedFunctionSpace([pkg.FunctionSpace(mesh, "RT", 1),
                                pkg.FunctionSpace(mesh, "DG", 0)])
    w = pkg.Function(W, name="w")
    w.dat = np.random.default_rng(2).standard_normal(W.dim)
    return mesh, u, v, w


def _write_ckpt(pkg, path):
    mesh, u, v, w = _ckpt_case(pkg)
    with pkg.CheckpointFile(str(path), pkg.FILE_CREATE) as f:
        f.save_mesh(mesh)
        f.save_function(u)
        f.save_function(v)
        f.save_function(w)
        for i in range(3):
            u.assign(u + 1.0)
            f.save_function(u, idx=i, timestepping_info={
                "time": 0.1 * i, "timestep": 0.1})
    with pkg.DumbCheckpoint(str(path.with_suffix("")) + "_dumb",
                            mode=pkg.FILE_CREATE) as f:
        f.store(v)
    return mesh, u, v, w


def _dat(f):
    return np.asarray(to_numpy(f.dat))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_files_cross_packages(tmp_path, writer):
    """A file written by one package (mesh with cell markers, P2, vector
    DG1, an RT1 x DG0 mixed Function, three timesteps of u, a
    DumbCheckpoint) loads in the other bit for bit."""
    W_, R_ = (J, T) if writer == "jax" else (T, J)
    path = tmp_path / "ck.h5"
    mesh, u, v, w = _write_ckpt(W_, path)
    with R_.CheckpointFile(str(path), R_.FILE_READ) as f:
        m2 = f.load_mesh("ckmesh")
        for x, y in ((mesh.topology.cell_vertices,
                      m2.topology.cell_vertices),
                     (mesh._vertex_coords, m2._vertex_coords),
                     (mesh.cell_markers, m2.cell_markers),
                     (mesh.facet_markers, m2.facet_markers)):
            assert np.array_equal(np.asarray(x), np.asarray(y))
        for g in (v, w):
            assert np.array_equal(_dat(f.load_function(m2, g.name)),
                                  _dat(g))
        assert np.array_equal(_dat(f.load_function(m2, "u", idx=2)),
                              _dat(u))
        hist = f.get_timestepping_history(m2, "u")
        assert hist["index"] == [0, 1, 2]
        assert hist["time"] == [0.0, 0.1, 0.2]
        assert hist["timestep"] == [0.1] * 3
        V = R_.VectorFunctionSpace(m2, "DG", 1)
    g = R_.Function(V, name="v")
    with R_.DumbCheckpoint(str(tmp_path / "ck_dumb"),
                           mode=R_.FILE_READ) as f:
        f.load(g)
    assert np.array_equal(_dat(g), _dat(v))


def test_checkpoint_vertex_only_mesh(tmp_path):
    """A VertexOnlyMesh and a Function on it saved by the JAX package,
    loaded by the port: the same located cells and values."""
    for writer, reader in ((J, T), (T, J)):
        path = tmp_path / f"vom_{writer.__name__}.h5"
        mesh = writer.UnitSquareMesh(5, 5, name="parent")
        vom = writer.VertexOnlyMesh(mesh, VOM_POINTS[:20],
                                    missing_points_behaviour="ignore",
                                    name="obs")
        X = writer.SpatialCoordinate(mesh)
        y = writer.Function(writer.FunctionSpace(vom, "DG", 0),
                            name="y").interpolate(X[0] + X[1])
        with writer.CheckpointFile(str(path), "w") as f:
            f.save_mesh(vom)
            f.save_function(y)
        with reader.CheckpointFile(str(path), "r") as f:
            v2 = f.load_mesh("obs")
            y2 = f.load_function(v2, "y")
        assert np.array_equal(v2.cells, vom.cells)
        assert np.array_equal(_dat(y2), _dat(y))
