"""The port's mesh readers and Mesh() factory against the JAX package:
gmsh ASCII v2.2 and v4.1 (with $Entities, and with a parametric node
block), Exodus II (two element blocks, side sets), CGNS and a duck-typed
netgen object, in 2D and 3D, with triangles, quads, tets and hexes.  Cells,
coordinates and both marker arrays must be equal bit for bit (dtypes
too).  The files are written here, at a few hundred cells.

Where the JAX package reads a file wrongly, a test shows its behaviour
beside the port's: a gmsh file of second-order triangles (read as an
interval mesh there, refused here), a parametric v4.1 node block
(KeyError there), an Exodus TRI6 block (cut to TRI3 there), an unsupported
CGNS section (skipped there) and CGNS BCs in a file that tracks creation
order (numbered by first element there, in file order here).

One whole-slice case assembles the Neumann Helmholtz operator and load of
chip_smoke.py's meshio phase on a small gmsh file through both packages'
gather routes (within 1e-12), and holds the port's CG solve to scipy's
spsolve of the JAX matrix."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
import jax

import firedrake_tpu as J
import firedrake_tpu_torch as T
from firedrake_tpu.mesh.io_exodus import _EXO_SIDES
from firedrake_tpu_torch.mesh.io_msh import match_rows
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


# ------------------------------------------------------------- meshes
def _grid(cell, n, seed=0):
    """(coords (nv, 3), cells in the file formats' vertex order, cell tags,
    boundary facet blocks [(rows, tag)]) of the unit square or cube cut
    into n^d boxes: triangles two per square, quads, tets six per cube
    (Kuhn), hexes; interior vertices of the simplex meshes jittered.  A
    cell is tagged 1 where its centroid has x < 0.5, else 2 (region 1's
    cells first); boundary facets are tagged 1, 2 (x = 0, 1), 3, 4 (y),
    5, 6 (z)."""
    dim = 2 if cell in ("triangle", "quadrilateral") else 3
    idx = np.stack(np.meshgrid(*[np.arange(n + 1)] * dim, indexing="ij"),
                   axis=-1).reshape(-1, dim)
    xyz = np.zeros((len(idx), 3))
    xyz[:, :dim] = idx / n
    if cell in ("triangle", "tetrahedron"):
        inner = ((idx > 0) & (idx < n)).all(axis=1)
        rng = np.random.default_rng(seed)
        xyz[inner, :dim] += rng.uniform(-0.2 / n, 0.2 / n,
                                        (int(inner.sum()), dim))
    vid = lambda *ijk: np.ravel_multi_index(ijk, (n + 1,) * dim)
    box = np.stack(np.meshgrid(*[np.arange(n)] * dim, indexing="ij"),
                   axis=-1).reshape(-1, dim)
    corner = {}
    for off in np.ndindex(*(2,) * dim):
        corner[off] = vid(*(box + np.array(off)).T)
    if cell == "triangle":
        c = [[corner[0, 0], corner[1, 0], corner[1, 1]],
             [corner[0, 0], corner[1, 1], corner[0, 1]]]
    elif cell == "quadrilateral":
        c = [[corner[0, 0], corner[1, 0], corner[1, 1], corner[0, 1]]]
    elif cell == "hexahedron":
        c = [[corner[0, 0, 0], corner[1, 0, 0], corner[1, 1, 0],
              corner[0, 1, 0], corner[0, 0, 1], corner[1, 0, 1],
              corner[1, 1, 1], corner[0, 1, 1]]]
    else:
        import itertools
        c = []
        for perm in itertools.permutations(range(3)):
            path = [np.zeros(3, dtype=int)]
            for ax in perm:
                step = path[-1].copy()
                step[ax] = 1
                path.append(step)
            c.append([corner[tuple(p)] for p in path])
    cells = np.stack([np.stack(cc, axis=1) for cc in c],
                     axis=1).reshape(-1, len(c[0]))
    tags = np.where(xyz[cells].mean(axis=1)[:, 0] < 0.5, 1, 2)
    order = np.argsort(tags, kind="stable")
    cells, tags = cells[order], tags[order]
    nfv = {"triangle": 2, "quadrilateral": 2, "tetrahedron": 3,
           "hexahedron": 4}[cell]
    sides = _EXO_SIDES[cell]
    allf = np.concatenate([cells[:, list(s)] for s in sides])
    key = np.sort(allf, axis=1)
    _, first, count = np.unique(key, axis=0, return_index=True,
                                return_counts=True)
    bnd = allf[first[count == 1]]
    blocks = []
    for ax in range(dim):
        for side, val in ((0, 0.0), (1, 1.0)):
            on = np.isclose(xyz[bnd][:, :, ax], val).all(axis=1)
            blocks.append((bnd[on], 2 * ax + side + 1))
    assert all(len(r[0][0]) == nfv for r in blocks)
    return xyz, cells, tags, blocks


_GMSH_TYPE = {"triangle": 2, "quadrilateral": 3, "tetrahedron": 4,
              "hexahedron": 5}
_GMSH_FACET = {2: 1, 3: 1, 4: 2, 5: 3}


def _xyz(row):
    """A node's coordinates as text that reads back to the same floats."""
    return " ".join(repr(float(v)) for v in row)


def _write_v22(path, xyz, cells, tags, blocks, cell):
    et = _GMSH_TYPE[cell]
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes",
             str(len(xyz))]
    lines += [f"{i + 1} " + _xyz(r) for i, r in enumerate(xyz)]
    lines += ["$EndNodes", "$Elements"]
    els = [(_GMSH_FACET[et], t, r) for rows, t in blocks for r in rows]
    els += [(et, t, r) for r, t in zip(cells, tags)]
    lines.append(str(len(els)))
    lines += [f"{i + 1} {e} 2 {t} {t} " + " ".join(str(v + 1) for v in r)
              for i, (e, t, r) in enumerate(els)]
    lines.append("$EndElements")
    path.write_text("\n".join(lines) + "\n")


def _write_v41(path, xyz, cells, tags, blocks, cell, parametric=False):
    """v4.1 with $Entities: surfaces/volumes 1, 2 (the regions) and one
    entity per boundary side (physical tag 10 times its number, so that
    the physical tag, not the entity tag, must reach the markers).  With
    `parametric`, the first node block is one node on a curve entity
    carrying its parametric coordinate u."""
    et = _GMSH_TYPE[cell]
    dim = 2 if et in (2, 3) else 3
    out = ["$MeshFormat", "4.1 0 8", "$EndMeshFormat", "$Entities"]
    counts = [0, 0, 0, 0]
    counts[dim - 1] = len(blocks)
    counts[dim] = 2
    if parametric and dim == 2:
        counts[1] += 1
    out.append(" ".join(map(str, counts)))
    ents = [(dim - 1, t, 10 * t) for _, t in blocks] + \
        [(dim, 1, 1), (dim, 2, 2)]
    if parametric and dim == 2:
        ents.insert(0, (1, 7, 70))
    for d in range(1, 4):
        for ed, tag, ph in ents:
            if ed == d:
                out.append(f"{tag} 0 0 0 1 1 1 1 {ph} 0")
    out.append("$EndEntities")
    nn = len(xyz)
    out += ["$Nodes"]
    if parametric:
        out += [f"2 {nn} 1 {nn}", "1 7 1 1", "1", _xyz(xyz[0]) + " 0.5",
                f"{dim} 1 0 {nn - 1}"]
        out += [str(i + 1) for i in range(1, nn)]
        out += [_xyz(r) for r in xyz[1:]]
    else:
        out += [f"1 {nn} 1 {nn}", f"{dim} 1 0 {nn}"]
        out += [str(i + 1) for i in range(nn)]
        out += [_xyz(r) for r in xyz]
    out.append("$EndNodes")
    eblocks = [(dim - 1, t, _GMSH_FACET[et], rows) for rows, t in blocks]
    eblocks += [(dim, t, et, cells[tags == t]) for t in (1, 2)]
    ntot = sum(len(b[3]) for b in eblocks)
    out += ["$Elements", f"{len(eblocks)} {ntot} 1 {ntot}"]
    eid = 1
    for ed, tag, etype, rows in eblocks:
        out.append(f"{ed} {tag} {etype} {len(rows)}")
        for r in rows:
            out.append(f"{eid} " + " ".join(str(v + 1) for v in r))
            eid += 1
    out.append("$EndElements")
    path.write_text("\n".join(out) + "\n")


def _sides_of(cells, cell, rows):
    """(element, local side) of each boundary facet row, 0-based."""
    sides = _EXO_SIDES[cell]
    key = {}
    for e, c in enumerate(cells):
        for s, loc in enumerate(sides):
            key.setdefault(tuple(sorted(c[list(loc)])), (e, s))
    return np.array([key[tuple(sorted(r))] for r in rows])


def _write_exodus(path, xyz, cells, tags, blocks, cell, etype=None):
    from scipy.io import netcdf_file
    dim = 2 if cell in ("triangle", "quadrilateral") else 3
    name = etype or {"triangle": "TRI3", "quadrilateral": "QUAD4",
                     "tetrahedron": "TETRA4", "hexahedron": "HEX8"}[cell]
    nc = netcdf_file(str(path), "w")
    nc.createDimension("num_dim", dim)
    nc.createDimension("num_nodes", len(xyz))
    nc.createDimension("num_elem", len(cells))
    nc.createDimension("num_el_blk", 2)
    nc.createDimension("num_side_sets", len(blocks))
    for k, ax in enumerate(("coordx", "coordy", "coordz")[:dim]):
        nc.createVariable(ax, "d", ("num_nodes",))[:] = xyz[:, k]
    nc.createVariable("eb_prop1", "i", ("num_el_blk",))[:] = [7, 8]
    for b in (1, 2):
        conn = cells[tags == b] + 1
        nc.createDimension(f"num_el_in_blk{b}", len(conn))
        nc.createDimension(f"num_nod_per_el{b}", conn.shape[1])
        v = nc.createVariable(f"connect{b}", "i", (f"num_el_in_blk{b}",
                                                   f"num_nod_per_el{b}"))
        v.elem_type = name
        v[:] = conn
    nc.createVariable("ss_prop1", "i", ("num_side_sets",))[:] = \
        [10 * t for _, t in blocks]
    for s, (rows, _) in enumerate(blocks, start=1):
        es = _sides_of(cells, cell, rows)
        nc.createDimension(f"num_side_ss{s}", len(rows))
        nc.createVariable(f"elem_ss{s}", "i", (f"num_side_ss{s}",))[:] = \
            es[:, 0] + 1
        nc.createVariable(f"side_ss{s}", "i", (f"num_side_ss{s}",))[:] = \
            es[:, 1] + 1
    nc.close()


def _cgns_node(parent, name, label, data=None):
    g = parent.create_group(name)
    g.attrs["name"] = np.bytes_(name)
    g.attrs["label"] = np.bytes_(label)
    if data is not None:
        g.create_dataset(" data", data=data)
    return g


_CGNS_TYPE = {"triangle": 5, "quadrilateral": 7, "tetrahedron": 10,
              "hexahedron": 17}
_CGNS_FACET = {5: 3, 7: 3, 10: 5, 17: 7}


def _write_cgns(path, xyz, cells, tags, blocks, cell, bc_names=None,
                bc_order=None, track=False, extra_section=None):
    """A CGNS/HDF5 file: the cells, then the boundary facets block by
    block, one BC_t per block; `bc_names` names the BCs (in block order),
    `bc_order` is the order in which the BC groups are created, `track`
    makes the ZoneBC_t group track creation order, `extra_section` adds an
    Elements_t section of that ElementType_t code."""
    import h5py
    et = _CGNS_TYPE[cell]
    dim = 2 if et in (5, 7) else 3
    with h5py.File(str(path), "w") as f:
        base = _cgns_node(f, "Base", "CGNSBase_t",
                          np.array([dim, dim], dtype=np.int32))
        zone = _cgns_node(base, "Zone", "Zone_t",
                          np.array([[len(xyz), len(cells), 0]],
                                   dtype=np.int32))
        _cgns_node(zone, "ZoneType", "ZoneType_t",
                   np.frombuffer(b"Unstructured", dtype=np.int8))
        gc = _cgns_node(zone, "GridCoordinates", "GridCoordinates_t")
        for k, nm in enumerate(("CoordinateX", "CoordinateY",
                                "CoordinateZ")[:dim]):
            _cgns_node(gc, nm, "DataArray_t", xyz[:, k].copy())
        sec = _cgns_node(zone, "Cells", "Elements_t",
                         np.array([et, 0], dtype=np.int32))
        _cgns_node(sec, "ElementRange", "IndexRange_t",
                   np.array([1, len(cells)], dtype=np.int32))
        _cgns_node(sec, "ElementConnectivity", "DataArray_t",
                   (cells + 1).astype(np.int32).reshape(-1))
        rows = np.concatenate([r for r, _ in blocks])
        start = len(cells) + 1
        fs = _cgns_node(zone, "Facets", "Elements_t",
                        np.array([_CGNS_FACET[et], 0], dtype=np.int32))
        _cgns_node(fs, "ElementRange", "IndexRange_t",
                   np.array([start, start + len(rows) - 1],
                            dtype=np.int32))
        _cgns_node(fs, "ElementConnectivity", "DataArray_t",
                   (rows + 1).astype(np.int32).reshape(-1))
        if extra_section is not None:
            xs = _cgns_node(zone, "Extra", "Elements_t",
                            np.array([extra_section, 0], dtype=np.int32))
            _cgns_node(xs, "ElementRange", "IndexRange_t",
                       np.array([start + len(rows), start + len(rows)],
                                dtype=np.int32))
            _cgns_node(xs, "ElementConnectivity", "DataArray_t",
                       np.arange(1, 7, dtype=np.int32))
        zbc = zone.create_group("ZoneBC", track_order=track)
        zbc.attrs["name"] = np.bytes_("ZoneBC")
        zbc.attrs["label"] = np.bytes_("ZoneBC_t")
        names = bc_names or [f"bc{t}" for _, t in blocks]
        firsts = start + np.cumsum([0] + [len(r) for r, _ in blocks])
        for i in (bc_order or range(len(blocks))):
            bc = _cgns_node(zbc, names[i], "BC_t",
                            np.frombuffer(b"BCWall", dtype=np.int8))
            _cgns_node(bc, "PointRange", "IndexRange_t",
                       np.array([firsts[i], firsts[i + 1] - 1],
                                dtype=np.int32))


def _same(a, b):
    """The JAX package's mesh a and the port's b: cells, coordinates and
    both marker arrays bit for bit, dtypes included."""
    for x, y in ((a.topology.cell_vertices, b.topology.cell_vertices),
                 (a._vertex_coords, b._vertex_coords),
                 (a.cell_markers, b.cell_markers),
                 (a.facet_markers, b.facet_markers)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)
    assert a.cell.name == b.cell.name
    assert a.geometric_dimension == b.geometric_dimension


GRIDS = {"triangle": 10, "quadrilateral": 9, "tetrahedron": 3,
         "hexahedron": 4}


@pytest.mark.parametrize("fmt", ["v22", "v41", "v41_parametric", "exodus",
                                 "cgns"])
@pytest.mark.parametrize("cell", list(GRIDS))
def test_reader_matches_jax(tmp_path, cell, fmt):
    arrays = _grid(cell, GRIDS[cell])
    if fmt == "v22":
        p = tmp_path / "m.msh"
        _write_v22(p, *arrays, cell)
    elif fmt.startswith("v41"):
        p = tmp_path / "m.msh"
        _write_v41(p, *arrays, cell, parametric=fmt == "v41_parametric")
    elif fmt == "exodus":
        p = tmp_path / "m.exo"
        _write_exodus(p, *arrays, cell)
    else:
        p = tmp_path / "m.cgns"
        _write_cgns(p, *arrays, cell)
    b = T.Mesh(str(p))
    if fmt == "v41_parametric":
        # the JAX package takes u for the next node's x (KeyError); the
        # port reads the file as the same file without the parametric
        # block
        with pytest.raises(KeyError):
            J.Mesh(str(p))
        q = tmp_path / "plain.msh"
        _write_v41(q, *arrays, cell)
        a = J.Mesh(str(q))
        assert np.array_equal(a.facet_markers, b.facet_markers)
    else:
        a = J.Mesh(str(p))
    _same(a, b)
    assert (b.facet_markers > 0).sum() == sum(len(r) for r, _ in arrays[3])
    if fmt != "cgns":
        want = {1, 2} if fmt.startswith("v") else {7, 8}
        assert set(np.unique(b.cell_markers)) == want


class _El:
    def __init__(self, verts, index=1):
        self.vertices = [int(v) + 1 for v in verts]    # netgen is 1-based
        self.index = index


class _Netgen:
    """netgen's duck-typed surface: Coordinates(), ElementsND() of 1-based
    vertices and region indices; in 3D the boundary triangles are
    Elements2D()."""

    def __init__(self, cell, n):
        xyz, cells, tags, blocks = _grid(cell, n)
        self.dim = 2 if cell == "triangle" else 3
        self._pts = xyz[:, :self.dim]
        self._els = [_El(c, t) for c, t in zip(cells, tags)]
        # one facet twice, under two tags: the last one counts
        rows = [(r, t) for rr, t in blocks for r in rr]
        rows.append((rows[0][0][::-1], 9))
        self._bels = [_El(r, t) for r, t in rows]

    def Coordinates(self):
        return self._pts

    def Elements1D(self):
        return self._bels

    def Elements2D(self):
        return self._els if self.dim == 2 else self._bels

    def Elements3D(self):
        return self._els


@pytest.mark.parametrize("cell", ["triangle", "tetrahedron"])
def test_netgen_matches_jax(cell):
    ng = _Netgen(cell, GRIDS[cell])
    a, b = J.Mesh(ng), T.Mesh(ng)
    _same(a, b)
    assert 9 in b.facet_markers


def test_mesh_dispatch(tmp_path):
    """Mesh() on a mesh, a coordinate Function, each file suffix and a
    netgen-like object; an unknown suffix and other objects raise as in
    the JAX package."""
    m = T.UnitSquareMesh(3, 3)
    assert T.Mesh(m) is m
    for pkg in (J, T):
        base = pkg.UnitSquareMesh(3, 3)
        X = pkg.SpatialCoordinate(base)
        V = pkg.VectorFunctionSpace(base, "CG", 2)
        f = pkg.Function(V).interpolate(pkg.as_vector(
            [X[0] + 0.1 * X[1] * X[1], X[1]]))
        if pkg is J:
            a = J.Mesh(f)
        else:
            b = T.Mesh(f)
    _same(a, b)
    assert b._coord_degree == a._coord_degree == 2
    assert np.array_equal(np.asarray(a.coordinates.dat),
                          to_numpy(b.coordinates.dat))
    arrays = _grid("triangle", 4)
    for name, write in (("m.msh", _write_v22), ("m.e", _write_exodus),
                        ("m.exo", _write_exodus), ("m.cgns", _write_cgns)):
        write(tmp_path / name, *arrays, "triangle")
        _same(J.Mesh(str(tmp_path / name)), T.Mesh(str(tmp_path / name)))
    for pkg in (J, T):
        with pytest.raises(NotImplementedError, match="mesh format"):
            pkg.Mesh(str(tmp_path / "m.vtk"))
        with pytest.raises(TypeError):
            pkg.Mesh(3)


# ------------------------------------------------- the reference's faults
P2_TRIANGLES = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
9
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
5 0.5 0 0
6 1 0.5 0
7 0.5 0.5 0
8 0 0.5 0
9 0.5 1 0
$EndNodes
$Elements
4
1 1 2 1 1 1 2
2 1 2 2 2 3 4
3 9 2 10 1 1 2 3 5 6 7
4 9 2 10 1 1 3 4 7 9 8
$EndElements
"""


def test_second_order_gmsh_raises(tmp_path):
    """Two second-order triangles (type 9) and two boundary lines: the JAX
    package skips the triangles and returns a 2-cell interval mesh; the
    port names the element type it cannot read."""
    p = tmp_path / "p2.msh"
    p.write_text(P2_TRIANGLES)
    a = J.Mesh(str(p))
    assert a.cell.name == "interval" and a.num_cells == 2
    with pytest.raises(NotImplementedError, match="element type 9"):
        T.Mesh(str(p))


def test_binary_and_v40_gmsh_raise(tmp_path):
    for head, what in (("2.2 1 8", "binary"), ("4 0 8", "format 4")):
        p = tmp_path / "m.msh"
        p.write_text(P2_TRIANGLES.replace("2.2 0 8", head))
        with pytest.raises(NotImplementedError, match=what):
            T.Mesh(str(p))


def test_higher_order_exodus_raises(tmp_path):
    """A TRI6 block: the JAX package keeps each element's first three
    nodes; the port refuses the block by name."""
    xyz, cells, tags, blocks = _grid("triangle", 4)
    mids = np.concatenate([cells, cells[:, :3]], axis=1)   # six per cell
    p = tmp_path / "m.exo"
    _write_exodus(p, xyz, mids, tags, blocks, "triangle", etype="TRI6")
    a = J.Mesh(str(p))
    assert a.num_cells == len(cells)
    with pytest.raises(NotImplementedError, match="TRI6"):
        T.Mesh(str(p))


def test_unsupported_cgns_section_raises(tmp_path):
    """A TRI_6 (code 6) section beside the cells: skipped by the JAX
    package, refused by the port."""
    p = tmp_path / "m.cgns"
    _write_cgns(p, *_grid("triangle", 4), "triangle", extra_section=6)
    assert J.Mesh(str(p)).num_cells == 32
    with pytest.raises(NotImplementedError, match="ElementType_t 6"):
        T.Mesh(str(p))


def _tagged(mesh, tag):
    fv = np.asarray(mesh.topology.facet_vertices)
    return set(map(tuple, np.sort(fv[np.asarray(mesh.facet_markers) == tag],
                                  axis=1)))


@pytest.mark.parametrize("track", [False, True])
def test_cgns_bc_order(tmp_path, track):
    """BCs created in another order than their element ranges, under names
    whose alphabetical order is a third.  The JAX package numbers them by
    first element id whatever the file; the port does too where the file
    does not track creation order, and numbers them in creation order
    where it does."""
    xyz, cells, tags, blocks = _grid("triangle", 4)
    order = [2, 0, 3, 1]
    p = tmp_path / "m.cgns"
    _write_cgns(p, xyz, cells, tags, blocks, "triangle",
                bc_names=["zz", "aa", "mm", "bb"], bc_order=order,
                track=track)
    a, b = J.Mesh(str(p)), T.Mesh(str(p))
    if not track:
        _same(a, b)
        return
    for tag in range(1, 5):
        want = set(map(tuple, np.sort(blocks[tag - 1][0], axis=1)))
        assert _tagged(a, tag) == want
        want = set(map(tuple, np.sort(blocks[order[tag - 1]][0], axis=1)))
        assert _tagged(b, tag) == want
    assert np.array_equal(np.asarray(a.topology.cell_vertices),
                          b.topology.cell_vertices)


def test_facet_tagged_twice_keeps_the_last_tag(tmp_path):
    """A boundary line listed twice with two tags: both packages keep the
    later one."""
    arrays = _grid("triangle", 4)
    xyz, cells, tags, blocks = arrays
    twice = blocks + [(blocks[0][0][:1][:, ::-1], 42)]
    p = tmp_path / "m.msh"
    _write_v22(p, xyz, cells, tags, twice, "triangle")
    a, b = J.Mesh(str(p)), T.Mesh(str(p))
    _same(a, b)
    assert (b.facet_markers == 42).sum() == 1


def test_match_rows_past_packed_keys():
    """match_rows on vertex ids past 2^21 (three ids no longer pack into
    one int64): every row found where a dict of tuples finds it."""
    rng = np.random.default_rng(3)
    table = np.unique(np.sort(rng.integers(0, 3_000_000_000, (4000, 3)),
                              axis=1), axis=0)
    pick = rng.choice(len(table), 500)
    rows = np.concatenate([table[pick], rng.integers(0, 9, (50, 3))])
    rows = np.sort(rows, axis=1)
    ref = {tuple(r): i for i, r in enumerate(table)}
    want = np.array([ref.get(tuple(r), -1) for r in rows])
    assert np.array_equal(match_rows(table, rows), want)


# ------------------------------------------------------ the whole slice
def test_gmsh_gather_route_and_solve_match_jax(tmp_path):
    """The meshio phase's problem on a 12^2 jittered gmsh v4.1 file: the
    port's gather-route matrix and vector within 1e-12 of the JAX
    package's, and the port's CG solve within 1e-9 of scipy's spsolve of
    the JAX matrix and vector."""
    import scipy.sparse.linalg as sla
    p = tmp_path / "m.msh"
    _write_v41(p, *_grid("triangle", 12), "triangle")
    out = {}
    for pkg in (J, T):
        mesh = pkg.Mesh(str(p))
        V = pkg.FunctionSpace(mesh, "CG", 1)
        u, v = pkg.TrialFunction(V), pkg.TestFunction(V)
        x, y = pkg.SpatialCoordinate(mesh)
        u_ex = pkg.cos(pkg.pi * x) * pkg.cos(pkg.pi * y)
        f = pkg.Function(V).interpolate((1 + 2 * pkg.pi ** 2) * u_ex)
        n = pkg.FacetNormal(mesh)
        a = (pkg.inner(pkg.grad(u), pkg.grad(v)) + u * v) * pkg.dx
        L = f * v * pkg.dx + (y - x * n[0]) * v * pkg.ds(10) \
            + v * pkg.dx(2)
        out[pkg] = (pkg.assemble(a).to_scipy(),
                    np.asarray(pkg.assemble(L).dat), a, L, V)
    (Aj, bj, *_), (At, bt, a, L, V) = out[J], out[T]
    assert abs(At - Aj).max() <= 1e-12 * abs(Aj).max()
    assert np.abs(bt - bj).max() <= 1e-12 * np.abs(bj).max()
    uh = T.Function(V)
    T.solve(a == L, uh, solver_parameters={
        "ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": 1e-13})
    ref = sla.spsolve(Aj.tocsc(), bj)
    assert np.abs(uh.dat.numpy() - ref).max() <= 1e-9 * np.abs(ref).max()
