"""Utility mesh constructors (reference: firedrake/utility_meshes.py — ~35
constructors; we implement the core set with the same names and boundary-id
conventions: 1:x=0, 2:x=Lx, 3:y=0, 4:y=Ly, 5:z=0, 6:z=Lz)."""
from __future__ import annotations

import numpy as np

from .topology import MeshTopology, _IDX
from .geometry import Mesh

__all__ = [
    "IntervalMesh", "UnitIntervalMesh",
    "RectangleMesh", "SquareMesh", "UnitSquareMesh",
    "BoxMesh", "CubeMesh", "UnitCubeMesh",
    "UnitTriangleMesh", "UnitTetrahedronMesh",
    "PeriodicIntervalMesh", "PeriodicUnitIntervalMesh",
]


def _mark_box_facets(mesh: Mesh, lengths):
    """Assign Firedrake-style boundary ids by coordinate planes."""
    topo = mesh.topology
    fv = topo.facet_vertices                     # (nf, nvpf)
    coords = mesh._vertex_coords
    centroids = coords[fv].mean(axis=1)          # (nf, gdim)
    markers = np.zeros(len(fv), dtype=_IDX)
    tol = 1e-12
    ext = set(topo.exterior_facets.tolist())
    for ax, L in enumerate(lengths):
        lo = np.abs(centroids[:, ax]) < tol * max(1.0, L)
        hi = np.abs(centroids[:, ax] - L) < tol * max(1.0, L)
        # only mark where ALL facet vertices lie on the plane
        on_lo = np.all(np.abs(coords[fv][:, :, ax]) < 1e-10 * max(1.0, L),
                       axis=1)
        on_hi = np.all(np.abs(coords[fv][:, :, ax] - L) < 1e-10 * max(1.0, L),
                       axis=1)
        markers[on_lo] = 2 * ax + 1
        markers[on_hi] = 2 * ax + 2
    # clear markers on interior facets
    interior = topo.facet_cells[:, 1] >= 0
    markers[interior] = 0
    mesh.facet_markers = markers
    mesh._box_lengths = tuple(lengths)
    return mesh


def IntervalMesh(ncells: int, length_or_left=1.0, right=None, name="mesh"):
    if right is None:
        left, right_ = 0.0, float(length_or_left)
    else:
        left, right_ = float(length_or_left), float(right)
    x = np.linspace(left, right_, ncells + 1)[:, None]
    cells = np.stack([np.arange(ncells), np.arange(1, ncells + 1)], axis=1)
    topo = MeshTopology(cells, ncells + 1, "interval", name)
    mesh = Mesh(topo, x, name=name)
    markers = np.zeros(len(topo.facet_cells), dtype=_IDX)
    markers[0] = 1
    markers[ncells] = 2
    mesh.facet_markers = markers
    mesh._box_lengths = (right_,) if left == 0.0 else None
    return mesh


def UnitIntervalMesh(ncells: int, name="mesh"):
    return IntervalMesh(ncells, 1.0, name=name)


def PeriodicIntervalMesh(ncells: int, length=1.0, name="mesh"):
    """Circle topology with per-cell UNWRAPPED (DG) coordinate charts —
    the reference's periodic-mesh representation (utility_meshes.py
    PeriodicIntervalMesh: discontinuous coordinates).  The wrapped
    vertex coords alone would give the seam cell an inverted chart
    spanning almost the whole interval."""
    h = length / ncells
    x = np.linspace(0.0, length, ncells + 1)[:-1, None]
    idx = np.arange(ncells)
    cells = np.stack([idx, (idx + 1) % ncells], axis=1)
    ccoords = np.stack([idx * h, (idx + 1) * h], axis=1)[..., None]
    topo = MeshTopology(cells, ncells, "interval", name)
    m = Mesh(topo, x, name=name, cell_coords=ccoords)
    m._periodic = ("x",)
    m._periodic_lengths = (length,)
    return m


def PeriodicUnitIntervalMesh(ncells: int, name="mesh"):
    return PeriodicIntervalMesh(ncells, 1.0, name=name)


def _structured_cells(nx, ny, kind):
    """Cell array of a structured grid mesh in the canonical ordering
    (cell = ntypes*q + t, quad q = i*ny + j x-major) — shared by
    RectangleMesh and the structured hierarchy refiner (mg/mesh.py)."""
    def vid(i, j):
        return i + j * (nx + 1)

    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    v00 = vid(I, J).ravel()
    v10 = vid(I + 1, J).ravel()
    v01 = vid(I, J + 1).ravel()
    v11 = vid(I + 1, J + 1).ravel()
    if kind == "quad":
        return np.stack([v00, v10, v01, v11], axis=1), "quadrilateral"
    if kind == "tri_left":
        t1 = np.stack([v00, v10, v01], axis=1)
        t2 = np.stack([v10, v11, v01], axis=1)
    else:
        t1 = np.stack([v00, v10, v11], axis=1)
        t2 = np.stack([v00, v11, v01], axis=1)
    # interleave the two triangles of each grid quad: consecutive cells
    # are spatial neighbors (gather locality + strip partitions)
    return np.stack([t1, t2], axis=1).reshape(-1, 3), "triangle"


def RectangleMesh(nx: int, ny: int, Lx=1.0, Ly=1.0, quadrilateral=False,
                  diagonal="left", name="mesh", originX=0.0, originY=0.0):
    xs = np.linspace(originX, originX + Lx, nx + 1)
    ys = np.linspace(originY, originY + Ly, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="xy")     # row j = y_j
    verts = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i + j * (nx + 1)

    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    v00 = vid(I, J).ravel()
    v10 = vid(I + 1, J).ravel()
    v01 = vid(I, J + 1).ravel()
    v11 = vid(I + 1, J + 1).ravel()

    structured = None
    if quadrilateral:
        cells, ct = _structured_cells(nx, ny, "quad")
        structured = {"nx": nx, "ny": ny, "kind": "quad"}
    else:
        if diagonal in ("left", "right"):
            cells, ct = _structured_cells(nx, ny, "tri_" + diagonal)
            structured = {"nx": nx, "ny": ny, "kind": "tri_" + diagonal}
        elif diagonal == "crossed":
            nverts = len(verts)
            centers = np.stack([(xs[:-1] + xs[1:]) / 2] * 1)
            CX, CY = np.meshgrid((xs[:-1] + xs[1:]) / 2,
                                 (ys[:-1] + ys[1:]) / 2, indexing="ij")
            cverts = np.stack([CX.ravel(), CY.ravel()], axis=1)
            cid = nverts + np.arange(len(cverts))
            verts = np.concatenate([verts, cverts])
            t1 = np.stack([v00, v10, cid], axis=1)
            t2 = np.stack([v10, v11, cid], axis=1)
            t3 = np.stack([v11, v01, cid], axis=1)
            t4 = np.stack([v01, v00, cid], axis=1)
            cells = np.concatenate([t1, t2, t3, t4])
            topo = MeshTopology(cells, len(verts), "triangle", name)
            return _mark_box_facets(Mesh(topo, verts, name=name), (Lx, Ly))
        else:
            raise ValueError(f"unknown diagonal {diagonal!r}")
    topo = MeshTopology(cells, len(verts), ct, name)
    mesh = _mark_box_facets(Mesh(topo, verts, name=name), (Lx, Ly))
    # stencil fast-path metadata (assembly/stencil.py): cell c is type
    # c % ntypes of grid quad (i, j) with i = (c//ntypes)//ny (x index),
    # vertex id = i + j*(nx+1)
    mesh._structured = structured
    return mesh


def SquareMesh(nx, ny, L, quadrilateral=False, name="mesh", **kw):
    return RectangleMesh(nx, ny, L, L, quadrilateral=quadrilateral,
                         name=name, **kw)


def UnitSquareMesh(nx, ny, quadrilateral=False, name="mesh", **kw):
    return RectangleMesh(nx, ny, 1.0, 1.0, quadrilateral=quadrilateral,
                         name=name, **kw)


_FREUDENTHAL = [p for p in
                [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0),
                 (2, 0, 1), (2, 1, 0)]]


def _structured_cells_3d(nx, ny, nz, kind):
    """Cell array of a structured 3D grid mesh in the canonical ordering
    (cell = ntypes*q + t, cube q = i*ny*nz + j*nz + k x-slowest) — shared
    by BoxMesh and the structured hierarchy refiner (mg/mesh.py)."""
    def vid(i, j, k):
        return i + j * (nx + 1) + k * (nx + 1) * (ny + 1)

    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    corner = {}
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                corner[(dx, dy, dz)] = vid(I + dx, J + dy, K + dz)

    if kind == "hex":
        # lexicographic vertex order (x fastest) to match our hex ref cell
        cells = np.stack([corner[(x, y, z)] for z in (0, 1) for y in (0, 1)
                          for x in (0, 1)], axis=1)
        return cells, "hexahedron"
    assert kind == "tet6"
    # Freudenthal/Kuhn 6-tet subdivision: tet for each permutation pi of
    # axes, path 000 -> +e_{pi0} -> +e_{pi1} -> +e_{pi2}.  All tets share
    # the main cube diagonal; refining each cube 2x reproduces the same
    # triangulation (Bey's conforming red refinement), which the
    # structured multigrid hierarchy relies on.
    tets = []
    for pi in _FREUDENTHAL:
        steps = [(0, 0, 0)]
        cur = [0, 0, 0]
        for ax in pi:
            cur = cur.copy()
            cur[ax] += 1
            steps.append(tuple(cur))
        tets.append(np.stack([corner[s] for s in steps], axis=1))
    # interleave the 6 tets of each cube (spatial locality)
    cells = np.stack(tets, axis=1).reshape(-1, 4)
    return cells, "tetrahedron"


def _structured_cells_nd(dims, kind):
    """Dimension dispatch for the canonical structured cell orderings."""
    if len(dims) == 2:
        return _structured_cells(dims[0], dims[1], kind)
    return _structured_cells_3d(dims[0], dims[1], dims[2], kind)


def BoxMesh(nx, ny, nz, Lx=1.0, Ly=1.0, Lz=1.0, hexahedral=False,
            name="mesh"):
    xs = np.linspace(0, Lx, nx + 1)
    ys = np.linspace(0, Ly, ny + 1)
    zs = np.linspace(0, Lz, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    # vertex id = i + j*(nx+1) + k*(nx+1)*(ny+1)
    verts = np.stack([X.transpose(2, 1, 0).ravel(),
                      Y.transpose(2, 1, 0).ravel(),
                      Z.transpose(2, 1, 0).ravel()], axis=1)

    kind = "hex" if hexahedral else "tet6"
    cells, ct = _structured_cells_3d(nx, ny, nz, kind)
    topo = MeshTopology(cells, len(verts), ct, name)
    mesh = _mark_box_facets(Mesh(topo, verts, name=name), (Lx, Ly, Lz))
    # stencil fast-path metadata (assembly/stencil.py): cell c is type
    # c % ntypes of grid cube (i, j, k) with q = c//ntypes decomposed
    # x-slowest; vertex id = i + j*(nx+1) + k*(nx+1)*(ny+1)
    mesh._structured = {"nx": nx, "ny": ny, "nz": nz, "kind": kind}
    return mesh


def CubeMesh(nx, ny, nz, L, name="mesh", **kw):
    return BoxMesh(nx, ny, nz, L, L, L, name=name, **kw)


def UnitCubeMesh(nx, ny, nz, name="mesh", **kw):
    return BoxMesh(nx, ny, nz, 1.0, 1.0, 1.0, name=name, **kw)


def UnitTriangleMesh(name="mesh"):
    verts = np.array([[0.0, 0], [1, 0], [0, 1]])
    cells = np.array([[0, 1, 2]])
    topo = MeshTopology(cells, 3, "triangle", name)
    return _mark_box_facets(Mesh(topo, verts, name=name), (1.0, 1.0))


def UnitTetrahedronMesh(name="mesh"):
    verts = np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    cells = np.array([[0, 1, 2, 3]])
    topo = MeshTopology(cells, 4, "tetrahedron", name)
    return Mesh(topo, verts, name=name)


# ------------------------------------------------------ periodic/manifold
def PeriodicRectangleMesh(nx, ny, Lx=1.0, Ly=1.0, direction="both",
                          quadrilateral=False, name="mesh"):
    """Torus/cylinder topology with DG1 coordinates unwrapped per cell
    (the reference's periodic-mesh trick: discontinuous coordinates,
    utility_meshes.py PeriodicRectangleMesh)."""
    px = direction in ("both", "x")
    py = direction in ("both", "y")
    nvx = nx if px else nx + 1
    nvy = ny if py else ny + 1
    xs = np.arange(nvx) * (Lx / nx)
    ys = np.arange(nvy) * (Ly / ny)

    def vid(i, j):
        return (i % nvx if px else i) + ((j % nvy if py else j)) * nvx

    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    v00 = vid(I, J).ravel()
    v10 = vid(I + 1, J).ravel()
    v01 = vid(I, J + 1).ravel()
    v11 = vid(I + 1, J + 1).ravel()
    # physical (unwrapped) corner coordinates per grid cell
    cx0 = (I * Lx / nx).ravel()
    cy0 = (J * Ly / ny).ravel()
    hx, hy = Lx / nx, Ly / ny
    c00 = np.stack([cx0, cy0], 1)
    c10 = np.stack([cx0 + hx, cy0], 1)
    c01 = np.stack([cx0, cy0 + hy], 1)
    c11 = np.stack([cx0 + hx, cy0 + hy], 1)
    if quadrilateral:
        cells = np.stack([v00, v10, v01, v11], axis=1)
        ccoords = np.stack([c00, c10, c01, c11], axis=1)
        ct = "quadrilateral"
    else:
        cells = np.concatenate([np.stack([v00, v10, v01], 1),
                                np.stack([v10, v11, v01], 1)])
        ccoords = np.concatenate([np.stack([c00, c10, c01], 1),
                                  np.stack([c10, c11, c01], 1)])
        ct = "triangle"
    nverts = nvx * nvy
    # vertex coordinates (wrapped representatives; only used for plotting)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    verts = np.stack([X.ravel(), Y.ravel()], axis=1)
    topo = MeshTopology(cells.astype(_IDX), nverts, ct, name)
    # unwrapped charts drive orientation forcing (Mesh permutes cell
    # vertices + charts together); the wrapped vertex chart misjudges
    # seam-cell orientation
    m = Mesh(topo, verts, name=name, cell_coords=ccoords)
    m._periodic = direction
    return m


def PeriodicSquareMesh(nx, ny, L, direction="both", quadrilateral=False,
                       name="mesh"):
    return PeriodicRectangleMesh(nx, ny, L, L, direction=direction,
                                 quadrilateral=quadrilateral, name=name)


def PeriodicUnitSquareMesh(nx, ny, direction="both", quadrilateral=False,
                           name="mesh"):
    return PeriodicSquareMesh(nx, ny, 1.0, direction=direction,
                              quadrilateral=quadrilateral, name=name)


def CircleManifoldMesh(ncells, radius=1.0, name="mesh"):
    """1D interval cells embedded on a circle in 2D (reference:
    utility_meshes.py CircleManifoldMesh)."""
    theta = 2 * np.pi * np.arange(ncells) / ncells
    verts = radius * np.stack([np.cos(theta), np.sin(theta)], axis=1)
    cells = np.stack([np.arange(ncells),
                      (np.arange(ncells) + 1) % ncells], axis=1)
    topo = MeshTopology(cells.astype(_IDX), ncells, "interval", name)
    return Mesh(topo, verts, name=name)


def IcosahedralSphereMesh(radius=1.0, refinement_level=0, name="mesh"):
    """Triangulated sphere by refined icosahedron (reference:
    utility_meshes.py:icosahedral sphere)."""
    phi = (1 + np.sqrt(5)) / 2
    verts = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], dtype=float)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ])
    for _ in range(refinement_level):
        edge_mid = {}
        new_faces = []
        verts = list(verts)

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                edge_mid[key] = len(verts)
                verts.append((np.asarray(verts[a])
                              + np.asarray(verts[b])) / 2)
            return edge_mid[key]

        for (a, b, c) in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        faces = np.array(new_faces)
        verts = np.array(verts)
    verts = np.asarray(verts, dtype=float)
    verts = radius * verts / np.linalg.norm(verts, axis=1, keepdims=True)
    topo = MeshTopology(faces.astype(_IDX), len(verts), "triangle", name)
    return Mesh(topo, verts, name=name)


def UnitIcosahedralSphereMesh(refinement_level=0, name="mesh"):
    return IcosahedralSphereMesh(1.0, refinement_level, name=name)


def AnnulusMesh(R, r, nr=4, nt=32, name="mesh"):
    """Triangulated annulus with inner marker 3, outer marker 4 — wait:
    reference uses (1=inner?) — we use 1=inner, 2=outer."""
    rs = np.linspace(r, R, nr + 1)
    ts = 2 * np.pi * np.arange(nt) / nt

    def vid(i, j):
        return (j % nt) + i * nt

    verts = np.zeros(((nr + 1) * nt, 2))
    for i, rr in enumerate(rs):
        verts[i * nt:(i + 1) * nt, 0] = rr * np.cos(ts)
        verts[i * nt:(i + 1) * nt, 1] = rr * np.sin(ts)
    tris = []
    for i in range(nr):
        for j in range(nt):
            v00, v10 = vid(i, j), vid(i, j + 1)
            v01, v11 = vid(i + 1, j), vid(i + 1, j + 1)
            tris += [[v00, v10, v01], [v10, v11, v01]]
    cells = np.array(tris)
    topo = MeshTopology(cells.astype(_IDX), len(verts), "triangle", name)
    m = Mesh(topo, verts, name=name)
    # markers by radius
    fv = m.topology.facet_vertices
    rad = np.linalg.norm(verts[fv], axis=2)
    markers = np.zeros(len(fv), dtype=_IDX)
    ext = m.topology.exterior_facets
    inner = np.all(np.abs(rad - r) < 1e-10 * max(R, 1), axis=1)
    outer = np.all(np.abs(rad - R) < 1e-10 * max(R, 1), axis=1)
    markers[inner] = 1
    markers[outer] = 2
    m.facet_markers = markers
    return m


def TorusMesh(nR, nr, R, r, name="mesh"):
    """Quadrilateral surface mesh of a torus in 3D (reference:
    utility_meshes.py TorusMesh)."""
    us = 2 * np.pi * np.arange(nR) / nR
    vs = 2 * np.pi * np.arange(nr) / nr
    verts = np.zeros((nR * nr, 3))
    for i, u in enumerate(us):
        for j, v in enumerate(vs):
            k = i * nr + j
            verts[k] = [(R + r * np.cos(v)) * np.cos(u),
                        (R + r * np.cos(v)) * np.sin(u),
                        r * np.sin(v)]

    def vid(i, j):
        return (i % nR) * nr + (j % nr)

    quads = []
    for i in range(nR):
        for j in range(nr):
            quads.append([vid(i, j), vid(i + 1, j), vid(i, j + 1),
                          vid(i + 1, j + 1)])
    cells = np.array(quads)
    topo = MeshTopology(cells.astype(_IDX), len(verts), "quadrilateral",
                        name)
    return Mesh(topo, verts, name=name)


__all__ += ["PeriodicRectangleMesh", "PeriodicSquareMesh",
            "PeriodicUnitSquareMesh", "CircleManifoldMesh",
            "IcosahedralSphereMesh", "UnitIcosahedralSphereMesh",
            "AnnulusMesh", "TorusMesh"]


# --------------------------------------------------------------- extruded
def ExtrudedMesh(base_mesh, layers, layer_height=None,
                 extrusion_type="uniform", name=None):
    """Extrude a base mesh in a structured vertical direction (reference:
    firedrake/mesh.py:3466 ExtrudedMesh; ExtrudedMeshTopology :1782).

    v1 materializes the column cells (interval->quad, quad->hex,
    triangle->prism) with the layer axis contiguous in the vertex
    numbering — the dense-axis layout the TPU build exploits.  Column-
    compressed (O(base) metadata) storage is the follow-up optimization
    (reference keeps layer extents only, extrusion_numbering.pyx:222).
    Only ``extrusion_type="uniform"`` is supported: another type raises
    (the JAX package accepts it and extrudes uniformly all the same).
    """
    if extrusion_type != "uniform":
        raise NotImplementedError(
            f"extrusion_type {extrusion_type!r}: only 'uniform' extrusion "
            "is supported (periodic and radial extrusion are out of "
            "scope, ROADMAP.md)")
    base = base_mesh
    layers_arr = np.asarray(layers)
    if layers_arr.ndim == 2:
        # variable layers: (ncell_base, 2) rows [start a, cell count b]
        # (reference mesh.py:3466, pyop2/types/set.py:307 layer extents)
        if layer_height is None:
            raise ValueError(
                "Must provide layer height for variable layers")
        return _variable_layer_extrude(base, layers_arr,
                                       float(layer_height), name)
    nlay = int(layers)
    h = layer_height if layer_height is not None else 1.0 / nlay
    nbv = base.num_vertices
    bcoords = base._vertex_coords
    gdim = base.geometric_dimension + 1
    # vertices: layer-major would scatter columns; use vertex-major with
    # contiguous columns: id = b * (nlay+1) + l
    verts = np.zeros((nbv * (nlay + 1), gdim))
    zs = np.arange(nlay + 1) * h
    verts[:, :-1] = np.repeat(bcoords, nlay + 1, axis=0)
    verts[:, -1] = np.tile(zs, nbv)

    def vid(b, l):
        return b * (nlay + 1) + l

    bcells = base.topology.cell_vertices
    ncell_b, nvc = bcells.shape
    cname = base.cell.name
    if cname == "interval":
        ct = "quadrilateral"
        lo = [0, 1]
    elif cname == "quadrilateral":
        ct = "hexahedron"
        lo = [0, 1, 2, 3]
    elif cname == "triangle":
        ct = "prism"
        lo = [0, 1, 2]
    else:
        raise NotImplementedError(f"extrusion of {cname}")
    cells = []
    L = np.arange(nlay)
    # cell id = base_cell * nlay + layer (column-contiguous)
    bot = (bcells[:, lo, None] * (nlay + 1) + L[None, None, :])
    top = bot + 1
    # shape (ncell_b, nvc, nlay) -> (ncell_b, nlay, 2*nvc)
    bot = np.moveaxis(bot, 2, 1)
    top = np.moveaxis(top, 2, 1)
    cells = np.concatenate([bot, top], axis=2).reshape(-1, 2 * nvc)
    topo = MeshTopology(cells.astype(_IDX), len(verts), ct,
                        name or f"{base.name}_extruded")
    m = Mesh(topo, verts, name=name or f"{base.name}_extruded")
    m._base_mesh = base
    m._layers = nlay
    m._extruded = True
    return m


def _variable_layer_extrude(base, layers, h, name):
    """Variable-layer extrusion: column c occupies cell layers
    a_c .. a_c + b_c - 1 (reference's deprecated-but-supported variable
    extrusion; firedrake/cython/extrusion_numbering.pyx:222 layer
    extents).  TPU encoding: the mesh is MATERIALIZED over the union of
    columns (padded-to-max lives only in the assembler's generic cell
    batch, where ragged columns are just more cells) — assembly runs
    the gather executor; the uniform-layer column fast path is gated
    off by `_var_layers`.

    Facet semantics match the reference's per-column iteration regions:
    a horizontal exterior facet at a cell's bottom is 'bottom', at a
    cell's top is 'top' (including the exposed steps where a neighbour
    column is shorter), everything else is 'sides'."""
    a = layers[:, 0].astype(np.int64)
    b = layers[:, 1].astype(np.int64)
    if (b < 1).any():
        raise ValueError("each column needs at least one cell layer")
    top = a + b                       # one-past-last cell layer
    bcells = base.topology.cell_vertices
    ncell_b, nvc = bcells.shape
    cname = base.cell.name
    ct = {"interval": "quadrilateral", "quadrilateral": "hexahedron",
          "triangle": "prism"}.get(cname)
    if ct is None:
        raise NotImplementedError(f"extrusion of {cname}")
    # per base vertex: union of adjacent columns' vertex-layer ranges
    nbv = base.num_vertices
    lo_v = np.full(nbv, np.iinfo(np.int64).max)
    hi_v = np.full(nbv, np.iinfo(np.int64).min)
    for k in range(nvc):
        np.minimum.at(lo_v, bcells[:, k], a)
        np.maximum.at(hi_v, bcells[:, k], top)
    used = hi_v >= lo_v
    lo_v[~used] = 0
    hi_v[~used] = -1
    counts = hi_v - lo_v + 1          # vertex layers per column
    voff = np.concatenate([[0], np.cumsum(counts)])
    nverts = int(voff[-1])
    gdim = base.geometric_dimension + 1
    verts = np.zeros((nverts, gdim))
    bcoords = base._vertex_coords
    vcol = np.repeat(np.arange(nbv), counts)
    vlay = np.arange(nverts) - np.repeat(voff[:-1], counts) \
        + np.repeat(lo_v, counts)
    verts[:, :-1] = bcoords[vcol]
    verts[:, -1] = vlay * h

    def vid(bv, l):
        return voff[bv] + (l - lo_v[bv])

    cells = []
    cell_base, cell_layer = [], []
    for c in range(ncell_b):
        for l in range(a[c], top[c]):
            bot = [vid(bcells[c, k], l) for k in range(nvc)]
            up = [vid(bcells[c, k], l + 1) for k in range(nvc)]
            cells.append(bot + up)
            cell_base.append(c)
            cell_layer.append(l)
    cells = np.asarray(cells, dtype=_IDX)
    topo = MeshTopology(cells, nverts, ct,
                        name or f"{base.name}_extruded")
    m = Mesh(topo, verts, name=name or f"{base.name}_extruded")
    m._base_mesh = base
    m._layers = int(top.max() - a.min())
    m._extruded = True
    m._var_layers = layers.copy()
    m._cell_base = np.asarray(cell_base, dtype=np.int64)
    m._cell_layer = np.asarray(cell_layer, dtype=np.int64)
    m._layer_height = h
    return m


__all__ += ["ExtrudedMesh"]


def CubedSphereMesh(radius=1.0, refinement_level=0, name="mesh"):
    """Quadrilateral surface mesh of a sphere from a refined cube
    (reference: utility_meshes.py CubedSphereMesh)."""
    n = 2 ** refinement_level
    # build the 6 faces of a cube with shared edge/corner vertices by
    # keying vertices on their (rounded) cube coordinates
    vid = {}
    verts = []

    def getv(p):
        key = tuple(np.round(p, 12))
        if key not in vid:
            vid[key] = len(verts)
            verts.append(np.asarray(p, dtype=float))
        return vid[key]

    quads = []
    axes = [(0, 1, 2), (1, 2, 0), (2, 0, 1)]
    for (a, b, c) in axes:
        for sign in (-1.0, 1.0):
            for i in range(n):
                for j in range(n):
                    corner = np.zeros((2, 2, 3))
                    for di in (0, 1):
                        for dj in (0, 1):
                            p = np.zeros(3)
                            p[a] = -1 + 2 * (i + di) / n
                            p[b] = -1 + 2 * (j + dj) / n
                            p[c] = sign
                            corner[di, dj] = p
                    quads.append([getv(corner[0, 0]), getv(corner[1, 0]),
                                  getv(corner[0, 1]),
                                  getv(corner[1, 1])])
    verts = np.asarray(verts)
    verts = radius * verts / np.linalg.norm(verts, axis=1, keepdims=True)
    topo = MeshTopology(np.asarray(quads, dtype=_IDX), len(verts),
                        "quadrilateral", name)
    return Mesh(topo, verts, name=name)


def UnitCubedSphereMesh(refinement_level=0, name="mesh"):
    return CubedSphereMesh(1.0, refinement_level, name=name)


def OctahedralSphereMesh(radius=1.0, refinement_level=0, name="mesh"):
    """Triangulated sphere from a refined octahedron (reference:
    utility_meshes.py OctahedralSphereMesh)."""
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], dtype=float)
    faces = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                      [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]])
    for _ in range(refinement_level):
        edge_mid = {}
        new_faces = []
        verts = list(verts)

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                edge_mid[key] = len(verts)
                verts.append((np.asarray(verts[a])
                              + np.asarray(verts[b])) / 2)
            return edge_mid[key]

        for (a, b, c) in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        faces = np.array(new_faces)
        verts = np.array(verts)
    verts = np.asarray(verts, dtype=float)
    verts = radius * verts / np.linalg.norm(verts, axis=1, keepdims=True)
    topo = MeshTopology(faces.astype(_IDX), len(verts), "triangle", name)
    return Mesh(topo, verts, name=name)


def UnitOctahedralSphereMesh(refinement_level=0, name="mesh"):
    return OctahedralSphereMesh(1.0, refinement_level, name=name)


def CylinderMesh(nr, nl, radius=1.0, depth=1.0, name="mesh"):
    """Quadrilateral surface mesh of a (open) cylinder in 3D
    (reference: utility_meshes.py CylinderMesh)."""
    theta = 2 * np.pi * np.arange(nr) / nr
    verts = np.zeros(((nl + 1) * nr, 3))
    for l in range(nl + 1):
        z = depth * l / nl
        for j in range(nr):
            verts[l * nr + j] = [radius * np.cos(theta[j]),
                                 radius * np.sin(theta[j]), z]

    def vid(l, j):
        return l * nr + (j % nr)

    quads = []
    for l in range(nl):
        for j in range(nr):
            quads.append([vid(l, j), vid(l + 1, j), vid(l, j + 1),
                          vid(l + 1, j + 1)])
    topo = MeshTopology(np.asarray(quads, dtype=_IDX), len(verts),
                        "quadrilateral", name)
    return Mesh(topo, verts, name=name)


def UnitDiskMesh(refinement_level=0, name="mesh"):
    """Triangle mesh of the unit disk: refined hexagonal fan with
    boundary vertices snapped to the circle (reference:
    utility_meshes.py UnitDiskMesh)."""
    verts = [np.zeros(2)] + [
        np.array([np.cos(t), np.sin(t)])
        for t in 2 * np.pi * np.arange(6) / 6]
    faces = np.array([[0, 1 + i, 1 + (i + 1) % 6] for i in range(6)])
    verts = np.asarray(verts)
    on_bdy = np.array([False] + [True] * 6)
    for _ in range(refinement_level):
        edge_mid = {}
        new_faces = []
        verts = list(verts)
        on_bdy = list(on_bdy)

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                edge_mid[key] = len(verts)
                verts.append((np.asarray(verts[a])
                              + np.asarray(verts[b])) / 2)
                on_bdy.append(bool(on_bdy[a] and on_bdy[b]))
            return edge_mid[key]

        for (a, b, c) in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        faces = np.array(new_faces)
        verts = np.asarray(verts)
        on_bdy = np.asarray(on_bdy)
        # NB: a midpoint of two boundary vertices lies on the hull only
        # for adjacent boundary points — interior chords stay interior;
        # correct by snapping only points at (near) unit radius scale
        r = np.linalg.norm(verts, axis=1)
        snap = on_bdy & (r > 0)
        verts[snap] = verts[snap] / r[snap, None]
    topo = MeshTopology(faces.astype(_IDX), len(verts), "triangle", name)
    return Mesh(topo, verts, name=name)


__all__ += ["CubedSphereMesh", "UnitCubedSphereMesh",
            "OctahedralSphereMesh", "UnitOctahedralSphereMesh",
            "CylinderMesh", "UnitDiskMesh"]


def Submesh(mesh, subdomain_id=None, cells=None, name=None):
    """Mesh of a cell subset (reference: firedrake/mesh.py Submesh /
    RelabeledMesh workflows): pass a dx subdomain id (cell markers) or
    an explicit cell index array.  Vertices are renumbered compactly;
    the result carries ``parent_cells`` / ``parent_vertices`` provenance
    and inherits facet markers on surviving facets."""
    topo = mesh.topology
    if cells is None:
        cells = mesh.cell_subset(subdomain_id)
    cells = np.asarray(cells, dtype=np.int64)
    if len(cells) == 0:
        raise ValueError("Submesh: empty cell subset")
    cv = np.asarray(topo.cell_vertices)[cells]
    verts = np.unique(cv.reshape(-1))
    renum = np.full(topo.num_vertices, -1, dtype=np.int64)
    renum[verts] = np.arange(len(verts))
    new_cells = renum[cv]
    nt = MeshTopology(new_cells.astype(_IDX), len(verts),
                      topo.cell.name, name or mesh.name + "_sub")
    out = Mesh(nt, mesh._vertex_coords[verts],
               name=name or mesh.name + "_sub")
    out.parent_cells = cells
    out.parent_vertices = verts
    out.cell_markers = np.asarray(mesh.cell_markers)[cells]
    # transfer facet markers by matching sorted (renumbered) vertex sets
    old_f = {}
    for fv, m in zip(np.asarray(topo.facet_vertices),
                     np.asarray(mesh.facet_markers)):
        vv = renum[fv[fv >= 0]]
        if np.all(vv >= 0):
            old_f[tuple(sorted(int(v) for v in vv))] = int(m)
    fm = np.zeros(len(nt.facet_cells), dtype=_IDX)
    for i, fv in enumerate(np.asarray(nt.facet_vertices)):
        key = tuple(sorted(int(v) for v in fv if v >= 0))
        fm[i] = old_f.get(key, 0)
    out.facet_markers = fm
    return out


__all__ += ["Submesh"]


def BallMesh(radius=1.0, refinement_level=0, name="mesh"):
    """Tetrahedral mesh of a solid ball (reference: utility_meshes.py
    BallMesh — gmsh/OpenCASCADE there; here a structured cube tet mesh
    mapped cube->ball by scaling each sup-norm shell onto the sphere of
    the same radius, which keeps radial lines nested and cells
    positively oriented)."""
    n = 2 * (refinement_level + 1)     # even: the origin is a vertex
    cube = UnitCubeMesh(n, n, n)
    coords = np.asarray(cube._vertex_coords) * 2.0 - 1.0   # [-1,1]^3
    rinf = np.max(np.abs(coords), axis=1)
    r2 = np.linalg.norm(coords, axis=1)
    scale = np.where(r2 > 0, rinf / np.maximum(r2, 1e-300), 0.0)
    verts = coords * (scale * radius)[:, None]
    topo = MeshTopology(np.asarray(cube.topology.cell_vertices),
                        len(verts), cube.cell.name, name)
    m = Mesh(topo, verts, name=name)
    # single boundary surface, id 1 (reference marks the sphere 1)
    m.facet_markers = np.where(
        np.isin(np.arange(m.topology.facet_cells.shape[0]),
                m.topology.exterior_facets), 1, 0).astype(_IDX)
    return m


def UnitBallMesh(refinement_level=0, name="mesh"):
    return BallMesh(1.0, refinement_level, name)


__all__ += ["BallMesh", "UnitBallMesh"]


def RelabeledMesh(mesh, indicators, subdomain_ids, name=None):
    """New mesh sharing topology/coordinates with additional subdomain
    labels (reference: firedrake/mesh.py:4769 RelabeledMesh).  Each
    indicator is a DG0 Function (cell labels) or a facet indicator
    (array over facets / HDivTrace-style Function); nonzero entries get
    the corresponding subdomain id."""
    topo = mesh.topology
    out = Mesh(topo, np.asarray(mesh._vertex_coords),
               name=name or mesh.name + "_relabeled")
    out.cell_markers = np.asarray(mesh.cell_markers).copy()
    out.facet_markers = np.asarray(mesh.facet_markers).copy()
    nf = topo.facet_cells.shape[0]
    for ind, sid in zip(indicators, subdomain_ids):
        vals = np.asarray(getattr(ind, "dat", ind)).reshape(-1)
        if vals.size == mesh.num_cells:
            out.cell_markers[vals != 0] = int(sid)
        elif vals.size == nf:
            out.facet_markers[vals != 0] = int(sid)
        else:
            raise ValueError(
                f"indicator size {vals.size} matches neither cells "
                f"({mesh.num_cells}) nor facets ({nf})")
    return out


class MeshSequence:
    """An ordered collection of meshes for mixed-domain problems
    (reference: firedrake/mesh.py:5090 MeshSequence)."""

    def __init__(self, meshes):
        self._meshes = list(meshes)

    def __getitem__(self, i):
        return self._meshes[i]

    def __len__(self):
        return len(self._meshes)

    def __iter__(self):
        return iter(self._meshes)

    def __repr__(self):
        return f"MeshSequence({self._meshes!r})"


__all__ += ["RelabeledMesh", "MeshSequence"]
