"""Mesh hierarchies by uniform refinement.

Reference: firedrake/mg/mesh.py:184 MeshHierarchy (DMPlex uniform
refinement, keeping coarse->fine cell maps) / HierarchyBase :36.
Refinement is host-side numpy; the products are the child-cell maps the
transfer kernels consume.

Simplex refinement: red refinement — each triangle -> 4 children, each tet
-> 4 corner tets + 4 octahedron tets (Bey's rule, diagonal m01-m23);
unstructured quads -> 4 children through edge and cell midpoints.
Structured utility meshes (triangles, quads, tets, hexes) refine keeping
their grid numbering (_refine_structured), so every level takes the
stencil path.  Extruded hierarchies refine their base meshes and the
layers (ExtrudedMeshHierarchy), or the layers alone
(SemiCoarsenedExtrudedHierarchy).  NonNestedHierarchy links meshes
that do not nest; its transfers interpolate across meshes
(mg/transfer.py NonNestedTransfer).
"""
from __future__ import annotations

import numpy as np

from ..mesh.topology import MeshTopology, _IDX
from ..mesh.geometry import Mesh

__all__ = ["MeshHierarchy", "HierarchyBase", "NonNestedHierarchy",
           "refine_mesh",
           "ExtrudedMeshHierarchy", "SemiCoarsenedExtrudedHierarchy"]

def _refine_triangle(mesh: Mesh):
    topo = mesh.topology
    nv = topo.num_vertices
    edges = topo._entity_data[1]["entities"]         # (ne, 2) sorted
    mids = mesh._vertex_coords[edges].mean(axis=1)
    verts = np.vstack([mesh._vertex_coords, mids])
    cell_edges = topo.cell_entities(1)               # (nc, 3) our order:
    # edge i opposite vertex i: e0=(1,2), e1=(0,2), e2=(0,1)
    cv = topo.cell_vertices
    m12 = nv + cell_edges[:, 0]
    m02 = nv + cell_edges[:, 1]
    m01 = nv + cell_edges[:, 2]
    v0, v1, v2 = cv[:, 0], cv[:, 1], cv[:, 2]
    children = np.stack([
        np.stack([v0, m01, m02], 1),
        np.stack([v1, m12, m01], 1),
        np.stack([v2, m02, m12], 1),
        np.stack([m01, m12, m02], 1),
    ], axis=1)                                        # (nc, 4, 3)
    cells = children.reshape(-1, 3)
    c2f = np.arange(len(cells)).reshape(-1, 4, order="C")
    # children interleaved per coarse cell: cell c children at 4c..4c+3
    cells = children.reshape(-1, 3)
    c2f = (np.arange(topo.num_cells)[:, None] * 4
           + np.arange(4)[None, :])
    return cells, verts, c2f


def _refine_tet(mesh: Mesh):
    topo = mesh.topology
    nv = topo.num_vertices
    edges = topo._entity_data[1]["entities"]
    mids = mesh._vertex_coords[edges].mean(axis=1)
    verts = np.vstack([mesh._vertex_coords, mids])
    ce = topo.cell_entities(1)                        # (nc, 6)
    cv = topo.cell_vertices
    # our tet edge order: (0,1),(0,2),(0,3),(1,2),(1,3),(2,3)
    m01 = nv + ce[:, 0]
    m02 = nv + ce[:, 1]
    m03 = nv + ce[:, 2]
    m12 = nv + ce[:, 3]
    m13 = nv + ce[:, 4]
    m23 = nv + ce[:, 5]
    v0, v1, v2, v3 = (cv[:, i] for i in range(4))
    # Bey's red refinement with the SHORTEST interior diagonal chosen
    # per cell (Zhang's criterion): a fixed diagonal degrades shape
    # quality geometrically under repeated refinement (measured: min
    # aspect quality halves per level on UnitCubeMesh hierarchies)
    dlen = np.stack([
        np.linalg.norm(verts[m01] - verts[m23], axis=1),
        np.linalg.norm(verts[m02] - verts[m13], axis=1),
        np.linalg.norm(verts[m03] - verts[m12], axis=1)], axis=1)
    type_of = np.argmin(dlen, axis=1)                 # (nc,)
    corner = [
        np.stack([v0, m01, m02, m03], 1),
        np.stack([v1, m01, m12, m13], 1),
        np.stack([v2, m02, m12, m23], 1),
        np.stack([v3, m03, m13, m23], 1)]
    interior_by_diag = [
        [np.stack([m01, m02, m03, m23], 1),
         np.stack([m01, m02, m12, m23], 1),
         np.stack([m01, m03, m13, m23], 1),
         np.stack([m01, m12, m13, m23], 1)],
        [np.stack([m02, m01, m03, m13], 1),
         np.stack([m02, m01, m12, m13], 1),
         np.stack([m02, m03, m23, m13], 1),
         np.stack([m02, m12, m23, m13], 1)],
        [np.stack([m03, m01, m02, m12], 1),
         np.stack([m03, m01, m13, m12], 1),
         np.stack([m03, m02, m23, m12], 1),
         np.stack([m03, m13, m23, m12], 1)]]
    interior = [np.where(type_of[:, None] == 2, i2,
                         np.where(type_of[:, None] == 1, i1, i0))
                for i0, i1, i2 in zip(*interior_by_diag)]
    children = np.stack(corner + interior, axis=1)    # (nc, 8, 4)
    cells = children.reshape(-1, 4)
    c2f = (np.arange(topo.num_cells)[:, None] * 8
           + np.arange(8)[None, :])
    return cells, verts, c2f, type_of


def _refine_quad(mesh: Mesh):
    topo = mesh.topology
    nv = topo.num_vertices
    edges = topo._entity_data[1]["entities"]
    ne = len(edges)
    mids = mesh._vertex_coords[edges].mean(axis=1)
    centers = mesh._vertex_coords[topo.cell_vertices].mean(axis=1)
    verts = np.vstack([mesh._vertex_coords, mids, centers])
    ce = topo.cell_entities(1)                        # (nc, 4)
    cv = topo.cell_vertices                           # lex: (0,0),(1,0),(0,1),(1,1)
    # our quad edges: e0=(0,1) y=0, e1=(2,3) y=1, e2=(0,2) x=0, e3=(1,3) x=1
    mb = nv + ce[:, 0]
    mt = nv + ce[:, 1]
    ml = nv + ce[:, 2]
    mr = nv + ce[:, 3]
    cc = nv + ne + np.arange(topo.num_cells)
    v00, v10, v01, v11 = (cv[:, i] for i in range(4))
    children = np.stack([
        np.stack([v00, mb, ml, cc], 1),
        np.stack([mb, v10, cc, mr], 1),
        np.stack([ml, cc, v01, mt], 1),
        np.stack([cc, mr, mt, v11], 1),
    ], axis=1)
    cells = children.reshape(-1, 4)
    c2f = (np.arange(topo.num_cells)[:, None] * 4
           + np.arange(4)[None, :])
    return cells, verts, c2f


_REFINERS = {"triangle": _refine_triangle, "tetrahedron": _refine_tet,
             "quadrilateral": _refine_quad}

# child reference maps: fine child k occupies sub-cell of the reference
# cell; A_k, b_k with  X_coarse = A_k @ X_fine + b_k
def child_reference_maps(cell_name: str):
    if cell_name == "triangle":
        V = np.array([[0.0, 0], [1, 0], [0, 1]])
        m01, m02, m12 = (V[0]+V[1])/2, (V[0]+V[2])/2, (V[1]+V[2])/2
        tris = [  # must match _refine_triangle child vertex order
            (V[0], m01, m02),
            (V[1], m12, m01),
            (V[2], m02, m12),
            (m01, m12, m02),
        ]
        out = []
        for (a, b, c) in tris:
            A = np.stack([b - a, c - a], axis=1)
            out.append((A, a))
        return out
    if cell_name == "tetrahedron":
        V = np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
        m = lambda i, j: (V[i] + V[j]) / 2
        tets = [
            (V[0], m(0, 1), m(0, 2), m(0, 3)),
            (V[1], m(0, 1), m(1, 2), m(1, 3)),
            (V[2], m(0, 2), m(1, 2), m(2, 3)),
            (V[3], m(0, 3), m(1, 3), m(2, 3)),
            (m(0, 1), m(0, 2), m(0, 3), m(2, 3)),
            (m(0, 1), m(0, 2), m(1, 2), m(2, 3)),
            (m(0, 1), m(0, 3), m(1, 3), m(2, 3)),
            (m(0, 1), m(1, 2), m(1, 3), m(2, 3)),
        ]
        out = []
        for vs in tets:
            a = vs[0]
            A = np.stack([vs[i] - a for i in (1, 2, 3)], axis=1)
            out.append((A, a))
        return out
    if cell_name == "quadrilateral":
        h = 0.5
        out = []
        for (ox, oy) in [(0, 0), (h, 0), (0, h), (h, h)]:
            A = np.eye(2) * h
            out.append((A, np.array([ox, oy])))
        return out
    raise NotImplementedError(cell_name)


def _refine_structured(mesh: Mesh):
    """Uniform refinement of a structured Rectangle/BoxMesh-family mesh
    that PRESERVES grid numbering (mesh/utility.py conventions), so every
    hierarchy level keeps the zero-gather stencil assembly/transfer fast
    path (assembly/stencil.py).  Fine vertex = the coarse vertex, edge
    midpoint, face-diagonal midpoint, or cell center it geometrically is
    (parity_class_weights derives the combination from the mesh's own
    cell types), so deformed coordinates refine exactly like the generic
    red refinement.  Dimension-generic: 2D tri/quad grids and 3D
    Freudenthal-tet/hex grids (Kuhn cubes refine to Kuhn cubes — Bey's
    conforming red refinement)."""
    from ..assembly.stencil import (type_vertex_offsets, struct_dims,
                                    parity_class_weights, _cell_grid_index)
    import itertools
    s = mesh._structured
    kind = s["kind"]
    dims = struct_dims(s)
    D = len(dims)
    g = mesh._vertex_coords.shape[1]
    tverts_i = type_vertex_offsets(mesh)
    ntypes = len(tverts_i)
    # fine vertex grid from parity-class stencils of the coarse grid
    pshape = tuple(reversed([n + 1 for n in dims]))      # coarse, rev axes
    C = mesh._vertex_coords.reshape(pshape + (g,))
    fshape = tuple(reversed([2 * n + 1 for n in dims]))
    F = np.zeros(fshape + (g,))
    for p in itertools.product((0, 1), repeat=D):
        dest = tuple(slice(p[ax], None, 2)
                     for ax in reversed(range(D)))
        if not any(p):
            F[dest] = C
            continue
        acc = None
        for off, w in parity_class_weights(tverts_i, p):
            src = tuple(slice(off[ax], off[ax] + dims[ax] + 1 - p[ax])
                        for ax in reversed(range(D)))
            v = w * C[src]
            acc = v if acc is None else acc + v
        F[dest] = acc
    from ..mesh.utility import _structured_cells_nd
    fdims = tuple(2 * n for n in dims)
    cells, ct = _structured_cells_nd(fdims, kind)
    topo = MeshTopology(cells.astype(_IDX), int(np.prod(
        [n + 1 for n in fdims])), ct, name=f"{mesh.name}_ref")
    fine = Mesh(topo, F.reshape(-1, g), name=f"{mesh.name}_ref")
    fine._structured = dict(s)
    for ax, nm in enumerate(("nx", "ny", "nz")[:D]):
        fine._structured[nm] = fdims[ax]
    if getattr(mesh, "_box_lengths", None) is not None:
        from ..mesh.utility import _mark_box_facets
        fine._box_lengths = mesh._box_lengths
        _mark_box_facets(fine, mesh._box_lengths)
    else:
        _inherit_markers(mesh, fine)

    # children: assign each fine cell of the 2^D sub-cubes to the coarse
    # type whose unit-cube simplex contains its centroid
    tverts = [np.asarray(v, dtype=np.float64) for v in tverts_i]
    # orientation forcing may permute fine tets differently only if the
    # fine mesh had negative cells; same unit geometry -> same types
    ftverts = [np.asarray(v, dtype=np.float64)
               for v in type_vertex_offsets(fine)]

    def _edges(V):
        if len(V) == 2 ** D:
            return np.eye(D)
        return np.stack([V[i + 1] - V[0] for i in range(D)], axis=1)

    def _contains(t, p):
        V = tverts[t]
        if len(V) == 2 ** D:
            return True
        lam = np.linalg.solve(_edges(V), p - V[0])
        return lam.min() > -1e-12 and lam.sum() < 1 + 1e-12

    children = {t: [] for t in range(ntypes)}      # [(t2, sub-cube offset)]
    child_maps = {t: [] for t in range(ntypes)}    # [(A, b)] fine->coarse ref
    for t2 in range(ntypes):
        for sub in itertools.product((0, 1), repeat=D):
            suba = np.asarray(sub, dtype=np.float64)
            cent = (suba + ftverts[t2].mean(axis=0)) / 2.0
            t = next(tt for tt in range(ntypes) if _contains(tt, cent))
            children[t].append((t2, sub))
            Ec, Ef = _edges(tverts[t]), _edges(ftverts[t2])
            V0c = tverts[t][0] if len(tverts[t]) != 2 ** D \
                else np.zeros(D)
            V0f = ftverts[t2][0] if len(ftverts[t2]) != 2 ** D \
                else np.zeros(D)
            Eci = np.linalg.inv(Ec)
            A = Eci @ Ef / 2.0
            bb = Eci @ ((suba + V0f) / 2.0 - V0c)
            child_maps[t].append((A, bb))
    nchild = 2 ** D
    assert all(len(children[t]) == nchild for t in range(ntypes))
    c = np.arange(ntypes * int(np.prod(dims)))
    t_of = c % ntypes
    qidx = _cell_grid_index(c // ntypes, dims)
    # fine quad index q = sum_ax fi_ax * prod(fdims[ax+1:]) with the
    # x-slowest convention: strides (prod(fdims[1:]), ..., fdims[-1], 1)
    fstr = [int(np.prod(fdims[ax + 1:])) for ax in range(D)]
    c2f = np.zeros((len(c), nchild), dtype=np.int64)
    for t in range(ntypes):
        sel = t_of == t
        for kchild, (t2, sub) in enumerate(children[t]):
            qf = 0
            for ax in range(D):
                qf = qf + (2 * qidx[ax][sel] + sub[ax]) * fstr[ax]
            c2f[sel, kchild] = ntypes * qf + t2
    fine._coarse_mesh = mesh
    fine._c2f_cells = c2f
    fine._child_maps = [child_maps[t] for t in range(ntypes)]
    return fine


def refine_mesh(mesh: Mesh):
    if getattr(mesh, "_structured", None) is not None:
        return _refine_structured(mesh)
    try:
        refiner = _REFINERS[mesh.cell.name]
    except KeyError:
        raise NotImplementedError(f"refinement of {mesh.cell.name}")
    out = refiner(mesh)
    type_of = None
    if len(out) == 4:                     # per-cell refinement variants
        cells, verts, c2f, type_of = out
    else:
        cells, verts, c2f = out
    topo = MeshTopology(cells.astype(_IDX), len(verts), mesh.cell.name,
                        name=f"{mesh.name}_ref")
    fine = Mesh(topo, verts, name=f"{mesh.name}_ref")
    # marker inheritance for box-utility meshes: re-mark geometrically
    if getattr(mesh, "_box_lengths", None) is not None:
        from ..mesh.utility import _mark_box_facets
        fine._box_lengths = mesh._box_lengths
        _mark_box_facets(fine, mesh._box_lengths)
    else:
        _inherit_markers(mesh, fine)
    fine._coarse_mesh = mesh
    fine._c2f_cells = c2f
    if type_of is not None:
        fine._c2f_type_of = type_of
    return fine


def _inherit_markers(coarse: Mesh, fine: Mesh):
    """Geometric marker inheritance: a fine exterior facet centroid lies on
    exactly one coarse exterior facet; copy its marker."""
    ct, ft = coarse.topology, fine.topology
    cf = ct.exterior_facets
    if len(cf) == 0:
        return
    cfv = ct.facet_vertices[cf]
    cpts = coarse._vertex_coords[cfv]                 # (ncf, nvpf, g)
    ffac = ft.exterior_facets
    fcent = fine._vertex_coords[ft.facet_vertices[ffac]].mean(axis=1)
    markers = np.zeros(len(ft.facet_cells), dtype=_IDX)
    # distance from fine centroid to coarse facet (affine hull + bounds)
    for i, fi in enumerate(cf):
        marker = coarse.facet_markers[fi]
        if marker == 0:
            continue
        pts = cpts[i]
        a = pts[0]
        if pts.shape[0] == 2:
            d = pts[1] - a
            t = ((fcent - a) @ d) / (d @ d)
            proj = a + np.clip(t, 0, 1)[:, None] * d
        else:
            d1, d2 = pts[1] - a, pts[2] - a
            G = np.array([[d1 @ d1, d1 @ d2], [d2 @ d1, d2 @ d2]])
            rhs = np.stack([(fcent - a) @ d1, (fcent - a) @ d2])
            uv = np.linalg.solve(G, rhs).T
            proj = a + uv[:, :1] * d1 + uv[:, 1:] * d2
        on = np.linalg.norm(fcent - proj, axis=1) < 1e-12
        markers[ffac[on]] = marker
    fine.facet_markers = markers


class HierarchyBase:
    """Reference: firedrake/mg/mesh.py:36."""

    def __init__(self, meshes):
        self.meshes = list(meshes)
        for lvl, m in enumerate(self.meshes):
            m._mg_hierarchy = self
            m._mg_level = lvl

    def __iter__(self):
        return iter(self.meshes)

    def __getitem__(self, i):
        return self.meshes[i]

    def __len__(self):
        return len(self.meshes)

    @property
    def coarsest(self):
        return self.meshes[0]

    @property
    def finest(self):
        return self.meshes[-1]


def MeshHierarchy(mesh: Mesh, refinement_levels: int, **kwargs):
    meshes = [mesh]
    for _ in range(refinement_levels):
        meshes.append(refine_mesh(meshes[-1]))
    return HierarchyBase(meshes)


# ------------------------------------------------------------- extruded
def _link_extruded_levels(mc, mf, nlc, nlf):
    """Attach coarse->fine cell maps + child reference maps between two
    extruded levels (horizontal children x vertical sub-layers).
    Reference: firedrake/mg/mesh.py:320 ExtrudedMeshHierarchy builds the
    extruded levels from the base hierarchy's DMPlex refinements."""
    bc_mesh, bf_mesh = mc._base_mesh, mf._base_mesh
    rz = nlf // nlc
    assert rz * nlc == nlf, "fine layers must be a multiple of coarse"
    d = mc.geometric_dimension
    if bf_mesh is bc_mesh:                      # semi-coarsened: z only
        b_c2f = np.arange(bc_mesh.num_cells, dtype=np.int64)[:, None]
        bcm = [[(np.eye(d - 1), np.zeros(d - 1))]]
        btype_of = np.zeros(bc_mesh.num_cells, dtype=np.int64)
    else:
        assert getattr(bf_mesh, "_coarse_mesh", None) is bc_mesh, \
            "base meshes are not consecutive hierarchy levels"
        b_c2f = np.asarray(bf_mesh._c2f_cells, dtype=np.int64)
        bcm = getattr(bf_mesh, "_child_maps", None)
        if bcm is None:
            bcm = [child_reference_maps(bc_mesh.cell.name)]
        ntypes_b = len(bcm)
        btype_of = np.arange(bc_mesh.num_cells) % ntypes_b
    ncb, nchild_b = b_c2f.shape
    lc = np.arange(nlc, dtype=np.int64)
    jz = np.arange(rz, dtype=np.int64)
    # coarse extruded cell (b, l) = b*nlc + l; fine child (bf, rz*l + j)
    c2f = (b_c2f[:, None, :, None] * nlf
           + lc[None, :, None, None] * rz + jz[None, None, None, :])
    mf._coarse_mesh = mc
    mf._c2f_cells = c2f.reshape(ncb * nlc, nchild_b * rz)
    # child maps: X_coarse = blkdiag(A_b, 1/rz) @ X_fine + (b_b, j/rz)
    cmaps = []
    for maps_t in bcm:
        mt = []
        for (Ab, bb) in maps_t:
            for j in range(rz):
                A = np.zeros((d, d))
                A[:d - 1, :d - 1] = Ab
                A[d - 1, d - 1] = 1.0 / rz
                b = np.append(np.asarray(bb, dtype=float), j / rz)
                mt.append((A, b))
        cmaps.append(mt)
    mf._child_maps = cmaps
    # extruded cell ordering is column-major, not type-interleaved
    mf._c2f_type_of = np.repeat(btype_of, nlc)


def ExtrudedMeshHierarchy(base_hierarchy, height=1.0, base_layer=None,
                          refinement_ratio=2, layers=None, **kwargs):
    """Hierarchy of extruded meshes over a base hierarchy: horizontal
    refinement from the base levels, vertical refinement by
    ``refinement_ratio`` starting at ``base_layer`` (or a constant
    ``layers`` on every level).  Reference: firedrake/mg/mesh.py:320."""
    from ..mesh.utility import ExtrudedMesh
    bms = list(base_hierarchy.meshes)
    if layers is not None:
        lays = [int(layers)] * len(bms)
    else:
        if base_layer is None:
            raise ValueError("give either layers= or base_layer=")
        lays = [int(base_layer) * int(refinement_ratio) ** l
                for l in range(len(bms))]
    meshes = [ExtrudedMesh(bm, nl, layer_height=height / nl)
              for bm, nl in zip(bms, lays)]
    for mc, mf, nlc, nlf in zip(meshes, meshes[1:], lays, lays[1:]):
        _link_extruded_levels(mc, mf, nlc, nlf)
    return HierarchyBase(meshes)


def SemiCoarsenedExtrudedHierarchy(base_mesh, height=1.0, nref=1,
                                   base_layer=1, refinement_ratio=2,
                                   **kwargs):
    """Hierarchy refined ONLY in the extruded direction (same base mesh
    on every level).  Reference: firedrake/mg/mesh.py:404."""
    from ..mesh.utility import ExtrudedMesh
    lays = [int(base_layer) * int(refinement_ratio) ** l
            for l in range(nref + 1)]
    meshes = [ExtrudedMesh(base_mesh, nl, layer_height=height / nl)
              for nl in lays]
    for mc, mf, nlc, nlf in zip(meshes, meshes[1:], lays, lays[1:]):
        _link_extruded_levels(mc, mf, nlc, nlf)
    return HierarchyBase(meshes)


def NonNestedHierarchy(*meshes):
    """Hierarchy over arbitrary (non-nested) meshes of the same domain;
    transfers go through cross-mesh node interpolation
    (mg/transfer.py NonNestedTransfer).  Reference:
    firedrake/mg/mesh.py:442 NonNestedHierarchy."""
    ms = list(meshes)
    for mc, mf in zip(ms, ms[1:]):
        mf._nonnested_coarse = mc
    return HierarchyBase(ms)
