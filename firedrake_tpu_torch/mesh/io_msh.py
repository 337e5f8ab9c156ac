"""Gmsh .msh reader (ASCII v2.2 and v4.1), and the tail every reader shares.

Reference: firedrake/mesh.py:363-461 reads gmsh/exodus/cgns through
DMPlex; here numpy parses the file and builds the plex-lite directly.
Physical tags become facet markers (codim-1 elements) and cell markers
(dim elements) — the same surface `Mesh("file.msh")` + `ds(tag)`/`dx(tag)`.

The sections are parsed as whole token arrays and the element records in
blocks of one type, so a file of millions of elements reads in seconds.
The JAX package's reader gives the same arrays, but differs in three
places: an element type it cannot read exactly (second-order cells,
prisms, pyramids) is an error here, not skipped; the parametric
coordinates of a v4.1 `$Nodes` block are read past, not taken for the next
node; and a binary file or a v4.0 file is refused by name.
"""
from __future__ import annotations

import numpy as np

from .topology import MeshTopology, _IDX
from .geometry import Mesh

# gmsh element type -> (cell name, nverts, dim)
_GMSH_TYPES = {
    1: ("interval", 2, 1),
    2: ("triangle", 3, 2),
    3: ("quadrilateral", 4, 2),
    4: ("tetrahedron", 4, 3),
    5: ("hexahedron", 8, 3),
    15: ("point", 1, 0),
}
# gmsh node orders differ from ours for quads/hexes (gmsh uses CCW cycles,
# we use lexicographic)
_REORDER_FROM_GMSH = {
    "quadrilateral": [0, 1, 3, 2],
    "hexahedron": [0, 1, 3, 2, 4, 5, 7, 6],
}


def read_msh(filename: str, name=None) -> Mesh:
    with open(filename) as fh:
        text = fh.read()
    if "$MeshFormat" not in text:
        raise ValueError("not a gmsh file")
    head = text.split("$MeshFormat")[1].split()
    version = float(head[0])
    if head[1] != "0":
        raise NotImplementedError(f"{filename}: binary gmsh files (ASCII "
                                  "v2.2 and v4.1 are read)")
    if version >= 4.0:
        if version != 4.1:
            raise NotImplementedError(f"{filename}: gmsh format {head[0]} "
                                      "(ASCII v2.2 and v4.1 are read)")
        nodes, elements = _parse_v4(text)
    else:
        nodes, elements = _parse_v2(text)
    return _build(nodes, elements, name or filename)


def _section(text, tag):
    return text.split(f"${tag}")[1].split(f"$End{tag}")[0]


def _check_type(etype):
    if etype not in _GMSH_TYPES:
        raise NotImplementedError(
            f"gmsh element type {etype} (linear points, lines, triangles, "
            "quadrilaterals, tetrahedra and hexahedra are read)")


def _parse_v2(text):
    raw = np.fromstring(_section(text, "Nodes"), dtype=np.float64, sep=" ")
    nn = int(raw[0])
    raw = raw[1:1 + 4 * nn].reshape(nn, 4)
    ids = raw[:, 0].astype(np.int64)
    coords = raw[:, 1:4]
    flat = np.fromstring(_section(text, "Elements"), dtype=np.int64,
                         sep=" ")
    left, p = int(flat[0]), 1
    elements = []       # (etype, phys tags, vertex ids) per run of records
    while left:
        etype, ntags = int(flat[p + 1]), int(flat[p + 2])
        _check_type(etype)
        L = 3 + ntags + _GMSH_TYPES[etype][1]
        r = _run_length(flat, p, L, left, etype, ntags)
        rec = flat[p:p + r * L].reshape(r, L)
        phys = rec[:, 3] if ntags >= 1 else np.zeros(r, dtype=np.int64)
        elements.append((etype, phys, rec[:, 3 + ntags:]))
        p += r * L
        left -= r
    return (ids, coords), elements


def _run_length(flat, p, L, left, etype, ntags):
    """How many records of length L from flat[p] on, at most `left`, share
    the first one's type and tag count (a record's length follows from
    both, so the next record starts L further on)."""
    r, step = 0, 1024
    while r < left:
        m = min(step, left - r, (len(flat) - p) // L - r)
        if m <= 0:
            raise ValueError("gmsh $Elements section ends early")
        rec = flat[p + r * L:p + (r + m) * L].reshape(m, L)
        bad = np.flatnonzero((rec[:, 1] != etype) | (rec[:, 2] != ntags))
        if len(bad):
            return r + int(bad[0])
        r += m
        step *= 2
    return r


def _parse_v4(text):
    # $Nodes: numEntityBlocks numNodes minTag maxTag; blocks of
    # (entityDim entityTag parametric numNodesInBlock) + tags + coords
    # (x y z, then entityDim parametric coordinates when parametric)
    ns = np.fromstring(_section(text, "Nodes"), dtype=np.float64, sep=" ")
    nblocks = int(ns[0])
    p = 4
    all_ids, all_xyz = [], []
    for _ in range(nblocks):
        edim, param, nb = int(ns[p]), int(ns[p + 2]), int(ns[p + 3])
        p += 4
        all_ids.append(ns[p:p + nb])
        p += nb
        w = 3 + (edim if param else 0)
        all_xyz.append(ns[p:p + nb * w].reshape(nb, w)[:, :3])
        p += nb * w
    ids = np.concatenate(all_ids).astype(np.int64)
    coords = np.concatenate(all_xyz)
    # $Entities give physical tags per (dim, entityTag)
    phys_of_entity = {}
    if "$Entities" in text:
        es = _section(text, "Entities").split()
        q = 0
        counts = [int(es[q + i]) for i in range(4)]
        q += 4
        # points: tag x y z numPhys [phys...]
        for _ in range(counts[0]):
            tag = int(es[q]); q += 4
            nph = int(es[q]); q += 1
            ph = int(es[q]) if nph else 0
            q += nph
            phys_of_entity[(0, tag)] = ph
        for d, cnt in ((1, counts[1]), (2, counts[2]), (3, counts[3])):
            for _ in range(cnt):
                tag = int(es[q]); q += 7
                nph = int(es[q]); q += 1
                ph = int(es[q]) if nph else 0
                q += nph
                nb = int(es[q]); q += 1 + nb
                phys_of_entity[(d, tag)] = ph
    els = np.fromstring(_section(text, "Elements"), dtype=np.int64, sep=" ")
    nblocks = int(els[0])
    p = 4
    elements = []
    for _ in range(nblocks):
        edim, etag, etype, nb = (int(x) for x in els[p:p + 4])
        p += 4
        _check_type(etype)
        phys = phys_of_entity.get((edim, etag), etag)
        nv = _GMSH_TYPES[etype][1]
        rec = els[p:p + nb * (1 + nv)].reshape(nb, 1 + nv)
        elements.append((etype, np.full(nb, phys, dtype=np.int64),
                         rec[:, 1:]))
        p += nb * (1 + nv)
    return (ids, coords), elements


def _index_of_ids(ids):
    """A function taking gmsh node ids to 0-based rows of `ids`."""
    if len(ids) and ids.min() >= 0 and ids.max() < 4 * len(ids) + 1024:
        dense = np.full(int(ids.max()) + 1, -1, dtype=np.int64)
        dense[ids] = np.arange(len(ids))

        def index(v):
            if v.size and (v.min() < 0 or v.max() >= len(dense)
                           or (dense[v] < 0).any()):
                raise KeyError("gmsh element names an unknown node")
            return dense[v]
        return index
    order = np.argsort(ids, kind="stable")
    srt = ids[order]

    def index(v):
        pos = np.minimum(np.searchsorted(srt, v), len(srt) - 1)
        if v.size and (srt[pos] != v).any():
            raise KeyError("gmsh element names an unknown node")
        return order[pos]
    return index


def _build(nodes, elements, name):
    ids, coords = nodes
    index = _index_of_ids(ids)
    dim = max(_GMSH_TYPES[e][2] for e, _, _ in elements)
    cell_name = None
    cells, cell_tags = [], []
    facet_elems = []    # (vertex rows, phys) blocks in file order
    for etype, phys, verts in elements:
        cname, nv, edim = _GMSH_TYPES[etype]
        vv = index(verts)
        if edim == dim:
            if cell_name is None:
                cell_name = cname
            elif cell_name != cname:
                raise NotImplementedError("mixed-cell gmsh meshes")
            if cname in _REORDER_FROM_GMSH:
                vv = vv[:, _REORDER_FROM_GMSH[cname]]
            cells.append(vv)
            cell_tags.append(phys)
        elif edim == dim - 1:
            facet_elems.append((vv, phys))
    cells = np.concatenate(cells).astype(_IDX)
    # drop geometric z column for 2D meshes embedded at z=0
    gdim = 3
    if dim <= 2 and np.allclose(coords[:, 2], 0.0):
        gdim = 2
    if dim == 1 and np.allclose(coords[:, 1], 0.0):
        gdim = 1
    verts = coords[:, :gdim]
    return mesh_from_arrays(verts, cells, cell_name, name,
                            cell_tags=np.concatenate(cell_tags),
                            facet_elems=facet_elems)


def match_rows(table, rows):
    """Row index in `table` of each row of `rows`, -1 where none equals it
    (both (n, k) integer arrays, `table`'s rows distinct), by one lexsort
    over both: no packed keys, so no bound on the vertex ids."""
    nt = len(table)
    both = np.concatenate([table, rows]).astype(np.int64)
    if not len(rows):
        return np.zeros(0, dtype=np.int64)
    order = np.lexsort(both.T[::-1])
    s = both[order]
    new = np.ones(len(s), dtype=bool)
    new[1:] = np.any(s[1:] != s[:-1], axis=1)
    group = np.empty(len(s), dtype=np.int64)
    group[order] = np.cumsum(new) - 1
    of_group = np.full(int(group.max()) + 1, -1, dtype=np.int64)
    of_group[group[:nt]] = np.arange(nt)
    return of_group[group[nt:]]


def facet_markers_of(topo, facet_elems):
    """Facet markers from (vertex rows, tag) blocks: each row is matched,
    as a vertex set, against the facets with that many vertices; a facet
    tagged more than once keeps its last tag, in block order."""
    fv = np.asarray(topo.facet_vertices)
    nvalid = (fv >= 0).sum(axis=1)
    fv_sorted = np.sort(np.where(fv < 0, np.iinfo(np.int64).max, fv),
                        axis=1)
    hit, tag = [], []
    for rows, phys in facet_elems:
        rows = np.sort(np.asarray(rows, dtype=np.int64), axis=1)
        k = rows.shape[1]
        sel = np.flatnonzero(nvalid == k)
        i = match_rows(fv_sorted[sel, :k], rows)
        found = i >= 0
        hit.append(sel[i[found]])
        tag.append(np.broadcast_to(np.asarray(phys), len(rows))[found])
    markers = np.zeros(len(fv), dtype=_IDX)
    if hit:
        hit, tag = np.concatenate(hit), np.concatenate(tag)
        # the last tag of each facet: first occurrence in reversed order
        uniq, first = np.unique(hit[::-1], return_index=True)
        markers[uniq] = tag[::-1][first]
    return markers


def mesh_from_arrays(verts, cells, cell_name, name, cell_tags=None,
                     facet_elems=None):
    """Build a tagged Mesh from vertex coordinates + 0-based cell
    connectivity (OUR node order).  `cell_tags` is a per-cell marker
    array; `facet_elems` is a list of (vertex rows, tags) blocks, each row
    a tagged codim-1 element's vertices (any order) and `tags` one tag or
    one per row, matched against the facet table to set facet markers.
    Shared tail of the gmsh/exodus/cgns readers (reference:
    firedrake/mesh.py plex-from-cell-list path, mesh.py:376-461)."""
    cells = np.asarray(cells, dtype=_IDX)
    topo = MeshTopology(cells, len(verts), cell_name, name)
    mesh = Mesh(topo, np.asarray(verts, dtype=float), name=name)
    if cell_tags is not None and len(cell_tags):
        mesh.cell_markers = np.asarray(cell_tags, dtype=_IDX)
    if facet_elems and sum(len(r) for r, _ in facet_elems):
        mesh.facet_markers = facet_markers_of(topo, facet_elems)
    return mesh
