"""CGNS mesh reader (.cgns, HDF5 flavor).

CGNS files since v3 are HDF5 containers: every CGNS node is an HDF5
group carrying `label`/`name` attributes with its payload in a " data"
dataset.  The reference reads these through DMPlexCreateCGNSFromFile
(firedrake/mesh.py:376-388); here h5py + numpy walk the tree directly.

Supported: one unstructured Zone_t; Elements_t sections of TRI_3,
QUAD_4, TETRA_4, HEXA_8 (cells) and their codim-1 types (boundary
facets); ZoneBC_t/BC_t with ElementRange/PointRange (FaceCenter
location) become facet markers, numbered by BC order (1-based) —
matching how DMPlex labels CGNS BCs.  Any other element section is an
error (the JAX package skips it).  BCs are numbered in the file's order
where the file tracks the creation order of its groups; elsewhere h5py
lists them by name, and they are numbered by their first element id, as
the JAX package numbers them in every file.
"""
from __future__ import annotations

import numpy as np

from .io_msh import mesh_from_arrays

# CGNS ElementType_t code -> (our cell name, nverts, dim)
_CGNS_TYPES = {
    3: ("interval", 2, 1),       # BAR_2
    5: ("triangle", 3, 2),       # TRI_3
    7: ("quadrilateral", 4, 2),  # QUAD_4
    10: ("tetrahedron", 4, 3),   # TETRA_4
    17: ("hexahedron", 8, 3),    # HEXA_8
}
_REORDER_FROM_CGNS = {
    "quadrilateral": [0, 1, 3, 2],
    "hexahedron": [0, 1, 3, 2, 4, 5, 7, 6],
}


def _label(node):
    lab = node.attrs.get("label", b"")
    return lab.decode() if isinstance(lab, bytes) else str(lab)


def _data(node):
    if " data" in node:
        return np.array(node[" data"])
    return None


def _children(node, label):
    out = []
    for k in node:
        if k == " data":
            continue
        child = node[k]
        if hasattr(child, "attrs") and _label(child) == label:
            out.append(child)
    return out


def _in_creation_order(group):
    """Whether h5py lists the group's members in the order they were
    created (the file tracks it) rather than by name."""
    import h5py
    flags = group.id.get_create_plist().get_link_creation_order()
    return bool(flags & h5py.h5p.CRT_ORDER_TRACKED)


def read_cgns(filename: str, name=None):
    import h5py
    with h5py.File(filename, "r") as f:
        bases = _children(f, "CGNSBase_t")
        if not bases:
            raise ValueError(f"{filename}: no CGNSBase_t node")
        base = bases[0]
        zones = _children(base, "Zone_t")
        if len(zones) != 1:
            raise NotImplementedError(
                f"cgns: {len(zones)} zones (single unstructured zone "
                f"supported)")
        zone = zones[0]
        for zt in _children(zone, "ZoneType_t"):
            ztype = bytes(_data(zt)).decode("ascii", "ignore")
            if "Unstructured" not in ztype:
                raise NotImplementedError(f"cgns zone type {ztype!r}")

        # coordinates
        gcs = _children(zone, "GridCoordinates_t")
        if not gcs:
            raise ValueError("cgns: no GridCoordinates_t")
        axes = []
        for nm in ("CoordinateX", "CoordinateY", "CoordinateZ"):
            if nm in gcs[0]:
                axes.append(np.asarray(_data(gcs[0][nm]), dtype=float))
        coords = np.stack(axes, axis=1)

        # element sections: (start, end, etype, conn rows)
        sections = []
        for sec in _children(zone, "Elements_t"):
            head = _data(sec)
            etype = int(head[0])
            rng = None
            for r in _children(sec, "IndexRange_t"):
                rng = np.asarray(_data(r), dtype=np.int64)
            conn = None
            for d in _children(sec, "DataArray_t"):
                nm = d.attrs.get("name", b"")
                nm = nm.decode() if isinstance(nm, bytes) else str(nm)
                if nm.strip("\x00 ") == "ElementConnectivity":
                    conn = np.asarray(_data(d), dtype=np.int64)
            if etype == 20:
                raise NotImplementedError("cgns MIXED element sections")
            if etype not in _CGNS_TYPES:
                raise NotImplementedError(
                    f"cgns ElementType_t {etype} in section {sec.name!r} "
                    "(BAR_2, TRI_3, QUAD_4, TETRA_4 and HEXA_8 are read)")
            if rng is None or conn is None:
                raise ValueError(f"cgns section {sec.name!r} has no "
                                 "ElementRange or ElementConnectivity")
            cname, nv, edim = _CGNS_TYPES[etype]
            sections.append((int(rng[0]), int(rng[1]), cname, nv, edim,
                             conn.reshape(-1, nv) - 1))

        if not sections:
            raise ValueError("cgns: no supported Elements_t sections")
        dim = max(s[4] for s in sections)
        cell_name = None
        cells = []
        # codim-1 sections: (first element id, ORIGINAL-ORDER vertex rows)
        # for BC resolution
        facet_secs = []
        for start, end, cname, nv, edim, conn in sections:
            if edim == dim:
                if cell_name is None:
                    cell_name = cname
                elif cell_name != cname:
                    raise NotImplementedError("mixed-cell cgns meshes")
                if cname in _REORDER_FROM_CGNS:
                    conn = conn[:, _REORDER_FROM_CGNS[cname]]
                cells.append(conn)
            elif edim == dim - 1:
                facet_secs.append((start, conn))
        cells = np.concatenate(cells, axis=0)

        # BCs -> facet markers, numbered 1, 2, ... in file order where the
        # file keeps it, else by ascending first element id (which equals
        # file order for sequentially-written element ranges, matching how
        # DMPlex numbers CGNS face sets)
        bc_ids = []
        for zbc in _children(zone, "ZoneBC_t"):
            tracked = _in_creation_order(zbc)
            for bc in _children(zbc, "BC_t"):
                ids = [np.arange(lo, hi + 1) for lo, hi in (
                    np.asarray(_data(r), dtype=np.int64).reshape(-1)[:2]
                    for r in _children(bc, "IndexRange_t"))]
                ids += [np.asarray(_data(d), dtype=np.int64).reshape(-1)
                        for d in _children(bc, "IndexArray_t")]
                ids = np.concatenate(ids) if ids else np.zeros(0, np.int64)
                if len(ids):
                    bc_ids.append((tracked, ids))
        if not all(t for t, _ in bc_ids):
            bc_ids.sort(key=lambda t_ids: t_ids[1].min())
        facet_elems = []
        for tag, (_, ids) in enumerate(bc_ids, start=1):
            for start, conn in facet_secs:
                i = ids - start
                i = i[(i >= 0) & (i < len(conn))]
                facet_elems.append((conn[i], tag))

        gdim = coords.shape[1]
        if dim <= 2 and gdim == 3 and np.allclose(coords[:, 2], 0.0):
            gdim = 2
    return mesh_from_arrays(coords[:, :gdim], cells, cell_name,
                            name or filename, facet_elems=facet_elems)
