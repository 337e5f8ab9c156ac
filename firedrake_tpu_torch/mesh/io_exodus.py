"""Exodus II mesh reader (.e / .exo).

Exodus II is a netCDF-3 container (Sandia's FEM interchange format);
scipy.io.netcdf_file reads it without any external library.  The
reference reads these through DMPlexCreateExodusFromFile
(firedrake/mesh.py:376-388); here numpy builds the plex-lite directly,
mapping element blocks to cell markers (block id) and side sets to facet
markers (side-set id) so the usual `Mesh("file.exo")` + `dx(tag)` /
`ds(tag)` surface works.

Supported element blocks: TRI3, QUAD4, TETRA4/TET4, HEX8 (linear
cells, matching the rest of the mesh layer).  All blocks in a file
must share one cell type.  A block with more nodes per element (TRI6,
HEX27, ...) is an error; the JAX package keeps its first corners.
"""
from __future__ import annotations

import numpy as np

from .io_msh import mesh_from_arrays

# exodus element name prefix -> (our cell name, nverts)
_EXO_TYPES = {
    "TRI": ("triangle", 3),
    "QUAD": ("quadrilateral", 4),
    "SHELL": ("quadrilateral", 4),
    "TETRA": ("tetrahedron", 4),
    "TET": ("tetrahedron", 4),
    "HEX": ("hexahedron", 8),
    "BAR": ("interval", 2),
    "BEAM": ("interval", 2),
}
# exodus node cycles -> our lexicographic order
_REORDER_FROM_EXO = {
    "quadrilateral": [0, 1, 3, 2],
    "hexahedron": [0, 1, 3, 2, 4, 5, 7, 6],
}
# Exodus II local side -> ORIGINAL-ORDER local vertices (0-based),
# per the Exodus II spec (sides are 1-based in the file).
_EXO_SIDES = {
    "triangle": [(0, 1), (1, 2), (2, 0)],
    "quadrilateral": [(0, 1), (1, 2), (2, 3), (3, 0)],
    "tetrahedron": [(0, 1, 3), (1, 2, 3), (0, 3, 2), (0, 2, 1)],
    "hexahedron": [(0, 1, 5, 4), (1, 2, 6, 5), (2, 3, 7, 6),
                   (0, 4, 7, 3), (0, 3, 2, 1), (4, 5, 6, 7)],
}


def _str(x):
    if isinstance(x, bytes):
        return x.decode("ascii", "ignore")
    return str(x)


def read_exodus(filename: str, name=None):
    from scipy.io import netcdf_file
    with netcdf_file(filename, "r", mmap=False) as nc:
        ndim = int(nc.dimensions["num_dim"])
        nnode = int(nc.dimensions["num_nodes"])
        # coordinates: either one (ndim, nnode) "coord" variable or
        # separate coordx/coordy/coordz
        if "coord" in nc.variables:
            coords = np.array(nc.variables["coord"][:]).T[:nnode, :ndim]
        else:
            axes = ["coordx", "coordy", "coordz"][:ndim]
            coords = np.stack(
                [np.array(nc.variables[a][:], dtype=float) for a in axes],
                axis=1)
        nblk = int(nc.dimensions.get("num_el_blk", 1))
        blk_ids = (np.array(nc.variables["eb_prop1"][:], dtype=np.int64)
                   if "eb_prop1" in nc.variables
                   else np.arange(1, nblk + 1, dtype=np.int64))
        cell_name = None
        cells, cell_tags = [], []
        # original-order (pre-reorder) connectivity per global element,
        # 0-based, for side-set resolution
        orig_conn = []
        for b in range(nblk):
            var = nc.variables[f"connect{b + 1}"]
            etype = _str(getattr(var, "elem_type", b"")).upper().strip()
            base = etype.rstrip("0123456789")
            if base not in _EXO_TYPES:
                raise NotImplementedError(
                    f"exodus element type {etype!r} (linear "
                    f"TRI3/QUAD4/TET4/HEX8 supported)")
            cname, nv = _EXO_TYPES[base]
            conn = np.array(var[:], dtype=np.int64)
            if conn.shape[1] != nv:
                raise NotImplementedError(
                    f"exodus block {b + 1}: element type {etype!r} with "
                    f"{conn.shape[1]} nodes per element (linear "
                    f"TRI3/QUAD4/TET4/HEX8 supported)")
            if cell_name is None:
                cell_name = cname
            elif cell_name != cname:
                raise NotImplementedError("mixed-cell exodus meshes")
            conn = conn - 1
            orig_conn.append(conn)
            if cname in _REORDER_FROM_EXO:
                conn = conn[:, _REORDER_FROM_EXO[cname]]
            cells.append(conn)
            cell_tags.append(np.full(len(conn), int(blk_ids[b]),
                                     dtype=np.int64))
        cells = np.concatenate(cells, axis=0)
        cell_tags = np.concatenate(cell_tags)
        orig_conn = np.concatenate(orig_conn, axis=0)

        # side sets -> (vertex rows, tag) blocks
        facet_elems = []
        nss = int(nc.dimensions.get("num_side_sets", 0) or 0)
        if nss:
            ss_ids = (np.array(nc.variables["ss_prop1"][:],
                               dtype=np.int64)
                      if "ss_prop1" in nc.variables
                      else np.arange(1, nss + 1, dtype=np.int64))
            sides = np.array(_EXO_SIDES[cell_name])
            for s in range(nss):
                els = np.array(nc.variables[f"elem_ss{s + 1}"][:],
                               dtype=np.int64) - 1
                sds = np.array(nc.variables[f"side_ss{s + 1}"][:],
                               dtype=np.int64) - 1
                rows = np.take_along_axis(orig_conn[els], sides[sds],
                                          axis=1)
                facet_elems.append((rows, int(ss_ids[s])))
    return mesh_from_arrays(coords[:, :ndim], cells, cell_name,
                            name or filename, cell_tags=cell_tags,
                            facet_elems=facet_elems)
