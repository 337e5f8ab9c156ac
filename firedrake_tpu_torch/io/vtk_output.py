"""VTK output: .vtu (XML unstructured grid) + .pvd time series.

Reference: firedrake/output/vtk_output.py VTKFile (with DG embedding and
paraview reordering).  Round-1 scope: fields are sampled at mesh vertices
(P1/Q1 view; higher-order and DG fields are interpolated), cells are
written as linear VTK cells.  Lagrange high-order VTK cells are a later
milestone.

Port note: host numpy, as in the JAX package; each field's device
tensor, and the mesh coordinates, are copied to the host once per
``write``, so the files are byte-identical to the JAX package's."""
from __future__ import annotations

import base64
import os
import struct
import numpy as np

from ..device import to_numpy

_VTK_TYPE = {"interval": 3, "triangle": 5, "quadrilateral": 9,
             "tetrahedron": 10, "hexahedron": 12}
# vertex reorder: our lexicographic -> VTK node order
_REORDER = {
    "quadrilateral": [0, 1, 3, 2],
    "hexahedron": [0, 1, 3, 2, 4, 5, 7, 6],
}


def _b64(arr):
    raw = arr.tobytes()
    header = struct.pack("<I", len(raw))
    return base64.b64encode(header + raw).decode()


def _vertex_values(f):
    """Sample a Function at mesh vertices -> (nvert, ncomp) array."""
    V = f.function_space()
    mesh = V.mesh_obj
    elem = V.scalar_element
    bs = V.block_size
    dat = to_numpy(f.dat).reshape(-1, bs)
    if elem.family == "Lagrange":
        # vertex dofs are the first num_vertices nodes
        return dat[:mesh.num_vertices]
    # general: average adjacent-cell corner values (DG etc.)
    cnm = V.cell_node_map
    out = np.zeros((mesh.num_vertices, bs))
    cnt = np.zeros(mesh.num_vertices)
    nvert = mesh.cell.num_vertices
    # element nodes at cell vertices: nodes matching ref vertices
    ref = elem.nodes
    vslots = []
    for vi, vpos in enumerate(mesh.cell.vertices):
        hit = np.where(np.all(np.abs(ref - vpos) < 1e-12, axis=1))[0]
        vslots.append(hit[0] if len(hit) else None)
    cv = mesh.topology.cell_vertices
    for vi in range(nvert):
        slot = vslots[vi]
        if slot is None:
            continue
        np.add.at(out, cv[:, vi], dat[cnm[:, slot]])
        np.add.at(cnt, cv[:, vi], 1.0)
    cnt = np.where(cnt > 0, cnt, 1.0)
    return out / cnt[:, None]


class VTKFile:
    """Reference API: VTKFile('out.pvd'); file.write(u, time=t)."""

    def __init__(self, filename, project_output=False, **kwargs):
        assert filename.endswith(".pvd"), "use a .pvd filename"
        self.pvd_path = filename
        self.basename = filename[:-4]
        os.makedirs(os.path.dirname(os.path.abspath(filename)),
                    exist_ok=True)
        self.steps = []   # (time, vtu relative path)

    def write(self, *functions, time=None):
        idx = len(self.steps)
        vtu = f"{self.basename}_{idx}.vtu"
        self._write_vtu(vtu, functions)
        t = float(time) if time is not None else float(idx)
        self.steps.append((t, os.path.basename(vtu)))
        self._write_pvd()

    # ------------------------------------------------------------ helpers
    _QUAD_TYPE = {"triangle": 22, "tetrahedron": 24}
    # VTK quadratic node order: vertices then edge midpoints
    _QUAD_EDGES = {"triangle": [(0, 1), (1, 2), (2, 0)],
                   "tetrahedron": [(0, 1), (1, 2), (2, 0),
                                   (0, 3), (1, 3), (2, 3)]}

    def _try_write_highorder(self, path, functions):
        """Per-cell point blocks: quadratic VTK cells for degree-2
        simplex fields, arbitrary-order VTK Lagrange cells (types 68-72,
        io/vtk_lagrange.py) for everything else of degree >= 2, and
        exact (non-averaged) DG output (reference: firedrake VTK DG
        embedding + output/paraview_reordering.py).  Returns False when
        a function's space cannot be sampled this way (falls back to
        the vertex-sampled linear writer)."""
        from .vtk_lagrange import vtk_lattice, VTK_LAGRANGE_TYPE
        mesh = functions[0].function_space().mesh_obj
        cellname = mesh.cell.name
        degs = []
        for f in functions:
            V = f.function_space()
            el = V.scalar_element
            if (V.mesh_obj is not mesh
                    or getattr(el, "mapping", "identity") != "identity"
                    or el.family not in ("Lagrange",
                                         "Discontinuous Lagrange")):
                return False
            degs.append(el.degree)
        # curved meshes always take the high-order path so the geometry
        # (not just the fields) renders curved
        deg = max(degs + [getattr(mesh, "_coord_degree", 1)])
        if deg < 2:
            return False
        if deg == 2 and cellname in self._QUAD_TYPE:
            # quadratic VTK cells: vertices + VTK-ordered edge midpoints
            verts = mesh.cell.vertices
            edges = self._QUAD_EDGES[cellname]
            ref = np.vstack([verts] + [(verts[a] + verts[b]) / 2
                                       for (a, b) in edges])
            vtk_type = self._QUAD_TYPE[cellname]
        elif cellname in VTK_LAGRANGE_TYPE:
            ref = vtk_lattice(cellname, deg)
            vtk_type = VTK_LAGRANGE_TYPE[cellname]
        else:
            return False
        # physical points through the mesh coordinate element (exact
        # for affine AND bilinear/trilinear cells)
        cspace = mesh.coordinates.function_space()
        ctab = cspace.scalar_element.tabulate(ref, 0)[0]   # (nn, ndc)
        gdim = mesh.geometric_dimension
        cdofs = to_numpy(mesh.coordinates.dat)[
            cspace.cell_dof_map].reshape(mesh.num_cells, -1, gdim)
        pts = np.einsum("ni,cig->cng", ctab, cdofs)
        nc, nn = pts.shape[:2]
        pts = pts.reshape(-1, pts.shape[-1])
        if pts.shape[1] < 3:
            pts = np.hstack([pts, np.zeros((len(pts), 3 - pts.shape[1]))])
        cells = np.arange(nc * nn, dtype=np.int64).reshape(nc, nn)
        offsets = np.arange(1, nc + 1, dtype=np.int64) * nn
        types = np.full(nc, vtk_type, dtype=np.uint8)
        arrays = []
        for f in functions:
            V = f.function_space()
            tab = V.scalar_element.tabulate(ref, 0)[0]   # (nn, nd)
            bs = V.block_size
            dofs = to_numpy(f.dat)[V.cell_dof_map].reshape(nc, -1, bs)
            vals = np.einsum("ni,cik->cnk", tab, dofs).reshape(nc * nn,
                                                               bs)
            arrays.append((f.name, vals))
        self._emit_vtu(path, pts, cells, offsets, types, arrays)
        return True

    def _write_vtu(self, path, functions):
        if self._try_write_highorder(path, functions):
            return
        mesh = functions[0].function_space().mesh_obj
        pts = np.asarray(mesh._vertex_coords, dtype=np.float64)
        if pts.shape[1] < 3:
            pts = np.hstack([pts, np.zeros((len(pts), 3 - pts.shape[1]))])
        cells = np.asarray(mesh.topology.cell_vertices, dtype=np.int64)
        if mesh.cell.name in _REORDER:
            cells = cells[:, _REORDER[mesh.cell.name]]
        ncell, npc = cells.shape
        offsets = np.arange(1, ncell + 1, dtype=np.int64) * npc
        types = np.full(ncell, _VTK_TYPE[mesh.cell.name], dtype=np.uint8)
        arrays = [(f.name, _vertex_values(f)) for f in functions]
        self._emit_vtu(path, pts, cells, offsets, types, arrays)

    def _emit_vtu(self, path, pts, cells, offsets, types, arrays):
        pieces = []
        pieces.append('<?xml version="1.0"?>')
        pieces.append('<VTKFile type="UnstructuredGrid" version="0.1" '
                      'byte_order="LittleEndian">')
        pieces.append('<UnstructuredGrid>')
        pieces.append(f'<Piece NumberOfPoints="{len(pts)}" '
                      f'NumberOfCells="{len(types)}">')
        pieces.append('<Points><DataArray type="Float64" '
                      'NumberOfComponents="3" format="binary">')
        pieces.append(_b64(np.ascontiguousarray(pts, dtype=np.float64)))
        pieces.append('</DataArray></Points>')
        pieces.append('<Cells>')
        pieces.append('<DataArray type="Int64" Name="connectivity" '
                      'format="binary">')
        pieces.append(_b64(cells.reshape(-1)))
        pieces.append('</DataArray>')
        pieces.append('<DataArray type="Int64" Name="offsets" '
                      'format="binary">')
        pieces.append(_b64(offsets))
        pieces.append('</DataArray>')
        pieces.append('<DataArray type="UInt8" Name="types" '
                      'format="binary">')
        pieces.append(_b64(types))
        pieces.append('</DataArray>')
        pieces.append('</Cells>')
        pieces.append('<PointData>')
        for name, vals in arrays:
            ncomp = vals.shape[1]
            if ncomp == 2:    # pad vectors to 3 for paraview
                vals = np.hstack([vals, np.zeros((len(vals), 1))])
                ncomp = 3
            pieces.append(f'<DataArray type="Float64" Name="{name}" '
                          f'NumberOfComponents="{ncomp}" format="binary">')
            pieces.append(_b64(np.ascontiguousarray(vals,
                                                    dtype=np.float64)))
            pieces.append('</DataArray>')
        pieces.append('</PointData>')
        pieces.append('</Piece></UnstructuredGrid></VTKFile>')
        with open(path, "w") as fh:
            fh.write("\n".join(pieces))

    def _write_pvd(self):
        lines = ['<?xml version="1.0"?>',
                 '<VTKFile type="Collection" version="0.1">',
                 '<Collection>']
        for t, vtu in self.steps:
            lines.append(f'<DataSet timestep="{t}" part="0" file="{vtu}"/>')
        lines += ['</Collection>', '</VTKFile>']
        with open(self.pvd_path, "w") as fh:
            fh.write("\n".join(lines))


File = VTKFile   # legacy alias (firedrake.File)
