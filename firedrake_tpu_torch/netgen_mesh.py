"""Netgen/NGSolve mesh import (reference: firedrake/netgen.py:188
FiredrakeMesh — builds a Firedrake mesh from a netgen mesh via DMPlex;
here the conversion targets our numpy topology directly).

The netgen package is not bundled; the converter duck-types netgen's
documented surface (``ngmesh.Coordinates()``, ``Elements2D()`` /
``Elements3D()`` with 1-based ``vertices`` PointIds and region
``index``, ``Elements1D()`` boundary segments), so any object exposing
it — including netgen.meshing.Mesh when installed — imports the same
way.  Region indices land in ``cell_markers`` (usable as ``dx(i)``);
boundary element indices become facet markers (``ds(i)``)."""
from __future__ import annotations

import numpy as np

__all__ = ["mesh_from_netgen"]


def _vertex_ids(el):
    """1-based netgen PointIds -> 0-based numpy ids."""
    return [int(getattr(v, "nr", v)) - 1 for v in el.vertices]


def mesh_from_netgen(ngmesh, name="netgenmesh"):
    """Build a Mesh from a netgen mesh object (or any object with the
    same surface).  Triangles (2D) and tetrahedra (3D)."""
    from .mesh.topology import MeshTopology
    from .mesh.geometry import Mesh as _Mesh
    from .mesh.io_msh import facet_markers_of

    coords = np.asarray(ngmesh.Coordinates(), dtype=float)
    dim = int(getattr(ngmesh, "dim", coords.shape[1]))
    if dim == 2:
        els = list(ngmesh.Elements2D())
        belts = list(getattr(ngmesh, "Elements1D", lambda: [])())
        cellname, nv, bnv = "triangle", 3, 2
        coords = coords[:, :2]
    elif dim == 3:
        els = list(ngmesh.Elements3D())
        belts = list(getattr(ngmesh, "Elements2D", lambda: [])())
        cellname, nv, bnv = "tetrahedron", 4, 3
    else:
        raise NotImplementedError(f"netgen mesh dim {dim}")
    cells = np.array([_vertex_ids(el) for el in els], dtype=np.int32)
    if cells.shape[1] != nv:
        raise NotImplementedError(
            f"netgen {cellname} mesh has {cells.shape[1]}-vertex cells "
            "(only simplicial netgen meshes are supported)")
    topo = MeshTopology(cells, len(coords), cellname, name)
    mesh = _Mesh(topo, coords, name=name)

    # cell region markers (netgen material/region index, 1-based)
    regions = np.array([int(getattr(el, "index", 1)) for el in els])
    if len(np.unique(regions)) > 1 or (regions != 1).any():
        mesh.cell_markers = regions

    # boundary facet markers from the boundary elements with a facet's
    # vertex count, matched by vertex set
    belts = [(_vertex_ids(b), int(getattr(b, "index", 1))) for b in belts]
    belts = [(v, i) for v, i in belts if len(v) == bnv]
    if belts:
        rows = np.array([v for v, _ in belts], dtype=np.int64)
        tags = np.array([i for _, i in belts], dtype=np.int64)
        fmark = facet_markers_of(mesh.topology, [(rows, tags)])
        if fmark.any():
            mesh.mark_facets(fmark.astype(np.int64))
    return mesh
