"""VTK arbitrary-order Lagrange cell lattices.

Reference: firedrake/output/paraview_reordering.py builds permutations
by calling the vtk package's vtkLagrange{Triangle,Tetra}::
BarycentricIndex / PointIndexFromIJK.  That package is not in this
image, so the conventions are implemented directly (the recursive-ring
scheme of "Modeling Arbitrary-order Lagrange Finite Elements in VTK"):

- vertices first, in the linear cell's vertex order;
- then edge interiors, edges in the linear cell's edge order, points
  ascending from the edge's first vertex;
- then face interiors (3D), faces in the linear cell's face order, each
  numbered by the recursive triangle/quad rule in the face's own frame;
- then the cell interior, recursively (the interior lattice of a
  degree-d simplex is a degree-(d-dim-1) simplex shifted inward).

Unlike the reference (which permutes the function's own dof vector),
the writer tabulates each field AT these lattice points, so only the
point ordering matters here, not a dof permutation.
"""
from __future__ import annotations

import numpy as np

# linear-cell connectivity (VTK conventions)
_TRI_EDGES = ((0, 1), (1, 2), (2, 0))
_TET_EDGES = ((0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3))
_TET_FACES = ((0, 1, 3), (1, 2, 3), (2, 0, 3), (0, 2, 1))
_QUAD_EDGES = ((0, 1), (1, 2), (3, 2), (0, 3))
_HEX_EDGES = ((0, 1), (1, 2), (3, 2), (0, 3), (4, 5), (5, 6), (7, 6),
              (4, 7), (0, 4), (1, 5), (3, 7), (2, 6))
_HEX_FACES = ((0, 4, 7, 3), (1, 2, 6, 5), (0, 1, 5, 4), (3, 7, 6, 2),
              (0, 3, 2, 1), (4, 5, 6, 7))

VTK_LAGRANGE_TYPE = {"interval": 68, "triangle": 69,
                     "quadrilateral": 70, "tetrahedron": 71,
                     "hexahedron": 72}


def _tri_bary(order):
    """Barycentric multi-indices (l0, l1, l2), sum == order, in VTK
    Lagrange-triangle order (vtkHigherOrderTriangle::BarycentricIndex:
    ring vertices, ring edges, recurse inward)."""
    out = []
    if order == 0:
        return [(0, 0, 0)]

    def ring(o, mn, mx):
        if o < 0:
            return
        if o == 0:
            out.append((mn, mn, mn))
            return
        for v in range(3):
            b = [mn, mn, mn]
            b[v] = mx
            out.append(tuple(b))
        for e, (a, bb) in enumerate(_TRI_EDGES):
            for k in range(1, o):
                b = [mn, mn, mn]
                b[a] = mx - k
                b[bb] = mn + k
                out.append(tuple(b))
        ring(o - 3, mn + 1, mx - 2)

    ring(order, 0, order)
    return out


def _tet_bary(order):
    """Barycentric multi-indices (l0..l3), sum == order, in VTK
    Lagrange-tetrahedron order (vertices, edges, faces by the triangle
    rule in the face frame, then the interior recursively)."""
    if order == 0:
        return [(0, 0, 0, 0)]
    out = []

    def block(o, mn, mx):
        if o < 0:
            return
        if o == 0:
            out.append((mn, mn, mn, mn))
            return
        for v in range(4):
            b = [mn] * 4
            b[v] = mx
            out.append(tuple(b))
        for a, bb in _TET_EDGES:
            for k in range(1, o):
                b = [mn] * 4
                b[a] = mx - k
                b[bb] = mn + k
                out.append(tuple(b))
        # face interiors: triangle rule of order o in the face frame,
        # keeping only interior lattice points (all face-barys >= 1)
        for face in _TET_FACES:
            for t in _tri_bary(o):
                if min(t) < 1:
                    continue
                b = [mn] * 4
                for fv, l in zip(face, t):
                    b[fv] = mn + l
                out.append(tuple(b))
        block(o - 4, mn + 1, mx - 3)

    block(order, 0, order)
    return out


def _quad_ij(order):
    """(i, j) lattice indices in VTK Lagrange-quadrilateral order."""
    d = order
    corners = [(0, 0), (d, 0), (d, d), (0, d)]
    out = list(corners)
    for a, b in _QUAD_EDGES:
        pa, pb = np.array(corners[a]), np.array(corners[b])
        for k in range(1, d):
            out.append(tuple(pa + (pb - pa) * k // d))
    for j in range(1, d):
        for i in range(1, d):
            out.append((i, j))
    return out


def _hex_ijk(order):
    """(i, j, k) lattice indices in VTK Lagrange-hexahedron order."""
    d = order
    corners = [(0, 0, 0), (d, 0, 0), (d, d, 0), (0, d, 0),
               (0, 0, d), (d, 0, d), (d, d, d), (0, d, d)]
    out = list(corners)
    for a, b in _HEX_EDGES:
        pa, pb = np.array(corners[a]), np.array(corners[b])
        for k in range(1, d):
            out.append(tuple(pa + (pb - pa) * k // d))
    for face in _HEX_FACES:
        p0 = np.array(corners[face[0]])
        du = (np.array(corners[face[1]]) - p0) // d
        dv = (np.array(corners[face[3]]) - p0) // d
        for v in range(1, d):
            for u in range(1, d):
                out.append(tuple(p0 + du * u + dv * v))
    for k in range(1, d):
        for j in range(1, d):
            for i in range(1, d):
                out.append((i, j, k))
    return out


def vtk_lattice(cell_name, order):
    """Reference-cell coordinates (n, tdim) in VTK Lagrange node order."""
    if cell_name == "interval":
        ts = [0.0, 1.0] + [k / order for k in range(1, order)]
        return np.array(ts)[:, None]
    if cell_name == "triangle":
        b = np.array(_tri_bary(order), dtype=float) / order
        return b[:, 1:]                       # cart = (l1, l2)
    if cell_name == "tetrahedron":
        b = np.array(_tet_bary(order), dtype=float) / order
        return b[:, 1:]
    if cell_name == "quadrilateral":
        return np.array(_quad_ij(order), dtype=float) / order
    if cell_name == "hexahedron":
        return np.array(_hex_ijk(order), dtype=float) / order
    raise NotImplementedError(f"VTK Lagrange lattice: {cell_name}")
