"""Mesh geometry: topology + coordinates (+ boundary markers).

Reference: firedrake/mesh.py:2367 MeshGeometry / :3275 Mesh factory.  The
coordinate field is a vector Lagrange Function, created lazily to break the
mesh <-> functionspace import cycle (same trick as the reference's callback
initialisation, mesh.py:3085-3226).
"""
from __future__ import annotations

import numpy as np
from functools import cached_property

from ..device import as_tensor, get_device, to_numpy
from .topology import MeshTopology, _IDX


class Mesh:
    """A mesh: topology plus vertex coordinates plus facet markers."""

    def __init__(self, topology: MeshTopology, vertex_coords: np.ndarray,
                 facet_markers: np.ndarray | None = None, name: str = "mesh",
                 cell_coords: np.ndarray | None = None):
        self.topology = topology
        self._vertex_coords = np.asarray(vertex_coords, dtype=np.float64)
        if cell_coords is not None:
            # discontinuous (per-cell, unwrapped) charts — periodic
            # meshes: vertex coords are wrapped representatives, so all
            # geometry (incl. orientation forcing below) must use these
            self._cell_coords = np.asarray(cell_coords, dtype=np.float64)
            self._coord_family = "DG"
        self._fix_simplex_orientation()
        self.name = name
        self.geometric_dimension = self._vertex_coords.shape[1]
        nf = len(topology.facet_cells)
        if facet_markers is None:
            facet_markers = np.zeros(nf, dtype=_IDX)
        self.facet_markers = np.asarray(facet_markers, dtype=_IDX)
        #: per-cell subdomain ids (0 = unmarked); drives dx(id) integrals
        self.cell_markers = np.zeros(topology.num_cells, dtype=_IDX)
        self.comm = None   # single-process host; device mesh handled in parallel/

    def _fix_simplex_orientation(self):
        """Reorder simplex cell vertices so every cell is positively
        oriented (detJ > 0) — required for consistent Piola signs and
        outward facet normals (the reference gets this from plex
        orientations; dmcommon.pyx:2612 renumbering)."""
        topo = self.topology
        if topo.cell.name not in ("interval", "triangle", "tetrahedron"):
            return
        d = topo.dim
        if self._vertex_coords.shape[1] != d:
            return   # manifold meshes keep their given orientation
        cv = topo.cell_vertices
        cc = getattr(self, "_cell_coords", None)
        # periodic meshes: orientation must come from the UNWRAPPED
        # per-cell charts — the wrapped vertex chart makes seam cells
        # look inverted (caught by the periodic-advection constant-
        # preservation check, round 5)
        pts = cc if cc is not None else self._vertex_coords[cv]
        E = pts[:, 1:, :] - pts[:, :1, :]              # (nc, d, d)
        det = np.linalg.det(E)
        neg = det < 0
        if neg.any():
            cv = cv.copy()
            # swap the last two vertices of negative cells
            cv[neg, -1], cv[neg, -2] = (cv[neg, -2].copy(),
                                        cv[neg, -1].copy())
            topo.cell_vertices = cv
            if cc is not None:
                cc = cc.copy()
                cc[neg, -1], cc[neg, -2] = (cc[neg, -2].copy(),
                                            cc[neg, -1].copy())
                self._cell_coords = cc
            # invalidate any cached connectivity
            for attr in ("_entity_data", "_facet_data", "facet_cells",
                         "facet_local_id", "exterior_facets",
                         "interior_facets", "facet_vertices"):
                topo.__dict__.pop(attr, None)

    # ------------------------------------------------------- delegation
    @property
    def cell(self):
        return self.topology.cell

    @property
    def num_cells(self):
        return self.topology.num_cells

    @property
    def num_vertices(self):
        return self.topology.num_vertices

    @property
    def topological_dimension(self):
        return self.topology.dim

    def ufl_cell(self):
        return self.cell

    # ------------------------------------------------------- coordinates
    #: family of the coordinate element ("Lagrange", or "DG" for periodic
    #: meshes whose coordinates must be discontinuous across the seam —
    #: same trick as the reference's periodic DG coordinates)
    _coord_family = "Lagrange"
    #: degree of the coordinate element (>1 = curved cells; every
    #: downstream geometry quantity — J, detJ, normals, facet measures —
    #: is evaluated per quadrature point through this element)
    _coord_degree = 1
    #: the coordinates Function after an assignment whose host mirror
    #: (_vertex_coords, _cell_coords) is not rebuilt yet
    _pending_coords = None
    #: bumped by every assignment to ``coordinates.dat``; keys the
    #: device copy of device_coordinates()
    _coord_version = 0

    # Host geometry.  After ``mesh.coordinates.dat = value`` both are
    # rebuilt from the value on their first read, with one host copy.
    @property
    def _vertex_coords(self):
        if self._pending_coords is not None:
            self._pull_coords()
        return self._vc

    @_vertex_coords.setter
    def _vertex_coords(self, value):
        self._vc = value

    @property
    def _cell_coords(self):
        """Per-cell vertex coordinates of DG-coordinate (periodic) meshes;
        None on meshes with continuous coordinates."""
        if self._pending_coords is not None:
            self._pull_coords()
        return self.__dict__.get("_cc")

    @_cell_coords.setter
    def _cell_coords(self, value):
        self._cc = value

    @cached_property
    def coordinates(self):
        """Vector P1/Q1 (or DG1) Function holding coordinates.

        Assigning ``mesh.coordinates.dat = ...`` (mesh movement — the
        reference's ``mesh.coordinates.assign`` idiom) takes a numpy array
        or a tensor on any device.  It marks the host geometry stale: the
        vertex and cell coordinates and the cell volumes are rebuilt from
        the new value on their first host read, so supermeshing, point
        location, refinement and cell volumes see the moved mesh.  The
        assemblers read ``device_coordinates()``, copied to the device
        once per assignment.  Changes made in place to the dat, without an
        assignment, are seen by neither."""
        from ..functionspace import VectorFunctionSpace
        from ..function import Function

        mesh = self

        class _MeshCoordinates(Function):
            @property
            def dat(self):
                return self._dat

            @dat.setter
            def dat(self, value):
                self._dat = value
                if getattr(self, "_sync_mesh", None) is not None:
                    mesh._coords_assigned(self)

        V = VectorFunctionSpace(self, self._coord_family,
                                self._coord_degree,
                                dim=self.geometric_dimension)
        f = _MeshCoordinates(V, name=f"{self.name}_coordinates")
        if self._coord_family == "Lagrange":
            # P1 numbering: dof g = vertex id
            f._dat = np.asarray(self._vertex_coords).reshape(-1)
        else:
            # DG1: per-cell vertex coords, possibly unwrapped (periodic)
            cellcoords = getattr(self, "_cell_coords", None)
            if cellcoords is None:
                cellcoords = self._vertex_coords[
                    self.topology.cell_vertices]
            dat = np.zeros(V.dim)
            dat[V.cell_dof_map.reshape(-1)] = cellcoords.reshape(-1)
            f._dat = dat
        f._sync_mesh = True
        return f

    def _coords_assigned(self, f):
        """Mark the host geometry and the device copy stale after an
        assignment to the coordinates Function ``f``."""
        self._pending_coords = f
        self._coord_version += 1
        self.__dict__.pop("cell_volumes", None)

    def device_coordinates(self):
        """The coordinates Function's dat as a tensor on the set device,
        copied there once per assignment (and per device)."""
        key = (self._coord_version, get_device())
        hit = self.__dict__.get("_dev_coords")
        if hit is None or hit[0] != key:
            hit = (key, as_tensor(self.coordinates.dat))
            self._dev_coords = hit
        return hit[1]

    def _pull_coords(self):
        """Rebuild the host geometry from the assigned coordinates."""
        f, self._pending_coords = self._pending_coords, None
        dat = np.asarray(to_numpy(f.dat), dtype=np.float64)
        g = self.geometric_dimension
        if self._coord_family == "Lagrange":
            self._vertex_coords = dat.reshape(-1, g).copy()
        else:
            # DG1 (periodic seams): per-cell coords are authoritative;
            # vertex positions take each vertex's first occurrence
            cc = dat[f.space.cell_dof_map.reshape(-1)].reshape(
                self.topology.cell_vertices.shape + (g,))
            self._cell_coords = cc
            vc = np.array(self._vertex_coords, copy=True)
            cv = self.topology.cell_vertices.reshape(-1)
            vc[cv[::-1]] = cc.reshape(-1, g)[::-1]
            self._vertex_coords = vc
        self.__dict__.pop("cell_volumes", None)

    @cached_property
    def coordinate_space(self):
        return self.coordinates.function_space()

    # ------------------------------------------------------------ facets
    def boundary_facets(self, subdomain) -> np.ndarray:
        """Exterior facet ids for a marker spec: int id, tuple of ids,
        'on_boundary'/'everywhere', or 'bottom'/'top'/'sides' on extruded
        meshes (reference: extruded iteration regions ON_BOTTOM/ON_TOP,
        pyop2/global_kernel.py:267-276)."""
        ext = self.topology.exterior_facets
        if subdomain in ("on_boundary", "everywhere", None):
            return ext
        if subdomain in ("bottom", "top", "sides"):
            assert getattr(self, "_extruded", False), \
                f"{subdomain!r} needs an extruded mesh"
            if getattr(self, "_var_layers", None) is not None:
                # variable layers: classify per COLUMN (the reference's
                # ON_TOP/ON_BOTTOM iteration regions follow each
                # column's own extent, extrusion_numbering.pyx:222) —
                # horizontal facets at the owning cell's bottom/top
                # layer, including steps exposed by shorter neighbours
                z = self._vertex_coords[:, -1]
                h = self._layer_height
                fv = self.topology.facet_vertices[ext]
                mask_ok = fv >= 0
                fz = np.where(mask_ok, z[np.where(fv < 0, 0, fv)],
                              np.nan)
                tol = 1e-12 * max(abs(z).max(), 1.0)
                horiz = (np.nanmax(fz, axis=1)
                         - np.nanmin(fz, axis=1)) < tol
                cells = self.topology.facet_cells[ext, 0]
                lay = self._cell_layer[cells]
                zf = np.nanmean(fz, axis=1)
                on_bot = horiz & (np.abs(zf - lay * h) < tol + h * 1e-9)
                on_top = horiz & (np.abs(zf - (lay + 1) * h)
                                  < tol + h * 1e-9)
                if subdomain == "bottom":
                    return ext[on_bot]
                if subdomain == "top":
                    return ext[on_top]
                return ext[~(on_bot | on_top)]
            z = self._vertex_coords[:, -1]
            zmin, zmax = z.min(), z.max()
            fv = self.topology.facet_vertices[ext]
            mask_ok = fv >= 0
            fz = np.where(mask_ok, z[np.where(fv < 0, 0, fv)], np.nan)
            tol = 1e-12 * max(abs(zmax), 1.0)
            on_bot = np.nanmax(np.abs(fz - zmin), axis=1) < tol
            on_top = np.nanmax(np.abs(fz - zmax), axis=1) < tol
            if subdomain == "bottom":
                return ext[on_bot]
            if subdomain == "top":
                return ext[on_top]
            return ext[~(on_bot | on_top)]
        if isinstance(subdomain, (int, np.integer)):
            subdomain = (int(subdomain),)
        mask = np.isin(self.facet_markers[ext], np.asarray(subdomain))
        return ext[mask]

    def marked_exterior_subset(self, subdomain_id):
        return self.boundary_facets(subdomain_id)

    def cell_subset(self, subdomain) -> np.ndarray:
        """Cell ids for a dx subdomain id spec."""
        if subdomain in ("everywhere", None):
            return np.arange(self.num_cells)
        if isinstance(subdomain, (int, np.integer)):
            subdomain = (int(subdomain),)
        return np.nonzero(np.isin(self.cell_markers,
                                  np.asarray(subdomain)))[0]

    def mark_facets(self, marker_fn_or_array):
        """Set facet subdomain ids from an array over facets or a
        midpoint predicate fn(midpoint)->id (for ds(id)/dS(id);
        reference reads these from gmsh physical groups)."""
        if callable(marker_fn_or_array):
            fv = self.topology.facet_vertices
            mids = self._vertex_coords[fv].mean(axis=1)
            self.facet_markers = np.array(
                [int(marker_fn_or_array(m)) for m in mids], dtype=_IDX)
        else:
            self.facet_markers = np.asarray(marker_fn_or_array,
                                            dtype=_IDX)
        return self

    def refine_marked_elements(self, markers):
        """Conforming NVB refinement of the marked cells (reference:
        netgen's Mesh.refine_marked_elements); see adapt.py."""
        from ..adapt import refine_marked
        return refine_marked(self, markers)

    def mark_cells(self, marker_fn_or_array):
        """Set cell subdomain ids from an array or a centroid predicate
        fn(centroid)->id (host-side utility; reference reads these from
        gmsh physical groups)."""
        if callable(marker_fn_or_array):
            cents = self._vertex_coords[
                self.topology.cell_vertices].mean(axis=1)
            self.cell_markers = np.array(
                [int(marker_fn_or_array(c)) for c in cents], dtype=_IDX)
        else:
            self.cell_markers = np.asarray(marker_fn_or_array, dtype=_IDX)
        return self

    @cached_property
    def cell_volumes(self) -> np.ndarray:
        """Host-side cell volumes (affine cells exactly; TP cells by quad)."""
        from ..elements import make_quadrature, Lagrange
        coords = self._vertex_coords[self.topology.cell_vertices]
        cell = self.cell
        e1 = Lagrange(cell.name, 1)
        q = make_quadrature(cell.name, 2)
        grads = e1.tabulate(q.points, 1)[1]         # (nq, nv, dim)
        # J[q] = coords^T @ grad
        J = np.einsum("cvg,qvd->cqgd", coords, grads)
        if self.geometric_dimension == self.topological_dimension:
            detJ = np.abs(np.linalg.det(J))
        else:
            G = np.einsum("cqgd,cqge->cqde", J, J)
            detJ = np.sqrt(np.abs(np.linalg.det(G)))
        return np.einsum("cq,q->c", detJ, q.weights)

    def __repr__(self):
        return (f"Mesh({self.name!r}, {self.cell.name}, "
                f"{self.num_cells} cells, {self.num_vertices} vertices)")


def make_mesh_from_coordinates(coord_fn, name=None):
    """Curved (higher-order geometry) mesh from a vector Lagrange/DG
    coordinate Function — the reference's ``Mesh(coordinates)`` factory
    path (firedrake/mesh.py:3275 -> make_mesh_from_coordinates
    mesh.py:3085).

    The new mesh SHARES topology with the coordinate function's mesh;
    the coordinate Function is re-homed onto it (the global numbering is
    a pure function of topology + element, so the dof vector transfers
    verbatim).  Every downstream geometry quantity (J, detJ, normals,
    facet measures, CellVolume) is evaluated per quadrature point
    through the coordinate element, so any degree works; quadrature
    degrees are bumped for the non-affine detJ (compiler/kernels.py).
    """
    from ..functionspace import VectorFunctionSpace
    from ..function import Function
    from ..elements.finite_element import VectorElement

    V = coord_fn.function_space()
    elem = V.element
    if not isinstance(elem, VectorElement):
        raise TypeError("coordinates must live in a VectorFunctionSpace")
    old = V.mesh()
    gdim = elem.ncomp
    fam = elem.sub.family
    fam = "DG" if "Discontinuous" in fam else "Lagrange"
    degree = elem.sub.degree
    nodes = np.array(to_numpy(coord_fn.dat),
                     dtype=np.float64).reshape(-1, gdim)
    m = Mesh(old.topology, np.asarray(old._vertex_coords),
             np.asarray(old.facet_markers),
             name=name or f"{old.name}_curved")
    m.cell_markers = np.asarray(old.cell_markers).copy()
    m._coord_family = fam
    m._coord_degree = degree
    Vnew = VectorFunctionSpace(m, fam, degree, dim=gdim)
    # the donor numbering may differ (structured meshes grid-renumber
    # their dofs, functionspace.py _maybe_grid_renumber); the local cell
    # orderings are identical (shared topology + identical element), so
    # the scalar cell-node maps define the node permutation
    old_map = np.asarray(V.sdata.cell_node_map).ravel()
    new_map = np.asarray(Vnew.sdata.cell_node_map).ravel()
    perm = np.empty(Vnew.sdata.num_nodes, dtype=np.int64)
    perm[new_map] = old_map
    new_nodes = nodes[perm]
    g = Function(Vnew, name=f"{m.name}_coordinates")
    g.dat = new_nodes.reshape(-1)
    if fam == "Lagrange":
        # in the (unrenumbered) new numbering vertex dofs come first and
        # are numbered by vertex id, so the P1 proxy (markers, point
        # location, plotting) is the vertex sub-lattice
        m._vertex_coords = np.ascontiguousarray(
            new_nodes[:old.num_vertices])
    m.__dict__["coordinates"] = g
    # NOTE: donor fast-path metadata (_structured, _extruded) is
    # intentionally NOT copied — those paths assume affine P1/Q1
    # coordinates; a curved mesh must take the generic gather path.
    # Validate the curved map: _fix_simplex_orientation only saw the
    # donor's straight-edge vertices, so a coordinate Function folding a
    # cell over (detJ <= 0 somewhere) would otherwise yield silently
    # wrong signed measures and normals.
    _validate_positive_jacobian(m, Vnew, new_nodes)
    return m


def _validate_positive_jacobian(mesh, Vcoord, nodes):
    """Raise if det(J) of the coordinate map is non-positive at any
    quadrature point of any cell (gdim == tdim meshes only; manifold
    meshes keep their given orientation, as in _fix_simplex_orientation)."""
    tdim = mesh.topology.dim
    gdim = nodes.shape[1]
    if gdim != tdim:
        return
    from ..elements.quadrature import make_quadrature
    elem = Vcoord.scalar_element
    q = make_quadrature(mesh.cell.name, max(2, 2 * elem.degree))
    t1 = np.asarray(elem.tabulate(np.asarray(q.points), 1)[1])
    # (nq, ndofc, tdim); cell coords (ncell, ndofc, gdim)
    cdofs = nodes[np.asarray(Vcoord.cell_node_map)]
    J = np.einsum("cjg,qjt->cqgt", cdofs, t1)
    det = np.linalg.det(J)
    if det.min() <= 0.0:
        bad = int(np.argwhere(det.min(axis=1) <= 0.0)[0, 0])
        raise ValueError(
            f"coordinate field is not orientation-preserving: det(J) = "
            f"{det.min():.3e} <= 0 in cell {bad}; curved meshes require "
            "an everywhere-positive Jacobian")
