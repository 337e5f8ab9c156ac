"""VertexOnlyMesh: a 0-dimensional mesh of points immersed in a parent
mesh — the data-assimilation / point-observation primitive.

Reference: firedrake/mesh.py:2912 VertexOnlyMesh (swarm-based: PETSc
DMSwarm + parallel point location), interpolation onto its P0DG space
(firedrake/interpolation.py cross-mesh path) and
``vertex_only_mesh.input_ordering`` for restoring the caller's point
ordering.

Point location runs once at construction (pointeval.py: the host's k-d
tree, the device's inversion); the located cells stay a host array and
their reference coordinates a device tensor, so interpolation from the
parent mesh is a gather and a small contraction per point on the device.
Cells ARE vertices: every function space on the mesh is P0 per point, and
an integral over it sums its integrand over the points.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .elements.reference_cell import by_name
from .device import as_tensor, get_device


class VertexOnlyMesh:
    is_vertex_only = True

    def __init__(self, parent, vertexcoords,
                 missing_points_behaviour="error", tolerance=1e-10,
                 name=None):
        from .pointeval import _locate, PointNotInDomainError
        pts = np.atleast_2d(np.asarray(vertexcoords, dtype=float))
        cells, refs = _locate(parent, pts, tol=tolerance)
        missing = cells < 0
        if missing.any():
            if missing_points_behaviour == "error":
                raise PointNotInDomainError(
                    f"points not in the parent mesh: {pts[missing]}")
            if missing_points_behaviour == "warn":
                warnings.warn(f"{int(missing.sum())} point(s) not in the "
                              "parent mesh; dropped")
        keep = ~missing
        self.parent = parent
        self.input_coords = pts
        self.input_found = keep             # mask into the input ordering
        self._pts = pts[keep]
        self.cells = cells[keep]            # parent cell per vertex
        self.refs = refs[torch.as_tensor(keep, device=refs.device)]
        self._init_common(name or "vertexonlymesh")

    def _init_common(self, name):
        self.cell = by_name("vertex")
        self.num_cells = len(self._pts)
        self.num_vertices = self.num_cells
        self.geometric_dimension = self.parent.geometric_dimension
        self.topological_dimension = 0
        self.name = name
        self._coordinates = None
        self._input_ordering = None

    def mesh(self):
        return self

    @property
    def coordinates(self):
        if self._coordinates is None:
            from .functionspace import VectorFunctionSpace
            from .function import Function
            V = VectorFunctionSpace(self, "DG", 0,
                                    dim=self.geometric_dimension)
            f = Function(V, name="coordinates")
            f.dat = self._pts.reshape(-1)
            self._coordinates = f
        return self._coordinates

    @property
    def input_ordering(self):
        """A VertexOnlyMesh over ALL input points in their original order
        (reference: mesh.py VertexOnlyMeshTopology.input_ordering).
        Interpolating a found-point Function onto it restores the
        caller's ordering, NaN where a point was not found."""
        if self._input_ordering is None:
            vm = object.__new__(VertexOnlyMesh)
            vm.parent = self.parent
            vm.input_coords = self.input_coords
            vm.input_found = np.ones(len(self.input_coords), dtype=bool)
            vm._pts = self.input_coords
            full_cells = np.full(len(self.input_coords), -1, np.int64)
            full_cells[self.input_found] = self.cells
            vm.cells = full_cells
            refs = self.refs.new_zeros((len(self.input_coords),
                                        self.refs.shape[1]))
            refs[torch.as_tensor(self.input_found,
                                 device=refs.device)] = self.refs
            vm.refs = refs
            vm._init_common(self.name + "_input_ordering")
            vm._input_ordering = vm
            vm._source_vom = self           # index mapping for transfers
            self._input_ordering = vm
        return self._input_ordering

    def __repr__(self):
        return f"VertexOnlyMesh({self.num_cells} vertices)"


# ----------------------------------------------- point-wise device evaluator
def _vom_eval(e, vom):
    """Evaluate a (restricted) expression at the mesh's vertices: a
    (npts,) + e.shape tensor on the set device."""
    from .language.core import (Sum, Product, Division, Power, Zero,
                                ScalarValue, ConstantBase,
                                SpatialCoordinate, MathFunction, Indexed,
                                Abs, MinMax)
    from .language.tensor_algebra import Inner, Dot, ListTensor
    from .function import Function
    npts = vom.num_cells
    dev = get_device()
    f64 = dict(dtype=torch.float64, device=dev)
    if isinstance(e, Zero):
        return torch.zeros((npts,) + e.shape, **f64)
    if isinstance(e, ScalarValue):
        return torch.full((npts,), float(e.value), **f64)
    if isinstance(e, ConstantBase):
        v = as_tensor(np.asarray(e.values()).reshape(e.shape))
        return v.expand((npts,) + e.shape).clone()
    if isinstance(e, SpatialCoordinate):
        return as_tensor(vom._pts)
    if isinstance(e, Function):
        V = e.function_space()
        m = V.mesh_obj
        if m is vom:
            d = as_tensor(e.dat)
            return d.reshape((npts,) + e.shape) if V.block_size > 1 \
                else d.clone()
        if getattr(m, "is_vertex_only", False):
            return _vom_to_vom(e, vom)
        from .pointeval import evaluate
        return evaluate(e, vom.cells, vom.refs)
    if isinstance(e, Sum):
        return _vom_eval(e.operands[0], vom) + _vom_eval(e.operands[1], vom)
    if isinstance(e, Product):
        a, b = (_vom_eval(o, vom) for o in e.operands)
        sa, sb = e.operands[0].shape, e.operands[1].shape
        if sa == () and sb != ():
            a = a.reshape((npts,) + (1,) * len(sb))
        if sb == () and sa != ():
            b = b.reshape((npts,) + (1,) * len(sa))
        return a * b
    if isinstance(e, Division):
        return _vom_eval(e.operands[0], vom) / _vom_eval(e.operands[1], vom)
    if isinstance(e, Power):
        return _vom_eval(e.operands[0], vom) \
            ** _vom_eval(e.operands[1], vom)
    if isinstance(e, (Inner, Dot)):
        a, b = (_vom_eval(o, vom) for o in e.operands)
        return torch.einsum("p...,p...->p", a, b) if isinstance(e, Inner) \
            else torch.einsum("p...i,pi->p...", a, b)
    if isinstance(e, MathFunction):
        fn = {"ln": torch.log}.get(e.fname, getattr(torch, e.fname, None))
        if fn is None:
            raise NotImplementedError(f"math function {e.fname!r} at "
                                      "vertices")
        return fn(_vom_eval(e.operands[0], vom))
    if isinstance(e, Abs):
        return torch.abs(_vom_eval(e.operands[0], vom))
    if isinstance(e, MinMax):
        fn = torch.minimum if e.which == "min" else torch.maximum
        return fn(_vom_eval(e.operands[0], vom),
                  _vom_eval(e.operands[1], vom))
    if isinstance(e, Indexed):
        v = _vom_eval(e.operands[0], vom)
        idx = tuple(int(i) for i in e.indices)
        return v[(slice(None),) + idx]
    if isinstance(e, ListTensor):
        return torch.stack([_vom_eval(o, vom) for o in e.operands], dim=-1)
    raise NotImplementedError(
        f"{type(e).__name__} in a VertexOnlyMesh expression")


def _vom_to_vom(src, dst_vom):
    """Transfer between a found-point VOM and its input_ordering twin."""
    src_vom = src.function_space().mesh_obj
    bs = src.function_space().block_size
    sdat = as_tensor(src.dat).reshape(src_vom.num_cells, bs)
    out = torch.full((dst_vom.num_cells, bs), float("nan"),
                     dtype=sdat.dtype, device=sdat.device)
    if getattr(dst_vom, "_source_vom", None) is src_vom:
        # found -> input order
        out[torch.as_tensor(src_vom.input_found, device=out.device)] = sdat
    elif getattr(src_vom, "_source_vom", None) is dst_vom:
        # input order -> found
        out = sdat[torch.as_tensor(dst_vom.input_found, device=out.device)]
    elif src_vom is dst_vom:
        out = sdat
    else:
        # unrelated vertex meshes: match points by coordinates
        # (reference: VomOntoVomInterpolator's SF permutation — here a
        # host KD-tree lookup; unmatched destination points get NaN)
        from scipy.spatial import cKDTree
        tree = cKDTree(src_vom._pts)
        d, idx = tree.query(dst_vom._pts)
        ok = np.flatnonzero(d < 1e-12)
        out[torch.as_tensor(ok, device=out.device)] = sdat[
            torch.as_tensor(idx[ok], device=out.device)]
    return out.reshape((dst_vom.num_cells,) + src.shape)


def vom_interpolate(expr, f):
    """interpolate(expr, V) where V lives on a VertexOnlyMesh."""
    vom = f.function_space().mesh_obj
    f.dat = _vom_eval(expr, vom).reshape(-1)
    return f


def vom_assemble(form):
    """Integrals over a VertexOnlyMesh: the vertex quadrature is a unit
    weight at each point (reference: P0DG integral over a swarm)."""
    from .language.core import Argument, ScalarValue
    from .language.calculus import map_expr
    from .function import Cofunction
    out0 = 0.0
    out1 = None
    for it in form.integrals():
        if it.integral_type != "cell":
            raise NotImplementedError("only dx on a VertexOnlyMesh")
        vom = form.mesh()
        args = [t for t in it.integrand.traverse()
                if isinstance(t, Argument)]
        if not args:
            out0 += float(torch.sum(_vom_eval(it.integrand, vom)))
        else:
            (test,) = args
            # P0 test basis is the indicator of each vertex: the rank-1
            # local value is the integrand with the test replaced by 1
            integrand = map_expr(it.integrand, {test: ScalarValue(1.0)})
            vals = _vom_eval(integrand, vom).reshape(-1)
            if out1 is None:
                out1 = Cofunction(test.space)
            out1.dat = out1.dat + vals
    return out1 if out1 is not None else out0
