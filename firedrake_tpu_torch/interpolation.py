"""Nodal interpolation onto Lagrange spaces on the same mesh (reference:
firedrake/interpolation.py:209 SameMeshInterpolator via TSFC dual
evaluation).  For the Lagrange family the dual basis is point evaluation
at element nodes, so interpolation = evaluate the expression at each
cell's node points and write the node values.

Not ported yet: moment (Piola-mapped) targets, cross-mesh interpolation
and interpolation matrices."""
from __future__ import annotations

import numpy as np
import torch

from .language.core import Expr, Argument
from .compiler.preprocess import push_grad
from .compiler.lowering import PointsContext, Lowerer
from .function import Function
from .device import as_tensor, get_device

_interp_cache: dict = {}

#: cells per vmap evaluation: the point-wise lowering keeps ~3.4 KB of
#: intermediates per P2-tet cell, 42 GB at 12.6M cells if taken at once
CELL_CHUNK = 1 << 18


def _build(expr: Expr, V):
    """(run, coeffs, consts): run(coords, coeff_dats, const_vals) -> dat."""
    mesh = V.mesh_obj
    if hasattr(V.element, "dual_quadrature"):
        raise NotImplementedError("interpolation into moment spaces is "
                                  "not ported yet")
    gdim = mesh.geometric_dimension
    scalar = V.scalar_element
    pts = scalar.nodes                       # (npts, tdim)
    integrand = push_grad(expr)
    coeffs = _expr_coeffs(integrand)
    consts = _expr_constants(integrand)
    if any(isinstance(t, Argument) for t in integrand.traverse()):
        raise ValueError("cannot interpolate an expression with arguments")
    if any(getattr(c.space, "has_dof_signs", False)
           or getattr(c.space, "has_dof_transforms", False) for c in coeffs):
        raise NotImplementedError("interpolating Piola-mapped "
                                  "coefficients is not ported yet")

    def kern(coords_e, ws, cvs):
        ctx = PointsContext(mesh, pts, coords_e)
        low = Lowerer(ctx, None, None,
                      {c.count: w for c, w in zip(coeffs, ws)},
                      {c.count: v for c, v in zip(consts, cvs)})
        v = low.eval(integrand, None)        # (1, 1, npts') + vs
        # constant subexpressions keep a size-1 point axis: broadcast
        return torch.broadcast_to(v[0, 0], (len(pts),) + integrand.shape)

    coords_space = mesh.coordinates.function_space()
    cmap3 = coords_space.cell_dof_map.reshape(mesh.num_cells, -1, gdim)
    target_map = np.asarray(V.cell_dof_map, dtype=np.int64)
    # shared nodes are written by every adjacent cell; take each node's
    # value from its last writer (numpy assignment order), deterministic
    src = np.empty(V.dim, dtype=np.int64)
    src[target_map.reshape(-1)] = np.arange(target_map.size)
    cache = {}

    def statics():
        dev = get_device()
        if cache.get("device") != dev:
            cache.update(
                device=dev,
                cmap3=torch.as_tensor(cmap3.astype(np.int64), device=dev),
                maps={c.count: torch.as_tensor(
                    c.space.cell_dof_map.astype(np.int64), device=dev)
                    for c in coeffs},
                src=torch.as_tensor(src, device=dev))
        return cache

    def run(coords_dat, coeff_dats, const_vals):
        st = statics()
        cvs = tuple(const_vals[c.count] for c in consts)
        kb = torch.func.vmap(lambda c, *w: kern(c, w, cvs))
        vals = None
        for c0 in range(0, mesh.num_cells, CELL_CHUNK):
            cells = slice(c0, c0 + CELL_CHUNK)
            ce = coords_dat[st["cmap3"][cells]]      # (chunk, nvert, gdim)
            ws = tuple(coeff_dats[c.count][st["maps"][c.count][cells]]
                       for c in coeffs)
            v = kb(ce, *ws)
            if vals is None:
                vals = v.new_empty((mesh.num_cells,) + v.shape[1:])
            vals[cells] = v
        # vals: (ncell, npts) + value_shape; flatten components node-major
        return vals.reshape(-1)[st["src"]]

    return run, coeffs, consts


def _expr_meshes(expr):
    from .language.core import Coefficient, GeometricQuantity
    out = set()
    for t in expr.traverse():
        if isinstance(t, (Coefficient, Argument)):
            out.add(id(t.space.mesh_obj))
        elif isinstance(t, GeometricQuantity):
            out.add(id(t.mesh))
    return out


def interpolate_onto(expr, f: Function):
    from .language.core import as_expr as _ae
    e0 = _ae(expr)
    meshes = _expr_meshes(e0)
    if meshes and id(f.space.mesh_obj) not in meshes:
        raise NotImplementedError("cross-mesh interpolation is not "
                                  "ported yet")
    expr = _as_expr_checked(expr, f.space)
    V = f.space
    # constants key the cache: the built program binds the cached
    # expression's Constant objects (values are looked up by count)
    key = (expr.signature(), id(V.mesh_obj), hash(V.element),
           tuple(id(c) for c in _expr_coeffs(expr)),
           tuple(c.count for c in _expr_constants(expr)))
    if key not in _interp_cache:
        _interp_cache[key] = _build(expr, V)
    run, coeffs, consts = _interp_cache[key]
    coords_dat = V.mesh_obj.device_coordinates()
    coeff_dats = {c.count: as_tensor(c.dat) for c in coeffs}
    const_vals = {c.count: as_tensor(c.values()) for c in consts}
    f.dat = run(coords_dat, coeff_dats, const_vals)
    return f


def _expr_coeffs(expr):
    from .language.core import Coefficient
    return tuple(sorted({t.count: t for t in expr.traverse()
                         if isinstance(t, Coefficient)}.values(),
                        key=lambda c: c.count))


def _expr_constants(expr):
    from .language.core import ConstantBase
    return tuple(sorted({t.count: t for t in expr.traverse()
                         if isinstance(t, ConstantBase)}.values(),
                        key=lambda c: c.count))


def _as_expr_checked(expr, V):
    from .language.core import as_expr
    expr = as_expr(expr)
    if expr.shape != tuple(V.value_shape):
        raise ValueError(f"expression shape {expr.shape} != space value "
                         f"shape {tuple(V.value_shape)}")
    return expr


def interpolate(expr, V, **kwargs):
    """Eager interpolation returning a Function (classic Firedrake API)."""
    if isinstance(V, Function):
        return interpolate_onto(expr, V)
    f = Function(V)
    return interpolate_onto(expr, f)
