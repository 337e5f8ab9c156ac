"""Interpolation on the same mesh (reference: firedrake/interpolation.py:209
SameMeshInterpolator via TSFC dual evaluation).  For the Lagrange family
the dual basis is point evaluation at element nodes, so interpolation =
evaluate the expression at each cell's node points and write the node
values.  Moment spaces (RT, BDM, N1curl) contract the Piola pullback of
the expression with their quadrature-form dual basis.  Coefficients on
H(div)/H(curl) spaces are read through their dof signs or transforms.
Onto a VertexOnlyMesh, and from a Function on another mesh, interpolation
is point evaluation (vertexonly.py, pointeval.py).

Not ported yet: interpolation matrices (ROADMAP.md queue 1, item 18)."""
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


def _localize(w, st, c, cells=slice(None)):
    """Gathered canonical values (ncell, nd) of coefficient c over
    ``cells`` -> its cell-local ones (dof signs, or matrix entity
    transforms)."""
    sg = st["signs"].get(c.count)
    if sg is not None:
        return w * sg[cells]
    B = st["transforms"].get(c.count)
    if B is not None:
        return torch.einsum("cij,cj->ci", B[cells], w)
    return w


def _coeff_statics(coeffs, dev):
    """Device gather maps of the coefficients, and their sign or
    transform tables where their spaces have them."""
    return dict(
        maps={c.count: torch.as_tensor(
            c.space.cell_dof_map.astype(np.int64), device=dev)
            for c in coeffs},
        signs={c.count: torch.as_tensor(c.space.cell_dof_signs, device=dev)
               for c in coeffs if getattr(c.space, "has_dof_signs", False)},
        transforms={c.count: torch.as_tensor(c.space.cell_dof_transforms,
                                             device=dev)
                    for c in coeffs
                    if getattr(c.space, "has_dof_transforms", False)})


def _build_moment(expr: Expr, V):
    """Dual-evaluation interpolation into Piola-mapped moment spaces
    (RT/BDM/N1curl): dof_i = ell_i(Piola pullback of expr) per cell,
    contracted from the element's quadrature-form dual basis (the JAX
    package's interpolation.py _build_moment).  Each shared dof is taken
    from the last cell that holds it, as the JAX scatter does on the
    host."""
    from .compiler.smallmat import det as _sdet, inv as _sinv
    mesh = V.mesh_obj
    gdim = mesh.geometric_dimension
    elem = V.element
    dpts, dwts = elem.dual_quadrature()   # (nd, nq, tdim), (nd, nq, vd)
    nd, nq, tdim = dpts.shape
    pts = dpts.reshape(nd * nq, tdim)
    integrand = push_grad(expr)
    coeffs = _expr_coeffs(integrand)
    consts = _expr_constants(integrand)
    if any(isinstance(t, Argument) for t in integrand.traverse()):
        raise ValueError("cannot interpolate an expression with arguments")

    def kern(coords_e, ws, cvs):
        ctx = PointsContext(mesh, pts, coords_e)
        low = Lowerer(ctx, None, None,
                      {c.count: w for c, w in zip(coeffs, ws)},
                      {c.count: v for c, v in zip(consts, cvs)})
        v = low.eval(integrand, None)
        return torch.broadcast_to(v[0, 0], (len(pts),) + integrand.shape)

    coords_space = mesh.coordinates.function_space()
    cmap3 = coords_space.cell_dof_map.reshape(mesh.num_cells, -1, gdim)
    target_map = np.asarray(V.cell_dof_map, dtype=np.int64)
    src = np.empty(V.dim, dtype=np.int64)
    src[target_map.reshape(-1)] = np.arange(target_map.size)
    mapping = getattr(elem, "mapping", "identity")
    cache = {}

    def statics():
        dev = get_device()
        if cache.get("device") != dev:
            cache.clear()
            cache.update(_coeff_statics(coeffs, dev))
            cache.update(
                device=dev,
                cmap3=torch.as_tensor(cmap3.astype(np.int64), device=dev),
                dwts=torch.as_tensor(np.asarray(dwts, dtype=np.float64),
                                     device=dev),
                src=torch.as_tensor(src, device=dev))
            # canonical <- local maps of the target space
            if getattr(V, "has_dof_signs", False):
                cache["tgt_signs"] = torch.as_tensor(V.cell_dof_signs,
                                                     device=dev)
            elif getattr(V, "has_dof_transforms", False):
                cache["tgt_Binv"] = torch.as_tensor(
                    np.linalg.inv(V.cell_dof_transforms), device=dev)
        return cache

    def run(coords_dat, coeff_dats, const_vals):
        st = statics()
        ce = coords_dat[st["cmap3"]]               # (ncell, nvert, gdim)
        ws = tuple(_localize(coeff_dats[c.count][st["maps"][c.count]],
                             st, c) for c in coeffs)
        cvs = tuple(const_vals[c.count] for c in consts)
        vals = torch.func.vmap(lambda c, *w: kern(c, w, cvs))(ce, *ws)
        # vals: (ncell, nd*nq, vd) physical values; pull back to the
        # reference cell (affine cells: constant J = [v_i - v_0])
        J = torch.stack([ce[:, i + 1] - ce[:, 0] for i in range(tdim)],
                        dim=-1)                    # (ncell, gdim, tdim)
        if mapping == "contravariant":
            # u_ref = detJ * Jinv @ u_phys
            uref = _sdet(J)[:, None, None] * torch.einsum(
                "cij,cqj->cqi", _sinv(J), vals)
        elif mapping == "covariant":
            # u_ref = J^T @ u_phys
            uref = torch.einsum("cji,cqj->cqi", J, vals)
        else:
            uref = vals
        uref = uref.reshape(uref.shape[0], nd, nq, -1)
        dofs = torch.einsum("nqv,cnqv->cn", st["dwts"].to(uref.dtype),
                            uref)
        if "tgt_signs" in st:
            dofs = dofs * st["tgt_signs"]          # signs^-1 == signs
        elif "tgt_Binv" in st:
            dofs = torch.einsum("cij,cj->ci", st["tgt_Binv"], dofs)
        return dofs.reshape(-1)[st["src"]]

    return run, coeffs, consts


def _build(expr: Expr, V):
    """(run, coeffs, consts): run(coords, coeff_dats, const_vals) -> dat."""
    mesh = V.mesh_obj
    if hasattr(V.element, "dual_quadrature"):
        return _build_moment(expr, V)
    gdim = mesh.geometric_dimension
    scalar = V.scalar_element
    pts = scalar.nodes                       # (npts, tdim)
    integrand = push_grad(expr)
    coeffs = _expr_coeffs(integrand)
    consts = _expr_constants(integrand)
    if any(isinstance(t, Argument) for t in integrand.traverse()):
        raise ValueError("cannot interpolate an expression with arguments")

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
            cache.update(_coeff_statics(coeffs, dev))
            cache.update(
                device=dev,
                cmap3=torch.as_tensor(cmap3.astype(np.int64), device=dev),
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
            ws = tuple(_localize(
                coeff_dats[c.count][st["maps"][c.count][cells]], st, c,
                cells) for c in coeffs)
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


def _node_coordinates(V):
    """Physical coordinates of every global node of a Lagrange space: the
    affine map of each cell's vertices at the element's nodes, each node
    taken from the last cell that holds it (the JAX package's)."""
    mesh = V.mesh_obj
    ref = V.scalar_element.nodes
    coords = mesh._vertex_coords[mesh.topology.cell_vertices]
    v0 = coords[:, 0]
    d = mesh.cell.dim
    J = np.stack([coords[:, i + 1] - coords[:, 0] for i in range(d)],
                 axis=-1)
    phys = v0[:, None, :] + np.einsum("cgt,nt->cng", J, ref)
    out = np.zeros((V.num_nodes, mesh.geometric_dimension))
    out[V.cell_node_map.reshape(-1)] = phys.reshape(-1, phys.shape[-1])
    return out


def _cross_mesh_interpolate(f_src, f_dst):
    """Interpolate a Function from another mesh by point evaluation at the
    target's nodes (reference: interpolation.py:411 CrossMeshInterpolator
    via VertexOnlyMesh point location); nodes outside the source mesh
    get 0."""
    from .pointeval import _locate, evaluate
    V = f_dst.space
    if V.scalar_element.family not in ("Lagrange",
                                       "Discontinuous Lagrange"):
        raise NotImplementedError("cross-mesh interpolation needs a nodal "
                                  "target space")
    cells, refs = _locate(f_src.function_space().mesh_obj,
                          _node_coordinates(V))
    f_dst.dat = torch.nan_to_num(evaluate(f_src, cells, refs)).reshape(-1)
    return f_dst


def interpolate_onto(expr, f: Function):
    from .language.core import as_expr as _ae
    e0 = _ae(expr)
    if getattr(f.space.mesh_obj, "is_vertex_only", False):
        from .vertexonly import vom_interpolate
        return vom_interpolate(e0, f)
    meshes = _expr_meshes(e0)
    if meshes and id(f.space.mesh_obj) not in meshes:
        if isinstance(expr, Function):
            return _cross_mesh_interpolate(expr, f)
        raise NotImplementedError("cross-mesh interpolation of general "
                                  "expressions: wrap in a Function first")
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
