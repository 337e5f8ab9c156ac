"""Interpolation on the same mesh (reference: firedrake/interpolation.py:209
SameMeshInterpolator via TSFC dual evaluation).  For the Lagrange family
the dual basis is point evaluation at element nodes, so interpolation =
evaluate the expression at each cell's node points and write the node
values.  Moment spaces (RT, BDM, N1curl) contract the Piola pullback of
the expression with their quadrature-form dual basis.  Coefficients on
H(div)/H(curl) spaces are read through their dof signs or transforms.
Onto a VertexOnlyMesh, and from a Function on another mesh, interpolation
is point evaluation (vertexonly.py, pointeval.py).

Interpolation as a linear operator: ``operator_matrix`` (the discrete
exterior derivatives of HiptmairPC), ``cross_mesh_scalar_matrix``
(NonNestedHierarchy transfers) and ``Interpolator.assemble`` (same-mesh,
cross-mesh and VertexOnlyMesh targets).  The sparsity is built on the
host as in the JAX package; the values are computed and summed on the
device, each entry's contributions in a fixed order (the gather route's
accumulation plan), and ``Matrix.transpose`` gives the adjoint as a
matrix of its own, so that restriction sums in a fixed order too."""
from __future__ import annotations

import numpy as np
import torch

from .language.core import Expr, Argument
from .compiler.preprocess import push_grad
from .compiler.lowering import PointsContext, Lowerer
from .function import Function
from .device import as_tensor, get_device, to_numpy

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


# ------------------------------------------------- interpolation operators
def _vmapped_cells(kern, ce):
    """kern vmapped over the cells of ce (ncell, nvert, gdim), CELL_CHUNK
    cells at a time."""
    kb = torch.func.vmap(kern)
    out = None
    for c0 in range(0, ce.shape[0], CELL_CHUNK):
        v = kb(ce[c0:c0 + CELL_CHUNK])
        if out is None:
            out = v.new_empty((ce.shape[0],) + v.shape[1:])
        out[c0:c0 + CELL_CHUNK] = v
    return out


def operator_matrix(expr: Expr, V):
    """Sparse matrix of the linear interpolation operator u -> I_V(expr(u)),
    where ``expr`` holds exactly one Argument (the source trial) and V is
    a moment (dual-quadrature) space: the discrete gradient G: CG_k ->
    N1curl_k with expr = grad(TrialFunction(CG)), the exterior derivative
    HiptmairPC needs (reference: hiptmair.py:204 interpolate(dminus(trial),
    V); the JAX package's interpolation.operator_matrix).

    Per cell, on the device: the expression lowered at the target's dual
    points with the trial axis kept (all cells in one vmapped batch),
    pulled back by the target's Piola map and contracted with the dual
    weights into a local (n_target, n_source) matrix; rows converted to
    the target's canonical dofs, columns from the source's; a shared
    target dof is the average over the cells that hold it."""
    from .compiler.smallmat import det as _sdet, inv as _sinv
    from .assembly.matrix import entry_matrix
    from .language.core import Coefficient, ConstantBase

    args = {t for t in expr.traverse() if isinstance(t, Argument)}
    if len(args) != 1:
        raise ValueError("operator_matrix needs exactly one Argument")
    if any(isinstance(t, (Coefficient, ConstantBase))
           for t in expr.traverse()):
        raise NotImplementedError("operator_matrix with coefficients")
    (arg,) = args
    Vs = arg.function_space()
    mesh = V.mesh_obj
    assert Vs.mesh_obj is mesh
    gdim = mesh.geometric_dimension
    elem = V.element
    dpts, dwts = elem.dual_quadrature()    # (nd, nq, tdim), (nd, nq, vd)
    nd, nq, tdim = dpts.shape
    pts = dpts.reshape(nd * nq, tdim)
    integrand = push_grad(expr)
    if Vs.block_size != 1:
        raise NotImplementedError("operator_matrix vector sources")
    nj = Vs.element.ndof
    mapping = getattr(elem, "mapping", "identity")

    def kern(coords_e):
        ctx = PointsContext(mesh, pts, coords_e)
        low = Lowerer(ctx, None, arg, {}, {})
        v = low.eval(integrand, None)      # (1, nj, nd*nq) + shape
        v = torch.broadcast_to(v, (1, nj, len(pts)) + integrand.shape)[0]
        return v.reshape((nj, len(pts), -1))   # (nj, nd*nq, vd)

    dev = get_device()
    cmap3 = mesh.coordinates.function_space().cell_dof_map.reshape(
        mesh.num_cells, -1, gdim)
    ce = mesh.device_coordinates()[torch.as_tensor(
        cmap3.astype(np.int64), device=dev)]     # (ncell, nvert, gdim)
    vals = _vmapped_cells(kern, ce)              # (nc, nj, nd*nq, vd)
    # pull the physical values back to the target's reference cell
    # (affine cells: constant J = [v_i - v_0])
    J = torch.stack([ce[:, i + 1] - ce[:, 0] for i in range(tdim)],
                    dim=-1)                      # (nc, gdim, tdim)
    if mapping == "contravariant":
        uref = _sdet(J)[:, None, None, None] * torch.einsum(
            "cij,cnqj->cnqi", _sinv(J), vals)
    elif mapping == "covariant":
        uref = torch.einsum("cji,cnqj->cnqi", J, vals)
    else:
        uref = vals
    uref = uref.reshape(uref.shape[0], nj, nd, nq, -1)
    dw = torch.as_tensor(np.asarray(dwts, dtype=np.float64).reshape(
        nd, nq, -1), device=dev)
    loc = torch.einsum("nqv,cjnqv->cnj", dw, uref)   # (nc, nd, nj)
    if getattr(V, "has_dof_signs", False):
        loc = loc * torch.as_tensor(V.cell_dof_signs,
                                    device=dev)[:, :, None]
    elif getattr(V, "has_dof_transforms", False):
        loc = torch.einsum("cij,cjk->cik", torch.as_tensor(
            np.linalg.inv(V.cell_dof_transforms), device=dev), loc)
    # source canonical -> local columns: w_loc = S w_can / T @ w_can
    if getattr(Vs, "has_dof_signs", False):
        loc = loc * torch.as_tensor(Vs.cell_dof_signs,
                                    device=dev)[:, None, :]
    elif getattr(Vs, "has_dof_transforms", False):
        loc = torch.einsum("cnj,cjk->cnk", loc, torch.as_tensor(
            Vs.cell_dof_transforms, device=dev))
    rows_sc = V.cell_dof_map.astype(np.int64)    # (nc, nd)
    cols_sc = Vs.cell_dof_map.astype(np.int64)   # (nc, nj)
    # shared target dofs are written by every adjacent cell: average
    mult = np.zeros(V.dim)
    np.add.at(mult, rows_sc.reshape(-1), 1.0)
    loc = loc / torch.as_tensor(mult[rows_sc], device=dev)[:, :, None]
    nc = rows_sc.shape[0]
    rows_e = np.broadcast_to(rows_sc[:, :, None], (nc, nd, nj))
    cols_e = np.broadcast_to(cols_sc[:, None, :], (nc, nd, nj))
    return entry_matrix(V.dim, Vs.dim, rows_e, cols_e, loc)


def scalar_node_positions(V):
    """(num_nodes, gdim) physical positions of a nodal space's scalar
    nodes, evaluated through the mesh coordinate element (curved-mesh
    aware); host numpy, as the JAX package's."""
    mesh = V.mesh_obj
    cspace = mesh.coordinate_space
    g = mesh.geometric_dimension
    ctab = cspace.scalar_element.tabulate(
        np.asarray(V.scalar_element.nodes), 0)[0]        # (nd, ndc)
    cdofs = to_numpy(mesh.coordinates.dat)[
        np.asarray(cspace.cell_dof_map)].reshape(mesh.num_cells, -1, g)
    pos_cells = np.einsum("ni,cig->cng", ctab, cdofs)    # (nc, nd, g)
    pos = np.zeros((V.sdata.num_nodes, g))
    pos[np.asarray(V.sdata.cell_node_map)] = pos_cells
    return pos


def _ref_inside(cellname, r, tol):
    """Which reference coordinates r (n, tdim) lie inside the reference
    cell within tol (a bool tensor)."""
    if cellname in ("interval", "triangle", "tetrahedron"):
        return (r.amin(dim=-1) >= -tol) & (r.sum(dim=-1) <= 1.0 + tol)
    if cellname in ("quadrilateral", "hexahedron"):
        return (r.amin(dim=-1) >= -tol) & (r.amax(dim=-1) <= 1.0 + tol)
    if cellname == "prism":
        return ((r[:, :2].amin(dim=-1) >= -tol)
                & (r[:, :2].sum(dim=-1) <= 1.0 + tol)
                & (r[:, 2] >= -tol) & (r[:, 2] <= 1.0 + tol))
    return torch.ones(len(r), dtype=torch.bool, device=r.device)


def _nearest_cells(mesh, pts, k=8):
    """For each point, the cell whose centroid is nearest (squared
    distance as the JAX package computes it, then the lower cell number):
    one k-d tree query for k candidates each."""
    from .pointeval import _host_geometry, _sorted_candidates
    geo = _host_geometry(mesh)
    k = min(k, len(geo["centroids"]))
    _, cand = geo["tree"].query(pts, k=k, workers=-1)
    cand = np.asarray(cand, dtype=np.int64).reshape(len(pts), k)
    return _sorted_candidates(geo, pts, cand)[0][:, 0]


def _locate_robust(mesh, pts, allow_extrapolate=False, tol_inside=5e-2):
    """Point location that tolerates nodes marginally outside the mesh
    (non-matching boundaries of non-nested hierarchies): widen the
    containment tolerance, then fall back to the nearest cell, for all
    remaining points in one k-d tree query and one batched inversion.

    The nearest-cell fallback is bounded by default: a point whose
    reference coordinates land farther than ``tol_inside`` outside the
    nearest cell is outside the mesh, and extrapolating there would give
    wrong values silently (the reference raises unless
    allow_missing_dofs=True).  NonNestedTransfer passes
    allow_extrapolate=True."""
    from .pointeval import _locate, _reference_coords, PointNotInDomainError
    pts = np.ascontiguousarray(np.asarray(pts, dtype=np.float64))
    cells, refs = _locate(mesh, pts, tol=1e-10)
    for tol in (1e-6, 1e-2):
        missing = cells < 0
        if not missing.any():
            return cells, refs
        idx = np.nonzero(missing)[0]
        c2, r2 = _locate(mesh, pts[idx], tol=tol)
        cells[idx] = c2
        refs[torch.as_tensor(idx, device=refs.device)] = r2
    missing = np.nonzero(cells < 0)[0]
    if len(missing):
        near = _nearest_cells(mesh, pts[missing])
        dev = refs.device
        r, ok = _reference_coords(
            mesh, torch.as_tensor(near, device=dev),
            torch.as_tensor(pts[missing], device=dev))
        bad = ~ok
        if not allow_extrapolate:
            bad = bad | ~_ref_inside(mesh.cell.name, r, tol_inside)
        bad = np.nonzero(bad.cpu().numpy())[0]
        if len(bad):
            # the first offending point, as the JAX package's loop meets it
            i = bad[0]
            if not bool(ok[i]):
                raise ValueError(f"point {pts[missing[i]]} not locatable")
            raise PointNotInDomainError(
                f"point {pts[missing[i]]} is outside the source mesh "
                "(pass allow_missing_dofs=True to extrapolate from the "
                "nearest cell)")
        cells[missing] = near
        refs[torch.as_tensor(missing, device=dev)] = r
    return cells, refs


def cross_mesh_entries(Vs, Vd, allow_extrapolate=False):
    """Per-target-scalar-node interpolation entries between nodal spaces
    on different meshes: rows_sc (nn, 1) and cols_sc (nn, nsrc) on the
    host, loc (nn, 1, nsrc) on the device with loc[i, 0, j] = phi_j^s at
    target node i."""
    from .pointeval import basis_at
    pos = scalar_node_positions(Vd)
    cells, refs = _locate_robust(Vs.mesh_obj, pos,
                                 allow_extrapolate=allow_extrapolate)
    loc = basis_at(Vs.scalar_element, refs)
    rows_sc = np.arange(len(pos), dtype=np.int64)[:, None]
    cols_sc = np.asarray(Vs.cell_node_map, dtype=np.int64)[cells]
    return rows_sc, cols_sc, loc[:, None, :]


def cross_mesh_scalar_matrix(Vs, Vd):
    """The cross-mesh interpolation operator over scalar node numberings
    as a device Matrix (NonNestedHierarchy transfers).  Extrapolation from
    the nearest cell is allowed here: non-nested hierarchy levels have
    marginally non-matching boundaries."""
    from .assembly.matrix import entry_matrix
    rows_sc, cols_sc, loc = cross_mesh_entries(Vs, Vd,
                                               allow_extrapolate=True)
    rows = np.repeat(rows_sc.ravel(), cols_sc.shape[1])
    return entry_matrix(Vd.sdata.num_nodes, Vs.sdata.num_nodes, rows,
                        cols_sc.ravel(), loc[:, 0, :])


class Interpolator:
    """Reusable interpolator (reference: interpolation.py Interpolator).

    When ``expr`` is an Argument or Function of a source space, the
    interpolation is a linear operator: ``assemble()`` makes the sparse
    matrix I (target dim x source dim) and ``interpolate(cof,
    adjoint=True)`` applies I^T (the data-assimilation adjoint), by I^T
    kept as a matrix of its own.  Identity-mapped (Lagrange-family)
    sources; targets are same-mesh or other-mesh nodal spaces, or a
    VertexOnlyMesh P0DG space."""

    def __init__(self, expr, V, allow_missing_dofs=False):
        self.expr = expr
        self.V = V
        self.allow_missing_dofs = allow_missing_dofs
        self._mat = None
        self._matT = None

    def _source_space(self):
        if isinstance(self.expr, (Argument, Function)):
            return self.expr.function_space()
        raise NotImplementedError(
            "interpolation matrices need a bare Function/Argument "
            "expression")

    def assemble(self):
        """The interpolation operator as a Matrix."""
        if self._mat is not None:
            return self._mat
        from .assembly.matrix import entry_matrix
        from .pointeval import basis_at
        Vs = self._source_space()
        Vd = self.V
        src = Vs.scalar_element
        if getattr(src, "mapping", "identity") != "identity":
            raise NotImplementedError("interpolation matrices of Piola-"
                                      "mapped sources")
        bs = Vs.block_size
        mesh_d = Vd.mesh_obj
        dev = get_device()
        if getattr(mesh_d, "is_vertex_only", False):
            # rows: one per (point, component); cols: parent cell dofs
            assert mesh_d.parent is Vs.mesh_obj
            loc = basis_at(src, as_tensor(mesh_d.refs))[:, None, :]
            rows_sc = np.arange(len(mesh_d.cells))[:, None]
            cols_sc = Vs.cell_node_map[mesh_d.cells]
            n_rownodes = len(mesh_d.cells)
        elif Vd.mesh_obj is not Vs.mesh_obj:
            # cross-mesh: one row per target scalar node, located in the
            # source mesh
            rows_sc, cols_sc, loc = cross_mesh_entries(
                Vs, Vd, allow_extrapolate=self.allow_missing_dofs)
            n_rownodes = Vd.num_nodes
        else:
            tab = src.tabulate(Vd.scalar_element.nodes, 0)[0]
            rows_sc = Vd.cell_node_map
            cols_sc = Vs.cell_node_map
            # shared CG target nodes are written by several cells: scale
            # by multiplicity so the sum averages (values agree for
            # continuous data)
            mult = np.zeros(Vd.num_nodes)
            np.add.at(mult, rows_sc.reshape(-1), 1.0)
            loc = torch.as_tensor(
                np.broadcast_to(tab, (Vs.mesh_obj.num_cells,) + tab.shape)
                / mult[rows_sc][:, :, None], device=dev)
            n_rownodes = Vd.num_nodes
        nc, ndst, nsrc = loc.shape
        comp = np.arange(bs)
        # (nc, ndst, nsrc, bs): component c of node i maps from component
        # c of node j (node-major interleave on both sides)
        rows_e = (rows_sc[:, :, None, None] * bs
                  + comp[None, None, None, :]) \
            * np.ones((1, 1, nsrc, 1), dtype=np.int64)
        cols_e = (cols_sc[:, None, :, None] * bs
                  + comp[None, None, None, :]) \
            * np.ones((1, ndst, 1, 1), dtype=np.int64)
        vals_e = torch.broadcast_to(loc[:, :, :, None], (nc, ndst, nsrc, bs))
        self._mat = entry_matrix(n_rownodes * bs, Vs.dim, rows_e, cols_e,
                                 vals_e)
        return self._mat

    def interpolate(self, source=None, output=None, adjoint=False):
        from .function import Cofunction
        if adjoint:
            if self._matT is None:
                self._matT = self.assemble().transpose()
            out = output or Cofunction(self._source_space())
            out.dat = self._matT.matvec(as_tensor(source.dat))
            return out
        if source is not None and not isinstance(self.expr, Function):
            f = output or Function(self.V)
            f.dat = self.assemble().matvec(as_tensor(source.dat))
            return f
        f = output or Function(self.V)
        return interpolate_onto(source if source is not None
                                else self.expr, f)
