"""Point evaluation: u.at(points).

Reference: firedrake/function.py:569 Function.at / PointEvaluator :711;
point location = libspatialindex R-tree over cell bboxes + per-cell Newton
inversion in generated C (firedrake/locate.c, pointquery_utils.py:38).

Here the host finds each point's candidate cells in a scipy cKDTree over
the cell centroids, in the JAX package's order (by the squared distance
to the centroid, then by cell number, within 1.5 times the largest
centroid-to-vertex distance), and the device maps every candidate's point
to reference coordinates at once: affine simplices by their inverse
Jacobians, manifold cells by least squares, bilinear and curved cells by
batched Newton.  A point goes to the first candidate that contains it, so
the located cells are the JAX package's; a point on a facet or a vertex,
inside several cells within the tolerance, gets the same one.  Evaluation
gathers the located cells' dofs and contracts them with the basis at the
reference points, on the device.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from .device import as_tensor, get_device, to_numpy


class PointNotInDomainError(Exception):
    pass


#: nearest candidate cells per point in the first pass; a point whose
#: answer the first pass cannot vouch for goes to the whole ball
FIRST_K = 8
#: points per device batch of the inversion (FIRST_K candidates each)
CHUNK = 1 << 17
NEWTON_ITS = 20


# ------------------------------------------------------------ host tables
def _host_geometry(mesh):
    """Centroids, the candidate radius and the k-d tree, per coordinate
    version of the mesh."""
    key = getattr(mesh, "_coord_version", 0)
    hit = mesh.__dict__.get("_locate_host")
    if hit is not None and hit[0] == key:
        return hit[1]
    from scipy.spatial import cKDTree
    coords = mesh._vertex_coords
    cellpts = coords[mesh.topology.cell_vertices]          # (nc, nv, g)
    centroids = cellpts.mean(axis=1)
    radius = np.max(np.linalg.norm(cellpts - centroids[:, None, :],
                                   axis=2), axis=1)
    geo = dict(centroids=centroids, r=radius.max() * 1.5,
               tree=cKDTree(centroids))
    mesh._locate_host = (key, geo)
    return geo


def _sorted_candidates(geo, pts, cand):
    """Sort each row of candidate cells `cand` (pads: the cell count) by
    the squared distance of its centroid to the point, computed as the
    JAX package computes it, then by cell number.  Returns the sorted
    cells and their squared distances (pads: inf)."""
    nc = len(geo["centroids"])
    pad = cand >= nc
    cen = geo["centroids"][np.where(pad, 0, cand)]
    d2 = ((cen - pts[:, None, :]) ** 2).sum(axis=-1)
    d2[pad] = np.inf
    order = np.lexsort((cand, d2), axis=-1)
    return (np.take_along_axis(cand, order, axis=-1),
            np.take_along_axis(d2, order, axis=-1))


def _candidates(mesh, pts):
    """First pass: the FIRST_K centroids nearest each point within the
    radius.  Returns the cells in the JAX package's order, their squared
    distances, and for each point the squared distance below which a pick
    is sure to be the one the whole ball would give (inf where the ball
    holds no more candidates)."""
    geo = _host_geometry(mesh)
    nc = len(geo["centroids"])
    k = min(FIRST_K, nc)
    dist, cand = geo["tree"].query(pts, k=k, distance_upper_bound=geo["r"],
                                   workers=-1)
    cand = cand.reshape(len(pts), k)
    dist = dist.reshape(len(pts), k)
    full = cand[:, -1] < nc
    # a cell outside these k is at least as far as the k-th: a pick
    # nearer than that (by more than rounding) is the ball's pick
    limit = np.where(full, dist[:, -1] ** 2 * (1 - 1e-9), np.inf)
    cand, d2 = _sorted_candidates(geo, pts, cand)
    return cand, d2, limit


def _ball_candidates(mesh, pts):
    """Every cell whose centroid lies within the radius of each point,
    as the JAX package gathers them, in its order."""
    geo = _host_geometry(mesh)
    nc = len(geo["centroids"])
    lists = geo["tree"].query_ball_point(pts, r=geo["r"], workers=-1)
    lens = np.fromiter(map(len, lists), dtype=np.int64, count=len(pts))
    cand = np.full((len(pts), max(int(lens.max(initial=0)), 1)), nc,
                   dtype=np.int64)
    cand[np.arange(cand.shape[1]) < lens[:, None]] = np.fromiter(
        itertools.chain.from_iterable(lists), dtype=np.int64,
        count=int(lens.sum()))
    return _sorted_candidates(geo, pts, cand)[0]


# ---------------------------------------------------------- device tables
def _tensor_polyset(elem):
    """The monomial polyset of a Lagrange-family element (through vector
    and broken wrappers), or None."""
    while not hasattr(elem, "_polyset") and hasattr(elem, "sub"):
        elem = elem.sub
    return getattr(elem, "_polyset", None)


def _mono(E, x, deriv=()):
    """Monomials x^E (n, nm) on the device, differentiated along the axes
    in `deriv` (the host polyset's _mono)."""
    out = torch.ones(x.shape[0], E.shape[0], dtype=x.dtype, device=x.device)
    for ax in range(E.shape[1]):
        e = E[:, ax]
        c = torch.ones_like(e)
        for _ in range(deriv.count(ax)):
            c = c * e
            e = torch.clamp(e - 1, min=0)
        out = out * (c[None, :] * torch.pow(x[:, ax:ax + 1], e[None, :]))
    return out


def _poly_tabulate(ps, x, order=0):
    """(values (n, ndof), first derivatives (n, ndof, d) if order) of a
    polyset at reference points x (n, d) on x's device."""
    E = torch.as_tensor(ps.exponents, dtype=x.dtype, device=x.device)
    C = torch.as_tensor(ps.coeffs, dtype=x.dtype, device=x.device)
    vals = _mono(E, x) @ C
    if not order:
        return vals, None
    grads = torch.stack([_mono(E, x, (ax,)) @ C for ax in range(E.shape[1])],
                        dim=-1)
    return vals, grads


def basis_at(elem, refs):
    """The element's reference basis at points refs (n, d), a tensor on
    refs' device: (n, ndof) for scalar bases, (n, ndof, d) for Piola-mapped
    ones.  Lagrange-family polysets evaluate on the device; other elements
    tabulate on the host."""
    ps = _tensor_polyset(elem)
    if ps is not None:
        return _poly_tabulate(ps, refs)[0]
    tab = elem.tabulate(to_numpy(refs), 0)[0]
    return torch.as_tensor(np.asarray(tab, dtype=np.float64),
                           device=refs.device)


def _device_geometry(mesh):
    """Per-cell inversion data on the set device, per coordinate version:
    the kind of inversion and its tables, computed there."""
    dev = get_device()
    key = (getattr(mesh, "_coord_version", 0), dev)
    hit = mesh.__dict__.get("_locate_dev")
    if hit is not None and hit[0] == key:
        return hit[1]
    from .elements import make_scalar_element
    cell = mesh.cell
    d, g = cell.dim, mesh.geometric_dimension
    cd = getattr(mesh, "_coord_degree", 1)
    vc = torch.as_tensor(np.asarray(mesh._vertex_coords), device=dev)[
        torch.as_tensor(np.asarray(mesh.topology.cell_vertices, np.int64),
                        device=dev)]                          # (nc, nv, g)
    simplex = cell.name in ("interval", "triangle", "tetrahedron")
    geo = dict(d=d, v0=vc[:, 0])
    A = torch.stack([vc[:, i + 1] - vc[:, 0] for i in range(d)], dim=-1)
    if g != d:
        geo["kind"] = "manifold" if cell.name in ("interval", "triangle") \
            else "never"
        geo.update(A=A, P=torch.linalg.pinv(A),
                   size=torch.linalg.vector_norm(A, dim=1).amax(dim=1))
        mesh._locate_dev = (key, geo)
        return geo
    if simplex:
        # the affine map; a singular one finds nothing
        Ainv, info = torch.linalg.inv_ex(A)
        geo.update(Ainv=Ainv, ok=(info == 0) & (torch.linalg.det(A) != 0))
    geo["kind"] = "affine" if simplex and cd == 1 else "newton"
    if geo["kind"] == "newton":
        # bilinear cells, and curved ones from the affine estimate
        if cd > 1:
            e = make_scalar_element(cell.name,
                                    getattr(mesh, "_coord_family",
                                            "Lagrange"), cd)
            cmap = torch.as_tensor(np.asarray(
                mesh.coordinate_space.sdata.cell_node_map, np.int64),
                device=dev)
            coords = as_tensor(mesh.coordinates.dat).reshape(-1, g)[cmap]
        else:
            e = make_scalar_element(cell.name, "Lagrange", 1)
            coords = vc
        geo.update(poly=_tensor_polyset(e), coords=coords)
        if not simplex:
            geo["x0"] = torch.as_tensor(cell.vertices.mean(axis=0),
                                        device=dev)
    mesh._locate_dev = (key, geo)
    return geo


def _newton(geo, c, p, x, ok):
    """NEWTON_ITS steps of Newton on the coordinate map of cells c for
    points p from x; each stops after the step whose size falls below
    1e-13, and a singular Jacobian marks the candidate not found."""
    ps, coords = geo["poly"], geo["coords"][c]       # (m, ndofc, g)
    done = torch.zeros_like(ok)
    for _ in range(NEWTON_ITS):
        vals, grads = _poly_tabulate(ps, x, order=1)
        X = torch.einsum("mj,mjg->mg", vals, coords)
        J = torch.einsum("mjt,mjg->mgt", grads, coords)
        det = torch.linalg.det(J)
        sing = det == 0
        ok = ok & ~(sing & ~done)
        J = torch.where(sing[:, None, None], torch.eye(
            J.shape[-1], dtype=J.dtype, device=J.device), J)
        dx = torch.linalg.solve(J, (p - X)[..., None])[..., 0]
        step = ~done & ok
        x = torch.where(step[:, None], x + dx, x)
        done = done | (step & (torch.linalg.vector_norm(dx, dim=-1)
                               < 1e-13))
        if bool((done | ~ok).all()):
            break
    return x, ok


def _reference_coords(mesh, c, p):
    """Reference coordinates of points p (m, g) in cells c (m,), both
    tensors on the device, and whether each inversion succeeded."""
    geo = _device_geometry(mesh)
    kind = geo["kind"]
    m = len(c)
    if kind == "never":
        return (torch.zeros(m, geo["d"], dtype=p.dtype, device=p.device),
                torch.zeros(m, dtype=torch.bool, device=p.device))
    if kind == "manifold":
        rhs = p - geo["v0"][c]
        A = geo["A"][c]
        ref = torch.einsum("mdg,mg->md", geo["P"][c], rhs)
        resid = torch.linalg.vector_norm(
            torch.einsum("mgd,md->mg", A, ref) - rhs, dim=-1)
        return ref, ~(resid > 0.2 * geo["size"][c])
    if "Ainv" in geo:
        ref = torch.einsum("mdg,mg->md", geo["Ainv"][c], p - geo["v0"][c])
        ok = geo["ok"][c]
        if kind == "affine":
            return ref, ok
        return _newton(geo, c, p, ref, ok)
    x0 = geo["x0"].expand(m, -1).clone()
    return _newton(geo, c, p, x0, torch.ones(m, dtype=torch.bool,
                                             device=p.device))


def _inside(cell, x, tol):
    """The reference cell's contains_points on the device."""
    if cell.name in ("interval", "quadrilateral", "hexahedron"):
        return ((x >= -tol) & (x <= 1 + tol)).all(dim=-1)
    if cell.name == "prism":
        horiz = ((x[..., :2] >= -tol).all(dim=-1)
                 & (x[..., 0] + x[..., 1] <= 1 + tol))
        return horiz & (x[..., 2] >= -tol) & (x[..., 2] <= 1 + tol)
    return (x >= -tol).all(dim=-1) & (x.sum(dim=-1) <= 1 + tol)


def _containing(mesh, cand, pts, tol):
    """For sorted candidate rows cand (n, k) (pads: the cell count) of
    points pts (n, g): the position of the first candidate containing
    each point (k where none does) and the reference coordinates there.
    Device work, in batches of CHUNK points."""
    dev = get_device()
    nc = mesh.num_cells
    n, k = cand.shape
    first = torch.empty(n, dtype=torch.int64, device=dev)
    refs = torch.zeros(n, mesh.cell.dim, dtype=torch.float64, device=dev)
    for s in range(0, n, CHUNK):
        cc = torch.as_tensor(cand[s:s + CHUNK], device=dev)
        p = torch.as_tensor(pts[s:s + CHUNK], dtype=torch.float64,
                            device=dev)
        m = len(cc)
        real = cc < nc
        c = torch.where(real, cc, 0).reshape(-1)
        ref, ok = _reference_coords(mesh, c, p.repeat_interleave(k, 0))
        hit = (ok & _inside(mesh.cell, ref, tol)).reshape(m, k) & real
        pos = torch.where(hit.any(dim=1), hit.to(torch.int8).argmax(dim=1),
                          k)
        first[s:s + m] = pos
        got = pos < k
        rows = torch.nonzero(got).reshape(-1)
        refs[s + rows] = ref.reshape(m, k, -1)[rows, pos[rows]]
    return first, refs


# ---------------------------------------------------------- point location
def _locate(mesh, pts, tol=1e-10):
    """(cells, refcoords) for each query point: cells a host int64 array
    (-1 where not found), refcoords a (n, tdim) tensor on the device."""
    pts = np.ascontiguousarray(np.asarray(pts, dtype=float))
    n = len(pts)
    cells = np.full(n, -1, dtype=np.int64)
    if n == 0:
        return cells, torch.zeros(0, mesh.cell.dim, dtype=torch.float64,
                                  device=get_device())
    cand, d2, limit = _candidates(mesh, pts)
    first, refs = _containing(mesh, cand, pts, tol)
    first = to_numpy(first)
    k = cand.shape[1]
    got = first < k
    rows = np.flatnonzero(got)
    pick = cand[rows, first[rows]]
    sure = d2[rows, first[rows]] < limit[rows]
    cells[rows[sure]] = pick[sure]
    # the rest (not found among a full first pass, or a pick a farther
    # cell could precede): the whole ball
    again = np.setdiff1d(np.arange(n), rows[sure])
    again = again[~((~got[again]) & np.isinf(limit[again]))]
    if len(again):
        cand2 = _ball_candidates(mesh, pts[again])
        first2, refs2 = _containing(mesh, cand2, pts[again], tol)
        first2 = to_numpy(first2)
        ok2 = first2 < cand2.shape[1]
        idx = np.flatnonzero(ok2)
        cells[again[idx]] = cand2[idx, first2[idx]]
        refs[torch.as_tensor(again, device=refs.device)] = refs2
    return cells, refs


def at(function, points, tolerance=1e-10, dont_raise=False):
    """Evaluate a Function at physical points (array (n, gdim) or single
    point)."""
    V = function.function_space()
    mesh = V.mesh_obj
    pts = np.asarray(points, dtype=float)
    single = pts.ndim == 1
    pts = np.atleast_2d(pts)
    cells, refs = _locate(mesh, pts, tol=tolerance)
    missing = cells < 0
    if missing.any() and not dont_raise:
        raise PointNotInDomainError(
            f"points not found in domain: {pts[missing]}")
    out = to_numpy(evaluate(function, cells, refs))
    return out[0] if single else out


def eval_at_cells(function, cells, refs):
    """Evaluate a Function at pre-located points: (cell, refcoord) pairs.
    cells < 0 yield NaN.  A host array, as the JAX package's."""
    return to_numpy(evaluate(function, cells, refs))


def _space_tables(V, dev):
    """The space's cell dof map and dof signs or transforms on `dev`,
    cached on the space."""
    hit = V.__dict__.get("_eval_tables")
    if hit is not None and hit[0] == dev:
        return hit[1]
    t = dict(cmap=torch.as_tensor(np.asarray(V.cell_dof_map, np.int64),
                                  device=dev))
    if getattr(V, "has_dof_signs", False):
        t["signs"] = torch.as_tensor(V.cell_dof_signs, device=dev)
    elif getattr(V, "has_dof_transforms", False):
        t["transforms"] = torch.as_tensor(V.cell_dof_transforms, device=dev)
    V._eval_tables = (dev, t)
    return t


def evaluate(function, cells, refs):
    """The device side of eval_at_cells: a (n,) + value_shape tensor on
    the set device, NaN where cells < 0."""
    V = function.function_space()
    mesh = V.mesh_obj
    elem = V.element
    dev = get_device()
    vs = tuple(V.value_shape)
    cells = torch.as_tensor(np.asarray(cells, dtype=np.int64), device=dev) \
        if not isinstance(cells, torch.Tensor) else cells.to(dev)
    refs = as_tensor(refs)
    found = cells >= 0
    c = torch.where(found, cells, 0)
    tb = _space_tables(V, dev)
    w = as_tensor(function.dat)[tb["cmap"][c]]              # (n, nloc)
    if "signs" in tb:
        w = w * tb["signs"][c]
    elif "transforms" in tb:
        w = torch.einsum("nij,nj->ni", tb["transforms"][c], w)
    tab = basis_at(elem, refs)
    mapping = getattr(elem, "mapping", "identity")
    n = len(c)
    if mapping == "identity":
        bs = V.block_size
        if bs > 1:
            # interleaved components: val[c] = sum_j tab[j] w[j*bs+c]
            val = torch.einsum("nj,njc->nc", tab, w.reshape(n, -1, bs))
            val = val.reshape((n,) + vs)
        elif vs:
            val = torch.einsum("nj,nj...->n...", w, tab)
        else:
            val = (w * tab).sum(dim=-1)
    else:
        # Piola: tab (n, nslot, d) reference values
        d = mesh.cell.dim
        vc = torch.as_tensor(np.asarray(mesh._vertex_coords), device=dev)
        cv = torch.as_tensor(np.asarray(mesh.topology.cell_vertices,
                                        np.int64), device=dev)
        coords = vc[cv[c]]                                  # (n, nv, g)
        A = torch.stack([coords[:, k + 1] - coords[:, 0]
                         for k in range(d)], dim=-1)        # (n, g, d)
        ref_val = torch.einsum("nj,njd->nd", w, tab)
        if mapping == "contravariant":
            val = torch.einsum("ngd,nd->ng", A, ref_val) \
                / torch.linalg.det(A)[:, None]
        else:
            val = torch.einsum("ndg,nd->ng", torch.linalg.inv(A), ref_val)
    return torch.where(found.reshape((n,) + (1,) * len(vs)), val,
                       torch.full_like(val, float("nan")))
