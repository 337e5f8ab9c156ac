"""Supermesh: mixed mass matrices between non-matching meshes, and the
conservative projection they give (the port's copy of
``firedrake_tpu/supermesh.py``; reference: firedrake/supermeshing.py:70
assemble_mixed_mass_matrix, backed by libsupermesh).

Candidate cell pairs come from a k-d tree over the target mesh's
centroids, on the host, as in the JAX package.  In 2D the rest runs on
the device for all pairs at once: each convex cell has at most 4
vertices and is clipped by at most 4 half-planes (Sutherland-Hodgman),
so every intersection polygon fits a buffer of 8 vertices; the polygons
are fan-triangulated, both bases are evaluated at the pieces' quadrature
points (affine inversion on triangles, batched Newton on quads), and the
local mass matrices are summed into the Sparsity in a fixed order (the
gather route's accumulation plan).  In 3D (tets, planar-faced hexes) the
pieces are made on the host by the JAX package's loops over cell pairs
(convex-intersection vertices, hull tetrahedralisation), transcribed in
numpy.  Vector spaces (matching block sizes) expand the scalar matrix
over components.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from .device import as_tensor, get_device, to_numpy

#: candidate pairs per device batch of the 2D clipping
PAIR_CHUNK = 1 << 20
#: vertices of an intersection polygon of two convex quadrilaterals
MAX_POLY = 8
#: a vertex within this (absolute) of a clipping line's inner side is in
_EPS = 1e-14
#: pieces whose |det J| (twice their area, six times their volume) lies
#: below this are dropped
_MIN_DETJ = 1e-16


# ------------------------------------------------------------ 2D clipping
def _clip_poly_halfplane(poly, a, b):
    """Clip polygon by the half-plane left of segment a->b (the per-pair
    transcription, on the host)."""
    n = np.array([-(b[1] - a[1]), b[0] - a[0]])
    out = []
    m = len(poly)
    for i in range(m):
        p, q = poly[i], poly[(i + 1) % m]
        dp = np.dot(p - a, n)
        dq = np.dot(q - a, n)
        if dp >= -_EPS:
            out.append(p)
            if dq < -_EPS:
                t = dp / (dp - dq)
                out.append(p + t * (q - p))
        elif dq >= -_EPS:
            t = dp / (dp - dq)
            out.append(p + t * (q - p))
    return out


def intersect_polys(polyA, polyB):
    """Convex intersection polygon of two ccw convex polygons (host)."""
    poly = list(polyA)
    m = len(polyB)
    for i in range(m):
        poly = _clip_poly_halfplane(poly, polyB[i], polyB[(i + 1) % m])
        if len(poly) < 3:
            return []
    return poly


def clip_batch(subj, nsubj, clip, nclip):
    """Sutherland-Hodgman for a batch of pairs on their device: polygons
    subj (P, k, 2) with vertex counts nsubj (P,), clipped by the
    half-planes left of the edges of the ccw loops clip (P, m, 2) with
    counts nclip (P,).  Returns the intersection polygons (P, MAX_POLY, 2)
    and their counts (0 where a pair does not intersect), the per-pair
    transcription's arithmetic on every pair at once."""
    P, dev = subj.shape[0], subj.device
    poly = subj.new_zeros((P, MAX_POLY, 2))
    poly[:, :subj.shape[1]] = subj
    cnt = nsubj.clone()
    alive = torch.ones(P, dtype=torch.bool, device=dev)
    rows = torch.arange(P, device=dev)
    slots = torch.arange(MAX_POLY, device=dev)
    for e in range(clip.shape[1]):
        has = (e < nclip) & alive
        a = clip[:, e]
        b = clip[rows, (e + 1) % nclip]
        n = torch.stack([-(b[:, 1] - a[:, 1]), b[:, 0] - a[:, 0]], dim=-1)
        nxt = (slots[None] + 1) % cnt.clamp(min=1)[:, None]
        p = poly
        q = torch.gather(poly, 1, nxt[..., None].expand(-1, -1, 2))
        dp = ((p - a[:, None]) * n[:, None]).sum(dim=-1)
        dq = ((q - a[:, None]) * n[:, None]).sum(dim=-1)
        real = slots[None] < cnt[:, None]
        pin, qin = dp >= -_EPS, dq >= -_EPS
        t = dp / torch.where(pin == qin, torch.ones_like(dp), dp - dq)
        x = p + t[..., None] * (q - p)
        keep = torch.stack([real & pin, real & (pin != qin)], dim=2)
        keep = keep.reshape(P, 2 * MAX_POLY)
        cand = torch.stack([p, x], dim=2).reshape(P, 2 * MAX_POLY, 2)
        newcnt = keep.sum(dim=1)
        if bool((has & (newcnt > MAX_POLY)).any()):
            raise RuntimeError("supermesh: a clipped polygon outgrew its "
                               f"{MAX_POLY}-vertex buffer")
        # compact the kept vertices in order; the rest go to a spill slot
        pos = torch.where(keep, keep.cumsum(dim=1) - 1,
                          torch.full_like(newcnt[:, None], 2 * MAX_POLY))
        out = poly.new_zeros((P, 2 * MAX_POLY + 1, 2))
        out.scatter_(1, pos[..., None].expand(-1, -1, 2), cand)
        poly = torch.where(has[:, None, None], out[:, :MAX_POLY], poly)
        cnt = torch.where(has, newcnt, cnt)
        alive = alive & ~(has & (newcnt < 3))
    return poly, torch.where(alive, cnt, torch.zeros_like(cnt))


def _cell_loops(verts, cellname):
    """ccw boundary loops (nc, nv, 2) of a 2D mesh's cells on the host:
    triangles as they are or with two vertices swapped, lattice-ordered
    quads reordered to the boundary walk (the JAX package's _cell_loop,
    for all cells at once)."""
    if cellname == "triangle":
        u, w = verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0]
        pos = u[:, 0] * w[:, 1] - u[:, 1] * w[:, 0] > 0
        return np.where(pos[:, None, None], verts, verts[:, [0, 2, 1]])
    loop = verts[:, [0, 1, 3, 2]]                 # lattice -> boundary walk
    x, y = loop[..., 0], loop[..., 1]
    area = 0.5 * np.sum(x * np.roll(y, -1, axis=1)
                        - np.roll(x, -1, axis=1) * y, axis=1)
    return np.where((area < 0)[:, None, None], loop[:, ::-1], loop)


# ------------------------------------------------------------ 3D (host)
def _tet_planes(tet):
    """Inward-pointing (n, d) halfspace data: n @ x + d >= 0 inside."""
    faces = ((1, 2, 3, 0), (0, 2, 3, 1), (0, 1, 3, 2), (0, 1, 2, 3))
    planes = []
    for i, j, k, opp in faces:
        n = np.cross(tet[j] - tet[i], tet[k] - tet[i])
        d = -np.dot(n, tet[i])
        if np.dot(n, tet[opp]) + d < 0:      # orient inward
            n, d = -n, -d
        s = np.linalg.norm(n)
        planes.append((n / s, d / s))
    return planes


def _inside(planes, p, tol):
    return all(np.dot(n, p) + d >= -tol for n, d in planes)


def _cell_planes(verts, cell, tol=1e-10):
    """Inward halfspace data of a convex 3D cell from its reference
    topology faces.  Raises on non-planar (warped) hex faces: the
    polyhedron clipping below needs true planes."""
    if cell.name == "tetrahedron":
        return _tet_planes(verts)
    centroid = verts.mean(axis=0)
    planes = []
    for fv in cell.topology[2]:
        ids = [int(v) for v in fv if v >= 0]
        p = verts[ids]
        n = np.cross(p[1] - p[0], p[2] - p[0])
        s = np.linalg.norm(n)
        n = n / s
        d = -np.dot(n, p[0])
        if any(abs(np.dot(n, q) + d) > tol * max(s, 1.0) for q in p[3:]):
            raise NotImplementedError(
                "supermesh: non-planar hexahedron faces")
        if np.dot(n, centroid) + d < 0:
            n, d = -n, -d
        planes.append((n, d))
    return planes


def _dedup(pts):
    keep = []
    for p in np.asarray(pts):      # dedup (tiny point sets)
        if not any(np.linalg.norm(p - q) < 1e-12 for q in keep):
            keep.append(p)
    return keep


def intersect_cells_3d(vertsA, vertsB, cellA, cellB, tol=1e-12):
    """Vertices of the convex intersection of two convex 3D cells:
    vertices of A in B, vertices of B in A, and every edge-face crossing,
    deduplicated."""
    pA = _cell_planes(vertsA, cellA)
    pB = _cell_planes(vertsB, cellB)
    pts = [v for v in vertsA if _inside(pB, v, tol)]
    pts += [v for v in vertsB if _inside(pA, v, tol)]
    for verts, edges, planes in ((vertsA, cellA.topology[1], pB),
                                 (vertsB, cellB.topology[1], pA)):
        for i, j in edges:
            a, b = verts[int(i)], verts[int(j)]
            u = b - a
            for n, d in planes:
                den = np.dot(n, u)
                if abs(den) < 1e-15:
                    continue
                t = -(np.dot(n, a) + d) / den
                if tol < t < 1 - tol:
                    p = a + t * u
                    if _inside(pA, p, tol) and _inside(pB, p, tol):
                        pts.append(p)
    if len(pts) < 4:
        return []
    return _dedup(pts)


def _hull_tets(pts):
    """Tetrahedralize the convex hull of `pts` by fanning hull triangles
    from the centroid; yields (4, 3) vertex arrays."""
    from scipy.spatial import QhullError, ConvexHull
    pts = np.asarray(pts)
    try:
        hull = ConvexHull(pts, qhull_options="QJ")
    except QhullError:
        return
    c = pts[hull.vertices].mean(axis=0)
    for simplex in hull.simplices:
        yield np.vstack([pts[simplex], c])


# ------------------------------------------------------- reference maps
def _inv_affine(cellx, pts):
    """Reference coordinates of pts (n, q, d) in affine cells whose
    vertices are cellx (n, nv, d), on the device."""
    d = cellx.shape[-1]
    A = torch.stack([cellx[:, k + 1] - cellx[:, 0] for k in range(d)],
                    dim=-1)                            # (n, d, d)
    rhs = (pts - cellx[:, None, 0]).transpose(1, 2)    # (n, d, q)
    return torch.linalg.solve(A, rhs).transpose(1, 2)


def _inv_multilinear(cellx, pts, refv, iters=30):
    """Newton inversion of the bi/trilinear vertex maps (lattice reference
    vertices refv in {0,1}^d) for pts (n, q, d) in cells cellx (n, nv, d),
    on the device: the JAX package's fixed iteration count."""
    n, nq, d = pts.shape
    hi = torch.as_tensor(refv > 0.5, device=pts.device)     # (nv, d)
    xi = pts.new_full((n, nq, d), 0.5)
    for _ in range(iters):
        w = pts.new_ones((n, nq, len(refv)))
        dw = pts.new_ones((n, nq, len(refv), d))
        for ax in range(d):
            x = xi[..., ax:ax + 1]
            f = torch.where(hi[:, ax], x, 1.0 - x)          # (n, nq, nv)
            df = torch.where(hi[:, ax], 1.0, -1.0).to(pts.dtype)
            w = w * f
            for bx in range(d):
                dw[..., bx] = dw[..., bx] * (df if bx == ax else f)
        F = torch.einsum("nqv,nvd->nqd", w, cellx) - pts
        J = torch.einsum("nqve,nvd->nqde", dw, cellx)
        xi = xi - torch.linalg.solve(J, F[..., None])[..., 0]
    return xi


# ------------------------------------------------------- mixed mass matrix
def _candidate_pairs(xA, xB):
    """(a, b) cell pairs whose bounding circles may meet: a ball query
    around each A centroid in a k-d tree over B's, a ascending, then b
    ascending (the JAX package's loop order)."""
    from scipy.spatial import cKDTree
    cA, cB = xA.mean(axis=1), xB.mean(axis=1)
    rA = np.linalg.norm(xA - cA[:, None], axis=2).max(axis=1)
    rB = np.linalg.norm(xB - cB[:, None], axis=2).max(axis=1)
    lists = cKDTree(cB).query_ball_point(cA, r=rA + rB.max(), workers=-1)
    lens = np.fromiter(map(len, lists), dtype=np.int64, count=len(lists))
    a = np.repeat(np.arange(len(lists), dtype=np.int64), lens)
    b = np.fromiter(itertools.chain.from_iterable(lists), dtype=np.int64,
                    count=int(lens.sum()))
    return a, b


def _pair_masses_2d(loopA, loopB, xA, xB, simplex, elA, elB, quad,
                    refv, chunk=PAIR_CHUNK):
    """Local mass matrices (npair, ndA, ndB) of every candidate pair, on
    the device, and which pairs met (a host bool array): clip, fan out,
    integrate; the pieces of a pair summed in their fan order."""
    from .pointeval import basis_at
    dev = loopA.device
    qp = torch.as_tensor(quad.points, dtype=torch.float64, device=dev)
    qw = torch.as_tensor(quad.weights, dtype=torch.float64, device=dev)
    nA, nB = loopA.shape[1], loopB.shape[1]
    P = len(xA)
    locs, met = [], []
    for s in range(0, P, chunk):
        la, lb = loopA[s:s + chunk], loopB[s:s + chunk]
        m = len(la)
        poly, cnt = clip_batch(
            la, torch.full((m,), nA, dtype=torch.int64, device=dev),
            lb, torch.full((m,), nB, dtype=torch.int64, device=dev))
        # fan triangulation: piece k is (p0, p_k+1, p_k+2)
        p0 = poly[:, :1]                                  # (m, 1, 2)
        e1 = poly[:, 1:MAX_POLY - 1] - p0                 # (m, 6, 2)
        e2 = poly[:, 2:MAX_POLY] - p0
        detJ = (e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]).abs()
        k = torch.arange(MAX_POLY - 2, device=dev)
        ok = (k[None] + 2 < cnt[:, None]) & (detJ >= _MIN_DETJ)
        J = torch.stack([e1, e2], dim=-1)                 # (m, 6, 2, 2)
        phys = p0[:, :, None] + torch.einsum("qt,mkgt->mkqg", qp, J)
        phys = phys.reshape(m, -1, 2)                     # (m, 6 nq, 2)
        ca, cb = xA[s:s + chunk], xB[s:s + chunk]
        if simplex:
            ra, rb = _inv_affine(ca, phys), _inv_affine(cb, phys)
        else:
            ra = _inv_multilinear(ca, phys, refv)
            rb = _inv_multilinear(cb, phys, refv)
        nq = len(qw)
        tA = basis_at(elA, ra.reshape(-1, 2)).reshape(m, -1, nq, elA.ndof)
        tB = basis_at(elB, rb.reshape(-1, 2)).reshape(m, -1, nq, elB.ndof)
        # pieces past a polygon's count (or of a pair that does not meet)
        # hold no points: their tables are zeroed, whatever the inversion
        # made of them
        tA = torch.where(ok[..., None, None], tA, torch.zeros_like(tA))
        tB = torch.where(ok[..., None, None], tB, torch.zeros_like(tB))
        w = torch.where(ok, detJ, torch.zeros_like(detJ))[..., None] * qw
        loc = torch.einsum("mkq,mkqi,mkqj->mkij", w, tA, tB)
        locs.append(loc.sum(dim=1))
        met.append(ok.any(dim=1))
    return torch.cat(locs), to_numpy(torch.cat(met))


def _pieces_3d(xA, xB, a_idx, b_idx, rcell):
    """Host loop over the candidate pairs: the tetrahedra of each pair's
    intersection, as (pair, (4, 3) vertices) items."""
    for i, (a, b) in enumerate(zip(a_idx, b_idx)):
        pts = intersect_cells_3d(xA[a], xB[b], rcell, rcell)
        if len(pts) >= 4:
            for sub in _hull_tets(pts):
                yield i, sub


def _pair_masses_3d(xA, xB, a_idx, b_idx, rcell, simplex, elA, elB, quad,
                    refv):
    """Local mass matrices of the pieces (host pieces, device
    integration) and each piece's pair index."""
    from .pointeval import basis_at
    owner, subs = [], []
    for i, sub in _pieces_3d(xA, xB, a_idx, b_idx, rcell):
        J = np.stack([sub[k + 1] - sub[0] for k in range(3)], axis=1)
        detJ = abs(np.linalg.det(J))
        if detJ < _MIN_DETJ:
            continue
        owner.append(i)
        subs.append((sub[0] + quad.points @ J.T, detJ))
    dev = get_device()
    if not subs:
        return torch.zeros((0, elA.ndof, elB.ndof), dtype=torch.float64,
                           device=dev), np.zeros(0, dtype=np.int64)
    owner = np.asarray(owner, dtype=np.int64)
    phys = torch.as_tensor(np.stack([p for p, _ in subs]), device=dev)
    detJ = torch.as_tensor(np.array([d for _, d in subs]), device=dev)
    ca = torch.as_tensor(xA[a_idx[owner]], device=dev)
    cb = torch.as_tensor(xB[b_idx[owner]], device=dev)
    if simplex:
        ra, rb = _inv_affine(ca, phys), _inv_affine(cb, phys)
    else:
        ra = _inv_multilinear(ca, phys, refv)
        rb = _inv_multilinear(cb, phys, refv)
    nq = quad.points.shape[0]
    tA = basis_at(elA, ra.reshape(-1, 3)).reshape(len(owner), nq, -1)
    tB = basis_at(elB, rb.reshape(-1, 3)).reshape(len(owner), nq, -1)
    w = detJ[:, None] * torch.as_tensor(quad.weights, device=dev)
    return torch.einsum("mq,mqi,mqj->mij", w, tA, tB), owner


def assemble_mixed_mass_matrix(V_A, V_B):
    """M[i, j] = integral phi_i^A psi_j^B over the supermesh (reference:
    supermeshing.py:70).  Returns a Matrix mapping V_B coefficients to
    V_A duals.  Scalar and vector Lagrange-type spaces on triangle, quad
    (2D), tetrahedron or planar-faced hexahedron (3D) meshes."""
    from .assembly.matrix import entry_matrix
    from .elements.quadrature import make_quadrature

    mesh_A, mesh_B = V_A.mesh_obj, V_B.mesh_obj
    cell = mesh_A.cell.name
    if cell != mesh_B.cell.name or cell not in (
            "triangle", "tetrahedron", "quadrilateral", "hexahedron"):
        raise NotImplementedError(
            "supermesh: both meshes must share a tri/quad/tet/hex cell")
    rcell = mesh_A.cell
    simplex = cell in ("triangle", "tetrahedron")
    bs = V_A.block_size
    if V_B.block_size != bs:
        raise NotImplementedError("supermesh: matching block sizes")
    for V in (V_A, V_B):
        if getattr(V.scalar_element, "mapping", "identity") != "identity":
            raise NotImplementedError("supermesh: nodal (identity-"
                                      "mapped) spaces")
    tdim = rcell.dim
    deg = V_A.scalar_element.degree + V_B.scalar_element.degree
    if not simplex:
        deg += tdim      # multilinear pullbacks raise the piece degree
    quad = make_quadrature("triangle" if tdim == 2 else "tetrahedron",
                           max(deg, 1))
    xA = mesh_A._vertex_coords[mesh_A.topology.cell_vertices]
    xB = mesh_B._vertex_coords[mesh_B.topology.cell_vertices]
    a_idx, b_idx = _candidate_pairs(xA, xB)
    elA, elB = V_A.scalar_element, V_B.scalar_element
    refv = np.asarray(rcell.vertices, dtype=float)
    if tdim == 2:
        dev = get_device()
        ia = torch.as_tensor(a_idx, device=dev)
        ib = torch.as_tensor(b_idx, device=dev)
        loc, met = _pair_masses_2d(
            as_tensor(_cell_loops(xA, cell))[ia],
            as_tensor(_cell_loops(xB, cell))[ib], as_tensor(xA)[ia],
            as_tensor(xB)[ib], simplex, elA, elB, quad, refv)
        keep = np.flatnonzero(met)
        loc = loc[torch.as_tensor(keep, device=dev)]
        a_sel, b_sel = a_idx[keep], b_idx[keep]
    else:
        # pairs whose bounding boxes lie apart cannot meet: the host loop
        # skips them (boxes that touch, within 1e-9, are kept)
        lo = np.maximum(xA.min(axis=1)[a_idx], xB.min(axis=1)[b_idx])
        hi = np.minimum(xA.max(axis=1)[a_idx], xB.max(axis=1)[b_idx])
        near = (lo <= hi + 1e-9).all(axis=1)
        a_idx, b_idx = a_idx[near], b_idx[near]
        loc, owner = _pair_masses_3d(xA, xB, a_idx, b_idx, rcell,
                                     simplex, elA, elB, quad, refv)
        a_sel, b_sel = a_idx[owner], b_idx[owner]
    mapA = np.asarray(V_A.cell_node_map, dtype=np.int64)
    mapB = np.asarray(V_B.cell_node_map, dtype=np.int64)
    ndA, ndB = elA.ndof, elB.ndof
    rows = np.broadcast_to(mapA[a_sel][:, :, None], (len(a_sel), ndA, ndB))
    cols = np.broadcast_to(mapB[b_sel][:, None, :], (len(b_sel), ndA, ndB))
    vals = loc
    if bs > 1:                 # kron with I_bs over components
        comp = np.arange(bs)
        rows = rows[..., None] * bs + comp
        cols = cols[..., None] * bs + comp
        vals = torch.broadcast_to(loc[..., None], loc.shape + (bs,))
    return entry_matrix(V_A.dim, V_B.dim, rows, cols, vals, V_A, V_B)


def supermesh_project(f_src, V_dst, solver_parameters=None):
    """Conservative (Galerkin) L2 projection across non-matching meshes:
    M_dd u = M_ds f, M_ds by assemble_mixed_mass_matrix on the device, the
    mass solve by the host sparse LU, as in the JAX package."""
    from .function import Function
    from .assemble import assemble
    from .language import TestFunction, TrialFunction, inner, dx
    from .solving import direct_solve
    M_ds = assemble_mixed_mass_matrix(V_dst, f_src.function_space())
    u, v = TrialFunction(V_dst), TestFunction(V_dst)
    M_dd = assemble(inner(u, v) * dx)
    out = Function(V_dst)
    out.dat = direct_solve(M_dd, M_ds.matvec(as_tensor(f_src.dat)))
    return out
