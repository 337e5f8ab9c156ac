"""H(div) elements: Raviart-Thomas and Brezzi-Douglas-Marini (lowest
orders), plus 2D Nedelec (rotated RT) for H(curl).

Reference consumes these from FIAT (firedrake mixed-Poisson /
hybridization demos).  Construction here is moment-based: pick a spanning
polynomial set, build the dof-moment Vandermonde with quadrature, invert.

Conventions:
  * value_shape = (tdim,); reference basis maps to physical space with the
    CONTRAVARIANT Piola transform  phi = J phi_ref / detJ  (covariant
    J^{-T} phi_ref for H(curl)).
  * one dof per facet (RT1/BDM1 facet dofs x P0/P1 moments): the dof
    functional is the normal-flux moment with the facet's CANONICAL
    orientation (global normal = the one induced by sorted global vertex
    order); a cell whose outward normal disagrees contributes with sign -1
    (FunctionSpaceData.cell_dof_signs applies this, the FIAT/FInAT
    orientation-sign analogue).
"""
from __future__ import annotations

import numpy as np
from functools import lru_cache

from .finite_element import FiniteElement
from .reference_cell import by_name
from .quadrature import make_quadrature


class _PtVecDual:
    """Moment functional in quadrature form: ell(u) = sum_q
    wvec[q] . u(pts[q]) (the FIAT pt_dict role, reference
    FIAT/functional.py) — dual-evaluation interpolation consumes the
    (pts, wvec) arrays directly."""

    def __init__(self, pts, wvec):
        self.pts = np.asarray(pts, dtype=float)      # (nq, tdim)
        self.wvec = np.asarray(wvec, dtype=float)    # (nq, vdim)

    def __call__(self, t):
        vals = np.array([t(p) for p in self.pts])
        return float(np.sum(self.wvec * vals))


class _MomentElement(FiniteElement):
    """Vector-valued element defined by span + moment dofs."""

    mapping = "contravariant"

    def __init__(self, cell, degree):
        if isinstance(cell, str):
            cell = by_name(cell)
        self.cell = cell
        self.degree = int(degree)
        self.value_shape = (cell.dim,)
        self._build()

    # subclasses define: _span_terms() -> list of fn(x)->(dim,) callables
    #                    _dof_functionals() -> list of fn(phi)->float
    def _build(self):
        terms = self._span_terms()
        dofs = self._dof_functionals()
        n = len(terms)
        assert len(dofs) == n, (len(dofs), n)
        V = np.zeros((n, n))
        for i, ell in enumerate(dofs):
            for j, t in enumerate(terms):
                V[i, j] = ell(t)
        self._coeffs = np.linalg.inv(V)        # basis_i = sum_j C[j,i] t_j
        self._terms = terms
        self._dofs = dofs
        self.nodes = np.zeros((n, self.cell.dim))   # (dof points n/a)

    def dual_quadrature(self):
        """Zero-padded quadrature representation of the dual basis:
        (pts (ndof, nqmax, tdim), wvec (ndof, nqmax, vdim)) with
        ell_i(u) = sum_q wvec[i,q,:] . u(pts[i,q,:]).  Feeds
        dual-evaluation interpolation (reference: TSFC dual evaluation
        over FIAT functional pt_dicts, interpolation.py:209)."""
        dofs = self._dofs
        assert all(isinstance(d, _PtVecDual) for d in dofs)
        nq = max(len(d.pts) for d in dofs)
        tdim = self.cell.dim
        vdim = self.value_shape[0]
        pts = np.zeros((len(dofs), nq, tdim))
        wts = np.zeros((len(dofs), nq, vdim))
        for i, d in enumerate(dofs):
            pts[i, :len(d.pts)] = d.pts
            wts[i, :len(d.wvec)] = d.wvec
        return pts, wts

    @property
    def ndof(self):
        return len(self._terms)

    def tabulate(self, points, order=1):
        pts = np.asarray(points, dtype=float)
        nq = len(pts)
        n = self.ndof
        d = self.cell.dim
        vals = np.zeros((nq, n, d))
        tvals = np.stack([np.array([t(p) for p in pts])
                          for t in self._terms], axis=1)  # (nq, n, d)
        vals = np.einsum("qjd,ji->qid", tvals, self._coeffs)
        out = {0: vals}
        if order >= 1:
            h = 1e-6
            grads = np.zeros((nq, n, d, d))
            for ax in range(d):
                pp = pts.copy()
                pp[:, ax] += h
                pm = pts.copy()
                pm[:, ax] -= h
                tp = np.stack([np.array([t(p) for p in pp])
                               for t in self._terms], axis=1)
                tm = np.stack([np.array([t(p) for p in pm])
                               for t in self._terms], axis=1)
                fd = (tp - tm) / (2 * h)
                grads[:, :, :, ax] = np.einsum("qjd,ji->qid", fd,
                                               self._coeffs)
            out[1] = grads
        return out

    def entity_permutation(self, dim, orientation):
        # single dof per facet: identity permutation; signs handled by
        # FunctionSpaceData via facet_dof_signs
        ed = self.entity_dofs.get(dim, {})
        n = len(ed.get(0, []))
        return np.arange(n, dtype=np.int32)

    def local_facet_sign(self, lf: int) -> float:
        """+-1: does the STORED local-facet vertex order induce the same
        direction (normal for HDiv / tangent for HCurl) as the cell's
        outward dof direction?  Composed with the orientation parity this
        gives the global continuity sign."""
        cell = self.cell
        pts = cell.vertices[list(cell.facets[lf])]
        nref = cell.facet_reference_normals[lf]
        if getattr(self, "continuity", "HDiv") == "HCurl":
            t_used = np.array([-nref[1], nref[0]])
            return float(np.sign(np.dot(pts[1] - pts[0], t_used)))
        if cell.dim == 2:
            t = pts[1] - pts[0]
            n_order = np.array([t[1], -t[0]])
            return float(np.sign(np.dot(n_order, nref)))
        n_order = np.cross(pts[1] - pts[0], pts[2] - pts[0])
        return float(np.sign(np.dot(n_order, nref)))

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.cell.name == other.cell.name
                and self.degree == other.degree)

    def __hash__(self):
        return hash((type(self).__name__, self.cell.name, self.degree))

    def __repr__(self):
        return f"{type(self).__name__}({self.cell.name!r}, {self.degree})"


def _facet_quad(cell, lf, deg):
    """(points in cell ref coords, weights*|facet scale|, canonical normal,
    tangent basis) for local facet lf."""
    fc = cell.facet_cell
    q = make_quadrature(fc.name, deg)
    A, b = cell.facet_embedding(lf)
    pts = q.points @ A.T + b[None, :]
    scale = cell.facet_area_scale(lf)
    nref = cell.facet_reference_normals[lf]
    return pts, q.weights * scale, nref


def _monomials2(k):
    """Exponent pairs of the P_k monomial basis on the triangle."""
    return [(i, t - i) for t in range(k + 1) for i in range(t + 1)]


def _monomials3(k):
    """Exponent triples of the P_k monomial basis on the tet."""
    return [(i, j, t - i - j) for t in range(k + 1)
            for i in range(t + 1) for j in range(t - i + 1)]


def _face_quad3(cell, lf, deg):
    """Face quadrature for a tet face: (3D points, weights*scale, outward
    normal, 2D parameter points in the LOCAL facet-vertex-order chart)."""
    fc = cell.facet_cell
    q = make_quadrature(fc.name, deg)
    A, b = cell.facet_embedding(lf)
    pts = q.points @ A.T + b[None, :]
    scale = cell.facet_area_scale(lf)
    nref = cell.facet_reference_normals[lf]
    return pts, q.weights * scale, nref, q.points


@lru_cache(maxsize=None)
def _tri_face_transform_tables(k, signed=True):
    """(6, m, m) dof-transform tables B for P_{k-1} moments on a
    triangular face under the 6 vertex-order permutations.

    Convention (matches topology.py cell_entity_orientations): for
    orientation index o with permutation sigma = permutations(range(3))[o],
    canonical vertex j is local vertex sigma[j].  With D(sigma) =
    parity(sigma) * C(sigma), where m_i(canonical coords) =
    sum_j C_ij m_j(local coords), the canonical basis functions are
    phi_loc @ B with B = D^-1 — so LOCAL dof coefficients = B @ canonical
    coefficients, and local element tensors map A_can = B^T A_loc B.
    (Reference role: FIAT/FInAT entity_transformations for H(div) tet
    faces, consumed by firedrake through TSFC.)

    signed=False drops the parity factor: SCALAR face moments (HDivTrace
    on tet faces) see no normal flip, only the chart change."""
    import itertools
    mons = _monomials2(k - 1)
    m = len(mons)
    q = make_quadrature("triangle", max(2 * k, 2))
    S = q.points

    def evalm(pts):
        return np.stack([pts[:, 0] ** a * pts[:, 1] ** b
                         for (a, b) in mons], axis=1)

    Ml = evalm(S)
    mu = np.stack([1 - S[:, 0] - S[:, 1], S[:, 0], S[:, 1]], axis=1)
    out = np.zeros((6, m, m))
    for o, sigma in enumerate(itertools.permutations(range(3))):
        lam_c = mu[:, list(sigma)]
        Sc = lam_c[:, 1:3]
        Mc = evalm(Sc)
        C = np.linalg.lstsq(Ml, Mc, rcond=None)[0].T   # m_i(can)=C_ij m_j
        par = 1.0
        if signed:
            p = list(sigma)
            for i in range(3):
                for j in range(i + 1, 3):
                    if p[i] > p[j]:
                        par = -par
        out[o] = np.linalg.inv(par * C)
    return out


def _legendre01(j, s):
    """Legendre P_j on [0,1] (edge-moment weights: parity (-1)^j under
    s -> 1-s gives clean orientation sign tables)."""
    c = np.zeros(j + 1)
    c[j] = 1.0
    return np.polynomial.legendre.legval(2 * np.asarray(s) - 1, c)


class RaviartThomas(_MomentElement):
    """RT_k: span (P_{k-1})^d + x * hom(P_{k-1}); normal-moment dofs
    against Legendre P_{0..k-1} per facet + interior moments against
    (P_{k-2})^d.  Any degree on triangles; degree 1 on tets (higher-order
    tet FACE moments need matrix-valued entity transformations, not just
    signed permutations — round 2)."""

    family = "Raviart-Thomas"
    continuity = "HDiv"

    def _span_terms(self):
        d = self.cell.dim
        k = self.degree
        terms = []
        if d == 3:
            for (a, b, c) in _monomials3(k - 1):
                for i in range(3):
                    e = np.zeros(3)
                    e[i] = 1.0
                    terms.append(lambda x, e=e, a=a, b=b, c=c:
                                 e * (x[0] ** a * x[1] ** b * x[2] ** c))
            for a in range(k):          # x * hom(P_{k-1}) in 3D
                for b in range(k - a):
                    c = k - 1 - a - b
                    terms.append(lambda x, a=a, b=b, c=c:
                                 np.asarray(x, dtype=float)
                                 * (x[0] ** a * x[1] ** b * x[2] ** c))
            return terms
        for (a, b) in _monomials2(k - 1):
            for i in range(2):
                e = np.zeros(2)
                e[i] = 1.0
                terms.append(lambda x, e=e, a=a, b=b:
                             e * (x[0] ** a * x[1] ** b))
        for a in range(k):             # hom degree k-1: x^a y^(k-1-a)
            b = k - 1 - a
            terms.append(lambda x, a=a, b=b: np.asarray(x, dtype=float)
                         * (x[0] ** a * x[1] ** b))
        return terms

    def _dof_functionals(self):
        cell = self.cell
        k = self.degree
        out = []
        if cell.dim == 3:
            # face normal moments against P_{k-1}(face) monomials in the
            # LOCAL facet-vertex-order chart; cross-cell consistency via
            # entity_transforms (matrix-valued, _tri_face_transform_tables)
            fmons = _monomials2(k - 1)
            for lf in range(len(cell.facets)):
                pts, wts, nref, s2 = _face_quad3(cell, lf, 2 * k + 2)
                for (a, b) in fmons:
                    m = s2[:, 0] ** a * s2[:, 1] ** b
                    out.append(_PtVecDual(
                        pts, (wts * m)[:, None] * nref[None, :]))
            if k >= 2:
                q = make_quadrature(cell.name, 2 * k + 2)
                for (a, b, c) in _monomials3(k - 2):
                    m = (q.points[:, 0] ** a * q.points[:, 1] ** b
                         * q.points[:, 2] ** c)
                    for i in range(3):
                        e = np.zeros(3)
                        e[i] = 1.0
                        out.append(_PtVecDual(
                            q.points, (q.weights * m)[:, None]
                            * e[None, :]))
            return out
        for lf in range(len(cell.facets)):
            pts, wts, nref = _facet_quad(cell, lf, 2 * k + 2)
            fverts = cell.vertices[list(cell.facets[lf])]
            dvec = fverts[1] - fverts[0]
            s = ((pts - fverts[0]) @ dvec) / (dvec @ dvec)
            for j in range(k):
                out.append(_PtVecDual(
                    pts, (wts * _legendre01(j, s))[:, None]
                    * nref[None, :]))
        if k >= 2:
            q = make_quadrature(cell.name, 2 * k + 2)
            for (a, b) in _monomials2(k - 2):
                m = q.points[:, 0] ** a * q.points[:, 1] ** b
                for i in range(2):
                    e = np.zeros(2)
                    e[i] = 1.0
                    out.append(_PtVecDual(
                        q.points,
                        (q.weights * m)[:, None] * e[None, :]))
        return out

    @property
    def entity_dofs(self):
        cell = self.cell
        k = self.degree
        npe = k * (k + 1) // 2 if cell.dim == 3 else k
        ed = {d: {e: [] for e in range(len(cell.topology[d]))}
              for d in cell.topology}
        for lf in range(len(cell.facets)):
            ed[cell.dim - 1][lf] = list(range(npe * lf, npe * (lf + 1)))
        nfacet = npe * len(cell.facets)
        ed[cell.dim][0] = list(range(nfacet, self.ndof))
        return ed

    @property
    def has_dof_transforms(self):
        """True when cross-cell dof consistency needs matrix (not just
        sign) entity transformations: multi-moment tet faces."""
        return self.cell.dim == 3 and self.degree >= 2

    def entity_transforms(self, d):
        """(n_orientations, npe, npe) local<-canonical dof-coefficient
        transform per entity orientation, or None for identity/sign
        entities.  The data layer composes these with local_facet_sign
        into per-cell block matrices."""
        if self.cell.dim == 3 and d == 2 and self.degree >= 2:
            return _tri_face_transform_tables(self.degree)
        return None

    def facet_dof_signs(self, orientation):
        import itertools
        nv = len(list(self.cell.facets[0]))
        perms = list(itertools.permutations(range(nv)))
        p = list(perms[orientation])
        par = 1.0
        for i in range(len(p)):
            for j in range(i + 1, len(p)):
                if p[i] > p[j]:
                    par = -par
        if self.cell.dim == 3:
            return np.array([par])
        if par > 0:
            return np.ones(self.degree)
        # reversed edge: normal flips (every moment) x Legendre parity
        return np.array([-((-1.0) ** j) for j in range(self.degree)])

    @property
    def facet_dof_sign_flip(self):
        """True: facet dofs flip sign under facet orientation reversal.
        False when matrix entity transforms handle consistency instead
        (multi-moment tet faces) — the two paths must not compose."""
        return not self.has_dof_transforms


class BrezziDouglasMarini(_MomentElement):
    """BDM_k: span (P_k)^d; facet normal moments against P_k(facet)
    (Legendre on edges, local-chart monomials on tet faces with matrix
    entity transforms), interior dofs by greedy rank completion over
    (P_{k-1})^d moments."""

    family = "Brezzi-Douglas-Marini"
    continuity = "HDiv"

    def _span_terms(self):
        k = self.degree
        terms = []
        if self.cell.dim == 3:
            for (a, b, c) in _monomials3(k):
                for i in range(3):
                    e = np.zeros(3)
                    e[i] = 1.0
                    terms.append(lambda x, e=e, a=a, b=b, c=c:
                                 e * (x[0] ** a * x[1] ** b * x[2] ** c))
            return terms
        for (a, b) in _monomials2(k):
            for i in range(2):
                e = np.zeros(2)
                e[i] = 1.0
                terms.append(lambda x, e=e, a=a, b=b:
                             e * (x[0] ** a * x[1] ** b))
        return terms

    def _greedy_complete(self, out, cands):
        """Rank-complete the dual basis: any unisolvent completion spans
        the same space (Galerkin solutions are basis-independent)."""
        terms = self._span_terms()
        rows = [np.array([ell(t) for t in terms]) for ell in out]
        for ell in cands:
            if len(rows) == len(terms):
                break
            r = np.array([ell(t) for t in terms])
            trial = np.vstack(rows + [r])
            if np.linalg.matrix_rank(trial, tol=1e-10) == len(trial):
                rows.append(r)
                out.append(ell)
        assert len(out) == len(terms), "BDM completion failed"
        return out

    def _dof_functionals(self):
        """Edge normal moments vs Legendre P_{0..k} (2D) / face normal
        moments vs P_k(face) local-chart monomials (3D, consistency via
        matrix entity transforms); interior completion by GREEDY RANK
        COMPLETION over (P_{k-1})^d moment candidates."""
        cell = self.cell
        k = self.degree
        out = []
        if cell.dim == 3:
            fmons = _monomials2(k)
            for lf in range(len(cell.facets)):
                pts, wts, nref, s2 = _face_quad3(cell, lf, 2 * k + 2)
                for (a, b) in fmons:
                    m = s2[:, 0] ** a * s2[:, 1] ** b
                    out.append(_PtVecDual(
                        pts, (wts * m)[:, None] * nref[None, :]))
            cands = []
            q = make_quadrature(cell.name, 2 * k + 2)
            for (a, b, c) in _monomials3(k - 1):
                m = (q.points[:, 0] ** a * q.points[:, 1] ** b
                     * q.points[:, 2] ** c)
                for i in range(3):
                    e = np.zeros(3)
                    e[i] = 1.0
                    cands.append(_PtVecDual(
                        q.points, (q.weights * m)[:, None] * e[None, :]))
            return self._greedy_complete(out, cands)
        for lf in range(len(cell.facets)):
            pts, wts, nref = _facet_quad(cell, lf, 2 * k + 2)
            fverts = cell.vertices[list(cell.facets[lf])]
            dvec = fverts[1] - fverts[0]
            s = ((pts - fverts[0]) @ dvec) / (dvec @ dvec)
            for j in range(k + 1):
                out.append(_PtVecDual(
                    pts, (wts * _legendre01(j, s))[:, None]
                    * nref[None, :]))
        n_int = (k + 1) * (k + 2) - 3 * (k + 1)
        if n_int:
            q = make_quadrature(cell.name, 2 * k + 2)
            cands = []
            for (a, b) in _monomials2(k - 1):
                m = q.points[:, 0] ** a * q.points[:, 1] ** b
                for i in range(2):
                    e = np.zeros(2)
                    e[i] = 1.0
                    cands.append(_PtVecDual(
                        q.points, (q.weights * m)[:, None] * e[None, :]))
            out = self._greedy_complete(out, cands)
        return out

    @property
    def entity_dofs(self):
        cell = self.cell
        k = self.degree
        npe = ((k + 1) * (k + 2) // 2 if cell.dim == 3 else k + 1)
        ed = {d: {e: [] for e in range(len(cell.topology[d]))}
              for d in cell.topology}
        for lf in range(len(cell.facets)):
            ed[cell.dim - 1][lf] = list(range(npe * lf, npe * (lf + 1)))
        nfacet = npe * len(cell.facets)
        ed[cell.dim][0] = list(range(nfacet, self.ndof))
        return ed

    @property
    def has_dof_transforms(self):
        """Tet faces always carry >= 3 P_k moments: matrix transforms."""
        return self.cell.dim == 3

    def entity_transforms(self, d):
        if self.cell.dim == 3 and d == 2:
            # P_k face moments = the (k+1)-parameter tables
            return _tri_face_transform_tables(self.degree + 1)
        return None

    @property
    def facet_dof_sign_flip(self):
        return not self.has_dof_transforms

    def entity_permutation(self, dim, orientation):
        # Legendre moments: edge reversal changes SIGNS, never the order
        ed = self.entity_dofs.get(dim, {})
        return np.arange(len(ed.get(0, [])), dtype=np.int32)

    def facet_dof_signs(self, orientation):
        """Per-facet-dof sign under facet orientation (0: canonical):
        normal flip x Legendre parity (-1)^j."""
        if orientation == 0:
            return np.ones(self.degree + 1)
        return np.array([-((-1.0) ** j) for j in range(self.degree + 1)])


class BrezziDouglasFortinMarini(_MomentElement):
    """BDFM_2 on triangles: span {v in (P_2)^2 : v.n|_e in P_1(e)}
    — the quadratic edge-normal Legendre mode of each edge constrained
    away from (P_2)^2, dim 12 - 3 = 9.  Dofs: per-edge normal moments
    against Legendre P_0, P_1 (6, single-valued -> H(div) conforming)
    plus three cell-interior tangential edge means
    l_e(v) = int_0^1 v(x(s)) . (v1 - v0) ds / |v1 - v0|^2.

    Reference: firedrake FunctionSpace(mesh, "BDFM", 2) resolves to
    FIAT's BDFM (exercised by
    tests/firedrake/regression/test_bubble.py test_BDFM); the span
    constraint is the element's defining property (Brezzi-Douglas-
    Fortin-Marini 1987), built here numerically as the SVD nullspace
    of the three quadratic-Legendre edge-normal moment functionals."""

    family = "Brezzi-Douglas-Fortin-Marini"
    continuity = "HDiv"

    def __init__(self, cell, degree):
        if int(degree) != 2:
            raise NotImplementedError("BDFM is defined for degree 2")
        if isinstance(cell, str):
            cell = by_name(cell)
        if cell.dim != 2:
            raise NotImplementedError("BDFM: triangles only")
        super().__init__(cell, degree)

    def _edge_chart(self, lf, deg=8):
        """(pts, wts, nref, s, dvec) for local edge lf: cell-coord
        quadrature points, weights*|edge scale|, reference normal,
        [0,1] edge parameter, vertex-order edge vector."""
        cell = self.cell
        pts, wts, nref = _facet_quad(cell, lf, deg)
        fverts = cell.vertices[list(cell.facets[lf])]
        dvec = fverts[1] - fverts[0]
        s = ((pts - fverts[0]) @ dvec) / (dvec @ dvec)
        return pts, wts, nref, s, dvec

    def _span_terms(self):
        cell = self.cell
        raw = []
        for (a, b) in _monomials2(2):
            for i in range(2):
                e = np.zeros(2)
                e[i] = 1.0
                raw.append(lambda x, e=e, a=a, b=b:
                           e * (x[0] ** a * x[1] ** b))
        nfac = len(cell.facets)
        C = np.zeros((nfac, len(raw)))
        for lf in range(nfac):
            pts, wts, nref, s, _ = self._edge_chart(lf)
            leg2 = _legendre01(2, s)
            for j, t in enumerate(raw):
                vals = np.array([t(p) for p in pts])
                C[lf, j] = np.sum(wts * leg2 * (vals @ nref))
        _, sv, VT = np.linalg.svd(C)
        assert (sv > 1e-10).sum() == nfac, "BDFM constraint rank"
        N = VT[nfac:]                                   # (9, 12)
        return [lambda x, r=r, raw=raw:
                sum(c * t(x) for c, t in zip(r, raw)) for r in N]

    def _dof_functionals(self):
        cell = self.cell
        out = []
        for lf in range(len(cell.facets)):
            pts, wts, nref, s, _ = self._edge_chart(lf)
            for j in range(2):
                out.append(_PtVecDual(
                    pts, (wts * _legendre01(j, s))[:, None]
                    * nref[None, :]))
        for lf in range(len(cell.facets)):
            pts, wts, nref, s, dvec = self._edge_chart(lf)
            scale = cell.facet_area_scale(lf)
            tvec = dvec / (dvec @ dvec) / scale
            out.append(_PtVecDual(pts, wts[:, None] * tvec[None, :]))
        return out

    @property
    def entity_dofs(self):
        cell = self.cell
        ed = {d: {e: [] for e in range(len(cell.topology[d]))}
              for d in cell.topology}
        for lf in range(len(cell.facets)):
            ed[1][lf] = [2 * lf, 2 * lf + 1]
        ed[2][0] = list(range(6, 9))
        return ed

    @property
    def has_dof_transforms(self):
        return False

    @property
    def facet_dof_sign_flip(self):
        return True

    def facet_dof_signs(self, orientation):
        """Normal flip x Legendre parity for the two P_0, P_1 edge
        moments (same rule as BDM's -(-1)^j)."""
        if orientation == 0:
            return np.ones(2)
        return np.array([-1.0, 1.0])


class RaviartThomasCubeFace(_MomentElement):
    """RTCF_k on quadrilaterals — the tensor-product Raviart-Thomas
    family (FIAT/FInAT 'RTCF'): x-component spans Q_{k,k-1}, y-component
    Q_{k-1,k} (dim 2k(k+1)); dofs are per-edge normal moments against
    Legendre P_{k-1} plus interior per-component moments (greedy rank
    completion); contravariant Piola.  Reference: firedrake
    FunctionSpace(mesh, 'RTCF', k) via FIAT's RTCF construction
    (exercised by tests/firedrake/regression/test_interior_facets.py)."""

    family = "RTCF"
    continuity = "HDiv"

    def __init__(self, cell, degree):
        if isinstance(cell, str):
            cell = by_name(cell)
        if cell.name != "quadrilateral":
            raise NotImplementedError("RTCF: quadrilaterals only")
        super().__init__(cell, degree)

    def _span_terms(self):
        k = self.degree
        terms = []
        for comp in range(2):
            e = np.zeros(2)
            e[comp] = 1.0
            arange = range(k + 1) if comp == 0 else range(k)
            brange = range(k) if comp == 0 else range(k + 1)
            for a in arange:
                for b in brange:
                    terms.append(lambda x, e=e, a=a, b=b:
                                 e * (x[0] ** a * x[1] ** b))
        return terms

    _greedy_complete = BrezziDouglasMarini._greedy_complete

    def _dof_functionals(self):
        cell = self.cell
        k = self.degree
        out = []
        for lf in range(len(cell.facets)):
            pts, wts, nref = _facet_quad(cell, lf, 2 * k + 2)
            fverts = cell.vertices[list(cell.facets[lf])]
            dvec = fverts[1] - fverts[0]
            s = ((pts - fverts[0]) @ dvec) / (dvec @ dvec)
            for j in range(k):
                out.append(_PtVecDual(
                    pts, (wts * _legendre01(j, s))[:, None]
                    * nref[None, :]))
        if k > 1:
            q = make_quadrature(cell.name, 2 * k + 2)
            cands = []
            for comp in range(2):
                e = np.zeros(2)
                e[comp] = 1.0
                for a in range(k):
                    for b in range(k):
                        m = q.points[:, 0] ** a * q.points[:, 1] ** b
                        cands.append(_PtVecDual(
                            q.points,
                            (q.weights * m)[:, None] * e[None, :]))
            out = self._greedy_complete(out, cands)
        return out

    @property
    def entity_dofs(self):
        cell = self.cell
        k = self.degree
        ed = {d: {e: [] for e in range(len(cell.topology[d]))}
              for d in cell.topology}
        for lf in range(len(cell.facets)):
            ed[1][lf] = list(range(k * lf, k * (lf + 1)))
        ed[2][0] = list(range(4 * k, self.ndof))
        return ed

    def facet_dof_signs(self, orientation):
        if orientation == 0:
            return np.ones(self.degree)
        return np.array([-((-1.0) ** j) for j in range(self.degree)])

    facet_dof_sign_flip = True


class NedelecCubeEdge(_MomentElement):
    """RTCE_k on quadrilaterals — tensor-product Nedelec (FInAT 'RTCE',
    the 90-degree rotation of RTCF_k): x-component Q_{k-1,k},
    y-component Q_{k,k-1}; per-edge tangential Legendre moments +
    interior moments; covariant Piola."""

    family = "RTCE"
    continuity = "HCurl"
    mapping = "covariant"

    def __init__(self, cell, degree):
        if isinstance(cell, str):
            cell = by_name(cell)
        if cell.name != "quadrilateral":
            raise NotImplementedError("RTCE: quadrilaterals only")
        super().__init__(cell, degree)

    def _span_terms(self):
        k = self.degree
        terms = []
        for comp in range(2):
            e = np.zeros(2)
            e[comp] = 1.0
            arange = range(k) if comp == 0 else range(k + 1)
            brange = range(k + 1) if comp == 0 else range(k)
            for a in arange:
                for b in brange:
                    terms.append(lambda x, e=e, a=a, b=b:
                                 e * (x[0] ** a * x[1] ** b))
        return terms

    _greedy_complete = BrezziDouglasMarini._greedy_complete

    def _dof_functionals(self):
        cell = self.cell
        k = self.degree
        out = []
        for lf in range(len(cell.facets)):
            pts, wts, nref = _facet_quad(cell, lf, 2 * k + 2)
            fverts = cell.vertices[list(cell.facets[lf])]
            dvec = fverts[1] - fverts[0]
            s = ((pts - fverts[0]) @ dvec) / (dvec @ dvec)
            tref = np.array([-nref[1], nref[0]])
            for j in range(k):
                out.append(_PtVecDual(
                    pts, (wts * _legendre01(j, s))[:, None]
                    * tref[None, :]))
        if k > 1:
            q = make_quadrature(cell.name, 2 * k + 2)
            cands = []
            for comp in range(2):
                e = np.zeros(2)
                e[comp] = 1.0
                for a in range(k):
                    for b in range(k):
                        m = q.points[:, 0] ** a * q.points[:, 1] ** b
                        cands.append(_PtVecDual(
                            q.points,
                            (q.weights * m)[:, None] * e[None, :]))
            out = self._greedy_complete(out, cands)
        return out

    @property
    def entity_dofs(self):
        return RaviartThomasCubeFace.entity_dofs.fget(self)

    def facet_dof_signs(self, orientation):
        if orientation == 0:
            return np.ones(self.degree)
        return np.array([-((-1.0) ** j) for j in range(self.degree)])

    facet_dof_sign_flip = True


class NedelecFirstKind2D(_MomentElement):
    """N1curl_k on triangles = 90-degree rotation of RT_k: span
    (P_{k-1})^2 + rot(x) hom(P_{k-1}); tangential Legendre moments per
    edge + interior (P_{k-2})^2 moments."""

    family = "Nedelec 1st kind H(curl)"
    continuity = "HCurl"
    mapping = "covariant"

    def _span_terms(self):
        if self.cell.dim != 2:
            raise NotImplementedError("N1curl on triangles only")
        k = self.degree
        terms = []
        for (a, b) in _monomials2(k - 1):
            for i in range(2):
                e = np.zeros(2)
                e[i] = 1.0
                terms.append(lambda x, e=e, a=a, b=b:
                             e * (x[0] ** a * x[1] ** b))
        for a in range(k):             # rot(x) * hom degree k-1
            b = k - 1 - a
            terms.append(lambda x, a=a, b=b:
                         np.array([-x[1], x[0]])
                         * (x[0] ** a * x[1] ** b))
        return terms

    def _dof_functionals(self):
        cell = self.cell
        k = self.degree
        out = []
        for lf in range(len(cell.facets)):
            pts, wts, nref = _facet_quad(cell, lf, 2 * k + 2)
            tang = np.array([-nref[1], nref[0]])
            fverts = cell.vertices[list(cell.facets[lf])]
            dvec = fverts[1] - fverts[0]
            s = ((pts - fverts[0]) @ dvec) / (dvec @ dvec)
            for j in range(k):
                out.append(_PtVecDual(
                    pts, (wts * _legendre01(j, s))[:, None]
                    * tang[None, :]))
        if k >= 2:
            q = make_quadrature(cell.name, 2 * k + 2)
            for (a, b) in _monomials2(k - 2):
                m = q.points[:, 0] ** a * q.points[:, 1] ** b
                for i in range(2):
                    e = np.zeros(2)
                    e[i] = 1.0
                    out.append(_PtVecDual(
                        q.points, (q.weights * m)[:, None] * e[None, :]))
        return out

    entity_dofs = RaviartThomas.entity_dofs
    facet_dof_signs = RaviartThomas.facet_dof_signs
    facet_dof_sign_flip = True


class NedelecFirstKindTet(_MomentElement):
    """N1curl_1 on tetrahedra (the Whitney edge element): span
    (P_0)^3 + {A x : A skew}; one tangential moment per edge, oriented
    by the edge's canonical (sorted global vertex) direction — a cell
    whose listed edge runs the other way contributes with sign -1
    (edge_dof_signs, the H(curl) analogue of facet flux signs)."""

    family = "Nedelec 1st kind H(curl)"
    continuity = "HCurl"
    mapping = "covariant"

    def __init__(self, cell, degree):
        if int(degree) != 1:
            raise NotImplementedError(
                "N1curl on tets: degree 1 (Whitney) for now — higher "
                "degrees need face/interior moments + face transforms")
        super().__init__(cell, degree)

    def _span_terms(self):
        terms = []
        for i in range(3):
            e = np.zeros(3)
            e[i] = 1.0
            terms.append(lambda x, e=e: e)
        skews = [np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 0]]),
                 np.array([[0.0, 0, -1], [0, 0, 0], [1, 0, 0]]),
                 np.array([[0.0, 0, 0], [0, 0, -1], [0, 1, 0]])]
        for S in skews:
            terms.append(lambda x, S=S: S @ np.asarray(x, dtype=float))
        return terms

    def _dof_functionals(self):
        cell = self.cell
        q = make_quadrature("interval", 4)
        s = q.points[:, 0]
        out = []
        for (a, b) in cell.topology[1]:
            va, vb = cell.vertices[int(a)], cell.vertices[int(b)]
            pts = va[None, :] + s[:, None] * (vb - va)[None, :]
            t = vb - va          # unnormalized: dof = int_0^1 u . t ds
            out.append(_PtVecDual(pts, q.weights[:, None] * t[None, :]))
        return out

    @property
    def entity_dofs(self):
        cell = self.cell
        ed = {d: {e: [] for e in range(len(cell.topology[d]))}
              for d in cell.topology}
        for le in range(len(cell.topology[1])):
            ed[1][le] = [le]
        return ed

    facet_dof_sign_flip = False
    edge_dof_sign_flip = True

    def edge_dof_signs(self, orientation):
        """Listed-order tangent vs canonical (sorted) direction."""
        return (np.ones(1) if orientation == 0 else -np.ones(1))

    def entity_permutation(self, dim, orientation):
        n = 1 if dim == 1 else 0
        return np.arange(n, dtype=np.int32)
