"""Lagrange (CG/DG, P/Q) elements with host-side numpy tabulation.

Replaces the FIAT/FInAT Lagrange stack consumed by the reference
(tsfc/fem.py tabulations, firedrake/functionspacedata.py entity dofs).
Basis functions are constructed by inverting a monomial Vandermonde at the
nodal lattice — exact in f64 for the moderate degrees FEM uses.

Dof order convention: grouped by entity (vertices, then edges, then faces,
then cell interior), each entity's internal dofs in lattice order. This makes
``entity_dofs`` contiguous and global numbering a pure offset computation.
"""
from __future__ import annotations

import itertools
import numpy as np
from functools import cached_property, lru_cache

from .finite_element import FiniteElement
from .reference_cell import ReferenceCell, by_name, simplex


# ----------------------------------------------------------------- lattices

def _simplex_multiindices(dim, k):
    """All (dim+1)-tuples of nonneg ints summing to k, lexicographic by
    (i1..idim) — i.e. enumerate the barycentric lattice."""
    if k == 0:
        return [tuple([0] * (dim + 1))]
    out = []
    for rest in itertools.product(range(k + 1), repeat=dim):
        s = sum(rest)
        if s <= k:
            out.append((k - s,) + rest)
    return out


def _tp_multiindices(dim, k):
    """Tensor-product lattice: tuples in {0..k}^dim, lexicographic."""
    return list(itertools.product(range(k + 1), repeat=dim))


def _entity_of_simplex_mi(mi):
    """Support of a barycentric multi-index → the vertex set of the smallest
    containing sub-entity."""
    return tuple(i for i, v in enumerate(mi) if v > 0)


class _PolySet:
    """Monomial polynomial set with Vandermonde-inverted nodal basis."""

    def __init__(self, exponents: np.ndarray, nodes: np.ndarray):
        self.exponents = np.asarray(exponents)          # (nmono, dim)
        self.nodes = np.asarray(nodes, dtype=float)     # (ndof, dim)
        V = self._mono(self.nodes)                      # (ndof, nmono)
        assert V.shape[0] == V.shape[1], (V.shape, "node/poly count mismatch")
        self.coeffs = np.linalg.inv(V)                  # (nmono, ndof)

    def _mono(self, pts, deriv=None):
        pts = np.asarray(pts, dtype=float)
        E = self.exponents                              # (nm, d)
        nm, d = E.shape
        nq = len(pts)
        out = np.ones((nq, nm))
        for ax in range(d):
            e = E[:, ax].copy()
            c = np.ones(nm)
            if deriv is not None:
                for _ in range(deriv.count(ax)):
                    c = c * e
                    e = np.maximum(e - 1, 0)
            # x^e with coefficient c (c may be 0)
            out *= c[None, :] * np.power(pts[:, ax:ax + 1], e[None, :])
        return out

    def tabulate(self, pts, order=1):
        pts = np.asarray(pts, dtype=float)
        d = self.exponents.shape[1]
        tabs = {0: self._mono(pts) @ self.coeffs}
        if order >= 1:
            if d == 0:       # point cell (VertexOnlyMesh): no axes
                g = np.zeros((len(pts), self.coeffs.shape[1], 0))
            else:
                g = np.stack([self._mono(pts, deriv=(ax,)) @ self.coeffs
                              for ax in range(d)], axis=-1)
            tabs[1] = g                                  # (nq, ndof, dim)
        if order >= 2:
            h = np.zeros((len(pts), self.coeffs.shape[1], d, d))
            for a in range(d):
                for b in range(d):
                    h[:, :, a, b] = self._mono(pts, deriv=(a, b)) @ self.coeffs
            tabs[2] = h
        return tabs



def _normalize_variant(variant):
    if variant in (None, "equispaced", "default"):
        return None
    if variant in ("spectral", "gll", "GLL"):
        return "spectral"
    raise ValueError(f"unknown Lagrange variant {variant!r}")


def _lattice_1d(k, variant):
    """k+1 points on [0,1]: equispaced, or Gauss-Lobatto-Legendre for
    variant='spectral' (the reference's FIAT GaussLobattoLegendre
    variant; fixes the ~1.5-orders-per-degree conditioning loss of the
    equispaced lattice at degree >= 5)."""
    if variant != "spectral" or k < 3:
        return np.linspace(0.0, 1.0, k + 1)
    from scipy.special import roots_jacobi
    interior, _ = roots_jacobi(k - 1, 1.0, 1.0)   # roots of P_k'
    return np.concatenate([[0.0], (interior + 1.0) / 2.0, [1.0]])


class Lagrange(FiniteElement):
    """Continuous Lagrange on simplices (P_k) and tensor cells (Q_k)."""

    continuous = True

    @property
    def embedded_superdegree(self):
        """Max TOTAL polynomial degree of the span (tensor-product cells
        exceed their per-axis degree: Q_k spans x^k y^k).  Drives
        quadrature estimation (ufl's degree estimation analogue)."""
        n_factors = {"quadrilateral": 2, "hexahedron": 3,
                     "prism": 2}.get(self.cell.name, 1)
        return self.degree * n_factors

    def __init__(self, cell, degree: int, variant=None):
        if isinstance(cell, str):
            cell = by_name(cell)
        if degree < 1 and self.continuous:
            raise ValueError("CG requires degree >= 1")
        self.cell = cell
        self.degree = int(degree)
        self.variant = _normalize_variant(variant)
        if variant is None and cell.name in ("interval", "quadrilateral",
                                             "hexahedron"):
            # reference default: FIAT Lagrange on tensor-product cells
            # places nodes at GLL points when no variant is requested —
            # a GLL collocation rule then lumps the mass matrix exactly
            # (reference tests/firedrake/regression/test_mass_lumping.py)
            self.variant = "spectral"
        self.family = ("Lagrange" if self.continuous
                       else "Discontinuous Lagrange")
        self._build()

    # -------------------------------------------------------------- layout
    def _lattice(self):
        """Returns (nodes, entity_assoc) where entity_assoc[i] = (dim, local
        entity id, internal key used for ordering)."""
        cell, k = self.cell, self.degree
        d = cell.dim
        nodes, assoc = [], []
        if cell.name in ("interval", "triangle", "tetrahedron", "point"):
            mis = _simplex_multiindices(d, max(k, 1)) if k > 0 else None
            if k == 0:
                nodes.append(cell.vertices.mean(axis=0))
                assoc.append((d, 0, ()))
            else:
                g1 = _lattice_1d(k, getattr(self, "variant", None))
                for mi in mis:
                    # warped barycentric lattice: on every sub-entity this
                    # restricts to the (normalized, symmetric) 1D rule, so
                    # neighbouring cells agree on shared-entity nodes
                    b = g1[np.array(mi)]
                    pt = ((b / b.sum())[None, :] @ cell.vertices).ravel()
                    support = _entity_of_simplex_mi(mi)
                    edim, eid = self._find_entity(support)
                    # internal key: barycentric weights restricted to the
                    # entity's vertices, in the entity's canonical local
                    # vertex order
                    everts = tuple(cell.topology[edim][eid])
                    key = tuple(mi[v] for v in everts)
                    nodes.append(pt)
                    assoc.append((edim, eid, key))
        elif cell.name == "prism":
            if k == 0:
                nodes.append(cell.vertices.mean(axis=0))
                assoc.append((d, 0, ()))
            else:
                # tensor lattice: tri barycentric x interval
                g1 = _lattice_1d(k, getattr(self, "variant", None))
                for mi in _simplex_multiindices(2, k):
                    b = g1[np.array(mi)]
                    b = b / b.sum()
                    for mz in range(k + 1):
                        pt = np.array([b[1], b[2], g1[mz]])
                        tri_support = _entity_of_simplex_mi(mi)
                        zpos = (0 if mz == 0 else
                                (1 if mz == k else None))
                        edim, eid, key = self._prism_entity(
                            tri_support, zpos, mi, mz, k)
                        nodes.append(pt)
                        assoc.append((edim, eid, key))
        elif cell.name in ("quadrilateral", "hexahedron"):
            if k == 0:
                nodes.append(cell.vertices.mean(axis=0))
                assoc.append((d, 0, ()))
            else:
                g1 = _lattice_1d(k, getattr(self, "variant", None))
                for mi in _tp_multiindices(d, k):
                    pt = g1[np.array(mi)]
                    # which sub-entity: per-axis, is coordinate on a wall?
                    onwall = [0 if m == 0 else (1 if m == k else None)
                              for m in mi]
                    free = [ax for ax, w in enumerate(onwall) if w is None]
                    edim = len(free)
                    eid = self._tp_entity_id(onwall, free)
                    if 0 < edim < d:
                        # one weight per listed entity vertex (the tensor
                        # analogue of barycentric keys) so orientation
                        # permutations act by re-indexing components
                        everts = cell.topology[edim][eid]
                        key = tuple(
                            int(np.prod([(k - mi[ax])
                                         if cell.vertices[v][ax] < 0.5
                                         else mi[ax] for ax in free]))
                            for v in everts)
                    else:
                        key = tuple(mi[ax] for ax in free)
                    nodes.append(pt)
                    assoc.append((edim, eid, key))
        else:
            raise NotImplementedError(cell.name)
        return np.array(nodes).reshape(len(nodes), d), assoc

    def _prism_entity(self, tri_support, zpos, mi, mz, k):
        """Classify a prism lattice point.  tri_support: vertex ids of the
        triangle sub-entity; zpos: 0 bottom, 1 top, None interior."""
        cell = self.cell
        ts = tuple(sorted(tri_support))
        if len(ts) == 1 and zpos is not None:
            v = ts[0] + 3 * zpos
            return 0, v, ()
        if len(ts) == 2 and zpos is not None:
            # horizontal edge: find prism edge with vertex set
            want = {ts[0] + 3 * zpos, ts[1] + 3 * zpos}
            for eid, evs in enumerate(cell.topology[1]):
                if set(int(x) for x in evs) == want:
                    # key: lattice position along the edge in listed order
                    a, b = int(evs[0]) % 3, int(evs[1]) % 3
                    key = (mi[1:][a] if a < 2 else mi[0],)
                    # use barycentric wrt listed order (a first)
                    bary = {0: mi[0], 1: mi[1], 2: mi[2]}
                    key = (bary[a], bary[b])
                    return 1, eid, key
            raise RuntimeError("edge not found")
        if len(ts) == 1 and zpos is None:
            # vertical edge above tri vertex ts[0]: edges 6,7,8
            return 1, 6 + ts[0], (k - mz, mz)
        if len(ts) == 3 and zpos is not None:
            # triangle face (id == zpos): full barycentric key per listed
            # face vertex so S3 orientations act by component re-indexing
            fvs = cell.topology[2][zpos]
            return 2, zpos, tuple(int(mi[int(v) % 3])
                                  for v in fvs if v >= 0)
        if len(ts) == 2 and zpos is None:
            # quad side face above tri edge: hex-style product weights
            # (edge barycentric x layer weight), one per listed vertex,
            # so S4's realizable (dihedral) orientations permute them
            want = {ts[0], ts[1], ts[0] + 3, ts[1] + 3}
            for fid, fvs in enumerate(cell.topology[2]):
                if set(int(x) for x in fvs if x >= 0) == want:
                    key = tuple(int(mi[int(v) % 3]
                                    * (k - mz if v < 3 else mz))
                                for v in fvs if v >= 0)
                    return 2, fid, key
            raise RuntimeError("face not found")
        return 3, 0, (mi[1], mi[2], mz)

    def _find_entity(self, support):
        cell = self.cell
        for edim in sorted(cell.topology):
            for eid, verts in enumerate(cell.topology[edim]):
                if set(support) == set() and edim == cell.dim:
                    return edim, eid
                if set(support) == set(int(v) for v in verts):
                    return edim, eid
        raise RuntimeError(f"no entity for support {support}")

    def _tp_entity_id(self, onwall, free):
        """Map wall pattern to our quad/hex topology entity ids."""
        cell = self.cell
        fixed = [(ax, w) for ax, w in enumerate(onwall) if w is not None]
        # a sub-entity of a TP cell = set of vertices matching the walls
        verts = []
        for vid, v in enumerate(cell.vertices):
            ok = all(abs(v[ax] - w) < 1e-12 for ax, w in fixed)
            if ok:
                verts.append(vid)
        target = set(verts)
        edim = len(free)
        for eid, evs in enumerate(cell.topology[edim]):
            if set(int(x) for x in evs) == target:
                return eid
        raise RuntimeError("entity not found")

    def _build(self):
        cell, k = self.cell, self.degree
        raw_nodes, assoc = self._lattice()
        if not self.continuous:
            # all dofs attached to the cell interior, but in the SAME
            # node order as the continuous element: DG_k node i sits at
            # CG_k node i.  The vertex-based limiter, the DG-coordinate
            # fill of periodic meshes, and BrokenElement(CG) all rely on
            # this (round-5 fix: the raw lattice order put triangle DG1
            # nodes at v0, v2, v1, which mirrored every periodic-mesh
            # coordinate chart and broke dS facet geometry)
            order = sorted(range(len(raw_nodes)),
                           key=lambda i: (assoc[i][0], assoc[i][1],
                                          assoc[i][2]))
            self.nodes = raw_nodes[order]
            self.entity_dofs = {d: {e: [] for e in range(len(cell.topology[d]))}
                                for d in cell.topology}
            self.entity_dofs[cell.dim][0] = list(range(len(raw_nodes)))
            self._entity_internal_keys = None
        else:
            # sort dofs: by (entity_dim, entity_id, internal key)
            order = sorted(range(len(raw_nodes)),
                           key=lambda i: (assoc[i][0], assoc[i][1],
                                          assoc[i][2]))
            self.nodes = raw_nodes[order]
            self.entity_dofs = {d: {e: [] for e in range(len(cell.topology[d]))}
                                for d in cell.topology}
            keys = {}
            for new_i, old_i in enumerate(order):
                edim, eid, key = assoc[old_i]
                self.entity_dofs[edim][eid].append(new_i)
                keys.setdefault((edim, eid), []).append(key)
            self._entity_internal_keys = keys
        # polynomial set
        if cell.name == "prism":
            if k == 0:
                expo = np.zeros((1, 3), dtype=int)
            else:
                expo = np.array([[mi[1], mi[2], mz]
                                 for mi in _simplex_multiindices(2, k)
                                 for mz in range(k + 1)])
        elif cell.name in ("interval", "triangle", "tetrahedron"):
            if k == 0:
                expo = np.zeros((1, cell.dim), dtype=int)
            else:
                expo = np.array([mi[1:] for mi in
                                 _simplex_multiindices(cell.dim, k)])
        else:
            expo = np.array(_tp_multiindices(cell.dim, max(k, 0)))
            if k == 0:
                expo = np.zeros((1, cell.dim), dtype=int)
        self._polyset = _PolySet(expo, self.nodes)

    # ------------------------------------------------------------ tabulate
    def tabulate(self, points, order=1):
        return self._polyset.tabulate(points, order)

    # ------------------------------------------------- orientation algebra
    @lru_cache(maxsize=None)
    def entity_permutation(self, dim: int, orientation: int, entity=0):
        """Permutation p of an entity's internal dofs under orientation.

        ``orientation`` indexes the permutation sigma of the entity's
        vertices (itertools.permutations order): the cell sees the entity's
        canonical vertex c_j at its local position sigma(j)...  Concretely:
        if the entity's canonical internal dof t sits at barycentric key
        kappa_t (w.r.t. canonical vertex order), then the cell-local slot k
        whose key (w.r.t. the cell's local vertex order) equals kappa_t
        permuted by sigma maps to t:  p[k] = t.

        ``entity`` selects the representative entity — needed on cells
        with heterogeneous entity classes (a prism's dim-2 entities are
        two triangles and three quads, with different dof counts AND
        different symmetric groups)."""
        if not self.continuous:
            return np.arange(0)
        cell = self.cell
        dofs = (self.entity_dofs[dim][entity]
                if self.entity_dofs[dim] else [])
        n = len(dofs)
        if n == 0:
            return np.arange(0)
        if dim > 0:
            row = np.asarray(cell.topology[dim][entity])
            nv = int((row >= 0).sum())
        else:
            nv = 1
        sigma = list(itertools.permutations(range(nv)))[orientation]
        keys = self._entity_internal_keys[(dim, entity)]
        # local slot k has key keys[k] in local vertex order; its key in
        # canonical order is keys[k] re-indexed by sigma:
        # canonical component j = local component sigma[j]
        canon_keys = {tuple(k): i for i, k in enumerate(keys)}
        p = np.empty(n, dtype=np.int32)
        for k in range(n):
            kk = keys[k]
            ck = tuple(kk[sigma[j]] for j in range(nv))
            if ck not in canon_keys:
                # geometrically unrealizable vertex permutation (e.g. a
                # non-dihedral element of S4 on a quad face): the
                # orientation table is built for all |S_nv| entries but
                # meshes only index realizable ones
                return np.arange(n, dtype=np.int32)
            p[k] = canon_keys[ck]
        return p

    @staticmethod
    def num_orientations(entity_nverts: int) -> int:
        import math
        return math.factorial(entity_nverts)


class Bubble(FiniteElement):
    """Interior bubble on a simplex: b = c * prod(barycentric coords),
    one cell-interior dof (value 1 at the centroid).  Reference: FIAT
    Bubble (family "B"/"Bubble"), the enrichment of the MINI Stokes
    element (reference tests/firedrake/regression/test_stokes_mini.py).
    Degree is dim+1 (the minimal bubble); tabulation is analytic —
    barycentrics are affine so all derivative products are cheap."""

    continuous = True
    family = "Bubble"

    def __init__(self, cell, degree=None):
        if isinstance(cell, str):
            cell = by_name(cell)
        if cell.name not in ("interval", "triangle", "tetrahedron"):
            raise NotImplementedError(f"Bubble on {cell.name!r}")
        d = cell.dim
        if degree is not None and int(degree) != d + 1:
            raise NotImplementedError(
                f"Bubble degree {degree} on {cell.name} (minimal bubble "
                f"degree is {d + 1})")
        self.cell = cell
        self.degree = d + 1
        self.value_shape = ()
        self.nodes = cell.vertices.mean(axis=0)[None, :]
        # barycentric gradients: lambda_0 = 1 - sum(x), lambda_i = x_i
        G = np.vstack([-np.ones((1, d)), np.eye(d)])     # (d+1, d)
        self._G = G
        self._scale = float((d + 1) ** (d + 1))

    embedded_superdegree = property(lambda self: self.degree)

    @property
    def entity_dofs(self):
        ed = {dd: {e: [] for e in range(len(self.cell.topology[dd]))}
              for dd in self.cell.topology}
        ed[self.cell.dim][0] = [0]
        return ed

    def _bary(self, pts):
        pts = np.asarray(pts, dtype=float)
        lam0 = 1.0 - pts.sum(axis=1, keepdims=True)
        return np.concatenate([lam0, pts], axis=1)       # (nq, d+1)

    def tabulate(self, points, order=1):
        pts = np.asarray(points, dtype=float)
        d = self.cell.dim
        lam = self._bary(pts)                            # (nq, d+1)
        c = self._scale
        nq = len(pts)
        tabs = {0: (c * lam.prod(axis=1))[:, None]}
        if order >= 1:
            g = np.zeros((nq, 1, d))
            for j in range(d + 1):
                others = np.delete(lam, j, axis=1).prod(axis=1)
                g[:, 0, :] += others[:, None] * self._G[j][None, :] * c
            tabs[1] = g
        if order >= 2:
            h = np.zeros((nq, 1, d, d))
            for j in range(d + 1):
                for k in range(d + 1):
                    if j == k:
                        continue
                    rest = np.delete(lam, (min(j, k), max(j, k)),
                                     axis=1).prod(axis=1)
                    h[:, 0] += (rest[:, None, None]
                                * np.einsum("a,b->ab", self._G[j],
                                            self._G[k])[None] * c)
            tabs[2] = h
        return tabs

    def entity_permutation(self, dim, orientation, entity=0):
        n = len(self.entity_dofs.get(dim, {}).get(entity, []))
        return np.arange(n, dtype=np.int32)

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.cell.name == other.cell.name)

    def __hash__(self):
        return hash(("Bubble", self.cell.name))

    def __repr__(self):
        return f"Bubble({self.cell.name!r})"


class NodalEnriched(FiniteElement):
    """Nodal enrichment: span(sub_1 + ... + sub_n) re-nodalized at the
    union of the sub-elements' nodes (reference: FIAT
    NodalEnrichedElement; ufl EnrichedElement, the `P1 + B` MINI
    spelling in tests/firedrake/regression/test_stokes_mini.py:12).
    The raw concatenated basis is re-nodalized by inverting the
    point-evaluation Vandermonde so point interpolation stays exact."""

    continuous = True

    def __init__(self, *subs):
        cells = {s.cell.name for s in subs}
        if len(cells) != 1:
            raise ValueError(f"enrichment across cells {cells}")
        if any(s.value_shape for s in subs):
            raise NotImplementedError("enrichment of non-scalar elements")
        self.subs = tuple(subs)
        self.cell = subs[0].cell
        self.degree = max(s.degree for s in subs)
        self.family = "NodalEnriched(" + "+".join(
            s.family for s in subs) + ")"
        self.value_shape = ()
        self.nodes = np.concatenate([np.asarray(s.nodes) for s in subs],
                                    axis=0)
        # raw basis -> nodal basis: A = V^-1 with V[i, j] = phi_j(z_i)
        V = np.concatenate(
            [s.tabulate(self.nodes, order=0)[0] for s in subs], axis=1)
        if abs(np.linalg.det(V)) < 1e-12:
            raise ValueError("enriched element is not unisolvent at the "
                             "union of sub-element nodes")
        self._A = np.linalg.inv(V)                       # (nraw, ndof)
        # merged entity dofs (sub order preserves entity grouping for
        # the standard vertex-elements + interior-bubble case)
        ed = {d: {e: [] for e in range(len(self.cell.topology[d]))}
              for d in self.cell.topology}
        off = 0
        for s in subs:
            for d, ents in s.entity_dofs.items():
                for e, dofs in ents.items():
                    ed[d][e].extend(off + k for k in dofs)
            off += s.ndof
        self.entity_dofs = ed

    @property
    def embedded_superdegree(self):
        return max(getattr(s, "embedded_superdegree", s.degree)
                   for s in self.subs)

    def tabulate(self, points, order=1):
        raws = [s.tabulate(points, order) for s in self.subs]
        out = {}
        for k in raws[0]:
            raw = np.concatenate([r[k] for r in raws], axis=1)
            out[k] = np.einsum("qj...,ji->qi...", raw, self._A)
        return out

    def entity_permutation(self, dim, orientation, entity=0):
        dofs = self.entity_dofs.get(dim, {}).get(entity, [])
        if len(dofs) <= 1:
            return np.arange(len(dofs), dtype=np.int32)
        raise NotImplementedError(
            "NodalEnriched orientation algebra with multi-dof entities")

    def __eq__(self, other):
        return type(self) is type(other) and self.subs == other.subs

    def __hash__(self):
        return hash(("NodalEnriched",) + tuple(hash(s) for s in self.subs))

    def __repr__(self):
        return f"NodalEnriched{self.subs!r}"


class DiscontinuousLagrange(Lagrange):
    continuous = False

    def __init__(self, cell, degree, variant=None):
        if isinstance(cell, str):
            cell = by_name(cell)
        self.cell = cell
        self.degree = int(degree)
        self.variant = _normalize_variant(variant)
        if variant is None and cell.name in ("interval", "quadrilateral",
                                             "hexahedron"):
            self.variant = "spectral"     # DQ default, as for Q (FIAT)
        self.family = "Discontinuous Lagrange"
        self._build()


class Real(FiniteElement):
    """The global-constant element: ONE dof shared by every cell.

    Reference: firedrake RealFunctionSpace (functionspaceimpl.py:1175,
    ufl 'Real' family) — the global Lagrange-multiplier space used e.g.
    to pin the mean of a pure-Neumann Poisson solve.  The numbering
    layer maps every cell to the single global dof
    (functionspace.py FunctionSpaceData special case)."""

    family = "Real"
    mapping = "identity"
    continuous = True
    ndof = 1
    embedded_superdegree = 0

    def __init__(self, cell, degree: int = 0):
        if isinstance(cell, str):
            cell = by_name(cell)
        self.cell = cell
        self.degree = 0
        self.value_shape = ()
        self.nodes = cell.vertices.mean(axis=0)[None, :]

    @property
    def entity_dofs(self):
        ed = {d: {e: [] for e in range(len(self.cell.topology[d]))}
              for d in self.cell.topology}
        ed[self.cell.dim][0] = [0]
        return ed

    def tabulate(self, points, order=1):
        nq = len(np.asarray(points))
        d = self.cell.dim
        tabs = {0: np.ones((nq, 1))}
        if order >= 1:
            tabs[1] = np.zeros((nq, 1, d))
        if order >= 2:
            tabs[2] = np.zeros((nq, 1, d, d))
        return tabs

    def entity_permutation(self, dim, orientation):
        return np.arange(1, dtype=np.int32)

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.cell.name == other.cell.name)

    def __hash__(self):
        return hash(("Real", self.cell.name))

    def __repr__(self):
        return f"Real({self.cell.name!r})"


@lru_cache(maxsize=None)
def make_scalar_element(cell_name: str, family: str, degree: int,
                        variant=None):
    family = {
        "CG": "Lagrange", "P": "Lagrange", "Lagrange": "Lagrange",
        "Q": "Lagrange",
        "DG": "DG", "DP": "DG", "Discontinuous Lagrange": "DG",
        "DQ": "DG",
        "R": "Real", "Real": "Real",
        "B": "Bubble", "Bubble": "Bubble",
        "RT": "RT", "Raviart-Thomas": "RT", "RTF": "RT",
        "BDM": "BDM", "Brezzi-Douglas-Marini": "BDM",
        "BDFM": "BDFM", "Brezzi-Douglas-Fortin-Marini": "BDFM",
        "N1curl": "N1curl", "Nedelec 1st kind H(curl)": "N1curl",
    }.get(family, family)
    if family == "Lagrange":
        return Lagrange(cell_name, degree, variant=variant)
    if family == "DG":
        return DiscontinuousLagrange(cell_name, degree, variant=variant)
    if family == "Real":
        return Real(cell_name, degree)
    if family == "Bubble":
        return Bubble(cell_name, degree)
    if family == "RT":
        from .hdiv import RaviartThomas
        return RaviartThomas(cell_name, degree)
    if family == "BDM":
        from .hdiv import BrezziDouglasMarini
        return BrezziDouglasMarini(cell_name, degree)
    if family == "BDFM":
        from .hdiv import BrezziDouglasFortinMarini
        return BrezziDouglasFortinMarini(cell_name, degree)
    if family == "RTCF":
        from .hdiv import RaviartThomasCubeFace
        return RaviartThomasCubeFace(cell_name, degree)
    if family == "RTCE":
        from .hdiv import NedelecCubeEdge
        return NedelecCubeEdge(cell_name, degree)
    if family == "N1curl":
        from .hdiv import NedelecFirstKind2D, NedelecFirstKindTet
        if by_name(cell_name).dim == 3:
            return NedelecFirstKindTet(cell_name, degree)
        return NedelecFirstKind2D(cell_name, degree)
    if family in ("HDiv Trace", "HDivT", "DGT", "TraceElement"):
        from .trace import HDivTrace
        return HDivTrace(cell_name, degree)
    raise NotImplementedError(f"element family {family!r}")
