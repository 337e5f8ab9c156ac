"""Tensor-product H(div) elements on prisms — the extruded-mesh flux
spaces (reference: FInAT TensorProductElement + HDivElement wrappers,
finat/tensor_product.py; consumed by firedrake as
HDiv(TensorProductElement(BDM_tri, DG_interval)) in e.g.
demos/extruded_shallow_water/).

The horizontal space is a 2D simplex H(div) element (RT_1/BDM_1), the
vertical a DG Legendre lattice; the product carries ONLY horizontal
vector components (vx, vy, 0) and its normal-flux dofs live on the
three vertical quad facets.  Inter-cell continuity rides the diagonal
sign machinery: on an extruded mesh the vertical direction is globally
consistent (top vertex ids follow bottoms), so the only realizable quad
orientation change is the horizontal edge flip — normal sign times
horizontal Legendre parity (-1)^a, vertical moments never flip.
"""
from __future__ import annotations

import numpy as np

from .reference_cell import by_name
from .hdiv import (_MomentElement, _PtVecDual, _legendre01,
                   RaviartThomas, BrezziDouglasMarini)


def _gauss01(n):
    x, w = np.polynomial.legendre.leggauss(n)
    return (x + 1) / 2, w / 2


class HDivPrism(_MomentElement):
    """HDiv(horiz_2d x DG_m(interval)) on the prism: horizontal flux
    components scaled by vertical Legendre polynomials."""

    continuity = "HDiv"
    mapping = "contravariant"

    def __init__(self, horiz_family, degree, vdegree=0):
        self.horiz_family = horiz_family
        self.vdegree = int(vdegree)
        if horiz_family == "RT":
            self._h2d = RaviartThomas("triangle", degree)
            self._nmom = degree          # RT_k: P_{k-1} edge moments
        elif horiz_family == "BDM":
            self._h2d = BrezziDouglasMarini("triangle", degree)
            self._nmom = degree + 1      # BDM_k: P_k edge moments
        else:
            raise NotImplementedError(
                f"HDiv prism product with {horiz_family!r}")
        if self._h2d.ndof != 3 * self._nmom:
            raise NotImplementedError(
                "HDiv prism products need a facet-moment-only horizontal "
                f"element ({horiz_family}_{degree} has interior dofs)")
        self.family = f"HDiv({horiz_family}{degree} x DG{vdegree})"
        super().__init__("prism", degree)

    def _span_terms(self):
        nv = self.vdegree + 1
        terms = []
        for t2 in self._h2d._span_terms():
            for j in range(nv):
                def t3(x, t2=t2, j=j):
                    h = t2(x[:2])
                    leg = _legendre01(j, np.array([x[2]]))[0]
                    return np.array([h[0] * leg, h[1] * leg, 0.0])
                terms.append(t3)
        return terms

    # quad facets of the prism in stored order [b0, b1, t0, t1]
    _QUAD_FACETS = (2, 3, 4)

    def _facet_frame(self, lf):
        cell = self.cell
        vs = cell.vertices[[v for v in cell.facets[lf] if v >= 0]]
        b0, b1, t0, t1 = vs
        n_order = np.cross(b1 - b0, t0 - b0)
        return b0, b1, t0, t1, n_order

    def _dof_functionals(self):
        nv = self.vdegree + 1
        nq = max(self._nmom, self.vdegree) + 2
        s, ws = _gauss01(nq)
        tau, wt = _gauss01(nq)
        S, T = np.meshgrid(s, tau, indexing="ij")
        W = np.outer(ws, wt).reshape(-1)
        S, T = S.reshape(-1), T.reshape(-1)
        out = []
        for lf in self._QUAD_FACETS:
            b0, b1, t0, t1, n_order = self._facet_frame(lf)
            pts = ((1 - T)[:, None]
                   * ((1 - S)[:, None] * b0 + S[:, None] * b1)
                   + T[:, None]
                   * ((1 - S)[:, None] * t0 + S[:, None] * t1))
            # OUTWARD-directed area-scaled normal (the RT/BDM dof
            # convention: ell = reference surface integral of u . n_out
            # against stored-order Legendre; local_facet_sign then
            # relates stored order to the canonical sorted order)
            n_out = n_order * self.local_facet_sign(lf)
            for a in range(self._nmom):
                la = _legendre01(a, S)
                for j in range(nv):
                    lj = _legendre01(j, T)
                    out.append(_PtVecDual(
                        pts, (W * la * lj)[:, None] * n_out[None, :]))
        return out

    @property
    def entity_dofs(self):
        cell = self.cell
        ed = {d: {e: [] for e in range(len(cell.topology[d]))}
              for d in cell.topology}
        per = self._nmom * (self.vdegree + 1)
        for i, lf in enumerate(self._QUAD_FACETS):
            ed[2][lf] = list(range(per * i, per * (i + 1)))
        ed[3][0] = []
        return ed

    facet_dof_sign_flip = True

    def entity_permutation(self, dim, orientation, entity=None):
        # Legendre moments: orientation changes SIGNS, never the order;
        # sized per entity (tri facets carry no dofs, quads carry all)
        ed = self.entity_dofs.get(dim, {})
        e = entity if entity is not None else 0
        return np.arange(len(ed.get(e, [])), dtype=np.int32)

    def facet_dof_signs(self, orientation, entity=None):
        """Signs under the quad-face orientation code (a 4-permutation
        sigma with view[sigma[j]] == canon[j], topology.py
        cell_entity_orientations).  Horizontal flip iff the stored
        bottom edge (view slots 0, 1) is in descending canonical rank;
        a flip negates the normal AND odd horizontal Legendre moments:
        sign(a, j) = (-1)^(a+1).  Vertical order is globally consistent
        on extruded meshes, so no other code is realizable for faces
        that carry dofs."""
        import itertools
        if entity is not None and entity not in self._QUAD_FACETS:
            return np.zeros(0)
        per = self._nmom * (self.vdegree + 1)
        sigma = list(itertools.permutations(range(4)))[orientation]
        rank = [0] * 4
        for j, p in enumerate(sigma):
            rank[p] = j
        flipped = rank[0] > rank[1]
        signs = np.ones(per)
        if flipped:
            k = 0
            for a in range(self._nmom):
                for j in range(self.vdegree + 1):
                    signs[k] = (-1.0) ** (a + 1)
                    k += 1
        return signs

    def local_facet_sign(self, lf):
        if lf not in self._QUAD_FACETS:
            return 1.0
        cell = self.cell
        _, _, _, _, n_order = self._facet_frame(lf)
        nref = cell.facet_reference_normals[lf]
        return float(np.sign(np.dot(n_order, nref)))

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.horiz_family == other.horiz_family
                and self.degree == other.degree
                and self.vdegree == other.vdegree)

    def __hash__(self):
        return hash((type(self).__name__, self.horiz_family,
                     self.degree, self.vdegree))

    def __repr__(self):
        return (f"HDivPrism({self.horiz_family!r}, {self.degree}, "
                f"vdegree={self.vdegree})")


# ------------------------------------------------- ufl-style spec API
class _ElementSpec:
    """FiniteElement(family, cell, degree): the ufl spec object.  It
    resolves to a concrete element when a FunctionSpace consumes it."""

    def __init__(self, family, cell=None, degree=None, variant=None):
        self.family = family
        self.cell_name = getattr(cell, "name", cell)
        self.degree = degree
        self.variant = variant

    def resolve(self):
        from .lagrange import make_scalar_element
        return make_scalar_element(self.cell_name, self.family,
                                   self.degree, variant=self.variant)

    def __add__(self, other):
        """P1 + B -> the nodal-enriched (MINI-style) element spec
        (reference: ufl EnrichedElement via `+`,
        tests/firedrake/regression/test_stokes_mini.py:12)."""
        return _EnrichedSpec(self, other)

    def __repr__(self):
        return (f"FiniteElement({self.family!r}, {self.cell_name!r}, "
                f"{self.degree})")


class _EnrichedSpec(_ElementSpec):
    def __init__(self, *specs):
        subs = []
        for s in specs:
            subs.extend(s.specs if isinstance(s, _EnrichedSpec) else [s])
        self.specs = tuple(subs)
        self.family = "Enriched"
        self.cell_name = subs[0].cell_name
        self.degree = max(s.degree or 0 for s in subs)
        self.variant = None

    def resolve(self):
        from .lagrange import NodalEnriched
        return NodalEnriched(*[s.resolve() for s in self.specs])

    def __repr__(self):
        return " + ".join(repr(s) for s in self.specs)


def EnrichedElement(*specs):
    return _EnrichedSpec(*specs)


def FiniteElement(family, cell=None, degree=None, variant=None):
    return _ElementSpec(family, cell, degree, variant=variant)


class _TPSpec:
    def __init__(self, a, b):
        self.a, self.b = a, b

    def __repr__(self):
        return f"TensorProductElement({self.a}, {self.b})"


def TensorProductElement(a, b):
    return _TPSpec(a, b)


def HDiv(spec):
    """HDiv(TensorProductElement(simplex_hdiv, interval_dg)) -> the
    prism product element (the firedrake HDivElement wrapper role)."""
    if not isinstance(spec, _TPSpec):
        raise NotImplementedError("HDiv() wraps TensorProductElement")
    a, b = spec.a, spec.b
    fam = {"RT": "RT", "Raviart-Thomas": "RT", "RTF": "RT",
           "BDM": "BDM", "Brezzi-Douglas-Marini": "BDM"}.get(a.family)
    if fam is None or a.cell_name != "triangle":
        raise NotImplementedError(
            f"HDiv product with horizontal {a.family!r} on "
            f"{a.cell_name!r}")
    if b.family not in ("DG", "Discontinuous Lagrange", "DP"):
        raise NotImplementedError(
            f"HDiv product with vertical {b.family!r}")
    return HDivPrism(fam, a.degree, vdegree=b.degree)
