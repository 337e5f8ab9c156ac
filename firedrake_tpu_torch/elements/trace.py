"""Facet trace elements and broken (DG-ized) elements (the port's copy of
``firedrake_tpu/elements/trace.py``; host numpy only, so tables and dof
numberings are bit-equal to the JAX package's).

Reference: FIAT's HDivTrace (used by firedrake hybridization,
slate/static_condensation/hybridization.py:18) and ufl BrokenElement.

* HDivTrace(cell, k): dofs live ON facets; functions are per-facet P_k
  with no cell interior.  They only make sense in facet integrals — cell
  tabulation raises; facet contexts call ``tabulate_facet(lf, pts)``.
* BrokenElement(elem): same local basis, all dofs attached to the cell
  (no inter-cell continuity, no orientation signs) — the hybridized
  mixed-method flux space.
"""
from __future__ import annotations

import numpy as np

from .finite_element import FiniteElement
from .reference_cell import by_name


class HDivTrace(FiniteElement):
    """Piecewise-P_k on facets: per-facet Legendre basis in the facet's
    LOCAL parametrization; odd modes flip sign under edge reversal
    (facet_dof_signs, composed by the numbering layer exactly as for
    H(div) edge moments).  Degree >= 1 on 2D cells (triangle-facet
    orientation groups need matrix transforms — round 2 with tet
    hybridization)."""

    family = "HDiv Trace"
    mapping = "identity"

    def __init__(self, cell, degree: int = 0):
        if isinstance(cell, str):
            cell = by_name(cell)
        if degree != 0 and cell.dim == 3 and cell.name != "tetrahedron":
            raise NotImplementedError(
                "HDivTrace degree >= 1 in 3D: tetrahedra only")
        self.cell = cell
        self.degree = int(degree)
        self.value_shape = ()
        self.nodes = np.repeat(np.stack(
            [cell.vertices[list(f[f >= 0])].mean(axis=0)
             if hasattr(f, "__len__") else None
             for f in (np.asarray(cell.facets))]), self.npe,
            axis=0)
        if cell.dim == 3 and self.degree >= 0:
            self._build_face_basis()

    def _build_face_basis(self):
        """Per-face P_k basis DUAL to local-chart monomial moments (same
        moment convention as RT/BDM tet face dofs, hdiv.py
        _face_quad3): phi_j = sum_i (G^-1)_{ji} m_i with
        G_ij = int_face m_i m_j dA_ref.  Cross-cell consistency via the
        UNSIGNED chart-change tables (scalar traces see no normal
        flip)."""
        from .hdiv import _monomials2
        from .quadrature import make_quadrature
        k = self.degree
        self._fmons = _monomials2(k)
        cell = self.cell
        # UNSCALED chart measure: the dual basis must depend only on the
        # 2D chart (the per-face embedding area scale differs between
        # the two cells sharing a face; barycentric permutations are
        # area-preserving, so the orientation tables then glue exactly)
        q = make_quadrature("triangle", 2 * k + 2)
        s2 = q.points
        M = np.stack([s2[:, 0] ** a * s2[:, 1] ** b
                      for (a, b) in self._fmons], axis=1)
        G = M.T @ (q.weights[:, None] * M)
        Ginv = np.linalg.inv(G)
        self._chart = []
        for lf in range(len(cell.facets)):
            A, b = cell.facet_embedding(lf)
            self._chart.append((np.linalg.pinv(A), b))
        self._Ginv = [Ginv] * len(cell.facets)

    @property
    def npe(self):
        if self.cell.dim == 3:
            return (self.degree + 1) * (self.degree + 2) // 2
        return self.degree + 1

    @property
    def ndof(self):
        return len(self.cell.facets) * self.npe

    @property
    def entity_dofs(self):
        cell = self.cell
        npe = self.npe
        ed = {d: {e: [] for e in range(len(cell.topology[d]))}
              for d in cell.topology}
        for lf in range(len(cell.facets)):
            ed[cell.dim - 1][lf] = list(range(npe * lf, npe * (lf + 1)))
        return ed

    def tabulate(self, points, order=1):
        raise ValueError("HDivTrace has no cell tabulation — trace "
                         "functions appear only in facet integrals")

    def tabulate_facet(self, lf: int, points, order: int = 0):
        """Basis at facet-embedded points (CELL reference coords):
        Legendre P_j of the local facet parameter on the owning 2D edge
        / moment-dual P_k in the local face chart on the owning tet
        face, zero on all others."""
        pts = np.asarray(points, dtype=float)
        nq = len(pts)
        vals = np.zeros((nq, self.ndof))
        if self.cell.dim == 3 and self.degree >= 1:
            Ai, b = self._chart[lf]
            s2 = (pts - b[None, :]) @ Ai.T               # (nq, 2)
            M = np.stack([s2[:, 0] ** a * s2[:, 1] ** bb
                          for (a, bb) in self._fmons], axis=1)
            vals[:, lf * self.npe:(lf + 1) * self.npe] = \
                M @ self._Ginv[lf].T
        elif self.degree == 0:
            vals[:, lf] = 1.0
        else:
            fverts = self.cell.vertices[list(self.cell.facets[lf])]
            d = fverts[1] - fverts[0]
            s = ((pts - fverts[0]) @ d) / (d @ d)
            for j in range(self.npe):
                c = np.zeros(j + 1)
                c[j] = 1.0
                vals[:, lf * self.npe + j] = \
                    np.polynomial.legendre.legval(2 * s - 1, c)
        out = {0: vals}
        if order >= 1:
            out[1] = np.zeros((nq, self.ndof, self.cell.dim))
        return out

    def entity_permutation(self, dim, orientation):
        return np.arange(self.npe, dtype=np.int32)

    @property
    def has_dof_transforms(self):
        """Multi-moment tet faces need matrix chart-change transforms
        (unsigned: scalar traces see no normal flip)."""
        return self.cell.dim == 3 and self.degree >= 1

    def entity_transforms(self, d):
        if self.has_dof_transforms and d == 2:
            from .hdiv import _tri_face_transform_tables
            return _tri_face_transform_tables(self.degree + 1,
                                              signed=False)
        return None

    @property
    def facet_dof_sign_flip(self):
        return self.degree >= 1 and self.cell.dim == 2

    def facet_dof_signs(self, orientation):
        """Edge reversal: Legendre parity (-1)^j (no normal flip — trace
        functions are scalars)."""
        if orientation == 0:
            return np.ones(self.npe)
        return np.array([(-1.0) ** j for j in range(self.npe)])

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.cell.name == other.cell.name
                and self.degree == other.degree)

    def __hash__(self):
        return hash(("HDivTrace", self.cell.name, self.degree))

    def __repr__(self):
        return f"HDivTrace({self.cell.name!r}, {self.degree})"


class BrokenElement(FiniteElement):
    """Discontinuous wrapper: all dofs attached to the cell interior."""

    def __init__(self, sub: FiniteElement):
        self.sub = sub
        self.cell = sub.cell
        self.degree = sub.degree
        self.family = f"Broken({sub.family})"
        self.value_shape = sub.value_shape
        self.mapping = getattr(sub, "mapping", "identity")
        self.nodes = sub.nodes

    @property
    def ndof(self):
        return self.sub.ndof

    @property
    def entity_dofs(self):
        cell = self.cell
        ed = {d: {e: [] for e in range(len(cell.topology[d]))}
              for d in cell.topology}
        ed[cell.dim][0] = list(range(self.ndof))
        return ed

    def tabulate(self, points, order=1):
        return self.sub.tabulate(points, order)

    def entity_permutation(self, dim, orientation):
        return np.arange(0, dtype=np.int32)

    # broken spaces carry no inter-cell continuity: no orientation signs
    facet_dof_sign_flip = False

    def __eq__(self, other):
        return type(self) is type(other) and self.sub == other.sub

    def __hash__(self):
        return hash(("Broken", hash(self.sub)))

    def __repr__(self):
        return f"BrokenElement({self.sub!r})"
