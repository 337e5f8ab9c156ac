"""UFL-subset -> torch lowering: the form compiler core.

Each Expr node maps 1:1 onto torch ops evaluated at quadrature points,
as in the JAX package (which replaces the reference's TSFC pipeline,
tsfc compile_form, tsfc/fem.py:836 compile_ufl).

Evaluation convention: every node evaluates to a tensor of rank
3 + len(node.shape):
    (ni, nj, nq) + value_shape
where ni/nj are test/trial basis-slot axes (size 1 when the subtree does
not involve that argument) and nq the quadrature axis.  The final local
tensor is  sum_q integrand * scale(q).

Geometry: J[q,g,t] = sum_j coords[j,g] dphi_j[q,t]; physical derivatives
contract reference-derivative axes with Jinv (pseudo-inverse on
manifolds).  Contexts: cell, points (interpolation), exterior facet and
interior facet; an interior-facet integrand doubles the argument slots
('+' then '-') and reads coefficients per side.
"""
from __future__ import annotations

import numpy as np
from functools import lru_cache

import torch

from ..language.core import (Zero, ScalarValue, Identity,
                             PermutationSymbol, Argument, Coefficient,
                             ConstantBase, Sum, Product, Division, Power,
                             Abs, MathFunction, Atan2, MinMax, Indexed,
                             Conj, Real, Imag,
                             Grad, Restricted, Condition, BoolOp,
                             Conditional, SpatialCoordinate, FacetNormal,
                             CellDiameter, CellVolume, FacetArea,
                             CellOrientation)
from ..language.tensor_algebra import (Inner, Dot, Outer, Cross, Transpose,
                                       Trace, Determinant, Inverse,
                                       ListTensor)
from ..language.operators import Div, Curl
from .preprocess import _LastIndex
from ..elements import make_quadrature
from .tabulation import element_tables
from .smallmat import det as _smalldet, inv as _smallinv
from .precision import table_dtype


def einsum(spec, *ops):
    """torch.einsum after promoting the operands to one dtype (torch does
    not promote inside einsum; jnp.einsum does)."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(spec, *(o.to(dt) for o in ops))


def literal(value, shape=(1, 1, 1), device=None):
    """A constant-filled tensor at the context's float dtype (complex
    values keep complex128)."""
    dt = torch.complex128 if isinstance(value, complex) else table_dtype()
    return torch.full(shape, value, dtype=dt, device=device)


# =========================================================== table helpers
@lru_cache(maxsize=None)
def _cell_rule(cell_name, degree):
    q = make_quadrature(cell_name, degree)
    return q.points, q.weights


def _tables_at(element, points, order):
    """numpy tables dict {d: (nq, nslot, *vs, *(t,)*d)}."""
    return element_tables(element, points, order)


def _facet_points(cell, qf_pts):
    """(nlf, nq, tdim): facet-rule points embedded in each local facet."""
    out = []
    for lf in range(len(cell.facets)):
        A, b = cell.facet_embedding(lf)
        out.append(qf_pts @ A.T + b[None, :])
    return np.stack(out)


def _minus_facet_points(cell, qf_pts, facet_cell):
    """(nlf, n_ori, nq, tdim): minus-side points matching the plus-side
    quadrature order under each relative vertex permutation."""
    import itertools
    nfv = facet_cell.num_vertices
    perms = list(itertools.permutations(range(nfv)))
    # barycentric coords of qf_pts w.r.t. facet reference vertices
    V = facet_cell.vertices                       # (nfv, fdim)
    if facet_cell.dim == 0:
        bary = np.ones((len(qf_pts), 1))
    else:
        # solve  [V^T; 1] b = [p; 1]
        M = np.vstack([V.T, np.ones(nfv)])        # (fdim+1, nfv)
        P = np.hstack([qf_pts, np.ones((len(qf_pts), 1))]).T
        bary = np.linalg.lstsq(M, P, rcond=None)[0].T   # (nq, nfv)
    out = np.zeros((len(cell.facets), len(perms), len(qf_pts), cell.dim))
    for lf in range(len(cell.facets)):
        A, b = cell.facet_embedding(lf)
        for oi, pi in enumerate(perms):
            # minus-side facet-local bary: b~[i'] = bary[pos] where
            # V-[i'] == V+[pi[i']]
            fpts = bary[:, list(pi)] @ V          # (nq, fdim)
            out[lf, oi] = fpts @ A.T + b[None, :]
    return out


# ============================================================== contexts
class BaseContext:
    """Holds per-entity inputs + cached geometry/tables."""

    kind = None

    def __init__(self, mesh, degree):
        self.mesh = mesh
        self.degree = degree
        self.cell = mesh.cell
        self.tdim = mesh.topological_dimension
        self.gdim = mesh.geometric_dimension
        from ..elements import make_scalar_element
        self.coord_elem = make_scalar_element(
            self.cell.name, getattr(mesh, "_coord_family", "Lagrange"),
            getattr(mesh, "_coord_degree", 1))
        self._cache = {}

    def ref_table(self, element, order, side):
        raise NotImplementedError

    def coords_of(self, side):
        raise NotImplementedError

    @property
    def device(self):
        return self.coords_of("+").device

    def const(self, a):
        """Host numpy -> tensor at the context's table dtype/device."""
        return torch.as_tensor(np.asarray(a), dtype=table_dtype(),
                               device=self.device)

    # ---------------------------------------------------------- geometry
    def geom(self, side="+"):
        key = ("geom", side)
        if key in self._cache:
            return self._cache[key]
        coords = self.coords_of(side)                 # (ndofc, gdim)
        t0 = self.ref_table(self.coord_elem, 0, side)  # (nq, ndofc)
        t1 = self.ref_table(self.coord_elem, 1, side)  # (nq, ndofc, tdim)
        X = einsum("jg,qj->qg", coords, t0)
        J = einsum("jg,qjt->qgt", coords, t1)
        if self.gdim == self.tdim:
            detJ = _smalldet(J)
            Jinv = _smallinv(J)                       # (nq, tdim, gdim)
            adet = torch.abs(detJ)
        else:
            G = einsum("qgt,qgs->qts", J, J)
            adet = torch.sqrt(_smalldet(G))
            Jinv = einsum("qts,qgs->qtg", _smallinv(G), J)
        out = dict(X=X, J=J, detJ=adet, Jinv=Jinv)
        self._cache[key] = out
        return out

    def jinv(self, side="+"):
        return self.geom(side)["Jinv"]

    def xi_hessian(self, side="+"):
        """d2(xi_s)/dx_a dx_b as (nq, g, g, t) — the inverse-map Hessian
        of a curved (degree >= 2) coordinate field, zero on affine cells.
        K[q,a,b,s] = -Jinv[s,c] H[c,d,e] Jinv[d,a] Jinv[e,b] with
        H = coordinate-map reference Hessian."""
        key = ("xihess", side)
        if key in self._cache:
            return self._cache[key]
        coords = self.coords_of(side)                  # (ndofc, g)
        t2 = self.ref_table(self.coord_elem, 2, side)  # (nq, ndofc, t, t)
        H = einsum("jg,qjde->qgde", coords, t2)
        Jinv = self.geom(side)["Jinv"]                 # (nq, t, g)
        K = -einsum("qsc,qcde,qda,qeb->qabs", Jinv, H, Jinv, Jinv)
        self._cache[key] = K
        return K

    # -------------------------------------------------------- quantities
    def cell_diameter(self, side="+"):
        coords = self.coords_of(side)
        nv = self.cell.num_vertices
        v = coords[:nv]                               # vertex dofs first
        d2 = torch.sum((v[:, None, :] - v[None, :, :]) ** 2, dim=-1)
        return torch.sqrt(torch.max(d2))

    def cell_volume(self, side="+"):
        # integrate 1 over the cell with a cell rule (degree bumped for
        # curved cells: detJ has degree tdim*(cd-1))
        cd = self.coord_elem.degree
        pts, wts = _cell_rule(self.cell.name,
                              max(2, self.cell.dim * (cd - 1), 2 * cd))
        e = self.coord_elem
        t1 = self.const(e.tabulate(pts, 1)[1])       # (nq, ndofc, tdim)
        coords = self.coords_of(side)
        J = einsum("jg,qjt->qgt", coords, t1)
        if self.gdim == self.tdim:
            dJ = torch.abs(_smalldet(J))
        else:
            G = einsum("qgt,qgs->qts", J, J)
            dJ = torch.sqrt(_smalldet(G))
        return torch.sum(dJ * self.const(wts).to(dJ.dtype))


class CellContext(BaseContext):
    kind = "cell"

    def __init__(self, mesh, degree, coords_e, rule=None):
        super().__init__(mesh, degree)
        if rule is not None:
            # user-supplied rule (dx(scheme=...), the reference's FInAT
            # QuadratureRule path)
            self.qpts = np.asarray(rule.points, dtype=float)
            self.qwts = np.asarray(rule.weights, dtype=float)
        else:
            self.qpts, self.qwts = _cell_rule(self.cell.name, degree)
        self._coords = coords_e

    def coords_of(self, side):
        return self._coords

    def ref_table(self, element, order, side):
        key = ("tab", hash(element), order)
        if key not in self._cache:
            self._cache[key] = {
                d: self.const(t)
                for d, t in _tables_at(element, self.qpts, order).items()}
        return self._cache[key][order]

    def scale(self):
        detJ = self.geom()["detJ"]
        return detJ * self.const(self.qwts).to(detJ.dtype)

    def num_q(self):
        return len(self.qwts)


class PointsContext(BaseContext):
    """Evaluate at explicit reference points (interpolation; no measure)."""
    kind = "points"

    def __init__(self, mesh, points, coords_e):
        super().__init__(mesh, degree=0)
        self.qpts = np.asarray(points)
        self.qwts = np.ones(len(self.qpts))
        self._coords = coords_e

    coords_of = CellContext.coords_of
    ref_table = CellContext.ref_table

    def num_q(self):
        return len(self.qpts)


class _FacetContext(BaseContext):
    """Shared part of the facet contexts: the facet rule, the facet
    measure and the unit normal, both from the '+' cell.  Cells with one
    facet class only (CompiledIntegral refuses prisms)."""

    def __init__(self, mesh, degree):
        super().__init__(mesh, degree)
        self.facet_cell = self.cell.facet_cell
        qf = make_quadrature(self.facet_cell.name, degree)
        self.qf_pts, self.qwts = qf.points, qf.weights
        self.fpts = _facet_points(self.cell, self.qf_pts)  # (nlf, nq, t)
        self.fdim = self.facet_cell.dim

    def _tables(self, element, pts, order):
        if hasattr(element, "tabulate_facet"):
            raise NotImplementedError(
                "facet-only elements (HDiv trace) are not ported yet: "
                "ROADMAP.md queue 1, item 14")
        return _tables_at(element, pts, order)

    def _plus_tables(self, element, order):
        """{d: (nlf, nq, ...)} tables at each local facet's points."""
        per = [self._tables(element, self.fpts[lf], order)
               for lf in range(len(self.fpts))]
        return {d: self.const(np.stack([p[d] for p in per]))
                for d in per[0]}

    def scale(self):
        key = "fscale"
        if key not in self._cache:
            J = self.geom("+")["J"]                    # (nq, g, t)
            wq = self.const(self.qwts)
            if self.fdim == 0:
                s = torch.ones_like(wq)
            else:
                A = self.const(np.stack(
                    [self.cell.facet_embedding(lf)[0]
                     for lf in range(len(self.fpts))]))[self.lf_plus]
                T = einsum("qgt,tf->qgf", J, A)
                Gm = einsum("qgf,qge->qfe", T, T)
                s = torch.sqrt(_smalldet(Gm))
            self._cache[key] = s * wq.to(s.dtype)
        return self._cache[key]

    def _plus_normal(self):
        key = "normal"
        if key not in self._cache:
            nref = self.const(self.cell.facet_reference_normals)[
                self.lf_plus]
            Jinv = self.geom("+")["Jinv"]              # (nq, t, g)
            u = einsum("qtg,t->qg", Jinv, nref)
            self._cache[key] = u / torch.linalg.vector_norm(
                u, dim=-1, keepdim=True)
        return self._cache[key]

    def facet_area(self):
        return torch.sum(self.scale())

    def num_q(self):
        return len(self.qwts)


class ExteriorFacetContext(_FacetContext):
    kind = "exterior_facet"

    def __init__(self, mesh, degree, coords_e, lf):
        super().__init__(mesh, degree)
        self._coords = coords_e
        self.lf_plus = lf

    def coords_of(self, side):
        return self._coords

    def ref_table(self, element, order, side):
        key = ("tab", hash(element), order)
        if key not in self._cache:
            # gathered by local facet
            self._cache[key] = {d: t[self.lf_plus] for d, t in
                                self._plus_tables(element, order).items()}
        return self._cache[key][order]

    def normal(self, side="+"):
        return self._plus_normal()


class InteriorFacetContext(_FacetContext):
    kind = "interior_facet"

    def __init__(self, mesh, degree, coords_p, coords_m, lf_p, lf_m,
                 o_rel):
        super().__init__(mesh, degree)
        self.mpts = _minus_facet_points(self.cell, self.qf_pts,
                                        self.facet_cell)
        self._coords = {"+": coords_p, "-": coords_m}
        self.lf_plus, self.lf_minus = lf_p, lf_m
        self.o_rel = o_rel

    def coords_of(self, side):
        return self._coords[side]

    def ref_table(self, element, order, side):
        key = ("tab", hash(element), order, side)
        if key not in self._cache:
            if side == "+":
                tabs = {d: t[self.lf_plus] for d, t in
                        self._plus_tables(element, order).items()}
            else:
                # by the minus cell's local facet and the relative
                # orientation of its vertices
                nlf, nori = self.mpts.shape[:2]
                per = [[self._tables(element, self.mpts[lf, o], order)
                        for o in range(nori)] for lf in range(nlf)]
                tabs = {d: self.const(np.stack([np.stack(
                    [per[lf][o][d] for o in range(nori)])
                    for lf in range(nlf)]))[self.lf_minus, self.o_rel]
                    for d in per[0][0]}
            self._cache[key] = tabs
        return self._cache[key][order]

    def normal(self, side="+"):
        n = self._plus_normal()
        return n if side == "+" else -n


# ============================================================== evaluator
_MATHFNS = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.arcsin, "arccos": torch.arccos, "arctan": torch.arctan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "exp": torch.exp, "log": torch.log, "sqrt": torch.sqrt,
    "sign": torch.sign, "erf": torch.special.erf,
}
_CONDOPS = {
    "lt": torch.lt, "le": torch.le,
    "gt": torch.gt, "ge": torch.ge,
    "eq": torch.eq, "ne": torch.ne,
}


def _pad_to(x, extra):
    """Append `extra` singleton axes."""
    return x.reshape(x.shape + (1,) * extra)


def _sum_value_axes(x, first, k):
    """Sum over the k value axes starting at `first` (k == 0: identity —
    torch's sum over an empty dim tuple would reduce every axis)."""
    if k == 0:
        return x
    return torch.sum(x, dim=tuple(range(first, first + k)))


class Lowerer:
    """Evaluates an integrand Expr to a (ni, nj, nq)+shape tensor."""

    def __init__(self, ctx, test, trial, coeff_dats, const_vals):
        self.ctx = ctx
        self.test = test
        self.trial = trial
        self.coeff_dats = coeff_dats      # count -> tensor or {'+', '-'}
        self.const_vals = const_vals      # count -> tensor
        self.memo = {}
        self.interior = ctx.kind == "interior_facet"

    # ----------------------------------------------------------- helpers
    def slot_count(self, arg):
        nd = arg.space.element.ndof
        return 2 * nd if self.interior else nd

    def arg_table(self, arg, order, side):
        elem = arg.space.element
        if self.interior:
            # doubled slots: the '+' cell's dofs, then the '-' cell's
            if side is None:
                raise ValueError(
                    "arguments must be restricted ('+'/'-') in dS integrals")
            T = self.ctx.ref_table(elem, order, side)
            Z = torch.zeros_like(T)
            return torch.cat([T, Z] if side == "+" else [Z, T], dim=1)
        return self.ctx.ref_table(elem, order, side or "+")

    def _to_phys(self, T, d, side, T1=None):
        """Contract the trailing d reference-derivative axes with Jinv.

        For second derivatives on curved cells (coordinate degree >= 2)
        the chain rule adds the coordinate-map curvature term
        d2u/dxa dxb = u_ref_st Jinv[s,a] Jinv[t,b]
                    + u_ref_s * d2(xi_s)/dxa dxb.
        ``T1`` is the order-1 reference table of the same terminal."""
        if d == 0:
            return T
        Jinv = self.ctx.jinv(side or "+")              # (nq, t, g)
        if d == 1:
            return einsum("q...t,qtg->q...g", T, Jinv)
        if d == 2:
            P = einsum("q...st,qsa,qtb->q...ab", T, Jinv, Jinv)
            if self.ctx.coord_elem.degree > 1:
                if self.ctx.gdim != self.ctx.tdim:
                    raise NotImplementedError(
                        "second derivatives on curved manifold meshes")
                if T1 is None:
                    raise NotImplementedError(
                        "second derivative of this terminal on a curved "
                        "mesh")
                K = self.ctx.xi_hessian(side or "+")   # (nq, g, g, t)
                P = P + einsum("q...s,qabs->q...ab", T1, K)
            return P
        raise NotImplementedError("derivatives beyond order 2")

    # -------------------------------------------------------------- eval
    def run(self, integrand):
        v = self.eval(integrand, None)
        assert v.ndim == 3, "integrand must be scalar"
        return v

    def eval(self, e, side):
        # memo holds a STRONG ref to the node and verifies identity:
        # lowering creates temporary Expr nodes, and a bare id() key can
        # be recycled by CPython onto a later temporary
        key = (id(e), side)
        hit = self.memo.get(key)
        if hit is not None and hit[0] is e:
            return hit[1]
        v = self._eval(e, side)
        expect = 3 + len(e.shape)
        assert v.ndim == expect, (type(e).__name__, v.shape, e.shape)
        self.memo[key] = (e, v)
        return v

    def _eval(self, e, side):
        t = type(e)
        ev = self.eval
        dev = self.ctx.device

        # ---- grad chains on terminals
        if t is Grad:
            base, d = e, 0
            while isinstance(base, Grad):
                base = base.operands[0]
                d += 1
            if isinstance(base, Restricted):
                side = base.side
                base = base.operands[0]
            return self._terminal_deriv(base, d, side, e.shape)

        if t is Restricted:
            return ev(e.operands[0], e.side)

        # ---- terminals
        if t is Zero:
            return literal(0.0, (1, 1, 1) + e.shape, dev)
        if t is ScalarValue:
            return literal(e.value, (1, 1, 1), dev)
        if t is Identity:
            return self.ctx.const(np.eye(e.dim)).reshape(1, 1, 1, e.dim,
                                                         e.dim)
        if t is PermutationSymbol:
            eps = np.zeros((e.dim,) * e.dim)
            import itertools as _it
            for p in _it.permutations(range(e.dim)):
                sgn = 1
                pl = list(p)
                for i in range(len(pl)):
                    for jj in range(i + 1, len(pl)):
                        if pl[i] > pl[jj]:
                            sgn = -sgn
                eps[p] = sgn
            return self.ctx.const(eps).reshape((1, 1, 1) + eps.shape)
        if isinstance(e, ConstantBase):
            v = self.const_vals.get(e.count)
            if v is None:
                v = self.ctx.const(e.values())
            return v.reshape((1, 1, 1) + e.shape)
        if isinstance(e, Argument) or isinstance(e, Coefficient):
            return self._terminal_deriv(e, 0, side, e.shape)
        if t is SpatialCoordinate:
            X = self.ctx.geom(side or "+")["X"]        # (nq, g)
            return X[None, None]
        if t is FacetNormal:
            if not hasattr(self.ctx, "normal"):
                raise ValueError("FacetNormal is only defined in facet "
                                 "integrals (ds/dS)")
            if self.interior and side is None:
                raise ValueError("FacetNormal must be restricted in dS")
            return self.ctx.normal(side or "+")[None, None]
        if t is CellDiameter:
            return self.ctx.cell_diameter(side or "+").reshape(1, 1, 1)
        if t is CellVolume:
            return self.ctx.cell_volume(side or "+").reshape(1, 1, 1)
        if t is FacetArea:
            if not hasattr(self.ctx, "facet_area"):
                raise ValueError(
                    "FacetArea is only defined in facet integrals "
                    "(ds/dS), not dx")
            return self.ctx.facet_area().reshape(1, 1, 1)
        if t is CellOrientation:
            return literal(1.0, (1, 1, 1), dev)

        # ---- algebra
        if t is Sum:
            return ev(e.operands[0], side) + ev(e.operands[1], side)
        if t is Product:
            a, b = e.operands
            va, vb = ev(a, side), ev(b, side)
            if a.shape == () and b.shape != ():
                va = _pad_to(va, len(b.shape))
            elif b.shape == () and a.shape != ():
                vb = _pad_to(vb, len(a.shape))
            return va * vb
        if t is Division:
            return ev(e.operands[0], side) / _pad_to(
                ev(e.operands[1], side), len(e.operands[0].shape))
        if t is Power:
            return ev(e.operands[0], side) ** ev(e.operands[1], side)
        if t is Abs:
            return torch.abs(ev(e.operands[0], side))
        if t is Conj:
            return torch.conj(ev(e.operands[0], side))
        if t is Real:
            return torch.real(ev(e.operands[0], side))
        if t is Imag:
            return torch.imag(ev(e.operands[0], side))
        if t is MathFunction:
            return _MATHFNS[e.fname](ev(e.operands[0], side))
        if t is Atan2:
            return torch.atan2(ev(e.operands[0], side),
                               ev(e.operands[1], side))
        if t is MinMax:
            f = torch.minimum if e.which == "min" else torch.maximum
            return f(ev(e.operands[0], side), ev(e.operands[1], side))
        if t is Indexed:
            v = ev(e.operands[0], side)
            return v[(slice(None),) * 3 + e.indices]
        if t is _LastIndex:
            v = ev(e.operands[0], side)
            return v[..., e.idx]
        if t is ListTensor:
            comps = [ev(o, side) for o in e.operands]
            lead = torch.broadcast_shapes(*[c.shape[:3] for c in comps])
            comps = [torch.broadcast_to(c, lead + c.shape[3:])
                     for c in comps]
            return torch.stack(comps, dim=3)

        # ---- tensor algebra
        if t is Inner:
            a, b = e.operands
            va, vb = ev(a, side), ev(b, side)
            k = len(a.shape)
            lead = torch.broadcast_shapes(va.shape[:3], vb.shape[:3])
            va = torch.broadcast_to(va, lead + va.shape[3:])
            vb = torch.broadcast_to(vb, lead + vb.shape[3:])
            return _sum_value_axes(va * vb, 3, k)
        if t is Dot:
            a, b = e.operands
            va, vb = ev(a, side), ev(b, side)
            return self._dot(va, vb, len(a.shape), len(b.shape))
        if t is Outer:
            a, b = e.operands
            va, vb = ev(a, side), ev(b, side)
            ka, kb = len(a.shape), len(b.shape)
            va2 = _pad_to(va, kb)
            vb2 = vb.reshape(vb.shape[:3] + (1,) * ka + vb.shape[3:])
            return va2 * vb2
        if t is Cross:
            va, vb = ev(e.operands[0], side), ev(e.operands[1], side)
            return torch.linalg.cross(va, vb, dim=-1)
        if t is Transpose:
            return torch.swapaxes(ev(e.operands[0], side), 3, 4)
        if t is Trace:
            v = ev(e.operands[0], side)
            return sum(v[..., i, i] for i in range(v.shape[-1]))
        if t is Determinant:
            return _smalldet(ev(e.operands[0], side))
        if t is Inverse:
            return _smallinv(ev(e.operands[0], side))
        if t is Div:
            # div = trace over (last value axis, gradient axis) of grad
            vg = ev(Grad(e.operands[0]), side)
            return sum(vg[..., i, i] for i in range(vg.shape[-1]))
        if t is Curl:
            vg = ev(Grad(e.operands[0]), side)     # (..., comp, gdim)
            if e.operands[0].shape == ():
                # 2D scalar curl = perp gradient (du/dy, -du/dx)
                return torch.stack([vg[..., 1], -vg[..., 0]], dim=-1)
            if e.operands[0].shape == (2,):
                return vg[..., 1, 0] - vg[..., 0, 1]
            c0 = vg[..., 2, 1] - vg[..., 1, 2]
            c1 = vg[..., 0, 2] - vg[..., 2, 0]
            c2 = vg[..., 1, 0] - vg[..., 0, 1]
            return torch.stack([c0, c1, c2], dim=-1)

        # ---- conditionals
        if t is Condition:
            return _CONDOPS[e.op](ev(e.operands[0], side),
                                  ev(e.operands[1], side))
        if t is BoolOp:
            vs = [ev(o, side) for o in e.operands]
            if e.op == "and":
                return torch.logical_and(vs[0], vs[1])
            if e.op == "or":
                return torch.logical_or(vs[0], vs[1])
            return torch.logical_not(vs[0])
        if t is Conditional:
            c = ev(e.operands[0], side)
            tv = ev(e.operands[1], side)
            fv = ev(e.operands[2], side)
            c = _pad_to(c, len(e.shape))
            return torch.where(c, tv, fv)

        raise NotImplementedError(f"lowering of {t.__name__}")

    @staticmethod
    def _dot(va, vb, ka, kb):
        """Contract last value axis of va with first value axis of vb
        (leading (ni,nj,nq) axes broadcast explicitly first)."""
        la = [chr(ord("d") + i) for i in range(ka - 1)]
        lb = [chr(ord("m") + i) for i in range(kb - 1)]
        lead = torch.broadcast_shapes(va.shape[:3], vb.shape[:3])
        va = torch.broadcast_to(va, lead + va.shape[3:])
        vb = torch.broadcast_to(vb, lead + vb.shape[3:])
        sa = "xyq" + "".join(la) + "z"
        sb = "xyq" + "z" + "".join(lb)
        so = "xyq" + "".join(la) + "".join(lb)
        return einsum(f"{sa},{sb}->{so}", va, vb)

    # ------------------------------------------------------- terminal d^k
    def _terminal_deriv(self, base, d, side, out_shape):
        ctx = self.ctx
        if isinstance(base, SpatialCoordinate):
            if d == 0:
                return ctx.geom(side or "+")["X"][None, None]
            if d == 1:
                # grad(x) is the identity in physical space (the JAX
                # package returns the reference Jacobian here)
                X = ctx.geom(side or "+")["X"]           # (nq, g)
                nq, gd = X.shape
                eye = torch.eye(gd, dtype=X.dtype, device=X.device)
                return eye.reshape(1, 1, 1, gd, gd).expand(1, 1, nq, gd, gd)
            # grad(grad(x)) is identically zero in physical space
            return literal(0.0, (1, 1, ctx.num_q()) + out_shape,
                           ctx.device)
        if isinstance(base, Argument):
            elem = base.space.element
            T = self.arg_table(base, d, side)          # (nq, nslot, vs, t^d)
            T1 = (self.arg_table(base, 1, side)
                  if d == 2 and ctx.coord_elem.degree > 1 else None)
            P = self._pullback(T, elem, d, side, T1)
            P = torch.movedim(P, 1, 0)                 # (nslot, nq, ...)
            if base.number == 0:
                return P[:, None]                      # (ni, 1, nq, ...)
            return P[None]                             # (1, nj, nq, ...)
        if isinstance(base, Coefficient):
            if self.interior and side is None:
                if not getattr(base.space.element, "continuous", False):
                    raise ValueError(
                        "coefficients must be restricted ('+'/'-') in "
                        "dS integrals")
                # ufl apply_default_restrictions: a continuous terminal
                # is single-valued on the facet, so '+' stands for both
                side = "+"
            dat = self.coeff_dats[base.count]
            if isinstance(dat, dict):
                dat = dat[side or "+"]
            elem = base.space.element
            T = ctx.ref_table(elem, d, side or "+")
            T1 = (ctx.ref_table(elem, 1, side or "+")
                  if d == 2 and ctx.coord_elem.degree > 1 else None)
            P = self._pullback(T, elem, d, side, T1)
            v = einsum("j,qj...->q...", dat, P)
            return v[None, None]
        raise NotImplementedError(
            f"grad of {type(base).__name__} terminal")

    def _pullback(self, T, elem, d, side, T1=None):
        """Apply the element's reference->physical mapping.  Only the
        identity (Lagrange) pullback is ported; Piola-mapped elements
        come with the mixed/H(div) slice."""
        mapping = getattr(elem, "mapping", "identity")
        if mapping == "identity":
            return self._to_phys(T, d, side, T1)
        raise NotImplementedError(f"{mapping} pullback")
