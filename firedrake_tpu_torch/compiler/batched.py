"""Cell-last ("batched") kernel evaluation.

Every evaluated array has shape (ni, nj, nq, *vs, C) with C in
{1, ncell}: the cell axis is trailing and broadcasts like the
quadrature axis, exactly as in the JAX package, so the (ni, nj, C)
local tensors feed the stencil accumulation slot by slot as flat (C,)
vectors.  This is the general evaluator of the structured path; the
form family of the main path goes to the hand-written kernel instead
(compiler/cell_eval.py).
"""
from __future__ import annotations

import numpy as np
import torch

from .lowering import (Lowerer, CellContext, _cell_rule, _MATHFNS,
                       _CONDOPS, _sum_value_axes, einsum, literal)
from ..language.core import (Argument, Coefficient, SpatialCoordinate,
                             Zero, ScalarValue, Identity)


def _detC(A, i0, i1):
    """det over axes (i0, i1) of size <= 3, arbitrary other axes."""
    n = A.shape[i0]

    def g(i, j):
        idx = [slice(None)] * A.ndim
        idx[i0], idx[i1] = i, j
        return A[tuple(idx)]

    if n == 1:
        return g(0, 0)
    if n == 2:
        return g(0, 0) * g(1, 1) - g(0, 1) * g(1, 0)
    if n == 3:
        return (g(0, 0) * (g(1, 1) * g(2, 2) - g(1, 2) * g(2, 1))
                - g(0, 1) * (g(1, 0) * g(2, 2) - g(1, 2) * g(2, 0))
                + g(0, 2) * (g(1, 0) * g(2, 1) - g(1, 1) * g(2, 0)))
    raise NotImplementedError(n)


def _invC(A, i0, i1):
    """inverse over axes (i0, i1) (size <= 3), stacked back in place."""
    n = A.shape[i0]

    def g(i, j):
        idx = [slice(None)] * A.ndim
        idx[i0], idx[i1] = i, j
        return A[tuple(idx)]

    d = _detC(A, i0, i1)
    if n == 1:
        rows = [[1.0 / g(0, 0)]]
        d = None
    elif n == 2:
        rows = [[g(1, 1), -g(0, 1)], [-g(1, 0), g(0, 0)]]
    elif n == 3:
        c = lambda a, b, cc, dd: g(a, b) * g(cc, dd) - g(a, dd) * g(cc, b)
        rows = [
            [c(1, 1, 2, 2), -c(0, 1, 2, 2),
             g(0, 1) * g(1, 2) - g(0, 2) * g(1, 1)],
            [-c(1, 0, 2, 2), c(0, 0, 2, 2),
             -(g(0, 0) * g(1, 2) - g(0, 2) * g(1, 0))],
            [g(1, 0) * g(2, 1) - g(1, 1) * g(2, 0),
             -(g(0, 0) * g(2, 1) - g(0, 1) * g(2, 0)),
             g(0, 0) * g(1, 1) - g(0, 1) * g(1, 0)],
        ]
    else:
        raise NotImplementedError(n)
    out = torch.stack([torch.stack(r, dim=i0) for r in rows], dim=i0)
    # the two matrix axes are now at (i0, i0+1) in source order
    assert i1 == i0 + 1
    if d is None:
        return out
    return out / d.unsqueeze(i0).unsqueeze(i1)


class BatchedCellContext(CellContext):
    """Cell context whose coords carry a trailing cell axis:
    coords (ndofc, gdim, C)."""

    kind = "cell"
    batched = True

    def geom(self, side="+"):
        key = ("geom", side)
        if key in self._cache:
            return self._cache[key]
        coords = self.coords_of(side)                  # (ndofc, g, C)
        t0 = self.ref_table(self.coord_elem, 0, side)  # (nq, ndofc)
        t1 = self.ref_table(self.coord_elem, 1, side)  # (nq, ndofc, t)
        X = einsum("jgc,qj->qgc", coords, t0)
        J = einsum("jgc,qjt->qgtc", coords, t1)        # (nq, g, t, C)
        if self.gdim == self.tdim:
            detJ = _detC(J, 1, 2)                      # (nq, C)
            Jinv = _invC(J, 1, 2)                      # (nq, t, g, C)
            adet = torch.abs(detJ)
        else:
            G = einsum("qgtc,qgsc->qtsc", J, J)
            adet = torch.sqrt(_detC(G, 1, 2))
            Jinv = einsum("qtsc,qgsc->qtgc", _invC(G, 1, 2), J)
        out = dict(X=X, J=J, detJ=adet, Jinv=Jinv)
        self._cache[key] = out
        return out

    def scale(self):
        detJ = self.geom()["detJ"]
        return detJ * self.const(self.qwts).to(detJ.dtype)[:, None]

    def cell_diameter(self, side="+"):
        coords = self.coords_of(side)                  # (ndofc, g, C)
        nv = self.cell.num_vertices
        v = coords[:nv]
        d2 = torch.sum((v[:, None] - v[None, :]) ** 2, dim=2)  # (nv,nv,C)
        return torch.sqrt(torch.amax(d2, dim=(0, 1)))          # (C,)

    def cell_volume(self, side="+"):
        pts, wts = _cell_rule(self.cell.name, 2)
        t1 = self.const(self.coord_elem.tabulate(pts, 1)[1])
        coords = self.coords_of(side)
        J = einsum("jgc,qjt->qgtc", coords, t1)
        if self.gdim == self.tdim:
            dJ = torch.abs(_detC(J, 1, 2))
        else:
            G = einsum("qgtc,qgsc->qtsc", J, J)
            dJ = torch.sqrt(_detC(G, 1, 2))
        return einsum("qc,q->c", dJ, self.const(wts))


class BatchedLowerer(Lowerer):
    """Evaluates with an extra trailing cell axis: every array has rank
    3 + len(shape) + 1, last axis C in {1, ncell}."""

    batched = True

    # -------------------------------------------------- shape conventions
    def eval(self, e, side):
        key = (id(e), side)
        hit = self.memo.get(key)
        if hit is not None and hit[0] is e:
            return hit[1]
        v = self._eval(e, side)
        expect = 4 + len(e.shape)
        assert v.ndim == expect, (type(e).__name__, v.shape, e.shape)
        self.memo[key] = (e, v)
        return v

    def run(self, integrand):
        v = self.eval(integrand, None)
        assert v.ndim == 4
        return v                                       # (ni, nj, nq, C)

    # helpers that must insert value axes BEFORE the trailing cell axis
    @staticmethod
    def _padv(x, extra):
        if extra == 0:
            return x
        return x.reshape(x.shape[:-1] + (1,) * extra + x.shape[-1:])

    def _eval(self, e, side):
        from ..language.core import (Sum, Product, Division, Power, Abs,
                                     MathFunction, Atan2, MinMax, Indexed,
                                     Conj, Real, Imag,
                                     Grad, Restricted, Condition, BoolOp,
                                     Conditional, ConstantBase,
                                     CellDiameter, CellVolume)
        from ..language.tensor_algebra import (Inner, Dot, Outer, Cross,
                                               Transpose, Trace,
                                               Determinant, Inverse,
                                               ListTensor)
        from ..language.operators import Div, Curl
        from .preprocess import _LastIndex
        t = type(e)
        ev = self.eval
        dev = self.ctx.device

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
        if t is Zero:
            return literal(0.0, (1, 1, 1) + e.shape + (1,), dev)
        if t is ScalarValue:
            return literal(e.value, (1, 1, 1, 1), dev)
        if t is Identity:
            return self.ctx.const(np.eye(e.dim)).reshape(
                1, 1, 1, e.dim, e.dim, 1)
        if isinstance(e, ConstantBase):
            v = self.const_vals.get(e.count)
            if v is None:
                v = self.ctx.const(e.values())
            return v.reshape((1, 1, 1) + e.shape + (1,))
        if isinstance(e, (Argument, Coefficient)):
            return self._terminal_deriv(e, 0, side, e.shape)
        if t is SpatialCoordinate:
            X = self.ctx.geom(side or "+")["X"]        # (nq, g, C)
            return X[None, None]
        if t is CellDiameter:
            return self.ctx.cell_diameter(side or "+").reshape(1, 1, 1, -1)
        if t is CellVolume:
            return self.ctx.cell_volume(side or "+").reshape(1, 1, 1, -1)

        if t is Sum:
            return ev(e.operands[0], side) + ev(e.operands[1], side)
        if t is Product:
            a, b = e.operands
            va, vb = ev(a, side), ev(b, side)
            if a.shape == () and b.shape != ():
                va = self._padv(va, len(b.shape))
            elif b.shape == () and a.shape != ():
                vb = self._padv(vb, len(a.shape))
            return va * vb
        if t is Division:
            return ev(e.operands[0], side) / self._padv(
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
            return v[..., e.idx, :]
        if t is ListTensor:
            comps = [ev(o, side) for o in e.operands]
            shapes = [c.shape for c in comps]
            lead = torch.broadcast_shapes(*[s[:3] for s in shapes])
            cb = torch.broadcast_shapes(*[s[-1:] for s in shapes])
            comps = [torch.broadcast_to(c, lead + c.shape[3:-1] + cb)
                     for c in comps]
            return torch.stack(comps, dim=3)
        if t is Inner:
            a, b = e.operands
            va, vb = ev(a, side), ev(b, side)
            k = len(a.shape)
            full = torch.broadcast_shapes(va.shape, vb.shape)
            va = torch.broadcast_to(va, full)
            vb = torch.broadcast_to(vb, full)
            return _sum_value_axes(va * vb, 3, k)
        if t is Dot:
            a, b = e.operands
            va, vb = ev(a, side), ev(b, side)
            ka, kb = len(a.shape), len(b.shape)
            la = "".join(chr(ord("d") + i) for i in range(ka - 1))
            lb = "".join(chr(ord("m") + i) for i in range(kb - 1))
            lead = torch.broadcast_shapes(va.shape[:3], vb.shape[:3])
            cb = torch.broadcast_shapes(va.shape[-1:], vb.shape[-1:])
            va = torch.broadcast_to(va, lead + va.shape[3:-1] + cb)
            vb = torch.broadcast_to(vb, lead + vb.shape[3:-1] + cb)
            return einsum(f"xyq{la}zc,xyqz{lb}c->xyq{la}{lb}c", va, vb)
        if t is Outer:
            a, b = e.operands
            va, vb = ev(a, side), ev(b, side)
            ka, kb = len(a.shape), len(b.shape)
            va2 = self._padv(va, kb)
            vb2 = vb.reshape(vb.shape[:3] + (1,) * ka + vb.shape[3:])
            return va2 * vb2
        if t is Cross:
            va, vb = ev(e.operands[0], side), ev(e.operands[1], side)
            return torch.linalg.cross(va, vb, dim=3)
        if t is Transpose:
            return torch.swapaxes(ev(e.operands[0], side), 3, 4)
        if t is Trace:
            v = ev(e.operands[0], side)
            n = v.shape[3]
            return sum(v[:, :, :, i, i, :] for i in range(n))
        if t is Determinant:
            return _detC(ev(e.operands[0], side), 3, 4)
        if t is Inverse:
            return _invC(ev(e.operands[0], side), 3, 4)
        if t is Div:
            vg = ev(Grad(e.operands[0]), side)
            return self._div_trace(vg)
        if t is Curl:
            vg = ev(Grad(e.operands[0]), side)
            if e.operands[0].shape == (2,):
                return vg[:, :, :, 1, 0, :] - vg[:, :, :, 0, 1, :]
            c0 = vg[:, :, :, 2, 1, :] - vg[:, :, :, 1, 2, :]
            c1 = vg[:, :, :, 0, 2, :] - vg[:, :, :, 2, 0, :]
            c2 = vg[:, :, :, 1, 0, :] - vg[:, :, :, 0, 1, :]
            return torch.stack([c0, c1, c2], dim=3)
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
            c = self._padv(c, len(e.shape))
            return torch.where(c, tv, fv)
        raise NotImplementedError(f"batched lowering of {t.__name__}")

    @staticmethod
    def _div_trace(vg):
        """trace over the last two VALUE axes (before the cell axis)."""
        n = vg.shape[-2]
        return sum(vg[..., i, i, :] for i in range(n))

    # ------------------------------------------------------- terminal d^k
    def _to_phys(self, T, d, side):
        """T (nq, nslot, vs.., t^d) constant table -> contract derivative
        axes with batched Jinv (nq, t, g, C) -> (nq, nslot, vs.., g^d, C)."""
        if d == 0:
            return T[..., None]
        Jinv = self.ctx.jinv(side or "+")
        if d == 1:
            return einsum("q...t,qtgc->q...gc", T, Jinv)
        if d == 2:
            return einsum("q...st,qsac,qtbc->q...abc", T, Jinv, Jinv)
        raise NotImplementedError("batched derivatives beyond order 2")

    def _terminal_deriv(self, base, d, side, out_shape):
        ctx = self.ctx
        if isinstance(base, SpatialCoordinate):
            g = ctx.geom(side or "+")
            if d == 0:
                return g["X"][None, None]              # (1,1,nq,g,C)
            nq, gd = g["X"].shape[:2]
            if d == 1:
                # grad(x) is the identity in physical space (the JAX
                # package returns the reference Jacobian here)
                eye = torch.eye(gd, dtype=g["X"].dtype, device=ctx.device)
                return eye.reshape(1, 1, 1, gd, gd, 1).expand(
                    1, 1, nq, gd, gd, 1)
            return literal(0.0, (1, 1, nq) + out_shape + (1,), ctx.device)
        if isinstance(base, Argument):
            elem = base.space.element
            if getattr(elem, "mapping", "identity") != "identity":
                raise NotImplementedError(elem.mapping)
            T = self.arg_table(base, d, side)
            P = self._to_phys(T, d, side)              # (nq,nslot,...,C)
            P = torch.movedim(P, 1, 0)                 # (nslot, nq, ..., C)
            if base.number == 0:
                return P[:, None]
            return P[None]
        if isinstance(base, Coefficient):
            dat = self.coeff_dats[base.count]          # (nslot, C)
            elem = base.space.element
            if getattr(elem, "mapping", "identity") != "identity":
                raise NotImplementedError(elem.mapping)
            T = ctx.ref_table(elem, d, side or "+")
            P = self._to_phys(T, d, side)
            v = einsum("jc,qj...c->q...c", dat, P)
            return v[None, None]
        raise NotImplementedError(
            f"batched grad of {type(base).__name__}")

