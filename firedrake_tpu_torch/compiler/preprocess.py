"""Form preprocessing: quadrature-degree estimation and grad pushdown.

Reference analogues: degree estimation in
tsfc/kernel_interface/common.py:305-360 / ufl.algorithms.estimate_total_
polynomial_degree; derivative expansion in ufl apply_derivatives (invoked
from tsfc/ufl_utils.py:479 compute_form_data)."""
from __future__ import annotations

import numpy as np

from ..language.core import (Expr, Terminal, Zero, ScalarValue, Argument,
                             Coefficient, ConstantBase, Identity, Sum,
                             Product, Division, Power, Abs, MathFunction,
                             Atan2, MinMax, Indexed, Grad, Restricted,
                             Condition, BoolOp, Conditional,
                             GeometricQuantity, SpatialCoordinate,
                             FacetNormal, CellDiameter, CellVolume,
                             FacetArea)
from ..language.tensor_algebra import (Inner, Dot, Outer, Cross, Transpose,
                                       Trace, Determinant, Inverse,
                                       ListTensor)
from ..language.operators import Div, Curl
from ..language.calculus import reconstruct


# ------------------------------------------------------- degree estimation
def estimate_degree(e: Expr, coord_degree: int = 1, memo=None) -> int:
    if memo is None:
        memo = {}
    k = id(e)
    hit = memo.get(k)
    if hit is not None and hit[0] is e:
        return hit[1]
    d = _estimate(e, coord_degree, memo)
    memo[k] = (e, d)
    return d


def _estimate(e, cd, memo):
    est = lambda x: estimate_degree(x, cd, memo)
    if isinstance(e, Argument):
        el = e.space.element
        return getattr(el, "embedded_superdegree", el.degree)
    if isinstance(e, Coefficient):
        el = e.space.element
        return getattr(el, "embedded_superdegree", el.degree)
    if isinstance(e, SpatialCoordinate):
        return cd
    if isinstance(e, (FacetNormal, CellDiameter, CellVolume, FacetArea)):
        return 0 if cd <= 1 else cd
    if isinstance(e, (ScalarValue, ConstantBase, Zero, Identity)):
        return 0
    if isinstance(e, Grad):
        return max(est(e.operands[0]) - (1 if cd <= 1 else 0), 0) \
            + (cd - 1 if cd > 1 else 0)
    if isinstance(e, (Div, Curl)):
        return max(est(e.operands[0]) - (1 if cd <= 1 else 0), 0)
    if isinstance(e, (Sum, MinMax, Conditional)):
        return max(est(o) for o in e.operands
                   if not isinstance(o, (Condition, BoolOp)))
    if isinstance(e, (Product, Inner, Dot, Outer, Cross)):
        return sum(est(o) for o in e.operands)
    if isinstance(e, Division):
        return est(e.operands[0]) + est(e.operands[1])
    if isinstance(e, Power):
        b, p = e.operands
        if isinstance(p, ScalarValue) and float(p.value).is_integer() \
                and p.value >= 0:
            return int(est(b) * p.value)
        return est(b) + 2
    if isinstance(e, (MathFunction, Abs, Atan2)):
        return max(est(e.operands[0]), 1) + 2
    if isinstance(e, (Indexed, Restricted, Transpose, Trace, ListTensor)):
        return max((est(o) for o in e.operands), default=0)
    if isinstance(e, (Determinant, Inverse)):
        n = e.operands[0].shape[0]
        return est(e.operands[0]) * n
    if isinstance(e, (Condition, BoolOp)):
        return max((est(o) for o in e.operands), default=0)
    if isinstance(e, Terminal):
        return 0
    return max((est(o) for o in e.operands), default=0)


# ------------------------------------------------------------ grad pushing
_GRAD_TERMINALS = (Argument, Coefficient, SpatialCoordinate)


def push_grad(e: Expr, memo=None) -> Expr:
    """Rewrite so Grad only wraps Argument/Coefficient/SpatialCoordinate
    (possibly nested Grad-of-terminal for Hessians)."""
    if memo is None:
        memo = {}
    k = id(e)
    hit = memo.get(k)
    if hit is not None and hit[0] is e:
        return hit[1]
    if isinstance(e, Grad):
        out = _push_one_grad(push_grad(e.operands[0], memo), e.shape[-1])
    elif isinstance(e, Terminal):
        out = e
    else:
        ops = [push_grad(o, memo) for o in e.operands]
        out = e if all(a is b for a, b in zip(ops, e.operands)) \
            else reconstruct(e, ops)
    memo[k] = (e, out)
    return out


def _is_grad_terminal(e):
    return isinstance(e, _GRAD_TERMINALS) or (
        isinstance(e, Grad) and _is_grad_terminal(e.operands[0])) or (
        isinstance(e, Restricted) and _is_grad_terminal(e.operands[0]))


def _push_one_grad(e: Expr, gdim: int) -> Expr:
    """grad(e) with grad distributed one level; e is already pushed.
    gdim is the geometric dimension of the outer grad: a constant
    operand (a literal, a Constant) has no mesh terminal to read it
    from, and its gradient is Zero(e.shape + (gdim,))."""
    if _is_grad_terminal(e):
        if isinstance(e, Restricted):
            # grad(u('+')) == (grad u)('+')
            return Restricted(_push_one_grad(e.operands[0], gdim), e.side)
        return Grad(e)
    if isinstance(e, Zero) or isinstance(e, (ScalarValue, ConstantBase,
                                             Identity)):
        return Zero(e.shape + (gdim,))
    if isinstance(e, Sum):
        return Sum(_push_one_grad(e.operands[0], gdim),
                   _push_one_grad(e.operands[1], gdim))
    if isinstance(e, Product):
        # one operand is scalar; Outer folds all-scalar cases to Product
        a, b = e.operands
        ga, gb = _push_one_grad(a, gdim), _push_one_grad(b, gdim)
        # d(a*b) = b (x) ga + a (x) gb, shape e.shape+(gdim,)
        return Sum(Outer(b, ga), Outer(a, gb))
    if isinstance(e, Division):
        a, b = e.operands
        ga, gb = _push_one_grad(a, gdim), _push_one_grad(b, gdim)
        t1 = Division(ga, b)
        t2 = Outer(Division(a, Power(b, ScalarValue(2.0))), gb)
        return Sum(t1, Product(ScalarValue(-1.0), t2))
    if isinstance(e, Power):
        a, b = e.operands
        if not _expr_const_wrt_x(b):
            raise NotImplementedError("grad of f**g with varying exponent")
        return Product(Product(b, Power(a, Sum(b, ScalarValue(-1.0)))),
                       _push_one_grad(a, gdim))
    if isinstance(e, MathFunction):
        from ..language.calculus import _CHAIN
        df = _CHAIN[e.fname](e.operands[0])
        return Product(df, _push_one_grad(e.operands[0], gdim))
    if isinstance(e, Abs):
        return Product(MathFunction("sign", e.operands[0]),
                       _push_one_grad(e.operands[0], gdim))
    if isinstance(e, Indexed):
        # grad(A[idx]) = grad(A)[idx] — Indexed consumes leading axes, the
        # new gradient axis is last, so plain Indexed is exactly right.
        return Indexed(_push_one_grad(e.operands[0], gdim), e.indices)
    if isinstance(e, ListTensor):
        return ListTensor(*[_push_one_grad(o, gdim) for o in e.operands])
    if isinstance(e, Conditional):
        return Conditional(e.operands[0],
                           _push_one_grad(e.operands[1], gdim),
                           _push_one_grad(e.operands[2], gdim))
    if isinstance(e, Inner):
        a, b = e.operands
        ga, gb = _push_one_grad(a, gdim), _push_one_grad(b, gdim)
        # d(a:b)_g = a_K dG b_{K g} + b_K dG a_{K g}
        return Sum(_contract_all_but_last(a, gb),
                   _contract_all_but_last(b, ga))
    if isinstance(e, Dot) and len(e.operands[0].shape) == 1 \
            and len(e.operands[1].shape) == 1:
        a, b = e.operands
        ga, gb = _push_one_grad(a, gdim), _push_one_grad(b, gdim)
        return Sum(Dot(a, gb), Dot(b, ga))
    raise NotImplementedError(
        f"grad() through {type(e).__name__}; rewrite the form with grad "
        "applied closer to terminals")


def _contract_all_but_last(a, gb):
    """a_K gb_{K g} -> vector over g.  Implemented with Inner over a
    ListTensor of gradient components when shapes are small."""
    from ..language.core import Indexed as Ix
    gdim = gb.shape[-1]
    comps = []
    for gax in range(gdim):
        comps.append(Inner(a, _index_last(gb, gax)))
    return ListTensor(*comps)


def _index_last(t, i):
    """t[..., i] — index the LAST axis, producing shape t.shape[:-1]."""
    return _LastIndex(t, i)


class _LastIndex(Expr):
    """Internal node: index the last value axis (used by grad pushdown)."""
    __slots__ = ("idx", "shape")

    def __init__(self, t, i):
        t = t
        super().__init__(t)
        self.idx = int(i)
        self.shape = t.shape[:-1]

    def _sig(self, rn):
        return f"LastIx{self.idx}({self.operands[0]._sig(rn)})"


def _expr_const_wrt_x(e):
    return all(isinstance(t, (ScalarValue, ConstantBase, Zero, Identity))
               for t in e.traverse() if isinstance(t, Terminal))
