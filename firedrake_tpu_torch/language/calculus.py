"""Form calculus: replace, Gateaux derivative, action, adjoint, lhs/rhs.

Reference surface: ufl.derivative/action/adjoint/replace/lhs/rhs/system as
re-exported by firedrake (firedrake/ufl_expr.py:90 derivative wrapper).

The lhs/rhs split exploits affinity: for F affine in the trial function,
    lhs(F) = F - F|_{trial=0},   rhs(F) = -F|_{trial=0},
with Zero-folding in the smart constructors doing the term elimination —
no ad-hoc "has the trial function" scanning of product trees needed.
"""
from __future__ import annotations

import numpy as np

from .core import (Expr, Terminal, Zero, ScalarValue, Argument, Coefficient,
                   ConstantBase, Sum, Product, Division, Power, Abs,
                   MathFunction, Atan2, MinMax, Indexed, Grad, Restricted,
                   Condition, BoolOp, Conditional, as_expr, Identity,
                   GeometricQuantity, SpatialCoordinate, Conj, Real, Imag)
from .tensor_algebra import (Inner, Dot, Outer, Cross, Transpose, Trace,
                             Determinant, Inverse, ListTensor)
from .operators import Div, Curl
from .measure import Form, Integral


# ---------------------------------------------------------------- rebuild
_LINEAR_ONE = (Grad, Indexed, Restricted, Transpose, Trace, ListTensor)
_MULTILINEAR = (Inner, Dot, Outer, Cross, Product)


def reconstruct(node: Expr, ops):
    """Rebuild a node with new operands, preserving non-operand state.

    Zero short-circuits use the ORIGINAL node's shape — constructors like
    Grad cannot infer the geometric dimension from a bare Zero operand."""
    t = type(node)
    if isinstance(node, Terminal):
        return node
    if (issubclass(t, _LINEAR_ONE) or t in (Div, Curl)) \
            and len(ops) >= 1 and all(o.is_zero() for o in ops):
        return Zero(node.shape)
    if issubclass(t, _MULTILINEAR) and any(o.is_zero() for o in ops):
        return Zero(node.shape)
    if t is Division and ops[0].is_zero():
        return Zero(node.shape)
    if t is Indexed:
        return Indexed(ops[0], node.indices)
    if t is MathFunction:
        return MathFunction(node.fname, ops[0])
    if t is Restricted:
        return Restricted(ops[0], node.side)
    if t is Condition:
        return Condition(node.op, *ops)
    if t is BoolOp:
        return BoolOp(node.op, *ops)
    if t is MinMax:
        return MinMax(node.which, *ops)
    if t is Product and len(ops) == 2 \
            and ops[0].shape != () and ops[0].shape == ops[1].shape:
        # a scalar product whose operands became equal-shaped vectors
        # under substitution (unsplit mixed terminals rewritten to their
        # flat component vectors): the contraction is the ufl semantics
        # of the original inner/dot on the mixed values
        from .tensor_algebra import Dot
        return Dot(ops[0], ops[1])
    return t(*ops)


def map_expr(e: Expr, mapping: dict, memo=None) -> Expr:
    """Substitute subtrees by identity (and also by ==-equal Functions)."""
    if memo is None:
        memo = {}
    key = id(e)
    hit = memo.get(key)
    if hit is not None and hit[0] is e:
        return hit[1]
    r = mapping.get(e)
    if r is not None:
        out = as_expr(r)
    elif isinstance(e, Terminal):
        out = e
    else:
        ops = [map_expr(o, mapping, memo) for o in e.operands]
        if all(a is b for a, b in zip(ops, e.operands)):
            out = e
        else:
            out = reconstruct(e, ops)
    memo[key] = (e, out)
    return out


def replace(form, mapping):
    """Replace terminals/subtrees in a Form or Expr."""
    mapping = {k: as_expr(v) for k, v in mapping.items()}
    if isinstance(form, Expr):
        return map_expr(form, mapping)
    out = []
    for it in form.integrals():
        integrand = map_expr(it.integrand, mapping)
        if not integrand.is_zero():
            out.append(it.reconstruct(integrand))
    return Form(tuple(out))


# -------------------------------------------------------------- derivative
_CHAIN = {
    "sin": lambda x: MathFunction("cos", x),
    "cos": lambda x: Product(ScalarValue(-1.0), MathFunction("sin", x)),
    "tan": lambda x: Division(ScalarValue(1.0),
                              Power(MathFunction("cos", x), ScalarValue(2.0))),
    "exp": lambda x: MathFunction("exp", x),
    "log": lambda x: Division(ScalarValue(1.0), x),
    "sqrt": lambda x: Division(ScalarValue(0.5), MathFunction("sqrt", x)),
    "sinh": lambda x: MathFunction("cosh", x),
    "cosh": lambda x: MathFunction("sinh", x),
    "tanh": lambda x: Sum(ScalarValue(1.0),
                          Product(ScalarValue(-1.0),
                                  Power(MathFunction("tanh", x),
                                        ScalarValue(2.0)))),
    "arcsin": lambda x: Power(Sum(ScalarValue(1.0),
                                  Product(ScalarValue(-1.0),
                                          Power(x, ScalarValue(2.0)))),
                              ScalarValue(-0.5)),
    "arccos": lambda x: Product(ScalarValue(-1.0),
                                Power(Sum(ScalarValue(1.0),
                                          Product(ScalarValue(-1.0),
                                                  Power(x, ScalarValue(2.0)))),
                                      ScalarValue(-0.5))),
    "arctan": lambda x: Division(ScalarValue(1.0),
                                 Sum(ScalarValue(1.0),
                                     Power(x, ScalarValue(2.0)))),
    "erf": lambda x: Product(ScalarValue(2.0 / np.sqrt(np.pi)),
                             MathFunction("exp",
                                          Product(ScalarValue(-1.0),
                                                  Power(x,
                                                        ScalarValue(2.0))))),
}


def _gateaux(e: Expr, u, du, memo) -> Expr:
    key = id(e)
    hit = memo.get(key)
    if hit is not None and hit[0] is e:
        return hit[1]
    out = _gateaux_impl(e, u, du, memo)
    assert out.shape == e.shape, (type(e).__name__, out.shape, e.shape)
    memo[key] = (e, out)
    return out


def _gateaux_impl(e, u, du, memo):
    if e is u:
        return du
    if isinstance(e, Terminal):
        return Zero(e.shape)
    g = lambda x: _gateaux(x, u, du, memo)
    t = type(e)
    a = e.operands
    if t is Sum:
        return Sum(g(a[0]), g(a[1]))
    if t is Product:
        return Sum(Product(g(a[0]), a[1]), Product(a[0], g(a[1])))
    if t is Division:
        return Sum(Division(g(a[0]), a[1]),
                   Product(ScalarValue(-1.0),
                           Division(Product(a[0], g(a[1])),
                                    Power(a[1], ScalarValue(2.0)))))
    if t is Power:
        base, expo = a
        dbase, dexpo = g(base), g(expo)
        terms = []
        if not dbase.is_zero():
            terms.append(Product(Product(expo, _lowered_power(base, expo)),
                                 dbase))
        if not dexpo.is_zero():
            terms.append(Product(Product(Power(base, expo),
                                         MathFunction("log", base)), dexpo))
        out = Zero(())
        for term in terms:
            out = Sum(out, term)
        return out
    if t is Abs:
        return Product(MathFunction("sign", a[0]), g(a[0]))
    if t is Conj:
        # antilinear: d conj(f)[du] = conj(df[du]) (real-perturbation
        # Gateaux convention, matching pyadjoint's treatment)
        return Conj(g(a[0]))
    if t is Real:
        return Real(g(a[0]))
    if t is Imag:
        return Imag(g(a[0]))
    if t is MathFunction:
        if e.fname == "sign":
            return Zero(())
        return Product(_CHAIN[e.fname](a[0]), g(a[0]))
    if t is Atan2:
        y, x = a
        denom = Sum(Power(x, ScalarValue(2.0)), Power(y, ScalarValue(2.0)))
        return Division(Sum(Product(x, g(y)),
                            Product(ScalarValue(-1.0), Product(y, g(x)))),
                        denom)
    if t is MinMax:
        cond = Condition("le" if e.which == "min" else "ge", a[0], a[1])
        return Conditional(cond, g(a[0]), g(a[1]))
    if t is Inner:
        return Sum(Inner(g(a[0]), a[1]), Inner(a[0], g(a[1])))
    if t is Dot:
        return Sum(Dot(g(a[0]), a[1]), Dot(a[0], g(a[1])))
    if t is Outer:
        return Sum(Outer(g(a[0]), a[1]), Outer(a[0], g(a[1])))
    if t is Cross:
        return Sum(Cross(g(a[0]), a[1]), Cross(a[0], g(a[1])))
    if t is Determinant:
        A = a[0]
        dA = g(A)
        if dA.is_zero():
            return Zero(())
        return Product(Determinant(A), Trace(Dot(Inverse(A), dA)))
    if t is Inverse:
        A = a[0]
        dA = g(A)
        if dA.is_zero():
            return Zero(e.shape)
        return Product(ScalarValue(-1.0),
                       Dot(Dot(Inverse(A), dA), Inverse(A)))
    if t is Conditional:
        return Conditional(a[0], g(a[1]), g(a[2]))
    if t in (Condition, BoolOp):
        raise ValueError("cannot differentiate a condition")
    # linear operators: rebuild with differentiated operands
    if t in (Grad, Div, Curl, Transpose, Trace, Indexed, Restricted,
             ListTensor):
        return reconstruct(e, [g(o) for o in a])
    raise NotImplementedError(f"derivative of {t.__name__}")


def _lowered_power(base, expo):
    """base ** (expo - 1), written as base where that exponent is the
    literal 1 and as 1 where it is 0 (the same values: so the derivative
    of a square, (u - d)**2, stays a product that K1's family takes)."""
    e1 = Sum(expo, ScalarValue(-1.0))
    if type(e1) is ScalarValue and e1.value == 1.0:
        return base
    if type(e1) is ScalarValue and e1.value == 0.0:
        return ScalarValue(1.0)
    return Power(base, e1)


def derivative(form, u, du=None):
    """Gateaux derivative of a Form (or Expr) w.r.t. coefficient u in
    direction du (default: a new Argument = trial function).  For a mixed
    Function, differentiates w.r.t. every part against the matching trial
    part (reference: ufl derivative over mixed coefficients)."""
    parts = getattr(u, "parts", None)
    if parts is not None and du is None:
        if isinstance(form, Form):
            # unsplit mixed terminals (incl. u itself) must become their
            # split parts first, else d/d(part) misses them
            from ..mixed import split_mixed_terminals
            form = split_mixed_terminals(form)
        nums = [arg.number for arg in form.arguments()]
        n = max(nums) + 1 if nums else 0
        trials = tuple(Argument(u.function_space().sub(i), n, part=i)
                       for i in range(len(parts)))
        out = None
        for p, t in zip(parts, trials):
            d = derivative(form, p, du=t)
            out = d if out is None else out + d
        return out
    if du is None:
        from .core import Argument as _Arg
        if isinstance(form, Form):
            nums = [arg.number for arg in form.arguments()]
        else:
            nums = [t.number for t in form.traverse()
                    if isinstance(t, Argument)]
        n = max(nums) + 1 if nums else 0
        du = _Arg(u.function_space(), n)
    if isinstance(form, Expr):
        return _gateaux(form, u, du, {})
    out = []
    for it in form.integrals():
        integrand = _gateaux(it.integrand, u, du, {})
        if not integrand.is_zero():
            out.append(it.reconstruct(integrand))
    return Form(tuple(out))


# ------------------------------------------------------------ form algebra
def action(form: Form, w):
    """Replace the trial function (highest-numbered argument) with w.
    On a mixed space the trial appears as per-part split Arguments —
    each part maps to the matching part of w (reference: ufl action +
    firedrake's argument splitting)."""
    args = form.arguments()
    if not args:
        raise ValueError("action needs a form with arguments")
    n = max(a.number for a in args)
    mapping = {}
    for t in (a for a in args if a.number == n):
        part = getattr(t, "part", None)
        if part is None:
            mapping[t] = w
        elif getattr(w, "parts", None) is not None:
            mapping[t] = w.parts[part]
        elif isinstance(w, Argument):
            from ..mixed import mixed_arguments, is_mixed
            mapping[t] = (mixed_arguments(w.space, w.number)[part]
                          if is_mixed(w.space) else w)
        else:
            mapping[t] = w
    return replace(form, mapping)


def adjoint(form: Form):
    """a*(u, v) = a(v, u): the TEST argument becomes the trial and vice
    versa (swapping the NUMBERS, not just the spaces — renaming spaces
    alone leaves the integrand, and thus the assembled matrix,
    untransposed; only visible for nonsymmetric Jacobians)."""
    args = form.arguments()
    assert len(args) == 2, "adjoint needs a bilinear form"
    v, u = args
    new_u = Argument(u.space, v.number)    # old trial -> test role
    new_v = Argument(v.space, u.number)    # old test  -> trial role
    return replace(form, {v: new_v, u: new_u})


def _split_integral(it):
    """(bilinear_part, linear_part) of one integral's integrand, using
    affinity in the trial function: bilinear = F - F|_{u=0}."""
    integrand = it.integrand
    trials = [t for t in integrand.traverse()
              if isinstance(t, Argument) and t.number >= 1]
    if not trials:
        return None, integrand
    sub = map_expr(integrand, {t: Zero(t.shape) for t in set(trials)})
    if sub.is_zero():
        return integrand, None
    if sub is integrand:
        return None, integrand
    return Sum(integrand, Product(ScalarValue(-1.0), sub)), sub


def lhs(form: Form) -> Form:
    out = []
    for it in form.integrals():
        bi, _ = _split_integral(it)
        if bi is not None and not bi.is_zero():
            out.append(it.reconstruct(bi))
    return Form(tuple(out))


def rhs(form: Form) -> Form:
    out = []
    for it in form.integrals():
        _, li = _split_integral(it)
        if li is not None and not li.is_zero():
            out.append(it.reconstruct(Product(ScalarValue(-1.0), li)))
    return Form(tuple(out))


def system(form: Form):
    return lhs(form), rhs(form)


def extract_blocks(form, test_space=None):
    raise NotImplementedError("mixed-space block extraction lands with "
                              "MixedFunctionSpace")
