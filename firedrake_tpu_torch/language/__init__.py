"""UFL-compatible symbolic language (public surface re-exported from the
top-level package, mirroring firedrake/__init__.py:48-49's `from ufl import *`)."""
from .core import (
    Expr, Zero, ScalarValue, Identity, PermutationSymbol,
    Argument, Coefficient, ConstantBase, GeometricQuantity,
    SpatialCoordinate, FacetNormal, CellDiameter, CellVolume, FacetArea,
    Sum, Product, Division, Power, Abs, MathFunction, Indexed, Grad,
    Restricted, Condition, BoolOp, Conditional, MinMax, Atan2, as_expr,
    Conj, Real, Imag, set_complex_mode, is_complex_mode,
)
from .tensor_algebra import (
    Inner, Dot, Outer, Cross, Transpose, Trace, Determinant, Inverse,
    ListTensor,
    inner, dot, outer, cross, transpose, tr, det, inv, sym, skew, dev,
    as_vector, as_matrix, as_tensor,
)
from .operators import (
    Div, Curl, grad, div, curl, rot, nabla_grad, nabla_div,
    sin, cos, tan, asin, acos, atan, atan2, atan_2, sinh, cosh, tanh,
    exp, ln, sqrt, erf, sign, Max, Min, max_value, min_value,
    conditional, lt, le, gt, ge, eq, ne, And, Or, Not,
    avg, jump, conj, real, imag,
)
from .freeindex import Index, indices, FreeExpr
from .measure import (Measure, Integral, Form, Equation, dx, ds, dS,
                      ds_b, ds_t, ds_v)
from .calculus import (replace, derivative, action, adjoint, lhs, rhs,
                       system, reconstruct, map_expr)


def TestFunction(V):
    return Argument(V, 0)


def TrialFunction(V):
    return Argument(V, 1)


def TestFunctions(V):
    return split(TestFunction(V))


def TrialFunctions(V):
    return split(TrialFunction(V))


def split(u):
    """Split a mixed function/argument into components (UFL split); a
    function or argument on a plain space is its own only component."""
    V = u.function_space()
    if type(V).__name__ == "MixedFunctionSpace":
        raise NotImplementedError("split of a mixed space is not ported "
                                  "yet: ROADMAP.md queue 1, item 14")
    return (u,)


def CellSize(mesh):
    return CellDiameter(mesh)


__all__ = [n for n in dir() if not n.startswith("_")]
