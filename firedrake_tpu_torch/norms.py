"""Norms and error norms through 0-form assembly (the port's copy of
``firedrake_tpu/norms.py``; reference: firedrake/norms.py:12,42)."""
from __future__ import annotations

from .language import inner, grad, div, curl, dx
from .assemble import assemble


def norm(v, norm_type="L2", mesh=None):
    nt = norm_type.lower()
    if nt == "l2":
        form = inner(v, v) * dx
    elif nt == "h1":
        form = (inner(v, v) + inner(grad(v), grad(v))) * dx
    elif nt in ("h1_semi", "h1semi"):
        form = inner(grad(v), grad(v)) * dx
    elif nt == "hdiv":
        form = (inner(v, v) + inner(div(v), div(v))) * dx
    elif nt == "hcurl":
        form = (inner(v, v) + inner(curl(v), curl(v))) * dx
    elif nt == "linf":
        return float(v.dat.abs().max())
    else:
        raise ValueError(f"unknown norm type {norm_type!r}")
    return assemble(form) ** 0.5


def errornorm(u, uh, norm_type="L2", degree_rise=None, mesh=None):
    """||u - uh|| (reference: norms.py:12); u may be an expression, and the
    quadrature degree is estimated from both operands."""
    return norm(u - uh, norm_type=norm_type, mesh=mesh)
