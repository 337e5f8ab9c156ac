"""Solver composition from PETSc-style options trees (reference role:
firedrake/dmhooks.py + PETSc's options-prefix machinery): a
``solver_parameters`` dict whose prefixed keys configure nested solvers,
e.g. ``mg_levels_ksp_type``, ``mg_levels_pc_type``, ``mg_coarse_pc_type``.

Every solver/PC built here is a callable on device tensors.  Ported so
far: ``none``, ``jacobi``, ``lu``/``cholesky``, ``ksp``, ``mg`` (geometric
multigrid) and ``patch`` (vertex-star additive Schwarz), under any of the
KSP methods of solvers/krylov.py.  Every other ``pc_type`` raises
NotImplementedError naming ROADMAP.md queue 1, item 16.
"""
from __future__ import annotations

import numpy as np
import torch

from .krylov import KSP_METHODS, _norm
from .preconditioners import identity_pc
from ..device import as_tensor, to_numpy

__all__ = ["OpCtx", "build_ksp", "build_pc"]

#: largest operator that the lu PC inverts densely on the device; above
#: it, a host sparse LU
_DENSE_LIMIT = 6000


def _power_lmax(apply, n, iters):
    """lambda_max of a linear map by power iteration from the JAX
    package's seeded start vector (numpy, then moved to the device), so
    that both packages smooth with the same bounds.  One host read, at
    the end."""
    x = as_tensor(np.random.default_rng(0).standard_normal(n))
    for _ in range(iters):
        y = apply(x)
        x = y / _norm(y)
    return float(_norm(apply(x)))


class OpCtx:
    """Everything a nested solver needs to build itself.

    mat     operator with BCs applied: assembled, or matrix-free
            (assembly/matfree.py: its diagonal is assembled, its
            action assembled per call); None when only matvec is given.
    matvec  y = A @ x (defaults to mat.matvec).
    space   FunctionSpace of the (sub)problem.
    form    the bilinear form, for re-discretization PCs (mg).
    bcs     DirichletBCs restricted to this space.
    appctx  user application context.
    """

    def __init__(self, *, mat=None, matvec=None, space=None, form=None,
                 bcs=(), appctx=None):
        self.mat = mat
        self.matvec = matvec if matvec is not None else (
            mat.matvec if mat is not None else None)
        self.space = space
        self.form = form
        self.bcs = tuple(bcs or ())
        self.appctx = appctx or {}
        self._cheb_bounds = None

    @property
    def dim(self):
        if self.mat is not None:
            return self.mat.shape[0]
        return self.space.dim

    def diagonal(self):
        if self.mat is None:
            raise ValueError(
                "this preconditioner needs an assembled operator; got a "
                "matrix-free context")
        return self.mat.diagonal()

    def cheb_bounds(self):
        """(emin, emax) estimate for D^-1 A by 12 power iterations (the
        PETSc ksp_chebyshev_esteig role), as host floats."""
        if self._cheb_bounds is None:
            d = self.diagonal()
            dinv = torch.where(torch.abs(d) > 0, 1.0 / d,
                               torch.ones_like(d))
            lam = _power_lmax(lambda x: dinv * self.matvec(x), self.dim,
                              12)
            self._cheb_bounds = (0.25 * lam, 1.05 * lam)
        return self._cheb_bounds


def opt(params, prefix, key, default=None):
    return params.get(prefix + key, default)


# --------------------------------------------------------------------- KSP
def build_ksp(ctx: OpCtx, params: dict, prefix: str = ""):
    """Return solve(b, x0=None) -> x, an approximate inverse of ctx's
    operator, configured by `<prefix>ksp_*` / `<prefix>pc_*`.

    Inner (prefixed) KSPs default to preonly+<pc>, matching PETSc's
    sub-KSP defaults; tolerances default looser than the outer solve
    (rtol 1e-5, max_it 100)."""
    inner = bool(prefix)
    ksp_type = opt(params, prefix, "ksp_type",
                   "preonly" if inner else "gmres")
    pc = build_pc(ctx, params, prefix)
    if ksp_type == "preonly":
        return lambda b, x0=None: pc(b)
    meth = KSP_METHODS.get(ksp_type)
    if meth is None:
        raise NotImplementedError(
            f"ksp_type {ksp_type!r} (prefix {prefix!r}) is not ported yet; "
            f"available: {sorted(KSP_METHODS)} and preonly")
    kw = dict(rtol=float(opt(params, prefix, "ksp_rtol",
                             1e-5 if inner else 1e-7)),
              atol=float(opt(params, prefix, "ksp_atol", 1e-50)),
              max_it=int(opt(params, prefix, "ksp_max_it",
                             100 if inner else 10000)))
    if ksp_type in ("gmres", "fgmres"):
        kw["restart"] = int(opt(params, prefix, "ksp_gmres_restart", 30))
    if ksp_type == "chebyshev":
        pct = opt(params, prefix, "pc_type",
                  "jacobi" if ctx.mat is not None else "none")
        if pct == "jacobi":
            emin, emax = ctx.cheb_bounds()
        else:
            # the spectrum of the ACTUAL preconditioned operator (PETSc
            # esteig semantics): Jacobi bounds on a patch-smoothed
            # operator put the Chebyshev interval far off
            emin, emax = _preconditioned_bounds(ctx, pc)
        kw["emin"], kw["emax"] = emin, emax
    if ksp_type == "richardson":
        kw["damping"] = float(opt(params, prefix,
                                  "ksp_richardson_scale", 1.0))
    op = ctx.matvec

    def solve(b, x0=None):
        return meth(op, b, x0=x0, pc=pc, **kw).x

    # the whole KSP result (iterations, convergence), for the condensed
    # solves of solvers/scpc.py and solvers/hybridization.py
    solve._full = lambda b, x0=None: meth(op, b, x0=x0, pc=pc, **kw)
    return solve


def _preconditioned_bounds(ctx, pc, iters=15):
    """(emin, emax) for M^-1 A by power iteration, as host floats."""
    mv = ctx.matvec
    lam = _power_lmax(lambda x: pc(mv(x)), ctx.dim, iters)
    return 0.25 * lam, 1.05 * lam


# ---------------------------------------------------------------------- PC
def build_pc(ctx: OpCtx, params: dict, prefix: str = ""):
    """Return pc(r) -> z for `<prefix>pc_type`."""
    pc_type = opt(params, prefix, "pc_type",
                  "jacobi" if ctx.mat is not None else "none")
    make = _PCS.get(pc_type)
    if make is None:
        raise NotImplementedError(
            f"pc_type {pc_type!r} (prefix {prefix!r}) is not ported yet "
            "(the rest of the PC zoo is ROADMAP.md queue 1, item 16); "
            f"available: {sorted(_PCS)}")
    return make(ctx, params, prefix)


def _pc_none(ctx, params, prefix):
    return identity_pc


def _pc_jacobi(ctx, params, prefix):
    d = ctx.diagonal()
    dinv = torch.where(torch.abs(d) > 0, 1.0 / d, torch.ones_like(d))
    return lambda r: dinv * r


def _pc_lu(ctx, params, prefix):
    """Exact inverse: a dense inverse on the device up to
    pc_factor_dense_limit unknowns, a host sparse LU above it."""
    from ..assembly.matfree import is_matfree
    n = ctx.dim
    limit = int(opt(params, prefix, "pc_factor_dense_limit", _DENSE_LIMIT))
    if ctx.mat is None or is_matfree(ctx.mat):
        raise ValueError("pc_type 'lu' needs an assembled operator; got "
                         "mat_type 'matfree'")
    if n <= limit:
        Ainv = as_tensor(np.linalg.inv(ctx.mat.to_dense()))
        return lambda r: Ainv @ r
    from scipy.sparse.linalg import splu
    lu = splu(ctx.mat.to_scipy().tocsc())
    return lambda r: torch.as_tensor(
        lu.solve(to_numpy(r).astype(np.float64)), dtype=r.dtype,
        device=r.device)


def _pc_ksp(ctx, params, prefix):
    """PCKSP: a full inner Krylov solve as the preconditioner."""
    return build_ksp(ctx, params, prefix + "ksp_")


def _pc_mg(ctx, params, prefix):
    from ..mg.vcycle import GMGPreconditioner
    if ctx.form is None or ctx.space is None:
        raise ValueError("pc_type 'mg' needs the bilinear form + space "
                         "(re-discretization)")
    return GMGPreconditioner(ctx.form, ctx.bcs, ctx.space,
                             params=params, prefix=prefix,
                             appctx=ctx.appctx)


def _pc_patch(ctx, params, prefix):
    from .preconditioners import make_star_patch
    if ctx.mat is None or ctx.space is None:
        raise ValueError("patch pc needs an assembled matrix + space")
    return make_star_patch(ctx.mat, ctx.space)


_PCS = {"none": _pc_none, "jacobi": _pc_jacobi, "lu": _pc_lu,
        "cholesky": _pc_lu, "ksp": _pc_ksp, "mg": _pc_mg,
        "patch": _pc_patch, "asm": _pc_patch, "star": _pc_patch}
