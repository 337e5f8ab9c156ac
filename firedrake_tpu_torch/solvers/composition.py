"""Solver composition from PETSc-style options trees (reference role:
firedrake/dmhooks.py + PETSc's options-prefix machinery): a
``solver_parameters`` dict whose prefixed keys configure nested solvers,
e.g. ``mg_levels_ksp_type``, ``mg_levels_pc_type``, ``mg_coarse_pc_type``.

Every solver/PC built here is a callable on device tensors.  Ported:
``none``, ``jacobi`` (and ``bjacobi``/``sor``/``ilu``/``icc``, which
substitute it with a warning), ``lu``/``cholesky``, ``ksp``, ``mg``/
``gamg`` (geometric multigrid), ``patch`` (vertex-star additive Schwarz),
``vanka``, ``pmg`` (p-multigrid, mg/pmg.py), the line and column
smoothers ``linesmooth``, ``extruded_star`` and ``gridline``
(solvers/asm.py), ``python`` (solvers/pcs.py and user subclasses),
``composite`` and ``fieldsplit`` (additive, multiplicative,
symmetric_multiplicative and Schur), under any of the KSP methods of
solvers/krylov.py.  ``hypre`` has no analogue.
"""
from __future__ import annotations

import warnings

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
            f"pc_type {pc_type!r} (prefix {prefix!r}) is not ported yet; "
            f"available: {sorted(_PCS)}")
    return make(ctx, params, prefix)


def _pc_none(ctx, params, prefix):
    return identity_pc


def _pc_jacobi(ctx, params, prefix):
    d = ctx.diagonal()
    dinv = torch.where(torch.abs(d) > 0, 1.0 / d, torch.ones_like(d))
    return lambda r: dinv * r


#: (pc_type, prefix) pairs already warned about
_warned_substitutions = set()


def _pc_jacobi_substitute(ctx, params, prefix):
    """bjacobi, sor, ilu and icc: point-Jacobi, with a warning once per
    (type, prefix), as in the JAX package."""
    pc_type = opt(params, prefix, "pc_type")
    if (pc_type, prefix) not in _warned_substitutions:
        _warned_substitutions.add((pc_type, prefix))
        warnings.warn(
            f"pc_type {pc_type!r} has no native implementation; "
            "substituting point-Jacobi. Expect different convergence: "
            "consider 'jacobi', 'patch'/'vanka' smoothers, 'mg', or a "
            "python PC instead.", stacklevel=3)
    return _pc_jacobi(ctx, params, prefix)


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


def _pc_pmg(ctx, params, prefix):
    from ..mg.pmg import PMGPC
    if ctx.form is None or ctx.space is None:
        raise ValueError("pc_type 'pmg' needs the bilinear form + space")
    return PMGPC(ctx.form, ctx.bcs, ctx.space, params=params,
                 prefix=prefix, appctx=ctx.appctx, A_fine=ctx.mat)


def _python_pc(name):
    """A builder running the python PC ``name`` of solvers/pcs.py (the
    pc_type aliases of the ASM family)."""
    def make(ctx, params, prefix):
        from . import pcs as _pcs
        pc_obj = getattr(_pcs, name)()
        pc_obj.initialize_ctx(ctx, params, prefix)
        return pc_obj.apply
    return make


def _pc_patch(ctx, params, prefix):
    from .preconditioners import make_star_patch
    if ctx.mat is None or ctx.space is None:
        raise ValueError("patch pc needs an assembled matrix + space")
    return make_star_patch(ctx.mat, ctx.space)


def _pc_vanka(ctx, params, prefix):
    from .preconditioners import make_vanka_patch
    if ctx.mat is None or ctx.space is None:
        raise ValueError("vanka pc needs an assembled matrix + space")
    exclude = opt(params, prefix, "pc_vanka_exclude_field", None)
    return make_vanka_patch(ctx.mat, ctx.space, exclude_field=exclude)


def _pc_python(ctx, params, prefix):
    name = opt(params, prefix, "pc_python_type", "")
    pc_obj = _resolve_python_pc(name)()
    pc_obj.initialize_ctx(ctx, params, prefix)
    return pc_obj.apply


def _resolve_python_pc(name):
    """``firedrake.X`` (or plain ``X``) is solvers/pcs.py's X; any other
    dotted path is imported (a user's AuxiliaryOperatorPC subclass)."""
    from . import pcs as _pcs
    short = name.rsplit(".", 1)[-1]
    if short in _pcs.__all__:
        return getattr(_pcs, short)
    if "." in name and not name.startswith("firedrake."):
        import importlib
        mod, cls = name.rsplit(".", 1)
        try:
            return getattr(importlib.import_module(mod), cls)
        except (ImportError, AttributeError) as e:
            raise ImportError(f"cannot resolve pc_python_type {name!r}: "
                              f"{e}") from e
    raise NotImplementedError(
        f"pc_python_type {name!r} is not a python PC of solvers/pcs.py; "
        f"available: {sorted(_pcs.__all__)}")


def _pc_composite(ctx, params, prefix):
    """PCCOMPOSITE: additive or multiplicative combination of sub-PCs
    configured under sub_0_, sub_1_, ... prefixes."""
    names = [s.strip() for s in
             opt(params, prefix, "pc_composite_pcs", "").split(",") if s]
    ctype = opt(params, prefix, "pc_composite_type", "additive")
    subs = []
    for i, nm in enumerate(names):
        sub_params = dict(params)
        sub_params[prefix + f"sub_{i}_pc_type"] = nm
        subs.append(build_pc(ctx, sub_params, prefix + f"sub_{i}_"))
    op = ctx.matvec

    def pc(r):
        z = subs[0](r)
        for s in subs[1:]:
            z = z + (s(r) if ctype == "additive" else s(r - op(z)))
        return z

    return pc


# --------------------------------------------------------------- fieldsplit
def _field_bcs(ctx, i):
    """Dirichlet BCs of mixed field i, re-rooted on the plain subspace
    (so re-discretization PCs like mg can rebuild them per level)."""
    from ..bcs import DirichletBC
    out = []
    for b in ctx.bcs:
        fs = getattr(b, "function_space_obj", None)
        if getattr(fs, "index", None) == i and \
                getattr(fs, "parent", None) is ctx.space:
            out.append(DirichletBC(fs._V, b.g, b.sub_domain,
                                   b.sub_component))
    return tuple(out)


def _field_ctx(ctx, i):
    """OpCtx of diagonal block i of a mixed operator."""
    W = ctx.space
    Bi = ctx.mat.blocks.get((i, i)) if ctx.mat is not None else None
    return OpCtx(mat=Bi, space=W.subspaces[i], form=_block_form(ctx, i, i),
                 bcs=_field_bcs(ctx, i), appctx=ctx.appctx)


def _block_form(ctx, i, j):
    """Bilinear form of block (i, j) with its arguments re-rooted on the
    plain subspaces (for re-discretization PCs); None without a form."""
    form, W = ctx.form, ctx.space
    if form is None or W is None:
        return None
    from ..mixed import extract_block
    from ..language.core import Argument
    from ..language.calculus import map_expr
    from ..language.measure import Form
    blk = extract_block(form, i, j)
    mapping = {}
    for it in blk.integrals():
        for t in it.integrand.traverse():
            if isinstance(t, Argument) and t.part is not None:
                mapping[t] = Argument(W.subspaces[t.part], t.number)
    return Form(tuple(it.reconstruct(map_expr(it.integrand, mapping))
                      for it in blk.integrals()))


def _pc_fieldsplit(ctx, params, prefix):
    W = ctx.space
    # a mixed space, or FacetSplitPC's blocks of one space
    if not hasattr(W, "subspaces"):
        raise ValueError("pc_type 'fieldsplit' needs a mixed space")
    A = ctx.mat
    if A is None:
        raise ValueError("fieldsplit needs an assembled block operator "
                         "(mat_type aij)")
    nf = W.num_sub_spaces
    fs_type = opt(params, prefix, "pc_fieldsplit_type", "additive")
    bounds = [(int(o), int(o) + V.dim)
              for o, V in zip(W.offsets, W.subspaces)]

    def split(r):
        return [r[a:b] for a, b in bounds]

    def inner_solver(i):
        fc = _field_ctx(ctx, i)
        if fc.mat is None:
            # zero diagonal block (e.g. Stokes pressure): identity
            return lambda b, x0=None: b
        return build_ksp(fc, params, prefix + f"fieldsplit_{i}_")

    if fs_type in ("additive", "multiplicative",
                   "symmetric_multiplicative"):
        inner = [inner_solver(i) for i in range(nf)]

        def sweep(rs, zs, order):
            """Block Gauss-Seidel: recompute field i's residual from all
            fields with corrections so far, then solve block (i, i)."""
            for i in order:
                ri = rs[i]
                for j in range(nf):
                    B = A.blocks.get((i, j))
                    if j != i and zs[j] is not None and B is not None:
                        ri = ri - B.matvec(zs[j])
                zs[i] = inner[i](ri)
            return zs

        def pc(r):
            rs = split(r)
            if fs_type == "additive":
                return torch.cat([f(ri) for f, ri in zip(inner, rs)])
            zs = sweep(rs, [None] * nf, range(nf))
            if fs_type == "symmetric_multiplicative":
                zs = sweep(rs, zs, range(nf - 2, -1, -1))
            return torch.cat(zs)

        return pc

    if fs_type != "schur":
        raise NotImplementedError(f"pc_fieldsplit_type {fs_type!r}")
    if nf != 2:
        raise ValueError("schur fieldsplit needs exactly 2 fields")
    return _schur_pc(ctx, params, prefix, split)


def _schur_pc(ctx, params, prefix, split):
    """Schur-complement fieldsplit: factorization full/diag/lower/upper,
    Schur preconditioned per pc_fieldsplit_schur_precondition
    (a11 | user | selfp | full)."""
    A = ctx.mat
    A00, A01, A10, A11 = (A.blocks.get(ij)
                          for ij in ((0, 0), (0, 1), (1, 0), (1, 1)))
    fact = opt(params, prefix, "pc_fieldsplit_schur_fact_type", "full")
    sp_kind = opt(params, prefix, "pc_fieldsplit_schur_precondition",
                  "a11")

    ctx0 = _field_ctx(ctx, 0)
    inv0 = build_ksp(ctx0, params, prefix + "fieldsplit_0_")

    def a10(z0):
        return A10.matvec(z0) if A10 is not None else 0.0

    def a01(z1):
        return A01.matvec(z1) if A01 is not None else 0.0

    # Schur operator S = A11 - A10 inv0 A01, matrix-free, with the
    # preconditioner-quality inv0 (PETSc's semantics when fieldsplit_0 is
    # preonly; with an inner KSP this is the "full" inner solve)
    def S_matvec(x1):
        y = A01.matvec(x1) if A01 is not None else x1.new_zeros(ctx0.dim)
        out = A11.matvec(x1) if A11 is not None else torch.zeros_like(x1)
        return out - a10(inv0(y))

    # the matrix the Schur PC is built against
    V1 = ctx.space.subspaces[1]
    if sp_kind == "selfp":
        # Sp = A11 - A10 diag(A00)^-1 A01, a host scipy product
        import scipy.sparse as sp
        from ..assembly.matrix import Matrix
        d0 = to_numpy(ctx0.diagonal())
        d0inv = sp.diags(np.where(np.abs(d0) > 0, 1.0 / d0, 1.0))
        Sp_sci = (-(A10.to_scipy() @ d0inv @ A01.to_scipy())).tocsr()
        if A11 is not None:
            Sp_sci = (A11.to_scipy() + Sp_sci).tocsr()
        Smat = Matrix.from_scipy(Sp_sci, V1)
    elif sp_kind in ("a11", "user"):
        Smat = A11
    elif sp_kind == "full":
        Smat = None   # matrix-free on S itself
    else:
        raise NotImplementedError(
            f"pc_fieldsplit_schur_precondition {sp_kind!r}")

    ctx1 = OpCtx(mat=Smat, matvec=S_matvec, space=V1,
                 form=_block_form(ctx, 1, 1), bcs=_field_bcs(ctx, 1),
                 appctx=ctx.appctx)
    p1 = params
    if Smat is None and opt(params, prefix + "fieldsplit_1_",
                            "pc_type") in (
            "jacobi", "bjacobi", "sor", "ilu", "icc", "lu", "cholesky"):
        # no Schur matrix to precondition with (zero A11 under a11, or
        # full): unpreconditioned, as in the JAX package
        p1 = dict(params)
        p1[prefix + "fieldsplit_1_pc_type"] = "none"
    inv1 = build_ksp(ctx1, p1, prefix + "fieldsplit_1_")

    def pc(r):
        r0, r1 = split(r)
        if fact == "diag":
            # PETSc's convention: -S^-1 on the (1, 1) block (minres-safe)
            return torch.cat([inv0(r0), -inv1(r1)])
        if fact == "lower":
            z0 = inv0(r0)
            return torch.cat([z0, inv1(r1 - a10(z0))])
        if fact == "upper":
            z1 = inv1(r1)
            return torch.cat([inv0(r0 - a01(z1)), z1])
        # full
        z0 = inv0(r0)
        z1 = inv1(r1 - a10(z0))
        return torch.cat([z0 - inv0(a01(z1)), z1])

    return pc


def _pc_hypre(ctx, params, prefix):
    raise NotImplementedError(
        "pc_type 'hypre' (BoomerAMG) has no analogue in the port or the "
        "JAX package; use 'mg' (geometric, needs a MeshHierarchy)")


_PCS = {"none": _pc_none, "jacobi": _pc_jacobi,
        "bjacobi": _pc_jacobi_substitute, "sor": _pc_jacobi_substitute,
        "ilu": _pc_jacobi_substitute, "icc": _pc_jacobi_substitute,
        "lu": _pc_lu, "cholesky": _pc_lu, "ksp": _pc_ksp, "mg": _pc_mg,
        "gamg": _pc_mg, "pmg": _pc_pmg, "patch": _pc_patch,
        "asm": _pc_patch, "star": _pc_patch, "vanka": _pc_vanka,
        "linesmooth": _python_pc("ASMLinesmoothPC"),
        "extruded_star": _python_pc("ASMExtrudedStarPC"),
        "gridline": _python_pc("ASMGridLinePC"), "python": _pc_python,
        "composite": _pc_composite, "fieldsplit": _pc_fieldsplit,
        "hypre": _pc_hypre}
