"""Python preconditioner classes (the port's copy of
``firedrake_tpu/solvers/pcs.py``; reference: the firedrake/preconditioners
zoo).

- PCBase (firedrake/preconditioners/base.py): initialize/apply.
- AssembledPC (assembled.py): assemble the (possibly matrix-free)
  operator's form and precondition it with options under `assembled_`.
- AuxiliaryOperatorPC (assembled.py): a subclass provides
  `form(pc, test, trial) -> (a, bcs)`; inner options under `aux_`.
- MassInvPC (massinv.py): the (1/mu)-weighted mass matrix on the space,
  options under `Mp_`: the Stokes Schur workhorse.
- PCDPC (pcd.py): the pressure convection-diffusion Schur approximation
  y = Kp^-1 Fp Mp^-1 x, appctx keys "Re", "state"/"velocity", options
  under `Mp_`/`Kp_`.

A PC is built once at solver set-up; `apply` is a callable on device
tensors.  FDMPC and P1PC (solvers/fdm.py), ASMLinesmoothPC,
ASMExtrudedStarPC and ASMGridLinePC (solvers/asm.py) and FacetSplitPC
(solvers/facet_split.py), HiptmairPC (solvers/hiptmair.py), GTMGPC
(solvers/gtmg.py) and BDDCPC (solvers/bddc.py) are resolved here by name,
as in the JAX package.  CovariancePC (preconditioners/covariance.py)
pairs with adjoint/covariance.py's CovarianceMat.
"""
from __future__ import annotations

import importlib

import torch

from ..device import as_tensor

__all__ = ["PCBase", "AssembledPC", "AuxiliaryOperatorPC", "MassInvPC",
           "PCDPC", "FDMPC", "P1PC", "ASMLinesmoothPC",
           "ASMExtrudedStarPC", "ASMGridLinePC", "FacetSplitPC",
           "HiptmairPC", "GTMGPC", "BDDCPC", "CovariancePC"]

#: python PCs of the other solver modules, bound on first use (those
#: modules import PCBase from here)
_LATE = {"FDMPC": "fdm", "P1PC": "fdm", "ASMLinesmoothPC": "asm",
         "ASMExtrudedStarPC": "asm", "ASMGridLinePC": "asm",
         "FacetSplitPC": "facet_split", "HiptmairPC": "hiptmair",
         "GTMGPC": "gtmg", "BDDCPC": "bddc"}


def __getattr__(name):
    mod = _LATE.get(name)
    if mod is not None:
        return getattr(importlib.import_module(f".{mod}", __package__),
                       name)
    raise AttributeError(name)


class PCBase:
    """Base for python PCs.  Subclasses implement initialize_ctx (or just
    `form`, for auxiliary-operator PCs) and apply(r) -> z."""

    _prefix = ""

    @staticmethod
    def get_appctx(pc):
        return pc.appctx

    def initialize_ctx(self, ctx, params, prefix):
        raise NotImplementedError

    def apply(self, r):
        raise NotImplementedError


class AssembledPC(PCBase):
    """Assemble the operator's own bilinear form and precondition it with
    `assembled_*` options (reference: preconditioners/assembled.py
    AssembledPC: an assembled PC for a matrix-free outer operator)."""

    _prefix = "assembled_"

    def form(self, pc, test=None, trial=None):
        """(a, bcs); by default the operator's own form and BCs."""
        return self._ctx.form, self._ctx.bcs

    def initialize_ctx(self, ctx, params, prefix):
        from ..assemble import assemble
        from ..language.core import Argument
        from .composition import OpCtx, build_ksp
        self._ctx = ctx
        self.appctx = ctx.appctx
        sub_prefix = prefix + self._prefix
        V = ctx.space
        a, bcs = self.form(self, Argument(V, 0), Argument(V, 1))
        if a is None:
            raise ValueError(f"{type(self).__name__} could not obtain a "
                             "form to assemble")
        A = assemble(a, bcs=list(bcs) if bcs else None)
        ictx = OpCtx(mat=A, space=V, form=a, bcs=bcs, appctx=ctx.appctx)
        # default inner configuration: preonly + lu (the exact inverse)
        p = dict(params)
        p.setdefault(sub_prefix + "ksp_type", "preonly")
        p.setdefault(sub_prefix + "pc_type", "lu")
        self._solve = build_ksp(ictx, p, sub_prefix)

    def apply(self, r):
        return self._solve(r)


class AuxiliaryOperatorPC(AssembledPC):
    """Precondition with a user's auxiliary operator: subclass and
    override `form(self, pc, test, trial) -> (a, bcs)` (reference:
    assembled.py AuxiliaryOperatorPC).  Options prefix `aux_`."""

    _prefix = "aux_"

    def form(self, pc, test, trial):
        raise NotImplementedError(
            "subclass AuxiliaryOperatorPC and implement form()")


class MassInvPC(AuxiliaryOperatorPC):
    """Inverse (1/mu)-weighted mass matrix on the space, spectrally
    equivalent to the Stokes Schur complement (reference: massinv.py).
    Viscosity from appctx["mu"] (default 1).  Options prefix `Mp_`."""

    _prefix = "Mp_"

    def form(self, pc, test, trial):
        from ..language.measure import dx
        from ..language.tensor_algebra import inner
        mu = self.get_appctx(pc).get("mu", 1.0)
        return inner((1.0 / mu) * trial, test) * dx, ()


def _dense_pinv_solver(A):
    """Pseudo-inverse apply, for the singular Neumann Laplacian (constant
    nullspace) inside PCD: the pseudo-inverse of the symmetric matrix at
    relative cut-off 1e-10, as the JAX package's numpy pinv, made on the
    device."""
    Ainv = torch.linalg.pinv(as_tensor(A.to_dense()), rtol=1e-10,
                             hermitian=True)
    return lambda r: Ainv @ r


class PCDPC(PCBase):
    """Pressure-convection-diffusion Schur complement approximation for
    Navier-Stokes (reference: pcd.py:155): S^-1 ~ Kp^-1 Fp Mp^-1, with Mp
    the pressure mass matrix, Kp the pressure stiffness and Fp = (1/Re)
    Kp + convection by the current velocity.

    appctx: "Re" (default 1), "state" (the mixed solution Function) and
    "velocity_space" (its field index, default 0), or "velocity".  The
    user's pressure block carries the sign that makes S ~ -(this), as in
    the reference."""

    def initialize_ctx(self, ctx, params, prefix):
        from ..assemble import assemble
        from ..language.core import Argument
        from ..language.measure import dx
        from ..language.tensor_algebra import inner
        from ..language.operators import grad
        from .composition import OpCtx, build_ksp, opt
        self.appctx = ctx.appctx
        Q = ctx.space
        q, p = Argument(Q, 0), Argument(Q, 1)
        Re = ctx.appctx.get("Re", 1.0)
        u0 = ctx.appctx.get("velocity")
        if u0 is None:
            u0 = ctx.appctx["state"].subfunctions[
                ctx.appctx.get("velocity_space", 0)]
        mass = inner(p, q) * dx
        stiff = inner(grad(p), grad(q)) * dx
        fp = (1.0 / Re) * inner(grad(p), grad(q)) * dx \
            + inner(u0, grad(p)) * q * dx
        Mp, Kp = assemble(mass), assemble(stiff)
        self._Fp = assemble(fp)
        # the Mp solve: options under <prefix>Mp_, by default exact
        mctx = OpCtx(mat=Mp, space=Q, form=mass, appctx=ctx.appctx)
        pm = dict(params)
        pm.setdefault(prefix + "Mp_ksp_type", "preonly")
        pm.setdefault(prefix + "Mp_pc_type", "lu")
        self._Mp_solve = build_ksp(mctx, pm, prefix + "Mp_")
        # Kp is singular (Neumann): the pseudo-inverse unless configured
        if opt(params, prefix, "Kp_pc_type") is None:
            self._Kp_solve = _dense_pinv_solver(Kp)
        else:
            kctx = OpCtx(mat=Kp, space=Q, form=stiff, appctx=ctx.appctx)
            self._Kp_solve = build_ksp(kctx, dict(params), prefix + "Kp_")

    def apply(self, r):
        return self._Kp_solve(self._Fp.matvec(self._Mp_solve(r)))


class CovariancePC(PCBase):
    """Apply the opposite of a CovarianceMat's operation — the
    action/inverse pairing makes a Krylov solve over a covariance
    operator converge in O(1) iterations (reference:
    preconditioners/covariance.py:6-119).

    The CovarianceMat is found on ctx.mat, or under appctx
    {"covariance": <CovarianceOperatorBase>} (then the Mat operation
    defaults to ACTION and this PC applies the INVERSE)."""

    def initialize_ctx(self, ctx, params, prefix):
        from ..adjoint.covariance import CovarianceMat
        mat = ctx.mat if isinstance(ctx.mat, CovarianceMat) else None
        if mat is None:
            cov = ctx.appctx.get("covariance")
            if cov is None:
                raise TypeError(
                    "CovariancePC needs a CovarianceMat operator or "
                    "appctx={'covariance': <operator>}")
            mat = CovarianceMat(cov, CovarianceMat.ACTION)
        cov = mat.covariance
        self.covariance = cov
        if mat.operation == CovarianceMat.ACTION:
            self.operation = CovarianceMat.INVERSE
            self._apply = cov._inverse
        else:
            self.operation = CovarianceMat.ACTION
            self._apply = cov._action

    def apply(self, r):
        return self._apply(r)
