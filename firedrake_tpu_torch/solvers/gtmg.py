"""GTMGPC: non-nested two-level multigrid (Gopalakrishnan & Tan 2009), the
port's copy of ``firedrake_tpu/solvers/gtmg.py``.

Reference surface: firedrake/preconditioners/gtmg.py:246 GTMGPC, a PCMG
V(1,1)-cycle between the problem's fine space (canonically the
hybridization trace space) and a user-defined coarse space supplied
through the appctx:

  * ``get_coarse_space()``    -> the coarse FunctionSpace (e.g. CG1)
  * ``get_coarse_operator()`` -> the coarse bilinear form
  * ``coarse_space_bcs``      -> bcs on the coarse space (optional)
  * ``interpolation_matrix``  -> coarse->fine transfer (optional; the
    default interpolates the coarse trial function into the fine space,
    exact for facet-midpoint (degree-0) trace targets)
  * ``restriction_matrix``    -> fine->coarse transfer (optional; the
    default is the interpolation's transpose)

The transfer is a device Matrix and the default restriction its transpose
as a matrix of its own (sums in a fixed order); smoother and coarse solve
come from the options tree (``gt_mg_levels_*``, ``gt_mg_coarse_*``)."""
from __future__ import annotations

import numpy as np

from .pcs import PCBase
from ..device import as_tensor

__all__ = ["GTMGPC"]


class GTMGPC(PCBase):
    """Two-level non-nested MG from appctx callbacks (prefix ``gt_``)."""

    _prefix = "gt_"

    def initialize_ctx(self, ctx, params, prefix):
        from ..assemble import assemble
        from ..language.core import Argument
        from ..interpolation import Interpolator
        from .composition import OpCtx, build_ksp
        self.appctx = appctx = ctx.appctx
        V = ctx.space
        if V is None:
            raise ValueError("GTMGPC needs the problem's function space")
        if ctx.matvec is None:
            raise ValueError("GTMGPC needs an operator (assembled or "
                             "matrix-free)")
        get_cs = appctx.get("get_coarse_space")
        get_co = appctx.get("get_coarse_operator")
        if get_cs is None or get_co is None:
            raise ValueError(
                "GTMGPC needs appctx callbacks 'get_coarse_space' and "
                "'get_coarse_operator' (reference gtmg.py:28)")
        Vc = get_cs()
        cform = get_co()
        cbcs = appctx.get("coarse_space_bcs", None)
        if cbcs is not None and not isinstance(cbcs, (list, tuple)):
            cbcs = [cbcs]
        Ac = assemble(cform, bcs=cbcs)

        P = appctx.get("interpolation_matrix")
        if P is None:
            P = Interpolator(Argument(Vc, 1), V).assemble()
        self._P = P
        R = appctx.get("restriction_matrix")
        self._R = R if R is not None else P.transpose()

        maskc = np.ones(Vc.dim)
        for b in cbcs or ():
            maskc[b.dof_indices] = 0.0
        self._maskc = as_tensor(maskc)

        cctx = OpCtx(mat=Ac, space=Vc, form=cform, bcs=cbcs or (),
                     appctx=appctx)
        p = dict(params)
        cpre = prefix + self._prefix + "mg_coarse_"
        p.setdefault(cpre + "ksp_type", "preonly")
        p.setdefault(cpre + "pc_type", "lu")
        self._coarse = build_ksp(cctx, p, cpre)
        spre = prefix + self._prefix + "mg_levels_"
        p.setdefault(spre + "ksp_type", "chebyshev")
        p.setdefault(spre + "ksp_max_it", 2)
        p.setdefault(spre + "pc_type",
                     "jacobi" if ctx.mat is not None else "none")
        self._smooth = build_ksp(ctx, p, spre)
        self._post_preonly = p[spre + "ksp_type"] == "preonly"
        self._op = ctx.matvec

    def apply(self, r):
        # V(1,1): pre-smooth, coarse correction, post-smooth
        x = self._smooth(r)
        rc = self._maskc * self._R.matvec(r - self._op(x))
        x = x + self._P.matvec(self._coarse(rc) * self._maskc)
        if self._post_preonly:
            return x + self._smooth(r - self._op(x))
        return self._smooth(r, x0=x)
