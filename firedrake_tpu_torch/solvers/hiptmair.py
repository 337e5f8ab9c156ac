"""HiptmairPC: auxiliary-space two-level method for H(curl)/H(div) (the
port's copy of ``firedrake_tpu/solvers/hiptmair.py``).

Reference surface: firedrake/preconditioners/hiptmair.py:120 HiptmairPC:
relax on the fine space, and correct in a potential space one step down
the de Rham complex, H^1 for H(curl) and H(curl) for H(div) (Hiptmair
1998).  The potential operator is the fine form's zero-order (mass) term
evaluated on exterior derivatives of the potential-space arguments (the
derivative term vanishes there: curl grad = div curl = 0); the transfer
is the discrete exterior derivative G, the interpolation of grad/curl of
the potential basis into the fine space (interpolation.operator_matrix).

The application
    z = S(r) + G A_c^{-1} G^T r        (additive two-level cycle)
runs on the device: G and its transpose are matrices of their own
(the transpose's sums run in a fixed order), the smoother and the coarse
solve come from the options tree (``hiptmair_mg_levels_*``,
``hiptmair_mg_coarse_*``).  For H(curl) the potential operator is
inner(grad p, grad q), which K1's family takes.

De Rham complexes handled (simplicial cells):
  3D: H1 --grad--> H(curl) --curl--> H(div);  N1curl_k <- CG_k,
      RT_k <- N1curl_k.
  2D: H1 --grad--> H(curl) and H1 --perp grad--> H(div);
      N1curl_k/RT_k/BDM_k <- CG_k.
"""
from __future__ import annotations

import numpy as np

from .pcs import PCBase
from ..device import as_tensor, to_numpy

__all__ = ["HiptmairPC"]


def _kill_arg_derivatives(form):
    """Replace Curl/Div/Grad of any Argument with Zero, the reference's
    ``replace(expand_derivatives(a), {grad(t): 0})`` (hiptmair.py:178),
    leaving only the zero-order (mass) terms."""
    from ..language.core import Argument, Zero, Grad, Restricted
    from ..language.operators import Curl, Div
    from ..language.calculus import replace
    mapping = {}
    for it in form.integrals():
        for t in it.integrand.traverse():
            if isinstance(t, (Curl, Div, Grad)):
                base = t.operands[0]
                while isinstance(base, Restricted):
                    base = base.operands[0]
                if isinstance(base, Argument):
                    mapping[t] = Zero(t.shape)
    return replace(form, mapping) if mapping else form


def _form_arguments(form):
    from ..language.core import Argument
    args = {}
    for it in form.integrals():
        for t in it.integrand.traverse():
            if isinstance(t, Argument):
                args[t.number] = t
    return args


class HiptmairPC(PCBase):
    """Two-level auxiliary-space PC for H(curl)/H(div) Riesz maps.
    Options: ``hiptmair_mg_levels_*`` (fine relaxation, default
    preonly+jacobi), ``hiptmair_mg_coarse_*`` (potential-space solve,
    default preonly+lu; jacobi for the singular H(curl) potential of 3D
    H(div)).  appctx: ``hiptmair_shift`` adds a mass term to a singular
    high-order H(div) potential problem (reference hiptmair.py:132)."""

    _prefix = "hiptmair_"

    def initialize_ctx(self, ctx, params, prefix):
        from ..functionspace import FunctionSpace
        from ..bcs import DirichletBC
        from ..assemble import assemble
        from ..language.core import Argument, Grad
        from ..language.operators import curl
        from ..language.tensor_algebra import as_vector
        from ..language.calculus import replace
        from ..interpolation import operator_matrix
        from .composition import OpCtx, build_ksp
        self.appctx = ctx.appctx
        V = ctx.space
        if V is None or ctx.form is None:
            raise ValueError("HiptmairPC needs the bilinear form and the "
                             "problem's function space")
        elem = V.scalar_element
        mapping = getattr(elem, "mapping", "identity")
        mesh = V.mesh_obj
        tdim = mesh.topology.dim
        k = elem.degree
        if mapping == "covariant":                 # H(curl)
            Vc = FunctionSpace(mesh, "CG", k)

            def dminus(p):
                return Grad(p)
        elif mapping == "contravariant":           # H(div)
            if tdim == 3:
                Vc = FunctionSpace(mesh, "N1curl", k)
                dminus = curl
            else:
                # 2D complex: perp-grad (the scalar curl) H1 -> H(div)
                Vc = FunctionSpace(mesh, "CG", k)

                def dminus(p):
                    g = Grad(p)
                    return as_vector([g[1], -g[0]])
        else:
            raise ValueError(
                "HiptmairPC needs an H(curl) or H(div) space; got "
                f"{elem.family}")

        # ---- potential operator: zero-order term on potential derivatives
        args = _form_arguments(ctx.form)
        if set(args) != {0, 1}:
            raise ValueError("HiptmairPC needs a bilinear form")
        beta = _kill_arg_derivatives(ctx.form)
        if not beta.integrals():
            raise ValueError(
                "HiptmairPC: the form has no zero-order term, so the "
                "potential-space operator would be zero (pure "
                "curl-curl/div-div problems need a shifted appctx form)")
        pc_test, pc_trial = Argument(Vc, 0), Argument(Vc, 1)
        coarse_form = replace(beta, {args[0]: dminus(pc_test),
                                     args[1]: dminus(pc_trial)})
        shift = ctx.appctx.get("hiptmair_shift", None)
        if shift is not None and getattr(Vc, "block_size", 1) == 1 \
                and getattr(Vc.scalar_element, "mapping",
                            "identity") != "identity":
            from ..language.measure import dx
            from ..language.tensor_algebra import inner
            coarse_form = coarse_form + (
                float(shift) * inner(pc_trial, pc_test) * dx)
        cbcs = [DirichletBC(Vc, 0.0, b.sub_domain)
                for b in (ctx.bcs or ())]
        Ac = assemble(coarse_form, bcs=cbcs)

        # ---- transfer: the discrete exterior derivative, and its
        # transpose as a matrix of its own
        G = operator_matrix(dminus(Argument(Vc, 1)), V)
        self._G, self._GT = G, G.transpose()

        # ---- boundary masks (the reference chops the interpolation's
        # rows and columns, hiptmair.py:204)
        maskf = np.ones(V.dim)
        for b in ctx.bcs or ():
            maskf[b.dof_indices] = 0.0
        maskc = np.ones(Vc.dim)
        for b in cbcs:
            maskc[b.dof_indices] = 0.0
        # zero-beta masking (reference zero_beta_poisson, default on):
        # where the potential operator's diagonal vanishes (beta == 0
        # regions) the coarse problem is singular, so those nodes are
        # masked; the diagonal is read once, at set-up
        diag = to_numpy(Ac.diagonal())
        atol = np.abs(diag).max() * 1e-10
        dead = np.flatnonzero(np.abs(diag) <= atol)
        if dead.size:
            maskc[dead] = 0.0
            Ac = Ac.with_dirichlet(dead)
        if not cbcs and getattr(Vc.scalar_element, "mapping",
                                "identity") == "identity":
            # no boundary conditions: the H^1 potential Laplacian is pure
            # Neumann (constant kernel).  G annihilates constants, so any
            # representative of the quotient gives the same fine-space
            # correction: pin one dof to make the coarse solve definite
            maskc[0] = 0.0
            Ac = Ac.with_dirichlet(np.array([0]), symmetric=True)
        self._maskf = as_tensor(maskf)
        self._maskc = as_tensor(maskc)

        # ---- sub-solvers from the options tree
        cctx = OpCtx(mat=Ac, space=Vc, form=coarse_form, bcs=cbcs,
                     appctx=ctx.appctx)
        p = dict(params)
        cpre = prefix + self._prefix + "mg_coarse_"
        p.setdefault(cpre + "ksp_type", "preonly")
        # the H(div) vector-potential operator (curl-curl on N1curl) is
        # singular, its kernel grad(H1) (reference hiptmair.py:131): an
        # exact solve would amplify kernel noise, so the default there is
        # a Jacobi sweep.  The H^1 potential Laplacian is definite.
        csingular = getattr(Vc.scalar_element, "mapping",
                            "identity") != "identity"
        p.setdefault(cpre + "pc_type", "jacobi" if csingular else "lu")
        self._coarse = build_ksp(cctx, p, cpre)
        spre = prefix + self._prefix + "mg_levels_"
        p.setdefault(spre + "ksp_type", "preonly")
        p.setdefault(spre + "pc_type",
                     "jacobi" if ctx.mat is not None else "none")
        self._smooth = build_ksp(ctx, p, spre)

    def apply(self, r):
        rm = r * self._maskf
        z = self._smooth(r)
        rc = self._maskc * self._GT.matvec(rm)
        zc = self._coarse(rc) * self._maskc
        return z + self._maskf * self._G.matvec(zc)
