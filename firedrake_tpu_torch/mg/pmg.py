"""p-multigrid: coarsen by polynomial degree on one mesh.

The port's copy of ``firedrake_tpu/mg/pmg.py`` (reference:
firedrake/preconditioners/pmg.py PMGPC/PMGSNES).  Degree levels k ->
max(k//2, 1) -> ... -> 1; the transfers are per-cell nodal tables (the
coarse basis at the fine element's nodes: no mesh maps), and the V-cycle
smooths with Chebyshev on [0.25, 1.05] lambda_max(D^-1 A), as the
geometric cycle does (mg/vcycle.py).

Shared nodes: ``prolong`` takes each fine node from the last cell that
holds it (numpy assignment order, as interpolation.py does), and
``restrict``/``inject`` sum the cells' contributions by the gather
route's fixed-order accumulation plan (assemble.py ``_accumulation``),
where the JAX package scatters with ``.at[].set``/``.at[].add``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor, get_device
from ..functionspace import FunctionSpace
from ..language.core import Argument
from ..language.calculus import map_expr
from ..language.measure import Form

__all__ = ["PLevelTransfer", "PMGPC"]


def _multiplicity(cmap, n):
    """How many cells hold each dof (1 where none does)."""
    mult = np.bincount(cmap.reshape(-1), minlength=n).astype(np.float64)
    return np.where(mult > 0, mult, 1.0)


class PLevelTransfer:
    """Transfers between P_kc and P_kf on the same mesh (kc < kf):
    ``prolong_fn``, ``restrict_fn`` (its transpose, with the fine dofs
    weighted by their cell multiplicity) and ``inject_fn`` (the fine
    function at the coarse nodes, averaged over the cells: FAS over
    degree levels)."""

    def __init__(self, Vc: FunctionSpace, Vf: FunctionSpace):
        from ..assemble import _accumulation
        assert Vc.mesh_obj is Vf.mesh_obj
        ec, ef = Vc.scalar_element, Vf.scalar_element
        bs = Vc.block_size
        assert bs == Vf.block_size
        dev = get_device()
        # coarse basis at the fine nodes (ndof_f, ndof_c), and the fine
        # basis at the coarse nodes (ndof_c, ndof_f)
        self.T = as_tensor(ec.tabulate(ef.nodes, 0)[0])
        self.T2 = as_tensor(ef.tabulate(ec.nodes, 0)[0])
        cmap = np.asarray(Vc.cell_dof_map, dtype=np.int64)
        fmap = np.asarray(Vf.cell_dof_map, dtype=np.int64)
        self.cmap, self.fmap = as_tensor(cmap), as_tensor(fmap)
        self.bs, self.ndc, self.ndf = bs, ec.ndof, ef.ndof
        self.fine_mult = as_tensor(_multiplicity(fmap, Vf.dim))
        self.coarse_mult = as_tensor(_multiplicity(cmap, Vc.dim))
        # each fine dof from the last cell slot that holds it
        src = np.zeros(Vf.dim, dtype=np.int64)
        src[fmap.reshape(-1)] = np.arange(fmap.size)
        self.src = as_tensor(src)
        self._acc = _accumulation(cmap.reshape(-1), Vc.dim, dev)

    def _blk(self, x, nd):
        return x.reshape(x.shape[0], nd, self.bs)

    def prolong_fn(self, cdat):
        cd = self._blk(cdat[self.cmap], self.ndc)         # (nc, ndc, bs)
        vals = torch.einsum("fj,njb->nfb", self.T, cd)
        return vals.reshape(-1)[self.src]

    def restrict_fn(self, fdual):
        fd = self._blk((fdual / self.fine_mult)[self.fmap], self.ndf)
        vals = torch.einsum("fj,nfb->njb", self.T, fd)
        return self._acc(vals.reshape(-1)).to(fdual.dtype)

    def inject_fn(self, fdat):
        fd = self._blk(fdat[self.fmap], self.ndf)
        vals = torch.einsum("cj,njb->ncb", self.T2, fd)
        return self._acc(vals.reshape(-1)).to(fdat.dtype) / self.coarse_mult


def _coarsen_degree_form(form: Form, space_map):
    """The form with its arguments on the lower-degree spaces (the same
    mesh, so coefficients and geometry stay as they are)."""
    mapping = {}
    for it in form.integrals():
        for t in it.integrand.traverse():
            if isinstance(t, Argument):
                mapping[t] = Argument(space_map(t.space), t.number, t.part)
    return Form(tuple(it.reconstruct(map_expr(it.integrand, mapping))
                      for it in form.integrals()))


def degree_spaces(V, coarsen=lambda k: max(k // 2, 1), family="CG"):
    """The degree ladder's spaces of ``family``, coarsest first, V
    last."""
    degrees = [V.scalar_element.degree]
    while degrees[-1] > 1:
        degrees.append(coarsen(degrees[-1]))
    mesh = V.mesh_obj

    def make(d):
        if V.block_size > 1:
            return FunctionSpace(mesh, family, d, vector_dim=V.block_size)
        return FunctionSpace(mesh, family, d)

    return [make(d) for d in degrees[:0:-1]] + [V]


class PMGPC:
    """V-cycle over degree levels (reference: PMGPC with the coarsening
    ``coarsen_element``: degree k -> max(k//2, 1)).

    Options under the PC's prefix, as PETSc's PMGPC reads them:
    ``pmg_mg_levels_ksp_max_it`` (smoothing steps, default 3),
    ``pmg_mg_levels_ksp_type`` (chebyshev; another type warns and is
    replaced by it) and ``pmg_mg_coarse_*``, the coarse level's options
    tree.  Without ``pmg_mg_coarse_*`` options the coarse level is the
    dense inverse, made on the host: for small coarse levels only.
    ``A_fine``, the finest level's operator with its Dirichlet rows (the
    outer solve's), is used as it is instead of assembling it again."""

    def __init__(self, a_fine: Form, bcs, fine_space: FunctionSpace,
                 smooth_its=3, coarsen=lambda k: max(k // 2, 1),
                 params=None, prefix="", appctx=None, A_fine=None):
        from ..assemble import assemble
        from ..bcs import DirichletBC
        from ..solvers.composition import OpCtx, _power_lmax, build_ksp
        params = dict(params or {})
        smooth_its = int(params.get(
            prefix + "pmg_mg_levels_ksp_max_it", smooth_its))
        sm_type = params.get(prefix + "pmg_mg_levels_ksp_type", "chebyshev")
        if sm_type != "chebyshev":
            import warnings
            warnings.warn(f"pmg smoother {sm_type!r} unsupported; "
                          "using chebyshev")
        V = fine_space
        spaces = degree_spaces(V, coarsen)
        forms = [a_fine if Vl is V else _coarsen_degree_form(
            a_fine, lambda _s, Vl=Vl: Vl) for Vl in spaces]

        self.levels = []
        for Vl, f in zip(spaces, forms):
            lb = [DirichletBC(Vl, 0.0, bc.sub_domain, bc.sub_component)
                  for bc in (bcs or ())]
            # a one-level ladder keeps its own assembled (dense) coarse
            # operator
            A = (A_fine if Vl is V and A_fine is not None
                 and len(spaces) > 1 else assemble(f, bcs=lb))
            d = A.diagonal()
            dinv = torch.where(torch.abs(d) > 0, 1.0 / d,
                               torch.ones_like(d))
            mask = np.ones(Vl.dim)
            if lb:
                mask[np.concatenate([b.dof_indices for b in lb])] = 0.0
            lam = _power_lmax(lambda x, A=A, dinv=dinv: dinv * A.matvec(x),
                              Vl.dim, 12)
            self.levels.append(dict(A=A, dinv=dinv, mask=as_tensor(mask),
                                    emin=0.25 * lam, emax=1.05 * lam))
        A0 = self.levels[0]["A"]
        coarse_pref = prefix + "pmg_mg_coarse_"
        if any(k.startswith(coarse_pref) for k in params):
            ctx0 = OpCtx(mat=A0, space=spaces[0], form=forms[0], bcs=bcs,
                         appctx=appctx)
            self.coarse_solve = build_ksp(ctx0, params, coarse_pref)
        else:
            Ainv = as_tensor(np.linalg.inv(A0.to_dense()))
            self.coarse_solve = lambda b: Ainv @ b
        self.transfers = [PLevelTransfer(spaces[i], spaces[i + 1])
                          for i in range(len(spaces) - 1)]
        self.smooth_its = smooth_its
        self.nlevels = len(spaces)

    def _smooth(self, lv, x, b, its):
        """Chebyshev smoothing on [emin, emax] of D^-1 A."""
        A, dinv = lv["A"], lv["dinv"]
        theta = (lv["emax"] + lv["emin"]) / 2
        delta = (lv["emax"] - lv["emin"]) / 2
        alpha = 1.0 / theta
        p = dinv * (b - A.matvec(x))
        x = x + alpha * p
        for _ in range(its - 1):
            beta = (delta * alpha / 2) ** 2
            alpha = 1.0 / (theta - beta / alpha)
            p = dinv * (b - A.matvec(x)) + beta * p
            x = x + alpha * p
        return x

    def _cycle(self, level, b):
        if level == 0:
            return self.coarse_solve(b)
        lv = self.levels[level]
        x = self._smooth(lv, torch.zeros_like(b), b, self.smooth_its)
        r = (b - lv["A"].matvec(x)) * lv["mask"]
        t = self.transfers[level - 1]
        rc = t.restrict_fn(r) * self.levels[level - 1]["mask"]
        x = x + t.prolong_fn(self._cycle(level - 1, rc)) * lv["mask"]
        return self._smooth(lv, x, b, self.smooth_its)

    def __call__(self, r):
        return self._cycle(self.nlevels - 1, r)
