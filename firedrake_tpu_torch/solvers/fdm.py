"""FDMPC and P1PC: fast-diagonalization and low-order preconditioning for
tensor-product cells.

The port's copy of ``firedrake_tpu/solvers/fdm.py`` (reference surface:
firedrake/preconditioners/fdm.py FDMPC and low_order.py P1PC).  FDMPC
keeps the nodal basis and applies the fast-diagonalization inverse per
cell as an additive Schwarz smoother, plus a Q1 coarse correction:

  P^-1 r = W^1/2 sum_c R_c^T S (Lambda_c)^-1 S^T R_c W^1/2 r
           + P1 A1^-1 P1^T r

where S solves the generalized 1D eigenproblem Khat S = Mhat S diag(l),
S^T Mhat S = I (on the host, scipy), and Lambda_c holds the Kronecker-sum
eigenvalues of the separable model operator on cell c,

  A_c ~= alpha_c prod_m h_m (sum_d h_d^-2 Khat_d (x) Mhat_else)
         + beta_c prod_m h_m (Mhat (x) ... (x) Mhat).

An application is a chain of per-axis (n_1d x n_1d) contractions
batched over the cells (``torch.einsum``), and the cells' results are
summed into the dofs by the gather route's fixed-order accumulation plan.
The local problems are pure Neumann, so the zero mode of each cell is
regularised to its smallest nonzero eigenvalue, and the Q1 coarse level
restores mesh independence.

Geometry: h_{c,d} is the extent of cell c's vertices along axis d (exact
for axis-aligned cells).  Diffusion enters as the cell average alpha_c of
``appctx["fdm_coef"]`` (default 1), reaction as that of
``appctx["fdm_mass_coef"]`` (default 0).
"""
from __future__ import annotations

import numpy as np
import torch

from .pcs import PCBase
from ..device import as_tensor, get_device

__all__ = ["FDMPC", "P1PC"]

_TP_CELLS = {"interval": 1, "quadrilateral": 2, "hexahedron": 3}


def _lagrange_1d_matrices(k, variant=None):
    """1D mass and stiffness on [0, 1] of the degree-k nodal Lagrange
    basis (equispaced or GLL lattice: the Q_k factor basis)."""
    from ..compiler.spectral import _lagrange_1d
    q, w = np.polynomial.legendre.leggauss(k + 2)
    q = 0.5 * (q + 1.0)
    w = 0.5 * w
    P, dP = _lagrange_1d(k, q, variant)              # (nq, k+1)
    return (P * w[:, None]).T @ P, (dP * w[:, None]).T @ dP


def _fdm_eigenbasis(k, variant=None):
    """S, lam with Khat S = Mhat S diag(lam), S^T Mhat S = I."""
    import scipy.linalg
    M, K = _lagrange_1d_matrices(k, variant)
    lam, S = scipy.linalg.eigh(K, M)
    return S, lam


def _axis_apply(T, x, ax):
    """Contract (n_out, n_in) T with axis ``ax`` (>= 1) of x, batched over
    the other axes, keeping the axis order."""
    d = x.ndim - 1
    xin = "c" + "".join(chr(ord("i") + m) for m in range(d))
    a = xin[1 + ax]
    return torch.einsum(f"A{a},{xin}->{xin.replace(a, 'A')}", T, x)


def _cell_average(mesh, expr):
    """Per-cell average of a scalar expression, as a device vector
    (assembled through the DG0 dual pairing)."""
    from ..functionspace import FunctionSpace
    from ..language.core import Argument
    from ..language.measure import dx
    from ..assemble import assemble
    v0 = Argument(FunctionSpace(mesh, "DG", 0), 0)
    num = as_tensor(assemble(expr * v0 * dx).dat)
    vol = as_tensor(assemble(1.0 * v0 * dx).dat)
    return num / vol


class FDMPC(PCBase):
    """Batched FDM additive Schwarz plus a Q1 coarse level (prefix
    ``fdm_``).

    Options: ``fdm_coarse_*`` configures the Q1 coarse solve (default
    preonly + lu); ``fdm_no_coarse`` drops the coarse level.  appctx:
    ``fdm_coef`` (diffusion), ``fdm_mass_coef`` (reaction)."""

    _prefix = "fdm_"

    def initialize_ctx(self, ctx, params, prefix):
        from ..assemble import _accumulation, assemble
        from ..bcs import DirichletBC
        from ..compiler.spectral import _slot_lattice
        from ..functionspace import FunctionSpace
        from ..mg.pmg import PLevelTransfer, _coarsen_degree_form
        from .composition import OpCtx, build_ksp, opt
        self.appctx = ctx.appctx
        V = ctx.space
        if V is None:
            raise ValueError("FDMPC needs the problem's function space")
        elem = V.scalar_element
        cellname = elem.cell.name
        if cellname not in _TP_CELLS or V.block_size != 1:
            raise NotImplementedError(
                "FDMPC supports scalar Lagrange spaces on tensor-product "
                f"cells (interval/quad/hex); got {cellname} x"
                f"{V.block_size}")
        d = _TP_CELLS[cellname]
        k = elem.degree
        n1 = k + 1
        mesh = V.mesh_obj

        # the 1D eigenbasis and the cells' eigenvalue denominators
        S, lam = _fdm_eigenbasis(k, getattr(elem, "variant", None))
        self._St, self._S = as_tensor(S.T), as_tensor(S)
        coords = as_tensor(mesh.coordinates.dat).reshape(
            -1, mesh.geometric_dimension)
        pts = coords[as_tensor(
            np.asarray(mesh.topology.cell_vertices, dtype=np.int64))]
        h = (pts.max(dim=1).values - pts.min(dim=1).values)[:, :d]
        volc = torch.prod(h, dim=1)                       # (C,)
        alpha = ctx.appctx.get("fdm_coef", None)
        ac = (_cell_average(mesh, alpha) if alpha is not None
              else torch.ones_like(volc))
        beta = ctx.appctx.get("fdm_mass_coef", None)
        bc_coef = (_cell_average(mesh, beta) if beta is not None
                   else torch.zeros_like(volc))
        lamt = as_tensor(lam)
        cshape = (-1,) + (1,) * d
        # D[c, i1..id] = vol * (alpha * sum_d lam[i_d] / h_d^2 + beta)
        D = torch.zeros((len(volc),) + (n1,) * d, dtype=volc.dtype,
                        device=volc.device)
        for ax in range(d):
            shp = [1] * d
            shp[ax] = n1
            D = D + lamt.reshape(shp)[None] / (h[:, ax] ** 2).reshape(cshape)
        D = volc.reshape(cshape) * (ac.reshape(cshape) * D
                                    + bc_coef.reshape(cshape))
        # each cell's (near-)zero eigenvalue becomes its smallest nonzero
        # one (the JAX package measured 87 -> 28 CG iterations at 32^2 Q3
        # against dropping the mode)
        axes = tuple(range(1, d + 1))
        dmax = torch.amax(torch.abs(D), dim=axes, keepdim=True)
        small = torch.abs(D) <= 1e-10 * dmax
        dmin = torch.amin(torch.where(small, torch.inf, torch.abs(D)),
                          dim=axes, keepdim=True)
        self._dinv = torch.where(small, 1.0 / dmin, 1.0 / D)

        # dof lattice permutation and counting weights
        lat, _ = _slot_lattice(elem)                      # (nslot, d)
        strides = np.array([n1 ** (d - 1 - m) for m in range(d)])
        idx = (lat * strides).sum(axis=1)                 # slot -> lattice
        if sorted(idx) != list(range(n1 ** d)):
            raise ValueError("the element's nodes are not a tensor lattice")
        self._order = as_tensor(np.argsort(idx))          # lattice <- slot
        self._idx = as_tensor(idx)                        # slot <- lattice
        cmap = np.asarray(V.cell_dof_map, dtype=np.int64)
        self._cmap = as_tensor(cmap)
        self._acc = _accumulation(cmap.reshape(-1), V.dim, get_device())
        mult = np.bincount(cmap.reshape(-1), minlength=V.dim)
        self._sqrtw = as_tensor(1.0 / np.sqrt(np.maximum(mult, 1.0)))
        mask = np.ones(V.dim)
        for b in ctx.bcs or ():
            mask[b.dof_indices] = 0.0
        self._mask = as_tensor(mask)
        self._d = d

        # the Q1 coarse level (the P1PC role)
        self._coarse = None
        sub = prefix + self._prefix
        if (not opt(params, sub, "no_coarse", False) and k > 1
                and ctx.form is not None
                and type(elem).__name__ == "Lagrange"):
            V1 = FunctionSpace(mesh, "CG", 1)
            f1 = _coarsen_degree_form(ctx.form, lambda _s: V1)
            b1 = [DirichletBC(V1, 0.0, b.sub_domain, b.sub_component)
                  for b in (ctx.bcs or ())]
            A1 = assemble(f1, bcs=b1)
            ictx = OpCtx(mat=A1, space=V1, form=f1, bcs=b1,
                         appctx=ctx.appctx)
            p = dict(params)
            p.setdefault(sub + "coarse_ksp_type", "preonly")
            p.setdefault(sub + "coarse_pc_type", "lu")
            cmask = np.ones(V1.dim)
            for b in b1:
                cmask[b.dof_indices] = 0.0
            self._coarse = (PLevelTransfer(V1, V),
                            build_ksp(ictx, p, sub + "coarse_"),
                            as_tensor(cmask))

    def apply(self, r):
        d = self._d
        rm = r * self._mask
        rw = (rm * self._sqrtw)[self._cmap]               # (C, nslot)
        n1 = self._S.shape[0]
        rl = rw[:, self._order].reshape((rw.shape[0],) + (n1,) * d)
        for ax in range(d):
            rl = _axis_apply(self._St, rl, ax)
        rl = rl * self._dinv
        for ax in range(d):
            rl = _axis_apply(self._S, rl, ax)
        vals = rl.reshape(rw.shape[0], -1)[:, self._idx]
        z = self._acc(vals.reshape(-1)).to(r.dtype) * self._sqrtw * self._mask
        if self._coarse is not None:
            tr, csolve, cmask = self._coarse
            rc = tr.restrict_fn(rm) * cmask
            z = z + tr.prolong_fn(csolve(rc)) * self._mask
        return z


class P1PC(PCBase):
    """Low-order preconditioning: one p-jump straight to degree 1
    (reference: low_order.py P1PC, a PMGPC whose coarsening is degree ->
    1).  Options under ``lo_pmg_*`` (``lo_pmg_mg_levels_*``,
    ``lo_pmg_mg_coarse_*``)."""

    _prefix = "lo_"

    def initialize_ctx(self, ctx, params, prefix):
        from ..mg.pmg import PMGPC
        self.appctx = ctx.appctx
        if ctx.form is None or ctx.space is None:
            raise ValueError("P1PC needs the bilinear form + space")
        self._pmg = PMGPC(ctx.form, ctx.bcs, ctx.space,
                          coarsen=lambda k: 1, params=dict(params),
                          prefix=prefix + self._prefix, appctx=ctx.appctx,
                          A_fine=ctx.mat)

    def apply(self, r):
        return self._pmg(r)
