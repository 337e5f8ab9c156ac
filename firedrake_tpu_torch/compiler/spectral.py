"""Sum-factorised (spectral) assembly for tensor-product cells.

The TSFC spectral/tensor-mode role (reference: tsfc/spectral.py:197;
tsfc/tensor.py:93) and the JAX package's compiler/spectral.py, in torch:
on quadrilaterals and hexahedra the Q_k basis factors into 1D Lagrange
bases, so the local-tensor contraction

    A_ij = sum_q w(q) * v_ij(q)

never materialises the (ni, nj, nq) array.

1. Probe extraction.  A bilinear integrand lowers to
       v_ij(q) = sum_{a,b} M_ab(q) * T^test_a(q, i) * T^trial_b(q, j)
   where a, b range over the reference channels of a scalar space
   (value, d/dxi_1 .. d/dxi_d): the lowering is linear in each
   argument's reference tables.  The cell-last BatchedLowerer, given
   one-hot probe tables with one slot per channel, returns M_ab(q) for
   every cell at once (one evaluation; the JAX package evaluates one
   1x1-slot probe per (a, b) per cell).  Variable coefficients and
   non-affine geometry come through the lowerer as for any form.
2. Factored contraction.  With per-dimension tables E_m[q_m, i_m, a]
   (the 1D derivative table when a == m+1, the 1D value table otherwise)
   the basis factorises as T_a(q, i) = prod_m E_m[q_m, i_m, a], and the
   local tensors are one contraction with the JAX package's subscripts
       loc[c, i1..id, j1..jd] = M[c, a, b, q1..qd]
                                * prod_m E_m[q_m, i_m, a]
                                * prod_m E_m[q_m, j_m, b],
   here a chain of torch.einsum calls, one quadrature axis at a time
   (the classical sum-factorisation order): O((k+1)^(2d+1)) per cell
   instead of O((k+1)^(3d)).

The plan slots into the gather route: it returns the (ni, nj, C)
cell-last local tensors the lowerer would, in element slot order.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .batched import BatchedCellContext, BatchedLowerer
from .lowering import einsum

_TP_CELLS = ("quadrilateral", "hexahedron")


def _is_tp_scalar_lagrange(space):
    from ..elements.lagrange import Lagrange
    return (space is not None
            and space.block_size == 1
            and type(space.element).__name__ in ("Lagrange",
                                                 "DiscontinuousLagrange")
            and isinstance(space.element, Lagrange)
            and space.element.cell.name in _TP_CELLS)


def _lagrange_1d(k, pts, variant=None):
    """Nodal 1D Lagrange basis on the degree-k lattice (equispaced, or
    GLL for variant='spectral'; k=0: the single constant): values and
    derivatives at pts."""
    if k == 0:
        return (np.ones((len(pts), 1)), np.zeros((len(pts), 1)))
    from ..elements.lagrange import _lattice_1d
    nodes = _lattice_1d(k, variant)
    V = np.vander(nodes, k + 1, increasing=True)       # (k+1, k+1)
    C = np.linalg.inv(V)                               # mono -> nodal
    P = np.vander(np.asarray(pts), k + 1, increasing=True)
    dP = np.zeros_like(P)
    dP[:, 1:] = P[:, :-1] * np.arange(1, k + 1)
    return P @ C, dP @ C


def _slot_lattice(elem):
    """(nslot, d) lattice multi-index of each element dof slot (matched
    against the element's own 1D lattice, so GLL variants factor too),
    and the 1D lattice size; None when the nodes are not a tensor
    lattice."""
    from ..elements.lagrange import _lattice_1d
    nodes = np.asarray(elem.nodes)                 # (nslot, d)
    if elem.degree == 0:
        # DG0: the single node is the centroid, not a lattice point; it
        # factors as the constant slot in every axis
        return np.zeros((len(nodes), nodes.shape[1]), dtype=np.int64), 1
    g1 = _lattice_1d(elem.degree, getattr(elem, "variant", None))
    d2 = np.abs(nodes[:, :, None] - g1[None, None, :])
    mi = d2.argmin(axis=2).astype(np.int64)        # (nslot, d)
    if np.take_along_axis(d2, mi[:, :, None], 2).max() >= 1e-9:
        return None
    return mi, elem.degree + 1


class _ProbeLowerer(BatchedLowerer):
    """BatchedLowerer whose argument tables are one-hot reference probes,
    one slot per channel: slot a of the value table is 1 for a == 0, slot
    a of the gradient table is the unit vector e_{a-1}.  Its (na, nb, nq,
    C) result is M_ab(q) for every cell."""

    def __init__(self, ctx, test, trial, coeffs, consts, tdim):
        super().__init__(ctx, test, trial, coeffs, consts)
        self._ptdim = tdim

    def arg_table(self, arg, order, side):
        na = self._ptdim + 1
        nq = self.ctx.num_q()
        if order == 0:
            t = np.zeros((nq, na))
            t[:, 0] = 1.0
        elif order == 1:
            t = np.zeros((nq, na, self._ptdim))
            for m in range(self._ptdim):
                t[:, m + 1, m] = 1.0
        else:
            raise NotImplementedError("spectral probes: 2nd derivatives")
        return self.ctx.const(t)


class SpectralPlan:
    """Per-integral sum-factorised cell executor."""

    def __init__(self, ci, test_space, trial_space, lattices):
        mesh = ci.mesh
        d = mesh.cell.dim
        self.ci = ci
        self.rank = (test_space is not None) + (trial_space is not None)
        # 1D factor of the cell rule (make_quadrature meshgrid 'ij' order:
        # the last axis varies fastest)
        from .lowering import _cell_rule
        pts, _ = _cell_rule(mesh.cell.name, ci.degree)
        n1q = round(len(pts) ** (1.0 / d))
        if n1q ** d != len(pts):
            raise NotImplementedError("the cell rule is not a tensor rule")
        pts1 = np.asarray(pts[:n1q, -1])
        self.nq1, self.d = n1q, d
        self.nalpha = d + 1

        def etables(space, lat):
            """Per-dimension extended tables E_m (nq1, n1, d+1), and the
            lattice flat index of each element slot."""
            elem = space.element
            V, D = _lagrange_1d(elem.degree, pts1,
                                getattr(elem, "variant", None))
            out = []
            for m in range(d):
                Em = np.repeat(V[:, :, None], d + 1, axis=2)
                Em[:, :, m + 1] = D
                out.append(Em)
            mi, n1 = lat
            return out, np.ravel_multi_index(tuple(mi.T), (n1,) * d)

        self._host = {}
        self._host["Et"], self.rows_perm = etables(test_space, lattices[0])
        self._host["Eu"], self.cols_perm = (
            etables(trial_space, lattices[1]) if trial_space is not None
            else (None, None))
        self._dev = {}

    def _tables(self, dtype, device):
        key = (dtype, str(device))
        if key not in self._dev:
            def t(a):
                return torch.as_tensor(a, dtype=dtype, device=device)
            self._dev[key] = (
                [t(E) for E in self._host["Et"]],
                None if self._host["Eu"] is None
                else [t(E) for E in self._host["Eu"]],
                torch.as_tensor(self.rows_perm, device=device),
                None if self.cols_perm is None
                else torch.as_tensor(self.cols_perm, device=device))
        return self._dev[key]

    # ------------------------------------------------------------- probes
    def probe(self, ce, ws, consts):
        """(na[, nb], nq, C) kernel matrices including the detJ * w scale,
        for cell-last inputs: one evaluation of the probe lowerer."""
        ci = self.ci
        ctx = BatchedCellContext(ci.mesh, ci.degree, ce)
        low = _ProbeLowerer(
            ctx, ci.test, ci.trial,
            {c.count: w for c, w in zip(ci.coefficients, ws)},
            {c.count: v for c, v in zip(ci.constants, consts)}, self.d)
        v = low.run(ci.integrand)                       # (na, nb', nq, C')
        C = max(ce.shape[-1], v.shape[-1])
        M = v * ctx.scale()
        na = self.nalpha
        nb = na if self.rank == 2 else 1
        return torch.broadcast_to(M, (na, nb) + M.shape[2:3] + (C,))

    # -------------------------------------------------------- contraction
    def local_tensors(self, ce, ws, consts):
        """(ni, nj, C) cell-last local tensors in element slot order.
        ce: (ndofc, g, C); ws: tuple of (nslot, C)."""
        from . import cell_eval
        cell_eval.lowerer_evals += 1
        M = self.probe(ce, ws, consts)
        Et, Eu, rp, cp = self._tables(M.dtype, M.device)
        nq1, d = self.nq1, self.d
        C = M.shape[-1]
        na = self.nalpha
        if self.rank == 2:
            # M[c, a, b, q1..qd]
            M = M.permute(3, 0, 1, 2).reshape((C, na, na) + (nq1,) * d)
            if d == 2:
                # "cabxy,xia,yka,xjb,ylb->cikjl", y first, then x
                S = einsum("cabxy,yka,ylb->cabxkl", M, Et[1], Eu[1])
                loc = einsum("cabxkl,xia,xjb->cikjl", S, Et[0], Eu[0])
            else:
                # "cabxyz,xia,yka,zma,xjb,ylb,znb->cikmjln", z, y, x
                S = einsum("cabxyz,zma,znb->cabxymn", M, Et[2], Eu[2])
                S = einsum("cabxymn,yka,ylb->cabxkmln", S, Et[1], Eu[1])
                loc = einsum("cabxkmln,xia,xjb->cikmjln", S, Et[0], Eu[0])
            n_i = int(np.prod([E.shape[1] for E in Et]))
            n_j = int(np.prod([E.shape[1] for E in Eu]))
            loc = loc.reshape(C, n_i, n_j)[:, rp][:, :, cp]
            return loc.permute(1, 2, 0)
        M = M[:, 0].permute(2, 0, 1).reshape((C, na) + (nq1,) * d)
        if d == 2:
            # "caxy,xia,yka->cik"
            S = einsum("caxy,yka->caxk", M, Et[1])
            loc = einsum("caxk,xia->cik", S, Et[0])
        else:
            # "caxyz,xia,yka,zma->cikm"
            S = einsum("caxyz,zma->caxym", M, Et[2])
            S = einsum("caxym,yka->caxkm", S, Et[1])
            loc = einsum("caxkm,xia->cikm", S, Et[0])
        loc = loc.reshape(C, -1)[:, rp]
        return loc.t()[:, None, :]                     # (ni, 1, C)


def first_cells_inputs(ci, C):
    """Cell-last inputs of a cell integral over the first C cells of its
    mesh (coordinates, zero coefficients, the Constants' values): what a
    route evaluates once to learn whether the lowerer covers the form."""
    from ..device import get_device
    mesh = ci.mesh
    dev = get_device()
    C = min(C, mesh.num_cells)
    g = mesh.geometric_dimension
    cmap = mesh.coordinates.function_space().cell_dof_map[:C]
    idx = torch.as_tensor(cmap.reshape(C, -1, g).astype(np.int64),
                          device=dev)
    ce = mesh.device_coordinates()[idx].permute(1, 2, 0).contiguous()
    ws = tuple(torch.zeros((c.space.cell_dof_map.shape[1], C),
                           dtype=torch.float64, device=dev)
               for c in ci.coefficients)
    consts = tuple(torch.as_tensor(np.asarray(c.values()),
                                   dtype=torch.float64, device=dev)
                   for c in ci.constants)
    return ce, ws, consts


def build_spectral_plan(ci, test, trial):
    """SpectralPlan for a cell integral on quads or hexes with scalar
    tensor-product Lagrange argument spaces, else None.

    Selection as in the JAX package: degree >= 2 arguments (probe
    overhead dominates at Q1) unless FDTPU_SPECTRAL=1 forces it on;
    FDTPU_SPECTRAL=0 turns it off.  An integrand the probe lowerer does
    not cover (second derivatives) takes the direct lowerer: a real
    evaluation on two cells decides."""
    flag = os.environ.get("FDTPU_SPECTRAL")
    if flag == "0" or ci.integral_type != "cell" \
            or ci.qrule is not None or test is None \
            or ci.mesh.cell.name not in _TP_CELLS:
        return None
    spaces = [a.space for a in (test, trial) if a is not None]
    if not all(_is_tp_scalar_lagrange(s) for s in spaces):
        return None
    if flag != "1" and max(s.element.degree for s in spaces) < 2:
        return None
    lattices = [_slot_lattice(s.element) for s in spaces]
    if any(lat is None for lat in lattices):
        return None
    trial_space = trial.space if trial is not None else None
    try:
        plan = SpectralPlan(ci, test.space, trial_space,
                            lattices + [None] * (2 - len(lattices)))
        plan.probe(*first_cells_inputs(ci, 2))
    except NotImplementedError:
        return None
    return plan
