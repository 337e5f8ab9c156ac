"""BDDCPC: Balancing Domain Decomposition by Constraints (the port's copy
of ``firedrake_tpu/solvers/bddc.py``; reference surface:
firedrake/preconditioners/bddc.py:27 BDDCPC, a wrapper of PETSc's PCBDDC).

The algorithm itself (Dohrmann 2003), exact interior solves on the
interface Schur complement:
  M^-1 r:  u1 = A_II^-1 r_I                 (batched interior solves)
           g  = r - A u1                     (Schur residual on Gamma)
           w  = E_D^T ( N(g) + Psi S_Pi^-1 Psi^T E_D g )   (interface)
           z  = u1 + w - A_II^-1 (A w)_I     (harmonic extension)
where per subdomain s the Neumann correction N solves the constrained
local problem [A_s  C_s^T; C_s  -eps I] [v; lam] = [E_D g; 0] and
Psi/S_Pi are the energy-minimal coarse basis and primal Schur complement,
read off the same batched saddle inverses (S_Pi^s = -(K^-1)_22).

Primal constraints: point constraints at subdomain corners (dofs whose
subdomain multiplicity is >= 3, and appctx ``primal_markers``) plus one
average per interface class (the dofs shared by the same subdomains).
Subdomains are contiguous chunks of the SFC cell order
(parallel/partition.py); ``bddc_subdomains`` overrides the count
(default clip(ncells // 64, 4, 512)).

The host tables (subdomains, multiplicities, corners, interface classes,
C, Lpad) are numpy and equal the JAX package's.  On the device: the local
Neumann matrices come from Slate's per-cell tensors (K1 where the form is
in its family) summed into the padded subdomain blocks by a fixed-order
plan (assemble._accumulation), as are the global primal Schur complement
and the interface sum; the interior solves are gathers.  K2 inverts the
interior blocks M_int (SPD, unpivoted), the saddle systems K (pivoted: on
a floating subdomain A_s is the singular Neumann matrix, and Gauss-Jordan
without pivoting meets a zero pivot in its last dof) and S_Pi (a batch of
one, unpivoted, as the JAX package's ``_dense_inv_gj``).  Each block
batch is freed as soon as it has been used.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from .pcs import PCBase
from ..device import as_tensor

__all__ = ["BDDCPC"]


def _host_tables(V, bcs, nsub, markers):
    """The JAX package's BDDC host tables, for V (a FunctionSpace) with
    Dirichlet conditions `bcs`, `nsub` subdomains (None: the default) and
    the forced primal dofs `markers` (or None).  Vectorised where the JAX
    package loops over subdomains; the results are the same arrays."""
    from ..parallel.partition import sfc_cell_order
    mesh = V.mesh_obj
    nc = mesh.num_cells
    cmap = np.asarray(V.cell_dof_map, dtype=np.int64)
    nd = cmap.shape[1]
    ndof = V.dim

    ns = int(nsub) if nsub is not None else int(np.clip(nc // 64, 4, 512))
    ns = max(2, min(ns, nc))
    order = sfc_cell_order(mesh)
    cell_sub = np.empty(nc, dtype=np.int64)
    for s, chunk in enumerate(np.array_split(order, ns)):
        cell_sub[chunk] = s

    bc_mask = np.zeros(ndof, dtype=bool)
    for b in bcs or ():
        bc_mask[np.asarray(b.dof_indices, dtype=np.int64)] = True

    # ---- dof -> set of touching subdomains: the distinct (dof, sub)
    # pairs in lexicographic order (np.unique(..., axis=0) of the JAX
    # package, by one integer key)
    key = np.unique(cmap.reshape(-1) * ns + np.repeat(cell_sub, nd))
    pairs = np.stack([key // ns, key % ns], 1)
    mult = np.bincount(pairs[:, 0], minlength=ndof)
    starts = np.searchsorted(pairs[:, 0], np.arange(ndof))
    ends = np.searchsorted(pairs[:, 0], np.arange(ndof) + 1)

    # ---- primal constraints
    forced = set(np.asarray(markers, dtype=np.int64).tolist()
                 if markers is not None else [])
    corners = []          # global dof ids (point constraints)
    classes = {}          # subdomain tuple -> [dofs] (averages)
    for d in np.flatnonzero((mult >= 2) & ~bc_mask):
        subs = tuple(pairs[starts[d]:ends[d], 1])
        if mult[d] >= 3 or d in forced:
            corners.append((int(d), subs))
        else:
            classes.setdefault(subs, []).append(int(d))

    # global constraint numbering: corners first, then classes
    n_pi = len(corners) + len(classes)
    if n_pi == 0:
        raise ValueError("BDDCPC: no primal constraints — mesh too "
                         "small for the subdomain count")
    sub_cons = [[] for _ in range(ns)]
    for gid, (d, subs) in enumerate(corners):
        for s in subs:
            sub_cons[s].append((gid, [(d, 1.0)]))
    for cid, (subs, dofs) in enumerate(classes.items()):
        gid = len(corners) + cid
        w = 1.0 / len(dofs)
        for s in subs:
            sub_cons[s].append((gid, [(d, w) for d in dofs]))

    # ---- per-subdomain local dof lists (sorted: np.unique's), padded
    by_sub = np.sort(pairs[:, 1] * ndof + pairs[:, 0])
    sub_start = np.searchsorted(by_sub, np.arange(ns + 1) * ndof)
    sub_dofs = [by_sub[sub_start[s]:sub_start[s + 1]] - s * ndof
                for s in range(ns)]
    nmax = max(len(L) for L in sub_dofs)
    mmax = max(len(c) for c in sub_cons)
    Lpad = np.zeros((ns, nmax), dtype=np.int64)
    valid = np.zeros((ns, nmax), dtype=bool)
    for s, L in enumerate(sub_dofs):
        Lpad[s, :len(L)] = L
        valid[s, :len(L)] = True

    free = valid & ~bc_mask[Lpad]
    interior = free & (mult[Lpad] == 1)
    gamma = free & (mult[Lpad] >= 2)
    Dw = np.where(free, 1.0 / np.maximum(mult[Lpad], 1), 0.0)

    # local constraint rows C (ns, mmax, nmax) + global ids
    C = np.zeros((ns, mmax, nmax))
    cpad = np.full((ns, mmax), n_pi, dtype=np.int64)  # pad -> dummy
    con_valid = np.zeros((ns, mmax), dtype=bool)
    for s, cons in enumerate(sub_cons):
        for m, (gid, entries) in enumerate(cons):
            cpad[s, m] = gid
            con_valid[s, m] = True
            d, w = zip(*entries)
            C[s, m, np.searchsorted(sub_dofs[s], d)] = w

    # each cell's dofs as positions in its subdomain's list
    lidx = (np.searchsorted(by_sub, cell_sub[:, None] * ndof + cmap)
            - sub_start[cell_sub][:, None])
    return SimpleNamespace(
        ns=ns, ndof=ndof, nmax=nmax, mmax=mmax, n_pi=n_pi,
        cell_sub=cell_sub, mult=mult, bc_mask=bc_mask, Lpad=Lpad,
        valid=valid, free=free, interior=interior, gamma=gamma, Dw=Dw,
        C=C, cpad=cpad, con_valid=con_valid, lidx=lidx)


def _sum_into(pos, nseg):
    """Fixed-order sum of a flat value array whose entry k lands in entry
    pos[k] of a length-nseg result (entries >= nseg dropped), over the
    distinct targets alone: (targets, plan), plan(values) giving one sum
    per target (the gather route's plan, summing in the entries' order)."""
    from ..assemble import _accumulation
    from ..device import get_device
    keep = pos < nseg
    targets, inv = np.unique(pos[keep], return_inverse=True)
    slot = np.full(pos.shape, len(targets), dtype=np.int64)
    slot[keep] = inv
    return (torch.as_tensor(targets, device=get_device()),
            _accumulation(slot, len(targets), get_device()))


class BDDCPC(PCBase):
    """Balancing Domain Decomposition by Constraints (SPD problems).

    Options: ``bddc_subdomains`` (int, default ~ncells/64).  appctx:
    ``primal_markers`` — extra global dof indices forced into the
    coarse (primal) space.  The reference's
    ``bddc_pc_bddc_{neumann,dirichlet,coarse}`` sub-KSP options are
    accepted but ignored: all three solves are exact batched dense
    inverses."""

    _prefix = "bddc_"

    def initialize_ctx(self, ctx, params, prefix):
        from .composition import opt
        from ..slate import _local_form_tensor
        from ..ops.batched_inverse import batched_inv

        V, form = ctx.space, ctx.form
        if V is None or form is None:
            raise ValueError("BDDCPC needs the bilinear form and space")
        self._matvec = ctx.matvec
        nsub = opt(params, prefix, self._prefix + "subdomains", None)
        t = _host_tables(V, ctx.bcs, nsub,
                         (ctx.appctx or {}).get("primal_markers", None))
        ns, nmax, mmax, ndof, n_pi = t.ns, t.nmax, t.mmax, t.ndof, t.n_pi

        # ---- batched local Neumann matrices: the canonical element
        # tensors summed into their subdomain blocks in a fixed order
        A_loc = _local_form_tensor(form).cell          # (nc, nd, nd)
        dt, dev = A_loc.dtype, A_loc.device
        flat = (t.cell_sub[:, None, None] * (nmax * nmax)
                + t.lidx[:, :, None] * nmax + t.lidx[:, None, :])
        slots, plan = _sum_into(flat.reshape(-1), ns * nmax * nmax)
        Apad = torch.zeros(ns * nmax * nmax, dtype=dt, device=dev)
        Apad[slots] = plan(A_loc.reshape(-1)).to(dt)
        Apad = Apad.reshape(ns, nmax, nmax)
        del A_loc, plan, slots

        fmask = as_tensor(t.free.astype(np.float64)).to(dt)
        Apad.mul_(fmask[:, :, None]).mul_(fmask[:, None, :])
        Apad.diagonal(dim1=1, dim2=2).add_(1.0 - fmask)   # identity filler

        imask = as_tensor(t.interior.astype(np.float64)).to(dt)
        M_int = Apad * imask[:, :, None]
        M_int.mul_(imask[:, None, :])
        M_int.diagonal(dim1=1, dim2=2).add_(1.0 - imask)
        self._Binv = batched_inv(M_int)
        del M_int

        # saddle systems: [[A, C^T], [C, -eps I]]; padded constraint
        # rows get a unit diagonal (zero C row) so K stays invertible
        Cd = as_tensor(t.C).to(dt)
        scale = torch.mean(Apad.diagonal(dim1=1, dim2=2))
        cv = as_tensor(t.con_valid.astype(np.float64)).to(dt)
        K = torch.zeros((ns, nmax + mmax, nmax + mmax), dtype=dt,
                        device=dev)
        K[:, :nmax, :nmax] = Apad
        del Apad
        K[:, :nmax, nmax:] = Cd.transpose(1, 2)
        K[:, nmax:, :nmax] = Cd
        K[:, nmax:, nmax:] = torch.diag_embed(
            torch.where(cv > 0, -1e-10 * scale, torch.ones_like(cv)))
        Kinv = batched_inv(K, pivot=True)
        del K
        self._T = Kinv[:, :nmax, :nmax]                # Neumann solve
        self._Psi = Kinv[:, :nmax, nmax:]              # coarse basis
        S_loc = -Kinv[:, nmax:, nmax:]                 # primal Schur

        # global primal Schur (dense, n_pi x n_pi) and its inverse
        both = t.con_valid[:, :, None] & t.con_valid[:, None, :]
        gi = np.where(both, t.cpad[:, :, None] * n_pi + t.cpad[:, None, :],
                      n_pi * n_pi)
        slots, plan = _sum_into(gi.reshape(-1), n_pi * n_pi)
        S_pi = torch.zeros(n_pi * n_pi, dtype=dt, device=dev)
        S_pi[slots] = plan(
            (S_loc * cv[:, :, None] * cv[:, None, :]).reshape(-1)).to(dt)
        S_pi = S_pi.reshape(n_pi, n_pi)
        self._SPinv = batched_inv(S_pi[None].contiguous())[0]
        del S_loc, S_pi

        dev_i = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
        self._Lpad = dev_i(t.Lpad)
        self._Dw = as_tensor(t.Dw).to(dt)
        self._imaskf = imask
        self._gmaskf = as_tensor(t.gamma.astype(np.float64)).to(dt)
        self._cpad = dev_i(t.cpad)
        self._freeg = as_tensor((~t.bc_mask).astype(np.float64)).to(dt)
        self._ndof, self._npi = ndof, n_pi
        # interior solves: every interior dof lies in one subdomain, so
        # the scatter is a gather (the pad slot ns * nmax reads 0)
        ipos = np.full(ndof, ns * nmax, dtype=np.int64)
        ipos[t.Lpad[t.interior]] = np.flatnonzero(t.interior.reshape(-1))
        self._ipos = dev_i(ipos)
        # the primal restriction and the interface sum, in a fixed order
        self._pi_sum = _sum_into(t.cpad.reshape(-1), n_pi)
        self._gamma_sum = _sum_into(
            np.where(t.gamma, t.Lpad, ndof).reshape(-1), ndof)

    @staticmethod
    def _scatter(sum_, vals, n):
        targets, plan = sum_
        out = vals.new_zeros(n)
        out[targets] = plan(vals).to(vals.dtype)
        return out

    def _interior(self, r):
        """Batched exact interior solves; zero outside interiors."""
        rloc = r[self._Lpad] * self._imaskf
        u = torch.einsum("snm,sm->sn", self._Binv, rloc) * self._imaskf
        return torch.cat([u.reshape(-1), u.new_zeros(1)])[self._ipos]

    def apply(self, r):
        rf = r * self._freeg
        u1 = self._interior(rf)
        g = (rf - self._matvec(u1)) * self._freeg
        gloc = g[self._Lpad] * self._Dw
        # dual (constrained-Neumann) corrections
        v = torch.einsum("snm,sm->sn", self._T, gloc)
        # primal coarse correction
        rpi = self._scatter(self._pi_sum, torch.einsum(
            "snm,sn->sm", self._Psi, gloc).reshape(-1), self._npi)
        xpi = self._SPinv @ rpi
        xpi = torch.cat([xpi, xpi.new_zeros(1)])       # dummy pad slot
        vc = torch.einsum("snm,sm->sn", self._Psi, xpi[self._cpad])
        w = self._scatter(self._gamma_sum,
                          ((v + vc) * self._Dw * self._gmaskf).reshape(-1),
                          self._ndof)
        # harmonic extension of the interface correction
        u2 = self._interior(self._matvec(w))
        z = u1 + w - u2
        return z * self._freeg + r * (1.0 - self._freeg)
