"""Extruded-mesh column assembly: the column plan and ``ColumnMatrix``.

On an extruded mesh every dof column is structured: with the column
renumbering (functionspace.py ``_maybe_column_renumber``) a CG_k node id
is ``base_node * Hd + z``, where ``Hd = k*nlay + 1`` is the vertical dof
count and ``z = layer*k + sz`` the vertical lattice position (the
reference keeps the same O(base) metadata: pyop2/types/set.py:307
ExtrudedSet, firedrake/cython/extrusion_numbering.pyx:222).  The JAX
package's assembly/columns.py, in torch:

* dof gathers are row gathers of whole ``(Hd,)`` columns, and the
  vertical offset of a cell slot is a strided slice of the layer axis;
* the local tensors land in base-ELL x layer-DIA planes
  ``(nbase, NB, ndz, Hd)``: the (row slot, column slot) pairs of a base
  cell are summed into planes by vertical offset, and the planes into
  their base rows by a gather table (or a sorted segment sum), in a fixed
  order and with no ``index_add_``;
* the SpMV is one row gather of x's columns plus shifted multiply-adds
  along the layer axis.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..device import get_device


# ------------------------------------------------------- factorization
def column_factorization(elem, base_elem, kz):
    """Factor each local dof of ``elem`` (on an extruded cell, extrusion
    axis = the last reference coordinate) into (base local dof, vertical
    lattice index): (sb, sz) int arrays, or None when it does not factor.

    The vertical coordinate is matched against the element's own 1D
    lattice (equispaced, or Gauss-Lobatto-Legendre for the spectral
    variant that Q_k >= 3 takes by default), not the equispaced ``z *
    kz``: the JAX package's match misses GLL nodes, so there Q3 on
    extruded quads is silently not column-numbered."""
    from ..elements.lagrange import _lattice_1d
    nodes = getattr(elem, "nodes", None)
    bnodes = getattr(base_elem, "nodes", None)
    if nodes is None or bnodes is None:
        return None
    nodes = np.asarray(nodes, dtype=np.float64)
    bnodes = np.asarray(bnodes, dtype=np.float64)
    if nodes.ndim != 2:
        return None
    if bnodes.ndim == 1:
        bnodes = bnodes[:, None]
    if nodes.shape[1] != bnodes.shape[1] + 1:
        return None
    g1 = _lattice_1d(kz, getattr(elem, "variant", None))
    dz = np.abs(nodes[:, -1][:, None] - g1[None, :])
    sz = dz.argmin(axis=1).astype(np.int64)
    if (dz[np.arange(len(sz)), sz] > 1e-9).any():
        return None
    xy = nodes[:, :-1]
    d2 = np.abs(xy[:, None, :] - bnodes[None, :, :]).max(axis=2)
    sb = d2.argmin(axis=1)
    if (d2[np.arange(len(sb)), sb] > 1e-9).any():
        return None
    # (sb, sz) pairs must be distinct (a bijection onto the product set)
    key = sb * (kz + 1) + sz
    if np.unique(key).size != len(key):
        return None
    return sb.astype(np.int64), sz


class ColumnLayout:
    """O(base) column metadata of a function space on an extruded mesh:
    node id == base_node * Hd + z (the extrusion_numbering.pyx role)."""

    def __init__(self, base_sdata, sb, sz, kz, nlay):
        self.base_sdata = base_sdata
        self.base_map = base_sdata.cell_node_map.astype(np.int64)
        self.sb, self.sz = sb, sz
        self.kz = kz                       # vertical dof stride per layer
        self.nlay = nlay
        self.Hd = kz * nlay + 1
        self.nbase = base_sdata.num_nodes


def _space_column(V):
    """ColumnLayout of V, or None (column-numbered spaces only; a
    RestrictedFunctionSpace renumbers its map and takes the gather
    route)."""
    sd = V.sdata
    col = getattr(sd, "column", None)
    if col is None or not getattr(sd, "column_numbered", False):
        return None
    if V.cell_node_map is not sd.cell_node_map:
        return None
    return col


def _idx(a, dtype=torch.int64):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=get_device())


# ------------------------------------------------------------------ plan
class ColumnPlan:
    """Device schedule for one form on an extruded mesh: column row
    gathers + strided z-slices in, fixed-order row sums out."""

    def __init__(self, asm, test_c, trial_c, coeff_c, coord_c):
        self.mesh = asm.mesh
        self.nlay = int(self.mesh._layers)
        self.ncell_b = self.mesh.num_cells // self.nlay
        self.rank = asm.rank
        self.test_c = test_c
        self.trial_c = trial_c
        self.coeff_c = coeff_c            # {count: (ColumnLayout, bs)}
        self.coord_c = coord_c            # (ColumnLayout, gdim)
        self._rows = {}                   # (id(layout), sb) -> device map
        if self.rank == 2:
            self._plan_adjacency()
            self._plan_rank2()
        else:
            self._plan_rank1()

    # ----------------------------------------------------- host planning
    def _plan_adjacency(self):
        """Base-mesh ELL adjacency + per-cell slot-pair positions."""
        r, c = self.test_c, self.trial_c
        rmap, cmap = r.base_map, c.base_map
        nbr, nbc = r.nbase, c.nbase
        key = (rmap[:, :, None] * nbc + cmap[:, None, :]).ravel()
        uk = np.unique(key)
        row_of, col_of = uk // nbc, uk % nbc
        row_start = np.searchsorted(row_of, np.arange(nbr))
        counts = np.diff(np.append(row_start, len(uk)))
        self.NB = int(counts.max())
        cols_tbl = np.zeros((nbr, self.NB), dtype=np.int64)
        cols_tbl[row_of, np.arange(len(uk)) - row_start[row_of]] = col_of
        self.cols_tbl = cols_tbl
        self.row_counts = counts
        ui = np.searchsorted(uk, key).reshape(rmap.shape[0],
                                              rmap.shape[1], cmap.shape[1])
        self.pos = (ui - row_start[row_of[ui]]).astype(np.int64)
        self.ndz = 2 * max(r.kz, c.kz) + 1
        # diagonal position (row == col) when square
        if nbr == nbc:
            k2 = np.arange(nbr) * nbc + np.arange(nbr)
            di = np.searchsorted(uk, k2)
            ok = (di < len(uk)) & (uk[np.minimum(di, len(uk) - 1)] == k2)
            self.diag_pos = np.where(ok, di - row_start, 0).astype(np.int64)
        else:
            self.diag_pos = None
        self._cols_dev = None
        self._keys_dev = None
        self._tsum = None

    def _plan_rank1(self):
        """Slot groups by base slot, and the fixed-order sum of each
        group's (ncb, Hd) plane into the base rows."""
        from ..assemble import _accumulation
        col = self.test_c
        self.groups1 = sorted(set(int(s) for s in col.sb))
        pos = np.concatenate([col.base_map[:, sb] for sb in self.groups1])
        self._acc = _accumulation(pos, col.nbase, get_device())

    def _plan_rank2(self):
        """(row base slot, column base slot) groups, and the fixed-order
        sum of their (ncb, ndz*Hd) planes into the ELL rows."""
        from ..assemble import _accumulation
        r, c = self.test_c, self.trial_c
        self.groups2 = sorted({(int(r.sb[i]), int(c.sb[j]))
                               for i in range(len(r.sb))
                               for j in range(len(c.sb))})
        pos = np.concatenate([r.base_map[:, sbr] * self.NB
                              + self.pos[:, sbr, sbc]
                              for sbr, sbc in self.groups2])
        self._acc = _accumulation(pos, r.nbase * self.NB, get_device())

    # --------------------------------------------------- device programs
    def _row_map(self, col, sb):
        k = (id(col), sb)
        if k not in self._rows:
            self._rows[k] = _idx(col.base_map[:, sb])
        return self._rows[k]

    @staticmethod
    def _planes(dat, col, bs):
        if bs == 1:
            return [dat.reshape(col.nbase, col.Hd)]
        return [dat[d::bs].reshape(col.nbase, col.Hd) for d in range(bs)]

    def _window(self, rows, sz, kz):
        """(ncb, Hd) column rows -> flat (C,) cell-slot values: one
        strided slice of the layer axis."""
        return rows[:, sz:sz + kz * (self.nlay - 1) + 1:kz].reshape(-1)

    def gather_cell_inputs(self, coords_dat, coeff_dats, ci):
        """Kernel inputs: coords (ndofc, g, C), coeffs tuple (nslots, C),
        cell id = base cell * nlay + layer.  One row gather per base slot,
        shared across vertical offsets."""
        rows = {}

        def rg(planes, col, d, sb):
            k = (id(planes), d, sb)
            if k not in rows:
                rows[k] = planes[d][self._row_map(col, sb)]
            return rows[k]

        col, g = self.coord_c
        planes = self._planes(coords_dat, col, g)
        ce = torch.stack([
            torch.stack([self._window(rg(planes, col, d, int(col.sb[s])),
                                      int(col.sz[s]), col.kz)
                         for d in range(g)])
            for s in range(len(col.sb))])
        ws = []
        for c in ci.coefficients:
            ccol, bs = self.coeff_c[c.count]
            p = self._planes(coeff_dats[c.count], ccol, bs)
            ws.append(torch.stack([
                self._window(rg(p, ccol, d, int(ccol.sb[s])),
                             int(ccol.sz[s]), ccol.kz)
                for s in range(len(ccol.sb)) for d in range(bs)]))
        return ce, tuple(ws)

    def _place(self, v, sz, col):
        """(ncb, nlay) per-cell values -> (ncb, Hd) at vertical offset sz
        with stride kz (zeros elsewhere)."""
        out = v.new_zeros((v.shape[0], col.Hd))
        out[:, sz:sz + col.kz * (self.nlay - 1) + 1:col.kz] = v
        return out

    def accumulate_rank1(self, loc):
        """(ni, 1, C) local values -> flat (nbase*Hd,) dof vector."""
        col = self.test_c
        ncb, nlay = self.ncell_b, self.nlay
        acc = {}
        for i in range(loc.shape[0]):
            p = self._place(loc[i, 0].reshape(ncb, nlay), int(col.sz[i]),
                            col)
            sb = int(col.sb[i])
            acc[sb] = p if sb not in acc else acc[sb] + p
        flat = torch.cat([acc[sb] for sb in self.groups1])
        return self._acc(flat).reshape(-1)

    def accumulate_rank2(self, loc):
        """(ni, nj, C) local tensors -> (nbase, NB, ndz, Hd) band data."""
        r, c = self.test_c, self.trial_c
        ncb, nlay = self.ncell_b, self.nlay
        kz = max(r.kz, c.kz)
        groups = {}                        # (sbr, sbc) -> {dz: plane}
        for i in range(loc.shape[0]):
            sbr, szr = int(r.sb[i]), int(r.sz[i])
            for j in range(loc.shape[1]):
                sbc, szc = int(c.sb[j]), int(c.sz[j])
                p = self._place(loc[i, j].reshape(ncb, nlay), szr, r)
                dz = szc - szr + kz
                g = groups.setdefault((sbr, sbc), {})
                g[dz] = p if dz not in g else g[dz] + p
        zero = loc.new_zeros((ncb, r.Hd))
        flat = torch.cat([
            torch.stack([groups[k].get(dz, zero) for dz in range(self.ndz)],
                        dim=1).reshape(ncb, -1)
            for k in self.groups2])
        return self._acc(flat).reshape(r.nbase, self.NB, self.ndz, r.Hd)

    # --------------------------------------------- matrix device tables
    def cols_device(self):
        if self._cols_dev is None:
            self._cols_dev = _idx(self.cols_tbl)
        return self._cols_dev

    def entry_keys_device(self):
        """(keys, slots): row * nbase_c + col of every stored base-ELL
        pair, ascending (row-major, each row's columns sorted), and its
        flat (row, neighbour) slot row * NB + nb, on the device."""
        if self._keys_dev is None:
            nb = np.arange(self.NB)[None, :]
            valid = nb < self.row_counts[:, None]
            rows = np.broadcast_to(np.arange(len(self.cols_tbl))[:, None],
                                   valid.shape)
            keys = rows * self.trial_c.nbase + self.cols_tbl
            self._keys_dev = (_idx(keys[valid]),
                              _idx((rows * self.NB + nb)[valid]))
        return self._keys_dev

    def transpose_sum(self):
        """Fixed-order sum of (row, neighbour) blocks into their base
        columns (the padding slots of short rows drop out)."""
        if self._tsum is None:
            from ..assemble import _accumulation
            nb = np.arange(self.NB)[None, :]
            pos = np.where(nb < self.row_counts[:, None], self.cols_tbl,
                           self.trial_c.nbase)
            self._tsum = _accumulation(pos.reshape(-1), self.trial_c.nbase,
                                       get_device())
        return self._tsum


def _covers(ci):
    """Whether the torch lowerer evaluates this cell integral: one real
    evaluation on a batch of 4 cells.  Only a form the lowerer does not
    cover (NotImplementedError) sends the form to the gather route."""
    from ..compiler.spectral import first_cells_inputs
    try:
        ci.cell_kernel_batched()(*first_cells_inputs(ci, 4))
    except NotImplementedError:
        return False
    return True


def build_column_plan(asm):
    """ColumnPlan for a FormAssembler, or None when it does not apply
    (FDTPU_NO_COLUMN=1 turns the route off, as in the JAX package)."""
    if os.environ.get("FDTPU_NO_COLUMN") == "1":
        return None
    mesh = asm.mesh
    if not getattr(mesh, "_extruded", False) or asm.rank not in (1, 2):
        return None
    if getattr(mesh, "_var_layers", None) is not None:
        return None     # ragged columns: the gather route
    test_c = _space_column(asm.test.space)
    if test_c is None or asm.test.space.block_size != 1:
        return None
    trial_c = None
    if asm.rank == 2:
        if asm.trial.space.block_size != 1:
            return None
        trial_c = _space_column(asm.trial.space)
        if trial_c is None:
            return None
    coord_space = mesh.coordinates.function_space()
    coord_c = _space_column(coord_space)
    if coord_c is None:
        return None
    coeff_c = {}
    for ci in asm._compiled:
        if ci.integral_type != "cell" \
                or ci.subdomain_id not in ("everywhere", None):
            return None
        for c in ci.coefficients:
            if c.count not in coeff_c:
                cs = getattr(c, "space", None)
                if cs is None or getattr(cs, "mesh_obj", None) is not mesh:
                    return None
                cc = _space_column(cs)
                if cc is None:
                    return None
                coeff_c[c.count] = (cc, cs.block_size)
        if not _covers(ci):
            return None
    return ColumnPlan(asm, test_c, trial_c, coeff_c,
                      (coord_c, coord_space.block_size))


# --------------------------------------------------------------- matrix
class ColumnMatrix:
    """Assembled operator on an extruded mesh: base-ELL x layer-DIA.

    data (nbase, NB, ndz, Hd): for base row node i and its nb-th base
    neighbour j = cols_tbl[i, nb], the entry A[(i, z), (j, z + dz - kz)]
    sits at data[i, nb, dz, z].  SpMV = one row gather of x's columns +
    shifted multiply-adds along the layer axis (reference semantics:
    firedrake/matrix.py:48 over a pyop2 Mat with an extruded iteration
    set)."""

    def __init__(self, plan: ColumnPlan, data, row_space=None,
                 col_space=None, bcs=()):
        self.plan = plan
        self.data = data                    # (nbase, NB, ndz, Hd)
        self.row_space = row_space
        self.col_space = col_space
        self.bcs = tuple(bcs)
        r, c = plan.test_c, plan.trial_c
        self.Hd, self.kz = r.Hd, max(r.kz, c.kz)
        self.nbase_r, self.nbase_c = r.nbase, c.nbase

    @property
    def shape(self):
        return (self.nbase_r * self.Hd, self.nbase_c * self.plan.trial_c.Hd)

    @property
    def dtype(self):
        return self.data.dtype

    # ---------------------------------------------------------------- ops
    def matvec(self, x):
        X = x.reshape(self.nbase_c, self.plan.trial_c.Hd)
        xn = X[self.plan.cols_device()]              # (nbase_r, NB, Hd)
        kz = self.kz
        xp = torch.nn.functional.pad(xn, (kz, kz))
        y = None
        for dz in range(self.plan.ndz):
            term = (self.data[:, :, dz, :]
                    * xp[:, :, dz:dz + self.Hd]).sum(dim=1)
            y = term if y is None else y + term
        return y.reshape(-1)

    __matmul__ = matvec

    def transpose_matvec(self, y):
        """A^T y: each (row, neighbour) block is shifted along the layer
        axis and the blocks are summed into their columns in a fixed
        order."""
        Y = y.reshape(self.nbase_r, self.Hd)
        kz, Hd = self.kz, self.Hd
        blk = y.new_zeros((self.nbase_r, self.plan.NB, Hd + 2 * kz))
        for dz in range(self.plan.ndz):
            blk[:, :, dz:dz + Hd] += self.data[:, :, dz, :] * Y[:, None, :]
        out = self.plan.transpose_sum()(blk.reshape(-1, Hd + 2 * kz))
        return out[:, kz:kz + self.plan.trial_c.Hd].reshape(-1)

    def entries(self, rows, cols):
        """A[rows, cols] for int64 index tensors of one shape, gathered on
        the data's device: the base pair (row // Hd, col // Hd) is looked
        up among the plan's sorted base-ELL keys, its layer offset is the
        difference of the two z; 0 off the band (as
        A.to_scipy()[np.ix_(p, p)].toarray(), bit for bit)."""
        p = self.plan
        Hc = p.trial_c.Hd
        keys, slots = p.entry_keys_device()
        z, zc = rows % self.Hd, cols % Hc
        q = (rows // self.Hd) * self.nbase_c + cols // Hc
        pos = torch.searchsorted(keys, q.reshape(-1)).clamp(
            max=keys.numel() - 1).reshape(q.shape)
        dz = zc - z + self.kz
        ok = (keys[pos] == q) & (dz >= 0) & (dz < p.ndz)
        vals = self.data.reshape(-1, p.ndz, self.Hd)[
            slots[pos], dz.clamp(0, p.ndz - 1), z]
        # + 0.0: a stored -0.0 (a Dirichlet row's zeros) reads as scipy's
        # dense copy holds it, +0.0
        return torch.where(ok, vals, torch.zeros((), dtype=vals.dtype,
                                                 device=vals.device)) + 0.0

    def diagonal(self):
        dp = self.plan.diag_pos
        if dp is None:
            raise ValueError("diagonal of a non-square ColumnMatrix")
        dev = self.data.device
        return self.data[torch.arange(self.nbase_r, device=dev),
                         _idx(dp).to(dev), self.kz, :].reshape(-1)

    def copy(self):
        return ColumnMatrix(self.plan, self.data, self.row_space,
                            self.col_space, self.bcs)

    # ----------------------------------------------------------------- bcs
    def with_dirichlet(self, bc_rows, symmetric=True):
        """Zero the bc rows (and columns), 1 on their diagonal; returns a
        new ColumnMatrix."""
        dev = self.data.device
        n = self.nbase_r * self.Hd
        mask = torch.zeros(n, dtype=self.data.dtype, device=dev)
        mask[torch.as_tensor(np.asarray(bc_rows, dtype=np.int64),
                             device=dev)] = 1.0
        mask = mask.reshape(self.nbase_r, self.Hd)
        data = self.data * (1.0 - mask)[:, None, None, :]
        if symmetric:
            cm = mask[self.plan.cols_device()]       # (nbr, NB, Hd)
            kz = self.kz
            cmp_ = torch.nn.functional.pad(cm, (kz, kz))
            keep = torch.stack([1.0 - cmp_[:, :, dz:dz + self.Hd]
                                for dz in range(self.plan.ndz)], dim=2)
            data = data * keep
        rows = torch.arange(self.nbase_r, device=dev)
        dpos = _idx(self.plan.diag_pos).to(dev)
        data[rows, dpos, self.kz, :] += mask
        return ColumnMatrix(self.plan, data, self.row_space,
                            self.col_space, self.bcs)

    # -------------------------------------------------------------- export
    def _band_indices(self):
        """Host (rows, cols, (nb, dz, z)) triplets of in-band entries."""
        p = self.plan
        nbr, NB, ndz, Hd = self.nbase_r, p.NB, p.ndz, self.Hd
        i = np.arange(nbr)[:, None, None, None]
        nb = np.arange(NB)[None, :, None, None]
        dz = np.arange(ndz)[None, None, :, None]
        z = np.arange(Hd)[None, None, None, :]
        zc = z + dz - self.kz
        valid = ((nb < p.row_counts[:, None, None, None])
                 & (zc >= 0) & (zc < p.trial_c.Hd))
        ii, nn, dd, zz = np.broadcast_arrays(i, nb, dz, z)
        ii, nn, dd, zz = (a[valid] for a in (ii, nn, dd, zz))
        rows = ii * Hd + zz
        cols = p.cols_tbl[ii, nn] * p.trial_c.Hd + (zz + dd - self.kz)
        return rows, cols, (ii, nn, dd, zz)

    def to_scipy(self):
        from scipy.sparse import coo_matrix
        rows, cols, (ii, nn, dd, zz) = self._band_indices()
        dat = self.data.detach().cpu().numpy()
        return coo_matrix((dat[ii, nn, dd, zz], (rows, cols)),
                          shape=self.shape).tocsr()

    def to_dense(self):
        return self.to_scipy().toarray()

    @property
    def M(self):
        from .matrix import MatView
        return MatView(self)

    def to_dense_device(self):
        """The dense operator on the data's device (each band entry is
        one distinct (row, column), so the placement is a plain index
        write)."""
        rows, cols, (ii, nn, dd, zz) = self._band_indices()
        dev = self.data.device
        out = torch.zeros(self.shape, dtype=self.data.dtype, device=dev)
        t = [torch.as_tensor(a, device=dev) for a in (ii, nn, dd, zz)]
        out[torch.as_tensor(rows, device=dev),
            torch.as_tensor(cols, device=dev)] = self.data[t[0], t[1], t[2],
                                                           t[3]]
        return out

    @property
    def nnz(self):
        """Band entries actually addressable."""
        if getattr(self.plan, "_nnz", None) is None:
            rows, _, _ = self._band_indices()
            self.plan._nnz = int(len(rows))
        return self.plan._nnz

    def __repr__(self):
        return (f"ColumnMatrix({self.shape}, NB={self.plan.NB}, "
                f"ndz={self.plan.ndz}, Hd={self.Hd})")
