"""Assembled sparse matrix over a Sparsity (the port's copy of
``firedrake_tpu/assembly/matrix.py``; reference role: firedrake/matrix.py:48
over pyop2.Mat / PETSc AIJ): one flat tensor of CSR values over nnz on the
device, the index tables of its Sparsity beside it.

The SpMV is plain torch, as the JAX package's is plain XLA: the ELL form
(the rows padded to the longest, one gather and a row sum), ten times
faster on the card than the flat form (one gather and a segment sum over
the sorted rows) at 1,050,625 rows (PERF.md).
"""
from __future__ import annotations

import numpy as np
import torch

from .sparsity import Sparsity
from ..device import get_device


def device_tables(sparsity: Sparsity, device):
    """The Sparsity's index tables on ``device``, made once per device and
    shared by every Matrix over it."""
    cache = sparsity.__dict__.setdefault("_device_tables", {})
    key = str(device)
    if key not in cache:
        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   dtype=torch.int32, device=device)
        ell_cols, ell_pos, _ = sparsity.ell
        cache[key] = dict(rows=t(sparsity.coo_rows), cols=t(sparsity.coo_cols),
                          ell_cols=t(ell_cols.reshape(-1)),
                          ell_pos=t(ell_pos),
                          diag=t(sparsity.diag_positions))
    return cache[key]


def ell_values(data, tables, nrows, kmax):
    """The CSR values laid out as the (nrows, kmax) ELL array, padded with
    zeros."""
    flat = data.new_zeros(nrows * kmax)
    flat[tables["ell_pos"]] = data
    return flat.view(nrows, kmax)


def ell_matvec(ell_data, x, tables):
    """y = A x from the ELL values: one gather, a product, a row sum."""
    nrows, kmax = ell_data.shape
    xg = x.index_select(0, tables["ell_cols"]).view(nrows, kmax)
    return (ell_data * xg).sum(dim=1)


class MatView:
    """Reference-compatible ``A.M`` handle (pyop2 Mat role): ``.values`` is
    the dense array."""

    def __init__(self, mat):
        self._mat = mat

    @property
    def values(self):
        return self._mat.to_dense()

    @property
    def handle(self):
        return self._mat


class Matrix:
    """Sparse matrix: static Sparsity + device data (nnz,).

    The matvec reads the ELL copy of ``data``, made on first use: assign
    ``data`` anew to change the values (that drops the copy); an in-place
    edit of the tensor is not seen by later matvecs."""

    def __init__(self, sparsity: Sparsity, data=None, row_space=None,
                 col_space=None, bcs=()):
        self.sparsity = sparsity
        self.data = (torch.zeros(sparsity.nnz, dtype=torch.float64,
                                 device=get_device())
                     if data is None else data)
        self.row_space = row_space
        self.col_space = col_space
        self.bcs = tuple(bcs)
        self._tables = device_tables(sparsity, self.data.device)

    @property
    def data(self):
        return self._data

    @data.setter
    def data(self, values):
        self._data = values
        self._ell = None

    @property
    def shape(self):
        return (self.sparsity.nrows, self.sparsity.ncols)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self):
        return self.sparsity.nnz

    @property
    def M(self):
        return MatView(self)

    # --------------------------------------------------------------- ops
    def matvec(self, x):
        if self._ell is None:
            s = self.sparsity
            self._ell = ell_values(self.data, self._tables, s.nrows, s.kmax)
        return ell_matvec(self._ell, x, self._tables)

    __matmul__ = matvec

    def diagonal(self):
        pos = self._tables["diag"]
        d = self.data[pos.clamp(min=0)]
        return torch.where(pos >= 0, d, torch.zeros_like(d))

    def entries(self, rows, cols):
        """A[rows, cols] for int64 index tensors of one shape, gathered on
        the data's device: each (row, col) is looked up among the stored
        entries' sorted keys; 0 where the sparsity has no entry (as
        A.to_scipy()[rows, cols])."""
        t = self._tables
        if "keys" not in t:
            # row * ncols + col of each stored entry, sorted ascending as
            # the CSR order is row-major: made on first use and shared by
            # the Sparsity's matrices (only the patch PC reads entries)
            t["keys"] = t["rows"].long() * self.sparsity.ncols + t["cols"]
        keys = t["keys"]
        q = rows * self.sparsity.ncols + cols
        pos = torch.searchsorted(keys, q.reshape(-1)).clamp(
            max=keys.numel() - 1).reshape(q.shape)
        vals = self.data[pos]
        return torch.where(keys[pos] == q, vals, torch.zeros_like(vals))

    def transpose_matvec(self, y):
        """A^T y by a scatter-add over the columns (for adjoint solves;
        on the card its sums run in no fixed order)."""
        t = self._tables
        contrib = self.data * y.index_select(0, t["rows"])
        return self.data.new_zeros(self.sparsity.ncols).index_add_(
            0, t["cols"], contrib)

    # ------------------------------------------------------------- export
    def to_scipy(self):
        from scipy.sparse import csr_matrix
        s = self.sparsity
        return csr_matrix((self.data.detach().cpu().numpy(), s.coo_cols,
                           s.indptr), shape=self.shape)

    def to_dense(self):
        return self.to_scipy().toarray()

    def copy(self):
        return Matrix(self.sparsity, self.data, self.row_space,
                      self.col_space, self.bcs)

    # ----------------------------------------------------- bc application
    def with_dirichlet(self, bc_rows, symmetric=True):
        """Zero the bc rows (and columns), 1 on their diagonal; returns a
        new Matrix (reference: firedrake/assemble.py:1243-1268)."""
        return self.with_zeroed(bc_rows, bc_rows if symmetric else (),
                                unit_diagonal=True)

    def with_zeroed(self, rows, cols, unit_diagonal):
        """A new Matrix with the given rows and columns zeroed and, with
        ``unit_diagonal``, 1 on the diagonal of those rows (a block of a
        mixed operator zeroes its field's bc rows and the other field's
        bc columns; only diagonal blocks take the 1)."""
        t = self._tables
        dev = self.data.device

        def mask(idx, n):
            m = torch.zeros(n, dtype=torch.bool, device=dev)
            m[torch.as_tensor(np.asarray(idx, dtype=np.int64),
                              device=dev)] = True
            return m

        keep = ~mask(rows, self.sparsity.nrows)[t["rows"]]
        if len(cols):
            keep &= ~mask(cols, self.sparsity.ncols)[t["cols"]]
        data = torch.where(keep, self.data, torch.zeros_like(self.data))
        if unit_diagonal and len(rows):
            dpos = t["diag"][torch.as_tensor(np.asarray(rows,
                                                        dtype=np.int64),
                                             device=dev)]
            data[dpos[dpos >= 0]] = 1.0
        return Matrix(self.sparsity, data, self.row_space, self.col_space,
                      self.bcs)

    def __repr__(self):
        return f"Matrix({self.shape}, nnz={self.sparsity.nnz})"
