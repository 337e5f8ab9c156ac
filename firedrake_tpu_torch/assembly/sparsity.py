"""Sparsity construction: sorted COO -> CSR with precomputed scatter
positions (the port's copy of ``firedrake_tpu/assembly/sparsity.py``;
reference role: pyop2/sparsity.pyx:105 build_sparsity).

Every (row, col) pair each kernel block writes is enumerated, unique-
sorted once on the host (``native.coo_sort_unique``), and each block
keeps the flat position array mapping its local-tensor entries to nnz
slots.  Host numpy only, bit-equal to the JAX package.  Also the ELL
(padded row) layout of the matvec and the diagonal's positions.
"""
from __future__ import annotations

from functools import cached_property

import numpy as np

from ..native import coo_sort_unique

_IDX = np.int32


class Sparsity:
    """CSR structure + per-block scatter positions.

    blocks: list of (row_map (ne, nr), col_map (ne, nc)) index arrays.
    ``key_order``: the in-range entries of the blocks, concatenated, in
    the stable order of their keys, so sorted by position (int64); the
    assembler builds its accumulation from it, then drops it.
    """

    def __init__(self, nrows: int, ncols: int, blocks):
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        keys_per_block = []
        for rm, cm in blocks:
            rm = np.asarray(rm, dtype=np.int64)
            cm = np.asarray(cm, dtype=np.int64)
            k = (rm[:, :, None] * self.ncols + cm[:, None, :]).ravel()
            # out-of-range dofs (RestrictedFunctionSpace sentinels) get
            # the sentinel position == nnz: their contributions vanish
            bad = ((rm[:, :, None] >= self.nrows)
                   | (cm[:, None, :] >= self.ncols)).ravel()
            k[bad] = -1
            keys_per_block.append(k)
        all_keys = np.concatenate(keys_per_block) if keys_per_block else \
            np.zeros(0, dtype=np.int64)
        uniq, inv, order = coo_sort_unique(all_keys)
        self.key_order = order[np.count_nonzero(all_keys < 0):]
        self.nnz = len(uniq)
        self.coo_rows = (uniq // self.ncols).astype(_IDX)
        self.coo_cols = (uniq % self.ncols).astype(_IDX)
        self.indptr = np.zeros(self.nrows + 1, dtype=np.int64)
        np.add.at(self.indptr, self.coo_rows + 1, 1)
        self.indptr = np.cumsum(self.indptr)
        # per-block scatter positions
        self.block_positions = []
        off = 0
        for k in keys_per_block:
            self.block_positions.append(inv[off:off + len(k)].astype(_IDX))
            off += len(k)

    # --------------------------------------------------------- ELL layout
    @cached_property
    def row_lengths(self):
        return np.diff(self.indptr)

    @cached_property
    def kmax(self):
        return int(self.row_lengths.max()) if self.nnz else 1

    @cached_property
    def ell(self):
        """(ell_cols (nrows, kmax) padded with col 0,
            ell_pos (nnz,): position of csr entry i in the flat ELL array,
            ell_mask (nrows, kmax) bool valid)."""
        kmax = self.kmax
        within = np.arange(self.nnz) - self.indptr[self.coo_rows]
        ell_pos = self.coo_rows.astype(np.int64) * kmax + within
        ell_cols = np.zeros((self.nrows, kmax), dtype=_IDX)
        ell_cols.reshape(-1)[ell_pos] = self.coo_cols
        mask = np.zeros((self.nrows, kmax), dtype=bool)
        mask.reshape(-1)[ell_pos] = True
        return ell_cols, ell_pos.astype(_IDX), mask

    @cached_property
    def diag_positions(self):
        """Position in nnz of each diagonal entry (-1 if absent)."""
        n = min(self.nrows, self.ncols)
        pos = np.full(n, -1, dtype=np.int64)
        keys = self.coo_rows.astype(np.int64) * self.ncols + self.coo_cols
        want = np.arange(n, dtype=np.int64) * self.ncols + np.arange(n)
        idx = np.searchsorted(keys, want)
        idx_cl = np.clip(idx, 0, self.nnz - 1)
        hit = keys[idx_cl] == want
        pos[hit] = idx[hit]
        return pos
