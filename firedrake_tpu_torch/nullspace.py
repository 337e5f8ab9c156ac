"""Nullspace bases (reference: firedrake/nullspace.py:17 VectorSpaceBasis,
the PETSc MatNullSpace role).  A basis is a device matrix of orthonormal
columns, made once per length by a host QR (numpy, as in the JAX
package); the Krylov solve projects it out of the operator's range and of
the right-hand side."""
from __future__ import annotations

import numpy as np
import torch

from .device import as_tensor, to_numpy


class VectorSpaceBasis:
    def __init__(self, vecs=None, constant=False, comm=None):
        self._vecs = list(vecs or [])
        self._constant = constant
        self._Q = None
        self._n = None

    def _materialize(self, n):
        if self._Q is not None and self._n == n:
            return self._Q
        cols = []
        if self._constant:
            cols.append(np.ones(n))
        for v in self._vecs:
            arr = to_numpy(getattr(v, "dat", v)).reshape(-1)
            if arr.size != n:
                raise ValueError(f"basis vector of length {arr.size} for "
                                 f"an operator of size {n}")
            cols.append(arr)
        M = np.stack(cols, axis=1) if cols else np.zeros((n, 0))
        Q, _ = np.linalg.qr(M)
        self._Q = as_tensor(Q)
        self._n = n
        return self._Q

    def orthogonalize(self, b):
        """b with its component in the basis removed."""
        Q = self._materialize(b.shape[0]).to(b.device)
        return b - Q @ (Q.T @ b)

    project_out = orthogonalize

    def is_trivial(self):
        return not (self._constant or self._vecs)


class MixedVectorSpaceBasis:
    """Per-field bases over a mixed space (reference: nullspace.py:206)."""

    def __init__(self, W, bases):
        self.W = W
        self.bases = bases

    def orthogonalize(self, b):
        """b with each field's segment orthogonalized against its basis
        (None entries are full spaces)."""
        outs = []
        for i, V in enumerate(self.W.subspaces):
            off = int(self.W.offsets[i])
            seg = b[off:off + V.dim]
            basis = self.bases[i]
            if isinstance(basis, VectorSpaceBasis):
                seg = basis.orthogonalize(seg)
            outs.append(seg)
        return torch.cat(outs)

    project_out = orthogonalize

    def is_trivial(self):
        return not any(isinstance(b, VectorSpaceBasis) and not
                       b.is_trivial() for b in self.bases)
