"""Nullspace bases (reference: firedrake/nullspace.py:17 VectorSpaceBasis,
the PETSc MatNullSpace role).  A basis is a device matrix of orthonormal
columns, made once per length by a host QR (numpy, as in the JAX
package); the Krylov solve projects it out of the operator's range and of
the right-hand side."""
from __future__ import annotations

import numpy as np

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
        raise NotImplementedError(
            "MixedVectorSpaceBasis needs mixed spaces, which are not "
            "ported yet: ROADMAP.md queue 1, item 14")
