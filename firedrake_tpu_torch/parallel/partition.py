"""Cell orders for partitions (the port's copy of
``firedrake_tpu/parallel/partition.py``: ``sfc_cell_order``).

Cells are ordered by a Morton space-filling curve on their centroids, so
that equal-count contiguous chunks of the order are spatially coherent
(the SFC analogue of graph partitioning without METIS).  Host numpy, as in
the JAX package, and equal to its order bit for bit.
"""
from __future__ import annotations

import numpy as np

from ..device import to_numpy

__all__ = ["sfc_cell_order"]


def sfc_cell_order(mesh):
    """Morton (Z-curve) order of cells by centroid — vectorized."""
    coords = to_numpy(mesh.coordinates.dat).reshape(
        -1, mesh.geometric_dimension)
    # P1 coords: vertex dofs coincide with vertices; for higher-order
    # coordinate fields fall back to vertex positions
    verts = coords[:mesh.topology.num_vertices] \
        if coords.shape[0] >= mesh.topology.num_vertices else coords
    cent = verts[mesh.topology.cell_vertices].mean(axis=1)   # (nc, g)
    g = cent.shape[1]
    lo, hi = cent.min(axis=0), cent.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    bits = 16 if g <= 2 else 10
    q = np.minimum(((cent - lo) / span * ((1 << bits) - 1)).astype(
        np.uint64), (1 << bits) - 1)
    key = np.zeros(len(cent), dtype=np.uint64)
    for b in range(bits):
        for d in range(g):
            key |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) << \
                np.uint64(b * g + d)
    return np.argsort(key, kind="stable")
