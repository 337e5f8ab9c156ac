"""Host-side mesh topology & geometry.

Replaces the reference's PETSc DMPlex + firedrake/cython/dmcommon.pyx layer
(reference: firedrake/mesh.py:502 AbstractMeshTopology; dmcommon.pyx entity
numbering/orientations :593-:1280).  Everything here is setup-time numpy; the
products are flat int32 index arrays that feed the device executor — exactly
the representation the TPU wants (static shapes, gather/scatter indices).

Key derived data (all cached):
  * per-dimension entity tables (canonical = sorted global vertex tuple),
  * cell -> entity index + orientation maps (orientation = permutation index
    aligning the cell's local view with the canonical entity order; consumed
    by FiniteElement.entity_permutation, mirroring dmcommon's
    entity_orientations :1193),
  * facet <-> cell adjacency with local facet numbers (for ds/dS integrals),
  * boundary facet markers (Firedrake's utility-mesh id conventions).
"""
from __future__ import annotations

import itertools
import numpy as np
from functools import cached_property

from ..elements.reference_cell import ReferenceCell, by_name

_IDX = np.int32


def _unique_rows(flat, M):
    """np.unique(flat, axis=0, return_inverse=True) for (N, k) int64
    rows with entries in [0, M): rows are packed into one or two int64
    keys and deduplicated with scalar argsorts.  unique(axis=0)'s
    void-dtype row sort measured 24.6 s of a 47 s 2M-dof hierarchy
    build (PERF_NOTES round 5 — the 16M north-star setup was ~11 min
    of host time, most of it here); packed keys cut it to ordinary
    int64 sorts.  Returns (uniq_rows, inverse), uniq in lexicographic
    order exactly like np.unique."""
    n, k = flat.shape
    if n == 0:
        return flat.copy(), np.zeros(0, dtype=np.int64)
    # packed halves must fit int64 (M^ceil(k/2) < 2^62); entities have
    # k <= 4 vertices today, so this fallback guards only exotic cells
    # or absurd vertex counts
    if float(M) ** max(k - k // 2, min(k, 2)) > 2.0 ** 62:
        return np.unique(flat, axis=0, return_inverse=True)
    if k <= 2:
        key = flat[:, 0] * M + (flat[:, 1] if k == 2 else 0)
        order = np.argsort(key, kind="stable")
        ks = key[order]
        new = np.empty(n, dtype=bool)
        new[0] = True
        new[1:] = ks[1:] != ks[:-1]
    else:
        h = k // 2
        hi = flat[:, 0].copy()
        for j in range(1, h):
            hi = hi * M + flat[:, j]
        lo = flat[:, h].copy()
        for j in range(h + 1, k):
            lo = lo * M + flat[:, j]
        order = np.lexsort((lo, hi))
        his, los = hi[order], lo[order]
        new = np.empty(n, dtype=bool)
        new[0] = True
        new[1:] = (his[1:] != his[:-1]) | (los[1:] != los[:-1])
    idx = np.cumsum(new) - 1
    inv = np.empty(n, dtype=np.int64)
    inv[order] = idx
    return flat[order[new]], inv


def orientation_index(pos):
    """Index, in itertools.permutations order, of each row of ``pos``
    (n, nv), a permutation of range(nv)."""
    nv = pos.shape[1]
    weights = nv ** np.arange(nv)
    lookup = np.full(nv ** nv, -1, dtype=_IDX)
    for i, p in enumerate(itertools.permutations(range(nv))):
        lookup[np.dot(p, weights)] = i
    return lookup[pos @ weights]


class MeshTopology:
    def __init__(self, cell_vertices: np.ndarray, num_vertices: int,
                 cell_type: str, name: str = "mesh"):
        self.cell_vertices = np.asarray(cell_vertices, dtype=_IDX)
        self.num_vertices = int(num_vertices)
        self.cell = by_name(cell_type)
        self.cell_type = self.cell.name
        self.dim = self.cell.dim
        self.name = name

    @property
    def num_cells(self):
        return len(self.cell_vertices)

    # ----------------------------------------------------------- entities
    @cached_property
    def _entity_data(self):
        """For each dim d in (1 .. dim): dict with
        'entities' (n_ent, nvpe) canonical sorted vertex ids,
        'cell_entities' (ncell, n_local) entity indices,
        'cell_orientations' (ncell, n_local) permutation indices.
        Dimension ``dim`` (the cells themselves) is not tabulated: every
        query answers it from the cell list (a hex's 8! orientations
        would take minutes at a million cells).
        """
        out = {}
        cell = self.cell
        cv = self.cell_vertices
        # pad sentinel = num_vertices: sorts after every real id AND
        # keeps packed int64 keys small (int64max/2 would overflow the
        # row-key packing below)
        SENT = self.num_vertices
        for d in range(1, self.dim):
            local = cell.topology[d]                  # (n_local, nvpe)
            n_local, nvpe = local.shape
            # cell-local view; ragged rows are padded with -1 (prisms):
            # replace padded slots with the sorting sentinel
            safe = np.where(local < 0, 0, local)
            views = cv[:, safe].astype(np.int64)      # (ncell, n_local, nvpe)
            pad = (local < 0)[None, :, :]
            views = np.where(pad, SENT, views)
            canon = np.sort(views, axis=-1)
            flat = canon.reshape(-1, nvpe)
            uniq, inv = _unique_rows(flat, SENT + 1)
            cell_entities = inv.reshape(self.num_cells, n_local).astype(_IDX)
            # orientation: the index, in itertools.permutations order, of
            # sigma with canon[j] == view[sigma[j]] (unique: an entity's
            # vertex ids are distinct, and a ragged row has one pad)
            ori = orientation_index(np.argsort(views.reshape(-1, nvpe),
                                               axis=1))
            ent = uniq
            ent = np.where(ent >= SENT, -1, ent)
            # arity classes (prisms mix triangle and quad faces): each
            # entity gets a within-class index so numbering can use
            # different dofs-per-entity per class
            arity = (ent >= 0).sum(axis=1)
            classes = np.unique(arity)
            class_index = np.zeros(len(ent), dtype=np.int64)
            class_counts = {}
            for a in classes:
                sel = arity == a
                class_index[sel] = np.arange(sel.sum())
                class_counts[int(a)] = int(sel.sum())
            out[d] = dict(entities=ent.astype(np.int64),
                          cell_entities=cell_entities,
                          cell_orientations=ori.reshape(self.num_cells,
                                                        n_local),
                          arity=arity.astype(np.int64),
                          class_index=class_index,
                          class_counts=class_counts)
        return out

    def num_entities(self, d: int) -> int:
        if d == 0:
            return self.num_vertices
        if d == self.dim:
            return self.num_cells
        return len(self._entity_data[d]["entities"])

    def cell_entities(self, d: int) -> np.ndarray:
        if d == 0:
            return self.cell_vertices
        if d == self.dim:
            return np.arange(self.num_cells, dtype=_IDX)[:, None]
        return self._entity_data[d]["cell_entities"]

    def entity_vertices(self, d: int) -> np.ndarray:
        """(num_entities(d), nvpe) vertex ids per dim-d entity (-1 pads
        for mixed-arity cells)."""
        if d == 0:
            return np.arange(self.num_vertices, dtype=np.int64)[:, None]
        if d == self.dim:
            return self.cell_vertices.astype(np.int64)
        return self._entity_data[d]["entities"]

    def entity_class_counts(self, d: int) -> dict:
        """{arity: count} for dim-d entities (uniform cells: one class)."""
        if d == 0:
            return {1: self.num_vertices}
        if d == self.dim:
            return {self.cell.num_vertices: self.num_cells}
        return self._entity_data[d]["class_counts"]

    def entity_class_index(self, d: int) -> np.ndarray:
        if d == 0:
            return np.arange(self.num_vertices, dtype=np.int64)
        if d == self.dim:
            return np.arange(self.num_cells, dtype=np.int64)
        return self._entity_data[d]["class_index"]

    def entity_arity(self, d: int) -> np.ndarray:
        if d == 0:
            return np.ones(self.num_vertices, dtype=np.int64)
        if d == self.dim:
            return np.full(self.num_cells, self.cell.num_vertices,
                           dtype=np.int64)
        return self._entity_data[d]["arity"]

    def cell_entity_orientations(self, d: int) -> np.ndarray:
        if d == 0 or d == self.dim:
            shape = self.cell_entities(d).shape
            return np.zeros(shape, dtype=_IDX)
        return self._entity_data[d]["cell_orientations"]

    # -------------------------------------------------------------- facets
    @cached_property
    def _facet_data(self):
        """facet_cells (nf, 2) [-1 pad], facet_local (nf, 2),
        using the dim-1 entity numbering."""
        d = self.dim - 1
        if d == 0:
            # interval mesh: facets are vertices
            ce = self.cell_vertices        # (ncell, 2)
            nf = self.num_vertices
        else:
            ce = self._entity_data[d]["cell_entities"]
            nf = len(self._entity_data[d]["entities"])
        n_local = ce.shape[1]
        facet_cells = np.full((nf, 2), -1, dtype=_IDX)
        facet_local = np.full((nf, 2), -1, dtype=_IDX)
        counts = np.zeros(nf, dtype=_IDX)
        # vectorized two-pass fill
        cells_flat = np.repeat(np.arange(self.num_cells, dtype=_IDX), n_local)
        local_flat = np.tile(np.arange(n_local, dtype=_IDX), self.num_cells)
        f_flat = ce.reshape(-1)
        order = np.argsort(f_flat, kind="stable")
        f_sorted = f_flat[order]
        first = np.searchsorted(f_sorted, np.arange(nf))
        last = np.searchsorted(f_sorted, np.arange(nf), side="right")
        counts = (last - first).astype(_IDX)
        assert counts.max() <= 2
        sel0 = first[counts >= 1]
        facet_cells[counts >= 1, 0] = cells_flat[order[sel0]]
        facet_local[counts >= 1, 0] = local_flat[order[sel0]]
        sel1 = (first + 1)[counts == 2]
        facet_cells[counts == 2, 1] = cells_flat[order[sel1]]
        facet_local[counts == 2, 1] = local_flat[order[sel1]]
        return facet_cells, facet_local

    @cached_property
    def facet_cells(self):
        return self._facet_data[0]

    @cached_property
    def facet_local_id(self):
        return self._facet_data[1]

    @cached_property
    def exterior_facets(self) -> np.ndarray:
        return np.nonzero(self.facet_cells[:, 1] < 0)[0].astype(_IDX)

    @cached_property
    def interior_facets(self) -> np.ndarray:
        return np.nonzero(self.facet_cells[:, 1] >= 0)[0].astype(_IDX)

    @cached_property
    def facet_vertices(self) -> np.ndarray:
        d = self.dim - 1
        if d == 0:
            return np.arange(self.num_vertices, dtype=_IDX)[:, None]
        return self._entity_data[d]["entities"]
