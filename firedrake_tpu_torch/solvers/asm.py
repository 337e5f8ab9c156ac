"""Column and line additive Schwarz smoothers.

The port's copy of ``firedrake_tpu/solvers/asm.py`` (reference surface:
firedrake/preconditioners/asm.py ASMLinesmoothPC :255 and
ASMExtrudedStarPC :381): one patch per vertical column over a base-mesh
entity, per base-vertex star swept through the column, or per grid line
of a structured mesh.  Every patch list is numbering arithmetic over
numpy arrays: with the column renumbering (functionspace.py
``_maybe_column_renumber``) a node id is ``base_node * Hd + z``, so a
column over a base entity is a contiguous z-run of each of its base
nodes.  The patches go to solvers/preconditioners.py
``_batched_patch_pc``: their matrices are gathered on the operator's
device and inverted by K2 (ops/batched_inverse.py), which takes patches
of up to 128 dofs on the card and raises above it.
"""
from __future__ import annotations

import numpy as np

from .pcs import PCBase

__all__ = ["ASMLinesmoothPC", "ASMExtrudedStarPC", "ASMGridLinePC",
           "entity_interior_nodes"]


def entity_interior_nodes(sdata, d):
    """The nodes interior to each dim-d mesh entity, in the space's
    current numbering (grid or column renumbering applied): (nodes,
    valid), (num_entities(d), P) arrays, entity g's nodes in row g
    (padded to the largest count P, valid 0 in the padding).  Offset
    arithmetic over the numbering dof(d, g, k) = offsets[(d, a)] + g *
    npe + k."""
    topo = sdata.mesh.topology
    cls_idx = topo.entity_class_index(d).astype(np.int64)
    arity = topo.entity_arity(d).astype(np.int64)
    npe = np.zeros(len(arity), dtype=np.int64)
    start = np.zeros(len(arity), dtype=np.int64)
    for a in np.unique(arity):
        sel = arity == a
        n = sdata.npe_class.get((d, int(a)), 0)
        if n:
            npe[sel] = n
            start[sel] = sdata.offsets[(d, int(a))] + cls_idx[sel] * n
    k = np.arange(int(npe.max()) if len(npe) else 0, dtype=np.int64)
    valid = k[None, :] < npe[:, None]
    nodes = np.where(valid, start[:, None] + k[None, :], 0)
    if sdata.node_perm is not None:
        nodes = np.where(valid, sdata.node_perm[nodes], 0)
    return nodes, valid


def _expand_block(idx, mask, bs):
    """Padded node patches -> padded dof patches of a block size bs."""
    if bs == 1:
        return idx, mask
    dofs = idx[:, :, None] * bs + np.arange(bs)[None, None, :]
    return (dofs.reshape(len(idx), -1),
            np.repeat(mask, bs, axis=1).reshape(len(idx), -1))


def _pad(parts):
    """Concatenate (idx, mask) patch sets of different widths."""
    K = max(i.shape[1] for i, _ in parts)
    idx = np.concatenate([np.pad(i, ((0, 0), (0, K - i.shape[1])))
                          for i, _ in parts])
    mask = np.concatenate([np.pad(m, ((0, 0), (0, K - m.shape[1])))
                           for _, m in parts])
    return idx, mask


def _columns(nodes_b, valid, Hd):
    """Base-node patches -> their full columns, each base node's z-run in
    turn: (idx, mask) of width P * Hd."""
    z = np.arange(Hd, dtype=np.int64)
    idx = (nodes_b[:, :, None] * Hd + z).reshape(len(nodes_b), -1)
    mask = np.repeat(valid, Hd, axis=1).reshape(len(nodes_b), -1)
    return idx, mask.astype(np.float64)


def _column_numbered(V):
    col = getattr(V.sdata, "column", None)
    if col is None or not getattr(V.sdata, "column_numbered", False):
        return None
    return col


def _column_patches(V, codims):
    """Patches of full vertical columns over the base-mesh entities of
    the given codimensions (reference ASMLinesmoothPC.get_patches), as
    padded (idx, mask).  Where those entities hold no dofs, codim 0 alone
    falls back to the cell columns, as in the JAX package."""
    mesh = V.mesh_obj
    if not getattr(mesh, "_extruded", False):
        raise ValueError("linesmooth needs an extruded mesh")
    col = _column_numbered(V)
    if col is not None:
        base_sdata = col.base_sdata
        Hd = col.kz * col.nlay + 1
        db = base_sdata.mesh.topology.dim
        parts = []
        for c in codims:
            d = db - c
            if d < 0 or d > db:
                raise ValueError(f"codim {c} out of range for base "
                                 f"dimension {db}")
            nodes, valid = entity_interior_nodes(base_sdata, d)
            keep = valid.any(axis=1)
            if keep.any():
                parts.append(_expand_block(
                    *_columns(nodes[keep], valid[keep], Hd),
                    V.block_size))
        if parts:
            return _pad(parts)
    # without column metadata (DG, non-Lagrange spaces): the codim-0
    # cell-column closure, every dof of the nlay cells stacked over one
    # base cell (cells are numbered base-major: c = b * nlay + l)
    if set(codims) - {0}:
        raise NotImplementedError(
            "linesmooth codims other than 0 need a column-numbered "
            "scalar Lagrange space; this space has no column metadata")
    nlay = int(mesh._layers)
    cmap = V.cell_dof_map.astype(np.int64)
    if cmap.shape[0] % nlay:
        raise ValueError("the cells are not whole columns of nlay layers")
    nbase = cmap.shape[0] // nlay
    ndof = int(cmap.max()) + 1
    base = np.repeat(np.arange(nbase), nlay * cmap.shape[1])
    keys = np.unique(base * ndof + cmap.reshape(-1))
    b, dof = np.divmod(keys, ndof)
    counts = np.bincount(b, minlength=nbase)
    pos = np.arange(len(keys)) - (np.cumsum(counts) - counts)[b]
    idx = np.zeros((nbase, int(counts.max())), dtype=np.int64)
    mask = np.zeros(idx.shape)
    idx[b, pos] = dof
    mask[b, pos] = 1.0
    return idx, mask


def _patch_pc(ctx, name, idx, mask):
    from .preconditioners import _batched_patch_pc
    if ctx.mat is None:
        raise ValueError(f"{name} needs an assembled matrix and the "
                         "problem's function space")
    return _batched_patch_pc(ctx.mat, idx, mask)


class ASMLinesmoothPC(PCBase):
    """Line smoother for extruded meshes: one additive Schwarz patch per
    vertical column over a base-mesh entity (reference asm.py:255).
    ``<prefix>pc_linesmooth_codims`` selects the base entities'
    codimensions (default "0,1", as the reference)."""

    _prefix = "pc_linesmooth_"

    def initialize_ctx(self, ctx, params, prefix):
        from .composition import opt
        self.appctx = ctx.appctx
        if ctx.space is None:
            raise ValueError("ASMLinesmoothPC needs an assembled matrix "
                             "and the problem's function space")
        codims = [int(s) for s in str(opt(
            params, prefix, self._prefix + "codims", "0,1")).split(",")
            if s.strip() != ""]
        self._pc = _patch_pc(ctx, "ASMLinesmoothPC",
                             *_column_patches(ctx.space, codims))

    def apply(self, r):
        return self._pc(r)


def extruded_star_patches(V):
    """Base-vertex stars swept through the column: patch v holds every
    node interior to a base entity whose closure contains base vertex v,
    sorted, each over the full column height (reference asm.py:381), as
    padded (idx, mask); one patch per vertex that has nodes."""
    col = _column_numbered(V)
    if col is None:
        raise NotImplementedError(
            "ASMExtrudedStarPC needs a column-numbered scalar Lagrange "
            "space (extruded mesh)")
    base_sdata = col.base_sdata
    topo = base_sdata.mesh.topology
    nnode = base_sdata.num_nodes
    verts, nds = [], []
    for d in range(topo.dim + 1):
        nodes, valid = entity_interior_nodes(base_sdata, d)
        if not valid.any():
            continue
        ev = np.asarray(topo.entity_vertices(d), dtype=np.int64)
        # (entity, vertex, node) triples: vertex v of entity g owns its
        # interior nodes
        ok = (ev[:, :, None] >= 0) & valid[:, None, :]
        v3 = np.broadcast_to(ev[:, :, None], ok.shape)
        n3 = np.broadcast_to(nodes[:, None, :], ok.shape)
        verts.append(v3[ok])
        nds.append(n3[ok])
    keys = np.unique(np.concatenate(verts) * nnode + np.concatenate(nds))
    vert, node = np.divmod(keys, nnode)
    counts = np.bincount(vert)
    starts = np.cumsum(counts) - counts
    patch_of = np.cumsum(counts > 0) - 1
    nodes_b = np.zeros((int(patch_of[-1]) + 1, int(counts.max())),
                       dtype=np.int64)
    valid = np.zeros(nodes_b.shape, dtype=bool)
    pos = np.arange(len(keys)) - starts[vert]
    nodes_b[patch_of[vert], pos] = node
    valid[patch_of[vert], pos] = True
    return _expand_block(*_columns(nodes_b, valid, col.kz * col.nlay + 1),
                         V.block_size)


class ASMExtrudedStarPC(PCBase):
    """Vertex-star patches swept through the vertical column (reference
    asm.py:381): one patch per base-mesh vertex, with every dof interior
    to a base entity incident to that vertex, over the full column
    height."""

    _prefix = "pc_star_"

    def initialize_ctx(self, ctx, params, prefix):
        self.appctx = ctx.appctx
        if ctx.space is None:
            raise ValueError("ASMExtrudedStarPC needs an assembled "
                             "matrix and the problem's function space")
        self._pc = _patch_pc(ctx, "ASMExtrudedStarPC",
                             *extruded_star_patches(ctx.space))

    def apply(self, r):
        return self._pc(r)


def grid_line_patches(V, axes=None):
    """One patch per grid line of a grid-numbered Lagrange space on a
    structured mesh, along each of ``axes`` (default every axis) in turn,
    as padded (idx, mask)."""
    from ..assembly.stencil import _space_grid
    s = getattr(V.mesh_obj, "_structured", None)
    sg = _space_grid(V, s) if s is not None else None
    if sg is None:
        raise NotImplementedError(
            "ASMGridLinePC needs a grid-numbered Lagrange space on a "
            "structured mesh")
    gdims = np.asarray(sg.gdims, dtype=np.int64)
    D = len(gdims)
    strides = np.cumprod(np.concatenate([[1], gdims[:-1]]))
    parts = []
    for ax in (range(D) if axes is None else axes):
        if not 0 <= ax < D:
            raise ValueError(f"grid axis {ax} out of range")
        base = np.zeros(1, dtype=np.int64)
        for a in range(D):
            if a != ax:
                base = (base[:, None]
                        + np.arange(gdims[a]) * strides[a]).reshape(-1)
        pat = base[:, None] + np.arange(gdims[ax]) * strides[ax]
        parts.append(_expand_block(pat, np.ones(pat.shape), V.block_size))
    return _pad(parts)


class ASMGridLinePC(PCBase):
    """Line smoother on structured grids: one additive Schwarz patch per
    grid line along each requested axis (reference asm.py:255 role).
    ``<prefix>pc_gridline_axes`` selects the axes, e.g. "2" or "0,1,2"
    (default every axis)."""

    _prefix = "pc_gridline_"

    def initialize_ctx(self, ctx, params, prefix):
        from .composition import opt
        self.appctx = ctx.appctx
        if ctx.space is None:
            raise ValueError("ASMGridLinePC needs an assembled matrix and "
                             "the problem's function space")
        axes = opt(params, prefix, self._prefix + "axes", None)
        if axes is not None:
            axes = [int(a) for a in str(axes).split(",") if a.strip()]
        self._pc = _patch_pc(ctx, "ASMGridLinePC",
                             *grid_line_patches(ctx.space, axes))

    def apply(self, r):
        return self._pc(r)
