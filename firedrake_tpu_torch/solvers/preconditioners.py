"""Preconditioner construction (reference: firedrake/preconditioners/ zoo).
The PC protocol is a callable z = pc(r) on tensors.  Here: the flat
make_pc dispatch, and the additive patch smoothers (vertex stars, Vanka
patches of a mixed operator) whose patch solves go through K2
(ops/batched_inverse.py)."""
from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor


def identity_pc(r):
    return r


def make_pc(pc_type: str, A=None, params=None):
    """A is an assembled matrix (or None for matrix-free with no PC).

    Flat dispatch onto composition.build_pc, which solving goes
    through."""
    from .composition import OpCtx, build_pc
    if pc_type == "jacobi" and A is None:
        raise ValueError("pc_type 'jacobi' needs an assembled "
                         "matrix (got matfree); use 'none'")
    return build_pc(OpCtx(mat=A), {"pc_type": pc_type or "none"})


def star_patches(V, exclude=None):
    """Vertex stars of V as padded dof lists: (idx, mask), both
    (npatch, K) numpy arrays.  Patch p is the p-th mesh vertex that has
    cells; its row holds the sorted dofs of every cell around it, padded
    with dof 0 at mask 0 to the largest patch size K.  The same lists, in
    the same order, as the JAX package's per-cell loop
    (firedrake_tpu/solvers/preconditioners.py:94-99), vectorised: the
    (vertex, dof) pairs of all cells are deduplicated and sorted by one
    np.unique over vertex * ndof + dof.  ``exclude``: dofs left out of
    every patch (the nonlinear patch smoother's Dirichlet dofs, as in
    firedrake_tpu/solving.py _patch_smooth); a star left empty is no
    patch."""
    cmap = V.cell_dof_map.astype(np.int64)             # (nc, nd)
    cv = V.mesh_obj.topology.cell_vertices.astype(np.int64)
    ndof = int(cmap.max()) + 1
    keys = np.unique((cv[:, :, None] * ndof + cmap[:, None, :]).ravel())
    vert, dof = np.divmod(keys, ndof)
    if exclude is not None and len(exclude):
        keep = ~np.isin(dof, exclude)
        vert, dof = vert[keep], dof[keep]
    counts = np.bincount(vert)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    patch_of = np.cumsum(counts > 0) - 1               # vertex -> patch
    npatch, K = int(patch_of[-1]) + 1, int(counts.max())
    rows, pos = patch_of[vert], np.arange(len(vert)) - starts[vert]
    idx = np.zeros((npatch, K), dtype=np.int64)
    mask = np.zeros((npatch, K))
    idx[rows, pos] = dof
    mask[rows, pos] = 1.0
    return idx, mask


def make_star_patch(A, V, multiplicative=False):
    """Vertex-star additive Schwarz smoother (reference:
    firedrake/preconditioners/asm.py ASMStarPC / PatchPC with
    construct_dim=0): one patch per mesh vertex containing every dof on
    entities whose closure includes the vertex.  The multiplicative
    smoother is not ported: the JAX package takes the flag and returns
    the additive one, and here it raises."""
    if multiplicative:
        raise NotImplementedError(
            "multiplicative star patches are not ported (the JAX package "
            "ignores the flag and smooths additively): ROADMAP.md queue 1, "
            "item 16")
    idx, mask = star_patches(V)
    return _batched_patch_pc(A, idx, mask)


def vanka_patches(A, W, seed_field):
    """Vanka patches of a mixed operator as padded dof lists (idx, mask),
    the JAX package's lists (firedrake_tpu/solvers/preconditioners.py
    make_vanka_patch) in its order: patch p is seed dof s = offset + p of
    field ``seed_field`` with every dof of the other fields in row s or
    column s of A's CSR pattern (explicit zeros included), sorted; one
    np.unique over s * n + dof instead of a set per seed."""
    Asp = A.to_scipy().tocsr()
    n = Asp.shape[0]
    off = int(W.offsets[seed_field])
    dim = W.subspaces[seed_field].dim
    seeds = np.arange(off, off + dim, dtype=np.int64)
    rows = [Asp[off:off + dim].tocoo(), Asp[:, off:off + dim].T.tocoo()]
    s_all = np.concatenate([seeds] + [m.row.astype(np.int64) + off
                                      for m in rows])
    d_all = np.concatenate([seeds] + [m.col.astype(np.int64)
                                      for m in rows])
    # classic Vanka couples one seed dof with the other fields only
    keep = (d_all < off) | (d_all >= off + dim) | (d_all == s_all)
    keys = np.unique(s_all[keep] * n + d_all[keep])
    seed, dof = np.divmod(keys, n)
    counts = np.bincount(seed - off, minlength=dim)
    pos = np.arange(len(keys)) - (np.cumsum(counts) - counts)[seed - off]
    idx = np.zeros((dim, int(counts.max())), dtype=np.int64)
    mask = np.zeros(idx.shape)
    idx[seed - off, pos] = dof
    mask[seed - off, pos] = 1.0
    return idx, mask


def make_vanka_patch(A, W, exclude_field=None):
    """Vanka smoother for mixed (saddle-point) systems (reference:
    firedrake/preconditioners/asm.py ASMVankaPC): one patch per dof of
    the seed field (the last, e.g. pressure, or the one before it when
    ``exclude_field`` names the last) holding that dof and every dof of
    the other fields it couples to, additive over the patches
    (vanka_patches)."""
    from ..mixed import is_mixed
    if not is_mixed(W):
        raise ValueError("vanka needs a mixed function space")
    seed_field = W.num_sub_spaces - 1
    if exclude_field is not None and int(exclude_field) == seed_field:
        seed_field -= 1
    idx, mask = vanka_patches(A, W, seed_field)
    return _batched_patch_pc(A, idx, mask)


def patch_matrices(A, idx, mask):
    """The (npatch, K, K) patch matrices A[idx_p, idx_p] of padded patches
    (idx, mask as star_patches builds them), gathered from A on its
    device (A.entries), with identity rows and columns in the padding:
    the reference's Asp[np.ix_(p, p)] blocks, value for value."""
    idx_t, mask_t = as_tensor(idx), as_tensor(mask)
    npatch, K = idx.shape
    valid = (mask_t[:, :, None] * mask_t[:, None, :]) > 0
    vals = A.entries(idx_t[:, :, None].expand(npatch, K, K),
                     idx_t[:, None, :].expand(npatch, K, K))
    eye = torch.eye(K, dtype=vals.dtype, device=vals.device)
    return torch.where(valid, vals, eye)


def _batched_patch_pc(A, idx, mask):
    """Additive Schwarz over padded dof-index patches (idx, mask as
    star_patches and vanka_patches build them): the patch matrices are
    inverted once by K2 and applied as one batched product per call,
    the patches' corrections summed into each dof in a fixed order (the
    gather route's accumulation plan: patch order within each dof)."""
    from ..assemble import _accumulation_device
    from ..ops.batched_inverse import batched_inv
    Apinv = batched_inv(patch_matrices(A, idx, mask))
    if not bool(torch.isfinite(Apinv).all()):
        # K2 does not pivot: a zero leading pivot (a saddle-point patch
        # whose first dofs have a zero block) gives no inverse
        raise ArithmeticError(
            "patch PC: a patch matrix has no inverse without pivoting "
            f"({idx.shape[0]} patches of up to {idx.shape[1]} dofs)")
    idx_t, mask_t = as_tensor(idx), as_tensor(mask)
    n = A.shape[0]
    # padding slots land past the last dof, where the plan drops them
    acc = _accumulation_device(
        torch.where(mask_t > 0, idx_t, n).reshape(-1), n)

    def pc(r):
        # plain additive Schwarz: z = sum_p R_p^T A_p^-1 R_p r (SPD as a
        # sum of SPD terms for SPD A: safe under CG)
        rp = r[idx_t] * mask_t                        # (npatch, K)
        zp = torch.einsum("pij,pj->pi", Apinv, rp)
        return acc(zp.reshape(-1)).to(r.dtype)

    return pc
