"""Preconditioner construction (reference: firedrake/preconditioners/ zoo).
The PC protocol is a callable z = pc(r) on tensors.  Ported so far: none,
jacobi (through composition.build_pc) and the vertex-star patch smoother,
whose patch solves go through K2 (ops/batched_inverse.py)."""
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


def star_patches(V):
    """Vertex stars of V as padded dof lists: (idx, mask), both
    (npatch, K) numpy arrays.  Patch p is the p-th mesh vertex that has
    cells; its row holds the sorted dofs of every cell around it, padded
    with dof 0 at mask 0 to the largest patch size K.  The same lists, in
    the same order, as the JAX package's per-cell loop
    (firedrake_tpu/solvers/preconditioners.py:94-99), vectorised: the
    (vertex, dof) pairs of all cells are deduplicated and sorted by one
    np.unique over vertex * ndof + dof."""
    cmap = V.cell_dof_map.astype(np.int64)             # (nc, nd)
    cv = V.mesh_obj.topology.cell_vertices.astype(np.int64)
    ndof = int(cmap.max()) + 1
    keys = np.unique((cv[:, :, None] * ndof + cmap[:, None, :]).ravel())
    vert, dof = np.divmod(keys, ndof)
    counts = np.bincount(vert)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    patch_of = np.cumsum(counts > 0) - 1               # vertex -> patch
    npatch, K = int(patch_of[-1]) + 1, int(counts.max())
    rows, pos = patch_of[vert], np.arange(len(keys)) - starts[vert]
    idx = np.zeros((npatch, K), dtype=np.int64)
    mask = np.zeros((npatch, K))
    idx[rows, pos] = dof
    mask[rows, pos] = 1.0
    return idx, mask


def make_star_patch(A, V):
    """Vertex-star additive Schwarz smoother (reference:
    firedrake/preconditioners/asm.py ASMStarPC / PatchPC with
    construct_dim=0): one patch per mesh vertex containing every dof on
    entities whose closure includes the vertex."""
    idx, mask = star_patches(V)
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
    """Additive Schwarz over padded dof-index patches (idx, mask from
    star_patches): the patch matrices are inverted once by K2 and applied
    as one batched product per call."""
    from ..ops.batched_inverse import batched_inv
    Apinv = batched_inv(patch_matrices(A, idx, mask))
    idx_t, mask_t = as_tensor(idx), as_tensor(mask)
    flat = idx_t.reshape(-1)

    def pc(r):
        # plain additive Schwarz: z = sum_p R_p^T A_p^-1 R_p r (SPD as a
        # sum of SPD terms — safe under CG).  index_add_ of float64 on
        # CUDA sums shared dofs in no fixed order (atomics), so repeated
        # applications agree to rounding, not bit for bit.
        rp = r[idx_t] * mask_t                        # (npatch, K)
        zp = torch.einsum("pij,pj->pi", Apinv, rp) * mask_t
        return torch.zeros_like(r).index_add_(0, flat, zp.reshape(-1))

    return pc
