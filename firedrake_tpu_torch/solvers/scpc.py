"""SCPC: static condensation of cell-interior dofs (the port's copy of
``firedrake_tpu/solvers/scpc.py``).

Reference: firedrake/slate/static_condensation/scpc.py (SCPC.initialize
:31 builds the condensed interface operator via Slate, :160 local
back-substitution).

Interior dofs (entity_dofs[cell_dim]) never couple across cells, so the
global Schur complement is the ASSEMBLY of per-cell Schur complements —
batched dense algebra on the device, the inverse of A_II by K2:
    S_c = A_c[G, G] - A_c[G, I] A_c[I, I]^{-1} A_c[I, G]
    E_c = F_c[G]    - A_c[G, I] A_c[I, I]^{-1} F_c[I]
solve the (much smaller) interface system, then back-substitute
    u_I = A_c[I, I]^{-1} (F_c[I] - A_c[I, G] u_G)  per cell.
The condensed matrix and vector are summed through gather tables in a
fixed order (assemble.py ``_accumulation``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor


def solve_scpc(problem, params, appctx=None):
    """Solve problem.a == problem.L for problem.u by condensing the
    cell-interior dofs; returns (iterations, converged) of the condensed
    solve."""
    from ..slate import _local_form_tensor
    from ..solving import direct_solve, _bc_data

    p = problem
    V = p.u.function_space()
    elem = V.element
    ed = elem.entity_dofs
    mesh = V.mesh_obj
    cdim = mesh.cell.dim
    islots = np.asarray(sorted(ed[cdim][0]), dtype=np.int64) \
        if ed.get(cdim, {}).get(0) else np.zeros(0, dtype=np.int64)
    if len(islots) == 0:
        raise ValueError("SCPC: the element has no cell-interior dofs "
                         "to condense (use a direct/Krylov solver)")
    nd = elem.ndof
    gslots = np.asarray([k for k in range(nd) if k not in set(islots)],
                        dtype=np.int64)

    # interface numbering: compress the surviving global dofs
    cmap = V.cell_dof_map.astype(np.int64)
    interior_global = np.unique(cmap[:, islots].reshape(-1))
    keep = np.ones(V.dim, dtype=bool)
    keep[interior_global] = False
    cond_id = np.cumsum(keep) - 1          # global -> condensed index
    ncond = int(keep.sum())
    gmap = cond_id[cmap[:, gslots]]        # (nc, nG) condensed ids

    # batched local tensors (signs already canonical)
    A_loc = _local_form_tensor(p.a).cell                  # (nc, nd, nd)
    F_loc = (_local_form_tensor(p.L).cell if p.L is not None
             else A_loc.new_zeros(A_loc.shape[:2]))        # (nc, nd)

    def dev_idx(a):
        return torch.as_tensor(a, dtype=torch.int64, device=A_loc.device)

    it, gt = dev_idx(islots), dev_idx(gslots)
    AIIinv, AIG, S_loc, E_loc = _condense(A_loc, F_loc, it, gt)
    S, rhs = _assemble_condensed(gmap, ncond, S_loc, E_loc)

    # Dirichlet bcs live on interface dofs (boundary nodes are never
    # interior): symmetric elimination with lifting (keeps the condensed
    # system SPD for inner CG)
    if p.bcs:
        idx, g = _bc_data(p.bcs, V.dim)
        idx = np.asarray(idx, dtype=np.int64)
        rows = cond_id[idx]
        rows_t = dev_idx(rows)
        vals = as_tensor(g[idx])
        gfull = rhs.new_zeros(ncond)
        gfull[rows_t] = vals
        rhs = rhs - S.matvec(gfull)
        rhs[rows_t] = vals
        S = S.with_dirichlet(rows, symmetric=True)

    # condensed-system options under the condensed_field_ prefix
    # (nested solver_parameters are flattened in solving.py; nested
    # access kept for direct callers)
    pre = "condensed_field_"
    sub = {(pre + k): v
           for k, v in dict(params.get("condensed_field", {})).items()}
    sub.update({k: v for k, v in params.items() if k.startswith(pre)})
    ksp = sub.get(pre + "ksp_type", "preonly")
    if ksp == "preonly" and sub.get(pre + "pc_type", "lu") in (
            "lu", "cholesky"):
        uG = direct_solve(S, rhs)
        its, converged = 1, True
    else:
        # full recursive composition on the condensed operator
        from .composition import OpCtx, build_ksp
        sub.setdefault(pre + "ksp_rtol", 1e-7)
        sub.setdefault(pre + "ksp_max_it", 10000)
        ictx = OpCtx(mat=S, space=None, form=None, bcs=(),
                     appctx=appctx or {})
        tsolve = build_ksp(ictx, sub, pre)
        if ksp == "preonly":
            uG, its, converged = tsolve(rhs), 1, True
        else:
            res = tsolve._full(rhs, x0=rhs.new_zeros(ncond))
            uG, its = res.x, int(res.iterations)
            converged = bool(res.converged)

    p.u.dat = _back_substitute(uG, AIIinv, AIG, F_loc[:, it],
                               dev_idx(gmap), dev_idx(np.nonzero(keep)[0]),
                               dev_idx(cmap[:, islots].reshape(-1)), V.dim)
    return its, converged


def _condense(A_loc, F_loc, it, gt):
    """Per-cell Schur complements onto the interface slots ``gt``: the
    interior blocks A_II inverted by K2, then (A_II^-1, A_IG, S_loc,
    E_loc)."""
    from ..ops.batched_inverse import batched_inv
    AII = A_loc[:, it[:, None], it[None, :]]
    AIG = A_loc[:, it[:, None], gt[None, :]]
    AGI = A_loc[:, gt[:, None], it[None, :]]
    AGG = A_loc[:, gt[:, None], gt[None, :]]
    AIIinv = batched_inv(AII)
    GIi = torch.einsum("cij,cjk->cik", AGI, AIIinv)       # A_GI A_II^-1
    S_loc = AGG - torch.einsum("cij,cjk->cik", GIi, AIG)
    E_loc = F_loc[:, gt] - torch.einsum("cij,cj->ci", GIi, F_loc[:, it])
    return AIIinv, AIG, S_loc, E_loc


def _assemble_condensed(gmap, ncond, S_loc, E_loc):
    """The condensed CSR matrix and right-hand side over the interface
    numbering ``gmap`` (nc, nG), summed in a fixed order."""
    from ..assembly.sparsity import Sparsity
    from ..assembly.matrix import Matrix
    from ..assemble import _accumulation
    dev = S_loc.device
    sp = Sparsity(ncond, ncond, [(gmap, gmap)])
    order, sp.key_order = sp.key_order, None
    data = _accumulation(sp.block_positions[0], sp.nnz, dev,
                         order=order)(S_loc.reshape(-1))
    rhs = _accumulation(gmap.reshape(-1), ncond, dev)(E_loc.reshape(-1))
    return Matrix(sp, data, None, None), rhs


def _back_substitute(uG, AIIinv, AIG, FI_loc, gmap, keep, interior, n):
    """u_I = A_II^-1 (F_I - A_IG u_G) per cell, then the full dof vector:
    the interface values at ``keep``, the interior ones (cell-unique) at
    ``interior``, each a direct write."""
    uI_loc = torch.einsum(
        "cij,cj->ci", AIIinv,
        FI_loc - torch.einsum("cij,cj->ci", AIG, uG[gmap]))
    out = uG.new_zeros(n)
    out[keep] = uG
    out[interior] = uI_loc.reshape(-1)
    return out
