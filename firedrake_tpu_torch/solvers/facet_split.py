"""FacetSplitPC: the interior/facet dof split (reference:
firedrake/preconditioners/facet_split.py:272 FacetSplitPC).

The port's copy of ``firedrake_tpu/solvers/facet_split.py``.  The
reference restricts the element into its interior and facet parts,
rebuilds the form on the mixed space and hands the permuted system to a
sub-PC under the ``facet_`` prefix: the route to statically condensed
solvers for high-degree CG.  Here the split is numbering arithmetic (the
cell-interior dofs are those of the top-dimensional entity class), the
permuted operator is cut into CSR blocks (assembly/matrix.py ``Matrix``)
on the device, and the whole ``facet_*`` options tree (fieldsplit, Schur,
any KSP nesting) builds on it through solvers/composition.py.
"""
from __future__ import annotations

import numpy as np

from .pcs import PCBase
from ..device import as_tensor

__all__ = ["FacetSplitPC", "interior_facet_split"]


class _ISSpace:
    """A function-space stand-in for one index-set block: what OpCtx and
    build_ksp read (``dim``, ``mesh_obj``)."""

    num_sub_spaces = 0

    def __init__(self, dim, mesh_obj=None):
        self.dim = dim
        self.mesh_obj = mesh_obj


class _SplitSpace:
    """A stand-in with the fields' blocks as subspaces, so the stock
    fieldsplit builder runs on the permuted operator."""

    def __init__(self, dims, mesh_obj=None):
        self.subspaces = [_ISSpace(d, mesh_obj) for d in dims]
        self.offsets = np.concatenate([[0], np.cumsum(dims)])[:-1]
        self.num_sub_spaces = len(dims)
        self.dim = int(sum(dims))
        self.mesh_obj = mesh_obj


class _PermMat:
    """The permuted operator as CSR blocks (``blocks[(i, j)]``, the
    nonempty ones) and the whole CSR matrix for its matvec."""

    def __init__(self, csr, dims):
        from ..assembly.matrix import Matrix
        self.shape = csr.shape
        self.blocks = {}
        offs = np.concatenate([[0], np.cumsum(dims)])
        for i in range(len(dims)):
            for j in range(len(dims)):
                sub = csr[offs[i]:offs[i + 1], offs[j]:offs[j + 1]]
                if sub.nnz:
                    self.blocks[(i, j)] = Matrix.from_scipy(sub)
        self._full = Matrix.from_scipy(csr)
        self._csr = csr

    def matvec(self, x):
        return self._full.matvec(x)

    __matmul__ = matvec

    def diagonal(self):
        return self._full.diagonal()

    def to_scipy(self):
        return self._csr

    def to_dense(self):
        return self._csr.toarray()


def interior_facet_split(V):
    """(interior dofs, facet dofs) of V in its current numbering: the
    interior ones are the dofs of the top-dimensional entity class (cell
    interiors), the facet ones everything else (vertices, edges,
    faces)."""
    sdata = V.sdata
    D = V.mesh_obj.topology.dim
    interior = [np.arange(off, off + sdata.mesh.topology
                          .entity_class_counts(d).get(a, 0)
                          * sdata.npe_class.get((d, a), 0), dtype=np.int64)
                for (d, a), off in sdata.offsets.items() if d == D]
    interior = (np.concatenate(interior) if interior
                else np.empty(0, dtype=np.int64))
    if sdata.node_perm is not None:
        interior = sdata.node_perm[interior]
    mask = np.zeros(sdata.num_nodes, dtype=bool)
    mask[interior] = True
    bs = V.block_size

    def expand(nodes):
        if bs == 1:
            return nodes
        return (nodes[:, None] * bs + np.arange(bs)[None, :]).reshape(-1)

    return expand(np.sort(interior)), expand(np.nonzero(~mask)[0])


class FacetSplitPC(PCBase):
    """Split into interior and facet dofs and solve the permuted system
    under ``facet_*`` options (default: fieldsplit).  Option
    ``facet_restriction_domain``: "interior,facet" (default),
    "facet,interior", or one domain (its block first, the other
    after)."""

    _prefix = "facet_"

    def initialize_ctx(self, ctx, params, prefix):
        from .composition import OpCtx, build_ksp, opt
        self.appctx = ctx.appctx
        V = ctx.space
        if ctx.mat is None or V is None:
            raise ValueError("FacetSplitPC needs an assembled matrix and "
                             "the problem's function space")
        if getattr(V, "num_sub_spaces", 1) > 1:
            raise ValueError("decomposition of mixed spaces is not "
                             "supported (reference facet_split.py:60)")
        interior, facet = interior_facet_split(V)
        if interior.size == 0:
            raise ValueError(
                f"{V.name} has no interior dofs to split off "
                "(degree too low for an interior/facet decomposition)")
        domains = [s.strip() for s in str(opt(
            params, prefix, self._prefix + "restriction_domain",
            "interior,facet")).split(",") if s.strip()]
        groups = {"interior": interior, "facet": facet}
        try:
            parts = [groups.pop(dom) for dom in domains]
        except KeyError as e:
            raise ValueError(f"unknown restriction domain {e}") from e
        parts += list(groups.values())            # unselected dofs last
        perm = np.concatenate(parts)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size)
        self._perm, self._inv = as_tensor(perm), as_tensor(inv)

        csr = ctx.mat.to_scipy().tocsr()[perm][:, perm].tocsr()
        dims = [p.size for p in parts if p.size]
        A = _PermMat(csr, dims)
        ictx = OpCtx(mat=A, space=_SplitSpace(dims, V.mesh_obj), form=None,
                     bcs=(), appctx=ctx.appctx)
        p = dict(params)
        sub = prefix + self._prefix
        p.setdefault(sub + "ksp_type", "preonly")
        p.setdefault(sub + "pc_type",
                     "fieldsplit" if len(dims) > 1 else "lu")
        self._solve = build_ksp(ictx, p, sub)

    def apply(self, r):
        return self._solve(r[self._perm])[self._inv]
