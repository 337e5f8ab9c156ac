"""Slate: element-local dense linear algebra on assembled tensors (the
port's copy of ``firedrake_tpu/slate.py``).

Reference: firedrake/slate/slate.py (Tensor :862, AssembledVector, Inverse
:1075, Transpose :1117, Solve :1311, Block :600) compiled by slac through
GEM/loopy with LAPACK callables (pyop2/codegen/c/inverse.c).

A Slate expression evaluates to a BATCH of per-cell dense tensors (ncell,
ni[, nj]) on the device.  Inverse and Solve are K2 (ops/batched_inverse.py:
the hand-written batched Gauss-Jordan on the card, its plain version on
the CPU); contractions are batched einsums; the final global assembly
scatters through the outer arguments' dof maps.

Facet integrals (hybridization's trace coupling) are localized ONE-SIDED:
a dS integrand written in the restriction-symmetric hybridizable style
(jump/avg of broken fluxes against single-valued trace functions) splits
into per-cell contributions where '+' means "this cell".  Each interior
facet is then visited from both adjacent cells and the transformed
integrand is evaluated with the cell's own outward normal.

Genuinely two-sided DG couplings (jump*jump cross terms) go through the
interior-facet kernel instead: each interior facet evaluates the
integrand once with BOTH cells' dofs, producing a (2ni, 2nj) block tensor
whose diagonal blocks accumulate into the per-cell dense tensors and whose
cross blocks ride along as explicit facet-pair couplings
(``_Local.cross``).  Cross couplings compose through every LINEAR Slate
operation (Add, Negative, Transpose, Block, global assembly); cell-local
algebra (Inverse, Solve, Mul contraction) on a cross-coupled tensor raises.

Mixed forms build BLOCKED local tensors: per-cell dof axes concatenate the
fields in the order of the mixed space ([flux | scalar | trace]);
``A.blocks[i, j]`` slices fields, enabling static condensation:

    S = A.blocks[2, 2] - A.blocks[2, :2] * A.blocks[:2, :2].inv \\
        * A.blocks[:2, 2]

K2 does not pivot: a broken mixed matrix [[M, -B^T], [-B, 0]] keeps its
pivots nonzero only because the flux block comes first.

Where the port departs from the JAX package, by design:

* cell integrals are evaluated cell-last, as the gather route does
  (compiler/cell_eval.py ``run_cell_kernel``: K1 for the forms of its
  family, the torch BatchedLowerer otherwise), where the JAX package vmaps
  a per-cell kernel; facet integrals run the per-facet kernels vmapped
  over the facets (compiler/kernels.py), as the gather route does;
* every sum runs in a fixed order: the facet contributions to a cell and
  the global scatter are gather tables (assemble.py ``_accumulation``),
  never an unordered scatter-add;
* the relative orientation of the two sides of an interior facet comes
  from the port's own interior-facet statics (assemble.py
  ``facet_pairs``).
"""
from __future__ import annotations

import numpy as np
import torch

from .language.measure import Form, Integral
from .language.core import (Argument, Coefficient, Restricted, Zero,
                            FacetNormal, Grad, Product, Division,
                            ScalarValue, Terminal)
from .language.tensor_algebra import Inner, Dot, Outer, Cross
from .language.calculus import reconstruct
from .function import Cofunction
from .device import as_tensor, get_device

__all__ = ["Tensor", "AssembledVector", "assemble_slate", "DiagonalTensor",
           "Reciprocal", "Factorization"]


class TensorBase:
    """Base of the Slate expression DAG."""

    def __mul__(self, other):
        return Mul(self, other)

    def __add__(self, other):
        return Add(self, other)

    def __sub__(self, other):
        return Add(self, Negative(other))

    def __neg__(self):
        return Negative(self)

    @property
    def T(self):
        return Transpose(self)

    @property
    def inv(self):
        return Inverse(self)

    def solve(self, b, decomposition=None):
        return Solve(self, b, decomposition=decomposition)

    @property
    def blocks(self):
        return _BlockIndexer(self)

    # rank: number of argument axes (2 matrix, 1 vector)
    rank = None


class Tensor(TensorBase):
    """Element-local tensor of a bilinear/linear form (possibly mixed).

    ``axes`` optionally pins each argument axis to a (possibly mixed)
    function space: a form referencing only SOME fields of a mixed space
    still produces the full blocked local tensor, with zero blocks for the
    absent couplings (needed by hybridization's trace operator K, whose
    trial argument touches only the flux field)."""

    def __init__(self, form: Form, axes=None):
        from .mixed import MixedFunctionSpace
        self.form = form
        self.arguments = form.arguments()
        numbers = sorted({a.number for a in self.arguments})
        self.rank = len(numbers)
        # per-axis field structure: list of part-arguments, sorted by part
        self.axis_parts = []
        for i, n in enumerate(numbers):
            space = axes[i] if axes is not None else None
            if space is None:
                # a form over a mixed space may touch only SOME fields;
                # the local tensor still carries the FULL block axis
                for a in self.arguments:
                    if a.number == n and a.part is not None:
                        space = a.space.parent
                        break
            if space is not None:
                if isinstance(space, MixedFunctionSpace):
                    parts = [Argument(space.sub(k), n, part=k)
                             for k in range(space.num_sub_spaces)]
                else:
                    parts = [Argument(space, n)]
            else:
                parts = sorted(
                    (a for a in self.arguments if a.number == n),
                    key=lambda a: -1 if a.part is None else a.part)
            self.axis_parts.append(parts)

    def __repr__(self):
        return f"Tensor(rank={self.rank})"


class AssembledVector(TensorBase):
    """Per-cell view of a global Function/Cofunction (rank 1)."""

    rank = 1

    def __init__(self, f):
        self.f = f
        self.space = f.function_space()


class Transpose(TensorBase):
    def __init__(self, a):
        self.a = a
        self.rank = a.rank


class Negative(TensorBase):
    def __init__(self, a):
        self.a = a
        self.rank = a.rank


class Inverse(TensorBase):
    rank = 2

    def __init__(self, a):
        assert a.rank == 2
        self.a = a


class Add(TensorBase):
    def __init__(self, a, b):
        assert a.rank == b.rank
        self.a, self.b = a, b
        self.rank = a.rank


class Mul(TensorBase):
    def __init__(self, a, b):
        self.a, self.b = a, b
        self.rank = a.rank + b.rank - 2


class Solve(TensorBase):
    def __init__(self, A, b, decomposition=None):
        if decomposition is not None and not isinstance(A, Factorization):
            A = Factorization(A, decomposition)
        assert A.rank == 2
        self.A, self.b = A, b
        self.rank = b.rank


class Factorization(TensorBase):
    """Cached decomposition of a rank-2 tensor (reference slate.py:766).

    Every decomposition evaluates through the same K2 ``batched_solve``,
    so this node is a semantic marker: Solve(Factorization(A), b) ==
    Solve(A, b), and user code written `A.solve(b, decomposition=...)`
    ports unchanged."""

    _DECOMPS = frozenset([
        "PartialPivLU", "FullPivLU", "HouseholderQR",
        "ColPivHouseholderQR", "FullPivHouseholderQR", "LLT", "LDLT",
        "CompleteOrthogonalDecomposition", "BDCSVD", "JacobiSVD"])

    rank = 2

    def __init__(self, a, decomposition=None):
        decomposition = decomposition or "PartialPivLU"
        if decomposition not in self._DECOMPS:
            raise ValueError(
                f"Decomposition {decomposition!r} not supported")
        assert a.rank == 2, "can only decompose matrices"
        self.a = a
        self.decomposition = decomposition


class DiagonalTensor(TensorBase):
    """Diagonal of a square rank-2 tensor, as a rank-2 tensor
    (reference slate.py:1377)."""

    rank = 2

    def __init__(self, a):
        assert a.rank == 2, "the tensor must be rank 2"
        self.a = a


class Reciprocal(TensorBase):
    """Elementwise reciprocal of a rank-1 tensor (reference
    slate.py:1044)."""

    rank = 1

    def __init__(self, a):
        assert a.rank == 1, "the tensor must be rank 1"
        self.a = a


class _BlockIndexer:
    def __init__(self, tensor):
        self.tensor = tensor

    def __getitem__(self, idx):
        return Block(self.tensor, idx)

    def __call__(self, *args, **kwargs):   # legacy .blocks() call form
        return self


class Block(TensorBase):
    """Field sub-block of a mixed tensor (reference slate.py:600 Block).

    Indices are FIELD indices (ints or slices), one per axis."""

    def __init__(self, a, indices):
        self.a = a
        self.indices = indices if isinstance(indices, tuple) else (indices,)
        assert len(self.indices) == a.rank
        self.rank = a.rank


# ------------------------------------------------- one-sided localization
def _is_single_valued(t):
    """Is this terminal single-valued on a facet (same seen from both
    cells)?  Trace elements by construction; continuous Lagrange values."""
    space = getattr(t, "space", None)
    elem = getattr(space, "element", None)
    if elem is None:
        return False
    from .elements.trace import HDivTrace
    if isinstance(elem, HDivTrace):
        return True
    scalar = getattr(elem, "sub", elem)        # Vector/Tensor wrapper
    fam = getattr(scalar, "family", "")
    return fam in ("Lagrange", "Q") and getattr(scalar, "degree", 0) >= 1


def _restriction_sides(e):
    """Bottom-up set of restriction sides attached to cell-based (NOT
    single-valued) quantities; None when a multiplicative node couples
    different sides (genuinely two-sided)."""
    if isinstance(e, Restricted):
        base = e.operands[0]
        cellbased = any(isinstance(t, (Argument, Coefficient))
                        and not _is_single_valued(t)
                        for t in base.traverse())
        return frozenset([e.side]) if cellbased else frozenset()
    subs = [_restriction_sides(o) for o in e.operands]
    if any(s is None for s in subs):
        return None
    if isinstance(e, (Product, Dot, Inner, Outer, Cross, Division)):
        nonempty = [s for s in subs if s]
        for i in range(len(nonempty)):
            for j in range(i + 1, len(nonempty)):
                if nonempty[i] != nonempty[j] or len(nonempty[i]) > 1:
                    return None
    out = frozenset()
    for s in subs:
        out |= s
    return out


def _is_two_sided(integrand):
    """True when the dS integrand couples '+' and '-' of cell-based
    quantities multiplicatively (cross-cell blocks exist)."""
    return _restriction_sides(integrand) is None


def _apply_side(e, side, under_grad=False):
    """Evaluate a restricted subtree one-sided: '+' == this cell."""
    if isinstance(e, FacetNormal):
        return e if side == "+" else Product(ScalarValue(-1.0), e)
    if isinstance(e, (Argument, Coefficient)):
        if side == "+" or (_is_single_valued(e) and not under_grad):
            return e
        return Zero(e.shape)
    if isinstance(e, Terminal):
        return e
    ug = under_grad or isinstance(e, Grad)
    ops = [_apply_side(o, side, ug) for o in e.operands]
    if all(a is b for a, b in zip(ops, e.operands)):
        return e
    return reconstruct(e, ops)


def _one_sided(e):
    """Strip restrictions for per-cell facet localization."""
    if isinstance(e, Restricted):
        return _apply_side(_one_sided_body(e.operands[0]), e.side)
    return _one_sided_body(e)


def _one_sided_body(e):
    if isinstance(e, Terminal):
        return e
    ops = [_one_sided(o) for o in e.operands]
    if all(a is b for a, b in zip(ops, e.operands)):
        return e
    return reconstruct(e, ops)


# ------------------------------------------------------- local evaluation
class _Local:
    """Per-cell dense local tensors plus optional cross-cell facet-pair
    couplings from genuinely two-sided dS integrals.

    cell:  (ncell, ni[, nj]) dense per-cell values.
    cross: tuple of (row_cells (nf,), col_cells (nf,), vals (nf, ni, nj))
           — the (+,-) / (-,+) blocks of interior-facet pair tensors,
           in the SAME (possibly blocked) local dof layout as `cell`.
    """

    __slots__ = ("cell", "cross")

    def __init__(self, cell, cross=()):
        self.cell = cell
        self.cross = tuple(cross)


def _no_cross(v, what):
    if v.cross:
        raise NotImplementedError(
            f"Slate {what} of a tensor with cross-cell (two-sided dS) "
            "couplings — cell-local algebra is not defined across cells. "
            "Condense on the cell-local part and keep jump-jump terms in "
            "a separate Tensor added AFTER the local algebra, or assemble "
            "the coupled operator globally with assemble(form).")
    return v.cell


def _idx(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64,
                           device=get_device())


def _cell_sum(nc, contribs):
    """Sum per-entity local tensors into their owning cells in a fixed
    order: contribs is a list of (owner cells (n,), values (n, ni, nj)),
    summed by the assembler's gather tables over whole blocks."""
    from .assemble import _accumulation
    owners = np.concatenate([o for o, _ in contribs]).astype(np.int64)
    vals = torch.cat([v for _, v in contribs])
    return _accumulation(owners, nc, vals.device)(vals)


def _local_form_tensor(form: Form):
    """Per-cell dense tensors of a NON-mixed form over ALL cells, as a
    ``_Local`` in canonical dof indexing: cell part (ncell, ni[, nj]) plus
    cross-cell facet-pair blocks for genuinely two-sided dS integrals.
    Cell integrals run cell-last (K1 or the BatchedLowerer); one-sided
    facet integrals run the exterior-facet kernel from each adjacent
    cell; two-sided dS integrals run the interior-facet kernel and split
    its (2ni, 2nj) block tensor into per-cell and cross contributions."""
    from .compiler.kernels import CompiledIntegral
    from .compiler.cell_eval import run_cell_kernel
    from .assemble import (_local_dofs, _coeff_local, _canonical,
                           _vmapped, _kernel_chunk, interior_facets,
                           facet_pairs, facet_classes, of_class)
    mesh = form.mesh()
    topo = mesh.topology
    nc = topo.num_cells
    args = form.arguments()
    test = next((a for a in args if a.number == 0), None)
    trial = next((a for a in args if a.number == 1), None)
    rank = len(args)
    ni = test.space.element.ndof if test is not None else 1
    nj = trial.space.element.ndof if trial is not None else 1
    coords = mesh.device_coordinates()
    cmap3 = mesh.coordinates.function_space().cell_dof_map.reshape(
        nc, -1, mesh.geometric_dimension)
    dats = {c.count: as_tensor(c.dat) for c in form.coefficients()}
    whole = None                     # cell integrals over every cell
    contribs = []                    # (owner cells, (n, ni, nj) values)
    cross = []

    def arg_maps(cells_list, cell_last):
        return [None if a is None else
                _local_dofs(a.space, cells_list, cell_last)
                for a in (test, trial)]

    def gathered(ci, cells, cell_last):
        out = []
        for c in ci.coefficients:
            m = c.space.cell_dof_map[cells]
            w = dats[c.count][_idx(m.T if cell_last else m)]
            out.append(_coeff_local(
                w, _local_dofs(c.space, [cells], cell_last), cell_last))
        return tuple(out)

    def consts_of(ci):
        return tuple(as_tensor(c.values()) for c in ci.constants)

    def run_cells(ci, cells):
        nonlocal whole
        ce = coords[_idx(cmap3[cells].transpose(1, 2, 0))]
        loc = run_cell_kernel(ci, ce, gathered(ci, cells, True),
                              consts_of(ci),
                              chunk=_kernel_chunk(ci, len(cells),
                                                  ce.element_size()))
        loc = _canonical(loc, *arg_maps([cells], True), True)
        loc = loc.permute(2, 0, 1)                      # (C, ni, nj)
        if len(cells) == nc and np.array_equal(cells, np.arange(nc)):
            whole = loc if whole is None else whole + loc
        else:
            contribs.append((cells, loc))

    def run_facets(ci, facets, sides):
        kern = ci.exterior_facet_kernel()
        consts = consts_of(ci)

        def fn(c, lf, *w):
            return kern(c, lf, w, consts)

        for side in sides:
            cells = topo.facet_cells[facets, side]
            ce = coords[_idx(cmap3[cells])]
            loc = _vmapped(fn, (ce, _idx(topo.facet_local_id[facets, side]))
                           + gathered(ci, cells, False),
                           _kernel_chunk(ci, len(facets), ce.element_size()))
            contribs.append((cells, _canonical(
                loc, *arg_maps([cells], False), False)))

    def run_two_sided(ci, facets):
        kern = ci.interior_facet_kernel()
        consts = consts_of(ci)
        nco = len(ci.coefficients)
        cp, cm, lfp, lfm, o_rel = facet_pairs(mesh, facets, ci.ftype)

        def fn(a, b, lp, lm, o, *w):
            return kern(a, b, lp, lm, o, w[:nco], w[nco:], consts)

        ce = coords[_idx(cmap3[cp])]
        loc = _vmapped(fn, (ce, coords[_idx(cmap3[cm])], _idx(lfp),
                            _idx(lfm), _idx(o_rel))
                       + gathered(ci, cp, False) + gathered(ci, cm, False),
                       _kernel_chunk(ci, len(facets), ce.element_size()))
        loc = _canonical(loc, *arg_maps([cp, cm], False), False)
        if rank == 2:
            contribs.append((cp, loc[:, :ni, :nj]))
            contribs.append((cm, loc[:, ni:, nj:]))
            cross.append((cp, cm, loc[:, :ni, nj:]))
            cross.append((cm, cp, loc[:, ni:, :nj]))
        elif rank == 1:
            contribs.append((cp, loc[:, :ni, :]))
            contribs.append((cm, loc[:, ni:, :]))
        else:
            contribs.append((cp, loc))

    def by_class(integral, facets, run, *sides):
        """``run`` per facet class (prisms: triangle and quad facets,
        each with its own rule), on that class's facets."""
        for ft in facet_classes(mesh):
            sub = of_class(mesh, facets, ft)
            if len(sub):
                run(CompiledIntegral(integral, test, trial, mesh, ftype=ft),
                    sub, *sides)

    for integral in form.integrals():
        itype = integral.integral_type
        if itype == "cell":
            cells = mesh.cell_subset(integral.subdomain_id)
            if len(cells):
                run_cells(CompiledIntegral(integral, test, trial, mesh),
                          cells)
        elif itype == "exterior_facet":
            facets = mesh.boundary_facets(integral.subdomain_id)
            if len(facets):
                one = Integral(_one_sided(integral.integrand),
                               "exterior_facet", integral.subdomain_id,
                               integral.metadata, integral.domain)
                by_class(one, facets, run_facets, (0,))
        elif itype == "interior_facet":
            facets = interior_facets(mesh, integral.subdomain_id)
            if not len(facets):
                continue
            if _is_two_sided(integral.integrand):
                by_class(integral, facets, run_two_sided)
            else:
                one = Integral(_one_sided(integral.integrand),
                               "exterior_facet", "everywhere",
                               integral.metadata, integral.domain)
                by_class(one, facets, run_facets, (0, 1))
        else:
            raise NotImplementedError(
                f"Slate local tensors over {itype!r} integrals")
    if contribs:
        part = _cell_sum(nc, contribs)
        whole = part if whole is None else whole + part
    if whole is None:
        whole = torch.zeros((nc, ni, nj), dtype=torch.float64,
                            device=get_device())
    if rank == 1:
        whole = whole[:, :, 0]
    elif rank == 0:
        whole = whole[:, 0, 0]
    return _Local(whole, cross)


def _axis_dims(parts):
    return [p.space.element.ndof for p in parts]


def _eval_local(expr, cache):
    """-> _Local of per-cell dense values (ncell, ...)."""
    # identity-checked strong-ref memo: bare id() keys can be recycled
    # by CPython onto later temporaries
    key = id(expr)
    hit = cache.get(key)
    if hit is not None and hit[0] is expr:
        return hit[1]
    v = _eval_local_impl(expr, cache)
    cache[key] = (expr, v)
    return v


def _eval_local_impl(expr, cache):
    if isinstance(expr, Tensor):
        if all(len(parts) == 1 for parts in expr.axis_parts):
            return _local_form_tensor(expr.form)
        # mixed: pack per-field blocks into one dense local tensor, in the
        # order of the axes' fields (the flux first: K2 does not pivot)
        from .mixed import extract_block
        dims = [_axis_dims(p) for p in expr.axis_parts]
        offs = [np.concatenate([[0], np.cumsum(d)]) for d in dims]
        nc = expr.form.mesh().topology.num_cells
        shape = (nc,) + tuple(int(o[-1]) for o in offs)
        out = torch.zeros(shape, dtype=torch.float64, device=get_device())
        cross = []
        if expr.rank == 2:
            for i, ti in enumerate(expr.axis_parts[0]):
                for j, tj in enumerate(expr.axis_parts[1]):
                    blk = extract_block(expr.form, ti.part, tj.part)
                    if not blk.integrals():
                        continue
                    loc = _local_form_tensor(blk)
                    rs = slice(int(offs[0][i]), int(offs[0][i + 1]))
                    cs = slice(int(offs[1][j]), int(offs[1][j + 1]))
                    out[:, rs, cs] = loc.cell
                    for (rc, cc, vals) in loc.cross:
                        # embed the sub-block at the blocked offsets
                        big = vals.new_zeros((vals.shape[0],) + shape[1:])
                        big[:, rs, cs] = vals
                        cross.append((rc, cc, big))
        else:
            for i, ti in enumerate(expr.axis_parts[0]):
                blk = extract_block(expr.form, ti.part, None)
                if not blk.integrals():
                    continue
                loc = _local_form_tensor(blk)
                out[:, int(offs[0][i]):int(offs[0][i + 1])] = loc.cell
        return _Local(out, cross)
    if isinstance(expr, AssembledVector):
        # local tensors are CANONICAL-indexed (dof signs applied to the
        # element tensors), so coefficient gathers here stay UNSIGNED
        from .mixed import MixedFunctionSpace
        V = expr.space
        if isinstance(V, MixedFunctionSpace):
            return _Local(torch.cat(
                [as_tensor(sub.dat)[_idx(Vi.cell_dof_map)]
                 for sub, Vi in zip(expr.f.subfunctions, V.subspaces)],
                dim=1))
        return _Local(as_tensor(expr.f.dat)[_idx(V.cell_dof_map)])
    if isinstance(expr, Transpose):
        v = _eval_local(expr.a, cache)
        if expr.rank != 2:
            return v
        return _Local(v.cell.transpose(1, 2),
                      [(cc, rc, vals.transpose(1, 2))
                       for (rc, cc, vals) in v.cross])
    if isinstance(expr, Negative):
        v = _eval_local(expr.a, cache)
        return _Local(-v.cell,
                      [(rc, cc, -vals) for (rc, cc, vals) in v.cross])
    if isinstance(expr, Inverse):
        from .ops.batched_inverse import batched_inv
        return _Local(batched_inv(
            _no_cross(_eval_local(expr.a, cache), "Inverse")))
    if isinstance(expr, Add):
        a = _eval_local(expr.a, cache)
        b = _eval_local(expr.b, cache)
        return _Local(a.cell + b.cell, a.cross + b.cross)
    if isinstance(expr, Mul):
        a = _no_cross(_eval_local(expr.a, cache), "contraction (Mul)")
        b = _no_cross(_eval_local(expr.b, cache), "contraction (Mul)")
        if a.shape[-1] != b.shape[1]:
            raise ValueError(
                f"Slate contraction mismatch: {tuple(a.shape)} x "
                f"{tuple(b.shape)} — check block slicing / Tensor axes")
        if expr.a.rank == 2 and expr.b.rank == 2:
            return _Local(torch.einsum("cij,cjk->cik", a, b))
        if expr.a.rank == 2 and expr.b.rank == 1:
            return _Local(torch.einsum("cij,cj->ci", a, b))
        if expr.a.rank == 1 and expr.b.rank == 2:
            return _Local(torch.einsum("ci,cij->cj", a, b))
        raise NotImplementedError
    if isinstance(expr, Solve):
        from .ops.batched_inverse import batched_solve
        A = _no_cross(_eval_local(expr.A, cache), "Solve")
        b = _no_cross(_eval_local(expr.b, cache), "Solve")
        if A.shape[-1] != b.shape[1]:
            raise ValueError(f"Slate solve mismatch: {tuple(A.shape)} x "
                             f"{tuple(b.shape)}")
        return _Local(batched_solve(A, b))
    if isinstance(expr, Factorization):
        # every decomposition is the same K2 batched_solve
        return _eval_local(expr.a, cache)
    if isinstance(expr, DiagonalTensor):
        v = _no_cross(_eval_local(expr.a, cache), "DiagonalTensor")
        return _Local(torch.diag_embed(torch.diagonal(v, dim1=1, dim2=2)))
    if isinstance(expr, Reciprocal):
        v = _no_cross(_eval_local(expr.a, cache), "Reciprocal")
        return _Local(torch.where(
            v != 0, 1.0 / torch.where(v == 0, torch.ones_like(v), v),
            torch.zeros_like(v)))
    if isinstance(expr, Block):
        v = _eval_local(expr.a, cache)
        sls = [slice(None)]
        for axis, idx in enumerate(expr.indices):
            parts = _axis_parts(expr.a)[axis]
            offs = np.concatenate([[0], np.cumsum(_axis_dims(parts))])
            if isinstance(idx, slice):
                rng = range(len(parts))[idx]
                sls.append(slice(int(offs[rng.start]),
                                 int(offs[rng.stop])))
            else:
                sls.append(slice(int(offs[idx]), int(offs[idx + 1])))
        sls = tuple(sls)
        return _Local(v.cell[sls],
                      [(rc, cc, vals[sls]) for (rc, cc, vals) in v.cross])
    raise NotImplementedError(type(expr).__name__)


# --------------------------------------------- axis (argument) bookkeeping
class _SpaceAxis:
    """Pseudo-argument carrying just a space (AssembledVector axes)."""

    def __init__(self, space):
        self.space = space


def _axis_parts(expr):
    """Per remaining axis: the list of per-field part arguments."""
    if isinstance(expr, Tensor):
        return expr.axis_parts
    if isinstance(expr, AssembledVector):
        from .mixed import MixedFunctionSpace
        V = expr.space
        if isinstance(V, MixedFunctionSpace):
            return [[_SpaceAxis(V.sub(i)) for i in
                     range(V.num_sub_spaces)]]
        return [[_SpaceAxis(V)]]
    if isinstance(expr, (Transpose, Inverse)):
        return _axis_parts(expr.a)[::-1]
    if isinstance(expr, (Negative, Factorization, DiagonalTensor,
                         Reciprocal, Add)):
        return _axis_parts(expr.a)
    if isinstance(expr, Mul):
        return _axis_parts(expr.a)[:-1] + _axis_parts(expr.b)[1:]
    if isinstance(expr, Solve):
        return _axis_parts(expr.A)[::-1][:-1] + _axis_parts(expr.b)[1:]
    if isinstance(expr, Block):
        out = []
        for axis, idx in enumerate(expr.indices):
            parts = _axis_parts(expr.a)[axis]
            out.append([parts[idx]] if isinstance(idx, int)
                       else list(parts[idx]))
        return out
    raise NotImplementedError(type(expr).__name__)


def _axis_space(parts, what):
    if len(parts) != 1:
        raise NotImplementedError(
            f"global assembly of a Slate expression with a multi-field "
            f"{what} axis — slice to single fields with .blocks[i, j]")
    return parts[0].space


def assemble_slate(expr, bcs=None):
    """Assemble a Slate expression into a global scalar, Cofunction or
    CSR Matrix.  Local tensors carry canonical dof indexing (signs and
    transforms applied where they were evaluated), so the scatter is a
    plain sum, in a fixed order."""
    from .assembly.sparsity import Sparsity
    from .assembly.matrix import Matrix
    from .assemble import _accumulation
    loc = _eval_local(expr, {})
    local = loc.cell
    if expr.rank == 0:
        return float(torch.sum(local))
    axes = _axis_parts(expr)
    V0 = _axis_space(axes[0], "row")
    rmap = np.asarray(V0.cell_dof_map, dtype=np.int64)
    dev = local.device
    if expr.rank == 1:
        acc = _accumulation(rmap.reshape(-1), V0.dim, dev)
        f = Cofunction(V0)
        f.dat = acc(local.reshape(-1))
        return f
    V1 = _axis_space(axes[1], "column")
    cmap = np.asarray(V1.cell_dof_map, dtype=np.int64)
    # cross-cell facet-pair couplings (two-sided dS): extra COO blocks
    blocks = [(rmap, cmap)] + [(rmap[rc], cmap[cc])
                               for (rc, cc, _vals) in loc.cross]
    sp = Sparsity(V0.dim, V1.dim, blocks)
    order, sp.key_order = sp.key_order, None
    acc = _accumulation(np.concatenate(sp.block_positions), sp.nnz, dev,
                        order=order)
    data = acc(torch.cat([local.reshape(-1)]
                         + [vals.reshape(-1) for (_r, _c, vals) in loc.cross]))
    A = Matrix(sp, data, V0, V1)
    if bcs:
        rows = np.unique(np.concatenate([bc.dof_indices for bc in bcs]))
        A = A.with_dirichlet(rows)
    return A
