"""Mixed function spaces and block assembly (the port's copy of
``firedrake_tpu/mixed.py``).

Reference: firedrake/functionspaceimpl.py:1030 MixedFunctionSpace,
firedrake/formmanipulation.py:270 split_form / ExtractSubBlock (block
extraction), pyop2 MixedDat/MixedMap/MatBlock.

A mixed space is a composition layer: each block (i, j) of a mixed form is
extracted symbolically by zeroing all other parts (exact by multilinearity
and Zero folding, the same trick as lhs/rhs), then assembled by the
single-space FormAssembler on the gather route.  The monolithic operator
is a ``BlockMatrix`` acting on one concatenated dof vector on the device;
its blocks are CSR ``Matrix`` objects, each the one owner of its layout.
"""
from __future__ import annotations

import numpy as np
import torch

from .functionspace import FunctionSpace
from .language.core import Argument, Zero
from .language.measure import Form
from .language.calculus import map_expr


class IndexedFunctionSpace:
    """W.sub(i): view of component i of a mixed space.  Delegates all
    space queries to the underlying subspace; remembers (parent, index)
    for dof offsetting (reference: functionspaceimpl.py WithGeometry.sub)."""

    def __init__(self, parent: "MixedFunctionSpace", index: int):
        self.parent = parent
        self.index = index
        self._V = parent.subspaces[index]

    def __getattr__(self, name):
        if name == "_V":            # not set yet (copy, pickle)
            raise AttributeError(name)
        return getattr(self._V, name)

    def mesh(self):
        return self._V.mesh_obj

    @property
    def offset(self):
        return int(self.parent.offsets[self.index])

    def __eq__(self, other):
        return (isinstance(other, IndexedFunctionSpace)
                and self.parent is other.parent
                and self.index == other.index)

    def __hash__(self):
        return hash((id(self.parent), self.index))

    def __repr__(self):
        return f"{self.parent!r}.sub({self.index})"


class MixedFunctionSpace:
    """Reference: functionspaceimpl.py:1030."""

    def __init__(self, spaces, name=None):
        flat = []
        for s in spaces:
            if isinstance(s, MixedFunctionSpace):
                flat.extend(s.subspaces)
            else:
                flat.append(s)
        self.subspaces = tuple(flat)
        self.mesh_obj = flat[0].mesh_obj
        if any(V.mesh_obj is not self.mesh_obj for V in flat):
            raise ValueError("mixed space components must share a mesh")
        self.name = name or "Mixed(" + ",".join(V.name for V in flat) + ")"
        dims = [V.dim for V in flat]
        self.offsets = np.concatenate([[0], np.cumsum(dims)])[:-1]
        self.dim = int(sum(dims))
        self.value_shape = ()   # not directly evaluable
        self.block_size = 1

    @property
    def num_sub_spaces(self):
        return len(self.subspaces)

    def sub(self, i):
        return IndexedFunctionSpace(self, i)

    def split(self):
        return tuple(self.sub(i) for i in range(self.num_sub_spaces))

    def mesh(self):
        return self.mesh_obj

    @property
    def element(self):
        return tuple(V.element for V in self.subspaces)

    def __iter__(self):
        return iter(self.split())

    def __getitem__(self, i):
        return self.sub(i)

    def __len__(self):
        return self.num_sub_spaces

    def __mul__(self, other):
        if isinstance(other, (FunctionSpace, MixedFunctionSpace)):
            return MixedFunctionSpace([self, other])
        return NotImplemented

    def __repr__(self):
        return self.name


def mixed_arguments(W: MixedFunctionSpace, number: int):
    """The per-part Arguments for TestFunctions/TrialFunctions(W)."""
    return tuple(Argument(W.sub(i), number, part=i)
                 for i in range(W.num_sub_spaces))


def is_mixed(space):
    return isinstance(space, MixedFunctionSpace)


def split_mixed_terminals(form):
    """Rewrite unsplit mixed-space terminals (Argument(W, n) on a
    MixedFunctionSpace, or a MixedFunction coefficient) into flat
    component vectors of their split parts, so `TestFunction(W)` and
    `inner(sol, test)` work without an explicit split() (ufl's
    mixed-element flat-component convention).  Identity when nothing is
    unsplit."""
    from .language.tensor_algebra import as_vector
    from .language.calculus import replace
    from .language.core import Coefficient

    def flat_components(parts):
        comps = []
        for p in parts:
            vs = tuple(getattr(p, "shape", ()) or ())
            if vs == ():
                comps.append(p)
            elif len(vs) == 1:
                comps.extend(p[i] for i in range(vs[0]))
            else:
                raise NotImplementedError(
                    "unsplit mixed terminal with a tensor-valued part; "
                    "use split()")
        return as_vector(comps)

    mapping = {}
    for it in form.integrals():
        for t in it.integrand.traverse():
            if any(t is k for k in mapping):
                continue
            if isinstance(t, Argument) and is_mixed(t.space):
                mapping[t] = flat_components(
                    mixed_arguments(t.space, t.number))
            elif (isinstance(t, Coefficient)
                  and getattr(t, "parts", None) is not None):
                mapping[t] = flat_components(t.parts)
    return replace(form, mapping) if mapping else form


def form_is_mixed(form: Form):
    """Whether any argument of ``form`` is a part of a mixed space."""
    return any(isinstance(t, Argument) and t.part is not None
               for it in form.integrals() for t in it.integrand.traverse())


# --------------------------------------------------------- block extraction
def extract_block(form: Form, test_part, trial_part):
    """Block (i, j): zero every argument belonging to other parts.
    Exact by multilinearity (reference: formmanipulation.py:29
    ExtractSubBlock)."""
    mapping = {}
    for it in form.integrals():
        for t in it.integrand.traverse():
            if isinstance(t, Argument):
                keep = ((t.number == 0 and t.part == test_part)
                        or (t.number == 1 and t.part == trial_part)
                        or t.number > 1)
                if not keep:
                    mapping[t] = Zero(t.shape)
    out = []
    for it in form.integrals():
        integrand = map_expr(it.integrand, mapping)
        if not integrand.is_zero():
            out.append(it.reconstruct(integrand))
    return Form(tuple(out))


# -------------------------------------------------------------- block matrix
class _ZeroBlock:
    def __init__(self, shape):
        self.shape = shape

    def to_dense(self):
        return np.zeros(self.shape)


class _BlockView:
    """``A.M``: ``.values`` is the dense operator, ``A.M[i, j].values`` one
    block (reference: pyop2/types/mat.py Mat.values / MatBlock)."""

    def __init__(self, mat):
        self._mat = mat

    @property
    def values(self):
        return self._mat.to_dense()

    @property
    def handle(self):
        return self._mat

    def __getitem__(self, ij):
        from .assembly.matrix import MatView
        return MatView(self._mat.block(*ij))


class BlockMatrix:
    """(nfields x nfields) block operator on ONE concatenated vector.

    ``blocks`` maps (i, j) to a CSR ``Matrix`` on the device; absent
    blocks are zero.  The matvec runs each block's own matvec on its
    slice of x; ``to_scipy`` stacks the blocks' host CSR copies (for the
    host LU).  No CSR layout of the whole operator is kept."""

    def __init__(self, W_test, W_trial, blocks):
        self.W_test = W_test
        self.W_trial = W_trial
        self.blocks = dict(blocks)
        self.row_offsets = W_test.offsets
        self.col_offsets = W_trial.offsets
        self.shape = (W_test.dim, W_trial.dim)
        self.bcs = ()

    def block(self, i, j):
        B = self.blocks.get((i, j))
        if B is None:
            return _ZeroBlock((self.W_test.subspaces[i].dim,
                               self.W_trial.subspaces[j].dim))
        return B

    @property
    def M(self):
        return _BlockView(self)

    def matvec(self, x):
        outs = []
        for i, Vi in enumerate(self.W_test.subspaces):
            acc = None
            for j, Vj in enumerate(self.W_trial.subspaces):
                B = self.blocks.get((i, j))
                if B is None:
                    continue
                c0 = int(self.col_offsets[j])
                y = B.matvec(x[c0:c0 + Vj.dim])
                acc = y if acc is None else acc + y
            outs.append(acc if acc is not None
                        else x.new_zeros(Vi.dim))
        return torch.cat(outs)

    __matmul__ = matvec

    def diagonal(self, missing=1.0):
        """The diagonal blocks' diagonals; ``missing`` on a field without
        a diagonal block (1 for Jacobi, as in the JAX package; 0 for the
        operator's true diagonal)."""
        dev = next(iter(self.blocks.values())).data.device
        return torch.cat([
            self.blocks[(i, i)].diagonal() if (i, i) in self.blocks
            else torch.full((Vi.dim,), missing, dtype=torch.float64,
                            device=dev)
            for i, Vi in enumerate(self.W_test.subspaces)])

    def entries(self, rows, cols):
        """A[rows, cols] for int64 index tensors of one shape in the
        concatenated numbering, each looked up in its block's stored
        entries (Matrix.entries); 0 in absent blocks."""
        dev, shape = rows.device, rows.shape
        rows, cols = rows.reshape(-1), cols.reshape(-1)
        rf = torch.bucketize(rows, torch.as_tensor(
            self.row_offsets[1:], device=dev), right=True)
        cf = torch.bucketize(cols, torch.as_tensor(
            self.col_offsets[1:], device=dev), right=True)
        out = torch.zeros(rows.shape, dtype=torch.float64, device=dev)
        for (i, j), B in self.blocks.items():
            sel = (rf == i) & (cf == j)
            out[sel] = B.entries(rows[sel] - int(self.row_offsets[i]),
                                 cols[sel] - int(self.col_offsets[j]))
        return out.view(shape)

    def to_scipy(self):
        """The host CSR of the whole operator: the blocks' stored entries,
        explicit zeros included (the pattern the Vanka patches read)."""
        from scipy.sparse import bmat
        n = self.W_test.num_sub_spaces
        m = self.W_trial.num_sub_spaces
        grid = [[None] * m for _ in range(n)]
        for (i, j), B in self.blocks.items():
            grid[i][j] = B.to_scipy()
        return bmat(grid, format="csr")

    def to_dense(self):
        return self.to_scipy().toarray()

    def with_dirichlet(self, bc_rows, symmetric=True):
        """Monolithic Dirichlet elimination given concatenated dof rows:
        in block (i, j) the bc rows of field i (and, symmetric, the bc
        columns of field j) are zeroed, with 1 on the diagonal of the
        diagonal blocks.  A field with bc rows and no diagonal block gets
        an identity block over those rows."""
        from .assembly.sparsity import Sparsity
        from .assembly.matrix import Matrix
        bc_rows = np.asarray(bc_rows, dtype=np.int64)

        def local(offsets, spaces, k):
            o = int(offsets[k])
            return bc_rows[(bc_rows >= o) & (bc_rows < o + spaces[k].dim)] \
                - o

        new = {}
        for (i, j), B in self.blocks.items():
            ri = local(self.row_offsets, self.W_test.subspaces, i)
            cj = (local(self.col_offsets, self.W_trial.subspaces, j)
                  if symmetric else ri[:0])
            new[(i, j)] = B.with_zeroed(ri, cj, unit_diagonal=(i == j))
        for i, Vi in enumerate(self.W_test.subspaces):
            if (i, i) in new:
                continue
            ri = local(self.row_offsets, self.W_test.subspaces, i)
            if len(ri) == 0:
                continue
            sp = Sparsity(Vi.dim, Vi.dim, [(ri[:, None], ri[:, None])])
            dev = next(iter(self.blocks.values())).data.device
            new[(i, i)] = Matrix(sp, torch.ones(sp.nnz, dtype=torch.float64,
                                                device=dev), Vi, Vi)
        out = BlockMatrix(self.W_test, self.W_trial, new)
        out.bcs = self.bcs
        return out

    def __repr__(self):
        return f"BlockMatrix({self.shape}, blocks={sorted(self.blocks)})"
