"""assemble(): form -> scalar / vector / operator.

Reference role: firedrake/assemble.py:48 assemble / :154 get_assembler
and the PyOP2 parloop machinery.  Two routes, as in the JAX package:

* the stencil route (assembly/stencil.py): on structured meshes
  (UnitSquareMesh, UnitCubeMesh, ...) coordinates and coefficients are
  read as strided slices of the dof grid and element tensors are
  slice-added into channel planes (a ``StencilMatrix``);
* the gather route, for everything else (unstructured meshes, facet
  integrals, 0-forms, or ``use_stencil=False`` / ``FDTPU_NO_STENCIL=1``):
  per integral, static int32 index tables gather coordinates and
  coefficients, the element tensors are evaluated, and a static gather
  table sums them into a flat vector or the CSR values of a ``Matrix``
  (assembly/sparsity.py, assembly/matrix.py).  Cell integrals are
  gathered cell-last and evaluated by K1 or the torch BatchedLowerer
  (compiler/cell_eval.py), facet integrals by the per-facet kernels
  vmapped over the facets (compiler/kernels.py).

H(div)/H(curl) spaces take the gather route: their dof signs (or, for
multi-moment tet faces, per-cell transforms) turn gathered canonical
coefficient values into cell-local ones and the local tensors back into
canonical rows and columns, on the device before accumulation.  Forms on
mixed spaces are assembled block by block (``MixedFormAssembler``) into a
``BlockMatrix`` (mixed.py) or one concatenated vector.

On extruded meshes a form whose arguments, coefficients and coordinates
are column-numbered takes the column plan (assembly/columns.py: row
gathers of whole dof columns, strided layer slices, a ``ColumnMatrix``);
every other form there (H(div) prism spaces, ragged columns, facet
integrals) takes the gather route, where a facet integral on prisms is
compiled once per facet class (triangle and quad facets carry different
rules).  On the gather route, cell integrals of scalar Lagrange Q_k
(k >= 2) on quads and hexes take the sum-factorised plan
(compiler/spectral.py).

Still raising NotImplementedError, each naming its ROADMAP.md queue 1
item: complex scalars (item 17), vertex-only meshes (item 18).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .language.measure import Form
from .language.core import ScalarValue
from .compiler.kernels import CompiledIntegral
from .compiler.precision import (kernel_dtype, trace_ctx, castf,
                                 castf_map, widen)
from .compiler.cell_eval import run_cell_kernel
from .compiler.lowering import einsum
from .assembly.sparsity import Sparsity
from .assembly.matrix import Matrix
from .function import Cofunction
from .mixed import (BlockMatrix, extract_block, form_is_mixed,
                    split_mixed_terminals)
from .bcs import as_bcs
from .device import as_tensor, get_device
from .mesh.topology import orientation_index

__all__ = ["assemble", "FormAssembler", "get_assembler"]

_assembler_cache: dict = {}

#: most contributions a gather table sums per output entry; beyond it the
#: sorted reduction takes over
_TABLE_MAX_K = 12


def _kernel_chunk(ci, n, itemsize):
    """Entity-axis chunk size bounding the kernel's live (ni, nj, nq,
    chunk) quadrature intermediate to FDTPU_KERNEL_BYTES (default 1 GiB).
    None = no chunking."""
    ni, nj = ci.local_shape()
    per_entity = max(ni * nj * ci.num_quad_points(), 1) * itemsize
    budget = float(os.environ.get("FDTPU_KERNEL_BYTES", 2 ** 30))
    chunk = int(budget / per_entity)
    if chunk >= n:
        return None
    return max(chunk, 1024)


def _vmapped(fn, args, chunk):
    """fn vmapped over the leading axis of every tensor in ``args``,
    ``chunk`` entities at a time (None: all at once)."""
    vfn = torch.func.vmap(fn)
    n = args[0].shape[0]
    if not chunk or chunk >= n:
        return vfn(*args)
    return torch.cat([vfn(*(a[c0:c0 + chunk] for a in args))
                      for c0 in range(0, n, chunk)])


def _is_complex(form):
    for c in form.coefficients():
        if torch.is_tensor(c.dat) and c.dat.is_complex():
            return True
    for c in form.constants():
        if np.iscomplexobj(c.values()):
            return True
    return any(isinstance(t, ScalarValue) and isinstance(t.value, complex)
               for it in form.integrals() for t in it.integrand.traverse())


def interior_facets(mesh, subdomain_id):
    """The interior facets of dS(subdomain_id): all, or the marked ones;
    UNMARKED (-1, the reference's label for untagged facets) selects
    0."""
    facets = mesh.topology.interior_facets
    if subdomain_id in ("everywhere", None):
        return facets
    sd = subdomain_id
    if isinstance(sd, (int, np.integer)):
        sd = (int(sd),)
    sd = tuple(0 if s == -1 else s for s in sd)
    return facets[np.isin(mesh.facet_markers[facets], np.asarray(sd))]


def facet_classes(mesh):
    """The facet classes a facet integral is compiled for: [None] on
    cells with one facet shape, the sorted class names on prisms
    (triangle and quad facets)."""
    if mesh.cell.facet_cell_name is not None:
        return [None]
    return sorted(set(mesh.cell.facet_types))


def of_class(mesh, facets, ftype):
    """The facets of class ``ftype`` (all for None)."""
    if ftype is None:
        return facets
    ftypes = np.asarray(mesh.cell.facet_types)
    return facets[ftypes[mesh.topology.facet_local_id[facets, 0]] == ftype]


def facet_pairs(mesh, facets, ftype=None):
    """(plus cells, minus cells, their local facet ids, the relative
    orientation of the minus side) of interior facets (of one class,
    ``ftype``, on prisms): the orientation is the index of the
    permutation taking each minus-cell facet vertex to its position in
    the plus cell's vertex list."""
    from .elements.reference_cell import by_name
    topo = mesh.topology
    cp = topo.facet_cells[facets, 0]
    cm = topo.facet_cells[facets, 1]
    lfp = topo.facet_local_id[facets, 0]
    lfm = topo.facet_local_id[facets, 1]
    fv = mesh.cell.facets
    if ftype is not None:
        fv = fv[:, :by_name(ftype).num_vertices]   # triangles pad with -1
    vp = topo.cell_vertices[cp[:, None], fv[lfp]]
    vm = topo.cell_vertices[cm[:, None], fv[lfm]]
    o_rel = orientation_index(
        np.argmax(vm[:, :, None] == vp[:, None, :], axis=2))
    return cp, cm, lfp, lfm, o_rel


def _local_dofs(space, cell_sets, cell_last):
    """The map from a space's canonical (global) dof values to its
    cell-local ones, over the cells of each set side by side: None for
    spaces without one; ("s", signs) with signs (n, nd), or (nd, C)
    cell-last; ("t", B) with B (n, nd, nd), block diagonal over the sets.
    The host tables are the space's own (built once, on first use)."""
    if space is None:
        return None
    if getattr(space, "has_dof_signs", False):
        sg = space.cell_dof_signs
        tab = np.hstack([sg[c] for c in cell_sets])
        kind = "s"
        if cell_last:
            tab = tab.T
    elif getattr(space, "has_dof_transforms", False):
        Tc = space.cell_dof_transforms
        blocks = [Tc[c] for c in cell_sets]
        n, nd = blocks[0].shape[:2]
        tab = np.zeros((n, nd * len(blocks), nd * len(blocks)))
        for k, B in enumerate(blocks):
            tab[:, k * nd:(k + 1) * nd, k * nd:(k + 1) * nd] = B
        kind = "t"
    else:
        return None
    return kind, torch.as_tensor(np.ascontiguousarray(tab),
                                 dtype=torch.float64, device=get_device())


def _coeff_local(w, m, cell_last):
    """Gathered canonical coefficient values -> cell-local values
    (w: (nd, C) cell-last, else (n, nd))."""
    if m is None:
        return w
    kind, t = m
    t = t.to(w.dtype)
    if kind == "s":
        return w * t
    return einsum("cij,jc->ic" if cell_last else "cij,cj->ci", t, w)


def _canonical(loc, mr, mc, cell_last):
    """Local tensors -> canonical rows (test map ``mr``) and columns
    (trial map ``mc``): A_can = B_r^T A_loc B_c, the signs being their
    own inverse.  loc: (ni, nj, C) cell-last, else (n, ni, nj)."""
    if mr is not None:
        kind, t = mr
        t = t.to(loc.dtype)
        if kind == "s":
            loc = loc * (t[:, None, :] if cell_last else t[:, :, None])
        else:
            loc = einsum("cip,ijc->pjc" if cell_last else "cip,cij->cpj",
                         t, loc)
    if mc is not None:
        kind, t = mc
        t = t.to(loc.dtype)
        if kind == "s":
            loc = loc * (t[None] if cell_last else t[:, None, :])
        else:
            loc = einsum("pjc,cjq->pqc" if cell_last else "cpj,cjq->cpq",
                         loc, t)
    return loc


class _Tables:
    """Gather-table accumulation: out[r] = sum_j flat[tbl[j, r]] with the
    padding slot len(flat) reading 0, split into a dense base table of NB
    columns and a spill table over the rows that have more contributions
    (the JAX package's _build_acc_table).  Deterministic: every entry is
    summed in the same order on every run and device.  An entry of
    ``flat`` may be a block (flat of shape (n, ...)): Slate sums element
    tensors into their cells this way."""

    def __init__(self, tbl, tblx, rows_x):
        self.tbl, self.tblx, self.rows_x = tbl, tblx, rows_x

    def __call__(self, flat):
        flat = torch.cat([flat, flat.new_zeros((1,) + flat.shape[1:])])
        total = widen(flat[self.tbl[0]])
        for col in self.tbl[1:]:
            total = total + widen(flat[col])
        if self.tblx is not None:
            extra = widen(flat[self.tblx[0]])
            for col in self.tblx[1:]:
                extra = extra + widen(flat[col])
            total[self.rows_x] = total[self.rows_x] + extra
        return total


class _Sorted:
    """Sorted-permutation accumulation: one gather sorts the contributions
    by output entry, a segment sum adds each entry's run (the JAX
    package's _build_sorted_accum)."""

    def __init__(self, perm, lengths):
        self.perm, self.lengths = perm, lengths

    def __call__(self, flat):
        return torch.segment_reduce(widen(flat[self.perm]), "sum",
                                    lengths=self.lengths)


def _accumulation(pos_all, nseg, device, sorted_=False, order=None):
    """Accumulation plan summing a flat value array whose entry k lands in
    output entry pos_all[k] (entries >= nseg are dropped: the
    RestrictedFunctionSpace sentinel).  ``order``: the indices of the
    kept entries sorted by output entry, each run in a fixed order (a
    stable argsort when not given).  A gather table when every output
    entry has at most _TABLE_MAX_K contributions, else (or with
    ``sorted_``) the sorted reduction."""
    nvals = len(pos_all)
    if order is None:
        src = np.nonzero(pos_all < nseg)[0]
        order = src[np.argsort(pos_all[src], kind="stable")]
    spos = pos_all[order]
    counts = np.bincount(spos, minlength=nseg)
    K = int(counts.max()) if counts.size else 0

    def dev(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    if sorted_ or K == 0 or K > _TABLE_MAX_K \
            or nseg * min(K, 4) > 6e7:
        return _Sorted(dev(order, torch.int64), dev(counts, torch.int64))
    col = np.arange(len(order)) - (np.cumsum(counts) - counts)[spos]
    # split point NB minimising the gathered volume: a dense (NB, nseg)
    # base table plus a short spill table over the rows with more
    # contributions (most entries have few)
    NB = min(range(1, K + 1),
             key=lambda nb: nseg * nb + int((counts > nb).sum()) * (K - nb))
    tbl = np.full((NB, nseg), nvals, dtype=np.int32)
    m = col < NB
    tbl[col[m], spos[m]] = order[m]
    rows_x = np.nonzero(counts > NB)[0]
    if not len(rows_x):
        return _Tables(dev(tbl), None, None)
    ridx = np.full(nseg, -1, dtype=np.int64)
    ridx[rows_x] = np.arange(len(rows_x))
    tblx = np.full((K - NB, len(rows_x)), nvals, dtype=np.int32)
    tblx[col[~m] - NB, ridx[spos[~m]]] = order[~m]
    return _Tables(dev(tbl), dev(tblx), dev(rows_x, torch.int64))


def _accumulation_device(pos_all, nseg):
    """_accumulation's plan built where the int64 tensor ``pos_all`` lies:
    the same stable order and the same tables, entry for entry, without
    the host's sort (the patch PCs' millions of slots)."""
    nvals = pos_all.numel()
    src = torch.nonzero(pos_all < nseg).reshape(-1)
    spos, perm = torch.sort(pos_all[src], stable=True)
    order = src[perm]
    counts = torch.bincount(spos, minlength=nseg)
    K = int(counts.max()) if counts.numel() else 0
    if K == 0 or K > _TABLE_MAX_K or nseg * min(K, 4) > 6e7:
        return _Sorted(order, counts)
    col = torch.arange(len(order), device=order.device) \
        - (torch.cumsum(counts, 0) - counts)[spos]
    # rows with more than nb contributions, for nb = 0..K (host: K + 1
    # numbers), and _accumulation's split point from them
    above = nseg - np.cumsum(
        torch.bincount(counts, minlength=K + 1).cpu().numpy())
    NB = min(range(1, K + 1), key=lambda nb: nseg * nb
             + int(above[nb]) * (K - nb))
    order32 = order.to(torch.int32)
    tbl = torch.full((NB, nseg), nvals, dtype=torch.int32,
                     device=order.device)
    m = col < NB
    tbl[col[m], spos[m]] = order32[m]
    rows_x = torch.nonzero(counts > NB).reshape(-1)
    if not len(rows_x):
        return _Tables(tbl, None, None)
    ridx = torch.full((nseg,), -1, dtype=torch.int64, device=order.device)
    ridx[rows_x] = torch.arange(len(rows_x), device=order.device)
    tblx = torch.full((K - NB, len(rows_x)), nvals, dtype=torch.int32,
                      device=order.device)
    tblx[col[~m] - NB, ridx[spos[~m]]] = order32[~m]
    return _Tables(tbl, tblx, rows_x)


class FormAssembler:
    """Static plan + device evaluation for one form (reference analogue:
    ParloopFormAssembler, assemble.py:1019)."""

    def __init__(self, form: Form, bcs=(), mat_type="aij",
                 zero_bc_nodes=False, use_stencil=True):
        self.form = form
        self.bcs = as_bcs(bcs)
        self.mat_type = mat_type
        self.zero_bc_nodes = zero_bc_nodes
        args = form.arguments()
        self.rank = len(args)
        self.test = args[0] if self.rank >= 1 else None
        self.trial = args[1] if self.rank >= 2 else None
        self.mesh = form.mesh()
        if self.mesh is None:
            raise ValueError("form has no mesh")
        if getattr(self.mesh, "is_vertex_only", False):
            raise NotImplementedError(
                "vertex-only assembly is not ported yet: ROADMAP.md "
                "queue 1, item 18")
        self.coefficients = form.coefficients()
        self.constants = form.constants()
        # mixed-precision kernel execution (compiler/precision.py), read
        # once at build as in the JAX package
        self._prec = kernel_dtype()
        if _is_complex(form):
            raise NotImplementedError("complex scalar assembly is not "
                                      "ported yet: ROADMAP.md queue 1, "
                                      "item 17")
        # a facet integral on prisms compiles once per facet class
        self._compiled = [
            CompiledIntegral(it, self.test, self.trial, self.mesh,
                             ftype=ft)
            for it in form.integrals()
            for ft in (facet_classes(self.mesh)
                       if it.integral_type != "cell" else [None])]
        self._stencil = self._column = None
        if use_stencil and self.rank in (1, 2):
            from .assembly.stencil import build_stencil_plan
            self._stencil = build_stencil_plan(self)
            if self._stencil is None:
                from .assembly.columns import build_column_plan
                self._column = build_column_plan(self)
        if self._stencil is None and self._column is None:
            self._build_statics()

    def _inputs(self):
        coords = self.mesh.device_coordinates()
        coeffs = {c.count: as_tensor(c.dat) for c in self.coefficients}
        consts = {c.count: as_tensor(c.values()) for c in self.constants}
        return coords, coeffs, consts

    # ------------------------------------------------------- stencil route
    def _run_stencil(self, coords_dat, coeff_dats, const_vals,
                     diag_only=False):
        """Strided slices in, K1 (or the lowerer) per cell type, strided
        slice-add accumulation out (assembly/stencil.py)."""
        plan = self._stencil
        prec = self._prec
        if prec is not None:
            coords_dat = castf(coords_dat, prec)
            coeff_dats = castf_map(coeff_dats, prec)
            const_vals = castf_map(const_vals, prec)
        acc = (plan.accumulate_diag if diag_only else
               plan.accumulate_rank2 if self.rank == 2 else
               plan.accumulate_rank1)
        out = None
        # one cell type at a time: a P2-tet operator at 12.6M cells would
        # otherwise hold ~10 GB (float64) of element tensors
        for t in range(plan.ntypes):
            loc = None
            for ci in self._compiled:
                consts = tuple(const_vals[c.count] for c in ci.constants)
                ce, ws = plan.gather_cell_inputs(t, coords_dat, coeff_dats,
                                                 ci)
                with trace_ctx(prec):
                    lt = run_cell_kernel(
                        ci, ce, ws, consts,
                        chunk=_kernel_chunk(ci, ce.shape[-1],
                                            ce.element_size()))
                loc = lt if loc is None else loc + lt
            if prec is not None:
                loc = widen(loc)              # f64 accumulation
            out = acc(out, t, loc)
        return out

    # -------------------------------------------------------- column route
    def _run_column(self, coords_dat, coeff_dats, const_vals):
        """Column row gathers + strided layer slices in, the lowerer per
        integral, fixed-order row sums out (assembly/columns.py)."""
        plan = self._column
        prec = self._prec
        if prec is not None:
            coords_dat = castf(coords_dat, prec)
            coeff_dats = castf_map(coeff_dats, prec)
            const_vals = castf_map(const_vals, prec)
        loc = None
        for ci in self._compiled:
            consts = tuple(const_vals[c.count] for c in ci.constants)
            ce, ws = plan.gather_cell_inputs(coords_dat, coeff_dats, ci)
            with trace_ctx(prec):
                lt = run_cell_kernel(
                    ci, ce, ws, consts,
                    chunk=_kernel_chunk(ci, ce.shape[-1],
                                        ce.element_size()))
            loc = lt if loc is None else loc + lt
        if prec is not None:
            loc = widen(loc)                  # f64 accumulation
        if self.rank == 2:
            return plan.accumulate_rank2(loc)
        return plan.accumulate_rank1(loc)

    # -------------------------------------------------------- gather route
    def _build_statics(self):
        """Per integral, the host index arrays (rows and columns of the
        local tensors, for the Sparsity and the accumulation) and ONE
        device copy of each gather table; then the Sparsity (rank 2) and
        the accumulation plan (ranks 1 and 2)."""
        compiled, self._compiled, self._statics = self._compiled, [], []
        for ci in compiled:
            st = self._prepare_integral(ci)
            if st is not None:          # empty entity sets drop out
                self._compiled.append(ci)
                self._statics.append(st)
        dev = get_device()
        sorted_ = os.environ.get("FDTPU_GATHER_ACC") == "sorted"
        self._acc = None
        if self.rank == 2:
            self.sparsity = Sparsity(
                self.test.space.dim, self.trial.space.dim,
                [(st["rows"], st["cols"]) for st in self._statics])
            # the Sparsity's key sort order, its block-entry indices
            # turned into value indices, is the accumulation's order
            order, self.sparsity.key_order = self.sparsity.key_order, None
            parts, off = [], 0
            for st, pos in zip(self._statics, self.sparsity.block_positions):
                m = len(pos)
                if st["cell_last"]:
                    # values of the cell-last kernels come slot-major:
                    # entry (entity e, slot s) sits at value s * n + e
                    n = st["n"]
                    S = m // n
                    pos = pos.reshape(n, S).T.reshape(-1)
                    sel = (order >= off) & (order < off + m)
                    q = order[sel] - off
                    order[sel] = off + (q % S) * n + q // S
                parts.append(pos)
                off += m
            if parts:
                self._acc = _accumulation(np.concatenate(parts),
                                          self.sparsity.nnz, dev, sorted_,
                                          order)
        elif self.rank == 1:
            parts = [st["rows"].T.reshape(-1) if st["cell_last"]
                     else st["rows"].reshape(-1) for st in self._statics]
            if parts:
                self._acc = _accumulation(np.concatenate(parts),
                                          self.test.space.dim, dev, sorted_)
        for st in self._statics:
            del st["rows"], st["cols"]

    def _prepare_integral(self, ci: CompiledIntegral):
        mesh = self.mesh
        topo = mesh.topology
        g = mesh.geometric_dimension
        cmap3 = mesh.coordinates.function_space().cell_dof_map.reshape(
            topo.num_cells, -1, g)
        dev = get_device()

        def idx(a):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   dtype=torch.int32, device=dev)

        def maps(cells, T=False):
            return {c.count: idx(c.space.cell_dof_map[cells].T if T
                                 else c.space.cell_dof_map[cells])
                    for c in ci.coefficients}

        def arg_maps(cells_list):
            """(rows, cols): each argument's cell dof maps, side by side
            over the cells of each list; with them the arguments' maps to
            cell-local dofs (signs, transforms) over the same cells."""
            cl = st["cell_last"]
            st["local_rows"], st["local_cols"] = [
                None if a is None else _local_dofs(a.space, cells_list, cl)
                for a in (self.test, self.trial)]
            return [None if a is None else np.hstack(
                [a.space.cell_dof_map[c] for c in cells_list])
                for a in (self.test, self.trial)]

        def coeff_local(cells, key="coeff_local"):
            st[key] = {c.count: m for c in ci.coefficients
                       if (m := _local_dofs(c.space, [cells],
                                            st["cell_last"])) is not None}

        st = {"cell_last": ci.integral_type == "cell"}
        if ci.integral_type == "cell":
            cells = mesh.cell_subset(ci.subdomain_id)
            if len(cells) == 0:
                return None
            # cell-last gathers: (ndofc, g, C) coordinates, (nslot, C)
            # coefficient values, the inputs of K1 and the lowerer
            st["coords_map"] = idx(cmap3[cells].transpose(1, 2, 0))
            st["coeff_maps"] = maps(cells, T=True)
            coeff_local(cells)
            st["rows"], st["cols"] = arg_maps([cells])
            st["n"] = len(cells)
            # sum-factorised Q_k on quads and hexes (compiler/spectral.py)
            from .compiler.spectral import build_spectral_plan
            st["spectral"] = build_spectral_plan(ci, self.test, self.trial)
        elif ci.integral_type == "exterior_facet":
            facets = of_class(mesh, mesh.boundary_facets(ci.subdomain_id),
                              ci.ftype)
            if len(facets) == 0:
                return None
            cells = topo.facet_cells[facets, 0]
            st["coords_map"] = idx(cmap3[cells])
            st["lf"] = idx(topo.facet_local_id[facets, 0])
            st["coeff_maps"] = maps(cells)
            coeff_local(cells)
            st["rows"], st["cols"] = arg_maps([cells])
            st["n"] = len(facets)
        else:
            facets = of_class(mesh, interior_facets(mesh, ci.subdomain_id),
                              ci.ftype)
            if len(facets) == 0:
                return None
            cp, cm, lfp, lfm, o_rel = facet_pairs(mesh, facets, ci.ftype)
            st["coords_map_p"] = idx(cmap3[cp])
            st["coords_map_m"] = idx(cmap3[cm])
            st["lf_p"], st["lf_m"] = idx(lfp), idx(lfm)
            st["o_rel"] = idx(o_rel)
            st["coeff_maps_p"] = maps(cp)
            st["coeff_maps_m"] = maps(cm)
            coeff_local(cp, "coeff_local_p")
            coeff_local(cm, "coeff_local_m")
            # doubled slots: the '+' cell's dofs, then the '-' cell's
            st["rows"], st["cols"] = arg_maps([cp, cm])
            st["n"] = len(facets)
        return st

    def _local_values(self, ci, st, coords_dat, coeff_dats, consts):
        """Element tensors of one integral: (ni, nj, C) for cell
        integrals (cell-last), (n, ni, nj) for facet integrals."""
        prec = self._prec
        cl = st["cell_last"]

        def gathered(c, sfx=""):
            w = coeff_dats[c.count][st["coeff_maps" + sfx][c.count]]
            return _coeff_local(w, st["coeff_local" + sfx].get(c.count), cl)

        if ci.integral_type == "cell":
            ce = coords_dat[st["coords_map"]]           # (ndofc, g, C)
            ws = tuple(gathered(c) for c in ci.coefficients)  # (nslot, C)
            with trace_ctx(prec):
                if st["spectral"] is not None:
                    loc = st["spectral"].local_tensors(ce, ws, consts)
                else:
                    loc = run_cell_kernel(
                        ci, ce, ws, consts,
                        chunk=_kernel_chunk(ci, st["n"],
                                            ce.element_size()))
            return _canonical(loc, st["local_rows"], st["local_cols"], cl)
        kern = ci.kernel()
        nco = len(ci.coefficients)
        if ci.integral_type == "exterior_facet":
            args = (coords_dat[st["coords_map"]], st["lf"]) + tuple(
                gathered(c) for c in ci.coefficients)

            def fn(c, lf, *w):
                return kern(c, lf, w, consts)
        else:
            args = (coords_dat[st["coords_map_p"]],
                    coords_dat[st["coords_map_m"]], st["lf_p"],
                    st["lf_m"], st["o_rel"]) + tuple(
                gathered(c, "_" + s) for s in "pm"
                for c in ci.coefficients)

            def fn(cp, cm, lp, lm, o, *w):
                return kern(cp, cm, lp, lm, o, w[:nco], w[nco:], consts)
        with trace_ctx(prec):
            loc = _vmapped(fn, args, _kernel_chunk(
                ci, st["n"], args[0].element_size()))
        return _canonical(loc, st["local_rows"], st["local_cols"], cl)

    def _run(self, coords_dat, coeff_dats, const_vals):
        """The gather route: rank 0 -> 0-d tensor, rank 1 -> vector,
        rank 2 -> CSR values over the Sparsity."""
        prec = self._prec
        if prec is not None:
            # cast before the gathers: they move narrow values
            coords_dat = castf(coords_dat, prec)
            coeff_dats = castf_map(coeff_dats, prec)
            const_vals = castf_map(const_vals, prec)
        total = torch.zeros((), dtype=torch.float64, device=get_device())
        flats = []
        for ci, st in zip(self._compiled, self._statics):
            consts = tuple(const_vals[c.count] for c in ci.constants)
            loc = self._local_values(ci, st, coords_dat, coeff_dats,
                                     consts)
            if self.rank == 0:
                total = total + torch.sum(widen(loc))
            elif self.rank == 1:
                # reduced-dtype values: widened after the gathers
                flats.append((loc[:, 0] if st["cell_last"]
                              else loc[:, :, 0]).reshape(-1))
            else:
                flats.append(loc.reshape(-1))
        if self.rank == 0:
            return total
        nseg = (self.sparsity.nnz if self.rank == 2
                else self.test.space.dim)
        if not flats:
            return total.new_zeros(nseg)
        return self._acc(flats[0] if len(flats) == 1 else torch.cat(flats))

    def diagonal_space(self):
        return self.test.space

    def assemble_diagonal(self):
        """diag(A) of a rank-2 form: on the stencil route without
        materializing the operator (only the zero-offset channel is
        accumulated), on the gather route from the assembled matrix."""
        assert self.rank == 2, "assemble_diagonal needs a bilinear form"
        if self._stencil is None:
            return self.assemble().diagonal()
        return self._run_stencil(*self._inputs(), diag_only=True)

    def _evaluate(self, coords_dat, coeff_dats, const_vals):
        """The form's raw values on the route this assembler took."""
        run = (self._run_stencil if self._stencil is not None else
               self._run_column if self._column is not None else self._run)
        return run(coords_dat, coeff_dats, const_vals)

    # ------------------------------------------------------------- public
    def assemble(self, tensor=None):
        return self._postprocess(self._evaluate(*self._inputs()), tensor)

    def _postprocess(self, out, tensor):
        if self.rank == 0:
            return float(out)
        if self.rank == 1:
            for bc in self.bcs:
                if self.zero_bc_nodes:
                    out = bc.zero(out)
                else:
                    out = bc.apply(out)
            if tensor is not None:
                tensor.dat = out
                return tensor
            f = Cofunction(self.test.space)
            f.dat = out
            return f
        if self._stencil is not None:
            from .assembly.stencil import StencilMatrix
            mat = StencilMatrix(self._stencil, out, self.test.space,
                                self.trial.space, self.bcs)
        elif self._column is not None:
            from .assembly.columns import ColumnMatrix
            mat = ColumnMatrix(self._column, out, self.test.space,
                               self.trial.space, self.bcs)
        else:
            mat = Matrix(self.sparsity, out, self.test.space,
                         self.trial.space, self.bcs)
        if self.bcs:
            rows = np.unique(np.concatenate(
                [bc.dof_indices for bc in self.bcs]))
            mat = mat.with_dirichlet(rows)
        return mat


def _bc_key(bcs):
    return tuple((id(bc.function_space_obj), str(bc.sub_domain),
                  bc.sub_component) for bc in bcs)


def build_key():
    """What a FormAssembler reads from its surroundings when it is built:
    the kernel precision, the route switches, the gather accumulation and
    the device.  Every cache of assemblers keys on it."""
    return (os.environ.get("FDTPU_PREC", ""),
            os.environ.get("FDTPU_NO_STENCIL", ""),
            os.environ.get("FDTPU_NO_COLUMN", ""),
            os.environ.get("FDTPU_SPECTRAL", ""),
            os.environ.get("FDTPU_GATHER_ACC", ""), str(get_device()))


def get_assembler(form: Form, bcs=None, mat_type="aij",
                  zero_bc_nodes=False) -> FormAssembler:
    bcs = as_bcs(bcs)
    form = split_mixed_terminals(form)
    # constants key the cache alongside coefficients: signature()
    # renumbers Constant terminals structurally, and the assembler binds
    # its form's Constant objects (values read at call time by count)
    key = (form.signature(), id(form.mesh()), _bc_key(bcs), mat_type,
           zero_bc_nodes, build_key(),
           tuple(id(c) for c in form.coefficients()),
           tuple(c.count for c in form.constants()))
    if key not in _assembler_cache:
        cls = MixedFormAssembler if form_is_mixed(form) else FormAssembler
        _assembler_cache[key] = cls(form, bcs, mat_type, zero_bc_nodes)
    else:
        _assembler_cache[key].bcs = bcs
    return _assembler_cache[key]


def assemble(form, tensor=None, bcs=None, mat_type="aij",
             zero_bc_nodes=False, diagonal=False, **kwargs):
    """Assemble a 0-, 1- or 2-form (reference: firedrake/assemble.py:48):
    a float, a Cofunction or an operator.  ``diagonal=True`` on a bilinear
    form returns the matrix diagonal as a Cofunction."""
    if isinstance(form, (int, float)):
        return float(form)
    if not isinstance(form, Form):
        raise TypeError(f"cannot assemble {type(form)}")
    if form.empty():
        return 0.0
    assembler = get_assembler(form, bcs, mat_type, zero_bc_nodes)
    if diagonal:
        d = assembler.assemble_diagonal()
        out = tensor if tensor is not None else Cofunction(
            assembler.diagonal_space())
        out.dat = d
        return out
    result = assembler.assemble(tensor=tensor)
    if isinstance(result, float):
        # a functional, taped while annotating (JAX assemble.py:899-906)
        from .adjoint.tape import (annotate_tape, get_working_tape,
                                   FunctionalBlock, AdjFloat)
        if annotate_tape():
            block = FunctionalBlock(form, result)
            get_working_tape().add_block(block)
            return AdjFloat(result, block)
    return result


class MixedFormAssembler:
    """Block-wise assembly over mixed spaces: each block is extracted
    symbolically (mixed.extract_block) and assembled by a FormAssembler,
    rank-2 blocks on the gather route (a BlockMatrix holds CSR blocks).
    The JAX package's MixedFormAssembler (assemble.py:911), with the
    diagonal of a mixed operator, and ``tensor`` filled in place, which
    the JAX package does not support (ROADMAP.md queue 3)."""

    def __init__(self, form: Form, bcs=(), mat_type="aij",
                 zero_bc_nodes=False):
        self.form = form
        self.bcs = as_bcs(bcs)
        self.zero_bc_nodes = zero_bc_nodes
        args = form.arguments()
        self.rank = len({a.number for a in args})
        tests = [a for a in args if a.number == 0]
        trials = [a for a in args if a.number == 1]
        self.W_test = tests[0].space.parent if tests else None
        self.W_trial = trials[0].space.parent if trials else None
        self.mesh = form.mesh()
        self.block_assemblers = {}
        if self.rank == 2:
            for i in range(self.W_test.num_sub_spaces):
                for j in range(self.W_trial.num_sub_spaces):
                    bf = extract_block(form, i, j)
                    if not bf.empty():
                        self.block_assemblers[(i, j)] = FormAssembler(
                            bf, use_stencil=False)
        elif self.rank == 1:
            for i in range(self.W_test.num_sub_spaces):
                bf = extract_block(form, i, None)
                if not bf.empty():
                    self.block_assemblers[(i,)] = FormAssembler(bf)
        else:
            raise ValueError("0-forms cannot contain arguments")

    def diagonal_space(self):
        return self.W_test

    def assemble_diagonal(self):
        """diag(A) of a mixed bilinear form: the diagonal blocks'
        diagonals, zero for a field without one, bcs applied as to the
        assembled operator."""
        if self.rank != 2:
            raise ValueError("assemble_diagonal needs a bilinear form")
        return self.assemble().diagonal(missing=0.0)

    def assemble(self, tensor=None):
        if self.rank == 2:
            blocks = {k: a.assemble() for k, a in
                      self.block_assemblers.items()}
            mat = BlockMatrix(self.W_test, self.W_trial, blocks)
            if self.bcs:
                rows = np.unique(np.concatenate(
                    [bc.dof_indices for bc in self.bcs]))
                mat = mat.with_dirichlet(rows)
            mat.bcs = self.bcs
            if tensor is not None:
                tensor.blocks, tensor.bcs = mat.blocks, mat.bcs
                return tensor
            return mat
        outs = []
        for i, Vi in enumerate(self.W_test.subspaces):
            a = self.block_assemblers.get((i,))
            outs.append(torch.zeros(Vi.dim, dtype=torch.float64,
                                    device=get_device()) if a is None
                        else a.assemble().dat)
        out = torch.cat(outs)
        for bc in self.bcs:
            out = bc.zero(out) if self.zero_bc_nodes else bc.apply(out)
        f = tensor if tensor is not None else Cofunction(self.W_test)
        f.dat = out
        return f
