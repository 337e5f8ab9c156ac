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

Still raising NotImplementedError, each naming its ROADMAP.md queue 1
item: mixed spaces and H(div)/H(curl) spaces with dof signs or
transforms and the sum-factorised Q_k plan (item 14), extruded meshes and
prism facets (item 15), complex scalars (item 17), vertex-only meshes
(item 18).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .language.measure import Form
from .language.core import Argument, ScalarValue
from .compiler.kernels import CompiledIntegral
from .compiler.precision import (kernel_dtype, trace_ctx, castf,
                                 castf_map, widen)
from .compiler.cell_eval import run_cell_kernel
from .assembly.sparsity import Sparsity
from .assembly.matrix import Matrix
from .function import Cofunction
from .bcs import as_bcs
from .device import as_tensor, get_device

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


def _orientation_index(pos):
    """Index, in itertools.permutations order, of each row of ``pos``
    (n, nfv), a permutation of range(nfv)."""
    import itertools
    nfv = pos.shape[1]
    weights = nfv ** np.arange(nfv)
    lookup = np.full(nfv ** nfv, -1, dtype=np.int32)
    for i, p in enumerate(itertools.permutations(range(nfv))):
        lookup[np.dot(p, weights)] = i
    return lookup[pos @ weights]


def _spectral_applies(ci, test, trial):
    """Whether the JAX package would evaluate this integral with its
    sum-factorised plan (compiler/spectral.py build_spectral_plan): cell
    integrals on quads/hexes with scalar Lagrange arguments of degree >= 2
    (any degree under FDTPU_SPECTRAL=1)."""
    flag = os.environ.get("FDTPU_SPECTRAL")
    if flag == "0" or ci.integral_type != "cell" or ci.qrule is not None \
            or test is None \
            or ci.mesh.cell.name not in ("quadrilateral", "hexahedron"):
        return False
    spaces = [a.space for a in (test, trial) if a is not None]
    if not all(tuple(s.value_shape) == () and s.block_size == 1
               and "Lagrange" in getattr(s.element, "family", "")
               for s in spaces):
        return False
    return flag == "1" or max(s.element.degree for s in spaces) >= 2


def _check_space(space, what):
    if getattr(space, "has_dof_signs", False) or \
            getattr(space, "has_dof_transforms", False):
        raise NotImplementedError(
            f"{what} on a space with dof signs or transforms (H(div), "
            "H(curl)) is not ported yet: ROADMAP.md queue 1, item 14")


class _Tables:
    """Gather-table accumulation: out[r] = sum_j flat[tbl[j, r]] with the
    padding slot len(flat) reading 0, split into a dense base table of NB
    columns and a spill table over the rows that have more contributions
    (the JAX package's _build_acc_table).  Deterministic: every entry is
    summed in the same order on every run and device."""

    def __init__(self, tbl, tblx, rows_x):
        self.tbl, self.tblx, self.rows_x = tbl, tblx, rows_x

    def __call__(self, flat):
        flat = torch.cat([flat, flat.new_zeros(1)])
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
        if getattr(self.mesh, "_extruded", False):
            raise NotImplementedError(
                "assembly on extruded meshes (the column plan) is not "
                "ported yet: ROADMAP.md queue 1, item 15")
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
        self._compiled = [CompiledIntegral(it, self.test, self.trial,
                                           self.mesh)
                          for it in form.integrals()]
        self._stencil = None
        if use_stencil and self.rank in (1, 2):
            from .assembly.stencil import build_stencil_plan
            self._stencil = build_stencil_plan(self)
        if self._stencil is None:
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
        for a in (self.test, self.trial):
            if a is not None:
                _check_space(a.space, "assembly")
        for c in ci.coefficients:
            _check_space(c.space, "assembly of a coefficient")
        if _spectral_applies(ci, self.test, self.trial):
            raise NotImplementedError(
                "the sum-factorised Q_k plan (compiler/spectral.py) is not "
                "ported yet: ROADMAP.md queue 1, item 14")
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
            over the cells of each list."""
            return [None if a is None else np.hstack(
                [a.space.cell_dof_map[c] for c in cells_list])
                for a in (self.test, self.trial)]

        st = {"cell_last": ci.integral_type == "cell"}
        if ci.integral_type == "cell":
            cells = mesh.cell_subset(ci.subdomain_id)
            if len(cells) == 0:
                return None
            # cell-last gathers: (ndofc, g, C) coordinates, (nslot, C)
            # coefficient values, the inputs of K1 and the lowerer
            st["coords_map"] = idx(cmap3[cells].transpose(1, 2, 0))
            st["coeff_maps"] = maps(cells, T=True)
            st["rows"], st["cols"] = arg_maps([cells])
            st["n"] = len(cells)
        elif ci.integral_type == "exterior_facet":
            facets = mesh.boundary_facets(ci.subdomain_id)
            if len(facets) == 0:
                return None
            cells = topo.facet_cells[facets, 0]
            st["coords_map"] = idx(cmap3[cells])
            st["lf"] = idx(topo.facet_local_id[facets, 0])
            st["coeff_maps"] = maps(cells)
            st["rows"], st["cols"] = arg_maps([cells])
            st["n"] = len(facets)
        else:
            facets = topo.interior_facets
            if ci.subdomain_id not in ("everywhere", None):
                # dS(id): marked interior facets; UNMARKED (-1, the
                # reference's label for untagged facets) selects 0
                sd = ci.subdomain_id
                if isinstance(sd, (int, np.integer)):
                    sd = (int(sd),)
                sd = tuple(0 if s == -1 else s for s in sd)
                facets = facets[np.isin(mesh.facet_markers[facets],
                                        np.asarray(sd))]
            if len(facets) == 0:
                return None
            cp = topo.facet_cells[facets, 0]
            cm = topo.facet_cells[facets, 1]
            lfp = topo.facet_local_id[facets, 0]
            lfm = topo.facet_local_id[facets, 1]
            # relative orientation of the minus side: position of each
            # minus-cell facet vertex in the plus cell's vertex list
            vp = topo.cell_vertices[cp[:, None], mesh.cell.facets[lfp]]
            vm = topo.cell_vertices[cm[:, None], mesh.cell.facets[lfm]]
            o_rel = _orientation_index(
                np.argmax(vm[:, :, None] == vp[:, None, :], axis=2))
            st["coords_map_p"] = idx(cmap3[cp])
            st["coords_map_m"] = idx(cmap3[cm])
            st["lf_p"], st["lf_m"] = idx(lfp), idx(lfm)
            st["o_rel"] = idx(o_rel)
            st["coeff_maps_p"] = maps(cp)
            st["coeff_maps_m"] = maps(cm)
            # doubled slots: the '+' cell's dofs, then the '-' cell's
            st["rows"], st["cols"] = arg_maps([cp, cm])
            st["n"] = len(facets)
        return st

    def _local_values(self, ci, st, coords_dat, coeff_dats, consts):
        """Element tensors of one integral: (ni, nj, C) for cell
        integrals (cell-last), (n, ni, nj) for facet integrals."""
        prec = self._prec
        if ci.integral_type == "cell":
            ce = coords_dat[st["coords_map"]]           # (ndofc, g, C)
            ws = tuple(coeff_dats[c.count][st["coeff_maps"][c.count]]
                       for c in ci.coefficients)        # (nslot, C)
            with trace_ctx(prec):
                return run_cell_kernel(
                    ci, ce, ws, consts,
                    chunk=_kernel_chunk(ci, st["n"], ce.element_size()))
        kern = ci.kernel()
        nco = len(ci.coefficients)
        if ci.integral_type == "exterior_facet":
            args = (coords_dat[st["coords_map"]], st["lf"]) + tuple(
                coeff_dats[c.count][st["coeff_maps"][c.count]]
                for c in ci.coefficients)

            def fn(c, lf, *w):
                return kern(c, lf, w, consts)
        else:
            args = (coords_dat[st["coords_map_p"]],
                    coords_dat[st["coords_map_m"]], st["lf_p"],
                    st["lf_m"], st["o_rel"]) + tuple(
                coeff_dats[c.count][st[f"coeff_maps_{s}"][c.count]]
                for s in "pm" for c in ci.coefficients)

            def fn(cp, cm, lp, lm, o, *w):
                return kern(cp, cm, lp, lm, o, w[:nco], w[nco:], consts)
        with trace_ctx(prec):
            return _vmapped(fn, args, _kernel_chunk(
                ci, st["n"], args[0].element_size()))

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
        run = self._run if self._stencil is None else self._run_stencil
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
    the kernel precision, the route switch, the gather accumulation and
    the device.  Every cache of assemblers keys on it."""
    return (os.environ.get("FDTPU_PREC", ""),
            os.environ.get("FDTPU_NO_STENCIL", ""),
            os.environ.get("FDTPU_GATHER_ACC", ""), str(get_device()))


def get_assembler(form: Form, bcs=None, mat_type="aij",
                  zero_bc_nodes=False) -> FormAssembler:
    bcs = as_bcs(bcs)
    if any(isinstance(t, Argument) and t.part is not None
           for it in form.integrals() for t in it.integrand.traverse()):
        raise NotImplementedError("mixed-space assembly is not ported yet: "
                                  "ROADMAP.md queue 1, item 14")
    # constants key the cache alongside coefficients: signature()
    # renumbers Constant terminals structurally, and the assembler binds
    # its form's Constant objects (values read at call time by count)
    key = (form.signature(), id(form.mesh()), _bc_key(bcs), mat_type,
           zero_bc_nodes, build_key(),
           tuple(id(c) for c in form.coefficients()),
           tuple(c.count for c in form.constants()))
    if key not in _assembler_cache:
        _assembler_cache[key] = FormAssembler(form, bcs, mat_type,
                                              zero_bc_nodes)
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
        test = [a for a in form.arguments() if a.number == 0][0]
        out = Cofunction(test.space)
        out.dat = d
        return out
    return assembler.assemble(tensor=tensor)
