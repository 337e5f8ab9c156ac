"""assemble(): form -> vector / operator, the stencil route.

Reference role: firedrake/assemble.py:48 assemble / :154 get_assembler
and the PyOP2 parloop machinery.  On structured meshes (UnitSquareMesh,
UnitCubeMesh, ...) the coordinates and coefficients are read as strided
slices of the dof grid, the element tensors come from K1 or the torch
BatchedLowerer (compiler/cell_eval.py), and accumulation is strided
slice-adds into channel planes (assembly/stencil.py).

Not ported yet: the gather route that serves unstructured meshes and
facet integrals, and 0-forms.  Both raise NotImplementedError.
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
from .function import Cofunction
from .bcs import as_bcs
from .device import as_tensor

__all__ = ["assemble", "FormAssembler", "get_assembler"]

_GATHER_ROUTE = ("the gather route (unstructured meshes, facet integrals, "
                 "0-forms) is not ported yet: ROADMAP.md queue 1, slice 4")

_assembler_cache: dict = {}


def _kernel_chunk(ci, ce):
    """Cell-axis chunk size bounding the batched kernel's live
    (ni, nj, nq, chunk) quadrature intermediate to FDTPU_KERNEL_BYTES
    (default 1 GiB).  None = no chunking."""
    C = ce.shape[-1]
    ni, nj = ci.local_shape()
    per_cell = max(ni * nj * ci.num_quad_points(), 1) * ce.element_size()
    budget = float(os.environ.get("FDTPU_KERNEL_BYTES", 2 ** 30))
    chunk = int(budget / per_cell)
    if chunk >= C:
        return None
    return max(chunk, 1024)


def _is_complex(form):
    for c in form.coefficients():
        if torch.is_tensor(c.dat) and c.dat.is_complex():
            return True
    for c in form.constants():
        if np.iscomplexobj(c.values()):
            return True
    return any(isinstance(t, ScalarValue) and isinstance(t.value, complex)
               for it in form.integrals() for t in it.integrand.traverse())


class FormAssembler:
    """Static slice plan + device evaluation for one form (reference
    analogue: ParloopFormAssembler, assemble.py:1019)."""

    def __init__(self, form: Form, bcs=(), mat_type="aij",
                 zero_bc_nodes=False):
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
        self.coefficients = form.coefficients()
        self.constants = form.constants()
        # mixed-precision kernel execution (compiler/precision.py), read
        # once at build as in the JAX package
        self._prec = kernel_dtype()
        if _is_complex(form):
            raise NotImplementedError("complex scalar assembly is not "
                                      "ported yet")
        self._compiled = [CompiledIntegral(it, self.test, self.trial,
                                           self.mesh)
                          for it in form.integrals()]
        self._stencil = None
        if self.rank in (1, 2):
            from .assembly.stencil import build_stencil_plan
            self._stencil = build_stencil_plan(self)
        if self._stencil is None:
            raise NotImplementedError(_GATHER_ROUTE)

    def _inputs(self):
        coords = self.mesh.device_coordinates()
        coeffs = {c.count: as_tensor(c.dat) for c in self.coefficients}
        consts = {c.count: as_tensor(c.values()) for c in self.constants}
        return coords, coeffs, consts

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
                    lt = run_cell_kernel(ci, ce, ws, consts,
                                         chunk=_kernel_chunk(ci, ce))
                loc = lt if loc is None else loc + lt
            if prec is not None:
                loc = widen(loc)              # f64 accumulation
            out = acc(out, t, loc)
        return out

    def assemble_diagonal(self):
        """diag(A) of a rank-2 form without materializing the operator:
        only the zero-offset channel is accumulated."""
        assert self.rank == 2, "assemble_diagonal needs a bilinear form"
        return self._run_stencil(*self._inputs(), diag_only=True)

    # ------------------------------------------------------------- public
    def assemble(self, tensor=None):
        return self._postprocess(self._run_stencil(*self._inputs()),
                                 tensor)

    def _postprocess(self, out, tensor):
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
        from .assembly.stencil import StencilMatrix
        mat = StencilMatrix(self._stencil, out, self.test.space,
                            self.trial.space, self.bcs)
        if self.bcs:
            rows = np.unique(np.concatenate(
                [bc.dof_indices for bc in self.bcs]))
            mat = mat.with_dirichlet(rows)
        return mat


def _bc_key(bcs):
    return tuple((id(bc.function_space_obj), str(bc.sub_domain),
                  bc.sub_component) for bc in bcs)


def get_assembler(form: Form, bcs=None, mat_type="aij",
                  zero_bc_nodes=False) -> FormAssembler:
    bcs = as_bcs(bcs)
    if any(isinstance(t, Argument) and t.part is not None
           for it in form.integrals() for t in it.integrand.traverse()):
        raise NotImplementedError("mixed-space assembly is not ported yet")
    # constants key the cache alongside coefficients: signature()
    # renumbers Constant terminals structurally, and the assembler binds
    # its form's Constant objects (values read at call time by count)
    key = (form.signature(), id(form.mesh()), _bc_key(bcs), mat_type,
           zero_bc_nodes, os.environ.get("FDTPU_PREC", ""),
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
    """Assemble a 1- or 2-form (reference: firedrake/assemble.py:48).
    ``diagonal=True`` on a bilinear form returns the matrix diagonal as a
    Cofunction without materializing the matrix."""
    if isinstance(form, (int, float)):
        return float(form)
    if not isinstance(form, Form):
        raise TypeError(f"cannot assemble {type(form)}")
    if form.empty():
        return 0.0
    if len(form.arguments()) == 0:
        raise NotImplementedError(_GATHER_ROUTE)
    assembler = get_assembler(form, bcs, mat_type, zero_bc_nodes)
    if diagonal:
        d = assembler.assemble_diagonal()
        test = [a for a in form.arguments() if a.number == 0][0]
        out = Cofunction(test.space)
        out.dat = d
        return out
    return assembler.assemble(tensor=tensor)
