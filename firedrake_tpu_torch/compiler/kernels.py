"""Per-integral kernel construction (the TSFC compile_form analogue,
reference: tsfc compile_form).

Two kinds of kernel per integral: the cell-last batched kernel over all
cells at once (compiler/batched.py; K1 takes its family's forms,
compiler/cell_eval.py), and kernels over ONE entity's gathered inputs
(``cell_kernel``, ``exterior_facet_kernel``, ``interior_facet_kernel``),
which the gather route evaluates over all entities with
``torch.func.vmap``.  Interior-facet kernels see both cells: their local
tensors have doubled slots, the '+' cell's dofs then the '-' cell's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..language.core import Coefficient, ConstantBase
from ..language.measure import Integral
from .preprocess import push_grad, estimate_degree
from .lowering import (einsum, CellContext, ExteriorFacetContext,
                       InteriorFacetContext, Lowerer)


class CompiledIntegral:
    def __init__(self, integral: Integral, test, trial, mesh, ftype=None):
        self.integral_type = integral.integral_type
        # the facet class of a facet integral on cells with two (prisms:
        # the assembler compiles a triangle-facet and a quad-facet
        # integral, each with its own rule)
        self.ftype = ftype
        self.subdomain_id = integral.subdomain_id
        self.test = test
        self.trial = trial
        self.mesh = mesh
        integrand = push_grad(integral.integrand)
        self.integrand = integrand
        # participants, in deterministic order
        self.coefficients = tuple(sorted(
            {t.count: t for t in integrand.traverse()
             if isinstance(t, Coefficient)}.values(),
            key=lambda c: c.count))
        self.constants = tuple(sorted(
            {t.count: t for t in integrand.traverse()
             if isinstance(t, ConstantBase)}.values(),
            key=lambda c: c.count))
        cd = getattr(mesh, "_coord_degree", 1)  # coordinate degree
        md = integral.metadata or {}
        # explicit rule: dx(scheme=QuadratureRule(...)) replaces the
        # estimated Gauss rule
        self.qrule = md.get("quadrature_rule")
        deg = md.get("quadrature_degree")
        if deg is None or deg == "auto":
            deg = estimate_degree(integrand, cd)
            if mesh.cell.name in ("quadrilateral", "hexahedron", "prism"):
                deg += cd   # non-affine Jacobian factors
            if cd > 1:
                # curved cells: detJ is degree tdim*(cd-1), Jinv rational
                deg += mesh.topological_dimension * (cd - 1)
        self.degree = max(int(deg), 1)

    # ------------------------------------------------ per-entity kernels
    def _lower(self, ctx, coeffs, consts):
        low = Lowerer(ctx, self.test, self.trial, coeffs,
                      {c.count: v for c, v in zip(self.constants, consts)})
        v = low.run(self.integrand)                    # (ni', nj', nq)
        out = einsum("ijq,q->ij", v, ctx.scale())
        return torch.broadcast_to(out, self.local_shape())

    def cell_kernel(self):
        """fn(coords (ndofc, g), coeffs, consts) -> (ni, nj)."""
        def fn(coords_e, coeffs, consts):
            ctx = CellContext(self.mesh, self.degree, coords_e,
                              rule=self.qrule)
            return self._lower(ctx, dict(zip(
                (c.count for c in self.coefficients), coeffs)), consts)
        return fn

    def exterior_facet_kernel(self):
        """fn(coords, local facet, coeffs, consts) -> (ni, nj)."""
        def fn(coords_e, lf, coeffs, consts):
            ctx = ExteriorFacetContext(self.mesh, self.degree, coords_e, lf,
                                       ftype=self.ftype)
            return self._lower(ctx, dict(zip(
                (c.count for c in self.coefficients), coeffs)), consts)
        return fn

    def interior_facet_kernel(self):
        """fn(coords_p, coords_m, lf_p, lf_m, o_rel, coeffs_p, coeffs_m,
        consts) -> (2 ni, 2 nj); o_rel is the index of the relative vertex
        permutation of the facet as the '-' cell sees it."""
        def fn(coords_p, coords_m, lf_p, lf_m, o_rel, coeffs_p, coeffs_m,
               consts):
            ctx = InteriorFacetContext(self.mesh, self.degree, coords_p,
                                       coords_m, lf_p, lf_m, o_rel,
                                       ftype=self.ftype)
            cd = {c.count: {"+": wp, "-": wm} for c, wp, wm in
                  zip(self.coefficients, coeffs_p, coeffs_m)}
            return self._lower(ctx, cd, consts)
        return fn

    def kernel(self):
        return {
            "cell": self.cell_kernel,
            "exterior_facet": self.exterior_facet_kernel,
            "interior_facet": self.interior_facet_kernel,
        }[self.integral_type]()

    def cell_kernel_batched(self):
        """Cell-last kernel: coords (ndofc, g, C), coeffs (nslot, C) ->
        local tensors (ni, nj, C).  See compiler/batched.py."""
        from .batched import BatchedCellContext, BatchedLowerer
        mesh, deg = self.mesh, self.degree

        def fn(coords_T, coeffs_T, consts):
            ctx = BatchedCellContext(mesh, deg, coords_T,
                                     rule=self.qrule)
            low = BatchedLowerer(
                ctx, self.test, self.trial,
                {c.count: w for c, w in zip(self.coefficients, coeffs_T)},
                {c.count: v for c, v in zip(self.constants, consts)})
            v = low.run(self.integrand)                # (ni', nj', nq, C)
            out = einsum("ijqc,qc->ijc", v, ctx.scale())
            ni, nj = self.local_shape()
            C = max(coords_T.shape[-1], out.shape[-1])
            return torch.broadcast_to(out, (ni, nj, C))

        return fn

    def num_quad_points(self):
        """Cell-rule point count (sizes the (ni, nj, nq, C) batched
        intermediate; feeds the kernel-chunking memory bound)."""
        if self.qrule is not None:
            return len(np.asarray(self.qrule.points))
        from .lowering import _cell_rule
        return len(_cell_rule(self.mesh.cell.name, self.degree)[0])

    def local_shape(self):
        """(ni, nj) of the local tensor; interior facets double both."""
        double = 2 if self.integral_type == "interior_facet" else 1
        ni = nj = 1
        if self.test is not None:
            ni = self.test.space.element.ndof * double
        if self.trial is not None:
            nj = self.trial.space.element.ndof * double
        return ni, nj
