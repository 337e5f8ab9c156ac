"""Geometric multigrid V-cycle preconditioner.

Reference: PETSc PCMG composed through dmhooks + firedrake/mg/ufl_utils.py
`coarsen` (re-discretization on each level).  The bilinear form is
re-built symbolically on every hierarchy level and assembled through the
stencil path; the V-cycle (smoothers from the options tree, structured
transfers, coarse solve) is a callable on device tensors, usable as `pc`
in any Krylov loop.  Levels at or above ``mg_matfree_threshold`` dofs
(default 4e6) are matrix-free (assembly/matfree.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..functionspace import FunctionSpace
from ..language.core import Argument, Coefficient, GeometricQuantity
from ..language.calculus import map_expr
from ..language.measure import Form
from ..device import as_tensor
from .transfer import get_transfer


def coarsen_form(form: Form, fine_mesh, coarse_mesh, space_map,
                 replace=None):
    """Re-discretize a form on a coarser level (reference:
    firedrake/mg/ufl_utils.py coarsen).  Function coefficients are
    transferred by injection; `replace` pre-seeds the node mapping for
    coefficients that must stay live on the coarse level."""
    from ..function import Function
    mapping = dict(replace or {})
    for it in form.integrals():
        for t in it.integrand.traverse():
            if isinstance(t, Argument):
                mapping[t] = Argument(space_map(t.space), t.number, t.part)
            elif isinstance(t, GeometricQuantity) and t.mesh is fine_mesh:
                mapping[t] = type(t)(coarse_mesh)
            elif isinstance(t, Coefficient) and t not in mapping:
                if not isinstance(t, Function):
                    raise NotImplementedError(
                        "cannot coarsen this coefficient type")
                Vf = t.function_space()
                Vc = FunctionSpace(coarse_mesh, Vf.element)
                fc = Function(Vc, name=f"{t.name}_coarse")
                fc.dat = get_transfer(Vc, Vf).inject_fn(as_tensor(t.dat))
                mapping[t] = fc
    out = []
    for it in form.integrals():
        ni = it.reconstruct(map_expr(it.integrand, mapping))
        ni.domain = coarse_mesh if it.domain is not None else None
        out.append(ni)
    return Form(tuple(out))


class GMGPreconditioner:
    """V(nu,nu)-cycle over re-discretized level operators.

    Options-tree composition (PETSc PCMG semantics): per-level smoothers
    configured by `<prefix>mg_levels_ksp_type` (default chebyshev,
    max_it 2) + `<prefix>mg_levels_pc_type` (default jacobi; patch
    allowed), overridable per level by `<prefix>mg_levels_<i>_*`, and the
    coarse solve by `<prefix>mg_coarse_*` (default preonly+lu)."""

    def __init__(self, a_fine: Form, bcs, fine_space: FunctionSpace,
                 smooth_its=2, params=None, prefix="", appctx=None):
        from ..assemble import assemble
        from ..assembly.matfree import MatrixFreeOperator
        from ..bcs import DirichletBC
        from ..solvers.composition import OpCtx, build_ksp
        mesh = fine_space.mesh_obj
        hierarchy = getattr(mesh, "_mg_hierarchy", None)
        if hierarchy is None:
            raise ValueError("pc_type 'mg' needs a mesh from MeshHierarchy")
        meshes = hierarchy.meshes[:mesh._mg_level + 1]
        elem = fine_space.element
        spaces = [FunctionSpace(m, elem) for m in meshes[:-1]] \
            + [fine_space]

        params = dict(params or {})
        # smoother defaults (PETSc mg_levels: chebyshev(2)+jacobi, no
        # convergence test -> rtol 0 runs exactly max_it iterations)
        params.setdefault(prefix + "mg_levels_ksp_type", "chebyshev")
        params.setdefault(prefix + "mg_levels_ksp_max_it", smooth_its)
        params.setdefault(prefix + "mg_levels_ksp_rtol", 0.0)
        params.setdefault(prefix + "mg_levels_pc_type", "jacobi")
        params.setdefault(prefix + "mg_coarse_ksp_type", "preonly")
        params.setdefault(prefix + "mg_coarse_pc_type", "lu")
        # matrix-free levels: at or above this size a level operator is an
        # action-assembly MatrixFreeOperator instead of channel planes (a
        # 17M-dof P2-tet StencilMatrix would hold ~65 planes);
        # `mg_fine_mat_type: matfree` forces it on the finest level
        threshold = float(params.get(prefix + "mg_matfree_threshold", 4e6))
        force_fine = params.get(prefix + "mg_fine_mat_type") == "matfree"

        forms = [a_fine]
        for i in range(len(meshes) - 2, -1, -1):
            forms.insert(0, coarsen_form(
                forms[0], meshes[i + 1], meshes[i],
                lambda Vf, i=i: spaces[i]))
        level_bcs = [[DirichletBC(V, 0.0, bc.sub_domain, bc.sub_component)
                      for bc in (bcs or ())] for V in spaces]

        self.levels = []
        for i, (V, f, lb) in enumerate(zip(spaces, forms, level_bcs)):
            rows = (np.unique(np.concatenate([b.dof_indices for b in lb]))
                    if lb else np.zeros(0, dtype=np.int64))
            if V.dim >= threshold or (force_fine and i == len(spaces) - 1):
                A = MatrixFreeOperator(f)
                if lb:
                    A = A.with_dirichlet(rows)
            else:
                A = assemble(f, bcs=lb)
            mask = np.ones(V.dim)
            mask[rows] = 0.0
            lv = dict(V=V, A=A, mask=as_tensor(mask))
            if i > 0:
                ctx = OpCtx(mat=A, space=V, form=f, bcs=lb, appctx=appctx)
                # per-level override mg_levels_<i>_* falls back to
                # mg_levels_* (PETSc semantics)
                lvl_prefix = prefix + f"mg_levels_{i}_"
                use = prefix + "mg_levels_"
                if any(k.startswith(lvl_prefix) for k in params):
                    use = lvl_prefix
                    for k in ("ksp_type", "ksp_max_it", "ksp_rtol",
                              "pc_type"):
                        params.setdefault(lvl_prefix + k,
                                          params[prefix + "mg_levels_" + k])
                lv["smooth"] = build_ksp(ctx, params, use)
            self.levels.append(lv)
        ctx0 = OpCtx(mat=self.levels[0]["A"], space=spaces[0],
                     form=forms[0], bcs=level_bcs[0], appctx=appctx)
        self.coarse_solve = build_ksp(ctx0, params, prefix + "mg_coarse_")
        self.transfers = [get_transfer(spaces[i], spaces[i + 1])
                          for i in range(len(spaces) - 1)]
        self.nlevels = len(spaces)

    def _cycle(self, level, b):
        lv = self.levels[level]
        if level == 0:
            return self.coarse_solve(b)
        x = lv["smooth"](b, x0=torch.zeros_like(b))
        r = (b - lv["A"].matvec(x)) * lv["mask"]
        t = self.transfers[level - 1]
        rc = t.restrict_fn(r) * self.levels[level - 1]["mask"]
        xc = self._cycle(level - 1, rc)
        x = x + t.prolong_fn(xc) * lv["mask"]
        return lv["smooth"](b, x0=x)

    def __call__(self, r):
        return self._cycle(self.nlevels - 1, r)
