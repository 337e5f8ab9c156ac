"""FAS (full approximation scheme) nonlinear multigrid.

The port's copy of ``firedrake_tpu/solvers/fas.py`` (reference role:
PETSc SNESFAS composed through firedrake's level machinery, with the
residual form re-discretized per level by mg/ufl_utils.py coarsen).  The
nonlinearity is treated on every level, not only under an outer Newton.

A V-cycle on levels l = L..0 solves R_l(u) = b_l:

    pre-smooth:  damped nonlinear Jacobi  u += w * r / diag(J_l(u))
    tau:         v = inject(u);  b_c = R_{l-1}(v) + restrict(b_l - R_l(u))
    coarse:      w_c = cycle(l-1, start v, right-hand side b_c)
                 u += prolong(w_c - v)
    post-smooth.

The coarsest level runs Newton with a host sparse LU.  Dirichlet dofs
stay fixed (the states satisfy the condition and every update is
masked).  Every level residual and diagonal is one assembly; the cycle
is a host loop, like Newton.

Options (PETSc spellings): ``snes_type`` "fas" (levels from the mesh's
MeshHierarchy) or "pfas" / ``snes_python_type`` ending in PMGSNES
(degree levels on one mesh, mg/pmg.py); ``fas_levels_max_it`` (smoothing
sweeps per leg, default 3), ``fas_levels_damping`` (default 2/3),
``fas_coarse_snes_max_it`` / ``fas_coarse_snes_rtol``, and ``snes_rtol``
/ ``snes_atol`` / ``snes_max_it`` for the outer cycles.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor
from ..functionspace import FunctionSpace
from ..mg.vcycle import coarsen_form
from ..mg.transfer import get_transfer

__all__ = ["FASSolver"]


def _norm(x):
    return float(torch.linalg.vector_norm(x))


class FASSolver:
    """Nonlinear multigrid for F(u; v) == 0.

    mode "h": the levels are a MeshHierarchy (PETSc SNESFAS).  mode "p":
    degree-coarsened spaces on the same mesh (the reference PMGSNES),
    with PLevelTransfer's prolong/restrict/inject; the level forms swap
    their argument and solution spaces only."""

    def __init__(self, F, u, bcs=(), params=None, mode="h"):
        from ..function import Function
        from ..language.calculus import derivative, replace
        from ..bcs import DirichletBC
        from ..assemble import get_assembler
        from ..solving import _bc_data

        params = dict(params or {})
        self.params = params
        V = u.function_space()
        mesh = V.mesh_obj
        self.u = u
        if mode == "p":
            from ..mg.pmg import (PLevelTransfer, _coarsen_degree_form,
                                  degree_spaces)
            if V.scalar_element.degree < 2:
                raise ValueError("snes_type 'pfas' needs degree >= 2")
            spaces = degree_spaces(V, family=V.scalar_element.family)
            self.us = [Function(Vl, name=f"pfas_u{i}")
                       for i, Vl in enumerate(spaces[:-1])] + [u]
            forms = [replace(_coarsen_degree_form(
                F, lambda _V, Vl=Vl: Vl), {u: ul})
                for Vl, ul in zip(spaces[:-1], self.us)] + [F]
            self.transfers = [PLevelTransfer(spaces[i], spaces[i + 1])
                              for i in range(len(spaces) - 1)]
        else:
            hierarchy = getattr(mesh, "_mg_hierarchy", None)
            if hierarchy is None:
                raise ValueError("snes_type 'fas' needs a mesh from "
                                 "MeshHierarchy")
            meshes = hierarchy.meshes[:mesh._mg_level + 1]
            spaces = [FunctionSpace(m, V.element)
                      for m in meshes[:-1]] + [V]
            self.us = [Function(Vl, name=f"fas_u{i}")
                       for i, Vl in enumerate(spaces[:-1])] + [u]
            # level residual forms: the solution coefficient stays live
            # (mapped to the level's state), the others are injected
            forms = [F]
            for i in range(len(meshes) - 2, -1, -1):
                forms.insert(0, coarsen_form(
                    forms[0], meshes[i + 1], meshes[i],
                    lambda Vf, i=i: spaces[i],
                    replace={self.us[i + 1]: self.us[i]}))
            self.transfers = [get_transfer(spaces[i], spaces[i + 1])
                              for i in range(len(spaces) - 1)]
        self.spaces = spaces
        self.res_asms = [get_assembler(f) for f in forms]
        self.jacs = [derivative(f, ul) for f, ul in zip(forms, self.us)]
        self.jac_asms = [get_assembler(J) for J in self.jacs]

        # bc masks per level; the fine level's bc values
        self.masks, self.bc_idx = [], []
        for i, Vl in enumerate(spaces):
            lb = [DirichletBC(Vl, b.g if i == len(spaces) - 1 else 0.0,
                              b.sub_domain, b.sub_component)
                  for b in (bcs or ())]
            idx, _ = _bc_data(lb, Vl.dim)
            m = np.ones(Vl.dim)
            m[idx] = 0.0
            self.masks.append(as_tensor(m))
            self.bc_idx.append(np.asarray(idx, dtype=np.int64))
        self.g_fine = as_tensor(_bc_data(list(bcs or ()), V.dim)[1])

        self.nlevels = len(spaces)
        self.smooth_its = int(params.get("fas_levels_max_it", 3))
        self.damping = float(params.get("fas_levels_damping", 2.0 / 3))
        self.coarse_max_it = int(params.get("fas_coarse_snes_max_it", 30))
        self.coarse_rtol = float(params.get("fas_coarse_snes_rtol", 1e-12))

    # --------------------------------------------------------- pieces
    def _R(self, l, uvec):
        """Level l's residual at the state uvec."""
        self.us[l].dat = uvec
        return as_tensor(self.res_asms[l].assemble().dat)

    def _diag(self, l, uvec):
        self.us[l].dat = uvec
        return self.jac_asms[l].assemble_diagonal()

    def _smooth(self, l, uvec, b):
        m = self.masks[l]
        for _ in range(self.smooth_its):
            r = (b - self._R(l, uvec)) * m
            d = self._diag(l, uvec)
            dinv = torch.where(torch.abs(d) > 0, 1.0 / d, torch.ones_like(d))
            uvec = uvec + self.damping * dinv * r
        return uvec

    def _coarse_newton(self, uvec, b):
        """Newton with a host sparse LU on the coarsest level."""
        from ..assemble import assemble
        from ..solving import direct_solve
        m = self.masks[0]
        r = (b - self._R(0, uvec)) * m
        r0 = _norm(r)
        for _ in range(self.coarse_max_it):
            if _norm(r) <= max(self.coarse_rtol * max(r0, 1e-30), 1e-14):
                break
            self.us[0].dat = uvec
            J = assemble(self.jacs[0])
            if len(self.bc_idx[0]):
                J = J.with_dirichlet(self.bc_idx[0])
            uvec = uvec + direct_solve(J, r) * m
            r = (b - self._R(0, uvec)) * m
        return uvec

    def _cycle(self, l, uvec, b):
        if l == 0:
            return self._coarse_newton(uvec, b)
        m = self.masks[l]
        uvec = self._smooth(l, uvec, b)
        r = (b - self._R(l, uvec)) * m
        t = self.transfers[l - 1]
        v = t.inject_fn(uvec)
        bc = self._R(l - 1, v) + t.restrict_fn(r) * self.masks[l - 1]
        w = self._cycle(l - 1, v, bc)
        uvec = uvec + t.prolong_fn(w - v) * m
        return self._smooth(l, uvec, b)

    # --------------------------------------------------------- public
    def solve(self):
        params = self.params
        rtol = float(params.get("snes_rtol", 1e-8))
        atol = float(params.get("snes_atol", 1e-50))
        max_it = int(params.get("snes_max_it", 50))
        L = self.nlevels - 1
        uvec = as_tensor(self.u.dat)
        if len(self.bc_idx[L]):
            idx = as_tensor(self.bc_idx[L])
            uvec = uvec.index_put((idx,), self.g_fine[idx])
        zero = torch.zeros_like(uvec)
        r = -self._R(L, uvec) * self.masks[L]
        r0 = _norm(r)
        self.iterations = 0
        self.converged = r0 == 0.0
        for it in range(max_it):
            if _norm(r) <= max(rtol * max(r0, 1e-30), atol):
                self.converged = True
                break
            uvec = self._cycle(L, uvec, zero)
            r = -self._R(L, uvec) * self.masks[L]
            self.iterations = it + 1
        else:
            self.converged = _norm(r) <= max(rtol * max(r0, 1e-30), atol)
        self.u.dat = uvec
        return self.u
