"""SNES-level python types (reference: preconditioners/base.py:217
SNESBase and its subclasses).

AuxiliaryOperatorSNES (reference: preconditioners/auxiliary_snes.py:12)
solves F(u) = 0 by the nonlinear Richardson iteration preconditioned
with a user-supplied auxiliary form G:

    G(u_{k+1}; u_k) = G(u_k; u_k) - F(u_k)

For a (bi)linear auxiliary G(u) = A u, the common case, which the
reference notes reduces to an inexact Newton method, each step is
    u_{k+1} = u_k - damping * A^{-1} F(u_k),
with the A-solve configured under the ``aux_`` options prefix.

Usage (PETSc spellings):
    solver_parameters = {
        "snes_type": "python",
        "snes_python_type": "mymodule.MyAuxSNES",   # subclass below
        "snes_rtol": 1e-8,
        "aux_ksp_type": "preonly", "aux_pc_type": "lu",
    }
with MyAuxSNES implementing form(self, snes, test, trial) -> (G, bcs).
"""
from __future__ import annotations

import torch

from ..device import as_tensor


class AuxiliaryOperatorSNES:
    """Subclass and implement form(self, snes, test, trial)->(a, bcs)."""

    _prefix = "aux_"

    def form(self, snes, test, trial):
        raise NotImplementedError(
            "subclass AuxiliaryOperatorSNES and implement form()")

    # ------------------------------------------------------------- solve
    def solve(self, problem, params, appctx=None):
        from ..assemble import assemble, get_assembler
        from ..language.core import Argument
        from ..solving import _bc_data
        from .composition import OpCtx, build_ksp

        p = problem
        self.appctx = dict(appctx or {})
        V = p.u.function_space()
        test, trial = Argument(V, 0), Argument(V, 1)
        G, gbcs = self.form(self, test, trial)
        bcs = list(p.bcs or ())
        bc_idx, g = _bc_data(bcs, V.dim)
        A = assemble(G, bcs=list(gbcs) if gbcs else None)
        if len(bc_idx):
            A = A.with_dirichlet(bc_idx)
        pre = self._prefix
        ps = dict(params)
        ps.setdefault(pre + "ksp_type", "preonly")
        ps.setdefault(pre + "pc_type", "lu")
        ictx = OpCtx(mat=A, space=V, form=G, bcs=bcs, appctx=self.appctx)
        ainv = build_ksp(ictx, ps, pre)

        res_asm = get_assembler(p.F)
        rtol = float(params.get("snes_rtol", 1e-8))
        atol = float(params.get("snes_atol", 1e-50))
        max_it = int(params.get("snes_max_it", 50))
        damping = float(params.get("snes_linesearch_damping", 1.0))

        idx = as_tensor(bc_idx.astype("int64"))
        mask = torch.ones(V.dim, dtype=torch.float64, device=idx.device)
        mask[idx] = 0.0
        u = as_tensor(p.u.dat)
        if len(bc_idx):
            u = u.index_put((idx,), as_tensor(g)[idx])

        def residual(uv):
            p.u.dat = uv
            return as_tensor(res_asm.assemble().dat) * mask

        r = residual(u)
        r0 = float(torch.linalg.vector_norm(r))
        self.iterations = 0
        self.converged = r0 == 0.0
        for it in range(max_it):
            if float(torch.linalg.vector_norm(r)) <= max(
                    rtol * max(r0, 1e-300), atol):
                self.converged = True
                break
            u = u - damping * ainv(r) * mask
            r = residual(u)
            self.iterations = it + 1
        p.u.dat = u
        return self.iterations


def resolve_snes_python(name):
    """Resolve snes_python_type to a class: a name defined here, or a
    dotted module path."""
    import importlib
    short = name.rsplit(".", 1)[-1]
    if short in globals():
        return globals()[short]
    try:
        mod, cls = name.rsplit(".", 1)
        return getattr(importlib.import_module(mod), cls)
    except Exception as e:
        raise ImportError(
            f"cannot resolve snes_python_type {name!r}: {e}") from e
