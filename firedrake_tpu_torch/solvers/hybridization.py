"""HybridizationPC: solve a conforming H(div) x DG mixed system by
hybridization + static condensation onto facet trace multipliers (the
port's copy of ``firedrake_tpu/solvers/hybridization.py``).

Reference: firedrake/slate/static_condensation/hybridization.py
(HybridizationPC.initialize :62 builds the broken space, trace space and
Schur complement via Slate; :310 back-substitutes the eliminated fields).

Every step is batched per-cell dense algebra (Slate, slate.py) driving one
small global trace solve:
  [[A, K^T], [K, 0]] [x, lam] = [F, 0]
  S = K A^{-1} K^T,  E = K A^{-1} F       (per-cell condensation)
  solve S lam = E                          (global, trace dofs only)
  x = A^{-1} (F - K^T lam)                 (per-cell back-substitution)
The per-cell inverses and solves are K2 (ops/batched_inverse.py).  The
broken flux goes back to the conforming space on the device, its shared
dofs averaged through a gather table in a fixed order (the JAX package
does this on the host with np.add.at).
"""
from __future__ import annotations

import numpy as np
import torch

from ..functionspace import FunctionSpace
from ..mixed import MixedFunctionSpace
from ..language.core import Argument, FacetNormal
from ..language.operators import jump
from ..language.tensor_algebra import dot, inner
from ..language.measure import Form, dS, ds
from ..language.calculus import map_expr
from ..function import Function
from ..slate import Tensor, AssembledVector, assemble_slate
from ..elements.trace import BrokenElement


def _broken_problem(a, L, W):
    """Rebuild (a, L) with the flux argument/unknown living in the broken
    space; returns (a_b, L_b, Wd, T)."""
    mesh = W.mesh_obj
    Sigma, U = W.subspaces
    elem = Sigma.element
    fam = getattr(elem, "family", "")
    if fam in ("Raviart-Thomas", "RT"):
        tdeg = elem.degree - 1       # RT_k normal trace is P_{k-1}
    elif fam in ("Brezzi-Douglas-Marini", "BDM"):
        tdeg = elem.degree           # BDM_k normal trace is P_k
    else:
        raise NotImplementedError(
            f"HybridizationPC: flux family {fam!r} (RT/BDM)")
    Sb = FunctionSpace(mesh, BrokenElement(elem))
    T = FunctionSpace(mesh, "HDiv Trace", tdeg)
    Wd = MixedFunctionSpace([Sb, U])

    mapping = {}
    for form in (a, L):
        if form is None:
            continue
        for arg in form.arguments():
            mapping[arg] = Argument(Wd.sub(arg.part), arg.number,
                                    part=arg.part)

    def rebuild(form):
        if form is None:
            return None
        return Form(tuple(it.reconstruct(map_expr(it.integrand, mapping))
                          for it in form.integrals()))

    return rebuild(a), rebuild(L), Wd, T


def _trace_coupling(Wd, T, mesh):
    """K: <gammar, [[sigma . n]]> over dS plus the boundary term over ds
    (test = trace, trial = broken flux in the full broken mixed axis)."""
    gammar = Argument(T, 0)
    sigma_t = Argument(Wd.sub(0), 1, part=0)
    n = FacetNormal(mesh)
    return (inner(gammar("+"), jump(sigma_t, n)) * dS
            + inner(gammar, dot(sigma_t, n)) * ds)


def _broken_to_conforming(Sigma, Sb, sigma_dat):
    """Broken flux -> conforming H(div), on the device: per-cell copy
    back to the canonical dof convention (normal continuity holds by
    construction; the cells sharing a dof are averaged, in a fixed order,
    to even out round-off).  Broken dofs are raw LOCAL reference dofs;
    the conforming space stores CANONICAL dofs with local = B @
    canonical, so invert diagonal signs or the matrix entity
    transforms."""
    from ..assemble import _accumulation
    dev = sigma_dat.device

    def t(a, dtype=torch.float64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    rt_map = np.asarray(Sigma.cell_dof_map, dtype=np.int64)
    loc = sigma_dat[t(Sb.cell_dof_map, torch.int64)]       # (C, nd)
    if getattr(Sigma, "has_dof_transforms", False):
        B = t(Sigma.cell_dof_transforms)                   # (C, nd, nd)
        can = torch.linalg.solve(B, loc[..., None])[..., 0]
    elif getattr(Sigma, "has_dof_signs", False):
        can = t(Sigma.cell_dof_signs) * loc            # signs^-1 = signs
    else:
        can = loc
    vals = _accumulation(rt_map.reshape(-1), Sigma.dim, dev)(
        can.reshape(-1))
    counts = np.bincount(rt_map.reshape(-1), minlength=Sigma.dim)
    return vals / t(np.maximum(counts, 1.0))


def solve_hybridization(problem, params, appctx=None):
    """Solve problem.a == problem.L for problem.u on W = RT x DG; returns
    (iterations, converged) of the trace solve."""
    from ..bcs import DirichletBC
    from ..solving import direct_solve

    p = problem
    W = p.u.function_space()
    if not isinstance(W, MixedFunctionSpace) or W.num_sub_spaces != 2:
        raise NotImplementedError(
            "HybridizationPC expects a 2-field H(div) x DG problem")
    if p.bcs:
        raise NotImplementedError(
            "HybridizationPC with strong bcs on the mixed problem "
            "(flux bcs)")
    a_b, L_b, Wd, T = _broken_problem(p.a, p.L, W)
    mesh = W.mesh_obj
    Sigma = W.subspaces[0]
    Sb = Wd.subspaces[0]

    A = Tensor(a_b, axes=(Wd, Wd))
    K = Tensor(_trace_coupling(Wd, T, mesh), axes=(T, Wd))
    F = Tensor(L_b, axes=(Wd,))

    Ainv = A.inv
    S = K * Ainv * K.T
    E = K * Ainv * F

    bc = DirichletBC(T, 0.0, "on_boundary")
    Smat = assemble_slate(S, bcs=[bc])
    rhs = assemble_slate(E).dat
    rhs[torch.as_tensor(bc.dof_indices, dtype=torch.int64,
                        device=rhs.device)] = 0.0

    # trace-solve options live under the hybridization_ prefix
    # (nested-dict solver_parameters are flattened in solving.py; nested
    # access kept for direct callers)
    pre = "hybridization_"
    hp = {(pre + k): v
          for k, v in dict(params.get("hybridization", {})).items()}
    hp.update({k: v for k, v in params.items() if k.startswith(pre)})
    ksp = hp.get(pre + "ksp_type", "preonly")
    if ksp == "preonly" and hp.get(pre + "pc_type", "lu") in (
            "lu", "cholesky"):
        lam_dat = direct_solve(Smat, rhs)
        its, converged = 1, True
    else:
        # full recursive composition on the trace operator
        from .composition import OpCtx, build_ksp
        hp.setdefault(pre + "ksp_rtol", 1e-7)    # outer-level defaults:
        hp.setdefault(pre + "ksp_max_it", 10000)  # this IS the solve
        ictx = OpCtx(mat=Smat, space=T, form=None, bcs=[bc],
                     appctx=appctx or {})
        tsolve = build_ksp(ictx, hp, pre)
        if ksp == "preonly":
            lam_dat, its, converged = tsolve(rhs), 1, True
        else:
            res = tsolve._full(rhs, x0=rhs.new_zeros(T.dim))
            lam_dat, its = res.x, int(res.iterations)
            converged = bool(res.converged)
    lam = Function(T)
    lam.dat = lam_dat
    sigma, u = _back_substitute(A, K, F, lam, Sigma, Sb)
    p.u.subfunctions[0].dat = sigma
    p.u.subfunctions[1].dat = u
    return its, converged


def _back_substitute(A, K, F, lam, Sigma, Sb):
    """x = A^{-1} (F - K^T lam), per cell (a Slate Solve: K2), each field
    assembled apart; the flux back in the conforming space.  Returns the
    dof vectors (sigma, u)."""
    x = A.solve(F - K.T * AssembledVector(lam))
    sigma_b = assemble_slate(x.blocks[0])
    u_co = assemble_slate(x.blocks[1])
    return _broken_to_conforming(Sigma, Sb, sigma_b.dat), u_co.dat
