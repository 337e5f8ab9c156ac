"""Adjoint taping: reverse-mode gradients through assemble/solve (the
port's copy of ``firedrake_tpu/adjoint/tape.py``).

Reference: the pyadjoint operator-overloading tape used by
firedrake/adjoint_utils/* (blocks recorded for every solve/assemble;
compute_gradient / ReducedFunctional / taylor_test re-exported from
firedrake/adjoint/__init__.py:1-40).

Blocks store SYMBOLIC forms, and the reverse sweep is classical
adjoint-PDE machinery built from the framework's own calculus:
  * functional block  J = assemble(j(u, m)):   ubar += dJ/du (assembled)
  * solve block       F(u; m) = 0:             solve  (dF/du)^T lam = ubar,
                                               mbar -= <lam, dF/dm>
There is no backward kernel: the adjoint, tangent and second-order
systems are forms, assembled and solved on the device like the primal
ones.  Snapshots of the coefficients are device tensors (``clone()``);
only the disk store moves them to the host.

Divergence from the JAX package: its shared inner solve ignores the
block's solver parameters, and above 20,000 rows returns a Jacobi-GMRES
iterate without reading whether it converged.  Here the adjoint, tangent
and second-order systems go through the solver the forward solve used
(``solver_parameters``, so ``pc_type: mg`` rediscretises the adjoint
operator on the hierarchy), and every Krylov solve that does not
converge raises naming its iterations and residual.  With no parameters
recorded, the JAX package's choice stays: host LU below 20,000 rows,
else Jacobi-GMRES(30) to rtol 1e-12.
"""
from __future__ import annotations

import contextlib
import glob
import os
import tempfile

import numpy as np
import torch

from ..device import as_tensor, get_device, to_numpy

#: rows below which an adjoint system recorded without solver parameters
#: is solved by host LU (the JAX package's threshold)
DIRECT_ROWS = 20000
#: the JAX package's Krylov solve above DIRECT_ROWS
DEFAULT_ADJOINT_KSP = {"ksp_type": "gmres", "pc_type": "jacobi",
                       "ksp_rtol": 1e-12}

_annotating = [False]


def annotate_tape():
    return _annotating[0]


def continue_annotation():
    _annotating[0] = True
    return True


def pause_annotation():
    _annotating[0] = False
    return False


@contextlib.contextmanager
def _paused():
    """No annotation inside: the sweeps assemble 0-forms of their own."""
    was = annotate_tape()
    pause_annotation()
    try:
        yield
    finally:
        if was:
            continue_annotation()


class _DiskStore:
    """Snapshot store that keeps tape state on disk (reference role:
    firedrake/adjoint_utils/checkpointing.py:528 enable_disk_checkpointing
    — bounds tape memory for long time loops).  Each snapshot is one .npy
    file, read back memory-mapped and moved to the set device."""

    def __init__(self, directory=None):
        self.dir = directory or tempfile.mkdtemp(prefix="fdtpu_tape_")
        os.makedirs(self.dir, exist_ok=True)
        self._n = 0

    def save(self, arr):
        key = os.path.join(self.dir, f"snap_{self._n:08d}.npy")
        self._n += 1
        np.save(key, to_numpy(arr))
        return _DiskRef(key, torch.is_tensor(arr))

    def clear(self):
        for f in glob.glob(os.path.join(self.dir, "snap_*.npy")):
            os.unlink(f)
        self._n = 0


class _DiskRef:
    __slots__ = ("key", "tensor")

    def __init__(self, key, tensor):
        self.key, self.tensor = key, tensor

    def load(self):
        a = np.load(self.key, mmap_mode="r")
        return as_tensor(np.array(a)) if self.tensor else np.array(a)


def _snap(x):
    """Snapshot a dat through the working tape's store: a device clone (a
    Constant's value: a numpy copy), or a disk ref when disk
    checkpointing is enabled."""
    store = getattr(_working_tape, "_store", None)
    if store is not None:
        return store.save(x)
    return x.clone() if torch.is_tensor(x) else np.array(x, copy=True)


def _unsnap(s):
    """A fresh copy of a snapshot's value (callers may write into it)."""
    if isinstance(s, _DiskRef):
        return s.load()
    return s.clone() if torch.is_tensor(s) else np.array(s, copy=True)


class Tape:
    def __init__(self):
        self.blocks = []
        self._store = None
        # work Functions of the sweeps, one per (role, space), so that the
        # forms they enter keep hitting the assembler cache
        self._work = {}

    def clear_tape(self):
        self.blocks.clear()
        self._work.clear()
        if self._store is not None:
            self._store.clear()

    def add_block(self, b):
        self.blocks.append(b)

    def enable_disk_checkpointing(self, directory=None):
        """Store all block snapshots on disk instead of device memory
        (reference: adjoint_utils/checkpointing.py:528).  Call before
        taping."""
        self._store = _DiskStore(directory)
        return self._store.dir


def enable_disk_checkpointing(directory=None):
    return get_working_tape().enable_disk_checkpointing(directory)


_working_tape = Tape()


def get_working_tape():
    return _working_tape


def set_working_tape(tape):
    global _working_tape
    _working_tape = tape
    return tape


def _work_function(pool, role, V, value):
    """The pool's Function for (role, V), holding ``value``."""
    from ..function import Function
    f = pool.get((role, id(V)))
    if f is None:
        f = pool[(role, id(V))] = Function(V)
    f.dat = value
    return f


def _add(acc, key, value):
    acc[key] = value if key not in acc else acc[key] + value


def _dot(a, b):
    """<a, b> as a shape-(1,) tensor (a Constant's adjoint entry)."""
    return torch.dot(as_tensor(a), as_tensor(b)).reshape(1)


# ------------------------------------------------------------------ blocks
class SolveBlock:
    """Records solve(F == 0, u) / solve(a == L, u).

    ALL coefficient values are snapshotted (pyadjoint's block-variable
    versioning): a time loop reuses the same Function objects, so the
    reverse sweep must evaluate each step's Jacobian/derivatives at that
    step's values, not the final ones.  The assemblers read every
    coefficient's ``dat`` when they run, so swapping the dats in
    ``_values_restored`` is all a sweep needs."""

    def __init__(self, F, u, bcs, solver_parameters=None, appctx=None):
        self.F = F                     # residual form, F(u) = 0
        self.u = u
        from ..bcs import as_bcs
        self.bcs = tuple(as_bcs(bcs))
        self.solver_parameters = dict(solver_parameters or {})
        # the forward solve's application context: its PCs read it in the
        # sweeps and the replay too
        self.appctx = appctx or {}
        self._pool = get_working_tape()._work
        self._snapshot()

    def _participants(self):
        return _leaf_coefficients(self.F) + _leaf_constants(self.F)

    def _snapshot(self):
        self.u_snapshot = _snap(self.u.dat)
        self.coeff_snapshots = {id(c): _snap(c.dat)
                                for c in self._participants()
                                if c is not self.u}

    @contextlib.contextmanager
    def _values_restored(self):
        """Set u and every participant coefficient to this block's
        snapshot values, restoring the current values on exit."""
        u = self.u
        restored = [c for c in self._participants()
                    if id(c) in self.coeff_snapshots]
        saved = [(u, u.dat)] + [(c, c.dat) for c in restored]
        u.dat = _unsnap(self.u_snapshot)
        for c in restored:
            c.dat = _unsnap(self.coeff_snapshots[id(c)])
        try:
            yield
        finally:
            for c, d in saved:
                c.dat = d

    def _bc_idx(self):
        from ..bcs import DirichletBC
        bcs = [b for b in self.bcs if isinstance(b, DirichletBC)]
        return (np.unique(np.concatenate([b.dof_indices for b in bcs]))
                if bcs else np.zeros(0, dtype=np.int64))

    def _linear_solve(self, form, rhs):
        """Solve the operator of the bilinear ``form`` (dF/du or its
        adjoint) against ``rhs`` with the block's Dirichlet rows
        homogeneous: through the solver and parameters the forward solve
        used, or, with none recorded, the JAX package's choice.  A Krylov
        solve that does not converge raises."""
        from ..assemble import assemble
        from ..bcs import homogenize, DirichletBC
        from ..solving import _merged_params, _run_ksp, direct_solve
        from ..solvers.composition import OpCtx, build_pc
        bc_idx = self._bc_idx()
        params = _merged_params(self.solver_parameters)
        if params.get("mat_type", "aij") == "matfree":
            from ..assembly.matfree import MatrixFreeOperator
            A = MatrixFreeOperator(form)
        else:
            A = assemble(form)
        rhs = as_tensor(rhs)
        if len(bc_idx):
            idx = torch.as_tensor(bc_idx.astype(np.int64),
                                  device=rhs.device)
            rhs = rhs.index_fill(0, idx, 0.0)
            A = A.with_dirichlet(bc_idx)
        if not self.solver_parameters:
            if A.shape[0] < DIRECT_ROWS:
                return direct_solve(A, rhs)
            params = _merged_params(DEFAULT_ADJOINT_KSP)
        elif params.get("ksp_type") == "preonly" and \
                params.get("pc_type") in ("lu", "cholesky", "ilu"):
            return direct_solve(A, rhs)
        bcs0 = tuple(homogenize(b) for b in self.bcs
                     if isinstance(b, DirichletBC))
        pc = build_pc(OpCtx(mat=A, space=self.u.function_space(),
                            form=form, bcs=bcs0, appctx=self.appctx),
                      params, "")
        if params.get("ksp_type") == "preonly":
            return pc(rhs)
        res = _run_ksp(A.matvec, rhs, params, pc=pc)
        if not res.converged:
            raise RuntimeError(
                f"adjoint-tape linear solve ({params.get('ksp_type')} + "
                f"{params.get('pc_type')}) did not converge: "
                f"{res.iterations} iterations, residual norm "
                f"{res.residual_norm}, ksp_rtol {params.get('ksp_rtol')}")
        return res.x

    # -------------------------------------------------- first-order sweep
    def adjoint_actions(self, ubar, adjoints, return_lam=False):
        """Given ubar (dJ/du at this point), do the adjoint solve and push
        contributions onto upstream coefficients."""
        from ..language.calculus import derivative, action
        from ..language.calculus import adjoint as form_adjoint
        from ..assemble import assemble
        from ..language.core import ScalarValue

        u = self.u
        with self._values_restored():
            lam = self._linear_solve(
                form_adjoint(derivative(self.F, u)), ubar)
            lam_fun = _work_function(self._pool, "lam",
                                     u.function_space(), lam)
            # propagate to every upstream coefficient in F (except u)
            for c in _leaf_coefficients(self.F):
                if c is u or not _differentiable(c):
                    continue
                dFdm = derivative(self.F, c)
                if not dFdm.integrals():
                    continue
                contrib = assemble(action(form_adjoint(dFdm), lam_fun))
                _add(adjoints, id(c), -contrib.dat)
            # scalar Constant controls: cbar -= <lam, dF/dc>
            for c in _leaf_constants(self.F):
                if c.values().size != 1:
                    continue
                dFdc = derivative(self.F, c, du=ScalarValue(1.0))
                if not dFdc.integrals():
                    continue
                _add(adjoints, id(c), -_dot(assemble(dFdc).dat, lam))
        if return_lam:
            return lam
        return adjoints

    # ----------------------------------------------- tangent (TLM) sweep
    def _tangent_dirs(self, tangents):
        """Direction Functions (at this block's tangent values) for every
        differentiable participant with a tangent."""
        return {id(c): _work_function(self._pool, ("dir", id(c)),
                                      c.function_space(),
                                      tangents[id(c)].clone())
                for c in _leaf_coefficients(self.F)
                if id(c) in tangents and _differentiable(c)}

    def tlm_actions(self, tangents):
        """Forward tangent sweep: (dF/du) udot = -(D_m F)[mdot]; stores
        this block's tangent snapshot for the second-order reverse."""
        from ..language.calculus import derivative
        from ..assemble import assemble
        u = self.u
        with self._values_restored():
            mdirs = {k: v for k, v in self._tangent_dirs(tangents).items()
                     if k != id(u)}
            mtan = {k: v for k, v in tangents.items() if k != id(u)}
            rhs_form = _directional(self.F, mdirs, mtan)
            if rhs_form is None:
                udot = torch.zeros(u.function_space().dim,
                                   dtype=torch.float64, device=get_device())
            else:
                udot = self._linear_solve(derivative(self.F, u),
                                          -assemble(rhs_form).dat)
        tangents[id(u)] = udot
        self.tlm_snapshot = {id(c): _snap(tangents[id(c)])
                             for c in self._participants() + [u]
                             if id(c) in tangents}
        return tangents

    # ------------------------------------- second-order (Hessian) sweep
    def soa_actions(self, lam, hess):
        """Second-order adjoint: with Fdot = D F[tape tangent],
            (dF/du)^T lamdot = ubar_dot - (d Fdot/du)^T lam
            hess[c] -= (d Fdot/dc)^T lam + (dF/dc)^T lamdot."""
        from ..language.calculus import derivative, action
        from ..language.calculus import adjoint as form_adjoint
        from ..assemble import assemble
        from ..language.core import ScalarValue

        u = self.u
        V = u.function_space()
        ubar_dot = hess.pop(id(u), None)
        tangents = {k: _unsnap(v)
                    for k, v in getattr(self, "tlm_snapshot", {}).items()}
        with self._values_restored():
            dirs = self._tangent_dirs(tangents)
            Fdot = _directional(self.F, dirs, tangents)
            lam_fun = _work_function(self._pool, "lam", V, lam)
            rhs2 = (ubar_dot if ubar_dot is not None else
                    torch.zeros(V.dim, dtype=torch.float64,
                                device=get_device()))
            if Fdot is not None:
                dFdot_du = derivative(Fdot, u)
                if dFdot_du.integrals():
                    rhs2 = rhs2 - assemble(
                        action(form_adjoint(dFdot_du), lam_fun)).dat
            lamdot = self._linear_solve(
                form_adjoint(derivative(self.F, u)), rhs2)
            lamdot_fun = _work_function(self._pool, "lamdot", V, lamdot)
            for c in _leaf_coefficients(self.F):
                if c is u or not _differentiable(c):
                    continue
                contrib = torch.zeros(c.dat.numel(), dtype=torch.float64,
                                      device=get_device())
                dFdc = derivative(self.F, c)
                if dFdc.integrals():
                    contrib = contrib + assemble(
                        action(form_adjoint(dFdc), lamdot_fun)).dat
                if Fdot is not None:
                    dFdot_dc = derivative(Fdot, c)
                    if dFdot_dc.integrals():
                        contrib = contrib + assemble(
                            action(form_adjoint(dFdot_dc), lam_fun)).dat
                _add(hess, id(c), -contrib)
            for c in _leaf_constants(self.F):
                if c.values().size != 1:
                    continue
                contrib = 0.0
                dFdc = derivative(self.F, c, du=ScalarValue(1.0))
                if dFdc.integrals():
                    contrib += float(_dot(assemble(dFdc).dat, lamdot))
                if Fdot is not None:
                    dFdot_dc = derivative(Fdot, c, du=ScalarValue(1.0))
                    if dFdot_dc.integrals():
                        contrib += float(_dot(assemble(dFdot_dc).dat, lam))
                if contrib:
                    _add(hess, id(c), -torch.tensor(
                        [contrib], dtype=torch.float64, device=get_device()))
        return hess


class AssignBlock:
    """Records target.assign(source) — the state hand-off of time loops
    (pyadjoint's assign block).  Reverse: the target's adjoint flows to
    the source."""

    def __init__(self, target, source):
        self.target = target
        self.source = source

    def adjoint_actions(self, adjoints):
        tbar = adjoints.pop(id(self.target), None)
        if tbar is not None:
            _add(adjoints, id(self.source), tbar)
        return adjoints

    def tlm_actions(self, tangents):
        sdot = tangents.get(id(self.source))
        if sdot is None:
            tangents.pop(id(self.target), None)
        else:
            tangents[id(self.target)] = sdot.clone()
        return tangents


class FunctionalBlock:
    """Records J = assemble(j) for a 0-form j."""

    def __init__(self, form, value):
        self.form = form
        self.value = value
        self._pool = get_working_tape()._work
        self._snapshot()
        self.tlm_snapshot = {}

    def _snapshot(self):
        self.snapshots = {id(c): _snap(c.dat)
                          for c in _leaf_coefficients(self.form)}

    @contextlib.contextmanager
    def _values_restored(self):
        cs = [c for c in _leaf_coefficients(self.form)
              if id(c) in self.snapshots]
        saved = [(c, c.dat) for c in cs]
        for c in cs:
            c.dat = _unsnap(self.snapshots[id(c)])
        try:
            yield
        finally:
            for c, d in saved:
                c.dat = d

    def _push(self, form, jbar, acc):
        """acc[c] += jbar * d(form)/dc for every differentiable
        coefficient and scalar Constant of the 0-form ``form``."""
        from ..language.calculus import derivative
        from ..assemble import assemble
        from ..language.core import ScalarValue
        for c in _leaf_coefficients(form):
            if not _differentiable(c):
                continue
            dj = derivative(form, c)
            if dj.integrals():
                _add(acc, id(c), jbar * assemble(dj).dat)
        for c in _leaf_constants(form):
            if c.values().size != 1:
                continue
            dj = derivative(form, c, du=ScalarValue(1.0))
            if dj.integrals():
                _add(acc, id(c), jbar * torch.tensor(
                    [float(assemble(dj))], dtype=torch.float64,
                    device=get_device()))

    def seed(self, jbar, adjoints):
        with self._values_restored():
            self._push(self.form, jbar, adjoints)
        return adjoints

    def tlm_record(self, tangents):
        """Record the tape tangents reaching the functional."""
        self.tlm_snapshot = {
            id(c): _snap(tangents[id(c)])
            for c in (_leaf_coefficients(self.form)
                      + _leaf_constants(self.form))
            if id(c) in tangents}
        return tangents

    def hessian_seed(self, jbar, hess):
        """Seed the second-order sweep: hess[c] += jbar * d(jdot)/dc
        where jdot = D j [tape tangent] (0-form)."""
        tangents = {k: _unsnap(v) for k, v in self.tlm_snapshot.items()}
        with self._values_restored():
            dirs = {id(c): _work_function(self._pool, ("dir", id(c)),
                                          c.function_space(),
                                          tangents[id(c)])
                    for c in _leaf_coefficients(self.form)
                    if id(c) in tangents and _differentiable(c)}
            jdot = _directional(self.form, dirs, tangents)
            if jdot is not None:
                self._push(jdot, jbar, hess)
        return hess


def _directional(form, dirs, tangents):
    """D form [tape tangent]: the sum of the directional derivatives along
    the direction Functions ``dirs`` and the scalar Constants' tangents;
    None when empty."""
    from ..language.calculus import derivative
    from ..language.core import ScalarValue
    out = None
    for c in _leaf_coefficients(form):
        cdot = dirs.get(id(c))
        if cdot is None:
            continue
        d = _dir_derivative(form, c, cdot)
        if d.integrals():
            out = d if out is None else out + d
    for c in _leaf_constants(form):
        td = tangents.get(id(c))
        if td is None or c.values().size != 1:
            continue
        d = derivative(form, c,
                       du=ScalarValue(float(to_numpy(td).reshape(-1)[0])))
        if d.integrals():
            out = d if out is None else out + d
    return out


def _dir_derivative(form, c, cdot):
    """derivative(form, c, du=cdot) that also handles mixed coefficients
    (the per-part branch of derivative() only fires when du is None)."""
    from ..language.calculus import derivative
    parts = getattr(c, "parts", None)
    if parts is not None:
        dparts = cdot.parts
        out = None
        for p, dp in zip(parts, dparts):
            d = derivative(form, p, du=dp)
            if d.integrals():
                out = d if out is None else out + d
        if out is None:
            out = derivative(form, parts[0], du=dparts[0])
        return out
    return derivative(form, c, du=cdot)


def _leaf_coefficients(form):
    from ..language.core import Coefficient
    out = {}
    for it in form.integrals():
        for t in it.integrand.traverse():
            if isinstance(t, Coefficient):
                out.setdefault(t.count, t)
    return [out[k] for k in sorted(out)]


def _leaf_constants(form):
    from ..language.core import ConstantBase
    out = {}
    for it in form.integrals():
        for t in it.integrand.traverse():
            if isinstance(t, ConstantBase):
                out.setdefault(t.count, t)
    return [out[k] for k in sorted(out)]


def _differentiable(c):
    from ..function import Function
    return isinstance(c, Function)


def _set_value(c, v):
    """Set a control's value from a Function, tensor or array."""
    from ..language.core import ConstantBase
    v = getattr(v, "dat", v)
    if isinstance(c, ConstantBase):
        c.assign(to_numpy(v).reshape(c.shape))
    else:
        c.dat = as_tensor(v).clone()


def _outputs(controls, acc):
    """One Function (or Constant) per control from the accumulated
    adjoint entries (zero where none reached it)."""
    from ..function import Cofunction, Constant
    from ..language.core import ConstantBase
    outs = []
    for ctrl in controls:
        c = ctrl.coefficient
        if isinstance(c, ConstantBase):
            g = to_numpy(acc.get(id(c), np.zeros(c.values().size)))
            outs.append(Constant(float(g.reshape(())) if g.size == 1
                                 else g))
            continue
        g = acc.get(id(c))
        gf = Cofunction(c.function_space())
        if g is not None:
            gf.dat = g
        outs.append(gf)
    return outs if len(outs) > 1 else outs[0]


# -------------------------------------------------------------- functional
class AdjFloat(float):
    """A float that remembers the block that produced it."""

    def __new__(cls, value, block=None):
        obj = super().__new__(cls, value)
        obj.block = block
        return obj


class Control:
    def __init__(self, coefficient):
        self.coefficient = coefficient

    def data(self):
        return self.coefficient.dat


class ReducedFunctional:
    """J(m) with derivative via one reverse tape sweep (reference:
    pyadjoint ReducedFunctional re-exported by firedrake.adjoint)."""

    def __init__(self, functional, controls, tape=None):
        self.functional = functional
        self.controls = (list(controls) if isinstance(controls, (list,
                                                                 tuple))
                         else [controls])
        self.tape = tape or get_working_tape()
        self._J_block = getattr(functional, "block", None)

    def __call__(self, values):
        """Re-evaluate by replaying the tape with new control values."""
        from ..solving import (NonlinearVariationalProblem,
                               NonlinearVariationalSolver)
        from ..assemble import assemble
        values = values if isinstance(values, (list, tuple)) else [values]
        J = None
        with _paused():
            for ctrl, v in zip(self.controls, values):
                _set_value(ctrl.coefficient, v)
            for b in self.tape.blocks:
                if isinstance(b, SolveBlock):
                    prob = NonlinearVariationalProblem(b.F, b.u, bcs=b.bcs)
                    NonlinearVariationalSolver(
                        prob, solver_parameters=b.solver_parameters,
                        appctx=b.appctx).solve()
                    b._snapshot()
                elif isinstance(b, AssignBlock):
                    b.target.dat = b.source.dat.clone()
                elif isinstance(b, FunctionalBlock):
                    b._snapshot()
                    J = assemble(b.form)
                    b.value = float(J)
        return float(J) if J is not None else float(self.functional)

    def _seed_block(self):
        j_block = self._J_block
        assert j_block is not None, \
            "functional was not produced by an annotated assemble()"
        return j_block

    def derivative(self, adj_input=1.0):
        adjoints = {}
        j_block = self._seed_block()
        with _paused():
            # seed from the functional block, then sweep backwards
            j_block.seed(float(adj_input), adjoints)
            for b in reversed(self.tape.blocks):
                if isinstance(b, SolveBlock):
                    ubar = adjoints.pop(id(b.u), None)
                    if ubar is not None:
                        b.adjoint_actions(ubar, adjoints)
                elif isinstance(b, AssignBlock):
                    b.adjoint_actions(adjoints)
        return _outputs(self.controls, adjoints)

    def hessian(self, mdot):
        """Hessian action H(m)[mdot] via forward-over-reverse: one TLM
        sweep, then a combined first+second-order reverse sweep
        (reference role: pyadjoint ReducedFunctional.hessian used by
        firedrake.adjoint; taylor_test with Hm converges at rate 3)."""
        mdots = mdot if isinstance(mdot, (list, tuple)) else [mdot]
        tangents = {}
        for ctrl, md in zip(self.controls, mdots):
            tangents[id(ctrl.coefficient)] = as_tensor(
                getattr(md, "dat", md)).reshape(-1).clone()
        j_block = self._seed_block()
        adjoints, hess = {}, {}
        with _paused():
            for b in self.tape.blocks:
                if isinstance(b, (SolveBlock, AssignBlock)):
                    b.tlm_actions(tangents)
                elif isinstance(b, FunctionalBlock):
                    b.tlm_record(tangents)
            j_block.seed(1.0, adjoints)
            j_block.hessian_seed(1.0, hess)
            for b in reversed(self.tape.blocks):
                if isinstance(b, SolveBlock):
                    ubar = adjoints.pop(id(b.u), None)
                    if ubar is None:
                        hess.pop(id(b.u), None)
                        continue
                    lam = b.adjoint_actions(ubar, adjoints, return_lam=True)
                    b.soa_actions(lam, hess)
                elif isinstance(b, AssignBlock):
                    b.adjoint_actions(adjoints)
                    b.adjoint_actions(hess)
        return _outputs(self.controls, hess)


def compute_gradient(J, controls, tape=None):
    rf = ReducedFunctional(J, controls, tape=tape)
    return rf.derivative()


def compute_hessian(J, controls, mdot, tape=None):
    rf = ReducedFunctional(J, controls, tape=tape)
    return rf.hessian(mdot)


def taylor_test(rf: ReducedFunctional, m, h, dJdm=None, Hm=None,
                eps0=None):
    """Residual convergence of the Taylor remainder — returns the observed
    order: ~2 with the gradient term, ~3 when the Hessian action Hm is
    also supplied.  Reference: pyadjoint taylor_test.

    eps0: largest perturbation size.  The third-order remainder decays
    fast — start large enough that it sits above the PDE-solver noise
    floor (default 0.1 with Hm, 0.01 without)."""
    return float(np.median(taylor_rates(rf, m, h, Hm=Hm, eps0=eps0)))


def taylor_rates(rf, m, h, Hm=None, eps0=None, steps=4):
    """The observed orders between successive halvings of eps (the
    remainders of ``steps`` perturbations); taylor_test is their
    median."""
    def vec(x):
        return as_tensor(getattr(x, "dat", x)).reshape(-1)

    m0, hd = vec(m).clone(), vec(h)
    Jm = rf(_wrap(m0))
    gh = float(torch.dot(vec(rf.derivative()), hd))
    second = None
    if Hm is not None:
        second = 0.5 * float(torch.dot(hd, vec(Hm)))
    residuals = []
    eps = eps0 if eps0 is not None else (0.1 if Hm is not None else 0.01)
    for _ in range(steps):
        Jp = rf(_wrap(m0 + eps * hd))
        r = Jp - Jm - eps * gh
        if second is not None:
            r -= eps * eps * second
        residuals.append(abs(r))
        eps /= 2
    rf(_wrap(m0))
    rs = np.array(residuals)
    if np.all(rs < 1e-14):
        return np.full(steps - 1, 3.0 if second is not None else 2.0)
    return np.log2(rs[:-1] / rs[1:])


def _wrap(data):
    class _V:
        pass
    v = _V()
    v.dat = data
    return v
