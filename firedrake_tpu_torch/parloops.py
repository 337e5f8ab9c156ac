"""User parallel loops over mesh cells (the port's copy of
``firedrake_tpu/parloops.py``).

Reference: firedrake/parloops.py:131 par_loop, user C/loopy kernels over
cells with access descriptors.  Here the kernel is a plain Python
function of per-cell torch tensors, vmapped over all cells with
``torch.func.vmap`` on the device; the access descriptors
(READ/WRITE/RW/INC/MIN/MAX, pyop2/types/access.py:4) drive the gather and
the write-back as PyOP2's Pack/Unpack did.

    par_loop(kernel, dx, {"u": (u, RW), "c": (coords, READ)})
    # kernel(u=u_cell, c=c_cell) -> {"u": new_u_cell}

A kernel is written in the array library of the package it runs in: one
written with ``jax.numpy`` for the JAX package does not run here; write
it with torch operations (ROADMAP.md, known divergences).

Write-back, all deterministic: WRITE/RW take, for a dof shared by several
cells, the value of the last cell that holds it (the JAX package's scatter
order on the host); INC sums each dof's contributions in a fixed order by
a sorted segment sum (no ``index_add_``); MIN/MAX reduce with
``scatter_reduce``, whose result does not depend on order.
"""
from __future__ import annotations

from enum import Enum

import numpy as np
import torch

from .device import as_tensor


class Access(Enum):
    READ = "READ"
    WRITE = "WRITE"
    RW = "RW"
    INC = "INC"
    MIN = "MIN"
    MAX = "MAX"


READ = Access.READ
WRITE = Access.WRITE
RW = Access.RW
INC = Access.INC
MIN = Access.MIN
MAX = Access.MAX


class _Plan:
    """The device index tables of a space's write-back: the cell gather,
    the last writer of each dof (WRITE/RW) and the contributions sorted
    by dof (INC)."""

    def __init__(self, cmap, ndof, device):
        flat = cmap.reshape(-1).astype(np.int64)
        self.gather = torch.as_tensor(cmap.astype(np.int64), device=device)
        self.flat = torch.as_tensor(flat, device=device)
        # the last writer of each dof, for WRITE/RW
        last = np.full(ndof, -1, dtype=np.int64)
        last[flat] = np.arange(flat.size)
        dofs = np.nonzero(last >= 0)[0]
        self.dofs = torch.as_tensor(dofs, device=device)
        self.last = torch.as_tensor(last[dofs], device=device)
        # contributions sorted by dof, for INC
        order = np.argsort(flat, kind="stable")
        self.order = torch.as_tensor(order, device=device)
        self.lengths = torch.as_tensor(np.bincount(flat, minlength=ndof),
                                       device=device)


def _plan(space, device):
    """The space's _Plan on ``device``, made once and kept on its
    function space data (shared by the scalar and vector spaces of one
    element: the dimension tells them apart)."""
    plans = space.sdata.__dict__.setdefault("_parloop_plans", {})
    key = (space.dim, str(device))
    if key not in plans:
        plans[key] = _Plan(np.asarray(space.cell_dof_map), space.dim,
                           device)
    return plans[key]


def par_loop(kernel, measure, args: dict, kernel_kwargs=None):
    """Execute ``kernel`` per cell.  ``kernel(**cell_args)`` receives, for
    each name, the per-cell dof block (ndof,) and must return a dict
    {name: new_block} for every WRITE/RW/INC/MIN/MAX argument (for INC,
    the block's increments)."""
    from .language.measure import Measure
    if isinstance(measure, Measure) and measure.integral_type != "cell":
        raise NotImplementedError(
            "par_loop over facets: the JAX package runs cell loops only")
    names = list(args.keys())
    funcs = {n: args[n][0] for n in names}
    access = {n: args[n][1] for n in names}
    if not any(hasattr(funcs[n], "function_space") for n in names):
        raise ValueError("par_loop needs at least one Function argument")
    dats = {n: as_tensor(funcs[n].dat) for n in names}
    plans = {n: _plan(funcs[n].function_space(), dats[n].device)
             for n in names}
    out = torch.func.vmap(lambda *vals: kernel(**dict(zip(names, vals))))(
        *[dats[n][plans[n].gather] for n in names])
    for n in names:
        acc = access[n]
        if acc == READ:
            continue
        p, dat = plans[n], dats[n]
        w = out[n].reshape(-1).to(dat.dtype)
        if acc in (WRITE, RW):
            new = dat.clone()
            new[p.dofs] = w[p.last]
        elif acc == INC:
            new = dat + torch.segment_reduce(w[p.order], "sum",
                                             lengths=p.lengths)
        elif acc in (MIN, MAX):
            new = dat.scatter_reduce(0, p.flat, w,
                                     "amin" if acc == MIN else "amax")
        else:
            raise ValueError(f"unknown access {acc!r}")
        funcs[n].dat = new
