"""Vertex-based slope limiter for DG1 (Kuzmin 2010); the port's copy of
``firedrake_tpu/slope_limiter.py``.

Reference: firedrake/slope_limiter/vertex_based_limiter.py:13
VertexBasedLimiter (P1DG bounds via par_loops).  Three device passes of
torch ops: the cell means; the max and min of the adjacent cell means at
each vertex (``scatter_reduce`` amax/amin, independent of order); the
per-cell scaling of the deviations from the mean.  Mean-preserving, so
mass is conserved to rounding.

On periodic meshes the limited values stay within the vertex bounds,
exactly as on other meshes.  The JAX package's periodic loop cases
(tests/acceptance/test_vertex_based_limiter.py::test_step_function_loop)
leave [0, 1] because that loop limits the stage input D1 after its last
stage and never the stage output D it then checks; the cell means stay
in [0, 1] there (ROADMAP.md queue 3).
"""
from __future__ import annotations

import numpy as np
import torch

from .functionspace import FunctionSpace
from .function import Function
from .device import as_tensor


class VertexBasedLimiter:
    def __init__(self, space: FunctionSpace):
        V = space
        elem = V.scalar_element
        # DG1 in any spelling with vertex-lattice nodes: plain "DG", or
        # BrokenElement(CG1/DG1), the reference's periodic-mesh idiom
        base = getattr(elem, "sub", elem)
        if not (base.family in ("Lagrange", "Discontinuous Lagrange")
                and base.degree == 1 and V.block_size == 1
                and not getattr(elem, "continuous", True)):
            raise ValueError("VertexBasedLimiter needs scalar DG1")
        self.V = V
        mesh = V.mesh_obj
        self.nvert = mesh.num_vertices
        # DG1 node k of cell c sits at the cell's vertex k
        self._host = (np.asarray(mesh.topology.cell_vertices, np.int64),
                      np.asarray(V.cell_dof_map, np.int64))
        self._dev = {}

    def _tables(self, device):
        t = self._dev.get(str(device))
        if t is None:
            cv, cnm = self._host
            t = dict(cv=torch.as_tensor(cv, device=device),
                     cv_flat=torch.as_tensor(cv.reshape(-1), device=device),
                     cnm=torch.as_tensor(cnm, device=device),
                     cnm_flat=torch.as_tensor(cnm.reshape(-1),
                                              device=device))
            self._dev[str(device)] = t
        return t

    def limited(self, dat):
        """The limited dof vector of ``dat`` (a new tensor)."""
        t = self._tables(dat.device)
        cv = t["cv"]
        vals = dat[t["cnm"]]                          # (ncell, nvc)
        means = vals.mean(dim=1)                      # exact for (D)P1
        big = torch.finfo(dat.dtype).max
        rep = means.repeat_interleave(cv.shape[1])
        vmax = torch.full((self.nvert,), -big, dtype=dat.dtype,
                          device=dat.device).scatter_reduce(
            0, t["cv_flat"], rep, "amax")
        vmin = torch.full((self.nvert,), big, dtype=dat.dtype,
                          device=dat.device).scatter_reduce(
            0, t["cv_flat"], rep, "amin")
        hi = vmax[cv]                                 # (ncell, nvc)
        lo = vmin[cv]
        dev = vals - means[:, None]
        eps = 1e-14
        one = torch.ones((), dtype=dat.dtype, device=dat.device)
        alpha_hi = torch.where(dev > eps, (hi - means[:, None])
                               / (dev + eps), one)
        alpha_lo = torch.where(dev < -eps, (lo - means[:, None])
                               / (dev - eps), one)
        alpha = torch.clamp(torch.minimum(alpha_hi, alpha_lo), 0.0, 1.0)
        alpha_cell = alpha.amin(dim=1)
        lim = means[:, None] + alpha_cell[:, None] * dev
        out = dat.clone()
        out[t["cnm_flat"]] = lim.reshape(-1)
        return out

    def apply(self, field: Function):
        field.dat = self.limited(as_tensor(field.dat))
        return field

    def compute_bounds(self, field: Function):
        pass   # the bounds are recomputed inside apply
