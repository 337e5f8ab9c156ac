"""EnsembleReducedFunctional: J(m) = sum over ensemble members of
J_i(m), gradients/Hessians summed across the member axis (the port's
copy of ``firedrake_tpu/adjoint/ensemble_rf.py``; reference:
firedrake/adjoint/ensemble_reduced_functional.py:249 — there an MPI
allreduce over ensemble ranks; here the members are in-controller
ReducedFunctionals and the reduction is a sum in member order)."""
from __future__ import annotations

import numpy as np


class EnsembleReducedFunctional:
    """Combine member ReducedFunctionals sharing one control.

    rfs      list of ReducedFunctional (one per ensemble member, each
             taped on its own Tape).
    ensemble optional Ensemble, kept and not read (the reduction is
             in-controller; Ensemble is ROADMAP.md queue 1, item 20).
    scale    optional per-member weights (e.g. sample probabilities).
    """

    def __init__(self, rfs, ensemble=None, scale=None):
        self.rfs = list(rfs)
        self.ensemble = ensemble
        self.scale = (np.ones(len(self.rfs)) if scale is None
                      else np.asarray(scale, dtype=float))
        assert len(self.scale) == len(self.rfs)

    @property
    def controls(self):
        return self.rfs[0].controls

    def __call__(self, values):
        return float(sum(w * rf(values)
                         for w, rf in zip(self.scale, self.rfs)))

    def derivative(self, adj_input=1.0):
        outs = [rf.derivative(adj_input=w * adj_input)
                for w, rf in zip(self.scale, self.rfs)]
        return _tree_sum(outs)

    def hessian(self, mdot):
        outs = []
        for w, rf in zip(self.scale, self.rfs):
            h = rf.hessian(mdot)
            outs.append(_scale(h, w))
        return _tree_sum(outs)


def _scale(g, w):
    if isinstance(g, (list, tuple)):
        return [_scale(x, w) for x in g]
    out = g.copy() if hasattr(g, "copy") else g
    out.dat = float(w) * g.dat
    return out


def _tree_sum(outs):
    """Sum Functions (or lists of Functions) elementwise, in member
    order."""
    if isinstance(outs[0], (list, tuple)):
        return [_tree_sum([o[i] for o in outs])
                for i in range(len(outs[0]))]
    acc = outs[0]
    total = acc.dat
    for o in outs[1:]:
        total = total + o.dat
    acc.dat = total
    return acc
