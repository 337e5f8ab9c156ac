"""Adjoint/AD surface (the port's copy of ``firedrake_tpu/adjoint``;
reference: firedrake/adjoint/__init__.py:1-40 — pyadjoint re-exports).
See tape.py for the design."""
from .tape import (annotate_tape, continue_annotation, pause_annotation,
                   get_working_tape, set_working_tape, Tape, Control,
                   ReducedFunctional, compute_gradient, compute_hessian,
                   taylor_test, AdjFloat, SolveBlock, FunctionalBlock,
                   enable_disk_checkpointing)
from .ensemble_rf import EnsembleReducedFunctional
from .transformed import L2RieszMap, L2TransformedFunctional
from .optimization import (minimize, maximize, MinimizationProblem,
                           MinimizationSolver, EqualityConstraint,
                           InequalityConstraint, UFLEqualityConstraint,
                           UFLInequalityConstraint)
from .covariance import (WhiteNoiseGenerator, CovarianceOperatorBase,
                         AutoregressiveCovariance,
                         MixedCovarianceOperator, CovarianceMat,
                         diffusion_form, lengthscale_m, lambda_m,
                         kappa_m)

__all__ = ["annotate_tape", "continue_annotation", "pause_annotation",
           "get_working_tape", "set_working_tape", "Tape", "Control",
           "ReducedFunctional", "compute_gradient", "compute_hessian",
           "taylor_test", "AdjFloat", "enable_disk_checkpointing",
           "EnsembleReducedFunctional", "minimize", "maximize",
           "L2RieszMap", "L2TransformedFunctional",
           "MinimizationProblem", "MinimizationSolver",
           "EqualityConstraint", "InequalityConstraint",
           "UFLEqualityConstraint", "UFLInequalityConstraint",
           "WhiteNoiseGenerator", "CovarianceOperatorBase",
           "AutoregressiveCovariance", "MixedCovarianceOperator",
           "CovarianceMat", "diffusion_form", "lengthscale_m",
           "lambda_m", "kappa_m"]


# `firedrake_tpu_torch.adjoint` is both this package AND (for API parity
# with ufl.adjoint re-exported at top level) the bilinear-form adjoint
# when called: importing the package rebinds the parent attribute, so
# make the module itself callable.
import sys as _sys
import types as _types


class _CallableModule(_types.ModuleType):
    def __call__(self, form, *args, **kwargs):
        from ..language.calculus import adjoint as _form_adjoint
        return _form_adjoint(form, *args, **kwargs)


_sys.modules[__name__].__class__ = _CallableModule
