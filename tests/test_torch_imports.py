"""The PyTorch port imports neither jax nor triton: every module of
firedrake_tpu_torch is imported in a fresh interpreter and sys.modules is
inspected afterwards.  Its device defaults to the CUDA card, also where
there is none (nothing probes for one)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import firedrake_tpu_torch as T
from firedrake_tpu_torch.device import to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    T.set_device("cpu")


#: one fresh interpreter for both probes below: its first line is the
#: device the port chose before anything asked, its second the modules of
#: jax, triton or the JAX package that importing every port module loaded
_PROBE = """
import importlib, pkgutil, sys
import firedrake_tpu_torch as pkg
print(pkg.get_device())
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "triton",
                                    "firedrake_tpu"))
# the walk reaches the adjoint package and every module of it
assert {"firedrake_tpu_torch.adjoint." + m for m in (
    "tape", "optimization", "covariance", "transformed",
    "ensemble_rf")} <= set(sys.modules)
print(" ".join(bad))
"""


@pytest.fixture(scope="module")
def probe():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return (res.stdout + "\n").split("\n")


def test_port_imports_no_jax_or_triton(probe):
    assert probe[1].strip() == "", f"port imported: {probe[1]}"


def test_device_defaults_to_cuda(probe):
    assert probe[0].strip() == "cuda"
    assert T.get_device() == torch.device("cpu")   # this module asked


#: every public name of the JAX package that the port does not have yet,
#: with the ROADMAP.md queue 1 item that brings it
NOT_YET_PORTED = {
    # item 18: meshes, I/O and tooling
    18: ["AdaptiveMeshHierarchy", "GeometryProjectedMeshHierarchy",
         "OpenCascadeMeshHierarchy", "RandomGenerator", "PCG64", "parameters",
         "Parameters", "set_log_level", "info", "warning", "error",
         "debug", "info_red", "info_blue", "info_green", "DEBUG", "INFO",
         "WARNING", "ERROR", "CRITICAL", "timed_region", "timed_function",
         "print_event_summary", "write_flamegraph", "ProgressBar",
         "Citations"],
    # item 19: external operators
    19: ["point_expr", "PointwiseOperator"],
    # item 20: parallel
    20: ["Ensemble", "EnsembleFunction", "EnsembleFunctionSpace",
         "ensemble_solve", "ensemble_batched_solve"],
}


def test_import_swap_names_have_items():
    """A script that swaps its import line finds every public name of the
    JAX package in the port, or the name is listed above with its ROADMAP
    item: a missing name without an item fails, and so does a listed
    name that the port now has."""
    import types
    import firedrake_tpu as J
    public = set(J.__all__) | {
        n for n in dir(J) if not n.startswith("_")
        and not (isinstance(getattr(J, n), types.ModuleType)
                 and n != "fml")}
    public.discard("os")
    missing = {n for n in public if not hasattr(T, n)}
    listed = [n for names in NOT_YET_PORTED.values() for n in names]
    assert len(listed) == len(set(listed))
    assert missing == set(listed), (
        f"missing without an item: {sorted(missing - set(listed))}; "
        f"listed but ported: {sorted(set(listed) - missing)}")


@pytest.mark.parametrize("call, item", [
    (lambda V, u: T.assemble(T.Constant(1j) * T.TestFunction(V) * T.dx),
     17),
    (lambda V, u: V.mesh().refine_marked_elements(np.ones(8)), 18),
    (lambda V, u: T.adapt(V.mesh(), np.ones(8)), 18),
])
def test_unported_methods_name_their_item(call, item):
    V = T.FunctionSpace(T.UnitSquareMesh(2, 2), "CG", 1)
    u = T.Function(V)
    with pytest.raises(NotImplementedError, match=f"item {item}\\b"):
        call(V, u)
    # restriction still works through Function.__call__
    assert type(u("+")).__name__ == "Restricted"


def _hiptmair_riesz(fd, python_type):
    """An N1curl Riesz map of a constant by CG with the python PC named
    python_type: (solution, CG iterations)."""
    V = fd.FunctionSpace(fd.UnitSquareMesh(3, 3), "N1curl", 1)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    f = fd.Constant((1.0, 2.0))
    uh = fd.Function(V)
    solver = fd.LinearVariationalSolver(
        fd.LinearVariationalProblem(
            (fd.inner(fd.curl(u), fd.curl(v)) + fd.inner(u, v)) * fd.dx,
            fd.inner(f, v) * fd.dx, uh,
            bcs=[fd.DirichletBC(V, f, "on_boundary")]),
        solver_parameters={"ksp_type": "cg", "ksp_rtol": 1e-10,
                           "pc_type": "python",
                           "pc_python_type": python_type})
    solver.solve()
    return np.asarray(to_numpy(uh.dat)), int(solver.ksp_iterations)


def test_hiptmair_python_type_resolves_and_matches_jax():
    """pc_python_type "firedrake.HiptmairPC", which raised naming item 18
    before HiptmairPC was ported, solves as the JAX package's does."""
    import firedrake_tpu as J
    uj, its_j = _hiptmair_riesz(J, "firedrake_tpu.HiptmairPC")
    ut, its_t = _hiptmair_riesz(T, "firedrake.HiptmairPC")
    assert its_t == its_j
    assert np.abs(ut - uj).max() <= 1e-10 * np.abs(uj).max()


@pytest.mark.parametrize("call", [
    lambda u: u.at((0.3, 0.6)),
    lambda u: u((0.3, 0.6)),
    lambda u: u.vector(),
])
def test_point_evaluation_calls_match_jax(call):
    """u.at(x), u(x) and u.vector(), which raised naming item 18 before
    point evaluation was ported, give the JAX package's values."""
    import firedrake_tpu as J
    got = []
    for pkg in (J, T):
        mesh = pkg.UnitSquareMesh(2, 2)
        x = pkg.SpatialCoordinate(mesh)
        u = pkg.Function(pkg.FunctionSpace(mesh, "CG", 2)).interpolate(
            x[0] * x[0] + 3 * x[1])
        got.append(np.asarray(to_numpy(call(u)) if pkg is T
                              else call(u), dtype=float))
    assert got[0].shape == got[1].shape
    assert np.abs(got[1] - got[0]).max() <= 1e-14


def _spectral_gather():
    Q = T.FunctionSpace(T.UnitSquareMesh(2, 2, quadrilateral=True), "CG", 2)
    return T.FormAssembler(T.TrialFunction(Q) * T.TestFunction(Q) * T.dx,
                           use_stencil=False)


@pytest.mark.parametrize("call, check", [
    (lambda V: T.MeshHierarchy(T.UnitSquareMesh(2, 2, quadrilateral=True),
                               1),
     lambda h: len(h) == 2 and h[1].num_cells == 16),
    (lambda V: _spectral_gather(),
     lambda asm: asm._statics[0]["spectral"] is not None),
    (lambda V: T.ExtrudedMeshHierarchy(T.MeshHierarchy(V.mesh(), 1), 1.0,
                                       base_layer=2),
     lambda h: [m._layers for m in h] == [2, 4]),
])
def test_tensor_product_and_extruded_calls_work(call, check):
    """The calls that raised naming items 14b and 15 before those were
    ported: a quad hierarchy, Q2 on the gather route (the sum-factorised
    plan), an extruded hierarchy."""
    V = T.FunctionSpace(T.UnitSquareMesh(2, 2), "CG", 1)
    assert check(call(V))
