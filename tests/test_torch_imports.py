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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    T.set_device("cpu")


_PROBE = """
import importlib, pkgutil, sys
import firedrake_tpu_torch as pkg
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


def test_port_imports_no_jax_or_triton():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", f"port imported: {res.stdout}"


def test_device_defaults_to_cuda():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c",
         "import firedrake_tpu_torch as T; print(T.get_device())"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "cuda"
    assert T.get_device() == torch.device("cpu")   # this module asked


#: every public name of the JAX package that the port does not have yet,
#: with the ROADMAP.md queue 1 item that brings it
NOT_YET_PORTED = {
    # item 18: meshes, I/O and tooling
    18: ["Mesh", "VertexOnlyMesh", "PointNotInDomainError", "Interpolator",
         "CheckpointFile", "DumbCheckpoint", "FILE_CREATE", "FILE_READ",
         "FILE_UPDATE",
         "assemble_mixed_mass_matrix", "AdaptiveMeshHierarchy",
         "GeometryProjectedMeshHierarchy", "OpenCascadeMeshHierarchy",
         "TransferManager", "RandomGenerator", "PCG64", "parameters",
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


def _mass_solve(V, params):
    T.solve(T.TrialFunction(V) * T.TestFunction(V) * T.dx
            == T.TestFunction(V) * T.dx, T.Function(V),
            solver_parameters=params)


@pytest.mark.parametrize("call, item", [
    (lambda V, u: _mass_solve(V, {
        "pc_type": "python", "pc_python_type": "firedrake.HiptmairPC"}), 18),
    (lambda V, u: u.at((0.5, 0.5)), 18),
    (lambda V, u: u((0.5, 0.5)), 18),
    (lambda V, u: u.vector(), 18),
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
