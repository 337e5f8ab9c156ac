"""Static condensation of cell-interior dofs (pc_type scpc) in the port
against the JAX package: P3 Poisson on UnitSquareMesh(4), one solve
through each package, shared by the asserts (tests/regression/
test_scpc.py's case).

Tolerances: within 1e-10 max|ref| of the JAX package's solution and of
the port's LU; the dof numbering bit for bit."""
import math

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
import jax

import firedrake_tpu as J
import firedrake_tpu_torch as T

LU = {"ksp_type": "preonly", "pc_type": "lu"}


#: the JAX package's reference programs are compiled with XLA's
#: optimisations off, which cuts the time of these tests by ~18% on 6 CPU
#: workers (most of it is compiling); the results agree within the same
#: tolerances.  The module's executables are dropped with it, so that no
#: later module runs them.
NO_OPT = "jax_disable_most_optimizations"


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    # two torch threads: six test workers share the host's cores, and
    # more threads per worker slow the many small torch operations down
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    T.set_device("cpu")
    opt = jax.config.read(NO_OPT)
    jax.config.update(NO_OPT, True)
    # one BLAS thread: with six test workers, numpy's OpenBLAS threads
    # (one per host core in each worker) made its dense linear algebra
    # ~20x slower
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    jax.config.update(NO_OPT, opt)
    jax.clear_caches()
    torch.set_num_threads(n)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(ours, ref, rtol):
    ours, ref = _np(ours), _np(ref)
    assert np.shape(ours) == np.shape(ref)
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(ours - ref).max() <= rtol * scale, \
        np.abs(ours - ref).max() / scale


# ------------------------------------------------------------------ SCPC
def _scpc(fd, params, n=4, deg=3):
    """P3 Poisson with sin sin data and zero Dirichlet conditions (the
    JAX test_scpc_matches_lu)."""
    mesh = fd.UnitSquareMesh(n, n)
    V = fd.FunctionSpace(mesh, "CG", deg)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    X = fd.SpatialCoordinate(mesh)
    f = 2 * math.pi ** 2 * fd.sin(math.pi * X[0]) * fd.sin(math.pi * X[1])
    uh = fd.Function(V)
    fd.solve(fd.inner(fd.grad(u), fd.grad(v)) * fd.dx == f * v * fd.dx, uh,
             bcs=[fd.DirichletBC(V, 0.0, "on_boundary")],
             solver_parameters=params)
    return V, uh


@pytest.fixture(scope="module")
def scpc_pair():
    params = {"ksp_type": "preonly", "pc_type": "scpc"}
    Vj, uj = _scpc(J, params)
    Vt, ut = _scpc(T, params)
    return Vj, uj, Vt, ut


def test_scpc_numbering_bit_for_bit(scpc_pair):
    Vj, _, Vt, _ = scpc_pair
    assert np.array_equal(np.asarray(Vt.cell_dof_map),
                          np.asarray(Vj.cell_dof_map))


def test_scpc_matches_jax(scpc_pair):
    _, uj, _, ut = scpc_pair
    _close(ut.dat, uj.dat, 1e-10)


def test_scpc_matches_port_lu(scpc_pair):
    _, _, _, ut = scpc_pair
    _, ul = _scpc(T, LU)
    _close(ut.dat, ul.dat, 1e-10)
