"""The host layer carried over into firedrake_tpu_torch (language,
elements, mesh, functionspace, compiler/preprocess+tabulation) is
bit-equal to the JAX package's: coordinates, cell_node_map, boundary
nodes, quadrature rules and tabulations on small structured meshes."""
import numpy as np
import pytest
import torch

import firedrake_tpu as J
import firedrake_tpu_torch as T
from firedrake_tpu.compiler.lowering import (_cell_rule as j_rule,
                                             _tables_at as j_tables)
from firedrake_tpu_torch.compiler.lowering import (_cell_rule as t_rule,
                                                   _tables_at as t_tables)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    T.set_device("cpu")
    yield
    torch.set_num_threads(n)


def _spaces(fd, mesh_kind, degree):
    mesh = (fd.UnitSquareMesh(5, 4) if mesh_kind == "square"
            else fd.UnitCubeMesh(2, 2, 2))
    return mesh, fd.FunctionSpace(mesh, "CG", degree)


CASES = [("square", 1), ("square", 2), ("cube", 1), ("cube", 2)]


@pytest.mark.parametrize("mesh_kind,degree", CASES)
def test_coordinates_and_numbering_bit_equal(mesh_kind, degree):
    mj, Vj = _spaces(J, mesh_kind, degree)
    mt, Vt = _spaces(T, mesh_kind, degree)
    assert np.array_equal(np.asarray(mj.coordinates.dat),
                          np.asarray(mt.coordinates.dat))
    assert np.array_equal(mj.topology.cell_vertices,
                          mt.topology.cell_vertices)
    assert np.array_equal(Vj.cell_node_map, Vt.cell_node_map)
    assert Vj.dim == Vt.dim
    assert mj._structured == mt._structured


@pytest.mark.parametrize("mesh_kind,degree", CASES)
@pytest.mark.parametrize("sub", ["on_boundary", 1, (2, 3)])
def test_boundary_nodes_bit_equal(mesh_kind, degree, sub):
    _, Vj = _spaces(J, mesh_kind, degree)
    _, Vt = _spaces(T, mesh_kind, degree)
    assert np.array_equal(J.DirichletBC(Vj, 0, sub).dof_indices,
                          T.DirichletBC(Vt, 0, sub).dof_indices)


@pytest.mark.parametrize("cell", ["triangle", "tetrahedron"])
@pytest.mark.parametrize("qdeg", [1, 2, 4])
@pytest.mark.parametrize("degree", [1, 2])
def test_quadrature_and_tabulation_bit_equal(cell, qdeg, degree):
    pj, wj = j_rule(cell, qdeg)
    pt, wt = t_rule(cell, qdeg)
    assert np.array_equal(pj, pt) and np.array_equal(wj, wt)
    from firedrake_tpu.elements import make_scalar_element as ej
    from firedrake_tpu_torch.elements import make_scalar_element as et
    tj = j_tables(ej(cell, "CG", degree), pj, 1)
    tt = t_tables(et(cell, "CG", degree), pt, 1)
    assert tj.keys() == tt.keys()
    for d in tj:
        assert np.array_equal(tj[d], tt[d])


def test_preprocessed_integrand_and_degree_match():
    from firedrake_tpu.compiler.kernels import CompiledIntegral as CJ
    from firedrake_tpu_torch.compiler.kernels import CompiledIntegral as CT
    out = []
    for fd, CI in ((J, CJ), (T, CT)):
        mesh = fd.UnitSquareMesh(3, 3)
        V = fd.FunctionSpace(mesh, "CG", 2)
        u, v = fd.TrialFunction(V), fd.TestFunction(V)
        w = fd.Function(V)
        form = fd.Constant(2.0) * w * fd.inner(fd.grad(u), fd.grad(v)) \
            * fd.dx + u * v * fd.dx
        cis = [CI(it, v, u, mesh) for it in form.integrals()]
        out.append([(ci.degree, ci.integrand.signature()
                     if hasattr(ci.integrand, "signature") else
                     repr(ci.integrand)) for ci in cis])
    assert out[0] == out[1]
