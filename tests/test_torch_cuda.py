"""K1 and K2 on the card: each CUDA kernel (K1's action variant, K2's
large and huge variants and its pivoted mode included) against its plain
PyTorch version, the launch counts, and the matrix-free operator, the
gather route's matrix and vectors, Newton (assembled and matrix-free
Jacobians), the Krylov methods, the slope limiter, an RT1 x DG0 block
assembly and a hybridized and an SCPC solve (K2 on the Slate path),
Stokes by Vanka (K2's large variant) and by a Schur fieldsplit, line
smoothers on 65- and 129-dof columns, the adjoint's gradient and
Hessian action, the supermesh clipping, and Hiptmair and GTMG solves
(restriction by transposes kept as matrices of their own: equal CG
counts) on the card against the CPU.
Marked `cuda`; skips where torch
has no CUDA device.  Run on a machine with an NVIDIA GPU with
    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
(--noconftest: tests/conftest.py configures jax, which these tests do not
use and such a machine need not have).
"""
import numpy as np
import pytest
import torch

import firedrake_tpu_torch as T
from firedrake_tpu_torch.assemble import FormAssembler
from firedrake_tpu_torch.compiler import cell_eval as K
from firedrake_tpu_torch.ops import batched_inverse as BI

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True, scope="module")
def _cpu_by_default():
    T.set_device("cpu")


@pytest.fixture
def on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    T.set_device("cuda")
    yield
    T.set_device("cpu")


def _forms():
    """Forms of K1's two variants; the meshes of 37^2 and 5 x 7 x 3 cells
    per type are not multiples of the kernel's cells per block."""
    out = []
    for deg, mesh in ((1, T.UnitSquareMesh(64, 64)),
                      (2, T.UnitSquareMesh(32, 32)),
                      (1, T.UnitSquareMesh(37, 37)),
                      (2, T.UnitCubeMesh(5, 7, 3))):
        V = T.FunctionSpace(mesh, "CG", deg)
        u, v = T.TrialFunction(V), T.TestFunction(V)
        w = T.Function(V, val=torch.linspace(0.5, 1.5, V.dim,
                                                dtype=torch.float64))
        g = T.Function(V, val=torch.linspace(2.0, 1.0, V.dim,
                                                dtype=torch.float64))
        k1, k2 = T.Constant(1.5), T.Constant(-0.25)
        out += [(T.inner(T.grad(u), T.grad(v)) + u * v) * T.dx,
                T.Constant(3.0) * w * T.inner(T.grad(u), T.grad(v)) * T.dx,
                w * v * T.dx,
                (k1 * k2 * T.inner(T.grad(u), T.grad(v)) - k1 * u * v)
                * T.dx,
                (k1 * w * g * T.inner(T.grad(u), T.grad(v))
                 + k2 * g * u * v) * T.dx,
                (k1 * k2 * w * g * v + 3.0 * w * v) * T.dx]
    return out


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 2e-6)])
def test_kernel_matches_plain_on_card(on_cuda, dtype, rtol):
    for form in _forms():
        asm = FormAssembler(form)
        coords, coeffs, consts = asm._inputs()
        (ci,) = asm._compiled
        spec = K.family_spec(ci)
        cv = tuple(consts[c.count].to(dtype) for c in ci.constants)
        for t in range(asm._stencil.ntypes):
            ce, ws = asm._stencil.gather_cell_inputs(t, coords, coeffs, ci)
            ce, ws = ce.to(dtype), tuple(w.to(dtype) for w in ws)
            n0 = K.kernel_launches
            out = K.cell_eval(spec, ce, ws, cv)
            assert K.kernel_launches == n0 + 1
            ref = K.cell_eval_plain(spec, ce, ws, cv)
            err = float((out - ref).abs().max())
            assert err <= rtol * float(ref.abs().max()), err


def _action_forms():
    """action(a, z) of K1's action variant (and, with a coefficient
    besides z, of its quadrature variant) on P1/P2 triangles and tets."""
    out = []
    for deg, mesh in ((1, T.UnitSquareMesh(37, 37)),
                      (2, T.UnitSquareMesh(32, 32)),
                      (1, T.UnitCubeMesh(5, 7, 3)),
                      (2, T.UnitCubeMesh(5, 7, 3))):
        V = T.FunctionSpace(mesh, "CG", deg)
        u, v = T.TrialFunction(V), T.TestFunction(V)
        z = T.Function(V, val=torch.as_tensor(
            np.random.default_rng(deg).standard_normal(V.dim)))
        w = T.Function(V, val=torch.linspace(0.5, 1.5, V.dim,
                                                dtype=torch.float64))
        k = T.Constant(1.5)
        gg = T.inner(T.grad(u), T.grad(v))
        out += [T.action(a, z) for a in (
            gg * T.dx, (k * gg - 2.0 * u * v) * T.dx, w * gg * T.dx)]
    return out


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 2e-6)])
def test_action_kernel_matches_plain_on_card(on_cuda, dtype, rtol):
    modes = set()
    for form in _action_forms():
        asm = FormAssembler(form)
        coords, coeffs, consts = asm._inputs()
        (ci,) = asm._compiled
        spec = K.family_spec(ci)
        modes.add(spec.mode)
        cv = tuple(consts[c.count].to(dtype) for c in ci.constants)
        for t in range(asm._stencil.ntypes):
            ce, ws = asm._stencil.gather_cell_inputs(t, coords, coeffs, ci)
            ce, ws = ce.to(dtype), tuple(w.to(dtype) for w in ws)
            n0 = K.kernel_launches
            out = K.cell_eval(spec, ce, ws, cv)
            assert K.kernel_launches == n0 + 1
            ref = K.cell_eval_plain(spec, ce, ws, cv)
            err = float((out - ref).abs().max())
            assert err <= rtol * float(ref.abs().max()), err
    assert modes == {K.ACT, K.QUAD}


def test_matfree_matvec_on_card_matches_cpu(on_cuda):
    """The matrix-free P2-tet operator (K1's action variant on the card)
    against the same operator on the CPU (the plain version)."""
    from firedrake_tpu_torch.assembly.matfree import MatrixFreeOperator
    x = np.random.default_rng(0).standard_normal(
        T.FunctionSpace(T.UnitCubeMesh(6, 5, 4), "CG", 2).dim)
    out = []
    for dev in ("cpu", "cuda"):
        T.set_device(dev)
        V = T.FunctionSpace(T.UnitCubeMesh(6, 5, 4), "CG", 2)
        u, v = T.TrialFunction(V), T.TestFunction(V)
        A = MatrixFreeOperator(T.inner(T.grad(u), T.grad(v)) * T.dx)
        out.append((A.matvec(torch.as_tensor(x, device=dev)).cpu(),
                    A.diagonal().cpu()))
    for a, b in zip(*out):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float64, 1e-12, 0.0),
                                             (torch.float32, 2e-6, 1e-7)])
def test_batched_inv_matches_plain_on_card(on_cuda, dtype, rtol, atol):
    for n in (4, 7, 15, 19, 32):
        B = np.random.default_rng(n).standard_normal((1000, n, n))
        A = torch.as_tensor(B @ B.transpose(0, 2, 1) + n * np.eye(n),
                            dtype=dtype, device="cuda")
        n0 = BI.kernel_launches
        out = BI.batched_inv(A)
        assert BI.kernel_launches == n0 + 1
        ref = BI.batched_inv_plain(A)
        err = float((out - ref).abs().max())
        assert err <= rtol * float(ref.abs().max()) + atol, err


def _ragged(n):
    """Batch sizes that fill no warp, team, block or grid: 1 and 3, and
    for the warp variant 4097; for the large variant three blocks past a
    full grid (the blocks per SM that its last launch, at this n and
    dtype, reported, times the SMs)."""
    yield 1
    yield 3
    if BI.variant(n) == "warp":
        yield 4097
    else:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        yield BI.large_report["blocks_per_sm"] * sms + 3


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_inv_every_n_and_ragged_batches_on_card(on_cuda, dtype):
    """Every n of the warp and large variants (4 to 128), at batch sizes
    that fill no warp, team, block or grid: the kernel rounds as the
    plain version does, so the two are equal (signed zeros cleared by
    adding 0.0)."""
    for n in range(4, BI.LARGE_N + 1):
        for nb in _ragged(n):
            B = np.random.default_rng(n * nb).standard_normal((nb, n, n))
            A = torch.as_tensor(B @ B.transpose(0, 2, 1) + n * np.eye(n),
                                dtype=dtype, device="cuda")
            out = BI.batched_inv(A) + 0.0
            ref = BI.batched_inv_plain(A) + 0.0
            assert torch.equal(out, ref), (n, nb)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_inv_large_pivoted_every_n_on_card(on_cuda, dtype):
    """The large variant's pivoted mode at every n from 33 to 128, on
    blocks with a zero leading entry at the same ragged batch sizes: bit
    for bit with the pivoted plain version, signed zeros aside."""
    for n in range(BI.WARP_N + 1, BI.LARGE_N + 1):
        for nb in _ragged(n):
            A = _needs_pivots(nb, n, n * nb + 1, dtype)
            p0 = BI.pivot_launches
            out = BI.batched_inv(A, pivot=True) + 0.0
            assert BI.pivot_launches == p0 + 1
            ref = BI.batched_inv_plain(A, pivot=True) + 0.0
            assert torch.equal(out, ref), (n, nb)


def test_moving_the_mesh_with_a_cuda_tensor(on_cuda):
    """mesh.coordinates.dat = a CUDA tensor, then assembly, equals the
    same move made with a CPU tensor."""
    out = []
    for dev in ("cpu", "cuda"):
        mesh = T.UnitSquareMesh(16, 16)
        V = T.FunctionSpace(mesh, "CG", 1)
        u, v = T.TrialFunction(V), T.TestFunction(V)
        X = torch.as_tensor(np.asarray(T.UnitSquareMesh(16, 16)
                                       ._vertex_coords)).reshape(-1)
        mesh.coordinates.dat = (X * 1.25 + 0.5).to(dev)
        A = T.assemble((T.inner(T.grad(u), T.grad(v)) + u * v) * T.dx)
        out.append((A.channels.cpu(), mesh.cell_volumes))
    assert torch.allclose(out[0][0], out[1][0], rtol=1e-12, atol=0)
    assert np.array_equal(out[0][1], out[1][1])


def test_batched_inv_large_variant_counts_on_card(on_cuda):
    A = torch.eye(40, dtype=torch.float64, device="cuda").repeat(5, 1, 1)
    n0, m0 = BI.kernel_launches, BI.large_launches
    assert torch.equal(BI.batched_inv(A), A)
    assert (BI.kernel_launches, BI.large_launches) == (n0 + 1, m0 + 1)
    # above n = 128 the huge variant, counted apart; no cap
    A = torch.eye(129, dtype=torch.float64, device="cuda").repeat(2, 1, 1)
    h0 = BI.huge_launches
    assert torch.equal(BI.batched_inv(A), A)
    assert (BI.kernel_launches, BI.large_launches, BI.huge_launches) == \
        (n0 + 2, m0 + 1, h0 + 1)


def _needs_pivots(nb, n, seed, dtype):
    A = np.random.default_rng(seed).standard_normal((nb, n, n))
    A[:, 0, 0] = 0.0
    return torch.as_tensor(A, dtype=dtype, device="cuda")


def _huge_gate(A, out, plain):
    """The huge variant's gate (chip_smoke.py's huge_gate: its blocked
    products sum in another order), asserted."""
    from chip_smoke import huge_gate
    g = huge_gate(A, out, plain, torch.linalg.inv(A))
    assert g["ok"], g


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_inv_huge_variant_matches_plain_on_card(on_cuda, dtype):
    """The huge variant (n > 128, blocked by panels of 64 columns) on SPD
    batches at ragged batch sizes, n one column past 4 w (257) and a batch
    of one at n = 700, held to the plain version by the library-relative
    gate, one launch counted per call."""
    for n, nb in ((129, 3), (256, 2), (257, 2), (513, 1), (200, 5),
                  (700, 1)):
        B = np.random.default_rng(n * nb).standard_normal((nb, n, n))
        A = torch.as_tensor(B @ B.transpose(0, 2, 1) + n * np.eye(n),
                            dtype=dtype, device="cuda")
        h0, k0 = BI.huge_launches, BI.kernel_launches
        out = BI.batched_inv(A)
        assert (BI.huge_launches, BI.kernel_launches) == (h0 + 1, k0 + 1)
        # per panel of 64 columns: the panel, the row copies, the update
        assert BI.huge_report == dict(kernels=3 * -(-n // 64), w=64, b=8,
                                      sub_panel="shared")
        _huge_gate(A, out, BI.batched_inv_plain(A))


@pytest.mark.parametrize("pivot", [False, True])
def test_batched_inv_huge_sub_panel_in_global_memory_on_card(on_cuda,
                                                             pivot):
    """Past n ~ 3,490 in float64 the panel's n x 8 sub-panel no longer
    fits shared memory and lives in global scratch: a batch of one at
    n = 3,600, SPD unpivoted and with a zero leading entry pivoted, held
    to the plain version by the gate; pivoted, the labels and the final
    relabelling add two kernels."""
    n = 3600
    rng = np.random.default_rng(n + pivot)
    B = rng.standard_normal((1, n, n))
    if pivot:
        B[:, 0, 0] = 0.0
    else:
        B = B @ B.transpose(0, 2, 1) + n * np.eye(n)
    A = torch.as_tensor(B, device="cuda")
    h0 = BI.huge_launches
    out = BI.batched_inv(A, pivot=pivot)
    assert BI.huge_launches == h0 + 1
    assert BI.huge_report == dict(kernels=3 * -(-n // 64) + 2 * pivot, w=64,
                                  b=8, sub_panel="global")
    _huge_gate(A, out, BI.batched_inv_plain(A, pivot=pivot))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_inv_pivoted_matches_plain_on_card(on_cuda, dtype):
    """The pivoted mode of each variant on blocks that need pivots (a
    zero leading diagonal entry): the warp and large variants bit for bit
    with the pivoted plain version up to signed zeros, the huge variant
    (n = 130, 300) by its library-relative gate; within 1e-9 (f64) of
    torch.linalg.inv."""
    for n in (4, 7, 19, 32, 33, 65, 128, 130, 300):
        for nb in (1, 5):
            A = _needs_pivots(nb, n, n * nb, dtype)
            p0 = BI.pivot_launches
            out = BI.batched_inv(A, pivot=True) + 0.0
            assert BI.pivot_launches == p0 + 1
            ref = BI.batched_inv_plain(A, pivot=True) + 0.0
            if BI.variant(n) == "huge":
                _huge_gate(A, out, ref)
            else:
                assert torch.equal(out, ref), (n, nb)
            if dtype == torch.float64:
                lib = torch.linalg.inv(A)
                err = float((out - lib).abs().max())
                assert err <= 1e-9 * float(lib.abs().max()), (n, err)


def test_gather_route_on_card_matches_cpu(on_cuda):
    """The gather route on the card (K1 for the cell terms, the vmapped
    facet kernels, the gather tables) against the CPU: the SIPG matrix
    and a load vector on DG1 over UnitDiskMesh(3), a 0-form, and the
    Matrix's matvec."""
    out = []
    for dev in ("cpu", "cuda"):
        T.set_device(dev)
        mesh = T.UnitDiskMesh(3)
        V = T.FunctionSpace(mesh, "DG", 1)
        u, v = T.TrialFunction(V), T.TestFunction(V)
        n = T.FacetNormal(mesh)
        h = T.CellDiameter(mesh)
        w = T.Function(V, val=torch.linspace(0.5, 1.5, V.dim,
                                                dtype=torch.float64))
        a = T.inner(T.grad(u), T.grad(v)) * T.dx \
            - T.inner(T.avg(T.grad(u)), T.jump(v, n)) * T.dS \
            - T.inner(T.jump(u, n), T.avg(T.grad(v))) * T.dS \
            + 10.0 / T.avg(h) * T.inner(T.jump(u, n), T.jump(v, n)) * T.dS \
            + 10.0 / h * u * v * T.ds
        L = w * v * T.dx + T.jump(v) * T.avg(w) * T.dS + w * v * T.ds
        n0 = K.kernel_launches
        A = T.assemble(a)
        b = T.assemble(L)
        if dev == "cuda":
            assert K.kernel_launches == n0 + 2
        x = torch.linspace(-1.0, 1.0, V.dim, dtype=torch.float64,
                           device=dev)
        out.append((A.data.cpu(), b.dat.cpu(), A.matvec(x).cpu(),
                    torch.tensor(T.assemble(w * w * T.dx + w("+") * T.dS))))
    for a, b in zip(*out):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


def _newton_on(dev, mat_type):
    """chip_smoke.py's newton_p1_1m problem at UnitSquareMesh(8) (two
    levels, CG + GMG) on one device: (Newton iterations, KSP iterations
    per step, solution on the host)."""
    T.set_device(dev)
    mesh = T.MeshHierarchy(T.UnitSquareMesh(4, 4), 1).meshes[-1]
    V = T.FunctionSpace(mesh, "CG", 1)
    x, y = T.SpatialCoordinate(mesh)
    s = T.sin(T.pi * x) * T.sin(T.pi * y)
    f = T.Function(V).interpolate(2 * T.pi ** 2 * s + s * s)
    u, v = T.Function(V), T.TestFunction(V)
    F = T.inner(T.grad(u), T.grad(v)) * T.dx + u * u * v * T.dx \
        - f * v * T.dx
    solver = T.NonlinearVariationalSolver(
        T.NonlinearVariationalProblem(
            F, u, bcs=T.DirichletBC(V, 0, "on_boundary")),
        solver_parameters={"snes_rtol": 1e-10, "ksp_type": "cg",
                           "ksp_rtol": 1e-8, "pc_type": "mg",
                           "mat_type": mat_type})
    K.lowerer_evals = 0
    n0 = K.kernel_launches
    solver.solve()
    assert solver.converged and K.lowerer_evals == 0
    if dev == "cuda":
        assert u.dat.is_cuda and K.kernel_launches > n0
    return (solver.snes_iterations,
            [h["ksp_iterations"] for h in solver.history], u.dat.cpu())


@pytest.mark.parametrize("mat_type", ["aij", "matfree"])
def test_newton_on_card_matches_cpu(on_cuda, mat_type):
    """Newton with an assembled or matrix-free Jacobian on the card (K1 for
    the residual, the Jacobian and its action) against the CPU: the same
    Newton and CG counts, the solution within 1e-12."""
    nc, kc, uc = _newton_on("cpu", mat_type)
    ng, kg, ug = _newton_on("cuda", mat_type)
    assert (ng, kg) == (nc, kc)
    assert float((ug - uc).abs().max()) <= 1e-12 * float(uc.abs().max())


@pytest.mark.parametrize("method", ["gmres", "fgmres", "bicgstab",
                                    "minres"])
def test_krylov_on_card_matches_cpu(on_cuda, method):
    """GMRES (and FGMRES, BiCGStab, MINRES) with Jacobi on the card against
    the CPU on a non-symmetric operator: equal iteration counts (the
    Hessenberg and rotations are float64 on the host either way), the
    solution within 1e-10."""
    out = []
    for dev in ("cpu", "cuda"):
        T.set_device(dev)
        mesh = T.UnitSquareMesh(16, 16)
        V = T.FunctionSpace(mesh, "CG", 1)
        u, v = T.TrialFunction(V), T.TestFunction(V)
        a = (T.inner(T.grad(u), T.grad(v)) + u * v
             + T.inner(T.dot(T.Constant([4.0, 2.0]), T.grad(u)), v)) * T.dx
        uh = T.Function(V)
        solver = T.LinearVariationalSolver(
            T.LinearVariationalProblem(a, v * T.dx, uh,
                                       bcs=T.DirichletBC(V, 0, (1, 3))),
            solver_parameters={"ksp_type": method, "pc_type": "jacobi",
                               "ksp_rtol": 1e-10})
        solver.solve()
        assert solver.converged
        out.append((solver.ksp_iterations, uh.dat.cpu()))
    assert out[0][0] == out[1][0]
    assert float((out[1][1] - out[0][1]).abs().max()) \
        <= 1e-10 * float(out[0][1].abs().max())


def _limited_on(dev):
    T.set_device(dev)
    mesh = T.UnitSquareMesh(20, 20)
    V = T.FunctionSpace(mesh, "DG", 1)
    f = T.Function(V, val=np.random.default_rng(6).standard_normal(V.dim))
    T.VertexBasedLimiter(V).apply(f)
    return f.dat


def test_limiter_on_card_matches_cpu(on_cuda):
    """VertexBasedLimiter's three passes (cell means, the vertex max/min
    by scatter_reduce, the per-cell scaling) on the card: bit for bit
    with the CPU (min/max and the scaling do not depend on order)."""
    dc = _limited_on("cpu")
    dg = _limited_on("cuda")
    assert dg.is_cuda
    assert float((dg.cpu() - dc).abs().max()) <= 1e-15


def _mixed_on(dev):
    T.set_device(dev)
    mesh = T.UnitSquareMesh(12, 12)
    W = T.FunctionSpace(mesh, "RT", 1) * T.FunctionSpace(mesh, "DG", 0)
    sigma, u = T.TrialFunctions(W)
    tau, v = T.TestFunctions(W)
    X = T.SpatialCoordinate(mesh)
    A = T.assemble((T.dot(sigma, tau) + T.div(tau) * u + T.div(sigma) * v)
                   * T.dx)
    b = T.assemble(T.sin(X[0]) * v * T.dx
                   + T.dot(T.as_vector([X[1], 1.0]), tau) * T.dx)
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(W.dim),
                        device=dev)
    w = T.Function(W)
    T.solve((T.dot(sigma, tau) + T.div(tau) * u + T.div(sigma) * v) * T.dx
            == T.sin(X[0]) * v * T.dx, w,
            solver_parameters={"ksp_type": "gmres", "pc_type": "jacobi",
                               "ksp_rtol": 1e-10})
    return A, b.dat, A.matvec(x), w.dat


def test_rt_dg0_block_assembly_on_card_matches_cpu(on_cuda):
    """RT1 x DG0 on the card: the three blocks (Piola maps and dof signs
    applied on the card, the torch lowerer), the right-hand side, the
    BlockMatrix matvec and a GMRES + Jacobi solve against the CPU."""
    Ac, bc, yc, wc = _mixed_on("cpu")
    Ag, bg, yg, wg = _mixed_on("cuda")
    assert sorted(Ag.blocks) == sorted(Ac.blocks)
    for k in Ac.blocks:
        assert Ag.blocks[k].data.is_cuda
        ref = float(Ac.blocks[k].data.abs().max())
        assert float((Ag.blocks[k].data.cpu() - Ac.blocks[k].data).abs()
                     .max()) <= 1e-12 * ref
    for g, c in ((bg, bc), (yg, yc), (wg, wc)):
        assert g.is_cuda
        assert float((g.cpu() - c).abs().max()) \
            <= 1e-10 * float(c.abs().max())


def _slate_solves_on(device):
    """A hybridized RT2 x DG1 solve on UnitSquareMesh(8) (the packed
    local blocks are 11 x 11: K2 runs) and an SCPC P5 solve on
    UnitSquareMesh(4) (6 interior dofs per cell: K2 runs), on `device`;
    returns both solutions and K2's launches in each."""
    T.set_device(device)
    import math
    mesh = T.UnitSquareMesh(8, 8)
    W = T.FunctionSpace(mesh, "RT", 2) * T.FunctionSpace(mesh, "DG", 1)
    sigma, u = T.TrialFunctions(W)
    tau, v = T.TestFunctions(W)
    X = T.SpatialCoordinate(mesh)
    f = T.Function(W.subspaces[1]).interpolate(
        2 * math.pi ** 2 * T.sin(math.pi * X[0]) * T.sin(math.pi * X[1]))
    w = T.Function(W)
    n0 = BI.kernel_launches
    T.solve((T.dot(sigma, tau) - u * T.div(tau) - T.div(sigma) * v) * T.dx
            == -T.inner(f, v) * T.dx, w,
            solver_parameters={"ksp_type": "preonly",
                               "pc_type": "hybridization",
                               "hybridization": {"ksp_type": "preonly"}})
    n1 = BI.kernel_launches
    V = T.FunctionSpace(T.UnitSquareMesh(4, 4), "CG", 5)
    p, q = T.TrialFunction(V), T.TestFunction(V)
    Y = T.SpatialCoordinate(V.mesh())
    uh = T.Function(V)
    T.solve(T.inner(T.grad(p), T.grad(q)) * T.dx
            == T.sin(math.pi * Y[0]) * T.sin(math.pi * Y[1]) * q * T.dx, uh,
            bcs=[T.DirichletBC(V, 0.0, "on_boundary")],
            solver_parameters={"ksp_type": "preonly", "pc_type": "scpc",
                               "condensed_field": {"ksp_type": "cg",
                                                   "pc_type": "jacobi",
                                                   "ksp_rtol": 1e-13}})
    return w.dat, uh.dat, n1 - n0, BI.kernel_launches - n1


def test_hybridized_and_scpc_solves_on_card_match_cpu(on_cuda):
    """Slate on the card: the hybridized solve launches K2 four times
    (A^-1 for S and for E, the Solve for each field), SCPC once (the
    interior blocks); both solutions within 1e-10 of the CPU's."""
    wc, uc, _, _ = _slate_solves_on("cpu")
    wg, ug, k2_hyb, k2_scpc = _slate_solves_on("cuda")
    assert (k2_hyb, k2_scpc) == (4, 1)
    for g, c in ((wg, wc), (ug, uc)):
        assert g.is_cuda
        assert float((g.cpu() - c).abs().max()) \
            <= 1e-10 * float(c.abs().max())


def _extruded_case():
    """A column-plan operator on extruded hexes (with Dirichlet rows), a
    Q3 spectral operator on quads (gather route), an HDiv prism mass
    matrix and a prism facet vector, as host arrays."""
    m = T.ExtrudedMesh(T.UnitSquareMesh(3, 3, quadrilateral=True), 3)
    V = T.FunctionSpace(m, "CG", 2)
    u, v = T.TrialFunction(V), T.TestFunction(V)
    X = T.SpatialCoordinate(m)
    f = T.Function(V).interpolate(1 + X[0] * X[2])
    bc = T.DirichletBC(V, 0.0, "top")
    A = T.assemble((T.inner(T.grad(u), T.grad(v)) + f * u * v) * T.dx,
                   bcs=[bc])
    x = torch.linspace(-1.0, 1.0, V.dim, dtype=torch.float64,
                       device=A.data.device)
    q = T.UnitSquareMesh(4, 4, quadrilateral=True)
    Q = T.FunctionSpace(q, "CG", 3)
    S = FormAssembler((T.inner(T.grad(T.TrialFunction(Q)),
                               T.grad(T.TestFunction(Q)))
                       + T.TrialFunction(Q) * T.TestFunction(Q)) * T.dx,
                      use_stencil=False)
    p = T.ExtrudedMesh(T.UnitSquareMesh(3, 3), 2)
    W = T.FunctionSpace(p, T.HDiv(T.TensorProductElement(
        T.FiniteElement("BDM", "triangle", 1),
        T.FiniteElement("DG", "interval", 0))))
    M = T.assemble(T.dot(T.TestFunction(W), T.TrialFunction(W)) * T.dx)
    P = T.FunctionSpace(p, "CG", 1)
    Y = T.SpatialCoordinate(p)
    t = T.TestFunction(P)
    b = T.assemble(Y[0] * t * T.ds + Y[0] * T.avg(t) * T.dS)
    return (A.to_dense(), A.matvec(x).cpu().numpy(),
            A.transpose_matvec(x).cpu().numpy(), S.assemble().to_dense(),
            M.to_dense(), b.dat.cpu().numpy(), A.data.device,
            S._statics[0]["spectral"] is not None)


def test_extruded_and_spectral_on_card_match_cpu(on_cuda):
    """The column plan (its ColumnMatrix, matvec and transpose), the
    sum-factorised plan, an HDiv prism mass matrix and prism facet
    integrals on the card, within 1e-12 of the CPU; K1 and K2 launch on
    none of them."""
    K.kernel_launches = BI.kernel_launches = 0
    card = _extruded_case()
    assert card[6].type == "cuda" and card[7]
    assert K.kernel_launches == 0 and BI.kernel_launches == 0
    T.set_device("cpu")
    cpu = _extruded_case()
    for a, b in zip(card[:6], cpu[:6]):
        assert np.abs(a - b).max() <= 1e-12 * max(np.abs(b).max(), 1.0)


def _stokes_solves_on(device):
    """Taylor-Hood Stokes on UnitSquareMesh(6) (Poiseuille data) by
    fgmres with the Vanka patches (K2's large variant, n = 39) and with
    a Schur fieldsplit (MassInvPC, K1's pressure mass); the solutions on
    the host and the large variant's launches of the Vanka solve."""
    T.set_device(device)
    mesh = T.UnitSquareMesh(6, 6)
    V = T.VectorFunctionSpace(mesh, "CG", 2)
    Q = T.FunctionSpace(mesh, "CG", 1)
    W = V * Q
    u, p = T.TrialFunctions(W)
    v, q = T.TestFunctions(W)
    a = (T.inner(T.grad(u), T.grad(v)) - p * T.div(v) - q * T.div(u)) * T.dx
    X = T.SpatialCoordinate(mesh)
    g = T.Function(V).interpolate(T.as_vector([X[1] * (1 - X[1]), 0.0]))
    L = T.inner(T.Constant([0.0, 0.0]), v) * T.dx
    bcs = [T.DirichletBC(W.sub(0), g, (1, 2, 3, 4))]
    out = []
    for sp in ({"ksp_type": "fgmres", "ksp_rtol": 1e-10,
                "pc_type": "vanka"},
               {"ksp_type": "fgmres", "ksp_rtol": 1e-10,
                "pc_type": "fieldsplit", "pc_fieldsplit_type": "schur",
                "fieldsplit_0_pc_type": "lu",
                "fieldsplit_1_pc_type": "python",
                "fieldsplit_1_pc_python_type": "firedrake.MassInvPC"}):
        w = T.Function(W)
        n0 = BI.large_launches
        T.solve(a == L, w, bcs=bcs, solver_parameters=sp)
        out += [w.dat, BI.large_launches - n0]
    return out


def test_vanka_and_fieldsplit_solves_on_card_match_cpu(on_cuda):
    """The Vanka solve launches K2's large variant once (the 49 patches);
    both solutions on the card within 1e-10 of the CPU's."""
    wc, _, fc, _ = _stokes_solves_on("cpu")
    wg, k2_vanka, fg, k2_fs = _stokes_solves_on("cuda")
    assert (k2_vanka, k2_fs) == (1, 0)
    for g, c in ((wg, wc), (fg, fc)):
        assert g.is_cuda
        assert float((g.cpu() - c).abs().max()) \
            <= 1e-10 * float(c.abs().max())


def test_patch_plan_built_on_card_is_the_host_plan(on_cuda):
    """The patch PC's accumulation plan, sorted on the card, holds the
    host plan's tables entry for entry (vertex stars of P2 on
    UnitSquareMesh(16))."""
    from firedrake_tpu_torch.assemble import (_accumulation,
                                              _accumulation_device)
    from firedrake_tpu_torch.solvers.preconditioners import star_patches
    T.set_device("cpu")
    V = T.FunctionSpace(T.UnitSquareMesh(16, 16), "CG", 2)
    idx, mask = star_patches(V)
    pos = np.where(mask > 0, idx, V.dim).reshape(-1)
    host = _accumulation(pos, V.dim, torch.device("cpu"))
    card = _accumulation_device(torch.as_tensor(pos, device="cuda"), V.dim)
    assert type(card) is type(host)
    for name, want in vars(host).items():
        got = getattr(card, name)
        assert (got is None and want is None) or (
            got.is_cuda and got.dtype == want.dtype
            and torch.equal(got.cpu(), want)), name


def _line_solve_on(device, layers):
    """Q1 on ExtrudedMesh(UnitSquareMesh(4, quadrilateral=True), layers),
    -lap u = 1, u = 0 on the sides, top and bottom, by CG with the line
    smoother (one (layers + 1)-dof column per base vertex); the solution
    on the host and the large and huge variants' launches."""
    T.set_device(device)
    mesh = T.ExtrudedMesh(T.UnitSquareMesh(4, 4, quadrilateral=True), layers)
    V = T.FunctionSpace(mesh, "CG", 1)
    u, v = T.TrialFunction(V), T.TestFunction(V)
    bcs = [T.DirichletBC(V, 0.0, s) for s in ("on_boundary", "top",
                                               "bottom")]
    w = T.Function(V)
    n0, h0 = BI.large_launches, BI.huge_launches
    T.solve(T.inner(T.grad(u), T.grad(v)) * T.dx == T.Constant(1.0) * v
            * T.dx, w, bcs=bcs, solver_parameters={
                "ksp_type": "cg", "ksp_rtol": 1e-10, "pc_type": "linesmooth",
                "pc_linesmooth_codims": "2"})
    return w.dat.cpu(), BI.large_launches - n0, BI.huge_launches - h0


def test_line_patches_on_card_match_plain_and_cpu(on_cuda):
    """K2's large variant on a real line patch set: the 25 columns of 65
    dofs of a Q1 slab, gathered on the card by ColumnMatrix.entries (bit
    for bit with its scipy copy), inverted bit for bit with the plain
    version up to signed zeros; the line-smoothed CG solve on the card
    within 1e-10 of the CPU's with one large launch; with 129-dof
    columns the line solve converges on the huge variant, within 1e-10 of
    the CPU's."""
    from firedrake_tpu_torch.solvers.asm import _column_patches
    from firedrake_tpu_torch.solvers.preconditioners import patch_matrices
    mesh = T.ExtrudedMesh(T.UnitSquareMesh(4, 4, quadrilateral=True), 64)
    V = T.FunctionSpace(mesh, "CG", 1)
    u, v = T.TrialFunction(V), T.TestFunction(V)
    A = T.assemble(T.inner(T.grad(u), T.grad(v)) * T.dx,
                   bcs=T.DirichletBC(V, 0.0, "top"))
    idx, mask = _column_patches(V, [2])
    Ap = patch_matrices(A, idx, mask)
    assert Ap.is_cuda and tuple(Ap.shape) == (25, 65, 65)
    ref = np.stack([A.to_scipy()[np.ix_(p, p)].toarray() for p in idx])
    assert np.array_equal(Ap.cpu().numpy(), ref)
    n0 = BI.large_launches
    out = BI.batched_inv(Ap)
    assert BI.large_launches - n0 == 1
    assert torch.equal(out + 0.0, BI.batched_inv_plain(Ap) + 0.0)
    wc, _, _ = _line_solve_on("cpu", 64)
    wg, launches, huge = _line_solve_on("cuda", 64)
    assert (launches, huge) == (1, 0)
    assert float((wg - wc).abs().max()) <= 1e-10 * float(wc.abs().max())
    wc, _, _ = _line_solve_on("cpu", 128)
    wg, launches, huge = _line_solve_on("cuda", 128)
    assert (launches, huge) == (0, 1)
    assert float((wg - wc).abs().max()) <= 1e-10 * float(wc.abs().max())


def _inversion_on(device, n=32):
    """demos/poisson_inversion.py's functional at f = x y on the finest
    mesh of a two-level hierarchy, every solve CG + GMG to rtol 1e-12:
    (gradient, Hessian action, K1 launches during the gradient), on
    ``device``."""
    import firedrake_tpu_torch.adjoint as adj
    T.set_device(device)
    mesh = T.MeshHierarchy(T.UnitSquareMesh(n // 2, n // 2), 1)[-1]
    V = T.FunctionSpace(mesh, "CG", 1)
    X = T.SpatialCoordinate(mesh)
    bcs = [T.DirichletBC(V, 0.0, "on_boundary")]
    u, v = T.TrialFunction(V), T.TestFunction(V)
    a = T.inner(T.grad(u), T.grad(v)) * T.dx
    sp = {"ksp_type": "cg", "ksp_rtol": 1e-12, "pc_type": "mg"}
    u_obs = T.Function(V)
    T.solve(a == T.sin(3 * X[0]) * X[1] * v * T.dx, u_obs, bcs=bcs,
            solver_parameters=sp)
    f = T.Function(V).interpolate(X[0] * X[1])
    tape = adj.set_working_tape(adj.Tape())
    adj.continue_annotation()
    w = T.Function(V)
    T.solve(a == f * v * T.dx, w, bcs=bcs, solver_parameters=sp)
    J = T.assemble(0.5 * (w - u_obs) ** 2 * T.dx + 5e-7 * f ** 2 * T.dx)
    adj.pause_annotation()
    rf = adj.ReducedFunctional(J, adj.Control(f), tape=tape)
    n0 = K.kernel_launches
    g = rf.derivative().dat
    k1 = K.kernel_launches - n0
    H = rf.hessian(T.Function(V).interpolate(T.cos(X[1]))).dat
    assert g.device.type == H.device.type == torch.device(device).type
    return g.cpu(), H.cpu(), k1


def test_adjoint_gradient_and_hessian_on_card_match_cpu(on_cuda):
    """The tape on the card (device snapshots, the adjoint, tangent and
    second-order solves by CG + GMG, K1 on their forms) within 1e-10 of
    the same tape on the CPU."""
    gc, Hc, _ = _inversion_on("cpu")
    gg, Hg, k1 = _inversion_on("cuda")
    assert k1 > 0
    for ours, ref in ((gg, gc), (Hg, Hc)):
        assert float((ours - ref).abs().max()) <= 1e-10 * float(
            ref.abs().max())


def _point_set(mesh, n, seed):
    """n seeded points: uniform ones, every 7th vertex, facet midpoints
    and a few outside the domain."""
    rng = np.random.default_rng(seed)
    vc = mesh._vertex_coords
    fv = mesh.topology.facet_vertices
    g = vc.shape[1]
    return np.concatenate([rng.random((n, g)), vc[::7],
                           vc[fv[::5]].mean(axis=1),
                           1.0 + rng.random((8, g))])


@pytest.mark.parametrize("cell", ["triangle", "quadrilateral",
                                  "tetrahedron", "curved"])
def test_point_location_and_evaluation_on_card_match_cpu(on_cuda, cell):
    """pointeval on the card against the CPU: the located cells equal and
    the values within 1e-14 of max|u|, on a few thousand points with exact
    vertices and facet midpoints (affine, bilinear, tetrahedral and
    P2-coordinate cells), and a VertexOnlyMesh's interpolation and misfit
    on the card against the CPU's."""
    from firedrake_tpu_torch import pointeval as PE
    T.set_device("cpu")
    if cell == "tetrahedron":
        mesh = T.UnitCubeMesh(6, 5, 4)
    elif cell == "curved":
        base = T.UnitSquareMesh(8, 8)
        X = T.SpatialCoordinate(base)
        Vc = T.VectorFunctionSpace(base, "CG", 2)
        mesh = T.Mesh(T.Function(Vc).interpolate(T.as_vector(
            [X[0] + 0.05 * T.sin(np.pi * X[0]) * T.sin(np.pi * X[1]),
             X[1]])))
    else:
        mesh = T.UnitSquareMesh(12, 10,
                                quadrilateral=cell == "quadrilateral")
    V = T.FunctionSpace(mesh, "CG", 2)
    x = T.SpatialCoordinate(mesh)
    u = T.Function(V).interpolate(T.cos(3 * x[0]) * (1 + x[1] ** 2))
    pts = _point_set(mesh, 3000, seed=len(cell))
    cells_cpu, refs_cpu = PE._locate(mesh, pts)
    vals_cpu = u.at(pts, dont_raise=True)
    vom_cpu = T.VertexOnlyMesh(mesh, pts, missing_points_behaviour="ignore")
    uv_cpu = T.interpolate(u, T.FunctionSpace(vom_cpu, "DG", 0))
    J_cpu = T.assemble(uv_cpu ** 2 * T.dx)
    T.set_device("cuda")
    cells, refs = PE._locate(mesh, pts)
    assert refs.is_cuda
    vals = u.at(pts, dont_raise=True)
    vom = T.VertexOnlyMesh(mesh, pts, missing_points_behaviour="ignore")
    uv = T.interpolate(u, T.FunctionSpace(vom, "DG", 0))
    assert uv.dat.is_cuda
    J = T.assemble(uv ** 2 * T.dx)
    assert np.array_equal(cells, cells_cpu)
    assert (cells >= 0).sum() == len(pts) - 8
    scale = np.nanmax(np.abs(vals_cpu))
    assert np.array_equal(np.isnan(vals), np.isnan(vals_cpu))
    assert np.nanmax(np.abs(vals - vals_cpu)) <= 1e-14 * scale
    assert np.abs(uv.dat.cpu().numpy()
                  - uv_cpu.dat.numpy()).max() <= 1e-14 * scale
    assert abs(J - J_cpu) <= 1e-13 * J_cpu


def _mixed_mass(device, kind):
    T.set_device(device)
    if kind == "quad":
        mA = T.UnitSquareMesh(12, 10, quadrilateral=True)
        mB = T.UnitSquareMesh(9, 13, quadrilateral=True)
    else:
        mA, mB = T.UnitSquareMesh(12, 10), T.UnitSquareMesh(9, 13)
    M = T.assemble_mixed_mass_matrix(T.FunctionSpace(mA, "CG", 1),
                                     T.FunctionSpace(mB, "CG", 2))
    return M.sparsity, M.data.cpu().numpy()


@pytest.mark.parametrize("kind", ["triangle", "quad"])
def test_supermesh_clipping_on_card_matches_cpu(on_cuda, kind):
    """The mixed mass matrix of a few hundred cells each side, clipped on
    the card (and by batched Newton on quads), against the CPU."""
    sp_d, d = _mixed_mass("cuda", kind)
    sp_c, c = _mixed_mass("cpu", kind)
    assert np.array_equal(sp_d.coo_rows, sp_c.coo_rows)
    assert np.array_equal(sp_d.coo_cols, sp_c.coo_cols)
    assert np.abs(d - c).max() <= 1e-12 * np.abs(c).max()


def _transfer_solves(device):
    """GTMG's default transfer (restriction by the transpose as a matrix of
    its own) and HiptmairPC's G^T: CG counts and solutions."""
    T.set_device(device)
    out = []
    mesh = T.UnitSquareMesh(16, 16)
    V = T.FunctionSpace(mesh, "N1curl", 1)
    u, v = T.TrialFunction(V), T.TestFunction(V)
    f = T.Constant((1.0, 2.0))
    uh = T.Function(V)
    s = T.LinearVariationalSolver(
        T.LinearVariationalProblem(
            (T.inner(T.curl(u), T.curl(v)) + T.inner(u, v)) * T.dx,
            T.inner(f, v) * T.dx, uh,
            bcs=[T.DirichletBC(V, f, "on_boundary")]),
        solver_parameters={"ksp_type": "cg", "ksp_rtol": 1e-10,
                           "pc_type": "python",
                           "pc_python_type": "firedrake.HiptmairPC"})
    s.solve()
    out.append((s.ksp_iterations, uh.dat.cpu().numpy()))
    P1 = T.FunctionSpace(mesh, "CG", 1)
    RT = T.FunctionSpace(mesh, "RT", 1)
    DG = T.FunctionSpace(mesh, "DG", 0)
    W = T.MixedFunctionSpace([RT, DG])
    sigma, p = T.TrialFunctions(W)
    tau, q = T.TestFunctions(W)
    x = T.SpatialCoordinate(mesh)
    w = T.Function(W)
    s = T.LinearVariationalSolver(
        T.LinearVariationalProblem(
            (T.inner(sigma, tau) - T.inner(p, T.div(tau))
             + T.inner(T.div(sigma), q)) * T.dx,
            T.inner(T.sin(3 * x[0]) * x[1], q) * T.dx, w),
        solver_parameters={
            "pc_type": "hybridization",
            "hybridization": {"ksp_type": "cg", "ksp_rtol": 1e-10,
                              "pc_type": "python",
                              "pc_python_type": "firedrake.GTMGPC"}},
        appctx={"get_coarse_space": lambda: P1,
                "get_coarse_operator": lambda: T.inner(
                    T.grad(T.TrialFunction(P1)),
                    T.grad(T.TestFunction(P1))) * T.dx,
                "coarse_space_bcs": T.DirichletBC(P1, 0.0, "on_boundary")})
    s.solve()
    out.append((s.ksp_iterations, w.subfunctions[1].dat.cpu().numpy()))
    return out


def test_fixed_order_transposes_repeat_cpu_counts_on_card(on_cuda):
    """Restriction through Matrix.transpose sums in a fixed order: the CG
    counts of a Hiptmair and a GTMG solve on the card equal the CPU's."""
    for (its_d, ud), (its_c, uc) in zip(_transfer_solves("cuda"),
                                         _transfer_solves("cpu")):
        assert its_d == its_c
        assert np.abs(ud - uc).max() <= 1e-9 * np.abs(uc).max()
