"""p-multigrid, FAS, the nonlinear patch smoother and the column, line,
FDM and facet-split preconditioners of the port against the JAX package:
the degree-level transfers on seeded vectors, one application of each new
preconditioner to one seeded vector on a small operator (the same
operator, with the same Dirichlet rows, in both packages), the column
matrix's entries against its scipy copy, and whole nonlinear solves
(FAS over a mesh hierarchy and over degree levels, Newton with the
nonlinear patch smoother) on Bratu's problem with the JAX package's
cycle and iteration counts.

Tolerances: transfers and PC applications within 1e-12 max|ref| (f64);
ColumnMatrix.entries bit for bit; the nonlinear solves within 1e-10
max|ref| with equal counts."""
import threading

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
import jax

import firedrake_tpu as J
import firedrake_tpu_torch as T

RTOL = 1e-12

#: the JAX package's reference programs are compiled with XLA's
#: optimisations off (the results agree within the same tolerances); the
#: module's executables are dropped with it
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


def _close(ours, ref, rtol=RTOL):
    ours, ref = _np(ours), _np(ref)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max()
    assert err <= rtol * max(np.abs(ref).max(), 1e-300), err


def _vec(fd, n, seed):
    r = np.random.default_rng(seed).standard_normal(n)
    return jax.numpy.asarray(r) if fd is J else torch.as_tensor(r)


# -------------------------------------------------------- P-level transfers
TRANSFERS = {"p1_p2": (1, 2, 1), "p2_p4": (2, 4, 1), "vector_p1_p2":
             (1, 2, 2)}


@pytest.mark.parametrize("op", ["prolong", "restrict", "inject"])
@pytest.mark.parametrize("case", sorted(TRANSFERS))
def test_plevel_transfer_matches_jax(case, op, jax_refs):
    _close(_transfer(T, case, op), jax_refs(("transfer", (case, op))))


def _transfer(fd, case, op):
    """One P-level transfer applied to a seeded vector."""
    kc, kf, dim = TRANSFERS[case]
    mesh = fd.UnitSquareMesh(3, 3)
    if dim > 1:
        Vc, Vf = (fd.VectorFunctionSpace(mesh, "CG", k, dim=dim)
                  for k in (kc, kf))
    else:
        Vc, Vf = (fd.FunctionSpace(mesh, "CG", k) for k in (kc, kf))
    t = __import__(f"{fd.__name__}.mg.pmg",
                   fromlist=["x"]).PLevelTransfer(Vc, Vf)
    n = Vc.dim if op == "prolong" else Vf.dim
    return _np(getattr(t, op + "_fn")(_vec(fd, n, 5)))


# --------------------------------------------------------- PC applications
def _poisson(fd, mesh, degree, family="CG", bcs="on_boundary"):
    V = fd.FunctionSpace(mesh, family, degree)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    a = (fd.inner(fd.grad(u), fd.grad(v)) + 0.5 * u * v) * fd.dx
    bc = ([fd.DirichletBC(V, 0.0, bcs)] if bcs else [])
    return V, a, bc


def _dg_mass(fd, mesh):
    V = fd.FunctionSpace(mesh, "DG", 1)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    return V, (u * v + 0.1 * fd.inner(fd.grad(u), fd.grad(v))) * fd.dx, []


def _ext(fd, quad=True, n=2, layers=3):
    return fd.ExtrudedMesh(fd.UnitSquareMesh(n, n, quadrilateral=quad),
                           layers)


#: kind -> fd -> (V, a, bcs); four operators serve every case
KINDS = {
    "p4_hier": lambda fd: _poisson(
        fd, fd.MeshHierarchy(fd.UnitSquareMesh(2, 2), 1)[-1], 4),
    "q2_ext": lambda fd: _poisson(fd, _ext(fd), 2,
                                  bcs=("on_boundary", "bottom")),
    "dg1_ext": lambda fd: _dg_mass(fd, _ext(fd, quad=False)),
    "q3_quad": lambda fd: _poisson(
        fd, fd.UnitSquareMesh(4, 4, quadrilateral=True), 3),
}

_PY = {"pc_type": "python"}
_FS = dict(_PY, pc_python_type="firedrake.FacetSplitPC")
PC_CASES = {
    "pmg_dense": ("p4_hier", {"pc_type": "pmg"}),
    "pmg_mg_coarse": ("p4_hier", {
        "pc_type": "pmg", "pmg_mg_coarse_ksp_type": "preonly",
        "pmg_mg_coarse_pc_type": "mg",
        "pmg_mg_levels_ksp_max_it": 2}),
    "linesmooth_default": ("q2_ext", {"pc_type": "linesmooth"}),
    "linesmooth_codim2": ("q2_ext", {
        "pc_type": "linesmooth", "pc_linesmooth_codims": "2"}),
    "linesmooth_dg": ("dg1_ext", {
        "pc_type": "linesmooth", "pc_linesmooth_codims": "0"}),
    "linesmooth_python": ("q2_ext", dict(
        _PY, pc_python_type="firedrake.ASMLinesmoothPC",
        pc_linesmooth_codims="0,1,2")),
    "extruded_star": ("q2_ext", {"pc_type": "extruded_star"}),
    "gridline_all": ("p4_hier", {"pc_type": "gridline"}),
    "gridline_axis": ("p4_hier", {"pc_type": "gridline",
                                  "pc_gridline_axes": "1"}),
    "fdm": ("q3_quad", dict(_PY, pc_python_type="firedrake.FDMPC")),
    # the port reads fdm_no_coarse, the JAX package no_coarse (the
    # PC's prefix without fdm_): both are given
    "fdm_no_coarse": ("q3_quad", dict(
        _PY, pc_python_type="firedrake.FDMPC", fdm_no_coarse=True,
        no_coarse=True)),
    "p1pc": ("p4_hier", dict(_PY, pc_python_type="firedrake.P1PC")),
    "facet_split_schur": ("p4_hier", dict(
        _FS, facet_pc_type="fieldsplit",
        facet_pc_fieldsplit_type="schur",
        facet_fieldsplit_0_pc_type="lu", facet_fieldsplit_1_pc_type="lu")),
    "facet_split_additive": ("q3_quad", dict(
        _FS, facet_restriction_domain="facet,interior",
        facet_fieldsplit_0_pc_type="jacobi",
        facet_fieldsplit_1_pc_type="lu")),
}

_CTX = {}
_CTX_LOCKS = {}
_CTX_LOCK = threading.Lock()


def _ctx(fd, kind):
    """(OpCtx, dim) of one operator, made once per module and package (a
    PC only reads its context; a thread that needs an operator another
    is building waits for it)."""
    key = (fd.__name__, kind)
    with _CTX_LOCK:
        lock = _CTX_LOCKS.setdefault(key, threading.Lock())
    with lock:
        if key not in _CTX:
            _CTX[key] = _make_ctx(fd, kind)
    return _CTX[key]


def _make_ctx(fd, kind):
    V, a, bcs = KINDS[kind](fd)
    sol = __import__(f"{fd.__name__}.solving", fromlist=["x"])
    idx, _ = sol._bc_data(bcs, V.dim)
    A = fd.assemble(a)
    if len(idx):
        A = A.with_dirichlet(idx if fd is T else jax.numpy.asarray(idx))
    comp = __import__(f"{fd.__name__}.solvers.composition", fromlist=["x"])
    return comp.OpCtx(mat=A, space=V, form=a, bcs=bcs), V.dim


def _pc_application(fd, case):
    """One application of the case's PC to a seeded vector."""
    kind, params = PC_CASES[case]
    ctx, n = _ctx(fd, kind)
    comp = __import__(f"{fd.__name__}.solvers.composition", fromlist=["x"])
    return _np(comp.build_pc(ctx, dict(params))(_vec(fd, n, 3)))


@pytest.mark.parametrize("case", sorted(PC_CASES))
def test_pc_application_matches_jax(case, jax_refs):
    ours = _pc_application(T, case)
    assert np.isfinite(ours).all()
    _close(ours, jax_refs(("pc", case)))


def test_column_matrix_entries_bit_for_bit():
    """ColumnMatrix.entries against to_scipy()[np.ix_(p, p)] on Q2 line
    patches (a Dirichlet-modified operator, out-of-band pairs
    included)."""
    from firedrake_tpu_torch.assembly.columns import ColumnMatrix
    from firedrake_tpu_torch.solvers.asm import _column_patches
    ctx, _ = _ctx(T, "q2_ext")
    A = ctx.mat
    assert isinstance(A, ColumnMatrix)
    idx, mask = _column_patches(ctx.space, [0, 1, 2])
    rng = np.random.default_rng(1)
    idx = np.concatenate([idx, rng.integers(0, A.shape[0], idx.shape)])
    it = torch.as_tensor(idx)
    K = idx.shape[1]
    got = A.entries(it[:, :, None].expand(-1, K, K),
                    it[:, None, :].expand(-1, K, K)).numpy()
    Asp = A.to_scipy()
    ref = np.stack([Asp[np.ix_(p, p)].toarray() for p in idx])
    assert np.array_equal(got.view(np.int64), ref.view(np.int64))


#: (operator, ASM class, options) of the patch-list comparison
PATCH_CASES = (
    ("q2_ext", "ASMLinesmoothPC", {"pc_linesmooth_codims": "0,1,2"}),
    ("q2_ext", "ASMExtrudedStarPC", {}),
    ("dg1_ext", "ASMLinesmoothPC", {"pc_linesmooth_codims": "0"}),
    ("p4_hier", "ASMGridLinePC", {"pc_gridline_axes": "1,0"}))


def _jax_patches(i):
    """The JAX package's patches of PATCH_CASES[i], in its order (captured
    at its _batched_patch_pc)."""
    kind, cls, prm = PATCH_CASES[i]
    seen = []
    jp = __import__("firedrake_tpu.solvers.preconditioners",
                    fromlist=["x"])
    jasm = __import__("firedrake_tpu.solvers.asm", fromlist=["x"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jp, "_batched_patch_pc",
                   lambda Asp, patches: seen.append(patches))
        getattr(jasm, cls)().initialize_ctx(_ctx(J, kind)[0], prm, "")
    (patches,) = seen
    return [list(map(int, p)) for p in patches]


def test_line_patch_lists_match_jax(jax_refs):
    """The port's padded column, star and grid-line lists hold the JAX
    package's patches in its order (captured once no thread builds a JAX
    preconditioner: the capture swaps a module function)."""
    from firedrake_tpu_torch.solvers import asm
    for case in PC_CASES:
        jax_refs(("pc", case))
    for i, (kind, cls, prm) in enumerate(PATCH_CASES):
        V = _ctx(T, kind)[0].space
        if cls == "ASMExtrudedStarPC":
            idx, mask = asm.extruded_star_patches(V)
        elif cls == "ASMGridLinePC":
            idx, mask = asm.grid_line_patches(V, [1, 0])
        else:
            idx, mask = asm._column_patches(
                V, [int(c) for c in prm["pc_linesmooth_codims"].split(",")])
        ours = [list(r[m > 0]) for r, m in zip(idx, mask)]
        assert ours == _jax_patches(i), cls


def test_multiplicative_star_patch_raises():
    from firedrake_tpu_torch.solvers.preconditioners import make_star_patch
    ctx, _ = _ctx(T, "p4_hier")
    with pytest.raises(NotImplementedError, match="item 16"):
        make_star_patch(ctx.mat, ctx.space, multiplicative=True)


def test_k2_cap_names_the_patches():
    """K2 has no cap on n: the card's variant is the warp one to n = 32,
    the large one to 128 and the huge one above (the 129-dof line
    patches), and the kernel wrapper refuses a CPU tensor before any
    build or launch (the CPU takes the plain version)."""
    from firedrake_tpu_torch.ops import batched_inverse as BI
    assert [BI.variant(n) for n in (4, 32, 33, 65, 128, 129, 2145)] == \
        ["warp", "warp", "large", "large", "large", "huge", "huge"]
    n0 = BI.kernel_launches
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        BI._launch(torch.zeros((3, 129, 129), dtype=torch.float64))
    assert BI.kernel_launches == n0


# -------------------------------------------------------- nonlinear solves
def _bratu(fd, degree, params, hier=True):
    """Bratu, -lap u - 2 exp(u) = 0, u = 0 on the boundary, on
    MeshHierarchy(UnitSquareMesh(4), 1)'s fine mesh."""
    mesh = (fd.MeshHierarchy(fd.UnitSquareMesh(4, 4), 1)[-1] if hier
            else fd.UnitSquareMesh(4, 4))
    V = fd.FunctionSpace(mesh, "CG", degree)
    u, v = fd.Function(V), fd.TestFunction(V)
    F = (fd.inner(fd.grad(u), fd.grad(v)) - 2.0 * fd.exp(u) * v) * fd.dx
    solver = fd.NonlinearVariationalSolver(
        fd.NonlinearVariationalProblem(
            F, u, bcs=[fd.DirichletBC(V, 0.0, "on_boundary")]),
        solver_parameters=params)
    solver.solve()
    return solver.snes_iterations, solver.converged, _np(u.dat)


SNES_CASES = {
    "fas_h_p1": (1, {"snes_type": "fas", "snes_rtol": 1e-8}),
    "pfas_p2": (2, {"snes_type": "pfas", "snes_rtol": 1e-8}),
    "pmgsnes_p2": (2, {"snes_type": "python", "snes_rtol": 1e-8,
                       "snes_python_type": "firedrake.PMGSNES"}),
    "npc_patch_p1": (1, {"npc_snes_type": "patch", "snes_rtol": 1e-8,
                         "ksp_type": "cg", "ksp_rtol": 1e-12,
                         "pc_type": "jacobi", "npc_snes_max_it": 2,
                         "npc_snes_linesearch_damping": 0.8}),
}


#: the JAX package's PMGSNES runs its pfas solver (firedrake_tpu/
#: solving.py:423-431), so the port's PMGSNES is held to that solve
_SAME_JAX = {"pmgsnes_p2": "pfas_p2"}


# ------------------------------------------------ the JAX package's side
#: the JAX package's results, in five threads started as the module's
#: tests start (XLA compiles with the GIL released, so they compile beside
#: each other and the port's side of the tests); the lists are balanced by
#: their compile times, and each program (the grid-line patches' K2, for
#: one) is compiled by one thread
JAX_TASKS = (
    [("pc", "pmg_mg_coarse"), ("pc", "facet_split_schur")],
    [("pc", "pmg_dense"), ("pc", "p1pc"), ("pc", "gridline_all"),
     ("pc", "gridline_axis")],
    [("pc", "extruded_star"), ("pc", "linesmooth_codim2"),
     ("pc", "linesmooth_default"), ("pc", "linesmooth_dg"),
     ("pc", "linesmooth_python")],
    [("transfer", (c, op)) for c in sorted(TRANSFERS)
     for op in ("prolong", "restrict", "inject")]
    + [("pc", "fdm"), ("pc", "fdm_no_coarse"),
       ("pc", "facet_split_additive")],
    [("snes", c) for c in sorted(SNES_CASES) if c not in _SAME_JAX])


def _jax_task(task):
    what, arg = task
    if what == "pc":
        return _pc_application(J, arg)
    if what == "transfer":
        return _transfer(J, *arg)
    deg, prm = SNES_CASES[arg]
    return _bratu(J, deg, prm)


class _Tasks(threading.Thread):
    """The JAX package's results of a list of tasks, computed in a thread
    started now, with a big stack (XLA:CPU's compiler recurses deeply on
    nested while-loop programs, as tests/conftest.py says of the main
    thread); ``get(task)`` waits for that task."""

    def __init__(self, tasks):
        super().__init__()
        self.tasks, self.out = tasks, {}
        self.done = threading.Condition()
        old = threading.stack_size(512 * 1024 * 1024)
        try:
            self.start()
        finally:
            threading.stack_size(old)

    def run(self):
        try:
            for task in self.tasks:
                out = _jax_task(task)
                with self.done:
                    self.out[task] = out
                    self.done.notify_all()
        finally:
            with self.done:
                self.tasks = ()
                self.done.notify_all()

    def get(self, task):
        with self.done:
            self.done.wait_for(lambda: task in self.out
                               or task not in self.tasks)
        assert task in self.out, f"{task} raised (see the thread's traceback)"
        return self.out[task]


@pytest.fixture(scope="module", autouse=True)
def jax_refs(_cpu):
    """jax_refs(task) -> the JAX package's result (waits for its
    thread)."""
    tasks = [t for g in JAX_TASKS for t in g]
    assert len(set(tasks)) == len(tasks)
    assert {a for w, a in tasks if w == "pc"} == set(PC_CASES)
    runs = {t: r for g in JAX_TASKS for r in [_Tasks(g)] for t in g}
    yield lambda task: runs[task].get(task)
    for r in set(runs.values()):
        r.join()


@pytest.mark.parametrize("case", sorted(SNES_CASES))
def test_nonlinear_solve_matches_jax(case, jax_refs):
    deg, prm = SNES_CASES[case]
    its, conv, u = _bratu(T, deg, prm)
    jits, jconv, ju = jax_refs(("snes", _SAME_JAX.get(case, case)))
    assert conv and jconv
    assert its == jits
    assert u.max() > 0.05
    _close(u, ju, 1e-10)
