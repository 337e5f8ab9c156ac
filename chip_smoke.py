"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # the card run (needs CUDA)
    python3 chip_smoke.py --cpu-rehearsal [label ...]
                                          # the GMG, gather-route and
                                          # nonlinear-phase solves on the
                                          # CPU only (the counts the card
                                          # must match)
    python3 chip_smoke.py --cpu-study [label ...]
                                          # the gather-route solves' and
                                          # the P1 nonlinear cases' CPU
                                          # convergence study (bounds)

Phases of the card run (each prints its own lines and its seconds; any
failure raises and the exit code is non-zero):

1. device  — needs torch.cuda; prints the card's name and power limit.
2. build   — compiles both hand-written kernels (firedrake_tpu_torch/csrc:
             K1 cell_eval.cu, K2 batched_inv.cu) with nvcc for sm_90a, one
             nvcc each, concurrently; prints seconds, registers and spills;
             and the host sparsity builder (native/coo_build.cpp, g++).
3. kernels — K1 against its plain PyTorch version and the torch
             BatchedLowerer (P1/P2 grad.grad + mass on both triangle types,
             P2 k*w*grad.grad, two Constants and two coefficients, P1 and
             P2 tets, f*v); K2 against its plain version on random SPD
             blocks (n = 4, 7, 15, 19, 32) and on the real star patch
             matrices of P2 at UnitSquareMesh(512) and P1 at 1024^2.
             float64 within 1e-12 max|ref|; float32 within 2e-6 max|ref| +
             1e-7 (K1) and 1e-5 max|ref| (K2); K2 also max|A K2(A) - I| <
             1e-9 in float64.  Times each kernel at the main path's shapes
             (and P2 tets at UnitCubeMesh(64)) beside the bytes/operations
             bound: `ms` is device time alone (_device_ms: per-launch CUDA
             events queued while the card sleeps, L2 flushed before each
             launch), `call_ms` the time per call of back-to-back calls
             (host and card together); the plain version and (K2)
             torch.linalg.inv by call time.  K2's large variant
             (33 <= n <= 128) at (65,536, 40, 40) and (16,384, 64, 64), bit
             for bit with its plain version, timed the same way.
4. main    — four solves through LinearVariationalSolver, each with every
             launch count set to 0 just before it and read just after:
             the README Helmholtz problem (UnitSquareMesh(1024), P1, CG +
             Jacobi), Dirichlet Poisson P2 at 512^2 (CG + Jacobi), and the
             two multigrid solves of -lap u = 2 pi^2 sin(pi x) sin(pi y),
             u = 0 on the boundary, at 1,050,625 dofs: gmg_p1_1m
             (UnitSquareMesh(32) + 5 levels, P1, Chebyshev(2) + Jacobi)
             and gmg_star_p2_1m (UnitSquareMesh(16) + 5 levels, P2,
             Chebyshev(2) + vertex-star patch, whose patch solves are K2).
             Each checks convergence, the relative residual, the nodal
             error, that the solution is on the card, and the launches.
5. gather  — the gather route at full size, each case with every launch
             count set to 0 before and read after, printing its stage
             seconds and K1 launches: gather_p1_1024 (the Helmholtz
             operator at UnitSquareMesh(1024) by FormAssembler(a,
             use_stencil=False), its Matrix.to_scipy() within 1e-12 max|A|
             of the stencil route's, f32 kernels within 2e-6 normwise,
             warm assembly times beside the route's byte bound, the CSR
             matvec (ELL and flat forms) beside StencilMatrix.matvec and
             torch's sparse CSR product); neumann_helmholtz_disk (-lap u +
             u = f, du/dn = grad(u_ex) . n on ds, UnitDiskMesh(9), P1) and
             sipg_dg1_disk (SIPG with dS and ds terms, -lap u = 4,
             UnitDiskMesh(8), DG1), both CG + Jacobi through
             LinearVariationalSolver: converged, on the card, K1 launched
             and the lowerer not, iterations within 1% of the CPU
             rehearsal, nodal and L2 (errornorm, a 0-form) errors below
             the bounds of GATHER.
6. nonlinear — at 1,050,625 P1 dofs on gmg_p1_1m's hierarchy, each case
             with every launch count set to 0 before its counted run and
             read after: newton_p1_1m (-lap u + u^2 = f, u = s = sin(pi x)
             sin(pi y), u = 0 on the boundary, u0 = 0; Newton, snes_rtol
             1e-10, CG + GMG at ksp_rtol 1e-8, assembled Jacobian) and
             newton_mf_p1_1m (the same, mat_type matfree): before each
             solve K1 is held to its plain version and the lowerer on the
             path's own cell-last inputs (residual, Jacobian and, matrix-
             free, its action; f64 and f32, full size); then per Newton
             step |F|, CG iterations and the residual, Jacobian, PC set-up
             and solve times; gates: converged, Newton steps equal to the
             CPU rehearsal, CG iterations per step within one of it,
             |F| / |F0| <= 1e-10, nodal error below NEWTON_ERR, K1
             launched and the lowerer not, the two solutions within 1e-10.
             krylov_p1_1m: gmg_p1_1m's linear system under GMRES, FGMRES,
             BiCGStab and MINRES with GMG at ksp_rtol 1e-10: iterations
             within one of the rehearsal, the residual each method tests
             <= 1e-10 (GMRES and MINRES: the preconditioned one; their true
             one below LEFT_PC_TRUE_RESIDUAL).  burgers_p2_256:
             demos/burgers.py at UnitSquareMesh(256), vector P2 (526,338
             dofs), two time steps, Newton + GMRES + Jacobi; every cell
             integral runs the torch BatchedLowerer, whose device time is
             summed per assembly (CUDA events); gates: Newton steps equal
             to the rehearsal, GMRES iterations within 2%, energies
             decreasing and within 1e-8 of the rehearsal's.
7. gmg_p2_tet_16m — the 16M-dof north star (the JAX bench's cg_gmg_16m):
             -lap u = 3 pi^2 sin(pi x) sin(pi y) sin(pi z), u = 0 on the
             boundary, P2 on MeshHierarchy(UnitCubeMesh(8), 4) (12,582,912
             tets, 16,974,593 dofs), CG + GMG (Chebyshev(2) + Jacobi) with
             mat_type matfree and mg_matfree_threshold 2e4: levels 1-4 are
             matrix-free (K1's action variant), level 0 (4,913 dofs) an
             assembled operator with a dense coarse inverse.  Prints the
             stage times, the fine-level matvec time, the peak device
             memory, the relative residual (matrix-free operator) and the
             nodal error, and fails on a residual above 1e-10, a nodal
             error at or above 1e-7, the lowerer used in the solve, or an
             iteration count more than one from the CPU rehearsal.  Then
             K1's action variant at one fine-level cell type (C =
             2,097,152) against its plain version, timed as in phase 3.

The second-to-last line is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""
import contextlib
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

F64_TOL = 1e-12
F32_RTOL, F32_ATOL = 2e-6, 1e-7
K2_F32_RTOL = 1e-5
TET_N = 64                         # UnitCubeMesh of the timed P2-tet K1 row
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = 67e12                 # f32 outside the tensor cores, and f64
                                   # on the tensor cores (data sheet)

# The GMG solves of the main phase, as built by _gmg_problem.
GMG = {
    "gmg_p1_1m": dict(n0=32, levels=5, degree=1, err=5e-5,
                      params={"ksp_type": "cg", "ksp_rtol": 1e-10,
                              "pc_type": "mg"}),
    "gmg_star_p2_1m": dict(n0=16, levels=5, degree=2, err=1e-6,
                           params={"ksp_type": "cg", "ksp_rtol": 1e-10,
                                   "pc_type": "mg",
                                   "mg_levels_ksp_type": "chebyshev",
                                   "mg_levels_pc_type": "patch"}),
    # the nodal error of P2 here falls as h^4 (7.5e-4, 5.0e-5, 3.2e-6 at
    # 8^3, 16^3, 32^3 cubes on the CPU), ~1e-8 expected at 128^3
    "gmg_p2_tet_16m": dict(n0=8, levels=4, degree=2, dim=3, err=1e-7,
                           params={"ksp_type": "cg", "ksp_rtol": 1e-10,
                                   "pc_type": "mg", "mat_type": "matfree",
                                   "mg_matfree_threshold": 2e4}),
}
# the main phase's GMG solves; the last one has a phase of its own
MAIN_GMG = ("gmg_p1_1m", "gmg_star_p2_1m")
# Iterations of the same solves on the CPU (python3 chip_smoke.py
# --cpu-rehearsal, run on the 8-core host of an H100 machine); the card
# must agree within one (the GMG solves) or within 1% (the gather-route
# solves: thousands of CG iterations, rounded in another order).  The
# Neumann count is the same with grad(u_ex) in the form as with the
# gradient written out.
CPU_REHEARSAL_ITS = {"gmg_p1_1m": 10, "gmg_star_p2_1m": 6,
                     "gmg_p2_tet_16m": 11,
                     # the gather-route solves: within 1% on the card
                     "neumann_helmholtz_disk": 2789, "sipg_dg1_disk": 3028,
                     # the nonlinear phase: Newton steps and CG iterations
                     # per step (within one on the card); the Krylov
                     # methods' iterations (within one); Burgers' Newton
                     # steps, GMRES iterations per Newton step (within 2%)
                     # and energies (within 1e-8)
                     "newton_p1_1m": (3, [8, 8, 8]),
                     "newton_mf_p1_1m": (3, [8, 8, 8]),
                     "krylov_p1_1m": {"gmres": 7, "fgmres": 10,
                                      "bicgstab": 5, "minres": 7},
                     "burgers_p2_256": dict(
                         newton=[2, 2], gmres=[[55, 64], [56, 64]],
                         energy=[0.49999999997637545, 0.49997733541826966,
                                 0.4999546803647855])}


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def phase_done(name, t0):
    print(f"phase {name} seconds {time.perf_counter() - t0:.3f}",
          flush=True)


def device_phase():
    t0 = phase("device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    from firedrake_tpu_torch.compiler import nvcc
    ver = subprocess.run([nvcc._nvcc(), "--version"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} nvcc "
          f"{ver[-1] if ver else 'not found'}")
    # float32 products in full float32 (no TF32) for the f32 checks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_done("device", t0)


def build_phase():
    t0 = phase("build")
    from firedrake_tpu_torch.compiler import cell_eval as K, nvcc
    from firedrake_tpu_torch.ops import batched_inverse as BI
    srcs = {"cell_eval": K._SRC, "batched_inv": BI._SRC}
    from firedrake_tpu_torch import native
    # the host library (g++) beside the two nvcc builds
    _, native_s = _sync_time(native.load)
    print(f"native coo_build: g++ build_s {native_s:.3f}")
    nvcc.compile_sources(list(srcs.values()))
    K.build()
    BI.build()
    for name, src in srcs.items():
        secs, log = nvcc.build_logs.get(src, (0.0, ""))
        lines = log.splitlines()
        regs = [int(l.split("Used ")[1].split(" ")[0])
                for l in lines if "Used " in l]
        spill = [int(l.split(" bytes spill stores")[0].split()[-1])
                 for l in lines if " bytes spill stores" in l]
        print(f"{name}: build_s {secs:.3f} instantiations {len(regs)} "
              f"max_registers {max(regs) if regs else 'n/a'} "
              f"instantiations_with_spills {sum(b > 0 for b in spill)} "
              f"max_spill_store_bytes {max(spill) if spill else 'n/a'}")
        for l in lines:
            if "spill stores" in l and " 0 bytes spill stores" not in l:
                print(f"  {l.strip()}")
    phase_done("build", t0)


def _cuda_ms(fn, reps=20, warm=3):
    """Call time: CUDA events around `reps` back-to-back calls, per call.
    Whichever is slower, the host issuing the calls or the card running
    them, sets it."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


_FLUSH = []
SLEEP_CYCLES = 10 ** 8          # ~50 ms of the card's clock


def _device_ms(fn, reps=20):
    """Device time of one launch, mean over `reps`: the card first sleeps
    (torch.cuda._sleep) while the host queues every launch, each between
    its own pair of events and after a write of 256 MB that evicts the
    50 MB L2, so each launch finds its inputs in device memory and the
    card never waits for the host inside an event pair.  The sleep is
    doubled until the host is done queueing before the card wakes."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(2 ** 25, dtype=torch.float64,
                                  device="cuda"))
    fn()
    cycles = SLEEP_CYCLES
    for _ in range(4):
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        woke = torch.cuda.Event()
        torch.cuda._sleep(cycles)
        woke.record()
        for s, e in ev:
            _FLUSH[0].zero_()
            s.record()
            fn()
            e.record()
        queued_early = not woke.query()
        torch.cuda.synchronize()
        if queued_early:
            return sum(s.elapsed_time(e) for s, e in ev) / reps
        cycles *= 2
    raise AssertionError("the host could not queue the launches before "
                         "the card woke")


def _pair_ms(kernel, plain, reps=20, plain_reps=20):
    """Device time of the kernel (`ms`), its call time (`call_ms`) and the
    plain version's call time, in the turns plain, kernel, kernel,
    plain: each kernel turn takes both the device and the call time."""
    p1 = _cuda_ms(plain, plain_reps, 1)
    d1, c1 = _device_ms(kernel, reps), _cuda_ms(kernel, reps)
    d2, c2 = _device_ms(kernel, reps), _cuda_ms(kernel, reps)
    p2 = _cuda_ms(plain, plain_reps, 1)
    return dict(ms=(d1 + d2) / 2, call_ms=(c1 + c2) / 2,
                plain_ms=(p1 + p2) / 2, runs=(d1, d2, c1, c2, p1, p2))


def _cases(fd, sp):
    """(label, form, timed) — forms of K1's family on the main path's
    meshes (P1 at 1024^2, P2 at 512^2) plus a small tet mesh."""
    V1, V2 = sp["P1"], sp["P2"]
    V3 = fd.FunctionSpace(fd.UnitCubeMesh(16, 16, 16), "CG", 1)
    rng = np.random.default_rng(0)
    out = []
    for lab, V in (("P1", V1), ("P2", V2)):
        u, v = fd.TrialFunction(V), fd.TestFunction(V)
        w = fd.Function(V, val=rng.uniform(0.5, 1.5, V.dim))
        out.append((f"{lab} grad.grad+mass", (fd.inner(fd.grad(u),
                    fd.grad(v)) + fd.inner(u, v)) * fd.dx, lab == "P1"))
        out.append((f"{lab} f*v", fd.inner(w, v) * fd.dx, True))
    u, v = fd.TrialFunction(V2), fd.TestFunction(V2)
    w = fd.Function(V2, val=rng.uniform(0.5, 1.5, V2.dim))
    out.append(("P2 grad.grad", fd.inner(fd.grad(u), fd.grad(v)) * fd.dx,
                True))
    out.append(("P2 k*w*grad.grad", fd.Constant(3.0) * w
                * fd.inner(fd.grad(u), fd.grad(v)) * fd.dx, False))
    u, v = fd.TrialFunction(V3), fd.TestFunction(V3)
    out.append(("tet P1 grad.grad", fd.inner(fd.grad(u), fd.grad(v))
                * fd.dx, False))
    # K1's action variant (matrix-free matvecs): action(a, z)
    for lab, V in (("P1", V1), ("P2", V2), ("tet P1", V3)):
        u, v = fd.TrialFunction(V), fd.TestFunction(V)
        z = fd.Function(V, val=rng.standard_normal(V.dim))
        out.append((f"{lab} action grad.grad+mass", fd.action(
            (fd.inner(fd.grad(u), fd.grad(v)) + u * v) * fd.dx, z), False))
    # two Constants and two coefficients (the kernel's quadrature variant)
    u, v = fd.TrialFunction(V1), fd.TestFunction(V1)
    f = fd.Function(V1, val=rng.uniform(0.5, 1.5, V1.dim))
    g = fd.Function(V1, val=rng.uniform(0.5, 1.5, V1.dim))
    k1, k2 = fd.Constant(1.5), fd.Constant(-0.25)
    out.append(("P1 k1*k2*f*g*grad.grad+k2*g*mass",
                (k1 * k2 * f * g * fd.inner(fd.grad(u), fd.grad(v))
                 + k2 * g * u * v) * fd.dx, False))
    # P2 tets at UnitCubeMesh(64): 262,144 cells of each of 6 types
    V4 = fd.FunctionSpace(fd.UnitCubeMesh(TET_N, TET_N, TET_N), "CG", 2)
    u, v = fd.TrialFunction(V4), fd.TestFunction(V4)
    out.append(("tet P2 grad.grad+mass", (fd.inner(fd.grad(u), fd.grad(v))
                                          + fd.inner(u, v)) * fd.dx, True))
    z = fd.Function(V4, val=rng.standard_normal(V4.dim))
    out.append(("tet P2 action grad.grad", fd.action(
        fd.inner(fd.grad(u), fd.grad(v)) * fd.dx, z), False))
    return out


def _k1_flops(K, spec, C):
    """Floating-point operations of one K1 launch over C cells, counted
    from the kernel's loops: one multiply-add per reference-tensor value
    (REF; ACT adds the two updates of y per pair), or per point the
    coefficients' values and the element entries (QUAD)."""
    nref = len(spec.kernel_doubles) - K._HEAD
    if spec.mode == K.REF:
        return 2 * nref * C
    pairs = spec.ni * (spec.ni + 1) // 2
    if spec.mode == K.ACT:
        return 2 * (nref + 2 * pairs) * C
    d = spec.tdim
    per_q = 2 * sum(spec.wdof) + 2 * spec.ni * spec.nj * (1 + d * (d + 1))
    return per_q * spec.nq * C


def _k1_compare(K, label, t, spec, ci, ce, ws, cv, timed):
    """K1 against its plain version and the BatchedLowerer on one cell
    type, in float64 and float32; with `timed`, also its times beside the
    bytes/operations bound.  Returns the timed rows."""
    from firedrake_tpu_torch.compiler.precision import trace_ctx
    rows = []
    for dt in (torch.float64, torch.float32):
        ce_, ws_ = ce.to(dt), tuple(w.to(dt) for w in ws)
        cv_ = tuple(c.to(dt) for c in cv)
        k1 = K.cell_eval(spec, ce_, ws_, cv_)
        plain = K.cell_eval_plain(spec, ce_, ws_, cv_)
        with trace_ctx(None if dt == torch.float64 else dt):
            low = ci.cell_kernel_batched()(ce_, ws_, cv_)
        torch.cuda.synchronize()
        ref = float(plain.abs().max())
        e_plain = float((k1 - plain).abs().max())
        e_low = float((k1 - low).abs().max())
        del low
        tol = (F64_TOL * ref if dt == torch.float64
               else F32_RTOL * ref + F32_ATOL)
        ok = e_plain <= tol and e_low <= tol
        print(f"{label:22s} type {t} {str(dt)[6:]:8s} "
              f"C={ce.shape[-1]:8d} err_vs_plain {e_plain:.3e} "
              f"err_vs_lowerer {e_low:.3e} max|ref| {ref:.3e} "
              f"tol {tol:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: K1 disagrees")
        if not timed:
            continue
        tm = _pair_ms(lambda: K.cell_eval(spec, ce_, ws_, cv_),
                      lambda: K.cell_eval_plain(spec, ce_, ws_, cv_),
                      plain_reps=5)
        runs = tm.pop("runs")
        nbytes = (ce_.numel() + sum(w.numel() for w in ws_)
                  + k1.numel()) * k1.element_size()
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * _k1_flops(K, spec, ce.shape[-1]) / PEAK_FLOPS
        row = dict(form=label, dtype=str(dt)[6:], C=ce.shape[-1],
                   mode=spec.mode, **tm, max_abs_err=e_plain,
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        rows.append(row)
        print(f"  time K1 device {tm['ms']:.4f} ms  call "
              f"{tm['call_ms']:.4f} ms  plain {tm['plain_ms']:.4f} ms  "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; bytes "
              f"{bytes_ms:.4f} operations {ops_ms:.4f})  share "
              f"{row['bound_ms'] / tm['ms']:.3f} (runs "
              "device/device/call/call/plain/plain "
              + "/".join(f"{x:.4f}" for x in runs) + ")")
    return rows


def _stencil_k1_checks(asm, label, timed=False):
    """K1 against its plain version and the lowerer on the stencil route's
    own inputs: every cell integral's strided gathers over each cell type,
    in float64 and float32, at full size; with `timed`, the first cell
    type's launches are timed too.  Returns the timed rows."""
    from firedrake_tpu_torch.compiler import cell_eval as K
    if asm._stencil is None:
        raise AssertionError(f"{label}: not on the stencil route")
    coords, coeffs, consts = asm._inputs()
    rows = []
    for ci in asm._compiled:
        spec = K.family_spec(ci)
        if spec is None:
            raise AssertionError(f"{label}: not in K1's family")
        cv = tuple(consts[c.count] for c in ci.constants)
        for t in range(asm._stencil.ntypes):
            ce, ws = asm._stencil.gather_cell_inputs(t, coords, coeffs, ci)
            rows += _k1_compare(K, label, t, spec, ci, ce, ws, cv,
                                timed and t == 0)
            del ce, ws
    return rows


def k1_checks(fd, sp):
    from firedrake_tpu_torch.assemble import FormAssembler
    rows = []
    for label, form, timed in _cases(fd, sp):
        rows += _stencil_k1_checks(FormAssembler(form), label, timed)
    torch.cuda.synchronize()
    print("k1_timings " + json.dumps(rows))
    return rows[0]


def _spd(nb, n, seed, dtype):
    B = np.random.default_rng(seed).standard_normal((nb, n, n))
    return torch.as_tensor(B @ B.transpose(0, 2, 1) + n * np.eye(n),
                           dtype=dtype, device="cuda")


def _k2_compare(BI, label, A):
    out = BI.batched_inv(A)
    plain = BI.batched_inv_plain(A)
    torch.cuda.synchronize()
    ref = float(plain.abs().max())
    err = float((out - plain).abs().max())
    f64 = A.dtype == torch.float64
    tol = F64_TOL * ref if f64 else K2_F32_RTOL * ref
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    res = float((A @ out - eye).abs().max()) if f64 else float("nan")
    ok = err <= tol and (not f64 or res < 1e-9)
    print(f"K2 {label:28s} {str(A.dtype)[6:]:8s} shape "
          f"{tuple(A.shape)} err_vs_plain {err:.3e} max|ref| {ref:.3e} "
          f"tol {tol:.3e} max|A X - I| {res:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K2 {label}: disagrees")
    return err


def _real_patches(fd, V):
    from firedrake_tpu_torch.solvers.preconditioners import (
        star_patches, patch_matrices)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    A = fd.assemble(fd.inner(fd.grad(u), fd.grad(v)) * fd.dx,
                    bcs=fd.DirichletBC(V, 0.0, "on_boundary"))
    idx, mask = star_patches(V)
    return patch_matrices(A, idx, mask)


def k2_checks(fd, sp):
    from firedrake_tpu_torch.ops import batched_inverse as BI
    for n in (4, 7, 15, 19, 32):
        for dt in (torch.float64, torch.float32):
            _k2_compare(BI, f"random SPD n={n}", _spd(4096, n, n, dt))
    rows = {}
    for lab, V in (("P2 star patches 512^2", sp["P2"]),
                   ("P1 star patches 1024^2", sp["P1"])):
        A64 = _real_patches(fd, V)
        for dt in (torch.float64, torch.float32):
            A = A64.to(dt)
            err = _k2_compare(BI, lab, A)
            nb, n = A.shape[0], A.shape[-1]
            tm = _pair_ms(lambda: BI.batched_inv(A),
                          lambda: BI.batched_inv_plain(A),
                          reps=20, plain_reps=3)
            runs = tm.pop("runs")
            lib1 = _cuda_ms(lambda: torch.linalg.inv(A), 3, 1)
            lib2 = _cuda_ms(lambda: torch.linalg.inv(A), 3, 1)
            bytes_ms = 1e3 * 2 * A.numel() * A.element_size() \
                / HBM_BYTES_PER_S
            ops_ms = 1e3 * 2 * n ** 3 * nb / PEAK_FLOPS
            row = dict(shape=list(A.shape), dtype=str(dt)[6:], **tm,
                       library_ms=(lib1 + lib2) / 2,
                       bound_ms=max(bytes_ms, ops_ms),
                       bound_by="bytes" if bytes_ms >= ops_ms
                       else "operations", max_abs_err=err)
            rows[(lab, row["dtype"])] = row
            print(f"  time K2 device {tm['ms']:.4f} ms  call "
                  f"{tm['call_ms']:.4f} ms  plain {tm['plain_ms']:.4f} ms  "
                  f"torch.linalg.inv {row['library_ms']:.4f} ms  bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']})  share "
                  f"{row['bound_ms'] / tm['ms']:.3f} (runs device/device/"
                  "call/call/plain/plain/lib/lib "
                  + "/".join(f"{x:.4f}" for x in runs + (lib1, lib2))
                  + ")")
        del A64, A
    print("k2_timings " + json.dumps(list(rows.values())))
    return rows[("P2 star patches 512^2", "float64")]


def k2_large_checks():
    """K2's large variant (33 <= n <= 128) against its plain version on
    random SPD batches, bit for bit up to signed zeros, and timed beside
    torch.linalg.inv and its bound.  Returns the (65,536, 40, 40) float64
    row."""
    from firedrake_tpu_torch.ops import batched_inverse as BI
    rows = []
    for nb, n in ((65536, 40), (16384, 64)):
        for dt in (torch.float64, torch.float32):
            A = _spd(nb, n, n, dt)
            err = _k2_compare(BI, f"large n={n}", A)
            exact = torch.equal(BI.batched_inv(A) + 0.0,
                                BI.batched_inv_plain(A) + 0.0)
            print(f"  bit for bit with the plain version: {exact}")
            if not exact:
                raise AssertionError(f"K2 large n={n}: not bit for bit")
            tm = _pair_ms(lambda: BI.batched_inv(A),
                          lambda: BI.batched_inv_plain(A),
                          reps=5, plain_reps=2)
            runs = tm.pop("runs")
            lib1 = _cuda_ms(lambda: torch.linalg.inv(A), 3, 1)
            lib2 = _cuda_ms(lambda: torch.linalg.inv(A), 3, 1)
            bytes_ms = 1e3 * 2 * A.numel() * A.element_size() \
                / HBM_BYTES_PER_S
            ops_ms = 1e3 * 2 * n ** 3 * nb / PEAK_FLOPS
            row = dict(shape=[nb, n, n], dtype=str(dt)[6:], **tm,
                       library_ms=(lib1 + lib2) / 2,
                       bound_ms=max(bytes_ms, ops_ms),
                       bound_by="bytes" if bytes_ms >= ops_ms
                       else "operations", max_abs_err=err)
            rows.append(row)
            print(f"  time K2 large device {tm['ms']:.4f} ms  call "
                  f"{tm['call_ms']:.4f} ms  plain {tm['plain_ms']:.4f} ms  "
                  f"torch.linalg.inv {row['library_ms']:.4f} ms  bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']})  share "
                  f"{row['bound_ms'] / tm['ms']:.3f} (runs device/device/"
                  "call/call/plain/plain/lib/lib "
                  + "/".join(f"{x:.4f}" for x in runs + (lib1, lib2))
                  + ")")
            del A
            torch.cuda.empty_cache()
    print("k2_large_timings " + json.dumps(rows))
    return rows[0]


def kernels_phase():
    t0 = phase("kernels")
    import firedrake_tpu_torch as fd
    fd.set_device(torch.device("cuda"))
    sp = {"P1": fd.FunctionSpace(fd.UnitSquareMesh(1024, 1024), "CG", 1),
          "P2": fd.FunctionSpace(fd.UnitSquareMesh(512, 512), "CG", 2)}
    k1 = k1_checks(fd, sp)
    k2 = k2_checks(fd, sp)
    del sp
    torch.cuda.empty_cache()
    k2_large = k2_large_checks()
    phase_done("kernels", t0)
    return k1, k2, k2_large


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class _Counts:
    """Every launch counter set to 0 on entry and read on exit; a `_Counts`
    entered more than once sums its blocks' readings.  `k1_by_variant`
    splits K1's launches by the kernel's variant."""

    def __init__(self):
        self.k1 = self.k2 = self.k2_large = self.lowerer = 0
        self.k1_by_variant = dict(ref=0, quad=0, act=0)

    def __enter__(self):
        from firedrake_tpu_torch.compiler import cell_eval as K
        from firedrake_tpu_torch.ops import batched_inverse as BI
        self.K, self.BI = K, BI
        K.kernel_launches = K.lowerer_evals = 0
        K.launches_by_mode[:] = [0, 0, 0]
        BI.kernel_launches = BI.large_launches = 0
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        K = self.K
        self.k1 += K.kernel_launches
        self.k2 += self.BI.kernel_launches
        self.k2_large += self.BI.large_launches
        self.lowerer += K.lowerer_evals
        for name, mode in (("ref", K.REF), ("quad", K.QUAD), ("act", K.ACT)):
            self.k1_by_variant[name] += K.launches_by_mode[mode]


def _check(label, uh, solver, exact, bound, counts, k2=0):
    err = float((uh.dat - exact.dat).abs().max())
    print(f"{label}: dofs {uh.function_space().dim} iterations "
          f"{solver.ksp_iterations} converged {solver.converged} "
          f"max_nodal_err {err:.3e} on {uh.dat.device} k1_launches "
          f"{counts.k1} k2_launches {counts.k2} lowerer_evals "
          f"{counts.lowerer}")
    if not uh.dat.is_cuda:
        raise AssertionError(f"{label}: solution is not on the card")
    if not solver.converged:
        raise AssertionError(f"{label}: solve did not converge")
    if not err < bound:
        raise AssertionError(f"{label}: nodal error {err} >= {bound}")
    if counts.k1 <= 0 or counts.lowerer:
        raise AssertionError(f"{label}: assembly bypassed K1")
    if counts.k2 != k2:
        raise AssertionError(f"{label}: K2 launched {counts.k2} times, "
                             f"expected {k2}")


def _release(label):
    """Drop what a phase leaves on the card before a later phase reads its
    peak memory: the port's module caches (assemblers, interpolation
    plans, grid transfers, function space data, which hold meshes and
    their device coordinates) and unreachable cycles (solvers and their
    preconditioner closures)."""
    import gc
    from firedrake_tpu_torch.assemble import _assembler_cache
    from firedrake_tpu_torch.interpolation import _interp_cache
    from firedrake_tpu_torch.mg.transfer import _transfer_cache
    from firedrake_tpu_torch.functionspace import _fsdata_cache
    for cache in (_assembler_cache, _interp_cache, _transfer_cache,
                  _fsdata_cache):
        cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{label}: device memory allocated after release "
          f"{torch.cuda.memory_allocated()} bytes")


class _StageTimes:
    """Seconds spent in named stages during one solve: each named module
    function (or class attribute) is wrapped, synchronised on both sides;
    `secs` sums each stage, `calls` lists its calls' seconds in order,
    over every block the object is entered for.  The default stages are
    the GMG set-up's."""

    STAGES = (("pc_setup", "firedrake_tpu_torch.mg.vcycle",
               "GMGPreconditioner"),
              ("level_assembly", "firedrake_tpu_torch.assemble",
               "assemble"),
              ("level_diagonal", "firedrake_tpu_torch.assemble",
               "FormAssembler.assemble_diagonal"),
              ("patch_setup", "firedrake_tpu_torch.solvers.preconditioners",
               "make_star_patch"),
              ("k2", "firedrake_tpu_torch.ops.batched_inverse",
               "batched_inv"),
              ("solve", "firedrake_tpu_torch.solving", "_run_ksp"))

    def __init__(self, stages=None):
        self.stages = stages or self.STAGES
        self.secs = {name: 0.0 for name, _, _ in self.stages}
        self.calls = {name: [] for name, _, _ in self.stages}

    def __enter__(self):
        import importlib
        self.saved = []
        for name, mod, path in self.stages:
            owner = importlib.import_module(mod)
            *outer, attr = path.split(".")
            for o in outer:
                owner = getattr(owner, o)
            fn = getattr(owner, attr)
            self.saved.append((owner, attr, fn))
            setattr(owner, attr, self._timed(name, fn))
        return self

    def _timed(self, name, fn):
        def run(*a, **kw):
            out, s = _sync_time(lambda: fn(*a, **kw))
            self.secs[name] += s
            self.calls[name].append(s)
            return out
        return run

    def __exit__(self, *exc):
        for m, attr, fn in self.saved:
            setattr(m, attr, fn)


def _max_rss_gib():
    """Peak resident memory of this process so far (Linux: ru_maxrss in
    KiB)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def _gmg_problem(fd, n0, levels, degree, params, dim=2, **_):
    """-lap u = dim pi^2 prod sin(pi x_k), u = 0 on the boundary of the
    unit square or cube, with f interpolated into V (K1's load form)."""
    t0 = time.perf_counter()
    base = (fd.UnitCubeMesh(n0, n0, n0) if dim == 3
            else fd.UnitSquareMesh(n0, n0))
    hier = fd.MeshHierarchy(base, levels)
    hier_s = time.perf_counter() - t0
    mesh = hier.meshes[-1]
    V = fd.FunctionSpace(mesh, "CG", degree)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    X = fd.SpatialCoordinate(mesh)
    s = fd.sin(fd.pi * X[0])
    for k in range(1, dim):
        s = s * fd.sin(fd.pi * X[k])
    f = fd.Function(V).interpolate(dim * fd.pi ** 2 * s)
    a = fd.inner(fd.grad(u), fd.grad(v)) * fd.dx
    L = fd.inner(f, v) * fd.dx
    bc = fd.DirichletBC(V, 0, "on_boundary")
    uh = fd.Function(V)
    solver = fd.LinearVariationalSolver(
        fd.LinearVariationalProblem(a, L, uh, bcs=bc),
        solver_parameters=params)
    exact = fd.Function(V).interpolate(s)
    return hier_s, hier, a, L, bc, uh, solver, exact


def _rel_residual(fd, a, L, bc, uh, matfree=False):
    """||b - A u|| / ||b||, A with the Dirichlet rows as identity: the
    assembled operator, or the matrix-free one (at 17M dofs the assembled
    P2-tet operator would hold ~65 channel planes)."""
    if matfree:
        from firedrake_tpu_torch.assembly.matfree import MatrixFreeOperator
        A = MatrixFreeOperator(a).with_dirichlet(bc.dof_indices)
    else:
        A = fd.assemble(a, bcs=bc)
    b = fd.assemble(L, bcs=bc).dat
    return float(torch.linalg.vector_norm(b - A.matvec(uh.dat))
                 / torch.linalg.vector_norm(b))


def gmg_run(fd, label):
    cfg = GMG[label]
    matfree = cfg["params"].get("mat_type") == "matfree"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hier_s, hier, a, L, bc, uh, solver, exact = _gmg_problem(fd, **cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    nsmoothed = len(hier) - 1
    with _Counts() as counts, _StageTimes() as st:
        _, first_s = _sync_time(solver.solve)
    its = solver.ksp_iterations
    peak = torch.cuda.max_memory_allocated()
    rel = _rel_residual(fd, a, L, bc, uh, matfree)
    _check(label, uh, solver, exact, cfg["err"], counts,
           k2=nsmoothed if "patch" in cfg["params"].values() else 0)
    sec = st.secs
    print(f"{label}: levels {len(hier)} hierarchy_s {hier_s:.3f} "
          f"problem_setup_s {setup_s:.3f} (hierarchy included) "
          f"first_solve_s {first_s:.3f} "
          f"pc_setup_s {sec['pc_setup']:.3f} level_assembly_s "
          f"{sec['level_assembly']:.3f} level_diagonal_s "
          f"{sec['level_diagonal']:.3f} patch_setup_s "
          f"{sec['patch_setup']:.3f} k2_s {sec['k2']:.4f} solve_s "
          f"{sec['solve']:.4f} iterations {its} ms_per_iteration "
          f"{1e3 * sec['solve'] / max(its, 1):.4f} rel_residual {rel:.3e} "
          f"max_memory_allocated setup {setup_peak} "
          f"({setup_peak / 2 ** 30:.3f} GiB) solve {peak} "
          f"({peak / 2 ** 30:.3f} GiB, PC set-up included) "
          f"host_max_rss_gib {_max_rss_gib():.2f}")
    if not rel <= 1e-10:
        raise AssertionError(f"{label}: relative residual {rel}")
    want = CPU_REHEARSAL_ITS[label]
    if abs(its - want) > 1:
        raise AssertionError(f"{label}: {its} iterations, the CPU "
                             f"rehearsal took {want}")
    if matfree:
        # the fine level's operator, as the V-cycle applies it
        A = solver._gmg.levels[-1]["A"]
        x = uh.dat.clone()
        mv = _cuda_ms(lambda: A.matvec(x), reps=10, warm=2)
        print(f"{label}: fine_matvec_ms {mv:.4f} ({A!r}, call time of 10 "
              "back-to-back matvecs)")
    # a second solve from zero reuses the solver's multigrid hierarchy
    uh.dat = torch.zeros_like(uh.dat)
    _, again_s = _sync_time(solver.solve)
    print(f"{label}: second_solve_s {again_s:.4f} iterations "
          f"{solver.ksp_iterations}")
    return counts, solver


def main_phase():
    t0 = phase("main")
    import firedrake_tpu_torch as fd
    from firedrake_tpu_torch import (UnitSquareMesh, FunctionSpace,
                                     TrialFunction, TestFunction,
                                     SpatialCoordinate, Function, pi, cos,
                                     sin, inner, grad, dx, assemble,
                                     DirichletBC, LinearVariationalProblem,
                                     LinearVariationalSolver)
    fd.set_device(torch.device("cuda"))
    params = {"ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": 1e-10}
    used = {}
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # a non-converged solve warns
        # --- the README problem; solve(a == L, uh, ...) spelled out as the
        # solver object it builds, so that the iteration count is readable
        with _Counts() as counts:
            t1 = time.perf_counter()
            mesh = UnitSquareMesh(1024, 1024)
            V = FunctionSpace(mesh, "CG", 1)
            u, v = TrialFunction(V), TestFunction(V)
            x, y = SpatialCoordinate(mesh)
            f = Function(V).interpolate((1 + 8*pi**2) * cos(2*pi*x)
                                        * cos(2*pi*y))
            a = (inner(grad(u), grad(v)) + inner(u, v)) * dx
            L = inner(f, v) * dx
            uh = Function(V)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t1
            _, cold_s = _sync_time(lambda: (assemble(a), assemble(L)))
            _, asm_s = _sync_time(lambda: (assemble(a), assemble(L)))
            solver = LinearVariationalSolver(
                LinearVariationalProblem(a, L, uh),
                solver_parameters=params)
            _, solve_s = _sync_time(solver.solve)
            exact = Function(V).interpolate(cos(2*pi*x) * cos(2*pi*y))
        _check("helmholtz_p1_1024", uh, solver, exact, 1e-4, counts)
        print(f"helmholtz_p1_1024: setup_s {setup_s:.3f} "
              f"assembly_cold_s {cold_s:.4f} assembly_s {asm_s:.4f} "
              f"solve_s {solve_s:.4f} ms_per_iteration "
              f"{1e3 * solve_s / max(solver.ksp_iterations, 1):.4f}")
        used["helmholtz_p1_1024"] = counts

        # --- Dirichlet Poisson, P2: -div grad u = f, u = 0 on the boundary
        with _Counts() as counts:
            t1 = time.perf_counter()
            mesh = UnitSquareMesh(512, 512)
            V = FunctionSpace(mesh, "CG", 2)
            u, v = TrialFunction(V), TestFunction(V)
            x, y = SpatialCoordinate(mesh)
            f = Function(V).interpolate(2*pi**2 * sin(pi*x) * sin(pi*y))
            a = inner(grad(u), grad(v)) * dx
            L = inner(f, v) * dx
            uh = Function(V)
            bc = DirichletBC(V, 0, "on_boundary")
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t1
            solver = LinearVariationalSolver(
                LinearVariationalProblem(a, L, uh, bcs=bc),
                solver_parameters=params)
            _, solve_s = _sync_time(solver.solve)
            exact = Function(V).interpolate(sin(pi*x) * sin(pi*y))
        _check("poisson_p2_512", uh, solver, exact, 1e-6, counts)
        print(f"poisson_p2_512: setup_s {setup_s:.3f} solve_s "
              f"{solve_s:.4f} ms_per_iteration "
              f"{1e3 * solve_s / max(solver.ksp_iterations, 1):.4f}")
        used["poisson_p2_512"] = counts
        del mesh, V, f, uh, solver, exact
        torch.cuda.empty_cache()

        # --- geometric multigrid at 1,050,625 dofs
        for label in MAIN_GMG:
            used[label], _ = gmg_run(fd, label)
            torch.cuda.empty_cache()
    phase_done("main", t0)
    return used


def north_star_phase():
    """The 16M-dof matrix-free solve, then K1's action variant timed on
    the fine level's own inputs (one cell type, C = 2,097,152)."""
    label = "gmg_p2_tet_16m"
    t0 = phase(label)
    import firedrake_tpu_torch as fd
    from firedrake_tpu_torch.compiler import cell_eval as K
    fd.set_device(torch.device("cuda"))
    with warnings.catch_warnings():
        warnings.filterwarnings("error", "linear solve did not converge")
        counts, solver = gmg_run(fd, label)
    mf = solver._gmg.levels[-1]["A"].base
    asm = mf._asm1
    (ci,) = asm._compiled
    spec = K.family_spec(ci)
    cd = dict(mf._coeff_dats)
    cd[mf._w.count] = torch.as_tensor(
        np.random.default_rng(0).standard_normal(mf.shape[0]),
        device="cuda")
    ce, ws = asm._stencil.gather_cell_inputs(0, mf._mesh.device_coordinates(),
                                             cd, ci)
    del solver, mf, cd
    torch.cuda.empty_cache()
    rows = _k1_compare(K, "tet P2 action (fine)", 0, spec, ci, ce, ws, (),
                       True)
    print("k1_action_timings " + json.dumps(rows))
    del ce, ws
    torch.cuda.empty_cache()
    phase_done(label, t0)
    return counts, rows[0]


# ---------------------------------------------------------- the gather route
# The gather-route solves: mesh level at full size, the levels of the CPU
# convergence study (python3 chip_smoke.py --cpu-study), and the bounds on
# the nodal and L2 errors fixed from that study (PERF.md).
# Both errors fall 3.7-4x per level in the study; each bound is twice the
# error extrapolated from the study's last level at that rate.
GATHER = {
    "neumann_helmholtz_disk": dict(level=9, study=(4, 5, 6, 7),
                                   nodal=1.1e-4, l2=8.5e-5),
    "sipg_dg1_disk": dict(level=8, study=(3, 4, 5, 6), nodal=6.5e-6,
                          l2=1.7e-5),
}
SOLVE_PARAMS = {"ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": 1e-10,
                "ksp_max_it": 100000}


def _neumann_problem(fd, level):
    """-lap u + u = f on UnitDiskMesh(level), du/dn = g: exact u =
    cos(pi x) cos(pi y), f = (1 + 2 pi^2) u interpolated into P1, g =
    grad(u) . n with the discrete normal (exact on the polygon)."""
    mesh = fd.UnitDiskMesh(level)
    V = fd.FunctionSpace(mesh, "CG", 1)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    x, y = fd.SpatialCoordinate(mesh)
    u_ex = fd.cos(fd.pi * x) * fd.cos(fd.pi * y)
    f = fd.Function(V).interpolate((1 + 2 * fd.pi ** 2) * u_ex)
    n = fd.FacetNormal(mesh)
    a = (fd.inner(fd.grad(u), fd.grad(v)) + u * v) * fd.dx
    L = f * v * fd.dx + fd.inner(fd.grad(u_ex), n) * v * fd.ds
    uh = fd.Function(V)
    solver = fd.LinearVariationalSolver(fd.LinearVariationalProblem(a, L, uh),
                                        solver_parameters=SOLVE_PARAMS)
    return dict(a=a, L=L, uh=uh, solver=solver, u_ex=u_ex,
                exact=fd.Function(V).interpolate(u_ex))


def _sipg_problem(fd, level, alpha=10.0):
    """-lap u = 4 on UnitDiskMesh(level) in DG1, u = 0 weakly on the
    boundary: the symmetric interior penalty form of the JAX package's
    tests/regression/test_dg.py::test_dg_poisson_sipg (h = CellDiameter);
    exact u = 1 - x^2 - y^2."""
    mesh = fd.UnitDiskMesh(level)
    V = fd.FunctionSpace(mesh, "DG", 1)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    x, y = fd.SpatialCoordinate(mesh)
    n = fd.FacetNormal(mesh)
    h = fd.CellDiameter(mesh)
    alpha = fd.Constant(alpha)
    a = fd.inner(fd.grad(u), fd.grad(v)) * fd.dx \
        - fd.inner(fd.avg(fd.grad(u)), fd.jump(v, n)) * fd.dS \
        - fd.inner(fd.jump(u, n), fd.avg(fd.grad(v))) * fd.dS \
        + alpha / fd.avg(h) * fd.inner(fd.jump(u, n), fd.jump(v, n)) * fd.dS \
        - fd.inner(fd.grad(u), v * n) * fd.ds \
        - fd.inner(u * n, fd.grad(v)) * fd.ds \
        + alpha / h * fd.inner(u, v) * fd.ds
    L = fd.Constant(4.0) * v * fd.dx
    u_ex = 1 - x ** 2 - y ** 2
    uh = fd.Function(V)
    solver = fd.LinearVariationalSolver(fd.LinearVariationalProblem(a, L, uh),
                                        solver_parameters=SOLVE_PARAMS)
    return dict(a=a, L=L, uh=uh, solver=solver, u_ex=u_ex,
                exact=fd.Function(V).interpolate(u_ex))


GATHER_PROBLEMS = {"neumann_helmholtz_disk": _neumann_problem,
                   "sipg_dg1_disk": _sipg_problem}


def _gather_errors(fd, p):
    """(max nodal error, L2 error through errornorm, a 0-form)."""
    nodal = float((p["uh"].dat - p["exact"].dat).abs().max())
    return nodal, fd.errornorm(p["u_ex"], p["uh"])


def _route_bytes(asm, itemsize):
    """Bytes a gather-route rank-2 assembly moves: index tables and
    coordinate values read, the gathered coordinates written and read by
    K1, the element entries written and gathered back, the gather tables
    read and the CSR values written."""
    n = 0
    for st in asm._statics:
        cm = st["coords_map"]
        n += cm.numel() * (4 + 3 * itemsize)
    for ci, st in zip(asm._compiled, asm._statics):
        ni, nj = ci.local_shape()
        n += 2 * ni * nj * st["n"] * itemsize
    acc = asm._acc
    if hasattr(acc, "tbl"):
        n += 4 * acc.tbl.numel()
        if acc.tblx is not None:
            n += 4 * acc.tblx.numel() + 8 * 2 * acc.rows_x.numel()
    else:
        n += 8 * (acc.perm.numel() + acc.lengths.numel())
    return n + 8 * asm.sparsity.nnz


def _matvec_timings(A_g, A_s):
    """The CSR matrix's matvec (the ELL form) beside the flat form (one
    gather and a segment sum over the sorted rows), StencilMatrix.matvec
    and torch's sparse CSR product (library_ms), in turns, with the byte
    bound: values, column indices and row pointers read once, x read
    and y written once."""
    n = A_g.shape[0]
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(n),
                        device="cuda")
    s = A_g.sparsity
    lib = torch.sparse_csr_tensor(
        torch.as_tensor(s.indptr, device="cuda"),
        torch.as_tensor(s.coo_cols.astype(np.int64), device="cuda"),
        A_g.data, size=A_g.shape)
    lengths = torch.as_tensor(s.row_lengths, device="cuda")
    A_g.matvec(x)                       # builds the ELL values once
    fns = {"ell": lambda: A_g.matvec(x),
           "csr": lambda: torch.segment_reduce(
               A_g.data * x.index_select(0, A_g._tables["cols"]), "sum",
               lengths=lengths),
           "stencil": lambda: A_s.matvec(x),
           "library": lambda: lib @ x}
    ref = fns["stencil"]()
    out = {}
    for name, fn in fns.items():
        err = float((fn() - ref).abs().max())
        if not err <= F64_TOL * float(ref.abs().max()):
            raise AssertionError(f"matvec {name} disagrees: {err}")
        out[name] = []
    for name in list(fns) + list(fns)[::-1]:
        out[name].append(_cuda_ms(fns[name], reps=50, warm=5))
    nbytes = s.nnz * (8 + 4) + (n + 1) * 8 + 2 * n * 8
    row = {k: sum(v) / 2 for k, v in out.items()}
    row["bound_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S
    print(f"  matvec (call time of 50, ms) ELL {row['ell']:.4f} flat CSR "
          f"{row['csr']:.4f} StencilMatrix {row['stencil']:.4f} torch "
          f"sparse CSR {row['library']:.4f} bound {row['bound_ms']:.4f} "
          f"(runs " + " ".join(f"{k} {'/'.join(f'{x:.4f}' for x in v)}"
                               for k, v in out.items()) + ")")
    return row


def _route_k1_checks(asm, label):
    """K1 against its plain version and the lowerer on the gather route's
    own inputs: each cell integral's cell-last gathers over all its cells
    (coordinates through coords_map, coefficients through coeff_maps), in
    float64 and float32, at full size."""
    from firedrake_tpu_torch.compiler import cell_eval as K
    coords, coeffs, consts = asm._inputs()
    cells = [(ci, st) for ci, st in zip(asm._compiled, asm._statics)
             if ci.integral_type == "cell"]
    if not cells:
        raise AssertionError(f"{label}: no cell integral to check")
    for ci, st in cells:
        spec = K.family_spec(ci)
        if spec is None:
            raise AssertionError(f"{label}: a cell integral is not in "
                                 "K1's family")
        ce = coords[st["coords_map"]]
        ws = tuple(coeffs[c.count][st["coeff_maps"][c.count]]
                   for c in ci.coefficients)
        cv = tuple(consts[c.count] for c in ci.constants)
        _k1_compare(K, f"{label} rank {asm.rank}", 0, spec, ci, ce, ws, cv,
                    False)
        del ce, ws


def gather_assembly(fd):
    """gather_p1_1024: the Helmholtz operator at UnitSquareMesh(1024)
    assembled by the gather route, held to the stencil route's matrix,
    timed warm in float64 and with float32 kernels."""
    import os
    from firedrake_tpu_torch.assemble import FormAssembler
    label = "gather_p1_1024"
    mesh = fd.UnitSquareMesh(1024, 1024)
    V = fd.FunctionSpace(mesh, "CG", 1)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    a = (fd.inner(fd.grad(u), fd.grad(v)) + u * v) * fd.dx
    with _Counts() as counts:
        asm, build_s = _sync_time(lambda: FormAssembler(a, use_stencil=False))
        A, cold_s = _sync_time(asm.assemble)
        warm_ms = _cuda_ms(asm.assemble, reps=10, warm=1)
    _route_k1_checks(asm, label)
    A_s = FormAssembler(a).assemble()
    Sg, Ss = A.to_scipy(), A_s.to_scipy()
    ref = abs(Ss).max()
    err = abs(Sg - Ss).max()
    os.environ["FDTPU_PREC"] = "f32"
    try:
        asm32 = FormAssembler(a, use_stencil=False)
    finally:
        del os.environ["FDTPU_PREC"]
    A32 = asm32.assemble()
    err32 = float(torch.linalg.vector_norm(A32.data - A.data)
                  / torch.linalg.vector_norm(A.data))
    warm32_ms = _cuda_ms(asm32.assemble, reps=10, warm=1)
    b64, b32 = _route_bytes(asm, 8), _route_bytes(asm32, 4)
    print(f"{label}: dofs {V.dim} cells {mesh.num_cells} nnz "
          f"{asm.sparsity.nnz} accumulation {type(asm._acc).__name__} "
          f"statics_build_s {build_s:.3f} "
          f"assembly_cold_s {cold_s:.4f} k1_launches {counts.k1} "
          f"lowerer_evals {counts.lowerer} max|A_gather - A_stencil| "
          f"{err:.3e} (max|A| {ref:.3e}) f32 normwise {err32:.3e}")
    print(f"  warm assembly f64 {warm_ms:.4f} ms (route bytes {b64}, bound "
          f"{1e3 * b64 / HBM_BYTES_PER_S:.4f} ms) f32 kernels "
          f"{warm32_ms:.4f} ms (route bytes {b32}, bound "
          f"{1e3 * b32 / HBM_BYTES_PER_S:.4f} ms)")
    if not err <= F64_TOL * ref:
        raise AssertionError(f"{label}: gather and stencil matrices differ")
    if not err32 <= F32_RTOL:
        raise AssertionError(f"{label}: f32 kernels off by {err32}")
    if counts.k1 <= 0 or counts.lowerer:
        raise AssertionError(f"{label}: assembly bypassed K1")
    mv = _matvec_timings(A, A_s)
    return counts, mv


def gather_solve(fd, label):
    """One gather-route solve at full size through LinearVariationalSolver,
    its launch counts read around set-up, assembly and solve; after them
    K1 held to its plain version on the route's inputs of a and L, and
    errornorm (a 0-form)."""
    from firedrake_tpu_torch.assemble import get_assembler
    cfg = GATHER[label]
    with warnings.catch_warnings():
        warnings.simplefilter("error")     # a non-converged solve warns
        with _Counts() as counts:
            p, setup_s = _sync_time(
                lambda: GATHER_PROBLEMS[label](fd, cfg["level"]))
            _, cold_s = _sync_time(lambda: (fd.assemble(p["a"]),
                                            fd.assemble(p["L"])))
            _, warm_s = _sync_time(lambda: (fd.assemble(p["a"]),
                                            fd.assemble(p["L"])))
            _, solve_s = _sync_time(p["solver"].solve)
    for form in (p["a"], p["L"]):
        _route_k1_checks(get_assembler(form), label)
    torch.cuda.empty_cache()
    solver, uh = p["solver"], p["uh"]
    its = solver.ksp_iterations
    (nodal, l2), err_s = _sync_time(lambda: _gather_errors(fd, p))
    want = CPU_REHEARSAL_ITS.get(label)
    print(f"{label}: dofs {uh.function_space().dim} setup_s {setup_s:.3f} "
          f"assembly_cold_s {cold_s:.3f} assembly_warm_s {warm_s:.4f} "
          f"solve_s {solve_s:.4f} iterations {its} (CPU rehearsal {want}) "
          f"ms_per_iteration {1e3 * solve_s / max(its, 1):.4f} converged "
          f"{solver.converged} max_nodal_err {nodal:.4e} (bound "
          f"{cfg['nodal']}) l2_err {l2:.4e} (bound {cfg['l2']}, errornorm "
          f"{err_s:.3f} s) on {uh.dat.device} k1_launches {counts.k1} "
          f"lowerer_evals {counts.lowerer}")
    if not uh.dat.is_cuda:
        raise AssertionError(f"{label}: solution is not on the card")
    if not solver.converged:
        raise AssertionError(f"{label}: solve did not converge")
    if counts.k1 <= 0 or counts.lowerer:
        raise AssertionError(f"{label}: cell integrals bypassed K1")
    if want is None or abs(its - want) > 0.01 * want:
        raise AssertionError(f"{label}: {its} iterations, the CPU "
                             f"rehearsal took {want}")
    if not (nodal < cfg["nodal"] and l2 < cfg["l2"]):
        raise AssertionError(f"{label}: errors {nodal}, {l2} above bounds")
    return counts


def gather_phase():
    t0 = phase("gather")
    import firedrake_tpu_torch as fd
    fd.set_device(torch.device("cuda"))
    used = {}
    used["gather_p1_1024"], mv = gather_assembly(fd)
    torch.cuda.empty_cache()
    for label in GATHER:
        used[label] = gather_solve(fd, label)
        torch.cuda.empty_cache()
    # the cached gather-route assemblers hold ~1 GB of index tables on the
    # card; free them before the 16M phase reads its peak memory
    _release("gather")
    phase_done("gather", t0)
    return used, mv


# ------------------------------------------------------- the nonlinear phase
# The three P1 cases share gmg_p1_1m's hierarchy, MeshHierarchy(
# UnitSquareMesh(32), 5): 1,050,625 dofs.  `study`: the levels of the CPU
# convergence study (python3 chip_smoke.py --cpu-study), which fixed the
# bounds below beforehand (PERF.md).
NONLINEAR_N0, NONLINEAR_LEVELS = 32, 5
NONLINEAR_STUDY = (1, 2, 3)
NEWTON_PARAMS = {"snes_rtol": 1e-10, "ksp_type": "cg", "ksp_rtol": 1e-8,
                 "pc_type": "mg"}
# Bounds, each twice the value extrapolated from the study's last level to
# level 5: max |u - s| of newton_p1_1m (s interpolated; 5.4768e-4,
# 1.3696e-4, 3.4241e-5 at levels 1-3, 4.0x per level), and the true
# relative residual of the left-preconditioned methods in krylov_p1_1m
# (GMRES and MINRES test the preconditioned residual, |M^-1 r| /
# |M^-1 b| <= 1e-10; their |r| / |b| was 1.194e-8, 1.376e-8, 2.164e-8,
# at most 1.57x per level).
NEWTON_ERR = 4.3e-6
LEFT_PC_TRUE_RESIDUAL = 1.1e-7
KRYLOV_METHODS = ("gmres", "fgmres", "bicgstab", "minres")
LEFT_PC = ("gmres", "minres")
BURGERS_N, BURGERS_STEPS = 256, 2
BURGERS_PARAMS = {"snes_rtol": 1e-8, "ksp_rtol": 1e-10}
# per Newton step: the residual assembly, the Jacobian (assembled, or the
# matrix-free operator), the PC set-up and the linear solve
NEWTON_STAGES = (
    ("residual", "firedrake_tpu_torch.solving",
     "NonlinearVariationalSolver._residual"),
    ("jacobian", "firedrake_tpu_torch.solving",
     "NonlinearVariationalSolver._jacobian"),
    ("pc_setup", "firedrake_tpu_torch.solving", "build_pc"),
    ("solve", "firedrake_tpu_torch.solving", "_run_ksp"))


def _newton_problem(fd, mesh, mat_type="aij"):
    """-lap u + u^2 = f, u = 0 on the boundary, u0 = 0, f interpolated
    from 2 pi^2 s + s^2 with s = sin(pi x) sin(pi y), so that u = s."""
    V = fd.FunctionSpace(mesh, "CG", 1)
    x, y = fd.SpatialCoordinate(mesh)
    s = fd.sin(fd.pi * x) * fd.sin(fd.pi * y)
    f = fd.Function(V).interpolate(2 * fd.pi ** 2 * s + s * s)
    u, v = fd.Function(V), fd.TestFunction(V)
    F = fd.inner(fd.grad(u), fd.grad(v)) * fd.dx + u * u * v * fd.dx \
        - f * v * fd.dx
    problem = fd.NonlinearVariationalProblem(
        F, u, bcs=fd.DirichletBC(V, 0, "on_boundary"))
    solver = fd.NonlinearVariationalSolver(
        problem, solver_parameters=dict(NEWTON_PARAMS, mat_type=mat_type))
    return dict(u=u, problem=problem, solver=solver,
                exact=fd.Function(V).interpolate(s))


def _newton_readings(p):
    """(Newton steps, CG iterations per step, final |F| / |F0|, max nodal
    error against s)."""
    solver, u = p["solver"], p["u"]
    r0 = solver.history[0]["rnorm"]
    rel = float(torch.linalg.vector_norm(solver._residual(u.dat))) / r0
    err = float((u.dat - p["exact"].dat).abs().max())
    return (solver.snes_iterations,
            [h["ksp_iterations"] for h in solver.history], rel, err)


def _krylov_problem(fd, mesh, method):
    """gmg_p1_1m's linear system under one Krylov method with GMG."""
    V = fd.FunctionSpace(mesh, "CG", 1)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    x, y = fd.SpatialCoordinate(mesh)
    f = fd.Function(V).interpolate(2 * fd.pi ** 2 * fd.sin(fd.pi * x)
                                   * fd.sin(fd.pi * y))
    a, L = fd.inner(fd.grad(u), fd.grad(v)) * fd.dx, fd.inner(f, v) * fd.dx
    bc = fd.DirichletBC(V, 0, "on_boundary")
    uh = fd.Function(V)
    solver = fd.LinearVariationalSolver(
        fd.LinearVariationalProblem(a, L, uh, bcs=bc),
        solver_parameters={"ksp_type": method, "pc_type": "mg",
                           "ksp_rtol": 1e-10})
    return dict(a=a, L=L, bc=bc, uh=uh, solver=solver)


def _krylov_readings(fd, p):
    """(iterations, true relative residual |b - A u| / |b|, preconditioned
    relative residual |M^-1 (b - A u)| / |M^-1 b|)."""
    A = fd.assemble(p["a"], bcs=p["bc"])
    b = fd.assemble(p["L"], bcs=p["bc"]).dat
    r = b - A.matvec(p["uh"].dat)
    pc = p["solver"]._gmg
    norm = torch.linalg.vector_norm
    return (p["solver"].ksp_iterations, float(norm(r) / norm(b)),
            float(norm(pc(r)) / norm(pc(b))))


def _burgers_problem(fd, n):
    """demos/burgers.py at UnitSquareMesh(n): vector P2, nu = 1e-4, the
    time step 1/n, u0 = (sin(pi x), 0)."""
    mesh = fd.UnitSquareMesh(n, n)
    V = fd.VectorFunctionSpace(mesh, "CG", 2)
    X = fd.SpatialCoordinate(mesh)
    u_, u = fd.Function(V, name="u_prev"), fd.Function(V, name="u")
    v = fd.TestFunction(V)
    u_.interpolate(fd.as_vector([fd.sin(fd.pi * X[0]), 0.0]))
    u.assign(u_)
    nu = fd.Constant(0.0001)
    timestep = 1.0 / n
    F = (fd.inner((u - u_) / timestep, v)
         + fd.inner(fd.dot(u, fd.nabla_grad(u)), v)
         + nu * fd.inner(fd.grad(u), fd.grad(v))) * fd.dx
    return dict(u=u, u_=u_, F=F)


def _burgers_steps(fd, p, steps, around=contextlib.nullcontext):
    """The demo's time loop for `steps` steps: (Newton steps per time
    step, GMRES iterations per Newton step, energies, the solvers).  Each
    solve runs inside `around()`; the energies, a check, outside it."""
    energy = [fd.assemble(fd.inner(p["u"], p["u"]) * fd.dx)]
    newton, gmres, solvers = [], [], []
    for _ in range(steps):
        solver = fd.NonlinearVariationalSolver(
            fd.NonlinearVariationalProblem(p["F"], p["u"]),
            solver_parameters=BURGERS_PARAMS)
        with around():
            solver.solve()
        if not solver.converged:
            raise AssertionError("burgers: Newton did not converge")
        newton.append(solver.snes_iterations)
        gmres.append([h["ksp_iterations"] for h in solver.history])
        solvers.append(solver)
        p["u_"].assign(p["u"])
        energy.append(fd.assemble(fd.inner(p["u"], p["u"]) * fd.dx))
    return newton, gmres, energy, solvers


class _LowererTimes:
    """Device time of the torch BatchedLowerer (CUDA events around each of
    its evaluations), summed per assembly: each evaluation of a form on
    either route (FormAssembler._run or _run_stencil) opens one, labelled
    by the form's rank.  Entered more than once, it keeps adding."""

    def __init__(self):
        self.buckets = []

    def __enter__(self):
        from firedrake_tpu_torch.compiler import cell_eval as K
        from firedrake_tpu_torch.assemble import FormAssembler as FA
        self.K, self.FA = K, FA
        self.orig = K._chunked, FA._run, FA._run_stencil

        def chunked(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = self.orig[0](*a, **kw)
            e.record()
            self.buckets[-1][1].append((s, e))
            return out

        def opens(fn):
            def run(asm, *a, **kw):
                self.buckets.append((asm.rank, []))
                return fn(asm, *a, **kw)
            return run

        K._chunked = chunked
        FA._run, FA._run_stencil = opens(self.orig[1]), opens(self.orig[2])
        return self

    def __exit__(self, *exc):
        self.K._chunked, self.FA._run, self.FA._run_stencil = self.orig
        torch.cuda.synchronize()
        self.per_assembly = [
            (rank, sum(s.elapsed_time(e) for s, e in ev), len(ev))
            for rank, ev in self.buckets]


def _newton_k1_checks(fd, p, label, matfree):
    """K1 on the Newton path's own inputs before the solve: the residual's
    and the Jacobian's cell integrals (and the matrix-free Jacobian's
    action) at the iterate u = s, the action's operand a seeded random
    vector; u is put back to 0 after."""
    from firedrake_tpu_torch.assemble import get_assembler
    from firedrake_tpu_torch.assembly.matfree import action_assembler
    prob, u = p["problem"], p["u"]
    u.dat = p["exact"].dat.clone()
    _stencil_k1_checks(get_assembler(prob.F), f"{label} residual")
    _stencil_k1_checks(get_assembler(prob.J), f"{label} Jacobian")
    if matfree:
        asm, w = action_assembler(prob.J)
        w.dat = torch.as_tensor(np.random.default_rng(1).standard_normal(
            w.function_space().dim), device=u.dat.device)
        _stencil_k1_checks(asm, f"{label} action")
        w.dat = torch.zeros_like(w.dat)
    u.dat = torch.zeros_like(u.dat)
    torch.cuda.empty_cache()


def _steps_line(label, hist, st):
    for i, h in enumerate(hist):
        print(f"{label} step {i}: |F| {h['rnorm']:.6e} ksp_iterations "
              f"{h['ksp_iterations']} residual_ms "
              f"{1e3 * st.calls['residual'][i]:.3f} jacobian_ms "
              f"{1e3 * st.calls['jacobian'][i]:.3f} pc_setup_ms "
              f"{1e3 * st.calls['pc_setup'][i]:.3f} solve_ms "
              f"{1e3 * st.calls['solve'][i]:.3f}")


def newton_run(fd, mesh, label, hier_s):
    matfree = label == "newton_mf_p1_1m"
    want_n, want_k = CPU_REHEARSAL_ITS[label]
    torch.cuda.reset_peak_memory_stats()
    p, setup_s = _sync_time(lambda: _newton_problem(
        fd, mesh, "matfree" if matfree else "aij"))
    _newton_k1_checks(fd, p, label, matfree)
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings():
        warnings.simplefilter("error")        # a non-converged solve warns
        with _Counts() as counts, _StageTimes(NEWTON_STAGES) as st:
            _, solve_s = _sync_time(p["solver"].solve)
    peak = torch.cuda.max_memory_allocated()
    n, ksp, rel, err = _newton_readings(p)
    _steps_line(label, p["solver"].history, st)
    print(f"{label}: dofs {p['u'].function_space().dim} newton_steps {n} "
          f"(CPU rehearsal {want_n}) ksp_iterations {ksp} (CPU rehearsal "
          f"{want_k}) converged {p['solver'].converged} final_rel_residual "
          f"{rel:.3e} max_nodal_err {err:.3e} (bound {NEWTON_ERR}) "
          f"hierarchy_s {hier_s:.3f} setup_s {setup_s:.3f} solve_s "
          f"{solve_s:.3f} device_peak {peak} ({peak / 2 ** 30:.3f} GiB) on "
          f"{p['u'].dat.device} k1_launches {counts.k1} k1_by_variant "
          f"{counts.k1_by_variant} lowerer_evals {counts.lowerer}")
    if not p["u"].dat.is_cuda:
        raise AssertionError(f"{label}: solution is not on the card")
    if not p["solver"].converged or n != want_n:
        raise AssertionError(f"{label}: {n} Newton steps, the CPU rehearsal "
                             f"took {want_n}")
    if len(ksp) != len(want_k) or any(abs(a - b) > 1
                                      for a, b in zip(ksp, want_k)):
        raise AssertionError(f"{label}: CG iterations {ksp}, the CPU "
                             f"rehearsal took {want_k}")
    if not rel <= 1e-10 or not err < NEWTON_ERR:
        raise AssertionError(f"{label}: residual {rel}, nodal error {err}")
    if counts.k1 <= 0 or counts.lowerer:
        raise AssertionError(f"{label}: the solve bypassed K1")
    return counts, p["u"].dat.clone()


def krylov_run(fd, mesh):
    label = "krylov_p1_1m"
    counts = _Counts()           # summed over the four solves alone
    for method in KRYLOV_METHODS:
        p = _krylov_problem(fd, mesh, method)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with counts, _StageTimes() as st:
                p["solver"].solve()
        its, true_rel, pc_rel = _krylov_readings(fd, p)
        want = CPU_REHEARSAL_ITS[label][method]
        print(f"{label} {method}: iterations {its} (CPU rehearsal {want}) "
              f"converged {p['solver'].converged} rel_residual "
              f"{true_rel:.3e} preconditioned_rel_residual {pc_rel:.3e} "
              f"pc_setup_s {st.secs['pc_setup']:.3f} solve_s "
              f"{st.secs['solve']:.4f} ms_per_iteration "
              f"{1e3 * st.secs['solve'] / max(its, 1):.4f}")
        if not p["solver"].converged or abs(its - want) > 1:
            raise AssertionError(f"{label} {method}: {its} iterations, "
                                 f"the CPU rehearsal took {want}")
        # the residual each method's test reads: preconditioned for the
        # left-preconditioned ones, else the true one
        if not (pc_rel if method in LEFT_PC else true_rel) <= 1e-10:
            raise AssertionError(f"{label} {method}: residual "
                                 f"{true_rel} / {pc_rel}")
        if method in LEFT_PC and not true_rel < LEFT_PC_TRUE_RESIDUAL:
            raise AssertionError(f"{label} {method}: true residual "
                                 f"{true_rel}")
        del p
        torch.cuda.empty_cache()
    print(f"{label}: k1_launches {counts.k1} k1_by_variant "
          f"{counts.k1_by_variant} lowerer_evals {counts.lowerer}")
    if counts.k1 <= 0 or counts.lowerer:
        raise AssertionError(f"{label}: assembly bypassed K1")
    return counts


def burgers_run(fd):
    label = "burgers_p2_256"
    want = CPU_REHEARSAL_ITS[label]
    torch.cuda.reset_peak_memory_stats()
    p, setup_s = _sync_time(lambda: _burgers_problem(fd, BURGERS_N))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        counts, st, lt = _Counts(), _StageTimes(NEWTON_STAGES), \
            _LowererTimes()
        solve_s = []

        @contextlib.contextmanager
        def around():
            with counts, st, lt:
                torch.cuda.synchronize()
                t = time.perf_counter()
                yield
                torch.cuda.synchronize()
                solve_s.append(time.perf_counter() - t)
        newton, gmres, energy, solvers = _burgers_steps(
            fd, p, BURGERS_STEPS, around)
    peak = torch.cuda.max_memory_allocated()
    k = 0
    for t, solver in enumerate(solvers):
        for i, h in enumerate(solver.history):
            print(f"{label} time step {t} newton step {i}: |F| "
                  f"{h['rnorm']:.6e} gmres_iterations {h['ksp_iterations']} "
                  f"jacobian_ms {1e3 * st.calls['jacobian'][k]:.3f} "
                  f"pc_setup_ms {1e3 * st.calls['pc_setup'][k]:.3f} "
                  f"solve_ms {1e3 * st.calls['solve'][k]:.3f}")
            k += 1
    asm = [(r, ms, n) for r, ms, n in lt.per_assembly if n]
    for rank in (1, 2):
        ms = [m for r, m, _ in asm if r == rank]
        print(f"{label}: rank-{rank} assemblies {len(ms)} lowerer_ms per "
              f"assembly " + " ".join(f"{m:.3f}" for m in ms))
    rel_e = max(abs(a - b) / abs(b) for a, b in zip(energy, want["energy"]))
    print(f"{label}: dofs {p['u'].function_space().dim} newton_steps "
          f"{newton} (CPU rehearsal {want['newton']}) gmres_iterations "
          f"{gmres} (CPU rehearsal {want['gmres']}) energy "
          + " ".join(repr(e) for e in energy)
          + f" (rel. to the rehearsal {rel_e:.3e}) setup_s {setup_s:.3f} "
          f"solve_s {' '.join(f'{x:.3f}' for x in solve_s)} device_peak "
          f"{peak} ({peak / 2 ** 30:.3f} GiB) k1_launches {counts.k1} "
          f"k1_by_variant {counts.k1_by_variant} lowerer_evals "
          f"{counts.lowerer} lowerer_ms_total "
          f"{sum(m for _, m, _ in asm):.3f}")
    if not p["u"].dat.is_cuda:
        raise AssertionError(f"{label}: solution is not on the card")
    if newton != want["newton"]:
        raise AssertionError(f"{label}: Newton steps {newton}")
    for got, ref in zip(gmres, want["gmres"]):
        if len(got) != len(ref) or any(abs(a - b) > 0.02 * b
                                       for a, b in zip(got, ref)):
            raise AssertionError(f"{label}: GMRES iterations {gmres}")
    if not all(b < a for a, b in zip(energy, energy[1:])) \
            or not rel_e <= 1e-8:
        raise AssertionError(f"{label}: energies {energy}")
    if not counts.lowerer:
        raise AssertionError(f"{label}: the lowerer did not run")
    return counts


def nonlinear_phase():
    """Newton (assembled and matrix-free Jacobians) and the four Krylov
    methods at 1,050,625 P1 dofs with GMG, then two Burgers time steps at
    526,338 vector P2 dofs (the torch lowerer)."""
    t0 = phase("nonlinear")
    import firedrake_tpu_torch as fd
    fd.set_device(torch.device("cuda"))
    used = {}
    hier, hier_s = _sync_time(lambda: fd.MeshHierarchy(
        fd.UnitSquareMesh(NONLINEAR_N0, NONLINEAR_N0), NONLINEAR_LEVELS))
    mesh = hier.meshes[-1]
    used["newton_p1_1m"], u_asm = newton_run(fd, mesh, "newton_p1_1m",
                                             hier_s)
    used["newton_mf_p1_1m"], u_mf = newton_run(fd, mesh, "newton_mf_p1_1m",
                                               hier_s)
    diff = float((u_mf - u_asm).abs().max() / u_asm.abs().max())
    print(f"newton_mf_p1_1m: max|u_mf - u_assembled| / max|u| {diff:.3e}")
    if not diff <= 1e-10:
        raise AssertionError("newton_mf_p1_1m: differs from newton_p1_1m")
    del u_asm, u_mf
    used["krylov_p1_1m"] = krylov_run(fd, mesh)
    del hier, mesh
    _release("newton and krylov")
    used["burgers_p2_256"] = burgers_run(fd)
    _release("nonlinear")
    phase_done("nonlinear", t0)
    return used


def nonlinear_cpu(labels, levels=NONLINEAR_LEVELS, n=BURGERS_N,
                  tag="cpu_rehearsal"):
    """The nonlinear phase's cases on the CPU (the plain kernel versions):
    the counts the card must match, and the errors and residuals of the
    convergence study."""
    import firedrake_tpu_torch as fd
    fd.set_device("cpu")
    mesh = None
    for label in labels:
        t0 = time.perf_counter()
        if label == "burgers_p2_256":
            p = _burgers_problem(fd, n)
            newton, gmres, energy, _ = _burgers_steps(fd, p, BURGERS_STEPS)
            print(f"{tag} {label} n {n}: dofs "
                  f"{p['u'].function_space().dim} newton {newton} gmres "
                  f"{gmres} energy {[repr(e) for e in energy]} seconds "
                  f"{time.perf_counter() - t0:.1f}", flush=True)
            continue
        if mesh is None:
            mesh = fd.MeshHierarchy(fd.UnitSquareMesh(
                NONLINEAR_N0, NONLINEAR_N0), levels).meshes[-1]
        if label == "krylov_p1_1m":
            for method in KRYLOV_METHODS:
                p = _krylov_problem(fd, mesh, method)
                p["solver"].solve()
                its, true_rel, pc_rel = _krylov_readings(fd, p)
                print(f"{tag} {label} {method} levels {levels}: iterations "
                      f"{its} rel_residual {true_rel:.3e} "
                      f"preconditioned_rel_residual {pc_rel:.3e}",
                      flush=True)
            continue
        p = _newton_problem(fd, mesh, "matfree" if label == "newton_mf_p1_1m"
                            else "aij")
        p["solver"].solve()
        steps, ksp, rel, err = _newton_readings(p)
        print(f"{tag} {label} levels {levels}: dofs "
              f"{p['u'].function_space().dim} newton {steps} ksp {ksp} "
              f"final_rel_residual {rel:.3e} max_nodal_err {err:.4e} "
              f"seconds {time.perf_counter() - t0:.1f} host_max_rss_gib "
              f"{_max_rss_gib():.2f}", flush=True)


NONLINEAR_LABELS = ("newton_p1_1m", "newton_mf_p1_1m", "krylov_p1_1m",
                    "burgers_p2_256")


def cpu_study(labels):
    """The gather-route solves and the nonlinear phase's P1 cases (all, or
    those named) on the CPU at their study levels: iterations, errors and
    residuals, and (gather) their rates per level."""
    import firedrake_tpu_torch as fd
    labels = labels or list(GATHER) + ["newton_p1_1m", "krylov_p1_1m"]
    for label in labels:
        if label in ("newton_p1_1m", "krylov_p1_1m"):
            for level in NONLINEAR_STUDY:
                nonlinear_cpu([label], levels=level, tag="cpu_study")
    fd.set_device("cpu")
    for label, cfg in GATHER.items():
        if label not in labels:
            continue
        prev = None
        for level in cfg["study"]:
            t0 = time.perf_counter()
            p = GATHER_PROBLEMS[label](fd, level)
            p["solver"].solve()
            nodal, l2 = _gather_errors(fd, p)
            rates = ("" if prev is None else
                     f" nodal_ratio {prev[0] / nodal:.3f} l2_ratio "
                     f"{prev[1] / l2:.3f}")
            print(f"cpu_study {label} level {level}: dofs "
                  f"{p['uh'].function_space().dim} iterations "
                  f"{p['solver'].ksp_iterations} converged "
                  f"{p['solver'].converged} max_nodal_err {nodal:.4e} "
                  f"l2_err {l2:.4e}{rates} seconds "
                  f"{time.perf_counter() - t0:.1f}", flush=True)
            prev = (nodal, l2)


def cpu_rehearsal(labels):
    """The GMG solves (all, or those named) on the CPU with the plain
    kernel versions; prints each iteration count."""
    import firedrake_tpu_torch as fd
    labels = labels or list(GMG) + list(GATHER) + list(NONLINEAR_LABELS)
    nonlinear_cpu([lb for lb in labels if lb in NONLINEAR_LABELS])
    fd.set_device("cpu")
    for label in labels:
        if label in NONLINEAR_LABELS:
            continue
        if label in GATHER:
            t0 = time.perf_counter()
            p = GATHER_PROBLEMS[label](fd, GATHER[label]["level"])
            p["solver"].solve()
            nodal, l2 = _gather_errors(fd, p)
            print(f"cpu_rehearsal {label}: dofs "
                  f"{p['uh'].function_space().dim} iterations "
                  f"{p['solver'].ksp_iterations} converged "
                  f"{p['solver'].converged} max_nodal_err {nodal:.4e} "
                  f"l2_err {l2:.4e} seconds {time.perf_counter() - t0:.1f} "
                  f"host_max_rss_gib {_max_rss_gib():.2f}", flush=True)
            continue
        cfg = GMG[label]
        t0 = time.perf_counter()
        _, _, a, L, bc, uh, solver, exact = _gmg_problem(fd, **cfg)
        solver.solve()
        err = float((uh.dat - exact.dat).abs().max())
        rel = _rel_residual(fd, a, L, bc, uh,
                            cfg["params"].get("mat_type") == "matfree")
        print(f"cpu_rehearsal {label}: dofs {uh.function_space().dim} "
              f"iterations {solver.ksp_iterations} converged "
              f"{solver.converged} max_nodal_err {err:.3e} rel_residual "
              f"{rel:.3e} seconds {time.perf_counter() - t0:.1f} "
              f"host_max_rss_gib {_max_rss_gib():.2f}", flush=True)


def main():
    t0 = time.perf_counter()
    device_phase()
    build_phase()
    k1, k2, k2_large = kernels_phase()
    used = main_phase()
    gathered, matvec = gather_phase()
    used.update(gathered)
    used.update(nonlinear_phase())
    used["gmg_p2_tet_16m"], k1_action = north_star_phase()
    for label, c in used.items():
        print(f"launches {label}: k1 {c.k1} k2 {c.k2} k2_large "
              f"{c.k2_large}")
    main_path = used["gmg_star_p2_1m"]
    print(f"total_s {time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": [
        {"name": "cell_eval",
         "route": "cuda",
         "source": "firedrake_tpu_torch/csrc/cell_eval.cu",
         "replaces": "firedrake_tpu/compiler/pallas_eval.py:88",
         "launches": main_path.k1,
         "launches_by_path": {k: c.k1 for k, c in used.items()},
         "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"],
         "call_ms": k1["call_ms"],
         "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"],
         "bound_by": "bytes",
         "library_ms": None,
         "torch_ms": None,
         # the action variant (matrix-free matvecs), timed on the 16M
         # solve's fine level
         "action": k1_action},
        {"name": "batched_inv",
         "route": "cuda",
         "source": "firedrake_tpu_torch/csrc/batched_inv.cu",
         "replaces": "firedrake_tpu/ops/batched_inverse.py:60",
         "launches": main_path.k2,
         "launches_by_path": {k: c.k2 for k, c in used.items()},
         "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"],
         "call_ms": k2["call_ms"],
         "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"],
         "library_ms": k2["library_ms"],
         "torch_ms": k2["library_ms"]},
        # the large variant (33 <= n <= 128), same source; no solve path
        # of this script has patches that large
        {"name": "batched_inv_large",
         "route": "cuda",
         "source": "firedrake_tpu_torch/csrc/batched_inv.cu",
         "replaces": "firedrake_tpu/ops/batched_inverse.py:60",
         "launches": main_path.k2_large,
         "launches_by_path": {k: c.k2_large for k, c in used.items()},
         "shape": k2_large["shape"],
         "max_abs_err": k2_large["max_abs_err"],
         "ms": k2_large["ms"],
         "call_ms": k2_large["call_ms"],
         "plain_ms": k2_large["plain_ms"],
         "bound_ms": k2_large["bound_ms"],
         "bound_by": k2_large["bound_by"],
         "library_ms": k2_large["library_ms"]}],
        # the CSR matrix's SpMV at 1,050,625 rows (torch ops, no kernel)
        "gather_matvec_ms": matvec}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-rehearsal"]:
        cpu_rehearsal(sys.argv[2:])
    elif sys.argv[1:2] == ["--cpu-study"]:
        cpu_study(sys.argv[2:])
    else:
        main()
