"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # the card run (needs CUDA)
    python3 chip_smoke.py --cpu-rehearsal [label ...]
                                          # the GMG, gather-route and
                                          # nonlinear-phase solves on the
                                          # CPU only (the counts the card
                                          # must match)
    python3 chip_smoke.py --cpu-study [label ...]
                                          # the gather-route solves', the
                                          # P1 nonlinear cases',
                                          # poisson_mixed_rt1_256's and
                                          # the slate cases' and the
                                          # extruded GMG and spectral
                                          # cases', pmg_p4_256's,
                                          # fdm_q4_256's and
                                          # eigen_p1_512's CPU
                                          # convergence study (bounds)
    python3 chip_smoke.py --only slate    # device, build and the named
                                          # phases alone (main, slate,
                                          # dg_mixed, gather, nonlinear,
                                          # extruded, fieldsplit,
                                          # multilevel, ddm, adjoint,
                                          # meshio, transfer)
    python3 chip_smoke.py --only ml_rounding
                                          # pmg_p4_256's and fdm_q4_256's
                                          # errornorms taken apart: card
                                          # against host CPU, residuals
                                          # in long double, iterative
                                          # refinement (prints only)
    python3 chip_smoke.py --only pcd_limit
                                          # PCDPC's dense Kp pseudo-
                                          # inverse on the card and the
                                          # host at navier_stokes_pcd_64's
                                          # size and the next (seconds,
                                          # memory)

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
             (33 <= n <= 128) at (65,536, 40, 40) and (16,384, 64, 64),
             float64 and float32, (16,641, 65, 65) and (81, 117, 117), and
             pivoted at (16,384, 64, 64) float64, bit for bit with its
             plain version, timed the same way, each row with its launch
             plan and its exact-arithmetic floor beside the bound (2 n^3
             nb unfused operations at the vector pipe's rate).  K2's
             huge variant (n > 128, blocked by panels of w = 64 columns)
             on random SPD blocks at n = 129, 256, 513 and the pivoted
             mode of each variant on blocks with a zero leading pivot at
             n = 7, 65, 300, float64 and float32: the warp and large
             variants bit for bit with their plain versions, the huge
             variant by its library-relative gate (huge_gate:
             max|X - X_ref| within 4 max|X_lib - X_ref| or n eps
             max|X_ref|, X_ref the plain version in float64 and the
             float64 inverse in float32, X_lib = torch.linalg.inv of the
             same blocks; max|A X - I| within 4 times the larger of the
             library's and the plain version's); the huge variant is
             timed on bddc_p1_1024's own blocks in the ddm phase.
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
7. dg_mixed — dg_advection_512: demos/DG_advection.py at
             UnitSquareMesh(512) (DG1, 1,572,864 dofs, 785,408 interior
             and 2,048 exterior facets), SSPRK3 with VertexBasedLimiter
             after every stage, dt = 0.2/512, 4 steps (12 stages).  Per
             stage (CUDA events; the first stage apart, it holds the
             assembler builds): the RHS assembly split into its cell
             integral (the torch lowerer) and its facet integrals (the
             vmapped facet kernels), the DG1 mass matrix (K1, REF
             variant), CG + Jacobi iterations and ms, the limiter; K1
             launches by variant and lowerer_evals counted over the stages
             alone; one VTKFile write of q (seconds, bytes).  Gates:
             |mass - mass0| <= 1e-10, -1e-8 <= q <= 1 + 1e-8 after every
             stage, q within 1e-10 of the same run on the CPU in this
             process (--cpu-rehearsal dg_advection_512 runs it alone),
             K1 held to its plain version on the mass form's inputs.
             poisson_mixed_rt1_256: demos/poisson_mixed.py at
             UnitSquareMesh(256), RT1 x DG0 (328,192 dofs): the block
             assembly on the card (all in the lowerer, RT1's dof signs on
             the card; K1 must not run), preonly + lu (host splu) timed
             apart, the BlockMatrix matvec beside its byte bound; gate:
             the L2 errors of u_h and sigma_h below MIXED_ERR (twice the
             --cpu-study extrapolation).
8. slate  — hybridized_rt2_256: demos/hybridized_poisson.py at
             UnitSquareMesh(256) (RT2 x DG1, 1,049,600 dofs; 131,072
             packed 11 x 11 broken mixed blocks; HDiv Trace 1, 394,240
             dofs), solved with the demo's preonly + lu trace solve (host
             splu), then with CG + Jacobi at rtol 1e-12 on the card; per
             solve the CUDA-event times of the local tensors (lowerer,
             facet kernels), K2, the Slate contractions, global assembly,
             the trace solve and back-substitution, the first solve apart
             from the second.  Gates: the L2 error of u_h below
             SLATE_ERR, CG iterations within 1% of the CPU rehearsal, the
             CG solution within 1e-8 of the LU one, the card within 1e-10
             of the same LU solve on the CPU in this process, K2 and the
             lowerer launched.  scpc_p5_128: P5 Poisson on
             UnitSquareMesh(128), pc_type scpc (410,881 dofs, 214,273
             after condensation), CG + Jacobi at rtol 1e-12 on the
             condensed system on the card, the same stage times; gates:
             the nodal error below SLATE_ERR, CG iterations within 1% of
             the rehearsal, K2 launched, and the same problem at 64^2 on
             the card within 1e-10 of it on the CPU in this process.  On
             each path's own blocks (the
             packed local A; the interior blocks A_II) K2 is held to its
             plain version (max |delta| <= 1e-13 max|inv|) and timed as
             in phase 3.
9. extruded — shallow_water_ext_128: demos/extruded_shallow_water.py on
             UnitSquareMesh(128) extruded to 16 layers (524,288 prisms;
             W = HDiv(BDM1 x DG0) 1,581,056 dofs, X = DG0 524,288) at the
             demo's Courant number (dt = 0.1 h), 8 Strang steps (24 CG
             solves) and the P1 x P1 projection (the column plan): per
             step the CUDA-event times of assembly, the column plan, the
             lowerer and CG, the host wall time and the assembler
             cache's new entries; gates: the demo's energy assertion, the
             drift below twice the CPU rehearsal's, each CG count within
             one of it, no cache miss after the first step, and the same
             run at the Firedrake demo's size (base 32, 4 layers) on the
             card and on the CPU in this process within 1e-10 (energies,
             p).  gmg_ext_hex_1m: -lap u = f, u = x(1-x)y(1-y)z(1-z), Q1
             on ExtrudedMeshHierarchy(MeshHierarchy(UnitSquareMesh(16,
             16, quadrilateral=True), 3), base_layer=8) (1,048,576 hexes,
             1,081,665 dofs; every level a ColumnMatrix), CG + GMG: the
             hierarchy's host seconds apart, relative residual <= 1e-10,
             nodal error and iterations against the CPU rehearsal, the
             finest ColumnMatrix's matvec beside its byte bound.
             spectral_q4_periodic_256: Q4 Helmholtz on
             PeriodicUnitSquareMesh(256, quadrilateral=True) (1,048,576
             dofs; the gather route, the sum-factorised plan chosen
             without a switch), CG + Jacobi: stage times, nodal error and
             iterations against the CPU study and rehearsal; the plan's
             local tensors within 1e-11 max|A| of the direct lowerer on
             the first 4,096 cells, both timed.  K1 and K2 launch 0 times
             on these paths.  Every case runs and prints; the phase fails
             after the last if any case failed.
10. fieldsplit — each case with every launch count set to 0 before its
             counted solve and read after, printing its stage times
             (assembly, PC set-up, GMG set-up, K2, solve: CUDA events;
             Newton per step): stokes_th_schur_256 (tests/regression/
             test_solver_composition.py test_mg_inside_fieldsplit on
             MeshHierarchy(UnitSquareMesh(16), 4): Taylor-Hood P2-P1,
             592,387 dofs, Poiseuille flow; fgmres at rtol 1e-8, Schur
             full, GMG with Chebyshev(3) on the velocity block, MassInvPC
             on the pressure); gates: converged, iterations within one of
             the CPU rehearsal, the velocity's errornorm below
             FIELDSPLIT_ERR, K1 launched, K2 not; then K2's large variant
             on that operator's (66,049, 39, 39) Vanka patches against
             its plain version, timed as in phase 3.
             stokes_th_vanka_24 (test_vanka_smoother at UnitSquareMesh(24),
             5,427 dofs, fgmres with pc_type vanka): iterations within 2%
             of the rehearsal, errornorm below FIELDSPLIT_ERR, one launch
             of K2's large variant, held to its plain version on the
             (625, 39, 39) patches.  navier_stokes_pcd_64
             (test_navier_stokes_schur[pcd] at UnitSquareMesh(64), 37,507
             dofs: Newton, fgmres, Schur full, fieldsplit_1 gmres with
             PCDPC): Newton steps and fgmres counts equal to the
             rehearsal's, 0.9 < max|u_x| < 1.3, max u_y > 0.02; the same
             problem at 32^2 on the card and on the CPU in this process,
             the velocity within 1e-8, the counts of every Newton step
             equal; K1 launched (the pressure mass, stiffness and
             convection), K2 not.  navier_stokes_pcd_128 (the same at UnitSquareMesh(128),
             148,739 dofs, on the card alone): Newton steps and fgmres
             counts equal to the CPU rehearsal's, the flow bounds, max
             u_y within 1e-8 of the rehearsal's.  In the Stokes Schur
             case and the cavities K1 is held to
             its plain version and the lowerer on the inputs of each
             form that the case's run gave it (every launch of the run
             through one of them).  Every case runs and prints; the
             phase fails after the last if any failed.
11. multilevel — each case with every launch count set to 0 before its
             counted solve and read after, printing its stage times
             (host set-up; assembly, PC set-up, K2 and CG by CUDA events;
             FAS: residuals, diagonals, the coarsest Newton) and ms per
             iteration: pmg_p4_256 (P4 Poisson at 256^2, 1,050,625 dofs,
             CG + pmg, the P1 level by GMG; iterations within one of the
             CPU rehearsal, ||b - A u|| / ||b|| <= 1e-10, errornorm below
             ML_ERR, K1 launched on the P2 and P1 levels and held to its
             plain version on their inputs); fas_bratu_p1_1024 (Bratu by
             FAS at 1024^2, 7 levels: converged, at most 3 cycles more
             than the rehearsal at 64^2, within FAS_ATOL of Newton + GMG
             on the card); linesmooth_q1_ext_128 (Q1 on a 128^2 x 64 slab,
             1,081,665 dofs, GMG with vertical line smoothers: iterations
             within one of the rehearsal, residual <= 1e-8, K2's large
             variant once per smoothed level, held to its plain version
             on the finest level's (16,641, 65, 65) patch matrices and
             timed as in phase 3); fdm_q4_256 (Q4 at 256^2 by CG + FDMPC:
             iterations within one of the rehearsal and below 60,
             errornorm below ML_ERR); then gridline_p1_cube_16,
             extruded_star_q2_ext_6 (K2's large variant at (81, 117, 117),
             held to its plain version and timed), npc_patch_bratu_64,
             pfas_bratu_p4_8 and facet_split_p4_32, each held to the same
             solve on the CPU in this process (within 1e-10, equal
             counts).  Every case runs and prints; the phase fails after
             the last if any failed.
12. ddm    — each case with every launch count set to 0 before its
             counted run and read after: bddc_p1_1024 (-lap u = 2 pi^2
             sin(pi x) sin(pi y) on UnitSquareMesh(1024), P1, CG at rtol
             1e-10 with BDDCPC at its default 512 subdomains; stage times
             by CUDA events: host tables, local tensors, each K2 call,
             CG, ms per iteration, the device peak; gates: converged,
             ||b - A u|| / ||b|| <= 1e-10, nodal error below 5e-5, three
             launches of K2's huge variant (M_int, K, S_Pi), one of them
             pivoted; then K2 on the path's first two M_int and K blocks
             held to its plain versions by the huge variant's gate, and
             timed on 64 of them beside the plain version,
             torch.linalg.inv and the bound, with w, the launches per
             call, both distances and the residuals); eigen_p1_512
             (test_aux_components.py's Dirichlet Laplacian with mass at
             512^2, the 4 smallest eigenvalues
             by host ARPACK on the card's matrices, the card's assembly
             and ARPACK timed apart; each within EIGEN_ERR of pi^2 (i^2 +
             j^2)); deflation_bratu_p1_1024 (Bratu, -lap u = 2 exp(u), on
             gmg_p1_1m's hierarchy, Newton with backtracking, Deflation()
             and GMRES + GMG at ksp_rtol 1e-8, two roots from one guess;
             per step |F|, GMRES iterations and tau; gates: both
             converged at snes_rtol 1e-10, ||u1 - u2||_L2 > 1, Newton
             steps equal to the CPU rehearsal at 512^2, GMRES iterations
             within 2% of it); then bddc_p2_16, bddc_elasticity_16,
             bddc_p1_cube_6, lobpcg_p1_12 and linesmooth_cap_129 (the
             129-dof lines, on K2's huge variant), each held to the same
             solve on the CPU in this process (within 1e-10, equal
             counts).  `--only ddm` runs it alone.
13. adjoint — the port's adjoint (firedrake_tpu_torch/adjoint/), every
             solve by CG + GMG on a MeshHierarchy of UnitSquareMesh(32),
             each case with every launch count set to 0 before its
             counted runs and read after: inversion_p1_1024
             (demos/poisson_inversion.py's problem at 1,050,625 P1 dofs,
             J = 1/2 ||u(f) - u_obs||^2 + 1e-6/2 ||f||^2, every solve to
             ksp_rtol 1e-10: the forward solve, the gradient with its
             adjoint solve's iterations and ms per iteration, a 4-step
             Taylor test, one Hessian action against grad J(f + d) -
             grad J(f) (J is quadratic: within 1e-7), 5 L-BFGS-B
             iterations of minimize with J falling, the device peak; then
             K1 held to its plain version and the lowerer on every form
             of its family that the case assembled on the fine mesh);
             heat_adjoint_p1_512 (263,169 dofs, ten backward-Euler steps
             by solve(F == 0) and assign, the initial condition the
             control: the gradient, its L2 Riesz map by host LU, Taylor
             rates); covariance_p1_1024 (AutoregressiveCovariance, m = 4,
             K solves by CG + GMG: B (M x) within 1e-4 of its closed
             form x / c on x = cos(pi x) cos(pi y),
             apply_action(apply_inverse(x)) back to x within 1e-10 times
             max|B^-1 x| / max|x|, CG with CovariancePC in at most 3
             iterations, one white-noise sample whose B^-1 norm is
             within 5% of dim); in both, K1 held to its plain version as
             in the inversion; gates: Taylor rates >= 1.9, every Krylov
             solve converged (a tape solve that does not converge
             raises), K1 launched; then adjoint_64: the three cases at
             64^2 with every solve to ksp_rtol 1e-12 on the card and on
             the CPU in this process, the gradients, the Hessian action,
             the heat gradient and the covariance's B x, B^-1 x, norm
             and first seeded sample within 1e-10 of max|CPU|.
             `--only adjoint` runs it alone.
14. transfer — each case with every launch count set to 0 before its
             counted run and read after; every gate is checked after
             all four ran: hiptmair_n1curl_576 (test_hiptmair.py's
             H(curl) Riesz map of a constant on N1curl1 of
             MeshHierarchy(UnitSquareMesh(36), 4), 996,480 dofs, CG to
             1e-8 with HiptmairPC: Jacobi on the fine level, one V-cycle
             on the 332,929-dof P1 potential space; G's build, matvec
             and transpose times; Jacobi-CG's count beside it; gates:
             errornorm(f, u_h) < 1e-6, the CPU rehearsal's count +-1);
             gtmg_hybrid_rt1_512 (test_gtmg.py's mixed Poisson at 512^2
             by hybridization, the 787,456-dof trace by CG + GTMGPC with
             a P1 coarse space; stage times by CUDA events; K2 held bit
             for bit to its plain version on Slate's blocks; gates: the
             DG0 error below twice the study's extrapolation, the
             rehearsal's count +-1); nonnested_gmg_p1_1024 (P1 Poisson
             by CG + GMG on NonNestedHierarchy over jittered 160^2,
             400^2 and 1024^2 meshes, each made by Mesh() on a jittered
             coordinate Function; the cross-mesh transfers' build and
             point location timed apart; gates: rel_residual <= 1e-10,
             the nodal error below twice the study's bound, the card
             within 1e-10 of the CPU at (10, 25, 64) in this process);
             supermesh_p1_512_384 (supermesh_project from P1 on a
             jittered 512^2 mesh onto P1 on a jittered 384^2 mesh:
             candidate pairs, clipping on the card and accumulation
             timed apart; the row sums' miss against int phi_i taken
             apart by the clipping's two tolerances; gates: mass within
             1e-12 relative, the mixed mass matrix's rows within 1e-15
             of int phi_i (absolute), and within 1e-12 relative with
             exact clipping and every fan piece kept, the L2 error below
             twice the study's, the clipping on the card equal to the
             CPU's within 1e-12 at (24, 18)); K1 held to its plain
             version on the inputs of every form of its family that
             each case assembled.  `--only transfer` runs it alone.
15. gmg_p2_tet_16m — the 16M-dof north star (the JAX bench's cg_gmg_16m):
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
import math
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
# The FP64 and FP32 vector pipes in unfused operations per second (data
# sheet: 33.5 and 67 TFLOP/s outside the tensor cores, an FMA counted as
# two): the floor of a kernel that rounds each product and sum apart.
VECTOR_OPS_PER_S = {torch.float64: 33.5e12 / 2, torch.float32: 67e12 / 2}

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
                                 0.4999546803647855]),
                     # the slate phase: CG iterations on the trace and on
                     # the condensed system (within 1%)
                     "hybridized_rt2_256": 1434, "scpc_p5_128": 1422,
                     # the extruded phase (within one)
                     "gmg_ext_hex_1m": 11, "spectral_q4_periodic_256": 10,
                     # the fieldsplit phase: fgmres iterations (within one;
                     # Vanka within 2%)
                     "stokes_th_schur_256": 28, "stokes_th_vanka_24": 404,
                     # Newton steps and fgmres iterations per step (equal;
                     # at 64^2 also the CPU solve's in the same process)
                     "navier_stokes_pcd_64": (4, [2, 2, 3, 3]),
                     "navier_stokes_pcd_128": (4, [2, 2, 3, 3]),
                     # the multilevel phase: CG iterations (within one);
                     # FAS cycles at 64^2 (the card's at 1024^2 at most
                     # 3 more)
                     "pmg_p4_256": 12, "linesmooth_q1_ext_128": 5,
                     "fdm_q4_256": 10, "fas_bratu_p1_1024": 11,
                     # the meshio phase: CG iterations on the gmsh file's
                     # mesh (within 1%)
                     "gmsh_helmholtz_p1_1024": 5712}


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
    """B B^T + n I in float64 on the card (B seeded standard normal),
    then cast."""
    B = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (nb, n, n)), device="cuda")
    eye = torch.eye(n, dtype=torch.float64, device="cuda")
    return (B @ B.transpose(1, 2) + n * eye).to(dtype)


def _k2_compare(BI, label, A, pivot=False):
    """K2 against its plain version on A: within F64_TOL (K2_F32_RTOL)
    max|plain|, and in float64 max|A X - I| < 1e-9 (unpivoted: SPD
    blocks; pivoted blocks are random, the residual only printed)."""
    out = BI.batched_inv(A, pivot)
    plain = BI.batched_inv_plain(A, pivot)
    torch.cuda.synchronize()
    ref = float(plain.abs().max())
    err = float((out - plain).abs().max())
    f64 = A.dtype == torch.float64
    tol = F64_TOL * ref if f64 else K2_F32_RTOL * ref
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    res = float((A @ out - eye).abs().max()) if f64 else float("nan")
    ok = err <= tol and (not f64 or pivot or res < 1e-9)
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


#: the rows of K2's large variant in the kernels phase: (batch, n, dtype,
#: pivoted); random SPD blocks, pivoted ones random with a zero leading
#: entry.  (16,641, 65) and (81, 117) are the shapes of the line and
#: extruded-star patches of the multilevel phase.
K2_LARGE_ROWS = ((65536, 40, torch.float64, False),
                 (65536, 40, torch.float32, False),
                 (16384, 64, torch.float64, False),
                 (16384, 64, torch.float32, False),
                 (16641, 65, torch.float64, False),
                 (81, 117, torch.float64, False),
                 (16384, 64, torch.float64, True))


def _floor_ms(nb, n, dtype):
    """The exact-arithmetic floor of a batched Gauss-Jordan inverse that
    rounds every product and difference apart: 2 n^3 nb unfused
    operations at the vector pipe's rate."""
    return 1e3 * 2 * n ** 3 * nb / VECTOR_OPS_PER_S[dtype]


def k2_large_checks():
    """K2's large variant (33 <= n <= 128) against its plain version on
    K2_LARGE_ROWS, bit for bit up to signed zeros, and timed beside
    torch.linalg.inv, its bound and its exact-arithmetic floor.  Returns
    the (65,536, 40, 40) float64 row."""
    from firedrake_tpu_torch.ops import batched_inverse as BI
    rows = []
    for nb, n, dt, pivot in K2_LARGE_ROWS:
        A = _needs_pivots(nb, n, n, dt) if pivot else _spd(nb, n, n, dt)
        mode = "pivoted " if pivot else ""
        err = _k2_compare(BI, f"large {mode}n={n}", A, pivot)
        exact = torch.equal(BI.batched_inv(A, pivot) + 0.0,
                            BI.batched_inv_plain(A, pivot) + 0.0)
        plan = dict(BI.large_report)
        print(f"  bit for bit with the plain version: {exact}; plan {plan}")
        if not exact:
            raise AssertionError(f"K2 large {mode}n={n}: not bit for bit")
        tm = _pair_ms(lambda: BI.batched_inv(A, pivot),
                      lambda: BI.batched_inv_plain(A, pivot),
                      reps=5, plain_reps=2)
        runs = tm.pop("runs")
        lib1 = _cuda_ms(lambda: torch.linalg.inv(A), 3, 1)
        lib2 = _cuda_ms(lambda: torch.linalg.inv(A), 3, 1)
        bytes_ms = 1e3 * 2 * A.numel() * A.element_size() / HBM_BYTES_PER_S
        ops_ms = 1e3 * 2 * n ** 3 * nb / PEAK_FLOPS
        row = dict(shape=[nb, n, n], dtype=str(dt)[6:], pivot=pivot, **tm,
                   library_ms=(lib1 + lib2) / 2,
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   floor_ms=_floor_ms(nb, n, dt), max_abs_err=err,
                   plan=plan)
        rows.append(row)
        print(f"  time K2 large {mode}device {tm['ms']:.4f} ms  call "
              f"{tm['call_ms']:.4f} ms  plain {tm['plain_ms']:.4f} ms  "
              f"torch.linalg.inv {row['library_ms']:.4f} ms  bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})  share "
              f"{row['bound_ms'] / tm['ms']:.3f}  floor "
              f"{row['floor_ms']:.4f} ms (unfused) share "
              f"{row['floor_ms'] / tm['ms']:.3f} (runs device/device/"
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
    k2_huge_checks()
    phase_done("kernels", t0)
    return k1, k2, k2_large


def _needs_pivots(nb, n, seed, dtype):
    """Random blocks with a zero leading diagonal entry."""
    A = np.random.default_rng(seed).standard_normal((nb, n, n))
    A[:, 0, 0] = 0.0
    return torch.as_tensor(A, dtype=dtype, device="cuda")


def huge_gate(A, X, plain, lib):
    """The huge variant's gate (its blocked products sum in another
    order, so it is not bit for bit with the plain version).  Distance:
    max|X - X_ref| at most 4 max|X_lib - X_ref|, or n eps max|X_ref|
    where that is larger, X_lib = torch.linalg.inv of the same blocks;
    X_ref is the plain version in float64 and, in float32, the float64
    inverse of the same blocks (there the plain version itself can lie
    farther from it than the kernel does, on pivoted random blocks).
    Residual: max|A X - I| at most 4 times the larger of the library's
    and the plain version's (Gauss-Jordan's residual is not bounded as an
    LU inverse's: on bddc_p1_1024's M_int blocks the plain version's is
    ~10 times the library's, as this gate prints)."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    ref = plain if A.dtype == torch.float64 else torch.linalg.inv(A.double())
    g = dict(ref="plain" if A.dtype == torch.float64 else "f64 inverse",
             dist=float((X - ref).abs().max()),
             plain_dist=float((X - plain).abs().max()),
             lib_dist=float((lib - ref).abs().max()),
             res=float((A @ X - eye).abs().max()),
             lib_res=float((A @ lib - eye).abs().max()),
             plain_res=float((A @ plain - eye).abs().max()))
    g["limit"] = max(4 * g["lib_dist"], n * torch.finfo(A.dtype).eps
                     * float(ref.abs().max()))
    g["ok"] = (g["dist"] <= g["limit"]
               and g["res"] <= 4 * max(g["lib_res"], g["plain_res"]))
    return g


def _gate_text(g):
    # in float32 the distance to the plain version too, beside the gated one
    plain = ("" if g["ref"] == "plain" else
             f"; max|X - X_plain| {g['plain_dist']:.3e}")
    return (f"max|X - X_ref| {g['dist']:.3e} (X_ref {g['ref']}; library "
            f"{g['lib_dist']:.3e}, limit {g['limit']:.3e}{plain}) "
            f"max|A X - I| {g['res']:.3e} (library {g['lib_res']:.3e}, plain "
            f"{g['plain_res']:.3e}) {'ok' if g['ok'] else 'FAIL'}")


def k2_huge_checks():
    """K2's huge variant (n > 128) on random SPD batches and the pivoted
    mode of each variant on blocks that need pivots, one counted launch
    per call: the warp and large variants bit for bit with the plain
    versions up to signed zeros, the huge variant by huge_gate.  (The
    huge variant is timed on bddc_p1_1024's own blocks, in the ddm
    phase.)"""
    from firedrake_tpu_torch.ops import batched_inverse as BI
    for dt in (torch.float64, torch.float32):
        for n, nb in ((129, 8), (256, 4), (513, 2)):
            A = _spd(nb, n, n, dt)
            h0 = BI.huge_launches
            g = huge_gate(A, BI.batched_inv(A), BI.batched_inv_plain(A),
                          torch.linalg.inv(A))
            print(f"K2 huge random SPD n={n:<4d} {str(dt)[6:]:8s} shape "
                  f"{tuple(A.shape)} launches {BI.huge_launches - h0} "
                  + _gate_text(g))
            if not g["ok"] or BI.huge_launches - h0 != 1:
                raise AssertionError(f"K2 huge n={n}: disagrees")
        for n in (7, 65, 300):
            A = _needs_pivots(6, n, 1000 + n, dt)
            p0 = BI.pivot_launches
            out = BI.batched_inv(A, pivot=True) + 0.0
            ref = BI.batched_inv_plain(A, pivot=True) + 0.0
            unpiv = bool(torch.isfinite(BI.batched_inv_plain(A)).all())
            if BI.variant(n) == "huge":
                g = huge_gate(A, out, ref, torch.linalg.inv(A))
                ok, how = g["ok"], _gate_text(g)
            else:
                ok = torch.equal(out, ref)
                how = f"bit for bit with the pivoted plain version {ok}"
            print(f"K2 pivoted n={n:<4d} {str(dt)[6:]:8s} ({BI.variant(n)} "
                  f"variant) zero leading pivot: {how}; unpivoted finite "
                  f"{unpiv}; launches {BI.pivot_launches - p0}")
            if not ok or BI.pivot_launches - p0 != 1:
                raise AssertionError(f"K2 pivoted n={n}: disagrees")


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
        self.k2_huge = self.k2_pivot = 0
        self.k1_by_variant = dict(ref=0, quad=0, act=0)

    def __enter__(self):
        from firedrake_tpu_torch.compiler import cell_eval as K
        from firedrake_tpu_torch.ops import batched_inverse as BI
        self.K, self.BI = K, BI
        K.kernel_launches = K.lowerer_evals = 0
        K.launches_by_mode[:] = [0, 0, 0]
        BI.kernel_launches = BI.large_launches = 0
        BI.huge_launches = BI.pivot_launches = 0
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        K = self.K
        self.k1 += K.kernel_launches
        self.k2 += self.BI.kernel_launches
        self.k2_large += self.BI.large_launches
        self.k2_huge += self.BI.huge_launches
        self.k2_pivot += self.BI.pivot_launches
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
    function (or class attribute, or dict entry) is wrapped, synchronised
    on both sides;
    `secs` sums each stage, `calls` lists its calls' seconds and
    `results` their return values, in order, over every block the object
    is entered for.  The default stages are the GMG set-up's."""

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
        self.results = {name: [] for name, _, _ in self.stages}

    def __enter__(self):
        import importlib
        self.saved = []
        # every module first: one that imports a name from another at its
        # own import would otherwise bind a wrapper, and keep it
        mods = {mod: importlib.import_module(mod)
                for _, mod, _ in self.stages}
        for name, mod, path in self.stages:
            owner = mods[mod]
            *outer, attr = path.split(".")
            for o in outer:
                owner = getattr(owner, o)
            fn = owner[attr] if isinstance(owner, dict) else \
                getattr(owner, attr)
            self.saved.append((owner, attr, fn))
            _put(owner, attr, self._timed(name, fn))
        return self

    def _timed(self, name, fn):
        def run(*a, **kw):
            out, s = _sync_time(lambda: fn(*a, **kw))
            self.secs[name] += s
            self.calls[name].append(s)
            self.results[name].append(out)
            return out
        return run

    def __exit__(self, *exc):
        for owner, attr, fn in self.saved:
            _put(owner, attr, fn)


def _put(owner, attr, value):
    """Bind `value` as `attr` of a module, class or dict."""
    if isinstance(owner, dict):
        owner[attr] = value
    else:
        setattr(owner, attr, value)


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
    return _neumann_on(fd, fd.UnitDiskMesh(level))


def _neumann_on(fd, mesh):
    """The Neumann Helmholtz problem of _neumann_problem on `mesh`."""
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
    labels = labels or list(GATHER) + ["newton_p1_1m", "krylov_p1_1m",
                                       "poisson_mixed_rt1_256"] \
        + list(SLATE_LABELS) + list(EXTRUDED_STUDY) \
        + ["stokes_th_schur_256"] + list(ML_STUDY) + ["eigen_p1_512",
                                                       "gmsh_helmholtz_p1_1024"] \
        + list(TRANSFER_STUDY)
    transfer_cpu(labels, "cpu_study", study=True)
    meshio_cpu(labels, "cpu_study", study=True)
    multilevel_cpu([lb for lb in ML_STUDY if lb in labels], "cpu_study",
                   study=True)
    ddm_cpu(labels, "cpu_study", study=True)
    if "poisson_mixed_rt1_256" in labels:
        mixed_cpu_study()
    fieldsplit_cpu([lb for lb in labels if lb == "stokes_th_schur_256"],
                   "cpu_study", study=True)
    extruded_cpu([lb for lb in EXTRUDED_STUDY if lb in labels],
                 "cpu_study", study=True)
    slate_cpu([lb for lb in SLATE_LABELS if lb in labels], "cpu_study",
              SLATE_STUDY)
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
    labels = labels or list(GMG) + list(GATHER) + list(NONLINEAR_LABELS) \
        + ["dg_advection_512"] + list(SLATE_LABELS) + list(EXTRUDED_LABELS) \
        + list(FIELDSPLIT_LABELS) + list(MULTILEVEL_LABELS) \
        + ["deflation_bratu_p1_1024", "gmsh_helmholtz_p1_1024"] \
        + [lb for lb in TRANSFER_LABELS if lb != "supermesh_p1_512_384"]
    transfer_cpu(labels, "cpu_rehearsal")
    meshio_cpu(labels, "cpu_rehearsal")
    multilevel_cpu([lb for lb in labels if lb in MULTILEVEL_LABELS],
                   "cpu_rehearsal")
    ddm_cpu(labels, "cpu_rehearsal")
    nonlinear_cpu([lb for lb in labels if lb in NONLINEAR_LABELS])
    fieldsplit_cpu([lb for lb in labels if lb in FIELDSPLIT_LABELS],
                   "cpu_rehearsal")
    slate_cpu([lb for lb in labels if lb in SLATE_LABELS], "cpu_rehearsal")
    extruded_cpu([lb for lb in labels if lb in EXTRUDED_LABELS],
                 "cpu_rehearsal")
    fd.set_device("cpu")
    for label in labels:
        if label in NONLINEAR_LABELS or label in SLATE_LABELS \
                or label in EXTRUDED_LABELS or label in FIELDSPLIT_LABELS \
                or label in MULTILEVEL_LABELS or label in TRANSFER_LABELS \
                or label in ("deflation_bratu_p1_1024",
                             "gmsh_helmholtz_p1_1024"):
            continue
        if label == "dg_advection_512":
            t0 = time.perf_counter()
            its, q, dmass = dg_cpu(fd, DG_N)
            print(f"cpu_rehearsal {label}: dofs {q.numel()} cg_iterations "
                  f"{its} q in [{float(q.min())!r}, {float(q.max())!r}] "
                  f"|dmass| {abs(dmass):.3e} seconds "
                  f"{time.perf_counter() - t0:.1f} host_max_rss_gib "
                  f"{_max_rss_gib():.2f}", flush=True)
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


# ------------------------------------------- DG advection and mixed Poisson
# dg_advection_512: demos/DG_advection.py at UnitSquareMesh(512) (DG1,
# 1,572,864 dofs; 785,408 interior and 2,048 exterior facets), SSPRK3 with
# the limiter after every stage, dt = 0.2/512, DG_STEPS steps.
DG_N, DG_STEPS = 512, 4
DG_SP = {"ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": 1e-11}
# poisson_mixed_rt1_256: demos/poisson_mixed.py at UnitSquareMesh(256), RT1
# x DG0 (197,120 + 131,072 dofs), preonly + lu.  Bounds on the L2 errors
# of u_h and sigma_h: twice the errors extrapolated from the last level of
# the CPU study (python3 chip_smoke.py --cpu-study poisson_mixed_rt1_256:
# at n = 16, 32, 64 u 3.269008e-2, 1.635810e-2, 8.180686e-3 and sigma
# 1.258816e-1, 6.295296e-2, 3.147800e-2, ratios 1.9996 and 1.9999 at the
# last level) to n = 256 at the last ratio.
MIXED_N, MIXED_STUDY = 256, (16, 32, 64)
MIXED_ERR = dict(u=4.092e-3, sigma=1.574e-2)
LU = {"ksp_type": "preonly", "pc_type": "lu"}


def _dg_problem(fd, n):
    """The demo's problem: the step 1 on 0.2 <= x <= 0.4 advected by
    (1, 0), upwind fluxes on dS and ds."""
    mesh = fd.UnitSquareMesh(n, n)
    V = fd.FunctionSpace(mesh, "DG", 1)
    X = fd.SpatialCoordinate(mesh)
    vel = fd.as_vector([1.0 + 0 * X[0], 0.0 * X[1]])
    q = fd.Function(V, name="q").interpolate(
        fd.conditional(fd.ge(X[0], 0.2), 1.0, 0.0)
        * fd.conditional(fd.ge(0.4, X[0]), 1.0, 0.0))
    nrm = fd.FacetNormal(mesh)
    un = 0.5 * (fd.dot(vel, nrm) + abs(fd.dot(vel, nrm)))
    p, qt = fd.TestFunction(V), fd.TrialFunction(V)
    L = (0.2 / n) * (fd.inner(q * vel, fd.grad(p)) * fd.dx
                     - fd.inner(fd.jump(p), fd.jump(un * q)) * fd.dS
                     - fd.inner(p, un * q) * fd.ds)
    return dict(mesh=mesh, V=V, q=q, a=fd.inner(qt, p) * fd.dx, L=L,
                dq=fd.Function(V), limiter=fd.VertexBasedLimiter(V))


def _dg_stages(fd, p, steps, around=None, after=None):
    """The demo's SSPRK3 loop, each stage one solve of the DG1 mass system
    and the limiter: `around(k, what)` is the context of stage k's solve
    ("solve") and limiter ("limiter"); `after(k)` runs after stage k,
    outside both."""
    q, dq, lim = p["q"], p["dq"], p["limiter"]
    around = around or (lambda k, what: contextlib.nullcontext())
    combine = (lambda qs, q, dq: q + dq,
               lambda qs, q, dq: 0.75 * qs + 0.25 * (q + dq),
               lambda qs, q, dq: (qs + 2.0 * (q + dq)) / 3.0)
    its = []
    for step in range(steps):
        qs = q.dat.clone()
        for s in range(3):
            k = 3 * step + s
            with around(k, "solve"):
                solver = fd.LinearVariationalSolver(
                    fd.LinearVariationalProblem(p["a"], p["L"], dq),
                    solver_parameters=DG_SP)
                solver.solve()
                q.dat = combine[s](qs, q.dat, dq.dat)
            with around(k, "limiter"):
                lim.apply(q)
            its.append(solver.ksp_iterations)
            if not solver.converged:
                raise AssertionError(f"dg_advection: stage {k} did not "
                                     "converge")
            if after is not None:
                after(k)
    return its


class _DGTimes:
    """CUDA events per stage: the RHS assembly (rank 1), with its cell
    integral (the torch lowerer) and its facet integrals (the vmapped
    facet kernels) apart; the mass matrix assembly (K1); the CG solve;
    the limiter.  Only the blocks opened by `stage` are timed."""

    KEYS = ("rhs", "rhs_cell", "rhs_facet", "mass", "cg", "limiter")

    def __init__(self):
        self.stages = []
        self.open = False

    def _events(self, key, fn):
        if not self.open:
            return fn()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn()
        e.record()
        self.stages[-1][key].append((s, e))
        return out

    def __enter__(self):
        import firedrake_tpu_torch.solving as S
        from firedrake_tpu_torch.assemble import FormAssembler as FA
        self.S, self.FA = S, FA
        self.orig = run0, lv0, ksp0 = FA._run, FA._local_values, S._run_ksp

        def run(asm, *a, **kw):
            return self._events("rhs" if asm.rank == 1 else "mass",
                                lambda: run0(asm, *a, **kw))

        def local_values(asm, ci, *a, **kw):
            if asm.rank != 1:
                return lv0(asm, ci, *a, **kw)
            return self._events(
                "rhs_cell" if ci.integral_type == "cell" else "rhs_facet",
                lambda: lv0(asm, ci, *a, **kw))

        def run_ksp(*a, **kw):
            return self._events("cg", lambda: ksp0(*a, **kw))

        FA._run, FA._local_values, S._run_ksp = run, local_values, run_ksp
        return self

    @contextlib.contextmanager
    def stage(self, k, what):
        """Stage k's solve ("solve", which opens the stage's record) or
        its limiter ("limiter", timed as a whole)."""
        if what == "solve":
            self.stages.append({key: [] for key in self.KEYS})
        self.open = what == "solve"
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        try:
            yield
        finally:
            e.record()
            self.open = False
            if what == "limiter":
                self.stages[-1]["limiter"].append((s, e))

    def __exit__(self, *exc):
        self.FA._run, self.FA._local_values, self.S._run_ksp = self.orig
        torch.cuda.synchronize()
        self.ms = [{key: sum(s.elapsed_time(e) for s, e in st[key])
                    for key in self.KEYS} for st in self.stages]


def dg_advection_run(fd):
    """dg_advection_512 on the card: per stage the RHS assembly split into
    the lowerer's cell integral and the facet kernels, the mass matrix
    (K1), CG + Jacobi and the limiter; then one VTKFile write of q, the
    gates (mass, bounds after every stage) and q against the port's own
    CPU rehearsal at the same size, run in this process."""
    import os
    import shutil
    from firedrake_tpu_torch.assemble import get_assembler
    label = "dg_advection_512"
    torch.cuda.reset_peak_memory_stats()
    p, setup_s = _sync_time(lambda: _dg_problem(fd, DG_N))
    mesh = p["mesh"]
    mass0 = fd.assemble(p["q"] * fd.dx)
    counts, times, wall, bounds = _Counts(), _DGTimes(), [], []

    @contextlib.contextmanager
    def around(k, what):
        with counts, times.stage(k, what):
            torch.cuda.synchronize()
            t = time.perf_counter()
            yield
            torch.cuda.synchronize()
            wall.append((k, what, time.perf_counter() - t))

    def after(k):
        bounds.append((float(p["q"].dat.min()), float(p["q"].dat.max())))

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with times:
            its = _dg_stages(fd, p, DG_STEPS, around, after)
    peak = torch.cuda.max_memory_allocated()
    stage_s = {}
    for k, what, s in wall:
        stage_s[k] = stage_s.get(k, 0.0) + s
    for k, ms in enumerate(times.ms):
        other = ms["rhs"] - ms["rhs_cell"] - ms["rhs_facet"]
        first = " (first: assembler builds)" if k == 0 else ""
        print(f"{label} stage {k}{first}: wall_s {stage_s[k]:.4f} rhs_ms {ms['rhs']:.3f} "
              f"(lowerer cell {ms['rhs_cell']:.3f} facet kernels "
              f"{ms['rhs_facet']:.3f} gathers+accumulation {other:.3f}) "
              f"mass_k1_ms {ms['mass']:.3f} cg_iterations {its[k]} cg_ms "
              f"{ms['cg']:.3f} limiter_ms {ms['limiter']:.3f} q in "
              f"[{bounds[k][0]!r}, {bounds[k][1]!r}]")
    rest = times.ms[1:]
    mean = {key: sum(m[key] for m in rest) / len(rest) for key in
            _DGTimes.KEYS}
    print(f"{label}: stages 1-{len(rest)} mean rhs_ms {mean['rhs']:.3f} "
          f"(lowerer cell {mean['rhs_cell']:.3f} facet kernels "
          f"{mean['rhs_facet']:.3f}) mass_k1_ms {mean['mass']:.3f} cg_ms "
          f"{mean['cg']:.3f} limiter_ms {mean['limiter']:.3f} wall_s "
          f"{sum(stage_s[k] for k in range(1, len(stage_s))) / len(rest):.4f}")
    mass = fd.assemble(p["q"] * fd.dx)
    # one VTK write of q, outside every timed block, into the build
    # directory of the checkout (removed after its size is read)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "firedrake_tpu_torch", "_build", "vtk_" + label)
    vtk = fd.VTKFile(os.path.join(out_dir, "q.pvd"))
    _, vtk_s = _sync_time(lambda: vtk.write(p["q"]))
    vtk_bytes = os.path.getsize(os.path.join(out_dir, "q_0.vtu"))
    shutil.rmtree(out_dir)
    q_card = p["q"].dat.cpu()
    print(f"{label}: dofs {p['V'].dim} cells {mesh.num_cells} interior "
          f"facets {len(mesh.topology.interior_facets)} setup_s "
          f"{setup_s:.3f} mass0 {mass0!r} mass {mass!r} |dmass| "
          f"{abs(mass - mass0):.3e} cg_iterations {its} k1_launches "
          f"{counts.k1} k1_by_variant {counts.k1_by_variant} "
          f"lowerer_evals {counts.lowerer} device_peak {peak} vtk_write_s "
          f"{vtk_s:.3f} vtk_bytes {vtk_bytes}")
    _route_k1_checks(get_assembler(p["a"]), label)
    del p
    _release(label)
    # the port's own CPU rehearsal at the same size
    fd.set_device("cpu")
    try:
        (cpu_its, q_cpu, _), cpu_s = _sync_time(lambda: dg_cpu(fd, DG_N))
    finally:
        fd.set_device(torch.device("cuda"))
    diff = float((q_card - q_cpu).abs().max())
    print(f"{label}: max|q_card - q_cpu| {diff:.3e} (CPU rehearsal "
          f"{cpu_s:.1f} s, cg_iterations {cpu_its})")
    if not q_card.numel() == 3 * mesh.num_cells:
        raise AssertionError(f"{label}: wrong size")
    if not abs(mass - mass0) <= 1e-10:
        raise AssertionError(f"{label}: mass {mass0} -> {mass}")
    if not all(-1e-8 <= lo and hi <= 1 + 1e-8 for lo, hi in bounds):
        raise AssertionError(f"{label}: q left [0, 1]: {bounds}")
    if not diff <= 1e-10:
        raise AssertionError(f"{label}: card and CPU differ by {diff}")
    if counts.k1 <= 0 or counts.k1_by_variant["ref"] != counts.k1 \
            or counts.lowerer <= 0:
        raise AssertionError(f"{label}: K1 (mass) or the lowerer (RHS) "
                             "did not run")
    return counts


def dg_cpu(fd, n):
    """The DG stages on the set device without timing: (CG iterations per
    stage, q on the host, the mass change)."""
    p = _dg_problem(fd, n)
    mass0 = fd.assemble(p["q"] * fd.dx)
    its = _dg_stages(fd, p, DG_STEPS)
    return its, p["q"].dat.cpu(), fd.assemble(p["q"] * fd.dx) - mass0


def _mixed_problem(fd, n):
    """demos/poisson_mixed.py at UnitSquareMesh(n): sigma = grad u, div
    sigma = -f, u = sin(pi x) sin(pi y)."""
    mesh = fd.UnitSquareMesh(n, n)
    W = fd.FunctionSpace(mesh, "RT", 1) * fd.FunctionSpace(mesh, "DG", 0)
    sigma, u = fd.TrialFunctions(W)
    tau, v = fd.TestFunctions(W)
    X = fd.SpatialCoordinate(mesh)
    f = fd.Function(W.subspaces[1]).interpolate(
        2 * fd.pi ** 2 * fd.sin(fd.pi * X[0]) * fd.sin(fd.pi * X[1]))
    a = (fd.dot(sigma, tau) + fd.div(tau) * u + fd.div(sigma) * v) * fd.dx
    u_ex = fd.sin(fd.pi * X[0]) * fd.sin(fd.pi * X[1])
    s_ex = fd.as_vector([fd.pi * fd.cos(fd.pi * X[0]) * fd.sin(fd.pi * X[1]),
                         fd.pi * fd.sin(fd.pi * X[0]) * fd.cos(fd.pi * X[1])])
    return dict(W=W, a=a, L=-fd.inner(f, v) * fd.dx, w=fd.Function(W),
                u_ex=u_ex, s_ex=s_ex)


def _mixed_errors(fd, p):
    sigma_h, u_h = p["w"].subfunctions
    return fd.errornorm(p["u_ex"], u_h), fd.errornorm(p["s_ex"], sigma_h)


def mixed_run(fd):
    """poisson_mixed_rt1_256 on the card: the four-block assembly (three
    blocks, all in the lowerer, RT1's dof signs applied on the card) cold
    and warm, the host LU of the BlockMatrix timed apart, the BlockMatrix
    matvec beside its byte bound, and the L2 errors of u_h and sigma_h
    against the bounds of the CPU study."""
    import firedrake_tpu_torch.solving as S
    label = "poisson_mixed_rt1_256"
    torch.cuda.reset_peak_memory_stats()
    p, setup_s = _sync_time(lambda: _mixed_problem(fd, MIXED_N))
    lu_s = []
    direct = S.direct_solve

    def timed_lu(A, b):
        x, s = _sync_time(lambda: direct(A, b))
        lu_s.append(s)
        return x

    with _Counts() as counts:
        A, cold_s = _sync_time(lambda: fd.assemble(p["a"]))
        warm_ms = _cuda_ms(lambda: fd.assemble(p["a"]), reps=3, warm=1)
        _, rhs_s = _sync_time(lambda: fd.assemble(p["L"]))
        S.direct_solve = timed_lu
        try:
            _, solve_s = _sync_time(lambda: fd.solve(p["a"] == p["L"], p["w"],
                                                     solver_parameters=LU))
        finally:
            S.direct_solve = direct
    peak = torch.cuda.max_memory_allocated()
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(A.shape[1]),
                        device=fd.get_device())
    y = A.matvec(x)
    ref = A.to_scipy() @ x.cpu().numpy()
    mv_err = float(np.abs(y.cpu().numpy() - ref).max())
    mv_ms = _cuda_ms(lambda: A.matvec(x), reps=50, warm=5)
    nnz = sum(B.nnz for B in A.blocks.values())
    nbytes = nnz * (8 + 4) + sum((B.shape[0] + 1) * 8
                                 for B in A.blocks.values()) \
        + (A.shape[0] + A.shape[1]) * 8
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    eu, es = _mixed_errors(fd, p)
    W = p["W"]
    print(f"{label}: dofs {W.subspaces[0].dim} + {W.subspaces[1].dim} = "
          f"{W.dim} blocks {sorted(A.blocks)} nnz {nnz} setup_s "
          f"{setup_s:.3f} assembly_cold_s {cold_s:.3f} assembly_warm_ms "
          f"{warm_ms:.3f} rhs_s {rhs_s:.4f} solve_s {solve_s:.3f} (host "
          f"splu {' '.join(f'{s:.3f}' for s in lu_s)} s) device_peak "
          f"{peak} k1_launches {counts.k1} lowerer_evals {counts.lowerer}")
    print(f"  BlockMatrix matvec (call time of 50) {mv_ms:.4f} ms bound "
          f"{bound_ms:.4f} ms ({nbytes} bytes) max|Ax - A_host x| "
          f"{mv_err:.3e}; L2 errors u_h {eu:.4e} (bound {MIXED_ERR['u']}) "
          f"sigma_h {es:.4e} (bound {MIXED_ERR['sigma']})")
    if not p["w"].dat.is_cuda:
        raise AssertionError(f"{label}: solution is not on the card")
    if not mv_err <= F64_TOL * float(np.abs(ref).max()):
        raise AssertionError(f"{label}: BlockMatrix matvec disagrees")
    if not (eu < MIXED_ERR["u"] and es < MIXED_ERR["sigma"]):
        raise AssertionError(f"{label}: errors {eu}, {es} above bounds")
    if counts.k1 or counts.lowerer <= 0 or len(lu_s) != 1:
        raise AssertionError(f"{label}: K1 ran ({counts.k1}) on a form "
                             "outside its family, or the lowerer or the "
                             "LU did not run")
    del p, A
    _release(label)
    return counts, dict(ms=mv_ms, bound_ms=bound_ms, nnz=nnz)


def dg_mixed_phase():
    """dg_advection_512, then poisson_mixed_rt1_256."""
    t0 = phase("dg_mixed")
    import firedrake_tpu_torch as fd
    fd.set_device(torch.device("cuda"))
    used = {"dg_advection_512": dg_advection_run(fd)}
    used["poisson_mixed_rt1_256"], mv = mixed_run(fd)
    phase_done("dg_mixed", t0)
    return used, mv


def mixed_cpu_study():
    """poisson_mixed_rt1_256 on the CPU at the study's sizes: the L2
    errors of u_h and sigma_h and their ratios per level."""
    import firedrake_tpu_torch as fd
    fd.set_device("cpu")
    prev = None
    for n in MIXED_STUDY:
        t0 = time.perf_counter()
        p = _mixed_problem(fd, n)
        fd.solve(p["a"] == p["L"], p["w"], solver_parameters=LU)
        eu, es = _mixed_errors(fd, p)
        rates = ("" if prev is None else
                 f" u_ratio {prev[0] / eu:.4f} sigma_ratio "
                 f"{prev[1] / es:.4f}")
        print(f"cpu_study poisson_mixed_rt1_256 n {n}: dofs {p['W'].dim} "
              f"u_l2_err {eu:.6e} sigma_l2_err {es:.6e}{rates} seconds "
              f"{time.perf_counter() - t0:.1f}", flush=True)
        prev = (eu, es)


# ------------------------------------------------------------ the slate phase
# hybridized_rt2_256: demos/hybridized_poisson.py at UnitSquareMesh(256)
# (RT2 x DG1, 656,384 + 393,216 dofs; broken RT2 1,048,576 dofs, HDiv
# Trace 1 394,240), its own forms, solved twice: with the demo's preonly +
# lu trace solve (host splu), then with CG + Jacobi at rtol 1e-12 on the
# device.  scpc_p5_128: P5 Poisson on UnitSquareMesh(128), sin sin data,
# u = 0 on the boundary (410,881 dofs, 196,608 interior ones condensed),
# CG + Jacobi at rtol 1e-12 on the condensed system on the device.
HYB_N, SCPC_N, SCPC_DEG = 256, 128, 5
# scpc_p5_128 is held to the CPU in this process at 64^2 (a card solve
# and a CPU solve there): at 128^2 the CPU solve alone took 71.6 s and
# 126.6 s on two card hosts (my chip runs, PR 13), too much of the
# script's time limit
SCPC_CPU_N = 64
# the hybridized LU solve held to the CPU in this process at this size
HYB_CPU_N = 128
HYB_LU = {"ksp_type": "preonly", "pc_type": "hybridization",
          "hybridization": {"ksp_type": "preonly"}}
HYB_CG = {"ksp_type": "preonly", "pc_type": "hybridization",
          "hybridization": {"ksp_type": "cg", "pc_type": "jacobi",
                            "ksp_rtol": 1e-12}}
SCPC_SP = {"ksp_type": "preonly", "pc_type": "scpc",
           "condensed_field": {"ksp_type": "cg", "pc_type": "jacobi",
                               "ksp_rtol": 1e-12}}
SLATE_STUDY = {"hybridized_rt2_256": (16, 32, 64),
               "scpc_p5_128": (8, 16, 32)}
# Bounds.  Hybridized, the L2 error of u_h: twice the error extrapolated
# from the last level of the CPU study (python3 chip_smoke.py --cpu-study
# hybridized_rt2_256: 3.446788e-3, 8.638285e-4, 2.160906e-4 at n = 16,
# 32, 64, ratio 3.9975) to n = 256 at the last ratio, 1.3523e-5 (the CPU
# rehearsal's: 1.350827e-5).  SCPC, the nodal error: the study's
# 8.594386e-8, 1.388339e-9, 2.196397e-11 at n = 8, 16, 32 (ratio 63.21)
# extrapolate to 5.5e-15 at 128, below what CG at rtol 1e-12 resolves:
# the error stops at that solve's floor, 1.599720e-12 at n = 64 and
# 1.559863e-12 at 128 on the CPU, 6.35e-12 on the card at the same 1422
# iterations (other summation order).  The bound sits above the floor.
SLATE_ERR = {"hybridized_rt2_256": 2.7046e-5, "scpc_p5_128": 1e-11}
K2_PATH_RTOL = 1e-13


def _hybrid_problem(fd, n):
    """demos/hybridized_poisson.py at UnitSquareMesh(n), its own forms."""
    mesh = fd.UnitSquareMesh(n, n)
    W = fd.MixedFunctionSpace([fd.FunctionSpace(mesh, "RT", 2),
                               fd.FunctionSpace(mesh, "DG", 1)])
    sigma, u = fd.TrialFunctions(W)
    tau, v = fd.TestFunctions(W)
    X = fd.SpatialCoordinate(mesh)
    s = fd.sin(fd.pi * X[0]) * fd.sin(fd.pi * X[1])
    f = fd.Function(W.subspaces[1]).interpolate(2 * fd.pi ** 2 * s)
    a = (fd.dot(sigma, tau) - u * fd.div(tau) - fd.div(sigma) * v) * fd.dx
    return dict(W=W, a=a, L=-fd.inner(f, v) * fd.dx, u_ex=s)


def _hybrid_solve(fd, p, params):
    w = fd.Function(p["W"])
    solver = fd.LinearVariationalSolver(
        fd.LinearVariationalProblem(p["a"], p["L"], w),
        solver_parameters=params)
    solver.solve()
    return w, solver


def _scpc_problem(fd, n):
    """-lap u = 2 pi^2 sin(pi x) sin(pi y), u = 0 on the boundary, P5 on
    UnitSquareMesh(n), pc_type scpc (tests/regression/test_scpc.py)."""
    mesh = fd.UnitSquareMesh(n, n)
    V = fd.FunctionSpace(mesh, "CG", SCPC_DEG)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    X = fd.SpatialCoordinate(mesh)
    s = fd.sin(fd.pi * X[0]) * fd.sin(fd.pi * X[1])
    uh = fd.Function(V)
    solver = fd.LinearVariationalSolver(
        fd.LinearVariationalProblem(
            fd.inner(fd.grad(u), fd.grad(v)) * fd.dx,
            2 * fd.pi ** 2 * s * v * fd.dx, uh,
            bcs=fd.DirichletBC(V, 0.0, "on_boundary")),
        solver_parameters=SCPC_SP)
    return dict(V=V, uh=uh, solver=solver,
                exact=fd.Function(V).interpolate(s))


def _slate_error(fd, label, p):
    if label == "hybridized_rt2_256":
        return fd.errornorm(p["u_ex"], p["w"].subfunctions[1])
    return float((p["uh"].dat - p["exact"].dat).abs().max())


class _EventStages(_StageTimes):
    """CUDA-event times of named stages over the blocks it is entered for.
    Each named function is wrapped; calls nest, and a stage's exclusive
    time leaves out the wrapped calls made inside it.  A stage may wrap
    several functions.  The positional arguments of each stage's first
    call are kept in `first_args`; `keep` maps a stage to a test of the
    arguments, and then its first call that passes is kept."""

    def __init__(self, stages, keep=None):
        super().__init__(stages)
        self.top, self.stack, self.first_args = [], [], {}
        self.keep = keep or {}

    def _timed(self, name, fn):
        def run(*a, **kw):
            if name not in self.first_args and \
                    self.keep.get(name, lambda _: True)(a):
                self.first_args[name] = a
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            rec = [name, s, e, []]
            (self.stack[-1][3] if self.stack else self.top).append(rec)
            self.stack.append(rec)
            s.record()
            try:
                return fn(*a, **kw)
            finally:
                e.record()
                self.stack.pop()
        return run

    def ms(self):
        """{stage: [exclusive ms, inclusive ms, calls]}."""
        torch.cuda.synchronize()
        out = {name: [0.0, 0.0, 0] for name, _, _ in self.stages}

        def walk(recs):
            for name, s, e, kids in recs:
                incl = s.elapsed_time(e)
                kid = sum(ks.elapsed_time(ke) for _, ks, ke, _ in kids)
                out[name][0] += incl - kid
                out[name][1] += incl
                out[name][2] += 1
                walk(kids)
        walk(self.top)
        return out


_TP = "firedrake_tpu_torch."
SLATE_STAGES = {
    "hybridized_rt2_256": (
        ("local", _TP + "slate", "_local_form_tensor"),
        ("cell_kernels", _TP + "compiler.cell_eval", "run_cell_kernel"),
        ("k2", _TP + "ops.batched_inverse", "batched_inv"),
        ("contractions", _TP + "slate", "_eval_local_impl"),
        ("assembly", _TP + "slate", "assemble_slate"),
        ("assembly", _TP + "solvers.hybridization", "assemble_slate"),
        ("solve", _TP + "solving", "direct_solve"),
        ("solve", _TP + "solvers.krylov", "KSP_METHODS.cg"),
        ("back_substitution", _TP + "solvers.hybridization",
         "_back_substitute")),
    "scpc_p5_128": (
        ("local", _TP + "slate", "_local_form_tensor"),
        ("cell_kernels", _TP + "compiler.cell_eval", "run_cell_kernel"),
        ("k2", _TP + "ops.batched_inverse", "batched_inv"),
        ("contractions", _TP + "solvers.scpc", "_condense"),
        ("assembly", _TP + "solvers.scpc", "_assemble_condensed"),
        ("solve", _TP + "solvers.krylov", "KSP_METHODS.cg"),
        ("back_substitution", _TP + "solvers.scpc", "_back_substitute"))}


def _slate_stages(label):
    """The label's stages, keeping the arguments of the first cell
    integral that K1 evaluates (the path's own cell-last inputs)."""
    def in_family(args):
        from firedrake_tpu_torch.compiler import cell_eval as K
        return K.family_spec(args[0]) is not None
    return _EventStages(SLATE_STAGES[label], keep={"cell_kernels": in_family})


def _slate_k1_check(label, st, k1):
    """K1 against its plain version and the lowerer, in float64 and
    float32, on the inputs Slate gave it in the run `st` timed; `k1` is
    that run's count of K1 launches."""
    from firedrake_tpu_torch.compiler import cell_eval as K
    args = st.first_args.get("cell_kernels")
    if k1 and args is None:
        raise AssertionError(f"{label}: K1 launched outside Slate's cell "
                             "integrals")
    if args is not None:
        ci, ce, ws, cv = args[:4]
        _k1_compare(K, label, 0, K.family_spec(ci), ci, ce, ws, cv, False)


class _K1Inputs:
    """While entered, keeps the inputs of the first K1 launch of each cell
    integral that the assembler (or Slate) evaluates, cloned: the path's
    own cell-last arrays, its coefficients included; `launches` counts
    the K1 launches made inside those calls."""

    OWNERS = ("firedrake_tpu_torch.assemble",
              "firedrake_tpu_torch.compiler.cell_eval")

    def __enter__(self):
        import importlib
        from firedrake_tpu_torch.compiler import cell_eval as K
        self.kept, self.launches, self.saved = {}, 0, []
        for name in self.OWNERS:
            mod = importlib.import_module(name)
            fn = mod.run_cell_kernel
            self.saved.append((mod, fn))
            mod.run_cell_kernel = self._keeping(K, fn)
        return self

    def _keeping(self, K, fn):
        def run(ci, ce, ws, consts, **kw):
            if id(ci) not in self.kept and K.family_spec(ci) is not None:
                self.kept[id(ci)] = (ci, ce.clone(),
                                     tuple(w.clone() for w in ws),
                                     tuple(consts))
            before = K.kernel_launches
            out = fn(ci, ce, ws, consts, **kw)
            self.launches += K.kernel_launches - before
            return out
        return run

    def __exit__(self, *exc):
        for mod, fn in self.saved:
            mod.run_cell_kernel = fn

    def check(self, label, k1):
        """K1 against its plain version and the lowerer, in float64 and
        float32, on each kept form's inputs; `k1` is the run's count of
        K1 launches, all of which must have gone through the kept
        calls."""
        from firedrake_tpu_torch.compiler import cell_eval as K
        if self.launches != k1:
            raise AssertionError(f"{label}: {k1} K1 launches, "
                                 f"{self.launches} of them from cell "
                                 "integrals that were kept")
        for i, (ci, ce, ws, cv) in enumerate(self.kept.values()):
            _k1_compare(K, f"{label} form {i}", 0, K.family_spec(ci), ci,
                        ce, ws, cv, False)
        print(f"{label}: K1 held to its plain version on the inputs of "
              f"{len(self.kept)} forms ({k1} launches)")


def _stage_line(label, run, total_s, st):
    ms = st.ms()
    parts = " ".join(f"{k} {v[0]:.3f}" for k, v in ms.items())
    other = 1e3 * total_s - sum(v[0] for v in ms.values())
    print(f"{label} {run}: total_ms {1e3 * total_s:.3f} exclusive_ms "
          f"{parts} other {other:.3f}; back_substitution inclusive_ms "
          f"{ms['back_substitution'][1]:.3f}; calls "
          + " ".join(f"{k} {v[2]}" for k, v in ms.items()))
    return ms


def _k2_path_row(label, A):
    """K2 on a path's own blocks: held to its plain version (max |delta|
    <= K2_PATH_RTOL max|inv|) and timed as the kernels phase times it."""
    from firedrake_tpu_torch.ops import batched_inverse as BI
    A = A.contiguous()
    out, plain = BI.batched_inv(A), BI.batched_inv_plain(A)
    torch.cuda.synchronize()
    ref = float(plain.abs().max())
    err = float((out - plain).abs().max())
    bitwise = torch.equal(out + 0.0, plain + 0.0)
    tm = _pair_ms(lambda: BI.batched_inv(A), lambda: BI.batched_inv_plain(A),
                  reps=20, plain_reps=3)
    runs = tm.pop("runs")
    lib1 = _cuda_ms(lambda: torch.linalg.inv(A), 3, 1)
    lib2 = _cuda_ms(lambda: torch.linalg.inv(A), 3, 1)
    nb, n = A.shape[0], A.shape[-1]
    bytes_ms = 1e3 * 2 * A.numel() * A.element_size() / HBM_BYTES_PER_S
    ops_ms = 1e3 * 2 * n ** 3 * nb / PEAK_FLOPS
    row = dict(path=label, shape=list(A.shape), dtype=str(A.dtype)[6:],
               **tm, library_ms=(lib1 + lib2) / 2,
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               floor_ms=_floor_ms(nb, n, A.dtype), max_abs_err=err,
               max_abs_inv=ref, bit_for_bit=bitwise)
    print(f"K2 on {label}'s blocks {tuple(A.shape)}: err_vs_plain "
          f"{err:.3e} max|inv| {ref:.3e} tol {K2_PATH_RTOL * ref:.3e} "
          f"bit_for_bit {bitwise}; device {tm['ms']:.4f} ms call "
          f"{tm['call_ms']:.4f} ms plain {tm['plain_ms']:.4f} ms "
          f"torch.linalg.inv {row['library_ms']:.4f} ms bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}) share "
          f"{row['bound_ms'] / tm['ms']:.3f} floor {row['floor_ms']:.4f} ms "
          "(unfused) (runs device/device/call/call/plain/plain/lib/lib "
          + "/".join(f"{x:.4f}" for x in runs + (lib1, lib2)) + ")")
    if not err <= K2_PATH_RTOL * ref:
        raise AssertionError(f"K2 on {label}'s blocks disagrees with its "
                             "plain version")
    if BI.variant(n) == "large" and not bitwise:
        raise AssertionError(f"K2's large variant on {label}'s blocks is "
                             "not bit for bit with its plain version")
    return row


def hybridized_run(fd):
    """hybridized_rt2_256 on the card: the demo's preonly + lu solve, then
    CG + Jacobi on the trace system, each timed by stage with CUDA events;
    K2 held to its plain version on the path's own blocks; the LU solve
    at HYB_CPU_N^2 on the card held to the CPU in this process."""
    label = "hybridized_rt2_256"
    torch.cuda.reset_peak_memory_stats()
    p, setup_s = _sync_time(lambda: _hybrid_problem(fd, HYB_N))
    W = p["W"]
    counts = _Counts()
    runs = {}
    for run, params in (("first_solve_lu", HYB_LU),
                        ("second_solve_cg", HYB_CG)):
        with counts, _slate_stages(label) as st:
            k1, k2 = counts.k1, counts.k2
            (w, solver), secs = _sync_time(
                lambda: _hybrid_solve(fd, p, params))
        ms = _stage_line(label, run, secs, st)
        runs[run] = dict(w=w, solver=solver, secs=secs, ms=ms, st=st,
                         k1=counts.k1 - k1, k2=st.first_args["k2"][0])
        print(f"{label} {run}: iterations {solver.ksp_iterations} "
              f"converged {solver.converged} k1_launches {counts.k1 - k1} "
              f"k2_launches {counts.k2 - k2} (all runs so far: k1 "
              f"{counts.k1} lowerer_evals {counts.lowerer})")
    peak = torch.cuda.max_memory_allocated()
    lu, cg = runs["first_solve_lu"], runs["second_solve_cg"]
    p["w"] = lu["w"]
    err = _slate_error(fd, label, p)
    ref = float(lu["w"].dat.abs().max())
    cg_diff = float((cg["w"].dat - lu["w"].dat).abs().max()) / ref
    # the LU solve at HYB_CPU_N on the card and on the CPU, in this process
    w_small, _ = _hybrid_solve(fd, _hybrid_problem(fd, HYB_CPU_N), HYB_LU)
    fd.set_device("cpu")
    t0 = time.perf_counter()
    try:
        w_cpu, _ = _hybrid_solve(fd, _hybrid_problem(fd, HYB_CPU_N), HYB_LU)
    finally:
        fd.set_device(torch.device("cuda"))
    cpu_s = time.perf_counter() - t0
    cpu_diff = float((w_small.dat.cpu() - w_cpu.dat).abs().max()) / float(
        w_cpu.dat.abs().max())
    its, want = cg["solver"].ksp_iterations, CPU_REHEARSAL_ITS[label]
    print(f"{label}: dofs {W.subspaces[0].dim} + {W.subspaces[1].dim} = "
          f"{W.dim} setup_s {setup_s:.3f} first_solve_s {lu['secs']:.3f} "
          f"second_solve_s {cg['secs']:.3f} cg_iterations {its} (CPU "
          f"rehearsal {want}) l2_err_u {err:.4e} (bound "
          f"{SLATE_ERR[label]}) cg_vs_lu {cg_diff:.3e} card_vs_cpu at "
          f"{HYB_CPU_N}^2 {cpu_diff:.3e} (cpu solve_s {cpu_s:.1f}) "
          f"device_peak {peak} "
          f"k1_launches {counts.k1} k2_launches {counts.k2} lowerer_evals "
          f"{counts.lowerer}")
    if not lu["w"].dat.is_cuda:
        raise AssertionError(f"{label}: solution is not on the card")
    if not (cg["solver"].converged and abs(its - want) <= 0.01 * want):
        raise AssertionError(f"{label}: {its} CG iterations, the CPU "
                             f"rehearsal took {want}")
    if not err < SLATE_ERR[label]:
        raise AssertionError(f"{label}: L2 error {err}")
    if not (cg_diff <= 1e-8 and cpu_diff <= 1e-10):
        raise AssertionError(f"{label}: CG {cg_diff} from LU, card "
                             f"{cpu_diff} from the CPU")
    if counts.k2 <= 0 or counts.lowerer <= 0:
        raise AssertionError(f"{label}: K2 or the lowerer did not run")
    _slate_k1_check(label, lu["st"], lu["k1"])
    row = _k2_path_row(label, lu["k2"])
    del p, runs, lu, cg, w_cpu
    _release(label)
    return counts, row


def scpc_run(fd):
    """scpc_p5_128 on the card: condensation, CG + Jacobi on the condensed
    system and back-substitution, timed by stage with CUDA events; K2
    held to its plain version on the interior blocks; the same problem at
    SCPC_CPU_N solved on the card and on the CPU in this process."""
    label = "scpc_p5_128"
    torch.cuda.reset_peak_memory_stats()
    p, setup_s = _sync_time(lambda: _scpc_problem(fd, SCPC_N))
    with _Counts() as counts, _slate_stages(label) as st:
        _, secs = _sync_time(p["solver"].solve)
    _stage_line(label, "solve", secs, st)
    solver = p["solver"]
    its, want = solver.ksp_iterations, CPU_REHEARSAL_ITS[label]
    err = _slate_error(fd, label, p)
    V = p["V"]
    small = _scpc_problem(fd, SCPC_CPU_N)
    small["solver"].solve()
    fd.set_device("cpu")
    t0 = time.perf_counter()
    try:
        q = _scpc_problem(fd, SCPC_CPU_N)
        q["solver"].solve()
    finally:
        fd.set_device(torch.device("cuda"))
    cpu_s = time.perf_counter() - t0
    cpu_its = q["solver"].ksp_iterations
    cpu_diff = float((small["uh"].dat.cpu() - q["uh"].dat).abs().max()) \
        / float(q["uh"].dat.abs().max())
    print(f"{label}: dofs {V.dim} setup_s {setup_s:.3f} solve_s "
          f"{secs:.3f} cg_iterations {its} (CPU rehearsal {want}; at "
          f"{SCPC_CPU_N}^2 the card {small['solver'].ksp_iterations} and "
          f"this process's CPU solve {cpu_its}) converged {solver.converged} "
          f"max_nodal_err {err:.4e} (bound {SLATE_ERR[label]}) card_vs_cpu "
          f"{cpu_diff:.3e} (cpu solve_s {cpu_s:.1f}) device_peak "
          f"{torch.cuda.max_memory_allocated()} k1_launches {counts.k1} "
          f"k2_launches {counts.k2} lowerer_evals {counts.lowerer}")
    if not p["uh"].dat.is_cuda:
        raise AssertionError(f"{label}: solution is not on the card")
    if not (solver.converged and abs(its - want) <= 0.01 * want):
        raise AssertionError(f"{label}: {its} CG iterations, the CPU "
                             f"rehearsal took {want}")
    if not err < SLATE_ERR[label]:
        raise AssertionError(f"{label}: nodal error {err}")
    if not cpu_diff <= 1e-10:
        raise AssertionError(f"{label}: card {cpu_diff} from the CPU at "
                             f"{SCPC_CPU_N}^2")
    if counts.k2 <= 0:
        raise AssertionError(f"{label}: K2 did not run")
    _slate_k1_check(label, st, counts.k1)
    row = _k2_path_row(label, st.first_args["k2"][0])
    del p, q, small, st
    _release(label)
    return counts, row


def slate_phase():
    """hybridized_rt2_256, then scpc_p5_128."""
    t0 = phase("slate")
    import firedrake_tpu_torch as fd
    fd.set_device(torch.device("cuda"))
    used, rows = {}, {}
    for label, run in (("hybridized_rt2_256", hybridized_run),
                       ("scpc_p5_128", scpc_run)):
        used[label], rows[label] = run(fd)
    phase_done("slate", t0)
    return used, rows


def slate_cpu(labels, tag, sizes=None):
    """The slate phase's cases on the CPU: at the card's size (the CG
    iterations the card must match) or, with `sizes`, at each of them
    with the error ratios per level."""
    import firedrake_tpu_torch as fd
    fd.set_device("cpu")
    for label in labels:
        prev = None
        full = HYB_N if label == "hybridized_rt2_256" else SCPC_N
        for n in (sizes or {}).get(label, (full,)):
            t0 = time.perf_counter()
            if label == "hybridized_rt2_256":
                p = _hybrid_problem(fd, n)
                p["w"], solver = _hybrid_solve(fd, p, HYB_CG)
                dofs = p["W"].dim
            else:
                p = _scpc_problem(fd, n)
                solver = p["solver"]
                solver.solve()
                dofs = p["V"].dim
            err = _slate_error(fd, label, p)
            rate = "" if prev is None else f" ratio {prev / err:.4f}"
            print(f"{tag} {label} n {n}: dofs {dofs} cg_iterations "
                  f"{solver.ksp_iterations} converged {solver.converged} "
                  f"err {err:.6e}{rate} seconds "
                  f"{time.perf_counter() - t0:.1f} host_max_rss_gib "
                  f"{_max_rss_gib():.2f}", flush=True)
            prev = err


SLATE_LABELS = ("hybridized_rt2_256", "scpc_p5_128")


# ---------------------------------------------------- extruded meshes, Q_k
# shallow_water_ext_128: demos/extruded_shallow_water.py on
# UnitSquareMesh(SW_N) extruded to SW_LAYERS layers (524,288 prisms; W =
# HDiv(BDM1 x DG0), 1,581,056 dofs; X = DG0, 524,288), the demo's Courant
# number dt/h = 0.1 (dt = 7.8125e-4), SW_STEPS Strang steps (three CG
# solves each), then the P1 x P1 projection.  SW_SMALL is the Firedrake
# demo's size (base 2^5, 4 layers), run on the card and on the CPU in
# this process.
SW_N, SW_LAYERS, SW_STEPS = 128, 16, 8
SW_SMALL = (32, 4)
SW_SP = {"ksp_type": "cg", "ksp_rtol": 1e-11}
# gmg_ext_hex_1m: -lap u = f, u = x(1-x) y(1-y) z(1-z)
# (tests/extrusion/test_extruded_hierarchy.py), Q1 on
# ExtrudedMeshHierarchy(MeshHierarchy(UnitSquareMesh(16, 16,
# quadrilateral=True), EXT_LEVELS), height=1, base_layer=8): 1,048,576
# hexes and 1,081,665 dofs on the finest level, every level a
# ColumnMatrix; CG + GMG with the default smoother (Chebyshev(2) +
# Jacobi), as gmg_p1_1m.
EXT_N0, EXT_LEVELS, EXT_LAYER0 = 16, 3, 8
EXT_SP = {"ksp_type": "cg", "ksp_rtol": 1e-10, "pc_type": "mg"}
# spectral_q4_periodic_256: -lap u + u = f, u = sin(2 pi x) sin(2 pi y),
# Q4 on PeriodicUnitSquareMesh(256, 256, quadrilateral=True) (65,536
# cells, 1,048,576 dofs): not structured, so the gather route, where the
# sum-factorised plan is chosen without a switch; CG + Jacobi.  Its local
# tensors are held to the direct lowerer (FDTPU_SPECTRAL=0) on the first
# SPEC_CMP_CELLS cells.  The load is one eigenfunction: CG reaches rtol
# 1e-10 in 10 iterations at every study size; at rtol 1e-12 it stalled
# on rounding at 256^2 and took 621 iterations on the CPU and 1632 on
# the card (NVIDIA H100 80GB HBM3), so the count was no gate.
SPEC_N, SPEC_DEG = 256, 4
SPEC_SP = {"ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": 1e-10}
SPEC_CMP_CELLS = 4096
# the CPU convergence study (python3 chip_smoke.py --cpu-study
# gmg_ext_hex_1m spectral_q4_periodic_256): MeshHierarchy levels of the
# GMG case, mesh sizes of the spectral case
EXTRUDED_STUDY = {"gmg_ext_hex_1m": (1, 2), "spectral_q4_periodic_256":
                  (16, 32, 64)}
EXTRUDED_LABELS = ("shallow_water_ext_128", "gmg_ext_hex_1m",
                   "spectral_q4_periodic_256")
SPECTRAL_RTOL = 1e-11
# The bounds on the nodal errors (PERF.md).  gmg_ext_hex_1m: Q1 is
# nodally exact on this separable problem, so the error is the solve's
# round-off at every size: 8.116121e-14 and 9.790259e-14 at levels 1 and
# 2 of the CPU study, 2.006728e-14 in the CPU rehearsal at full size
# (the 8-core host of an H100 machine); the bound is twice the study's
# last level.  spectral_q4_periodic_256: the study's 7.297630e-9,
# 1.173366e-10, 1.888822e-12 at n = 16, 32, 64 (ratio 62.1) extrapolate
# to 4.9e-16 at 256, below the solve's floor; the bound is twice the CPU
# rehearsal's error at full size, 1.676659e-12 (the same host).
EXTRUDED_ERR = {"gmg_ext_hex_1m": 1.96e-13,
                "spectral_q4_periodic_256": 3.35e-12}
# shallow_water_ext_128 on the CPU of the 8-core host of an H100 machine
# (python3 chip_smoke.py --cpu-rehearsal shallow_water_ext_128): the
# energy drift and the CG iterations of each solve, in order
SW_REHEARSAL = dict(drift=2.3196735765562682e-07,
                    cg=[33, 1, 33] * SW_STEPS + [16])


class _KspIts:
    """The iteration count of every Krylov solve made through
    solving._run_ksp while entered (on any device)."""

    def __enter__(self):
        from firedrake_tpu_torch import solving
        self.mod, self.fn, self.its = solving, solving._run_ksp, []

        def run(*a, **kw):
            res = self.fn(*a, **kw)
            self.its.append(int(res.iterations))
            return res
        solving._run_ksp = run
        return self

    def __exit__(self, *exc):
        self.mod._run_ksp = self.fn


def _sw_run(fd, n, layers, steps, around=None):
    """demos/extruded_shallow_water.py on UnitSquareMesh(n) x `layers`
    layers with dt = 0.1 / n: its spaces, forms and loop (`steps` Strang
    steps of three `solve` calls each, then the P1 x P1 projection).
    `around(k)` is a context entered around step k (k = steps: the
    projection)."""
    around = around or (lambda k: contextlib.nullcontext())
    m = fd.UnitSquareMesh(n, n)
    mesh = fd.ExtrudedMesh(m, layers, layer_height=1.0 / layers)
    horiz = fd.FiniteElement("BDM", "triangle", 1)
    vert = fd.FiniteElement("DG", "interval", 0)
    W = fd.FunctionSpace(mesh, fd.HDiv(fd.TensorProductElement(horiz, vert)))
    X = fd.FunctionSpace(mesh, "DG", 0, vfamily="DG", vdegree=0)
    Xplot = fd.FunctionSpace(mesh, "CG", 1, vfamily="Lagrange", vdegree=1)
    u_0, u_h, u_1 = fd.Function(W), fd.Function(W), fd.Function(W)
    p_0, p_1 = fd.Function(X), fd.Function(X)
    p_plot = fd.Function(Xplot)
    x, y, z = fd.SpatialCoordinate(mesh)
    p_0.interpolate(fd.sin(4 * np.pi * x) * fd.sin(2 * np.pi * y))
    dt = 0.1 / n
    dot, div, dx = fd.dot, fd.div, fd.dx
    E0 = fd.assemble(0.5 * (dot(u_0, u_0) + p_0 * p_0) * dx)
    for k in range(steps):
        with around(k):
            u, w = fd.TrialFunction(W), fd.TestFunction(W)
            fd.solve(dot(w, u) * dx == dot(w, u_0) * dx
                     + 0.5 * dt * div(w) * p_0 * dx, u_h,
                     solver_parameters=SW_SP)
            p, phi = fd.TrialFunction(X), fd.TestFunction(X)
            fd.solve(phi * p * dx == phi * p_0 * dx
                     - dt * phi * div(u_h) * dx, p_1,
                     solver_parameters=SW_SP)
            u, w = fd.TrialFunction(W), fd.TestFunction(W)
            fd.solve(dot(w, u) * dx == dot(w, u_h) * dx
                     + 0.5 * dt * div(w) * p_1 * dx, u_1,
                     solver_parameters=SW_SP)
            u_0.assign(u_1)
            p_0.assign(p_1)
    with around(steps):
        p_trial, p_test = fd.TrialFunction(Xplot), fd.TestFunction(Xplot)
        fd.solve(p_trial * p_test * dx == p_0 * p_test * dx, p_plot,
                 solver_parameters=SW_SP)
    E1 = fd.assemble(0.5 * (dot(u_0, u_0) + p_0 * p_0) * dx)
    return dict(mesh=mesh, W=W, X=X, Xplot=Xplot, E0=E0, E1=E1, p_0=p_0,
                p_plot=p_plot, drift=abs(E1 - E0) / E0)


SW_STAGES = (
    ("assembly", _TP + "assemble", "FormAssembler.assemble"),
    ("column_plan", _TP + "assemble", "FormAssembler._run_column"),
    # the name the assembler calls (bound at its import)
    ("lowerer", _TP + "assemble", "run_cell_kernel"),
    ("solve", _TP + "solving", "_run_ksp"))


def shallow_water_run(fd):
    """shallow_water_ext_128 on the card: per step the CUDA-event times of
    assembly (the lowerer and the column plan apart) and the CG solves,
    the host wall time and the assembler cache's new entries; the gates;
    then SW_SMALL on the card and on the CPU in this process."""
    from firedrake_tpu_torch.assemble import _assembler_cache
    label = "shallow_water_ext_128"
    torch.cuda.reset_peak_memory_stats()
    counts, rows = _Counts(), []

    @contextlib.contextmanager
    def around(k):
        st = _EventStages(SW_STAGES)
        n0 = len(_assembler_cache)
        with counts, st:
            torch.cuda.synchronize()
            t = time.perf_counter()
            yield
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        rows.append((k, wall, st.ms(), len(_assembler_cache) - n0))

    t0 = time.perf_counter()
    with _KspIts() as its, warnings.catch_warnings():
        warnings.filterwarnings("error", "linear solve did not converge")
        p = _sw_run(fd, SW_N, SW_LAYERS, SW_STEPS, around)
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    calls = 0
    for k, wall, ms, new in rows:
        what = "projection" if k == SW_STEPS else f"step {k}"
        n_asm = ms["assembly"][2]
        calls += n_asm
        print(f"{label} {what}: wall_s {wall:.4f} exclusive_ms "
              + " ".join(f"{s} {v[0]:.3f}" for s, v in ms.items())
              + f" other_ms {1e3 * wall - sum(v[0] for v in ms.values()):.3f}"
              f" assemble_calls {n_asm} new_assemblers {new} cache_hits "
              f"{n_asm - new}")
    rest = rows[1:SW_STEPS]
    mean = {s: sum(r[2][s][0] for r in rest) / len(rest)
            for s, _, _ in SW_STAGES}
    print(f"{label}: steps 1-{SW_STEPS - 1} mean wall_s "
          f"{sum(r[1] for r in rest) / len(rest):.4f} exclusive_ms "
          + " ".join(f"{s} {v:.3f}" for s, v in mean.items()))
    mesh, W, X = p["mesh"], p["W"], p["X"]
    print(f"{label}: prisms {mesh.num_cells} W dofs {W.dim} X dofs {X.dim}"
          f" Xplot dofs {p['Xplot'].dim} total_s {total_s:.3f} (setup, "
          f"steps and projection; step 0 builds the assemblers) E0 "
          f"{p['E0']!r} E1 {p['E1']!r} drift {p['drift']:.6e} "
          f"cg_iterations {its.its} device_peak {peak} "
          f"({peak / 2 ** 30:.3f} GiB) k1_launches {counts.k1} "
          f"k2_launches {counts.k2} lowerer_evals {counts.lowerer} "
          f"assemble_calls {calls} host_max_rss_gib {_max_rss_gib():.2f}")
    if not p["p_plot"].dat.is_cuda or not p["p_0"].dat.is_cuda:
        raise AssertionError(f"{label}: solution is not on the card")
    if not np.isfinite(p["p_plot"].dat.cpu().numpy()).all():
        raise AssertionError(f"{label}: projection is not finite")
    # the demo's own assertion, then the rehearsal's drift and counts
    assert p["drift"] < 0.02, p["drift"]
    want = SW_REHEARSAL
    if want is None or not p["drift"] < 2 * want["drift"]:
        raise AssertionError(f"{label}: drift {p['drift']}, the CPU "
                             f"rehearsal {want}")
    if len(its.its) != len(want["cg"]) or any(
            abs(a - b) > 1 for a, b in zip(its.its, want["cg"])):
        raise AssertionError(f"{label}: CG iterations {its.its}, the CPU "
                             f"rehearsal {want['cg']}")
    if any(r[3] for r in rows[1:SW_STEPS]):
        raise AssertionError(f"{label}: the assembler cache missed after "
                             "the first step")
    if counts.k1 or counts.k2 or counts.lowerer <= 0:
        raise AssertionError(f"{label}: K1/K2 launched or the lowerer "
                             "did not run")
    del p
    _release(label)
    # the Firedrake demo's size on the card and on the CPU
    n, layers = SW_SMALL
    card = _sw_run(fd, n, layers, SW_STEPS)
    fd.set_device("cpu")
    try:
        cpu, cpu_s = _sync_time(lambda: _sw_run(fd, n, layers, SW_STEPS))
    finally:
        fd.set_device(torch.device("cuda"))
    dE = max(abs(card[k] - cpu[k]) for k in ("E0", "E1"))
    dp = float((card["p_0"].dat.cpu() - cpu["p_0"].dat).abs().max())
    print(f"{label} small (base {n}, {layers} layers): card E1 "
          f"{card['E1']!r} cpu E1 {cpu['E1']!r} max|dE| {dE:.3e} max|dp| "
          f"{dp:.3e} (cpu run_s {cpu_s:.1f})")
    if not (dE <= 1e-10 and dp <= 1e-10):
        raise AssertionError(f"{label}: card and CPU differ at the demo's "
                             "size")
    del card, cpu
    _release(label)
    return counts


def _ext_gmg_problem(fd, levels):
    """gmg_ext_hex_1m's problem on an extruded hierarchy over `levels`
    refinements of UnitSquareMesh(EXT_N0) quads."""
    t0 = time.perf_counter()
    bh = fd.MeshHierarchy(fd.UnitSquareMesh(EXT_N0, EXT_N0,
                                            quadrilateral=True), levels)
    h = fd.ExtrudedMeshHierarchy(bh, height=1.0, base_layer=EXT_LAYER0)
    hier_s = time.perf_counter() - t0
    m = h[-1]
    V = fd.FunctionSpace(m, "CG", 1)
    X = fd.SpatialCoordinate(m)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    ex = X[0] * (1 - X[0]) * X[1] * (1 - X[1]) * X[2] * (1 - X[2])
    lap = -2 * (X[1] * (1 - X[1]) * X[2] * (1 - X[2])
                + X[0] * (1 - X[0]) * X[2] * (1 - X[2])
                + X[0] * (1 - X[0]) * X[1] * (1 - X[1]))
    f = fd.Function(V).interpolate(-lap)
    a = fd.inner(fd.grad(u), fd.grad(v)) * fd.dx
    L = fd.inner(f, v) * fd.dx
    bc = fd.DirichletBC(V, 0.0, "on_boundary")
    uh = fd.Function(V)
    solver = fd.LinearVariationalSolver(
        fd.LinearVariationalProblem(a, L, uh, bcs=bc),
        solver_parameters=EXT_SP)
    return dict(hier=h, hier_s=hier_s, V=V, a=a, L=L, bc=bc, uh=uh,
                solver=solver, exact=fd.Function(V).interpolate(ex))


def ext_gmg_run(fd):
    """gmg_ext_hex_1m on the card: host hierarchy build apart, the GMG
    set-up and solve stages, the gates, and the finest ColumnMatrix's
    matvec beside its byte bound."""
    from firedrake_tpu_torch.assembly.columns import ColumnMatrix
    label = "gmg_ext_hex_1m"
    torch.cuda.reset_peak_memory_stats()
    p, setup_s = _sync_time(lambda: _ext_gmg_problem(fd, EXT_LEVELS))
    solver, uh = p["solver"], p["uh"]
    with _Counts() as counts, _StageTimes() as st, \
            warnings.catch_warnings():
        warnings.filterwarnings("error", "linear solve did not converge")
        _, solve_s = _sync_time(solver.solve)
    peak = torch.cuda.max_memory_allocated()
    its = solver.ksp_iterations
    rel = _rel_residual(fd, p["a"], p["L"], p["bc"], uh)
    err = float((uh.dat - p["exact"].dat).abs().max())
    levels = [lv["A"] for lv in solver._gmg.levels]
    A = levels[-1]
    x = uh.dat.clone()
    mv_ms = _cuda_ms(lambda: A.matvec(x), reps=20, warm=3)
    mv_bytes = (A.data.numel() + 2 * x.numel()) * 8
    mv_bound = 1e3 * mv_bytes / HBM_BYTES_PER_S
    sec = st.secs
    print(f"{label}: levels {len(levels)} hexes {p['V'].mesh().num_cells} "
          f"dofs {p['V'].dim} hierarchy_s {p['hier_s']:.3f} "
          f"problem_setup_s {setup_s:.3f} (hierarchy included) solve_s "
          f"{solve_s:.3f} pc_setup_s {sec['pc_setup']:.3f} "
          f"level_assembly_s {sec['level_assembly']:.3f} cg_s "
          f"{sec['solve']:.4f} iterations {its} ms_per_iteration "
          f"{1e3 * sec['solve'] / max(its, 1):.4f} rel_residual {rel:.3e} "
          f"max_nodal_err {err:.4e} device_peak {peak} "
          f"({peak / 2 ** 30:.3f} GiB) host_max_rss_gib "
          f"{_max_rss_gib():.2f} k1_launches {counts.k1} k2_launches "
          f"{counts.k2} lowerer_evals {counts.lowerer}")
    print(f"{label}: finest ColumnMatrix {A!r} data_bytes "
          f"{A.data.numel() * 8} matvec_ms {mv_ms:.4f} (call time of 20 "
          f"back-to-back matvecs) byte_bound_ms {mv_bound:.4f} share "
          f"{mv_bound / mv_ms:.3f}")
    if not uh.dat.is_cuda:
        raise AssertionError(f"{label}: solution is not on the card")
    if not all(isinstance(B, ColumnMatrix) for B in levels):
        raise AssertionError(f"{label}: a level is not a ColumnMatrix")
    if not (solver.converged and rel <= 1e-10):
        raise AssertionError(f"{label}: relative residual {rel}")
    bound = EXTRUDED_ERR[label]
    if bound is None or not err < bound:
        raise AssertionError(f"{label}: nodal error {err}, bound {bound}")
    want = CPU_REHEARSAL_ITS.get(label)
    if want is None or abs(its - want) > 1:
        raise AssertionError(f"{label}: {its} iterations, the CPU "
                             f"rehearsal took {want}")
    if counts.k1 or counts.k2 or counts.lowerer <= 0:
        raise AssertionError(f"{label}: K1/K2 launched or the lowerer "
                             "did not run")
    del p, solver, uh, levels, A, x
    _release(label)
    return counts


def _spec_problem(fd, n):
    mesh = fd.PeriodicUnitSquareMesh(n, n, quadrilateral=True)
    V = fd.FunctionSpace(mesh, "CG", SPEC_DEG)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    X = fd.SpatialCoordinate(mesh)
    ex = fd.sin(2 * fd.pi * X[0]) * fd.sin(2 * fd.pi * X[1])
    a = (fd.inner(fd.grad(u), fd.grad(v)) + u * v) * fd.dx
    uh = fd.Function(V)
    solver = fd.LinearVariationalSolver(
        fd.LinearVariationalProblem(
            a, (1 + 8 * fd.pi ** 2) * ex * v * fd.dx, uh),
        solver_parameters=SPEC_SP)
    return dict(V=V, a=a, uh=uh, solver=solver,
                exact=fd.Function(V).interpolate(ex))


SPEC_STAGES = (
    ("assembly", _TP + "assemble", "FormAssembler.assemble"),
    ("spectral", _TP + "compiler.spectral", "SpectralPlan.local_tensors"),
    ("lowerer", _TP + "assemble", "run_cell_kernel"),
    ("solve", _TP + "solving", "_run_ksp"))


def spectral_run(fd):
    """spectral_q4_periodic_256 on the card: set-up (the sorted COO keys
    of the Sparsity) apart, the solve's stages by CUDA events, the gates;
    then the plan's local tensors against the direct lowerer's on the
    path's own inputs (the first SPEC_CMP_CELLS cells), both timed."""
    from firedrake_tpu_torch.assemble import get_assembler
    label = "spectral_q4_periodic_256"
    torch.cuda.reset_peak_memory_stats()
    p, setup_s = _sync_time(lambda: _spec_problem(fd, SPEC_N))
    solver = p["solver"]
    with _Counts() as counts, _EventStages(SPEC_STAGES) as st, \
            warnings.catch_warnings():
        warnings.filterwarnings("error", "linear solve did not converge")
        _, solve_s = _sync_time(solver.solve)
    ms = st.ms()
    peak = torch.cuda.max_memory_allocated()
    its = solver.ksp_iterations
    err = float((p["uh"].dat - p["exact"].dat).abs().max())
    print(f"{label}: cells {p['V'].mesh().num_cells} dofs {p['V'].dim} "
          f"setup_s {setup_s:.3f} solve_s {solve_s:.3f} (assembler build "
          f"included) exclusive_ms "
          + " ".join(f"{k} {v[0]:.3f}" for k, v in ms.items())
          + f" iterations {its} max_nodal_err {err:.4e} device_peak "
          f"{peak} ({peak / 2 ** 30:.3f} GiB) k1_launches {counts.k1} "
          f"k2_launches {counts.k2} lowerer_evals {counts.lowerer}")
    # the plan against the direct lowerer on the path's own inputs
    asm = get_assembler(p["a"])
    (ci,), (stt,) = asm._compiled, asm._statics
    sp = stt["spectral"]
    if ci.coefficients or ci.constants:
        raise AssertionError(f"{label}: the operator is expected to have "
                             "no coefficients or Constants")
    coords = asm.mesh.device_coordinates()
    ce = coords[stt["coords_map"]]
    C = ce.shape[-1]
    spec_ms = _cuda_ms(lambda: sp.local_tensors(ce, (), ()), reps=5, warm=1)
    loc = sp.local_tensors(ce[..., :SPEC_CMP_CELLS], (), ())
    direct = ci.cell_kernel_batched()
    ce_c = ce[..., :SPEC_CMP_CELLS].contiguous()
    ref = direct(ce_c, (), ())
    direct_ms = _cuda_ms(lambda: direct(ce_c, (), ()), reps=5, warm=1)
    scale = float(ref.abs().max())
    diff = float((loc - ref).abs().max())
    print(f"{label}: spectral local tensors vs the direct lowerer on "
          f"{SPEC_CMP_CELLS} cells: max|delta| {diff:.3e} max|A| "
          f"{scale:.3e} tol {SPECTRAL_RTOL * scale:.3e}; spectral_ms "
          f"{spec_ms:.3f} on {C} cells ({spec_ms * SPEC_CMP_CELLS / C:.4f} "
          f"per {SPEC_CMP_CELLS}) direct_ms {direct_ms:.3f} on "
          f"{SPEC_CMP_CELLS} cells")
    if not p["uh"].dat.is_cuda:
        raise AssertionError(f"{label}: solution is not on the card")
    if asm._stencil is not None or sp is None:
        raise AssertionError(f"{label}: the spectral plan was not chosen")
    if not diff <= SPECTRAL_RTOL * scale:
        raise AssertionError(f"{label}: spectral and direct differ")
    bound = EXTRUDED_ERR[label]
    if bound is None or not err < bound:
        raise AssertionError(f"{label}: nodal error {err}, bound {bound}")
    want = CPU_REHEARSAL_ITS.get(label)
    if want is None or abs(its - want) > 1:
        raise AssertionError(f"{label}: {its} iterations, the CPU "
                             f"rehearsal took {want}")
    if counts.k1 or counts.k2 or counts.lowerer <= 0:
        raise AssertionError(f"{label}: K1/K2 launched or the plan did "
                             "not run")
    del p, solver, asm, ce, loc, ref, ce_c
    _release(label)
    return counts


def extruded_phase():
    """shallow_water_ext_128, gmg_ext_hex_1m, spectral_q4_periodic_256."""
    t0 = phase("extruded")
    import firedrake_tpu_torch as fd
    fd.set_device(torch.device("cuda"))
    used, failed = {}, []
    for label, run in (("shallow_water_ext_128", shallow_water_run),
                       ("gmg_ext_hex_1m", ext_gmg_run),
                       ("spectral_q4_periodic_256", spectral_run)):
        t1 = time.perf_counter()
        try:
            used[label] = run(fd)
        except AssertionError as exc:
            # the later cases still run and print; the phase fails below
            failed.append(f"{label}: {exc}")
            _release(label)
        print(f"{label}: case_s {time.perf_counter() - t1:.1f}")
    if failed:
        raise AssertionError("extruded phase: " + "; ".join(failed))
    phase_done("extruded", t0)
    return used


def extruded_cpu(labels, tag, study=False):
    """The extruded phase's cases on the CPU: at the card's size (the
    counts, drift and errors the card must match) or, with `study`, the
    GMG and spectral cases at EXTRUDED_STUDY's sizes with the error
    ratios per level."""
    import firedrake_tpu_torch as fd
    fd.set_device("cpu")
    for label in labels:
        t0 = time.perf_counter()
        if label == "shallow_water_ext_128":
            if study:
                continue
            with _KspIts() as its:
                p = _sw_run(fd, SW_N, SW_LAYERS, SW_STEPS)
            print(f"{tag} {label}: W dofs {p['W'].dim} E0 {p['E0']!r} E1 "
                  f"{p['E1']!r} drift {p['drift']!r} cg_iterations "
                  f"{its.its} seconds {time.perf_counter() - t0:.1f} "
                  f"host_max_rss_gib {_max_rss_gib():.2f}", flush=True)
            continue
        sizes = (EXTRUDED_STUDY[label] if study else
                 (EXT_LEVELS if label == "gmg_ext_hex_1m" else SPEC_N,))
        prev = None
        for s in sizes:
            t0 = time.perf_counter()
            p = (_ext_gmg_problem(fd, s) if label == "gmg_ext_hex_1m"
                 else _spec_problem(fd, s))
            p["solver"].solve()
            err = float((p["uh"].dat - p["exact"].dat).abs().max())
            rate = "" if prev is None else f" ratio {prev / err:.4f}"
            print(f"{tag} {label} size {s}: dofs {p['V'].dim} iterations "
                  f"{p['solver'].ksp_iterations} converged "
                  f"{p['solver'].converged} max_nodal_err {err:.6e}{rate} "
                  f"seconds {time.perf_counter() - t0:.1f} "
                  f"host_max_rss_gib {_max_rss_gib():.2f}", flush=True)
            prev = err


# ------------------------------------------ fieldsplit, python PCs, Vanka
# stokes_th_schur_256: tests/regression/test_solver_composition.py
# test_mg_inside_fieldsplit on MeshHierarchy(UnitSquareMesh(16), 4), i.e.
# 256^2 (Taylor-Hood P2-P1, 526,338 + 66,049 = 592,387 dofs), Poiseuille
# flow u = (y(1 - y), 0) on the whole boundary: fgmres at rtol 1e-8, Schur
# full, fieldsplit_0 preonly + mg (Chebyshev(3) levels) on the velocity
# block, fieldsplit_1 MassInvPC (its Mp_ preonly + lu).
# stokes_th_vanka_24: test_vanka_smoother at UnitSquareMesh(24) (5,427
# dofs), fgmres at rtol 1e-8 with pc_type vanka (625 patches of 39 dofs,
# K2's large variant); Vanka alone takes 50, 104, 404 iterations at n = 6,
# 12, 24 and stops at the 2000 cap at 48 (the JAX package, CPU), so it
# runs at 24.  navier_stokes_pcd_64: test_navier_stokes_schur[pcd] at
# UnitSquareMesh(64) (37,507 dofs): the Re = 50 lid-driven cavity, Newton
# at snes_rtol 1e-8, fgmres at rtol 1e-8, Schur full, fieldsplit_0 lu,
# fieldsplit_1 gmres at rtol 1e-4 with PCDPC (Kp's pseudo-inverse at
# 4,225 pressure dofs on the card), held to the same solve on the CPU in
# this process.  navier_stokes_pcd_128: the same at UnitSquareMesh(128)
# (148,739 dofs), on the card alone, held to the CPU rehearsal: the
# largest size whose dense Kp pseudo-inverse the card holds (16,641
# pressure dofs: 5.18 s, 12.4 GB, python3 chip_smoke.py --only
# pcd_limit; at 256^2 the dense Kp alone is 34.9 GB).
FS_N0, FS_LEVELS, VANKA_N, PCD_N, PCD_RE = 16, 4, 24, 64, 50.0
PCD_FULL_N = 128
# navier_stokes_pcd_128's max u_y in the CPU rehearsal (python3
# chip_smoke.py --cpu-rehearsal navier_stokes_pcd_128 on the 8-core host
# of an H100 machine, 784 s); the card's within 1e-8 of it
PCD_FULL_UY = 0.5238850498573759
# navier_stokes_pcd_64 is held to the CPU in this process at 32^2 (a
# card solve and a CPU solve there, equal counts, within 1e-8): at 64^2
# the CPU solve took 35.4 s and 57.5 s on two card hosts (my chip runs,
# PR 13), too much of the script's time limit
PCD_CPU_N = 32
SCHUR_MG_SP = {"ksp_type": "fgmres", "ksp_rtol": 1e-8,
               "pc_type": "fieldsplit", "pc_fieldsplit_type": "schur",
               "pc_fieldsplit_schur_fact_type": "full",
               "fieldsplit_0_ksp_type": "preonly",
               "fieldsplit_0_pc_type": "mg",
               "fieldsplit_0_mg_levels_ksp_type": "chebyshev",
               "fieldsplit_0_mg_levels_ksp_max_it": 3,
               "fieldsplit_1_pc_type": "python",
               "fieldsplit_1_pc_python_type": "firedrake.MassInvPC"}
VANKA_SP = {"ksp_type": "fgmres", "ksp_rtol": 1e-8, "ksp_max_it": 2000,
            "pc_type": "vanka"}
PCD_SP = {"snes_rtol": 1e-8, "snes_max_it": 30, "ksp_type": "fgmres",
          "ksp_rtol": 1e-8, "ksp_max_it": 400, "pc_type": "fieldsplit",
          "pc_fieldsplit_type": "schur",
          "pc_fieldsplit_schur_fact_type": "full",
          "fieldsplit_0_ksp_type": "preonly", "fieldsplit_0_pc_type": "lu",
          "fieldsplit_1_ksp_type": "gmres", "fieldsplit_1_ksp_rtol": 1e-4,
          "fieldsplit_1_ksp_max_it": 100, "fieldsplit_1_pc_type": "python",
          "fieldsplit_1_pc_python_type": "firedrake.PCDPC"}
FIELDSPLIT_LABELS = ("stokes_th_schur_256", "stokes_th_vanka_24",
                     "navier_stokes_pcd_64", "navier_stokes_pcd_128")
PCD_SIZE = {"navier_stokes_pcd_64": PCD_N,
            "navier_stokes_pcd_128": PCD_FULL_N}
# --cpu-study stokes_th_schur_256: the hierarchy at these levels
FIELDSPLIT_STUDY = (2, 3)
# Bounds on the Poiseuille velocity's errornorm (P2 holds it exactly: the
# error is the solve's): stokes_th_schur_256 twice the CPU rehearsal's
# (python3 chip_smoke.py --cpu-rehearsal stokes_th_schur_256 on the 8-core
# host of an H100 machine: 28 iterations, 1.647235e-7), below the test's
# 1e-6; stokes_th_vanka_24 below 1e-7 (the JAX package's CPU run and the
# port's: 1.13e-8).
FIELDSPLIT_ERR = {"stokes_th_schur_256": 3.2945e-7,
                  "stokes_th_vanka_24": 1e-7}
# stage times of a linear solve (CUDA events; the host's LU and set-up
# too, the card idle meanwhile)
FIELDSPLIT_STAGES = (
    ("assembly", _TP + "solving", "assemble"),
    ("pc_setup", _TP + "solving", "build_pc"),
    ("gmg_setup", _TP + "mg.vcycle", "GMGPreconditioner"),
    ("k2", _TP + "ops.batched_inverse", "batched_inv"),
    ("solve", _TP + "solving", "_run_ksp"))


def _stokes_problem(fd, mesh, params):
    """test_solver_composition.py stokes_problem on `mesh`: Taylor-Hood
    Stokes, Poiseuille flow on the boundary, zero load."""
    V = fd.VectorFunctionSpace(mesh, "CG", 2)
    Q = fd.FunctionSpace(mesh, "CG", 1)
    W = V * Q
    u, p = fd.TrialFunctions(W)
    v, q = fd.TestFunctions(W)
    a = (fd.inner(fd.grad(u), fd.grad(v)) - p * fd.div(v)
         - q * fd.div(u)) * fd.dx
    X = fd.SpatialCoordinate(mesh)
    uex = fd.as_vector([X[1] * (1 - X[1]), 0.0])
    L = fd.inner(fd.Constant([0.0, 0.0]), v) * fd.dx
    bcs = [fd.DirichletBC(W.sub(0), fd.Function(V).interpolate(uex),
                          (1, 2, 3, 4))]
    w = fd.Function(W)
    solver = fd.LinearVariationalSolver(
        fd.LinearVariationalProblem(a, L, w, bcs=bcs),
        solver_parameters=params)
    return dict(W=W, w=w, uex=uex, solver=solver)


def _stokes_case(fd, label, n):
    """The Stokes cases' problem: the 256^2 hierarchy's finest mesh, or
    UnitSquareMesh(n)."""
    if label == "stokes_th_schur_256":
        mesh = fd.MeshHierarchy(fd.UnitSquareMesh(FS_N0, FS_N0),
                                n).meshes[-1]
        return _stokes_problem(fd, mesh, SCHUR_MG_SP)
    return _stokes_problem(fd, fd.UnitSquareMesh(n, n), VANKA_SP)


def _cavity_problem(fd, n):
    """test_solver_composition.py navier_stokes_cavity at Re = PCD_RE with
    PCD_SP, as a solver object (its Newton history)."""
    mesh = fd.UnitSquareMesh(n, n)
    V = fd.VectorFunctionSpace(mesh, "CG", 2)
    Q = fd.FunctionSpace(mesh, "CG", 1)
    W = V * Q
    w = fd.Function(W)
    u, p = fd.split(w)
    v, q = fd.TestFunctions(W)
    F = ((1.0 / PCD_RE) * fd.inner(fd.grad(u), fd.grad(v))
         + fd.inner(fd.dot(u, fd.nabla_grad(u)), v)
         - p * fd.div(v) - q * fd.div(u)) * fd.dx
    X = fd.SpatialCoordinate(mesh)
    lid = fd.as_vector([1.0 + 0 * X[0], 0.0 * X[1]])
    bcs = [fd.DirichletBC(W.sub(0), fd.Function(V).interpolate(lid), 4),
           fd.DirichletBC(W.sub(0), fd.Constant([0.0, 0.0]), (1, 2, 3))]
    solver = fd.NonlinearVariationalSolver(
        fd.NonlinearVariationalProblem(F, w, bcs=bcs),
        solver_parameters=PCD_SP,
        appctx={"Re": PCD_RE, "state": w, "velocity_space": 0,
                "mu": 1 / PCD_RE})
    return dict(W=W, w=w, solver=solver)


def _flow(w):
    """(max |u_x|, max u_y) of the cavity's velocity."""
    ud = w.subfunctions[0].dat.reshape(-1, 2)
    return float(ud[:, 0].abs().max()), float(ud[:, 1].max())


def _fs_stage_line(label, total_s, st):
    ms = st.ms()
    print(f"{label} stages: total_ms {1e3 * total_s:.3f} exclusive_ms "
          + " ".join(f"{k} {v[0]:.3f}" for k, v in ms.items())
          + " other " + f"{1e3 * total_s - sum(v[0] for v in ms.values()):.3f}"
          + "; calls " + " ".join(f"{k} {v[2]}" for k, v in ms.items()))


def _stokes_run(fd, label):
    """One Stokes case on the card: host set-up, then the counted solve
    with its stage times; the gates."""
    n = FS_LEVELS if label == "stokes_th_schur_256" else VANKA_N
    torch.cuda.reset_peak_memory_stats()
    p, setup_s = _sync_time(lambda: _stokes_case(fd, label, n))
    solver = p["solver"]
    with _Counts() as counts, _EventStages(FIELDSPLIT_STAGES) as st, \
            _K1Inputs() as k1_inputs:
        _, solve_s = _sync_time(solver.solve)
    _fs_stage_line(label, solve_s, st)
    err = fd.errornorm(p["uex"], p["w"].subfunctions[0])
    its, want = solver.ksp_iterations, CPU_REHEARSAL_ITS[label]
    bound = FIELDSPLIT_ERR[label]
    W = p["W"]
    print(f"{label}: dofs {W.subspaces[0].dim} + {W.subspaces[1].dim} = "
          f"{W.dim} setup_s {setup_s:.3f} solve_s {solve_s:.3f} "
          f"iterations {its} (CPU rehearsal {want}) converged "
          f"{solver.converged} errornorm_u {err:.4e} (bound {bound}) "
          f"device_peak {torch.cuda.max_memory_allocated()} on "
          f"{p['w'].dat.device} k1_launches {counts.k1} k1_by_variant "
          f"{counts.k1_by_variant} k2_launches {counts.k2} k2_large "
          f"{counts.k2_large} lowerer_evals {counts.lowerer}")
    if not p["w"].dat.is_cuda:
        raise AssertionError(f"{label}: solution is not on the card")
    tol = 1 if label == "stokes_th_schur_256" else 0.02 * want
    if not (solver.converged and abs(its - want) <= tol):
        raise AssertionError(f"{label}: {its} iterations, the CPU "
                             f"rehearsal took {want}")
    if not err < bound:
        raise AssertionError(f"{label}: errornorm {err} >= {bound}")
    k1_inputs.check(label, counts.k1)
    return p, counts, st


def stokes_schur_run(fd, label):
    """stokes_th_schur_256: K1 on MassInvPC's pressure mass, K2 not on the
    solve; then the Vanka patches of its assembled operator, (66,049, 39,
    39), through K2's large variant against its plain version (set-up
    only: Vanka alone does not converge at this size)."""
    from firedrake_tpu_torch.solvers.preconditioners import (
        vanka_patches, patch_matrices)
    p, counts, st = _stokes_run(fd, label)
    if counts.k1 <= 0 or counts.k2:
        raise AssertionError(f"{label}: K1 {counts.k1} launches, K2 "
                             f"{counts.k2} (K1 >= 1, K2 0 expected)")
    A = st.first_args["pc_setup"][0].mat
    (idx, mask), patch_s = _sync_time(lambda: vanka_patches(A, p["W"], 1))
    Ap, gather_s = _sync_time(lambda: patch_matrices(A, idx, mask))
    print(f"{label}: Vanka patches {tuple(Ap.shape)} host lists_s "
          f"{patch_s:.3f} device gather_s {gather_s:.3f}")
    row = _k2_path_row(f"{label} Vanka", Ap)
    del p, st, A, Ap
    _release(label)
    return counts, row


def stokes_vanka_run(fd, label):
    """stokes_th_vanka_24: one launch of K2's large variant on the 625
    Vanka patches, held to its plain version on them."""
    p, counts, st = _stokes_run(fd, label)
    Ap = st.first_args["k2"][0]
    if counts.k2 != 1 or counts.k2_large != 1 or Ap.shape[-1] <= 32:
        raise AssertionError(f"{label}: K2 {counts.k2} launches, "
                             f"{counts.k2_large} large, on {Ap.shape}")
    row = _k2_path_row(label, Ap)
    del p, st, Ap
    _release(label)
    return counts, row


def cavity_run(fd, label):
    """A cavity case on the card, per Newton step the stage times; held
    to the CPU rehearsal's Newton steps and fgmres counts, to the test's
    flow bounds and, within 1e-8, to the same problem at PCD_CPU_N solved
    on the card and on the CPU in this process (navier_stokes_pcd_64: the
    velocity and the counts) or to the rehearsal's max u_y
    (navier_stokes_pcd_128); K1 to its plain version on the inputs the
    run gave it.  Returns (counts, None): no K2 row."""
    torch.cuda.reset_peak_memory_stats()
    p, setup_s = _sync_time(lambda: _cavity_problem(fd, PCD_SIZE[label]))
    solver = p["solver"]
    with _Counts() as counts, _StageTimes(NEWTON_STAGES) as st, \
            _K1Inputs() as k1_inputs:
        _, solve_s = _sync_time(solver.solve)
    _steps_line(label, solver.history, st)
    peak = torch.cuda.max_memory_allocated()
    n, ksp = solver.snes_iterations, [h["ksp_iterations"]
                                      for h in solver.history]
    want_n, want_k = CPU_REHEARSAL_ITS[label]
    ux, uy = _flow(p["w"])
    u = p["w"].subfunctions[0].dat
    if label == "navier_stokes_pcd_64":
        small = _cavity_problem(fd, PCD_CPU_N)
        small["solver"].solve()
        fd.set_device("cpu")
        t0 = time.perf_counter()
        try:
            q = _cavity_problem(fd, PCD_CPU_N)
            q["solver"].solve()
        finally:
            fd.set_device(torch.device("cuda"))
        u_small = small["w"].subfunctions[0].dat
        u_cpu = q["w"].subfunctions[0].dat
        diff = float((u_small.cpu() - u_cpu).abs().max()) / float(
            u_cpu.abs().max())

        def counts_of(sv):
            return (sv.snes_iterations,
                    [h["ksp_iterations"] for h in sv.history])
        small_counts = (counts_of(small["solver"]), counts_of(q["solver"]))
        ref = (f"at {PCD_CPU_N}^2 the card {small_counts[0]} and this "
               f"process's CPU solve {small_counts[1]}, card_vs_cpu "
               f"{diff:.3e}, cpu solve_s {time.perf_counter() - t0:.1f}")
        del q, small
    else:
        small_counts = (0, 0)
        diff = abs(uy - PCD_FULL_UY) / PCD_FULL_UY
        ref = f"max u_y {PCD_FULL_UY!r}, card_vs_cpu {diff:.3e}"
    print(f"{label}: dofs {p['W'].subspaces[0].dim} + "
          f"{p['W'].subspaces[1].dim} = {p['W'].dim} setup_s {setup_s:.3f} "
          f"solve_s {solve_s:.3f} newton_steps {n} fgmres_iterations {ksp} "
          f"(CPU rehearsal {want_n} {want_k}; {ref}) converged "
          f"{solver.converged} max|u_x| {ux:.6f} max u_y {uy!r} "
          f"device_peak {peak} on {u.device} k1_launches {counts.k1} "
          f"k1_by_variant {counts.k1_by_variant} k2_launches {counts.k2} "
          f"lowerer_evals {counts.lowerer}")
    if not u.is_cuda:
        raise AssertionError(f"{label}: solution is not on the card")
    if not (solver.converged and (n, ksp) == (want_n, want_k)
            and small_counts[0] == small_counts[1]):
        raise AssertionError(f"{label}: {n} Newton steps, fgmres {ksp}; "
                             f"the CPU rehearsal {want_n}, {want_k}; at "
                             f"{PCD_CPU_N}^2 card and CPU {small_counts}")
    if not (0.9 < ux < 1.3 and uy > 0.02):
        raise AssertionError(f"{label}: flow max|u_x| {ux}, max u_y {uy}")
    if not diff <= 1e-8:
        raise AssertionError(f"{label}: card {diff} from the CPU")
    if counts.k1 <= 0 or counts.k2:
        raise AssertionError(f"{label}: K1 {counts.k1} launches, K2 "
                             f"{counts.k2} (K1 >= 1, K2 0 expected)")
    k1_inputs.check(label, counts.k1)
    del p, st
    _release(label)
    return counts, None


def fieldsplit_phase():
    """stokes_th_schur_256, stokes_th_vanka_24, navier_stokes_pcd_64,
    navier_stokes_pcd_128."""
    t0 = phase("fieldsplit")
    import firedrake_tpu_torch as fd
    fd.set_device(torch.device("cuda"))
    used, rows, failed = {}, {}, []
    for label, run in (("stokes_th_schur_256", stokes_schur_run),
                       ("stokes_th_vanka_24", stokes_vanka_run),
                       ("navier_stokes_pcd_64", cavity_run),
                       ("navier_stokes_pcd_128", cavity_run)):
        t1 = time.perf_counter()
        try:
            used[label], rows[label] = run(fd, label)
        except AssertionError as exc:
            # the later cases still run and print; the phase fails below
            failed.append(f"{label}: {exc}")
            _release(label)
        print(f"{label}: case_s {time.perf_counter() - t1:.1f}")
    if failed:
        raise AssertionError("fieldsplit phase: " + "; ".join(failed))
    phase_done("fieldsplit", t0)
    return used, {k: v for k, v in rows.items() if v is not None}


def pcd_limit():
    """PCDPC's Kp solve (solvers/pcs.py _dense_pinv_solver: the dense
    pseudo-inverse of the pressure stiffness, made once per Newton step)
    at navier_stokes_pcd_64's size and the next, UnitSquareMesh(64) and
    (128): seconds on the card (a warm-up call first) and the device
    memory it takes; the same on the host at 64 (the in-process CPU
    solve's)."""
    import firedrake_tpu_torch as fd
    from firedrake_tpu_torch.solvers.pcs import _dense_pinv_solver

    def stiffness(n):
        Q = fd.FunctionSpace(fd.UnitSquareMesh(n, n), "CG", 1)
        p, q = fd.TrialFunction(Q), fd.TestFunction(Q)
        return fd.assemble(fd.inner(fd.grad(p), fd.grad(q)) * fd.dx)

    fd.set_device(torch.device("cuda"))
    _dense_pinv_solver(stiffness(8))
    for n in (PCD_N, 2 * PCD_N):
        Kp = stiffness(n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        solve, pinv_s = _sync_time(lambda: _dense_pinv_solver(Kp))
        extra = torch.cuda.max_memory_allocated() - base
        r = torch.ones(Kp.shape[0], dtype=torch.float64, device="cuda")
        _, apply_s = _sync_time(lambda: solve(r))
        print(f"pcd_limit card n {n}: pressure dofs {Kp.shape[0]} pinv_s "
              f"{pinv_s:.3f} apply_ms {1e3 * apply_s:.3f} device_peak_extra "
              f"{extra} ({extra / 2 ** 30:.3f} GiB)", flush=True)
        del solve, Kp
    fd.set_device("cpu")
    try:
        Kp = stiffness(PCD_N)
        t0 = time.perf_counter()
        _dense_pinv_solver(Kp)
        print(f"pcd_limit host n {PCD_N}: pressure dofs {Kp.shape[0]} "
              f"pinv_s {time.perf_counter() - t0:.3f}", flush=True)
    finally:
        fd.set_device(torch.device("cuda"))


def fieldsplit_cpu(labels, tag, study=False):
    """The fieldsplit phase's cases on the CPU: at the card's size (the
    counts and errors the card must match) or, with `study`,
    stokes_th_schur_256 at the hierarchy levels of FIELDSPLIT_STUDY."""
    import firedrake_tpu_torch as fd
    fd.set_device("cpu")
    for label in labels:
        if label in PCD_SIZE:
            if study:
                continue
            t0 = time.perf_counter()
            p = _cavity_problem(fd, PCD_SIZE[label])
            p["solver"].solve()
            ux, uy = _flow(p["w"])
            print(f"{tag} {label}: dofs {p['W'].dim} newton_steps "
                  f"{p['solver'].snes_iterations} fgmres_iterations "
                  f"{[h['ksp_iterations'] for h in p['solver'].history]} "
                  f"max|u_x| {ux!r} max u_y {uy!r} seconds "
                  f"{time.perf_counter() - t0:.1f} host_max_rss_gib "
                  f"{_max_rss_gib():.2f}", flush=True)
            continue
        full = FS_LEVELS if label == "stokes_th_schur_256" else VANKA_N
        sizes = FIELDSPLIT_STUDY if study else (full,)
        if study and label != "stokes_th_schur_256":
            continue
        for s in sizes:
            t0 = time.perf_counter()
            p = _stokes_case(fd, label, s)
            p["solver"].solve()
            err = fd.errornorm(p["uex"], p["w"].subfunctions[0])
            print(f"{tag} {label} size {s}: dofs {p['W'].dim} iterations "
                  f"{p['solver'].ksp_iterations} converged "
                  f"{p['solver'].converged} errornorm_u {err:.6e} seconds "
                  f"{time.perf_counter() - t0:.1f} host_max_rss_gib "
                  f"{_max_rss_gib():.2f}", flush=True)


# ------------------------------------------------------------ multilevel
# pmg_p4_256: -lap u = 2 pi^2 sin(pi x) sin(pi y), u = 0 on the boundary,
# P4 on the finest mesh of MeshHierarchy(UnitSquareMesh(16), 4) (256^2,
# 1,050,625 dofs), CG at rtol 1e-11 with pc_type pmg (4 -> 2 -> 1), the
# P1 level (66,049 dofs) by GMG over the hierarchy (at rtol 1e-10 CG
# stopped with ||b - A u|| / ||b|| at 1.008e-10, on the card and in the
# CPU rehearsal alike, above the case's 1e-10 gate).  fas_bratu_p1_1024:
# Bratu, -lap u = 2 exp(u), u = 0, P1 on MeshHierarchy(UnitSquareMesh(16),
# 6) (1024^2, 1,050,625 dofs, 7 levels), snes_type fas at snes_rtol 1e-9
# (tests/multigrid/test_fas.py), held to Newton + CG + GMG on the same
# mesh.  linesmooth_q1_ext_128: -lap u = 1 on a slab 0.05 thick, Q1 on
# ExtrudedMeshHierarchy(MeshHierarchy(UnitSquareMesh(8, quadrilateral=
# True), 4), height=0.05, layers=64) (128^2 x 64, 1,081,665 dofs), u = 0
# on the sides, top and bottom, CG at rtol 1e-8 with GMG whose levels
# smooth by vertical lines (linesmooth, codim 2: one 65-dof column per
# base vertex, K2's large variant), horizontal coarsening only.
# fdm_q4_256: pmg_p4_256's problem with Q4 on UnitSquareMesh(256,
# quadrilateral=True) (1,050,625 dofs), CG at rtol 1e-10 with FDMPC (its
# Q1 coarse level by host LU).
ML_N0, PMG_LEVELS, FAS_LEVELS = 16, 4, 6
LINE_N0, LINE_LEVELS, LINE_LAYERS, LINE_HEIGHT = 8, 4, 64, 0.05
FDM_N = 256
# fas_bratu_p1_1024 may take at most 3 cycles more than the same solve at
# MeshHierarchy(UnitSquareMesh(16), 2), 64^2 (the JAX test's
# mesh-independence bound), as --cpu-rehearsal counts it
FAS_REHEARSAL_LEVELS = 2
FAS_ATOL = 5e-8                    # FAS against Newton (the JAX test's)
PMG_SP = {"ksp_type": "cg", "ksp_rtol": 1e-11, "pc_type": "pmg",
          "pmg_mg_coarse_ksp_type": "preonly",
          "pmg_mg_coarse_pc_type": "mg"}
FAS_SP = {"snes_type": "fas", "snes_rtol": 1e-9}
BRATU_NEWTON_SP = {"snes_rtol": 1e-10, "ksp_type": "cg", "ksp_rtol": 1e-12,
                   "pc_type": "mg"}
LINE_SP = {"ksp_type": "cg", "ksp_rtol": 1e-8, "pc_type": "mg",
           "mg_levels_pc_type": "linesmooth",
           "mg_levels_pc_linesmooth_codims": "2"}
FDM_SP = {"ksp_type": "cg", "ksp_rtol": 1e-10, "pc_type": "python",
          "pc_python_type": "firedrake.FDMPC"}
MULTILEVEL_LABELS = ("pmg_p4_256", "fas_bratu_p1_1024",
                     "linesmooth_q1_ext_128", "fdm_q4_256")
# --cpu-study: pmg_p4_256 at these hierarchy levels, fdm_q4_256 at these
# mesh sizes (the errornorms' rates)
ML_STUDY = {"pmg_p4_256": (0, 1, 2), "fdm_q4_256": (16, 32, 64)}
# errornorm bounds.  At 256^2 the errornorm is set by rounding, not by the
# h^5 rate of the study (ratios 31.95-31.99 up to 64^2).  python3
# chip_smoke.py --only ml_rounding (an H100 and its 8-core host) takes it
# apart: card and CPU assemble b and A within 6.3e-16 relative, the
# card's u gives the card's errornorm on the host too, and both u's
# residuals, taken in long double, lie below the f64 floor
# eps || |A| |u| || / ||b|| (pmg 2.8e-10, FDM 1.4e-10), where CG stops
# reducing them.  Two steps of iterative refinement with long-double
# residuals bring the card's and the CPU's u to one vector (within
# 2.2e-16) whose errornorm is 4.987e-13 (pmg) and 2.1135e-12 (FDM): the
# solution of the f64-assembled system.  The readings (card, CPU) differ
# from it by the algebraic error CG leaves at the floor, which follows
# the order of the reductions.  So each case is held below twice the
# larger reading and below the study's errornorm at 64^2.  pmg's CG runs
# at rtol 1e-11: at 1e-10 its true residual stopped at 1.008e-10, on
# card and CPU alike, over the 1e-10 gate.
ML_READINGS = {"pmg_p4_256": (4.5216e-12, 5.1626e-13),
               "fdm_q4_256": (1.9981e-13, 2.1076e-12)}
ML_STUDY_64 = {"pmg_p4_256": 2.389e-11, "fdm_q4_256": 3.237e-12}
ML_ERR = {k: min(2 * max(v), ML_STUDY_64[k])
          for k, v in ML_READINGS.items()}
# the small cases, each held to the same solve on the CPU in this process
# (within 1e-10 max|u|, equal counts): GMG with grid-line smoothers on
# MeshHierarchy(UnitCubeMesh(4), 2) (17-dof lines, K2's warp variant);
# Q2 on ExtrudedMesh(UnitSquareMesh(8, quadrilateral=True), 6) with
# pc_type extruded_star (117-dof stars, K2's large variant); Newton with
# the nonlinear patch smoother on Bratu P1 at 64^2; pfas on Bratu P4 at
# 8^2 (35 cycles; at 32^2 the CPU solve alone takes 251-277 s on 8
# cores); FacetSplitPC with an exact Schur factorization on P4 at 32^2
# (tests/regression/test_facet_split.py:26), also held to the LU solve.
SMALL_ML = ("gridline_p1_cube_16", "extruded_star_q2_ext_6",
            "npc_patch_bratu_64", "pfas_bratu_p4_8", "facet_split_p4_32")
GRIDLINE_SP = {"ksp_type": "cg", "ksp_rtol": 1e-10, "pc_type": "mg",
               "mg_levels_pc_type": "gridline"}
STAR_SP = {"ksp_type": "cg", "ksp_rtol": 1e-10,
           "pc_type": "extruded_star"}
NPC_SP = {"snes_rtol": 1e-9, "npc_snes_type": "patch", "ksp_type": "cg",
          "ksp_rtol": 1e-10, "pc_type": "jacobi"}
PFAS_SP = {"snes_type": "pfas", "snes_rtol": 1e-9}
FACET_SP = {"ksp_type": "preonly", "pc_type": "python",
            "pc_python_type": "firedrake.FacetSplitPC",
            "facet_pc_type": "fieldsplit",
            "facet_pc_fieldsplit_type": "schur",
            "facet_pc_fieldsplit_schur_fact_type": "full",
            "facet_fieldsplit_0_ksp_type": "preonly",
            "facet_fieldsplit_0_pc_type": "lu",
            "facet_fieldsplit_1_ksp_type": "cg",
            "facet_fieldsplit_1_ksp_rtol": 1e-12,
            "facet_fieldsplit_1_ksp_max_it": 2000,
            "facet_fieldsplit_1_pc_type": "none"}
# the line smoother on 128 layers (129-dof lines: K2's huge variant), a
# small case of the ddm phase
CAP_LAYERS = 128
# stage times of a linear solve (CUDA events): the operator's and right-
# hand side's assembly, the PC set-up (level operators, patches; K2
# apart), K2, CG
ML_STAGES = (
    ("assembly", _TP + "solving", "assemble"),
    ("pc_setup", _TP + "solving", "build_pc"),
    ("k2", _TP + "ops.batched_inverse", "batched_inv"),
    ("solve", _TP + "solving", "_run_ksp"))
# Newton with the nonlinear patch smoother: NEWTON_STAGES, the smoother
# (K2 apart)
NPC_STAGES = NEWTON_STAGES + (
    ("patch_smooth", _TP + "solving",
     "NonlinearVariationalSolver._patch_smooth"),
    ("k2", _TP + "ops.batched_inverse", "batched_inv"))
# FAS: its set-up (level forms, transfers), the level residuals and
# Jacobian diagonals (assemblies), the coarsest Newton
FAS_STAGES = (
    ("residual", _TP + "solvers.fas", "FASSolver._R"),
    ("diagonal", _TP + "solvers.fas", "FASSolver._diag"),
    ("coarse_newton", _TP + "solvers.fas", "FASSolver._coarse_newton"),
    # the class last: its methods are wrapped on the class itself
    ("setup", _TP + "solvers.fas", "FASSolver"))


def _sin_problem(fd, V, params):
    """-lap u = dim pi^2 prod sin(pi x_k), u = 0 on the boundary, in V."""
    dim = V.mesh().geometric_dimension
    X = fd.SpatialCoordinate(V.mesh())
    s = fd.sin(fd.pi * X[0])
    for k in range(1, dim):
        s = s * fd.sin(fd.pi * X[k])
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    a = fd.inner(fd.grad(u), fd.grad(v)) * fd.dx
    L = dim * fd.pi ** 2 * s * v * fd.dx
    bcs = [fd.DirichletBC(V, 0.0, "on_boundary")]
    uh = fd.Function(V)
    solver = fd.LinearVariationalSolver(
        fd.LinearVariationalProblem(a, L, uh, bcs=bcs),
        solver_parameters=params)
    return dict(V=V, a=a, L=L, bcs=bcs, uh=uh, solver=solver, exact=s)


def _slab_problem(fd, mesh, degree, params):
    """-lap u = 1 on an extruded mesh, u = 0 on its sides, top and
    bottom."""
    V = fd.FunctionSpace(mesh, "CG", degree)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    a = fd.inner(fd.grad(u), fd.grad(v)) * fd.dx
    L = fd.Constant(1.0) * v * fd.dx
    bcs = [fd.DirichletBC(V, 0.0, sub) for sub in
           ("on_boundary", "top", "bottom")]
    uh = fd.Function(V)
    solver = fd.LinearVariationalSolver(
        fd.LinearVariationalProblem(a, L, uh, bcs=bcs),
        solver_parameters=params)
    return dict(V=V, a=a, L=L, bcs=bcs, uh=uh, solver=solver, exact=None)


def _bratu_problem(fd, mesh, degree, params):
    """Bratu, -lap u = 2 exp(u), u = 0 on the boundary, u0 = 0."""
    V = fd.FunctionSpace(mesh, "CG", degree)
    u, v = fd.Function(V), fd.TestFunction(V)
    F = (fd.inner(fd.grad(u), fd.grad(v)) - 2.0 * fd.exp(u) * v) * fd.dx
    solver = fd.NonlinearVariationalSolver(
        fd.NonlinearVariationalProblem(
            F, u, bcs=[fd.DirichletBC(V, 0.0, "on_boundary")]),
        solver_parameters=params)
    return dict(V=V, uh=u, solver=solver)


def _ml_problem(fd, label, size=None):
    """The problem of one multilevel case (full size by default, or at
    `size`: hierarchy levels, mesh cells per side or layers)."""
    if label == "pmg_p4_256":
        mesh = fd.MeshHierarchy(fd.UnitSquareMesh(ML_N0, ML_N0),
                                size if size is not None
                                else PMG_LEVELS)[-1]
        return _sin_problem(fd, fd.FunctionSpace(mesh, "CG", 4), PMG_SP)
    if label == "fdm_q4_256":
        n = size or FDM_N
        mesh = fd.UnitSquareMesh(n, n, quadrilateral=True)
        return _sin_problem(fd, fd.FunctionSpace(mesh, "CG", 4), FDM_SP)
    if label in ("fas_bratu_p1_1024", "bratu_newton"):
        mesh = fd.MeshHierarchy(fd.UnitSquareMesh(ML_N0, ML_N0),
                                size if size is not None
                                else FAS_LEVELS)[-1]
        return _bratu_problem(fd, mesh, 1, FAS_SP if label.startswith(
            "fas") else BRATU_NEWTON_SP)
    if label == "linesmooth_q1_ext_128":
        bh = fd.MeshHierarchy(fd.UnitSquareMesh(
            LINE_N0, LINE_N0, quadrilateral=True),
            size if size is not None else LINE_LEVELS)
        h = fd.ExtrudedMeshHierarchy(bh, height=LINE_HEIGHT,
                                     layers=LINE_LAYERS)
        return _slab_problem(fd, h[-1], 1, LINE_SP)
    if label == "gridline_p1_cube_16":
        mesh = fd.MeshHierarchy(fd.UnitCubeMesh(4, 4, 4), 2)[-1]
        return _sin_problem(fd, fd.FunctionSpace(mesh, "CG", 1),
                            GRIDLINE_SP)
    if label == "extruded_star_q2_ext_6":
        mesh = fd.ExtrudedMesh(fd.UnitSquareMesh(8, 8, quadrilateral=True),
                               6)
        return _slab_problem(fd, mesh, 2, STAR_SP)
    if label == "npc_patch_bratu_64":
        return _bratu_problem(fd, fd.UnitSquareMesh(64, 64), 1, NPC_SP)
    if label == "pfas_bratu_p4_8":
        return _bratu_problem(fd, fd.UnitSquareMesh(8, 8), 4, PFAS_SP)
    if label == "facet_split_p4_32":
        mesh = fd.UnitSquareMesh(32, 32)
        V = fd.FunctionSpace(mesh, "CG", 4)
        u, v = fd.TrialFunction(V), fd.TestFunction(V)
        x, y = fd.SpatialCoordinate(mesh)
        a = fd.inner(fd.grad(u), fd.grad(v)) * fd.dx
        L = (x - y) * v * fd.dx
        bcs = [fd.DirichletBC(V, 0.0, "on_boundary")]
        uh = fd.Function(V)
        solver = fd.LinearVariationalSolver(
            fd.LinearVariationalProblem(a, L, uh, bcs=bcs),
            solver_parameters=FACET_SP)
        return dict(V=V, a=a, L=L, bcs=bcs, uh=uh, solver=solver,
                    exact=None)
    if label == "linesmooth_cap_129":
        mesh = fd.ExtrudedMesh(fd.UnitSquareMesh(2, 2, quadrilateral=True),
                               CAP_LAYERS)
        return _slab_problem(fd, mesh, 1, {
            "ksp_type": "cg", "pc_type": "linesmooth",
            "pc_linesmooth_codims": "2"})
    raise KeyError(label)


def _counts_of(solver):
    """(iterations, converged, linear iterations per Newton step) of a
    linear or nonlinear solver."""
    its = getattr(solver, "snes_iterations", None)
    if its is None:
        its = solver.ksp_iterations
    hist = [h["ksp_iterations"] for h in getattr(solver, "history", ())]
    return its, solver.converged, hist


def _ml_stage_line(label, setup_s, total_s, st, its):
    ms = st.ms()
    parts = " ".join(f"{k} {v[0] / 1e3:.3f}" for k, v in ms.items())
    other = total_s - sum(v[0] for v in ms.values()) / 1e3
    solve = ms["solve"][0] if "solve" in ms else 1e3 * total_s
    print(f"{label} stages (s): host_setup {setup_s:.3f} total_solve "
          f"{total_s:.3f} exclusive {parts} other {other:.3f}; calls "
          + " ".join(f"{k} {v[2]}" for k, v in ms.items())
          + f"; ms_per_iteration {solve / max(its, 1):.4f}")
    return ms


def _pmg_fdm_run(fd, label):
    """pmg_p4_256 or fdm_q4_256 on the card: iterations against the CPU
    rehearsal, ||b - A u|| / ||b||, errornorm against ML_ERR; pmg: K1
    launched on the P2 and P1 levels, held to its plain version on their
    inputs."""
    torch.cuda.reset_peak_memory_stats()
    p, setup_s = _sync_time(lambda: _ml_problem(fd, label))
    solver, uh = p["solver"], p["uh"]
    with _Counts() as counts, _EventStages(ML_STAGES) as st, \
            _K1Inputs() as k1_inputs:
        _, solve_s = _sync_time(solver.solve)
    its = solver.ksp_iterations
    _ml_stage_line(label, setup_s, solve_s, st, its)
    rel = _rel_residual(fd, p["a"], p["L"], p["bcs"], uh)
    err = fd.errornorm(p["exact"], uh)
    want, bound = CPU_REHEARSAL_ITS.get(label), ML_ERR[label]
    print(f"{label}: dofs {p['V'].dim} iterations {its} (CPU rehearsal "
          f"{want}) converged {solver.converged} rel_residual {rel:.3e} "
          f"errornorm {err:.6e} (bound {bound:.4e}) device_peak "
          f"{torch.cuda.max_memory_allocated()} on {uh.dat.device} "
          f"k1_launches {counts.k1} k1_by_variant {counts.k1_by_variant} "
          f"k2_launches {counts.k2} lowerer_evals {counts.lowerer}")
    if not uh.dat.is_cuda:
        raise AssertionError(f"{label}: solution is not on the card")
    if want is None or not (solver.converged and abs(its - want) <= 1):
        raise AssertionError(f"{label}: {its} iterations, the CPU "
                             f"rehearsal took {want}")
    if not rel <= 1e-10:
        raise AssertionError(f"{label}: relative residual {rel}")
    if bound is None or not err < bound:
        raise AssertionError(f"{label}: errornorm {err}, bound {bound}")
    if label == "fdm_q4_256":
        if its >= 60:
            raise AssertionError(f"{label}: {its} iterations")
    else:
        if counts.k1 <= 0:
            raise AssertionError(f"{label}: K1 did not launch")
        k1_inputs.check(label, counts.k1)
    del p, solver, uh, st
    _release(label)
    return counts, None


def _line_run(fd, label):
    """linesmooth_q1_ext_128 on the card: K2's large variant on every
    smoothed level's 65-dof columns, held to its plain version on the
    finest level's (16,641, 65, 65) patch matrices and timed there;
    iterations against the CPU rehearsal, ||b - A u|| / ||b|| <= 1e-8."""
    torch.cuda.reset_peak_memory_stats()
    p, setup_s = _sync_time(lambda: _ml_problem(fd, label))
    solver, uh = p["solver"], p["uh"]
    nbase = (LINE_N0 * 2 ** LINE_LEVELS + 1) ** 2
    with _Counts() as counts, _EventStages(
            ML_STAGES, keep={"k2": lambda a: a[0].shape[0] == nbase}) as st:
        _, solve_s = _sync_time(solver.solve)
    its = solver.ksp_iterations
    _ml_stage_line(label, setup_s, solve_s, st, its)
    rel = _rel_residual(fd, p["a"], p["L"], p["bcs"], uh)
    want = CPU_REHEARSAL_ITS.get(label)
    print(f"{label}: dofs {p['V'].dim} iterations {its} (CPU rehearsal "
          f"{want}) converged {solver.converged} rel_residual {rel:.3e} "
          f"max u {float(uh.dat.max())!r} device_peak "
          f"{torch.cuda.max_memory_allocated()} on {uh.dat.device} "
          f"k1_launches {counts.k1} k2_launches {counts.k2} k2_large "
          f"{counts.k2_large} lowerer_evals {counts.lowerer}")
    if not uh.dat.is_cuda:
        raise AssertionError(f"{label}: solution is not on the card")
    if want is None or not (solver.converged and abs(its - want) <= 1):
        raise AssertionError(f"{label}: {its} iterations, the CPU "
                             f"rehearsal took {want}")
    if not rel <= 1e-8:
        raise AssertionError(f"{label}: relative residual {rel}")
    Ap = st.first_args.get("k2", (None,))[0]
    if counts.k2_large != LINE_LEVELS or Ap is None \
            or tuple(Ap.shape) != (nbase, LINE_LAYERS + 1, LINE_LAYERS + 1):
        raise AssertionError(
            f"{label}: K2 large {counts.k2_large} launches (one per "
            f"smoothed level, {LINE_LEVELS}), finest patches "
            f"{None if Ap is None else tuple(Ap.shape)}")
    del p, solver, uh
    row = _k2_path_row(f"{label} line patches", Ap)
    del st, Ap
    _release(label)
    return counts, row


def _fas_run(fd, label):
    """fas_bratu_p1_1024 on the card, its stage times; then Newton + CG +
    GMG on the same mesh on the card: max|u_fas - u_newton| <= FAS_ATOL,
    cycles at most 3 above the CPU rehearsal's at 64^2."""
    torch.cuda.reset_peak_memory_stats()
    p, setup_s = _sync_time(lambda: _ml_problem(fd, label))
    solver = p["solver"]
    with _Counts() as counts, _EventStages(FAS_STAGES) as st:
        _, solve_s = _sync_time(solver.solve)
    cycles = solver.snes_iterations
    ms = _ml_stage_line(label, setup_s, solve_s, st, cycles)
    peak = torch.cuda.max_memory_allocated()
    q, newton_setup_s = _sync_time(lambda: _ml_problem(fd, "bratu_newton"))
    with _Counts() as ncounts:
        _, newton_s = _sync_time(q["solver"].solve)
    u, un = p["uh"].dat, q["uh"].dat
    diff = float((u - un).abs().max())
    want = CPU_REHEARSAL_ITS.get(label)
    print(f"{label}: dofs {p['V'].dim} levels {FAS_LEVELS + 1} cycles "
          f"{cycles} (CPU rehearsal at 64^2 {want}) converged "
          f"{solver.converged} ms_per_cycle "
          f"{1e3 * solve_s / max(cycles, 1):.3f}"
          f" residual_evals {ms['residual'][2]} diagonal_evals "
          f"{ms['diagonal'][2]} max u {float(u.max())!r} device_peak {peak} "
          f"on {u.device} k1_launches {counts.k1} k2_launches {counts.k2} "
          f"lowerer_evals {counts.lowerer}; Newton + GMG: setup_s "
          f"{newton_setup_s:.3f} solve_s {newton_s:.3f} newton_steps "
          f"{q['solver'].snes_iterations} converged {q['solver'].converged}"
          f" k1_launches {ncounts.k1} lowerer_evals {ncounts.lowerer}; "
          f"max|u_fas - u_newton| {diff:.3e} (bound {FAS_ATOL})")
    if not u.is_cuda:
        raise AssertionError(f"{label}: solution is not on the card")
    if not (solver.converged and q["solver"].converged):
        raise AssertionError(f"{label}: FAS or Newton did not converge")
    if want is None or cycles > want + 3:
        raise AssertionError(f"{label}: {cycles} cycles, the CPU "
                             f"rehearsal at 64^2 took {want}")
    if not diff <= FAS_ATOL:
        raise AssertionError(f"{label}: FAS {diff} from Newton")
    # the Newton reference's launches are printed above and not counted
    # as the FAS path's
    del p, q, solver, u, un, st
    _release(label)
    return counts, None


def _small_ml_run(fd, label):
    """One small case on the card, then on the CPU in this process:
    within 1e-10 max|u|, equal counts; its kernel launches."""
    keep = {"k2": lambda a: a[0].shape[-1] > 32}
    p, setup_s = _sync_time(lambda: _ml_problem(fd, label))
    stages = {"npc_patch_bratu_64": NPC_STAGES,
              "pfas_bratu_p4_8": FAS_STAGES}.get(label, ML_STAGES)
    with _Counts() as counts, _EventStages(stages, keep=keep) as st:
        _, solve_s = _sync_time(p["solver"].solve)
    its, conv, hist = _counts_of(p["solver"])
    _ml_stage_line(label, setup_s, solve_s, st, its)
    u = p["uh"].dat
    fd.set_device("cpu")
    t0 = time.perf_counter()
    try:
        q = _ml_problem(fd, label)
        q["solver"].solve()
    finally:
        fd.set_device(torch.device("cuda"))
    cpu_s = time.perf_counter() - t0
    cits, cconv, chist = _counts_of(q["solver"])
    ref = q["uh"].dat
    diff = float((u.cpu() - ref).abs().max()) / float(ref.abs().max())
    extra = ""
    if label == "facet_split_p4_32":
        # the exact Schur factorization against the host LU solve
        r = _ml_problem(fd, label)
        r["solver"].params.update(ksp_type="preonly", pc_type="lu")
        r["solver"].solve()
        lu_diff = float((u - r["uh"].dat).abs().max()) / float(
            r["uh"].dat.abs().max())
        extra = f" card_vs_lu {lu_diff:.3e}"
        if not lu_diff <= 1e-8:
            raise AssertionError(f"{label}: {lu_diff} from the LU solve")
    print(f"{label}: dofs {p['V'].dim} iterations {its} {hist} converged "
          f"{conv} (this process's CPU solve {cits} {chist} {cconv}, "
          f"{cpu_s:.1f} s) "
          f"card_vs_cpu {diff:.3e}{extra} on {u.device} k1_launches "
          f"{counts.k1} k2_launches {counts.k2} k2_large {counts.k2_large} "
          f"lowerer_evals {counts.lowerer}")
    if not u.is_cuda:
        raise AssertionError(f"{label}: solution is not on the card")
    if not (conv and cconv and (its, hist) == (cits, chist)
            and diff <= 1e-10):
        raise AssertionError(f"{label}: card {its} {conv}, CPU {cits} "
                             f"{cconv}, {diff} apart")
    want_k2 = {"gridline_p1_cube_16": 2, "extruded_star_q2_ext_6": 1}
    if label in want_k2 and counts.k2 != want_k2[label]:
        raise AssertionError(f"{label}: K2 launched {counts.k2} times")
    if label == "npc_patch_bratu_64" and counts.k2 <= 0:
        raise AssertionError(f"{label}: K2 did not launch")
    row = None
    if label == "extruded_star_q2_ext_6":
        Ap = st.first_args.get("k2", (None,))[0]
        if counts.k2_large != 1 or Ap is None:
            raise AssertionError(f"{label}: K2 large {counts.k2_large}")
        row = _k2_path_row(f"{label} star patches", Ap)
    del p, q, st
    _release(label)
    return counts, row


def multilevel_phase():
    """pmg_p4_256, fas_bratu_p1_1024, linesmooth_q1_ext_128, fdm_q4_256
    and the small cases against the CPU."""
    t0 = phase("multilevel")
    import firedrake_tpu_torch as fd
    fd.set_device(torch.device("cuda"))
    used, rows, failed = {}, {}, []
    runs = [("pmg_p4_256", _pmg_fdm_run), ("fas_bratu_p1_1024", _fas_run),
            ("linesmooth_q1_ext_128", _line_run),
            ("fdm_q4_256", _pmg_fdm_run)] \
        + [(label, _small_ml_run) for label in SMALL_ML]
    for label, run in runs:
        t1 = time.perf_counter()
        try:
            used[label], rows[label] = run(fd, label)
        except AssertionError as exc:
            # the later cases still run and print; the phase fails below
            failed.append(f"{label}: {exc}")
            _release(label)
        print(f"{label}: case_s {time.perf_counter() - t1:.1f}", flush=True)
    if failed:
        raise AssertionError("multilevel phase: " + "; ".join(failed))
    phase_done("multilevel", t0)
    return used, {k: v for k, v in rows.items() if v is not None}


def ml_rounding():
    """Where pmg_p4_256's and fdm_q4_256's errornorms come from.  Each is
    solved on the card and on the host's CPU, and compared on the host:
    the assembled b and A, u, the errornorm of the card's u evaluated on
    the host, the true residual ||b - A u|| / ||b|| taken in long double
    beside its f64 rounding floor eps || |A| |u| || / ||b||, and the
    errornorm after two steps of iterative refinement against the CPU's
    A and b, their residuals taken in long double and the corrections
    solved on the card by the case's own solver (rtol 1e-8).  Prints
    only; gates nothing."""
    t0 = phase("ml_rounding")
    import firedrake_tpu_torch as fd
    from firedrake_tpu_torch.solvers.composition import OpCtx, build_pc
    from firedrake_tpu_torch.solving import _run_ksp
    ld, eps = np.longdouble, np.finfo(np.float64).eps
    for label in ("pmg_p4_256", "fdm_q4_256"):
        t1 = time.perf_counter()
        fd.set_device(torch.device("cuda"))
        p = _ml_problem(fd, label)
        p["solver"].solve()
        card_its = p["solver"].ksp_iterations
        card_err = fd.errornorm(p["exact"], p["uh"])
        u_card = p["uh"].dat.cpu().numpy()
        A_card = fd.assemble(p["a"], bcs=p["bcs"])
        b_card = fd.assemble(p["L"], bcs=p["bcs"]).dat.cpu().numpy()
        params = p["solver"].params
        pc = build_pc(OpCtx(mat=A_card, space=p["V"], form=p["a"],
                            bcs=p["bcs"]), params)
        fd.set_device("cpu")
        q = _ml_problem(fd, label)
        q["solver"].solve()
        cpu_its = q["solver"].ksp_iterations
        cpu_err = fd.errornorm(q["exact"], q["uh"])
        u_cpu = q["uh"].dat.numpy().copy()
        A = fd.assemble(q["a"], bcs=q["bcs"]).to_scipy().tocsr()
        b = fd.assemble(q["L"], bcs=q["bcs"]).dat.numpy()
        dA = abs(A_card.to_scipy().tocsr() - A).max() / abs(A).max()
        db = np.abs(b_card - b).max() / np.abs(b).max()
        A_ld, b_ld = A.astype(ld), b.astype(ld)
        absA = abs(A)
        nb = np.linalg.norm(b_ld)

        def host_err(u):
            q["uh"].dat = torch.as_tensor(u)
            return fd.errornorm(q["exact"], q["uh"])

        def residual(u):
            r = b_ld - A_ld @ u.astype(ld)
            floor = eps * np.linalg.norm(absA @ np.abs(u)) / float(nb)
            return r, float(np.linalg.norm(r) / nb), floor

        def refine(u):
            r = residual(u)[0]
            res = _run_ksp(A_card.matvec, torch.as_tensor(
                r.astype(np.float64), device="cuda"),
                dict(params, ksp_rtol=1e-8), pc=pc)
            return (u.astype(ld) + res.x.cpu().numpy().astype(ld)).astype(
                np.float64), res.iterations

        line = (f"ml_rounding {label}: dofs {p['V'].dim} iterations card "
                f"{card_its} cpu {cpu_its}; max|b_card - b_cpu| / max|b| "
                f"{db:.3e} max|A_card - A_cpu| / max|A| {dA:.3e} "
                f"max|u_card - u_cpu| {np.abs(u_card - u_cpu).max():.3e}; "
                f"errornorm card {card_err!r} (the card's u on the host "
                f"{host_err(u_card)!r}) cpu {cpu_err!r}")
        refined = {}
        for name, u in (("card", u_card), ("cpu", u_cpu)):
            _, rel, floor = residual(u)
            line += (f"; {name}: long-double residual {rel:.3e} (f64 "
                     f"floor {floor:.3e})")
            for step in (1, 2):
                u, kits = refine(u)
                line += (f", refined {step} ({kits} its) errornorm "
                         f"{host_err(u)!r} residual {residual(u)[1]:.3e}")
            refined[name] = u
        line += (f"; refined max|u_card - u_cpu| "
                 f"{np.abs(refined['card'] - refined['cpu']).max():.3e} "
                 f"seconds {time.perf_counter() - t1:.1f}")
        print(line, flush=True)
        del p, q, pc, A_card, A, A_ld
        _release(label)
    fd.set_device(torch.device("cuda"))
    phase_done("ml_rounding", t0)


def multilevel_cpu(labels, tag, study=False):
    """The multilevel cases on the CPU: at the card's size (the counts the
    card must match; fas_bratu_p1_1024 at 64^2) or, with `study`, at the
    sizes of ML_STUDY (the errornorms and their ratios)."""
    import firedrake_tpu_torch as fd
    fd.set_device("cpu")
    for label in labels:
        if study:
            sizes = ML_STUDY.get(label, ())
        else:
            sizes = (FAS_REHEARSAL_LEVELS if label == "fas_bratu_p1_1024"
                     else None,)
        prev = None
        for size in sizes:
            t0 = time.perf_counter()
            p = _ml_problem(fd, label, size)
            p["solver"].solve()
            its, conv, _ = _counts_of(p["solver"])
            err = ("" if p.get("exact") is None else
                   fd.errornorm(p["exact"], p["uh"]))
            line = (f"{tag} {label} size {size}: dofs {p['V'].dim} "
                    f"iterations {its} converged {conv}")
            if err != "":
                line += f" errornorm {err!r}"
                if prev is not None:
                    line += f" ratio {prev / err:.3f}"
                prev = err
            if "a" in p:
                rel = _rel_residual(fd, p["a"], p["L"], p["bcs"], p["uh"])
                line += f" rel_residual {rel:.3e}"
            print(f"{line} max u {float(p['uh'].dat.max())!r} seconds "
                  f"{time.perf_counter() - t0:.1f} host_max_rss_gib "
                  f"{_max_rss_gib():.2f}", flush=True)


# ------------------------------------------------- BDDC, deflation, eigen
# bddc_p1_1024: -lap u = 2 pi^2 sin(pi x) sin(pi y), u = 0 on the
# boundary, P1 on UnitSquareMesh(1024) (1,050,625 dofs), CG at rtol 1e-10
# with BDDCPC at its default subdomain count (clip(ncells // 64, 4, 512) =
# 512 Morton chunks of 4,096 cells, 2,145 dofs each): K2's huge variant
# inverts the interior blocks M_int (512, 2145, 2145), the saddle systems
# K (512, 2153, 2153, pivoted) and S_Pi (1, 1441, 1441).  Its nodal error
# is held to the P1 GMG bound.
DDM_N = 1024
BDDC_SP = {"ksp_type": "cg", "ksp_rtol": 1e-10, "pc_type": "python",
           "pc_python_type": "firedrake.BDDCPC"}
BDDC_ERR = 5e-5
# CG iterations predicted before the first card run (7 at 128^2 and 9
# at 256^2 with the same 512 subdomains on the CPU: ~2 per doubling of
# H/h)
BDDC_PREDICTED_ITS = 13
# K2's huge variant timed on this many of the path's own M_int and K blocks
HUGE_TIMED_BLOCKS = 64
# eigen_p1_512: tests/regression/test_aux_components.py:47-57 (the
# Dirichlet Laplacian with the consistent mass, the 4 smallest
# eigenvalues) at UnitSquareMesh(EIGEN_N), the default backend (host
# ARPACK on the matrices assembled on the card).  512^2, not DDM_N: at
# 1024^2 the case took 65-80 s, all but ~3 s of it host ARPACK, no card
# work.  Bounds: twice the P1 errors extrapolated from the CPU study
# (python3 chip_smoke.py --cpu-study eigen_p1_512: n = 64, 128, 256) to
# n = EIGEN_N at the last ratio.
EIGEN_N = 512
EIGEN_K = 4
EIGEN_EXACT = tuple(np.pi ** 2 * np.array([2.0, 5.0, 5.0, 8.0]))
EIGEN_STUDY = (64, 128, 256)
# the study's errors at 256^2: 7.431774e-4, 3.195020e-3, 4.980035e-3,
# 1.189033e-2, ratios 4.0001, 4.0000, 4.0004, 3.9996; extrapolated to
# 512^2: 1.8579e-4, 7.9875e-4, 1.2449e-3, 2.9729e-3
EIGEN_ERR = (3.7158e-4, 1.5975e-3, 2.4898e-3, 5.9458e-3)
# deflation_bratu_p1_1024: Bratu, -lap u = 2 exp(u), u = 0 on the
# boundary, P1 on gmg_p1_1m's hierarchy (UnitSquareMesh(32) + 5 levels),
# Newton with backtracking, Deflation() and GMRES + GMG at ksp_rtol 1e-8
# (the upper root's Jacobian is indefinite), from u0 = 3 * 16 x (1 - x)
# y (1 - y) twice: the upper root first, then the lower one.
DEFL_GUESS = 3.0
DEFL_SP = {"snes_rtol": 1e-10, "snes_max_it": 60,
           "snes_linesearch_type": "bt", "ksp_type": "gmres",
           "ksp_rtol": 1e-8, "ksp_max_it": 300, "pc_type": "mg"}
# the CPU rehearsal at 512^2 (one level fewer; python3 chip_smoke.py
# --cpu-rehearsal deflation_bratu_p1_1024, a few minutes): Newton steps
# per root and GMRES iterations per step; the card's Newton steps equal,
# its GMRES iterations within 2% in all (128^2 and 256^2 give the same
# Newton steps; the GMRES total was 128 at 128^2, 130 at 512^2)
DEFL_LEVELS, DEFL_REHEARSAL_LEVELS = 5, 4
DEFL_REHEARSAL = ((5, 19), ([5, 6, 7, 7, 7], [5] * 16 + [6, 6, 6]))
# Small cases, each held to the same solve on the CPU in this process
# (within 1e-10, equal counts): BDDC on P2 Poisson at 16^2 with 16
# subdomains, vector P1 elasticity at 16^2 with 9 (clamped on x = 0,
# gravity), P1 on UnitCubeMesh(6) with 8; the LOBPCG backend on the
# 12^2 problem of test_aux_components.py:92-107; the line smoother on 128
# layers (129-dof lines, K2's huge variant).
SMALL_DDM = ("bddc_p2_16", "bddc_elasticity_16", "bddc_p1_cube_6",
             "lobpcg_p1_12", "linesmooth_cap_129")


def _bddc_small(fd, label):
    sp = dict(BDDC_SP)
    if label == "bddc_elasticity_16":
        mesh = fd.UnitSquareMesh(16, 16)
        V = fd.VectorFunctionSpace(mesh, "CG", 1)
        u, v = fd.TrialFunction(V), fd.TestFunction(V)

        def eps(w):
            return fd.sym(fd.grad(w))

        a = (2.0 * fd.inner(eps(u), eps(v))
             + fd.inner(fd.div(u), fd.div(v))) * fd.dx
        L = fd.inner(fd.Constant((0.0, -1.0)), v) * fd.dx
        bcs = [fd.DirichletBC(V, fd.Constant((0.0, 0.0)), 1)]
        uh = fd.Function(V)
        solver = fd.LinearVariationalSolver(
            fd.LinearVariationalProblem(a, L, uh, bcs=bcs),
            solver_parameters=dict(sp, bddc_subdomains=9))
        return dict(V=V, a=a, L=L, bcs=bcs, uh=uh, solver=solver,
                    exact=None)
    if label == "bddc_p2_16":
        V = fd.FunctionSpace(fd.UnitSquareMesh(16, 16), "CG", 2)
        return _sin_problem(fd, V, dict(sp, bddc_subdomains=16))
    V = fd.FunctionSpace(fd.UnitCubeMesh(6, 6, 6), "CG", 1)
    return _sin_problem(fd, V, dict(sp, bddc_subdomains=8))


def _eigen_problem(fd, n, params=None, k=EIGEN_K):
    V = fd.FunctionSpace(fd.UnitSquareMesh(n, n), "CG", 1)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    ep = fd.LinearEigenproblem(
        fd.inner(fd.grad(u), fd.grad(v)) * fd.dx, fd.inner(u, v) * fd.dx,
        bcs=[fd.DirichletBC(V, 0.0, "on_boundary")])
    return V, fd.LinearEigensolver(ep, n_evals=k, solver_parameters=params)


class _LobpcgRun:
    """lobpcg_p1_12 (test_aux_components.py:92-107) as a solver: after
    solve(), the LOBPCG iterations, whether it stopped before
    eps_max_it, and the 4 eigenvalues."""

    def __init__(self, fd):
        self.V, self.es = _eigen_problem(fd, 12, {
            "eps_backend": "lobpcg", "eps_which": "SM", "eps_max_it": 400})

    def solve(self):
        from firedrake_tpu_torch import eigensolver
        its = []
        run = eigensolver.lobpcg_standard

        def counted(*a, **kw):
            out = run(*a, **kw)
            its.append(out[2])
            return out
        eigensolver.lobpcg_standard = counted
        try:
            self.es.solve()
        finally:
            eigensolver.lobpcg_standard = run
        self.ksp_iterations, self.converged = its[0], its[0] < 400
        self.values = torch.as_tensor(np.array(
            [self.es.eigenvalue(i) for i in range(EIGEN_K)]))


def _ddm_problem(fd, label):
    if label.startswith("bddc_"):
        return _bddc_small(fd, label)
    if label == "lobpcg_p1_12":
        run = _LobpcgRun(fd)
        return dict(V=run.V, uh=None, solver=run)
    if label == "linesmooth_cap_129":
        p = _ml_problem(fd, label)
        p["solver"].params.update(ksp_rtol=1e-10)
        return p
    raise KeyError(label)


def _deflation_problem(fd, levels=DEFL_LEVELS):
    mesh = fd.MeshHierarchy(fd.UnitSquareMesh(32, 32), levels)[-1]
    V = fd.FunctionSpace(mesh, "CG", 1)
    X = fd.SpatialCoordinate(mesh)
    u, v = fd.Function(V), fd.TestFunction(V)
    F = (fd.inner(fd.grad(u), fd.grad(v)) - 2.0 * fd.exp(u) * v) * fd.dx
    deflation = fd.Deflation()
    solver = fd.NonlinearVariationalSolver(
        fd.NonlinearVariationalProblem(
            F, u, bcs=[fd.DirichletBC(V, 0.0, "on_boundary")]),
        solver_parameters=DEFL_SP, appctx={"deflation": deflation})
    guess = fd.Function(V).interpolate(
        DEFL_GUESS * 16 * X[0] * (1 - X[0]) * X[1] * (1 - X[1]))
    return dict(V=V, uh=u, solver=solver, deflation=deflation, guess=guess)


def _deflation_roots(fd, p, around=contextlib.nullcontext):
    """Both deflated solves from the one guess: per root (Newton steps,
    [(|F|, GMRES iterations, tau) per step], max u, seconds)."""
    out = []
    for _ in range(2):
        p["uh"].dat = p["guess"].dat.clone()
        cuda = p["uh"].dat.is_cuda
        with around():
            t0 = time.perf_counter()
            p["solver"].solve()
            if cuda:
                torch.cuda.synchronize()
            s = time.perf_counter() - t0
        sv = p["solver"]
        if not sv.converged:
            raise AssertionError(f"deflated Newton did not converge "
                                 f"after {sv.snes_iterations} steps")
        out.append((sv.snes_iterations,
                    [(h["rnorm"], h["ksp_iterations"], h["tau"])
                     for h in sv.history], float(p["uh"].dat.max()), s))
    return out


class _K2Calls:
    """Each batched_inv call while entered: its shape, pivot flag and
    CUDA-event milliseconds; copies of the first `keep` blocks of the
    first unpivoted and the first pivoted call with n > 128 (the path's
    M_int and K, which the PC frees after use)."""

    def __init__(self, keep):
        self.keep, self.calls, self.blocks = keep, [], {}

    def __enter__(self):
        from firedrake_tpu_torch.ops import batched_inverse as BI
        self.BI, self.run = BI, BI.batched_inv

        def timed(A, pivot=False):
            n = A.shape[-1]
            if n > BI.LARGE_N and bool(pivot) not in self.blocks:
                self.blocks[bool(pivot)] = A[:self.keep].clone()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = self.run(A, pivot)
            e.record()
            self.calls.append((tuple(A.shape), bool(pivot), s, e))
            return out
        BI.batched_inv = timed
        return self

    def __exit__(self, *exc):
        self.BI.batched_inv = self.run

    def lines(self):
        torch.cuda.synchronize()
        return [f"{shape} pivot={piv} {s.elapsed_time(e):.1f} ms"
                for shape, piv, s, e in self.calls]


BDDC_STAGES = (
    ("host_tables", _TP + "solvers.bddc", "_host_tables"),
    ("local_tensors", _TP + "slate", "_local_form_tensor"),
    ("pc_setup", _TP + "solving", "build_pc"),
    ("assembly", _TP + "solving", "assemble"),
    ("solve", _TP + "solving", "_run_ksp"))


def _huge_row(BI, label, A, pivot):
    """K2's huge variant on a path's own blocks: held to its plain version
    by huge_gate, timed (device time of one call, call time) beside the
    plain version, torch.linalg.inv and the bound."""
    nb, n = A.shape[0], A.shape[-1]
    # the plain version once (~13.5 s at 64 blocks); the kernel's 2
    # ceil(n / w) (+ 2 pivoted) launches per call fit the card's launch
    # queue, so _device_ms queues three calls while the card sleeps
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    plain = BI.batched_inv_plain(A, pivot=pivot)
    e.record()
    torch.cuda.synchronize()
    plain_ms = s.elapsed_time(e)
    # the kernels launched per call, as the library counts them
    k0, h0 = BI.huge_kernels, BI.huge_launches
    d1 = _device_ms(lambda: BI.batched_inv(A, pivot=pivot), reps=3)
    c1 = _cuda_ms(lambda: BI.batched_inv(A, pivot=pivot), 3)
    lib1 = _cuda_ms(lambda: torch.linalg.inv(A), 1, 1)
    d2 = _device_ms(lambda: BI.batched_inv(A, pivot=pivot), reps=3)
    c2 = _cuda_ms(lambda: BI.batched_inv(A, pivot=pivot), 3)
    lib2 = _cuda_ms(lambda: torch.linalg.inv(A), 1, 1)
    calls, kernels = BI.huge_launches - h0, BI.huge_kernels - k0
    if calls <= 0 or kernels % calls:
        raise AssertionError(f"K2 huge {label}: {kernels} kernels in "
                             f"{calls} calls")
    g = huge_gate(A, BI.batched_inv(A, pivot=pivot), plain,
                  torch.linalg.inv(A))
    del plain
    bytes_ms = 1e3 * 2 * A.numel() * A.element_size() / HBM_BYTES_PER_S
    ops_ms = 1e3 * 2 * n ** 3 * nb / PEAK_FLOPS
    row = dict(shape=list(A.shape), dtype=str(A.dtype)[6:], pivot=pivot,
               w=BI.huge_report["w"], sub_panel=BI.huge_report["b"],
               sub_panel_in=BI.huge_report["sub_panel"],
               launches_per_call=kernels // calls, calls_counted=calls,
               ms=(d1 + d2) / 2, call_ms=(c1 + c2) / 2, plain_ms=plain_ms,
               library_ms=(lib1 + lib2) / 2,
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               bytes_bound_ms=bytes_ms, max_abs_err=g["dist"],
               lib_dist=g["lib_dist"], dist_limit=g["limit"],
               residual=g["res"], lib_residual=g["lib_res"],
               plain_residual=g["plain_res"],
               runs=[d1, d2, c1, c2, lib1, lib2])
    print(f"K2 huge {label:24s} shape {tuple(A.shape)} pivot {pivot} w "
          f"{row['w']} b {row['sub_panel']} ({row['sub_panel_in']} memory) "
          f"launches_per_call {row['launches_per_call']} (counted over "
          f"{calls} calls) device "
          f"{row['ms']:.3f} ms call {row['call_ms']:.3f} ms plain "
          f"{plain_ms:.1f} ms torch.linalg.inv {row['library_ms']:.2f} ms "
          f"(runs device/device/call/call/lib/lib "
          + "/".join(f"{x:.3f}" for x in row["runs"])
          + f") bound {row['bound_ms']:.3f} ms ({row['bound_by']}; bytes "
          f"{bytes_ms:.3f} ms) share {row['bound_ms'] / row['ms']:.4f}; "
          + _gate_text(g), flush=True)
    if not g["ok"]:
        raise AssertionError(f"K2 huge {label}: outside its gate")
    return row


def bddc_run(fd, label="bddc_p1_1024"):
    """bddc_p1_1024 on the card: stage times, K2's launches by variant,
    the path's blocks against the plain version, then the huge variant
    timed on HUGE_TIMED_BLOCKS of them."""
    from firedrake_tpu_torch.ops import batched_inverse as BI
    torch.cuda.reset_peak_memory_stats()
    p, setup_s = _sync_time(lambda: _sin_problem(
        fd, fd.FunctionSpace(fd.UnitSquareMesh(DDM_N, DDM_N), "CG", 1),
        BDDC_SP))
    solver, uh = p["solver"], p["uh"]
    with _Counts() as counts, _EventStages(
            BDDC_STAGES, keep={n: (lambda a: False)
                               for n, _, _ in BDDC_STAGES}) as st, \
            _K2Calls(HUGE_TIMED_BLOCKS) as k2:
        _, solve_s = _sync_time(solver.solve)
    its = solver.ksp_iterations
    peak = torch.cuda.max_memory_allocated()
    ms = st.ms()
    pc_ms = ms["pc_setup"][1]
    solve_ms = ms["solve"][0]
    rel = _rel_residual(fd, p["a"], p["L"], p["bcs"], uh)
    err = float((uh.dat - fd.Function(p["V"]).interpolate(
        p["exact"]).dat).abs().max())
    print(f"{label} stages (s): host_setup {setup_s:.3f} total_solve "
          f"{solve_s:.3f} host_tables {ms['host_tables'][1] / 1e3:.3f} "
          f"local_tensors {ms['local_tensors'][1] / 1e3:.3f} "
          f"operator_assembly {ms['assembly'][1] / 1e3:.3f} pc_setup "
          f"{pc_ms / 1e3:.3f} (K2 calls: " + "; ".join(k2.lines())
          + f") cg {solve_ms / 1e3:.3f}; ms_per_iteration "
          f"{solve_ms / max(its, 1):.3f}")
    print(f"{label}: dofs {p['V'].dim} subdomains {k2.calls[0][0][0]} "
          f"iterations {its} (predicted {BDDC_PREDICTED_ITS}) converged "
          f"{solver.converged} rel_residual {rel:.3e} max_nodal_err "
          f"{err:.3e} (bound {BDDC_ERR}) device_peak {peak} "
          f"({peak / 2 ** 30:.2f} GiB) on {uh.dat.device} k1_launches "
          f"{counts.k1} k2_launches {counts.k2} k2_huge {counts.k2_huge} "
          f"k2_pivot {counts.k2_pivot} lowerer_evals {counts.lowerer}",
          flush=True)
    if not uh.dat.is_cuda:
        raise AssertionError(f"{label}: solution is not on the card")
    if not solver.converged or not rel <= 1e-10 or not err < BDDC_ERR:
        raise AssertionError(f"{label}: converged {solver.converged}, "
                             f"residual {rel}, nodal error {err}")
    if (counts.k2_huge, counts.k2_pivot) != (3, 1) or counts.k1 <= 0:
        raise AssertionError(f"{label}: K2 huge {counts.k2_huge} (3 "
                             f"expected), pivoted {counts.k2_pivot} (1), "
                             f"K1 {counts.k1}")
    del p, solver, uh, st
    _release(label)
    rows = {}
    for piv, name in ((False, "M_int"), (True, "K")):
        A = k2.blocks[piv]
        two = A[:2].contiguous()
        g = huge_gate(two, BI.batched_inv(two, pivot=piv),
                      BI.batched_inv_plain(two, pivot=piv),
                      torch.linalg.inv(two))
        print(f"{label}: K2 on the path's first two {name} blocks "
              f"{tuple(two.shape)} pivot {piv}: " + _gate_text(g))
        if not g["ok"]:
            raise AssertionError(f"{label}: K2 on {name} disagrees")
        rows[f"{label} {name}"] = _huge_row(BI, f"{label} {name}", A, piv)
        del A, two
        k2.blocks.pop(piv)
        torch.cuda.empty_cache()
    return counts, rows


def eigen_run(fd, label="eigen_p1_512"):
    """eigen_p1_512: the matrices assembled on the card, ARPACK on the
    host, each stage timed; the eigenvalues against pi^2 (i^2 + j^2)."""
    from firedrake_tpu_torch import eigensolver
    V, es = _eigen_problem(fd, EIGEN_N)
    stages = (("assembly", _TP + "eigensolver", "assemble"),)
    import scipy.sparse.linalg as spla
    eigsh = spla.eigsh
    host = []

    def timed_eigsh(*a, **kw):
        t0 = time.perf_counter()
        try:
            return eigsh(*a, **kw)
        finally:
            host.append(time.perf_counter() - t0)
    spla.eigsh = timed_eigsh
    try:
        with _Counts() as counts, _EventStages(
                stages, keep={"assembly": lambda a: False}) as st:
            _, total_s = _sync_time(es.solve)
    finally:
        spla.eigsh = eigsh
    ms = st.ms()
    vals = np.array([es.eigenvalue(i) for i in range(EIGEN_K)])
    errs = np.abs(vals - np.array(EIGEN_EXACT))
    print(f"{label}: dofs {V.dim} total_s {total_s:.3f} card assembly "
          f"{ms['assembly'][1] / 1e3:.3f} s ({ms['assembly'][2]} calls) "
          f"host ARPACK {sum(host):.3f} s eigenvalues "
          + " ".join(repr(float(x)) for x in vals) + " errors "
          + " ".join(f"{x:.4e}" for x in errs) + " bounds "
          + " ".join(str(b) for b in EIGEN_ERR)
          + f" k1_launches {counts.k1} lowerer_evals {counts.lowerer}",
          flush=True)
    if counts.k1 <= 0:
        raise AssertionError(f"{label}: the card's assembly bypassed K1")
    if any(b is None or not e < b for e, b in zip(errs, EIGEN_ERR)):
        raise AssertionError(f"{label}: errors {errs}, bounds {EIGEN_ERR}")
    del es
    _release(label)
    return counts, None


def deflation_run(fd, label="deflation_bratu_p1_1024"):
    """deflation_bratu_p1_1024: both roots from one guess on the card,
    per Newton step |F|, GMRES iterations and tau; gates: converged,
    ||u1 - u2||_L2 > 1, Newton steps equal to the CPU rehearsal's, GMRES
    iterations within 2% of it."""
    p, setup_s = _sync_time(lambda: _deflation_problem(fd))
    counts = _Counts()
    out = _deflation_roots(fd, p, around=lambda: counts)
    dist = fd.norm(p["deflation"].roots[0] - p["deflation"].roots[1])
    for r, (n, hist, umax, s) in enumerate(out):
        print(f"{label} root {r}: newton_steps {n} max u {umax!r} solve_s "
              f"{s:.3f} steps (|F|, gmres, tau) "
              + " ".join(f"({f:.3e}, {k}, {t:.4f})" for f, k, t in hist),
              flush=True)
    its = [n for n, *_ in out]
    gm = [[k for _, k, _ in h] for _, h, _, _ in out]
    want = DEFL_REHEARSAL
    print(f"{label}: dofs {p['V'].dim} setup_s {setup_s:.3f} newton_steps "
          f"{its} gmres {gm} (CPU rehearsal {want}) ||u1 - u2||_L2 "
          f"{dist:.6f} on {p['uh'].dat.device} k1_launches {counts.k1} "
          f"lowerer_evals {counts.lowerer}", flush=True)
    if not p["uh"].dat.is_cuda:
        raise AssertionError(f"{label}: solution is not on the card")
    if not dist > 1:
        raise AssertionError(f"{label}: the roots are {dist} apart")
    total, want_total = sum(map(sum, gm)), None
    if want is not None:
        want_total = sum(map(sum, want[1]))
    if want is None or its != list(want[0]) \
            or abs(total - want_total) > 0.02 * want_total:
        raise AssertionError(f"{label}: Newton {its}, GMRES {gm}; the CPU "
                             f"rehearsal {want}")
    del p
    _release(label)
    return counts, None


def _small_ddm_run(fd, label):
    """One small case on the card, then on the CPU in this process:
    within 1e-10 relative, equal counts; its kernel launches."""
    p, setup_s = _sync_time(lambda: _ddm_problem(fd, label))
    with _Counts() as counts:
        _, solve_s = _sync_time(p["solver"].solve)
    its, conv, _ = _counts_of(p["solver"])
    u = p["solver"].values if label == "lobpcg_p1_12" else p["uh"].dat
    fd.set_device("cpu")
    t0 = time.perf_counter()
    try:
        q = _ddm_problem(fd, label)
        q["solver"].solve()
    finally:
        fd.set_device(torch.device("cuda"))
    cpu_s = time.perf_counter() - t0
    cits, cconv, _ = _counts_of(q["solver"])
    ref = q["solver"].values if label == "lobpcg_p1_12" else q["uh"].dat
    diff = float((u.cpu() - ref).abs().max()) / float(ref.abs().max())
    print(f"{label}: dofs {p['V'].dim} iterations {its} converged {conv} "
          f"solve_s {solve_s:.3f} (this process's CPU solve {cits} "
          f"{cconv}, {cpu_s:.1f} s) card_vs_cpu {diff:.3e} k1_launches "
          f"{counts.k1} k2_launches {counts.k2} k2_large {counts.k2_large} "
          f"k2_huge {counts.k2_huge} k2_pivot {counts.k2_pivot}",
          flush=True)
    if label != "lobpcg_p1_12" and not p["uh"].dat.is_cuda:
        raise AssertionError(f"{label}: solution is not on the card")
    # LOBPCG stops when every residual is below 10 n eps (|A v| + theta),
    # at the rounding floor: its count moves with the rounding (85 on the
    # card and on one CPU host, 87 on another), so its gate is the
    # eigenvalues alone
    same_count = its == cits or label == "lobpcg_p1_12"
    if not (conv and cconv and same_count and diff <= 1e-10):
        raise AssertionError(f"{label}: card {its} {conv}, CPU {cits} "
                             f"{cconv}, {diff} apart")
    if label.startswith("bddc_") and (counts.k2 < 2 or counts.k2_pivot != 1):
        raise AssertionError(f"{label}: K2 {counts.k2} launches, "
                             f"{counts.k2_pivot} pivoted")
    if label == "linesmooth_cap_129" and counts.k2_huge != 1:
        raise AssertionError(f"{label}: K2 huge {counts.k2_huge}")
    del p, q
    _release(label)
    return counts, None


def ddm_phase():
    """bddc_p1_1024, eigen_p1_512, deflation_bratu_p1_1024 and the small
    cases against the CPU."""
    t0 = phase("ddm")
    import firedrake_tpu_torch as fd
    fd.set_device(torch.device("cuda"))
    used, rows, failed = {}, {}, []
    runs = [("bddc_p1_1024", bddc_run), ("eigen_p1_512", eigen_run),
            ("deflation_bratu_p1_1024", deflation_run)] \
        + [(label, _small_ddm_run) for label in SMALL_DDM]
    for label, run in runs:
        t1 = time.perf_counter()
        try:
            used[label], row = run(fd, label)
            rows.update(row or {})
        except AssertionError as exc:
            # the later cases still run and print; the phase fails below
            failed.append(f"{label}: {exc}")
            _release(label)
        print(f"{label}: case_s {time.perf_counter() - t1:.1f}", flush=True)
    if failed:
        raise AssertionError("ddm phase: " + "; ".join(failed))
    phase_done("ddm", t0)
    return used, rows


def ddm_cpu(labels, tag, study=False):
    """deflation_bratu_p1_1024 on the CPU at 512^2 (the counts the card
    must match), or with `study` the eigenvalue errors of eigen_p1_512 at
    EIGEN_STUDY and their extrapolation to EIGEN_N."""
    import firedrake_tpu_torch as fd
    fd.set_device("cpu")
    if "deflation_bratu_p1_1024" in labels and not study:
        t0 = time.perf_counter()
        p = _deflation_problem(fd, DEFL_REHEARSAL_LEVELS)
        out = _deflation_roots(fd, p)
        print(f"{tag} deflation_bratu_p1_1024: dofs {p['V'].dim} "
              f"newton_steps {[n for n, *_ in out]} gmres "
              f"{[[k for _, k, _ in h] for _, h, _, _ in out]} max u "
              f"{[m for *_, m, _ in out]} ||u1 - u2||_L2 "
              f"{fd.norm(p['deflation'].roots[0] - p['deflation'].roots[1])!r}"
              f" seconds {time.perf_counter() - t0:.1f} host_max_rss_gib "
              f"{_max_rss_gib():.2f}", flush=True)
    if "eigen_p1_512" in labels and study:
        prev = None
        for n in EIGEN_STUDY:
            t0 = time.perf_counter()
            _, es = _eigen_problem(fd, n)
            es.solve()
            errs = np.array([es.eigenvalue(i) for i in range(EIGEN_K)]) \
                - np.array(EIGEN_EXACT)
            line = (f"{tag} eigen_p1_512 n {n}: errors "
                    + " ".join(f"{e:.6e}" for e in errs))
            if prev is not None:
                ratio = prev / errs
                ext = errs / ratio ** np.log2(EIGEN_N / n)
                line += (" ratios " + " ".join(f"{r:.4f}" for r in ratio)
                         + f" extrapolated to {EIGEN_N}: "
                         + " ".join(f"{e:.4e}" for e in ext))
            prev = errs
            print(f"{line} seconds {time.perf_counter() - t0:.1f}",
                  flush=True)


# ------------------------------------------------------------ adjoint phase
# demos/poisson_inversion.py's problem, a heat loop and the covariance
# operators on the port's adjoint (firedrake_tpu_torch/adjoint/): every
# solve by CG + GMG on a MeshHierarchy of UnitSquareMesh(ADJ_BASE), K1 on
# every grad.grad, mass and source form of the primal, adjoint, tangent
# and second-order systems.
ADJ_BASE = 32
ADJ_ALPHA = 1e-6
ADJ_SP = {"ksp_type": "cg", "ksp_rtol": 1e-10, "pc_type": "mg"}
ADJ_SMALL_SP = dict(ADJ_SP, ksp_rtol=1e-12)
# refinements of UnitSquareMesh(ADJ_BASE): 1024^2, 512^2; the card-vs-CPU
# cases at 64^2
ADJ_LEVELS = {"inversion_p1_1024": 5, "heat_adjoint_p1_512": 4,
              "covariance_p1_1024": 5}
ADJ_SMALL_LEVELS = 1
HEAT_STEPS, HEAT_DT = 10, 0.05
TAYLOR_MIN = 1.9                   # the JAX tests' bound
HESSIAN_RTOL = 1e-7
ADJ_CARD_CPU_RTOL = 1e-10
COVARIANCE = dict(L=0.2, sigma=1.3, m=4, seed=3)   # the JAX test's
COVARIANCE_PC_ITS = 3              # the JAX test's bound
# the round trip's error, relative to max|x|, within this times
# max|B^-1 x| / max|x| (the magnification of the solves' errors): the
# ratio read 1.9e-11 to 3.2e-11 on the CPU at 64^2 to 256^2 with the K
# solves to rtol 1e-12, 4.5e-12 on the card at 1024^2 with them to 1e-10
COVARIANCE_RT = 1e-10
# B (M x) against its closed form x / c for x = cos(pi x) cos(pi y), an
# eigenfunction of the Neumann Laplacian (eigenvalue 2 pi^2): c = (1 +
# 2 pi^2 kappa)^m / (sigma^2 lambda), with kappa and lambda the published
# formulas (Mirouze & Weaver 2010), not the port's.  The P1 error, max
# relative, read 5.4e-2, 1.7e-2, 4.9e-3, 1.4e-3, 3.9e-4 on the CPU at 8^2
# to 128^2 (x3.5 per halving of h): ~9e-6 at 1024^2.  A kappa 1% off moves
# c by 5.5e-3.
COVARIANCE_CLOSED_FORM = 1e-4
LBFGS_ITS = 5


def _ksp_runs():
    """Every Krylov solve made through solving._run_ksp while entered
    (the forward solves and the tape's adjoint, tangent and second-order
    solves): its result (iterations, convergence) and synchronised
    seconds."""
    return _StageTimes((("solve", "firedrake_tpu_torch.solving",
                         "_run_ksp"),))


def _ksp_line(st):
    its = [int(r.iterations) for r in st.results["solve"]]
    return (f"krylov_solves {len(its)} iterations {its} ksp_s "
            f"{st.secs['solve']:.4f} ms_per_iteration "
            f"{1e3 * st.secs['solve'] / max(sum(its), 1):.4f}")


def _all_converged(*sts):
    return all(bool(r.converged) for st in sts for r in st.results["solve"])


#: the finest mesh of each hierarchy the adjoint phase built, by (levels,
#: device): inversion_p1_1024 and covariance_p1_1024 share one
_ADJ_MESHES = {}


def _adj_mesh(fd, levels):
    key = (levels, str(fd.get_device()))
    if key not in _ADJ_MESHES:
        _ADJ_MESHES[key] = fd.MeshHierarchy(
            fd.UnitSquareMesh(ADJ_BASE, ADJ_BASE), levels)[-1]
    return _ADJ_MESHES[key]


def _inversion_problem(fd, levels, params):
    """demos/poisson_inversion.py's problem on the finest mesh of a
    hierarchy: J = 1/2 ||u(f) - u_obs||^2 + alpha/2 ||f||^2, -lap u = f,
    u = 0 on the boundary, f = x y the initial guess (the demo's is 0,
    a forward solve with nothing to do); ``record()`` tapes the forward
    solve and J on a fresh tape."""
    import firedrake_tpu_torch.adjoint as adj
    mesh = _adj_mesh(fd, levels)
    V = fd.FunctionSpace(mesh, "CG", 1)
    X = fd.SpatialCoordinate(mesh)
    bcs = [fd.DirichletBC(V, 0.0, "on_boundary")]
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    a = fd.inner(fd.grad(u), fd.grad(v)) * fd.dx
    f_true = fd.Function(V).interpolate(
        fd.sin(fd.pi * X[0]) * fd.sin(2 * fd.pi * X[1]))
    u_obs = fd.Function(V)
    fd.solve(a == f_true * v * fd.dx, u_obs, bcs=bcs,
             solver_parameters=params)
    p = dict(V=V, f=fd.Function(V).interpolate(X[0] * X[1]), u_obs=u_obs,
             f_true=f_true,
             # the Taylor and Hessian directions
             h=fd.Function(V).interpolate(X[0] * (1 - X[0]) * X[1]),
             d=fd.Function(V).interpolate(fd.cos(fd.pi * X[0]) * X[1]))

    def record():
        tape = adj.set_working_tape(adj.Tape())
        adj.continue_annotation()
        w = fd.Function(V)
        fd.solve(a == p["f"] * v * fd.dx, w, bcs=bcs,
                 solver_parameters=params)
        J = fd.assemble(0.5 * (w - u_obs) ** 2 * fd.dx
                        + 0.5 * ADJ_ALPHA * p["f"] ** 2 * fd.dx)
        adj.pause_annotation()
        p.update(w=w, J=J, tape=tape,
                 rf=adj.ReducedFunctional(J, adj.Control(p["f"]),
                                          tape=tape))
    p["record"] = record
    return p


def _hessian_fd(fd, p):
    """(H d, grad J(f + d) - grad J(f)): J is quadratic in f, so the two
    differ by the solves' tolerance alone; the tape is left at f."""
    rf, f0 = p["rf"], p["f"].dat.clone()
    Hd = rf.hessian(p["d"]).dat.clone()
    rf(fd.Function(p["V"], val=f0 + p["d"].dat))
    g1 = rf.derivative().dat.clone()
    rf(fd.Function(p["V"], val=f0))
    return Hd, g1 - rf.derivative().dat


def _heat_problem(fd, levels, params, steps=HEAT_STEPS):
    """tests/adjoint/test_adjoint.py::test_time_dependent_adjoint's loop:
    backward Euler (dt 0.05) by solve(F == 0) and assign, J = ||u_N||^2,
    the initial condition the control; ``record()`` tapes it.  The
    residual is the test's times dt."""
    import firedrake_tpu_torch.adjoint as adj
    mesh = _adj_mesh(fd, levels)
    V = fd.FunctionSpace(mesh, "CG", 1)
    X = fd.SpatialCoordinate(mesh)
    v = fd.TestFunction(V)
    bcs = [fd.DirichletBC(V, 0.0, "on_boundary")]
    p = dict(V=V, u0=fd.Function(V).interpolate(
        fd.sin(fd.pi * X[0]) * fd.sin(fd.pi * X[1])),
        h=fd.Function(V).interpolate(
            0.1 * X[0] * (1 - X[0]) * X[1] * (1 - X[1])))

    def record():
        tape = adj.set_working_tape(adj.Tape())
        adj.continue_annotation()
        u_prev = fd.Function(V)
        u_prev.assign(p["u0"])
        u = fd.Function(V)
        # the JAX test's residual times dt: mass + dt stiffness, in K1's
        # family (a division by dt is not)
        F = ((u - u_prev) * v
             + HEAT_DT * fd.inner(fd.grad(u), fd.grad(v))) * fd.dx
        for _ in range(steps):
            fd.solve(F == 0, u, bcs=bcs, solver_parameters=params)
            u_prev.assign(u)
        J = fd.assemble(u * u * fd.dx)
        adj.pause_annotation()
        p.update(J=J, tape=tape,
                 rf=adj.ReducedFunctional(J, adj.Control(p["u0"]),
                                          tape=tape))
    p["record"] = record
    return p


def _covariance_problem(fd, levels, params):
    """AutoregressiveCovariance (the JAX test's L, sigma, m and seed) with
    its K solves by CG + GMG, and x = cos(pi x) cos(pi y), which meets
    K's natural boundary condition (B^-1 = K (M^-1 K)^3 / lam^2 magnifies
    whatever of x the discrete operator sees as rough by up to
    (1 + kappa lambda_max)^4, ~1e19 at 1024^2)."""
    import firedrake_tpu_torch.adjoint as adj
    mesh = _adj_mesh(fd, levels)
    V = fd.FunctionSpace(mesh, "CG", 1)
    X = fd.SpatialCoordinate(mesh)
    B = adj.AutoregressiveCovariance(V, solver_parameters=params,
                                     **COVARIANCE)
    x = fd.Function(V).interpolate(
        fd.cos(fd.pi * X[0]) * fd.cos(fd.pi * X[1]))
    return dict(V=V, B=B, x=x)


def _round_trip(p):
    """(y, error, gain): y = apply_action(apply_inverse(x)), its max error
    relative to max|x|, and max|B^-1 x| / max|x|, the magnification that
    the solves' errors meet on the way back."""
    bx = p["B"].apply_inverse(p["x"])
    y = p["B"].apply_action(bx).dat
    xmax = p["x"].dat.abs().max()
    return (y, float((y - p["x"].dat).abs().max() / xmax),
            float(bx.dat.abs().max() / xmax))


def _closed_form_action(fd, p):
    """max|B (M x) - x / c| / max|x / c| (COVARIANCE_CLOSED_FORM)."""
    L, sigma, m = COVARIANCE["L"], COVARIANCE["sigma"], COVARIANCE["m"]
    kappa = L ** 2 / (2 * m - 3)
    lam = (L / math.sqrt(2 * m - 3) * 2 ** (2 * m - 1)
           * math.factorial(m - 1) ** 2 / math.factorial(2 * m - 2))
    c = (1 + 2 * math.pi ** 2 * kappa) ** m / (sigma ** 2 * lam)
    u, v = fd.TrialFunction(p["V"]), fd.TestFunction(p["V"])
    mx = fd.Cofunction(p["V"])
    mx.dat = fd.assemble(u * v * fd.dx).matvec(p["x"].dat)
    want = p["x"].dat / c
    return float((p["B"].apply_action(mx).dat - want).abs().max()
                 / want.abs().max())


def _covariance_pc(p):
    """CG on B y = x with CovariancePC (B^-1), by name: the KSP result."""
    import firedrake_tpu_torch.adjoint as adj
    from firedrake_tpu_torch.solvers.composition import OpCtx, build_ksp
    solve = build_ksp(
        OpCtx(mat=adj.CovarianceMat(p["B"], adj.CovarianceMat.ACTION),
              space=p["V"]),
        {"ksp_type": "cg", "ksp_rtol": 1e-10, "pc_type": "python",
         "pc_python_type": "firedrake.CovariancePC"})
    return solve._full(p["x"].dat)


def _adj_k1_checks(V, label):
    """K1 against its plain version and the lowerer on the inputs of
    every form of K1's family that the case assembled on its finest mesh
    (the assembler cache's stencil-route entries; their coefficients hold
    the last values the path gave them)."""
    from firedrake_tpu_torch.assemble import _assembler_cache, FormAssembler
    from firedrake_tpu_torch.compiler import cell_eval as K
    n = 0
    for asm in list(_assembler_cache.values()):
        if not isinstance(asm, FormAssembler) or asm._stencil is None \
                or asm.mesh is not V.mesh() \
                or any(K.family_spec(ci) is None for ci in asm._compiled):
            continue
        _stencil_k1_checks(asm, f"{label} form {n}")
        n += 1
    if not n:
        raise AssertionError(f"{label}: no form of K1's family assembled")
    torch.cuda.empty_cache()
    return n


def inversion_run(fd, label="inversion_p1_1024"):
    """The demo's problem at 1,050,625 dofs: forward, gradient (one
    adjoint CG + GMG solve), a 4-step Taylor test, one Hessian action
    against a gradient difference, 5 L-BFGS-B iterations; then K1 held to
    its plain version on the path's inputs."""
    import firedrake_tpu_torch.adjoint as adj
    from firedrake_tpu_torch.adjoint.tape import taylor_rates
    torch.cuda.reset_peak_memory_stats()
    p, setup_s = _sync_time(
        lambda: _inversion_problem(fd, ADJ_LEVELS[label], ADJ_SP))
    counts = _Counts()
    with counts, _ksp_runs() as fwd:
        _, fwd_s = _sync_time(p["record"])
    with counts, _ksp_runs() as adj_ks:
        g, grad_s = _sync_time(p["rf"].derivative)
    print(f"{label}: dofs {p['V'].dim} setup_s {setup_s:.3f} (hierarchy, "
          f"shared with covariance_p1_1024; the u_obs solve) forward_s "
          f"{fwd_s:.4f} {_ksp_line(fwd)} J {float(p['J'])!r}", flush=True)
    print(f"{label}: gradient_s {grad_s:.4f} adjoint {_ksp_line(adj_ks)} "
          f"max|g| {float(g.dat.abs().max())!r} on {g.dat.device}",
          flush=True)
    with counts:
        rates, taylor_s = _sync_time(
            lambda: taylor_rates(p["rf"], p["f"], p["h"]))
    with counts, _ksp_runs() as hk:
        (Hd, dg), hess_s = _sync_time(lambda: _hessian_fd(fd, p))
    hrel = float((Hd - dg).abs().max() / dg.abs().max())
    print(f"{label}: taylor_s {taylor_s:.3f} rates "
          + " ".join(f"{r:.6f}" for r in rates)
          + f" hessian_s {hess_s:.3f} (H d, two replays, two gradients; "
          f"{_ksp_line(hk)}) max|H d - (g(f + d) - g(f))| / max "
          f"{hrel:.3e}", flush=True)
    traced = _Traced(p["rf"])
    J0 = float(p["J"])
    with counts:
        mopt, opt_s = _sync_time(lambda: adj.minimize(
            traced, method="L-BFGS-B",
            # no stopping test but the iteration count (the gradient's
            # entries are mass-weighted, ~h^2: below scipy's gtol)
            options={"maxiter": LBFGS_ITS, "gtol": 0.0, "ftol": 0.0}))
    res, J_end = mopt._opt_result, traced.evals[-1]
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: minimize_s {opt_s:.3f} L-BFGS-B nit {res.nit} nfev "
          f"{res.nfev} J {J0!r} -> {J_end!r} evaluations "
          + " ".join(f"{e:.6e}" for e in traced.evals)
          + f" k1_launches {counts.k1} k1_by_variant "
          f"{counts.k1_by_variant} lowerer_evals {counts.lowerer} "
          f"max_memory_allocated {peak} ({peak / 2 ** 30:.3f} GiB)",
          flush=True)
    nforms = _adj_k1_checks(p["V"], label)
    print(f"{label}: K1 held to its plain version on {nforms} forms",
          flush=True)
    failed = []
    if not g.dat.is_cuda:
        failed.append("the gradient is not on the card")
    if not _all_converged(fwd, adj_ks, hk):
        failed.append("a Krylov solve did not converge")
    if not min(rates) >= TAYLOR_MIN:
        failed.append(f"Taylor rates {list(rates)}")
    if not hrel <= HESSIAN_RTOL:
        failed.append(f"Hessian action {hrel} from the gradient difference")
    if res.nit != LBFGS_ITS or not J_end < J0:
        failed.append(f"L-BFGS-B: {res.nit} iterations, J {J0} -> {J_end}")
    if counts.k1 <= 0:
        failed.append("K1 was not launched")
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    del p, g, Hd, dg, mopt, traced
    _release(label)
    return counts


class _Traced:
    """A ReducedFunctional whose values are recorded in the order
    minimize asks for them."""

    def __init__(self, rf):
        self.rf, self.evals = rf, []

    @property
    def controls(self):
        return self.rf.controls

    def __call__(self, values):
        self.evals.append(self.rf(values))
        return self.evals[-1]

    def derivative(self, adj_input=1.0):
        return self.rf.derivative(adj_input)


def heat_run(fd, label="heat_adjoint_p1_512"):
    """Ten backward-Euler steps at 263,169 dofs (SolveBlock and
    AssignBlock snapshots at width): forward, gradient (ten adjoint
    solves), the gradient's L2 Riesz map (host LU, as in the JAX
    package), a 4-step Taylor test; then K1 held to its plain version on
    the path's inputs."""
    from firedrake_tpu_torch.adjoint.tape import taylor_rates
    p, setup_s = _sync_time(
        lambda: _heat_problem(fd, ADJ_LEVELS[label], ADJ_SP))
    counts = _Counts()
    with counts, _ksp_runs() as fwd:
        _, fwd_s = _sync_time(p["record"])
    with counts, _ksp_runs() as adj_ks:
        g, grad_s = _sync_time(p["rf"].derivative)
    riesz, riesz_s = _sync_time(lambda: g.riesz_representation("L2"))
    with counts:
        rates, taylor_s = _sync_time(
            lambda: taylor_rates(p["rf"], p["u0"], p["h"]))
    print(f"{label}: dofs {p['V'].dim} steps {HEAT_STEPS} setup_s "
          f"{setup_s:.3f} forward_s {fwd_s:.4f} ({_ksp_line(fwd)}) J "
          f"{float(p['J'])!r} gradient_s {grad_s:.4f} (adjoint "
          f"{_ksp_line(adj_ks)}) riesz_L2_s {riesz_s:.3f} (host LU) "
          f"taylor_s {taylor_s:.3f} rates "
          + " ".join(f"{r:.6f}" for r in rates)
          + f" k1_launches {counts.k1} lowerer_evals {counts.lowerer}",
          flush=True)
    nforms = _adj_k1_checks(p["V"], label)
    print(f"{label}: K1 held to its plain version on {nforms} forms",
          flush=True)
    failed = []
    if not g.dat.is_cuda or not riesz.dat.is_cuda:
        failed.append("the gradient is not on the card")
    n_adj = len(adj_ks.results["solve"])
    if n_adj != HEAT_STEPS or not _all_converged(fwd, adj_ks):
        failed.append(f"{n_adj} adjoint solves, or one did not converge")
    if not min(rates) >= TAYLOR_MIN:
        failed.append(f"Taylor rates {list(rates)}")
    if not bool(torch.isfinite(riesz.dat).all()):
        failed.append("the Riesz map is not finite")
    if counts.k1 <= 0:
        failed.append("K1 was not launched")
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    del p, g, riesz
    _release(label)
    return counts


def covariance_run(fd, label="covariance_p1_1024"):
    """AutoregressiveCovariance (m = 4) at 1,050,625 dofs: B (M x) against
    its closed form, the round trip apply_action(apply_inverse(x)), CG
    with CovariancePC, one sample and its B^-1 norm (expected dim, std
    sqrt(2 dim)); then K1 held to its plain version on the path's
    inputs."""
    counts = _Counts()
    with counts:
        p, setup_s = _sync_time(
            lambda: _covariance_problem(fd, ADJ_LEVELS[label], ADJ_SP))
        cf, cf_s = _sync_time(lambda: _closed_form_action(fd, p))
        (_, rt, gain), rt_s = _sync_time(lambda: _round_trip(p))
        res, pc_s = _sync_time(lambda: _covariance_pc(p))
        s, sample_s = _sync_time(lambda: p["B"].sample())
        ratio = p["B"].norm(s) / p["V"].dim
    print(f"{label}: dofs {p['V'].dim} setup_s {setup_s:.3f} action_s "
          f"{cf_s:.3f} max|B M x - x / c| / max|x / c| {cf:.3e} "
          f"round_trip_s "
          f"{rt_s:.3f} max|B B^-1 x - x| / max|x| {rt:.3e} (max|B^-1 x| "
          f"/ max|x| {gain:.3e}) "
          f"covariance_pc cg iterations {res.iterations} converged "
          f"{res.converged} solve_s {pc_s:.3f} sample_s {sample_s:.3f} "
          f"|sample|^2_(B^-1) / dim {ratio:.6f} k1_launches {counts.k1} "
          f"lowerer_evals {counts.lowerer}", flush=True)
    nforms = _adj_k1_checks(p["V"], label)
    print(f"{label}: K1 held to its plain version on {nforms} forms",
          flush=True)
    failed = []
    if not s.dat.is_cuda:
        failed.append("the sample is not on the card")
    if not cf <= COVARIANCE_CLOSED_FORM:
        failed.append(f"B M x {cf} from its closed form")
    if not rt <= COVARIANCE_RT * gain:
        failed.append(f"round trip {rt}, {gain} times the solves' errors")
    if not (res.converged and res.iterations <= COVARIANCE_PC_ITS):
        failed.append(f"CovariancePC: {res.iterations} iterations")
    if not abs(ratio - 1) < 0.05:
        failed.append(f"sample norm / dim {ratio}")
    if counts.k1 <= 0:
        failed.append("K1 was not launched")
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    del p, s
    _release(label)
    return counts


def _adjoint_small(fd):
    """The three cases at 64^2, every solve to ksp_rtol 1e-12: the
    inversion's gradient and Hessian action, the heat gradient, and the
    covariance's B x, B^-1 x, x^T B^-1 x and first seeded sample (host
    arrays)."""
    p = _inversion_problem(fd, ADJ_SMALL_LEVELS, ADJ_SMALL_SP)
    p["record"]()
    out = dict(inversion_gradient=p["rf"].derivative().dat.cpu(),
               inversion_hessian=p["rf"].hessian(p["d"]).dat.cpu())
    q = _heat_problem(fd, ADJ_SMALL_LEVELS, ADJ_SMALL_SP)
    q["record"]()
    out["heat_gradient"] = q["rf"].derivative().dat.cpu()
    c = _covariance_problem(fd, ADJ_SMALL_LEVELS, ADJ_SMALL_SP)
    B, x = c["B"], c["x"]
    out.update(covariance_action=B.apply_action(x).dat.cpu(),
               covariance_inverse=B.apply_inverse(x).dat.cpu(),
               covariance_norm=torch.tensor([B.norm(x)]),
               covariance_sample=B.sample().dat.cpu())
    return out


def adjoint_small_run(fd, label="adjoint_64"):
    """_adjoint_small on the card, then on the CPU in this process:
    within ADJ_CARD_CPU_RTOL of max|CPU|."""
    card, card_s = _sync_time(lambda: _adjoint_small(fd))
    fd.set_device("cpu")
    t0 = time.perf_counter()
    try:
        cpu = _adjoint_small(fd)
    finally:
        fd.set_device(torch.device("cuda"))
    cpu_s = time.perf_counter() - t0
    diffs = {k: float((card[k] - cpu[k]).abs().max() / cpu[k].abs().max())
             for k in card}
    print(f"{label}: card_s {card_s:.3f} cpu_s {cpu_s:.3f} card_vs_cpu "
          + " ".join(f"{k} {v:.3e}" for k, v in diffs.items()), flush=True)
    bad = {k: v for k, v in diffs.items() if not v <= ADJ_CARD_CPU_RTOL}
    if bad:
        raise AssertionError(f"{label}: card and CPU apart: {bad}")
    _release(label)


ADJOINT_RUNS = (("inversion_p1_1024", inversion_run),
                ("heat_adjoint_p1_512", heat_run),
                ("covariance_p1_1024", covariance_run))


def adjoint_phase():
    """inversion_p1_1024, heat_adjoint_p1_512, covariance_p1_1024 and the
    same three at 64^2 on the card against the CPU."""
    t0 = phase("adjoint")
    import firedrake_tpu_torch as fd
    fd.set_device(torch.device("cuda"))
    used, failed = {}, []
    for label, run in ADJOINT_RUNS + (("adjoint_64", adjoint_small_run),):
        t1 = time.perf_counter()
        try:
            with warnings.catch_warnings():
                # a forward solve that does not converge warns: fail it
                warnings.filterwarnings("error",
                                        message=".*did not converge")
                c = run(fd, label)
            if c is not None:
                used[label] = c
        except (AssertionError, RuntimeError, UserWarning) as exc:
            # the later cases still run and print; the phase fails below
            failed.append(f"{label}: {exc}")
            _release(label)
        print(f"{label}: case_s {time.perf_counter() - t1:.1f}", flush=True)
    _ADJ_MESHES.clear()
    if failed:
        raise AssertionError("adjoint phase: " + "; ".join(failed))
    phase_done("adjoint", t0)
    return used


# ------------------------------------------------------------ the meshio phase
# gmsh_helmholtz_p1_1024: the unit square cut into MESHIO_N^2 squares of two
# triangles each, the interior vertices moved by up to MESHIO_JITTER h in
# each coordinate (a seeded generator), so the mesh takes the gather route;
# written as an ASCII gmsh v4.1 file and read back through Mesh().  The
# Neumann Helmholtz problem of neumann_helmholtz_disk is solved on it; the
# bounds on its nodal and L2 errors are twice the --cpu-study extrapolation
# (from 64 to 512 the nodal error falls 3.71-3.81x per level, the L2 error
# 3.99-4.02x; PERF.md).  Then
# the same mesh as an Exodus II file; points_1m: a million seeded points
# located and evaluated, a VertexOnlyMesh on them and a cross-mesh
# interpolation onto P1 of UnitSquareMesh(XMESH_N).
MESHIO_N = 1024
MESHIO_JITTER = 0.2
MESHIO_SEED = 17
MESHIO = dict(study=(64, 128, 256, 512), nodal=3.2e-5, l2=1.4e-5)
POINTS_N = 1_000_000
POINTS_CPU = 10_000                # the subset also located on the CPU
XMESH_N = 512
POINT_STAGES = (("host_candidates", "firedrake_tpu_torch.pointeval",
                 "_candidates"),
                ("host_ball", "firedrake_tpu_torch.pointeval",
                 "_ball_candidates"),
                ("device_inversion", "firedrake_tpu_torch.pointeval",
                 "_containing"),
                ("evaluate", "firedrake_tpu_torch.pointeval", "evaluate"))


def _jittered_square(n, jitter=MESHIO_JITTER, seed=MESHIO_SEED):
    """(vertices, cells, cell tags, boundary edge blocks) of the unit square
    cut into n^2 squares of two triangles: the interior vertices moved by
    up to jitter/n in each coordinate, a cell tagged 1 where its centroid
    has x < 0.5 and 2 elsewhere (region 1's cells first), the boundary
    edges in blocks tagged as UnitSquareMesh's (1: x = 0, 2: x = 1, 3: y =
    0, 4: y = 1)."""
    h = 1.0 / n
    ix, iy = (a.ravel() for a in np.meshgrid(np.arange(n + 1),
                                             np.arange(n + 1)))
    xy = np.stack([ix * h, iy * h], axis=1)
    inner = (ix > 0) & (ix < n) & (iy > 0) & (iy < n)
    rng = np.random.default_rng(seed)
    xy[inner] += rng.uniform(-jitter * h, jitter * h, (int(inner.sum()), 2))
    vid = lambda i, j: j * (n + 1) + i
    a, b = (t.ravel() for t in np.meshgrid(np.arange(n), np.arange(n)))
    v00, v10, v11, v01 = vid(a, b), vid(a + 1, b), vid(a + 1, b + 1), \
        vid(a, b + 1)
    cells = np.stack([np.stack([v00, v10, v11], 1),
                      np.stack([v00, v11, v01], 1)], 1).reshape(-1, 3)
    tags = np.where(xy[cells].mean(axis=1)[:, 0] < 0.5, 1, 2)
    order = np.argsort(tags, kind="stable")
    k = np.arange(n)
    edges = [(np.stack([vid(0, k), vid(0, k + 1)], 1), 1),
             (np.stack([vid(n, k), vid(n, k + 1)], 1), 2),
             (np.stack([vid(k, 0), vid(k + 1, 0)], 1), 3),
             (np.stack([vid(k, n), vid(k + 1, n)], 1), 4)]
    return xy, cells[order], tags[order], edges


def _write_rows(fh, fmt, rows, chunk=1 << 16):
    """Rows of a 2D array through one %-format per row, in chunks."""
    for s in range(0, len(rows), chunk):
        r = rows[s:s + chunk]
        fh.write((fmt * len(r)) % tuple(r.ravel().tolist()))


def _write_gmsh41(path, xy, cells, tags, edges):
    """An ASCII gmsh v4.1 file: curves 1-4 and surfaces 1-2, each its own
    physical group; one node block; the boundary lines, then each region's
    triangles."""
    nn, nc = len(xy), len(cells)
    nb = sum(len(e) for e, _ in edges)
    with open(path, "w") as fh:
        fh.write("$MeshFormat\n4.1 0 8\n$EndMeshFormat\n$Entities\n0 4 2 0\n")
        for k in (1, 2, 3, 4):
            fh.write(f"{k} 0 0 0 1 1 0 1 {k} 0\n")
        for k in (1, 2):
            fh.write(f"{k} 0 0 0 1 1 0 1 {k} 0\n")
        fh.write(f"$EndEntities\n$Nodes\n1 {nn} 1 {nn}\n2 1 0 {nn}\n")
        _write_rows(fh, "%d\n", np.arange(1, nn + 1)[:, None])
        _write_rows(fh, "%.17g %.17g 0\n", xy)
        fh.write(f"$EndNodes\n$Elements\n6 {nb + nc} 1 {nb + nc}\n")
        eid = 1
        blocks = [(1, t, 1, e) for e, t in edges] + \
            [(2, t, 2, cells[tags == t]) for t in (1, 2)]
        for edim, tag, etype, conn in blocks:
            fh.write(f"{edim} {tag} {etype} {len(conn)}\n")
            ids = np.arange(eid, eid + len(conn))[:, None]
            _write_rows(fh, "%d" + " %d" * conn.shape[1] + "\n",
                        np.hstack([ids, conn + 1]))
            eid += len(conn)
        fh.write("$EndElements\n")


def _write_exodus(path, xy, cells, tags, edges):
    """The same mesh as an Exodus II file: element blocks 1 and 2 (the
    regions, in the gmsh file's cell order) and side sets 1-4 (each
    boundary edge as its triangle's local side)."""
    from scipy.io import netcdf_file
    from firedrake_tpu_torch.mesh.io_msh import match_rows
    sides = np.sort(cells[:, [[0, 1], [1, 2], [2, 0]]], axis=2).reshape(-1, 2)
    nc = netcdf_file(path, "w")
    nc.createDimension("num_dim", 2)
    nc.createDimension("num_nodes", len(xy))
    nc.createDimension("num_elem", len(cells))
    nc.createDimension("num_el_blk", 2)
    nc.createDimension("num_side_sets", len(edges))
    for k, ax in enumerate(("coordx", "coordy")):
        nc.createVariable(ax, "d", ("num_nodes",))[:] = xy[:, k]
    nc.createVariable("eb_prop1", "i", ("num_el_blk",))[:] = [1, 2]
    for b in (1, 2):
        conn = cells[tags == b] + 1
        nc.createDimension(f"num_el_in_blk{b}", len(conn))
        nc.createDimension(f"num_nod_per_el{b}", 3)
        var = nc.createVariable(f"connect{b}", "i", (
            f"num_el_in_blk{b}", f"num_nod_per_el{b}"))
        var.elem_type = "TRI3"
        var[:] = conn
    nc.createVariable("ss_prop1", "i", ("num_side_sets",))[:] = \
        [t for _, t in edges]
    for s, (e, _) in enumerate(edges, start=1):
        at = match_rows(sides, np.sort(e, axis=1))
        nc.createDimension(f"num_side_ss{s}", len(e))
        nc.createVariable(f"elem_ss{s}", "i", (f"num_side_ss{s}",))[:] = \
            at // 3 + 1
        nc.createVariable(f"side_ss{s}", "i", (f"num_side_ss{s}",))[:] = \
            at % 3 + 1
    nc.close()


def _meshio_file(tmp, n):
    """Write the jittered square at n as a gmsh v4.1 file in `tmp`:
    (path, seconds, the arrays)."""
    import os
    arrays = _jittered_square(n)
    path = os.path.join(tmp, f"square_{n}.msh")
    t = time.perf_counter()
    _write_gmsh41(path, *arrays)
    return path, time.perf_counter() - t, arrays


def _meshio_tmp():
    """A temporary directory in the checkout's build directory."""
    import os
    import tempfile
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "firedrake_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    return tempfile.TemporaryDirectory(prefix="meshio_", dir=build)


def _same_mesh(a, b):
    """Cells, coordinates and both marker arrays bit for bit."""
    return all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in (
        (a.topology.cell_vertices, b.topology.cell_vertices),
        (a._vertex_coords, b._vertex_coords),
        (a.cell_markers, b.cell_markers),
        (a.facet_markers, b.facet_markers)))


def _meshio_measures(fd, mesh):
    """The tags' measures: each boundary side 1, both regions 1 together,
    region 1 the area of its tagged cells summed in numpy (within 1e-12).
    Returns the largest deviation."""
    one = fd.Constant(1.0)
    dev = {f"ds({k})": abs(fd.assemble(one * fd.ds(k, domain=mesh)) - 1)
           for k in (1, 2, 3, 4)}
    a1 = fd.assemble(one * fd.dx(1, domain=mesh))
    a2 = fd.assemble(one * fd.dx(2, domain=mesh))
    p = mesh._vertex_coords[mesh.topology.cell_vertices]
    e1, e2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    area = 0.5 * np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
    dev["dx(1)+dx(2)"] = abs(a1 + a2 - 1)
    dev["dx(1)"] = abs(a1 - area[mesh.cell_markers == 1].sum())
    print("  measures: " + " ".join(f"{k} {v:.3e}" for k, v in dev.items()))
    return max(dev.values())


def meshio_solve(fd, mesh, label):
    """The Neumann Helmholtz solve on the file mesh, counted over set-up,
    assembly and solve; K1 held to its plain version on the route's inputs
    of a and L after it.  Returns the counts, the problem and the gates
    that failed."""
    from firedrake_tpu_torch.assemble import get_assembler
    with warnings.catch_warnings():
        warnings.simplefilter("error")     # a non-converged solve warns
        with _Counts() as counts:
            p, setup_s = _sync_time(lambda: _neumann_on(fd, mesh))
            _, cold_s = _sync_time(lambda: (fd.assemble(p["a"]),
                                            fd.assemble(p["L"])))
            _, solve_s = _sync_time(p["solver"].solve)
    asm = get_assembler(p["a"])
    for form in (p["a"], p["L"]):
        _route_k1_checks(get_assembler(form), label)
    solver, uh = p["solver"], p["uh"]
    its = solver.ksp_iterations
    nodal, l2 = _gather_errors(fd, p)
    want = CPU_REHEARSAL_ITS.get(label)
    cfg = MESHIO
    print(f"{label}: dofs {uh.function_space().dim} route "
          f"{'stencil' if asm._stencil is not None else 'gather'} setup_s "
          f"{setup_s:.3f} assembly_cold_s {cold_s:.3f} solve_s "
          f"{solve_s:.4f} iterations {its} (CPU rehearsal {want}) "
          f"ms_per_iteration {1e3 * solve_s / max(its, 1):.4f} converged "
          f"{solver.converged} max_nodal_err {nodal:.4e} (bound "
          f"{cfg['nodal']}) l2_err {l2:.4e} (bound {cfg['l2']}) on "
          f"{uh.dat.device} k1_launches {counts.k1} lowerer_evals "
          f"{counts.lowerer}")
    failed = [msg for bad, msg in (
        (not uh.dat.is_cuda, "solution is not on the card"),
        (asm._stencil is not None, "the file mesh took the stencil route"),
        (not solver.converged, "solve did not converge"),
        (counts.k1 <= 0 or counts.lowerer, "cell integrals bypassed K1"),
        (want is None or abs(its - want) > 0.01 * want,
         f"{its} iterations, the CPU rehearsal took {want}"),
        (not (nodal < cfg["nodal"] and l2 < cfg["l2"]),
         f"errors {nodal}, {l2} above bounds")) if bad]
    return counts, p, [f"{label}: {m}" for m in failed]


def _query_points(mesh, seed=MESHIO_SEED):
    """POINTS_N seeded points: 32 vertices and 32 facet midpoints of the
    mesh, 16 outside the square and the rest uniform inside it, the 80 at
    seeded places.  Returns the points and the places of the 80 (the
    outside ones last)."""
    rng = np.random.default_rng(seed + 1)
    vc = mesh._vertex_coords
    fv = mesh.topology.facet_vertices
    vert = vc[rng.choice(len(vc), 32, replace=False)]
    mid = vc[fv[rng.choice(len(fv), 32, replace=False)]].mean(axis=1)
    t = rng.uniform(0, 2 * np.pi, 16)
    out = 0.5 + (0.75 + 0.5 * rng.random(16))[:, None] * np.stack(
        [np.cos(t), np.sin(t)], axis=1)
    pts = rng.random((POINTS_N, 2))
    where = rng.choice(POINTS_N, 80, replace=False)
    pts[where] = np.concatenate([vert, mid, out])
    return pts, where


def points_run(fd, mesh, uh, label):
    """points_1m: uh.at on a million points (the host's candidate search
    and the device's inversion apart), a CPU run on a 10,000-point subset
    in the same process, a VertexOnlyMesh with its input-ordering round
    trip and a misfit functional, and uh interpolated onto P1 of
    UnitSquareMesh(XMESH_N)."""
    from firedrake_tpu_torch import pointeval as PE
    from firedrake_tpu_torch.device import to_numpy
    pts, where = _query_points(mesh)
    outside = np.zeros(POINTS_N, dtype=bool)
    outside[where[64:]] = True
    with _Counts() as counts, _StageTimes(POINT_STAGES) as st:
        vals, at_s = _sync_time(lambda: uh.at(pts, dont_raise=True))
    x, y = pts[:, 0], pts[:, 1]
    exact = np.cos(np.pi * x) * np.cos(np.pi * y)
    fv = mesh.topology.facet_vertices
    hmax = float(np.linalg.norm(mesh._vertex_coords[fv[:, 1]]
                                - mesh._vertex_coords[fv[:, 0]],
                                axis=1).max())
    bound = MESHIO["nodal"] + 0.5 * np.pi ** 2 * hmax ** 2
    err = float(np.abs(vals[~outside] - exact[~outside]).max())
    host_s = st.secs["host_candidates"] + st.secs["host_ball"]
    print(f"{label}: points {POINTS_N} at_s {at_s:.3f} locate_s "
          f"{host_s + st.secs['device_inversion']:.3f} (host candidate "
          f"search {host_s:.3f}: first pass "
          f"{st.secs['host_candidates']:.3f}, whole ball "
          f"{st.secs['host_ball']:.3f} for {len(st.results['host_ball'])} "
          f"call(s); device inversion {st.secs['device_inversion']:.3f}) "
          f"eval_ms {1e3 * st.secs['evaluate']:.3f} not_found "
          f"{int(np.isnan(vals).sum())} max|u_h(p) - u(p)| {err:.4e} "
          f"(bound {bound:.4e}: nodal {MESHIO['nodal']} + pi^2 hmax^2 / 2, "
          f"hmax {hmax:.4e}) k1_launches {counts.k1}")
    if not np.array_equal(np.isnan(vals), outside):
        raise AssertionError(f"{label}: NaN away from the outside points")
    if not err <= bound:
        raise AssertionError(f"{label}: a value off by {err} > {bound}")
    # the card against the CPU on a subset holding the 80 special points
    rng = np.random.default_rng(MESHIO_SEED + 2)
    rest = np.setdiff1d(np.arange(POINTS_N), where)
    sub = np.sort(np.concatenate([where, rng.choice(
        rest, POINTS_CPU - len(where), replace=False)]))
    cells_card, _ = PE._locate(mesh, pts[sub])
    fd.set_device("cpu")
    try:
        (cells_cpu, refs_cpu), cpu_s = _sync_time(
            lambda: PE._locate(mesh, pts[sub]))
        vals_cpu = to_numpy(PE.evaluate(uh, cells_cpu, refs_cpu))
    finally:
        fd.set_device(torch.device("cuda"))
    scale = float(np.nanmax(np.abs(vals)))
    rel = float(np.nanmax(np.abs(vals_cpu - vals[sub]))) / scale
    same_nan = np.array_equal(np.isnan(vals_cpu), np.isnan(vals[sub]))
    print(f"  cpu subset {len(sub)}: cells equal "
          f"{np.array_equal(cells_card, cells_cpu)} max|card - cpu| / "
          f"max|u_h| {rel:.3e} cpu_s {cpu_s:.3f}")
    if not (np.array_equal(cells_card, cells_cpu) and same_nan
            and rel <= 1e-14):
        raise AssertionError(f"{label}: the card and the CPU disagree")
    # VertexOnlyMesh on the same points
    with _Counts() as vcounts:
        vom, vom_s = _sync_time(lambda: fd.VertexOnlyMesh(
            mesh, pts, missing_points_behaviour="ignore"))
        P0 = fd.FunctionSpace(vom, "DG", 0)
        u_vom, vi_s = _sync_time(lambda: fd.interpolate(uh, P0))
        back = fd.interpolate(u_vom, fd.FunctionSpace(vom.input_ordering,
                                                      "DG", 0))
        found = ~outside
        y_obs = exact[found] + 1e-3 * rng.standard_normal(int(found.sum()))
        obs = fd.Function(P0, val=y_obs)
        J, j_s = _sync_time(lambda: fd.assemble((u_vom - obs) ** 2
                                                * fd.dx))
    J_np = float(np.sum((to_numpy(u_vom.dat) - y_obs) ** 2))
    round_trip = np.array_equal(to_numpy(back.dat), vals, equal_nan=True)
    print(f"  VertexOnlyMesh: vertices {vom.num_cells} build_s {vom_s:.3f} "
          f"interpolate_s {vi_s:.3f} input_ordering round trip bit for bit "
          f"{round_trip} misfit {J!r} numpy {J_np!r} assemble_s {j_s:.4f}")
    if vom.num_cells != POINTS_N - 16 or not round_trip:
        raise AssertionError(f"{label}: VertexOnlyMesh lost its points")
    if not abs(J - J_np) <= 1e-12 * J_np:
        raise AssertionError(f"{label}: misfit {J} against {J_np}")
    # cross-mesh interpolation, held to uh.at of the target's nodes
    m2 = fd.UnitSquareMesh(XMESH_N, XMESH_N)
    V2 = fd.FunctionSpace(m2, "CG", 1)
    f2, x_s = _sync_time(lambda: fd.Function(V2).interpolate(uh))
    X = fd.Function(fd.VectorFunctionSpace(m2, "CG", 1)).interpolate(
        fd.SpatialCoordinate(m2))
    ref = uh.at(to_numpy(X.dat).reshape(-1, 2))
    xerr = float(np.abs(to_numpy(f2.dat) - ref).max())
    print(f"  cross-mesh onto P1 of UnitSquareMesh({XMESH_N}): nodes "
          f"{V2.dim} interpolate_s {x_s:.3f} max|I u_h - u_h.at(nodes)| "
          f"{xerr:.3e}")
    if not xerr <= 1e-12 * float(np.abs(ref).max()):
        raise AssertionError(f"{label}: cross-mesh interpolation off by "
                             f"{xerr}")
    counts.k1 += vcounts.k1
    counts.lowerer += vcounts.lowerer
    return counts


def meshio_phase():
    """gmsh_helmholtz_p1_1024 (read, solve, tags' measures), the Exodus
    copy of its mesh, points_1m."""
    import os
    t0 = phase("meshio")
    import firedrake_tpu_torch as fd
    fd.set_device(torch.device("cuda"))
    label = "gmsh_helmholtz_p1_1024"
    used = {}
    with _meshio_tmp() as tmp:
        path, write_s, arrays = _meshio_file(tmp, MESHIO_N)
        mesh, read_s = _sync_time(lambda: fd.Mesh(path))
        print(f"{label}: file {os.path.getsize(path)} bytes (gmsh v4.1 "
              f"ASCII) write_s {write_s:.3f} read_s {read_s:.3f} cells "
              f"{mesh.num_cells} vertices {mesh.num_vertices} tagged "
              f"facets {int((mesh.facet_markers > 0).sum())}")
        # a failed gate of the solve is raised after the other cases ran
        used[label], p, failed = meshio_solve(fd, mesh, label)
        worst = _meshio_measures(fd, mesh)
        if not worst <= 1e-12:
            raise AssertionError(f"{label}: a tag's measure off by {worst}")
        exo = os.path.join(tmp, "square.exo")
        _, exo_w = _sync_time(lambda: _write_exodus(exo, *arrays))
        mexo, exo_r = _sync_time(lambda: fd.Mesh(exo))
        same = _same_mesh(mesh, mexo)
        print(f"  exodus copy: {os.path.getsize(exo)} bytes write_s "
              f"{exo_w:.3f} read_s {exo_r:.3f} equal to the gmsh read bit "
              f"for bit {same}")
        if not same:
            raise AssertionError(f"{label}: the Exodus copy differs")
        del mexo
    used["points_1m"] = points_run(fd, mesh, p["uh"], "points_1m")
    del p, mesh
    _release("meshio")
    if failed:
        raise AssertionError("meshio phase: " + "; ".join(failed))
    phase_done("meshio", t0)
    return used


def meshio_cpu(labels, tag, study=False):
    """gmsh_helmholtz_p1_1024 on the CPU: at full size (the CG iterations
    the card must match within 1%; run on the card's host) or at the
    study's levels (errors and their ratios per level)."""
    import firedrake_tpu_torch as fd
    label = "gmsh_helmholtz_p1_1024"
    if label not in labels:
        return
    fd.set_device("cpu")
    prev = None
    for n in (MESHIO["study"] if study else (MESHIO_N,)):
        t0 = time.perf_counter()
        with _meshio_tmp() as tmp:
            mesh = fd.Mesh(_meshio_file(tmp, n)[0])
        p = _neumann_on(fd, mesh)
        p["solver"].solve()
        nodal, l2 = _gather_errors(fd, p)
        rates = ("" if prev is None else
                 f" nodal_ratio {prev[0] / nodal:.3f} l2_ratio "
                 f"{prev[1] / l2:.3f}")
        print(f"{tag} {label} n {n}: dofs {p['uh'].function_space().dim} "
              f"iterations {p['solver'].ksp_iterations} converged "
              f"{p['solver'].converged} max_nodal_err {nodal:.4e} l2_err "
              f"{l2:.4e}{rates} seconds {time.perf_counter() - t0:.1f} "
              f"host_max_rss_gib {_max_rss_gib():.2f}", flush=True)
        prev = (nodal, l2)



# ------------------------------------------------------------ transfer phase
# hiptmair_n1curl_576: test_hiptmair.py's _riesz at full width, N1curl1 on
# the finest level of MeshHierarchy(UnitSquareMesh(36), 4) (996,480 dofs),
# CG + HiptmairPC; the potential space P1 (332,929 dofs) by one V-cycle
# (K1 on every level).  gtmg_hybrid_rt1_512: test_gtmg.py's mixed Poisson
# at 512^2 (RT1 x DG0, 1,311,744 dofs; trace 787,456), the trace by CG +
# GTMGPC with a P1 coarse space (263,169 dofs, host LU).
# nonnested_gmg_p1_1024: P1 Poisson with test_nonnested.py's source by CG
# + GMG on NonNestedHierarchy over jittered 160^2, 400^2 and 1024^2 meshes
# (1,050,625 dofs).  supermesh_p1_512_384: P1 on a jittered 512^2 mesh
# projected by supermesh_project onto P1 on a jittered 384^2 mesh.
HIP_BASE, HIP_LEVELS = 36, 4
HIP_SP = {"ksp_type": "cg", "ksp_rtol": 1e-8, "pc_type": "python",
          "pc_python_type": "firedrake.HiptmairPC",
          "hiptmair_mg_levels_ksp_type": "preonly",
          "hiptmair_mg_levels_pc_type": "jacobi",
          "hiptmair_mg_coarse_ksp_type": "preonly",
          "hiptmair_mg_coarse_pc_type": "mg"}
HIP_JACOBI_SP = {"ksp_type": "cg", "ksp_rtol": 1e-8, "pc_type": "jacobi",
                 "ksp_max_it": 20000}
GTMG_N = 512
GTMG_SP = {"pc_type": "hybridization",
           "hybridization": {"ksp_type": "cg", "ksp_rtol": 1e-10,
                             "pc_type": "python",
                             "pc_python_type": "firedrake.GTMGPC"}}
NN_SIZES, NN_SEEDS, NN_JITTER = (160, 400, 1024), (31, 32, 33), 0.2
NN_SP = {"ksp_type": "cg", "ksp_rtol": 1e-11, "pc_type": "mg"}
NN_SMALL = (10, 25, 64)            # held to the CPU in process
SM_SIZES, SM_SEEDS = (512, 384), (41, 42)
SM_SMALL = (24, 18)                # held to the CPU in process
TRANSFER_LABELS = ("hiptmair_n1curl_576", "gtmg_hybrid_rt1_512",
                   "nonnested_gmg_p1_1024", "supermesh_p1_512_384")
#: the CPU study's sizes: the finest mesh of each case, divided down
TRANSFER_STUDY = {"gtmg_hybrid_rt1_512": (32, 64, 128),
                  "nonnested_gmg_p1_1024": (128, 256, 512),
                  "supermesh_p1_512_384": (64, 128, 256)}
#: CG iterations of --cpu-rehearsal at full size (the card within one;
#: the card's host, 427.4 s, 17.9 s and 37.6 s)
TRANSFER_ITS = {"hiptmair_n1curl_576": 3181, "gtmg_hybrid_rt1_512": 10,
                "nonnested_gmg_p1_1024": 14}
#: the error bounds: twice the study's extrapolation to full size
#: (python3 chip_smoke.py --cpu-study <label>: the DG0 L2 error 1.3642e-5,
#: 3.4184e-6, 8.5511e-7 at 32, 64, 128; the nodal error 8.0513e-6,
#: 1.9164e-6, 5.3861e-7 at 128, 256, 512; the projection's L2 error
#: 3.2107e-4, 8.0286e-5, 2.0078e-5 at 64, 128, 256)
TRANSFER_ERR = {"gtmg_hybrid_rt1_512": 1.0701e-07,
                "nonnested_gmg_p1_1024": 3.0275e-07,
                "supermesh_p1_512_384": 1.0043e-05}
HIP_RIESZ_ERR = 1e-6               # test_hiptmair.py's gate
#: the projection's mass (relative); the mixed mass matrix's row sums
#: against int phi_i: relative once the clipping's two tolerances are off
#: (exact clipping, every fan piece kept), absolute for the matrix as
#: built.  The JAX package's tolerances drop fan pieces with |det J| <
#: 1e-16, each less than 5e-17 of a row, and keep vertices within 1e-14 /
#: |edge| of a clipping line; _row_sum_sources measures each.  At 512/384
#: the dropped pieces make the whole miss (5.415e-17 of 5.401e-17 at the
#: worst row, the tolerance 1.7e-21, 1.4e-19 left; NVIDIA H100 80GB HBM3,
#: 700.00 W), so the matrix is held to twenty such pieces a row.  The
#: clipping on the card against the CPU (relative)
SM_CONSERVE, SM_ROWSUM, SM_CARD_CPU = 1e-12, 1e-12, 1e-12
SM_ROWSUM_ABS = 20 * 5e-17
NN_CARD_CPU = 1e-10


def _jittered_mesh(fd, n, seed, jitter=NN_JITTER):
    """UnitSquareMesh(n) with its interior vertices moved by up to
    jitter / n in each coordinate (seeded), made a mesh of its own by
    Mesh() on the coordinate Function (the gather route)."""
    base = fd.UnitSquareMesh(n, n)
    X = fd.Function(fd.VectorFunctionSpace(base, "CG", 1)).interpolate(
        fd.SpatialCoordinate(base))
    xy = X.dat.reshape(-1, 2).cpu().numpy().copy()
    inner = ((xy > 1e-12) & (xy < 1 - 1e-12)).all(axis=1)
    rng = np.random.default_rng(seed)
    xy[inner] += rng.uniform(-jitter / n, jitter / n, (int(inner.sum()), 2))
    X.dat = torch.as_tensor(xy.reshape(-1), device=X.dat.device)
    return fd.Mesh(X)


def _hiptmair_problem(fd, base=HIP_BASE, levels=HIP_LEVELS, params=HIP_SP):
    hier = fd.MeshHierarchy(fd.UnitSquareMesh(base, base), levels)
    V = fd.FunctionSpace(hier[-1], "N1curl", 1)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    f = fd.Constant((1.0, 2.0))
    a = (fd.inner(fd.curl(u), fd.curl(v)) + fd.inner(u, v)) * fd.dx
    L = fd.inner(f, v) * fd.dx
    bcs = [fd.DirichletBC(V, f, "on_boundary")]
    uh = fd.Function(V)
    solver = fd.LinearVariationalSolver(
        fd.LinearVariationalProblem(a, L, uh, bcs=bcs),
        solver_parameters=params)
    return dict(V=V, f=f, a=a, L=L, bcs=bcs, uh=uh, solver=solver)


def _gtmg_problem(fd, n, params=GTMG_SP):
    mesh = fd.UnitSquareMesh(n, n)
    x = fd.SpatialCoordinate(mesh)
    P1 = fd.FunctionSpace(mesh, "CG", 1)
    RT = fd.FunctionSpace(mesh, "RT", 1)
    DG = fd.FunctionSpace(mesh, "DG", 0)
    W = fd.MixedFunctionSpace([RT, DG])
    sigma, u = fd.TrialFunctions(W)
    tau, v = fd.TestFunctions(W)
    f = fd.Function(DG).interpolate(-2 * (x[0] - 1) * x[0]
                                    - 2 * (x[1] - 1) * x[1])
    a = (fd.inner(sigma, tau) - fd.inner(u, fd.div(tau))
         + fd.inner(fd.div(sigma), v)) * fd.dx
    w = fd.Function(W)
    appctx = {"get_coarse_space": lambda: P1,
              "get_coarse_operator": lambda: fd.inner(
                  fd.grad(fd.TrialFunction(P1)),
                  fd.grad(fd.TestFunction(P1))) * fd.dx,
              "coarse_space_bcs": fd.DirichletBC(P1, 0.0, "on_boundary")}
    solver = fd.LinearVariationalSolver(
        fd.LinearVariationalProblem(a, fd.inner(f, v) * fd.dx, w),
        solver_parameters=params, appctx=appctx)
    exact = fd.Function(DG).interpolate(x[0] * (1 - x[0]) * x[1]
                                        * (1 - x[1]))
    return dict(W=W, w=w, solver=solver, exact=exact, P1=P1)


def _nonnested_problem(fd, sizes=NN_SIZES, seeds=NN_SEEDS):
    hier = fd.NonNestedHierarchy(*[_jittered_mesh(fd, n, s)
                                   for n, s in zip(sizes, seeds)])
    mesh = hier[-1]
    V = fd.FunctionSpace(mesh, "CG", 1)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    x, y = fd.SpatialCoordinate(mesh)
    a = fd.inner(fd.grad(u), fd.grad(v)) * fd.dx
    L = 2 * (x * (1 - x) + y * (1 - y)) * v * fd.dx
    bc = fd.DirichletBC(V, 0.0, "on_boundary")
    uh = fd.Function(V)
    solver = fd.LinearVariationalSolver(
        fd.LinearVariationalProblem(a, L, uh, bcs=[bc]),
        solver_parameters=NN_SP)
    exact = fd.Function(V).interpolate(x * (1 - x) * y * (1 - y))
    return dict(V=V, a=a, L=L, bc=bc, uh=uh, solver=solver, exact=exact)


def _supermesh_problem(fd, sizes=SM_SIZES):
    ms, md = (_jittered_mesh(fd, n, s) for n, s in zip(sizes, SM_SEEDS))
    Vs, Vd = fd.FunctionSpace(ms, "CG", 1), fd.FunctionSpace(md, "CG", 1)
    x, y = fd.SpatialCoordinate(ms)
    f = fd.Function(Vs).interpolate(fd.sin(math.pi * x) * fd.sin(
        math.pi * y) + x)
    xd, yd = fd.SpatialCoordinate(md)
    exact = fd.sin(math.pi * xd) * fd.sin(math.pi * yd) + xd
    return dict(Vs=Vs, Vd=Vd, f=f, exact=exact)


def _transfer_errors(fd, label, p):
    """The case's error: the DG0 error of the hybridized solve, the nodal
    error of the non-nested solve, the projection's L2 error."""
    if label == "gtmg_hybrid_rt1_512":
        return fd.errornorm(p["exact"], p["w"].subfunctions[1])
    if label == "nonnested_gmg_p1_1024":
        return float((p["uh"].dat - p["exact"].dat).abs().max())
    return fd.errornorm(p["exact"], p["u"])


def _gate(failed, ok, text):
    print(("  gate ok: " if ok else "  GATE FAILED: ") + text)
    if not ok:
        failed.append(text)


def _its_gate(failed, label, its):
    want = TRANSFER_ITS[label]
    _gate(failed, want is not None and abs(its - want) <= 1,
          f"{label}: {its} CG iterations, the CPU rehearsal took {want}")


HIP_STAGES = (
    ("hiptmair_setup", _TP + "solvers.hiptmair", "HiptmairPC.initialize_ctx"),
    ("build_G", _TP + "interpolation", "operator_matrix"),
    ("transpose_G", _TP + "assembly.matrix", "Matrix.transpose"),
    ("potential_mg_setup", _TP + "mg.vcycle", "GMGPreconditioner"),
    ("solve", _TP + "solving", "_run_ksp"))


def hiptmair_run(fd, label="hiptmair_n1curl_576"):
    """CG + HiptmairPC on the H(curl) Riesz map of a constant; Jacobi-CG's
    count beside it; G's build, matvec and transpose times."""
    failed = []
    torch.cuda.reset_peak_memory_stats()
    p, setup_s = _sync_time(lambda: _hiptmair_problem(fd))
    with _Counts() as counts, _StageTimes(HIP_STAGES) as st, \
            _K1Inputs() as k1in:
        _, solve_s = _sync_time(p["solver"].solve)
    its = p["solver"].ksp_iterations
    err = fd.errornorm(p["f"], p["uh"])
    G = st.results["build_G"][0]
    GT = G.transpose()
    zc = torch.ones(G.shape[1], dtype=torch.float64, device="cuda")
    zf = torch.ones(G.shape[0], dtype=torch.float64, device="cuda")
    mv = _cuda_ms(lambda: G.matvec(zc), reps=20, warm=3)
    tmv = _cuda_ms(lambda: GT.matvec(zf), reps=20, warm=3)
    sa_mv = _cuda_ms(lambda: G.transpose_matvec(zf), reps=20, warm=3)
    sec = st.secs
    print(f"{label}: dofs {p['V'].dim} potential_dofs {G.shape[1]} "
          f"problem_setup_s {setup_s:.3f} first_solve_s {solve_s:.3f} "
          f"hiptmair_setup_s {sec['hiptmair_setup']:.3f} (inclusive: "
          f"build_G_s {sec['build_G']:.3f} transpose_G_s "
          f"{sec['transpose_G']:.3f} potential_mg_setup_s "
          f"{sec['potential_mg_setup']:.3f}) solve_s {sec['solve']:.3f} "
          f"iterations {its} ms_per_iteration "
          f"{1e3 * sec['solve'] / max(its, 1):.4f} errornorm_f "
          f"{err:.3e} G nnz {G.nnz} G_matvec_ms {mv:.4f} "
          f"GT_matvec_ms {tmv:.4f} (transpose_matvec scatter-add "
          f"{sa_mv:.4f}) device_peak {torch.cuda.max_memory_allocated()} "
          f"k1_launches {counts.k1} lowerer_evals {counts.lowerer}")
    k1in.check(label, counts.k1)
    # Jacobi-CG on the same problem, for its count
    uj = fd.Function(p["V"])
    jac = fd.LinearVariationalSolver(
        fd.LinearVariationalProblem(p["a"], p["L"], uj, bcs=p["bcs"]),
        solver_parameters=HIP_JACOBI_SP)
    _, jac_s = _sync_time(jac.solve)
    print(f"{label}: jacobi_cg iterations {jac.ksp_iterations} "
          f"converged {jac.converged} solve_s {jac_s:.3f} (hiptmair {its})")
    _gate(failed, p["uh"].dat.is_cuda and p["solver"].converged,
          f"{label}: converged on the card")
    _gate(failed, err < HIP_RIESZ_ERR,
          f"{label}: errornorm(f, u_h) {err:.3e} < {HIP_RIESZ_ERR}")
    _its_gate(failed, label, its)
    _gate(failed, counts.k1 > 0, f"{label}: K1 launched {counts.k1}")
    del p, jac, uj, st, G, GT
    return counts, failed


GTMG_STAGES = (
    ("slate_assembly", _TP + "solvers.hybridization", "assemble_slate"),
    ("k2", _TP + "ops.batched_inverse", "batched_inv"),
    ("gtmg_setup", _TP + "solvers.gtmg", "GTMGPC.initialize_ctx"),
    ("interpolation_matrix", _TP + "interpolation", "Interpolator.assemble"),
    ("trace_cg", _TP + "solvers.krylov", "KSP_METHODS.cg"),
    ("back_substitution", _TP + "solvers.hybridization",
     "_back_substitute"))


def gtmg_run(fd, label="gtmg_hybrid_rt1_512"):
    """The hybridized mixed Poisson, its trace by CG + GTMGPC, stage times
    by CUDA events; K2 held bit for bit to its plain version on the
    path's own blocks."""
    failed = []
    torch.cuda.reset_peak_memory_stats()
    p, setup_s = _sync_time(lambda: _gtmg_problem(fd, GTMG_N))
    with _Counts() as counts, _EventStages(GTMG_STAGES) as st, \
            _K1Inputs() as k1in:
        _, solve_s = _sync_time(p["solver"].solve)
    its = p["solver"].ksp_iterations
    err = _transfer_errors(fd, label, p)
    ms = st.ms()
    print(f"{label}: dofs {p['W'].dim} coarse_dofs {p['P1'].dim} "
          f"problem_setup_s {setup_s:.3f} solve_s {solve_s:.3f} stage_ms "
          "(exclusive/inclusive/calls) "
          + " ".join(f"{k} {v[0]:.3f}/{v[1]:.3f}/{v[2]}"
                     for k, v in ms.items())
          + f" trace_cg_iterations {its} (hybridized_rt2_256's Jacobi "
          f"trace solve: 1440) l2_err_u {err:.4e} device_peak "
          f"{torch.cuda.max_memory_allocated()} k1_launches {counts.k1} "
          f"k2_launches {counts.k2} lowerer_evals {counts.lowerer}")
    k1in.check(label, counts.k1)
    row = _k2_path_row(label, st.first_args["k2"][0])
    bound = TRANSFER_ERR[label]
    _gate(failed, p["w"].dat.is_cuda and p["solver"].converged,
          f"{label}: converged on the card")
    _gate(failed, bound is not None and err < bound,
          f"{label}: DG0 error {err:.4e} < {bound}")
    _its_gate(failed, label, its)
    _gate(failed, counts.k1 > 0 and counts.k2 > 0,
          f"{label}: K1 launched {counts.k1}, K2 {counts.k2}")
    _gate(failed, row["bit_for_bit"],
          f"{label}: K2 bit for bit with its plain version on "
          f"{tuple(row['shape'])}")
    del p, st
    return counts, failed, row


NN_STAGES = (
    ("cross_mesh_matrix", _TP + "interpolation", "cross_mesh_scalar_matrix"),
    ("point_location", _TP + "interpolation", "_locate_robust"),
    ("pc_setup", _TP + "mg.vcycle", "GMGPreconditioner"),
    ("level_assembly", _TP + "assemble", "assemble"),
    ("solve", _TP + "solving", "_run_ksp"))


def nonnested_run(fd, label="nonnested_gmg_p1_1024"):
    """CG + GMG over the non-nested jittered meshes; the cross-mesh
    transfers' build timed apart (each level pair: the fine nodes located
    in the coarse mesh, then the reverse); the same solve at NN_SMALL on
    the card and the CPU in this process."""
    failed = []
    torch.cuda.reset_peak_memory_stats()
    p, setup_s = _sync_time(lambda: _nonnested_problem(fd))
    with _Counts() as counts, _StageTimes(NN_STAGES) as st, \
            _K1Inputs() as k1in:
        _, solve_s = _sync_time(p["solver"].solve)
    its = p["solver"].ksp_iterations
    err = _transfer_errors(fd, label, p)
    rel = _rel_residual(fd, p["a"], p["L"], p["bc"], p["uh"])
    sec, calls = st.secs, st.calls
    pairs = [f"{a:.3f}/{b:.3f}" for a, b in zip(
        calls["point_location"][0::2], calls["point_location"][1::2])]
    print(f"{label}: meshes {NN_SIZES} jitter {NN_JITTER} dofs "
          f"{p['V'].dim} problem_setup_s {setup_s:.3f} first_solve_s "
          f"{solve_s:.3f} pc_setup_s {sec['pc_setup']:.3f} "
          f"(inclusive: cross_mesh_matrix_s {sec['cross_mesh_matrix']:.3f}"
          f", point location fine-in-coarse/coarse-in-fine s per level "
          f"pair {' '.join(pairs)}; level_assembly_s "
          f"{sec['level_assembly']:.3f}) solve_s {sec['solve']:.3f} "
          f"iterations {its} ms_per_iteration "
          f"{1e3 * sec['solve'] / max(its, 1):.4f} rel_residual {rel:.3e} "
          f"max_nodal_err {err:.4e} device_peak "
          f"{torch.cuda.max_memory_allocated()} k1_launches {counts.k1} "
          f"lowerer_evals {counts.lowerer}")
    k1in.check(label, counts.k1)
    # the same solve at NN_SMALL on the card and on the CPU, in process
    small = _nonnested_problem(fd, NN_SMALL)
    small["solver"].solve()
    fd.set_device("cpu")
    try:
        small_cpu = _nonnested_problem(fd, NN_SMALL)
        small_cpu["solver"].solve()
    finally:
        fd.set_device(torch.device("cuda"))
    ref = small_cpu["uh"].dat
    diff = float((small["uh"].dat.cpu() - ref).abs().max()
                 / ref.abs().max())
    print(f"{label}: at {NN_SMALL} card_vs_cpu {diff:.3e} iterations "
          f"{small['solver'].ksp_iterations} (cpu "
          f"{small_cpu['solver'].ksp_iterations})")
    bound = TRANSFER_ERR[label]
    _gate(failed, p["uh"].dat.is_cuda and p["solver"].converged,
          f"{label}: converged on the card")
    _gate(failed, rel <= 1e-10, f"{label}: rel_residual {rel:.3e} <= 1e-10")
    _gate(failed, bound is not None and err < bound,
          f"{label}: nodal error {err:.4e} < {bound}")
    _gate(failed, diff <= NN_CARD_CPU,
          f"{label}: card and CPU at {NN_SMALL} within {NN_CARD_CPU}")
    _its_gate(failed, label, its)
    _gate(failed, counts.k1 > 0, f"{label}: K1 launched {counts.k1}")
    del p, st, small, small_cpu
    return counts, failed


SM_STAGES = (
    ("candidate_pairs", _TP + "supermesh", "_candidate_pairs"),
    ("clipping", _TP + "supermesh", "_pair_masses_2d"),
    ("accumulation", _TP + "assembly.matrix", "entry_matrix"),
    ("target_mass", _TP + "assemble", "assemble"),
    ("mass_solve", _TP + "solving", "direct_solve"))


def _small_mixed_mass(fd, device):
    fd.set_device(device)
    try:
        p = _supermesh_problem(fd, SM_SMALL)
        M = fd.assemble_mixed_mass_matrix(p["Vd"], p["Vs"])
        return M.sparsity, M.data.cpu()
    finally:
        fd.set_device(torch.device("cuda"))


def _row_sum_sources(fd, p, phi):
    """The mixed mass matrix's row sums against int phi_i, taken apart by
    the two tolerances of the clipping (the JAX package's): each row
    summed by index_add_ over the pairs' local matrices as built (_EPS,
    _MIN_DETJ), with every fan piece kept (_MIN_DETJ = 0), and with exact
    clipping as well (_EPS = 0).  Returns the three row-sum vectors."""
    from firedrake_tpu_torch import supermesh as SM
    from firedrake_tpu_torch.elements.quadrature import make_quadrature
    VA, VB = p["Vd"], p["Vs"]
    mA, mB = VA.mesh_obj, VB.mesh_obj
    xA = mA._vertex_coords[mA.topology.cell_vertices]
    xB = mB._vertex_coords[mB.topology.cell_vertices]
    a, b = SM._candidate_pairs(xA, xB)
    dev = phi.device
    ia, ib = (torch.as_tensor(i, device=dev) for i in (a, b))
    args = (torch.as_tensor(SM._cell_loops(xA, "triangle"), device=dev)[ia],
            torch.as_tensor(SM._cell_loops(xB, "triangle"), device=dev)[ib],
            torch.as_tensor(xA, device=dev)[ia],
            torch.as_tensor(xB, device=dev)[ib], True, VA.scalar_element,
            VB.scalar_element, make_quadrature("triangle", 2),
            np.asarray(mA.cell.vertices, dtype=float))
    rows_of = torch.as_tensor(np.asarray(VA.cell_node_map, dtype=np.int64),
                              device=dev)[ia].reshape(-1)
    saved = SM._EPS, SM._MIN_DETJ
    out = []
    try:
        for eps, min_detj in (saved, (saved[0], 0.0), (0.0, 0.0)):
            SM._EPS, SM._MIN_DETJ = eps, min_detj
            loc, _ = SM._pair_masses_2d(*args)
            out.append(torch.zeros_like(phi).index_add_(
                0, rows_of, loc.sum(dim=-1).reshape(-1)))
            del loc
    finally:
        SM._EPS, SM._MIN_DETJ = saved
    return out


def supermesh_run(fd, label="supermesh_p1_512_384"):
    """supermesh_project across the jittered meshes: candidate pairs on
    the host, clipping and integration on the card, the accumulation,
    the mass solve, each timed; conservation and the mixed mass
    matrix's row sums, taken apart by the clipping's two tolerances; the
    clipping held to the CPU at SM_SMALL."""
    from firedrake_tpu_torch.supermesh import supermesh_project
    failed = []
    torch.cuda.reset_peak_memory_stats()
    p, setup_s = _sync_time(lambda: _supermesh_problem(fd))
    with _Counts() as counts, _StageTimes(SM_STAGES) as st, \
            _K1Inputs() as k1in:
        p["u"], proj_s = _sync_time(
            lambda: supermesh_project(p["f"], p["Vd"]))
    M = st.results["accumulation"][0]
    sec = st.secs
    mass_f = float(fd.assemble(p["f"] * fd.dx))
    mass_u = float(fd.assemble(p["u"] * fd.dx))
    phi = fd.assemble(fd.TestFunction(p["Vd"]) * fd.dx).dat
    rows = M.matvec(torch.ones(M.shape[1], dtype=torch.float64,
                               device="cuda"))
    row_abs = float((rows - phi).abs().max())
    phi_max = float(phi.abs().max())
    # the miss taken apart: the fan pieces below _MIN_DETJ, the clipping
    # tolerance _EPS, and what is left with neither (rounding)
    r_jax, r_keep, r_exact = _row_sum_sources(fd, p, phi)
    dropped, tol = r_keep - r_jax, r_exact - r_keep
    left = float((r_exact - phi).abs().max())
    by_add = float((r_jax - phi).abs().max())
    w = int((rows - phi).abs().argmax())
    print(f"{label}: row sums against int phi_i (max {phi_max:.4e}): "
          f"matrix {row_abs:.3e}; by index_add_ {by_add:.3e}"
          f" of which dropped fan pieces {float(dropped.abs().max()):.3e} "
          f"({int((dropped != 0).sum())} rows) and the clipping tolerance "
          f"{float(tol.abs().max()):.3e} ({int((tol != 0).sum())} rows); "
          f"with both off {left:.3e} (relative {left / phi_max:.3e}); "
          f"worst row {w}: miss {float(rows[w] - phi[w]):.3e} dropped "
          f"{float(dropped[w]):.3e} tolerance {float(tol[w]):.3e} left "
          f"{float(r_exact[w] - phi[w]):.3e}")
    err = _transfer_errors(fd, label, p)
    dP, mP = _small_mixed_mass(fd, "cuda"), _small_mixed_mass(fd, "cpu")
    same = (np.array_equal(dP[0].coo_rows, mP[0].coo_rows)
            and np.array_equal(dP[0].coo_cols, mP[0].coo_cols))
    small_diff = float((dP[1] - mP[1]).abs().max() / mP[1].abs().max()) \
        if same else float("inf")
    npairs = len(st.results["candidate_pairs"][0][0])
    print(f"{label}: cells {p['Vs'].mesh().num_cells} -> "
          f"{p['Vd'].mesh().num_cells} candidate_pairs {npairs} "
          f"mixed_mass nnz {M.nnz} problem_setup_s {setup_s:.3f} "
          f"project_s {proj_s:.3f} "
          + " ".join(f"{k}_s {v:.3f}" for k, v in sec.items())
          + f" |int u - int f|/|int f| {abs(mass_u - mass_f) / abs(mass_f):.3e}"
          f" row_sums_vs_int_phi {row_abs:.3e} (relative "
          f"{row_abs / phi_max:.3e}) l2_err {err:.4e} small "
          f"{SM_SMALL} card_vs_cpu {small_diff:.3e} pattern_equal {same} "
          f"device_peak {torch.cuda.max_memory_allocated()} k1_launches "
          f"{counts.k1}")
    k1in.check(label, counts.k1)
    bound = TRANSFER_ERR[label]
    _gate(failed, p["u"].dat.is_cuda, f"{label}: projection on the card")
    _gate(failed, abs(mass_u - mass_f) <= SM_CONSERVE * abs(mass_f),
          f"{label}: mass conserved within {SM_CONSERVE}")
    _gate(failed, left <= SM_ROWSUM * phi_max,
          f"{label}: with exact clipping and every fan piece, row sums "
          f"equal int phi_i within {SM_ROWSUM} relative")
    _gate(failed, row_abs <= SM_ROWSUM_ABS,
          f"{label}: row sums of the matrix equal int phi_i within "
          f"{SM_ROWSUM_ABS} absolute")
    _gate(failed, bound is not None and err < bound,
          f"{label}: L2 error {err:.4e} < {bound}")
    _gate(failed, small_diff <= SM_CARD_CPU,
          f"{label}: clipping on the card equals the CPU's at {SM_SMALL}")
    _gate(failed, counts.k1 > 0, f"{label}: K1 launched {counts.k1}")
    del p, st, M, r_jax, r_keep, r_exact
    return counts, failed


def transfer_phase():
    """hiptmair_n1curl_576, gtmg_hybrid_rt1_512, nonnested_gmg_p1_1024,
    supermesh_p1_512_384; every gate is checked after all four ran."""
    t0 = phase("transfer")
    import firedrake_tpu_torch as fd
    fd.set_device(torch.device("cuda"))
    used, failed = {}, []
    used["hiptmair_n1curl_576"], f = hiptmair_run(fd)
    failed += f
    _release("hiptmair_n1curl_576")
    used["gtmg_hybrid_rt1_512"], f, k2_row = gtmg_run(fd)
    failed += f
    _release("gtmg_hybrid_rt1_512")
    used["nonnested_gmg_p1_1024"], f = nonnested_run(fd)
    failed += f
    _release("nonnested_gmg_p1_1024")
    used["supermesh_p1_512_384"], f = supermesh_run(fd)
    failed += f
    _release("supermesh_p1_512_384")
    if failed:
        raise AssertionError("transfer phase: " + "; ".join(failed))
    phase_done("transfer", t0)
    return used, {"gtmg_hybrid_rt1_512": k2_row}


def transfer_cpu(labels, tag, study=False):
    """The transfer phase's cases on the CPU: at full size (the CG counts
    the card must match; run on the card's host) or at the study's sizes
    (the errors, their ratios and the extrapolation to full size)."""
    import firedrake_tpu_torch as fd
    from firedrake_tpu_torch.supermesh import supermesh_project
    fd.set_device("cpu")
    for label in labels:
        if label not in TRANSFER_LABELS:
            continue
        if study and label not in TRANSFER_STUDY:
            continue
        full = {"gtmg_hybrid_rt1_512": GTMG_N,
                "nonnested_gmg_p1_1024": NN_SIZES[-1],
                "supermesh_p1_512_384": SM_SIZES[0]}.get(label)
        sizes = TRANSFER_STUDY[label] if study else (full,)
        errs = []
        for n in sizes:
            t0 = time.perf_counter()
            its = None
            if label == "hiptmair_n1curl_576":
                p = _hiptmair_problem(fd)
                p["solver"].solve()
                its, err = p["solver"].ksp_iterations, fd.errornorm(
                    p["f"], p["uh"])
            elif label == "gtmg_hybrid_rt1_512":
                p = _gtmg_problem(fd, n)
                p["solver"].solve()
                its = p["solver"].ksp_iterations
            elif label == "nonnested_gmg_p1_1024":
                p = _nonnested_problem(fd, tuple(
                    k * n // NN_SIZES[-1] for k in NN_SIZES))
                p["solver"].solve()
                its = p["solver"].ksp_iterations
            else:
                p = _supermesh_problem(fd, (n, n * SM_SIZES[1]
                                            // SM_SIZES[0]))
                p["u"] = supermesh_project(p["f"], p["Vd"])
            if label != "hiptmair_n1curl_576":
                err = _transfer_errors(fd, label, p)
            errs.append(err)
            rate = ("" if len(errs) < 2 else
                    f" ratio {errs[-2] / errs[-1]:.3f}")
            print(f"{tag} {label} n {n}: iterations {its} err {err:.4e}"
                  f"{rate} seconds {time.perf_counter() - t0:.1f} "
                  f"host_max_rss_gib {_max_rss_gib():.2f}", flush=True)
        if study and len(errs) >= 2:
            r = errs[-2] / errs[-1]
            steps = round(math.log2(full / sizes[-1]))
            print(f"{tag} {label}: extrapolated to n {full}: "
                  f"{errs[-1] / r ** steps:.4e} (last ratio {r:.3f} over "
                  f"{steps} halvings); bound (twice) "
                  f"{2 * errs[-1] / r ** steps:.4e}", flush=True)


def main():
    t0 = time.perf_counter()
    device_phase()
    build_phase()
    k1, k2, k2_large = kernels_phase()
    used = main_phase()
    gathered, matvec = gather_phase()
    used.update(gathered)
    used.update(nonlinear_phase())
    dg_mixed, block_mv = dg_mixed_phase()
    used.update(dg_mixed)
    slate_used, k2_paths = slate_phase()
    used.update(slate_used)
    used.update(extruded_phase())
    fs_used, vanka_rows = fieldsplit_phase()
    used.update(fs_used)
    ml_used, line_rows = multilevel_phase()
    used.update(ml_used)
    ddm_used, huge_rows = ddm_phase()
    used.update(ddm_used)
    used.update(adjoint_phase())
    used.update(meshio_phase())
    transfer_used, transfer_k2 = transfer_phase()
    used.update(transfer_used)
    used["gmg_p2_tet_16m"], k1_action = north_star_phase()
    for label, c in used.items():
        print(f"launches {label}: k1 {c.k1} k2 {c.k2} k2_large "
              f"{c.k2_large} k2_huge {c.k2_huge} k2_pivot {c.k2_pivot}")
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
         "torch_ms": k2["library_ms"],
         # on the slate phase's own blocks: hybridized_rt2_256's packed
         # broken mixed matrices, scpc_p5_128's interior blocks, and
         # gtmg_hybrid_rt1_512's (transfer phase)
         "paths": {**k2_paths, **transfer_k2}},
        # the large variant (33 <= n <= 128), same source: the Vanka
        # patches (n = 39) of the fieldsplit phase, the line (n = 65) and
        # extruded star (n = 117) patches of the multilevel phase
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
         "library_ms": k2_large["library_ms"],
         # 2 n^3 nb unfused operations at the FP64 pipe's rate, and the
         # launch plan (R, r, threads, shared memory, blocks per SM)
         "floor_ms": k2_large["floor_ms"],
         "plan": k2_large["plan"],
         # on the Vanka patches: stokes_th_vanka_24's solve, and
         # stokes_th_schur_256's operator at full width; on the line
         # patches of linesmooth_q1_ext_128's finest level and the star
         # patches of extruded_star_q2_ext_6
         "paths": {**vanka_rows, **line_rows}},
        # the huge variant (n > 128, blocked Gauss-Jordan by panels of w
        # columns, its update on the FP64 tensor cores), same source: BDDC's
        # interior blocks, saddle systems (pivoted) and primal Schur
        # complement on bddc_p1_1024 (its own path's count), the 129-dof
        # lines of linesmooth_cap_129; timed on 64 of bddc_p1_1024's own
        # M_int blocks (the row's numbers) and K blocks (in "paths")
        {"name": "batched_inv_huge",
         "route": "cuda",
         "source": "firedrake_tpu_torch/csrc/batched_inv.cu",
         "replaces": "firedrake_tpu/ops/batched_inverse.py:60",
         "launches": used["bddc_p1_1024"].k2_huge,
         "launches_by_path": {k: c.k2_huge for k, c in used.items()},
         "pivot_launches_by_path": {k: c.k2_pivot
                                    for k, c in used.items()},
         "shape": huge_rows["bddc_p1_1024 M_int"]["shape"],
         "max_abs_err": huge_rows["bddc_p1_1024 M_int"]["max_abs_err"],
         "ms": huge_rows["bddc_p1_1024 M_int"]["ms"],
         "call_ms": huge_rows["bddc_p1_1024 M_int"]["call_ms"],
         "plain_ms": huge_rows["bddc_p1_1024 M_int"]["plain_ms"],
         "bound_ms": huge_rows["bddc_p1_1024 M_int"]["bound_ms"],
         "bound_by": huge_rows["bddc_p1_1024 M_int"]["bound_by"],
         "library_ms": huge_rows["bddc_p1_1024 M_int"]["library_ms"],
         "w": huge_rows["bddc_p1_1024 M_int"]["w"],
         "launches_per_call":
             huge_rows["bddc_p1_1024 M_int"]["launches_per_call"],
         "paths": huge_rows}],
        # the CSR matrix's SpMV at 1,050,625 rows (torch ops, no kernel)
        "gather_matvec_ms": matvec,
        # poisson_mixed_rt1_256's BlockMatrix matvec (torch ops, no kernel)
        "block_matvec_ms": block_mv}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def only(names):
    """The device and build phases, then the named phases alone (for
    trying one phase on the card); prints no result line."""
    device_phase()
    build_phase()
    phases = {"main": main_phase, "slate": slate_phase,
              "dg_mixed": dg_mixed_phase,
              "gather": gather_phase, "nonlinear": nonlinear_phase,
              "extruded": extruded_phase, "fieldsplit": fieldsplit_phase,
              "multilevel": multilevel_phase, "pcd_limit": pcd_limit,
              "ddm": ddm_phase, "adjoint": adjoint_phase,
              "meshio": meshio_phase, "transfer": transfer_phase,
              "ml_rounding": ml_rounding}
    for name in names:
        phases[name]()
    print("only: done")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--only"]:
        only(sys.argv[2:])
    elif sys.argv[1:2] == ["--cpu-rehearsal"]:
        cpu_rehearsal(sys.argv[2:])
    elif sys.argv[1:2] == ["--cpu-study"]:
        cpu_study(sys.argv[2:])
    else:
        main()
