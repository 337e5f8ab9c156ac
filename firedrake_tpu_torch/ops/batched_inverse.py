"""K2: batched small dense inverse (Gauss-Jordan).

Replaces ``firedrake_tpu/ops/batched_inverse.py`` (``_pallas_batched_inv``,
body ``_gj_kernel``; entry points ``batched_inv`` and ``batched_solve``).
Role: the dense local inverses behind the patch smoothers
(solvers/preconditioners.py), Slate, static condensation and BDDC.

``batched_inv(A, pivot=False)`` inverts over the last two axes of a
(..., n, n) batch:

* n <= 3: the closed-form cofactor inverse (compiler/smallmat.py);
* CPU tensors: ``batched_inv_plain``, the TPU kernel's Gauss-Jordan without
  pivoting, transcribed to torch in the same order of operations, or with
  ``pivot=True`` the same with partial pivoting (what the JAX package gets
  from ``jnp.linalg.inv`` on the CPU);
* CUDA tensors: the hand-written kernel (``csrc/batched_inv.cu``), counted
  in ``kernel_launches``, in one of three variants by n (``variant``):
  4 <= n <= 32 the warp variant (in-place elimination, one row per lane,
  floor(32 / n) matrices per warp); 33 <= n <= 128 the large variant (one
  matrix per block of R^2 threads, each thread an r x r tile of it in
  registers, laid out cyclically; only column k and row k of pivot step
  k pass through shared memory, with one barrier per step; a persistent
  grid stages each block's next matrix with cp.async while it eliminates
  the current one; the plan, R, r and the shared memory, is
  ``large_plan``'s; also counted in ``large_launches``, the last call's
  occupancy in ``large_report``); n > 128 the huge variant
  (in place in global memory, Gauss-Jordan blocked by panels of w = 64
  columns: per panel one launch eliminates the panel's columns, one
  copies its rows to scratch and one applies the rank-64 update to the
  rest, on the FP64 tensor cores in float64; also counted in
  ``huge_launches``, once per call, and its kernels, as the library
  reports them, in ``huge_kernels``; ``huge_report`` holds the last
  call's report).  Each takes the
  ``pivot`` flag (counted in ``pivot_launches``).  Nothing falls back to
  another inverse: a failed build or launch raises.

The warp and large variants round as ``batched_inv_plain`` does, pivoted
or not, so each agrees with it bit for bit up to signed zeros.  The huge
variant sums its panel products in another order, with FMAs, and is held
to the plain version relative to ``torch.linalg.inv`` of the same blocks
(chip_smoke.py ``huge_gate``).

Unlike the JAX package there is no ``force_pallas``/``interpret`` switch and
no padding of the batch to a multiple of 256: the kernel takes any batch.
"""
from __future__ import annotations

import ctypes

import torch

from ..compiler import nvcc
from ..compiler.smallmat import inv as _cofactor_inv

__all__ = ["batched_inv", "batched_solve", "batched_inv_plain"]

#: launches of the CUDA kernel, every variant (counted where it launches,
#: nowhere else)
kernel_launches = 0
#: launches of the large variant alone
large_launches = 0
#: launches of the huge variant alone (one per call: its panel launches
#: are counted together)
huge_launches = 0
#: kernels the huge variant's calls launched, as the library counts them
#: where it launches each
huge_kernels = 0
#: the last huge-variant call's report: kernels launched, panel width w,
#: sub-panel width b, and whether the sub-panel sat in shared memory
huge_report = {}
#: the last large-variant call's plan and occupancy: R, r, threads and
#: shared memory per block (``large_plan``), blocks per SM, grid blocks
large_report = {}
#: launches in the pivoted mode, any variant
pivot_launches = 0
#: largest n of the warp variant (a lane holds a row, a warp has 32 lanes)
WARP_N = 32
#: largest n of the large variant (a matrix in the registers of one
#: block, staged whole in shared memory: 128 KB in float64); above it the
#: huge variant
LARGE_N = 128

_SRC = nvcc.source("batched_inv.cu")
_lib = None


def variant(n):
    """The kernel variant that inverts blocks of size n on the card."""
    if n <= 3:
        return "cofactor"
    if n <= WARP_N:
        return "warp"
    return "large" if n <= LARGE_N else "huge"


def large_plan(n, dtype, pivot=False):
    """The large variant's launch for blocks of size n (33 <= n <= 128):
    one block of ``threads`` = R^2 threads per matrix, thread (tr, tc)
    holding the r x r tile of rows tr + R a and columns tc + R b (entries
    past n are padding), R = 8 to n = 72 and 16 above, r = ceil(n / R);
    ``smem`` bytes of shared memory (the staged next matrix, n^2 values
    in whole 16-byte pieces, column k and row k twice; pivoted also the
    old row k, two sets of warp candidates and the row labels), and
    ``tile_regs`` 32-bit registers for a thread's tile beside the kernel's
    ``reg_cap`` (its launch bounds)."""
    if not WARP_N < n <= LARGE_N:
        raise ValueError(f"large_plan: n = {n} is outside "
                         f"{WARP_N + 1}..{LARGE_N}")
    size = torch.empty((), dtype=dtype).element_size()
    R = 8 if n <= 72 else 16
    r = -(-n // R)
    nbk, threads = R * r, R * R
    per16 = 16 // size
    stage = -(-n * n // per16) * per16
    cand = 2 * threads // 32
    vals = stage + 4 * nbk + (nbk + cand if pivot else 0)
    ints = cand + nbk if pivot else 0
    return dict(R=R, r=r, threads=threads, smem=vals * size + ints * 4,
                tile_regs=r * r * size // 4, reg_cap=255)


def batched_inv_plain(A, pivot=False):
    """Gauss-Jordan over the last two axes of A, as ``_gj_kernel`` computes
    it: for each pivot k, scale row k by 1/A[k, k] and eliminate column k
    from every other row, on [A | I].  With ``pivot``, rows k and p of
    [A | I] are swapped first, p the first i >= k with the largest
    |A[i, k]| (torch.argmax's tie rule)."""
    n = A.shape[-1]
    nb = A.numel() // (n * n) if n else 0
    M = A.reshape(nb, n, n).clone()
    X = torch.eye(n, dtype=A.dtype, device=A.device).repeat(nb, 1, 1)
    b = torch.arange(nb, device=A.device)
    for k in range(n):
        if pivot:
            p = torch.argmax(M[:, k:, k].abs(), dim=-1) + k
            for Y in (M, X):
                rowk, rowp = Y[:, k, :].clone(), Y[b, p, :]
                Y[:, k, :] = rowp
                Y[b, p, :] = rowk
        inv_piv = 1.0 / M[:, k, k][:, None, None]
        rowM = M[:, k, :][:, None, :] * inv_piv
        rowX = X[:, k, :][:, None, :] * inv_piv
        colM = M[:, :, k][:, :, None].clone()
        M -= colM * rowM
        X -= colM * rowX
        M[:, k, :] = rowM[:, 0]
        X[:, k, :] = rowX[:, 0]
    return X.reshape(A.shape)


def build():
    """Compile csrc/batched_inv.cu for sm_90a (once per source version)
    and load it.  Returns the build seconds (0 when already built)."""
    global _lib
    if _lib is not None:
        return 0.0
    lib = nvcc.load(_SRC)
    lib.fdt_batched_inv.restype = ctypes.c_int
    lib.fdt_batched_inv.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.fdt_batched_inv_large.restype = ctypes.c_int
    lib.fdt_batched_inv_large.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.fdt_batched_inv_huge.restype = ctypes.c_int
    lib.fdt_batched_inv_huge.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.fdt_batched_inv_huge_scratch.restype = ctypes.c_longlong
    lib.fdt_batched_inv_huge_scratch.argtypes = [ctypes.c_int] * 4
    _lib = lib
    return nvcc.build_logs.get(_SRC, (0.0, ""))[0]


def _launch(A, pivot=False):
    global kernel_launches, large_launches, huge_launches, pivot_launches
    global huge_kernels, huge_report, large_report
    n = A.shape[-1]
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"batched_inv takes float32/float64, got {A.dtype}")
    if A.device.type != "cuda":
        raise RuntimeError(f"batched_inv: the CUDA kernel takes CUDA "
                           f"tensors; got one on {A.device}")
    A2 = A.reshape(-1, n, n).contiguous()
    out = torch.empty_like(A2)
    nb = A2.shape[0]
    if nb == 0:
        return out.reshape(A.shape)
    build()
    kind = variant(n)
    dbl = int(A.dtype == torch.float64)
    with torch.cuda.device(A.device):
        stream = nvcc.current_stream(A.device)
        if kind == "huge":
            # per matrix a panel's rows R (pivoted: and the rows its swaps
            # moved; beyond shared memory: the sub-panel), and pivoted the
            # row labels and the swap record
            vals, ints = (_lib.fdt_batched_inv_huge_scratch(
                dbl, n, int(pivot), i) for i in (0, 1))
            if vals < 0:
                raise RuntimeError(f"batched_inv: device query failed: "
                                   f"code {-vals}")
            rsc = torch.empty((nb, vals), dtype=A.dtype, device=A.device)
            iws = (torch.empty((nb, ints), dtype=torch.int32,
                               device=A.device) if ints else None)
            info = (ctypes.c_int * 4)()
            rc = _lib.fdt_batched_inv_huge(
                dbl, int(pivot), A2.data_ptr(), out.data_ptr(),
                rsc.data_ptr(), None if iws is None else iws.data_ptr(),
                nb, n, stream, info)
            huge_kernels += info[0]
            huge_report = dict(kernels=info[0], w=info[1], b=info[2],
                               sub_panel="shared" if info[3] else "global")
        elif kind == "large":
            plan = large_plan(n, A.dtype, pivot)
            info = (ctypes.c_int * 2)()
            rc = _lib.fdt_batched_inv_large(
                dbl, int(pivot), A2.data_ptr(), out.data_ptr(), nb, n,
                plan["R"], plan["r"], plan["smem"], stream, info)
            large_report = dict(R=plan["R"], r=plan["r"],
                                threads=plan["threads"], smem=plan["smem"],
                                blocks_per_sm=info[0], blocks=info[1])
        else:
            rc = _lib.fdt_batched_inv(dbl, int(pivot), A2.data_ptr(),
                                      out.data_ptr(), nb, n, stream)
    if rc != 0:
        raise RuntimeError(f"batched_inv kernel ({kind} variant, {nb} "
                           f"blocks of n = {n}) launch failed: code {rc}")
    kernel_launches += 1
    large_launches += kind == "large"
    huge_launches += kind == "huge"
    pivot_launches += bool(pivot)
    return out.reshape(A.shape)


def batched_inv(A, pivot=False):
    """Inverse over the last two axes of a (..., n, n) batch; ``pivot``:
    Gauss-Jordan with partial pivoting (for blocks that need it, such as
    BDDC's saddle-point systems)."""
    if A.shape[-1] != A.shape[-2]:
        raise ValueError(f"batched_inv: blocks {tuple(A.shape[-2:])} are "
                         "not square")
    if A.shape[-1] <= 3:
        return _cofactor_inv(A)
    if A.device.type == "cpu":
        return batched_inv_plain(A, pivot)
    if A.device.type != "cuda":
        raise RuntimeError(f"batched_inv: no kernel for {A.device}")
    return _launch(A, pivot)


def batched_solve(A, b):
    """Solve A x = b batched over leading axes, through batched_inv; b is
    a vector (..., n) or a matrix (..., n, k) per block."""
    Ainv = batched_inv(A)
    if b.ndim == A.ndim - 1:
        return torch.einsum("...ij,...j->...i", Ainv, b)
    return torch.einsum("...ij,...jk->...ik", Ainv, b)
