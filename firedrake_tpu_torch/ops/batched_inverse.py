"""K2: batched small dense inverse (Gauss-Jordan).

Replaces ``firedrake_tpu/ops/batched_inverse.py`` (``_pallas_batched_inv``,
body ``_gj_kernel``; entry points ``batched_inv`` and ``batched_solve``).
Role: the dense local inverses behind the patch smoothers
(solvers/preconditioners.py), later Slate, static condensation and BDDC.

``batched_inv(A)`` inverts over the last two axes of a (..., n, n) batch:

* n <= 3: the closed-form cofactor inverse (compiler/smallmat.py);
* CPU tensors: ``batched_inv_plain``, the TPU kernel's Gauss-Jordan without
  pivoting, transcribed to torch in the same order of operations;
* CUDA tensors with 4 <= n <= 32: the hand-written kernel
  (``csrc/batched_inv.cu``: in-place elimination, one row per lane,
  floor(32 / n) matrices per warp), counted in ``kernel_launches``;
* CUDA tensors with 33 <= n <= 128: the kernel's large variant in the
  same source (in place in shared memory, one thread per row, floor(128
  / n) matrices per block), counted in ``kernel_launches`` and
  ``large_launches``; larger n raises, naming the cap and the batch
  (the JAX package has no cap; nothing falls back to another inverse).

Both variants round as ``batched_inv_plain`` does, so each agrees with it
bit for bit up to signed zeros.

Unlike the JAX package there is no ``force_pallas``/``interpret`` switch and
no padding of the batch to a multiple of 256: the kernel takes any batch.
"""
from __future__ import annotations

import ctypes

import torch

from ..compiler import nvcc
from ..compiler.smallmat import inv as _cofactor_inv

__all__ = ["batched_inv", "batched_solve", "batched_inv_plain"]

#: launches of the CUDA kernel, both variants (counted where it launches,
#: nowhere else)
kernel_launches = 0
#: launches of the large variant alone
large_launches = 0
#: largest n of the warp variant (a lane holds a row, a warp has 32 lanes)
WARP_N = 32
#: largest n the kernel takes (the large variant's n x (n + 1) block in
#: shared memory: 133 KB in float64)
MAX_N = 128

_SRC = nvcc.source("batched_inv.cu")
_lib = None


def batched_inv_plain(A):
    """Gauss-Jordan without pivoting over the last two axes of A, as
    ``_gj_kernel`` computes it: for each pivot k, scale row k by 1/A[k, k]
    and eliminate column k from every other row, on [A | I]."""
    n = A.shape[-1]
    M = A
    X = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    rows = torch.arange(n, device=A.device)
    for k in range(n):
        inv_piv = 1.0 / M[..., k, k][..., None, None]
        rowM = M[..., k, :][..., None, :] * inv_piv
        rowX = X[..., k, :][..., None, :] * inv_piv
        colM = M[..., :, k][..., :, None]
        M = M - colM * rowM
        X = X - colM * rowX
        sel = (rows == k)[:, None]
        M = torch.where(sel, rowM, M)
        X = torch.where(sel, rowX, X)
    return X


def build():
    """Compile csrc/batched_inv.cu for sm_90a (once per source version)
    and load it.  Returns the build seconds (0 when already built)."""
    global _lib
    if _lib is not None:
        return 0.0
    lib = nvcc.load(_SRC)
    for fn in (lib.fdt_batched_inv, lib.fdt_batched_inv_large):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    _lib = lib
    return nvcc.build_logs.get(_SRC, (0.0, ""))[0]


def _launch(A):
    global kernel_launches, large_launches
    n = A.shape[-1]
    if n > MAX_N:
        nb = A.numel() // (n * n)
        raise ValueError(
            f"batched_inv: the CUDA kernel takes blocks of n <= {MAX_N} "
            f"(its large variant's block in shared memory); got {nb} "
            f"blocks of n = {n}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"batched_inv takes float32/float64, got {A.dtype}")
    A2 = A.reshape(-1, n, n).contiguous()
    out = torch.empty_like(A2)
    if A2.shape[0] == 0:
        return out.reshape(A.shape)
    build()
    large = n > WARP_N
    fn = _lib.fdt_batched_inv_large if large else _lib.fdt_batched_inv
    with torch.cuda.device(A.device):
        rc = fn(int(A.dtype == torch.float64), A2.data_ptr(),
                out.data_ptr(), A2.shape[0], n,
                nvcc.current_stream(A.device))
    if rc != 0:
        raise RuntimeError(f"batched_inv kernel launch failed: code {rc}")
    kernel_launches += 1
    large_launches += large
    return out.reshape(A.shape)


def batched_inv(A):
    """Inverse over the last two axes of a (..., n, n) batch."""
    if A.shape[-1] != A.shape[-2]:
        raise ValueError(f"batched_inv: blocks {tuple(A.shape[-2:])} are "
                         "not square")
    if A.shape[-1] <= 3:
        return _cofactor_inv(A)
    if A.device.type == "cpu":
        return batched_inv_plain(A)
    if A.device.type != "cuda":
        raise RuntimeError(f"batched_inv: no kernel for {A.device}")
    return _launch(A)


def batched_solve(A, b):
    """Solve A x = b batched over leading axes, through batched_inv; b is
    a vector (..., n) or a matrix (..., n, k) per block."""
    Ainv = batched_inv(A)
    if b.ndim == A.ndim - 1:
        return torch.einsum("...ij,...j->...i", Ainv, b)
    return torch.einsum("...ij,...jk->...ik", Ainv, b)
