#!/usr/bin/env python
"""K2 (csrc/batched_inv.cu) against a copy of itself whose update is one
FMA instead of a rounded multiply and a rounded subtraction, on one
NVIDIA GPU:

    python scripts/torch_k2_fma.py

The copy is made from the kernel's source at run time and built beside
it in firedrake_tpu_torch/_build/.  For each shape of the patch
smoothers (n = 19 and n = 7, float64 and float32, random SPD blocks from
a seed) it prints the device time of both (chip_smoke's _device_ms, in
the turns kernel, fma, fma, kernel), the FMA copy's gain, and each one's
largest difference from the plain version (the kernel's is 0).  The
kernel keeps its exact rounding unless the gain exceeds 10%.
"""
import ctypes
import os
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke as S                                   # noqa: E402
from firedrake_tpu_torch.compiler import nvcc            # noqa: E402
from firedrake_tpu_torch.ops import batched_inverse as BI  # noqa: E402

UPDATE = "r[p + v] = sub_rn(r[p + v], mul_rn(c, x[v]));"
FMA = "r[p + v] = fma(-c, x[v], r[p + v]);"


def _fma_source():
    with open(BI._SRC) as fh:
        src = fh.read()
    if src.count(UPDATE) != 1:
        raise RuntimeError("the kernel's update line has changed")
    path = os.path.join(nvcc.BUILD_DIR, "batched_inv_fma.cu")
    os.makedirs(nvcc.BUILD_DIR, exist_ok=True)
    with open(path, "w") as fh:
        fh.write(src.replace(UPDATE, FMA))
    return path


def _entry(src):
    fn = ctypes.CDLL(nvcc.library_path(src)).fdt_batched_inv
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    return fn


def main():
    S.device_phase()
    fma_src = _fma_source()
    nvcc.compile_sources([BI._SRC, fma_src])
    fns = {"kernel": _entry(BI._SRC), "fma": _entry(fma_src)}

    def run(name, A):
        out = torch.empty_like(A)
        rc = fns[name](int(A.dtype == torch.float64), A.data_ptr(),
                       out.data_ptr(), A.shape[0], A.shape[-1],
                       nvcc.current_stream(A.device))
        if rc != 0:
            raise RuntimeError(f"{name}: launch failed, code {rc}")
        return out

    for nb, n in ((263169, 19), (1050625, 7)):
        for dt in (torch.float64, torch.float32):
            A = S._spd(nb, n, n, dt)
            ref = BI.batched_inv_plain(A)
            err = {k: float((run(k, A) - ref).abs().max()) for k in fns}
            ms = {k: [] for k in fns}
            for k in ("kernel", "fma", "fma", "kernel"):
                ms[k].append(S._device_ms(lambda: run(k, A)))
            t = {k: sum(v) / len(v) for k, v in ms.items()}
            print(f"K2 ({nb}, {n}, {n}) {str(dt)[6:]}: kernel "
                  f"{t['kernel']:.4f} ms, fma {t['fma']:.4f} ms, fma gain "
                  f"{1 - t['fma'] / t['kernel']:.3f}; max|X - plain| "
                  f"kernel {err['kernel']:.3e} fma {err['fma']:.3e} "
                  f"(max|plain| {float(ref.abs().max()):.3e})", flush=True)
            del A, ref
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
