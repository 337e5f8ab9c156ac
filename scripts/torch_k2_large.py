#!/usr/bin/env python
"""K2's large variant (csrc/batched_inv.cu, 33 <= n <= 128) timed on one
NVIDIA GPU, optionally beside an earlier version of the same source:

    python scripts/torch_k2_large.py [--against OLD/batched_inv.cu]

For each row of chip_smoke.py's K2_LARGE_ROWS (random blocks made from a
seed: SPD, or with a zero leading entry where the row is pivoted) it
prints the launch plan, whether the kernel equals its plain version bit
for bit (signed zeros aside), and the device time of one launch
(chip_smoke's _device_ms: CUDA events per launch, L2 flushed, queued
while the card sleeps) beside the bound and the exact-arithmetic floor
(2 n^3 nb unfused operations at the vector pipe's rate).

With --against, that source is compiled by nvcc beside this tree's and
its large variant called through the interface of the one-thread-per-row
design, fdt_batched_inv_large(is_double, pivot, a, out, nb, n, stream);
it is held to the plain version bit for bit as well, and the two are
timed in the turns old, new, new, old.  The last line is a JSON list of
the rows.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import chip_smoke as CS  # noqa: E402
from firedrake_tpu_torch.compiler import nvcc  # noqa: E402
from firedrake_tpu_torch.ops import batched_inverse as BI  # noqa: E402


def _old_large(path):
    """The large variant of an earlier batched_inv.cu, as a function of
    (A, pivot)."""
    lib = ctypes.CDLL(nvcc.library_path(path))
    fn = lib.fdt_batched_inv_large
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]

    def inv(A, pivot):
        out = torch.empty_like(A)
        rc = fn(int(A.dtype == torch.float64), int(pivot), A.data_ptr(),
                out.data_ptr(), A.shape[0], A.shape[-1],
                nvcc.current_stream(A.device))
        if rc != 0:
            raise RuntimeError(f"the earlier large variant failed: {rc}")
        return out
    return inv


def _build_report(src):
    """Registers, stack and spills of each instantiation of the large
    variant's kernel, from nvcc's ptxas report of this build."""
    out, name, frame = [], "", ""
    for line in nvcc.build_logs.get(src, (0.0, ""))[1].splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            frame = line.strip()
        elif "Used " in line and "gj_team_kernel" in name:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}; {frame}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", help="an earlier batched_inv.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    srcs = [BI._SRC] + ([os.path.abspath(args.against)]
                        if args.against else [])
    nvcc.compile_sources(srcs)
    BI.build()
    for line in _build_report(BI._SRC):
        print("ptxas", line)
    old = _old_large(srcs[1]) if args.against else None
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    rows = []
    for nb, n, dt, pivot in CS.K2_LARGE_ROWS:
        A = (CS._needs_pivots(nb, n, n, dt) if pivot
             else CS._spd(nb, n, n, dt))
        plain = BI.batched_inv_plain(A, pivot) + 0.0
        new = lambda: BI.batched_inv(A, pivot)  # noqa: E731
        row = dict(shape=[nb, n, n], dtype=str(dt)[6:], pivot=pivot,
                   bit_for_bit=torch.equal(new() + 0.0, plain),
                   plan=dict(BI.large_report),
                   bound_ms=1e3 * 2 * A.numel() * A.element_size()
                   / CS.HBM_BYTES_PER_S,
                   floor_ms=CS._floor_ms(nb, n, dt))
        if old is not None:
            row["old_bit_for_bit"] = torch.equal(old(A, pivot) + 0.0, plain)
            o1 = CS._device_ms(lambda: old(A, pivot), 5)
            n1, n2 = CS._device_ms(new, 5), CS._device_ms(new, 5)
            o2 = CS._device_ms(lambda: old(A, pivot), 5)
            row.update(ms=(n1 + n2) / 2, old_ms=(o1 + o2) / 2,
                       runs=[o1, n1, n2, o2])
        else:
            n1, n2 = CS._device_ms(new, 5), CS._device_ms(new, 5)
            row.update(ms=(n1 + n2) / 2, runs=[n1, n2])
        print(json.dumps(row), flush=True)
        rows.append(row)
        del A, plain
        torch.cuda.empty_cache()
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
