#!/usr/bin/env python
"""Where the time of K2's huge variant (csrc/batched_inv.cu, n > 128) goes,
on one NVIDIA GPU:

    python scripts/torch_k2_huge.py

For random float64 blocks of bddc_p1_1024's shapes, made on the card from
a seed (SPD unpivoted: (64, 2145, 2145), (512, 2145, 2145),
(1, 1441, 1441); with a zero leading entry, pivoted: (64, 2153, 2153),
(512, 2153, 2153)), it prints the device time of one call (CUDA events)
and the device time of each of its kernels summed over the call
(torch.profiler): the panel, the row copies, the trailing update, and
pivoted the labels and the final relabelling; and the kernels one call
launched, as the profiler counts them beside the library's own count.  Beside them, the time of a copy of the
batch (torch's copy_, the same bytes as one pass of the update over the
matrices) and the update's bytes per second over its passes.
"""
import os
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from firedrake_tpu_torch.ops import batched_inverse as BI  # noqa: E402

SHAPES = ((64, 2145, False), (64, 2153, True), (512, 2145, False),
          (512, 2153, True), (1, 1441, False))
KERNELS = ("gj_huge_panel", "gj_huge_rows", "gj_huge_update",
           "gj_huge_labels", "gj_huge_unpermute")


def _event_ms(fn):
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e)


def _blocks(nb, n, pivot, gen):
    B = torch.randn(nb, n, n, dtype=torch.float64, device="cuda",
                    generator=gen)
    if pivot:
        B[:, 0, 0] = 0.0
        return B
    eye = torch.eye(n, dtype=torch.float64, device="cuda")
    return torch.baddbmm(eye.expand(nb, n, n), B, B.transpose(1, 2),
                         alpha=1.0 / n)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    BI.build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for nb, n, pivot in SHAPES:
        A = _blocks(nb, n, pivot, gen)
        call = lambda: BI.batched_inv(A, pivot=pivot)  # noqa: E731
        call()
        ms = min(_event_ms(call) for _ in range(2))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        by = dict.fromkeys(KERNELS, 0.0)
        launched = 0
        for ev in prof.key_averages():
            for name in KERNELS:
                if name + "<" in ev.key or name + "(" in ev.key:
                    by[name] += ev.device_time_total / 1e3
                    launched += ev.count
        out = torch.empty_like(A)
        out.copy_(A)
        copy_ms = min(_event_ms(lambda: out.copy_(A)) for _ in range(3))
        w = BI.huge_report["w"]
        passes = -(-n // w)
        rate = passes * 2 * A.numel() * 8 / (by["gj_huge_update"] / 1e3)
        print(f"{torch.cuda.get_device_name(0)} ({nb}, {n}, {n}) float64 "
              f"pivot {pivot}: call {ms:.3f} ms; kernels {launched} "
              f"(profiler), {BI.huge_report['kernels']} (library); "
              + " ".join(f"{k[8:]} {v:.3f} ms" for k, v in by.items())
              + f"; copy of the batch {copy_ms:.3f} ms "
              f"({2 * A.numel() * 8 / copy_ms / 1e9:.2f} TB/s); update "
              f"{passes} passes at {rate / 1e12:.2f} TB/s", flush=True)
        del A, out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
