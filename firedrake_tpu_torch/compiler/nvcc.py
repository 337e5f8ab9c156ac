"""Build the hand-written CUDA kernels (``csrc/*.cu``) and load them.

Each source is compiled by nvcc for sm_90a into a shared library with a
plain C interface, named by a hash of the source, in
``firedrake_tpu_torch/_build/``; ctypes loads it.  ``compile_sources``
starts one nvcc per missing library, all at once, and waits for them, so
building every kernel takes as long as the slowest one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: per source path: (build seconds, nvcc output with the ptxas report) of
#: the build made by this process
build_logs: dict = {}


def current_stream(device):
    """Handle of PyTorch's current stream on a CUDA device, as an int for
    a kernel's launch (the raw query; ``torch.cuda.current_stream``
    builds a Python Stream object on every call)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def source(name):
    return os.path.join(CSRC, name)


def library_path(src):
    with open(src, "rb") as fh:
        tag = hashlib.sha1(fh.read()).hexdigest()[:12]
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{tag}.so")


def _nvcc():
    return shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def compile_sources(srcs):
    """Compile every source of ``srcs`` whose library is missing, one nvcc
    process each, concurrently; raise on the first failure."""
    jobs = []
    for src in srcs:
        so = library_path(src)
        if os.path.exists(so):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, src]
        jobs.append((src, so, tmp, time.perf_counter(),
                     subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, so, tmp, t0, proc in jobs:
        log = proc.communicate()[0]
        build_logs[src] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src} ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(src):
    """ctypes handle of ``src``'s library, compiled first if missing."""
    compile_sources([src])
    return ctypes.CDLL(library_path(src))
