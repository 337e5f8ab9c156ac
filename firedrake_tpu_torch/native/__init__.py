"""Host-side native kernels (C++, built with g++ at first use).

The port's copy of ``firedrake_tpu/native`` (``coo_sort_unique``, the
hot step of the sparsity build, reference role: pyop2 sparsity.pyx).  The
library is compiled from ``coo_build.cpp`` into
``firedrake_tpu_torch/_build/`` beside the CUDA builds, named by a hash of
the source; a failed build raises.  ``coo_sort_unique_plain`` is the
numpy version of the same function, with identical results: the tests
hold the build against it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "coo_build.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_lib = None


def library_path():
    with open(_SRC, "rb") as fh:
        tag = hashlib.sha1(fh.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libcoo_build_{tag}.so")


def load():
    """ctypes handle of the library, compiled first if missing."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o",
             tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {_SRC} ({proc.returncode}):"
                               f"\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    lib.coo_sort_unique.restype = ctypes.c_int64
    lib.coo_sort_unique.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p]
    _lib = lib
    return lib


def coo_sort_unique_plain(keys):
    """numpy version of ``coo_sort_unique``."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    vmask = keys >= 0
    uniq = np.unique(keys[vmask])
    positions = np.searchsorted(uniq, keys).astype(np.int32)
    positions[~vmask] = len(uniq)
    return uniq, positions, np.argsort(keys, kind="stable")


def coo_sort_unique(keys):
    """(uniq_keys, positions, order): the sorted unique COO keys, each
    entry's position among them (sentinel keys < 0 get position == nnz),
    and the stable sort order of the keys (int64, the sentinels first;
    equal keys keep their input order)."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if not keys.size:
        return coo_sort_unique_plain(keys)
    lib = load()
    n = keys.size
    positions = np.empty(n, dtype=np.int32)
    uniq = np.empty(n, dtype=np.int64)
    order = np.empty(n, dtype=np.int64)
    nnz = lib.coo_sort_unique(keys.ctypes.data, n, positions.ctypes.data,
                              uniq.ctypes.data, order.ctypes.data)
    return uniq[:nnz].copy(), positions, order
