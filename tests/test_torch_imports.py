"""The PyTorch port imports neither jax nor triton: every module of
firedrake_tpu_torch is imported in a fresh interpreter and sys.modules is
inspected afterwards.  Its device defaults to the CUDA card, also where
there is none (nothing probes for one)."""
import os
import subprocess
import sys

import pytest
import torch

import firedrake_tpu_torch as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    T.set_device("cpu")


_PROBE = """
import importlib, pkgutil, sys
import firedrake_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "triton",
                                    "firedrake_tpu"))
print(" ".join(bad))
"""


def test_port_imports_no_jax_or_triton():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", f"port imported: {res.stdout}"


def test_device_defaults_to_cuda():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c",
         "import firedrake_tpu_torch as T; print(T.get_device())"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "cuda"
    assert T.get_device() == torch.device("cpu")   # this module asked
