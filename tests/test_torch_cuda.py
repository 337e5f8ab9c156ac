"""K1 and K2 on the card: each CUDA kernel against its plain PyTorch
version, and the launch counts.  Marked `cuda`; skips where torch has no CUDA device.
Run on a machine with an NVIDIA GPU with
    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
(--noconftest: tests/conftest.py configures jax, which these tests do not
use and such a machine need not have).
"""
import numpy as np
import pytest
import torch

import firedrake_tpu_torch as T
from firedrake_tpu_torch.assemble import FormAssembler
from firedrake_tpu_torch.compiler import cell_eval as K
from firedrake_tpu_torch.ops import batched_inverse as BI

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True, scope="module")
def _cpu_by_default():
    T.set_device("cpu")


@pytest.fixture
def on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    T.set_device("cuda")
    yield
    T.set_device("cpu")


def _forms():
    out = []
    for deg, n in ((1, 64), (2, 32)):
        V = T.FunctionSpace(T.UnitSquareMesh(n, n), "CG", deg)
        u, v = T.TrialFunction(V), T.TestFunction(V)
        w = T.Function(V, val=torch.linspace(0.5, 1.5, V.dim,
                                                dtype=torch.float64))
        out += [(T.inner(T.grad(u), T.grad(v)) + u * v) * T.dx,
                T.Constant(3.0) * w * T.inner(T.grad(u), T.grad(v)) * T.dx,
                w * v * T.dx]
    return out


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 2e-6)])
def test_kernel_matches_plain_on_card(on_cuda, dtype, rtol):
    for form in _forms():
        asm = FormAssembler(form)
        coords, coeffs, consts = asm._inputs()
        (ci,) = asm._compiled
        spec = K.family_spec(ci)
        cv = tuple(consts[c.count].to(dtype) for c in ci.constants)
        for t in range(asm._stencil.ntypes):
            ce, ws = asm._stencil.gather_cell_inputs(t, coords, coeffs, ci)
            ce, ws = ce.to(dtype), tuple(w.to(dtype) for w in ws)
            n0 = K.kernel_launches
            out = K.cell_eval(spec, ce, ws, cv)
            assert K.kernel_launches == n0 + 1
            ref = K.cell_eval_plain(spec, ce, ws, cv)
            err = float((out - ref).abs().max())
            assert err <= rtol * float(ref.abs().max()), err


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float64, 1e-12, 0.0),
                                             (torch.float32, 2e-6, 1e-7)])
def test_batched_inv_matches_plain_on_card(on_cuda, dtype, rtol, atol):
    for n in (4, 7, 15, 19, 32):
        B = np.random.default_rng(n).standard_normal((1000, n, n))
        A = torch.as_tensor(B @ B.transpose(0, 2, 1) + n * np.eye(n),
                            dtype=dtype, device="cuda")
        n0 = BI.kernel_launches
        out = BI.batched_inv(A)
        assert BI.kernel_launches == n0 + 1
        ref = BI.batched_inv_plain(A)
        err = float((out - ref).abs().max())
        assert err <= rtol * float(ref.abs().max()) + atol, err
