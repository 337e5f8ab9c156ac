"""K2, the batched Gauss-Jordan inverse: the port's batched_inv and
batched_solve (their plain version on the CPU) against the JAX package's
Pallas kernel run in interpret mode, on the same seeded SPD batches.

Tolerances: float64 1e-12 max|ref| (the two sum in different orders);
float32 2e-6 max|ref| + 1e-7, the f32 bound of the port's other kernel
tests.  n <= 3 goes to the port's cofactor inverse and is held to the
same bounds against the Gauss-Jordan kernel.  The CUDA kernel itself is
held against the plain version in tests/test_torch_cuda.py, which runs on
a machine with a card and without jax."""
import numpy as np
import pytest
import torch
import jax

from firedrake_tpu.ops import batched_inverse as JB
import firedrake_tpu_torch as T
from firedrake_tpu_torch.ops import batched_inverse as BI

NS = (2, 3, 4, 7, 12, 15, 19)
DTYPES = {"f64": (np.float64, torch.float64, 1e-12, 0.0),
          "f32": (np.float32, torch.float32, 2e-6, 1e-7)}


#: the JAX package's reference programs are compiled with XLA's
#: optimisations off, which cuts the time of these tests by ~18% on 6 CPU
#: workers (most of it is compiling); the results agree within the same
#: tolerances.  The module's executables are dropped with it, so that no
#: later module runs them.
NO_OPT = "jax_disable_most_optimizations"


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    T.set_device("cpu")
    opt = jax.config.read(NO_OPT)
    jax.config.update(NO_OPT, True)
    yield
    jax.config.update(NO_OPT, opt)
    jax.clear_caches()
    torch.set_num_threads(n)


def _spd(shape, n, seed):
    B = np.random.default_rng(seed).standard_normal(shape + (n, n))
    return B @ np.swapaxes(B, -1, -2) + n * np.eye(n)


def _close(ours, ref, rtol, atol):
    err = np.abs(ours - ref).max()
    assert err <= rtol * np.abs(ref).max() + atol, err


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("n", NS)
def test_inverse_matches_pallas_interpret(n, dt):
    npdt, tdt, rtol, atol = DTYPES[dt]
    A = _spd((3, 40), n, seed=n).astype(npdt)
    ref = np.asarray(JB.batched_inv(A, force_pallas=True, interpret=True))
    At = torch.as_tensor(A)
    for fn in (BI.batched_inv, BI.batched_inv_plain):
        ours = fn(At)
        assert ours.dtype == tdt and ours.shape == At.shape
        _close(ours.numpy(), ref, rtol, atol)


@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_solve_matches_pallas_interpret(rhs):
    A = _spd((30,), 7, seed=1)
    rng = np.random.default_rng(2)
    b = rng.standard_normal((30, 7) if rhs == "vector" else (30, 7, 3))
    ref = np.asarray(JB.batched_solve(A, b, force_pallas=True,
                                      interpret=True))
    ours = BI.batched_solve(torch.as_tensor(A), torch.as_tensor(b))
    assert ours.shape == b.shape
    _close(ours.numpy(), ref, 1e-12, 0.0)


@pytest.mark.parametrize("n", [33, 40, 64])
def test_large_n_matches_pallas_interpret(n):
    """Blocks beyond a warp's 32 rows (the kernel's large variant on the
    card): the plain version against the JAX package's kernel."""
    A = _spd((6,), n, seed=n)
    ref = np.asarray(JB.batched_inv(A, force_pallas=True, interpret=True))
    ours = BI.batched_inv(torch.as_tensor(A))
    _close(ours.numpy(), ref, 1e-12, 0.0)


def test_kernel_limits_raise():
    """No cap on n: the variant follows n, and the kernel wrapper refuses
    only what it cannot take: CPU tensors (the CUDA kernel has no CPU
    mode), integer blocks, and blocks that are not square."""
    n0 = BI.kernel_launches
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        BI._launch(torch.zeros(2, 129, 129))
    with pytest.raises(TypeError, match="float32/float64"):
        BI._launch(torch.zeros(2, 129, 129, dtype=torch.int64))
    with pytest.raises(ValueError, match="square"):
        BI.batched_inv(torch.zeros(2, 4, 5))
    assert BI.kernel_launches == n0


def _needs_pivots(shape, n, seed):
    """Random blocks whose leading diagonal entry is zero (Gauss-Jordan
    without pivoting divides by it)."""
    A = np.random.default_rng(seed).standard_normal(shape + (n, n))
    A[..., 0, 0] = 0.0
    return A


@pytest.mark.parametrize("n", [4, 7, 33, 65, 130])
def test_pivoted_plain_matches_lapack(n):
    """batched_inv_plain(A, pivot=True) against the JAX package's CPU
    inverse (jnp.linalg.inv, LAPACK's partial pivoting) and
    torch.linalg.inv, on blocks that need pivots; the unpivoted version
    is not finite there."""
    import jax.numpy as jnp
    A = _needs_pivots((5,), n, seed=n)
    ref = np.asarray(jnp.linalg.inv(jnp.asarray(A)))
    At = torch.as_tensor(A)
    ours = BI.batched_inv(At, pivot=True)
    _close(ours.numpy(), ref, 1e-11, 0.0)
    _close(ours.numpy(), torch.linalg.inv(At).numpy(), 1e-11, 0.0)
    assert not torch.isfinite(BI.batched_inv_plain(At)).all()


def test_pivoted_plain_swaps_like_argmax():
    """The pivot row is the first largest |A[i, k]| over i >= k (ties go
    to the first): on a permutation matrix with repeated magnitudes the
    plain version inverts exactly, and on a block that needs no swap
    it equals the unpivoted version bit for bit."""
    P = torch.zeros(1, 6, 6, dtype=torch.float64)
    perm = [3, 0, 5, 1, 2, 4]
    P[0, torch.arange(6), torch.as_tensor(perm)] = 1.0
    A = P * 2.0
    assert torch.equal(BI.batched_inv_plain(A, pivot=True),
                       P.transpose(1, 2) * 0.5)
    D = torch.as_tensor(_spd((4,), 9, seed=5))
    D = D + torch.diag_embed(torch.linspace(100.0, 10.0, 9,
                                            dtype=torch.float64))
    assert torch.equal(BI.batched_inv_plain(D, pivot=True) + 0.0,
                       BI.batched_inv_plain(D) + 0.0)


def test_variant_by_n_without_cap():
    """The card's variant for each n: the cofactor inverse to 3, the warp
    variant to 32, the large variant to 128 and the huge variant above
    it, with no upper cap."""
    assert [BI.variant(n) for n in (2, 3, 4, 32, 33, 128, 129, 2153,
                                    10 ** 5)] == \
        ["cofactor", "cofactor", "warp", "warp", "large", "large",
         "huge", "huge", "huge"]
    assert not hasattr(BI, "MAX_N")


def _in_place_gj(A, pivot=False):
    """The CUDA kernel's arithmetic, step by step, in torch: in-place
    Gauss-Jordan on n x n.  At step k (pivoted: after swapping rows k and
    p, p the first largest |S[i, k]| over i >= k, and their labels) the
    pivot row is set to 1 at k and scaled by the correctly rounded
    1 / pivot; every other row i takes c = S[i, k], sets S[i, k] = 0 and
    subtracts c times the pivot row, each product and difference rounded
    on its own (no FMA).  Pivoted, stored column j is the result's column
    of label j at the end."""
    S = A.clone()
    nb, n = S.shape[0], S.shape[-1]
    b = torch.arange(nb)
    lab = torch.arange(n).repeat(nb, 1)
    for k in range(n):
        if pivot:
            p = torch.argmax(S[:, k:, k].abs(), dim=-1) + k
            for Y in (S, lab):
                rowk, rowp = Y[:, k].clone(), Y[b, p].clone()
                Y[:, k], Y[b, p] = rowp, rowk
        inv = 1.0 / S[:, k, k]
        piv = S[:, k, :].clone()
        piv[:, k] = 1.0
        piv = piv * inv[:, None]
        c = S[:, :, k].clone()
        S[:, :, k] = 0.0
        S = S - c[:, :, None] * piv[:, None, :]
        S[:, k, :] = piv
    if pivot:
        out = torch.empty_like(S)
        out[b[:, None], :, lab] = S.transpose(1, 2)
        S = out
    return S


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_in_place_order_equals_plain_bit_for_bit(dt):
    """The kernel's in-place elimination skips only exact operations of
    the plain [A | I] version (x * 0, 0 - p, 1 * r), so for every n the
    kernel takes (both variants) the two give the same rounded numbers,
    signed zeros aside (cleared by adding 0.0)."""
    for n in list(range(4, 33)) + [33, 40, 64]:
        A = torch.as_tensor(_spd((24,), n, seed=100 + n), dtype=dt)
        ours = _in_place_gj(A) + 0.0
        ref = BI.batched_inv_plain(A) + 0.0
        assert torch.equal(ours, ref), n


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_pivoted_in_place_order_equals_plain_bit_for_bit(dt):
    """The same for the pivoted mode, with the swaps and the final column
    relabelling of the kernel's three variants (warp, large, huge), on
    blocks that need pivots."""
    for n in (4, 7, 19, 32, 33, 65, 129, 140):
        A = torch.as_tensor(_needs_pivots((6,), n, seed=200 + n), dtype=dt)
        ours = _in_place_gj(A, pivot=True) + 0.0
        ref = BI.batched_inv_plain(A, pivot=True) + 0.0
        assert torch.equal(ours, ref), n
