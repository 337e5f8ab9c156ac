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
from threadpoolctl import threadpool_limits
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
    # one BLAS thread: with six test workers, numpy's OpenBLAS threads
    # (one per host core in each worker) made its dense linear algebra
    # ~20x slower
    with threadpool_limits(limits=1, user_api="blas"):
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
    relabelling of the kernel's warp and large variants, on blocks that
    need pivots (n above 128 too: the unblocked order itself; the huge
    variant's blocked order is held to the plain version by tolerance,
    below)."""
    for n in (4, 7, 19, 32, 33, 65, 129, 140):
        A = torch.as_tensor(_needs_pivots((6,), n, seed=200 + n), dtype=dt)
        ours = _in_place_gj(A, pivot=True) + 0.0
        ref = BI.batched_inv_plain(A, pivot=True) + 0.0
        assert torch.equal(ours, ref), n


def _rank_update(S, rows, cols, Q, R):
    """Columns ``cols`` of S become (S with ``rows`` zeroed) + Q R, summed
    in float64 and rounded once (the kernel sums its rank updates in
    float64 in both types)."""
    base = S[:, :, cols].double()
    base[:, rows, :] = 0.0
    S[:, :, cols] = (base + Q.double() @ R.double()).to(S.dtype)


def _blocked_gj(A, w, pivot=False, b=8):
    """The huge variant's blocked order in torch: Gauss-Jordan by panels
    of w columns.  The panel step eliminates inside the panel's columns
    only, in sub-panels of b columns: each pivot step (pivoted: a
    whole-row swap with the first largest |S[i, kk]| over i >= kk, in the
    column as the earlier steps left it) eliminates inside its
    sub-panel, then the panel's other columns take the sub-panel's
    rank-b update.  The trailing update gives every column outside the
    panel (S with the panel's rows zeroed) + Q R, Q the panel's columns
    after the panel step and R the panel's rows before it, in the order
    the swaps left them; both rank updates sum in float64.  Pivoted,
    stored column j is the result's column of label j at the end."""
    S = A.clone()
    nb, n = S.shape[0], S.shape[-1]
    bi = torch.arange(nb)
    lab = torch.arange(n).repeat(nb, 1)
    for k in range(0, n, w):
        K = slice(k, min(k + w, n))
        for s0 in range(K.start, K.stop, b):
            Kb = slice(s0, min(s0 + b, K.stop))
            for kk in range(Kb.start, Kb.stop):
                if pivot:
                    p = torch.argmax(S[:, kk:, kk].abs(), dim=-1) + kk
                    for Y in (S, lab):
                        rk, rp = Y[:, kk].clone(), Y[bi, p].clone()
                        Y[:, kk], Y[bi, p] = rp, rk
                inv = 1.0 / S[:, kk, kk]
                piv = S[:, kk, Kb].clone()
                piv[:, kk - s0] = 1.0
                piv = piv * inv[:, None]
                col = S[:, :, kk].clone()
                S[:, :, kk] = 0.0
                S[:, :, Kb] -= col[:, :, None] * piv[:, None, :]
                S[:, kk, Kb] = piv
            rest = [j for j in range(K.start, K.stop)
                    if not Kb.start <= j < Kb.stop]
            if rest:
                _rank_update(S, Kb, rest, S[:, :, Kb], S[:, Kb, rest])
        rest = [j for j in range(n) if not K.start <= j < K.stop]
        _rank_update(S, K, rest, S[:, :, K], S[:, K, rest])
    if pivot:
        out = torch.empty_like(S)
        out[bi[:, None], :, lab] = S.transpose(1, 2)
        S = out
    return S


#: the blocked order against the plain version and LAPACK: float64 within
#: 1e-12 max|X|, float32 within 1e-5 max|X| (the products sum in another
#: order)
BLOCKED_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _blocked_close(A, w, pivot):
    ours = _blocked_gj(A, w, pivot=pivot)
    tol = BLOCKED_TOL[A.dtype]
    ref = np.linalg.inv(A.double().numpy())
    for other in (BI.batched_inv_plain(A, pivot=pivot).numpy(), ref):
        err = np.abs(ours.numpy() - other).max()
        assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("w", [8, 16, 64])
@pytest.mark.parametrize("n", [129, 130, 191, 192, 193, 300])
def test_blocked_order_matches_plain_and_lapack(n, w, dt):
    """The huge variant's blocked order on SPD blocks, n one over the
    large variant's limit, on and around multiples of the panel width."""
    A = torch.as_tensor(_spd((2,), n, seed=300 + n), dtype=dt)
    _blocked_close(A, w, pivot=False)
    _blocked_close(A, w, pivot=True)


@pytest.mark.parametrize("w", [8, 16, 64])
@pytest.mark.parametrize("n", [129, 193, 300])
def test_blocked_pivots_from_outside_the_panel(n, w):
    """Pivoted, on blocks whose first w + 6 rows are scaled down 1000x:
    the first panel's pivots come from rows below the panel (checked for
    its first column), so the swaps send panel rows out and the trailing
    update must read them in their new places."""
    A = np.random.default_rng(400 + n).standard_normal((3, n, n))
    A[:, :w + 6, :] *= 1e-3
    At = torch.as_tensor(A)
    first = torch.argmax(At[:, :, 0].abs(), dim=-1)
    assert bool((first >= w).all())
    _blocked_close(At, w, pivot=True)


def _saddle(na, m, eps):
    """[[A, C^T], [C, -eps I]]: A the Neumann Laplacian of a path of na
    nodes (singular: constants), C m averages over consecutive runs."""
    A = 2.0 * np.eye(na) - np.eye(na, k=1) - np.eye(na, k=-1)
    A[0, 0] = A[-1, -1] = 1.0
    C = np.zeros((m, na))
    run = na // m
    for r in range(m):
        C[r, r * run:(r + 1) * run] = 1.0 / run
    return np.block([[A, C.T], [C, -eps * np.eye(m)]])


@pytest.mark.parametrize("w", [8, 16, 64])
@pytest.mark.parametrize("n", [129, 300])
def test_blocked_saddle_block(n, w):
    """A BDDC-like saddle block with a singular leading block: pivoted,
    against the pivoted plain version and LAPACK."""
    A = torch.as_tensor(_saddle(n - 8, 8, 1e-8)[None])
    assert np.linalg.matrix_rank(A[0, :n - 8, :n - 8].numpy()) == n - 9
    _blocked_close(A, w, pivot=True)


def test_blocked_float32_no_less_accurate_than_plain():
    """Float32 on pivoted random blocks (a zero leading entry), against
    the float64 inverse: the blocked order with its rank updates summed
    in float64 errs no more than 2x the plain version (summed in float32
    it erred more on some of these blocks)."""
    for n, nb in ((130, 1), (130, 5), (300, 1), (300, 5)):
        B = np.random.default_rng(n * nb).standard_normal((nb, n, n))
        B[:, 0, 0] = 0.0
        A = torch.as_tensor(B, dtype=torch.float32)
        exact = torch.as_tensor(np.linalg.inv(B))
        err = {name: float((X.double() - exact).abs().max()) for name, X in
               (("blocked", _blocked_gj(A, 64, pivot=True)),
                ("plain", BI.batched_inv_plain(A, pivot=True)))}
        assert err["blocked"] <= 2 * err["plain"], (n, nb, err)
