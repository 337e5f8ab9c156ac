"""Eigenproblem solvers (the port's copy of ``firedrake_tpu/eigensolver.py``;
reference: firedrake/eigensolver.py:18 LinearEigenproblem / :99
LinearEigensolver wrapping SLEPc).

Generalized problems A x = lambda M x, the matrices assembled on the
device.  Default backend: scipy ARPACK on the host (``Matrix.to_scipy()``;
any spectrum target, a dense fallback for tiny problems).  ``eps_backend:
lobpcg``: LOBPCG on the device (``lobpcg_standard``, the JAX package's
``jax.experimental.sparse.linalg.lobpcg_standard`` written in torch) for
Hermitian problems, through the lumped-mass congruence and a Gershgorin
shift.
"""
from __future__ import annotations

import numpy as np
import torch

from .assemble import assemble
from .device import as_tensor, to_numpy
from .function import Function

__all__ = ["LinearEigenproblem", "LinearEigensolver", "lobpcg_standard"]


class LinearEigenproblem:
    def __init__(self, A, M=None, bcs=None, bc_shift=0.0,
                 restrict=False):
        self.A_form = A
        self.M_form = M
        self.bcs = tuple(bcs or ())
        self.bc_shift = bc_shift
        self.output_space = A.arguments()[-1].space      # the trial space

    def dirichlet_bcs(self):
        return self.bcs


class LinearEigensolver:
    """solver_parameters subset: eps_gen_{hermitian,non_hermitian},
    eps_target / which ('LM','SM','LR','SR'), n_evals; eps_backend
    'lobpcg' with eps_max_it."""

    def __init__(self, problem: LinearEigenproblem, n_evals=1, *,
                 options_prefix=None, solver_parameters=None, ncv=None):
        self.problem = problem
        self.n_evals = n_evals
        self.params = dict(solver_parameters or {})
        self._evals = None
        self._evecs = None

    def solve(self):
        import scipy.sparse.linalg as spla
        p = self.problem
        A = assemble(p.A_form).to_scipy().tocsc()
        M = (assemble(p.M_form).to_scipy().tocsc()
             if p.M_form is not None else None)
        self._keep = None
        if p.bcs:
            # restrict to non-bc dofs (the reference's restrict=True path)
            n = A.shape[0]
            bc = np.unique(np.concatenate(
                [b.dof_indices for b in p.bcs]))
            keep = np.setdiff1d(np.arange(n), bc)
            self._keep = (keep, n)
            # rows, then columns: the JAX package's A[np.ix_(keep, keep)]
            # makes scipy form the n^2 index grid, which fails once it
            # passes 2^31 entries (~4.6e4 free dofs)
            A = A.tocsr()[keep][:, keep].tocsc()
            if M is not None:
                M = M.tocsr()[keep][:, keep].tocsc()
        k = self.n_evals
        which = self.params.get("eps_which", "SM")
        sigma = self.params.get("eps_target")
        hermitian = self.params.get("eps_gen_non_hermitian") is None
        if (self.params.get("eps_backend") == "lobpcg" and hermitian
                and sigma is None):
            vals, vecs = self._lobpcg_device(A, M, k, which)
            order = np.argsort(vals)
            self._evals = np.asarray(vals)[order]
            self._evecs = np.asarray(vecs)[:, order]
            return len(self._evals)
        try:
            if hermitian:
                vals, vecs = spla.eigsh(
                    A, k=k, M=M,
                    sigma=sigma if sigma is not None
                    else (0.0 if which in ("SM", "SR") else None),
                    which="LM" if sigma is not None or which in ("SM", "SR")
                    else which)
            else:
                vals, vecs = spla.eigs(A, k=k, M=M, sigma=sigma,
                                       which=which)
        except Exception:
            # dense fallback for tiny problems
            import scipy.linalg as sla
            Ad = A.toarray()
            Md = M.toarray() if M is not None else None
            vals, vecs = sla.eigh(Ad, Md) if hermitian else sla.eig(Ad, Md)
            order = np.argsort(np.abs(vals))
            vals, vecs = vals[order][:k], vecs[:, order][:, :k]
        order = np.argsort(vals)
        self._evals = np.asarray(vals)[order]
        self._evecs = np.asarray(vecs)[:, order]
        return len(self._evals)

    def _lobpcg_device(self, A, M, k, which):
        """Device LOBPCG for Hermitian problems: largest-k natively;
        smallest-k via a Gershgorin shift (sigma*I - A keeps SPD-ness);
        generalized problems by lumped mass (diagonal) congruence
        D^-1/2 A D^-1/2, the standard FEM lumping (use the scipy backend
        when the consistent mass matters)."""
        Ac = A.tocsr()
        d = None
        if M is not None:
            import scipy.sparse as sp
            d = np.asarray(M.sum(axis=1)).ravel()     # lumped mass
            S = sp.diags(1.0 / np.sqrt(d))
            Ac = (S @ Ac @ S).tocsr()
        n = Ac.shape[0]
        # ELL layout for a device matvec: row r's entries in its first
        # row-length slots, the padding reading column 0 with value 0
        lens = np.diff(Ac.indptr)
        kmax = int(lens.max())
        rows = np.repeat(np.arange(n), lens)
        slot = np.arange(Ac.nnz) - np.repeat(Ac.indptr[:-1], lens)
        cols = np.zeros((n, kmax), dtype=np.int64)
        vals = np.zeros((n, kmax))
        cols[rows, slot] = Ac.indices
        vals[rows, slot] = Ac.data
        cols_t, vals_t = as_tensor(cols), as_tensor(vals)
        smallest = which in ("SM", "SR")
        # Gershgorin upper bound on the spectrum
        sig = float(np.abs(Ac).sum(axis=1).max()) if smallest else 0.0

        def op(X):                                    # (n, k) block
            AX = torch.einsum("rk,rkb->rb", vals_t, X[cols_t])
            return sig * X - AX if smallest else AX

        rng = np.random.RandomState(0)
        X0 = as_tensor(np.linalg.qr(rng.randn(n, k))[0])
        theta, U, _ = lobpcg_standard(op, X0, m=int(self.params.get(
            "eps_max_it", 200)))
        theta, U = to_numpy(theta), to_numpy(U)
        lam = (sig - theta) if smallest else theta
        if d is not None:
            U = U / np.sqrt(d)[:, None]               # back-transform
        return lam, U

    def eigenvalue(self, i):
        return self._evals[i]

    def _embed(self, vec):
        if self._keep is None:
            return vec
        keep, n = self._keep
        full = np.zeros(n, dtype=vec.dtype)
        full[keep] = vec
        return full

    def eigenfunction(self, i):
        fr = Function(self.problem.output_space)
        fr.dat = as_tensor(np.real(self._embed(self._evecs[:, i])))
        fi = Function(self.problem.output_space)
        fi.dat = as_tensor(np.imag(self._embed(self._evecs[:, i])))
        return fr, fi


# ------------------------------------------------------------------ LOBPCG
# lobpcg_standard and its helpers follow jax.experimental.sparse.linalg
# (the JAX package's device eigensolver) step for step: an orthonormal
# basis [X, P, R] kept by SVQB orthonormalisation, Rayleigh-Ritz on it,
# no locking, and convergence by the residual's self-consistency.

def _eigh_descending(A):
    w, V = torch.linalg.eigh(A)
    return w.flip(0), V.flip(1)


def _svqb(X):
    """A truncated orthonormal basis of X's columns (SVQB): columns that
    are numerically dependent come out zero."""
    norms = torch.linalg.vector_norm(X, dim=0, keepdim=True)
    X = X / torch.where(norms == 0, torch.ones_like(norms), norms)
    inner = X.T @ X
    w, V = _eigh_descending(inner)
    tau = torch.finfo(X.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, torch.ones_like(padded)) ** -0.5
    orthoX = X @ (V * sqrted[None, :])
    keep = ((w > tau) & (torch.diag(inner) > 0.0))[None, :]
    orthoX = orthoX * keep.to(orthoX.dtype)
    norms = torch.linalg.vector_norm(orthoX, dim=0, keepdim=True)
    keep = keep & (norms > 0.0)
    return orthoX / torch.where(keep, norms, torch.ones_like(norms))


def _orthonormalize(basis):
    for _ in range(2):               # twice is enough
        basis = _svqb(basis)
    return basis


def _extend_basis(X, m):
    """m more orthonormal columns for the orthonormal (n, k) X, by block
    Householder reflectors (deterministic)."""
    n, k = X.shape
    Xupper, Xlower = X[:k], X[k:]
    u, s, vt = torch.linalg.svd(Xupper)
    y = torch.cat([Xupper + u @ vt, Xlower], dim=0)
    other = torch.cat([torch.eye(m, dtype=X.dtype, device=X.device),
                       X.new_zeros((n - k - m, m))], dim=0)
    w = y @ (vt.T * ((2 * (1 + s)) ** -0.5)[None, :])
    h = -2 * (w @ (w[k:, :].T @ other))
    h[k:] += other
    return h


def _project_out(basis, U):
    """U's component orthogonal to `basis` (orthonormal, zero columns
    allowed), orthonormalised; suspicious columns zeroed."""
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U)
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
    normU = torch.linalg.vector_norm(U, dim=0, keepdim=True)
    return U * (normU >= 0.99).to(U.dtype)


def lobpcg_standard(A, X, m=100, tol=None):
    """The top-k eigenpairs of the symmetric operator A (a callable on
    (n, k) blocks) from the start block X: (theta (k,), U (n, k),
    iterations), as jax.experimental.sparse.linalg.lobpcg_standard."""
    n, k = X.shape
    if k == 0 or k * 5 >= n:
        raise ValueError(f"lobpcg_standard needs 0 < 5 k < n, got k = {k}, "
                         f"n = {n}")
    if tol is None:
        tol = float(torch.finfo(X.dtype).eps)
    X = _orthonormalize(X)
    P = _extend_basis(X, X.shape[1])
    AX = A(X)
    theta = torch.sum(X * AX, dim=0, keepdim=True)
    R = AX - theta * X
    i = converged = 0
    while i < m and converged < k:
        R = _project_out(torch.cat([X, P], dim=1), R)
        XPR = torch.cat([X, P, R], dim=1)
        theta, Q = _eigh_descending(XPR.T @ A(XPR))
        B = Q[:, :k]
        B = B / torch.linalg.vector_norm(B, dim=0, keepdim=True)
        X = XPR @ B
        X = X / torch.linalg.vector_norm(X, dim=0, keepdim=True)
        q, _ = torch.linalg.qr(Q[:k, k:].T)
        P = XPR @ (Q[:, k:] @ q)
        normP = torch.linalg.vector_norm(P, dim=0, keepdim=True)
        P = P / torch.where(normP == 0, torch.ones_like(normP), normP)
        AX = A(X)
        R = AX - theta[None, :k] * X
        resid = torch.linalg.vector_norm(R, dim=0)
        reltol = (torch.linalg.vector_norm(AX, dim=0) + theta[:k]) * n * 10
        converged = int((resid < tol * reltol).sum())
        theta = theta[None, :k]
        i += 1
    return theta[0], X, i
