"""Unrolled small-matrix Cholesky routines for per-lane fitter algebra.

The port of ``ngmix_tpu/ops/small_linalg.py``. Each function takes
``A[..., n, n]`` and unrolls the factorization in Python into
elementwise tensor ops over the leading batch dims. That keeps every
lane's arithmetic independent of how many lanes share the batch, which
the LM's straggler compaction relies on for bitwise-equal results.

Failure propagates IEEE-style: a non-positive pivot gives nan (sqrt of
a negative, or a division by zero), which callers treat as a rejected
step or a flagged covariance. ``torch.linalg.cholesky`` raises instead
and ``cholesky_ex`` returns error codes, so neither is a drop-in.
"""
import torch

__all__ = ["chol_solve", "chol_inverse", "chol_is_spd"]


def _chol_entries(A):
    """lower-triangular Cholesky entries of A as Python lists.

    Returns (L, pivots): L[i][j] (i >= j) tensors of A's leading shape,
    and the n pre-sqrt pivots (A is SPD iff all pivots > 0, Sylvester's
    criterion through the leading principal minors).
    """
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    pivots = []
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        pivots.append(s)
        d = torch.sqrt(s)
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            t = A[..., i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * inv_d
    return L, pivots


def chol_solve(A, b):
    """solve A x = b for SPD A[..., n, n], b[..., n] -> x[..., n];
    nan where A is not positive definite"""
    L, _ = _chol_entries(A)
    n = len(L)
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def chol_inverse(A):
    """inverse of SPD A[..., n, n] via inv(L): A^-1 = L^-T L^-1.

    nan where A is not positive definite: an indefinite (invalid
    covariance) matrix comes back nan for the callers' finiteness
    flags, where an LU inverse would return finite garbage.
    """
    L, _ = _chol_entries(A)
    n = len(L)
    invL = [[None] * n for _ in range(n)]
    for j in range(n):
        invL[j][j] = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = L[i][j] * invL[j][j]
            for k in range(j + 1, i):
                s = s + L[i][k] * invL[k][j]
            invL[i][j] = -s / L[i][i]
    rows = []
    for i in range(n):
        cols = []
        for j in range(n):
            s = None
            for k in range(max(i, j), n):
                t = invL[k][i] * invL[k][j]
                s = t if s is None else s + t
            cols.append(s)
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


def chol_is_spd(A):
    """[...] bool: every Cholesky pivot strictly positive. For finite
    symmetric A this is "all eigenvalues > 0"; nan pivots compare
    False."""
    _, pivots = _chol_entries(A)
    ok = None
    for s in pivots:
        good = s > 0
        ok = good if ok is None else ok & good
    return ok
