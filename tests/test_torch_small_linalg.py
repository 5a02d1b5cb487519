"""The unrolled Cholesky routines of the PyTorch port against the JAX
package's (ngmix_tpu/ops/small_linalg.py), in float64 on the same numpy
batches of SPD, singular and indefinite 6x6 matrices.

Tolerance: rtol 1e-12 (both unroll the same elementwise arithmetic in
the same order), and the nan rule must match: a matrix that is not
positive definite gives nan in the same entries on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmix_tpu.ops import small_linalg as jlinalg

from ngmix_tpu_torch.ops import small_linalg as tlinalg


def _batch(kind, B=24, n=6, seed=11):
    rng = np.random.RandomState(seed + len(kind))
    M = rng.normal(size=(B, n + 2, n))
    A = np.einsum("bri,brj->bij", M, M) + 0.1 * np.eye(n)
    if kind == "singular":
        # a zero row and column, at a different index from matrix to
        # matrix, in every other matrix
        for i in range(0, B, 2):
            A[i, i % n, :] = 0.0
            A[i, :, i % n] = 0.0
    elif kind == "indefinite":
        for i in range(0, B, 2):
            w, V = np.linalg.eigh(A[i])
            w[i % n] = -abs(w[i % n]) - 1e-3
            A[i] = (V * w) @ V.T
    return A, rng.normal(size=(B, n))


def _same(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    ok = ~np.isnan(ref)
    np.testing.assert_allclose(out[ok], ref[ok], rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("kind", ["spd", "singular", "indefinite"])
def test_chol_solve_matches_jax(kind):
    A, b = _batch(kind)
    _same(tlinalg.chol_solve(torch.as_tensor(A), torch.as_tensor(b)),
          jlinalg.chol_solve(jnp.asarray(A), jnp.asarray(b)))


@pytest.mark.parametrize("kind", ["spd", "singular", "indefinite"])
def test_chol_inverse_matches_jax(kind):
    A, _ = _batch(kind)
    _same(tlinalg.chol_inverse(torch.as_tensor(A)),
          jlinalg.chol_inverse(jnp.asarray(A)))


@pytest.mark.parametrize("kind", ["spd", "singular", "indefinite"])
def test_chol_is_spd_matches_jax(kind):
    A, _ = _batch(kind)
    got = tlinalg.chol_is_spd(torch.as_tensor(A)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jlinalg.chol_is_spd(jnp.asarray(A))))
    if kind == "spd":
        assert got.all()
    else:
        assert not got[::2].any()


def test_not_spd_gives_nan():
    A = torch.diag(torch.tensor([1.0, -1.0, 2.0], dtype=torch.float64))
    assert not torch.isfinite(tlinalg.chol_solve(A, torch.ones(3, dtype=A.dtype))).all()
    assert not torch.isfinite(tlinalg.chol_inverse(A)).all()
    assert not bool(tlinalg.chol_is_spd(A))
