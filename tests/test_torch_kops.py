"""k-space operations of the PyTorch port (ngmix_tpu_torch/metacal/kops.py)
against ngmix_tpu/metacal/kops.py on the same numpy inputs, in float64.

Tolerance: 1e-10 relative to the max |value| of the reference, the
float64 round-off of two FFT libraries and of host-built phase
matrices against device-built ones. The exactness checks repeat
tests/test_metacal.py::test_remap_exact (1e-12 absolute) and
test_partial_dft_matrices_exact (rtol 1e-10).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmix_tpu.jacobian import Jacobian as JJacobian
from ngmix_tpu.metacal import kops as jk

from ngmix_tpu_torch.jacobian import Jacobian
from ngmix_tpu_torch.metacal import kops as tk

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

# a sheared, rotated WCS so every jacobian term enters
_JAC = (0.26, 0.013, -0.009, 0.27)


def _jjac():
    return JJacobian(
        row=0.0, col=0.0, dvdrow=_JAC[0], dvdcol=_JAC[1], dudrow=_JAC[2],
        dudcol=_JAC[3],
    )


def _tjac():
    return Jacobian(
        row=0.0, col=0.0, dvdrow=_JAC[0], dvdcol=_JAC[1], dudrow=_JAC[2],
        dudcol=_JAC[3],
    )


def _close(out, ref):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(out - ref)) <= 1e-10 * scale


def _cplx(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def test_good_fft_size_matches():
    for n in (19, 25, 49, 64, 97, 98, 128, 129, 333):
        assert tk.good_fft_size(n) == jk.good_fft_size(n)


@pytest.mark.parametrize("N", [64, 100])
def test_grids_match(N):
    _close(tk.signed_index(N), jk.signed_index(N))
    for a, b in zip(tk.kgrids(N), jk.kgrids(N)):
        _close(a, b)
    _close(tk.pixel_kresponse(N), jk.pixel_kresponse(N))
    jac = _tjac()
    for a, b in zip(tk.sky_kvu(N, jac), jk.sky_kvu(N, _jjac())):
        _close(a, b)
    _close(tk.sky_ksq(N, jac), jk.sky_ksq(N, _jjac()))


@pytest.mark.parametrize("N", [64, 100])
def test_transforms_match(N):
    rng = np.random.RandomState(N)
    A = _cplx(rng, (3, N, N))
    _close(tk.fft2_auto(torch.as_tensor(A)), jk.fft2_auto(jnp.asarray(A)))
    _close(
        tk.fft2_auto(torch.as_tensor(A), inverse=True),
        jk.fft2_auto(jnp.asarray(A), inverse=True),
    )
    img = rng.normal(size=(3, 25, 21))
    _close(tk.dft2_zeropad(torch.as_tensor(img), N),
           jk.dft2_zeropad(jnp.asarray(img), N))
    _close(tk.idft2_crop(torch.as_tensor(A), 7, 11, 19, 13),
           jk.idft2_crop(jnp.asarray(A), 7, 11, 19, 13))
    _close(tk.partial_idft_matrix(N, 5, 19), jk.partial_idft_matrix(N, 5, 19))


@pytest.mark.parametrize("N", [64, 100])
def test_deconvolve_and_target_sigma_match(N):
    rng = np.random.RandomState(N + 1)
    ksq = jk.sky_ksq(N, _jjac())
    # a psf-like transform with a near-zero mode to hit the floor
    psfhat = np.exp(-0.5 * 0.9**2 * np.asarray(ksq))[None] * (
        1 + 0.05 * _cplx(rng, (2, N, N))
    )
    psfhat[:, 3, 5] = 1e-14
    imhat = _cplx(rng, (2, N, N))
    _close(
        tk.deconvolve_k(torch.as_tensor(imhat), torch.as_tensor(psfhat)),
        jk.deconvolve_k(jnp.asarray(imhat), jnp.asarray(psfhat)),
    )
    _close(
        tk.gauss_target_sigma(torch.as_tensor(psfhat), torch.as_tensor(np.array(ksq))),
        jk.gauss_target_sigma(jnp.asarray(psfhat), ksq),
    )


def test_shear_and_kmap_matrices_match():
    S = tk.shear_matrix(0.01, -0.007)
    np.testing.assert_array_equal(S, jk.shear_matrix(0.01, -0.007))
    np.testing.assert_allclose(
        tk.kmap_matrix(_tjac(), S), jk.kmap_matrix(_jjac(), S),
        rtol=1e-14,
    )


@pytest.mark.parametrize("N", [64, 100])
@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("b,coef", [(1.013, None), (0.987, 0.021), (1.0, -0.013)])
def test_scale_axis_matmul_matches(N, axis, b, coef):
    rng = np.random.RandomState(N + 7)
    A = _cplx(rng, (2, N, N))
    idx = jk.signed_index(N)
    jshift = None
    if coef is not None:
        # the JAX version takes the shift field: coef times the signed
        # index along the other axis
        jshift = coef * (idx[None, :] if axis == -2 else idx[:, None])
    _close(
        tk._scale_axis_matmul(torch.as_tensor(A), b, axis=axis, shift=coef),
        jk._scale_axis_matmul(jnp.asarray(A), b, axis=axis, shift=jshift),
    )


@pytest.mark.parametrize("N", [64, 100])
def test_remap_k_matches(N):
    rng = np.random.RandomState(N + 3)
    khat = _cplx(rng, (2, N, N))
    jac = _tjac()
    for g1, g2 in ((0.01, 0.0), (-0.01, 0.0), (0.0, 0.01), (0.0, -0.01)):
        S = tk.shear_matrix(g1, g2)
        M = tk.kmap_matrix(jac, S)
        _close(tk.remap_k(torch.as_tensor(khat), M),
               jk.remap_k(jnp.asarray(khat), M))
    M = np.eye(2) * 1.02
    _close(tk.remap_k(torch.as_tensor(khat), M), jk.remap_k(jnp.asarray(khat), M))


def test_remap_exact():
    """the shear / scale remap is exact for band-limited data"""
    N = 96
    kr, kc = (x.numpy() for x in tk.kgrids(N))
    ksq = kr**2 + kc**2
    ghat = torch.as_tensor(np.exp(-0.5 * 2.6**2 * ksq) + 0j)
    S = tk.shear_matrix(0.01, -0.007)
    out = tk.remap_k(ghat, S.T)
    STk_r = S[0, 0] * kr + S[1, 0] * kc
    STk_c = S[0, 1] * kr + S[1, 1] * kc
    oracle = np.exp(-0.5 * 2.6**2 * (STk_r**2 + STk_c**2))
    assert np.abs(out.real.numpy() - oracle).max() < 1e-12

    # dilation (det != 1)
    out = tk.remap_k(ghat, np.eye(2) * 1.02)
    oracle = np.exp(-0.5 * 2.6**2 * 1.02**2 * ksq)
    assert np.abs(out.real.numpy() - oracle).max() < 1e-12


def test_partial_dft_matrices_exact():
    """idft2_crop and dft2_zeropad match full FFTs to round-off"""
    rng = np.random.RandomState(5)
    N = 48
    khat = torch.as_tensor(_cplx(rng, (3, N, N)))
    full = torch.fft.ifft2(khat)
    crop = tk.idft2_crop(khat, 7, 11, 19, 13)
    np.testing.assert_allclose(
        crop.numpy(), full[:, 7:26, 11:24].numpy(), rtol=1e-10, atol=1e-12
    )
    img = torch.as_tensor(rng.normal(size=(3, 21, 17)))
    pad = torch.zeros((3, N, N), dtype=torch.float64)
    pad[:, :21, :17] = img
    np.testing.assert_allclose(
        tk.dft2_zeropad(img, N).numpy(), torch.fft.fft2(pad).numpy(),
        rtol=1e-10, atol=1e-10,
    )


@pytest.mark.parametrize("N", [64, 65])
@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("b,coef", [(1.013, None), (0.987, 0.021), (1.0, -0.013), (1.0, None)])
def test_czt_scale_axis_matches(N, axis, b, coef):
    """the chirp-z scaling at an even and an odd N, with and without a
    shift, and at b = 1; it also equals the dense matrix route"""
    rng = np.random.RandomState(N + 11)
    A = _cplx(rng, (2, N, N))
    idx = jk.signed_index(N)
    jshift = None
    if coef is not None:
        jshift = coef * (idx[None, :] if axis == -2 else idx[:, None])
    out = tk._czt_scale_axis(torch.as_tensor(A), b, axis=axis, shift=coef)
    _close(out, jk._czt_scale_axis(jnp.asarray(A), b, axis=axis, shift=jshift))
    _close(out, tk._scale_axis_matmul(torch.as_tensor(A), b, axis=axis, shift=coef).numpy())


def test_remap_large_grid_not_ported():
    """above MAX_MATMUL_N remap_k leaves the dense matrix route for the
    chirp-z scaling, and matches the JAX package there (one stamp)"""
    N = tk.MAX_MATMUL_N + 8
    rng = np.random.RandomState(N)
    khat = _cplx(rng, (1, N, N))
    M = tk.kmap_matrix(_tjac(), tk.shear_matrix(0.01, -0.007))
    _close(tk.remap_k(torch.as_tensor(khat), M), jk.remap_k(jnp.asarray(khat), M))


def test_constants_cached_per_device_and_dtype():
    a = tk.pixel_kresponse(64, dtype=torch.float32)
    assert a is tk.pixel_kresponse(64, dtype=torch.float32)
    assert a.dtype == torch.float32
    assert tk.pixel_kresponse(64, dtype=torch.float64).dtype == torch.float64
