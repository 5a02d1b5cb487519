"""Pre-PSF moments of the PyTorch port (ngmix_tpu_torch/prepsfmom.py)
against ngmix_tpu/prepsfmom.py on the same numpy inputs, in float64.

The host-built kernels, apodization mask and partial-DFT matrices
equal the JAX package's numpy build (xp=np) to 1e-14. prepsfmom_batch,
by both routes (partial modes and full FFTs), both kernels, white and
measured noise and an even and an odd target_dim, matches JAX's at
rtol 1e-10 and atol 1e-13 (tests/test_prepsfmom.py:226) in every
result field, kernel_nrm and the flags included; one lane is negated
so that the flags are not all 0. The two routes of the port agree with
each other at the same tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmix_tpu import prepsfmom as jp

from ngmix_tpu_torch import prepsfmom as tp

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

B, H, HP = 4, 33, 25
SCALE = 0.263
# a sheared, rotated WCS so every jacobian term enters
JAC_WCS = (SCALE, 0.01, -0.02, 0.95 * SCALE)


def _gauss_stamps(rng, n, dim, cens, T, g):
    """[n, dim, dim] unit-flux elliptical gaussians at cens [n, 2]"""
    rr, cc = np.meshgrid(np.arange(dim), np.arange(dim), indexing="ij")
    v = (rr[None] - cens[:, 0, None, None]) * SCALE
    u = (cc[None] - cens[:, 1, None, None]) * SCALE
    irr = T / 2 * (1 - g[:, 0])
    irc = T / 2 * g[:, 1]
    icc = T / 2 * (1 + g[:, 0])
    det = irr * icc - irc * irc
    chi2 = (icc[:, None, None] * v * v + irr[:, None, None] * u * u
            - 2 * irc[:, None, None] * v * u) / det[:, None, None]
    return np.exp(-0.5 * chi2) / (2 * np.pi * np.sqrt(det))[:, None, None] * SCALE**2


def _inputs(seed=3):
    """(images, cens, psf_images, psf_cens, tot_var, noise_images): B
    galaxies of varied size and shape seen through varied psfs, with
    noise; lane 1 negated"""
    rng = np.random.RandomState(seed)
    cens = (H - 1) / 2.0 + rng.uniform(-0.5, 0.5, (B, 2))
    pcens = np.full((B, 2), (HP - 1) / 2.0)
    pT = rng.uniform(0.24, 0.32, B)
    pg = rng.uniform(-0.03, 0.03, (B, 2))
    gT = rng.uniform(0.3, 1.0, B)
    gg = rng.uniform(-0.2, 0.2, (B, 2))
    images = 100.0 * _gauss_stamps(rng, B, H, cens, gT + pT, gg)
    images += rng.normal(0, 1e-3, images.shape)
    images[1] *= -1.0
    pims = _gauss_stamps(rng, B, HP, pcens, pT, pg)
    tot_var = np.full(B, 1e-6 * H * H)
    noise = rng.normal(0, 1e-3, images.shape)
    return images, cens, pims, pcens, tot_var, noise


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.mark.parametrize("smooth", [0.0, 0.8])
@pytest.mark.parametrize("kernel", ["ksigma", "gauss"])
@pytest.mark.parametrize("dim", [132, 133])
def test_kernels_match_jax_numpy_build(kernel, dim, smooth):
    jbuild = jp.ksigma_kernels if kernel == "ksigma" else jp.gauss_kernels
    tbuild = tp.ksigma_kernels if kernel == "ksigma" else tp.gauss_kernels
    ref = jbuild(dim, 1.7, JAC_WCS, fwhm_smooth=smooth, dtype=np.float64, xp=np)
    got = tbuild(dim, 1.7, JAC_WCS, fwhm_smooth=smooth)
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["msk"], ref["msk"])
    for k in ("fkf", "fkr", "fkp", "fkc", "nrm", "fk00"):
        scale = np.max(np.abs(ref[k]))
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-14, atol=1e-14 * scale, err_msg=k)


@pytest.mark.parametrize("dims,ap_rad", [((33, 33), 1.5), ((25, 31), 2.5)])
def test_apodization_mask_matches_jax(dims, ap_rad):
    np.testing.assert_allclose(tp.apodization_mask(dims, ap_rad),
                               np.asarray(jp.apodization_mask(dims, ap_rad)),
                               rtol=1e-14, atol=1e-14)


def test_partial_dft_matrix_matches_jax():
    sel = np.array([0, 1, 2, 3, 128, 129, 130])
    np.testing.assert_array_equal(tp._partial_dft_matrix(132, sel, 33, 49),
                                  jp._partial_dft_matrix(132, sel, 33, 49))


@pytest.mark.parametrize("dc", [(0, 0), (2, 3)])
def test_deconvolve_floor_matches_jax(dc):
    """the |P| floor: modes at zero, below the floor and above it, the
    reference amplitude at the given place"""
    rng = np.random.RandomState(4)
    kpsf = rng.normal(size=(3, 6, 7)) + 1j * rng.normal(size=(3, 6, 7))
    kpsf[:, dc[0], dc[1]] = 10.0
    kpsf[0, 1, 1] = 0.0
    kpsf[1, 4, 5] = 1e-5 + 1e-6j
    kpsf[2, 5, 6] = 1e-9
    kim = rng.normal(size=(3, 6, 7)) + 1j * rng.normal(size=(3, 6, 7))
    for got, ref in zip(tp._deconvolve_at(torch.as_tensor(kim), torch.as_tensor(kpsf), *dc),
                        jp._deconvolve_at(jnp.asarray(kim), jnp.asarray(kpsf), *dc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-14, atol=0)


def _compare(got, ref, rtol=1e-10, atol=1e-13):
    assert set(got) == set(ref)
    for k, r in ref.items():
        r = np.asarray(r)
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        assert g.shape == r.shape, (k, g.shape, r.shape)
        if r.dtype.kind in "iub":
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            np.testing.assert_allclose(g, r, rtol=rtol, atol=atol, equal_nan=True, err_msg=k)


KW = {"pgauss": dict(kernel="gauss", fwhm=2.0), "ksigma": dict(kernel="ksigma", fwhm=1.2)}


@pytest.mark.parametrize("noise", [False, True], ids=["white", "noise_images"])
@pytest.mark.parametrize("partial", [True, False], ids=["partial", "fft"])
@pytest.mark.parametrize("target_dim", [4 * H, 4 * H + 1])
@pytest.mark.parametrize("measure", sorted(KW))
def test_prepsfmom_batch_matches_jax(inputs, measure, target_dim, partial, noise):
    images, cens, pims, pcens, tot_var, nz = inputs
    kw = dict(KW[measure], target_dim=target_dim, jac_tuple=JAC_WCS, partial_modes=partial)
    ref = jp.prepsfmom_batch(*map(jnp.asarray, (images, cens, pims, pcens, tot_var)),
                             noise_images=jnp.asarray(nz) if noise else None, **kw)
    got = tp.prepsfmom_batch(images, cens, pims, pcens, tot_var,
                             noise_images=nz if noise else None, device="cpu", **kw)
    _compare(got, jax.tree.map(np.asarray, ref))
    flags = got["flags"].numpy()
    assert flags[1] != 0 and np.all(flags[[0, 2, 3]] == 0)
    assert np.all(np.isnan(got["sums"][:, :2].numpy()))
    np.testing.assert_allclose(got["kernel_nrm"].numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("has_psf,use_noise", [(False, False), (False, True), (True, True)])
def test_prepsfmom_core_matches_jax(inputs, has_psf, use_noise):
    """the full-FFT route over the batch against JAX's single-stamp
    prepsfmom_core, also without a psf (the pixel response alone)"""
    images, cens, pims, pcens, tot_var, nz = inputs
    static = (4 * H + 1, 1.5, "ksigma", JAC_WCS, 1.2, 0.0, has_psf, use_noise)
    got = tp.prepsfmom_core(*(torch.as_tensor(x) for x in (images, cens, pims, pcens, tot_var,
                                                           nz)), *static)
    for i in range(B):
        ref = jp.prepsfmom_core(*(jnp.asarray(x[i]) for x in (images, cens, pims, pcens,
                                                               tot_var, nz)), *static)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(r), rtol=1e-10, atol=1e-13,
                                       equal_nan=True)


@pytest.mark.parametrize("measure", sorted(KW))
def test_partial_modes_match_fft_route(inputs, measure):
    """the port's two routes agree, with the diagonal WCS at bench.py's
    target_dim"""
    images, cens, pims, pcens, tot_var, _ = inputs
    kw = dict(KW[measure], target_dim=4 * H, jac_tuple=(SCALE, 0.0, 0.0, SCALE))
    a = tp.prepsfmom_batch(images, cens, pims, pcens, tot_var, partial_modes=True,
                           device="cpu", **kw)
    b = tp.prepsfmom_batch(images, cens, pims, pcens, tot_var, partial_modes=False,
                           device="cpu", **kw)
    _compare(a, b)


def test_float32_keeps_its_dtype(inputs):
    images, cens, pims, pcens, tot_var, _ = inputs
    res = tp.prepsfmom_batch(images.astype(np.float32), cens, pims, pcens, tot_var,
                             target_dim=4 * H, kernel="ksigma", jac_tuple=JAC_WCS,
                             fwhm=1.2, device="cpu")
    ref = tp.prepsfmom_batch(images, cens, pims, pcens, tot_var, target_dim=4 * H,
                             kernel="ksigma", jac_tuple=JAC_WCS, fwhm=1.2, device="cpu")
    assert res["T"].dtype == torch.float32 and res["sums_cov"].dtype == torch.float32
    ok = ref["flags"] == 0
    np.testing.assert_allclose(res["T"][ok].numpy(), ref["T"][ok].numpy(), rtol=1e-4)


def test_constants_cached_per_device_and_dtype():
    args = ("plan", ("kmat", 132, "ksigma", (SCALE, 0.0, 0.0, SCALE), 1.2, 0.0))
    a = tp._const(*args, torch.device("cpu"), torch.float32)
    assert a is tp._const(*args, torch.device("cpu"), torch.float32)
    assert tp._const(*args, torch.device("cpu"), torch.float64).dtype == torch.float64


def test_no_device_without_card_raises(monkeypatch, inputs):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.prepsfmom_batch(*inputs[:5], target_dim=4 * H, kernel="ksigma",
                           jac_tuple=JAC_WCS, fwhm=1.2)
