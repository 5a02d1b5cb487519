"""The psf modes of the PyTorch port (azgauss, fitgauss and dilate, with
the psf-sheared metacal types) against the JAX package, in float64 at
B = 6 on inputs made once with numpy from a seed: 33x33 stamps at pad 2
(N = 66), 25x25 psf stamps, the 19x19 fit window.

Tolerance: flags, numiter (admom) and nfev (exp-LM) equal; every other
result field, the target sigma, the images and the responses to rtol
1e-8 and atol 1e-10 with NaNs in the same places, as
tests/test_batch_pipeline.py holds two implementations of one objective
against each other. The exp-LM reference is the JAX package's K1 route
(ngmix_tpu.batch._exp_lm_measure patched to use_pallas=True with the
TPU kernel in interpret mode, for the duration of the fixture only).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmix_tpu import batch as jbatch
from ngmix_tpu.gmix import core as jcore
from ngmix_tpu.metacal import kops as jkops

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import batch as tbatch, convert
from ngmix_tpu_torch.metacal import kops

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

B = 6
DIMS = (33, 33)
PSF_DIMS = (25, 25)
SCALE = 0.263
TYPES9 = jbatch.GALSHEAR_TYPES + jbatch.PSFSHEAR_TYPES
INT_KEYS = ("flags", "numiter", "nfev", "T_flags", "flux_flags", "rho4_flags",
            "npix", "ier")


def _inputs(seed=29):
    """exp galaxies of varied size, flux and shape convolved with varied
    elliptical turb psfs, sheared by (0.02, 0), with noise"""
    rng = np.random.RandomState(seed)
    z = np.zeros(B)
    gal, _ = jcore.fill_exp(jnp.asarray(np.stack(
        [z, z, rng.uniform(-0.2, 0.2, B), rng.uniform(-0.2, 0.2, B),
         rng.uniform(0.3, 1.1, B), rng.uniform(60.0, 140.0, B)], -1)))
    gal = jcore.gmix_get_sheared(gal, 0.02, 0.0)
    psf, _ = jcore.fill_turb(jnp.asarray(np.stack(
        [z, z, rng.uniform(-0.04, 0.04, B), rng.uniform(-0.04, 0.04, B),
         rng.uniform(0.24, 0.30, B), np.ones(B)], -1)))

    def grid(dims, cens):
        rr, cc = np.meshgrid(np.arange(dims[0]), np.arange(dims[1]), indexing="ij")
        return ((rr.reshape(-1)[None] - cens[:, :1]) * SCALE,
                (cc.reshape(-1)[None] - cens[:, 1:]) * SCALE)

    cens = np.array([(DIMS[0] - 1) / 2, (DIMS[1] - 1) / 2]) + rng.uniform(-0.5, 0.5, (B, 2))
    v, u = grid(DIMS, cens)
    conv = jcore.gmix_convolve(gal, psf)
    imgs = np.array(jcore.eval_gmix(conv, v, u, SCALE**2, fast=False)).reshape(B, *DIMS)
    imgs = imgs + rng.normal(0, 1e-4, imgs.shape)
    pcens = np.tile([(PSF_DIMS[0] - 1) / 2, (PSF_DIMS[1] - 1) / 2], (B, 1)).astype(float)
    pv, pu = grid(PSF_DIMS, pcens)
    pimgs = np.array(jcore.eval_gmix(psf, pv, pu, SCALE**2, fast=False)).reshape(B, *PSF_DIMS)
    weights = np.full((B,) + DIMS, 1e8)
    noise = rng.normal(0, 1e-4, (B,) + DIMS)
    return imgs, weights, cens, pimgs, pcens, noise


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _jconf(mode, **kw):
    types = TYPES9 if mode == "dilate" else jbatch.GALSHEAR_TYPES
    return jbatch.MetacalConfig(
        dims=DIMS, psf_dims=PSF_DIMS, jac=(SCALE, 0.0, 0.0, SCALE), fixnoise=True,
        pad_factor=2, fit_dims=(19, 19), psf_mode=mode, types=types, **kw,
    )


def assert_results_equal(tres, jres, what):
    """every field of two result dicts: the integer fields equal, the
    others to rtol 1e-8 and atol 1e-10 with NaNs in the same places"""
    assert set(tres) == set(jres), (what, set(tres) ^ set(jres))
    for k, ref in jres.items():
        got = tres[k]
        assert np.shape(got) == np.shape(ref), (what, k)
        if k in INT_KEYS:
            np.testing.assert_array_equal(got, ref, err_msg=str((what, k)))
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-10, equal_nan=True,
                                       err_msg=str((what, k)))


def _sr_input(res):
    return {t: {k: torch.as_tensor(v) for k, v in r.items()}
            for t, r in res.items() if isinstance(r, dict)}


# ----------------------------------------------------------------------
# the target sigma of each mode

def _psfhat(pimgs, N, n_noise=0.02, seed=5):
    """unnormalized psf transforms [5, N, N]: two turb psfs centered on
    the origin, whose positive profiles cross the threshold by the log
    interpolation; a noisy one; a flat one that never crosses it (the
    first annulus is clamped to 1); and one whose profile turns
    negative (the linear interpolation)"""
    rng = np.random.RandomState(seed)
    pad = np.zeros((2, N, N))
    pad[:, :PSF_DIMS[0], :PSF_DIMS[1]] = pimgs[:2]
    c = (PSF_DIMS[0] - 1) // 2
    ph = np.fft.fft2(np.roll(pad, (-c, -c), axis=(1, 2))) * 3.0
    noisy = ph[0] + n_noise * ph[0, 0, 0].real * rng.normal(size=(N, N))
    flat = np.ones((N, N), complex) * 2.0
    kr = np.fft.fftfreq(N)[:, None] * N
    kc = np.fft.fftfreq(N)[None, :] * N
    neg = np.where(np.hypot(kr, kc) > 2.6, -0.5, 1.0).astype(complex)
    return np.concatenate([ph, noisy[None], flat[None], neg[None]])


def test_azgauss_target_sigma_matches_jax(inputs):
    N = 66
    ph = _psfhat(inputs[3], N)
    jac = jbatch._host_jacobian(_jconf("azgauss"))
    jksq = jkops.sky_ksq(N, jac, dtype=jnp.float64)
    want = np.asarray(jax.vmap(lambda p: jkops.azgauss_target_sigma(p, jksq, nbin=N))(
        jnp.asarray(ph)))
    ksq = kops.sky_ksq(N, tbatch._host_jacobian(convert.config_from_fields(_jconf("azgauss"))))
    got = kops.azgauss_target_sigma(torch.as_tensor(ph), ksq, nbin=N).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)
    assert np.all(np.isfinite(want))


@pytest.mark.parametrize("mode", ["gauss", "azgauss", "fitgauss", "dilate"])
def test_prepare_psf_kdata_sigma_matches_jax(inputs, mode):
    pimgs, pcens = inputs[3].copy(), inputs[4]
    # a negated psf stamp fails the fitgauss admom fit (NONPOS_FLUX)
    # and takes the k-pinned fallback
    pimgs[1] *= -1.0
    jconf = _jconf(mode)
    jd = jbatch.prepare_psf_kdata(jnp.asarray(pimgs), jnp.asarray(pcens), jconf)
    td = tbatch.prepare_psf_kdata(torch.as_tensor(pimgs), torch.as_tensor(pcens),
                                  convert.config_from_fields(jconf))
    np.testing.assert_allclose(td["sigma"].numpy(), np.asarray(jd["sigma"]),
                               rtol=1e-8, atol=1e-10)
    if mode == "dilate":
        np.testing.assert_allclose(td["psfhat_nopix"].numpy(), np.asarray(jd["psfhat_nopix"]),
                                   rtol=1e-8, atol=1e-10)
    else:
        assert td["psfhat_nopix"] is None and jd["psfhat_nopix"] is None
    if mode == "fitgauss":
        fit = tbatch._fitgauss_target_sigma_batch(
            torch.as_tensor(pimgs), torch.as_tensor(pcens), convert.config_from_fields(jconf))
        assert np.isnan(fit[1].item()) and np.all(np.isfinite(np.delete(fit.numpy(), 1)))


def test_bad_psf_mode_raises(inputs):
    conf = convert.config_from_fields(_jconf("gauss"))._replace(psf_mode="bogus")
    with pytest.raises(ValueError, match="bad psf_mode"):
        tbatch.prepare_psf_kdata(torch.as_tensor(inputs[3]), torch.as_tensor(inputs[4]), conf)


def test_metacal_image_set_dilate_matches_jax(inputs):
    jconf = _jconf("dilate")
    imgs, _, cens, pimgs, pcens, _ = inputs
    jout, jsig, jpsf = jbatch.metacal_image_set(
        *map(jnp.asarray, (imgs, cens, pimgs, pcens)), jconf, with_psf_images=True)
    tout, tsig, tpsf = tbatch.metacal_image_set(
        *map(torch.as_tensor, (imgs, cens, pimgs, pcens)), convert.config_from_fields(jconf),
        with_psf_images=True)
    assert list(tout) == list(jout) == list(TYPES9) and list(tpsf) == list(TYPES9)
    np.testing.assert_allclose(tsig.numpy(), np.asarray(jsig), rtol=1e-8, atol=1e-10)
    for t in TYPES9:
        assert tout[t].shape == (B,) + DIMS and tpsf[t].shape == (B,) + PSF_DIMS
        np.testing.assert_allclose(tout[t].numpy(), np.asarray(jout[t]), rtol=1e-8,
                                   atol=1e-10, err_msg=t)
        np.testing.assert_allclose(tpsf[t].numpy(), np.asarray(jpsf[t]), rtol=1e-8,
                                   atol=1e-10, err_msg=t)
    # the psf-sheared targets differ from the unsheared one
    assert not np.allclose(tpsf["1p_psf"].numpy(), tpsf["noshear"].numpy(), atol=1e-6)


# ----------------------------------------------------------------------
# the pipelines

PIPELINES = [("gaussmom", "fitgauss"), ("gaussmom", "azgauss"), ("gaussmom", "dilate"),
             ("admom", "fitgauss"), ("admom", "azgauss"), ("admom", "dilate"),
             ("exp-lm", "dilate")]


@pytest.fixture(scope="module", params=PIPELINES, ids=["%s-%s" % p for p in PIPELINES])
def runs(request, inputs):
    """(measure, mode, JAX results, port results), computed once per
    module; the exp-LM reference runs through the JAX package's K1
    route"""
    measure, mode = request.param
    jconf = _jconf(mode)
    with pytest.MonkeyPatch.context() as mp:
        if measure == "exp-lm":
            mp.setattr(jbatch, "_exp_lm_measure", functools.partial(
                jbatch._exp_lm_measure, use_pallas=True, interpret=True))
        jres = jbatch.make_metacal_pipeline_fn(jconf, measure=measure)(
            *map(jnp.asarray, inputs))
    tres = nt.make_metacal_pipeline_fn(convert.config_from_fields(jconf), measure=measure,
                                       device="cpu")(*inputs)
    return measure, mode, jax.tree.map(np.asarray, jres), convert.to_numpy(tres)


def test_psf_mode_pipelines_match_jax(runs):
    measure, mode, jres, tres = runs
    assert set(tres) == set(jres)
    np.testing.assert_allclose(tres["psf_sigma"], jres["psf_sigma"], rtol=1e-8, atol=1e-10)
    for t in _jconf(mode).types:
        assert_results_equal(tres[t], jres[t], (measure, mode, t))
    # every lane of these clean stamps measures
    assert all(np.all(tres[t]["flags"] == 0) for t in jbatch.GALSHEAR_TYPES)


def test_psf_mode_responses_match_jax(runs):
    measure, mode, jres, tres = runs
    jsr = jbatch.shear_response(jax.tree.map(jnp.asarray, jres))
    tsr = convert.to_numpy(tbatch.shear_response(_sr_input(tres)))
    for k in ("R", "shear", "e_mean"):
        np.testing.assert_allclose(tsr[k], np.asarray(jsr[k]), rtol=1e-8, atol=1e-10)
    if mode == "dilate":
        jrp = np.asarray(jbatch.psf_shear_response(jax.tree.map(jnp.asarray, jres)))
        trp = nt.psf_shear_response(_sr_input(tres)).numpy()
        np.testing.assert_allclose(trp, jrp, rtol=1e-8, atol=1e-10)
        assert np.all(np.isfinite(trp))


def test_psf_types_need_dilate(inputs):
    for mode in ("gauss", "azgauss", "fitgauss"):
        conf = convert.config_from_fields(_jconf(mode))._replace(types=TYPES9)
        with pytest.raises(ValueError, match="psf_mode='dilate'"):
            nt.metacal_pipeline(*inputs, conf, device="cpu")
