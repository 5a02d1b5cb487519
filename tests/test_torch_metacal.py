"""The port's host metacal against ngmix_tpu's on the same inputs: the
k-space helpers (kops.centered_fft, centered_ifft, gauss_kprofile, and
the first two bitwise against the batched engine's code they replace),
the metacal images and psf images of every psf mode and every type of
its default list (MetacalGaussPSF, MetacalAzGaussPSF,
MetacalFitGaussPSF, MetacalDilatePSF, MetacalAnalyticPSF) at rtol 1e-8
with an atol of 1e-10 of the peak, get_all_metacal with and without
fixnoise and with use_noise_image on an ObsList and a
MultiBandObsList, the WCS-mismatch ValueError and the Shape TypeError,
simobs.simulate_obs and get_noise_image bit for bit from one seed, the
fitgauss and azgauss target psfs, KSpacePSFFluxFitter's template
fluxes (k-space renders through the same helpers), and ROADMAP fault
3.7 (an image of negative strides, as np.rot90 makes, as an
Observation's image).

The stamps are 25x25 (33x33 for the object of the pixel-size case),
float64, made by the JAX package and carried across by
convert.observation_from_object(device="cpu"); both sides draw from
numpy RandomStates of one seed in the reference's order (the psf noise
of the gaussian targets at construction, fitgauss's guesses, the
fixnoise field).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ngmix_tpu as jn
from ngmix_tpu import simobs as jsimobs
from ngmix_tpu.fitting import kspace_fitters as jk
from ngmix_tpu.metacal import (
    azgauss_target_psf as jaz,
    fitgauss_target_psf as jfit,
    get_all_metacal as jget_all,
    kops as jkops,
)

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import convert, simobs
from ngmix_tpu_torch.fitting import kspace_fitters as tk
from ngmix_tpu_torch.metacal import (
    MetacalAnalyticPSF,
    MetacalDilatePSF,
    MetacalGaussPSF,
    azgauss_target_psf,
    fitgauss_target_psf,
    get_all_metacal,
    kops,
)

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

SCALE = 0.263
DIMS = (25, 25)


def _jax_obs(seed, noise=0.01, dims=DIMS, psf_model="gauss", offset=(0.2, -0.1), jac_psf=None):
    """a JAX package observation of a sheared gaussian under an
    elliptical psf, its center off the stamp center"""
    rng = np.random.RandomState(seed)
    gal = jn.GMixModel([0.0, 0.0, 0.05, -0.03, 0.9, 100.0], "gauss")
    psf = jn.GMixModel([0.0, 0.0, 0.02, 0.01, 0.3, 1.0], psf_model)
    cen = (np.array(dims) - 1.0) / 2.0 + np.array(offset)
    jac = jn.DiagonalJacobian(row=cen[0], col=cen[1], scale=SCALE)
    pjac = jac_psf or jn.DiagonalJacobian(row=12.0, col=12.0, scale=SCALE)
    img = gal.convolve(psf).make_image(dims, jacobian=jac) + rng.normal(size=dims) * noise
    pimg = psf.make_image(DIMS, jacobian=pjac)
    psf_obs = jn.Observation(pimg, weight=np.full(DIMS, 1e6), jacobian=pjac)
    return jn.Observation(img, weight=np.full(dims, 1.0 / noise**2), jacobian=jac,
                          psf=psf_obs)


def _pair(seed, **kw):
    jobs = _jax_obs(seed, **kw)
    return jobs, convert.observation_from_object(jobs, device="cpu")


def _assert_image_close(a, b, what):
    """rtol 1e-8 with an atol of 1e-10 of the peak"""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-10 * np.abs(b).max(), err_msg=what)


def _assert_obs_close(tobs, jobs, what):
    _assert_image_close(tobs.image, jobs.image, what + " image")
    _assert_image_close(tobs.psf.image, jobs.psf.image, what + " psf image")
    np.testing.assert_allclose(tobs.weight, jobs.weight, rtol=1e-12, err_msg=what + " weight")
    np.testing.assert_allclose(tobs.psf.weight, jobs.psf.weight, rtol=1e-12,
                               err_msg=what + " psf weight")
    assert tobs.psf.jacobian.get_cen() == jobs.psf.jacobian.get_cen()
    # the device pixels follow the image (the writeable scope rebuilt them)
    np.testing.assert_array_equal(tobs.pixels.val.numpy(), tobs.image.reshape(-1))


def _assert_dicts_close(td, jd, what):
    assert list(td) == list(jd)
    for key in jd:
        if isinstance(jd[key], jn.Observation):
            _assert_obs_close(td[key], jd[key], "%s %s" % (what, key))
        else:
            assert type(td[key]).__name__ == type(jd[key]).__name__
            for i, (t, j) in enumerate(zip(_leaves(td[key]), _leaves(jd[key]))):
                _assert_obs_close(t, j, "%s %s %d" % (what, key, i))


def _leaves(container):
    if isinstance(container, (jn.Observation, nt.Observation)):
        return [container]
    return [leaf for sub in container for leaf in _leaves(sub)]


# ----------------------------------------------------------------------
# the k-space helpers

def _old_center_phase(cens, N, dtype, sign):
    """the batched engine's center phase before it moved to kops"""
    kr, kc = kops.kgrids(N, dtype=dtype, device=cens.device)
    pr = torch.exp(sign * 1j * kr[:, 0][None, :] * cens[:, 0, None])
    pc = torch.exp(sign * 1j * kc[0, :][None, :] * cens[:, 1, None])
    return pr[:, :, None] * pc[:, None, :]


def _old_batched_centered_fft(img, cens, N):
    H, W = img.shape[-2:]
    phase = _old_center_phase(cens, N, img.dtype, +1.0)
    if H <= N // 2 and W <= N // 2:
        return kops.dft2_zeropad(img, N) * phase
    pad = torch.zeros(img.shape[:-2] + (N, N), dtype=kops.complex_dtype(img.dtype),
                      device=img.device)
    pad[..., :H, :W] = img
    return kops.fft2_auto(pad) * phase


def _old_batched_centered_ifft(khat, cens, dims):
    N = khat.shape[-1]
    phase = _old_center_phase(cens, N, khat.real.dtype, -1.0)
    full = kops.fft2_auto(khat * phase, inverse=True).real
    return full[..., : dims[0], : dims[1]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N", [64, 40])
def test_centered_fft_is_the_batched_engines_bitwise(dtype, N):
    """kops.centered_fft / centered_ifft, which batch.py now calls, equal
    the batched engine's former code bit for bit (N = 64: the partial
    DFT products; N = 40: the padded FFT)"""
    rng = np.random.RandomState(3)
    img = torch.as_tensor(rng.normal(size=(3,) + DIMS), dtype=dtype)
    cens = torch.as_tensor(rng.uniform(10, 14, size=(3, 2)), dtype=dtype)
    new = kops.centered_fft(img, cens, N)
    assert torch.equal(new, _old_batched_centered_fft(img, cens, N))
    assert torch.equal(kops.centered_ifft(new, cens, DIMS),
                       _old_batched_centered_ifft(new, cens, DIMS))


def test_kops_helpers_match_jax():
    """one stamp: centered_fft, centered_ifft and gauss_kprofile against
    the JAX package's at rtol 1e-10 with an atol of 1e-12 of the peak"""
    rng = np.random.RandomState(4)
    img = rng.normal(size=DIMS)
    cen = np.array([12.3, 11.8])
    N = kops.good_fft_size(4 * DIMS[0])
    jhat = np.asarray(jkops.centered_fft(jnp.asarray(img) + 0j, jnp.asarray(cen), N))
    that = kops.centered_fft(torch.as_tensor(img), torch.as_tensor(cen), N)
    np.testing.assert_allclose(that.numpy(), jhat, rtol=1e-10, atol=1e-12 * np.abs(jhat).max())
    jback = np.asarray(jkops.centered_ifft(jnp.asarray(jhat), jnp.asarray(cen), DIMS))
    tback = kops.centered_ifft(that, torch.as_tensor(cen), DIMS).numpy()
    np.testing.assert_allclose(tback, jback, rtol=1e-10, atol=1e-12 * np.abs(jback).max())
    np.testing.assert_allclose(tback, img, atol=1e-12)
    jac = jn.Jacobian(row=12, col=12, dvdrow=0.25, dvdcol=0.03, dudrow=-0.02, dudcol=0.27)
    tjac = convert.jacobian_from_object(jac)
    jprof = np.asarray(jkops.gauss_kprofile(N, jac, 0.7, flux=2.0))
    np.testing.assert_allclose(kops.gauss_kprofile(N, tjac, 0.7, flux=2.0).numpy(), jprof,
                               rtol=1e-10, atol=1e-14)


# ----------------------------------------------------------------------
# the metacal images of every psf mode

def _engine(module, name, obs, rng, psf=None):
    cls = getattr(module, name)
    if name == "MetacalDilatePSF":
        return cls(obs)
    if name == "MetacalAnalyticPSF":
        return cls(obs=obs, psf=psf, rng=rng)
    return cls(obs=obs, rng=rng)


MODES = {
    "gauss": ("MetacalGaussPSF", None),
    "azgauss": ("MetacalAzGaussPSF", None),
    "fitgauss": ("MetacalFitGaussPSF", None),
    "dilate": ("MetacalDilatePSF", None),
    "analytic_sigma": ("MetacalAnalyticPSF", 0.45),
    "analytic_gmix": ("MetacalAnalyticPSF", "gmix"),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_metacal_images_match_jax(mode):
    """every type of the engine's default list: the image and the psf
    image at rtol 1e-8 + atol 1e-10 of the peak, the weights, the psf
    noise drawn at construction and, for fitgauss, the guesses of its
    psf fit from one RandomState on both sides"""
    name, psf = MODES[mode]
    jobs, tobs = _pair(11, psf_model="turb" if mode == "fitgauss" else "gauss")
    jpsf, tpsf = psf, psf
    if psf == "gmix":
        jpsf = jn.GMixModel([0.0, 0.0, 0.0, 0.0, 0.4, 1.0], "gauss")
        tpsf = nt.GMixModel([0.0, 0.0, 0.0, 0.0, 0.4, 1.0], "gauss")
    from ngmix_tpu.metacal import metacal as jmetacal
    from ngmix_tpu_torch.metacal import metacal as tmetacal

    jeng = _engine(jmetacal, name, jobs, np.random.RandomState(5), jpsf)
    teng = _engine(tmetacal, name, tobs, np.random.RandomState(5), tpsf)
    jd, td = jeng.get_all(), teng.get_all()
    assert list(td) == list(jd) == list(jeng.types_default)
    _assert_dicts_close(td, jd, mode)
    if mode != "dilate":
        assert teng._target_sigma == pytest.approx(jeng._target_sigma, rel=1e-10)


def test_get_all_metacal_variants_match_jax():
    """get_all_metacal on one observation: without fixnoise, with it
    (image_orig and weight_orig kept, the weight halved), and with
    use_noise_image; the FutureWarning of the default psf"""
    jobs, tobs = _pair(21)
    noise = np.random.RandomState(8).normal(size=DIMS) * 0.01
    jobs.set_noise(noise)
    tobs.set_noise(noise)
    for kw in (dict(psf="gauss", fixnoise=False), dict(psf="azgauss"),
               dict(psf="gauss", use_noise_image=True),
               dict(psf="dilate", types=["noshear", "1p_psf"])):
        jd = jget_all(jobs, rng=np.random.RandomState(9), **kw)
        td = get_all_metacal(tobs, rng=np.random.RandomState(9), **kw)
        _assert_dicts_close(td, jd, str(kw))
        if kw.get("fixnoise", True):
            for key in td:
                np.testing.assert_array_equal(td[key].image_orig.shape, DIMS)
                np.testing.assert_allclose(td[key].weight, tobs.weight / 2.0, rtol=0.01)
                np.testing.assert_allclose(td[key].image_orig, jd[key].image_orig, rtol=1e-8,
                                           atol=1e-10 * np.abs(jd[key].image_orig).max())
    with pytest.warns(FutureWarning):
        td = get_all_metacal(tobs, rng=np.random.RandomState(9), fixnoise=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        jd = jget_all(jobs, rng=np.random.RandomState(9), fixnoise=False)
    _assert_dicts_close(td, jd, "default psf")


@pytest.mark.parametrize("kind", ["ObsList", "MultiBandObsList"])
def test_get_all_metacal_containers_match_jax(kind):
    """fixnoise over the containers: the noise fields of every epoch
    drawn in the reference's order, the rot90 field added back"""
    jl, tl = jn.ObsList(), nt.ObsList()
    for seed in (31, 32):
        jobs, tobs = _pair(seed)
        jl.append(jobs)
        tl.append(tobs)
    if kind == "MultiBandObsList":
        jm, tm = jn.MultiBandObsList(), nt.MultiBandObsList()
        jm.append(jl)
        tm.append(tl)
        jl, tl = jm, tm
    jd = jget_all(jl, psf="gauss", rng=np.random.RandomState(12))
    td = get_all_metacal(tl, psf="gauss", rng=np.random.RandomState(12))
    for key in jd:
        assert type(td[key]).__name__ == kind
    _assert_dicts_close(td, jd, kind)


def test_wcs_mismatch_and_shape_type_raise():
    bad = jn.Jacobian(row=12, col=12, dvdrow=SCALE * 1.1, dvdcol=0, dudrow=0, dudcol=SCALE)
    jobs = _jax_obs(9, jac_psf=bad)
    with pytest.raises(ValueError):
        jn.metacal.MetacalGaussPSF(obs=jobs, rng=np.random.RandomState(1))
    tobs = convert.observation_from_object(jobs, device="cpu")
    with pytest.raises(ValueError, match="same WCS"):
        MetacalGaussPSF(obs=tobs, rng=np.random.RandomState(1))
    _, tobs = _pair(10)
    m = MetacalGaussPSF(obs=tobs, rng=np.random.RandomState(1))
    with pytest.raises(TypeError):
        m.get_obs_galshear((0.01, 0.0))
    assert m.get_obs_galshear(nt.Shape(0.01, 0.0)).image.shape == DIMS
    with pytest.raises(ValueError, match="psf"):
        MetacalDilatePSF(nt.Observation(np.zeros(DIMS), device="cpu"))
    with pytest.raises(ValueError, match="GMix or a gaussian sigma"):
        MetacalAnalyticPSF(obs=tobs, psf=[0.4, 0.5])


def test_target_psfs_match_jax():
    """get_fitgauss_target_psf (admom with GMixPSFGuesser's draws) and
    get_azgauss_target_psf; the ellipticity dilation"""
    jobs, tobs = _pair(13, psf_model="turb")
    jgm = jfit.get_fitgauss_target_psf(jobs.psf, rng=np.random.RandomState(2))
    tgm = fitgauss_target_psf.get_fitgauss_target_psf(tobs.psf, rng=np.random.RandomState(2))
    np.testing.assert_allclose(tgm.get_data(), jgm.get_data(), rtol=1e-10)
    for e1, e2, T in ((0.0, 0.0, 0.3), (0.05, -0.02, 0.3), (0.4, 0.1, 1.0)):
        assert fitgauss_target_psf._get_ellip_dilation(e1, e2, T) == \
            jfit._get_ellip_dilation(e1, e2, T)
    N = kops.good_fft_size(4 * DIMS[0])
    pimg = np.asarray(jobs.psf.image)
    jhat = jkops.centered_fft(jnp.asarray(pimg) + 0j, jnp.asarray([12.0, 12.0]), N)
    ksq = np.asarray(jkops.sky_ksq(N, jobs.jacobian))
    jaz_gm = jaz.get_azgauss_target_psf(jhat, jnp.asarray(ksq), N, flux=2.0)
    taz_gm = azgauss_target_psf.get_azgauss_target_psf(
        kops.centered_fft(torch.tensor(pimg), torch.tensor([12.0, 12.0]), N),
        torch.as_tensor(ksq), N, flux=2.0)
    np.testing.assert_allclose(taz_gm.get_data(), jaz_gm.get_data(), rtol=1e-10)


# ----------------------------------------------------------------------
# simobs

def test_simulate_obs_and_noise_image_match_jax():
    """the noise bit for bit from one seed (the weight map's zero pixels
    take the median noise), the model through K2's plain version at
    rtol 1e-12, noise_factor, a MultiBandObsList with a mixture a band,
    and the errors"""
    jobs, tobs = _pair(41)
    gm = [0.1, -0.05, 0.05, 0.0, 1.0, 50.0]
    jobs.psf.set_gmix(jn.GMixModel([0.0, 0.0, 0.02, 0.01, 0.3, 1.0], "gauss"))
    tobs.psf.set_gmix(nt.GMixModel([0.0, 0.0, 0.02, 0.01, 0.3, 1.0], "gauss"))
    wt = np.full(DIMS, 25.0)
    wt[:5, :5] = 0.0
    np.testing.assert_array_equal(simobs.get_noise_image(wt, np.random.RandomState(3)),
                                  jsimobs.get_noise_image(wt, np.random.RandomState(3)))
    np.testing.assert_array_equal(
        simobs.get_noise_image(np.zeros(DIMS), np.random.RandomState(3), noise_factor=2.0),
        jsimobs.get_noise_image(np.zeros(DIMS), np.random.RandomState(3), noise_factor=2.0))
    for g, kw in ((None, {}), (gm, dict(noise_factor=1.5)), (gm, dict(add_noise=False))):
        jsim = jsimobs.simulate_obs(None if g is None else jn.GMixModel(g, "gauss"), jobs,
                                    rng=np.random.RandomState(4), **kw)
        tsim = simobs.simulate_obs(None if g is None else nt.GMixModel(g, "gauss"), tobs,
                                   rng=np.random.RandomState(4), **kw)
        assert tsim.device == tobs.device
        np.testing.assert_allclose(tsim.image, jsim.image, rtol=1e-12, atol=1e-14)
        np.testing.assert_array_equal(tsim.weight, jsim.weight)
        if g is None:
            np.testing.assert_array_equal(tsim.image, jsim.noise_image)
        assert (tsim.noise_image is None) == (jsim.noise_image is None)
    jm, tm = jn.MultiBandObsList(), nt.MultiBandObsList()
    for obs, mb, ol in ((jobs, jm, jn.ObsList()), (tobs, tm, nt.ObsList())):
        ol.append(obs)
        mb.append(ol)
        mb.append(ol)
    jsim = jsimobs.simulate_obs([jn.GMixModel(gm, "gauss")] * 2, jm, rng=np.random.RandomState(5))
    tsim = simobs.simulate_obs([nt.GMixModel(gm, "gauss")] * 2, tm, rng=np.random.RandomState(5))
    for t, j in zip(_leaves(tsim), _leaves(jsim)):
        np.testing.assert_allclose(t.image, j.image, rtol=1e-12, atol=1e-14)
    with pytest.raises(ValueError, match="one per band"):
        simobs.simulate_obs(nt.GMixModel(gm, "gauss"), tm, rng=np.random.RandomState(5))
    with pytest.raises(ValueError, match="needs an rng"):
        simobs.get_noise_image(wt, None)
    tobs.psf.set_gmix(None)
    with pytest.raises(RuntimeError, match="no fitted mixture"):
        simobs.simulate_obs(nt.GMixModel(gm, "gauss"), tobs, rng=np.random.RandomState(5))


def test_image_of_negative_strides():
    """ROADMAP fault 3.7: np.rot90 (and flips) give arrays of negative
    strides, which the device pixels must copy, not reject"""
    im = np.arange(35.0).reshape(5, 7)
    obs = nt.Observation(np.zeros((7, 5)), device="cpu")
    obs.set_image(np.rot90(im))
    np.testing.assert_array_equal(obs.pixels.val.numpy(), np.rot90(im).reshape(-1))
    obs.set_weight(np.rot90(im)[::-1] + 1.0)
    np.testing.assert_allclose(obs.pixels.ierr.numpy(),
                               np.sqrt(np.rot90(im)[::-1] + 1.0).reshape(-1), rtol=1e-15)


# ----------------------------------------------------------------------
# the k-space template fluxes

def test_kspace_psf_flux_fitter_matches_jax():
    """KSpacePSFFluxFitter: the psf flux and the analytic templates
    (ifft(model_khat psfhat) through the k-space helpers above), flux,
    flux_err and chi2per at rtol 1e-10"""
    jobs, tobs = _pair(31, noise=1e-3)
    for spec in (None, {"model": "exp", "r50": 0.5, "g1": 0.1},
                 {"model": "spergel", "r50": 0.5, "nu": 0.5},
                 {"model": "moffat", "fwhm": 1.0, "beta": 3.5}):
        jres = jk.KSpacePSFFluxFitter(model=spec).go(jobs)
        tres = tk.KSpacePSFFluxFitter(model=spec).go(tobs)
        assert tres["flags"] == jres["flags"] == 0
        for k in ("flux", "flux_err", "chi2per"):
            np.testing.assert_allclose(tres[k], jres[k], rtol=1e-10, err_msg="%s %s" % (spec, k))
    with pytest.raises(ValueError):
        tk.KSpacePSFFluxFitter(model="exp")
    with pytest.raises(nt.GMixRangeError):
        tk.KSpacePSFFluxFitter(model={"model": "exp", "r50": 0.5, "g1": 1.2}).go(tobs)
    assert tk.GalsimPSFFluxFitter is tk.KSpacePSFFluxFitter
    assert nt.fitting.GalsimFitter is nt.KSpaceFitter
