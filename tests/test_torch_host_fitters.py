"""The single-object fitters of the PyTorch port against ngmix_tpu's on
the same observations: AdmomFitter / run_admom / find_cen_admom,
GaussMom over an Observation, ObsList and MultiBandObsList, the
pre-psf PrePSFMom classes, and EMFitter in every mode, with their
result objects. The observations are made once from a seed in numpy,
built in the JAX package and carried over by
convert.observation_from_object with device="cpu" (K2's plain version).

Tolerances, from the reference's own tests: admom and EM fields rtol
1e-8 and atol 1e-10 with flags and numiter equal
(tests/test_torch_admom.py, tests/test_torch_em.py), gaussmom rtol
1e-10 and atol 1e-12, pre-psf rtol 1e-10 and atol 1e-13
(tests/test_prepsfmom.py:226); renders of fitted mixtures at the
fields' rtol.
"""
import numpy as np
import pytest
import torch

import ngmix_tpu as jn

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import convert, flags
from ngmix_tpu_torch.ops import gmix_eval

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

SCALE = 0.263
DIMS = (25, 25)
PSF_DIMS = (17, 17)
PSF_PARS = [0.0, 0.0, 0.0, 0.0, 0.3, 1.0]


def _obs_pair(seed, gal_pars=(0.05, -0.03, 0.2, -0.1, 0.8, 100.0), noise=0.01, zero_wt=False):
    """the same noisy exp galaxy, convolved with a gaussian psf, as a
    JAX package Observation (with its psf observation and mixture) and
    as the port's"""
    rng = np.random.RandomState(seed)
    tjac = nt.DiagonalJacobian(row=12.2, col=11.9, scale=SCALE)
    psf = nt.GMixModel(PSF_PARS, "gauss")
    im = nt.GMixModel(list(gal_pars), "exp").convolve(psf).make_image(
        DIMS, jacobian=tjac, fast_exp=True, device="cpu")
    im = im + rng.normal(0, noise, DIMS)
    wt = np.full(DIMS, 1.0 / noise**2)
    if zero_wt:
        wt[2:4, 3:7] = 0.0
    psf_jac = jn.DiagonalJacobian(row=8, col=8, scale=SCALE)
    psf_im = psf.make_image(PSF_DIMS, jacobian=nt.DiagonalJacobian(row=8, col=8, scale=SCALE),
                            device="cpu") + rng.normal(0, 1e-6, PSF_DIMS)
    jpsf = jn.Observation(psf_im, weight=np.full(PSF_DIMS, 1e12), jacobian=psf_jac,
                          gmix=jn.GMixModel(PSF_PARS, "gauss"))
    jobs = jn.Observation(im, weight=wt, noise=rng.normal(0, noise, DIMS),
                          jacobian=jn.DiagonalJacobian(row=12.2, col=11.9, scale=SCALE),
                          psf=jpsf)
    return jobs, convert.observation_from_object(jobs, device="cpu")


@pytest.fixture(scope="module")
def obs():
    return _obs_pair(11)


def _close(got, ref, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol,
                               equal_nan=True)


def assert_result_equal(tres, jres, rtol, atol, exact=("flags", "numiter")):
    assert set(tres) == set(jres), set(tres) ^ set(jres)
    for k, ref in jres.items():
        got = tres[k]
        if isinstance(ref, str) or k in exact or k.endswith("flags"):
            assert np.array_equal(got, ref), (k, got, ref)
        else:
            assert np.shape(got) == np.shape(ref), k
            _close(got, ref, rtol, atol)


# ----------------------------------------------------------------------
# admom

ADMOM_CASES = {
    "T guess": (dict(), 1.0),
    "gmix guess": (dict(), [0.02, -0.01, 0.0, 0.0, 0.9, 1.0]),
    "maxiter": (dict(maxiter=2), 1.0),
    "shiftmax": (dict(shiftmax=0.1), [0.6, 0.0, 0.0, 0.0, 0.9, 1.0]),
    "cenonly": (dict(cenonly=True), 1.0),
}


@pytest.mark.parametrize("case", ADMOM_CASES)
def test_admom_matches_jax(obs, case):
    kw, guess = ADMOM_CASES[case]
    jobs, tobs = obs
    res = []
    for pkg, o in ((jn, jobs), (nt, tobs)):
        g = pkg.GMixModel(guess, "gauss") if isinstance(guess, list) else guess
        res.append(pkg.run_admom(o, g, rng=np.random.RandomState(7), **kw))
    jres, tres = res
    assert isinstance(tres, nt.admom.AdmomResult)
    assert_result_equal(tres, jres, 1e-8, 1e-10)
    expect = {"maxiter": flags.MAXITER, "shiftmax": flags.CEN_SHIFT}.get(case, 0)
    assert tres["flags"] == expect, tres["flagstr"]
    if expect:
        with pytest.raises(RuntimeError):
            tres.get_gmix()
        return
    _close(tres.get_gmix().get_data(), jres.get_gmix().get_data(), 1e-8, 1e-10)
    _close(tres.make_image(), jres.make_image(), 1e-8, 1e-10)


def test_admom_weight_goes_through_k2(obs, monkeypatch):
    calls = []

    def counted(*a, **kw):
        calls.append(kw.get("fast"))
        return gmix_eval.eval_gmix_plain(*a, **kw)

    monkeypatch.setattr(gmix_eval, "eval_gmix", counted)
    res = nt.admom.AdmomFitter(rng=np.random.RandomState(7)).go(obs[1], 1.0)
    # two launches an iteration (the centroid and the moments), one for
    # the covariance, all apodized (fast)
    assert res["flags"] == 0 and calls == [True] * (2 * res["numiter"] + 1)
    with pytest.raises(ValueError):
        nt.admom.AdmomFitter().go(obs[0], 1.0)


def test_find_cen_admom_matches_jax(obs):
    jobs, tobs = obs
    jres = jn.admom.find_cen_admom(jobs, fwhm=1.2, ntry=2, rng=np.random.RandomState(3))
    tres = nt.find_cen_admom(tobs, fwhm=1.2, ntry=2, rng=np.random.RandomState(3))
    assert tres["flags"] == jres["flags"] == 0 and tres["numiter"] == jres["numiter"]
    _close(tres["cen"], jres["cen"], 1e-8, 1e-10)
    # every try fails on an empty stamp: each retry draws a new center
    # from rng, and the center is NaN
    empty = nt.Observation(np.zeros(DIMS), jacobian=tobs.jacobian, device="cpu")
    rngs = [np.random.RandomState(5), np.random.RandomState(5)]
    gm = nt.GMixModel([0.0, 0.0, 0.0, 0.0, 0.5, 1.0], "gauss")
    tfail = nt.find_cen_admom(empty, gmix=gm, ntry=3, rng=rngs[0])
    jfail = jn.admom.find_cen_admom(
        jn.Observation(np.zeros(DIMS), jacobian=jobs.jacobian),
        gmix=jn.GMixModel([0.0, 0.0, 0.0, 0.0, 0.5, 1.0], "gauss"), ntry=3, rng=rngs[1])
    assert tfail["flags"] == jfail["flags"] == flags.NONPOS_FLUX
    assert np.all(np.isnan(tfail["cen"])) and np.isnan(jfail["cen"]).all()
    assert gm.get_cen() == (0.0, 0.0)  # the caller's mixture is not moved
    assert rngs[0].uniform() == rngs[1].uniform()  # two draws a retry in both
    with pytest.raises(ValueError):
        nt.find_cen_admom(tobs, fwhm=1.2, ntry=2)
    with pytest.raises(ValueError):
        nt.find_cen_admom(tobs)


# ----------------------------------------------------------------------
# gaussian weighted moments

def _lists(pkg, o1, o2):
    ol = pkg.ObsList()
    ol.append(o1)
    ol.append(o2)
    mb = pkg.MultiBandObsList()
    mb.append(ol)
    return {"obs": o1, "obslist": ol, "mbobs": mb}


@pytest.fixture(scope="module")
def obs_lists(obs):
    other = _obs_pair(12, noise=0.02)
    return [_lists(pkg, a, b) for pkg, a, b in ((jn, obs[0], other[0]), (nt, obs[1], other[1]))]


@pytest.mark.parametrize("higher", [False, True], ids=["6", "17"])
@pytest.mark.parametrize("kind", ["obs", "obslist", "mbobs"])
def test_gaussmom_matches_jax(obs_lists, kind, higher):
    jo, to = (x[kind] for x in obs_lists)
    jres = jn.GaussMom(1.2, with_higher_order=higher).go(jo)
    tres = nt.GaussMom(1.2, with_higher_order=higher).go(to)
    assert nt.GaussMom.kind == "wmom" and tres["flags"] == 0
    assert tres["sums"].shape == (17 if higher else 6,)
    assert_result_equal(tres, jres, 1e-10, 1e-12)
    if kind != "obs":
        # the coadd: the sums of its observations
        one = nt.GaussMom(1.2, with_higher_order=higher).go(obs_lists[1]["obs"])
        assert tres["npix"] == 2 * one["npix"]
    with pytest.raises(ValueError):
        nt.GaussMom(1.2).go([to])


# ----------------------------------------------------------------------
# pre-psf moments

PREPSF_CASES = {
    "ksigma": ("KSigmaMom", dict(fwhm=1.2), dict()),
    "pgauss": ("PGaussMom", dict(fwhm=1.2), dict()),
    "no psf": ("PGaussMom", dict(fwhm=1.2), dict(no_psf=True)),
    "noise image": ("KSigmaMom", dict(fwhm=1.2, use_noise_image=True), dict()),
    "smooth": ("PGaussMom", dict(fwhm=1.2, fwhm_smooth=0.8, pad_factor=3), dict()),
}


@pytest.mark.parametrize("case", PREPSF_CASES)
def test_prepsfmom_matches_jax(obs, case):
    cls, kw, go_kw = PREPSF_CASES[case]
    jres = getattr(jn, cls)(**kw).go(obs[0], **go_kw)
    tres = getattr(nt, cls)(**kw).go(obs[1], return_kernels=True, **go_kw)
    assert tres["flags"] == 0, tres["flagstr"]
    assert_result_equal(tres, jres, 1e-10, 1e-13)


def test_prepsfmom_checks(obs):
    _, tobs = obs
    assert nt.prepsfmom.PrePSFGaussMom is nt.PGaussMom
    assert nt.ksigmamom.KSigmaMom is nt.KSigmaMom
    assert nt.KSigmaMom(1.0).kind == "ksigma" and nt.PGaussMom(1.0).kind == "pgauss"
    for toggle in ("fft", "kernel"):
        for state in ("on", "off"):
            getattr(nt.prepsfmom, "turn_%s_%s_caching" % (state, toggle))()
    # a kernel whose support does not fit the padded grid
    with pytest.raises(nt.FFTRangeError):
        nt.KSigmaMom(fwhm=0.05).go(tobs)
    with pytest.raises(ValueError):
        nt.prepsfmom.PrePSFMom(1.0, "bad")
    with pytest.raises(ValueError):
        nt.PGaussMom(1.2).go(nt.Observation(np.zeros((24, 25)), device="cpu"), no_psf=True)
    with pytest.raises(RuntimeError):
        nt.PGaussMom(1.2).go(nt.Observation(np.zeros(DIMS), device="cpu"))
    with pytest.raises(ValueError):
        nt.PGaussMom(1.2).go(tobs.image)
    other = tobs.copy()
    other.set_psf(nt.Observation(tobs.psf.image, device="cpu"))  # unit WCS
    with pytest.raises(RuntimeError):
        nt.PGaussMom(1.2).go(other)
    plain = tobs.copy()
    plain.set_noise(None)
    with pytest.raises(ValueError):
        nt.KSigmaMom(1.2, use_noise_image=True).go(plain)


# ----------------------------------------------------------------------
# EM

EM_MODES = {"free": dict(), "fixcen": dict(fixcen=True), "fixcov": dict(fixcov=True),
            "fluxonly": dict(fluxonly=True)}


def _em_pair(jobs, tobs, guess, **kw):
    jres = jn.run_em(jobs, jn.GMixModel(guess, "gauss"), **kw)
    tres = nt.run_em(tobs, nt.GMixModel(guess, "gauss"), **kw)
    return jres, tres


def assert_em_equal(tres, jres):
    assert_result_equal(tres, jres, 1e-8, 1e-10)
    assert tres.has_gmix() == jres.has_gmix()
    if jres.has_gmix():
        _close(tres.get_gmix().get_data(), jres.get_gmix().get_data(), 1e-8, 1e-10)
        _close(tres.get_convolved_gmix().get_data(), jres.get_convolved_gmix().get_data(),
               1e-8, 1e-10)
        _close(tres.make_image(), jres.make_image(), 1e-8, 1e-10)


@pytest.mark.parametrize("mode", EM_MODES)
def test_em_modes_match_jax(obs, mode):
    jres, tres = _em_pair(*obs, [0.02, -0.01, 0.05, 0.0, 0.5, 1.0], **EM_MODES[mode])
    assert isinstance(tres, nt.em.EMResult) and tres["flags"] == 0, tres["message"]
    assert_em_equal(tres, jres)


@pytest.mark.parametrize("case", ["sky given", "zero weight", "maxiter", "range error"])
def test_em_cases_match_jax(obs, case):
    jobs, tobs = obs
    guess, kw = [0.0, 0.0, 0.0, 0.0, 0.5, 1.0], {}
    if case == "sky given":
        (jobs, jsky), (tobs, tsky) = jn.em.prep_obs(jobs), nt.em.prep_obs(tobs)
        assert np.array_equal(tobs.image, jobs.image) and tsky == jsky
        kw = dict(sky=tsky, vary_sky=True)
    elif case == "zero weight":
        jobs, tobs = _obs_pair(13, zero_wt=True)
    elif case == "maxiter":
        kw = dict(maxiter=3)
    else:
        # an empty stamp: the model and the sky are 0 on the stamp's
        # corners, gtot == 0
        jobs, tobs = (pkg.Observation(np.zeros(DIMS), jacobian=o.jacobian, **dev)
                      for pkg, o, dev in ((jn, jobs, {}), (nt, tobs, dict(device="cpu"))))
        guess = [0.0, 0.0, 0.0, 0.0, 0.1, 1.0]
    jres, tres = _em_pair(jobs, tobs, guess, **kw)
    expect = {"maxiter": flags.EM_MAXITER, "range error": flags.EM_RANGE_ERROR}.get(case, 0)
    assert tres["flags"] == expect
    assert_em_equal(tres, jres)
    if case == "range error":
        with pytest.raises(RuntimeError):
            tres.get_gmix()
    with pytest.raises(ValueError):
        nt.em.EMFitter().go(jobs, nt.GMixModel(guess, "gauss"))
