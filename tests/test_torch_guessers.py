"""The port's guessers, srandu and the priors' host methods against
ngmix_tpu's from one seed on both sides: the numpy guesses equal bit
for bit; those that read a measurement of the stamp (the psf-flux
fluxes through PSFFluxFitter's K2 renders, guess_from_moms's weighted
moments) to rtol 1e-12. The priors go through
convert.prior_from_object, which copies each generator's state and
keeps generators that the JAX prior's components share shared; their
sample / sample1d / sample2d draws equal, get_lnprob_scalar equal (or
raising GMixRangeError alike), a joint prior's
get_lnprob_scalar_device to rtol 1e-12 of the JAX package's. Two fits
from guessers end the file, held to the JAX Fitter at the LM
tolerances (rtol 1e-5, nfev within 2): a bdf Fitter with the
production PriorBDFSep from a BDFGuesser's guess (the K3 route with
prior rows), and PSFRunner with Fitter("gauss") and
SimplePSFGuesser(guess_from_moms=True) on the psf stamps (a fit
without a psf mixture: K3 with a psf of zero covariance). The stamps
are tests/_sims.get_model_obs at 25x25.
"""
import numpy as np
import pytest
import torch

import ngmix_tpu as jn
from ngmix_tpu import guessers as jg, priors as jpriors
from ngmix_tpu.gexceptions import GMixRangeError as JGMixRangeError

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import convert, guessers as tg
from ngmix_tpu_torch.gexceptions import GMixRangeError

from _priors import get_prior
from _sims import get_model_obs
from test_torch_fitters import assert_fit_equal

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

DIMS = (25, 25)


@pytest.fixture(scope="module")
def obs():
    """(JAX observation with its psf mixture, the port's)"""
    data = get_model_obs(rng=np.random.RandomState(11), model="gauss", T=1.0, g1=0.05,
                         g2=-0.02, flux=120.0, noise=0.05, dims=DIMS)
    jobs = data["obs"]
    jobs.psf.set_gmix(data["psf_gmix"])
    return jobs, convert.observation_from_object(jobs, device="cpu")


def _equal(a, b, rtol=0.0):
    if isinstance(b, jn.GMix):
        a, b = a.get_data(), b.get_data()
    if rtol:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=0)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _bd_prior(pkg, rng):
    P = pkg.priors
    return pkg.joint_prior.PriorBDSep(
        cen_prior=P.CenPrior(0.0, 0.0, 0.263, 0.263, rng=rng),
        g_prior=P.GPriorBA(sigma=0.1, rng=rng),
        T_prior=P.TwoSidedErf(-1.0, 0.1, 1.0e3, 1.0, rng=rng),
        logTratio_prior=P.Normal(0.0, 0.3, rng=rng),
        fracdev_prior=P.LogNormal(0.5, 0.1, rng=rng),
        F_prior=P.TwoSidedErf(-100.0, 0.1, 1.0e9, 1.0, rng=rng))


def _strict_T_prior(pkg, rng):
    """a PriorSimpleSep whose T prior rejects T near 0.8 (raising), so
    the guessers' fix-up resamples from it"""
    P = pkg.priors
    return pkg.joint_prior.PriorSimpleSep(
        cen_prior=P.CenPrior(0.0, 0.0, 0.263, 0.263, rng=rng),
        g_prior=P.GPriorBA(sigma=0.2, rng=rng),
        T_prior=P.TruncatedGaussian(5.0, 1.0, 3.0, 7.0, rng=rng),
        F_prior=P.LogNormal(100.0, 30.0, rng=rng))


def _priors_pair(kind, seed):
    """(JAX joint prior, the port's conversion of it): one shared
    generator on the JAX side, so one on the port's"""
    rng = np.random.RandomState(seed)
    if kind == "bd":
        jp = _bd_prior(jn, rng)
    elif kind == "strict":
        jp = _strict_T_prior(jn, rng)
    else:
        jp = get_prior(fit_model=kind, rng=rng, nband=2 if kind == "exp2" else None)
    return jp, convert.prior_from_object(jp)


# each case: name -> (run(jobs, tobs), which gives the JAX guesses and
# the port's from the same seed, and the rtol, 0 for equal)
def _tflux(nband, nrand, prior):
    def run(jobs, tobs):
        flux = 100.0 if nband == 1 else [100.0, 130.0]
        jp, tp = _priors_pair(prior, 6) if prior else (None, None)
        jrng = jp.cen_prior.rng if prior else np.random.RandomState(5)
        trng = tp.cen_prior.rng if prior else np.random.RandomState(5)
        return (jg.TFluxGuesser(rng=jrng, T=0.8, flux=flux, prior=jp)(nrand=nrand),
                tg.TFluxGuesser(rng=trng, T=0.8, flux=flux, prior=tp)(nrand=nrand))
    return run


def _with_prior(jcls, tcls, kind, **kw):
    def run(jobs, tobs, nrand=4):
        jp, tp = _priors_pair(kind, 8)
        args = dict(kw)
        if "rng" in args:
            jargs, targs = dict(args, rng=jp.cen_prior.rng), dict(args, rng=tp.cen_prior.rng)
        else:
            jargs, targs = args, args
        jgs, tgs = jcls(prior=jp, **jargs), tcls(prior=tp, **targs)
        if "flux" in kw:
            return jgs(nrand=nrand), tgs(nrand=nrand)
        return jgs(obs=jobs, nrand=nrand), tgs(obs=tobs, nrand=nrand)
    return run


def _plain(jmake, tmake, call):
    def run(jobs, tobs):
        return call(jmake(np.random.RandomState(13)), jobs), call(tmake(np.random.RandomState(13)),
                                                                  tobs)
    return run


CASES = {
    "tflux_1band": (_tflux(1, 1, None), 0),
    "tflux_2band_3": (_tflux(2, 3, None), 0),
    "tflux_prior": (_tflux(1, 10, "exp"), 0),
    "tflux_prior_fixup": (_tflux(1, 6, "strict"), 0),
    "tpsfflux": (_plain(lambda r: jg.TPSFFluxGuesser(rng=r, T=0.8),
                        lambda r: tg.TPSFFluxGuesser(rng=r, T=0.8),
                        lambda g, o: g(obs=o, nrand=3)), 1e-12),
    "tpsfflux_and_prior": (_with_prior(jg.TPSFFluxAndPriorGuesser, tg.TPSFFluxAndPriorGuesser,
                                       "exp", rng=None, T=0.8), 1e-12),
    "tflux_and_prior": (_with_prior(jg.TFluxAndPriorGuesser, tg.TFluxAndPriorGuesser, "exp",
                                    rng=None, T=0.9, flux=80.0), 0),
    "bdf": (_with_prior(jg.BDFGuesser, tg.BDFGuesser, "bdf", T=0.8, flux=100.0), 0),
    "bdf_psfflux": (_with_prior(jg.BDFPSFFluxGuesser, tg.BDFPSFFluxGuesser, "bdf", T=0.8),
                    1e-12),
    "bd": (_with_prior(jg.BDGuesser, tg.BDGuesser, "bd", T=0.8, flux=[100.0]), 0),
    "pars": (_plain(lambda r: jg.ParsGuesser(rng=r, pars=[0.0, 0.0, 0.1, -0.1, 2.0, 50.0]),
                    lambda r: tg.ParsGuesser(rng=r, pars=[0.0, 0.0, 0.1, -0.1, 2.0, 50.0]),
                    lambda g, o: (g(), g(nrand=7))), 0),
    "shape_guess": (lambda jobs, tobs: tuple(
        m.get_shape_guess(rng=np.random.RandomState(12), g1=0.95, g2=0.4, nrand=20,
                          width=[0.01, 0.01], max=0.8) for m in (jg, tg)), 0),
    "r50_flux": (_plain(lambda r: jg.R50FluxGuesser(rng=r, r50=1.5, flux=[100.0, 20.0]),
                        lambda r: tg.R50FluxGuesser(rng=r, r50=1.5, flux=[100.0, 20.0]),
                        lambda g, o: g(nrand=4)), 0),
    "r50_nu_flux": (_plain(lambda r: jg.R50NuFluxGuesser(rng=r, r50=1.5, nu=1.0, flux=100.0),
                           lambda r: tg.R50NuFluxGuesser(rng=r, r50=1.5, nu=1.0, flux=100.0),
                           lambda g, o: g(nrand=4)), 0),
    "prior_sample": (lambda jobs, tobs: tuple(
        cls(prior=p)(nrand=9) for cls, p in zip((jg.PriorGuesser, tg.PriorGuesser),
                                                  _priors_pair("exp2", 14))), 0),
    "simple_psf": (_plain(lambda r: jg.SimplePSFGuesser(rng=r),
                          lambda r: tg.SimplePSFGuesser(rng=r), lambda g, o: g(obs=o.psf)), 0),
    "simple_psf_moms": (_plain(lambda r: jg.SimplePSFGuesser(rng=r, guess_from_moms=True),
                               lambda r: tg.SimplePSFGuesser(rng=r, guess_from_moms=True),
                               lambda g, o: g(obs=o.psf)), 1e-12),
}
for _n in (1, 2, 3, 4, 5):
    for _moms in (False, True):
        CASES["gmix_psf_%d%s" % (_n, "_moms" if _moms else "")] = (_plain(
            lambda r, n=_n, m=_moms: jg.GMixPSFGuesser(rng=r, ngauss=n, guess_from_moms=m),
            lambda r, n=_n, m=_moms: tg.GMixPSFGuesser(rng=r, ngauss=n, guess_from_moms=m),
            lambda g, o: g(obs=o.psf)), 1e-12 if _moms else 0)
    CASES["coellip_psf_%d" % _n] = (_plain(
        lambda r, n=_n: jg.CoellipPSFGuesser(rng=r, ngauss=n, guess_from_moms=True),
        lambda r, n=_n: tg.CoellipPSFGuesser(rng=r, ngauss=n, guess_from_moms=True),
        lambda g, o: g(obs=o.psf)), 1e-12)


@pytest.mark.parametrize("name", sorted(CASES))
def test_guesser_matches_jax(obs, name):
    run, rtol = CASES[name]
    jout, tout = run(*obs)
    if isinstance(jout, tuple):
        for a, b in zip(tout, jout):
            _equal(a, b, rtol)
    else:
        assert type(tout).__name__ == type(jout).__name__
        _equal(tout, jout, rtol)


def test_guesser_errors():
    with pytest.raises(GMixRangeError):
        tg.R50FluxGuesser(rng=np.random.RandomState(1), r50=-1.0, flux=100.0)
    with pytest.raises(ValueError):
        tg.GMixPSFGuesser(rng=np.random.RandomState(1), ngauss=6)
    g = tg.R50NuFluxGuesser(rng=np.random.RandomState(1), r50=1.5, nu=99.0, flux=100.0)
    assert g.nu == g.NUMAX


def test_srandu_and_make_rng():
    _equal(nt.srandu(7, rng=np.random.RandomState(4)), jn.srandu(7, rng=np.random.RandomState(4)))
    _equal(nt.srandu(rng=3), jn.srandu(rng=3))
    rng = np.random.RandomState(2)
    assert nt.priors.make_rng(rng) is rng
    _equal(nt.priors.make_rng(9).uniform(size=3), jpriors.make_rng(9).uniform(size=3))


# ----------------------------------------------------------------------
# the priors' host methods

ONE_D = {
    "FlatPrior": lambda P, r: P.FlatPrior(-2.0, 3.0, rng=r),
    "TwoSidedErf": lambda P, r: P.TwoSidedErf(-1.0, 0.1, 10.0, 1.0, rng=r),
    "Normal": lambda P, r: P.Normal(1.0, 0.5, rng=r),
    "LogNormal": lambda P, r: P.LogNormal(2.0, 0.7, rng=r),
    "LogNormal_shift": lambda P, r: P.LogNormal(2.0, 0.7, rng=r, shift=-0.5),
    "Sinh": lambda P, r: P.Sinh(1.0, 2.0, rng=r),
    "TruncatedGaussian": lambda P, r: P.TruncatedGaussian(0.5, 1.0, 0.0, 1.2, rng=r),
}


@pytest.mark.parametrize("name", sorted(ONE_D))
def test_one_d_prior_host_methods(name):
    jp = ONE_D[name](jpriors, np.random.RandomState(17))
    tp = convert.prior_from_object(jp)
    _equal(tp.sample(), jp.sample())
    _equal(tp.sample(50), jp.sample(50))
    for x in (-3.0, -0.2, 0.3, 1.1, 2.5, 20.0):
        try:
            ref = jp.get_lnprob_scalar(x)
        except JGMixRangeError:
            with pytest.raises(GMixRangeError):
                tp.get_lnprob_scalar(x)
            continue
        np.testing.assert_array_equal(tp.get_lnprob_scalar(x), ref)


@pytest.mark.parametrize("name", ["GPriorBA", "GPriorGauss", "ZDisk2D", "CenPrior"])
def test_two_d_prior_host_methods(name):
    rng = np.random.RandomState(19)
    jp = {"GPriorBA": lambda: jpriors.GPriorBA(0.3, rng=rng),
          "GPriorGauss": lambda: jpriors.GPriorGauss(0.2, rng=rng),
          "ZDisk2D": lambda: jpriors.ZDisk2D(0.8, rng=rng),
          "CenPrior": lambda: jpriors.CenPrior(0.1, -0.2, 0.3, 0.5, rng=rng)}[name]()
    tp = convert.prior_from_object(jp)
    if name == "CenPrior":
        _equal(tp.sample(20), jp.sample(20))
        _equal(tp.get_lnprob_scalar(0.3, 0.1), jp.get_lnprob_scalar(0.3, 0.1))
        return
    _equal(tp.sample2d(), jp.sample2d())
    _equal(tp.sample2d(30), jp.sample2d(30))
    if name != "GPriorGauss":
        _equal(tp.sample1d(30), jp.sample1d(30))
        for g1, g2 in ((0.1, -0.2), (0.6, 0.5), (0.9, 0.5)):
            try:
                ref = jp.get_lnprob_scalar2d(g1, g2)
            except JGMixRangeError:
                with pytest.raises(GMixRangeError):
                    tp.get_lnprob_scalar2d(g1, g2)
                continue
            np.testing.assert_array_equal(tp.get_lnprob_scalar2d(g1, g2), ref)


@pytest.mark.parametrize("kind", ["exp", "exp2", "bdf", "bd"])
def test_joint_prior_host_methods_share_generators(kind):
    jp, tp = _priors_pair(kind, 23)
    # one generator on the JAX side, one copy of it on the port's
    comps = [tp.cen_prior, tp.g_prior, tp.T_prior] + [p for p, _ in tp._one_dim()]
    assert len({id(p.rng) for p in comps}) == 1
    assert tp.cen_prior.rng is not jp.cen_prior.rng
    _equal(tp.sample(), jp.sample())
    samples = jp.sample(6)
    _equal(tp.sample(6), samples)
    for s in samples:
        np.testing.assert_array_equal(tp.get_lnprob_scalar(s), jp.get_lnprob_scalar(s))
    np.testing.assert_allclose(
        tp.get_lnprob_scalar_device(torch.as_tensor(samples)).numpy(),
        np.array([float(jp.get_lnprob_scalar_device(s)) for s in samples]), rtol=1e-12)


def test_bdf_fit_with_prior_from_its_guesser_takes_k3():
    rng = np.random.RandomState(5)
    data = get_model_obs(rng=rng, model="exp", T=1.2, g1=0.1, g2=-0.05, flux=100.0,
                         noise=0.1, dims=DIMS)
    jobs = data["obs"]
    jobs.psf.set_gmix(data["psf_gmix"])
    jp, tp = _priors_pair("bdf", 3)
    jguess = jg.BDFGuesser(T=1.1, flux=95.0, prior=jp)()
    tguess = tg.BDFGuesser(T=1.1, flux=95.0, prior=tp)()
    _equal(tguess, jguess)
    jres = jn.Fitter("bdf", prior=jp).go(jobs, jguess)
    tres = nt.Fitter("bdf", prior=tp).go(convert.observation_from_object(jobs, device="cpu"),
                                         tguess)
    assert tres.route == "K3"
    assert tres["flags"] == 0
    assert_fit_equal(tres, jres)
    np.testing.assert_allclose(tres["lnprob"], jres["lnprob"], rtol=1e-5)


def test_psf_runner_gauss_without_psf_takes_k3():
    rng = np.random.RandomState(32)
    jobs = get_model_obs(rng=rng, model="gauss", T=1.2, g1=0.1, g2=-0.05, flux=100.0,
                         noise=0.05, dims=DIMS)["obs"]
    tobs = convert.observation_from_object(jobs, device="cpu")
    jres = jn.PSFRunner(fitter=jn.Fitter("gauss"), ntry=3, guesser=jg.SimplePSFGuesser(
        rng=np.random.RandomState(7), guess_from_moms=True)).go(jobs)
    tres = nt.PSFRunner(fitter=nt.Fitter("gauss"), ntry=3, guesser=tg.SimplePSFGuesser(
        rng=np.random.RandomState(7), guess_from_moms=True)).go(tobs)
    assert tres.route == "K3" and not tobs.psf.has_psf()
    assert tres["flags"] == 0
    assert_fit_equal(tres, jres)
    # the fit lands on the psf observation
    assert tobs.psf.meta["result"] is tres
    np.testing.assert_allclose(tobs.psf.gmix.get_data(), jobs.psf.gmix.get_data(), rtol=1e-5,
                               atol=1e-12)
