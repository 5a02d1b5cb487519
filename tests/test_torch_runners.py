"""The port's runners and the run_lm route of its Fitter against
ngmix_tpu's: PSFRunner with CoellipFitter(3) (run_lm), Runner with
Fitter("exp") under a turb psf of three gaussians (run_lm), each with
ntry retries and the same guesser from one seed on both sides; and the
retry loop itself (PSFRunner with Fitter("gauss") on psf stamps, the
K3 route without a psf, is in tests/test_torch_guessers.py). The
stamps are tests/_sims.get_model_obs at 25x25 (the coellip psf a
25x25 render of three coelliptical gaussians), carried across by
convert.observation_from_object(device="cpu"). Flags equal; pars,
pars_err and the fields of the result to rtol 1e-5 (+ atol 1e-12);
nfev within 2; each test asserts the route.
"""
import numpy as np
import torch

import ngmix_tpu as jn
from ngmix_tpu import guessers as jguessers

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import convert, guessers

from _sims import get_model_obs
from test_torch_fitters import DIMS, assert_fit_equal

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

# a three-gaussian coelliptical psf whose components are all resolved
# (a turb psf's third gaussian carries 1e-7 of the flux, which leaves a
# coellip fit's covariance numerically singular in both packages)
COELLIP_PSF = [0.0, 0.0, 0.03, -0.02, 0.15, 0.45, 1.3, 0.5, 0.35, 0.15]


def test_psf_runner_coellip_takes_run_lm():
    rng = np.random.RandomState(31)
    jac = jn.DiagonalJacobian(row=12.0, col=12.0, scale=0.263)
    im = jn.GMixCoellip(COELLIP_PSF).make_image(DIMS, jacobian=jac, fast_exp=True)
    psf = jn.Observation(im + rng.normal(size=DIMS) * 1e-5, weight=np.full(DIMS, 1e10),
                         jacobian=jac)
    jobs = jn.Observation(np.zeros(DIMS), weight=np.ones(DIMS), jacobian=jac, psf=psf)
    tobs = convert.observation_from_object(jobs, device="cpu")
    jres = jn.PSFRunner(fitter=jn.CoellipFitter(3), ntry=2, guesser=jguessers.CoellipPSFGuesser(
        rng=np.random.RandomState(1), ngauss=3)).go(jobs)
    tres = nt.PSFRunner(fitter=nt.CoellipFitter(3), ntry=2, guesser=guessers.CoellipPSFGuesser(
        rng=np.random.RandomState(1), ngauss=3)).go(tobs)
    assert tres.route == "run_lm"
    assert tres["flags"] == 0
    assert_fit_equal(tres, jres, keys=("pars", "pars_err", "g", "T", "s2n"))
    np.testing.assert_allclose(tobs.psf.gmix.get_data(), jobs.psf.gmix.get_data(), rtol=1e-5,
                               atol=1e-12)


def test_runner_exp_under_turb_psf_takes_run_lm():
    rng = np.random.RandomState(33)
    data = get_model_obs(rng=rng, model="exp", T=1.2, g1=0.1, g2=-0.05, flux=100.0,
                         noise=0.05, dims=DIMS, psf_model="turb")
    jobs = data["obs"]
    jobs.psf.set_gmix(data["psf_gmix"])
    tobs = convert.observation_from_object(jobs, device="cpu")
    jres = jn.Runner(fitter=jn.Fitter("exp"), ntry=2, guesser=jguessers.TFluxGuesser(
        rng=np.random.RandomState(8), T=1.0, flux=90.0)).go(jobs)
    tres = nt.Runner(fitter=nt.Fitter("exp"), ntry=2, guesser=guessers.TFluxGuesser(
        rng=np.random.RandomState(8), T=1.0, flux=90.0)).go(tobs)
    assert tres.route == "run_lm"
    assert tres["flags"] == 0
    assert_fit_equal(tres, jres)


class _Flaky:
    """a fitter whose first nfail results are flagged, recording the
    guesses it was given"""

    def __init__(self, nfail):
        self.nfail, self.guesses = nfail, []

    def go(self, obs, guess=None):
        self.guesses.append(guess)
        return {"flags": int(len(self.guesses) <= self.nfail)}


def test_runner_retries_until_a_clean_fit():
    obs = nt.Observation(np.zeros((5, 5)), device="cpu")
    guesser = guessers.TFluxGuesser(rng=np.random.RandomState(3), T=1.0, flux=10.0)
    ref = jguessers.TFluxGuesser(rng=np.random.RandomState(3), T=1.0, flux=10.0)
    for nfail, ntry, calls, flags in ((2, 4, 3, 0), (5, 3, 3, 1), (0, 1, 1, 0)):
        fitter = _Flaky(nfail)
        res = nt.Runner(fitter=fitter, guesser=guesser, ntry=ntry).go(obs)
        assert (len(fitter.guesses), res["flags"]) == (calls, flags)
        # a fresh guess every try, drawn as the reference draws them
        for g in fitter.guesses:
            np.testing.assert_array_equal(g, ref())
    # PSFRunner: the same loop on each epoch's psf, the result set there
    psf_obs = nt.ObsList()
    for _ in range(2):
        psf_obs.append(nt.Observation(np.zeros((5, 5)), device="cpu",
                                      psf=nt.Observation(np.zeros((5, 5)), device="cpu")))
    fitter = _Flaky(1)
    out = nt.PSFRunner(fitter=fitter, ntry=2).go(psf_obs)
    assert [r["flags"] for r in out] == [0, 0] and len(fitter.guesses) == 3
    assert [o.psf.meta["result"]["flags"] for o in psf_obs] == [0, 0]
