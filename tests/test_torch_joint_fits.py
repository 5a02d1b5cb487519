"""The real-space host fits with the joint priors of this slice against
the JAX package's on the same stamps, in float64 on the CPU:
Fitter("exp") with a PriorSimpleSep of LMBounds slots, its bounds
those of the prior, on the K3 route (one band), the K3-mb route (two
bands) and run_lm (a psf of three gaussians), and CoellipFitter(3)
with PriorCoellipSame (run_lm). The k-space fits are in
tests/test_torch_joint_kfits.py (each JAX k-space fit compiles its own
closure). Tolerances: the North star's LM ones, flags equal, nfev
within 2, pars, pars_err and the derived fields to rtol 1e-5.
"""
import numpy as np
import pytest
import torch

import ngmix_tpu as jn
from ngmix_tpu import joint_prior as jjp, priors as jpr

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import convert

from test_torch_fitter_routes import _stamp
from test_torch_fitters import _obs, assert_fit_equal

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)


def _cen_g(rng):
    return jpr.CenPrior(0.0, 0.0, 0.263, 0.263, rng=rng), jpr.GPriorBA(0.3, rng=rng)


@pytest.mark.parametrize("route", ["run_lm", "K3", "K3-mb"])
def test_fitter_with_lmbounds_prior_matches_jax(route):
    """LMBounds slots carry no weight, and the fit takes their bounds
    from prior.bounds as the reference's Fitter does. The one-band stamp
    is ROADMAP fault 3.8's: the flux's pin flips at the optimum there,
    and K3 then reaches a trial cost equal to its own"""
    rng = np.random.RandomState(3)
    cen, g = _cen_g(rng)
    T = jpr.LMBounds(0.01, 50.0, rng=rng)
    if route == "K3-mb":
        rng = np.random.RandomState(49)
        jobs = jn.MultiBandObsList()
        for flux in (100.0, 150.0):
            ol = jn.ObsList()
            ol.append(_stamp(rng, "exp", flux, 0.1)["obs"])
            jobs.append(ol)
        guess = np.array([0.0, 0.0, 0.05, 0.0, 1.1, 90.0, 160.0])
        jprior = jjp.PriorSimpleSep(cen, g, T, [jpr.LMBounds(1e-3, 1e9, rng=rng),
                                                jpr.LMBounds(1e-3, 1e9, rng=rng)])
        tobs = convert.observation_from_object(jobs, device="cpu")
    else:
        kw = {"psf_model": "turb"} if route == "run_lm" else {}
        jobs, tobs, data = _obs(46, model="exp", **kw)
        guess = data["guess"]
        jprior = jjp.PriorSimpleSep(cen, g, T, jpr.LMBounds(1e-3, 1e9, rng=rng))
    jres = jn.Fitter("exp", prior=jprior).go(jobs, guess)
    tres = nt.Fitter("exp", prior=convert.prior_from_object(jprior)).go(tobs, guess)
    assert tres.route == route and tres["flags"] == 0
    assert_fit_equal(tres, jres)
    assert 0.01 < tres["pars"][4] < 50.0


def test_coellip_fitter_with_prior_matches_jax():
    rng = np.random.RandomState(4)
    jprior = jjp.PriorCoellipSame(3, *_cen_g(rng), jpr.LMBounds(1e-4, 10.0, rng=rng),
                                  jpr.TwoSidedErf(-100.0, 0.1, 1e9, 1.0, rng=rng))
    truth = [0.0, 0.0, 0.03, -0.02, 0.15, 0.45, 1.3, 0.5, 0.35, 0.15]
    jac = dict(row=12.0, col=12.0, scale=0.263)
    im = nt.GMixCoellip(truth).make_image((25, 25), jacobian=nt.DiagonalJacobian(**jac),
                                          device="cpu")
    im = im + np.random.RandomState(5).normal(size=im.shape) * 1e-4
    wt = np.full(im.shape, 1e8)
    jobs = jn.Observation(im, weight=wt, jacobian=jn.DiagonalJacobian(**jac))
    tobs = nt.Observation(im, weight=wt, jacobian=nt.DiagonalJacobian(**jac), device="cpu")
    guess = np.array(truth) * np.random.RandomState(6).uniform(0.95, 1.05, 10)
    jres = jn.CoellipFitter(3, prior=jprior).go(jobs, guess)
    tres = nt.CoellipFitter(3, prior=convert.prior_from_object(jprior)).go(tobs, guess)
    assert tres.route == "run_lm" and tres["flags"] == 0
    assert_fit_equal(tres, jres, keys=("pars", "pars_err", "s2n"))
