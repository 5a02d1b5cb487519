"""The port's Fitter against ngmix_tpu's on the K3 route for dev (free,
and with fit_pars["bounds"] whose flux bound pins the fit) and on the
K3-mb route (one band over two epochs; two bands), on the same
25x25 stamps of tests/_sims.get_model_obs carried across by
convert.observation_from_object(device="cpu") (the kernels' plain
versions). Flags equal; pars, pars_err, g, T, flux and s2n to rtol
1e-5 (+ atol 1e-12); nfev within 2; each test asserts the route.
"""
import numpy as np
import pytest
import torch

import ngmix_tpu as jn

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import convert

from _sims import get_model_obs
from test_torch_fitters import DIMS, _k3_case, assert_fit_equal

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)


def _stamp(rng, model, flux, noise):
    data = get_model_obs(rng=rng, model=model, T=1.2, g1=0.1, g2=-0.05, flux=flux,
                         noise=noise, dims=DIMS)
    data["obs"].psf.set_gmix(data["psf_gmix"])
    return data


@pytest.mark.parametrize("name", ["dev", "dev_bounds"])
def test_dev_takes_k3(name):
    jres, tres = _k3_case(name)
    assert tres.route == "K3"
    assert tres["flags"] == 0
    assert_fit_equal(tres, jres)
    if name == "dev_bounds":
        # the flux lower bound above the truth pins the fit there
        assert abs(tres["pars"][5] - 120.0) < 5e-3


@pytest.mark.parametrize("kind", ["epochs", "bands"])
def test_multi_epoch_and_band_take_k3_mb(kind):
    rng = np.random.RandomState(48 if kind == "epochs" else 49)
    if kind == "epochs":
        jobs = jn.ObsList()
        for _ in range(2):
            data = _stamp(rng, "gauss", 100.0, 0.1)
            jobs.append(data["obs"])
        guess = data["pars"] * rng.uniform(low=0.9, high=1.1, size=6)
    else:
        jobs = jn.MultiBandObsList()
        for flux in (100.0, 150.0):
            ol = jn.ObsList()
            ol.append(_stamp(rng, "gauss", flux, 0.05)["obs"])
            jobs.append(ol)
        guess = np.array([0.0, 0.0, 0.05, 0.0, 1.1, 90.0, 160.0])
    jres = jn.Fitter("gauss").go(jobs, guess)
    tres = nt.Fitter("gauss").go(convert.observation_from_object(jobs, device="cpu"), guess)
    assert tres.route == "K3-mb"
    assert tres["flags"] == 0
    assert_fit_equal(tres, jres)
    if kind == "bands":
        assert tres["flux"].shape == (2,)
        np.testing.assert_allclose(tres["flux_cov"], jres["flux_cov"], rtol=1e-5)
