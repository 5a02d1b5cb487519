"""Simulate observations from gaussian mixtures and weight-map noise.

The port of ``ngmix_tpu/simobs.py``: the same sampling, the noise drawn
in numpy from the caller's ``RandomState`` in the reference's order
(weight-map gaussian noise, the median noise in zero-weight pixels,
the optional noise_factor rescale), the model rendered by
``GMix.make_image`` through K2 on the observation's device. The
container recursion runs band by band, so a MultiBandObsList pairs
with a list of mixtures, one a band.
"""
import logging
from copy import deepcopy

import numpy as np

from .gmix.gmix import GMix
from .observation import MultiBandObsList, Observation, ObsList

LOGGER = logging.getLogger(__name__)

BIGNOISE = 1.0e15


def simulate_obs(
    gmix, obs, add_noise=True, rng=None, add_all=True, noise_factor=None,
    use_raw_weight=True, convolve_psf=True,
):
    """simulate observation(s) matching ``obs``'s geometry and noise.

    gmix renders the object (convolved with each epoch's psf mixture
    unless convolve_psf=False); gmix=None simulates pure noise. For a
    MultiBandObsList pass a list of mixtures, one per band.
    """
    kw = dict(
        add_noise=add_noise, rng=rng, add_all=add_all,
        noise_factor=noise_factor, use_raw_weight=use_raw_weight,
        convolve_psf=convolve_psf,
    )
    if isinstance(obs, MultiBandObsList):
        per_band = _band_mixtures(gmix, obs)
        out = MultiBandObsList()
        for g, obslist in zip(per_band, obs):
            out.append(simulate_obs(g, obslist, **kw))
        return out

    if gmix is not None and not isinstance(gmix, GMix):
        raise ValueError(
            "simulate_obs needs a GMix (or None for pure noise) here; "
            "got a %s" % type(gmix).__name__
        )
    if isinstance(obs, ObsList):
        out = ObsList()
        for epoch in obs:
            out.append(simulate_obs(gmix, epoch, **kw))
        return out
    if isinstance(obs, Observation):
        return _simulate_one(gmix, obs, **kw)
    raise ValueError(
        "simulate_obs takes an Observation, ObsList or "
        "MultiBandObsList; got a %s" % type(obs).__name__
    )


def _band_mixtures(gmix, mbobs):
    """pair a per-band mixture list with a MultiBandObsList"""
    if gmix is None:
        return [None] * len(mbobs)
    if not isinstance(gmix, list) or not all(
        isinstance(g, GMix) for g in gmix
    ):
        raise ValueError(
            "a MultiBandObsList pairs with a list of GMix, one per band"
        )
    if len(gmix) != len(mbobs):
        raise ValueError(
            "got %d mixtures for %d bands" % (len(gmix), len(mbobs))
        )
    return gmix


def _simulate_one(gmix, obs, add_noise=True, rng=None, add_all=True,
                  noise_factor=None, use_raw_weight=True, convolve_psf=True):
    """simulate a single Observation on its device"""
    if gmix is None:
        image = np.zeros(obs.image.shape)
    else:
        gm = gmix.convolve(_psf_mixture(obs)) if convolve_psf else gmix
        image = gm.make_image(obs.image.shape, jacobian=obs.jacobian, device=obs.device)

    noise_image = None
    if add_noise:
        # the raw (pre-fixnoise) weight map drives the realization when
        # available, so noise sims of halved-weight metacal obs match
        # the original depth
        wt_for_noise = (
            obs.weight_raw
            if use_raw_weight and hasattr(obs, "weight_raw")
            else obs.weight
        )
        noise_image = get_noise_image(
            weight=wt_for_noise, rng=rng, add_all=add_all,
            noise_factor=noise_factor,
        )
        image = image + noise_image

    weight = obs.weight.copy()
    if noise_factor is not None:
        LOGGER.debug(
            "scaling weight by 1/noise_factor^2 (%s)", noise_factor
        )
        weight /= noise_factor**2

    out = Observation(
        image, weight=weight, jacobian=obs.jacobian,
        psf=deepcopy(obs.psf) if obs.has_psf() else None,
        device=obs.device,
    )
    out.noise_image = noise_image
    return out


def get_noise_image(weight, rng, add_all=True, noise_factor=None):
    """noise realization from a weight map; zero-weight pixels get the
    median noise if add_all"""
    if rng is None:
        raise ValueError("get_noise_image needs an rng")

    unit = rng.normal(loc=0.0, scale=1.0, size=weight.shape)
    live = weight > 0
    if not live.any():
        LOGGER.debug("weight map is all zero; noise sigma = %s", BIGNOISE)
        return unit * BIGNOISE

    err = np.zeros(weight.shape)
    err[live] = np.sqrt(1.0 / weight[live])
    if add_all and not live.all():
        err[~live] = np.median(err[live])
    if noise_factor is not None:
        LOGGER.debug("scaling noise by factor %s", noise_factor)
        err *= noise_factor
    return unit * err


def _psf_mixture(obs):
    """the fitted psf mixture needed for convolve_psf"""
    if not obs.has_psf():
        raise RuntimeError(
            "convolve_psf=True but this observation carries no psf"
        )
    psf = obs.get_psf()
    if not psf.has_gmix():
        raise RuntimeError(
            "convolve_psf=True but the psf has no fitted mixture"
        )
    return psf.gmix
