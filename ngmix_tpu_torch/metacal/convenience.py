"""The top-level metacal entry with noise cancellation: the port of
``ngmix_tpu/metacal/convenience.py``.

get_all_metacal makes the full dict of counter-sheared observations
and, by default (fixnoise), adds back a noise field that was rotated
by 90 degrees, put through the same metacal engine and rotated back,
so that the shear-correlated noise cancels at the cost of sqrt(2) more
noise. The containers fan out through the port's containers module;
the noise draws come from the caller's RandomState in the reference's
order.
"""
import copy
import logging
import warnings

import numpy as np

from .. import simobs
from ..containers import obs_map, obs_map_transpose, obs_zip_map
from ..observation import Observation
from .defaults import DEFAULT_STEP
from .metacal import (
    MetacalAnalyticPSF,
    MetacalAzGaussPSF,
    MetacalDilatePSF,
    MetacalFitGaussPSF,
    MetacalGaussPSF,
)

__all__ = ["get_all_metacal"]

logger = logging.getLogger(__name__)


def get_all_metacal(
    obs, psf=None, step=DEFAULT_STEP, fixnoise=True, rng=None,
    use_noise_image=False, types=None,
):
    """every metacal image combination as {type: observation(s)}.

    psf selects the reconvolution target: 'gauss' (the default, with a
    FutureWarning that it will become 'azgauss'), 'azgauss',
    'fitgauss', 'dilate', or an analytic psf (a GMix or a gaussian sky
    sigma). With fixnoise (the default) the sheared-noise cancellation
    is applied, from a noise image drawn with rng or, with
    use_noise_image, from each observation's noise plane.
    """
    if psf is None:
        warnings.warn(
            "The default reconvolution psf will change from "
            "'gauss' to 'azgauss' in a future version",
            FutureWarning,
            stacklevel=2,
        )
        psf = "gauss"

    if not fixnoise:
        logger.debug("    not doing fixnoise")
        return _metacal_images(obs, psf=psf, step=step, rng=rng, types=types)

    return _metacal_images_fixnoise(
        obs, psf=psf, step=step, rng=rng,
        use_noise_image=use_noise_image, types=types,
    )


def _make_engine(single_obs, psf, rng):
    """the reconvolution-psf engine of one observation"""
    if psf == "dilate":
        return MetacalDilatePSF(single_obs)
    if psf == "azgauss":
        return MetacalAzGaussPSF(obs=single_obs, rng=rng)
    if psf == "gauss":
        return MetacalGaussPSF(obs=single_obs, rng=rng)
    if psf == "fitgauss":
        return MetacalFitGaussPSF(obs=single_obs, rng=rng)
    return MetacalAnalyticPSF(obs=single_obs, psf=psf, rng=rng)


def _metacal_images(obs, psf, step, rng, types):
    """{type: container} of sheared observations, without the noise fix"""
    return obs_map_transpose(
        obs,
        lambda single: _make_engine(single, psf, rng).get_all(
            step=step, types=types
        ),
    )


def _metacal_images_fixnoise(obs, psf, step, rng, use_noise_image, types):
    """the sheared images plus the rot90 noise-cancellation field: the
    noise is rotated a quarter turn, put through the same metacal
    engine, rotated back (three more quarter turns) and added to each
    sheared image; the weights combine as independent variances"""
    if use_noise_image:
        logger.debug("    Doing fixnoise with input noise image")
        noise_obs = copy.deepcopy(obs)
        obs_map(noise_obs, _swap_in_noise_image)
    else:
        noise_obs = simobs.simulate_obs(gmix=None, obs=obs, rng=rng)

    obs_map(noise_obs, lambda o: _rot90_image(o, k=1))

    sheared = _metacal_images(obs, psf=psf, step=step, rng=rng, types=types)
    sheared_noise = _metacal_images(
        noise_obs, psf=psf, step=step, rng=rng, types=types
    )

    for key, noise_container in sheared_noise.items():
        obs_map(noise_container, lambda o: _rot90_image(o, k=3))
        obs_zip_map(sheared[key], noise_container, _add_canceling_noise)

    return sheared


def _swap_in_noise_image(single_obs):
    single_obs.image = single_obs.noise


def _rot90_image(single_obs, k):
    single_obs.set_image(np.rot90(single_obs.image, k=k))


def _add_canceling_noise(single_obs, noise_obs):
    """image += the metacal'd noise; weight = 1 / (var + var_noise).

    Keeps the image and weight before the addition as image_orig and
    weight_orig. Pixels where either weight is zero keep their weight.
    The observation's device pixels are rebuilt when the writeable
    scope closes.
    """
    assert isinstance(single_obs, Observation)
    single_obs.image_orig = single_obs.image.copy()
    single_obs.weight_orig = single_obs.weight.copy()

    both_valid = (single_obs.weight != 0.0) & (noise_obs.weight != 0.0)
    combined_var = np.zeros_like(single_obs.weight)
    np.divide(1.0, single_obs.weight, out=combined_var, where=both_valid)
    combined_var += np.divide(
        1.0, noise_obs.weight,
        out=np.zeros_like(combined_var), where=both_valid,
    )

    with single_obs.writeable():
        single_obs.image += noise_obs.image
        single_obs.weight[both_valid] = 1.0 / combined_var[both_valid]
