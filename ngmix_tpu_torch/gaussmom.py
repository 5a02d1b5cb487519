"""Fixed-gaussian weighted moments (the batched device path).

Ports of ``ngmix_tpu/gaussmom.py: make_weight_gmix, gaussmom_measure,
_normalize_sums``: the weight is a round gaussian of the given FWHM at
the jacobian origin, scaled to unit peak so fluxes come out in image
units; the sums are divided by the pixel area to give flux units. The
weight is evaluated by K2 through gmix.core.get_weighted_sums.

``GaussMom`` is the host API: one observation, or the epochs and bands
of an ObsList or MultiBandObsList with their sums coadded, one K2
launch an observation on the observations' device.
"""
import logging

import numpy as np
import torch

from . import moments
from .gmix import core as gcore
from .gmix.gmix import get_weighted_moments_stats
from .observation import MultiBandObsList, Observation, ObsList

logger = logging.getLogger(__name__)


def make_weight_gmix(fwhm, dtype=torch.float64, device=None):
    """unit-peak round gaussian weight [1, 6] for the given fwhm"""
    T = moments.fwhm_to_T(fwhm)
    sigma2 = T / 2.0
    # flux = 1/norm = 2*pi*sqrt(det) makes the peak exactly 1
    flux = 2 * np.pi * sigma2
    return torch.tensor(
        [[flux, 0.0, 0.0, sigma2, 0.0, sigma2]], dtype=dtype, device=device
    )


def gaussmom_measure(pixels, fwhm, area):
    """weighted sums and their normalization for one or a batch of pixel
    structs ([..., npix] fields); area is the jacobian pixel area, a
    scalar or [...]"""
    wt = make_weight_gmix(fwhm, dtype=pixels.val.dtype, device=pixels.val.device)
    if pixels.val.dim() > 1:
        wt = torch.broadcast_to(wt, pixels.val.shape[:-1] + wt.shape)
    T = moments.fwhm_to_T(fwhm)
    maxrad = 100.0 * np.sqrt(T / 2.0)
    sums = gcore.get_weighted_sums(wt, pixels, maxrad)
    return _normalize_sums(sums, area)


def _normalize_sums(sums, area):
    """divide out the pixel area factor and build the moments result"""
    fac = 1.0 / torch.as_tensor(
        area, dtype=sums["sums"].dtype, device=sums["sums"].device
    )
    raw = dict(sums)
    raw["sums"] = sums["sums"] * fac[..., None]
    raw["sums_cov"] = sums["sums_cov"] * (fac**2)[..., None, None]
    raw["wsum"] = sums["wsum"] * fac
    return get_weighted_moments_stats(raw)


class GaussMom(object):
    """gaussian weighted moments (kind = "wmom") of an Observation, or
    of an ObsList or MultiBandObsList with the sums coadded (which
    assumes perfect registration); with_higher_order gives the 17
    moments"""

    kind = "wmom"

    def __init__(self, fwhm, with_higher_order=False):
        self.fwhm = fwhm
        self.with_higher_order = with_higher_order

    def go(self, obs):
        res = self._measure_moments(obs=obs)
        if res["flags"] != 0:
            logger.debug("        moments failed: %s" % res["flagstr"])
        return res

    def _obs_seq(self, obs):
        if isinstance(obs, Observation):
            return [obs]
        if isinstance(obs, ObsList):
            return list(obs)
        if isinstance(obs, MultiBandObsList):
            return [o for olist in obs for o in olist]
        raise ValueError(
            "obs must be Observation, ObsList or MultiBandObsList"
        )

    def _measure_moments(self, obs):
        obslist = self._obs_seq(obs)
        T = float(moments.fwhm_to_T(self.fwhm))
        maxrad = 100.0 * np.sqrt(T / 2.0)

        total = None
        for o in obslist:
            pixels = o.pixels
            wt = make_weight_gmix(self.fwhm, dtype=pixels.val.dtype, device=pixels.val.device)
            s = gcore.get_weighted_sums(
                wt, pixels, maxrad, higher_order=self.with_higher_order
            )
            if total is None:
                total = dict(s)
            else:
                for k in ("sums", "sums_cov", "wsum"):
                    total[k] = total[k] + s[k]
                total["npix"] = total["npix"] + s["npix"]

        res = _normalize_sums(total, obslist[0].jacobian.area)
        return moments.result_to_host(res)
