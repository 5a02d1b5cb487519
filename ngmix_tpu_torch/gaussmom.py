"""Fixed-gaussian weighted moments (the batched device path).

Ports of ``ngmix_tpu/gaussmom.py: make_weight_gmix, gaussmom_measure,
_normalize_sums``: the weight is a round gaussian of the given FWHM at
the jacobian origin, scaled to unit peak so fluxes come out in image
units; the sums are divided by the pixel area to give flux units. The
weight is evaluated by K2 through gmix.core.get_weighted_sums.
"""
import numpy as np
import torch

from . import moments
from .gmix import core as gcore
from .gmix.gmix import get_weighted_moments_stats


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
