"""Gaussian-aperture fluxes of a catalog of model parameters: the port
of ``ngmix_tpu/gaussap.py``.

Every object of every band is filled at once on the device
(``gmix.core.gmix_fill``, or ``fill_cm`` for the cm model) in float64,
and its flux through a round gaussian weight of the given sigma is the
closed form of ``gaussap_flux_single``: for a gaussian of covariance M,
the reference's sqrt(det((M^-1 + W^-1)^-1) / det M) with W = sigma^2 I
is 1 / sqrt(1 + T / sigma^2 + det M / sigma^4). The catalog goes to the
CUDA card unless the caller passes ``device="cpu"``; the fluxes and
flags come back as numpy.
"""
import numpy as np
import torch

from . import moments
from .flags import GMIX_RANGE_ERROR, NO_ATTEMPT
from .gmix import core as gcore
from .util import resolve_device

DEFAULT_FLUX = np.nan


def gaussap_flux_single(gmix, sigma):
    """the aperture flux [...] of mixtures [..., n, 6] under a round
    gaussian weight of the given sigma"""
    det = gcore.gmix_det(gmix)
    T = gmix[..., gcore.G_IRR] + gmix[..., gcore.G_ICC]
    s2 = sigma * sigma
    good = det > 0
    det_safe = torch.where(good, det, 1.0)
    fac = 1.0 / torch.sqrt(1.0 + T / s2 + det_safe / (s2 * s2))
    fac = torch.where(good, torch.clamp(fac, max=1.0), 1.0)
    return torch.sum(gmix[..., gcore.G_P] * fac, dim=-1)


def _band_pars(pars, band, npars_band):
    """the shared parameters and band's flux [nobj, npars_band], T at
    least 1e-4"""
    out = torch.cat([pars[:, :npars_band - 1],
                     pars[:, npars_band - 1 + band:npars_band + band]], dim=1)
    out[:, 4] = torch.clamp(out[:, 4], min=0.0001)
    return out


def get_gaussap_flux(pars, model, weight_fwhm, fracdev=None, TdByTe=None, mask=None,
                     verbose=True, device=None):
    """gaussian-aperture fluxes of a catalog (ref: gaussap.py:44-98).

    pars [nobj, npars (+ a flux for each band past the first)]; returns
    (gap_flux [nobj, nband], flags [nobj, nband]) as numpy: DEFAULT_FLUX
    and GMIX_RANGE_ERROR where a fill is flagged, DEFAULT_FLUX and
    NO_ATTEMPT where mask is False. device: where the fills run, None
    for the CUDA card."""
    del verbose
    pars = np.array(pars, dtype="f8", ndmin=2)
    nobj = pars.shape[0]
    if mask is not None:
        mask = np.array(mask, dtype=bool, ndmin=1)
        assert mask.shape[0] == nobj, "mask and pars must be same length"
    else:
        mask = np.ones(nobj, dtype=bool)
    if model == "cm":
        fracdev = np.array(fracdev, dtype="f8", ndmin=1)
        TdByTe = np.array(TdByTe, dtype="f8", ndmin=1)
        assert fracdev.size == nobj, "fracdev/pars must be same size"
        assert TdByTe.size == nobj, "TdByTe/pars must be same length"

    npars_band = 7 if model == "bdf" else 6
    nband = pars.shape[1] - npars_band + 1
    sigma = float(moments.fwhm_to_sigma(weight_fwhm))

    dev = resolve_device(device)
    dpars = torch.as_tensor(pars, device=dev)
    if model == "cm":
        dfracdev = torch.as_tensor(fracdev, device=dev)
        dTdByTe = torch.as_tensor(TdByTe, device=dev)
    fluxes, bads = [], []
    for band in range(nband):
        bpars = _band_pars(dpars, band, npars_band)
        if model == "cm":
            gm, gflags = gcore.fill_cm(bpars, dfracdev, dTdByTe)
        else:
            gm, gflags = gcore.gmix_fill(model, bpars)
        fluxes.append(gaussap_flux_single(gm, sigma))
        bads.append(gflags != 0)
    flux = torch.stack(fluxes, dim=1).cpu().numpy()
    bad = torch.stack(bads, dim=1).cpu().numpy()

    gap_flux = np.where(bad, DEFAULT_FLUX, flux)
    flags = np.where(bad, GMIX_RANGE_ERROR, 0).astype("i4")
    gap_flux[~mask, :] = DEFAULT_FLUX
    flags[~mask, :] = NO_ATTEMPT
    return gap_flux, flags
