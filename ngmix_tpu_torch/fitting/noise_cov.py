"""The sandwich covariance of an LM fit under stationary correlated
noise: the port of ``ngmix_tpu/fitting/noise_cov.py``.

    Cov = A^-1 B A^-1,   A^-1 = pars_cov0,
    B_ab = sum_epochs sum_q conj(G_a) G_b |n~(q)|^2 / N^2

with G_a = fft2(weight * dmodel/dp_a) and n~ the FFT of the epoch's
noise image. The derivative images are torch.func.jacfwd of the
apodized render with the broadcasting ``gmix.core.eval_gmix`` on the
observation's device (K2 has no derivative), as the reference takes
them from jax.jacfwd; the sums are numpy on the host.
"""
import numpy as np
import torch

from ..flags import EIG_NOTFINITE, LM_NEG_COV_DIAG, LM_NEG_COV_EIG
from ..gexceptions import GMixRangeError
from ..gmix import core as gcore
from ..pixels import make_coords
from .fit_model import get_band_pars_device
from .lm import get_def_stuff

__all__ = ["calc_noise_cov", "apply_noise_cov"]


def _test_cov(pcov):
    """the covariance's sanity flags: a negative eigenvalue or diagonal
    entry, or eigenvalues that cannot be found"""
    flags = 0
    try:
        e, _ = np.linalg.eig(pcov)
        if np.any(e < 0):
            flags |= LM_NEG_COV_EIG
        if np.any(np.diag(pcov) < 0):
            flags |= LM_NEG_COV_DIAG
    except np.linalg.LinAlgError:
        flags |= EIG_NOTFINITE
    return flags


def apply_noise_cov(fit_model, result):
    """replace the chi^2-scaled LM covariance of a successful fit with
    the noise-power sandwich covariance (in place)"""
    if result["flags"] != 0:
        return
    pcov0 = result.get("pars_cov0")
    if pcov0 is None or not np.all(np.isfinite(pcov0)):
        return

    npars = result["pars"].size
    try:
        cov = calc_noise_cov(fit_model=fit_model, pars=result["pars"], pars_cov0=pcov0)
    except GMixRangeError:
        cov = np.full((npars, npars), np.nan)

    if not np.all(np.isfinite(cov)):
        cflags = _test_cov(np.diag(np.full(npars, -1.0)))
    else:
        cflags = _test_cov(cov)

    if cflags != 0:
        result["flags"] |= cflags
        result["errmsg"] = "bad noise covariance matrix"
        _, result["pars_cov"], result["pars_err"] = get_def_stuff(npars)
    else:
        result["pars_cov"] = cov
        result["pars_err"] = np.sqrt(np.diag(cov))


def _model_image_fn(model_name, coords, psf_gmix):
    """the convolved model image [P] as a function of an epoch's
    parameters, differentiable under torch.func"""

    def render(band_pars):
        gm, _ = gcore.gmix_fill(model_name, band_pars)
        if psf_gmix is not None:
            gm = gcore.gmix_convolve(gm, psf_gmix)
        return gcore.eval_gmix(gm, coords.v, coords.u, coords.area, fast=True)

    return render


def calc_noise_cov(fit_model, pars, pars_cov0):
    """the sandwich covariance pars_cov0 B pars_cov0, B summed over the
    epochs from each one's noise power"""
    pars = np.asarray(pars)
    npars = pars.size
    nband = fit_model.nband
    nshape = npars - nband

    B = np.zeros((npars, npars))
    for band in range(nband):
        kpars = list(range(nshape)) + [nshape + band]
        for obs in fit_model.obs[band]:
            if not obs.has_noise():
                raise ValueError("obs.noise must be set for calc_noise_cov")
            dims = obs.image.shape
            dev = obs.device
            coords = make_coords(dims, obs.jacobian.to_device(dev))
            psf_gmix = obs.psf.gmix.to_device(dev) if obs.has_psf_gmix() else None
            band_pars = get_band_pars_device(fit_model.model_name,
                                             torch.as_tensor(pars, device=dev), band)
            render = _model_image_fn(fit_model.model_name, coords, psf_gmix)
            # [P, band parameters]: the exact derivative images of the
            # apodized objective
            dflat = torch.func.jacfwd(render)(band_pars).cpu().numpy()
            kernels = [np.fft.fft2(obs.weight * dflat[:, a].reshape(dims))
                       for a in range(dflat.shape[1])]
            p = np.abs(np.fft.fft2(obs.noise)) ** 2
            n = obs.image.size
            for ia in range(len(kpars)):
                for ib in range(ia, len(kpars)):
                    val = np.sum(np.conj(kernels[ia]) * kernels[ib] * p).real / n**2
                    B[kpars[ia], kpars[ib]] += val
                    if ib != ia:
                        B[kpars[ib], kpars[ia]] += val

    return pars_cov0 @ B @ pars_cov0
