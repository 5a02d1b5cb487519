"""The reconvolution kernel's size from a gaussian fit to the psf: the
port of ``ngmix_tpu/metacal/fitgauss_target_psf.py``.

Adaptive moments (AdmomFitter, K2) first, then the maximum-likelihood
gaussian (Fitter("gauss"), one K3 launch a try), then a one-gaussian
mixture already attached to the psf; the round T is dilated by the
ellipticity factor, capped at 1.1. The guessers draw from the caller's
RandomState in the reference's order.
"""
import logging

import numpy as np

from .. import moments
from ..gexceptions import BootPSFFailure, GMixRangeError

logger = logging.getLogger(__name__)


def get_fitgauss_target_T(psfobs, rng):
    """fit the psf and return the dilated round T of the target
    gaussian kernel"""
    from ..admom import AdmomFitter
    from ..fitting import Fitter
    from ..guessers import GMixPSFGuesser, SimplePSFGuesser
    from ..runners import run_psf_fitter

    ntry = 4
    guesser = GMixPSFGuesser(rng=rng, ngauss=1)

    fitter = AdmomFitter(rng=rng)
    res = run_psf_fitter(
        obs=psfobs, fitter=fitter, guesser=guesser, ntry=ntry,
        set_result=False,
    )

    if res["flags"] == 0:
        e1, e2 = res["e"]
        T = res["T"]
    else:
        lm_pars = {"maxfev": 2000, "ftol": 1.0e-05, "xtol": 1.0e-05}
        fitter = Fitter(model="gauss", fit_pars=lm_pars)
        guesser = SimplePSFGuesser(rng=rng)
        res = run_psf_fitter(
            obs=psfobs, fitter=fitter, guesser=guesser, ntry=ntry,
            set_result=False,
        )
        if res["flags"] == 0:
            psf_gmix = res.get_gmix()
        elif psfobs.has_gmix() and len(psfobs.gmix) == 1:
            psf_gmix = psfobs.gmix.copy()
        else:
            raise BootPSFFailure("failed to fit psf for MetacalFitGaussPSF")
        try:
            e1, e2, T = psf_gmix.get_e1e2T()
        except GMixRangeError as err:
            logger.info("%s", err)
            raise BootPSFFailure(
                "could not get e1,e2 from psf fit for MetacalFitGaussPSF"
            )

    dilation = _get_ellip_dilation(e1, e2, T)
    return T * dilation


def _get_ellip_dilation(e1, e2, T):
    """the dilation that hides the modes the psf's ellipticity exposes"""
    irr, irc, icc = (float(x) for x in moments.e2mom(e1, e2, T))
    mat = np.array([[irr, irc], [irc, icc]])
    eigs = np.linalg.eigvals(mat)
    dilation = np.sqrt(eigs.max() / (T / 2.0))
    dilation = 1.0 + 2 * (dilation - 1.0)
    return min(dilation, 1.1)


def get_fitgauss_target_psf(psfobs, rng, flux=None):
    """the reconvolution kernel from a gaussian fit to the psf, as a
    round GMixModel ('gauss')"""
    from ..gmix.gmix import GMixModel

    if flux is None:
        flux = float(np.sum(psfobs.image))
    T = float(get_fitgauss_target_T(psfobs, rng))
    return GMixModel(np.array([0.0, 0.0, 0.0, 0.0, T, flux]), "gauss")
