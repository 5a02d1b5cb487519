"""Guess generators of the host fitters: the port of
``ngmix_tpu/guessers.py``.

The guesses are numpy over the caller's generator (a ``RandomState``,
or a prior's), so a generator in the same state gives the same guesses
as the reference: jittered parameter vectors around an input T and
fluxes, prior samples with the fits' fix-up against the prior, fluxes
from psf-flux fits (``PSFFluxFitter``, its templates rendered through
K2 on the observation's device), and the one- to five-gaussian psf
starts with the reference's (p, f) tables. ``GMixPSFGuesser``'s
``guess_from_moms`` reads a weighted-moments pass
(``GMix.get_weighted_moments``, on the observation's device).
"""
import logging

import numpy as np

from . import moments
from .defaults import LOWVAL
from .gexceptions import GMixRangeError, PSFFluxFailure
from .gmix.gmix import GMix, GMixModel, get_coellip_npars
from .priors.random import srandu
from .shape import Shape
from .util import print_pars

LOGGER = logging.getLogger(__name__)


# ----------------------------------------------------------------------
# shared jitter helpers

def _about(rng, center, frac, n=None):
    """center * U(1-frac, 1+frac)"""
    return center * rng.uniform(low=1.0 - frac, high=1.0 + frac, size=n)


def _base5(rng, nrand, T):
    """the standard leading columns of a simple-model guess:
    cen jittered +-0.01 px, shape +-0.02, T +-10%"""
    cols = np.zeros((nrand, 5))
    cols[:, 0] = rng.uniform(low=-0.01, high=0.01, size=nrand)
    cols[:, 1] = rng.uniform(low=-0.01, high=0.01, size=nrand)
    cols[:, 2] = rng.uniform(low=-0.02, high=0.02, size=nrand)
    cols[:, 3] = rng.uniform(low=-0.02, high=0.02, size=nrand)
    cols[:, 4] = _about(rng, T, 0.1, nrand)
    return cols


def _set_flux_cols(rng, guess, col0, fluxes, frac=0.1):
    """per-band flux columns jittered by +-frac"""
    for b, f in enumerate(fluxes):
        guess[:, col0 + b] = _about(rng, f, frac, guess.shape[0])


def _one_or_many(guess, scalar):
    return guess[0, :] if scalar else guess


def _as_fluxes(flux):
    return np.array(flux, dtype="f8", ndmin=1)


# ----------------------------------------------------------------------
# simple-model guessers

class TFluxGuesser(object):
    """guesses around an input T and per-band fluxes
    (ref: guessers.py:14-75)"""

    def __init__(self, rng, T, flux, prior=None):
        self.rng = rng
        self.T = T
        self.fluxes = _as_fluxes(flux)
        self.prior = prior

    def __call__(self, nrand=1, obs=None):
        guess = np.zeros((nrand, 5 + self.fluxes.size))
        guess[:, :5] = _base5(self.rng, nrand, self.T)
        _set_flux_cols(self.rng, guess, 5, self.fluxes)
        if self.prior is not None:
            _fix_guess(guess, self.prior)
        return _one_or_many(guess, nrand == 1)


class TPSFFluxGuesser(object):
    """like TFluxGuesser with the fluxes measured from psf-flux fits,
    cached per obs identity (ref: guessers.py:78-144)"""

    def __init__(self, rng, T, prior=None):
        self.rng = rng
        self.T = T
        self.prior = prior
        self._id_last = None
        self._psf_fluxes = None

    def _get_psf_fluxes(self, obs):
        oid = id(obs)
        if oid != self._id_last:
            self._id_last = oid
            self._psf_fluxes = _get_psf_fluxes(
                rng=self.rng, obs=obs
            )["flux"]
        return self._psf_fluxes

    def __call__(self, obs, nrand=1):
        fluxes = self._get_psf_fluxes(obs=obs)
        guess = np.zeros((nrand, 5 + fluxes.size))
        guess[:, :5] = _base5(self.rng, nrand, self.T)
        _set_flux_cols(self.rng, guess, 5, fluxes)
        if self.prior is not None:
            _fix_guess(guess, self.prior)
        return _one_or_many(guess, nrand == 1)


class TPSFFluxAndPriorGuesser(TPSFFluxGuesser):
    """prior samples with T and psf-flux overrides
    (ref: guessers.py:147-201)"""

    def __init__(self, rng, T, prior):
        super().__init__(rng=rng, T=T, prior=prior)

    def __call__(self, obs, nrand=1):
        fluxes = self._get_psf_fluxes(obs=obs)
        guess = np.atleast_2d(self.prior.sample(nrand))
        guess[:, 4] = _about(self.rng, self.T, 0.1, nrand)
        _set_flux_cols(self.rng, guess, 5, fluxes)
        _fix_guess_TFlux(guess, self.prior)
        return _one_or_many(guess, nrand == 1)


def _get_psf_fluxes(rng, obs):
    """per-band template psf fluxes; failed bands get the mean of the
    good ones with a 10% jitter (ref: guessers.py:204-264)"""
    from .fitting import PSFFluxFitter
    from .observation import get_mb_obs

    fitter = PSFFluxFitter()
    results = [fitter.go(obs=obslist) for obslist in get_mb_obs(obs)]
    flux = np.array([r["flux"] for r in results])
    flux_err = np.array([r["flux_err"] for r in results])
    flags = np.array([r["flags"] for r in results], dtype="i4")

    good = (flags == 0) & np.isfinite(flux)
    if not good.any():
        raise PSFFluxFailure("every band's psf flux fit failed")
    if not good.all():
        nbad = int(np.count_nonzero(~good))
        flux[~good] = _about(rng, flux[good].mean(), 0.1, nbad)

    return {"flags": flags, "flux": flux, "flux_err": flux_err}


class TFluxAndPriorGuesser(object):
    """prior samples with T and flux overrides
    (ref: guessers.py:267-322)"""

    def __init__(self, rng, T, flux, prior):
        self.T = T
        self.fluxes = _as_fluxes(flux)
        self.prior = prior

    def __call__(self, nrand=1, obs=None):
        rng = self.prior.cen_prior.rng
        guess = np.atleast_2d(self.prior.sample(nrand))
        guess[:, 4] = _about(rng, self.T, 0.1, nrand)
        _set_flux_cols(rng, guess, 5, self.fluxes)
        _fix_guess_TFlux(guess, self.prior)
        return _one_or_many(guess, nrand == 1)


# ----------------------------------------------------------------------
# bulge+disk guessers

class BDFPSFFluxGuesser(TPSFFluxGuesser):
    """bdf guesses: prior samples, psf fluxes, U(0.4,0.6) fracdev
    (ref: guessers.py:325-376)"""

    def __init__(self, T, prior):
        super().__init__(rng=prior.cen_prior.rng, T=T, prior=prior)

    def __call__(self, obs, nrand=1):
        rng = self.prior.cen_prior.rng
        fluxes = self._get_psf_fluxes(obs=obs)
        guess = np.atleast_2d(self.prior.sample(nrand))
        guess[:, 4] = _about(rng, self.T, 0.1, nrand)
        guess[:, 5] = rng.uniform(low=0.4, high=0.6, size=nrand)
        _set_flux_cols(rng, guess, 6, fluxes)
        _fix_guess(guess, self.prior)
        return _one_or_many(guess, nrand == 1)


class BDFGuesser(object):
    """bdf guesses from T, flux and the joint prior
    (ref: guessers.py:379-429)"""

    flux_col = 6

    def __init__(self, T, flux, prior):
        self.T = T
        self.fluxes = np.array(flux, ndmin=1)
        self.prior = prior

    def __call__(self, nrand=1, obs=None):
        rng = self.prior.cen_prior.rng
        guess = np.atleast_2d(self.prior.sample(nrand))
        guess[:, 4] = _about(rng, self.T, 0.1, nrand)
        guess[:, 5] = rng.uniform(low=0.4, high=0.6, size=nrand)
        _set_flux_cols(rng, guess, self.flux_col, self.fluxes)
        if self.prior is not None:
            _fix_guess(guess, self.prior)
        return _one_or_many(guess, nrand == 1)


class BDGuesser(BDFGuesser):
    """bd guesses (extra logTratio par; fluxes start at column 7)
    (ref: guessers.py:432-486)"""

    flux_col = 7


# ----------------------------------------------------------------------
# around-a-point and prior-sample guessers

class ParsGuesser(object):
    """guesses jittered around an input parameter vector
    (ref: guessers.py:489-570)"""

    def __init__(self, rng, pars, prior=None, widths=None):
        self.rng = rng
        self.pars = np.array(pars)
        self.prior = prior
        self.np = self.pars.size
        if widths is None:
            self.widths = np.full(self.np, 0.1)
            self.widths[:2] = 0.02
        else:
            self.widths = widths

    def __call__(self, nrand=None, obs=None):
        rng = self.rng
        is_scalar = nrand is None
        n = 1 if is_scalar else nrand
        pars, widths = self.pars, self.widths
        guess = np.zeros((n, self.np))
        guess[:, 0] = pars[0] + widths[0] * srandu(n, rng=rng)
        guess[:, 1] = pars[1] + widths[1] * srandu(n, rng=rng)
        guess[:, 2:4] = get_shape_guess(
            rng=rng, g1=pars[2], g2=pars[3], nrand=n, width=widths[2:4],
            max=0.8,
        )
        for i in range(4, self.np):
            guess[:, i] = pars[i] * (1.0 + widths[i] * srandu(n, rng=rng))
        if self.prior is not None:
            _fix_guess(guess, self.prior)
        return _one_or_many(guess, is_scalar)


def get_shape_guess(rng, g1, g2, nrand, width, max=0.99):
    """[nrand, 2] shape guesses sheared off (g1, g2), resampling any
    draw that leaves the unit disk (ref: guessers.py:573-601)"""
    gtot = np.hypot(g1, g2)
    if gtot > max:
        g1, g2 = g1 * max / gtot, g2 * max / gtot
    base = Shape(g1, g2)

    out = np.zeros((nrand, 2))
    for i in range(nrand):
        while True:
            try:
                jittered = base.get_sheared(
                    width[0] * srandu(rng=rng),
                    width[1] * srandu(rng=rng),
                )
            except GMixRangeError:
                continue
            break
        out[i] = (jittered.g1, jittered.g2)
    return out


class R50FluxGuesser(object):
    """guesses from half-light radius and fluxes
    (ref: guessers.py:604-664)"""

    def __init__(self, rng, r50, flux, prior=None):
        if r50 < 0.0:
            raise GMixRangeError("r50 <= 0: %g" % r50)
        self.rng = rng
        self.r50 = r50
        self.fluxes = _as_fluxes(flux)
        self.prior = prior

    def __call__(self, nrand=1, obs=None):
        rng = self.rng
        guess = np.zeros((nrand, 5 + self.fluxes.size))
        guess[:, 0] = 0.01 * srandu(nrand, rng=rng)
        guess[:, 1] = 0.01 * srandu(nrand, rng=rng)
        guess[:, 2] = 0.02 * srandu(nrand, rng=rng)
        guess[:, 3] = 0.02 * srandu(nrand, rng=rng)
        guess[:, 4] = self.r50 * (1.0 + 0.1 * srandu(nrand, rng=rng))
        for b, f in enumerate(self.fluxes):
            guess[:, 5 + b] = f * (1.0 + 0.1 * srandu(nrand, rng=rng))
        if self.prior is not None:
            _fix_guess(guess, self.prior)
        return _one_or_many(guess, nrand == 1)


class PriorGuesser(object):
    """sample directly from a joint prior (ref: guessers.py:667-686)"""

    def __init__(self, prior):
        self.prior = prior

    def __call__(self, obs=None, nrand=None):
        return self.prior.sample(nrand)


class R50NuFluxGuesser(R50FluxGuesser):
    """r50 + spergel nu + fluxes (ref: guessers.py:689-764)"""

    NUMIN = -0.99
    NUMAX = 3.5

    def __init__(self, rng, r50, nu, flux, prior=None):
        super().__init__(rng=rng, r50=r50, flux=flux, prior=prior)
        self.nu = float(np.clip(nu, self.NUMIN, self.NUMAX))

    def __call__(self, nrand=1, obs=None):
        rng = self.rng
        guess = np.zeros((nrand, 6 + self.fluxes.size))
        guess[:, 0] = 0.01 * srandu(nrand, rng=rng)
        guess[:, 1] = 0.01 * srandu(nrand, rng=rng)
        guess[:, 2] = 0.02 * srandu(nrand, rng=rng)
        guess[:, 3] = 0.02 * srandu(nrand, rng=rng)
        guess[:, 4] = self.r50 * (1.0 + 0.1 * srandu(nrand, rng=rng))
        for i in range(nrand):
            while True:
                nuguess = self.nu * (1.0 + 0.1 * srandu(rng=rng))
                if self.NUMIN < nuguess < self.NUMAX:
                    break
            guess[i, 5] = nuguess
        for b, f in enumerate(self.fluxes):
            guess[:, 6 + b] = f * (1.0 + 0.1 * srandu(nrand, rng=rng))
        if self.prior is not None:
            _fix_guess(guess, self.prior)
        return _one_or_many(guess, nrand == 1)


# ----------------------------------------------------------------------
# EM / coellip psf guess tables (the reference's hard-coded starting
# decompositions; ref: guessers.py:1036-1052, 1226-1243)

_EM_PGUESS = {
    2: np.array([0.596510042804182, 0.4034898268889178]),
    3: np.array(
        [0.596510042804182, 0.4034898268889178, 1.303069003078001e-07]
    ),
    4: np.array(
        [0.596510042804182, 0.4034898268889178, 1.303069003078001e-07,
         1.0e-8]
    ),
    5: np.array(
        [0.59453032, 0.35671819, 0.03567182, 0.01189061, 0.00118906]
    ),
}
_EM_FGUESS = {
    2: np.array([0.5793612389470884, 1.621860687127999]),
    3: np.array(
        [0.5793612389470884, 1.621860687127999, 7.019347162356363]
    ),
    4: np.array(
        [0.5793612389470884, 1.621860687127999, 7.019347162356363, 16.0]
    ),
    5: np.array([0.5, 1.0, 3.0, 10.0, 20.0]),
}
_MOFFAT_PGUESS = {
    2: np.array([0.5, 0.5]),
    3: np.array([0.27559669, 0.55817131, 0.166232]),
    4: np.array([0.44534, 0.366951, 0.10506, 0.0826497]),
    5: np.array(
        [0.57874897, 0.32273483, 0.03327272, 0.0341253, 0.03111819]
    ),
}
_MOFFAT_FGUESS = {
    2: np.array([0.48955064, 1.50658978]),
    3: np.array([0.36123609, 0.8426139, 2.58747785]),
    4: np.array([0.541019, 1.19701, 0.282176, 3.51086]),
    5: np.array(
        [0.27831284, 0.9959897, 5.86989779, 5.63590429, 4.17285878]
    ),
}

# module-level aliases kept for parity with the reference namespace
_em2_pguess, _em3_pguess = _EM_PGUESS[2], _EM_PGUESS[3]
_em4_pguess, _em5_pguess = _EM_PGUESS[4], _EM_PGUESS[5]
_em2_fguess, _em3_fguess = _EM_FGUESS[2], _EM_FGUESS[3]
_em4_fguess, _em5_fguess = _EM_FGUESS[4], _EM_FGUESS[5]
_moffat2_pguess, _moffat3_pguess = _MOFFAT_PGUESS[2], _MOFFAT_PGUESS[3]
_moffat4_pguess, _moffat5_pguess = _MOFFAT_PGUESS[4], _MOFFAT_PGUESS[5]
_moffat2_fguess, _moffat3_fguess = _MOFFAT_FGUESS[2], _MOFFAT_FGUESS[3]
_moffat4_fguess, _moffat5_fguess = _MOFFAT_FGUESS[4], _MOFFAT_FGUESS[5]


class GMixPSFGuesser(object):
    """full mixture guess for psf fits, for EM and admom
    (ref: guessers.py:767-1033)"""

    def __init__(self, rng, ngauss, guess_from_moms=False):
        self.rng = rng
        self.ngauss = ngauss
        self.guess_from_moms = guess_from_moms
        if ngauss not in (1, 2, 3, 4, 5):
            raise ValueError("bad ngauss: %d" % ngauss)

    def __call__(self, obs):
        return self._get_guess(obs=obs)

    def _get_guess(self, obs):
        T, flux = self._get_T_flux(obs=obs)
        return self._make_gmix_guess(flux=flux, T=T)

    def _make_guess_array(self):
        """npars-length parameter array with jittered center and shape
        (shared by the Simple/Coellip psf guessers, which set npars)"""
        rng = self.rng
        guess = np.zeros(self.npars)
        guess[0:2] = rng.uniform(low=-0.01, high=0.01, size=2)
        guess[2:4] = rng.uniform(low=-0.05, high=0.05, size=2)
        return guess

    def _get_T_flux(self, obs):
        if self.guess_from_moms:
            return self._get_T_flux_from_moms(obs=obs)
        return self._get_T_flux_default(obs=obs)

    def _get_T_flux_default(self, obs):
        """fallback scales: a 3.5-pixel-fwhm size and the plain pixel
        sum as the flux"""
        T = float(moments.fwhm_to_T(3.5 * obs.jacobian.scale))
        return T, float(obs.image.sum())

    def _get_T_flux_from_moms(self, obs):
        """weighted-moments T/flux with the gaussian weight deweighted
        out of the size (same math as ref guessers.py:845-880); falls
        back to the default scales when the moments fail or resolve
        below one pixel"""
        from .moments import result_to_host

        scale = obs.jacobian.scale
        Tw = float(moments.fwhm_to_T(3.5 * scale))
        weight = GMixModel([0.0, 0.0, 0.0, 0.0, Tw, 1.0], "gauss")
        res = result_to_host(
            weight.get_weighted_moments(obs=obs, maxrad=1.0e9)
        )
        if int(res["flags"]) != 0:
            return self._get_T_flux_default(obs=obs)
        Tmeas = float(res["T"])
        if float(moments.T_to_fwhm(Tmeas)) < scale:
            return self._get_T_flux_default(obs=obs)

        # invert the size convolution with the round weight; when the
        # inversion overshoots (weight smaller than measured), keep the
        # raw measurement instead
        Tdew = 1.0 / (1.0 / Tmeas - 1.0 / Tw)
        if Tdew < 0:
            return Tmeas, float(res["flux"])
        return Tdew, float(res["flux"]) * np.pi * (Tw + Tdew) / scale**2

    def _make_gmix_guess(self, flux, T):
        rng = self.rng
        sigma2 = T / 2
        n = self.ngauss

        if n == 1:
            pars = np.array([
                _about(rng, flux, 0.1),
                rng.uniform(low=-0.1, high=0.1),
                rng.uniform(low=-0.1, high=0.1),
                _about(rng, sigma2, 0.1),
                rng.uniform(low=-0.2 * sigma2, high=0.2 * sigma2),
                _about(rng, sigma2, 0.1),
            ])
            return GMix(pars=pars)

        pguess = _EM_PGUESS[n]
        fguess = _EM_FGUESS[n]
        pars = []
        for i in range(n):
            if n == 2:
                # the 2-gauss case has no p jitter and zero irc
                # (ref: guessers.py:900-920)
                p = pguess[i] * flux
                irc = 0.0
            else:
                p = _about(rng, flux * pguess[i], 0.1)
                irc = rng.uniform(low=-0.01, high=0.01)
            pars += [
                p,
                rng.uniform(low=-0.1, high=0.1),
                rng.uniform(low=-0.1, high=0.1),
                _about(rng, fguess[i] * sigma2, 0.1),
                irc,
                _about(rng, fguess[i] * sigma2, 0.1),
            ]
        return GMix(pars=np.array(pars))


class SimplePSFGuesser(GMixPSFGuesser):
    """simple-model psf guesses (ref: guessers.py:1055-1103)"""

    def __init__(self, rng, guess_from_moms=False):
        self.rng = rng
        self.guess_from_moms = guess_from_moms
        self.npars = 6

    def __call__(self, obs):
        return self._get_guess(obs=obs)

    def _get_guess(self, obs):
        T, flux = self._get_T_flux(obs=obs)
        guess = self._make_guess_array()
        guess[4] = _about(self.rng, T, 0.1)
        guess[5] = _about(self.rng, flux, 0.1)
        return guess


class CoellipPSFGuesser(GMixPSFGuesser):
    """coellip psf guesses (ref: guessers.py:1106-1223)"""

    def __init__(self, rng, ngauss, guess_from_moms=False):
        super().__init__(
            rng=rng, ngauss=ngauss, guess_from_moms=guess_from_moms
        )
        self.npars = get_coellip_npars(ngauss)

    def __call__(self, obs):
        return self._get_guess(obs=obs)

    def _get_guess(self, obs):
        T, flux = self._get_T_flux(obs=obs)
        rng = self.rng
        n = self.ngauss
        guess = self._make_guess_array()
        if n == 1:
            guess[4] = _about(rng, T, 0.1)
            guess[5] = _about(rng, flux, 0.1)
            return guess
        pguess = _MOFFAT_PGUESS[n]
        fguess = _MOFFAT_FGUESS[n]
        for i in range(n):
            guess[4 + i] = _about(rng, T * fguess[i], 0.01)
            guess[4 + n + i] = _about(rng, flux * pguess[i], 0.01)
        return guess


# ----------------------------------------------------------------------
# guess fix-up against a prior

def _resample_bad_rows(guess, prior, ntry, tail_only):
    """replace guess rows the prior rejects (lnprob <= LOWVAL or out
    of range) with fresh prior samples; tail_only keeps the sampled
    cen/shape and swaps in only the size/flux tail
    (ref: guessers.py:1245-1299; note the reference's TFlux variant
    never takes its whole-row branch - itry < ntry always holds - so
    tail_only always swaps the tail)"""
    for row in guess:
        for _ in range(ntry):
            try:
                ok = prior.get_lnprob_scalar(row) > LOWVAL
            except GMixRangeError:
                ok = False
            if ok:
                break
            print_pars(row, front="bad guess:", logger=LOGGER)
            fresh = prior.sample()
            if tail_only:
                row[4:] = fresh[4:]
            else:
                row[:] = fresh


def _fix_guess(guess, prior, ntry=4):
    _resample_bad_rows(guess, prior, ntry, tail_only=False)


def _fix_guess_TFlux(guess, prior, ntry=4):
    _resample_bad_rows(guess, prior, ntry, tail_only=True)
