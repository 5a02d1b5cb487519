"""Expectation-maximization image decomposition, batched over lanes.

The port of ``ngmix_tpu/em.py``: each iteration convolves the pre-psf
mixture with the psf, evaluates every convolved gaussian on every
pixel (E-step, with the hard chi2 cut of the reference EM), and
re-estimates fluxes, centers and sizes from the responsibilities
(M-step, the psf moments subtracted). The four modes (free, fixcen,
fixcov, fluxonly) share one body.

The JAX package runs one lane as a ``lax.while_loop`` and batches it
with vmap. Here one host loop steps every lane at once: a lane that is
active (not done and under maxiter) takes the new state, the others
keep theirs through ``torch.where`` on every field, and the loop reads
the count of active lanes from the device once per iteration, as
admom.admom_raw does. A lane's result does not depend on its batch.

The host API (``prep_obs``, ``EMResult``, ``EMFitter`` with
``EMFitterFixCen``, ``EMFitterFixCov`` and ``EMFitterFluxOnly``,
``run_em``, and ``em_fit``) fits one observation as one lane of the
same loop on the observation's device.
"""
import logging
from typing import NamedTuple

import numpy as np
import torch

from . import flags as nf
from .defaults import FASTEXP_MAX_CHI2, GMIX_LOW_DETVAL
from .gmix import core as gcore
from .gmix.gmix import GMix, GMixModel
from .observation import Observation
from .pixels import Pixels
from .util import resolve_device

logger = logging.getLogger(__name__)

DEFAULT_TOL = 1.0e-5
DEFAULT_MINITER = 40
DEFAULT_MAXITER = 500

_MODES = ("free", "fixcen", "fixcov", "fluxonly")


class EMConf(NamedTuple):
    """EM configuration: the mode (free, fixcen, fixcov or fluxonly),
    the least and most iterations, the convergence tolerance on the
    log likelihood (fluxonly: on the total flux), whether the sky level
    is re-estimated, and whether zero-weight pixels are filled with the
    model"""

    mode: str = "free"
    miniter: int = DEFAULT_MINITER
    maxiter: int = DEFAULT_MAXITER
    tol: float = DEFAULT_TOL
    vary_sky: bool = False
    fill_zero_weight: bool = False


def _conv_and_norms(gmix, gmix_psf):
    """convolved mixture and its evaluation terms: (gmix_conv, dcc,
    drr, drc, pnorm, logtau, logdet), the last six [..., n m]"""
    gmix_conv = gcore.gmix_convolve(gmix, gmix_psf)
    det = gcore.gmix_det(gmix_conv)
    det_safe = torch.where(det > 0, det, 1.0)
    idet = 1.0 / det_safe
    drr = gmix_conv[..., gcore.G_IRR] * idet
    drc = gmix_conv[..., gcore.G_IRC] * idet
    dcc = gmix_conv[..., gcore.G_ICC] * idet
    p = gmix_conv[..., gcore.G_P]
    pnorm = torch.where(det > 0, p / (2 * np.pi * torch.sqrt(det_safe)), 0.0)
    logtau = torch.log(torch.where(p > 0, p, 1.0))
    logdet = torch.log(det_safe)
    return gmix_conv, dcc, drr, drc, pnorm, logtau, logdet


def _psf_moms(gmix_psf):
    """total (irr, irc, icc) [...] of the psf about its center"""
    row, col, psum = gcore.gmix_get_cen(gmix_psf)
    p = gmix_psf[..., gcore.G_P]
    rd = gmix_psf[..., gcore.G_ROW] - row[..., None]
    cd = gmix_psf[..., gcore.G_COL] - col[..., None]
    psum_safe = torch.where(psum == 0, 1.0, psum)
    irr = torch.sum(p * (gmix_psf[..., gcore.G_IRR] + rd * rd), dim=-1) / psum_safe
    irc = torch.sum(p * (gmix_psf[..., gcore.G_IRC] + rd * cd), dim=-1) / psum_safe
    icc = torch.sum(p * (gmix_psf[..., gcore.G_ICC] + cd * cd), dim=-1) / psum_safe
    return irr, irc, icc


def _dot(a, b):
    """sum over pixels of a [B, n, P] times b [B, P] -> [B, n]"""
    return torch.sum(a * b[:, None, :], dim=-1)


def _step(s, pixels, gmix_psf, mask, include, finclude, npix_f, psf_moms, conf):
    """one EM iteration of every lane; returns the new state of every
    lane (the caller keeps the old state of inactive lanes)"""
    gmix, sky = s["gmix"], s["sky"]
    B, n = gmix.shape[:2]
    m = gmix_psf.shape[1]
    zero = torch.zeros_like(s["flags"])

    gmix_conv, dcc, drr, drc, pnorm, logtau, logdet = _conv_and_norms(gmix, gmix_psf)

    # per conv-gaussian evaluation [B, n m, P] with the hard chi2 cut
    vd = pixels.v[:, None, :] - gmix_conv[..., gcore.G_ROW, None]
    ud = pixels.u[:, None, :] - gmix_conv[..., gcore.G_COL, None]
    v2 = vd * vd
    u2 = ud * ud
    uv = vd * ud
    chi2 = dcc[..., None] * v2 + drr[..., None] * u2 - 2.0 * drc[..., None] * uv
    inrange = (chi2 < FASTEXP_MAX_CHI2) & (chi2 >= 0.0)
    gval = torch.where(
        inrange,
        pnorm[..., None] * torch.exp(-0.5 * torch.clamp(chi2, 0.0, FASTEXP_MAX_CHI2))
        * pixels.area[:, None, :],
        0.0,
    )

    # model-fill zero weight pixels
    if conf.fill_zero_weight:
        model = torch.sum(gval, dim=1)
        val = torch.where(mask, pixels.val, sky[:, None] + model)
    else:
        val = pixels.val

    # group the psf components per object gaussian
    gval_g = gval.reshape(B, n, m, -1)
    gi = torch.sum(gval_g, dim=2) * finclude[:, None, :]  # [B, n, P]
    gsum = torch.sum(gi, dim=1)  # [B, P]
    gtot = gsum + sky[:, None]
    bad_gtot = torch.any(include & (gtot == 0.0), dim=-1)
    gtot_safe = torch.where(gtot == 0.0, 1.0, gtot)

    # E-step log likelihood
    logterm = logtau - 0.5 * logdet
    per_px_L = torch.sum(gval * (logterm[..., None] - 0.5 * chi2) * inrange, dim=1)
    gsum_safe = torch.where(gsum == 0.0, 1.0, gsum)
    elogL = torch.sum(
        torch.where(gsum == 0.0, 0.0, per_px_L / gsum_safe) * finclude, dim=-1
    )

    factor = val / gtot_safe * finclude  # [B, P]

    pnew = _dot(gi, factor)  # [B, n]
    p_safe = torch.where(pnew == 0, 1.0, pnew)
    pinv = 1.0 / p_safe

    if conf.mode in ("free", "fixcov"):
        newv = _dot(gi, pixels.v * factor) * pinv
        newu = _dot(gi, pixels.u * factor) * pinv
    else:
        newv = gmix[..., gcore.G_ROW]
        newu = gmix[..., gcore.G_COL]

    if conf.mode in ("free", "fixcen"):
        psf_irr, psf_irc, psf_icc = psf_moms
        tv2 = torch.sum(v2.reshape(B, n, m, -1) * gval_g, dim=2)
        tuv = torch.sum(uv.reshape(B, n, m, -1) * gval_g, dim=2)
        tu2 = torch.sum(u2.reshape(B, n, m, -1) * gval_g, dim=2)
        fi = finclude[:, None, :]
        irr = _dot(tv2 * fi, factor) * pinv - psf_irr[:, None]
        irc = _dot(tuv * fi, factor) * pinv - psf_irc[:, None]
        icc = _dot(tu2 * fi, factor) * pinv - psf_icc[:, None]

        # force positive sizes
        minval = 1.0e-4
        neg = (irr < 0.0) | (icc < 0.0)
        irr = torch.where(neg, minval, irr)
        irc = torch.where(neg, 0.0, irc)
        icc = torch.where(neg, minval, icc)
        det = irr * icc - irc**2
        low = det < GMIX_LOW_DETVAL
        Thalf = 0.5 * (irr + icc)
        irr = torch.where(low, Thalf, irr)
        icc = torch.where(low, Thalf, icc)
        irc = torch.where(low, 0.0, irc)
    else:
        irr = gmix[..., gcore.G_IRR]
        irc = gmix[..., gcore.G_IRC]
        icc = gmix[..., gcore.G_ICC]

    new_gmix = torch.stack([pnew, newv, newu, irr, irc, icc], dim=-1)

    if conf.vary_sky:
        skysum = torch.sum(sky[:, None] * val / gtot_safe * finclude, dim=-1)
        new_sky = skysum / torch.where(npix_f == 0, 1.0, npix_f)
    else:
        new_sky = sky

    numiter = s["numiter"] + 1

    if conf.mode == "fluxonly":
        # convergence on the total flux
        stat = torch.sum(pnew, dim=-1)
        last = s["elogL_last"]
        fdiff = torch.abs(stat / torch.where(last == 0, 1.0, last) - 1.0)
        bad_stat = torch.zeros_like(bad_gtot)
    else:
        stat = elogL
        bad_stat = (numiter >= conf.miniter) & (elogL == 0.0)
        elogL_safe = torch.where(elogL == 0.0, 1.0, elogL)
        fdiff = torch.abs((elogL - s["elogL_last"]) / elogL_safe)

    converged = (numiter >= conf.miniter) & (fdiff < conf.tol)
    flags = torch.where(bad_gtot | bad_stat, nf.EM_RANGE_ERROR, zero)

    return {
        "gmix": new_gmix,
        "sky": new_sky,
        "elogL_last": stat,
        "fdiff": fdiff,
        "numiter": numiter,
        "flags": s["flags"] | flags,
        "done": converged | (flags != 0),
    }


def _active(s, conf):
    return (~s["done"]) & (s["numiter"] < conf.maxiter)


def em_raw(pixels, gmix0, gmix_psf, sky, conf: EMConf):
    """run EM on every lane of tensors on one device: pixels fields
    [B, P], gmix0 [B, n, 6] pre-psf guesses, gmix_psf [B, m, 6], sky
    [B] (the images must be non-negative after adding it, see
    prep_image). Returns dict gmix (pre-psf), gmix_conv, numiter,
    fdiff, sky and flags"""
    if conf.mode not in _MODES:
        raise ValueError("EM mode must be one of %s, got %r" % (_MODES, conf.mode))
    dtype, dev = pixels.val.dtype, pixels.val.device
    B = pixels.val.shape[0]
    mask = pixels.ierr > 0
    include = torch.ones_like(mask) if conf.fill_zero_weight else mask
    finclude = include.to(dtype)
    npix_f = torch.sum(finclude, dim=-1)
    psf_moms = _psf_moms(gmix_psf)

    s = {
        "gmix": gmix0.to(dtype),
        "sky": sky.to(dtype),
        "elogL_last": torch.full((B,), -9999.9e9, dtype=dtype, device=dev),
        "fdiff": torch.full((B,), torch.inf, dtype=dtype, device=dev),
        "numiter": torch.zeros(B, dtype=torch.int32, device=dev),
        "flags": torch.zeros(B, dtype=torch.int32, device=dev),
        "done": torch.zeros(B, dtype=torch.bool, device=dev),
    }
    for _ in range(conf.maxiter):
        active = _active(s, conf)
        # the loop's one read from the device per iteration
        if int(torch.count_nonzero(active)) == 0:
            break
        new = _step(s, pixels, gmix_psf, mask, include, finclude, npix_f, psf_moms, conf)
        s = {
            k: torch.where(active.view((B,) + (1,) * (v.dim() - 1)), v, s[k])
            for k, v in new.items()
        }

    mi = torch.full_like(s["flags"], nf.EM_MAXITER)
    flags = s["flags"] | torch.where(s["numiter"] >= conf.maxiter, mi, 0)
    return {
        "gmix": s["gmix"],
        "gmix_conv": gcore.gmix_convolve(s["gmix"], gmix_psf),
        "numiter": s["numiter"],
        "fdiff": s["fdiff"],
        "sky": s["sky"],
        "flags": flags,
    }


def em_batch(pixels, gmix0, gmix_psf, sky, conf: EMConf, device=None):
    """EM over a [B] batch of stamps: pixels a Pixels or a (v, u, area,
    val, ierr) tuple of [B, P] fields, gmix0 [B, n, 6], gmix_psf
    [B, m, 6], sky [B], as numpy arrays or tensors. Runs on the CUDA
    card unless the caller passes device="cpu"; the real dtype of
    pixels.val is kept. Returns em_raw's dict."""
    dev = resolve_device(device)
    pixels = Pixels(*pixels)
    dtype = torch.as_tensor(pixels.val).dtype
    pixels = Pixels(*(torch.as_tensor(x, dtype=dtype, device=dev) for x in pixels))
    gmix0, gmix_psf, sky = (
        torch.as_tensor(x, dtype=dtype, device=dev) for x in (gmix0, gmix_psf, sky)
    )
    return em_raw(pixels, gmix0, gmix_psf, torch.broadcast_to(sky, gmix0.shape[:1]), conf)


def prep_image(images):
    """shift the sky of [..., H, W] stamps so that no pixel of a stamp
    is below 0.001 times its range; returns (shifted images, the shift
    [...] added to each)"""
    im_min = torch.amin(images, dim=(-2, -1))
    im_max = torch.amax(images, dim=(-2, -1))
    sky = 0.001 * (im_max - im_min) - im_min
    return images + sky[..., None, None], sky


def em_fit(pixels, gmix0, gmix_psf, sky, conf: EMConf):
    """EM of one stamp, one lane of em_raw on the pixels' device:
    pixels fields [P] tensors, gmix0 [n, 6], gmix_psf [m, 6], sky a
    number; returns em_raw's dict for the stamp"""
    dtype, dev = pixels.val.dtype, pixels.val.device
    out = em_raw(
        Pixels(*(x[None] for x in pixels)),
        torch.as_tensor(gmix0, dtype=dtype, device=dev)[None],
        torch.as_tensor(gmix_psf, dtype=dtype, device=dev)[None],
        torch.as_tensor(sky, dtype=dtype, device=dev).reshape(1),
        conf,
    )
    return {k: v[0] for k, v in out.items()}


# ----------------------------------------------------------------------
# host API

def prep_obs(obs):
    """a copy of obs with its sky shifted by prep_image, and the shift"""
    imsky, sky = prep_image(torch.tensor(obs.image))
    newobs = obs.copy()
    with newobs.writeable():
        newobs.image[:, :] = imsky.numpy()
    return newobs, float(sky)


class EMResult(dict):
    """EM fit result of one observation, with the fitted pre-psf and
    convolved mixtures"""

    def __init__(self, obs, result, gm=None, gm_conv=None):
        self._obs = obs
        self.update(result)
        if gm is not None and gm_conv is not None:
            self._gm = gm
            self._gm_conv = gm_conv

    def has_gmix(self):
        return hasattr(self, "_gm")

    def get_gmix(self):
        if not self.has_gmix():
            raise RuntimeError("no gmix set")
        return self._gm.copy()

    def get_convolved_gmix(self):
        if not self.has_gmix():
            raise RuntimeError("no gmix set")
        return self._gm_conv.copy()

    def make_image(self):
        """the convolved mixture rendered through K2 on the
        observation's device"""
        gm = self.get_convolved_gmix()
        return gm.make_image(
            self._obs.image.shape, jacobian=self._obs.jacobian, device=self._obs.device
        )


class EMFitter(object):
    """EM fitter of one observation; go(obs, guess, sky=None) takes a
    pre-psf GMix guess and, without sky, shifts the image by
    prep_obs"""

    mode = "free"

    def __init__(self, miniter=DEFAULT_MINITER, maxiter=DEFAULT_MAXITER,
                 tol=DEFAULT_TOL, vary_sky=False):
        self.miniter = miniter
        self.maxiter = maxiter
        self.tol = tol
        self.vary_sky = vary_sky

    def go(self, obs, guess, sky=None):
        if not isinstance(obs, Observation):
            raise ValueError("input obs must be an instance of Observation")

        if sky is None:
            obs_sky, sky = prep_obs(obs)
        else:
            obs_sky = obs

        if not obs_sky.has_psf() or not obs_sky.psf.has_gmix():
            logger.debug("NO PSF SET")
            gmix_psf = GMixModel([0.0, 0.0, 0.0, 0.0, 0.0, 1.0], "gauss")
        else:
            gmix_psf = obs_sky.psf.gmix
            gmix_psf.set_flux(1.0)

        pixels = obs_sky.pixels
        fill_zero_weight = bool(torch.any(pixels.ierr <= 0.0))

        conf = EMConf(
            mode=self.mode, miniter=self.miniter, maxiter=self.maxiter,
            tol=self.tol, vary_sky=self.vary_sky,
            fill_zero_weight=fill_zero_weight,
        )

        out = em_fit(pixels, guess.get_data(), gmix_psf.get_data(), sky, conf)

        flags = int(out["flags"])
        if flags & nf.EM_RANGE_ERROR:
            result = {
                "flags": nf.EM_RANGE_ERROR,
                "message": "gtot == 0 or elogL == 0",
            }
            gm = gm_conv = None
        else:
            gm = GMix(pars=out["gmix"].cpu().numpy().ravel())
            gm_conv = GMix(pars=out["gmix_conv"].cpu().numpy().ravel())
            result = {
                "flags": flags,
                "numiter": int(out["numiter"]),
                "fdiff": float(out["fdiff"]),
                "sky": float(out["sky"]),
                "message": "maxit" if flags & nf.EM_MAXITER else "OK",
            }

        return EMResult(obs=obs, result=result, gm=gm, gm_conv=gm_conv)


class EMFitterFixCen(EMFitter):
    mode = "fixcen"


class EMFitterFixCov(EMFitter):
    mode = "fixcov"


class EMFitterFluxOnly(EMFitter):
    mode = "fluxonly"

    def __init__(self, miniter=20, maxiter=DEFAULT_MAXITER, tol=DEFAULT_TOL,
                 vary_sky=False):
        super().__init__(
            miniter=miniter, maxiter=maxiter, tol=tol, vary_sky=vary_sky
        )


def run_em(obs, guess, sky=None, fixcen=False, fixcov=False, fluxonly=False,
           **kws):
    """fit the observation with EM"""
    if fixcen:
        fitter = EMFitterFixCen(**kws)
    elif fixcov:
        fitter = EMFitterFixCov(**kws)
    elif fluxonly:
        fitter = EMFitterFluxOnly(**kws)
    else:
        fitter = EMFitter(**kws)
    return fitter.go(obs=obs, guess=guess, sky=sky)


fit_em = run_em
