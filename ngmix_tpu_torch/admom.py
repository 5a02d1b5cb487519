"""Adaptive moments (admom), batched over lanes.

The port of ``ngmix_tpu/admom.py:25-466``. Each lane iterates {recenter
on the weighted centroid; accumulate the 7 weighted sums; test
convergence; deweight}; a failure sets flag bits and freezes the lane.
The JAX package runs one lane as a ``lax.while_loop`` and batches it
with vmap. Here one host loop steps every lane at once: a lane that is
active (not done and under maxiter) takes the new state, the others
keep theirs, and the loop reads the count of active lanes from the
device once per iteration and stops at zero or at maxiter. Frozen
lanes keep their whole state, as they do under vmap, so the results
are those of the per-lane loop.

The single-gaussian weight goes through K2 in fast (apodized) mode,
n = 1, with the pixels' area (``gmix.core._eval_batched``); the JAX
package evaluates it with the plain ``eval_gmix``, and routing it
through the kernel is this port's choice. On CPU tensors K2 is its
plain version, so the plain version of this module is the same loop on
the CPU.

The host API (``admom_fit``, ``AdmomResult``, ``AdmomFitter``,
``run_admom``, ``find_cen_admom``) runs one stamp as one lane of the
same loop on the observation's device, so on the card its weight goes
through K2 twice an iteration and once more for the covariance.
"""
from typing import NamedTuple

import numpy as np
import torch

from . import flags as nf
from .defaults import GMIX_LOW_DETVAL
from .gmix import core as gcore
from .gmix.gmix import GMix, GMixModel
from .moments import fwhm_to_T
from .observation import Observation
from .pixels import Pixels
from .shape import _t, e1e2_to_g1g2
from .util import get_ratio_error, resolve_device

DEFAULT_MAXITER = 200
DEFAULT_SHIFTMAX = 5.0  # pixels
DEFAULT_ETOL = 1.0e-5
DEFAULT_TTOL = 1.0e-3

_NSUMS = 7


class AdmomConf(NamedTuple):
    """admom configuration: iteration cap, largest centroid shift
    (pixels), convergence tolerances on e1/e2 and T, and whether to
    skip the deweighting (center only)"""

    maxiter: int = DEFAULT_MAXITER
    shiftmax: float = DEFAULT_SHIFTMAX
    etol: float = DEFAULT_ETOL
    Ttol: float = DEFAULT_TTOL
    cenonly: bool = False


def _eval_weight(wt6, pixels):
    """apodized single-gaussian weight [B, P] through K2; masked pixels
    (ierr == 0) get 0"""
    w = gcore._eval_batched(wt6[..., None, :], pixels, fast=True)
    return w * (pixels.ierr > 0)


def _censums(wt6, pixels):
    """sums for the weighted centroid"""
    wdata = _eval_weight(wt6, pixels) * pixels.val
    s0 = torch.sum(wdata * pixels.v, dim=-1)
    s1 = torch.sum(wdata * pixels.u, dim=-1)
    s5 = torch.sum(wdata, dim=-1)
    return s0, s1, s5


def _momsums(wt6, pixels, with_cov=True):
    """the 7 weighted sums, their 7x7 covariance (None without
    with_cov: the loop uses only the sums, and the covariance is taken
    once after it, at the weight of the final sums) and the weight sum"""
    w = _eval_weight(wt6, pixels)
    vcen, ucen = wt6[..., 1], wt6[..., 2]
    irr, irc, icc = wt6[..., 3], wt6[..., 4], wt6[..., 5]
    det = irr * icc - irc * irc
    det_safe = torch.where(det > 0, det, 1.0)
    dcc, drr, drc = icc / det_safe, irr / det_safe, irc / det_safe

    vmod = pixels.v - vcen[..., None]
    umod = pixels.u - ucen[..., None]
    chi2 = (
        dcc[..., None] * vmod * vmod
        + drr[..., None] * umod * umod
        - 2.0 * drc[..., None] * vmod * umod
    )
    feats = [
        pixels.v,
        pixels.u,
        umod * umod - vmod * vmod,
        2 * vmod * umod,
        umod * umod + vmod * vmod,
        torch.ones_like(vmod),
        chi2 * chi2,
    ]
    wdata = w * pixels.val
    wsum = torch.sum(w, dim=-1)
    w2var = None
    if with_cov:
        ierr_safe = torch.where(pixels.ierr > 0, pixels.ierr, 1.0)
        var = 1.0 / (ierr_safe * ierr_safe)
        w2var = w * w * var
    sums, sums_cov = gcore.weighted_feature_reductions(wdata, feats, cov_weight=w2var)
    return sums, sums_cov, wsum


def _deweight(wt6, Irr, Irc, Icc):
    """inverse-covariance subtraction N^-1 = M^-1 - W^-1 of each lane.
    Returns (new wt6, int32 flags): LOW_DET, and the weight unchanged,
    where a determinant is at or below the floor."""
    detm = Irr * Icc - Irc * Irc
    Wrr, Wrc, Wcc = wt6[..., 3], wt6[..., 4], wt6[..., 5]
    detw = Wrr * Wcc - Wrc * Wrc

    bad = (detm <= GMIX_LOW_DETVAL) | (detw <= GMIX_LOW_DETVAL)
    idetm = 1.0 / torch.where(bad, 1.0, detm)
    idetw = 1.0 / torch.where(bad, 1.0, detw)

    Nrr = Icc * idetm - Wcc * idetw
    Ncc = Irr * idetm - Wrr * idetw
    Nrc = -Irc * idetm + Wrc * idetw
    detn = Nrr * Ncc - Nrc * Nrc
    bad = bad | (detn <= GMIX_LOW_DETVAL)
    idetn = 1.0 / torch.where(bad, 1.0, detn)

    new = torch.cat(
        [wt6[..., :3], torch.stack([Ncc * idetn, -Nrc * idetn, Nrr * idetn], dim=-1)],
        dim=-1,
    )
    new = torch.where(bad[..., None], wt6, new)
    zero = torch.zeros(bad.shape, dtype=torch.int32, device=bad.device)
    return new, torch.where(bad, nf.LOW_DET, zero)


def _step(s, pixels, roworig, colorig, conf):
    """one admom iteration of every lane; returns the new state of every
    lane (the caller keeps the old state of inactive lanes)"""
    wt = s["wt"]
    zero = torch.zeros_like(s["flags"])

    det = wt[:, 3] * wt[:, 5] - wt[:, 4] * wt[:, 4]
    low_det = det < GMIX_LOW_DETVAL
    flags = torch.where(low_det, nf.LOW_DET, zero)

    # center update
    s0, s1, s5 = _censums(wt, pixels)
    nonpos_flux1 = (~low_det) & (s5 <= 0.0)
    flags = flags | torch.where(nonpos_flux1, nf.NONPOS_FLUX, zero)
    s5_safe = torch.where(s5 == 0, 1.0, s5)
    keep = low_det | nonpos_flux1
    newrow = torch.where(keep, wt[:, 1], s0 / s5_safe)
    newcol = torch.where(keep, wt[:, 2], s1 / s5_safe)
    wt = torch.cat([wt[:, :1], newrow[:, None], newcol[:, None], wt[:, 3:]], dim=-1)

    cen_shift = (
        (torch.abs(newrow - roworig) > conf.shiftmax)
        | (torch.abs(newcol - colorig) > conf.shiftmax)
    ) & (flags == 0)
    flags = flags | torch.where(cen_shift, nf.CEN_SHIFT, zero)

    # moment sums at the center-updated weight (the covariance waits
    # for the end of the loop)
    sums, _, wsum = _momsums(wt, pixels, with_cov=False)
    wt_meas = wt
    nonpos_flux2 = (flags == 0) & (sums[:, 5] <= 0.0)
    flags = flags | torch.where(nonpos_flux2, nf.NONPOS_FLUX, zero)

    finv = 1.0 / torch.where(sums[:, 5] == 0, 1.0, sums[:, 5])
    M1 = sums[:, 2] * finv
    M2 = sums[:, 3] * finv
    T = sums[:, 4] * finv
    Irr = 0.5 * (T - M1)
    Icc = 0.5 * (T + M1)
    Irc = 0.5 * M2

    nonpos_size = (flags == 0) & (T <= 0.0)
    flags = flags | torch.where(nonpos_size, nf.NONPOS_SIZE, zero)

    T_safe = torch.where(T == 0, 1.0, T)
    e1 = (Icc - Irr) / T_safe
    e2 = 2 * Irc / T_safe

    # the first iteration never converges: the old values start as NaN
    converged = (
        (flags == 0)
        & (torch.abs(e1 - s["e1old"]) < conf.etol)
        & (torch.abs(e2 - s["e2old"]) < conf.etol)
        & (torch.abs(T / torch.where(s["Told"] == 0, 1.0, s["Told"]) - 1.0) < conf.Ttol)
    )

    pars = torch.stack(
        [wt[:, 1], wt[:, 2], wt[:, 5] - wt[:, 3], 2.0 * wt[:, 4], wt[:, 5] + wt[:, 3],
         torch.ones_like(T)],
        dim=-1,
    )
    rho4 = sums[:, 6] * finv

    # deweight for the next iteration, skipped once converged or failed;
    # its flags count only where the lane iterates on
    if conf.cenonly:
        wt_next, dw_flags = wt, zero
    else:
        wt_next, dw_flags = _deweight(wt, Irr, Irc, Icc)
    do_iterate = (flags == 0) & (~converged)
    flags = flags | torch.where(do_iterate, dw_flags, zero)
    wt = torch.where(do_iterate[:, None], wt_next, wt)

    return {
        "wt": wt,
        "wt_meas": wt_meas,
        "e1old": torch.where(do_iterate, e1, s["e1old"]),
        "e2old": torch.where(do_iterate, e2, s["e2old"]),
        "Told": torch.where(do_iterate, T, s["Told"]),
        "flags": s["flags"] | flags,
        "numiter": s["numiter"] + 1,
        "done": (flags != 0) | converged,
        "sums": sums,
        "wsum": wsum,
        # set only on the iteration that converges
        "pars": torch.where(converged[:, None], pars, s["pars"]),
        "rho4": torch.where(converged, rho4, s["rho4"]),
    }


def _active(s, conf):
    return (~s["done"]) & (s["numiter"] < conf.maxiter)


def admom_raw(pixels, wt0, conf: AdmomConf):
    """run adaptive moments on every lane: pixels fields [B, P], wt0
    [B, 6] single-gaussian guesses (p, row, col, irr, irc, icc).
    Returns the dict of raw results (flags, numiter, sums, sums_cov,
    wsum, pars, rho4, wgt_norm, wt) that admom_result takes."""
    dtype, dev = pixels.val.dtype, pixels.val.device
    B = pixels.val.shape[0]
    wt0 = wt0.to(dtype)
    nan = torch.full((B,), torch.nan, dtype=dtype, device=dev)
    s = {
        "wt": wt0,
        # the weight the final sums were measured with (center updated,
        # before the deweight): the covariance is taken there
        "wt_meas": wt0,
        "e1old": nan,
        "e2old": nan,
        "Told": nan,
        "flags": torch.zeros(B, dtype=torch.int32, device=dev),
        "numiter": torch.zeros(B, dtype=torch.int32, device=dev),
        "done": torch.zeros(B, dtype=torch.bool, device=dev),
        "sums": torch.zeros((B, _NSUMS), dtype=dtype, device=dev),
        "wsum": torch.zeros(B, dtype=dtype, device=dev),
        "pars": torch.full((B, 6), torch.nan, dtype=dtype, device=dev),
        "rho4": nan,
    }
    roworig, colorig = wt0[:, 1], wt0[:, 2]
    for _ in range(conf.maxiter):
        active = _active(s, conf)
        # the loop's one read from the device per iteration
        if int(torch.count_nonzero(active)) == 0:
            break
        new = _step(s, pixels, roworig, colorig, conf)
        s = {
            k: torch.where(active.view((B,) + (1,) * (v.dim() - 1)), v, s[k])
            for k, v in new.items()
        }

    # parity with the reference: reaching maxiter replaces the flags
    # with MAXITER, even over a final-iteration convergence
    mi = torch.full_like(s["flags"], nf.MAXITER)
    flags = torch.where(s["numiter"] >= conf.maxiter, mi, s["flags"])

    wt = s["wt"]
    det = wt[:, 3] * wt[:, 5] - wt[:, 4] * wt[:, 4]
    wgt_norm = 1.0 / (2 * np.pi * torch.sqrt(torch.where(det > 0, det, 1.0)))
    _, sums_cov, _ = _momsums(s["wt_meas"], pixels)
    return {
        "flags": flags,
        "numiter": s["numiter"],
        "sums": s["sums"],
        "sums_cov": sums_cov,
        "wsum": s["wsum"],
        "pars": s["pars"],
        "rho4": s["rho4"],
        "wgt_norm": wgt_norm,
        "wt": wt,
    }


def admom_single(pixels, wt0, conf: AdmomConf):
    """adaptive moments of one stamp: admom_raw on one lane. pixels:
    Pixels of [P] fields (tensors on one device), wt0 [6]; returns
    admom_raw's dict of that lane"""
    raw = admom_raw(Pixels(*(x[None] for x in pixels)), wt0[None], conf)
    return {k: v[0] for k, v in raw.items()}


def admom_result(raw, jac_area):
    """raw admom output -> the full result dict, batched: flux, T, rho4
    and shapes with their errors and flags; failures are NaN values and
    flag bits"""
    flags = raw["flags"]
    sums = raw["sums"]
    cov = raw["sums_cov"]
    wsum = raw["wsum"]
    pars = raw["pars"]
    ok = flags == 0
    nan = torch.nan
    izero = torch.zeros_like(flags)

    T = torch.where(ok, pars[..., 4], nan)
    rho4 = torch.where(ok, raw["rho4"], nan)
    wsum_safe = torch.where(wsum == 0, 1.0, wsum)
    flux_mean = torch.where(ok, sums[..., 5] / wsum_safe, nan)
    pars = torch.cat(
        [pars[..., :5], torch.where(ok, flux_mean, pars[..., 5])[..., None]], dim=-1
    )

    res = {
        "flags": flags,
        "numiter": raw["numiter"],
        "sums": sums,
        "sums_cov": cov,
        "wsum": wsum,
        "sums_norm": wsum,
        "pars": pars,
        "T": T,
        "rho4": rho4,
        "flux_mean": flux_mean,
    }

    # flux: fnorm = area * wgt_norm * wsum
    T_ok = T > GMIX_LOW_DETVAL
    fnorm = torch.as_tensor(jac_area, dtype=sums.dtype, device=sums.device) * \
        raw["wgt_norm"] * wsum_safe
    flux = torch.where(ok & T_ok, sums[..., 5] / fnorm, nan)
    var55 = cov[..., 5, 5]
    flux_err = torch.where(ok & T_ok & (var55 > 0), torch.sqrt(torch.abs(var55)) / fnorm, nan)
    s2n = flux / flux_err
    res["flux"] = flux
    res["flux_err"] = flux_err
    res["s2n"] = torch.where(torch.isfinite(s2n), s2n, nan)
    res["flux_flags"] = torch.where(
        ok,
        torch.where(T_ok, torch.where(var55 > 0, izero, nf.NONPOS_VAR), nf.NONPOS_SIZE),
        flags,
    )

    # T error (a factor ~4 from the weight)
    var44 = cov[..., 4, 4]
    fsum_pos = sums[..., 5] > 0
    fsum_safe = torch.where(fsum_pos, sums[..., 5], 1.0)
    var_ok = (var44 > 0) & (var55 > 0)
    T_err = 4 * get_ratio_error(sums[..., 4], fsum_safe, var44, var55, cov[..., 4, 5])
    res["T_err"] = torch.where(ok & var_ok & fsum_pos, T_err, nan)
    res["T_flags"] = torch.where(
        ok,
        torch.where(var_ok, torch.where(fsum_pos, izero, nf.NONPOS_FLUX), nf.NONPOS_VAR),
        flags,
    )

    # rho4
    var66 = cov[..., 6, 6]
    rho4_var_ok = (var66 > 0) & (var55 > 0)
    rho4_err = 4 * get_ratio_error(sums[..., 6], fsum_safe, var66, var55, cov[..., 6, 5])
    res["rho4_err"] = torch.where(ok & rho4_var_ok & fsum_pos, rho4_err, nan)
    res["rho4_flags"] = torch.where(
        ok,
        torch.where(rho4_var_ok, torch.where(fsum_pos, izero, nf.NONPOS_FLUX),
                    nf.NONPOS_VAR),
        flags,
    )

    # full flags: the covariance of moments 2..6 must have a positive
    # diagonal
    diag = torch.diagonal(cov, dim1=-2, dim2=-1)[..., 2:]
    flags = flags | torch.where(torch.all(diag > 0, dim=-1), izero, nf.NONPOS_VAR)

    T_pos = torch.nan_to_num(T, nan=-1.0) > 0
    e_ok = (flags == 0) & fsum_pos & T_pos
    T_div = torch.where(T_pos, T, 1.0)
    e1 = torch.where(e_ok, pars[..., 2] / T_div, nan)
    e2 = torch.where(e_ok, pars[..., 3] / T_div, nan)
    s4_safe = torch.where(fsum_pos, sums[..., 4], 1.0)
    e1err = 2 * get_ratio_error(sums[..., 2], s4_safe, cov[..., 2, 2], var44, cov[..., 2, 4])
    e2err = 2 * get_ratio_error(sums[..., 3], s4_safe, cov[..., 3, 3], var44, cov[..., 3, 4])
    err_finite = torch.isfinite(e1err) & torch.isfinite(e2err)
    flags = flags | torch.where(e_ok & ~err_finite, nf.NONPOS_SHAPE_VAR, izero)
    flags = flags | torch.where((flags == 0) & fsum_pos & ~T_pos, nf.NONPOS_SIZE, izero)
    flags = flags | torch.where((flags == 0) & ~fsum_pos, nf.NONPOS_FLUX, izero)

    res["e1"] = e1
    res["e2"] = e2
    res["e"] = torch.stack([e1, e2], dim=-1)
    e1err = torch.where(e_ok & err_finite, e1err, nan)
    e2err = torch.where(e_ok & err_finite, e2err, nan)
    res["e1err"] = e1err
    res["e2err"] = e2err
    res["e_err"] = torch.stack([e1err, e2err], dim=-1)
    zero = torch.zeros_like(e1err)
    res["e_cov"] = torch.stack(
        [torch.stack([e1err**2, zero], dim=-1), torch.stack([zero, e2err**2], dim=-1)],
        dim=-2,
    )
    res["flags"] = flags
    return res


def admom_batch(pixels, wt0, jac_area, conf: AdmomConf, device=None):
    """adaptive moments over a [B] batch of stamps: pixels fields
    [B, P], wt0 [B, 6], jac_area [B] or a scalar, as numpy arrays or
    tensors. Runs on the CUDA card unless the caller passes
    device="cpu"; the real dtype of pixels.val is kept. Returns the
    result dict of admom_result with numiter and the final weight wt."""
    dev = resolve_device(device)
    dtype = torch.as_tensor(pixels.val).dtype
    pixels = Pixels(*(torch.as_tensor(x, dtype=dtype, device=dev) for x in pixels))
    wt0 = torch.as_tensor(wt0, dtype=dtype, device=dev)
    raw = admom_raw(pixels, wt0, conf)
    res = admom_result(raw, torch.as_tensor(jac_area, dtype=dtype, device=dev))
    res["numiter"] = raw["numiter"]
    res["wt"] = raw["wt"]
    return res


def admom_fit(pixels, wt0, jac_area, conf: AdmomConf):
    """adaptive moments of one stamp, one lane of admom_raw on the
    pixels' device: pixels fields [P] tensors, wt0 [6]; returns the
    result dict of admom_result for the stamp with numiter and wt"""
    pixels = Pixels(*(x[None] for x in pixels))
    raw = admom_raw(pixels, torch.as_tensor(wt0, device=pixels.val.device)[None], conf)
    res = admom_result(raw, jac_area)
    res["numiter"] = raw["numiter"]
    res["wt"] = raw["wt"]
    return {k: v[0] for k, v in res.items()}


# ----------------------------------------------------------------------
# host API

class AdmomResult(dict):
    """admom fit result of one observation"""

    def __init__(self, obs, result):
        self._obs = obs
        self.update(result)

    def get_gmix(self):
        if self["flags"] != 0:
            raise RuntimeError("cannot create gmix, fit failed")
        pars = np.array(self["pars"], copy=True)
        pars[5] = 1.0
        e1 = pars[2] / pars[4]
        e2 = pars[3] / pars[4]
        g1, g2 = (float(x) for x in e1e2_to_g1g2(_t(e1), _t(e2)))
        pars[2] = g1
        pars[3] = g2
        return GMixModel(pars, "gauss")

    def make_image(self):
        """the fitted gaussian at the image's flux, rendered through K2
        on the observation's device"""
        if self["flags"] != 0:
            raise RuntimeError("cannot create image, fit failed")
        obs = self._obs
        gm = self.get_gmix()
        gm.set_flux(obs.image.sum())
        return gm.make_image(obs.image.shape, jacobian=obs.jacobian, device=obs.device)


_INT_KEYS = ("flags", "flux_flags", "T_flags", "rho4_flags")
_FLOAT_KEYS = ("flux", "flux_err", "flux_mean", "T", "T_err", "rho4", "rho4_err", "s2n",
               "e1", "e2", "e1err", "e2err", "wsum", "sums_norm")


class AdmomFitter(object):
    """adaptive moments fitter (kind = "am"); go(obs, guess) takes a
    GMix guess or a T guess, from which a gaussian is drawn with rng"""

    kind = "am"

    def __init__(self, maxiter=DEFAULT_MAXITER, shiftmax=DEFAULT_SHIFTMAX,
                 etol=DEFAULT_ETOL, Ttol=DEFAULT_TTOL, cenonly=False,
                 rng=None):
        self.conf = AdmomConf(
            maxiter=maxiter, shiftmax=shiftmax, etol=etol, Ttol=Ttol,
            cenonly=cenonly,
        )
        self.rng = rng

    def go(self, obs, guess):
        if not isinstance(obs, Observation):
            raise ValueError("input obs must be an Observation")

        guess_gmix = self._get_guess(obs=obs, guess=guess)
        pixels = obs.pixels
        wt0 = torch.as_tensor(guess_gmix.get_data()[0], dtype=pixels.val.dtype,
                              device=pixels.val.device)

        res = admom_fit(pixels, wt0, obs.jacobian.area, self.conf)
        result = {k: v.cpu().numpy() for k, v in res.items() if k != "wt"}
        for k in _INT_KEYS:
            result[k] = int(result[k])
            result[k.replace("flags", "flagstr")] = nf.get_flags_str(result[k])
        result["numiter"] = int(result["numiter"])
        for k in _FLOAT_KEYS:
            result[k] = float(result[k])
        return AdmomResult(obs=obs, result=result)

    def _get_guess(self, obs, guess):
        if isinstance(guess, GMix):
            return guess
        return self._generate_guess(obs=obs, Tguess=guess)

    def _get_rng(self):
        if self.rng is None:
            self.rng = np.random.RandomState()
        return self.rng

    def _generate_guess(self, obs, Tguess):
        rng = self._get_rng()
        scale = obs.jacobian.get_scale()
        pars = np.zeros(6)
        pars[0:2] = rng.uniform(low=-0.5 * scale, high=0.5 * scale, size=2)
        pars[2:4] = rng.uniform(low=-0.3, high=0.3, size=2)
        pars[4] = Tguess * (1.0 + rng.uniform(low=-0.1, high=0.1))
        pars[5] = 1.0
        return GMixModel(pars, "gauss")


def run_admom(obs, guess, maxiter=DEFAULT_MAXITER, shiftmax=DEFAULT_SHIFTMAX,
              etol=DEFAULT_ETOL, Ttol=DEFAULT_TTOL, cenonly=False, rng=None):
    """run adaptive moments on one observation"""
    am = AdmomFitter(
        maxiter=maxiter, shiftmax=shiftmax, etol=etol, Ttol=Ttol,
        cenonly=cenonly, rng=rng,
    )
    return am.go(obs=obs, guess=guess)


def find_cen_admom(obs, fwhm=None, gmix=None, maxiter=DEFAULT_MAXITER,
                   shiftmax=DEFAULT_SHIFTMAX, etol=DEFAULT_ETOL,
                   Ttol=DEFAULT_TTOL, ntry=1, rng=None):
    """center-only adaptive moments, retried up to ntry times from a
    center drawn with rng within half a pixel; res["cen"] is the
    fitted center, NaN on failure"""
    if ntry > 1 and rng is None:
        raise ValueError(
            "send a random number generator rng= when trying more than once "
            "this facilitates generating a new guess for the center"
        )

    if gmix is not None:
        wt = gmix.copy()
    elif fwhm is not None:
        T = float(fwhm_to_T(fwhm))
        wt = GMixModel([0.0, 0.0, 0.0, 0.0, T, 1.0], "gauss")
    else:
        raise ValueError("send gmix= or fwhm=")

    scale = obs.jacobian.scale
    am = AdmomFitter(
        maxiter=maxiter, shiftmax=shiftmax, etol=etol, Ttol=Ttol,
        cenonly=True,
    )

    res = None
    for itry in range(ntry):
        res = am.go(obs=obs, guess=wt)
        if res["flags"] == 0:
            break
        if ntry > 1:
            drow, dcol = rng.uniform(low=-scale / 2, high=scale / 2, size=2)
            wt.set_cen(row=drow, col=dcol)

    if res["flags"] == 0:
        res["cen"] = res.get_gmix().get_cen()
    else:
        res["cen"] = np.zeros(2) + np.nan
    return res


# the reference's package layout (ngmix.admom.admom)
import sys as _sys  # noqa: E402

admom = _sys.modules[__name__]
admom_nb = admom
