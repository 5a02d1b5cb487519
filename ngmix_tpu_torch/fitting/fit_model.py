"""The fit objective and the FitModel result classes of the host
fitters, and the per-epoch parameter rows of a joint multi-band fit.

The port of ``ngmix_tpu/fitting/fit_model.py``. All of an object's
epochs are stacked into one ``FitData`` ([E, P] pixel planes, the psf
mixtures, the band of each epoch), and ``make_fdiff_fn`` gives the
whole residual vector of a parameter point as one tensor function:
(model - data) * ierr of the apodized model, with the prior's rows in
front. It evaluates with the broadcasting ``gmix.core.eval_gmix`` (K2
has no derivative), so ``torch.func.jacfwd`` differentiates it, as the
reference's ``jax.jacfwd`` differentiates its plain evaluation;
``make_lnprob_fn`` (the s/n sums after a fit), ``FitModel.make_image``
and ``PSFFluxFitModel``'s templates render through K2.

The simple models (exp, gauss, dev, turb) take the 5 + nband layout
(row, col, g1, g2, T, one flux a band); bdf and bd have more shape
columns, coellip (row, col, g1, g2, T_1..T_n, F_1..F_n) one band.
"""
import copy
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..defaults import BIGVAL, CDEF, LOWVAL, PDEF
from ..flags import BAD_VAR, DIV_ZERO, ZERO_DOF
from ..gexceptions import GMixRangeError
from ..gmix import core as gcore
from ..gmix.gmix import get_model_name, get_model_npars, get_model_num, make_gmix_model
from ..observation import Observation, ObsList, get_mb_obs
from ..pixels import Pixels

# residual value of a row at an out-of-range parameter point: large but
# finite, so the LM rejects the step without inf arithmetic
FDIFF_BAD = 1.0e10

# the first flux column of the models whose shape takes more than the
# five (row, col, g1, g2, T) parameters
_FLUX_START = {"bd": 7, "bdf": 6}


def shape_count(model):
    """the shared shape columns of the model, before its flux column(s)"""
    return _FLUX_START.get(model, 5)


def get_band_pars_device(model, pars, band):
    """the shared parameters plus the flux of one band: pars [...,
    npars], band an int or an int tensor [...] -> [..., start + 1]"""
    if model == "coellip":
        return pars
    start = _FLUX_START.get(model, 5)
    band = torch.as_tensor(band, device=pars.device).to(torch.int64)
    flux = torch.gather(
        pars[..., start:], -1,
        torch.broadcast_to(band, pars.shape[:-1])[..., None],
    )
    return torch.cat([pars[..., :start], flux], dim=-1)


def epoch_band_pars(model, pars, band):
    """[..., E, start + 1] per-epoch parameter rows: pars [..., npars],
    band [..., E] the band of each epoch. The shared shape columns
    broadcast; each epoch's flux is a one-hot contraction over the flux
    columns (exactly one 1 in a row, so the selection is exact, as in
    the reference). A band outside [0, nband) selects no flux: 0."""
    E = band.shape[-1]
    if model == "coellip":
        return pars[..., None, :].expand(pars.shape[:-1] + (E, pars.shape[-1]))
    start = _FLUX_START.get(model, 5)
    flux = pars[..., start:]
    onehot = (
        band[..., :, None] == torch.arange(flux.shape[-1], device=band.device)
    ).to(pars.dtype)
    flux_e = torch.sum(onehot * flux[..., None, :], dim=-1)
    shared = pars[..., None, :start].expand(pars.shape[:-1] + (E, start))
    return torch.cat([shared, flux_e[..., None]], dim=-1)


# the simple models, whose derivatives are shared across components
SIMPLE_ANALYTIC_MODELS = ("gauss", "exp", "dev")


class FitData(NamedTuple):
    """one object's fit data, its epochs stacked"""

    pixels: Pixels  # fields [E, P]
    psf_gmix: Optional[torch.Tensor]  # [E, m, 6] or None
    band: torch.Tensor  # [E] int32


def _convolved(model, pars, data):
    """(the model's mixture of each epoch [E, n m, 6], convolved with
    the epoch's psf where the data has psfs, and the fill flags [E])"""
    gm0, gflags = gcore.gmix_fill(model, epoch_band_pars(model, pars, data.band))
    if data.psf_gmix is None:
        return gm0, gflags
    return gcore.gmix_convolve(gm0, data.psf_gmix), gflags


def make_fdiff_fn(model, prior=None):
    """the residual function (pars [npars], FitData) -> [n_prior + E P]:
    the prior's rows (a joint prior's fill_fdiff_device; FDIFF_BAD where
    a row is not finite), then (model - data) * ierr of every epoch's
    apodized model, every pixel row FDIFF_BAD at a bad parameter point
    (fill or mixture flags). Functional, so torch.func.jacfwd
    differentiates it."""

    def fdiff_fn(pars, data):
        gm, gflags = _convolved(model, pars, data)
        px = data.pixels
        rows = (gcore.eval_gmix(gm, px.v, px.u, px.area, fast=True) - px.val) * px.ierr
        bad = torch.any((gflags != 0) | (gcore.gmix_flags(gm) != 0))
        pix_rows = torch.where(bad, FDIFF_BAD, rows).reshape(-1)
        if prior is None:
            return pix_rows
        prows = prior.fill_fdiff_device(pars[None])[0]
        prows = torch.where(torch.isfinite(prows), prows, FDIFF_BAD)
        return torch.cat([prows, pix_rows])

    return fdiff_fn


def make_lnprob_fn(model, prior=None):
    """(pars, FitData) -> (lnprob, s2n_numer, s2n_denom, npix), the
    epochs' sums of gmix.core.get_loglike (one K2 launch over the E
    lanes) and the prior's ln(prob); LOWVAL, 0, BIGVAL and 0 at a bad
    fill"""

    def lnprob_fn(pars, data):
        gm, gflags = _convolved(model, pars, data)
        loglike, s2n_numer, s2n_denom, npix = gcore.get_loglike(gm, data.pixels)
        lnprob = torch.sum(loglike)
        if prior is not None:
            lnprob = lnprob + prior.get_lnprob_scalar_device(pars)
        bad = torch.any(gflags != 0)
        return (torch.where(bad, LOWVAL, lnprob), torch.where(bad, 0.0, torch.sum(s2n_numer)),
                torch.where(bad, BIGVAL, torch.sum(s2n_denom)),
                torch.where(bad, 0, torch.sum(npix)))

    return lnprob_fn


def pack_fit_data(obs, model=None):
    """an Observation, ObsList or MultiBandObsList stacked into a
    FitData on the observations' device, and the MultiBandObsList.
    Every epoch must have one stamp size; psf mixtures of fewer
    gaussians are padded with zero-flux gaussians of unit covariance"""
    mbobs = get_mb_obs(obs)
    epochs = [(band, o) for band, obslist in enumerate(mbobs) for o in obslist]
    npix = {o.pixels.val.shape[-1] for _, o in epochs}
    if len(npix) != 1:
        raise ValueError("all epochs must share a stamp size for a stacked fit; "
                         "got pixel counts %s" % sorted(npix))
    device = epochs[0][1].device
    pixels = Pixels(*(torch.stack([o.pixels[k] for _, o in epochs]) for k in range(5)))
    psf_gmix = None
    if mbobs[0][0].has_psf_gmix():
        psfs = [o.psf.gmix.get_data() for _, o in epochs]
        m = max(pg.shape[0] for pg in psfs)
        padded = []
        for pg in psfs:
            if pg.shape[0] < m:
                pad = np.zeros((m - pg.shape[0], 6))
                pad[:, 3] = pad[:, 5] = 1.0
                pg = np.vstack([pg, pad])
            padded.append(pg)
        psf_gmix = torch.as_tensor(np.stack(padded), dtype=pixels.val.dtype, device=device)
    band = torch.tensor([b for b, _ in epochs], dtype=torch.int32, device=device)
    return FitData(pixels=pixels, psf_gmix=psf_gmix, band=band), mbobs


def _np(x):
    return x.detach().cpu().numpy()


class FitModel(dict):
    """the result of a model fit, a dict of its fields, with the fit's
    data and objective (the reference's FitModel)"""

    def __init__(self, obs, model, guess, prior=None):
        self.prior = prior
        self.model = get_model_num(model)
        self.model_name = get_model_name(self.model)
        self["model"] = self.model_name

        self._set_obs_and_data(obs)
        self._set_npars()
        self._set_n_prior_pars()
        self.fdiff_size = self.totpix + self.n_prior_pars
        self._set_bounds()
        self._check_guess(guess)

        self._fdiff_fn = make_fdiff_fn(self.model_name, prior=prior)
        self._lnprob_fn = make_lnprob_fn(self.model_name, prior=prior)

    def _set_obs_and_data(self, obs):
        self.data, self.obs = pack_fit_data(obs)
        self.nband = len(self.obs)
        self.nimage = int(self.data.band.shape[0])
        self.totpix = int(self.data.pixels.val.numel())
        self.dopsf = self.data.psf_gmix is not None

    def _set_npars(self):
        self.npars = get_model_npars(self.model) + self.nband - 1

    def _set_n_prior_pars(self):
        if self.prior is None:
            self.n_prior_pars = 0
        elif hasattr(self.prior, "n_prior_pars"):
            self.n_prior_pars = self.prior.n_prior_pars
        else:
            self.n_prior_pars = get_lm_n_prior_pars(model=self.model_name, nband=self.nband)

    def _set_bounds(self):
        self._bounds = None
        if self.prior is not None and hasattr(self.prior, "bounds"):
            self._bounds = self.prior.bounds

    def _check_guess(self, guess):
        guess = np.asarray(guess, dtype="f8")
        assert guess.size == self.npars, (
            "guess has npars=%d, expected %d" % (guess.size, self.npars))
        g1, g2 = guess[2], guess[3]
        if self.model_name != "coellip" and g1 * g1 + g2 * g2 >= 1.0:
            raise GMixRangeError("g out of range in guess")

    @property
    def bounds(self):
        return copy.deepcopy(self._bounds)

    def _pars(self, pars):
        return torch.as_tensor(np.asarray(pars, dtype="f8"), dtype=self.data.pixels.val.dtype,
                               device=self.data.pixels.val.device)

    # --- the objective --------------------------------------------------
    def calc_fdiff(self, pars):
        return _np(self._fdiff_fn(self._pars(pars), self.data))

    def calc_lnprob(self, pars, more=False):
        out = self._lnprob_fn(self._pars(pars), self.data)
        if more:
            return {"lnprob": float(out[0]), "s2n_numer": float(out[1]),
                    "s2n_denom": float(out[2]), "npix": int(out[3])}
        return float(out[0])

    # --- results --------------------------------------------------------
    def set_fit_result(self, result):
        self.update(result)
        if self["flags"] == 0:
            self.update(self.calc_lnprob(self["pars"], more=True))
            if self["s2n_denom"] > 0:
                s2n = self["s2n_numer"] / np.sqrt(self["s2n_denom"])
            else:
                s2n = 0.0
            chi2 = self["lnprob"] / (-0.5)
            dof = self["npix"] - self.npars
            self["chi2per"] = chi2 / dof if dof != 0 else 9999.0
            self["dof"] = dof
            self["s2n_w"] = s2n
            self["s2n"] = s2n
            self._set_g()
            self._set_T()
            self._set_flux()

    def _set_g(self):
        self["g"] = self["pars"][2:4].copy()
        self["g_cov"] = self["pars_cov"][2:4, 2:4].copy()
        self["g_err"] = self["pars_err"][2:4].copy()

    def _set_T(self):
        self["T"] = self["pars"][4]
        self["T_err"] = np.sqrt(self["pars_cov"][4, 4])

    def _set_flux(self):
        _set_flux(res=self, nband=self.nband)

    def get_band_pars(self, pars, band):
        return _np(get_band_pars_device(self.model_name, self._pars(pars), band))

    def get_gmix(self, band=0):
        pars = self.get_band_pars(pars=self["pars"], band=band)
        return make_gmix_model(pars, self.model)

    def get_convolved_gmix(self, band=0, obsnum=0):
        gm = self.get_gmix(band)
        obs = self.obs[band][obsnum]
        if obs.has_psf_gmix():
            gm = gm.convolve(obs.psf.gmix)
        return gm

    def make_image(self, band=0, obsnum=0):
        """the convolved model of an epoch rendered through K2 on the
        observation's device"""
        gm = self.get_convolved_gmix(band=band, obsnum=obsnum)
        obs = self.obs[band][obsnum]
        return gm.make_image(obs.image.shape, jacobian=obs.jacobian, device=obs.device)


class CoellipFitModel(FitModel):
    """the fit of ngauss coelliptical gaussians, one band"""

    def __init__(self, obs, ngauss, guess, prior=None):
        self._ngauss = ngauss
        super().__init__(obs=obs, model="coellip", guess=guess, prior=prior)

    def _set_flux(self):
        pass

    def _set_npars(self):
        assert self.nband == 1, "Coellip can only fit one band"
        self.npars = 4 + 2 * self._ngauss

    def get_band_pars(self, pars, band):
        return np.asarray(pars).copy()


def _as_obs_list(obs):
    """a bare Observation as a one-epoch ObsList; an ObsList as it is"""
    if isinstance(obs, ObsList):
        return obs
    if isinstance(obs, Observation):
        wrapped = ObsList()
        wrapped.append(obs)
        return wrapped
    raise ValueError("PSFFluxFitModel takes an Observation or an ObsList, got %s"
                     % type(obs).__name__)


class PSFFluxFitModel(dict):
    """the flux of a template (the psf's mixture or template image, or
    the observation's) by zero-lag cross correlation over the epochs.

    Each epoch has one template, a mixture rendered through K2 on the
    observation's device or a template image, with a flux norm that
    turns the cross-correlation amplitude into a flux; the first epoch
    decides which kind (``self._mode``, "gmix" or "image")."""

    def __init__(self, obs, do_psf=True, normalize_psf=True):
        self.do_psf = do_psf
        self.normalize_psf = normalize_psf
        self["model"] = "template"
        self.npars = 1

        self.obs = _as_obs_list(obs)
        lead = self.obs[0].psf if do_psf else self.obs[0]
        if lead.has_gmix():
            self._mode = "gmix"
        elif hasattr(lead, "template"):
            self._mode = "image"
        else:
            raise ValueError(
                "PSFFluxFitModel: the %s carries neither a gmix nor a template image to "
                "correlate against" % ("psf observation" if do_psf else "observation"))
        specs = [self._make_template(o) for o in self.obs]
        self._templates = [t for t, _ in specs]
        self._norms = [n for _, n in specs]
        self.totpix = sum(o.pixels.val.shape[-1] for o in self.obs)

    def _make_template(self, obs):
        """one epoch's (template, flux norm): unit flux, but a psf kept
        at its own flux with normalize_psf=False, whose norm then carries
        that flux"""
        if self._mode == "gmix":
            gm = obs.get_psf_gmix() if self.do_psf else obs.get_gmix()
            if self.normalize_psf or not self.do_psf:
                gm.set_flux(1.0)
            return gm, gm.get_flux()
        src = obs.psf if self.do_psf else obs
        im = np.array(src.template, dtype="f8", copy=True)
        total = im.sum()
        if self.do_psf and not self.normalize_psf:
            return im, total
        return im / total, 1.0

    def _get_model(self, iobs, flux=None):
        """epoch iobs's template image: at its stored normalization for
        flux None, else scaled to the flux"""
        tmpl = self._templates[iobs]
        if self._mode == "image":
            if flux is None:
                return tmpl
            return tmpl * (self._norms[iobs] * flux / tmpl.sum())
        gm = tmpl
        if flux is not None:
            gm = gm.copy()
            gm.set_flux(flux * self._norms[iobs])
        obs = self.obs[iobs]
        return gm.make_image(obs.image.shape, jacobian=obs.jacobian, device=obs.device)

    def go(self):
        flags = 0
        xcorr_sum = 0.0
        msq_sum = 0.0
        chi2 = 0.0
        flux = PDEF
        flux_err = CDEF

        for ipass in (1, 2):
            for iobs, obs in enumerate(self.obs):
                im = obs.image
                wt = obs.weight
                if ipass == 1:
                    model = self._get_model(iobs)
                    xcorr_sum += (model * im * wt).sum()
                    msq_sum += (model * model * wt).sum()
                else:
                    model = self._get_model(iobs, flux=flux)
                    chi2 += ((model - im) ** 2 * wt).sum()
            if ipass == 1:
                if msq_sum == 0:
                    break
                flux = xcorr_sum / msq_sum

        dof = self.get_dof()
        chi2per = 9999.0
        if dof > 0:
            chi2per = chi2 / dof
        else:
            flags |= ZERO_DOF

        if msq_sum == 0 or self.totpix == 1:
            flags |= DIV_ZERO
        else:
            arg = chi2 / msq_sum / (self.totpix - 1)
            if arg >= 0.0:
                flux_err = np.sqrt(arg)
            else:
                flags |= BAD_VAR

        self.update({"flags": flags, "chi2per": chi2per, "dof": dof, "flux": flux,
                     "flux_err": flux_err})

    def get_dof(self):
        dof = self.get_effective_npix() - self.npars
        if dof <= 0:
            dof = 1.0e-6
        return dof

    def get_effective_npix(self):
        if not hasattr(self, "eff_npix"):
            self.eff_npix = sum(int((obs.weight > 0).sum()) for obs in self.obs)
        return self.eff_npix


def get_lm_n_prior_pars(model, nband):
    """the prior rows of a model's fit"""
    if model == "bd":
        return 6 + nband
    elif model in ("bdf", "exp", "dev", "gauss", "turb"):
        return 5 + nband
    raise ValueError("bad model: %s" % model)


def _set_flux(res, nband):
    """the flux fields of a fit result: flux and flux_err, and the flux
    covariance with several bands"""
    model = res["model"]
    assert model != "coellip"
    start = _FLUX_START.get(model, 5)
    if nband == 1:
        res["flux"] = res["pars"][start]
        res["flux_err"] = np.sqrt(res["pars_cov"][start, start])
    else:
        res["flux"] = res["pars"][start:]
        res["flux_cov"] = res["pars_cov"][start:, start:]
        res["flux_err"] = np.sqrt(np.diag(res["flux_cov"]))
