"""k-space maximum-likelihood fits of analytic profiles (the reference's
"galsim fitters"): the port of ``ngmix_tpu/fitting/kspace_fitters.py``.

The model k images are closed-form expressions on the k grid:

- gauss:   exp(-sigma^2 k^2 / 2)
- exp:     (1 + (k r0)^2)^(-3/2)            (the exponential disk's FT)
- dev:     the 10-gaussian dev expansion in k
- spergel: (1 + (k r_c)^2)^(-(1+nu))        (Spergel 2010)
- moffat:  2 (k rd / 2)^(b-1) K_{b-1}(k rd) / Gamma(b-1), interpolated
           in a (beta, log k) table of scipy's Bessel function

The shear enters as evaluation at |S^T k| and the centroid as a phase,
written in real arithmetic (cos, sin), so ``torch.func.jacfwd``
differentiates the residuals: the real and the imaginary parts of
(model x psf - data) * sqrt(weight), fitted by ``fitting.lm.run_lm``
with k_space=True (half the rows count for the dof) on the k
observations' device. No kernel of ours runs on this path.

The Spergel c_nu table (120 root solves) and the Moffat table (180 x
1500 Bessel values) are built with scipy once, at first use, to the
reference's values; ``_SPERGEL_NUS``, ``_SPERGEL_CS``,
``_MOFFAT_BETAS``, ``_MOFFAT_LOGX`` and ``_MOFFAT_TAB`` read them.
"""
import functools
import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..defaults import DEFAULT_LM_PARS
from ..gexceptions import GMixRangeError
from ..gmix import core as gcore, tables as gtables
from ..kobs import KMultiBandObsList, KObservation, KObsList, get_kmb_obs, make_kobs
from ..metacal import kops
from .fit_model import FDIFF_BAD, PSFFluxFitModel
from .lm import LMConf, get_def_stuff, run_lm

logger = logging.getLogger(__name__)

__all__ = [
    "GalsimFitter",
    "GalsimSpergelFitter",
    "GalsimMoffatFitter",
    "GalsimPSFFluxFitter",
    "KSpaceFitter",
]


# ----------------------------------------------------------------------
# size conversions and the tables

R50_TO_SIGMA_GAUSS = 1.0 / (2.0 * np.sqrt(2.0 * np.log(2.0)) / 2.0)
R50_TO_R0_EXP = 1.0 / 1.6783469900166605

# the ranges of the Spergel nu and the Moffat beta tables
SPERGEL_NU_RANGE = (-0.85, 4.0)
MOFFAT_BETA_RANGE = (1.05, 10.0)


def _dev_r50_factor():
    """r50 / sqrt(T) of the 10-gaussian dev expansion, from the mixture's
    enclosed flux"""
    p = gtables.PVALS_DEV
    f = gtables.FVALS_DEV

    def enclosed(r, T):
        sig2 = T * f / 2.0
        return np.sum(p * (1 - np.exp(-0.5 * r * r / sig2)))

    lo, hi = 1e-4, 50.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if enclosed(mid, 1.0) < 0.5:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


_DEV_R50_FAC = _dev_r50_factor()


@functools.lru_cache(maxsize=1)
def spergel_cnu_table():
    """(nu [120], c_nu [120]): c_nu = r50 / r_c of the Spergel profile,
    the root of F(c) = 0.5 with the enclosed flux F(x) = 1 - x^(nu+1)
    K_{nu+1}(x) / (2^nu Gamma(nu+1))"""
    from scipy.optimize import brentq
    from scipy.special import gamma, kv

    nus = np.linspace(*SPERGEL_NU_RANGE, 120)
    cs = np.zeros_like(nus)
    for i, nu in enumerate(nus):
        norm = 2**nu * gamma(nu + 1)

        def func(x):
            return 1.0 - x ** (nu + 1) * kv(nu + 1, x) / norm - 0.5

        cs[i] = brentq(func, 1e-4, 50.0)
    return nus, cs


@functools.lru_cache(maxsize=1)
def moffat_ktable():
    """(beta [180], log x [1500], table [180, 1500]): the unit-flux
    Moffat k profile g_beta(x) = 2 (x/2)^(beta-1) K_{beta-1}(x) /
    Gamma(beta-1)"""
    from scipy.special import gamma, kv

    betas = np.linspace(*MOFFAT_BETA_RANGE, 180)
    logx = np.linspace(np.log(1e-4), np.log(300.0), 1500)
    x = np.exp(logx)
    tab = np.zeros((betas.size, x.size))
    for i, b in enumerate(betas):
        nu = b - 1.0
        tab[i] = 2.0 * (x / 2.0) ** nu * kv(nu, x) / gamma(nu)
    tab = np.nan_to_num(tab, nan=0.0)
    return betas, logx, tab


_TABLE_NAMES = {
    "_SPERGEL_NUS": (spergel_cnu_table, 0),
    "_SPERGEL_CS": (spergel_cnu_table, 1),
    "_MOFFAT_BETAS": (moffat_ktable, 0),
    "_MOFFAT_LOGX": (moffat_ktable, 1),
    "_MOFFAT_TAB": (moffat_ktable, 2),
}


def __getattr__(name):
    """the reference's module-level table names, built at first use"""
    if name in _TABLE_NAMES:
        fn, i = _TABLE_NAMES[name]
        return fn()[i]
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


@functools.lru_cache(maxsize=8)
def _tables_on(device, dtype):
    """the Spergel and Moffat tables as tensors on device"""
    dev = torch.device(device)
    spergel = tuple(torch.as_tensor(x, dtype=dtype, device=dev) for x in spergel_cnu_table())
    moffat = tuple(torch.as_tensor(x, dtype=dtype, device=dev) for x in moffat_ktable())
    return spergel, moffat


def _interp(x, xp, fp):
    """jnp.interp of a scalar x inside [xp[0], xp[-1]]: the piecewise
    linear interpolant, its weight carrying the derivative. The index
    stays a one-element tensor, so no value is read to the host"""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.detach().reshape(1), right=True), 1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    return (fp[i - 1] + (delta / dx) * df).reshape(())


def _moffat_kprofile(x, beta):
    """the bilinear interpolation of the Moffat k table at x (any shape)
    and a scalar beta: 1 below the table's x range, 0 above it"""
    _, (betas, logxg, tab) = _tables_on(str(x.device), x.dtype)
    nb, nx = betas.shape[0], logxg.shape[0]
    beta = torch.as_tensor(beta, dtype=x.dtype, device=x.device)
    # a one-element index, so no value is read to the host
    bi = torch.clamp(torch.searchsorted(betas, beta.detach().reshape(1)) - 1, 0, nb - 2)
    bw = (beta - betas[bi]) / (betas[bi + 1] - betas[bi])

    lx = torch.log(torch.clamp(x, min=1e-30))
    xi = torch.clamp(torch.searchsorted(logxg, lx.detach().contiguous()) - 1, 0, nx - 2)
    xw = (lx - logxg[xi]) / (logxg[xi + 1] - logxg[xi])

    v00 = tab[bi, xi]
    v01 = tab[bi, xi + 1]
    v10 = tab[bi + 1, xi]
    v11 = tab[bi + 1, xi + 1]
    val = (
        v00 * (1 - bw) * (1 - xw)
        + v01 * (1 - bw) * xw
        + v10 * bw * (1 - xw)
        + v11 * bw * xw
    )
    val = torch.where(lx < logxg[0], 1.0, val)
    return torch.where(lx > logxg[-1], 0.0, val)


# ----------------------------------------------------------------------
# model k-image evaluation

class KFitData(NamedTuple):
    kimage: torch.Tensor  # [nepoch, N, N] complex, fftshifted
    ierr: torch.Tensor  # [nepoch, N, N]
    psf_kimage: Optional[torch.Tensor]  # [nepoch, N, N] complex or None
    band: torch.Tensor  # [nepoch]
    kv: torch.Tensor  # [N, N] sky-frame k (row-like)
    ku: torch.Tensor  # [N, N] sky-frame k (col-like)


def _round_kprofile(model, ksq, size, extra):
    """the unit-flux round profile at |k|^2; ``size`` is r50 but for
    moffat, the scale radius. Returns (profile, bad flag)"""
    bad = size < 1.0e-4
    size = torch.where(bad, 1.0, size)
    if model == "gauss":
        sigma = size * R50_TO_SIGMA_GAUSS
        return torch.exp(-0.5 * sigma**2 * ksq), bad
    elif model == "exp":
        r0 = size * R50_TO_R0_EXP
        return (1.0 + ksq * r0 * r0) ** (-1.5), bad
    elif model == "dev":
        T = (size / _DEV_R50_FAC) ** 2
        p = gcore._table(gtables.PVALS_DEV, ksq)
        f = gcore._table(gtables.FVALS_DEV, ksq)
        sig2 = T * f / 2.0
        return torch.sum(p * torch.exp(-0.5 * sig2 * ksq[..., None]), dim=-1), bad
    elif model == "spergel":
        (nus, cs), _ = _tables_on(str(ksq.device), ksq.dtype)
        nu = extra
        lo, hi = SPERGEL_NU_RANGE
        bad = bad | (nu < lo) | (nu > hi)
        nu_s = torch.clamp(nu, lo, hi)
        cnu = _interp(nu_s, nus, cs)
        rc = size / cnu
        return (1.0 + ksq * rc * rc) ** (-(1.0 + nu_s)), bad
    elif model == "moffat":
        beta = extra
        lo, hi = MOFFAT_BETA_RANGE
        bad = bad | (beta < lo) | (beta > hi)
        beta_s = torch.clamp(beta, lo, hi)
        return _moffat_kprofile(torch.sqrt(ksq) * size, beta_s), bad
    raise ValueError("bad kspace model %s" % model)


def _moffat_rd(size, beta, size_type):
    """the Moffat scale radius rd of the size parameter"""
    beta_s = torch.clamp(beta, min=1.0 + 1e-3)
    if size_type in ("r50", "half_light_radius", "hlr"):
        return size / torch.sqrt(2.0 ** (1.0 / (beta_s - 1.0)) - 1.0)
    elif size_type == "fwhm":
        return size / (2.0 * torch.sqrt(2.0 ** (1.0 / beta_s) - 1.0))
    raise ValueError("bad size_type %s" % size_type)


def _kspace_model_parts(model, size_type="r50"):
    """(head [nhead], kv, ku) -> (profile [N, N], phase angle [N, N], bad):
    the unit-flux sheared profile and the centroid's phase angle phi,
    the model being flux * profile * e^{-i phi}; head is the band
    parameters without the flux"""

    def parts(head, kv, ku):
        c1 = head[0]  # x/u shift (galsim shift convention)
        c2 = head[1]  # y/v shift
        g1 = head[2]
        g2 = head[3]
        size = head[4]
        extra = head[5] if model in ("spergel", "moffat") else None

        gsq = g1 * g1 + g2 * g2
        bad_g = gsq >= 1.0
        g1s = torch.where(bad_g, 0.0, g1)
        g2s = torch.where(bad_g, 0.0, g2)

        # the sheared profile: evaluated at S^T k ((v, u) ordering)
        gsq_s = g1s * g1s + g2s * g2s
        fac = 1.0 / torch.sqrt(1.0 - gsq_s)
        s00 = (1.0 - g1s) * fac
        s01 = g2s * fac
        s11 = (1.0 + g1s) * fac
        kv_s = s00 * kv + s01 * ku
        ku_s = s01 * kv + s11 * ku
        ksq = kv_s * kv_s + ku_s * ku_s

        if model == "moffat":
            rd = _moffat_rd(size, extra, size_type)
            prof, bad_p = _round_kprofile(model, ksq, rd, extra)
        else:
            prof, bad_p = _round_kprofile(model, ksq, size, extra)
        return prof, ku * c1 + kv * c2, bad_g | bad_p

    return parts


def make_kspace_model_fn(model, size_type="r50"):
    """(band_pars, kv, ku) -> (complex k model, bad flag)"""
    parts = _kspace_model_parts(model, size_type=size_type)

    def model_fn(band_pars, kv, ku):
        band_pars = torch.as_tensor(band_pars, dtype=kv.dtype, device=kv.device)
        prof, phi, bad = parts(band_pars[:-1], kv, ku)
        amp = band_pars[-1] * prof
        return torch.complex(amp * torch.cos(phi), -amp * torch.sin(phi)), bad

    return model_fn


def _nhead(model):
    return 6 if model in ("spergel", "moffat") else 5


def make_kspace_fdiff_fn(model, size_type="r50", prior=None):
    """the residual function (pars, KFitData) of run_lm with
    k_space=True: the real, then the imaginary residuals of every epoch
    scaled by ierr, every row FDIFF_BAD at a bad parameter point, the
    prior's rows in front. In real arithmetic, functional, so
    torch.func.jacfwd differentiates it"""
    parts = _kspace_model_parts(model, size_type=size_type)
    nhead = _nhead(model)

    def fdiff_fn(pars, data: KFitData):
        prof, phi, bad = parts(pars[:nhead], data.kv, data.ku)
        # one flux an epoch, the flux of its band
        flux = pars[nhead:][data.band][:, None, None]
        re = flux * prof * torch.cos(phi)
        im = -(flux * prof) * torch.sin(phi)
        if data.psf_kimage is not None:
            pr, pi = data.psf_kimage.real, data.psf_kimage.imag
            re, im = re * pr - im * pi, re * pi + im * pr

        dre = (re - data.kimage.real) * data.ierr
        dim = (im - data.kimage.imag) * data.ierr
        rows = torch.cat([dre.reshape(-1), dim.reshape(-1)])
        rows = torch.where(bad, FDIFF_BAD, rows)

        if prior is not None:
            prows = prior.fill_fdiff_device(pars[None])[0]
            prows = torch.where(torch.isfinite(prows), prows, FDIFF_BAD)
            return torch.cat([prows, rows])
        return rows

    return fdiff_fn


def _kgrids_sky(dims, dk, device):
    """fftshift-layout k grids (sky units) matching KObservation"""
    N0, N1 = dims
    idx0 = np.fft.fftshift(np.fft.fftfreq(N0) * N0)
    idx1 = np.fft.fftshift(np.fft.fftfreq(N1) * N1)
    kv = idx0[:, None] * dk + np.zeros((1, N1))
    ku = np.zeros((N0, 1)) + idx1[None, :] * dk
    return (torch.as_tensor(kv, device=device), torch.as_tensor(ku, device=device))


def pack_kfit_data(mb_kobs):
    """a KMultiBandObsList stacked into KFitData on the device of its
    first KObservation"""
    kimages, ierrs, psfs, bands = [], [], [], []
    have_psf = mb_kobs[0][0].has_psf()
    device = mb_kobs[0][0].device
    dk = None
    dims = None
    for band, kobs_list in enumerate(mb_kobs):
        for kobs in kobs_list:
            if dk is None:
                dk = kobs.scale
                dims = kobs.kimage.shape
            else:
                assert np.allclose(dk, kobs.scale), "dk must match"
                assert dims == kobs.kimage.shape, "kimage dims must match"
            kimages.append(kobs.kimage)
            ierr = np.zeros(kobs.weight.shape)
            w = kobs.weight > 0
            ierr[w] = np.sqrt(kobs.weight[w])
            ierrs.append(ierr)
            bands.append(band)
            if have_psf:
                psfs.append(kobs.psf.kimage)

    kv, ku = _kgrids_sky(dims, dk, device)

    def dev(x):
        return torch.as_tensor(np.stack(x), device=device)

    return KFitData(
        kimage=dev(kimages),
        ierr=dev(ierrs),
        psf_kimage=dev(psfs) if have_psf else None,
        band=torch.as_tensor(bands, dtype=torch.int64, device=device),
        kv=kv,
        ku=ku,
    )


# ----------------------------------------------------------------------
# the fit model and the fitters

def get_galsim_npars(model, nband):
    """the parameters of a model's fit over nband bands"""
    if model in ["exp", "dev", "gauss"]:
        return 5 + nband
    elif model in ["spergel", "moffat"]:
        return 6 + nband
    else:
        raise ValueError("bad model %s" % model)


class KSpaceFitModel(dict):
    """the k-space fit model and result (the reference's GalsimFitModel)"""

    def __init__(self, obs, model, guess, prior=None, size_type="r50"):
        self.prior = prior
        self.model = model
        self.size_type = size_type
        self["model"] = model

        self._set_kobs(obs)
        self.data = pack_kfit_data(self.mb_kobs)
        self.totpix = int(np.prod(self.data.kimage.shape))
        self._set_npars()
        self._set_n_prior_pars()
        self.fdiff_size = self.n_prior_pars + 2 * self.totpix
        self._set_bounds()
        self._check_guess(guess)
        self._fdiff_fn = make_kspace_fdiff_fn(
            model, size_type=size_type, prior=prior
        )

    def _set_kobs(self, obs_in):
        if isinstance(obs_in, (KObservation, KObsList, KMultiBandObsList)):
            kobs = get_kmb_obs(obs_in)
        else:
            kobs = make_kobs(obs_in)
        self.mb_kobs = kobs
        self.nband = len(kobs)

    def _set_npars(self):
        self.npars = get_galsim_npars(self.model, self.nband)

    def _set_n_prior_pars(self):
        if self.prior is None:
            self.n_prior_pars = 0
        elif hasattr(self.prior, "n_prior_pars"):
            self.n_prior_pars = self.prior.n_prior_pars
        elif self.model in ("spergel", "moffat"):
            self.n_prior_pars = 5 + self.nband
        else:
            self.n_prior_pars = 4 + self.nband

    def _set_bounds(self):
        self._bounds = None
        if self.prior is not None and hasattr(self.prior, "bounds"):
            self._bounds = self.prior.bounds

    @property
    def bounds(self):
        import copy

        return copy.deepcopy(self._bounds)

    def _check_guess(self, guess):
        guess = np.asarray(guess, dtype="f8")
        if guess.size != self.npars:
            raise ValueError(
                "expected %d entries in the guess, but got %d"
                % (self.npars, guess.size)
            )
        if guess[2] ** 2 + guess[3] ** 2 >= 1.0:
            raise GMixRangeError("g out of range in guess")
        if guess[4] < 1.0e-4:
            raise GMixRangeError("low r50: %g" % guess[4])

    def calc_fdiff(self, pars):
        pars = torch.as_tensor(np.asarray(pars, dtype="f8"), device=self.data.kv.device)
        return self._fdiff_fn(pars, self.data).cpu().numpy()

    def get_band_pars(self, pars, band):
        nhead = _nhead(self.model)
        out = np.zeros(nhead + 1)
        out[:nhead] = pars[:nhead]
        out[nhead] = pars[nhead + band]
        return out

    def set_fit_result(self, result):
        self.update(result)
        if self["flags"] == 0:
            self["s2n_r"] = self.calc_s2n_r(self["pars"])
            self._set_g()
            self._set_flux()

    def _set_g(self):
        self["g"] = self["pars"][2:4].copy()
        self["g_cov"] = self["pars_cov"][2:4, 2:4].copy()
        self["g_err"] = self["pars_err"][2:4].copy()

    def _set_flux(self):
        nhead = _nhead(self.model)
        if self.nband == 1:
            self["flux"] = self["pars"][nhead]
            self["flux_err"] = np.sqrt(self["pars_cov"][nhead, nhead])
        else:
            self["flux"] = self["pars"][nhead:]
            self["flux_cov"] = self["pars_cov"][nhead:, nhead:]
            self["flux_err"] = np.sqrt(np.diag(self["flux_cov"]))

    def calc_s2n_r(self, pars):
        """the round model's s/n: sqrt(sum |model x psf|^2 weight) over
        every epoch, the shear set to 0"""
        model_fn = make_kspace_model_fn(self.model, self.size_type)
        data = self.data
        s2n_sum = 0.0
        for band in range(self.nband):
            bp = self.get_band_pars(pars, band)
            bp[2:4] = 0.0
            kmodel, _ = model_fn(bp, data.kv, data.ku)
            for i in torch.nonzero(data.band == band)[:, 0].tolist():
                km = kmodel
                if data.psf_kimage is not None:
                    km = km * data.psf_kimage[i]
                w = data.ierr[i] ** 2
                s2n_sum += float(torch.sum((km.real**2 + km.imag**2) * w))
        return np.sqrt(s2n_sum) if s2n_sum > 0 else 0.0


class KSpaceFitter(object):
    """the LM fitter of k-space models (the reference's GalsimFitter):
    run_lm with k_space=True on the k observations' device"""

    def __init__(self, model, prior=None, fit_pars=None, size_type="r50"):
        self.prior = prior
        self.model = model
        self.size_type = size_type
        if fit_pars is not None:
            self.fit_pars = dict(fit_pars)
        else:
            self.fit_pars = dict(DEFAULT_LM_PARS)

    def go(self, obs, guess):
        guess = np.asarray(guess, dtype="f8")
        fit_model = self._make_fit_model(obs=obs, guess=guess)

        conf = LMConf(
            maxfev=int(self.fit_pars.get("maxfev", 4000)),
            ftol=float(self.fit_pars.get("ftol", 1.0e-5)),
            xtol=float(self.fit_pars.get("xtol", 1.0e-5)),
        )
        npars = fit_model.npars
        lo = np.full(npars, -np.inf)
        hi = np.full(npars, np.inf)
        if fit_model.bounds is not None:
            for i, b in enumerate(fit_model.bounds):
                if b[0] is not None:
                    lo[i] = b[0]
                if b[1] is not None:
                    hi[i] = b[1]

        dev = fit_model.data.kv.device
        out = run_lm(
            fit_model._fdiff_fn,
            fit_model.data,
            torch.as_tensor(guess, device=dev),
            torch.as_tensor(lo, device=dev),
            torch.as_tensor(hi, device=dev),
            conf,
            n_prior_pars=fit_model.n_prior_pars,
            k_space=True,
        )
        result = {
            "flags": int(out["flags"]),
            "nfev": int(out["nfev"]),
            "ier": int(out["ier"]),
            "errmsg": "",
        }
        for k in ("pars", "pars_err", "pars_cov0", "pars_cov"):
            result[k] = out[k].detach().cpu().numpy()
        if result["flags"] != 0:
            pars, pcov, perr = get_def_stuff(npars)
            if not np.all(np.isfinite(result["pars"])):
                result["pars"] = pars
            result["pars_cov"] = pcov
            result["pars_err"] = perr

        fit_model.set_fit_result(result)
        return fit_model

    def _make_fit_model(self, obs, guess):
        return KSpaceFitModel(
            obs=obs, model=self.model, guess=guess, prior=self.prior,
            size_type=self.size_type,
        )


class KSpaceSpergelFitter(KSpaceFitter):
    def __init__(self, prior=None, fit_pars=None):
        super().__init__(model="spergel", prior=prior, fit_pars=fit_pars)


class KSpaceMoffatFitter(KSpaceFitter):
    def __init__(self, prior=None, size_type="r50", fit_pars=None):
        super().__init__(
            model="moffat", prior=prior, fit_pars=fit_pars,
            size_type=size_type,
        )


class _TemplateFluxFitModel(PSFFluxFitModel):
    """the template flux against given (model x psf) template images:
    PSFFluxFitModel's two-pass cross correlation over templates that
    were made outside it"""

    def __init__(self, obs, templates):
        from ..observation import Observation, ObsList

        self.do_psf = False
        self.normalize_psf = True
        self["model"] = "template"
        self.npars = 1
        if isinstance(obs, Observation):
            obs_list = ObsList()
            obs_list.append(obs)
        else:
            obs_list = obs
        self.obs = obs_list
        self._mode = "image"
        self._templates = [
            np.asarray(t) / np.asarray(t).sum() for t in templates
        ]
        self._norms = [1.0] * len(self._templates)
        self.totpix = sum(o.pixels.val.shape[-1] for o in self.obs)


class KSpacePSFFluxFitter(object):
    """the psf or template flux by cross correlation (the reference's
    GalsimPSFFluxFitter).

    model=None measures a psf flux against the psf image itself. An
    analytic template is a spec dict, e.g. {"model": "exp", "r50": 0.5}
    (optional g1/g2, nu for spergel, beta and fwhm or r50 for moffat):
    the template is ifft(model_khat(k_sky) * psfhat) on the
    observation's device.
    """

    def __init__(self, model=None, draw_method="auto", interp="lanczos15",
                 pad_factor=4):
        del draw_method, interp  # galsim's; the k operations are exact
        if model is not None and not (
            isinstance(model, dict) and "model" in model
        ):
            raise ValueError(
                "model must be None or a spec dict like "
                "{'model': 'exp', 'r50': 0.5}"
            )
        self.model = model
        self.pad_factor = pad_factor

    def go(self, obs):
        from ..observation import Observation, ObsList

        if isinstance(obs, Observation):
            obs_list = ObsList()
            obs_list.append(obs)
        else:
            obs_list = obs
        templates = [self._make_template(o) for o in obs_list]
        fit_model = _TemplateFluxFitModel(
            obs=obs_list, templates=templates
        )
        fit_model.go()
        return fit_model

    def _make_template(self, obs):
        """the unit-flux model convolved with the epoch's pixelized psf
        (model=None: the psf itself), rendered at the observation's
        jacobian center on its grid"""
        spec = self.model
        name = None if spec is None else spec["model"]
        if name == "moffat":
            size_type = "fwhm" if "fwhm" in spec else "r50"
            size = spec.get("fwhm", spec.get("r50"))
            band_pars = [0.0, 0.0, spec.get("g1", 0.0), spec.get("g2", 0.0),
                         size, spec["beta"], 1.0]
        elif name == "spergel":
            size_type = "r50"
            band_pars = [0.0, 0.0, spec.get("g1", 0.0), spec.get("g2", 0.0),
                         spec["r50"], spec["nu"], 1.0]
        elif name is not None:
            size_type = "r50"
            band_pars = [0.0, 0.0, spec.get("g1", 0.0), spec.get("g2", 0.0),
                         spec["r50"], 1.0]

        dev = obs.device
        psf_obs = obs.psf
        psf_im = psf_obs.image / psf_obs.image.sum()
        H, W = obs.image.shape
        Hp, Wp = psf_im.shape
        N = kops.good_fft_size(self.pad_factor * max(H, W, Hp, Wp))
        psfhat = kops.centered_fft(
            torch.as_tensor(psf_im, device=dev),
            torch.as_tensor(np.array(psf_obs.jacobian.get_cen()), device=dev), N)
        if name is None:
            khat = psfhat
        else:
            model_fn = make_kspace_model_fn(name, size_type=size_type)
            kv, ku = kops.sky_kvu(N, obs.jacobian, device=dev)
            khat_model, bad = model_fn(band_pars, kv, ku)
            if bool(bad):
                raise GMixRangeError("bad template model parameters")
            khat = khat_model * psfhat
        template = kops.centered_ifft(
            khat, torch.as_tensor(np.array(obs.jacobian.get_cen()), device=dev), (H, W))
        return template.cpu().numpy()


# the reference's names
GalsimFitter = KSpaceFitter
GalsimSpergelFitter = KSpaceSpergelFitter
GalsimMoffatFitter = KSpaceMoffatFitter
GalsimPSFFluxFitter = KSpacePSFFluxFitter
GalsimFitModel = KSpaceFitModel
