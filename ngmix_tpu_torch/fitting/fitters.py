"""Levenberg-Marquardt fitters of the host API: the port of
``ngmix_tpu/fitting/fitters.py`` (Fitter, CoellipFitter,
PSFFluxFitter).

The reference solves every fit with its residual-form LM
(``run_lm``). Its objective, (model - data) * ierr of the apodized
model with the prior's rows in front, is the one K3 and K3-mb solve
with the same stopping rules, so the port routes each fit by its shape
alone, never by a kernel's success:

- "K3": a model the kernels hold (``ops.lm_solve.MODELS``: exp, gauss,
  dev, bdf, bd), one epoch whose psf is one gaussian, and a prior that
  is None or a joint prior of the fit's slots (``joint_prior.PRIORS``):
  one K3 launch at B = 1 (``lm_solve.lm_solve``), then
  ``fitting.lm._normal_epilogue`` over the live pixels;
- "K3-mb": the same over several epochs or bands (nband <= 6), each
  epoch's psf one gaussian: one K3-mb launch at B = 1;
- "run_lm": everything else (coellip, turb, psfs of several gaussians,
  epochs whose psfs differ in size, another prior): ``fitting.lm.run_lm``
  over ``make_fdiff_fn`` on the observation's device.

One psf gaussian is exact: the convolution normalizes the psf to unit
flux and recentres it on its own centroid, so only its (irr, irc, icc)
matter, which is what K3 takes. A fit without a psf mixture takes K3
with a psf of zero covariance: the convolution then adds exact zeros,
so the kernels' model is the unconvolved one to the bit
(tests/test_torch_fitters.py holds it). On a CUDA observation a K3 or
K3-mb fit launches its kernel or raises; nothing falls back to run_lm.
CPU observations take the kernels' plain versions.
"""
import numpy as np
import torch

from .. import joint_prior
from ..defaults import DEFAULT_LM_PARS
from ..gmix.gmix import get_model_name, get_model_num
from ..ops import lm_solve
from .fit_model import CoellipFitModel, FitModel, PSFFluxFitModel
from .lm import LMConf, _normal_epilogue, get_def_stuff, run_lm

def fit_route(fit_model, prior):
    """the route of a fit ("K3", "K3-mb" or "run_lm"), from the model,
    the epochs, their psf mixtures and the prior"""
    data = fit_model.data
    psf_ok = data.psf_gmix is None or data.psf_gmix.shape[-2] == 1
    prior_ok = prior is None or (isinstance(prior, joint_prior.PRIORS)
                                 and prior.npars == fit_model.npars)
    if not (fit_model.model_name in lm_solve.MODELS and psf_ok and prior_ok
            and fit_model.nband <= lm_solve.MAX_NBAND):
        return "run_lm"
    return "K3" if data.band.shape[0] == 1 else "K3-mb"


def _kernel_solve(route, fit_model, guess, lo, hi, conf, prior):
    """the K3 or K3-mb route: the finished solver state's epilogue over
    the live pixels, as numpy fields of one fit"""
    data = fit_model.data
    px = data.pixels
    E = px.val.shape[0]
    planes = [x.contiguous() for x in (px.v, px.u, px.ierr * px.area, px.val * px.ierr)]
    if data.psf_gmix is None:
        psf = px.val.new_zeros((E, 3))
    else:
        psf = data.psf_gmix[:, 0, 3:6].contiguous()
    # new tensors of the pixels' dtype on their device
    g = px.val.new_tensor(guess)[None].contiguous()
    lo = px.val.new_tensor(lo)
    hi = px.val.new_tensor(hi)
    if route == "K3":
        state = lm_solve.lm_solve(g, lo, hi, psf, *planes, conf, fit_model.model_name, prior)
    else:
        state = lm_solve.lm_solve_mb(g, lo, hi, psf[None].contiguous(), data.band,
                                     *(x[None].contiguous() for x in planes), conf,
                                     fit_model.model_name, prior)
    nres = torch.sum(px.ierr > 0)
    out = _normal_epilogue(state, lo, hi, conf, nres)
    return {k: out[k][0] for k in ("pars", "pars_err", "pars_cov0", "pars_cov", "flags",
                                   "nfev", "ier")}


class Fitter(object):
    """the LM fit of a model (ref: fitters.py:20-117)

    fit_pars: maxfev, ftol and xtol (DEFAULT_LM_PARS without it),
    bounds [(lo, hi)] * npars (None for an open side), which take
    precedence over the prior's, and epsfcn (accepted, unused: the
    derivatives are exact); another key raises ValueError."""

    def __init__(self, model, prior=None, fit_pars=None, use_noise_image=False,
                 analytic_jacobian=True):
        self.prior = prior
        self.model = get_model_num(model)
        self.model_name = get_model_name(self.model)
        self.use_noise_image = use_noise_image
        # the derivatives are exact; the flag is the reference's
        self.analytic_jacobian = analytic_jacobian
        if fit_pars is not None:
            self.fit_pars = dict(fit_pars)
        else:
            self.fit_pars = dict(DEFAULT_LM_PARS)
        unknown = set(self.fit_pars) - {"maxfev", "ftol", "xtol", "bounds", "epsfcn"}
        if unknown:
            raise ValueError(
                "unsupported fit_pars keys %s; supported: maxfev, ftol, xtol, bounds "
                "(epsfcn accepted, ignored)" % sorted(unknown))

    def go(self, obs, guess):
        """fit the observation (an Observation, ObsList or
        MultiBandObsList) from the guess; returns the FitModel, whose
        ``route`` says how it was solved"""
        guess = np.asarray(guess, dtype="f8")
        fit_model = self._make_fit_model(obs=obs, guess=guess)

        if self.use_noise_image:
            for obslist in fit_model.obs:
                for tobs in obslist:
                    if not tobs.has_noise():
                        raise ValueError("obs.noise must be set when use_noise_image=True")

        conf = LMConf(maxfev=int(self.fit_pars.get("maxfev", 4000)),
                      ftol=float(self.fit_pars.get("ftol", 1.0e-5)),
                      xtol=float(self.fit_pars.get("xtol", 1.0e-5)))

        npars = fit_model.npars
        lo = np.full(npars, -np.inf)
        hi = np.full(npars, np.inf)
        bounds = self.fit_pars.get("bounds", None)
        if bounds is None:
            bounds = fit_model.bounds
        if bounds is not None:
            if len(bounds) != npars:
                raise ValueError("bounds has %d entries for %d parameters"
                                 % (len(bounds), npars))
            for i, b in enumerate(bounds):
                if b[0] is not None:
                    lo[i] = b[0]
                if b[1] is not None:
                    hi[i] = b[1]

        route = fit_route(fit_model, self.prior)
        fit_model.route = route
        if route == "run_lm":
            data = fit_model.data
            dtype, dev = data.pixels.val.dtype, data.pixels.val.device
            # masked pixels stay as zero rows: the dof counts the live
            # ones and the prior rows
            n_eff = fit_model.n_prior_pars + int(torch.sum(data.pixels.ierr > 0))
            out = run_lm(fit_model._fdiff_fn, data,
                         torch.as_tensor(guess, dtype=dtype, device=dev),
                         torch.as_tensor(lo, dtype=dtype, device=dev),
                         torch.as_tensor(hi, dtype=dtype, device=dev), conf,
                         n_prior_pars=fit_model.n_prior_pars, n_eff=n_eff)
        else:
            out = _kernel_solve(route, fit_model, guess, lo, hi, conf, self.prior)

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

        if self.use_noise_image:
            from .noise_cov import apply_noise_cov

            apply_noise_cov(fit_model=fit_model, result=result)

        fit_model.set_fit_result(result)
        return fit_model

    def _make_fit_model(self, obs, guess):
        return FitModel(obs=obs, model=self.model, guess=guess, prior=self.prior)


class CoellipFitter(Fitter):
    """the fit of ngauss coelliptical gaussians (ref: fitters.py:120-141);
    its route is run_lm"""

    def __init__(self, ngauss, prior=None, fit_pars=None):
        self._ngauss = ngauss
        super().__init__(model="coellip", prior=prior, fit_pars=fit_pars)

    def _make_fit_model(self, obs, guess):
        return CoellipFitModel(obs=obs, ngauss=self._ngauss, guess=guess, prior=self.prior)


class PSFFluxFitter(object):
    """the psf (or template) flux by cross correlation (ref:
    fitters.py:144-181); the templates render through K2"""

    def __init__(self, do_psf=True, normalize_psf=True):
        self.do_psf = do_psf
        self.normalize_psf = normalize_psf

    def go(self, obs):
        fit_model = PSFFluxFitModel(obs=obs, do_psf=self.do_psf,
                                    normalize_psf=self.normalize_psf)
        fit_model.go()
        return fit_model
