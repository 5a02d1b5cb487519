"""1-d priors: the device side of ``ngmix_tpu/priors/priors.py``.

Each prior keeps the reference's constructor parameters and derived
attributes and evaluates ``get_lnprob_device`` and ``get_fdiff_device``
on tensors, with the same formulas: they never raise, and a point
outside the support gives ln(prob) = LOWVAL (-inf) and, for the signed
rows, an infinite fdiff. The ``*_grad`` forms also return the
derivative in closed form, the reference's ``jax.jacfwd`` of the same
expression; where a value is guarded by a ``where`` (outside the
support, or sqrt(-2 ln p) at chi2 = 0) the derivative is 0.

K3 and K3-mb evaluate the same rows from a table (``kind`` and
``consts`` of each prior, ``csrc/lm_common.cuh: prior_row``). Sampling
and the host API are not ported; ``rng`` is accepted and not used.
"""
import math

import torch

from ..defaults import LOWVAL

# the kinds of prior row of K3's and K3-mb's prior table
# (csrc/lm_common.cuh: PriorKind)
FLAT, NORMAL, CEN, ERF, LOGNORMAL, SINH, TRUNC, GBA, ZDISK = range(9)
# a row is sqrt(max(-2 ln p, 0)) (FORM_LNP) or a signed fdiff (FORM_FDIFF)
FORM_LNP, FORM_FDIFF = 0, 1

_TWO_OVER_SQRT_PI = 2.0 / math.sqrt(math.pi)


def sqrt_m2ln_grad(lnp, *dlnp):
    """the pseudo-residual sqrt(max(-2 ln p, 0)) of ln(prob) values and
    its derivatives from those of ln p: 0 where chi2 = -2 ln p is not
    positive (a nan ln p included), and an infinite row where ln p is
    -inf, whose derivative is then 0"""
    chi2 = torch.clamp(-2.0 * lnp, min=0.0)
    pos = chi2 > 0.0
    row = torch.where(pos, torch.sqrt(torch.where(pos, chi2, 1.0)), 0.0)
    half = 0.5 / torch.where(pos, row, 1.0)
    return (row,) + tuple(torch.where(pos, (-2.0 * d) * half, 0.0) for d in dlnp)


class PriorBase(object):
    """a prior's bounds (used by the joint priors' ``bounds``)"""

    def __init__(self, rng=None, bounds=None):
        self.bounds = bounds
        self.rng = rng

    def has_bounds(self):
        return self.bounds is not None

    def get_lnprob_device(self, val):
        return self.get_lnprob_device_grad(val)[0]

    def get_fdiff_device(self, val):
        return self.get_fdiff_device_grad(val)[0]


class _LnpFdiff:
    """get_fdiff_device as sqrt(max(-2 ln p, 0)) of get_lnprob_device"""

    fdiff_form = FORM_LNP

    def get_fdiff_device_grad(self, val):
        return sqrt_m2ln_grad(*self.get_lnprob_device_grad(val))


class FlatPrior(PriorBase):
    """flat in [minval, maxval] (ref: priors.py:67-124)"""

    kind = FLAT
    fdiff_form = FORM_FDIFF

    def __init__(self, minval, maxval, rng=None):
        super().__init__(rng=rng)
        self.minval = minval
        self.maxval = maxval

    @property
    def consts(self):
        return (self.minval, self.maxval)

    def _out(self, val):
        return (val < self.minval) | (val > self.maxval)

    def get_lnprob_device_grad(self, val):
        return torch.where(self._out(val), LOWVAL, torch.zeros_like(val)), torch.zeros_like(val)

    def get_fdiff_device_grad(self, val):
        return (torch.where(self._out(val), math.inf, torch.zeros_like(val)),
                torch.zeros_like(val))


class TwoSidedErf(_LnpFdiff, PriorBase):
    """smooth box 0.5 erf((x - min) / wmin) + 0.5 erf((max - x) / wmax)
    (ref: priors.py:127-188)"""

    kind = ERF

    def __init__(self, minval, width_at_min, maxval, width_at_max, rng=None):
        super().__init__(rng=rng)
        self.minval = minval
        self.width_at_min = width_at_min
        self.maxval = maxval
        self.width_at_max = width_at_max

    @property
    def consts(self):
        return (self.minval, self.width_at_min, self.maxval, self.width_at_max)

    def get_lnprob_device_grad(self, val):
        a = (val - self.minval) / self.width_at_min
        b = (self.maxval - val) / self.width_at_max
        p = 0.5 * (torch.erf(a) + torch.erf(b))
        # d erf(x) = 2 / sqrt(pi) exp(-x^2) dx
        drise = _TWO_OVER_SQRT_PI * ((1.0 / self.width_at_min) * torch.exp(-(a * a)))
        dfall = _TWO_OVER_SQRT_PI * ((-1.0 / self.width_at_max) * torch.exp(-(b * b)))
        dp = 0.5 * (drise + dfall)
        ok = p > 0.0
        lnp = torch.where(ok, torch.log(torch.where(ok, p, 1.0)), LOWVAL)
        return lnp, torch.where(ok, dp / torch.where(ok, p, 1.0), 0.0)


class Normal(PriorBase):
    """unnormalized gaussian, peak ln(prob) = 0 (ref: priors.py:191-226)"""

    kind = NORMAL
    fdiff_form = FORM_FDIFF

    def __init__(self, mean, sigma, rng=None, bounds=None):
        super().__init__(rng=rng, bounds=bounds)
        self.mean = mean
        self.sigma = sigma
        self.sinv = 1.0 / sigma
        self.s2inv = 1.0 / sigma**2
        self.ndim = 1

    @property
    def consts(self):
        return (self.mean, self.sigma)

    def get_lnprob_device_grad(self, val):
        z = (val - self.mean) / self.sigma
        return (-0.5 * z) * z, -(z * (1.0 / self.sigma))

    def get_fdiff_device_grad(self, val):
        return (val - self.mean) / self.sigma, torch.full_like(val, 1.0 / self.sigma)


class LogNormal(_LnpFdiff, PriorBase):
    """lognormal, peak ln(prob) = 0 at the mode (ref: priors.py:292-358)"""

    kind = LOGNORMAL

    def __init__(self, mean, sigma, rng=None, shift=None):
        super().__init__(rng=rng)
        if mean <= 0:
            raise ValueError("mean must be > 0")
        self.shift = shift
        self.mean = mean
        self.sigma = sigma
        # moment matching: the underlying normal in t = log(x)
        self.logvar = math.log1p((sigma / mean) ** 2)
        self.logmean = math.log(mean) - 0.5 * self.logvar
        self.logsigma = math.sqrt(self.logvar)
        self.logivar = 1.0 / self.logvar
        self.log_mode = self.logmean - self.logvar
        self.mode = math.exp(self.log_mode)
        self.lnprob_max = 0.5 * self.logvar - self.logmean

    @property
    def consts(self):
        return (0.0 if self.shift is None else self.shift, self.logmean,
                -0.5 * self.logivar, self.lnprob_max)

    def get_lnprob_device_grad(self, val):
        if self.shift is not None:
            val = val - self.shift
        ok = val > 0
        v = torch.where(ok, val, 1.0)
        t = torch.log(v)
        d = t - self.logmean
        c = -0.5 * self.logivar
        lnp = c * (d * d) - t
        dt = 1.0 / v
        dlnp = c * (dt * (2.0 * d)) - dt
        return torch.where(ok, lnp - self.lnprob_max, LOWVAL), torch.where(ok, dlnp, 0.0)


class Sinh(PriorBase):
    """sinh pseudo-prior (ref: priors.py:417-441)"""

    kind = SINH
    fdiff_form = FORM_FDIFF

    def __init__(self, mean, scale, rng=None):
        super().__init__(rng=rng)
        self.mean = mean
        self.scale = scale

    @property
    def consts(self):
        return (self.mean, self.scale)

    def get_fdiff_device_grad(self, val):
        u = (val - self.mean) / self.scale
        return torch.sinh(u), torch.cosh(u) * (1.0 / self.scale)

    def get_lnprob_device_grad(self, val):
        f, df = self.get_fdiff_device_grad(val)
        return (-0.5 * f) * f, -(f * df)


class TruncatedGaussian(PriorBase):
    """gaussian truncated to [minval, maxval] (ref: priors.py:444-492)"""

    kind = TRUNC
    fdiff_form = FORM_FDIFF

    def __init__(self, mean, sigma, minval, maxval, rng=None):
        super().__init__(rng=rng)
        self.mean = mean
        self.sigma = sigma
        self.ivar = 1.0 / sigma**2
        self.sinv = 1.0 / sigma
        self.minval = minval
        self.maxval = maxval

    @property
    def consts(self):
        return (self.mean, self.sinv, self.minval, self.maxval)

    def _out(self, val):
        return (val < self.minval) | (val > self.maxval)

    def get_lnprob_device_grad(self, val):
        z = (val - self.mean) * self.sinv
        out = self._out(val)
        return (torch.where(out, LOWVAL, (-0.5 * z) * z),
                torch.where(out, 0.0, -(z * self.sinv)))

    def get_fdiff_device_grad(self, val):
        out = self._out(val)
        return (torch.where(out, math.inf, (val - self.mean) * self.sinv),
                torch.where(out, 0.0, torch.full_like(val, self.sinv)))
