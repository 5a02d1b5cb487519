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
``consts`` of each prior, ``csrc/lm_common.cuh: prior_row``).

The host methods that the guessers and the host fitters call are the
reference's numpy code: ``sample`` draws from ``self.rng`` (a numpy
``RandomState``; ``make_rng`` of the ``rng`` argument), so a prior
whose generator is in the same state draws the same numbers, and
``get_lnprob_scalar`` evaluates one value, raising ``GMixRangeError``
where the reference does. Rejection sampling goes through
``draw_until``, the reference's accumulator.
"""
import math

import numpy as np
import torch

from ..defaults import LOWVAL
from ..gexceptions import GMixRangeError
from .random import make_rng

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


def draw_until(n, propose):
    """at least n accepted draws, exactly n returned (leading axis).

    ``propose(k)`` makes k proposals and returns the accepted ones. Each
    round asks for the deficit over the running acceptance rate (at
    least 1/64), as the reference's sampler does, so the same generator
    state gives the same draws."""
    if n <= 0:
        return np.asarray(propose(0))[:0]
    kept = []
    have = 0
    asked = 0
    ask = int(n)
    while have < n:
        got = np.asarray(propose(ask))
        kept.append(got)
        have += got.shape[0]
        asked += ask
        rate = max(have / asked, 1.0 / 64.0)
        ask = int(np.ceil((n - have) / rate)) + 1
    return np.concatenate(kept, axis=0)[:n]


def _one_or_many(vals, nrand):
    """the reference's convention: nrand None gives a bare value"""
    return vals[0] if nrand is None else vals


class PriorBase(object):
    """a prior's bounds (used by the joint priors' ``bounds``) and its
    numpy generator"""

    def __init__(self, rng=None, bounds=None):
        self.bounds = bounds
        self.rng = make_rng(rng)

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

    def get_lnprob_scalar(self, val):
        if np.any(np.asarray(val) < self.minval) or np.any(np.asarray(val) > self.maxval):
            raise GMixRangeError("value %s out of range: [%s,%s]"
                                 % (val, self.minval, self.maxval))
        return 0.0

    def sample(self, nrand=None):
        n = 1 if nrand is None else nrand
        span = self.maxval - self.minval
        return _one_or_many(self.minval + span * self.rng.uniform(size=n), nrand)

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

    def _smooth_box(self, x):
        """the probability of numpy values x"""
        from scipy.special import erf

        rise = erf((x - self.minval) / self.width_at_min)
        fall = erf((self.maxval - x) / self.width_at_max)
        return 0.5 * (rise + fall)

    def get_lnprob_scalar(self, val):
        p = float(self._smooth_box(np.float64(val)))
        return np.log(p) if p > 0.0 else LOWVAL

    def sample(self, nrand=None):
        lo = self.minval - 5.0 * self.width_at_min
        hi = self.maxval + 5.0 * self.width_at_max

        def propose(k):
            x = self.rng.uniform(low=lo, high=hi, size=k)
            return x[self.rng.uniform(size=k) < self._smooth_box(x)]

        return _one_or_many(draw_until(1 if nrand is None else nrand, propose), nrand)

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

    def get_lnprob_scalar(self, val):
        z = (val - self.mean) / self.sigma
        return -0.5 * z * z

    def sample(self, nrand=None, size=None):
        if size is None and nrand is not None:
            size = nrand
        return self.rng.normal(loc=self.mean, scale=self.sigma, size=size)

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

    def get_lnprob_scalar(self, val):
        if self.shift is not None:
            val = val - self.shift
        if val <= 0:
            raise GMixRangeError("values of LogNormal must be > 0")
        t = np.log(val)
        return -0.5 * (self.logivar * (t - self.logmean) ** 2) - t - self.lnprob_max

    def sample(self, nrand=None):
        z = self.rng.normal(size=nrand)
        r = np.exp(self.logmean + self.logsigma * z)
        if self.shift is not None:
            r += self.shift
        return r

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

    def get_lnprob_scalar(self, val):
        f = np.sinh((val - self.mean) / self.scale)
        return -0.5 * f * f

    def sample(self, nrand=None):
        n = 1 if nrand is None else nrand
        vals = self.rng.uniform(low=self.mean - self.scale, high=self.mean + self.scale,
                                size=n)
        return _one_or_many(vals, nrand)

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

    def get_lnprob_scalar(self, val):
        if val < self.minval or val > self.maxval:
            raise GMixRangeError("value out of range")
        z = (val - self.mean) * self.sinv
        return -0.5 * z * z

    def sample(self, nrand=None):
        def propose(k):
            cand = self.rng.normal(loc=self.mean, scale=self.sigma, size=k)
            return cand[(cand > self.minval) & (cand < self.maxval)]

        return _one_or_many(draw_until(1 if nrand is None else nrand, propose), nrand)

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
