"""Shape (ellipticity) priors: the device side of
``ngmix_tpu/priors/shape.py``.

``GPriorBA.get_lnprob_device2d`` and ``ZDisk2D.get_lnprob_device2d``
on tensors, with their derivatives in closed form, and
``GPriorBase.get_fdiff_device``, sqrt(max(-2 ln p, 0)). A g prior
without a device form (``GPriorGauss``) raises, as in the reference.
The host methods the guessers call (``sample1d``, ``sample2d``,
``get_lnprob_scalar2d`` and the probabilities they sample from) are
the reference's numpy code over ``self.rng``.
"""
import numpy as np
import torch

from ..defaults import LOWVAL
from ..gexceptions import GMixRangeError
from .priors import FORM_LNP, GBA, ZDISK, PriorBase, draw_until, sqrt_m2ln_grad


class GPriorBase(PriorBase):
    """base of the |g| priors (ref: shape.py:16-72)"""

    fdiff_form = FORM_LNP

    def __init__(self, pars, rng=None):
        super().__init__(rng=rng)
        self.pars = [float(p) for p in torch.as_tensor(pars, dtype=torch.float64).reshape(-1)]
        self.gmax = 1.0

    @property
    def kind(self):
        raise RuntimeError("over-ride me")

    def get_lnprob_device2d_grad(self, g1, g2):
        raise RuntimeError("over-ride me")

    def get_lnprob_device2d(self, g1, g2):
        return self.get_lnprob_device2d_grad(g1, g2)[0]

    def get_fdiff_device_grad(self, g1, g2):
        """sqrt(max(-2 ln p, 0)) and its derivatives in (g1, g2)"""
        return sqrt_m2ln_grad(*self.get_lnprob_device2d_grad(g1, g2))

    def get_fdiff_device(self, g1, g2):
        return self.get_fdiff_device_grad(g1, g2)[0]

    def get_lnprob_scalar2d(self, g1, g2):
        raise RuntimeError("over-ride me")

    def get_prob_scalar2d(self, g1, g2):
        raise RuntimeError("over-ride me")

    def get_prob_scalar1d(self, g):
        raise RuntimeError("over-ride me")

    def get_prob_array2d(self, g1arr, g2arr):
        g1arr = np.atleast_1d(np.asarray(g1arr, dtype="f8"))
        g2arr = np.atleast_1d(np.asarray(g2arr, dtype="f8"))
        return np.array([self.get_prob_scalar2d(a, b) for a, b in zip(g1arr, g2arr)],
                        dtype="f8")

    def get_prob_array1d(self, garr):
        garr = np.atleast_1d(np.asarray(garr, dtype="f8"))
        return np.array([self.get_prob_scalar1d(g) for g in garr], dtype="f8")

    def sample2d(self, nrand=None, maxguess=0.1):
        """(g1, g2) by rejection from the 2-d probability under a ceiling
        read off a grid of |g|"""
        gmax = self.gmax - 1.0e-4
        gg = np.linspace(0, gmax, 1000)
        pmax = np.max([self.get_prob_scalar2d(g, 0.0) for g in gg]) * 1.05

        def propose(k):
            cand = self.rng.uniform(low=-gmax, high=gmax, size=(k, 2))
            inside = np.hypot(cand[:, 0], cand[:, 1]) < gmax
            h = pmax * self.rng.uniform(size=k)
            p = self.get_prob_array2d(cand[:, 0], cand[:, 1])
            return cand[inside & (h < p)]

        pairs = draw_until(1 if nrand is None else nrand, propose)
        if nrand is None:
            return pairs[0, 0], pairs[0, 1]
        return pairs[:, 0], pairs[:, 1]

    def sample1d(self, nrand=None, maxguess=0.1):
        """|g| by rejection from the 1-d probability"""
        gmax = self.gmax - 1.0e-4
        gg = np.linspace(1e-6, gmax, 1000)
        pmax = np.max(self.get_prob_array1d(gg)) * 1.05

        def propose(k):
            cand = self.rng.uniform(low=0.0, high=gmax, size=k)
            h = pmax * self.rng.uniform(size=k)
            return cand[h < self.get_prob_array1d(cand)]

        g = draw_until(1 if nrand is None else nrand, propose)
        return g[0] if nrand is None else g


class GPriorGauss(GPriorBase):
    """gaussian prior on (g1, g2) (ref: shape.py:185-205); it has no
    device form"""

    def __init__(self, pars, rng=None):
        super().__init__(pars, rng=rng)
        self.sigma = self.pars[0]

    def sample1d(self, nrand=None, **kw):
        raise NotImplementedError("no 1d for gauss")

    def sample2d(self, nrand=None, **kw):
        gmax = self.gmax - 1.0e-4

        def propose(k):
            cand = self.rng.normal(scale=self.sigma, size=(k, 2))
            return cand[np.hypot(cand[:, 0], cand[:, 1]) < gmax]

        pairs = draw_until(1 if nrand is None else nrand, propose)
        if nrand is None:
            return pairs[0, 0], pairs[0, 1]
        return pairs[:, 0], pairs[:, 1]


class GPriorBA(GPriorBase):
    """Bernstein & Armstrong 2013: p = A (1 - g^2)^2 exp(-g^2 / 2 sigma^2)
    (ref: shape.py:208-236)"""

    kind = GBA

    def __init__(self, sigma, rng=None, A=1.0):
        PriorBase.__init__(self, rng=rng)
        self.set_pars([A, sigma])
        self.gmax = 1.0

    def set_pars(self, pars):
        self.pars = [float(p) for p in pars]
        self.A = self.pars[0]
        self.sigma = self.pars[1]
        self.sig2 = self.sigma**2
        self.sig2inv = 1.0 / self.sig2

    @property
    def consts(self):
        return (self.sig2inv,)

    def get_lnprob_scalar2d(self, g1, g2):
        gsq = g1 * g1 + g2 * g2
        omgsq = 1.0 - gsq
        if omgsq <= 0.0:
            raise GMixRangeError("g^2 too big: %s" % gsq)
        return 2 * np.log(omgsq) - 0.5 * gsq * self.sig2inv

    def get_prob_scalar2d(self, g1, g2):
        gsq = g1 * g1 + g2 * g2
        omgsq = 1.0 - gsq
        if omgsq <= 0.0:
            return 0.0
        return self.A * omgsq * omgsq * np.exp(-0.5 * gsq * self.sig2inv)

    def get_prob_scalar1d(self, g):
        gsq = g * g
        omgsq = 1.0 - gsq
        if omgsq <= 0.0:
            return 0.0
        return self.A * omgsq * omgsq * np.exp(-0.5 * gsq * self.sig2inv) * 2 * np.pi * g

    def get_lnprob_device2d_grad(self, g1, g2):
        gsq = g1 * g1 + g2 * g2
        omgsq = 1.0 - gsq
        ok = omgsq > 0.0
        om = torch.where(ok, omgsq, 1.0)
        lnp = 2 * torch.log(om) - (0.5 * gsq) * self.sig2inv
        # d gsq / d g_i = 2 g_i
        d1, d2 = ((2.0 * (-(2.0 * g) / om) - (0.5 * (2.0 * g)) * self.sig2inv)
                  for g in (g1, g2))
        return (torch.where(ok, lnp, LOWVAL), torch.where(ok, d1, 0.0),
                torch.where(ok, d2, 0.0))


class ZDisk2D(PriorBase):
    """uniform on a disk of the given radius (ref: shape.py:282-297)"""

    kind = ZDISK

    def __init__(self, radius, rng=None):
        super().__init__(rng=rng)
        self.radius = radius
        self.radius_sq = radius**2

    @property
    def consts(self):
        return (self.radius_sq,)

    def get_lnprob_scalar1d(self, r):
        if r >= self.radius:
            raise GMixRangeError("position out of bounds")
        return 0.0

    def get_lnprob_scalar2d(self, x, y):
        if x**2 + y**2 >= self.radius_sq:
            raise GMixRangeError("position out of bounds")
        return 0.0

    def get_prob_scalar2d(self, x, y):
        return 0.0 if x**2 + y**2 >= self.radius_sq else 1.0

    def sample1d(self, nrand=None):
        n = 1 if nrand is None else nrand
        r = np.sqrt(self.radius_sq * self.rng.uniform(size=n))
        return r[0] if nrand is None else r

    def sample2d(self, nrand=None):
        n = 1 if nrand is None else nrand
        radius = self.sample1d(nrand=n)
        theta = 2.0 * np.pi * self.rng.uniform(size=n)
        x = radius * np.cos(theta)
        y = radius * np.sin(theta)
        if nrand is None:
            return x[0], y[0]
        return x, y

    def get_lnprob_device2d_grad(self, x, y):
        r2 = x**2 + y**2
        zero = torch.zeros_like(r2)
        return torch.where(r2 >= self.radius_sq, LOWVAL, zero), zero, zero

    def get_lnprob_device2d(self, x, y):
        return self.get_lnprob_device2d_grad(x, y)[0]
