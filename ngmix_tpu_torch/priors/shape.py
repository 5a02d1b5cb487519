"""Shape (ellipticity) priors: the device side of
``ngmix_tpu/priors/shape.py``.

``GPriorBA.get_lnprob_device2d`` and ``ZDisk2D.get_lnprob_device2d``
on tensors, with their derivatives in closed form, and
``GPriorBase.get_fdiff_device``, sqrt(max(-2 ln p, 0)). A g prior
without a device form (``GPriorGauss``) raises, as in the reference.
"""
import torch

from ..defaults import LOWVAL
from .priors import FORM_LNP, GBA, ZDISK, PriorBase, sqrt_m2ln_grad


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


class GPriorGauss(GPriorBase):
    """gaussian prior on (g1, g2) (ref: shape.py:185-205); it has no
    device form"""

    def __init__(self, pars, rng=None):
        super().__init__(pars, rng=rng)
        self.sigma = self.pars[0]


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

    def get_lnprob_device2d_grad(self, x, y):
        r2 = x**2 + y**2
        zero = torch.zeros_like(r2)
        return torch.where(r2 >= self.radius_sq, LOWVAL, zero), zero, zero

    def get_lnprob_device2d(self, x, y):
        return self.get_lnprob_device2d_grad(x, y)[0]
