"""The 2-d center prior: the device side of
``ngmix_tpu/priors/multivariate.py``, with its host ``sample`` and
``get_lnprob_scalar``."""
import torch

from .priors import CEN, PriorBase


class CenPrior(PriorBase):
    """independent gaussians in each dimension (ref:
    multivariate.py:7-52)"""

    kind = CEN

    def __init__(self, cen1, cen2, sigma1, sigma2, rng=None):
        super().__init__(rng=rng)
        self.cen1 = float(cen1)
        self.cen2 = float(cen2)
        self.sigma1 = float(sigma1)
        self.sigma2 = float(sigma2)
        self.sinv1 = 1.0 / self.sigma1
        self.sinv2 = 1.0 / self.sigma2
        self.s2inv1 = 1.0 / self.sigma1**2
        self.s2inv2 = 1.0 / self.sigma2**2

    def consts(self, i):
        """the table constants of the row of dimension i (0 or 1)"""
        return ((self.cen1, self.sinv1, self.s2inv1) if i == 0
                else (self.cen2, self.sinv2, self.s2inv2))

    def get_fdiff_device_grad(self, x1, x2):
        """((fdiff, its derivative) of x1, the same of x2)"""
        return (((x1 - self.cen1) * self.sinv1, torch.full_like(x1, self.sinv1)),
                ((x2 - self.cen2) * self.sinv2, torch.full_like(x2, self.sinv2)))

    def get_fdiff_device(self, x1, x2):
        (f1, _), (f2, _) = self.get_fdiff_device_grad(x1, x2)
        return f1, f2

    def get_lnprob_device_sep_grad(self, x1, x2):
        """((ln p, its derivative) of x1, the same of x2)"""
        d1 = self.cen1 - x1
        d2 = self.cen2 - x2
        return (((-0.5 * d1) * d1 * self.s2inv1, d1 * self.s2inv1),
                ((-0.5 * d2) * d2 * self.s2inv2, d2 * self.s2inv2))

    def get_lnprob_device_sep(self, x1, x2):
        (l1, _), (l2, _) = self.get_lnprob_device_sep_grad(x1, x2)
        return l1, l2

    def get_lnprob_device(self, x1, x2):
        l1, l2 = self.get_lnprob_device_sep(x1, x2)
        return l1 + l2

    def get_lnprob_scalar(self, x1, x2):
        d1 = self.cen1 - x1
        d2 = self.cen2 - x2
        return -0.5 * d1 * d1 * self.s2inv1 - 0.5 * d2 * d2 * self.s2inv2

    def sample(self, nrand=None):
        """(x1, x2) drawn from the two gaussians"""
        rand1 = self.rng.normal(loc=self.cen1, scale=self.sigma1, size=nrand)
        rand2 = self.rng.normal(loc=self.cen2, scale=self.sigma2, size=nrand)
        return rand1, rand2

    sample2d = sample


SimpleGauss2D = CenPrior
