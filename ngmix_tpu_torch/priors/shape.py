"""Shape (ellipticity) priors: the device side of
``ngmix_tpu/priors/shape.py``.

``GPriorBA.get_lnprob_device2d`` and ``ZDisk2D.get_lnprob_device2d``
on tensors, with their derivatives in closed form, and
``GPriorBase.get_fdiff_device``, sqrt(max(-2 ln p, 0)). A g prior
without a device form (``GPriorGauss``) raises, as in the reference.
The host methods (``sample1d``, ``sample2d``, ``sample2d_brute``,
``get_lnprob_scalar2d``, the probabilities, ``get_fdiff``,
``set_maxval1d`` and ``fit``, with scipy) are the reference's numpy
code over ``self.rng``.
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

    def get_lnprob_array2d(self, g1arr, g2arr):
        """ln(prob) of each (g1, g2), LOWVAL where the scalar raises"""
        g1arr = np.atleast_1d(np.asarray(g1arr, dtype="f8"))
        g2arr = np.atleast_1d(np.asarray(g2arr, dtype="f8"))
        out = np.zeros(g1arr.size) + LOWVAL
        for i in range(g1arr.size):
            try:
                out[i] = self.get_lnprob_scalar2d(g1arr[i], g2arr[i])
            except GMixRangeError:
                pass
        return out

    def get_prob_array1d(self, garr):
        garr = np.atleast_1d(np.asarray(garr, dtype="f8"))
        return np.array([self.get_prob_scalar1d(g) for g in garr], dtype="f8")

    def get_fdiff(self, g1, g2):
        """sqrt(max(-2 ln p, 0)) of numpy (g1, g2)"""
        if isinstance(g1, np.ndarray):
            lnp = self.get_lnprob_array2d(g1, g2)
            return np.sqrt(np.clip(-2 * lnp, 0.0, None))
        lnp = self.get_lnprob_scalar2d(g1, g2)
        return np.sqrt(max(-2 * lnp, 0.0))

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

    def sample2d_brute(self, nrand):
        """(g1, g2) by rejection under the density at the centre, a
        check of sample2d (ref: shape.py:98-112)"""
        ceiling = self.get_prob_scalar2d(0.0, 0.0)

        def propose(k):
            cand = self.rng.uniform(low=-1.0, high=1.0, size=(k, 2))
            h = ceiling * self.rng.uniform(size=k)
            p = self.get_prob_array2d(cand[:, 0], cand[:, 1])
            return cand[h < p]

        pairs = draw_until(nrand, propose)
        return pairs[:, 0], pairs[:, 1]

    def set_maxval1d(self, maxguess=0.1):
        """the maximum of the 1-d |g| density (maxval1d) and where it is
        (maxval1d_loc), by scipy's bounded minimize_scalar"""
        from scipy.optimize import minimize_scalar

        res = minimize_scalar(lambda g: -self.get_prob_scalar1d(g),
                              bounds=(1e-6, self.gmax - 1e-4), method="bounded")
        if not res.success:
            raise RuntimeError("failed to find 1d max: %s" % res.message)
        self.maxval1d = -res.fun
        self.maxval1d_loc = res.x

    def fit(self, xdata, ydata, guess=None):
        """fit the family's parameters to a 1-d |g| profile: scipy's
        least_squares of get_prob_array1d against (x, p(x)) with weights
        1 / sqrt(p) (ref: shape.py:140-197). Keeps fit_pars, fit_pars_cov
        (chi2 / dof scaled) and fit_perr, and returns the result dict"""
        from scipy.optimize import least_squares

        x = np.asarray(xdata, dtype="f8")
        y = np.asarray(ydata, dtype="f8")
        keep = y > 0
        x, y = x[keep], y[keep]
        ierr = 1.0 / np.sqrt(y)
        self.xdata, self.ydata, self.ierr = x, y, ierr
        if guess is None:
            guess = self._get_guess(y.sum())

        def resid(pars):
            self.set_pars(pars)
            return (self.get_prob_array1d(x) - y) * ierr

        fit = least_squares(resid, np.asarray(guess, "f8"), max_nfev=4000)
        dof = max(y.size - fit.x.size, 1)
        jtj = fit.jac.T @ fit.jac
        try:
            cov = np.linalg.inv(jtj) * (2 * fit.cost / dof)
        except np.linalg.LinAlgError:
            cov = np.full((fit.x.size, fit.x.size), np.inf)
        self.set_pars(fit.x)
        self.fit_pars = fit.x
        self.fit_pars_cov = cov
        self.fit_perr = np.sqrt(np.abs(np.diag(cov)))
        return {"flags": 0 if fit.success else 1, "pars": fit.x, "pars_cov": cov,
                "pars_err": self.fit_perr, "nfev": fit.nfev}


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

    def _get_guess(self, num):
        """fit()'s starting point from the data's sum and bin width,
        jittered by self.rng (ref: shape.py:260-265)"""
        bin_width = self.xdata[1] - self.xdata[0]
        base = np.array([1.3 * num * bin_width, 0.16])
        return base * (1.0 + 0.2 * self.rng.uniform(-1.0, 1.0, size=2))

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

    def get_prob_scalar1d(self, r):
        return 0.0 if r >= self.radius else 1.0

    def get_prob_scalar2d(self, x, y):
        return 0.0 if x**2 + y**2 >= self.radius_sq else 1.0

    def get_prob_array2d(self, x, y):
        x = np.atleast_1d(np.asarray(x))
        y = np.atleast_1d(np.asarray(y))
        out = np.zeros(x.size)
        out[(x**2 + y**2) < self.radius_sq] = 1.0
        return out

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
