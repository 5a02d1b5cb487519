"""Gaussian mixtures in N dimensions (GMixND) for empirical priors: the
port of ``ngmix_tpu/gmix_ndim.py``.

The mixture's weights, means and covariances are numpy arrays, as in
the JAX package. ``get_lnprob_array`` / ``get_prob_array`` evaluate a
whole catalog [N, ndim] as float64 tensors on the mixture's device
(the CUDA card unless the constructor is given ``device="cpu"``): the
chi2 of every row to every gaussian, then a log-sum-exp over the
gaussians. ``get_lnprob_scalar`` / ``get_prob_scalar`` evaluate one
row the same way. ``fit`` uses sklearn's GaussianMixture;
``save_mixture`` / ``load_mixture`` use fitsio when it is installed and
an npz file when it is not.
"""
import numpy as np
import torch

from .util import resolve_device

__all__ = ["GMixND"]


class GMixND(object):
    """gaussian mixture in any number of dimensions (ref:
    gmix_ndim.py:16-172); device: where the evaluations run, None for
    the CUDA card"""

    def __init__(self, weights=None, means=None, covars=None, file=None, rng=None,
                 device=None):
        if rng is None:
            rng = np.random.RandomState()
        self.rng = rng
        self.device = device
        if file is not None:
            self.load_mixture(file)
        elif weights is not None and means is not None and covars is not None:
            self.set_mixture(weights, means, covars)
        elif weights is not None or means is not None or covars is not None:
            raise RuntimeError("send all or none of weights, means, covars")

    def set_mixture(self, weights, means, covars):
        weights = np.array(weights, dtype="f8", copy=True)
        means = np.array(means, dtype="f8", copy=True)
        covars = np.array(covars, dtype="f8", copy=True)
        if len(means.shape) == 1:
            means = means.reshape((means.size, 1))
        if len(covars.shape) == 1:
            covars = covars.reshape((covars.size, 1, 1))
        self.weights = weights
        self.means = means
        self.covars = covars
        self.ngauss = weights.size
        self.ndim = means.shape[1]
        self._calc_icovars_and_norms()

    def _calc_icovars_and_norms(self):
        twopi = 2.0 * np.pi
        norms = np.zeros(self.ngauss)
        icovars = np.zeros((self.ngauss, self.ndim, self.ndim))
        for i in range(self.ngauss):
            cov = self.covars[i]
            icovars[i] = np.linalg.inv(cov)
            det = np.linalg.det(cov)
            norms[i] = 1.0 / np.sqrt(twopi**self.ndim * det)
        self.norms = norms
        self.pnorms = norms * self.weights
        self.log_pnorms = np.log(self.pnorms)
        self.icovars = icovars
        self._tensors = None

    def _mixture_tensors(self):
        """(means, icovars, log_pnorms) as float64 tensors on the device,
        made once a mixture"""
        if self._tensors is None:
            dev = resolve_device(self.device)
            self._tensors = tuple(torch.as_tensor(x, dtype=torch.float64, device=dev)
                                  for x in (self.means, self.icovars, self.log_pnorms))
        return self._tensors

    def get_lnprob_device(self, pars, component=None):
        """ln(prob) [...] of pars [..., ndim] (a tensor or an array) as a
        float64 tensor on the mixture's device; one gaussian's term for
        an integer component"""
        means, icov, logpn = self._mixture_tensors()
        pars = torch.as_tensor(pars, dtype=torch.float64, device=means.device)
        xdiff = pars[..., None, :] - means  # [..., ngauss, ndim]
        chi2 = torch.einsum("...gi,gij,...gj->...g", xdiff, icov, xdiff)
        lnp = -0.5 * chi2 + logpn
        if component is not None:
            return lnp[..., component]
        m = torch.amax(lnp, dim=-1)
        return torch.log(torch.sum(torch.exp(lnp - m[..., None]), dim=-1)) + m

    def get_lnprob_scalar(self, pars_in, component=None):
        pars = np.array(pars_in, dtype="f8", ndmin=1)
        return float(self.get_lnprob_device(pars, component=component))

    def get_prob_scalar(self, pars_in, component=None):
        return float(np.exp(self.get_lnprob_scalar(pars_in, component)))

    def get_lnprob_array(self, pars, component=None):
        """ln(prob) [N] of a catalog [N, ndim] (or [N] in one dimension),
        as numpy"""
        pars = np.array(pars, dtype="f8", ndmin=1)
        if len(pars.shape) == 1:
            pars = pars[:, np.newaxis]
        return self.get_lnprob_device(pars, component=component).cpu().numpy()

    def get_prob_array(self, pars, component=None):
        return np.exp(self.get_lnprob_array(pars, component=component))

    @property
    def converged(self):
        return self._gmm.converged_

    def fit(self, data, ngauss, n_iter=5000, min_covar=1.0e-6, **keys):
        """fit the mixture to data [N, ndim] with sklearn's
        GaussianMixture (full covariances, random_state self.rng)"""
        from sklearn.mixture import GaussianMixture

        data = np.asarray(data)
        if len(data.shape) == 1:
            data = data[:, np.newaxis]
        gmm = GaussianMixture(n_components=ngauss, max_iter=n_iter, reg_covar=min_covar,
                              covariance_type="full", random_state=self.rng)
        gmm.fit(data)
        if not gmm.converged_:
            print("DID NOT CONVERGE")
        self._gmm = gmm
        self.set_mixture(gmm.weights_, gmm.means_, gmm.covariances_)

    def sample(self, n=None):
        """draws from the mixture: a component by weight, then its
        gaussian, from self.rng"""
        nuse = 1 if n is None else n
        rng = self.rng
        comps = rng.choice(self.ngauss, size=nuse, p=self.weights / self.weights.sum())
        samples = np.zeros((nuse, self.ndim))
        for i, c in enumerate(comps):
            samples[i] = rng.multivariate_normal(self.means[c], self.covars[c])
        if self.ndim == 1:
            samples = samples[:, 0]
        return samples[0] if n is None else samples

    def save_mixture(self, fname):
        """weights, means and covars to a FITS file with fitsio, or to an
        npz file without it"""
        try:
            import fitsio

            with fitsio.FITS(fname, "rw", clobber=True) as fits:
                fits.write(self.weights, extname="weights")
                fits.write(self.means, extname="means")
                fits.write(self.covars, extname="covars")
        except ImportError:
            np.savez(fname, weights=self.weights, means=self.means, covars=self.covars)

    def load_mixture(self, fname):
        try:
            import fitsio

            with fitsio.FITS(fname) as fits:
                weights = fits["weights"].read()
                means = fits["means"].read()
                covars = fits["covars"].read()
        except ImportError:
            data = np.load(fname if str(fname).endswith(".npz") else str(fname) + ".npz")
            weights = data["weights"]
            means = data["means"]
            covars = data["covars"]
        self.set_mixture(weights, means, covars)
