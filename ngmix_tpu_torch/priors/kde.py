"""A kernel density estimate as a prior: the port of
``ngmix_tpu/priors/kde.py``, scipy's ``gaussian_kde`` sampled with the
caller's numpy generator, on the host."""
import scipy.stats


class KDE(object):
    """scipy.stats.gaussian_kde of data [n] or [n, ndim] with the
    bandwidth factor kde_factor; ``sample`` draws from rng, a numpy
    RandomState (ref: kde.py:5-23)"""

    def __init__(self, data, kde_factor, rng):
        self.rng = rng
        self.is_1d = len(data.shape) == 1
        self.kde = scipy.stats.gaussian_kde(data.transpose(), bw_method=kde_factor)

    def sample(self, nrand=None):
        n = 1 if nrand is None else nrand
        r = self.kde.resample(size=n, seed=self.rng).transpose()
        if self.is_1d:
            r = r[:, 0]
        return r[0] if nrand is None else r
