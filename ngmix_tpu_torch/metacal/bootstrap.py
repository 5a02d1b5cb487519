"""One-call metacal: the sheared image set and the fits of each type,
the port of ``ngmix_tpu/metacal/bootstrap.py``. Each type's psf fits
and object fit run through bootstrap.bootstrap on the observations'
device: a Fitter("gauss") psf fit is one K3 launch, an object fit one
K3 launch or GaussMom's K2 launch.
"""
from ..bootstrap import bootstrap
from .convenience import get_all_metacal

__all__ = ["MetacalBootstrapper", "metacal_bootstrap"]


class MetacalBootstrapper(object):
    """make the metacal sheared images and run a fitter on each"""

    def __init__(self, runner, psf_runner, ignore_failed_psf=True, rng=None,
                 **metacal_kws):
        self.runner = runner
        self.psf_runner = psf_runner
        self.ignore_failed_psf = ignore_failed_psf
        self.metacal_kws = metacal_kws
        self.rng = rng

    def go(self, obs):
        return metacal_bootstrap(
            obs=obs,
            runner=self.runner,
            psf_runner=self.psf_runner,
            ignore_failed_psf=self.ignore_failed_psf,
            rng=self.rng,
            **self.metacal_kws,
        )

    @property
    def fitter(self):
        return self.runner.fitter


def metacal_bootstrap(obs, runner, psf_runner=None, ignore_failed_psf=True,
                      rng=None, **metacal_kws):
    """the metacal image set and each type's bootstrap; returns
    (resdict, obsdict)"""
    obsdict = get_all_metacal(obs=obs, rng=rng, **metacal_kws)

    resdict = {}
    for key, tobs in obsdict.items():
        resdict[key] = bootstrap(
            obs=tobs, runner=runner, psf_runner=psf_runner,
            ignore_failed_psf=ignore_failed_psf,
        )
    return resdict, obsdict
