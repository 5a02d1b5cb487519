"""The psf-then-object bootstrap: the port of ``ngmix_tpu/bootstrap.py``.

Fit every epoch's psf, drop (optionally) the epochs whose psf fit
failed, then run the object fitter on what remains, over the port's
containers module.
"""
import logging

from .containers import obs_prune
from .gexceptions import BootPSFFailure

__all__ = ["Bootstrapper", "bootstrap", "remove_failed_psf_obs"]

# the bootstrap's diagnostic flag bits
BOOT_S2N_LOW = 2**0
BOOT_R2_LOW = 2**1
BOOT_R4_LOW = 2**2
BOOT_TS2N_ROUND_FAIL = 2**3
BOOT_ROUND_CONVOLVE_FAIL = 2**4
BOOT_WEIGHTS_LOW = 2**5

logger = logging.getLogger(__name__)


def bootstrap(obs, runner, psf_runner=None, ignore_failed_psf=True):
    """the psf fits first, then the object fit.

    With ``ignore_failed_psf`` the epochs whose psf fit carries nonzero
    flags are dropped before the object stage; an object with no epoch
    left raises BootPSFFailure. The psf runner stores
    ``meta['result']`` (and a gmix on success) on each psf observation.
    """
    if psf_runner is not None:
        psf_runner.go(obs=obs)
        if ignore_failed_psf:
            obs = remove_failed_psf_obs(obs=obs)
    return runner.go(obs=obs)


def remove_failed_psf_obs(obs):
    """drop the epochs whose psf fit failed: a rebuilt container of the
    same type; raises BootPSFFailure if no epoch (or a whole band) is
    left"""
    kept = obs_prune(obs, _psf_fit_succeeded)
    if kept is None:
        raise BootPSFFailure("no good psf fits")
    return kept


def _psf_fit_succeeded(single_obs):
    return single_obs.psf.meta["result"]["flags"] == 0


class Bootstrapper(object):
    """an object runner and a psf runner in one ``go(obs=...)``"""

    def __init__(self, runner, psf_runner=None, ignore_failed_psf=True):
        self.runner = runner
        self.psf_runner = psf_runner
        self.ignore_failed_psf = ignore_failed_psf

    @property
    def fitter(self):
        return self.runner.fitter

    def go(self, obs):
        return bootstrap(
            obs=obs,
            runner=self.runner,
            psf_runner=self.psf_runner,
            ignore_failed_psf=self.ignore_failed_psf,
        )
