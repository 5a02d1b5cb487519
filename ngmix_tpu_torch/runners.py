"""Runners: the retry loop and the container fan-out around the host
fitters, the port of ``ngmix_tpu/runners.py`` (Runner, PSFRunner,
run_fitter, run_psf_fitter) over the port's ``containers.obs_map``.
Each try draws a fresh guess from the guesser and the loop stops at
the first result with flags 0.
"""
from .containers import obs_map

__all__ = ["RunnerBase", "Runner", "PSFRunner", "run_fitter",
           "run_psf_fitter"]


def run_fitter(obs, fitter, guesser=None, ntry=1):
    """Run ``fitter.go`` up to ``ntry`` times with fresh guesses.

    Returns the last result; callers inspect ``result['flags']``.
    Parity: ngmix/runners.py:116-149.
    """
    result = None
    for _ in range(max(int(ntry), 1)):
        if guesser is None:
            result = fitter.go(obs=obs)
        else:
            result = fitter.go(obs=obs, guess=guesser(obs=obs))
        if result["flags"] == 0:
            break
    return result


def run_psf_fitter(obs, fitter, guesser=None, ntry=1, set_result=True):
    """Fit the PSF of every epoch in the container.

    Each leaf fits its attached ``.psf`` observation (or the leaf
    itself when none is attached). With ``set_result``, the fit result
    lands in the target's ``meta['result']`` and, on success, its
    ``gmix``. Returns results in the input's nesting.
    Parity: ngmix/runners.py:152-223.
    """

    def fit_one(single_obs):
        target = single_obs.psf if single_obs.has_psf() else single_obs
        result = run_fitter(
            obs=target, fitter=fitter, guesser=guesser, ntry=ntry
        )
        if set_result:
            target.meta["result"] = result
            if result["flags"] == 0 and hasattr(result, "get_gmix"):
                target.gmix = result.get_gmix()
        return result

    return obs_map(obs, fit_one)


class RunnerBase(object):
    """Common state for runners: fitter + guesser + retry count."""

    def __init__(self, fitter, guesser=None, ntry=1):
        self.fitter = fitter
        self.guesser = guesser
        self.ntry = ntry


class Runner(RunnerBase):
    """Object-fit runner (parity: ngmix/runners.py:28-59)."""

    def go(self, obs):
        return run_fitter(
            obs=obs, fitter=self.fitter, guesser=self.guesser,
            ntry=self.ntry,
        )


class PSFRunner(RunnerBase):
    """PSF-fit runner over containers (parity: ngmix/runners.py:62-113)."""

    def __init__(self, fitter, guesser=None, ntry=1, set_result=True):
        super().__init__(fitter=fitter, guesser=guesser, ntry=ntry)
        self.set_result = set_result

    def go(self, obs):
        return run_psf_fitter(
            obs=obs, fitter=self.fitter, guesser=self.guesser,
            ntry=self.ntry, set_result=self.set_result,
        )
