"""The k-space host fits with the joint priors of this slice against
the JAX package's on the same k observations, in float64 on the CPU:
KSpaceFitter "spergel" with PriorSpergelSep and "exp" with
PriorGalsimSimpleSep, both run_lm (tests/test_torch_kspace.py's stamps,
on a grid padded twice). Tolerances: the North star's LM ones, flags
equal, nfev within 2, pars, pars_err, g, flux and s2n_r to rtol 1e-5.
A file of its own: each JAX k-space fit compiles its own closure.
"""
import numpy as np
import pytest
import torch

import ngmix_tpu as jn
from ngmix_tpu import joint_prior as jjp, priors as jpr
from ngmix_tpu.fitting import kspace_fitters as jk

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import convert
from ngmix_tpu_torch.fitting import kspace_fitters as tk

from test_torch_joint_fits import _cen_g
from test_torch_kspace import _assert_fit_equal, _pair

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)


KFITS = {
    "spergel": (lambda r: jjp.PriorSpergelSep(
        *_cen_g(r), jpr.TwoSidedErf(0.01, 0.01, 5.0, 0.1, rng=r),
        jpr.TwoSidedErf(-0.8, 0.05, 3.5, 0.1, rng=r),
        jpr.TwoSidedErf(-100.0, 0.1, 1e9, 1.0, rng=r)),
        dict(g1=0.02, g2=0.0), [0.0, 0.0, 0.0, 0.0, 0.45, 0.8, 90.0]),
    "exp": (lambda r: jjp.PriorGalsimSimpleSep(
        *_cen_g(r), jpr.LMBounds(0.01, 5.0, rng=r),
        jpr.TwoSidedErf(-100.0, 0.1, 1e9, 1.0, rng=r)),
        dict(model="exp", T=0.6), [0.0, 0.0, 0.0, 0.0, 0.5, 90.0]),
}


@pytest.mark.parametrize("name", sorted(KFITS))
def test_kspace_fitter_with_prior_matches_jax(name):
    make, kw, guess = KFITS[name]
    jprior = make(np.random.RandomState(7))
    tprior = convert.prior_from_object(jprior)
    assert type(tprior).__name__ == type(jprior).__name__
    jobs, tobs = _pair(7, **kw)
    jobs, tobs = jn.make_kobs(jobs, pad_factor=2), nt.make_kobs(tobs, pad_factor=2)
    jres = jk.KSpaceFitter(name, prior=jprior).go(jobs, np.array(guess))
    tres = tk.KSpaceFitter(name, prior=tprior).go(tobs, np.array(guess))
    _assert_fit_equal(tres, jres)
    assert tres.fdiff_size == 2 * tres.totpix + tprior.n_prior_pars
