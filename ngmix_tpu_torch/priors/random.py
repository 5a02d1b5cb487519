"""Random-number helpers of the host API: the port's copy of
``ngmix_tpu/priors/random.py``. Sampling is numpy over a caller's
``RandomState``, so a generator in the same state draws the same
numbers in both packages."""
import numpy as np


def make_rng(rng=None):
    """a numpy RandomState: a new one for None, one seeded from rng for
    a seed, rng itself for a RandomState"""
    if rng is None:
        rng = np.random.RandomState()
    elif not isinstance(rng, np.random.RandomState):
        rng = np.random.RandomState(seed=rng)
    return rng


def srandu(nrand=None, rng=None):
    """uniform deviates in [-1, 1)"""
    rng = make_rng(rng)
    return rng.uniform(low=-1.0, high=1.0, size=nrand)
