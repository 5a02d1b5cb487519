"""The exponential of the host API (``ngmix_tpu/fastexp.py``).

``fexp`` is the exact exponential, as in the JAX package; the
apodization window that defines the fit objective lives in gmix.core
and is re-exported here.
"""
import torch

from .defaults import FASTEXP_APOD_CHI2, FASTEXP_MAX_CHI2  # noqa: F401
from .gmix.core import apod_window, apod_window_deriv  # noqa: F401


def fexp(x):
    """exact exponential of a tensor, array or number, as a tensor"""
    return torch.exp(torch.as_tensor(x))


fexp_arr = fexp
