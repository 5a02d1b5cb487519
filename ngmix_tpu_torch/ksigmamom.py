"""alias module of the ksigma pre-psf moments (``ngmix_tpu/ksigmamom.py``)"""
from .prepsfmom import KSigmaMom  # noqa: F401
