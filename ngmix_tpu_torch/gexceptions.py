"""Exception hierarchy of the host API.

The port's own copy of ``ngmix_tpu/gexceptions.py``. Device code never
raises: invalid parameter regions set flag bits (flags.py). These
exceptions belong to the host-facing layer (GMix, the fitters).
"""


class NGmixBaseException(Exception):
    """Base exception class"""

    def __init__(self, value):
        super().__init__(value)
        self.value = value

    def __str__(self):
        return repr(self.value)


class GMixRangeError(NGmixBaseException):
    """Some number was out of range."""


class GMixFatalError(NGmixBaseException):
    """A fatal error in the gaussian mixtures."""


class GMixMaxIterEM(NGmixBaseException):
    """EM algorithm hit max iter."""


class PSFFluxFailure(NGmixBaseException):
    """Failure to fit PSF fluxes."""


class BootPSFFailure(NGmixBaseException):
    """Failure to bootstrap PSF."""


class BootGalFailure(NGmixBaseException):
    """Failure to bootstrap galaxy."""


class FFTRangeError(NGmixBaseException):
    """FFT size is not correct/consistent."""
