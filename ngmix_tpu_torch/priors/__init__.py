"""The device side of the priors: the tensor functions that the LM's
prior rows evaluate (``get_lnprob_device``, ``get_fdiff_device`` and
their closed-form derivatives). Sampling and the rest of the host API
are not ported."""
from .multivariate import CenPrior, SimpleGauss2D
from .priors import (
    FlatPrior,
    LogNormal,
    Normal,
    PriorBase,
    Sinh,
    TruncatedGaussian,
    TwoSidedErf,
)
from .shape import GPriorBA, GPriorBase, GPriorGauss, ZDisk2D

__all__ = [
    "CenPrior",
    "FlatPrior",
    "GPriorBA",
    "GPriorBase",
    "GPriorGauss",
    "LogNormal",
    "Normal",
    "PriorBase",
    "SimpleGauss2D",
    "Sinh",
    "TruncatedGaussian",
    "TwoSidedErf",
    "ZDisk2D",
]
