"""The priors: the tensor functions that the LM's prior rows evaluate
(``get_lnprob_device``, ``get_fdiff_device`` and their closed-form
derivatives), and the host methods (``sample``, ``sample1d`` /
``sample2d``, ``get_lnprob_scalar`` / ``get_lnprob_scalar2d``, the
probabilities, ``get_fdiff``, the fits) in numpy over each prior's
generator; ``LMBounds``, ``Bounded1D`` / ``LimitPDF``, ``KDE``,
``make_rng`` and ``srandu`` as in the JAX package."""
from .kde import KDE
from .multivariate import CenPrior, SimpleGauss2D
from .priors import (
    Bounded1D,
    FlatPrior,
    LimitPDF,
    LMBounds,
    LogNormal,
    Normal,
    PriorBase,
    Sinh,
    TruncatedGaussian,
    TwoSidedErf,
)
from .random import make_rng, srandu
from .shape import GPriorBA, GPriorBase, GPriorGauss, ZDisk2D

__all__ = [
    "Bounded1D",
    "CenPrior",
    "FlatPrior",
    "GPriorBA",
    "GPriorBase",
    "GPriorGauss",
    "KDE",
    "LimitPDF",
    "LMBounds",
    "LogNormal",
    "Normal",
    "PriorBase",
    "SimpleGauss2D",
    "Sinh",
    "TruncatedGaussian",
    "TwoSidedErf",
    "ZDisk2D",
    "make_rng",
    "srandu",
]
