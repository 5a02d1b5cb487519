"""The priors: the tensor functions that the LM's prior rows evaluate
(``get_lnprob_device``, ``get_fdiff_device`` and their closed-form
derivatives), and the host methods that the guessers and the host
fitters call (``sample``, ``sample1d`` / ``sample2d``,
``get_lnprob_scalar`` / ``get_lnprob_scalar2d``) in numpy over each
prior's generator; ``make_rng`` and ``srandu`` as in the JAX
package."""
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
from .random import make_rng, srandu
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
    "make_rng",
    "srandu",
]
