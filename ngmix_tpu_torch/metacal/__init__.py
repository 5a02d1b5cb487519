"""Metacalibration: the k-space operations of the batched engine and
the host API's image engines, get_all_metacal and the bootstrapper."""
# flake8: noqa
from . import azgauss_target_psf, fitgauss_target_psf, kops
from .azgauss_target_psf import get_azgauss_target_psf
from .fitgauss_target_psf import get_fitgauss_target_psf
from .bootstrap import MetacalBootstrapper, metacal_bootstrap
from .convenience import get_all_metacal
from .defaults import DEFAULT_STEP, METACAL_MINIMAL_TYPES, METACAL_TYPES
from .metacal import (
    MetacalAnalyticPSF,
    MetacalAzGaussPSF,
    MetacalDilatePSF,
    MetacalFitGaussPSF,
    MetacalGaussPSF,
)
