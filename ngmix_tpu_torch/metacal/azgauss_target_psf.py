"""The azimuthally averaged round-gaussian target psf: the port of
``ngmix_tpu/metacal/azgauss_target_psf.py``.

The derivation is the k-space threshold crossing of
kops.azgauss_target_sigma; this module keeps the reference's entry
point. The input is the psf's centered k transform and its |k|^2 grid,
the return a round GMixModel.
"""
import numpy as np
import torch

from ..gmix.gmix import GMixModel
from .kops import azgauss_target_sigma  # noqa: F401

SMALL_KVAL = 3.0e-2
SMALLER_KVAL = 9.0e-3


def get_azgauss_target_psf(psfhat, ksq, nbin, flux=1.0,
                           small_kval=SMALL_KVAL,
                           smaller_kval=SMALLER_KVAL):
    """the round gaussian target pinned below the psf's azimuthally
    averaged k profile, psfhat and ksq [N, N] tensors; returns a
    GMixModel ('gauss') of the requested flux"""
    sigma = float(
        azgauss_target_sigma(
            torch.as_tensor(psfhat)[None], torch.as_tensor(ksq), nbin,
            small_kval=small_kval, smaller_kval=smaller_kval,
        )[0]
    )
    T = 2.0 * sigma**2
    return GMixModel(np.array([0.0, 0.0, 0.0, 0.0, T, flux]), "gauss")
