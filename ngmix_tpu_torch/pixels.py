"""Pixel structs: full [..., npix] grids with ierr = 0 marking absent pixels.

The port of ``ngmix_tpu/pixels.py: Pixels``.
"""
from typing import NamedTuple

import torch


class Pixels(NamedTuple):
    """pixel struct; all fields [..., npix]"""

    v: torch.Tensor
    u: torch.Tensor
    area: torch.Tensor
    val: torch.Tensor
    ierr: torch.Tensor
