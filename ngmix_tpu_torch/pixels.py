"""Pixel structs: full [..., npix] grids with ierr = 0 marking absent pixels.

The port of ``ngmix_tpu/pixels.py``. The reference compacts each stamp
to its positive-weight pixels; here every stamp keeps its full H*W
grid and pixels of zero or negative weight carry ierr = 0, which every
evaluation treats as "pixel absent".
"""
from typing import NamedTuple

import numpy as np
import torch

from .jacobian import Jac


class Coords(NamedTuple):
    """tangent-plane coordinate grid; all [..., npix]"""

    v: torch.Tensor
    u: torch.Tensor
    area: torch.Tensor


class Pixels(NamedTuple):
    """pixel struct; all fields [..., npix]"""

    v: torch.Tensor
    u: torch.Tensor
    area: torch.Tensor
    val: torch.Tensor
    ierr: torch.Tensor

    @property
    def coords(self):
        return Coords(self.v, self.u, self.area)

    @property
    def mask(self):
        return self.ierr > 0


def grid_rowcol(dims, dtype=torch.float64, device=None):
    """flat (row, col) index grids [H*W] of a stamp of shape dims"""
    nrow, ncol = dims
    rows = torch.arange(nrow, dtype=dtype, device=device)
    cols = torch.arange(ncol, dtype=dtype, device=device)
    rr, cc = torch.meshgrid(rows, cols, indexing="ij")
    return rr.reshape(-1), cc.reshape(-1)


def make_coords(dims, jac: Jac):
    """coordinate grid [..., H*W] of a stamp of shape dims (H, W) on the
    jacobian's device and dtype; the jac fields may carry leading
    batch dims, which broadcast against the grid"""
    rows, cols = grid_rowcol(dims, dtype=jac.row0.dtype, device=jac.row0.device)
    v, u = jac.get_vu(
        rows + torch.zeros_like(jac.row0[..., None]),
        cols + torch.zeros_like(jac.col0[..., None]),
    )
    area = torch.broadcast_to(jac.area[..., None], v.shape)
    return Coords(v, u, area)


def _copied(x, dtype, device):
    """x as a tensor that shares no memory with a numpy array (of any
    strides: np.rot90 and flips give negative ones)"""
    if isinstance(x, np.ndarray):
        return torch.tensor(np.ascontiguousarray(x), dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)


def make_pixels(image, weight, jac: Jac, ignore_zero_weight=True):
    """image [..., H, W] + weight + jacobian -> Pixels [..., H*W] on the
    jacobian's device and dtype: ierr = sqrt(weight), 0 where the
    weight is <= 0. Nothing is dropped, so ignore_zero_weight changes
    nothing (it is taken for the reference's signature)."""
    dtype, device = jac.row0.dtype, jac.row0.device
    image = _copied(image, dtype, device)
    coords = make_coords(tuple(image.shape[-2:]), jac)
    val = image.reshape(image.shape[:-2] + (-1,))
    w = _copied(weight, dtype, device).reshape(val.shape)
    ierr = torch.sqrt(torch.clamp(w, min=0.0))
    del ignore_zero_weight
    v = torch.broadcast_to(coords.v, val.shape)
    u = torch.broadcast_to(coords.u, val.shape)
    area = torch.broadcast_to(coords.area, val.shape)
    return Pixels(v=v, u=u, area=area, val=val, ierr=ierr)
