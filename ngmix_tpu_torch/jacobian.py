"""The WCS matrix fields that the k-space operations read.

The subset of ``ngmix_tpu/jacobian.py: Jacobian`` the slice needs: the
linear map (row, col) -> (v, u) of a shared WCS.
"""
from typing import NamedTuple


class Jacobian(NamedTuple):
    dvdrow: float
    dvdcol: float
    dudrow: float
    dudcol: float
