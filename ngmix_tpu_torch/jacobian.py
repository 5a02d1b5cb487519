"""WCS affine jacobian: pixel (row, col) <-> tangent plane (v, u).

The port of ``ngmix_tpu/jacobian.py``. The device representation is
``Jac``, a NamedTuple of (possibly batched) tensors; the host
``Jacobian`` class keeps the reference's constructor modes (row/col,
x/y, wcs=) and float fields, and ``to_device`` makes its ``Jac`` on a
device. The k-space operations read only the four matrix fields
(dvdrow, dvdcol, dudrow, dudcol) of whatever they are given.
"""
from typing import NamedTuple

import numpy as np
import torch

from .util import resolve_device

__all__ = ["Jac", "Jacobian", "DiagonalJacobian", "UnitJacobian"]


class Jac(NamedTuple):
    """device jacobian; fields are 0-d or batched tensors"""

    row0: torch.Tensor
    col0: torch.Tensor
    dvdrow: torch.Tensor
    dvdcol: torch.Tensor
    dudrow: torch.Tensor
    dudcol: torch.Tensor

    @property
    def det(self):
        return self.dvdrow * self.dudcol - self.dvdcol * self.dudrow

    @property
    def scale(self):
        return torch.sqrt(torch.abs(self.det))

    @property
    def area(self):
        return torch.abs(self.det)

    def get_vu(self, row, col):
        """(row, col) -> (v, u); a batched jacobian broadcasts against
        the coordinates' trailing dims"""
        rowdiff = row - self.row0
        coldiff = col - self.col0
        v = self.dvdrow * rowdiff + self.dvdcol * coldiff
        u = self.dudrow * rowdiff + self.dudcol * coldiff
        return v, u

    def get_rowcol(self, v, u):
        """(v, u) -> (row, col), the inverse map"""
        det = self.det
        rowdiff = self.dudcol * v - self.dvdcol * u
        coldiff = -self.dudrow * v + self.dvdrow * u
        return self.row0 + rowdiff / det, self.col0 + coldiff / det


def jac_from_arrays(row0, col0, dvdrow, dvdcol, dudrow, dudcol, dtype=torch.float64,
                    device=None):
    """a Jac of the given values (numbers, arrays or tensors) as tensors
    of dtype on device: the CUDA card unless the caller passes one"""
    device = resolve_device(device)
    return Jac(*(torch.as_tensor(x, dtype=dtype, device=device)
                 for x in (row0, col0, dvdrow, dvdcol, dudrow, dudcol)))


def diagonal_jac(row0, col0, scale=1.0, dtype=torch.float64, device=None):
    """a Jac with scale on the diagonal, broadcast to row0's shape, on
    device: the CUDA card unless the caller passes one"""
    device = resolve_device(device)
    row0 = torch.as_tensor(row0, dtype=dtype, device=device)
    z = torch.zeros_like(row0)
    s = torch.broadcast_to(torch.as_tensor(scale, dtype=dtype, device=device), z.shape)
    return Jac(row0 + z, torch.as_tensor(col0, dtype=dtype, device=device) + z, s, z, z, s)


class Jacobian(object):
    """Host jacobian with the reference's constructor conventions:
    row=, col=, dvdrow=, dvdcol=, dudrow=, dudcol= or x=, y=, dudx=,
    dudy=, dvdx=, dvdy=, or row/col or x/y with wcs= (an object with
    dvdy, dvdx, dudy, dudx)"""

    def __init__(self, **kw):
        if "x" in kw:
            if "wcs" in kw:
                dvdrow, dvdcol, dudrow, dudcol = self._extract_wcs(kw["wcs"])
            else:
                dvdrow, dvdcol = kw["dvdy"], kw["dvdx"]
                dudrow, dudcol = kw["dudy"], kw["dudx"]
            row0, col0 = kw["y"], kw["x"]
        elif "row" in kw:
            if "wcs" in kw:
                dvdrow, dvdcol, dudrow, dudcol = self._extract_wcs(kw["wcs"])
            else:
                for k in ("dvdrow", "dvdcol", "dudrow", "dudcol"):
                    if k not in kw:
                        raise ValueError("missing keyword: '%s'" % k)
                dvdrow, dvdcol = kw["dvdrow"], kw["dvdcol"]
                dudrow, dudcol = kw["dudrow"], kw["dudcol"]
            row0, col0 = kw["row"], kw["col"]
        else:
            raise ValueError("send by row,col or x,y")

        self._set(row0, col0, dvdrow, dvdcol, dudrow, dudcol)

    @staticmethod
    def _extract_wcs(wcs):
        return wcs.dvdy, wcs.dvdx, wcs.dudy, wcs.dudx

    def _set(self, row0, col0, dvdrow, dvdcol, dudrow, dudcol):
        self._row0 = float(row0)
        self._col0 = float(col0)
        self._dvdrow = float(dvdrow)
        self._dvdcol = float(dvdcol)
        self._dudrow = float(dudrow)
        self._dudcol = float(dudcol)

    # --- accessors -----------------------------------------------------
    @property
    def row0(self):
        return self._row0

    @property
    def col0(self):
        return self._col0

    @property
    def dvdrow(self):
        return self._dvdrow

    @property
    def dvdcol(self):
        return self._dvdcol

    @property
    def dudrow(self):
        return self._dudrow

    @property
    def dudcol(self):
        return self._dudcol

    @property
    def det(self):
        return self._dvdrow * self._dudcol - self._dvdcol * self._dudrow

    @property
    def scale(self):
        return float(np.sqrt(np.abs(self.det)))

    @property
    def area(self):
        return self.scale**2

    def get_cen(self):
        return self._row0, self._col0

    cen = property(fget=get_cen)

    def get_det(self):
        return self.det

    def get_scale(self):
        return self.scale

    def get_area(self):
        return self.area

    def get_vu(self, row, col):
        rowdiff = np.asarray(row) - self._row0
        coldiff = np.asarray(col) - self._col0
        v = self._dvdrow * rowdiff + self._dvdcol * coldiff
        u = self._dudrow * rowdiff + self._dudcol * coldiff
        return v, u

    def get_rowcol(self, v, u):
        det = self.det
        rowdiff = self._dudcol * np.asarray(v) - self._dvdcol * np.asarray(u)
        coldiff = -self._dudrow * np.asarray(v) + self._dvdrow * np.asarray(u)
        return self._row0 + rowdiff / det, self._col0 + coldiff / det

    def __call__(self, row, col):
        return self.get_vu(row, col)

    def set_cen(self, **kw):
        if "row" in kw:
            self._row0, self._col0 = float(kw["row"]), float(kw["col"])
        elif "x" in kw:
            self._row0, self._col0 = float(kw["y"]), float(kw["x"])
        else:
            raise ValueError("expected row=,col= or x=,y=")

    def copy(self):
        return Jacobian(
            row=self._row0,
            col=self._col0,
            dvdrow=self._dvdrow,
            dvdcol=self._dvdcol,
            dudrow=self._dudrow,
            dudcol=self._dudcol,
        )

    def __copy__(self):
        return self.copy()

    def __deepcopy__(self, memo):
        result = self.copy()
        memo[id(self)] = result
        return result

    def __eq__(self, other):
        if not isinstance(other, Jacobian):
            raise ValueError(f"expected Jacobian, got {type(other)}")
        return self.asarray().tolist() == other.asarray().tolist()

    def to_device(self, device=None, dtype=torch.float64):
        """the Jac of this jacobian on device: the CUDA card unless the
        caller passes one (util.resolve_device)"""
        return jac_from_arrays(*self.asarray(), dtype=dtype, device=device)

    def asarray(self):
        """[6] array (row0, col0, dvdrow, dvdcol, dudrow, dudcol)"""
        return np.array(
            [
                self._row0,
                self._col0,
                self._dvdrow,
                self._dvdcol,
                self._dudrow,
                self._dudcol,
            ]
        )

    def __repr__(self):
        fmt = (
            "ngmix_tpu_torch.Jacobian(row=%r, col=%r, dvdrow=%r, "
            "dvdcol=%r, dudrow=%r, dudcol=%r)"
        )
        return fmt % tuple(self.asarray().tolist())


class DiagonalJacobian(Jacobian):
    """scale on the diagonal"""

    def __init__(self, scale=1.0, **kw):
        if "x" in kw:
            super().__init__(
                x=kw["x"], y=kw["y"], dudx=scale, dudy=0.0, dvdx=0.0, dvdy=scale
            )
        elif "row" in kw:
            super().__init__(
                row=kw["row"],
                col=kw["col"],
                dvdrow=scale,
                dvdcol=0.0,
                dudrow=0.0,
                dudcol=scale,
            )
        else:
            raise ValueError("expected row=,col= or x=,y=")


class UnitJacobian(DiagonalJacobian):
    def __init__(self, **kw):
        super().__init__(scale=1.0, **kw)
