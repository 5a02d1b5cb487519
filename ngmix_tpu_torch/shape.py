"""Reduced-shear ellipticity algebra.

Ports of ``ngmix_tpu/shape.py``: elementwise on tensors of any shape,
never raising: out-of-range inputs are clipped to |g| or |e| =
ONE_MINUS_EPS. The conversions from line ``g1g2_to_eta1eta2`` on also
take numbers and numpy arrays (as float64 tensors). The host-facing
``Shape`` class keeps the reference's raising behavior.
"""
import numpy as np
import torch

from .gexceptions import GMixRangeError

ONE_MINUS_EPS = 0.9999999999999999


def shear_reduced(g1, g2, s1, s2):
    """Reduced-shear addition: apply shear (s1, s2) to shape (g1, g2)."""
    A = 1 + g1 * s1 + g2 * s2
    B = g2 * s1 - g1 * s2
    denom_inv = 1.0 / (A * A + B * B)

    g1o = (A * (g1 + s1) + B * (g2 + s2)) * denom_inv
    g2o = (A * (g2 + s2) - B * (g1 + s1)) * denom_inv
    return g1o, g2o


def _clip_scale(sq):
    """factor that brings a squared magnitude >= 1 to ONE_MINUS_EPS"""
    big = sq >= 1.0
    return torch.where(
        big, ONE_MINUS_EPS / torch.sqrt(torch.where(big, sq, 1.0)), 1.0
    )


def g1g2_to_e1e2(g1, g2):
    """g -> e: e = 2 g / (1 + |g|^2), with |g| clipped below 1."""
    scale = _clip_scale(g1 * g1 + g2 * g2)
    g1c = g1 * scale
    g2c = g2 * scale
    fac = 2.0 / (1.0 + g1c * g1c + g2c * g2c)
    return fac * g1c, fac * g2c


def e1e2_to_g1g2(e1, e2):
    """e -> g: g = e / (1 + sqrt(1 - |e|^2)), with |e| clipped below 1."""
    scale = _clip_scale(e1 * e1 + e2 * e2)
    e1c = e1 * scale
    e2c = e2 * scale
    esqc = e1c * e1c + e2c * e2c
    fac = 1.0 / (1.0 + torch.sqrt(torch.clamp(1.0 - esqc, min=0.0)))
    return fac * e1c, fac * e2c


def _t(x):
    """x as a tensor: numbers and numpy arrays become float64"""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=torch.float64)


def _safe_ratio(num_mag, mag):
    """num_mag / mag with the mag == 0 limit -> 1"""
    return torch.where(mag == 0.0, 1.0, num_mag / torch.where(mag == 0.0, 1.0, mag))


def g1g2_to_eta1eta2(g1, g2):
    """g -> eta: eta = 2 atanh(g)"""
    g1, g2 = _t(g1), _t(g2)
    g = torch.sqrt(g1 * g1 + g2 * g2)
    gc = torch.clamp(g, 0.0, ONE_MINUS_EPS)
    fac = _safe_ratio(2 * torch.atanh(gc), gc)
    return fac * g1, fac * g2


def e1e2_to_eta1eta2(e1, e2):
    """e -> eta: eta = atanh(e)"""
    e1, e2 = _t(e1), _t(e2)
    e = torch.sqrt(e1 * e1 + e2 * e2)
    ec = torch.clamp(e, 0.0, ONE_MINUS_EPS)
    fac = _safe_ratio(torch.atanh(ec), ec)
    return fac * e1, fac * e2


def eta1eta2_to_g1g2(eta1, eta2):
    """eta -> g: g = tanh(eta / 2)"""
    eta1, eta2 = _t(eta1), _t(eta2)
    eta = torch.sqrt(eta1 * eta1 + eta2 * eta2)
    fac = _safe_ratio(torch.tanh(0.5 * eta), eta)
    return fac * eta1, fac * eta2


def dgs_by_dgo_jacob(g1, g2, s1, s2):
    """|dgs/dgo| jacobian of the shear transform"""
    ssq = s1 * s1 + s2 * s2
    num = (ssq - 1) ** 2
    denom = (1 + 2 * g1 * s1 + 2 * g2 * s2 + g1**2 * ssq + g2**2 * ssq) ** 2
    return num / denom


def get_round_factor(g1, g2):
    """T_round = T * f(g1, g2)"""
    gsq = g1**2 + g2**2
    return (1 - gsq) / (1 + gsq)


def rotate_shape(g1, g2, theta):
    """rotate shapes by angle theta (radians)"""
    twotheta = 2.0 * _t(theta)
    c = torch.cos(twotheta)
    s = torch.sin(twotheta)
    return g1 * c + g2 * s, -g1 * s + g2 * c


def g_range_flag(g1, g2):
    """1 where |g| >= 1 (invalid), else 0, int32"""
    g2sum = _t(g1) ** 2 + _t(g2) ** 2
    return (g2sum >= 1.0).to(torch.int32)


class Shape(object):
    """Host-side reduced-shear shape with range checking."""

    def __init__(self, g1, g2):
        self.set_g1g2(g1, g2)

    def set_g1g2(self, g1, g2):
        self.g1 = g1
        self.g2 = g2
        g = np.sqrt(g1 * g1 + g2 * g2)
        if g >= 1.0:
            raise GMixRangeError("g out of range: %.16g" % g)
        self.g = g

    def get_sheared(self, s1, s2=None):
        if isinstance(s1, Shape):
            s1, s2 = s1.g1, s1.g2
        elif s2 is None:
            raise ValueError("send s1,s2 or a Shape")
        g1, g2 = shear_reduced(self.g1, self.g2, s1, s2)
        return Shape(float(g1), float(g2))

    def __neg__(self):
        return Shape(-self.g1, -self.g2)

    def get_rotated(self, theta_radians):
        g1, g2 = rotate_shape(self.g1, self.g2, theta_radians)
        return Shape(float(g1), float(g2))

    def rotate(self, theta_radians):
        sh = self.get_rotated(theta_radians)
        self.set_g1g2(sh.g1, sh.g2)

    def copy(self):
        return Shape(self.g1, self.g2)

    def __repr__(self):
        return "(%.16g, %.16g)" % (self.g1, self.g2)
