"""Reduced-shear ellipticity algebra (the subset the slice needs).

Ports of ``ngmix_tpu/shape.py``: elementwise on tensors of any shape,
never raising: out-of-range inputs are clipped to |g| or |e| =
ONE_MINUS_EPS.
"""
import torch

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
