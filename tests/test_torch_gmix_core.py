"""Mixture geometry, fills, shape algebra and the broadcasting mixture
evaluation of the PyTorch port against the JAX package, in float64 on
the same numpy inputs.

Tolerance: rtol 1e-12, the mixture-evaluation tolerance of
tests/test_misc_components.py; closed-form algebra agrees to round-off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmix_tpu import moments as jmoments, shape as jshape
from ngmix_tpu.gmix import core as jcore

from ngmix_tpu_torch import moments as tmoments, shape as tshape
from ngmix_tpu_torch.gmix import core as tcore


def _close(out, ref, rtol=1e-12):
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(ref), rtol=rtol, atol=1e-300
    )


def _pars(rng, B):
    """[B, 6] (row, col, g1, g2, T, flux), with one |g| >= 1 lane"""
    pars = np.stack(
        [rng.uniform(-0.3, 0.3, B), rng.uniform(-0.3, 0.3, B),
         rng.uniform(-0.5, 0.5, B), rng.uniform(-0.5, 0.5, B),
         rng.uniform(0.2, 3.0, B), rng.uniform(10.0, 200.0, B)], axis=-1,
    )
    pars[0, 2:4] = (0.9, 0.6)
    return pars


@pytest.mark.parametrize("fill", ["fill_exp", "fill_turb"])
def test_fills_shear_convolve_match(fill):
    rng = np.random.RandomState(2)
    pars = _pars(rng, 5)
    jg, jflags = getattr(jcore, fill)(jnp.asarray(pars))
    tg, tflags = getattr(tcore, fill)(torch.as_tensor(pars))
    _close(tg, jg)
    np.testing.assert_array_equal(tflags.numpy(), np.asarray(jflags))
    assert tflags.dtype == torch.int32

    _close(tcore.gmix_get_sheared(tg, 0.02, -0.01),
           jcore.gmix_get_sheared(jg, 0.02, -0.01))
    psf_pars = _pars(rng, 5)
    psf_pars[:, 2:4] *= 0.1
    jp, _ = jcore.fill_turb(jnp.asarray(psf_pars))
    tp, _ = tcore.fill_turb(torch.as_tensor(psf_pars))
    _close(tcore.gmix_convolve(tg, tp), jcore.gmix_convolve(jg, jp))
    # an unbatched psf broadcasts over the batch
    _close(tcore.gmix_convolve(tg, tp[0]), jcore.gmix_convolve(jg, jp[0]))
    for a, b in zip(tcore.gmix_get_cen(tg), jcore.gmix_get_cen(jg)):
        _close(a, b)


@pytest.mark.parametrize("fast", [True, False])
def test_broadcasting_eval_gmix_matches(fast):
    rng = np.random.RandomState(4)
    gm, _ = jcore.fill_exp(jnp.asarray(_pars(rng, 3)))
    gm = np.array(gm)
    gm[1, 2, 3:] = 0.0  # an invalid component evaluates to zero
    v = rng.uniform(-4, 4, (3, 150))
    u = rng.uniform(-4, 4, (3, 150))
    for a, b in zip(tcore.gmix_norms(torch.as_tensor(gm)), jcore.gmix_norms(jnp.asarray(gm))):
        _close(a, b)
    _close(tcore.eval_chi2(*map(torch.as_tensor, (gm, v, u))),
           jcore.eval_chi2(*map(jnp.asarray, (gm, v, u))))
    ref = jax.jit(jcore.eval_gmix, static_argnames="fast")(
        jnp.asarray(gm), jnp.asarray(v), jnp.asarray(u), 0.07, fast=fast
    )
    _close(tcore.eval_gmix(*map(torch.as_tensor, (gm, v, u)), 0.07, fast=fast), ref)


def test_shape_and_moment_algebra_match():
    rng = np.random.RandomState(6)
    g1, g2 = rng.uniform(-0.8, 0.8, (2, 50))
    g1[:3] = (0.99, 1.2, -0.3)
    g2[:3] = (0.2, 0.4, -1.1)
    t = torch.as_tensor
    for a, b in zip(tshape.g1g2_to_e1e2(t(g1), t(g2)), jshape.g1g2_to_e1e2(g1, g2)):
        _close(a, b)
    # e -> g at |e| >= 1 clips to |e| = 1 - 2^-53, where sqrt(1 - |e|^2)
    # turns ulp-level differences of the two libraries into ~1e-8: hold
    # those lanes to the clip's contract (finite, |g| < 1) instead
    inside = g1**2 + g2**2 < 1.0
    eg = tshape.e1e2_to_g1g2(t(g1), t(g2))
    for a, b in zip(eg, jshape.e1e2_to_g1g2(g1, g2)):
        _close(a[inside], np.asarray(b)[inside])
    gsq = eg[0] ** 2 + eg[1] ** 2
    assert bool(torch.all(torch.isfinite(gsq) & (gsq < 1.0)))
    for a, b in zip(tshape.shear_reduced(t(g1), t(g2), 0.02, -0.01),
                    jshape.shear_reduced(g1, g2, 0.02, -0.01)):
        _close(a, b)
    irr, icc = rng.uniform(0.2, 2.0, (2, 50))
    irc = rng.uniform(-0.1, 0.1, 50)
    for a, b in zip(
        tmoments.get_sheared_moments(t(irr), t(irc), t(icc), 0.01, 0.0),
        jmoments.get_sheared_moments(irr, irc, icc, 0.01, 0.0),
    ):
        _close(a, b)
    assert tmoments.fwhm_to_T(1.2) == float(jmoments.fwhm_to_T(1.2))


def test_lm_objective_pieces_match():
    """gmix_flags, apod_window_deriv, fill_fdiff and get_loglike (whose
    model goes through K2's plain version here) against the JAX
    package, with invalid components and masked pixels"""
    from ngmix_tpu.pixels import Pixels as JPixels
    from ngmix_tpu_torch.pixels import Pixels

    rng = np.random.RandomState(9)
    gm, _ = jcore.fill_exp(jnp.asarray(_pars(rng, 4)))
    gm = np.array(gm)
    gm[1, 2, 3:] = (0.2, 0.3, 0.2)  # det < 0
    gm[2, 0, 3:] = 0.0  # det = 0, T = 0
    np.testing.assert_array_equal(
        tcore.gmix_flags(torch.as_tensor(gm)).numpy(), np.asarray(jcore.gmix_flags(gm))
    )
    chi2 = rng.uniform(0.0, 30.0, 200)
    _close(tcore.apod_window_deriv(torch.as_tensor(chi2)), jcore.apod_window_deriv(chi2))

    P = 300
    fields = [rng.uniform(-3, 3, (4, P)), rng.uniform(-3, 3, (4, P)),
              rng.uniform(0.05, 0.08, (4, P)), rng.normal(0.0, 1.0, (4, P)),
              rng.uniform(0.5, 2.0, (4, P))]
    fields[4][0, :50] = 0.0  # masked pixels
    jpix = JPixels(*map(jnp.asarray, fields))
    tpix = Pixels(*map(torch.as_tensor, fields))
    tgm = torch.as_tensor(gm)
    _close(tcore.fill_fdiff(tgm, tpix), jcore.fill_fdiff(jnp.asarray(gm), jpix))
    out = tcore.get_loglike(tgm, tpix)
    ref = jcore.get_loglike(jnp.asarray(gm), jpix)
    for a, b in zip(out[:3], ref[:3]):
        _close(a, b)
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
