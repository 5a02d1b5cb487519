"""Gaussian weighted moments of the PyTorch port against the JAX package:
gmix.core.get_weighted_sums and gaussmom.gaussmom_measure, every result
key, in float64 on the same numpy pixels.

Tolerance: rtol 1e-10 with atol 1e-12, the float64 round-off of the
same sums taken in another order; flags and pixel counts are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmix_tpu import gaussmom as jgm
from ngmix_tpu.gmix import core as jcore
from ngmix_tpu.pixels import Pixels as JPixels

from ngmix_tpu_torch import convert, gaussmom as tgm
from ngmix_tpu_torch.gmix import core as tcore

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

FWHM = 1.2
SCALE = 0.263


def _pixels(B=6, dims=(19, 19), seed=11):
    """stamps of a round-ish gaussian blob with noise and a few masked
    pixels, as numpy (v, u, area, val, ierr)"""
    rng = np.random.RandomState(seed)
    H, W = dims
    rr, cc = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    cen = (np.array([(H - 1) / 2, (W - 1) / 2]) + rng.uniform(-0.5, 0.5, (B, 2)))
    v = (rr.reshape(-1)[None] - cen[:, :1]) * SCALE
    u = (cc.reshape(-1)[None] - cen[:, 1:]) * SCALE
    T = rng.uniform(0.3, 1.0, (B, 1))
    val = 10.0 * np.exp(-(v**2 + u**2) / T) + rng.normal(0, 0.01, v.shape)
    ierr = np.full(v.shape, 100.0)
    ierr[:, :7] = 0.0
    # an empty lane: no flux, so every moment flag fires
    val[-1] = 0.0
    area = np.full(v.shape, SCALE**2)
    return JPixels(v=v, u=u, area=area, val=val, ierr=ierr)


def _compare(port, ref):
    ref = {k: np.asarray(v) for k, v in ref.items() if v is not None}
    port = convert.to_numpy({k: v for k, v in port.items() if v is not None})
    assert set(port) == set(ref)
    for k in ref:
        assert port[k].shape == ref[k].shape, k
        if ref[k].dtype.kind in "iub":
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
        else:
            np.testing.assert_allclose(
                port[k], ref[k], rtol=1e-10, atol=1e-12, equal_nan=True,
                err_msg=k,
            )


@pytest.mark.parametrize("with_cov", [True, False])
def test_get_weighted_sums_matches(with_cov):
    px = _pixels()
    wt = np.broadcast_to(
        np.asarray(jgm.make_weight_gmix(FWHM)), (px.v.shape[0], 1, 6)
    )
    maxrad = 1.5
    ref = jax.jit(
        lambda w, p: jcore.get_weighted_sums(w, p, maxrad, with_cov=with_cov)
    )(jnp.asarray(wt), JPixels(*map(jnp.asarray, px)))
    port = tcore.get_weighted_sums(
        torch.as_tensor(np.array(wt)), convert.pixels_from_arrays(px), maxrad,
        with_cov=with_cov,
    )
    _compare(port, ref)


def test_gaussmom_measure_matches():
    px = _pixels()
    ref = jax.jit(lambda p: jgm.gaussmom_measure(p, FWHM, SCALE**2))(
        JPixels(*map(jnp.asarray, px))
    )
    port = tgm.gaussmom_measure(convert.pixels_from_arrays(px), FWHM, SCALE**2)
    _compare(port, ref)
    assert int(port["flags"][-1]) != 0 and int(port["flags"][0]) == 0


def test_make_weight_gmix_matches():
    np.testing.assert_allclose(
        tgm.make_weight_gmix(FWHM).numpy(), np.asarray(jgm.make_weight_gmix(FWHM)),
        rtol=1e-15,
    )


def test_unbatched_pixels():
    """one stamp with [npix] fields goes through the same path"""
    px = _pixels(B=2)
    one = convert.pixels_from_arrays(px)
    batched = tgm.gaussmom_measure(one, FWHM, SCALE**2)
    single = tgm.gaussmom_measure(type(one)(*(f[0] for f in one)), FWHM, SCALE**2)
    for k in ("sums", "sums_cov", "pars", "flags"):
        np.testing.assert_allclose(
            single[k].numpy(), batched[k][0].numpy(), rtol=1e-13
        )
