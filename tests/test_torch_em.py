"""The batched EM of the PyTorch port (ngmix_tpu_torch/em.py) against
ngmix_tpu.em.em_batch on the same numpy inputs, in float64.

Inputs: B = 6 stamps of 21x21 pixels, each a two-gaussian object of
varied flux, center and shape convolved with a two-gaussian psf, with
noise, sky-shifted as the reference's prep_image does; the guesses are
the truth perturbed. Tolerance: the gmix, its convolution, fdiff and
sky to rtol 1e-8 (tests/test_em.py:223), numiter and flags equal, in
every mode, with vary_sky, with zero-weight pixels (left out, and
model-filled), and at the maxiter flag. A lane alone and the same lane
in a batch give bitwise the same result.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmix_tpu import em as jem
from ngmix_tpu.pixels import Pixels as JPixels

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import convert, em as tem, flags, sims

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

B = 6
DIMS = (21, 21)
SCALE = 0.263
NOISE = 1e-3


def _render(gm, v, u, area):
    """exact mixture [B, P] of gm [B, n, 6] at (v, u) [P], numpy"""
    p, row, col, irr, irc, icc = (gm[..., k][..., None] for k in range(6))
    det = irr * icc - irc * irc
    vd, ud = v - row, u - col
    chi2 = (icc * vd * vd + irr * ud * ud - 2 * irc * vd * ud) / det
    return np.sum(p / (2 * np.pi * np.sqrt(det)) * np.exp(-0.5 * chi2), axis=1) * area


def _inputs(seed=5):
    """(pixels, gmix0, gmix_psf, sky) as numpy arrays"""
    rng = np.random.RandomState(seed)
    rr, cc = np.meshgrid(np.arange(DIMS[0]), np.arange(DIMS[1]), indexing="ij")
    cen = (np.array(DIMS) - 1) / 2.0
    v = ((rr - cen[0]) * SCALE).reshape(-1)
    u = ((cc - cen[1]) * SCALE).reshape(-1)
    gal = np.zeros((B, 2, 6))
    gal[:, :, 0] = rng.uniform(30.0, 80.0, (B, 2))
    # two components apart, so that every lane converges well inside
    # maxiter
    gal[:, :, 1:3] = np.array([[0.5, 0.4], [-0.5, -0.4]]) + rng.uniform(-0.1, 0.1, (B, 2, 2))
    T = rng.uniform(0.3, 0.8, (B, 2))
    e = rng.uniform(-0.2, 0.2, (B, 2, 2))
    gal[:, :, 3] = T / 2 * (1 - e[..., 0])
    gal[:, :, 4] = T / 2 * e[..., 1]
    gal[:, :, 5] = T / 2 * (1 + e[..., 0])
    psf = np.zeros((B, 2, 6))
    psf[:, :, 0] = [0.6, 0.4]
    psf[:, :, 3] = psf[:, :, 5] = [[0.08, 0.2]] * B
    psf[:, 0, 4] = rng.uniform(-0.01, 0.01, B)
    conv = np.zeros((B, 4, 6))
    for i in range(2):
        for j in range(2):
            k = 2 * i + j
            conv[:, k, 0] = gal[:, i, 0] * psf[:, j, 0]
            conv[:, k, 1:3] = gal[:, i, 1:3] + psf[:, j, 1:3]
            conv[:, k, 3:] = gal[:, i, 3:] + psf[:, j, 3:]
    img = _render(conv, v, u, SCALE**2) + rng.normal(0, NOISE, (B, v.size))
    im_min, im_max = img.min(axis=1), img.max(axis=1)
    sky = 0.001 * (im_max - im_min) - im_min
    val = img + sky[:, None]
    guess = gal.copy()
    guess[..., 0] *= rng.uniform(0.9, 1.1, (B, 2))
    guess[..., 1:3] += rng.uniform(-SCALE, SCALE, (B, 2, 2))
    guess[..., 3:] += 0.1 * SCALE**2 * rng.uniform(-1, 1, (B, 2, 3))
    ierr = np.full((B, v.size), 1.0 / NOISE)
    pixels = (np.tile(v, (B, 1)), np.tile(u, (B, 1)), np.full((B, v.size), SCALE**2),
              val, ierr)
    return pixels, guess, psf, sky


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _masked(inputs):
    """the inputs with a 4x4 block of zero-weight pixels in every stamp
    and a whole zero-weight row in stamp 1"""
    pixels, guess, psf, sky = inputs
    ierr = pixels[4].copy().reshape(B, *DIMS)
    ierr[:, 8:12, 8:12] = 0.0
    ierr[1, 3, :] = 0.0
    return pixels[:4] + (ierr.reshape(B, -1),), guess, psf, sky


CASES = {
    "free": (dict(), False),
    "fixcen": (dict(mode="fixcen"), False),
    "fixcov": (dict(mode="fixcov"), False),
    "fluxonly": (dict(mode="fluxonly", miniter=20), False),
    "vary_sky": (dict(vary_sky=True), False),
    "zero_weight_left_out": (dict(), True),
    "fill_zero_weight": (dict(fill_zero_weight=True), True),
    "maxiter": (dict(maxiter=3, miniter=1, tol=1e-14), False),
}


def _run_jax(inputs, fields):
    pixels, guess, psf, sky = inputs
    conf = jem.EMConf(**fields)
    out = jem.em_batch(JPixels(*map(jnp.asarray, pixels)), jnp.asarray(guess),
                       jnp.asarray(psf), jnp.asarray(sky), conf)
    return jax.tree.map(np.asarray, out)


def _run_port(inputs, fields, sel=slice(None)):
    pixels, guess, psf, sky = inputs
    out = nt.em_batch(tuple(x[sel] for x in pixels), guess[sel], psf[sel], sky[sel],
                      nt.EMConf(**fields), device="cpu")
    return convert.to_numpy(out)


@pytest.mark.parametrize("case", sorted(CASES))
def test_em_batch_matches_jax(inputs, case):
    fields, masked = CASES[case]
    args = _masked(inputs) if masked else inputs
    ref = _run_jax(args, fields)
    got = _run_port(args, fields)
    assert set(got) == set(ref)
    for k in ("numiter", "flags"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("gmix", "gmix_conv", "fdiff", "sky"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-8, atol=1e-10, err_msg=k)
    if case == "maxiter":
        assert np.all(got["flags"] & flags.EM_MAXITER) and np.all(got["numiter"] == 3)
    elif case == "fill_zero_weight":
        # the filled pixels follow the model, and some lanes run to
        # maxiter, in the reference as here
        assert np.all((got["flags"] & ~flags.EM_MAXITER) == 0)
        assert np.any(got["numiter"] < 500)
    else:
        assert np.all(got["flags"] == 0) and np.all(got["numiter"] < 500)
    if case == "vary_sky":
        assert not np.array_equal(got["sky"], args[3])


def test_em_lanes_are_batch_independent(inputs):
    """each lane alone, and a permuted subset of the lanes, give the
    bitwise result of the whole batch, with the lanes converging at
    different iterations"""
    full = _run_port(inputs, {})
    assert len(set(full["numiter"].tolist())) > 1
    for i in range(B):
        one = _run_port(inputs, {}, slice(i, i + 1))
        for k, x in one.items():
            np.testing.assert_array_equal(x[0], full[k][i], err_msg=(i, k))
    perm = np.array([4, 0, 3])
    sub = _run_port(inputs, {}, perm)
    for k, x in sub.items():
        np.testing.assert_array_equal(x, full[k][perm], err_msg=k)


def test_em_bad_mode_raises(inputs):
    with pytest.raises(ValueError, match="EM mode"):
        _run_port(inputs, dict(mode="bogus"))


def test_prep_image_matches_jax(inputs):
    rng = np.random.RandomState(8)
    ims = rng.normal(size=(3,) + DIMS)
    got, sky = tem.prep_image(torch.as_tensor(ims))
    for i in range(3):
        ref, ref_sky = jem.prep_image(ims[i])
        np.testing.assert_allclose(got[i].numpy(), ref, rtol=1e-14, atol=1e-15)
        np.testing.assert_allclose(float(sky[i]), ref_sky, rtol=1e-14)


def test_em_conf_from_jax_fields():
    jconf = jem.EMConf(mode="fixcov", miniter=7, maxiter=99, tol=1e-4, vary_sky=True)
    conf = convert.em_conf_from_fields(jconf)
    assert conf == nt.EMConf("fixcov", 7, 99, 1e-4, True, False)
    assert convert.em_conf_from_fields(conf._asdict()) == conf
    with pytest.raises(ValueError):
        convert.em_conf_from_fields({**conf._asdict(), "bogus": 1})


def test_em1_inputs_match_bench():
    """sims.em1_inputs builds bench.py's em1 input (bench.py:280-289)
    from a sim batch: the sky-shifted stamps with the sky 0.001 x their
    range, the round guess of irr = icc = 0.3 and the delta psf"""
    gen = torch.Generator().manual_seed(3)
    imgs, weights, cens, _, _, _ = sims.make_sim_batch(gen, 4, torch.float64, device="cpu")
    pixels, gmix0, psf, sky = sims.em1_inputs(imgs, weights, cens)
    x = imgs.numpy()
    im_min = x.min(axis=(1, 2))
    ref_sky = 0.001 * (x.max(axis=(1, 2)) - im_min)
    np.testing.assert_allclose(sky.numpy(), ref_sky, rtol=1e-14)
    np.testing.assert_allclose(
        pixels.val.numpy(), (x - im_min[:, None, None] + ref_sky[:, None, None]).reshape(4, -1),
        rtol=1e-14)
    ref0 = np.zeros((4, 1, 6))
    ref0[:, 0, [0, 3, 5]] = (1.0, 0.3, 0.3)
    np.testing.assert_array_equal(gmix0.numpy(), ref0)
    refp = np.zeros((4, 1, 6))
    refp[:, 0, 0] = 1.0
    np.testing.assert_array_equal(psf.numpy(), refp)
    assert pixels.v.shape == (4, 49 * 49)
