"""Simulated stamp batches for the metacal pipeline.

Ports of ``bench.py: make_sim_batch`` and ``make_sim_batch_hetero``
(the flat case: one epoch, one band) on an explicit torch.Generator.
Like every entry point they run on the CUDA card unless the caller
passes device="cpu", and the generator must live on that device. The
psf and galaxy stamps are rendered
through K2 with the untruncated exponential (fast=False). The random
streams differ from JAX's, so the draws differ; the populations are
the same.
"""
import numpy as np
import torch

from .batch import MetacalConfig
from .gmix import core as gcore
from .ops import gmix_eval
from .util import resolve_device

SCALE = 0.263
DIMS = (49, 49)
PSF_DIMS = (25, 25)
SHEAR_TRUE = 0.02
NOISE = 1.0e-4
JAC = (SCALE, 0.0, 0.0, SCALE)

# bench.py's metacal_gaussmom configuration, the main path on the card
# of measure="gaussmom"
METACAL_GAUSSMOM_CONFIG = MetacalConfig(
    dims=DIMS, psf_dims=PSF_DIMS, jac=JAC, fixnoise=True, pad_factor=2,
    fit_dims=(19, 19),
)
# bench.py's headline configuration (the FFT grid is N = 64), the main
# path on the card of measure="exp-lm"
METACAL_EXP_LM_CONFIG = MetacalConfig(
    dims=DIMS, psf_dims=PSF_DIMS, jac=JAC, fixnoise=True, pad_factor=1.3,
    fit_dims=(19, 19),
)


def _sim_device(gen, device):
    """the device the sims run on; raises if gen lives elsewhere"""
    dev = resolve_device(device)
    gdev = gen.device
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if gdev.type == "cuda" and gdev.index is None:
        gdev = torch.device("cuda", torch.cuda.current_device())
    if gdev != dev:
        raise ValueError(
            "the generator lives on %s but the sims run on %s; make it with "
            "torch.Generator(device=...)" % (gen.device, dev)
        )
    return dev


def _uniform(gen, shape, dtype, lo, hi):
    return torch.rand(shape, generator=gen, dtype=dtype, device=gen.device) * (
        hi - lo
    ) + lo


def _normal(gen, shape, dtype):
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)


def _grid_offsets(dims, cens):
    """(drow, dcol) [B, H*W] of every pixel from each stamp center"""
    rows = torch.arange(dims[0], dtype=cens.dtype, device=cens.device)
    cols = torch.arange(dims[1], dtype=cens.dtype, device=cens.device)
    rr, cc = torch.meshgrid(rows, cols, indexing="ij")
    return (
        rr.reshape(-1)[None, :] - cens[:, 0:1],
        cc.reshape(-1)[None, :] - cens[:, 1:2],
    )


def _render(gmix, cens, dims):
    """K2 render of [B, n, 6] mixtures into [B, H, W] stamps under the
    shared WCS JAC, centered at cens [B, 2]"""
    dvdrow, dvdcol, dudrow, dudcol = JAC
    dr, dc = _grid_offsets(dims, cens)
    v = (dvdrow * dr + dvdcol * dc).contiguous()
    u = (dudrow * dr + dudcol * dc).contiguous()
    area = abs(dvdrow * dudcol - dvdcol * dudrow)
    img = gmix_eval.eval_gmix(gmix.contiguous(), v, u, area, fast=False)
    return img.reshape((gmix.shape[0],) + tuple(dims))


def _stamp_centers(B, dims, dtype, device):
    c = torch.tensor([(dims[0] - 1) / 2.0, (dims[1] - 1) / 2.0], dtype=dtype,
                     device=device)
    return c.expand(B, 2)


def make_sim_batch(gen, B, dtype=torch.float32, device=None):
    """B exp-galaxy stamps with one turb psf, sheared by SHEAR_TRUE,
    with random subpixel offsets. Returns (images, weights, cens,
    psf_images, psf_cens, noise) on device (the card by default)."""
    dev = _sim_device(gen, device)
    gal_pars = torch.tensor(
        [0.0, 0.0, 0.0, 0.0, 0.5, 100.0], dtype=dtype, device=dev
    ).expand(B, 6)
    gal, _ = gcore.fill_exp(gal_pars)
    gal = gcore.gmix_get_sheared(gal, SHEAR_TRUE, 0.0)
    psf_pars = torch.tensor(
        [0.0, 0.0, 0.025, -0.01, 0.27, 1.0], dtype=dtype, device=dev
    )
    psf, _ = gcore.fill_turb(psf_pars)
    conv = gcore.gmix_convolve(gal, psf.expand(B, 3, 6))

    offsets = _uniform(gen, (B, 2), dtype, -0.5, 0.5)
    cens = _stamp_centers(B, DIMS, dtype, dev) + offsets
    imgs = _render(conv, cens, DIMS)
    imgs = imgs + _normal(gen, imgs.shape, dtype) * NOISE

    pcens = _stamp_centers(B, PSF_DIMS, dtype, dev)
    pimg = _render(psf[None], pcens[:1], PSF_DIMS)
    pimgs = pimg.expand((B,) + PSF_DIMS)

    weights = torch.full((B,) + DIMS, 1.0 / NOISE**2, dtype=dtype, device=dev)
    noise_field = _normal(gen, (B,) + DIMS, dtype) * NOISE
    return imgs, weights, cens, pimgs, pcens, noise_field


def make_sim_batch_hetero(gen, B, dtype=torch.float32, device=None):
    """heterogeneous batch: per-stamp size, flux and intrinsic shape,
    and per-stamp turb psf shape and size, in +-g_int pairs that share
    T, flux and psf (ring cancellation), sheared by (SHEAR_TRUE, 0).
    B must be even. Same return layout as make_sim_batch."""
    if B % 2:
        raise ValueError("pairing needs an even batch, got B=%d" % B)
    dev = _sim_device(gen, device)
    H = B // 2

    def pair(x):
        return torch.cat([x, x], dim=0)

    T = _uniform(gen, (H,), dtype, 0.3, 1.1)
    flux = _uniform(gen, (H,), dtype, 60.0, 140.0)
    # intrinsic shapes uniform on a disc |g| < 0.3
    r = torch.sqrt(_uniform(gen, (H,), dtype, 0.0, 1.0)) * 0.3
    th = _uniform(gen, (H,), dtype, 0.0, 2.0 * np.pi)
    g1i = r * torch.cos(th)
    g2i = r * torch.sin(th)
    zeros = torch.zeros((B,), dtype=dtype, device=dev)
    gal_pars = torch.stack(
        [zeros, zeros, torch.cat([g1i, -g1i]), torch.cat([g2i, -g2i]),
         pair(T), pair(flux)],
        dim=-1,
    )
    gal, _ = gcore.fill_exp(gal_pars)
    gal = gcore.gmix_get_sheared(gal, SHEAR_TRUE, 0.0)

    # per-stamp turb psf (paired): shape +-0.03, T in [0.24, 0.30]
    pg = _uniform(gen, (H, 2), dtype, -0.03, 0.03)
    pT = _uniform(gen, (H,), dtype, 0.24, 0.30)
    psf_pars = torch.cat(
        [torch.zeros((H, 2), dtype=dtype, device=dev), pg, pT[:, None],
         torch.ones((H, 1), dtype=dtype, device=dev)],
        dim=-1,
    )
    psf, _ = gcore.fill_turb(pair(psf_pars))
    conv = gcore.gmix_convolve(gal, psf)

    offsets = _uniform(gen, (B, 2), dtype, -0.5, 0.5)
    cens = _stamp_centers(B, DIMS, dtype, dev) + offsets
    clean = _render(conv, cens, DIMS)
    pcens = _stamp_centers(B, PSF_DIMS, dtype, dev)
    pimgs = _render(psf, pcens, PSF_DIMS)

    imgs = clean + _normal(gen, clean.shape, dtype) * NOISE
    weights = torch.full((B,) + DIMS, 1.0 / NOISE**2, dtype=dtype, device=dev)
    noise_field = _normal(gen, (B,) + DIMS, dtype) * NOISE
    return imgs, weights, cens, pimgs, pcens, noise_field
