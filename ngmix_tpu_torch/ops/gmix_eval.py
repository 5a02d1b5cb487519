"""K2: batched gaussian-mixture evaluation, a hand-written CUDA kernel.

    model[b, p] = area[b, p] * sum_i pnorm[b, i] * exp(-chi2[b, i, p] / 2) * w(chi2)

Replaces ``ngmix_tpu/ops/pallas_gmix.py: eval_gmix_pallas`` (the TPU
kernel, body ``_eval_kernel_body``). The kernel is
``ngmix_tpu_torch/csrc/gmix_eval.cu``, built by ``ops/_build.py`` and
bound with ctypes; ``eval_gmix_plain`` is its plain PyTorch version.

What bounds it on an H100: at the gaussmom shape (n = 1 over
[5 B, 361]) it reads v, u and area and writes the model, about 16
bytes a pixel in float32 against a few dozen operations, so it is
memory-bound. At the sims' shape (n = 18 over [B, 2401]) each pixel
costs 18 exponentials and about 15 operations per gaussian, so the
arithmetic, and the exponentials in it, may bound it instead. The
design answers both: one block per (lane, pixel tile) loads the lane's
n gaussians into shared memory once, derives pnorm and the inverse
covariance there, and each thread streams its pixels with neighbouring
threads on neighbouring addresses, keeping the [B, n, P] intermediate
of the plain version out of device memory.

Area is a scalar or a [B, P] tensor. A scalar is handed to the kernel
as a value with a null area pointer (scalar mode), so it is never
broadcast into a tensor.

The wrapper takes the plain version only for tensors on the CPU. For a
CUDA tensor it launches the kernel or raises; it never falls back.
"""
import numpy as np
import torch

from ..defaults import FASTEXP_APOD_CHI2, FASTEXP_MAX_CHI2, GMIX_LOW_DETVAL
from . import _build

MAX_GAUSS = 64
_APOD_IWIDTH = 1.0 / (FASTEXP_MAX_CHI2 - FASTEXP_APOD_CHI2)

# launches of the CUDA kernel since the last reset (set it to 0 to reset)
launches = 0

_C_FUNCS = {
    torch.float32: "ngmix_gmix_eval_f32",
    torch.float64: "ngmix_gmix_eval_f64",
}


def eval_gmix_plain(gmix, v, u, area=1.0, fast=True):
    """plain PyTorch version of K2: gmix [B, n, 6], v/u [B, P], area a
    scalar or [B, P]; returns [B, P]. Same validity rule and arithmetic
    as the kernel; materializes the [B, n, P] intermediate."""
    p, row, col, irr, irc, icc = gmix.unbind(-1)
    det = irr * icc - irc * irc
    T = irr + icc
    # the floor is compared in the element type: 0 in float32
    valid = (det > GMIX_LOW_DETVAL) & (T > 0)
    idet = 1.0 / torch.where(valid, det, 1.0)
    drr = torch.where(valid, irr * idet, 0.0)[..., None]
    drc = torch.where(valid, irc * idet, 0.0)[..., None]
    dcc = torch.where(valid, icc * idet, 0.0)[..., None]
    pnorm = torch.where(
        valid, p / (2 * np.pi * torch.sqrt(torch.where(valid, det, 1.0))), 0.0
    )[..., None]

    vd = v[..., None, :] - row[..., None]
    ud = u[..., None, :] - col[..., None]
    chi2 = dcc * vd * vd + drr * ud * ud - 2.0 * drc * vd * ud
    if fast:
        t = (FASTEXP_MAX_CHI2 - chi2) * _APOD_IWIDTH
        win = t * t * t * (10.0 + t * (-15.0 + 6.0 * t))
        win = torch.where(chi2 > FASTEXP_APOD_CHI2, win, 1.0)
        win = torch.where((chi2 < FASTEXP_MAX_CHI2) & (chi2 >= 0.0), win, 0.0)
        val = torch.exp(-0.5 * torch.clamp(chi2, 0.0, FASTEXP_MAX_CHI2)) * win
    else:
        val = torch.exp(-0.5 * chi2)
    return torch.sum(pnorm * val, dim=-2) * area


def _check(gmix, v, u, area):
    """raise on what the kernel does not take; returns the area tensor
    or None for scalar mode"""
    if gmix.dim() != 3 or gmix.shape[-1] != 6:
        raise ValueError("gmix must be [B, n, 6], got %s" % (tuple(gmix.shape),))
    B, n, _ = gmix.shape
    if not 1 <= n <= MAX_GAUSS:
        raise ValueError("need 1 <= n <= %d gaussians, got %d" % (MAX_GAUSS, n))
    if v.dim() != 2 or v.shape[0] != B or u.shape != v.shape:
        raise ValueError(
            "v and u must be [B, P] with B = %d, got %s and %s"
            % (B, tuple(v.shape), tuple(u.shape))
        )
    if gmix.dtype not in _C_FUNCS:
        raise TypeError("dtype must be float32 or float64, got %s" % gmix.dtype)
    area_t = None
    if isinstance(area, torch.Tensor) and area.dim() > 0:
        if area.shape != v.shape:
            raise ValueError(
                "area must be a scalar or [B, P], got %s" % (tuple(area.shape),)
            )
        area_t = area
    tensors = [gmix, v, u] + ([area_t] if area_t is not None else [])
    for t in tensors:
        if t.dtype != gmix.dtype or t.device != gmix.device:
            raise TypeError("gmix, v, u and area must share dtype and device")
        if not t.is_contiguous():
            raise ValueError("gmix, v, u and area must be contiguous")
    return area_t


def eval_gmix(gmix, v, u, area=1.0, fast=True):
    """K2: evaluate [B, n, 6] mixtures over [B, P] pixel coordinates.

    CPU tensors go to eval_gmix_plain; CUDA tensors launch the kernel.
    area is a scalar (number or 0-d tensor) or a [B, P] tensor.
    """
    global launches
    area_t = _check(gmix, v, u, area)
    if gmix.device.type == "cpu":
        return eval_gmix_plain(gmix, v, u, area, fast=fast)
    if gmix.device.type != "cuda":
        raise RuntimeError("K2 runs on CUDA or CPU tensors, not %s" % gmix.device)

    fn = getattr(_build.load(), _C_FUNCS[gmix.dtype])
    B, n, _ = gmix.shape
    P = v.shape[1]
    out = torch.empty_like(v)
    if out.numel() == 0:
        return out
    area_scalar = 0.0 if area_t is not None else float(area)
    # the tensors' device is current only for the launch, so the caller's
    # current device is left as it was
    with torch.cuda.device(gmix.device):
        err = fn(
            gmix.data_ptr(), v.data_ptr(), u.data_ptr(),
            area_t.data_ptr() if area_t is not None else None,
            area_scalar, out.data_ptr(), B, n, P, int(bool(fast)),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError("K2 gmix_eval launch failed: CUDA error %d" % err)
    launches += 1
    return out
