"""K1: the LM normal equations of a gaussian-mixture fit, a hand-written
CUDA kernel.

Each Levenberg-Marquardt iteration needs (cost, J^T r, J^T J) of the
apodized objective at the candidate parameters. With the convolved
mixture reparametrized per gaussian as

    q = (N, row, col, Fvv, Fvu, Fuu)

(N = p / (2 pi sqrt(det)) the peak amplitude, F the inverse
covariance), a pixel's value is N e^{-chi2/2} w(chi2) area, whose
derivatives d value / d q are closed-form. The chain matrices
C[g] = d q[g] / d pars come from forward-mode AD of the small fill,
convolve and reparam map outside the kernel, so J is AD-exact.

Replaces ``ngmix_tpu/ops/pallas_lm.py: gmix_normal_eqs_pallas`` (the
TPU kernel, body ``_normal_kernel_body``). The kernel is
``ngmix_tpu_torch/csrc/normal_eqs.cu``, built by ``ops/_build.py`` and
bound with ctypes; ``gmix_normal_eqs_plain`` is its plain PyTorch
version.

What bounds it on an H100: at the main path's shape (n = 6 gaussians
over [5 B, 361] pixels) each pixel costs about 100 floating operations
per gaussian, most of them the 36-term chain product, and one
exponential, against 16 bytes of pixel planes read once; that is above
the card's float32 operations-per-byte ratio, so the arithmetic bounds
it. The kernel keeps every intermediate on chip (one block per lane,
the lane's gaussians and chain in shared memory, per-thread partial
sums in registers) and writes 1 + 6 + 36 numbers a lane; the plain
version materializes the [B, n, P] terms in device memory. Its block
reduction runs in a fixed order, so each lane's result does not depend
on the other lanes of the launch.

The wrapper takes the plain version only for tensors on the CPU. For a
CUDA tensor it launches the kernel or raises; it never falls back.
"""
import numpy as np
import torch

from ..defaults import FASTEXP_APOD_CHI2, FASTEXP_MAX_CHI2, GMIX_LOW_DETVAL
from . import _build

MAX_GAUSS = 64
NPARS = 6
_APOD_IWIDTH = 1.0 / (FASTEXP_MAX_CHI2 - FASTEXP_APOD_CHI2)

# launches of the CUDA kernel since the last reset (set it to 0 to reset)
launches = 0

_C_FUNCS = {
    torch.float32: "ngmix_normal_eqs_f32",
    torch.float64: "ngmix_normal_eqs_f64",
}


def gmix_reparam(gmix):
    """[..., n, 6] (p, row, col, irr, irc, icc) -> (N, row, col, Fvv,
    Fvu, Fuu).

    Safe under torch.func: an invalid gaussian (det <= GMIX_LOW_DETVAL
    or T <= 0, the TPU kernel's own rule) gets a unit inverse
    covariance and N = 0, so the evaluation and its derivatives stay
    finite; the caller rejects such parameter points through
    gmix_flags.
    """
    p, row, col, irr, irc, icc = gmix.unbind(-1)
    det = irr * icc - irc * irc
    T = irr + icc
    valid = (det > GMIX_LOW_DETVAL) & (T > 0)
    det_s = torch.where(valid, det, 1.0)
    idet = 1.0 / det_s
    N = torch.where(valid, p / (2.0 * np.pi * torch.sqrt(det_s)), 0.0)
    Fvv = torch.where(valid, icc * idet, 1.0)
    Fvu = torch.where(valid, -irc * idet, 0.0)
    Fuu = torch.where(valid, irr * idet, 1.0)
    return torch.stack([N, row, col, Fvv, Fvu, Fuu], dim=-1)


def _pixel_terms(rp, v, u):
    """the per-(gaussian, pixel) terms [B, n, P] of the apodized model,
    with the TPU kernel body's arithmetic: N, dv, du, gv, gu, e, win and
    dwin (the C2 window and its derivative) and mw = e win"""
    N, row, col, Fvv, Fvu, Fuu = (x[..., None] for x in rp.unbind(-1))
    dv = v[:, None, :] - row
    du = u[:, None, :] - col
    gv = Fvv * dv + Fvu * du
    gu = Fvu * dv + Fuu * du
    chi2 = gv * dv + gu * du

    t = (FASTEXP_MAX_CHI2 - chi2) * _APOD_IWIDTH
    win = t * t * t * (10.0 + t * (-15.0 + 6.0 * t))
    tmt = t * (1.0 - t)
    dwin = -30.0 * tmt * tmt * _APOD_IWIDTH
    inwin = (chi2 < FASTEXP_MAX_CHI2) & (chi2 >= 0.0)
    hot = chi2 > FASTEXP_APOD_CHI2
    win = torch.where(inwin, torch.where(hot, win, 1.0), 0.0)
    dwin = torch.where(hot & inwin, dwin, 0.0)

    e = torch.exp(-0.5 * torch.clamp(chi2, 0.0, FASTEXP_MAX_CHI2))
    return N, dv, du, gv, gu, e, win, dwin, e * win


def gmix_model_plain(rp, v, u):
    """the apodized model [B, P] of the reparametrized mixture rp [B, n,
    6] at the pixels v, u [B, P] (without the pixel area), summed over
    the gaussians in the order of K1's body: the value whose residuals
    gmix_normal_eqs_plain reduces"""
    N, *_, mw = _pixel_terms(rp, v, u)
    f = torch.zeros_like(v)
    for g in range(rp.shape[1]):
        f = f + N[:, g] * mw[:, g]
    return f


def gmix_normal_eqs_plain(rp, chain, v, u, ia, ve):
    """plain PyTorch version of K1, with the TPU kernel body's
    arithmetic; materializes the [B, n, P] terms. The parameter count
    npars is the chain's last dimension: 6 as in the kernel, or more
    for the composite models, whose solves (K3's plain version) reduce
    through this function too. Returns cost [B], Jtr [B, npars] and
    JtJ [B, npars, npars]."""
    npars = chain.shape[-1]
    N, dv, du, gv, gu, e, win, dwin, mw = _pixel_terms(rp, v, u)
    # d(N e(chi2) w(chi2)) / d chi2
    c = N * e * (dwin - 0.5 * win)
    dq = (mw, -2.0 * c * gv, -2.0 * c * gu, c * dv * dv,
          2.0 * c * dv * du, c * du * du)
    # sums over the gaussians in the body's order
    f = torch.zeros_like(v)
    J = [torch.zeros_like(v) for _ in range(npars)]
    for g in range(rp.shape[1]):
        f = f + N[:, g] * mw[:, g]
        for k in range(npars):
            acc = J[k]
            for j in range(6):
                acc = acc + chain[:, g, j, k, None] * dq[j][:, g]
            J[k] = acc

    fd = f * ia - ve
    Jw = [Jk * ia for Jk in J]
    cost = torch.sum(fd * fd, dim=-1)
    Jtr = torch.stack([torch.sum(Jk * fd, dim=-1) for Jk in Jw], dim=-1)
    rows = [[None] * npars for _ in range(npars)]
    for k in range(npars):
        for m in range(k, npars):
            rows[k][m] = rows[m][k] = torch.sum(Jw[k] * Jw[m], dim=-1)
    JtJ = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    return cost, Jtr, JtJ


def _check(rp, chain, planes):
    if rp.dim() != 3 or rp.shape[-1] != 6:
        raise ValueError("rp must be [B, n, 6], got %s" % (tuple(rp.shape),))
    B, n, _ = rp.shape
    if not 1 <= n <= MAX_GAUSS:
        raise ValueError("need 1 <= n <= %d gaussians, got %d" % (MAX_GAUSS, n))
    if tuple(chain.shape) != (B, n, 6, NPARS):
        raise ValueError(
            "chain must be [B, n, 6, %d] = %s, got %s"
            % (NPARS, (B, n, 6, NPARS), tuple(chain.shape))
        )
    P = planes[0].shape[-1] if planes[0].dim() == 2 else -1
    for x in planes:
        if tuple(x.shape) != (B, P):
            raise ValueError(
                "v, u, ia and ve must be [B, P] with B = %d, got %s"
                % (B, [tuple(x.shape) for x in planes])
            )
    if rp.dtype not in _C_FUNCS:
        raise TypeError("dtype must be float32 or float64, got %s" % rp.dtype)
    for t in (rp, chain) + tuple(planes):
        if t.dtype != rp.dtype or t.device != rp.device:
            raise TypeError("rp, chain, v, u, ia and ve must share dtype and device")
        if not t.is_contiguous():
            raise ValueError("rp, chain, v, u, ia and ve must be contiguous")


def gmix_normal_eqs(rp, chain, v, u, ia, ve):
    """K1: normal-equation reductions for a batch of mixture fits.

    rp [B, n, 6] (gmix_reparam of the convolved model); chain
    [B, n, 6, 6] = d rp[g, j] / d pars[k]; v, u [B, P] pixel
    coordinates; ia = ierr * area and ve = val * ierr [B, P]. Returns
    cost [B], Jtr [B, 6] and JtJ [B, 6, 6] of the apodized objective
    sum(((model - val) * ierr)^2). CPU tensors go to
    gmix_normal_eqs_plain; CUDA tensors launch the kernel.
    """
    global launches
    _check(rp, chain, (v, u, ia, ve))
    if rp.device.type == "cpu":
        return gmix_normal_eqs_plain(rp, chain, v, u, ia, ve)
    if rp.device.type != "cuda":
        raise RuntimeError("K1 runs on CUDA or CPU tensors, not %s" % rp.device)

    fn = getattr(_build.load(), _C_FUNCS[rp.dtype])
    B, n, _ = rp.shape
    P = v.shape[1]
    cost = rp.new_empty((B,))
    Jtr = rp.new_empty((B, NPARS))
    JtJ = rp.new_empty((B, NPARS, NPARS))
    if B == 0:
        return cost, Jtr, JtJ
    # the tensors' device is current only for the launch, so the caller's
    # current device is left as it was
    with torch.cuda.device(rp.device):
        err = fn(
            rp.data_ptr(), chain.data_ptr(), v.data_ptr(), u.data_ptr(),
            ia.data_ptr(), ve.data_ptr(), cost.data_ptr(), Jtr.data_ptr(),
            JtJ.data_ptr(), B, n, P, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError("K1 normal_eqs launch failed: CUDA error %d" % err)
    launches += 1
    return cost, Jtr, JtJ
