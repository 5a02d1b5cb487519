"""Pre-PSF moments measured in Fourier space (the ksigma and gaussian
kernels), batched over [B] stamps.

The port of ``ngmix_tpu/prepsfmom.py``: apodize the stamp, FFT image
and psf on a zero-padded grid, deconvolve with an amplitude floor,
phase shift to the jacobian center, and dot masked k-space kernels
against the modes. Two routes give the same result:

- ``partial_modes=True`` (the default) never builds the padded grids:
  the measurement only consumes the modes inside the kernel's support,
  so the forward transforms are partial-DFT products straight from the
  unpadded stamps to the masked row and column block, taken over the
  canonical half-plane of the conjugate pairs, and the moment sums and
  the covariance are two contractions against constant planes;
- ``partial_modes=False`` takes full FFTs of the padded stamps
  (``prepsfmom_core``): the oracle of the first route.

The kernels and every matrix are static configuration, built in
float64 numpy on the host and cached on the device per (kind,
arguments, device, dtype). Products are complex ``torch.matmul`` with
TF32 off (util.full_precision_matmuls). Device code never raises on
bad data: flags carry failures.

The host API (``PrePSFMom``, ``KSigmaMom``, ``PGaussMom``) measures one
observation by the full-FFT route, as the JAX package's does, on the
observation's device, and raises FFTRangeError where the kernel's
normalization on the padded grid is not 1.
"""
import functools
import logging

import numpy as np
import torch

from .defaults import FASTEXP_MAX_CHI2
from .gexceptions import FFTRangeError
from .metacal.kops import complex_dtype
from .moments import fwhm_to_sigma, make_mom_result, result_to_host
from .observation import Observation
from .util import full_precision_matmuls, resolve_device

logger = logging.getLogger(__name__)


# ----------------------------------------------------------------------
# host-built configuration (float64 numpy)

def _ap_kern_kern(x, m, h):
    """cumulative triweight kernel"""
    y = (x - m) / h + 3
    val = (
        -5 * y**7 / 69984
        + 7 * y**5 / 2592
        - 35 * y**3 / 864
        + 35 * y / 96
        + 1.0 / 2.0
    )
    return np.where(y < -3, 0.0, np.where(y > 3, 1.0, val))


def apodization_mask(dims, ap_rad):
    """square stamp-edge apodization [H, W]"""
    ap_range = int(6 * ap_rad + 0.5)
    ny, nx = dims
    y = np.arange(ny, dtype=np.float64)
    x = np.arange(nx, dtype=np.float64)
    wy = _ap_kern_kern(y, ap_range, ap_rad) * _ap_kern_kern(ny - 1 - y, ap_range, ap_rad)
    wx = _ap_kern_kern(x, ap_range, ap_rad) * _ap_kern_kern(nx - 1 - x, ap_range, ap_rad)
    return wy[:, None] * wx[None, :]


def _zero_pad_offsets(dim, target_dim):
    return (target_dim - dim) // 2


def _sky_freqs(dim, jac_tuple):
    """(fv, fu) sky-frame angular frequencies [dim, dim] and |det Atinv|"""
    dvdrow, dvdcol, dudrow, dudcol = jac_tuple
    f = 2 * np.pi * np.fft.fftfreq(dim)
    fy = f[:, None]
    fx = f[None, :]
    At = np.array([[dvdrow, dvdcol], [dudrow, dudcol]], dtype=float)
    Atinv = np.linalg.inv(At).T
    fv = Atinv[0, 0] * fy + Atinv[0, 1] * fx
    fu = Atinv[1, 0] * fy + Atinv[1, 1] * fx
    detAtinv = abs(np.linalg.det(Atinv))
    return fv, fu, detAtinv


def ksigma_kernels(dim, fwhm, jac_tuple, fwhm_smooth=0.0):
    """Bernstein et al. ksigma k-space kernels on the full [dim, dim]
    grid with the support mask folded in; dict fkf/fkr/fkp/fkc/msk/nrm/fk00"""
    fv, fu, detAtinv = _sky_freqs(dim, jac_tuple)
    n = 4
    sigma = float(fwhm_to_sigma(fwhm))
    kmax2 = 2 * n / sigma**2
    fu2 = fu * fu
    fv2 = fv * fv
    fmag2 = fu2 + fv2
    msk = fmag2 < kmax2
    fm = msk.astype(fv.dtype)

    karg = np.clip(1.0 - fmag2 / kmax2, 0.0, None)
    karg2 = karg * karg
    karg3 = karg2 * karg
    karg4 = karg3 * karg

    max_real_val = n / (sigma**2 * 10 * np.pi)
    knrm = detAtinv / max_real_val

    fkf = karg4 * knrm * fm
    nrm = np.sum(fkf) / dim / dim

    two_knrm_dWdk2 = (-knrm * 8.0 / kmax2) * karg3 * fm
    four_knrm_dW2dk22 = (knrm * 48 / kmax2**2) * karg2 * fm

    if fwhm_smooth > 0:
        sm = _smooth_profile(fwhm_smooth, fmag2)
        fkf = fkf * sm
        two_knrm_dWdk2 = two_knrm_dWdk2 * sm
        four_knrm_dW2dk22 = four_knrm_dW2dk22 * sm

    fkr = -2 * two_knrm_dWdk2 - fmag2 * four_knrm_dW2dk22
    fkp = -(fu2 - fv2) * four_knrm_dW2dk22
    fkc = -2 * fu * fv * four_knrm_dW2dk22

    return dict(fkf=fkf, fkr=fkr, fkp=fkp, fkc=fkc, msk=msk, nrm=nrm, fk00=knrm)


def gauss_kernels(dim, fwhm, jac_tuple, fwhm_smooth=0.0):
    """gaussian k-space kernels, laid out as ksigma_kernels'"""
    fv, fu, detAtinv = _sky_freqs(dim, jac_tuple)
    sigma = float(fwhm_to_sigma(fwhm))
    sigma2 = sigma * sigma
    fu2 = fu * fu
    fv2 = fv * fv
    fmag2 = fu2 + fv2
    exp_fac = sigma2 / 2
    chi2_2 = exp_fac * fmag2
    msk = (chi2_2 < FASTEXP_MAX_CHI2 / 2) & (chi2_2 >= 0)
    fm = msk.astype(fv.dtype)
    exp_val = np.exp(-np.clip(chi2_2, 0.0, FASTEXP_MAX_CHI2)) * fm

    knrm = detAtinv * np.pi * 2 * sigma2
    fkf = exp_val * knrm
    nrm = np.sum(fkf) / dim / dim

    if fwhm_smooth > 0:
        fkf = fkf * _smooth_profile(fwhm_smooth, fmag2)

    fkfac = 2 * exp_fac
    fkfac2 = 4 * exp_fac**2
    fkr = (2 * fkfac - fkfac2 * fmag2) * fkf
    fkp = fkfac2 * (fv2 - fu2) * fkf
    fkc = -2 * fkfac2 * fu * fv * fkf

    return dict(fkf=fkf, fkr=fkr, fkp=fkp, fkc=fkc, msk=msk, nrm=nrm, fk00=knrm)


def _smooth_profile(fwhm_smooth, fmag2):
    sigma_smooth = float(fwhm_to_sigma(fwhm_smooth))
    chi2_2 = sigma_smooth**2 / 2 * fmag2
    ok = (chi2_2 < FASTEXP_MAX_CHI2 / 2) & (chi2_2 >= 0)
    return np.where(ok, np.exp(-np.clip(chi2_2, 0, FASTEXP_MAX_CHI2)), 0.0)


def _partial_dft_matrix(target_dim, sel, nin, offset, sign=-1):
    """[nin, nsel] evaluation matrix taking the nin nonzero input rows
    of a block placed at offset in a target_dim-padded frame to the
    selected DFT output rows sel; the zero padding contributes nothing"""
    f = np.fft.fftfreq(target_dim)[np.asarray(sel)]
    y = offset + np.arange(nin)
    return np.exp(sign * 2j * np.pi * np.outer(y, f))


@functools.lru_cache(maxsize=64)
def _kernels(N, kernel, jac_tuple, fwhm, fwhm_smooth):
    build = ksigma_kernels if kernel == "ksigma" else gauss_kernels
    return build(N, fwhm, jac_tuple, fwhm_smooth)


def _kernel_args(target_dim, kernel, jac_tuple, fwhm, fwhm_smooth):
    """the hashable key of a kernel's constants: "ksigma", or "gauss"
    for any other kernel name, as in the JAX package"""
    return (int(target_dim), "ksigma" if kernel == "ksigma" else "gauss",
            tuple(float(x) for x in jac_tuple), float(fwhm), float(fwhm_smooth))


def _selfconj(i, N):
    return i == 0 or (N % 2 == 0 and i == N // 2)


@functools.lru_cache(maxsize=64)
def _mode_plan(N, kernel, jac_tuple, fwhm, fwhm_smooth):
    """the partial-mode route's selection: the rows of the canonical
    half-plane and the columns inside the support mask, the moment-sum
    planes kmat [M, 4] and the covariance products cmat [M, 10] with
    the mask and the conjugate-pair weights folded in, and the DC mode's
    place in the selection.

    Real inputs give modes in conjugate pairs k <-> -k, and every
    consumed quantity is even under the pairing, so a pair counts twice
    from its canonical member, a self-conjugate mode once, and the
    dropped half of a self-conjugate row not at all."""
    kern = _kernels(N, kernel, jac_tuple, fwhm, fwhm_smooth)
    msk = kern["msk"]
    all_rows = np.flatnonzero(msk.any(axis=1))
    cols = np.flatnonzero(msk.any(axis=0))
    freqs = np.fft.fftfreq(N)
    rows = np.asarray(
        [r for r in all_rows if freqs[r] > 0 or _selfconj(r, N)], np.int64
    )
    wgt = np.full((rows.size, cols.size), 2.0)
    for i, r in enumerate(rows):
        if _selfconj(r, N):
            for j, c in enumerate(cols):
                if _selfconj(c, N):
                    wgt[i, j] = 1.0
                elif freqs[c] < 0:
                    wgt[i, j] = 0.0
    fm = msk[np.ix_(rows, cols)].astype(np.float64) * wgt
    fk = [kern[k][np.ix_(rows, cols)] for k in ("fkp", "fkc", "fkr", "fkf")]
    kmat = np.stack([(f * fm).reshape(-1) for f in fk], axis=-1)
    cmat = np.stack(
        [(fk[i] * fk[j] * fm).reshape(-1) for i, j in _PAIRS], axis=-1
    )
    return dict(
        rows=rows, cols=cols, kmat=kmat, cmat=cmat,
        i0r=int(np.flatnonzero(rows == 0)[0]), i0c=int(np.flatnonzero(cols == 0)[0]),
        nrm=float(kern["nrm"]), fk00=float(kern["fk00"]),
    )


# the covariance entries (i, j), i <= j, of the four moment kernels
_PAIRS = tuple((i, j) for i in range(4) for j in range(i, 4))


def _pixel_fft_np(dim):
    f = np.sinc(np.fft.fftfreq(dim))
    return f[:, None] * f[None, :]


_BUILDERS = {
    "apod": lambda H, W, ap_rad: apodization_mask((H, W), ap_rad),
    "freq": lambda N: 2 * np.pi * np.fft.fftfreq(N),
    "pixel": _pixel_fft_np,
    "kern": lambda name, *kargs: _kernels(*kargs)[name],
    "plan": lambda name, *kargs: _mode_plan(*kargs)[name],
    "freq_sel": lambda axis, *kargs: (
        2 * np.pi * np.fft.fftfreq(kargs[0])[_mode_plan(*kargs)[axis]]
    ),
    "dft_sel": lambda axis, nin, offset, *kargs: _partial_dft_matrix(
        kargs[0], _mode_plan(*kargs)[axis], nin, offset
    ),
}


@functools.lru_cache(maxsize=256)
def _const(kind, args, device, dtype):
    """the host-built float64 / complex128 constant cast to dtype on
    device; callers must not modify it in place"""
    return torch.as_tensor(_BUILDERS[kind](*args)).to(device=device, dtype=dtype)


# ----------------------------------------------------------------------
# the full-FFT route, batched over [B]

def _pad_and_fft(im, cen, target_dim, ap_rad):
    """apodize, symmetric zero pad and FFT [B, H, W] stamps; returns
    (kim [B, N, N], padded cen [B, 2])"""
    H, W = im.shape[-2:]
    if ap_rad > 0:
        im = im * _const("apod", (H, W, float(ap_rad)), im.device, im.dtype)
    before = _zero_pad_offsets(W, target_dim)
    after = target_dim - W - before
    pim = torch.nn.functional.pad(im, (before, after, before, after))
    return torch.fft.fft2(pim), cen + before


def _cen_phase(dim, cen_row, cen_col, dtype):
    """exp(i 2 pi f . cen) [B, dim, dim] for centers [B]"""
    f = _const("freq", (dim,), cen_row.device, dtype)
    kcen = f[None, :, None] * cen_row[:, None, None] + f[None, None, :] * cen_col[:, None, None]
    return torch.exp(1j * kcen)


def _pixel_fft(dim, dtype, device):
    """k-response of the pixel [dim, dim], complex"""
    return _const("pixel", (dim,), device, complex_dtype(dtype))


def _deconvolve_at(kim, kpsf, i0r, i0c, min_psf_frac=1e-5):
    """deconvolve with a |P| floor of min_psf_frac times |P| at the DC
    mode, which sits at [..., i0r, i0c]; returns (kim / P_fl, P_fl)"""
    max_amp = torch.abs(kpsf[..., i0r, i0c])[..., None, None]
    min_amp = min_psf_frac * max_amp
    amp = torch.abs(kpsf)
    kpsf_fl = torch.where(
        (amp <= min_amp) & (amp != 0),
        kpsf / torch.where(amp == 0, 1.0, amp) * min_amp,
        kpsf,
    )
    kpsf_fl = torch.where(amp == 0, min_amp.to(kpsf.dtype), kpsf_fl)
    return kim / kpsf_fl, kpsf_fl


def _deconvolve(kim, kpsf, min_psf_frac=1e-5):
    """_deconvolve_at with the DC mode at [..., 0, 0]"""
    return _deconvolve_at(kim, kpsf, 0, 0, min_psf_frac)


def measure_moments_fft(kim, kpsf, pnoise_white, kernels, drow, dcol, knoise=None):
    """masked k-space dot products and the 6x6 noise covariance of
    [B, N, N] transforms; kernels holds the [N, N] planes (fkf, fkr,
    fkp, fkc, msk) on the device. pnoise_white [B] is the white
    per-mode power; knoise (the FFT of the noise stamps) gives the
    measured per-mode power instead. Returns (mom [B, 6], cov
    [B, 6, 6], fk00)."""
    B, dim = kim.shape[0], kim.shape[-1]
    rdtype = kim.real.dtype
    fm = kernels["msk"]

    kim_d, kpsf_fl = _deconvolve(kim, kpsf)
    kim_d = kim_d * _cen_phase(dim, drow, dcol, rdtype)

    df = 1.0 / dim
    df2 = df * df
    df4 = df2 * df2

    fkf, fkr, fkp, fkc = (kernels[k] for k in ("fkf", "fkr", "fkp", "fkc"))

    def msum(x):
        return torch.sum(x, dim=(-2, -1))

    mf = msum((kim_d * fkf).real * fm) * df2
    mr = msum((kim_d * fkr).real * fm) * df2
    mp = msum((kim_d * fkp).real * fm) * df2
    mc = msum((kim_d * fkc).real * fm) * df2

    if knoise is not None:
        pnoise = torch.abs(knoise) ** 2
    else:
        pnoise = pnoise_white[:, None, None]

    ipsf = 1.0 / kpsf_fl
    kerns = [fkp * ipsf, fkc * ipsf, fkr * ipsf, fkf * ipsf]

    cov = torch.zeros((B, 6, 6), dtype=rdtype, device=kim.device)
    cov[:, 0, 0] = 1.0
    cov[:, 1, 1] = 1.0
    for i in range(2, 6):
        for j in range(i, 6):
            val = msum((kerns[i - 2] * torch.conj(kerns[j - 2])).real * pnoise * fm) * df4
            cov[:, i, j] = val
            cov[:, j, i] = val

    nan = torch.full_like(mf, torch.nan)
    mom = torch.stack([nan, nan, mp, mc, mr, mf], dim=-1)
    return mom, cov, kernels["fk00"]


def prepsfmom_core(images, cens, psf_images, psf_cens, tot_var, noise_images,
                   target_dim, ap_rad, kernel, jac_tuple, fwhm, fwhm_smooth,
                   has_psf, use_noise):
    """the full-FFT route over [B] stamps -> (mom [B, 6], cov [B, 6, 6],
    norm [B], nrm [B]); has_psf=False deconvolves the pixel response
    alone, use_noise takes the per-mode power of noise_images"""
    B, dim = images.shape[0], images.shape[-1]
    dtype, dev = images.dtype, images.device
    eff_pad_factor = target_dim / dim

    kim, pcen = _pad_and_fft(images, cens, target_dim, ap_rad)
    if has_psf:
        kpsf, ppcen = _pad_and_fft(psf_images, psf_cens, target_dim, 0.0)
    else:
        kpsf = _pixel_fft(target_dim, dtype, dev).expand(B, target_dim, target_dim)
        ppcen = torch.zeros((B, 2), dtype=dtype, device=dev)

    kargs = _kernel_args(target_dim, kernel, jac_tuple, fwhm, fwhm_smooth)
    kernels = {k: _const("kern", (k,) + kargs, dev, dtype)
               for k in ("fkf", "fkr", "fkp", "fkc", "msk")}
    kernels["fk00"] = torch.full((B,), _kernels(*kargs)["fk00"], dtype=dtype, device=dev)

    if use_noise:
        knoise, _ = _pad_and_fft(noise_images, cens, target_dim, 0.0)
        knoise = knoise * eff_pad_factor
        pnoise_white = None
    else:
        knoise = None
        pnoise_white = tot_var * eff_pad_factor**2

    mom, cov, norm = measure_moments_fft(
        kim, kpsf, pnoise_white, kernels,
        pcen[:, 0] - ppcen[:, 0], pcen[:, 1] - ppcen[:, 1], knoise=knoise,
    )
    nrm = torch.full((B,), _kernels(*kargs)["nrm"], dtype=dtype, device=dev)
    return mom, cov, norm, nrm


# ----------------------------------------------------------------------
# the batched entry point

def _partial_dft(x, Fr, Fc):
    """[B, h, w] real block -> [B, nrows, ncols] selected modes"""
    out = torch.matmul(Fr.transpose(0, 1), x.to(Fr.dtype))
    return torch.matmul(out, Fc)


def prepsfmom_batch(images, cens, psf_images, psf_cens, tot_var, target_dim,
                    kernel, jac_tuple, fwhm, ap_rad=1.5, fwhm_smooth=0.0,
                    partial_modes=True, noise_images=None, device=None):
    """batched pre-psf moments over a [B] batch of square stamps.

    images [B, H, H]; cens and psf_cens [B, 2]; psf_images [B, Hp, Hp];
    tot_var [B], the white noise variance summed over each stamp; as
    numpy arrays or tensors, run on the CUDA card unless the caller
    passes device="cpu" (the real dtype of the images is kept). kernel
    "ksigma" or "gauss" (any other name is the gaussian kernel), of
    FWHM fwhm on the padded grid of target_dim. noise_images [B, H, H]
    switch the covariance from the white per-mode power to the measured
    per-mode power |fft(noise)|^2. Returns the moments result dict
    (moments.make_mom_result; the first two sums are NaN) with
    kernel_nrm [B], the kernel's normalization (1 on a large enough
    grid).

    partial_modes=True takes the partial-DFT route (see the module
    docstring), False the full-FFT route; they agree to float64
    round-off.
    """
    full_precision_matmuls()
    dev = resolve_device(device)
    images = torch.as_tensor(images, device=dev)
    dtype = images.dtype
    cens, psf_images, psf_cens, tot_var = (
        torch.as_tensor(x, device=dev).to(dtype)
        for x in (cens, psf_images, psf_cens, tot_var)
    )
    B = images.shape[0]
    tot_var = torch.broadcast_to(tot_var, (B,))
    if noise_images is not None:
        noise_images = torch.as_tensor(noise_images, device=dev).to(dtype)
    kargs = _kernel_args(target_dim, kernel, jac_tuple, fwhm, fwhm_smooth)

    if not partial_modes:
        use_noise = noise_images is not None
        mom, cov, norm, nrm = prepsfmom_core(
            images, cens, psf_images, psf_cens, tot_var,
            noise_images if use_noise else torch.zeros_like(images),
            int(target_dim), float(ap_rad), kernel, jac_tuple, float(fwhm),
            float(fwhm_smooth), True, use_noise,
        )
        res = make_mom_result(mom, cov, sums_norm=norm)
        res["kernel_nrm"] = nrm
        return res

    N = int(target_dim)
    H, W = images.shape[-2:]
    Hp, Wp = psf_images.shape[-2:]
    cdtype = complex_dtype(dtype)
    plan = _mode_plan(*kargs)
    M = plan["rows"].size * plan["cols"].size

    off_g = _zero_pad_offsets(H, N)
    off_p = _zero_pad_offsets(Hp, N)
    Fr_g = _const("dft_sel", ("rows", H, off_g) + kargs, dev, cdtype)
    Fc_g = _const("dft_sel", ("cols", W, off_g) + kargs, dev, cdtype)
    Fr_p = _const("dft_sel", ("rows", Hp, off_p) + kargs, dev, cdtype)
    Fc_p = _const("dft_sel", ("cols", Wp, off_p) + kargs, dev, cdtype)
    fsel_r = _const("freq_sel", ("rows",) + kargs, dev, dtype)
    fsel_c = _const("freq_sel", ("cols",) + kargs, dev, dtype)
    kmat = _const("plan", ("kmat",) + kargs, dev, dtype)
    cmat = _const("plan", ("cmat",) + kargs, dev, dtype)

    im_ap = images
    if ap_rad > 0:
        im_ap = images * _const("apod", (H, W, float(ap_rad)), dev, dtype)
    kim = _partial_dft(im_ap, Fr_g, Fc_g)
    kpsf = _partial_dft(psf_images, Fr_p, Fc_p)
    kim_d, kpsf_fl = _deconvolve_at(kim, kpsf, plan["i0r"], plan["i0c"])

    # separable center phase about the (padded) galaxy-psf centroid
    # offset; the pad offsets cancel but for the stamp-size mismatch
    drow = (cens[:, 0] + off_g) - (psf_cens[:, 0] + off_p)
    dcol = (cens[:, 1] + off_g) - (psf_cens[:, 1] + off_p)
    ph_r = torch.exp(1j * fsel_r[None, :] * drow[:, None])
    ph_c = torch.exp(1j * fsel_c[None, :] * dcol[:, None])
    kim_d = kim_d * ph_r[:, :, None] * ph_c[:, None, :]

    df2 = 1.0 / (N * N)
    # the kernel planes are real: only the real part of the
    # deconvolved modes enters the sums
    mom4 = torch.matmul(kim_d.real.reshape(B, M).contiguous(), kmat) * df2

    eff_pad = N / H
    w = (1.0 / torch.abs(kpsf_fl) ** 2).reshape(B, M)
    if noise_images is not None:
        # the measured per-mode power at the selected modes: the same
        # partial DFT of the noise stamps, without apodization
        knz = _partial_dft(noise_images, Fr_g, Fc_g)
        pmode = (torch.abs(knz) ** 2).reshape(B, M) * eff_pad**2
        cvals = torch.matmul(w * pmode, cmat) * (df2 * df2)
    else:
        pnoise = tot_var * eff_pad**2  # [B] white per-mode power
        cvals = torch.matmul(w, cmat) * (pnoise[:, None] * df2 * df2)
    cov = torch.zeros((B, 6, 6), dtype=dtype, device=dev)
    cov[:, 0, 0] = 1.0
    cov[:, 1, 1] = 1.0
    for k, (i, j) in enumerate(_PAIRS):
        cov[:, 2 + i, 2 + j] = cvals[:, k]
        cov[:, 2 + j, 2 + i] = cvals[:, k]

    nan = torch.full((B,), torch.nan, dtype=dtype, device=dev)
    mom = torch.stack([nan, nan, mom4[:, 0], mom4[:, 1], mom4[:, 2], mom4[:, 3]], dim=-1)
    res = make_mom_result(
        mom, cov, sums_norm=torch.full((B,), plan["fk00"], dtype=dtype, device=dev)
    )
    res["kernel_nrm"] = torch.full((B,), plan["nrm"], dtype=dtype, device=dev)
    return res


# ----------------------------------------------------------------------
# host API

class PrePSFMom(object):
    """pre-psf weighted moments of one observation with the ksigma
    kernel or the gaussian one ("gauss" or "pgauss")"""

    def __init__(self, fwhm, kernel, pad_factor=4, ap_rad=1.5,
                 fwhm_smooth=0, use_noise_image=False):
        self.fwhm = fwhm
        self.pad_factor = pad_factor
        self.kernel = kernel
        self.ap_rad = ap_rad
        self.fwhm_smooth = fwhm_smooth
        self.use_noise_image = use_noise_image
        if self.kernel == "ksigma":
            self.kind = "ksigma"
        elif self.kernel in ["gauss", "pgauss"]:
            self.kind = "pgauss"
        else:
            raise ValueError(
                "The kernel '%s' for PrePSFMom is not recognized!"
                % self.kernel
            )

    def go(self, obs, return_kernels=False, no_psf=False):
        """the moments result dict (numpy, with flag strings) of obs;
        no_psf deconvolves the pixel response alone. return_kernels is
        taken for the reference's signature and returns nothing more,
        as in the JAX package."""
        psf_obs = _check_obs_and_get_psf_obs(obs, no_psf)

        if psf_obs is not None and (
            psf_obs.image.shape[0] > obs.image.shape[0]
        ):
            target_dim = int(psf_obs.image.shape[0] * self.pad_factor)
        else:
            target_dim = int(obs.image.shape[0] * self.pad_factor)

        jac = obs.jacobian
        jac_tuple = (jac.dvdrow, jac.dvdcol, jac.dudrow, jac.dudcol)

        msk = obs.weight > 0
        tot_var = float(np.sum(1.0 / obs.weight[msk]))

        full_precision_matmuls()
        dev = obs.device

        def one(x):
            return torch.tensor(np.asarray(x, dtype=np.float64), device=dev)[None]

        if self.use_noise_image:
            if not obs.has_noise():
                raise ValueError(
                    "obs.noise must be set when use_noise_image=True"
                )
            noise_image = one(obs.noise)
        else:
            noise_image = torch.zeros_like(one(obs.image))

        if psf_obs is not None:
            psf_image = one(psf_obs.image)
            psf_cen = one(psf_obs.jacobian.get_cen())
        else:
            psf_image = one(np.zeros((1, 1)))
            psf_cen = one(np.zeros(2))

        mom, cov, norm, nrm = prepsfmom_core(
            one(obs.image), one(jac.get_cen()), psf_image, psf_cen, one(tot_var),
            noise_image, int(target_dim), float(self.ap_rad),
            self.kind if self.kind == "ksigma" else "gauss", jac_tuple,
            float(self.fwhm), float(self.fwhm_smooth), psf_obs is not None,
            bool(self.use_noise_image),
        )

        nrm = float(nrm[0])
        if not np.allclose(nrm, 1.0, atol=1e-5, rtol=0):
            raise FFTRangeError(
                "FFT size appears to be too small for %s kernel size %f: "
                "norm = %f (should be 1)!" % (self.kind, self.fwhm, nrm)
            )

        res = result_to_host(make_mom_result(mom, cov, sums_norm=norm), index=0)
        if res["flags"] != 0:
            logger.debug("pre-psf moments failed: %s" % res["flagstr"])
        return res


class KSigmaMom(PrePSFMom):
    """ksigma pre-psf moments (Bernstein et al., arXiv:1508.05655)"""

    def __init__(self, fwhm, pad_factor=4, ap_rad=1.5, fwhm_smooth=0,
                 use_noise_image=False):
        super().__init__(
            fwhm, "ksigma", pad_factor=pad_factor, ap_rad=ap_rad,
            fwhm_smooth=fwhm_smooth, use_noise_image=use_noise_image,
        )


class PGaussMom(PrePSFMom):
    """gaussian-kernel pre-psf moments"""

    def __init__(self, fwhm, pad_factor=4, ap_rad=1.5, fwhm_smooth=0,
                 use_noise_image=False):
        super().__init__(
            fwhm, "pgauss", pad_factor=pad_factor, ap_rad=ap_rad,
            fwhm_smooth=fwhm_smooth, use_noise_image=use_noise_image,
        )


PrePSFGaussMom = PGaussMom


def _check_obs_and_get_psf_obs(obs, no_psf):
    """the psf observation of obs (None with no_psf); raises for a
    non-square image, a missing psf, or a psf of another WCS matrix"""
    if not isinstance(obs, Observation):
        raise ValueError("input obs must be an Observation")

    shape = obs.image.shape
    if shape[0] != shape[1]:
        raise ValueError(
            "pre-psf moments require a square image, got %s" % (shape,)
        )

    if not obs.has_psf() and not no_psf:
        raise RuntimeError("The PSF must be set to measure a pre-PSF moment!")

    if not no_psf:
        psf_obs = obs.get_psf()
        j1 = obs.jacobian
        j2 = psf_obs.jacobian
        same = all(
            np.isclose(getattr(j1, a), getattr(j2, a))
            for a in ("dvdrow", "dvdcol", "dudrow", "dudcol")
        )
        if not same:
            raise RuntimeError(
                "The PSF and observation must have the same WCS "
                "Jacobian for measuring pre-PSF moments."
            )
    else:
        psf_obs = None

    return psf_obs


# the reference's caching toggles: the port caches its constants per
# configuration and device (_const), so they change nothing
def turn_on_fft_caching():
    pass


def turn_off_fft_caching():
    pass


def turn_on_kernel_caching():
    pass


def turn_off_kernel_caching():
    pass
