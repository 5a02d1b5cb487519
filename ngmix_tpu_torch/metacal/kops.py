"""k-space image operations for metacal.

The port of ``ngmix_tpu/metacal/kops.py``. Everything happens in the
pixel-frame Fourier domain on one padded grid: deconvolution by the
psf, the exact shear remap of the transform, reconvolution by the
target and a partial inverse transform onto the fit window.

Every constant matrix (DFT, remap, crop) and shear phase is built in
float64 numpy on the host, cast once to the working type and cached
per (shape, b, shift, device, dtype), so no matrix is rebuilt or
copied to the card on each call. FFTs are ``torch.fft``; matrix
products are ``torch.matmul``, which must run with TF32 off
(util.full_precision_matmuls).
"""
import functools

import numpy as np
import torch

# the scale-axis evaluation is a dense [N, N] matrix product up to this
# grid size, and a chirp-z transform (O(N log N)) above it
MAX_MATMUL_N = 512


def good_fft_size(n):
    """smallest even size >= n with prime factors in {2, 3, 5}"""
    m = n + (n % 2)
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 2


def complex_dtype(dtype):
    """complex counterpart of a real (or complex) torch dtype"""
    if dtype in (torch.float64, torch.complex128):
        return torch.complex128
    return torch.complex64


def _signed(N):
    """signed frequency indices in fft order, float64 numpy [N]"""
    return np.fft.fftfreq(N, d=1.0 / N)


# ----------------------------------------------------------------------
# host-built constants, cached per device and dtype

def _build_kgrids(N):
    k = 2 * np.pi * np.fft.fftfreq(N)
    return k[:, None], k[None, :]


def _build_pixel_kresponse(N):
    s = np.sinc(np.fft.fftfreq(N))
    return s[:, None] * s[None, :]


def _wcs(jac):
    """the hashable WCS matrix (dvdrow, dvdcol, dudrow, dudcol) of a
    jacobian, or of anything with those four fields"""
    return tuple(float(getattr(jac, k)) for k in ("dvdrow", "dvdcol", "dudrow", "dudcol"))


def _build_sky_kvu(N, wcs):
    kr, kc = _build_kgrids(N)
    J = np.array(wcs, dtype=float).reshape(2, 2)
    Jinv = np.linalg.inv(J)
    # k_sky = J^-T kappa
    kv = Jinv[0, 0] * kr + Jinv[1, 0] * kc
    ku = Jinv[0, 1] * kr + Jinv[1, 1] * kc
    return kv, ku


def _build_sky_ksq(N, wcs):
    kv, ku = _build_sky_kvu(N, wcs)
    return kv * kv + ku * ku


def _build_scale_w(N, b):
    """W[m, j] = e^{2 pi i b m j / N} / N over signed fft-order indices"""
    mf = _signed(N)
    return np.exp((2j * np.pi * float(b) / N) * np.outer(mf, mf)) / N


def _build_scale_fw(N, b):
    """the forward DFT folded into W: Wt[x, j] = sum_m F[m, x] W[m, j]"""
    mf = _signed(N)
    F = np.exp((-2j * np.pi / N) * np.outer(mf, np.arange(N)))
    return F.T @ _build_scale_w(N, b)


def _build_shift_phase(N, coef, axis):
    """e^{2 pi i m coef o / N} in tensor layout [N, N], with m the
    signed index along ``axis`` (-2 or -1) and o the signed index
    along the other axis: the shear factor of remap_k"""
    mf = _signed(N)
    ph = np.exp((2j * np.pi * float(coef) / N) * np.outer(mf, mf))
    return ph if axis == -2 else ph.T


def _build_czt_chirp(N, b):
    """e^{i pi b m^2 / N} over the natural-order signed index m"""
    m = np.arange(N) - N // 2
    return np.exp(1j * np.pi * float(b) * m * m / N)


def _build_czt_filter(N, b):
    """the FFT over good_fft_size(2 N) points of the zero-padded chirp
    filter e^{-i pi b t^2 / N}, t in [-(N-1), N-1]"""
    L = good_fft_size(2 * N)
    t = np.arange(-(N - 1), N)
    v = np.zeros(L, dtype=np.complex128)
    v[: t.size] = np.exp(-1j * np.pi * float(b) * t * t / N)
    return np.fft.fft(v)


def _build_zeropad_dft(N, n):
    """[n, N] forward DFT rows of the first n inputs of an N-grid"""
    return np.exp((-2j * np.pi / N) * np.outer(np.arange(n), _signed(N)))


def partial_idft_matrix(N, start, count):
    """[N, count] inverse-DFT evaluation matrix for output rows
    start..start+count-1 of an N-point inverse transform:
    E[m, r] = exp(2 pi i m (start + r) / N) / N, float64 phases"""
    m = _signed(N)
    r = start + np.arange(count)
    return np.exp((2j * np.pi / N) * np.outer(m, r)) / N


_BUILDERS = {
    "kgrid_r": lambda N: _build_kgrids(N)[0],
    "kgrid_c": lambda N: _build_kgrids(N)[1],
    "signed": _signed,
    "pixel": _build_pixel_kresponse,
    "sky_kv": lambda N, wcs: _build_sky_kvu(N, wcs)[0],
    "sky_ku": lambda N, wcs: _build_sky_kvu(N, wcs)[1],
    "sky_ksq": _build_sky_ksq,
    "scale_w": _build_scale_w,
    "scale_fw": _build_scale_fw,
    "shift_phase": _build_shift_phase,
    "czt_chirp": _build_czt_chirp,
    "czt_filter": _build_czt_filter,
    "zeropad_dft": _build_zeropad_dft,
    "partial_idft": partial_idft_matrix,
}


@functools.lru_cache(maxsize=256)
def _const(kind, args, device, dtype):
    """the host-built float64 / complex128 constant cast to dtype on
    device; callers must not modify it in place"""
    return torch.as_tensor(_BUILDERS[kind](*args)).to(device=device, dtype=dtype)


def _dev(device):
    return torch.device(device if device is not None else "cpu")


# ----------------------------------------------------------------------
# grids

def signed_index(N, dtype=torch.float64, device=None):
    """signed frequency indices [-N/2, N/2) in fft order, [N]"""
    return _const("signed", (N,), _dev(device), dtype)


def kgrids(N, dtype=torch.float64, device=None):
    """pixel-frame angular frequencies (radians/pixel) in fft order:
    (krow [N, 1], kcol [1, N])"""
    dev = _dev(device)
    return _const("kgrid_r", (N,), dev, dtype), _const("kgrid_c", (N,), dev, dtype)


def pixel_kresponse(N, dtype=torch.float64, device=None):
    """k-response of the (WCS-distorted) pixel: the unit square in
    pixel coordinates gives a separable sinc product, [N, N]"""
    return _const("pixel", (N,), _dev(device), dtype)


def sky_kvu(N, jac, dtype=torch.float64, device=None):
    """sky-frame k components (kv, ku) on the pixel-frame fft grid"""
    dev = _dev(device)
    return (
        _const("sky_kv", (N, _wcs(jac)), dev, dtype),
        _const("sky_ku", (N, _wcs(jac)), dev, dtype),
    )


def sky_ksq(N, jac, dtype=torch.float64, device=None):
    """|k_sky|^2 on the pixel-frame grid, [N, N]"""
    return _const("sky_ksq", (N, _wcs(jac)), _dev(device), dtype)


# ----------------------------------------------------------------------
# transforms

def fft_axis(A, axis=-1, inverse=False):
    """the 1-d FFT (or its inverse) along one axis"""
    return torch.fft.ifft(A, dim=axis) if inverse else torch.fft.fft(A, dim=axis)


def fft2_auto(A, inverse=False):
    """2-D FFT over the last two axes"""
    return torch.fft.ifft2(A) if inverse else torch.fft.fft2(A)


def dft2_zeropad(img, N):
    """forward 2-D DFT of an [..., H, W] real block zero-padded to
    N x N, by DFT matrix products over only the H (W) nonzero rows
    (columns); the padded buffer is never built"""
    H, W = img.shape[-2:]
    cdtype = complex_dtype(img.dtype)
    Fr = _const("zeropad_dft", (N, H), img.device, cdtype)
    Fc = _const("zeropad_dft", (N, W), img.device, cdtype)
    out = torch.matmul(Fr.transpose(0, 1), img.to(cdtype))
    return torch.matmul(out, Fc)


def idft2_crop(khat, r0, c0, nrows, ncols):
    """rows r0..r0+nrows-1, cols c0..c0+ncols-1 of ifft2(khat), by two
    partial inverse-DFT matrix products"""
    N = khat.shape[-1]
    Er = _const("partial_idft", (N, r0, nrows), khat.device, khat.dtype)
    Ec = _const("partial_idft", (N, c0, ncols), khat.device, khat.dtype)
    out = torch.matmul(Er.transpose(0, 1), khat)
    return torch.matmul(out, Ec)


def center_phase(cen, N, dtype, sign):
    """the separable center-shift phase e^{sign i (kr c0 + kc c1)}
    [..., N, N] of centers cen [..., 2], as the outer product of two
    phase vectors"""
    kr, kc = kgrids(N, dtype=dtype, device=cen.device)
    pr = torch.exp(sign * 1j * kr[:, 0] * cen[..., 0, None])
    pc = torch.exp(sign * 1j * kc[0, :] * cen[..., 1, None])
    return pr[..., :, None] * pc[..., None, :]


def centered_fft(img, cen, N):
    """the N x N FFT of real stamps img [..., H, W] with phases referenced
    to the (fractional) centers cen [..., 2]: khat(kappa) = sum_x img(x)
    e^{-i kappa.(x - cen)}, so the profile sits at the origin. Stamps of
    at most N / 2 a side take the partial-input DFT products
    (dft2_zeropad), larger ones a padded FFT"""
    H, W = img.shape[-2:]
    cen = torch.as_tensor(cen, dtype=img.dtype, device=img.device)
    phase = center_phase(cen, N, img.dtype, +1.0)
    if H <= N // 2 and W <= N // 2:
        return dft2_zeropad(img, N) * phase
    pad = torch.zeros(img.shape[:-2] + (N, N), dtype=complex_dtype(img.dtype),
                      device=img.device)
    pad[..., :H, :W] = img
    return fft2_auto(pad) * phase


def centered_ifft(khat, cen, dims):
    """the inverse of centered_fft: a centered k profile [..., N, N]
    rendered into [..., dims] stamps whose centers land at cen [..., 2]"""
    N = khat.shape[-1]
    dtype = khat.real.dtype
    cen = torch.as_tensor(cen, dtype=dtype, device=khat.device)
    phase = center_phase(cen, N, dtype, -1.0)
    full = fft2_auto(khat * phase, inverse=True).real
    return full[..., : dims[0], : dims[1]]


def deconvolve_k(imhat, psfhat, eps=1.0e-10):
    """I(k)/P(k) with an amplitude floor that keeps the division
    finite; modes at the floor are suppressed by the target psf"""
    amp = torch.abs(psfhat)
    max_amp = torch.amax(amp, dim=(-2, -1), keepdim=True)
    floor = (eps * max_amp).to(psfhat.dtype)
    safe = torch.where(amp > eps * max_amp, psfhat, floor)
    return imhat / safe


def gauss_kprofile(N, jac, sigma, flux=1.0, dtype=torch.float64, device=None):
    """the k profile [N, N] of a round gaussian of sky sigma on the
    pixel-frame grid (no pixel factor)"""
    return flux * torch.exp(-0.5 * sigma**2 * sky_ksq(N, jac, dtype=dtype, device=device))


def gauss_target_sigma(psfhat, ksq, small_kval=1.0e-2, smaller_kval=3.0e-3):
    """round-gaussian target psf size from k-power pinning: the
    smallest |k_sky|^2 where Re(P)/P(0) < small_kval gets the value
    smaller_kval in the target"""
    re = psfhat.real / psfhat.real[..., 0:1, 0:1]
    cond = re < small_kval
    ksq_max = torch.amin(
        torch.where(cond, ksq, torch.inf), dim=(-2, -1)
    )
    sigma_sq = -2.0 * np.log(smaller_kval) / ksq_max
    return torch.sqrt(sigma_sq)


def azgauss_target_sigma(psfhat, ksq, nbin, small_kval=3.0e-2,
                         smaller_kval=9.0e-3):
    """round-gaussian target psf size [B] of psfhat [B, N, N] from the
    azimuthally averaged k profile: annuli of width dk = |k|[0, 1] over
    the shared ksq [N, N] (bins at or beyond nbin are dropped, empty
    ones are inf), the first annulus i >= 1 whose mean Re(P)/P(0) is
    below small_kval, a log-interpolated crossing between annuli i - 1
    and i (linear where either is not positive), and the value
    smaller_kval there in the target"""
    B = psfhat.shape[0]
    re = (psfhat.real / psfhat.real[..., 0:1, 0:1]).reshape(B, -1)
    kmag = torch.sqrt(ksq)
    dk = kmag[0, 1]
    # one overflow bin at nbin takes the dropped indices
    ibin = torch.clamp(torch.round(kmag / dk).to(torch.int64), max=nbin).reshape(-1)
    num = torch.zeros(nbin + 1, dtype=re.dtype, device=re.device).index_add_(
        0, ibin, torch.ones_like(re[0]))[:nbin]
    tot = torch.zeros((B, nbin + 1), dtype=re.dtype, device=re.device).scatter_add_(
        1, ibin.expand(B, -1), re)[:, :nbin]
    prof = torch.where(num > 0, tot / torch.where(num > 0, num, 1.0), torch.inf)

    thresh = small_kval
    # the first annulus below the threshold (argmax returns the first
    # maximum), at least 1
    i = torch.clamp(torch.argmax((prof < thresh).to(torch.int32), dim=-1), min=1)
    p0 = torch.gather(prof, 1, (i - 1)[:, None])[:, 0]
    p1 = torch.gather(prof, 1, i[:, None])[:, 0]
    pos = (p0 > 0) & (p1 > 0)
    lp0 = torch.log(torch.abs(p0) + 1e-300)
    frac_log = (np.log(thresh) - lp0) / (torch.log(torch.abs(p1) + 1e-300) - lp0)
    frac_lin = (thresh - p0) / torch.where(p1 != p0, p1 - p0, 1.0)
    frac = torch.where(pos, frac_log, frac_lin)
    k_cross = ((i - 1).to(re.dtype) + frac) * dk
    sigma_sq = -2.0 * np.log(smaller_kval) / k_cross**2
    return torch.sqrt(sigma_sq)


# ----------------------------------------------------------------------
# exact shear remap

def shear_matrix(g1, g2):
    """reduced-shear coordinate matrix S (unit det) in the (v, u)
    sky-vector ordering: profile.shear(g) means f'(x) = f(S^-1 x)"""
    gsq = g1 * g1 + g2 * g2
    f = 1.0 / np.sqrt(1.0 - gsq)
    return np.array([[1.0 - g1, g2], [g2, 1.0 + g1]]) * f


def kmap_matrix(jac, S):
    """pixel-frame k-domain matrix for a sky-coordinate transform S:
    khat'(kappa) = khat(M kappa) with M = J^T S^T J^-T"""
    J = np.array(
        [[jac.dvdrow, jac.dvdcol], [jac.dudrow, jac.dudcol]], dtype=float
    )
    Jinv = np.linalg.inv(J)
    return J.T @ S.T @ Jinv.T


def _scale_axis_matmul(A, b, axis, shift=None):
    """evaluate the trig-poly interpolant of A at b * j + shift along
    ``axis`` (-2 or -1) by direct DFT evaluation: one FFT and one
    [N, N] matrix product.

    shift is a scalar coefficient: the shift at a point is shift times
    the signed index along the other axis (the shear factor of
    remap_k). With no shift the FFT folds into the matrix."""
    N = A.shape[axis]
    dev, cdtype = A.device, complex_dtype(A.dtype)
    A = A.to(cdtype)
    if shift is None:
        Wt = _const("scale_fw", (N, float(b)), dev, cdtype)
        return torch.matmul(A, Wt) if axis == -1 else torch.matmul(Wt.T, A)
    Ahat = torch.fft.fft(A, dim=axis)
    Ahat = Ahat * _const("shift_phase", (N, float(shift), axis), dev, cdtype)
    W = _const("scale_w", (N, float(b)), dev, cdtype)
    return torch.matmul(Ahat, W) if axis == -1 else torch.matmul(W.T, Ahat)


def _along(x, axis, ndim):
    """a [n] constant shaped to broadcast along axis of an ndim tensor"""
    shape = [1] * ndim
    shape[axis] = x.shape[0]
    return x.reshape(shape)


def _czt_scale_axis(A, b, axis, shift=None):
    """evaluate the trig-poly interpolant of A at b * j + shift along
    ``axis`` (-2 or -1), with j the signed fft-order index, by a
    Bluestein chirp transform: exact, O(N log N).

    A(b j) = (1/N) sum_m Ahat_m e^{2 pi i m b j / N}; with m b j = (m^2
    + j^2 - (j - m)^2) b / 2 this is a linear convolution against a
    chirp, done with zero-padded FFTs over good_fft_size(2 N) points.
    shift is a scalar coefficient as in _scale_axis_matmul (the shear
    factor of remap_k), applied in the conjugate domain. With no shift
    and b = 1 it is the identity. The chirps and the filter's FFT are
    built in float64 on the host."""
    N = A.shape[axis]
    dev, cdtype = A.device, complex_dtype(A.dtype)
    Ahat = torch.fft.fft(A.to(cdtype), dim=axis)
    if shift is not None:
        Ahat = Ahat * _const("shift_phase", (N, float(shift), axis), dev, cdtype)
    if b == 1.0:
        return torch.fft.ifft(Ahat, dim=axis)
    Ahat = torch.fft.fftshift(Ahat, dim=axis)

    chirp = _along(_const("czt_chirp", (N, float(b)), dev, cdtype), axis, A.dim())
    V = _along(_const("czt_filter", (N, float(b)), dev, cdtype), axis, A.dim())
    # the linear convolution; output j (natural order) sits at N - 1 + j
    U = torch.fft.fft(Ahat * chirp, n=V.shape[axis], dim=axis)
    out = torch.fft.ifft(U * V, dim=axis).narrow(axis, N - 1, N)
    out = out * chirp / N
    return torch.fft.ifftshift(out, dim=axis)


def remap_k(khat, M):
    """khat'(kappa) = khat(M kappa), exactly, for [..., N, N] khat.

    The k samples are a trigonometric polynomial, so evaluation at
    linearly remapped points is exact. M is factored as an upper
    shear, an axis scaling and a lower shear; each shear fuses into
    the same-axis scaling (see ngmix_tpu/metacal/kops.py remap_k). The
    scaling is a dense matrix product up to N = MAX_MATMUL_N and a
    chirp-z transform above it.
    """
    M = np.asarray(M, dtype=float)
    if abs(M[1, 1]) < 1e-8:
        raise ValueError("remap matrix too far from identity")
    N = khat.shape[-1]
    scale_axis = _scale_axis_matmul if N <= MAX_MATMUL_N else _czt_scale_axis
    # M = [[d0 + a1 d1 c1, a1 d1], [d1 c1, d1]]
    d1 = M[1, 1]
    c1 = M[1, 0] / d1
    a1 = M[0, 1] / d1
    d0 = M[0, 0] - a1 * d1 * c1
    ct = d1 * c1

    out = khat
    # upper shear then D0 on axis -2 (shift a1 * col index)
    shift0 = a1 if a1 != 0.0 else None
    if shift0 is not None or abs(d0 - 1.0) > 1e-14:
        out = scale_axis(out, d0, axis=-2, shift=shift0)
    # lower shear then D1 on axis -1 (shift d1*c1 * row index)
    shift1 = ct if ct != 0.0 else None
    if shift1 is not None or abs(d1 - 1.0) > 1e-14:
        out = scale_axis(out, d1, axis=-1, shift=shift1)
    return out
