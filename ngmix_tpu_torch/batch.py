"""Batched metacal pipeline over [B] stamps, with the gaussmom measure.

The gaussmom subset of ``ngmix_tpu/batch.py``: target-psf derivation,
the 5-type k-space metacal image set with optional fixnoise, stacking
of the types into 5 B lanes, gaussian weighted moments of every lane
(whose weight goes through K2) and the shear response.

Entry points (``metacal_pipeline``, ``make_metacal_pipeline_fn``) take
numpy arrays or tensors and run on the CUDA card unless the caller
passes device="cpu". Device code never raises on bad data: flags
carry failures.
"""
from typing import NamedTuple

import numpy as np
import torch

from .gaussmom import gaussmom_measure
from .jacobian import Jacobian
from .metacal import kops
from .metacal.defaults import DEFAULT_STEP
from .pixels import Pixels
from .util import full_precision_matmuls, resolve_device


class MetacalConfig(NamedTuple):
    """static configuration for the batched metacal pipeline"""

    dims: tuple  # (H, W) galaxy stamps
    psf_dims: tuple  # (Hp, Wp) psf stamps
    jac: tuple  # (dvdrow, dvdcol, dudrow, dudcol) shared WCS matrix
    step: float = DEFAULT_STEP
    types: tuple = ("noshear", "1p", "1m", "2p", "2m")
    fixnoise: bool = True
    psf_mode: str = "gauss"  # only 'gauss' in this port so far
    # FFT grid = good_fft_size(ceil(pad_factor * stamp size))
    pad_factor: float = 4
    # optional central window for the measurement stage
    fit_dims: tuple = None
    # LM measures only (not in this port yet); 0 = off
    sheared_refine: int = 0


GALSHEAR_TYPES = ("noshear", "1p", "1m", "2p", "2m")
PSFSHEAR_TYPES = ("1p_psf", "1m_psf", "2p_psf", "2m_psf")

# measures of the JAX pipeline that this port has not taken over yet,
# and the slice of the port each waits for
_LATER_MEASURES = {
    "exp-lm": "slice 2 (the exp-LM measure with kernel K1)",
    "admom": "the admom slice",
    "pgauss": "the pre-PSF moments slice",
    "ksigma": "the pre-PSF moments slice",
}


def _host_jacobian(conf):
    return Jacobian(*(float(x) for x in conf.jac))


def _type_shear(type_, step):
    """(g1, g2) that a galshear metacal type applies to the galaxy"""
    return {
        "noshear": (0.0, 0.0),
        "1p": (step, 0.0),
        "1m": (-step, 0.0),
        "2p": (0.0, step),
        "2m": (0.0, -step),
    }[type_]


def _check_types(conf):
    for t in conf.types:
        if t in GALSHEAR_TYPES:
            continue
        if t in PSFSHEAR_TYPES:
            raise NotImplementedError(
                "psf-sheared metacal types need psf_mode='dilate', which "
                "this port has not taken over yet"
            )
        raise ValueError("bad metacal type: %s" % t)


def prepare_psf_kdata(psf_images, psf_cens, conf: MetacalConfig):
    """psf-side k data shared by the image and fixnoise pipelines:
    (normalized psfhat, target sigma, pixel response, sky |k|^2)"""
    if conf.psf_mode != "gauss":
        raise NotImplementedError(
            "psf_mode=%r: this port has only the 'gauss' target so far"
            % (conf.psf_mode,)
        )
    N = kops.good_fft_size(
        int(np.ceil(
            conf.pad_factor * max(max(conf.dims), max(conf.psf_dims))
        ))
    )
    jac = _host_jacobian(conf)
    dtype, dev = psf_images.dtype, psf_images.device
    psfhat = _batched_centered_fft(psf_images, psf_cens, N)
    psf_flux = psfhat[:, 0, 0].real[:, None, None]
    psfhat_n = psfhat / psf_flux
    pix = kops.pixel_kresponse(N, dtype=dtype, device=dev)
    ksq = kops.sky_ksq(N, jac, dtype=dtype, device=dev)
    sigma = kops.gauss_target_sigma(psfhat, ksq)
    return dict(N=N, psfhat_n=psfhat_n, pix=pix, ksq=ksq, sigma=sigma)


def metacal_image_set(images, cens, psf_images, psf_cens,
                      conf: MetacalConfig, psfdata=None, crop=None):
    """the galshear metacal image set of a batch.

    images [B, H, W]; cens [B, 2]; psf_images [B, Hp, Wp]; psf_cens
    [B, 2]. Returns (dict type -> [B, H, W] images, target_sigma [B] of
    the undilated round target psf). ``psfdata`` (prepare_psf_kdata)
    shares the psf transforms with the fixnoise pass. crop: optional
    (r0, c0, fh, fw); the images are then only that window [B, fh, fw],
    evaluated by partial inverse-DFT matrix products.
    """
    _check_types(conf)
    if psfdata is None:
        psfdata = prepare_psf_kdata(psf_images, psf_cens, conf)
    N = psfdata["N"]
    jac = _host_jacobian(conf)

    imhat = _batched_centered_fft(images, cens, N)
    objhat = kops.deconvolve_k(imhat, psfdata["psfhat_n"])
    ksq = psfdata["ksq"]
    sigma = psfdata["sigma"]

    # round-gaussian target WITHOUT the pixel: the deconvolution
    # removed the pixelized psf and the target is drawn without one
    dilation = 1.0 + 2.0 * conf.step
    sig_d = sigma * dilation
    ghat = torch.exp(-0.5 * (sig_d[:, None, None] ** 2) * ksq)
    ghat = ghat.to(psfdata["psfhat_n"].dtype)

    out = {}
    for type_ in conf.types:
        g1, g2 = _type_shear(type_, conf.step)
        if type_ == "noshear":
            sheared = objhat
        else:
            M = kops.kmap_matrix(jac, kops.shear_matrix(g1, g2))
            sheared = kops.remap_k(objhat, M)
        if crop is not None:
            out[type_] = _batched_centered_ifft_crop(sheared * ghat, cens, *crop)
        else:
            out[type_] = _batched_centered_ifft(sheared * ghat, cens, conf.dims)
    return out, sigma


def _center_phase(cens, N, dtype, sign):
    """separable center-shift phase e^{sign i (kr c0 + kc c1)} [B, N, N]
    as the outer product of two per-lane phase vectors"""
    kr, kc = kops.kgrids(N, dtype=dtype, device=cens.device)
    pr = torch.exp(sign * 1j * kr[:, 0][None, :] * cens[:, 0, None])
    pc = torch.exp(sign * 1j * kc[0, :][None, :] * cens[:, 1, None])
    return pr[:, :, None] * pc[:, None, :]


def _batched_centered_fft(img, cens, N):
    H, W = img.shape[-2:]
    phase = _center_phase(cens, N, img.dtype, +1.0)
    if H <= N // 2 and W <= N // 2:
        # small blocks: partial-input DFT products, no padded buffer
        return kops.dft2_zeropad(img, N) * phase
    pad = torch.zeros(
        img.shape[:-2] + (N, N), dtype=kops.complex_dtype(img.dtype),
        device=img.device,
    )
    pad[..., :H, :W] = img
    return kops.fft2_auto(pad) * phase


def _batched_centered_ifft(khat, cens, dims):
    N = khat.shape[-1]
    phase = _center_phase(cens, N, khat.real.dtype, -1.0)
    full = kops.fft2_auto(khat * phase, inverse=True).real
    return full[..., : dims[0], : dims[1]]


def _batched_centered_ifft_crop(khat, cens, r0, c0, fh, fw):
    """only rows r0..r0+fh-1, cols c0..c0+fw-1 of the centered inverse
    transform, via partial inverse-DFT products (kops.idft2_crop)"""
    N = khat.shape[-1]
    phase = _center_phase(cens, N, khat.real.dtype, -1.0)
    return kops.idft2_crop(khat * phase, r0, c0, fh, fw).real


def make_pixels_batch(images, weights, cens, conf: MetacalConfig):
    """[B, H, W] images -> batched Pixels [B, H*W] with per-stamp centers"""
    H, W = conf.dims
    rows = torch.arange(H, dtype=images.dtype, device=images.device)
    cols = torch.arange(W, dtype=images.dtype, device=images.device)
    rr, cc = torch.meshgrid(rows, cols, indexing="ij")
    rflat = rr.reshape(-1)[None, :] - cens[:, 0:1]
    cflat = cc.reshape(-1)[None, :] - cens[:, 1:2]
    dvdrow, dvdcol, dudrow, dudcol = conf.jac
    v = dvdrow * rflat + dvdcol * cflat
    u = dudrow * rflat + dudcol * cflat
    area = abs(dvdrow * dudcol - dvdcol * dudrow)
    val = images.reshape(images.shape[0], -1)
    ierr = torch.sqrt(torch.clamp(weights.reshape(val.shape), min=0.0))
    return Pixels(v=v, u=u, area=torch.full_like(val, area), val=val, ierr=ierr)


def _fit_crop(conf):
    """the central fit window (r0, c0, fh, fw) that the k engine can
    evaluate directly, or None"""
    if (
        conf.fit_dims is not None
        and conf.dims[0] == conf.dims[1]
        and conf.fit_dims[0] == conf.fit_dims[1]
        and (conf.dims[0] - conf.fit_dims[0]) % 2 == 0
    ):
        fh, fw = conf.fit_dims
        return (conf.dims[0] - fh) // 2, (conf.dims[1] - fw) // 2, fh, fw
    return None


def _as_inputs(args, device):
    """numpy arrays or tensors -> tensors on the device; the real
    dtype of the images is kept (float32 or float64)"""
    dev = resolve_device(device)
    out = [torch.as_tensor(a, device=dev) for a in args]
    dtype = out[0].dtype
    return [a.to(dtype) for a in out]


def metacal_pipeline(images, weights, cens, psf_images, psf_cens, noise,
                     conf: MetacalConfig, measure="gaussmom",
                     measure_fwhm=1.2, device=None):
    """the whole batched pipeline: metacal image set (+ fixnoise) and
    the measurement of every type.

    images/weights/noise [B, H, W], cens [B, 2], psf_images [B, Hp, Wp],
    psf_cens [B, 2], as numpy arrays or tensors; noise is the fixnoise
    field (zeros with fixnoise=False). Only measure="gaussmom" is
    ported so far. Returns dict type -> result dict of [B, ...] tensors,
    plus "psf_sigma" [B].
    """
    if measure != "gaussmom":
        if measure in _LATER_MEASURES or measure.endswith("-lm"):
            raise NotImplementedError(
                "measure=%r is not ported yet: it waits for %s"
                % (measure, _LATER_MEASURES.get(measure, "slice 2 (LM measures)"))
            )
        raise ValueError("bad measure: %s" % measure)
    full_precision_matmuls()
    images, weights, cens, psf_images, psf_cens, noise = _as_inputs(
        (images, weights, cens, psf_images, psf_cens, noise), device
    )

    psfdata = prepare_psf_kdata(psf_images, psf_cens, conf)
    crop = _fit_crop(conf)
    odict, sigma = metacal_image_set(
        images, cens, psf_images, psf_cens, conf, psfdata=psfdata, crop=crop,
    )

    if conf.fixnoise:
        # rotate the noise field by 90 deg, metacal it, rotate back and
        # add; the variance doubles
        cen_c = torch.full_like(cens, (conf.dims[0] - 1) / 2.0)
        noise_rot = torch.rot90(noise, k=1, dims=(-2, -1))
        ndict, _ = metacal_image_set(
            noise_rot, cen_c, psf_images, psf_cens, conf, psfdata=psfdata,
            crop=crop,
        )
        for t in odict:
            odict[t] = odict[t] + torch.rot90(ndict[t], k=3, dims=(-2, -1))
        weights = weights * 0.5

    area = abs(conf.jac[0] * conf.jac[3] - conf.jac[1] * conf.jac[2])

    # stack the metacal types into the batch axis: one measurement of
    # 5 B lanes
    types = list(odict.keys())
    B = weights.shape[0]
    ims_all = torch.cat([odict[t] for t in types], dim=0)
    wt_all = weights.repeat(len(types), 1, 1)
    cens_all = cens.repeat(len(types), 1)

    if crop is not None:
        # the images came out of the k engine already cropped
        r0, c0, fh, fw = crop
        wt_all = wt_all[:, r0:r0 + fh, c0:c0 + fw]
        cens_all = cens_all - torch.tensor([r0, c0], dtype=cens.dtype, device=cens.device)
        conf_fit = conf._replace(dims=(fh, fw))
    elif conf.fit_dims is not None:
        fh, fw = conf.fit_dims
        r0 = (conf.dims[0] - fh) // 2
        c0 = (conf.dims[1] - fw) // 2
        ims_all = ims_all[:, r0:r0 + fh, c0:c0 + fw]
        wt_all = wt_all[:, r0:r0 + fh, c0:c0 + fw]
        cens_all = cens_all - torch.tensor([r0, c0], dtype=cens.dtype, device=cens.device)
        conf_fit = conf._replace(dims=(fh, fw))
    else:
        conf_fit = conf
    pixels = make_pixels_batch(ims_all, wt_all, cens_all, conf_fit)

    res_all = gaussmom_measure(pixels, measure_fwhm, area)

    nall = len(types) * B
    results = {}
    for i, t in enumerate(types):
        results[t] = {
            k: x[i * B:(i + 1) * B]
            if isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] == nall
            else x
            for k, x in res_all.items()
        }
    results["psf_sigma"] = sigma
    return results


def _concat_results(parts):
    out = {}
    for k, v in parts[0].items():
        if isinstance(v, dict):
            out[k] = {kk: torch.cat([p[k][kk] for p in parts]) for kk in v}
        else:
            out[k] = torch.cat([p[k] for p in parts])
    return out


def make_metacal_pipeline_fn(conf: MetacalConfig, measure="gaussmom",
                             measure_fwhm=1.2, max_chunk=10240,
                             device=None):
    """pipeline closure over a fixed configuration and device.

    Batches larger than max_chunk run as successive chunks of at most
    max_chunk stamps, and the per-lane results are concatenated; the
    pipeline is lane-independent, so they equal a single-batch run.
    None disables chunking.
    """
    dev = resolve_device(device)

    def fn(images, weights, cens, psf_images, psf_cens, noise):
        args = (images, weights, cens, psf_images, psf_cens, noise)
        B = len(images)
        if max_chunk is None or B <= max_chunk:
            return metacal_pipeline(
                *args, conf, measure=measure, measure_fwhm=measure_fwhm,
                device=dev,
            )
        parts = [
            metacal_pipeline(
                *(a[i:i + max_chunk] for a in args), conf, measure=measure,
                measure_fwhm=measure_fwhm, device=dev,
            )
            for i in range(0, B, max_chunk)
        ]
        return _concat_results(parts)

    return fn


# ----------------------------------------------------------------------
# calibration

def shear_response_sums(results):
    """per-type partial calibration sums {type: {"se": [2], "n": []}}"""
    missing = [t for t in GALSHEAR_TYPES if t not in results]
    if missing:
        raise ValueError(
            "shear_response needs all five galshear metacal types; "
            "results lack %s (run with types including %s)"
            % (missing, GALSHEAR_TYPES)
        )
    out = {}
    for t in GALSHEAR_TYPES:
        ok = results[t]["flags"] == 0
        se = torch.stack([
            torch.sum(torch.where(ok, results[t]["e1"], 0.0)),
            torch.sum(torch.where(ok, results[t]["e2"], 0.0)),
        ])
        out[t] = {"se": se, "n": torch.sum(ok)}
    return out


def shear_response_from_sums(sums, step=DEFAULT_STEP):
    """shear_response from partial sums"""
    def mean_e(t):
        # an all-flagged batch divides by 1 and yields e=0 instead of
        # nan; n_used in the output exposes the empty selection
        return sums[t]["se"] / torch.clamp(sums[t]["n"], min=1)

    e_ns = mean_e("noshear")
    R11 = (mean_e("1p")[0] - mean_e("1m")[0]) / (2 * step)
    R22 = (mean_e("2p")[1] - mean_e("2m")[1]) / (2 * step)
    R12 = (mean_e("2p")[0] - mean_e("2m")[0]) / (2 * step)
    R21 = (mean_e("1p")[1] - mean_e("1m")[1]) / (2 * step)
    R = torch.stack([torch.stack([R11, R12]), torch.stack([R21, R22])])
    # closed-form 2x2 solve: a singular R gives inf/nan, never raises
    det = R11 * R22 - R12 * R21
    shear = torch.stack([
        (R22 * e_ns[0] - R12 * e_ns[1]) / det,
        (R11 * e_ns[1] - R21 * e_ns[0]) / det,
    ])
    return {
        "e_mean": e_ns, "R": R, "shear": shear,
        "n_used": sums["noshear"]["n"],
    }


def shear_response(results, step=DEFAULT_STEP):
    """mean shear and response of a batched metacal result dict:
    e_mean [2], R [2, 2] and shear [2] = R^-1 e_mean"""
    return shear_response_from_sums(shear_response_sums(results), step=step)
