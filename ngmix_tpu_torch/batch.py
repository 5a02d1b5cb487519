"""Batched metacal pipeline over [B] stamps, with the gaussmom, admom,
LM (exp, gauss, dev, bdf and bd models) and pre-psf (pgauss, ksigma)
measures.

The subset of ``ngmix_tpu/batch.py`` for those measures: target-psf
derivation (the gauss, azgauss, fitgauss and dilate psf modes), the
metacal image set with optional fixnoise (the five galshear types and,
under dilate, the four psf-sheared types), stacking of the types into
lanes, the measure of every lane, and the shear and psf-shear
responses. gaussmom takes gaussian weighted moments (the weight goes
through K2). admom iterates adaptive moments (admom.py, its weight
through K2); fitgauss and dilate also run it on psf stamps. The LM
measures (exp-lm, gauss-lm, dev-lm) fit a model of 6, 1 or 10 fixed
gaussians, and bdf-lm and bd-lm the 16-gaussian bulge+disk models,
convolved with a one-gaussian psf (the round target, or under
dilate the admom fit of each type's rendered target) by the
normal-equation LM, optionally inside bounds: on the card every lane's
whole solve runs in K3 (ops/lm_solve.py), and the host loop of
fitting/lm.py with K1 for the normal equations is its plain version;
its moments guess and its s/n sums evaluate the model through K2. pgauss and ksigma take pre-psf
moments (prepsfmom.py) of the full stamps, deconvolving the round
target psf rendered through K2, or under dilate each type's rendered
target. The multi-band, multi-epoch pipeline (``metacal_pipeline_mb``)
folds the epochs into the same engine and fits each object jointly
over its epochs and bands (K3-mb on the card), or pools its epochs'
pixels for the moments measures. The calibration takes the plain
response (``shear_response``) or one of the two selection-corrected
estimators (``shear_response_select``,
``shear_response_select_consistent``).

Entry points (``metacal_pipeline``, ``make_metacal_pipeline_fn``,
``metacal_pipeline_mb``, ``make_metacal_pipeline_mb_fn``) take numpy
arrays or tensors and run on the CUDA card unless the caller passes
device="cpu". Device code never raises on bad data: flags carry
failures.
"""
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import joint_prior
from .admom import AdmomConf, admom_batch
from .defaults import BIGVAL, GMIX_LOW_DETVAL
from .fitting import fit_model, lm
from .gaussmom import gaussmom_measure
from .gmix import core as gcore, tables
from .jacobian import Jacobian
from .metacal import kops
from .metacal.defaults import DEFAULT_STEP
from .moments import e2mom, fwhm_to_T
from .ops import gmix_eval, lm_solve, normal_eqs
from .pixels import Pixels
from .prepsfmom import prepsfmom_batch
from .shape import ONE_MINUS_EPS
from .util import full_precision_matmuls, resolve_device


class MetacalConfig(NamedTuple):
    """static configuration for the batched metacal pipeline"""

    dims: tuple  # (H, W) galaxy stamps
    psf_dims: tuple  # (Hp, Wp) psf stamps
    jac: tuple  # (dvdrow, dvdcol, dudrow, dudcol) shared WCS matrix
    step: float = DEFAULT_STEP
    types: tuple = ("noshear", "1p", "1m", "2p", "2m")
    fixnoise: bool = True
    psf_mode: str = "gauss"  # 'gauss' | 'azgauss' | 'fitgauss' | 'dilate'
    # FFT grid = good_fft_size(ceil(pad_factor * stamp size))
    pad_factor: float = 4
    # optional central window for the measurement stage
    fit_dims: tuple = None
    # LM measures only: Gauss-Newton refinement of the sheared types
    # from the noshear fit; 0 = off (the only value ported so far)
    sheared_refine: int = 0


GALSHEAR_TYPES = ("noshear", "1p", "1m", "2p", "2m")
PSFSHEAR_TYPES = ("1p_psf", "1m_psf", "2p_psf", "2m_psf")

_PREPSF_MEASURES = ("pgauss", "ksigma")
_LM_MEASURES = ("exp-lm", "gauss-lm", "dev-lm", "bdf-lm", "bd-lm")
_MEASURES = ("gaussmom", "admom") + _LM_MEASURES + _PREPSF_MEASURES
_PSF_MODES = ("gauss", "azgauss", "fitgauss", "dilate")


def _host_jacobian(conf):
    return Jacobian(*(float(x) for x in conf.jac))


def _type_shear(type_, step):
    """(g1, g2) that a metacal type applies: to the galaxy for the
    galshear types, to the target psf for the *_psf types"""
    base = type_[:-4] if type_.endswith("_psf") else type_
    return {
        "noshear": (0.0, 0.0),
        "1p": (step, 0.0),
        "1m": (-step, 0.0),
        "2p": (0.0, step),
        "2m": (0.0, -step),
    }[base]


def _check_types(conf):
    for t in conf.types:
        if t in GALSHEAR_TYPES:
            continue
        if t in PSFSHEAR_TYPES:
            if conf.psf_mode != "dilate":
                # as in the reference, round-gaussian targets are not
                # psf-sheared
                raise ValueError(
                    "psf-sheared metacal types need psf_mode='dilate', "
                    "got %r" % (conf.psf_mode,)
                )
            continue
        raise ValueError("bad metacal type: %s" % t)


def prepare_psf_kdata(psf_images, psf_cens, conf: MetacalConfig):
    """psf-side k data shared by the image and fixnoise pipelines:
    the normalized psfhat, the round target sigma of conf.psf_mode, the
    pixel response, the sky |k|^2 and, under dilate, the pixel-free
    psf transform"""
    if conf.psf_mode not in _PSF_MODES:
        raise ValueError("bad psf_mode: %r" % (conf.psf_mode,))
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
    psfhat_nopix = None
    if conf.psf_mode == "dilate":
        # the target is the dilated original psf: its pixel-free
        # transform serves the per-type remaps. sigma comes from the
        # normalized psfhat here, unlike the other modes
        psfhat_nopix = psfhat_n / torch.where(torch.abs(pix) > 1e-8, pix, 1e-8)
        sigma = kops.gauss_target_sigma(psfhat_n, ksq)
    elif conf.psf_mode == "azgauss":
        sigma = kops.azgauss_target_sigma(psfhat, ksq, nbin=N)
    elif conf.psf_mode == "fitgauss":
        sigma = _fitgauss_target_sigma_batch(psf_images, psf_cens, conf)
        # per lane, the k-pinned sigma where the fit failed
        sigma = torch.where(
            torch.isfinite(sigma) & (sigma > 0),
            sigma, kops.gauss_target_sigma(psfhat, ksq),
        )
    else:
        sigma = kops.gauss_target_sigma(psfhat, ksq)
    return dict(N=N, psfhat_n=psfhat_n, pix=pix, ksq=ksq, sigma=sigma,
                psfhat_nopix=psfhat_nopix)


def round_wt0(n, T, dtype, device):
    """[n, 6] round gaussians (p, row, col, irr, irc, icc) = (1, 0, 0,
    T/2, 0, T/2): admom's starting weight"""
    wt0 = torch.zeros((n, 6), dtype=dtype, device=device)
    wt0[:, 0] = 1.0
    wt0[:, 3] = T / 2
    wt0[:, 5] = T / 2
    return wt0


def _admom_gauss_fit_batch(psf_images, psf_cens, conf):
    """adaptive-moments gaussian fit of every psf stamp with unit
    weights, started from a round gaussian of FWHM 3.5 pixels; returns
    the admom result dict"""
    B = psf_images.shape[0]
    pixels = make_pixels_batch(
        psf_images, torch.ones_like(psf_images), psf_cens,
        conf._replace(dims=conf.psf_dims),
    )
    scale = abs(conf.jac[0] * conf.jac[3] - conf.jac[1] * conf.jac[2]) ** 0.5
    wt0 = round_wt0(B, float(fwhm_to_T(3.5 * scale)), psf_images.dtype, psf_images.device)
    area = torch.full((B,), scale**2, dtype=psf_images.dtype, device=psf_images.device)
    return admom_batch(pixels, wt0, area, AdmomConf(), device=psf_images.device)


def _psf_moms_from_stamps(psf_images, conf, fallback_sigma):
    """(irr, irc, icc) [B, 3] of the admom gaussian fit of rendered
    target-psf stamps centered on their stamp, and round with
    fallback_sigma [B] where the fit failed: the LM's psf model under
    psf_mode='dilate', where the target is not an analytic gaussian"""
    B = psf_images.shape[0]
    Hp, Wp = conf.psf_dims
    pcens = torch.tensor([(Hp - 1) / 2.0, (Wp - 1) / 2.0], dtype=psf_images.dtype,
                         device=psf_images.device).expand(B, 2)
    res = _admom_gauss_fit_batch(psf_images, pcens, conf)
    T_safe = torch.where(res["T"] > 0, res["T"], 1.0)
    irr, irc, icc = e2mom(res["e1"], res["e2"], T_safe)
    ok = (res["flags"] == 0) & (res["T"] > 0)
    rnd = fallback_sigma**2
    return torch.stack(
        [torch.where(ok, irr, rnd), torch.where(ok, irc, 0.0), torch.where(ok, icc, rnd)],
        dim=-1,
    )


def _fitgauss_target_sigma_batch(psf_images, psf_cens, conf):
    """round target sigma [B] from the admom gaussian fit of each psf
    stamp, dilated by its ellipticity (at most 1.1 in T); NaN where the
    fit failed, for the caller to replace"""
    res = _admom_gauss_fit_batch(psf_images, psf_cens, conf)
    e1, e2, T = res["e1"], res["e2"], res["T"]
    T_safe = torch.where(T > 0, T, 1.0)
    irr, irc, icc = e2mom(e1, e2, T_safe)
    half = 0.5 * (irr + icc)
    d = torch.sqrt((0.5 * (irr - icc)) ** 2 + irc**2)
    eigmax = half + d
    dil = torch.clamp(1.0 + 2.0 * (torch.sqrt(eigmax / (T_safe / 2.0)) - 1.0), max=1.1)
    sigma = torch.sqrt(T_safe * dil / 2.0)
    ok = (res["flags"] == 0) & (T > 0)
    return torch.where(ok, sigma, torch.nan)


def metacal_image_set(images, cens, psf_images, psf_cens,
                      conf: MetacalConfig, psfdata=None, with_psf_images=False,
                      crop=None):
    """the metacal image set of a batch.

    images [B, H, W]; cens [B, 2]; psf_images [B, Hp, Wp]; psf_cens
    [B, 2]. Returns (dict type -> [B, H, W] images, target_sigma [B] of
    the undilated round target psf). ``psfdata`` (prepare_psf_kdata)
    shares the psf transforms with the fixnoise pass. The galshear
    types shear the deconvolved galaxy and reconvolve it with the
    dilated target; the *_psf types (psf_mode='dilate' only) reconvolve
    the unsheared galaxy with the sheared dilated psf.
    with_psf_images: also return {type: [B, Hp, Wp]} the rendered
    target psf of each type, centered on the stamp. crop: optional
    (r0, c0, fh, fw); the images are then only that window
    [B, fh, fw], evaluated by partial inverse-DFT matrix products.
    """
    _check_types(conf)
    if psfdata is None:
        psfdata = prepare_psf_kdata(psf_images, psf_cens, conf)
    N = psfdata["N"]
    jac = _host_jacobian(conf)

    imhat = _batched_centered_fft(images, cens, N)
    objhat = kops.deconvolve_k(imhat, psfdata["psfhat_n"])
    pix = psfdata["pix"]
    ksq = psfdata["ksq"]
    sigma = psfdata["sigma"]

    dilation = 1.0 + 2.0 * conf.step
    if conf.psf_mode == "dilate":
        # the dilated original psf (its pixel-free transform evaluated
        # at d k, exactly), reconvolved by the pixel
        ghat = kops.remap_k(psfdata["psfhat_nopix"], np.eye(2) * dilation) * pix
    else:
        # round-gaussian target WITHOUT the pixel: the deconvolution
        # removed the pixelized psf and the target is drawn without one
        sig_d = sigma * dilation
        ghat = torch.exp(-0.5 * (sig_d[:, None, None] ** 2) * ksq)
        ghat = ghat.to(psfdata["psfhat_n"].dtype)

    out = {}
    psf_out = {}
    B = images.shape[0]
    for type_ in conf.types:
        g1, g2 = _type_shear(type_, conf.step)
        ghat_t = ghat
        if type_ in PSFSHEAR_TYPES:
            M = kops.kmap_matrix(jac, kops.shear_matrix(g1, g2)) @ (np.eye(2) * dilation)
            ghat_t = kops.remap_k(psfdata["psfhat_nopix"], M) * pix
            sheared = objhat
        elif type_ == "noshear":
            sheared = objhat
        else:
            M = kops.kmap_matrix(jac, kops.shear_matrix(g1, g2))
            sheared = kops.remap_k(objhat, M)
        if crop is not None:
            out[type_] = _batched_centered_ifft_crop(sheared * ghat_t, cens, *crop)
        else:
            out[type_] = _batched_centered_ifft(sheared * ghat_t, cens, conf.dims)
        if with_psf_images:
            Hp, Wp = conf.psf_dims
            pcen = torch.tensor([(Hp - 1) / 2.0, (Wp - 1) / 2.0], dtype=images.dtype,
                                device=images.device).expand(B, 2)
            psf_out[type_] = _batched_centered_ifft(ghat_t, pcen, conf.psf_dims)
    if with_psf_images:
        return out, sigma, psf_out
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


def _fit_crop(conf, measure=None):
    """the central fit window (r0, c0, fh, fw) that the k engine can
    evaluate directly, or None; the pre-psf measures always take the
    full stamps"""
    if (
        conf.fit_dims is not None
        and measure not in _PREPSF_MEASURES
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


def _check_measure(conf, measure, lm_conf, lm_prior, lm_bounds, nband=1):
    """raise for a measure or LM option this port has not taken over;
    returns the LM measure's prior as one of the port's joint priors
    (another package's prior is converted by convert.prior_from_object,
    which raises TypeError for a class the port does not have), or None.
    A prior whose parameter slots are not the model's shape columns and
    nband fluxes raises ValueError."""
    if measure not in _MEASURES:
        raise ValueError("bad measure: %s" % measure)
    if measure not in _LM_MEASURES:
        return None
    if conf.sheared_refine:
        raise NotImplementedError(
            "sheared_refine > 0 is not ported yet: ROADMAP queue item 10"
        )
    if lm_conf is not None:
        lm.check_supported(lm_conf)
    if lm_prior is None:
        return None
    if not isinstance(lm_prior, joint_prior.PRIORS):
        # convert imports this module
        from .convert import prior_from_object
        lm_prior = prior_from_object(lm_prior)
    model = measure[:-3]
    lm_solve._check_prior(lm_prior, _MODEL_NSHAPE[model] + nband, nband, model)
    return lm_prior


def metacal_pipeline(images, weights, cens, psf_images, psf_cens, noise,
                     conf: MetacalConfig, measure="gaussmom",
                     measure_fwhm=1.2, lm_conf=None, lm_prior=None,
                     lm_bounds=None, device=None):
    """the whole batched pipeline: metacal image set (+ fixnoise) and
    the measurement of every type.

    images/weights/noise [B, H, W], cens [B, 2], psf_images [B, Hp, Wp],
    psf_cens [B, 2], as numpy arrays or tensors; noise is the fixnoise
    field (zeros with fixnoise=False). measure: "gaussmom" (fixed
    gaussian weighted moments), "admom" (adaptive moments started from
    a round gaussian of FWHM measure_fwhm), "exp-lm", "gauss-lm",
    "dev-lm", "bdf-lm" or "bd-lm" (LM fits of that model, configured by
    lm_conf, an LMConf, inside lm_bounds = (lo, hi) of one value a
    parameter each, 6 for the simple models, 7 for bdf and 8 for bd,
    with +-inf for an open side, or unbounded), or "pgauss" / "ksigma"
    (pre-psf moments of FWHM measure_fwhm on the full stamps,
    deconvolving the round target psf, or under dilate each type's
    rendered target). lm_prior regularizes the LM fits: a joint prior of
    the port (joint_prior.PriorSimpleSep for the simple models,
    PriorBDFSep, PriorBDSep) or another package's of the same class,
    converted by convert.prior_from_object. A nonzero
    conf.sheared_refine is not ported yet and raises
    NotImplementedError. Returns dict type -> result dict of [B, ...]
    tensors, plus "psf_sigma" [B].
    """
    lm_prior = _check_measure(conf, measure, lm_conf, lm_prior, lm_bounds)
    full_precision_matmuls()
    images, weights, cens, psf_images, psf_cens, noise = _as_inputs(
        (images, weights, cens, psf_images, psf_cens, noise), device
    )
    if measure in _PREPSF_MEASURES:
        ims, wt, cens_all, sigma, psfdict = _stacked_stamps(
            images, weights, cens, psf_images, psf_cens, noise, conf, crop=None,
            need_psf_stamps=conf.psf_mode == "dilate",
        )
        res_all = _prepsf_measure(ims, wt, cens_all, sigma, psfdict, conf, measure,
                                  measure_fwhm)
    else:
        pixels, sigma, psfdict = _stacked_pixels(
            images, weights, cens, psf_images, psf_cens, noise, conf,
            with_psf_stamps=measure in _LM_MEASURES,
        )
        if measure in _LM_MEASURES:
            psf_moms = _lm_psf_moms(conf, sigma, psfdict)
            res_all = _exp_lm_measure(pixels, psf_moms, lm_conf or lm.LMConf(),
                                      model=measure[:-3], bounds=lm_bounds,
                                      prior=lm_prior)
        else:
            res_all = _moments_measure(pixels, conf, measure, measure_fwhm)
    return _split_types(res_all, conf.types, images.shape[0], sigma)


def _stacked_stamps(images, weights, cens, psf_images, psf_cens, noise, conf, crop,
                    need_psf_stamps):
    """the metacal image set of n stamps (+ fixnoise), its types stacked
    into T n lanes: (images [T n, h, w], weights [T n, H, W] (halved
    under fixnoise), cens [T n, 2], target sigma [n], and with
    need_psf_stamps the rendered target psf of each type {type: [n, Hp,
    Wp]}, else None). With a crop the images come out of the k engine
    as that window; the weights and centers stay those of the stamps"""
    psfdata = prepare_psf_kdata(psf_images, psf_cens, conf)
    out = metacal_image_set(
        images, cens, psf_images, psf_cens, conf, psfdata=psfdata,
        with_psf_images=need_psf_stamps, crop=crop,
    )
    odict, sigma = out[:2]
    psfdict = out[2] if need_psf_stamps else None

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

    # stack the metacal types into the batch axis: one measurement of
    # len(types) n lanes
    types = list(odict.keys())
    ims_all = torch.cat([odict[t] for t in types], dim=0)
    wt_all = weights.repeat(len(types), 1, 1)
    cens_all = cens.repeat(len(types), 1)
    return ims_all, wt_all, cens_all, sigma, psfdict


def _stacked_pixels(images, weights, cens, psf_images, psf_cens, noise, conf,
                    with_psf_stamps=False):
    """the stacked metacal image set (_stacked_stamps) as the pixels of
    the fit window: (pixels [T n, P], target sigma [n], and under dilate
    with with_psf_stamps the rendered target psf of each type {type:
    [n, Hp, Wp]}, else None)"""
    crop = _fit_crop(conf)
    # under dilate the target psf is not an analytic gaussian: the LM
    # takes its psf model from each type's rendered target
    ims_all, wt_all, cens_all, sigma, psfdict = _stacked_stamps(
        images, weights, cens, psf_images, psf_cens, noise, conf, crop,
        need_psf_stamps=conf.psf_mode == "dilate" and with_psf_stamps,
    )
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
    return make_pixels_batch(ims_all, wt_all, cens_all, conf_fit), sigma, psfdict


def round_target_psf_stamps(sigma, conf):
    """[B, Hp, Wp] stamps of the round unit-flux gaussian psf of sigma
    [B] centered on the stamp, exact (untruncated) and times the pixel
    area, through K2 (n = 1 over [B, Hp Wp] with a scalar area)"""
    B = sigma.shape[0]
    Hp, Wp = conf.psf_dims
    dtype, dev = sigma.dtype, sigma.device
    pr = torch.arange(Hp, dtype=dtype, device=dev) - (Hp - 1) / 2.0
    pc = torch.arange(Wp, dtype=dtype, device=dev) - (Wp - 1) / 2.0
    prr, pcc = torch.meshgrid(pr, pc, indexing="ij")
    dvdrow, dvdcol, dudrow, dudcol = conf.jac
    pv = (dvdrow * prr + dvdcol * pcc).reshape(1, -1).expand(B, -1).contiguous()
    pu = (dudrow * prr + dudcol * pcc).reshape(1, -1).expand(B, -1).contiguous()
    pg = torch.zeros((B, 1, 6), dtype=dtype, device=dev)
    pg[:, 0, 0] = 1.0
    pg[:, 0, 3] = sigma**2
    pg[:, 0, 5] = sigma**2
    area = abs(dvdrow * dudcol - dvdcol * dudrow)
    return gmix_eval.eval_gmix(pg, pv, pu, area, fast=False).reshape(B, Hp, Wp)


def _prepsf_measure(ims, wt, cens, sigma, psfdict, conf, measure, measure_fwhm):
    """pre-psf moments (prepsfmom_batch, kernel of FWHM measure_fwhm on
    the pad-4 grid) of every stacked full stamp, deconvolving the round
    dilated target psf of its stamp, or under dilate its type's rendered
    target; the white noise variance of a lane is the sum of 1 / weight
    over its pixels of positive weight"""
    types = list(conf.types)
    Hp, Wp = conf.psf_dims
    if psfdict is not None:
        pimgs = torch.cat([psfdict[t] for t in types], dim=0)
    else:
        pimgs = round_target_psf_stamps(
            sigma * (1.0 + 2.0 * conf.step), conf
        ).repeat(len(types), 1, 1)
    pcens = torch.tensor([(Hp - 1) / 2.0, (Wp - 1) / 2.0], dtype=ims.dtype,
                         device=ims.device).expand(ims.shape[0], 2)
    tot_var = torch.sum(1.0 / torch.where(wt > 0, wt, torch.inf), dim=(-2, -1))
    return prepsfmom_batch(
        ims, cens, pimgs, pcens, tot_var, target_dim=4 * conf.dims[0],
        kernel="gauss" if measure == "pgauss" else "ksigma", jac_tuple=conf.jac,
        fwhm=measure_fwhm, device=ims.device,
    )


def _moments_measure(pixels, conf, measure, measure_fwhm):
    """gaussmom or admom (from a round gaussian of FWHM measure_fwhm)
    of every lane of pixels"""
    area = abs(conf.jac[0] * conf.jac[3] - conf.jac[1] * conf.jac[2])
    if measure == "gaussmom":
        return gaussmom_measure(pixels, measure_fwhm, area)
    nb = pixels.val.shape[0]
    wt0 = round_wt0(nb, float(fwhm_to_T(measure_fwhm)), pixels.val.dtype,
                    pixels.val.device)
    area_b = torch.full((nb,), area, dtype=pixels.val.dtype, device=pixels.val.device)
    return admom_batch(pixels, wt0, area_b, AdmomConf(), device=pixels.val.device)


def _lm_psf_moms(conf, sigma, psfdict):
    """the LM's psf model of every stacked lane as (irr, irc, icc) [T n,
    3]: the round dilated target, or under dilate the admom gaussian fit
    of each type's rendered target (all types in one lane-independent
    batch)"""
    types = list(conf.types)
    sig_d = sigma * (1.0 + 2.0 * conf.step)
    if psfdict is not None:
        return _psf_moms_from_stamps(
            torch.cat([psfdict[t] for t in types]), conf, sig_d.repeat(len(types))
        )
    return torch.stack(
        [sig_d**2, torch.zeros_like(sig_d), sig_d**2], dim=-1
    ).repeat(len(types), 1)


def _split_types(res_all, types, B, sigma):
    """dict type -> the type's B lanes of every stacked [T B, ...]
    result, plus "psf_sigma" """
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
                             measure_fwhm=1.2, lm_conf=None, lm_prior=None,
                             lm_bounds=None, max_chunk=10240, device=None):
    """pipeline closure over a fixed configuration and device.

    lm_conf, lm_prior and lm_bounds pass through to the LM measure (see
    metacal_pipeline); unported options raise here, before any work.
    Batches larger than max_chunk run as successive chunks of at most
    max_chunk stamps, and the per-lane results are concatenated; the
    pipeline is lane-independent, so they equal a single-batch run
    (the LM's compaction levels scale with the chunk, which never
    changes per-lane results). None disables chunking.
    """
    lm_prior = _check_measure(conf, measure, lm_conf, lm_prior, lm_bounds)
    dev = resolve_device(device)
    kw = dict(measure=measure, measure_fwhm=measure_fwhm, lm_conf=lm_conf,
              lm_prior=lm_prior, lm_bounds=lm_bounds, device=dev)

    def fn(images, weights, cens, psf_images, psf_cens, noise):
        args = (images, weights, cens, psf_images, psf_cens, noise)
        B = len(images)
        if max_chunk is None or B <= max_chunk:
            return metacal_pipeline(*args, conf, **kw)
        parts = [
            metacal_pipeline(*(a[i:i + max_chunk] for a in args), conf, **kw)
            for i in range(0, B, max_chunk)
        ]
        return _concat_results(parts)

    return fn


# ----------------------------------------------------------------------
# the LM measures

# the models of the LM measures: fill_simple over each model's fixed
# (p, f) tables, 6 (exp), 1 (gauss) and 10 (dev) gaussians, with the
# (row, col, g1, g2, T) shape and one flux a band; and the composite
# bulge+disk models, 16 gaussians (fill_cm): bdf (Td/Te = 1, a free
# fracdev column after T) and bd (log10(Td/Te) and fracdev after T)
_MODEL_FILLS = {
    "exp": gcore.fill_exp,
    "gauss": gcore.fill_gauss,
    "dev": gcore.fill_dev,
    "bdf": gcore.fill_bdf,
    "bd": gcore.fill_bd,
}
# parameters before the flux column(s): 5, 6 for bdf, 7 for bd
_MODEL_NSHAPE = {m: fit_model.shape_count(m) for m in _MODEL_FILLS}
# starting values of the extra shape columns (after row, col, g1, g2,
# T): fracdev 0.5; bd's log10(Td/Te) 0 (equal sizes)
_MODEL_EXTRA_GUESS = {"bdf": (0.5,), "bd": (0.0, 0.5)}


def _moments_lm_guess(pixels, Tpsf, guess_fwhm=1.2):
    """LM starting guesses from one gaussian weighted-moments pass (its
    weight through K2): the measured centroid and halved shape, the
    deweighted size less the psf's Tpsf [B], and the masked pixel sum
    as the flux scale. Returns (guess5 [B, 5], wsum [B])."""
    B = pixels.val.shape[0]
    dtype, dev = pixels.val.dtype, pixels.val.device
    Tw = float(fwhm_to_T(guess_fwhm))
    wt = torch.zeros((B, 1, 6), dtype=dtype, device=dev)
    wt[:, 0, 0] = 2 * np.pi * Tw / 2
    wt[:, 0, 3] = Tw / 2
    wt[:, 0, 5] = Tw / 2
    s = gcore.get_weighted_sums(wt, pixels, maxrad=1.0e9, with_cov=False)["sums"]
    mf = s[..., 5]
    mf_safe = torch.where(mf > 0, mf, 1.0)
    cen_v = s[..., 0] / mf_safe
    cen_u = s[..., 1] / mf_safe
    mt = s[..., 4] / mf_safe
    s4_safe = torch.where(s[..., 4] > 0, s[..., 4], 1.0)
    e1 = torch.clamp(s[..., 2] / s4_safe, -0.5, 0.5)
    e2 = torch.clamp(s[..., 3] / s4_safe, -0.5, 0.5)
    # deweight the measured size and remove the psf
    Tmeas = torch.clamp(mt, min=0.05)
    Tdew = 1.0 / torch.clamp(1.0 / Tmeas - 1.0 / Tw, min=0.05)
    Tguess = torch.clamp(Tdew - Tpsf, min=0.05)

    wsum = torch.sum(pixels.val * (pixels.ierr > 0), dim=-1)
    guess5 = torch.stack([cen_v, cen_u, 0.5 * e1, 0.5 * e2, Tguess], dim=-1)
    return guess5, wsum


def _lm_planes(pixels):
    """the loop-invariant pixel planes of K1: v, u, ia = ierr * area
    and ve = val * ierr, [B, P] and contiguous (no padding)"""
    return tuple(
        x.contiguous() for x in (
            pixels.v, pixels.u, pixels.ierr * pixels.area,
            pixels.val * pixels.ierr,
        )
    )


def _exp_reparam(pars, psf_gmix, model="exp"):
    """pars [..., 6], psf [..., 1, 6] -> (rp [..., n, 6], gm, fill
    flags): the model's fill (exp by default), the convolution and
    gmix_reparam, whose derivative in pars is exp_chain"""
    g0, gflags = _MODEL_FILLS[model](pars)
    gm = gcore.gmix_convolve(g0, psf_gmix)
    return normal_eqs.gmix_reparam(gm), gm, gflags


def _composite_pf(x, model):
    """the composite model's (p, f) [B, 16] before the flux and the
    size, Tfactor [B], and their derivatives in its extra shape columns
    x [B, nx] (bdf: fracdev; bd: l = log10(Td/Te), fracdev), a list of
    (dp, df, dTfactor) a column: dp/dfracdev is -p_exp on the exp half
    and +p_dev on the dev half, df/dl = ln 10 Td/Te f_dev on the dev
    half, and dTfactor = -Tfactor^2 sum_g (dp_g f_g + p_g df_g)"""
    fracdev = x[:, -1]
    R = 10.0 ** x[:, 0] if model == "bd" else torch.ones_like(fracdev)
    p, f = gcore._cm_pf(fracdev, R)
    Tf = 1.0 / torch.sum(p * f, dim=-1)
    B = x.shape[0]
    pe, pd, fd = (torch.as_tensor(t, dtype=x.dtype, device=x.device)
                  for t in (tables.PVALS_EXP, tables.PVALS_DEV, tables.FVALS_DEV))
    zero = torch.zeros_like(p)
    d_fracdev = (torch.cat([-pe, pd]).expand(B, -1), zero)
    cols = [d_fracdev]
    if model == "bd":
        d_l = (zero, torch.cat([torch.zeros_like(pe).expand(B, -1),
                                np.log(10.0) * R[:, None] * fd], dim=-1))
        cols = [d_l, d_fracdev]
    return p, f, Tf, [(dp, df, -Tf * Tf * torch.sum(dp * f + p * df, dim=-1))
                      for dp, df in cols]


def exp_chain(pars, psf_gmix, model="exp"):
    """K1's chain d rp[g, j] / d pars[k], [B, n, 6, npars], in closed
    form.

    pars [B, npars] = (row, col, g1, g2, T, [extra shape columns,] flux);
    psf_gmix [B, 1, 6], one gaussian; model exp, gauss or dev, whose
    (p, f) tables give the n gaussians, or bdf and bd, whose 16 (p, f)
    and size factor Tfactor depend on the extra columns (fracdev, and
    bd's log10(Td/Te) before it). rp = (N, row, col, Fvv, Fvu, Fuu) of
    each gaussian of the convolved model: row and col pass straight
    through; flux only scales N; g1, g2, T and the extra columns reach
    N and F through e(g) (with its clip at |g| = 1), the convolved
    moments (irr, irc, icc) = h (1 - e1, e2, 1 + e1) + psf, h = T
    Tfactor f_g / 2 (Tfactor 1 for the simple models), and the inverse
    covariance; the extra columns also reach N directly through p_g. An
    invalid gaussian (gmix_reparam's rule) has constant N and F. The
    counterpart of the reference's jax.vmap(jax.jacfwd(reparam_of));
    K3 (ops/lm_solve.py) computes the same terms per gaussian.
    """
    nshape = _MODEL_NSHAPE[model]
    row, col, g1, g2, T = pars[:, :5].unbind(-1)
    flux = pars[:, nshape]
    if model in _MODEL_EXTRA_GUESS:
        pv, fv, Tf, d_extra = _composite_pf(pars[:, 5:nshape], model)
        Ts = T * Tf
    else:
        pv, fv = (torch.as_tensor(x, dtype=pars.dtype, device=pars.device)
                  for x in tables.MODEL_TABLES[model])
        d_extra = []
        Ts = T
    # e(g) and de/dg through the clip gc = g min(1, c / |g|)
    sq = g1 * g1 + g2 * g2
    big = sq >= 1.0
    scale = torch.where(big, ONE_MINUS_EPS / torch.sqrt(torch.where(big, sq, 1.0)), 1.0)
    g1c, g2c = g1 * scale, g2 * scale
    fac = 2.0 / (1.0 + g1c * g1c + g2c * g2c)
    e1, e2 = fac * g1c, fac * g2c
    f2 = fac * fac
    de_dgc = ((fac - f2 * g1c * g1c, -f2 * g1c * g2c),
              (-f2 * g1c * g2c, fac - f2 * g2c * g2c))
    # d gc / d g: the identity, or scale (I - g g^T / |g|^2) on the clip
    isq = torch.where(big, 1.0 / torch.where(big, sq, 1.0), 0.0)
    dgc_dg = ((scale * (1.0 - g1 * g1 * isq), -scale * g1 * g2 * isq),
              (-scale * g1 * g2 * isq, scale * (1.0 - g2 * g2 * isq)))
    de = [[de_dgc[i][0] * dgc_dg[0][k] + de_dgc[i][1] * dgc_dg[1][k]
           for k in range(2)] for i in range(2)]

    # the convolved moments [B, n] and their derivatives in the shape
    # columns 2 .. nshape - 1
    psf = psf_gmix[:, 0]
    # gmix_convolve's unit-flux normalization of the psf
    p_norm = psf[:, 0] * (1.0 / torch.where(psf[:, 0] == 0, 1.0, psf[:, 0]))
    h = (0.5 * Ts)[:, None] * fv
    irr = h * (1 - e1[:, None]) + psf[:, None, 3]
    irc = h * e2[:, None] + psf[:, None, 4]
    icc = h * (1 + e1[:, None]) + psf[:, None, 5]
    p = (flux[:, None] * pv) * p_norm[:, None]

    def d_of(dh):
        return dh * (1 - e1[:, None]), dh * e2[:, None], dh * (1 + e1[:, None])

    dh_dT = 0.5 * fv if not d_extra else (0.5 * Tf)[:, None] * fv
    d_mom = [  # (d irr, d irc, d icc) per shape parameter
        (-h * de[0][k][:, None], h * de[1][k][:, None], h * de[0][k][:, None])
        for k in range(2)
    ] + [d_of(dh_dT)] + [
        d_of((0.5 * T)[:, None] * (dTf[:, None] * fv + Tf[:, None] * df))
        for _, df, dTf in d_extra
    ]

    det = irr * icc - irc * irc
    valid = (det > GMIX_LOW_DETVAL) & ((irr + icc) > 0)
    det_s = torch.where(valid, det, 1.0)
    sqrt_det = torch.sqrt(det_s)
    N = p / (2.0 * np.pi * sqrt_det)
    Fvv, Fvu, Fuu = icc / det_s, -irc / det_s, irr / det_s

    zero = torch.zeros_like(h)
    one = torch.ones_like(h)
    npars = nshape + 1
    cols = [[zero] * npars for _ in range(6)]  # cols[j][k]
    cols[1][0] = one
    cols[2][1] = one
    cols[0][nshape] = torch.where(valid, (pv * p_norm[:, None]) / (2.0 * np.pi * sqrt_det),
                                  0.0)
    # the direct term of N in the extra columns: flux dp_g / (2 pi sqrt det)
    dN = [None] * 5 + [(flux[:, None] * dp) * p_norm[:, None] / (2.0 * np.pi * sqrt_det)
                       for dp, _, _ in d_extra]
    for k, (d_rr, d_rc, d_cc) in zip(range(2, nshape), d_mom):
        ddet = icc * d_rr + irr * d_cc - 2.0 * irc * d_rc
        dNk = -0.5 * N * ddet / det_s
        if dN[k] is not None:
            dNk = dNk + dN[k]
        cols[0][k] = torch.where(valid, dNk, 0.0)
        cols[3][k] = torch.where(valid, (d_cc - Fvv * ddet) / det_s, 0.0)
        cols[4][k] = torch.where(valid, (-d_rc - Fvu * ddet) / det_s, 0.0)
        cols[5][k] = torch.where(valid, (d_rr - Fuu * ddet) / det_s, 0.0)
    return torch.stack([torch.stack(c, dim=-1) for c in cols], dim=-2)


def _exp_normal_sums(pars, planes, psf_gmix, plain=False, model="exp"):
    """K1's reductions (cost, Jtr, JtJ) of a batched fit of the model
    (exp by default; plain=True: K1's plain version), with the chain
    from exp_chain, and the lanes whose parameter point is bad (fill
    flags or gmix_flags), whose sums mean nothing"""
    v, u, ia, ve = planes
    rp, gm, gflags = _exp_reparam(pars, psf_gmix, model)
    bad = (gflags != 0) | (gcore.gmix_flags(gm) != 0)
    k1 = normal_eqs.gmix_normal_eqs_plain if plain else normal_eqs.gmix_normal_eqs
    cost, Jtr, JtJ = k1(
        rp.contiguous(), exp_chain(pars, psf_gmix, model).contiguous(), v, u, ia, ve
    )
    return cost, Jtr, JtJ, bad


def _exp_normal_fn(pars, planes, psf_gmix, plain=False, model="exp"):
    """normal-equation reductions (cost, Jtr, JtJ) of a batched fit of
    the model (_exp_normal_sums). A bad parameter point gets cost 1e30,
    Jtr 0 and JtJ = I, so the LM rejects the step.
    """
    cost, Jtr, JtJ, bad = _exp_normal_sums(pars, planes, psf_gmix, plain, model)
    eye = torch.eye(pars.shape[-1], dtype=cost.dtype, device=cost.device)
    cost = torch.where(bad, 1.0e30, cost)
    Jtr = torch.where(bad[:, None], 0.0, Jtr)
    JtJ = torch.where(bad[:, None, None], eye, JtJ)
    return cost, Jtr, JtJ


def _normal_fn(pars, data, model="exp"):
    planes, psf_gmix = data
    return _exp_normal_fn(pars, planes, psf_gmix, model=model)


def _psf_gmix(psf_moms):
    """[B, 3] (irr, irc, icc) -> the one-gaussian psf mixture [B, 1, 6]
    of unit flux at the origin"""
    p_irr, p_irc, p_icc = psf_moms.unbind(-1)
    zero = torch.zeros_like(p_irr)
    return torch.stack(
        [torch.ones_like(p_irr), zero, zero, p_irr, p_irc, p_icc], dim=-1
    )[:, None, :]


def _auto_cascade(B):
    """default straggler-compaction capacities for B lanes: geometric
    halving B/2, B/4, ... down to no fewer than 32 lanes"""
    return tuple(B // (2 ** i) for i in range(1, 8) if B // (2 ** i) >= 32)


def _safe_best_pars(pars, flags):
    """best-fit pars with failed lanes replaced by a benign round
    unit-T point, so the fill never sees sentinel pars; flagged lanes
    are masked downstream"""
    benign = torch.zeros(pars.shape[-1], dtype=pars.dtype, device=pars.device)
    benign[4] = 1.0
    return torch.where((flags == 0)[:, None], pars, benign)


def _model_s2n_sums(pars, flags, psf_gmix, pixels, model="exp"):
    """model-weighted s/n sums at the best-fit parameters of the model
    (exp by default): s2n_numer = sum(val model ivar), s2n_denom =
    sum(model^2 ivar), with the model through K2 (gmix.core.get_loglike)"""
    gm0, _ = _MODEL_FILLS[model](_safe_best_pars(pars, flags))
    gm = gcore.gmix_convolve(gm0, psf_gmix)
    _, num, den, _ = gcore.get_loglike(gm, pixels)
    return num, den


def _lm_result_columns(out, s2n_sums, nband=1, model="exp"):
    """add the derived catalog columns (e1, e2, T, flux, s2n_flux, s2n,
    and fracdev for bdf, logTdByTe and fracdev for bd) of a fit of the
    model (exp by default) to a batched LM result dict,
    in place. s2n = numer / sqrt(denom) of the model-weighted sums, 0
    for failed or zero-signal lanes. One band: flux [B] and s2n_flux =
    |flux| / flux_err. nband > 1: flux [B, nband], and s2n_flux takes
    the band-sum flux with its error from the whole flux covariance
    block (the band fluxes are correlated through the shared shape)"""
    nshape = _MODEL_NSHAPE[model]
    out["e1"] = out["pars"][:, 2]
    out["e2"] = out["pars"][:, 3]
    out["T"] = out["pars"][:, 4]
    if nband == 1:
        out["flux"] = out["pars"][:, nshape]
        ferr = out["pars_err"][:, nshape]
        out["s2n_flux"] = torch.where(ferr > 0, torch.abs(out["flux"]) / ferr, 0.0)
    else:
        out["flux"] = out["pars"][:, nshape:]
        fsum = torch.sum(out["flux"], dim=-1)
        fcov = out["pars_cov"][:, nshape:, nshape:]
        esum = torch.sqrt(torch.clamp(torch.sum(fcov, dim=(-2, -1)), min=0.0))
        out["s2n_flux"] = torch.where(esum > 0, torch.abs(fsum) / esum, 0.0)
    num, den = s2n_sums
    ok = (out["flags"] == 0) & (den > 0)
    out["s2n"] = torch.where(
        ok, num / torch.sqrt(torch.where(den > 0, den, 1.0)), 0.0
    )
    if model == "bdf":
        out["fracdev"] = out["pars"][:, 5]
    elif model == "bd":
        out["logTdByTe"] = out["pars"][:, 5]
        out["fracdev"] = out["pars"][:, 6]


def _lm_bounds(bounds, npars, dtype, device):
    """(lo, hi) [npars] tensors of the bounds (lo, hi), +-inf for an
    open side; both infinite everywhere without bounds"""
    if bounds is None:
        return (torch.full((npars,), -torch.inf, dtype=dtype, device=device),
                torch.full((npars,), torch.inf, dtype=dtype, device=device))
    return tuple(torch.as_tensor(x, dtype=dtype, device=device).contiguous()
                 for x in bounds)


def _clamp_guess_in_bounds(guess, lo, hi):
    """the guesses clamped strictly inside the box, 1e-9 of the span
    from each finite bound (a span of 1 where one side is open), so the
    bounds map starts in the interior: a wider margin would move a
    moments flux guess of ~1e2 far off inside a [1e-3, 1e9] box"""
    span = torch.where(torch.isfinite(hi - lo), hi - lo, 1.0)
    return torch.clamp(guess, min=lo + 1.0e-9 * span, max=hi - 1.0e-9 * span)


def _caller_guess(guess, default_guess):
    """the caller's guess [B, npars] per lane where every entry is
    finite and |x| < 1e9, else the default guess: a failed fit's PDEF
    sentinel pars never seed a lane"""
    guess = torch.as_tensor(guess, dtype=default_guess.dtype, device=default_guess.device)
    bad = ~torch.all(torch.isfinite(guess) & (torch.abs(guess) < 1.0e9), dim=-1)
    return torch.where(bad[:, None], default_guess, guess)


def _extra_guess(model, guess5):
    """the starting values [B, nshape - 5] of the model's extra shape
    columns (none for the simple models)"""
    extra = _MODEL_EXTRA_GUESS.get(model, ())
    return torch.tensor(extra, dtype=guess5.dtype, device=guess5.device).expand(
        guess5.shape[0], len(extra))


def _exp_lm_measure(pixels, psf_sigma, lm_conf, host_loop=False,
                    compact_capacity="auto", model="exp", bounds=None, guess=None,
                    prior=None):
    """batched LM fit of the model (exp, gauss, dev, bdf or bd) to
    every lane; the psf is the analytic round target gaussian, psf_sigma
    a scalar or [B] (round sigma) or [B, 3] (irr, irc, icc).

    Starting guesses come from a gaussian weighted-moments pass with
    FWHM 1.2 (bdf's fracdev at 0.5, bd's log10(Td/Te) and fracdev at 0
    and 0.5), or from guess [B, npars] (a warm start) on the lanes where
    all its entries are finite and below 1e9. bounds = (lo, hi), [npars]
    each with +-inf for an open side, bound the fit, the guess clamped
    inside them. prior, a joint prior of the model's parameter vector
    (joint_prior), adds its rows to every lane's objective; the
    covariance scales by the pixels' chi^2 alone. The solve runs in K3
    (ops/lm_solve.py), one kernel
    launch for every lane's whole solve; CPU tensors take its plain
    version. host_loop=True runs run_lm_normal_batched instead, the host
    loop with K1 and, by default ("auto"), the geometric compaction
    cascade (compact_capacity takes its values too); the card checks and
    timings compare the two routes. K1 fits 6 parameters, as the TPU
    kernel does, so bdf and bd raise ValueError there. Refinement is not
    ported yet (ROADMAP queue item 10).
    """
    lm.check_supported(lm_conf)
    if host_loop and _MODEL_NSHAPE[model] + 1 != normal_eqs.NPARS:
        raise ValueError("the host-loop route runs K1, which fits %d parameters; "
                         "model %r has %d" % (normal_eqs.NPARS, model,
                                              _MODEL_NSHAPE[model] + 1))
    B = pixels.val.shape[0]
    dtype, dev = pixels.val.dtype, pixels.val.device
    psf_sigma = torch.as_tensor(psf_sigma, dtype=dtype, device=dev)
    if psf_sigma.dim() == 0:
        psf_sigma = psf_sigma.expand(B)
    if psf_sigma.dim() == 2:
        psf_moms = psf_sigma
    else:
        psf_moms = torch.stack(
            [psf_sigma**2, torch.zeros_like(psf_sigma), psf_sigma**2], dim=-1
        )
    psf_moms = psf_moms.contiguous()
    psf_gmix = _psf_gmix(psf_moms)

    guess5, wsum = _moments_lm_guess(pixels, psf_moms[:, 0] + psf_moms[:, 2])
    default_guess = torch.cat([guess5, _extra_guess(model, guess5), wsum[:, None]], dim=-1)
    guess = default_guess if guess is None else _caller_guess(guess, default_guess)
    lo, hi = _lm_bounds(bounds, _MODEL_NSHAPE[model] + 1, dtype, dev)
    if bounds is not None:
        guess = _clamp_guess_in_bounds(guess, lo, hi)
    guess = guess.contiguous()
    # per-stamp unmasked row count for the chi2/dof covariance scale
    nres = torch.sum(pixels.ierr > 0, dim=-1)
    planes = _lm_planes(pixels)
    if host_loop:
        if compact_capacity == "auto":
            compact_capacity = _auto_cascade(B)
        out = lm.run_lm_normal_batched(
            functools.partial(_normal_fn, model=model), (planes, psf_gmix), guess, lo,
            hi, lm_conf, nres=nres, compact_capacity=compact_capacity,
            prior_fn=lm_solve._prior_fn(prior),
        )
    else:
        state = lm_solve.lm_solve(guess, lo, hi, psf_moms, *planes, lm_conf, model, prior)
        out = lm._normal_epilogue(state, lo, hi, lm_conf, nres)
    _lm_result_columns(
        out, _model_s2n_sums(out["pars"], out["flags"], psf_gmix, pixels, model),
        model=model,
    )
    return out


# ----------------------------------------------------------------------
# the multi-band, multi-epoch pipeline

# the reference's LM objective formulations of the multi-band fit; each
# gives the same per-lane result, and this port computes all of them
# with one solve
_MB_OBJECTIVES = ("auto", "epoch", "fused", "epoch-be", "epoch-t")


def _check_measure_mb(conf, measure, nband, objective, lm_conf, lm_prior,
                      lm_bounds):
    """raise for what the multi-band pipeline cannot measure (the
    reference's ValueErrors) and, through _check_measure, for what this
    port has not taken over; returns the prior as _check_measure does,
    for nband flux slots"""
    if measure in ("pgauss", "ksigma"):
        raise ValueError(
            "pre-psf moments (%s) need a per-epoch psf deconvolution and "
            "cannot pool epochs; run each epoch through the flat "
            "metacal_pipeline or use an LM measure for joint multi-epoch "
            "fits" % measure
        )
    if measure in ("gaussmom", "admom") and nband != 1:
        raise ValueError(
            "moments measures pool the epochs of ONE band; got nband=%d "
            "(use an LM measure for joint multi-band fits)" % nband
        )
    if objective not in _MB_OBJECTIVES:
        raise ValueError(
            "objective must be 'auto', 'epoch', 'epoch-be', 'epoch-t' or "
            "'fused'; got %r" % (objective,)
        )
    return _check_measure(conf, measure, lm_conf, lm_prior, lm_bounds, nband)


def _mb_exp_normal_fn(pars, data, plain=False, model="exp"):
    """normal-equation reductions (cost, Jtr, JtJ) of the joint
    multi-band fit of the model (exp by default): pars [Bc, nshape +
    nband], the model's nshape shape columns and one flux a band;
    data = (planes, psf_gmix, band) with the epochs folded into the rows
    of the planes ([Bc E, P] each) and of psf_gmix ([Bc E, 1, 6]), band
    [Bc, E].

    Each epoch sees nshape + 1 parameters, the shared shape and its
    band's flux (fit_model.epoch_band_pars), so the epoch rows go
    through K1 as flat lanes (_exp_normal_sums; plain=True: K1's plain version), and the
    band one-hot sums over the epochs assemble the global system: the
    shape block, the shape-flux column of each band and the diagonal
    flux block. As in the reference, a bad point in any epoch poisons
    the lane: each of its E P rows is FDIFF_BAD, so cost = E P
    FDIFF_BAD^2, Jtr = 0 and JtJ = 0 (the flat fit's convention is
    1e30 and JtJ = I).
    """
    planes, psf_gmix, band = data
    Bc, E = band.shape
    P = planes[0].shape[-1]
    ns = _MODEL_NSHAPE[model]
    nband = pars.shape[-1] - ns
    bp = fit_model.epoch_band_pars(model, pars, band).reshape(Bc * E, ns + 1)
    cost_l, jtr_l, jtj_l, bad_l = _exp_normal_sums(bp, planes, psf_gmix, plain, model)
    bad = torch.any(bad_l.reshape(Bc, E), dim=1)
    jtr_e = jtr_l.reshape(Bc, E, ns + 1)
    jtj_e = jtj_l.reshape(Bc, E, ns + 1, ns + 1)
    oh = (band[:, :, None] == torch.arange(nband, device=band.device)).to(pars.dtype)

    cost = torch.sum(cost_l.reshape(Bc, E), dim=1)
    Jtr = torch.cat([
        torch.sum(jtr_e[..., :ns], dim=1),
        torch.sum(oh * jtr_e[..., ns:], dim=1),
    ], dim=-1)
    SS = torch.sum(jtj_e[..., :ns, :ns], dim=1)
    SF = torch.sum(jtj_e[..., :ns, ns:] * oh[:, :, None, :], dim=1)
    FF = torch.diag_embed(torch.sum(oh * jtj_e[..., ns, ns:], dim=1))
    JtJ = torch.cat([torch.cat([SS, SF], dim=-1),
                     torch.cat([SF.transpose(-1, -2), FF], dim=-1)], dim=-2)

    cost = torch.where(bad, fit_model.FDIFF_BAD**2 * (E * P), cost)
    Jtr = torch.where(bad[:, None], 0.0, Jtr)
    JtJ = torch.where(bad[:, None, None], 0.0, JtJ)
    return cost, Jtr, JtJ


def _mb_gather(E):
    """run_lm_normal_batched's gather_fn for _mb_exp_normal_fn's data:
    the E epoch rows of each lane of idx, and its band row"""

    def gather(data, idx):
        planes, psf_gmix, band = data
        rows = (idx[:, None] * E + torch.arange(E, device=idx.device)).reshape(-1)
        return tuple(x[rows] for x in planes), psf_gmix[rows], band[idx]

    return gather


def _mb_s2n_sums(pars, flags, band, psf_gmix, pixels, model="exp"):
    """model-weighted s/n sums of the joint fit of the model (exp by
    default), over every epoch of a
    lane, at the best-fit parameters: each epoch row (pixels and
    psf_gmix folded as in _mb_exp_normal_fn) with its band's flux,
    through K2 (gmix.core.get_loglike). A lane whose fill is bad gets
    numer 0 and denom BIGVAL, as in the reference"""
    Bc, E = band.shape
    bp = fit_model.epoch_band_pars(model, _safe_best_pars(pars, flags), band)
    gm0, gflags = _MODEL_FILLS[model](bp.reshape(Bc * E, _MODEL_NSHAPE[model] + 1))
    gm = gcore.gmix_convolve(gm0, psf_gmix)
    _, num, den, _ = gcore.get_loglike(gm, pixels)
    bad = torch.any((gflags != 0).reshape(Bc, E), dim=1)
    num = torch.sum(num.reshape(Bc, E), dim=1)
    den = torch.sum(den.reshape(Bc, E), dim=1)
    # BIGVAL is inf in float32, as in the reference
    return torch.where(bad, 0.0, num), torch.where(bad, den.new_tensor(BIGVAL), den)


def _mb_exp_lm_measure(pixels, psf_moms, band, nband, lm_conf, model="exp",
                       bounds=None, prior=None):
    """the joint LM fit of the model (exp, gauss, dev, bdf or bd) of
    every object-lane over its epochs and bands: pixels [Bc E, P] and
    psf_moms [Bc E, 3] = (irr, irc, icc) with each lane's E epochs in
    consecutive rows, band [Bc, E]; bounds = (lo, hi), [nshape + nband]
    each, or None.

    The guess pools the epochs: one gaussian weighted-moments pass over
    the lane's E P pixels with the psf's T averaged over its real
    epochs (those with an ierr > 0 pixel), the extra shape columns of
    bdf and bd at the flat fit's starting values, and each band's flux
    the mean masked pixel sum of its real epochs, so a pad epoch changes
    nothing. prior: a joint prior with nband flux slots, or None.
    On CUDA tensors the solve is one launch of K3-mb
    (ops.lm_solve.lm_solve_mb); CPU tensors take its plain version.
    """
    lm.check_supported(lm_conf)
    Bc, E = band.shape
    P = pixels.val.shape[-1]
    dtype, dev = pixels.val.dtype, pixels.val.device
    psf_moms = psf_moms.contiguous()
    pix_e = Pixels(*(x.reshape(Bc, E, P) for x in pixels))
    real_e = torch.any(pix_e.ierr > 0, dim=-1)
    nreal = torch.clamp(torch.sum(real_e, dim=-1), min=1)
    pm = psf_moms.reshape(Bc, E, 3)
    Tpsf = torch.sum(torch.where(real_e, pm[..., 0] + pm[..., 2], 0.0), dim=-1) / nreal
    guess5, _ = _moments_lm_guess(Pixels(*(x.reshape(Bc, E * P) for x in pixels)), Tpsf)
    wsum_e = torch.sum(pix_e.val * (pix_e.ierr > 0), dim=-1)
    onehot = (
        band[:, :, None] == torch.arange(nband, device=dev)
    ) & real_e[:, :, None]
    nep_band = torch.clamp(torch.sum(onehot, dim=1), min=1)
    flux_guess = torch.sum(wsum_e[:, :, None] * onehot, dim=1) / nep_band
    guess = torch.cat([guess5, _extra_guess(model, guess5), flux_guess], dim=-1)

    lo, hi = _lm_bounds(bounds, _MODEL_NSHAPE[model] + nband, dtype, dev)
    if bounds is not None:
        guess = _clamp_guess_in_bounds(guess, lo, hi)
    nres = torch.sum(pix_e.ierr > 0, dim=(-2, -1))
    planes = [x.reshape(Bc, E, P) for x in _lm_planes(pixels)]
    state = lm_solve.lm_solve_mb(guess.contiguous(), lo, hi, pm, band, *planes, lm_conf,
                                 model, prior)
    out = lm._normal_epilogue(state, lo, hi, lm_conf, nres)
    _lm_result_columns(out, _mb_s2n_sums(out["pars"], out["flags"], band,
                                         _psf_gmix(psf_moms), pixels, model),
                       nband=nband, model=model)
    return out


def metacal_pipeline_mb(images, weights, cens, psf_images, psf_cens, noise,
                        band, nband, conf: MetacalConfig, lm_conf=None,
                        measure="exp-lm", measure_fwhm=1.2, lm_prior=None,
                        lm_bounds=None, objective="auto", device=None):
    """metacal and the joint multi-band, multi-epoch measure of every
    object (MEDS-style).

    images/weights/noise [B, E, H, W], cens [B, E, 2], psf_images [B,
    E, Hp, Wp], psf_cens [B, E, 2]: E epochs an object, spanning nband
    bands, with band [E] the band of each epoch or [B, E] per object.
    Each epoch's metacal image set is made on its own (the epoch axis
    folds into the engine's batch axis). measure: "exp-lm", "gauss-lm",
    "dev-lm", "bdf-lm" or "bd-lm", one joint LM fit of that model an
    object and type of the nshape + nband parameters (row, col, g1, g2,
    T, bdf's fracdev or bd's log10(Td/Te) and fracdev, one flux a band),
    each epoch with its own psf gaussian (the round dilated target,
    under dilate the admom fit of its type's rendered target), inside
    lm_bounds = (lo, hi) of nshape + nband values each, or unbounded; or
    "gaussmom" / "admom" with nband = 1, which
    pool the weighted sums over the epochs' pixels (the moment-space
    coadd). The pre-psf moments raise ValueError, as in the reference.
    A pad epoch (ierr = 0 everywhere, a valid psf stamp) adds nothing.

    objective: the reference's normal-equation formulations ("auto",
    "epoch", "fused", "epoch-be", "epoch-t") are one objective laid out
    differently on a TPU, each with the same per-lane result; this port
    computes every one of them with the same solve (K3-mb on the card).
    lm_prior regularizes the LM fits as in metacal_pipeline, built for
    nband flux slots (a list of nband F priors). A nonzero
    conf.sheared_refine and the LMConf options flux_col and varpro raise
    NotImplementedError. Returns dict
    type -> result dict of [B, ...] tensors (flux [B, nband] when
    nband > 1), plus "psf_sigma" [B, E].
    """
    lm_prior = _check_measure_mb(conf, measure, nband, objective, lm_conf, lm_prior,
                                 lm_bounds)
    full_precision_matmuls()
    images, weights, cens, psf_images, psf_cens, noise = _as_inputs(
        (images, weights, cens, psf_images, psf_cens, noise), device
    )
    B, E = images.shape[:2]

    def fold(x):
        return x.reshape((B * E,) + x.shape[2:])

    pixels, sigma, psfdict = _stacked_pixels(
        *map(fold, (images, weights, cens, psf_images, psf_cens, noise)), conf,
        with_psf_stamps=measure in _LM_MEASURES,
    )
    T = len(conf.types)
    if measure in _LM_MEASURES:
        band = torch.as_tensor(band, device=images.device).to(torch.int32)
        band_st = torch.broadcast_to(band, (B, E)).repeat(T, 1)
        res_all = _mb_exp_lm_measure(pixels, _lm_psf_moms(conf, sigma, psfdict), band_st,
                                     nband, lm_conf or lm.LMConf(), model=measure[:-3],
                                     bounds=lm_bounds, prior=lm_prior)
    else:
        # the epochs of a lane pooled into one moments measurement
        pooled = Pixels(*(x.reshape(T * B, -1) for x in pixels))
        res_all = _moments_measure(pooled, conf, measure, measure_fwhm)
    return _split_types(res_all, conf.types, B, sigma.reshape(B, E))


def make_metacal_pipeline_mb_fn(conf: MetacalConfig, band, nband, measure="exp-lm",
                                measure_fwhm=1.2, lm_conf=None, lm_prior=None,
                                lm_bounds=None, max_chunk=4096, objective="auto",
                                device=None):
    """multi-band pipeline closure over a fixed configuration, band map
    and device (see metacal_pipeline_mb); unsupported options raise
    here, before any work. Batches of more than max_chunk OBJECTS run
    as successive chunks, a [B, E] band map sliced with them, and the
    per-lane results are concatenated; they equal a single-batch run.
    None disables chunking.
    """
    lm_prior = _check_measure_mb(conf, measure, nband, objective, lm_conf, lm_prior,
                                 lm_bounds)
    dev = resolve_device(device)
    band = torch.as_tensor(band).to(torch.int32)
    kw = dict(measure=measure, measure_fwhm=measure_fwhm, lm_conf=lm_conf,
              lm_prior=lm_prior, lm_bounds=lm_bounds, objective=objective, device=dev)

    def fn(images, weights, cens, psf_images, psf_cens, noise):
        args = (images, weights, cens, psf_images, psf_cens, noise)
        B = len(images)
        if max_chunk is None or B <= max_chunk:
            return metacal_pipeline_mb(*args, band, nband, conf, **kw)
        parts = [
            metacal_pipeline_mb(
                *(a[i:i + max_chunk] for a in args),
                band if band.dim() == 1 else band[i:i + max_chunk], nband, conf, **kw)
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


def _solve2(A, b):
    """A^-1 b for a 2x2 A in closed form: a singular A gives inf/nan,
    never raises (torch.linalg.solve would)"""
    det = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
    return torch.stack([
        (A[1, 1] * b[0] - A[0, 1] * b[1]) / det,
        (A[0, 0] * b[1] - A[1, 0] * b[0]) / det,
    ])


def _mean_e_n(r_val, ok):
    """(mean (e1, e2) of r_val over the lanes ok, their count); an
    empty selection divides by 1 and gives e = 0 with a count of 0"""
    n = torch.sum(ok)
    n_safe = torch.clamp(n, min=1)
    e1 = torch.sum(torch.where(ok, r_val["e1"], 0.0)) / n_safe
    e2 = torch.sum(torch.where(ok, r_val["e2"], 0.0)) / n_safe
    return torch.stack([e1, e2]), n


def _response(e_1p, e_1m, e_2p, e_2m, step):
    """the 2x2 finite-difference response d<e_i> / d g_j"""
    return torch.stack([
        torch.stack([e_1p[0] - e_1m[0], e_2p[0] - e_2m[0]]),
        torch.stack([e_1p[1] - e_1m[1], e_2p[1] - e_2m[1]]),
    ]) / (2 * step)


def shear_response_select(results, select_fn, step=DEFAULT_STEP):
    """mean shear with the selection-response correction (Sheldon &
    Huff 2017 eq. 10-12).

    R comes from the sheared measurements under the selection made on
    noshear; R_sel from the noshear measurements under the selections
    made on each sheared type. select_fn maps a type's result dict of
    tensors to a bool [B] keep mask; a lane also needs flags 0 in the
    type measured and the type selected on. Returns e_mean, R, R_sel,
    shear = (R + R_sel)^-1 e_mean (closed form: an empty selection gives
    nan, never raises) and n_used.

    Prefer shear_response_select_consistent at survey noise: in the
    reference this split estimator read m ~ 1.3e-3 on a null control
    (an s/n cut that never binds, where an unbiased estimator returns
    the plain answer), from the cross-type intersections of flags and
    selections. That is the reference's behaviour, which this port
    keeps.
    """
    def mean_e_n(val_t, sel_t):
        ok = ((results[val_t]["flags"] == 0) & (results[sel_t]["flags"] == 0)
              & select_fn(results[sel_t]))
        return _mean_e_n(results[val_t], ok)

    def mean_e(val_t, sel_t):
        return mean_e_n(val_t, sel_t)[0]

    e_ns, n_used = mean_e_n("noshear", "noshear")
    # measurement response: sheared measurements, noshear selection
    R = _response(*(mean_e(t, "noshear") for t in ("1p", "1m", "2p", "2m")), step)
    # selection response: noshear measurements, sheared selections
    R_sel = _response(*(mean_e("noshear", t) for t in ("1p", "1m", "2p", "2m")), step)
    return {"e_mean": e_ns, "R": R, "R_sel": R_sel, "shear": _solve2(R + R_sel, e_ns),
            "n_used": n_used}


def shear_response_select_consistent(results, select_fn, step=DEFAULT_STEP):
    """mean shear with a shear-consistent selection of each type.

    Each type's sample is selected by that type's own catalog (flags 0
    and select_fn on its own measurements), so the selection response
    is absorbed into R rather than a separate R_sel term: the
    metadetect method. select_fn maps a type's result dict of tensors
    to a bool [B] keep mask. Returns e_mean (noshear, its own
    selection), R, shear = R^-1 e_mean (closed form, as
    shear_response_select) and n_used.

    The reference read m ~ 1.8e-4 with this estimator on the null
    control where shear_response_select read ~1.3e-3; both are
    first-order metacal estimators and agree when flags and the
    selection do not depend on the shear.
    """
    def mean_e_n(t):
        r = results[t]
        return _mean_e_n(r, (r["flags"] == 0) & select_fn(r))

    e_ns, n_used = mean_e_n("noshear")
    R = _response(*(mean_e_n(t)[0] for t in ("1p", "1m", "2p", "2m")), step)
    return {"e_mean": e_ns, "R": R, "shear": _solve2(R, e_ns), "n_used": n_used}


def psf_shear_response(results, step=DEFAULT_STEP):
    """psf-leakage response R_psf [2, 2] from the *_psf metacal types
    (psf_mode='dilate'): R_psf[i, j] = d<e_i> / d g_psf_j over the
    unflagged lanes of each type"""
    def mean_e(t):
        ok = results[t]["flags"] == 0
        n = torch.clamp(torch.sum(ok), min=1)
        e1 = torch.sum(torch.where(ok, results[t]["e1"], 0.0)) / n
        e2 = torch.sum(torch.where(ok, results[t]["e2"], 0.0)) / n
        return torch.stack([e1, e2])

    d1 = (mean_e("1p_psf") - mean_e("1m_psf")) / (2 * step)
    d2 = (mean_e("2p_psf") - mean_e("2m_psf")) / (2 * step)
    return torch.stack([d1, d2], dim=-1)
