"""Gaussian-mixture operations on dense [..., n, 6] tensors.

The main-path subset of ``ngmix_tpu/gmix/core.py``: columns are
(p, row, col, irr, irc, icc), every function broadcasts over leading
batch dims, and invalid gaussians evaluate to zero instead of raising.
The batched [B, P] evaluations of the moment sums and of the s/n sums
(``get_weighted_sums``, ``get_loglike``) go through K2
(ops/gmix_eval.py).
"""
import numpy as np
import torch

from .. import flags as _flags
from ..defaults import FASTEXP_APOD_CHI2, FASTEXP_MAX_CHI2, GMIX_LOW_DETVAL
from ..moments import get_sheared_moments
from ..ops import gmix_eval
from ..shape import g1g2_to_e1e2
from . import tables

# column indices of the gmix tensor
G_P, G_ROW, G_COL, G_IRR, G_IRC, G_ICC = range(6)

_APOD_IWIDTH = 1.0 / (FASTEXP_MAX_CHI2 - FASTEXP_APOD_CHI2)


def apod_window(chi2):
    """quintic smoothstep from 1 at APOD_CHI2 to 0 at MAX_CHI2"""
    u = (FASTEXP_MAX_CHI2 - chi2) * _APOD_IWIDTH
    return u * u * u * (10.0 + u * (-15.0 + 6.0 * u))


def apod_window_deriv(chi2):
    """d(apod_window)/d(chi2)"""
    u = (FASTEXP_MAX_CHI2 - chi2) * _APOD_IWIDTH
    umu = u * (1.0 - u)
    return -30.0 * umu * umu * _APOD_IWIDTH


def gmix_det(gmix):
    """determinants [..., n] of the per-gaussian covariances"""
    return (
        gmix[..., G_IRR] * gmix[..., G_ICC] - gmix[..., G_IRC] * gmix[..., G_IRC]
    )


def gmix_flags(gmix):
    """int32 flags [...]: LOW_DET where any component has det or T
    below the floor. This is the rule of the fills' callers; the
    evaluation (gmix_norms) and the reparametrization of the normal
    equations (ops.normal_eqs.gmix_reparam) each have their own."""
    det = gmix_det(gmix)
    T = gmix[..., G_IRR] + gmix[..., G_ICC]
    bad = (det < GMIX_LOW_DETVAL) | (T <= GMIX_LOW_DETVAL)
    zero = torch.zeros(bad.shape[:-1], dtype=torch.int32, device=gmix.device)
    return torch.where(torch.any(bad, dim=-1), _flags.LOW_DET, zero)


def gmix_norms(gmix):
    """(dcc, drr, drc, pnorm, valid), each [..., n]: inverse-covariance
    terms, p / (2 pi sqrt(det)) and a per-gaussian validity mask.
    Invalid gaussians get pnorm = 0 so they evaluate to zero."""
    det = gmix_det(gmix)
    T = gmix[..., G_IRR] + gmix[..., G_ICC]
    valid = (det >= GMIX_LOW_DETVAL) & (det > 0) & (T > GMIX_LOW_DETVAL)
    det_safe = torch.where(valid, det, 1.0)
    idet = 1.0 / det_safe
    drr = gmix[..., G_IRR] * idet
    drc = gmix[..., G_IRC] * idet
    dcc = gmix[..., G_ICC] * idet
    norm = 1.0 / (2 * np.pi * torch.sqrt(det_safe))
    pnorm = torch.where(valid, gmix[..., G_P] * norm, 0.0)
    return dcc, drr, drc, pnorm, valid


def eval_chi2(gmix, v, u):
    """mahalanobis distances [..., n, npix] of (v, u) [..., npix] to
    each gaussian"""
    dcc, drr, drc, _, _ = gmix_norms(gmix)
    vd = v[..., None, :] - gmix[..., G_ROW, None]
    ud = u[..., None, :] - gmix[..., G_COL, None]
    return (
        dcc[..., None] * vd * vd
        + drr[..., None] * ud * ud
        - 2.0 * drc[..., None] * vd * ud
    )


def eval_gmix(gmix, v, u, area=1.0, fast=True):
    """mixture surface brightness [..., npix] at (v, u) [..., npix],
    times the pixel area (scalar or [..., npix]). fast: the apodized
    objective (chi2 cut at 25 with the C2 window from 20); fast=False
    is the exact untruncated gaussian. Broadcasting tensor code; the
    batched [B, P] evaluations of the main path go through K2."""
    _, _, _, pnorm, _ = gmix_norms(gmix)
    chi2 = eval_chi2(gmix, v, u)
    if fast:
        win = torch.where(chi2 > FASTEXP_APOD_CHI2, apod_window(chi2), 1.0)
        win = torch.where((chi2 < FASTEXP_MAX_CHI2) & (chi2 >= 0.0), win, 0.0)
        vals = torch.exp(-0.5 * torch.clamp(chi2, 0.0, FASTEXP_MAX_CHI2)) * win
    else:
        vals = torch.exp(-0.5 * chi2)
    return torch.sum(pnorm[..., None] * vals, dim=-2) * area


def _eval_batched(gmix, pixels, fast):
    """K2 over every lane of a pixel struct: gmix [..., n, 6] (leading
    dims broadcast to the pixels'), pixels fields [..., P] with area a
    scalar or [..., P]; returns the model [..., P] times the area"""
    lead, P = pixels.v.shape[:-1], pixels.v.shape[-1]
    nb = int(np.prod(lead, dtype=np.int64))
    area = pixels.area
    if isinstance(area, torch.Tensor) and area.dim() > 0:
        area = torch.broadcast_to(area, pixels.v.shape).reshape(nb, P).contiguous()
    return gmix_eval.eval_gmix(
        torch.broadcast_to(gmix, lead + gmix.shape[-2:]).reshape(nb, -1, 6).contiguous(),
        pixels.v.reshape(nb, P).contiguous(),
        pixels.u.reshape(nb, P).contiguous(),
        area,
        fast=fast,
    ).reshape(pixels.v.shape)


def get_loglike(gmix, pixels):
    """log likelihood and s/n sums over a pixel struct: (loglike,
    s2n_numer, s2n_denom, npix), each [...]. Masked pixels carry
    ierr = 0 and contribute zero.

    The model is the apodized objective (fast=True) through K2. The
    JAX function evaluates it with the plain broadcasting eval_gmix;
    routing the batched [B, P] evaluation through the kernel is this
    port's choice.
    """
    model = _eval_batched(gmix, pixels, fast=True)
    ivar = pixels.ierr * pixels.ierr
    diff = model - pixels.val
    loglike = -0.5 * torch.sum(diff * diff * ivar, dim=-1)
    s2n_numer = torch.sum(pixels.val * model * ivar, dim=-1)
    s2n_denom = torch.sum(model * model * ivar, dim=-1)
    npix = torch.sum((pixels.ierr > 0).to(torch.int32), dim=-1, dtype=torch.int32)
    return loglike, s2n_numer, s2n_denom, npix


def fill_fdiff(gmix, pixels):
    """scaled residuals (model - data) * ierr, [..., P]; masked pixels
    give 0 rows. Broadcasting tensor code (differentiable with
    torch.func); the LM's normal equations go through K1 instead."""
    model = eval_gmix(gmix, pixels.v, pixels.u, pixels.area, fast=True)
    return (model - pixels.val) * pixels.ierr


# ----------------------------------------------------------------------
# mixture-level geometry

def gmix_get_cen(gmix):
    """(row, col, psum) flux-weighted center"""
    p = gmix[..., G_P]
    psum = torch.sum(p, dim=-1)
    psum_safe = torch.where(psum == 0, 1.0, psum)
    row = torch.sum(p * gmix[..., G_ROW], dim=-1) / psum_safe
    col = torch.sum(p * gmix[..., G_COL], dim=-1) / psum_safe
    return row, col, psum


def gmix_convolve(gmix, psf):
    """analytic gaussian x gaussian convolution: gmix [..., n, 6] (*)
    psf [..., m, 6] -> [..., n*m, 6]; the psf is normalized to unit
    flux and recentered about its own flux-weighted center"""
    psf_row, psf_col, psf_psum = gmix_get_cen(psf)
    ipsum = 1.0 / torch.where(psf_psum == 0, 1.0, psf_psum)

    p = gmix[..., :, None, G_P] * psf[..., None, :, G_P] * ipsum[..., None, None]
    row = gmix[..., :, None, G_ROW] + (
        psf[..., None, :, G_ROW] - psf_row[..., None, None]
    )
    col = gmix[..., :, None, G_COL] + (
        psf[..., None, :, G_COL] - psf_col[..., None, None]
    )
    irr = gmix[..., :, None, G_IRR] + psf[..., None, :, G_IRR]
    irc = gmix[..., :, None, G_IRC] + psf[..., None, :, G_IRC]
    icc = gmix[..., :, None, G_ICC] + psf[..., None, :, G_ICC]

    out = torch.stack(torch.broadcast_tensors(p, row, col, irr, irc, icc), dim=-1)
    return out.reshape(out.shape[:-3] + (-1, 6))


def gmix_get_sheared(gmix, s1, s2):
    """apply reduced shear to each component's second moments"""
    irr_s, irc_s, icc_s = get_sheared_moments(
        gmix[..., G_IRR], gmix[..., G_IRC], gmix[..., G_ICC], s1, s2
    )
    return torch.stack(
        [gmix[..., G_P], gmix[..., G_ROW], gmix[..., G_COL], irr_s, irc_s, icc_s],
        dim=-1,
    )


# ----------------------------------------------------------------------
# model fills: pars [..., 6] -> (gmix [..., ngauss, 6], flags [...])

def _fill_from_pf(row, col, e1, e2, T, flux, pvals, fvals):
    """assemble a co-centered, co-elliptical expansion [..., n, 6] from
    per-model values [..., 1]"""
    T_i_2 = 0.5 * T * fvals
    p = flux * pvals
    row = torch.broadcast_to(row, p.shape)
    col = torch.broadcast_to(col, p.shape)
    irr = T_i_2 * (1 - e1)
    irc = T_i_2 * e2
    icc = T_i_2 * (1 + e1)
    return torch.stack([p, row, col, irr, irc, icc], dim=-1)


def _g_flags(g1, g2):
    return torch.where(
        g1 * g1 + g2 * g2 >= 1.0,
        _flags.GMIX_RANGE_ERROR,
        torch.zeros(g1.shape, dtype=torch.int32, device=g1.device),
    )


def fill_simple(pars, pvals, fvals):
    """6-parameter [cen1, cen2, g1, g2, T, flux] fill over fixed tables"""
    # the per-model values keep a trailing axis of 1: under torch.func a
    # python scalar met by a 0-d tensor (as g1g2_to_e1e2's constants
    # meet each lane's g under vmap) promotes the tangent to float64
    row, col, g1, g2, T, flux = pars.split(1, dim=-1)
    e1, e2 = g1g2_to_e1e2(g1, g2)
    gm = _fill_from_pf(row, col, e1, e2, T, flux, pvals, fvals)
    return gm, _g_flags(g1[..., 0], g2[..., 0])


def _table(vals, like):
    return torch.as_tensor(vals, dtype=like.dtype, device=like.device)


def fill_exp(pars):
    return fill_simple(
        pars, _table(tables.PVALS_EXP, pars), _table(tables.FVALS_EXP, pars)
    )


def fill_dev(pars):
    return fill_simple(
        pars, _table(tables.PVALS_DEV, pars), _table(tables.FVALS_DEV, pars)
    )


def fill_turb(pars):
    return fill_simple(
        pars, _table(tables.PVALS_TURB, pars), _table(tables.FVALS_TURB, pars)
    )


def fill_gauss(pars):
    return fill_simple(
        pars, _table(tables.PVALS_GAUSS, pars), _table(tables.FVALS_GAUSS, pars)
    )


# the composite (bulge + disk) models: the 6 exp gaussians of weight
# 1 - fracdev and the 10 dev gaussians of weight fracdev, the dev sizes
# scaled by Td/Te, all sizes by Tfactor = 1 / sum_g p_g f_g

def _cm_pf(fracdev, TdByTe):
    """16-component (p, f) [..., 16] of the composite models at fracdev
    and TdByTe [...]"""
    pe = _table(tables.PVALS_EXP, fracdev) * (1.0 - fracdev)[..., None]
    pd = _table(tables.PVALS_DEV, fracdev) * fracdev[..., None]
    fe = torch.broadcast_to(_table(tables.FVALS_EXP, fracdev), pe.shape)
    fd = _table(tables.FVALS_DEV, fracdev) * TdByTe[..., None]
    return torch.cat([pe, pd], dim=-1), torch.cat([fe, fd], dim=-1)


def get_cm_Tfactor(fracdev, TdByTe):
    """T normalization factor [...] of the composite models"""
    p, f = _cm_pf(torch.as_tensor(fracdev), torch.as_tensor(TdByTe))
    return 1.0 / torch.sum(p * f, dim=-1)


def fill_cm(pars, fracdev, TdByTe):
    """composite model [..., 16, 6] from pars [..., 6] = (row, col, g1,
    g2, T, flux) and fracdev, TdByTe [...]"""
    fracdev = torch.as_tensor(fracdev, dtype=pars.dtype, device=pars.device)
    TdByTe = torch.as_tensor(TdByTe, dtype=pars.dtype, device=pars.device)
    Tfactor = get_cm_Tfactor(fracdev, TdByTe)
    p, f = _cm_pf(fracdev, TdByTe)
    # the per-model values keep a trailing axis of 1, as in fill_simple
    row, col, g1, g2, T, flux = pars.split(1, dim=-1)
    e1, e2 = g1g2_to_e1e2(g1, g2)
    gm = _fill_from_pf(row, col, e1, e2, T * Tfactor[..., None], flux, p, f)
    return gm, _g_flags(g1[..., 0], g2[..., 0])


def fill_bd(pars):
    """bulge+disk, pars [..., 8] = (row, col, g1, g2, T, log10(Td/Te),
    fracdev, flux)"""
    return fill_cm(torch.cat([pars[..., :5], pars[..., 7:8]], dim=-1), pars[..., 6],
                   10.0 ** pars[..., 5])


def fill_bdf(pars):
    """bdf, Td/Te = 1 and a free fracdev: pars [..., 7] = (row, col, g1,
    g2, T, fracdev, flux)"""
    fracdev = pars[..., 5]
    return fill_cm(torch.cat([pars[..., :5], pars[..., 6:7]], dim=-1), fracdev,
                   torch.ones_like(fracdev))


# ----------------------------------------------------------------------
# weighted moment sums

def _moment_feature_list(vmod, umod, v, u):
    """moment basis functions as a list of [..., npix] tensors, in the
    order of moments.MOMENTS_NAME_MAP. The first two are the absolute
    coords v, u; the quadratic terms use centered coords."""
    rad2 = umod * umod + vmod * vmod
    return [
        v,
        u,
        umod * umod - vmod * vmod,
        2 * vmod * umod,
        rad2,
        torch.ones_like(rad2),
    ]


def weighted_feature_reductions(w, feats, cov_weight=None):
    """sums_i = sum_p w f_i and, when cov_weight is given,
    cov_ij = sum_p cov_weight f_i f_j over the last axis. Returns
    (sums [..., nf], cov [..., nf, nf] or None)."""
    n = len(feats)
    sums = torch.stack([torch.sum(w * f, dim=-1) for f in feats], dim=-1)
    if cov_weight is None:
        return sums, None
    rows = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i, n):
            rows[i][j] = torch.sum(cov_weight * feats[i] * feats[j], dim=-1)
    for i in range(n):
        for j in range(i):
            rows[i][j] = rows[j][i]
    cov = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    return sums, cov


def get_weighted_sums(wt, pixels, maxrad, with_cov=True):
    """weighted moment sums with their covariance.

    wt [..., n, 6] is the weight mixture, evaluated with the exact
    (untruncated) exponential times the pixel area through K2;
    pixels fields are [..., npix] with the same leading dims. Returns a
    dict with sums [..., 6], sums_cov [..., 6, 6] (None without
    with_cov), wsum, npix and flags.
    """
    vcen = wt[..., 0, G_ROW]
    ucen = wt[..., 0, G_COL]
    vmod = pixels.v - vcen[..., None]
    umod = pixels.u - ucen[..., None]
    rad2 = umod * umod + vmod * vmod

    mask = (rad2 < maxrad**2) & (pixels.ierr > 0.0)
    fmask = mask.to(pixels.v.dtype)

    weight = _eval_batched(wt, pixels, fast=False) * fmask

    ierr_safe = torch.where(mask, pixels.ierr, 1.0)
    var = 1.0 / (ierr_safe * ierr_safe)

    wdata = weight * pixels.val
    w2var = weight * weight * var

    feats = _moment_feature_list(vmod, umod, pixels.v, pixels.u)
    sums, sums_cov = weighted_feature_reductions(
        wdata, feats, cov_weight=w2var if with_cov else None
    )
    return {
        "sums": sums,
        "sums_cov": sums_cov,
        "wsum": torch.sum(weight, dim=-1),
        "npix": torch.sum(mask.to(torch.int32), dim=-1, dtype=torch.int32),
        "flags": torch.zeros(sums.shape[:-1], dtype=torch.int32, device=sums.device),
    }
