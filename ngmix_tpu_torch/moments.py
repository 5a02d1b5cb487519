"""Moment conversions and the moment-sums -> result path.

Ports of ``ngmix_tpu/moments.py``: ``make_mom_result`` works on
tensors with any leading batch dims and encodes every failure as a
flag bit with torch.where, so it never raises on bad data. The size
conversions take numbers, numpy arrays or tensors; ``result_to_host``
turns a result dict into numpy with flag strings.
"""
import numpy as np
import torch

from . import flags as _flags
from . import shape
from .util import get_ratio_error

MOMENTS_NAME_MAP = {
    "Mv": 0,
    "Mu": 1,
    "M1": 2,
    "M2": 3,
    "MT": 4,
    "MF": 5,
    # alternative notation (piff-style)
    "M00": 5,
    "M10": 1,
    "M01": 0,
    "M11": 4,
    "M20": 2,
    "M02": 3,
    # third order
    "M21": 6,
    "M12": 7,
    "M30": 8,
    "M03": 9,
    # fourth order
    "M22": 10,
    "M31": 11,
    "M13": 12,
    "M40": 13,
    "M14": 14,
    # 6th / 8th order radial
    "M33": 15,
    "M44": 16,
}

SIGMA_TO_FWHM_FAC = 2.3548200450309493


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else np.sqrt(x)


def sigma_to_fwhm(sigma):
    return sigma * SIGMA_TO_FWHM_FAC


def fwhm_to_sigma(fwhm):
    return fwhm / SIGMA_TO_FWHM_FAC


def T_to_fwhm(T):
    return sigma_to_fwhm(_sqrt(T / 2.0))


def fwhm_to_T(fwhm):
    return 2 * fwhm_to_sigma(fwhm) ** 2


def r50_to_sigma(r50):
    return fwhm_to_sigma(2.0 * r50)


def sigma_to_r50(sigma):
    return sigma_to_fwhm(sigma) / 2.0


def r50_to_T(r50):
    return 2 * r50_to_sigma(r50) ** 2


def T_to_r50(T):
    return sigma_to_r50(_sqrt(T / 2.0))


def moms_to_e1e2(M1, M2, T):
    """e = (M1 / T, M2 / T); T <= 0 gives NaN (flagged upstream)"""
    T = shape._t(T)
    Tsafe = torch.where(T <= 0.0, torch.nan, T)
    return M1 / Tsafe, M2 / Tsafe


def get_Tround(T, g1, g2):
    gsq = g1**2 + g2**2
    return T * (1 - gsq) / (1 + gsq)


def get_T(Tround, g1, g2):
    gsq = g1**2 + g2**2
    return Tround * (1 + gsq) / (1 - gsq)


def get_sheared_M1M2T(M1, M2, T, s1, s2):
    """shear raw M1, M2, T moments"""
    T = shape._t(T)
    e1, e2 = moms_to_e1e2(shape._t(M1), shape._t(M2), T)
    g1, g2 = shape.e1e2_to_g1g2(e1, e2)
    g1s, g2s = shape.shear_reduced(g1, g2, s1, s2)
    Tround = get_Tround(T, g1, g2)
    Ts = get_T(Tround, g1s, g2s)
    e1s, e2s = shape.g1g2_to_e1e2(g1s, g2s)
    return Ts * e1s, Ts * e2s, Ts


def get_sheared_g1g2T(g1, g2, T, s1, s2):
    g1s, g2s = shape.shear_reduced(g1, g2, s1, s2)
    Tround = get_Tround(T, g1, g2)
    Ts = get_T(Tround, g1s, g2s)
    return g1s, g2s, Ts


def get_sheared_moments(irr, irc, icc, s1, s2):
    g1, g2, T = mom2g(irr, irc, icc)
    g1s, g2s, Ts = get_sheared_g1g2T(g1, g2, T, s1, s2)
    return g2mom(g1s, g2s, Ts)


def mom2e(Irr, Irc, Icc):
    T = Irr + Icc
    return (Icc - Irr) / T, 2.0 * Irc / T, T


def mom2g(Irr, Irc, Icc):
    e1, e2, T = mom2e(Irr, Irc, Icc)
    g1, g2 = shape.e1e2_to_g1g2(e1, e2)
    return g1, g2, T


def e2mom(e1, e2, T):
    return (1 - e1) * T / 2.0, e2 * T / 2.0, (1 + e1) * T / 2.0


def g2mom(g1, g2, T):
    e1, e2 = shape.g1g2_to_e1e2(g1, g2)
    return e2mom(e1, e2, T)


def make_mom_result(sums, sums_cov, sums_norm=None):
    """raw (unnormalized) moment sums [..., nmom] and their covariance
    [..., nmom, nmom] -> result dict of tensors with the leading batch
    dims kept. 'flags' / 'T_flags' / 'flux_flags' are int32 bitmasks.
    nmom is 6 or 17, ordered [Mv, Mu, M1, M2, MT, MF, ...]."""
    nmom = sums.shape[-1]
    if nmom not in (6, 17):
        raise ValueError(
            "You must pass exactly 6 or 17 unnormalized moments in the order "
            "[Mv, Mu, M1, M2, MT, MF, ...]"
        )
    if tuple(sums_cov.shape[-2:]) != (nmom, nmom):
        raise ValueError("sums_cov must be [..., nmom, nmom]")

    mv, mu, m1, m2, mt, mf = 0, 1, 2, 3, 4, 5
    batch_shape = sums.shape[:-1]
    izero = torch.zeros(batch_shape, dtype=torch.int32, device=sums.device)
    nan = torch.nan

    res = {}
    res["sums"] = sums
    res["sums_cov"] = sums_cov
    res["sums_norm"] = (
        torch.broadcast_to(
            torch.as_tensor(sums_norm, dtype=sums.dtype, device=sums.device),
            batch_shape,
        )
        if sums_norm is not None
        else torch.full(batch_shape, nan, dtype=sums.dtype, device=sums.device)
    )
    res["flux"] = sums[..., mf]

    var_mf = sums_cov[..., mf, mf]
    var_mt = sums_cov[..., mt, mt]

    flux_flags = torch.where(var_mf > 0, izero, _flags.NONPOS_VAR)
    res["flux_err"] = torch.where(
        var_mf > 0, torch.sqrt(torch.abs(var_mf)), nan
    )
    res["s2n"] = torch.where(var_mf > 0, res["flux"] / res["flux_err"], nan)
    res["flux_flags"] = flux_flags

    # T = MT / MF with ratio error
    fluxvar_ok = (var_mf > 0) & (var_mt > 0)
    flux_pos = sums[..., mf] > 0
    t_ok = fluxvar_ok & flux_pos
    mf_safe = torch.where(t_ok, sums[..., mf], 1.0)
    res["T"] = torch.where(t_ok, sums[..., mt] / mf_safe, nan)
    T_err = get_ratio_error(
        sums[..., mt], mf_safe, var_mt, var_mf, sums_cov[..., mt, mf]
    )
    res["T_err"] = torch.where(t_ok, T_err, nan)
    res["T_flags"] = torch.where(
        fluxvar_ok,
        torch.where(flux_pos, izero, _flags.NONPOS_FLUX),
        _flags.NONPOS_VAR,
    )

    # full flags
    diag = torch.diagonal(sums_cov, dim1=-2, dim2=-1)
    diag_ok = torch.all(diag > 0, dim=-1)
    res["sums_err"] = torch.where(
        diag_ok[..., None], torch.sqrt(torch.abs(diag)), nan
    )
    flags = torch.where(diag_ok, izero, _flags.NONPOS_VAR)

    T_pos = torch.nan_to_num(res["T"], nan=-1.0) > 0
    e_ok = diag_ok & flux_pos & T_pos
    mt_safe = torch.where(e_ok, sums[..., mt], 1.0)
    e1 = torch.where(e_ok, sums[..., m1] / mt_safe, nan)
    e2 = torch.where(e_ok, sums[..., m2] / mt_safe, nan)
    res["e1"] = e1
    res["e2"] = e2
    res["e"] = torch.stack([e1, e2], dim=-1)
    res["pars"] = torch.stack(
        [sums[..., mv], sums[..., mu], e1, e2, res["T"], res["flux"]], dim=-1
    )

    e1_err = get_ratio_error(
        sums[..., m1], mt_safe, sums_cov[..., m1, m1], var_mt,
        sums_cov[..., m1, mt],
    )
    e2_err = get_ratio_error(
        sums[..., m2], mt_safe, sums_cov[..., m2, m2], var_mt,
        sums_cov[..., m2, mt],
    )
    e_err = torch.stack([e1_err, e2_err], dim=-1)
    e_err_finite = torch.all(torch.isfinite(e_err), dim=-1)
    e_good = e_ok & e_err_finite
    res["e_err"] = torch.where(e_good[..., None], e_err, nan)
    eye = torch.eye(2, dtype=sums.dtype, device=sums.device)
    res["e_cov"] = torch.where(
        e_good[..., None, None],
        eye * (torch.nan_to_num(e_err, nan=0.0) ** 2)[..., None, :],
        nan,
    )

    flags = flags | torch.where(
        diag_ok & flux_pos & T_pos & ~e_err_finite,
        _flags.NONPOS_SHAPE_VAR, izero,
    )
    flags = flags | torch.where(
        diag_ok & flux_pos & ~T_pos, _flags.NONPOS_SIZE, izero
    )
    flags = flags | torch.where(diag_ok & ~flux_pos, _flags.NONPOS_FLUX, izero)
    res["flags"] = flags

    _add_moments_by_name(res, nmom)
    return res


def _add_moments_by_name(res, nmom):
    """add named, flux-normalized moments"""
    sums = res["sums"]
    sums_cov = res["sums_cov"]
    mf = MOMENTS_NAME_MAP["MF"]
    fsum = sums[..., mf]
    fsum_pos = fsum > 0
    fsum_safe = torch.where(fsum_pos, fsum, 1.0)
    fsum_err = torch.sqrt(torch.abs(sums_cov[..., mf, mf]))

    for name, ind in MOMENTS_NAME_MAP.items():
        if ind > nmom - 1:
            continue
        err_name = f"{name}_err"
        if name in ("MF", "M00"):
            res[name] = fsum
            res[err_name] = fsum_err
        else:
            val = torch.where(fsum_pos, sums[..., ind] / fsum_safe, torch.nan)
            err = get_ratio_error(
                sums[..., ind],
                fsum_safe,
                sums_cov[..., ind, ind],
                sums_cov[..., mf, mf],
                sums_cov[..., ind, mf],
            )
            res[name] = val
            res[err_name] = torch.where(fsum_pos, err, torch.nan)


def regularize_mom_shapes(res, fwhm_reg):
    """regularized shapes e = M1,2 / (T + T_reg) of a result dict of
    tensors; fwhm_reg <= 0 returns res"""
    if fwhm_reg <= 0:
        return res

    raw_mom = res["sums"]
    raw_mom_cov = res["sums_cov"]
    T_reg = fwhm_to_T(fwhm_reg)

    amat = torch.eye(6, dtype=raw_mom.dtype, device=raw_mom.device)
    amat[4, 5] = T_reg

    # pre-PSF measures leave the centroid moments NaN: 0 in the
    # transform, NaN again after it
    nan0 = torch.isnan(raw_mom[..., 0])
    nan1 = torch.isnan(raw_mom[..., 1])
    mom_in = raw_mom.clone()
    mom_in[..., 0] = torch.where(nan0, 0.0, raw_mom[..., 0])
    mom_in[..., 1] = torch.where(nan1, 0.0, raw_mom[..., 1])

    reg_mom = torch.einsum("ij,...j->...i", amat, mom_in)
    reg_mom[..., 0] = torch.where(nan0, torch.nan, reg_mom[..., 0])
    reg_mom[..., 1] = torch.where(nan1, torch.nan, reg_mom[..., 1])
    reg_mom_cov = torch.einsum("ij,...jk,lk->...il", amat, raw_mom_cov, amat)

    momres = make_mom_result(reg_mom, reg_mom_cov, sums_norm=res.get("sums_norm"))
    for col in ["T", "T_err", "T_flags"]:
        momres[col] = res[col]
    momres["flags"] = momres["flags"] | res["flags"]
    return momres


def result_to_host(res, index=None):
    """a (possibly batched) result dict of tensors as numpy, one batch
    element of it with index, with the flag strings of 0-d flags"""
    out = {}
    for k, v in res.items():
        a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        if index is not None and a.ndim > 0:
            a = a[index]
        out[k] = a
    for fk in ("flags", "T_flags", "flux_flags"):
        if fk in out and np.ndim(out[fk]) == 0:
            out[fk.replace("flags", "flagstr")] = _flags.get_flags_str(int(out[fk]))
    return out
