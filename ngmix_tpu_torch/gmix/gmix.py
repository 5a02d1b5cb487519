"""Host-facing gaussian mixture classes.

The port of ``ngmix_tpu/gmix/gmix.py`` (GMix, GMixModel, GMixCM,
GMixCoellip, make_gmix_model, gmix_concat) over the dense [n, 6]
layout (p, row, col, irr, irc, icc). A mixture keeps its data as a
float64 numpy array; its fills and summary statistics run on CPU
tensors through gmix.core, and ``to_device(device)`` hands the data to
device code. The pixel evaluations run where their pixels are:
``make_image`` renders through K2 on the card unless the caller passes
device="cpu", and ``get_loglike``, ``fill_fdiff``, ``get_model_s2n*``
and ``get_weighted_moments`` on the device of the observation's pixels.
"""
import numpy as np
import torch

from .. import moments
from ..gexceptions import GMixRangeError
from ..jacobian import Jacobian, UnitJacobian
from ..pixels import make_coords
from ..shape import Shape, _t, e1e2_to_g1g2
from ..util import resolve_device
from . import core, tables
from .tables import (  # noqa: F401  (re-exported registry helpers)
    get_coellip_ngauss,
    get_coellip_npars,
    get_model_name,
    get_model_ngauss,
    get_model_npars,
    get_model_num,
)

__all__ = [
    "GMix",
    "GMixModel",
    "GMixCM",
    "GMixCoellip",
    "gmix_concat",
    "make_gmix_model",
    "get_coellip_npars",
    "get_coellip_ngauss",
    "get_model_num",
    "get_model_name",
    "get_model_ngauss",
    "get_model_npars",
    "get_weighted_moments_stats",
]


def make_gmix_model(pars, model, **kw):
    """create a GMix subclass for the given model name/num"""
    model = get_model_num(model)
    if model == tables.GMIX_COELLIP:
        return GMixCoellip(pars)
    elif model == tables.GMIX_FULL:
        return GMix(pars=pars)
    else:
        return GMixModel(pars, model)


def _check_flags(flags):
    if int(flags) != 0:
        raise GMixRangeError("invalid gmix parameters (flags=%d)" % int(flags))


def _cpu(x):
    """a float64 numpy array (or number) as a CPU tensor"""
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _np(x):
    return x.detach().cpu().numpy()


class GMix(object):
    """A general 2-d gaussian mixture over the dense [n, 6] layout
    (p, row, col, irr, irc, icc)."""

    def __init__(self, ngauss=None, pars=None):
        self._model = tables.GMIX_FULL
        self._model_name = "full"

        if ngauss is None and pars is None:
            raise ValueError("send ngauss= or pars=")

        if pars is not None:
            pars = np.asarray(pars, dtype=np.float64).ravel()
            if pars.size % 6 != 0:
                raise ValueError(
                    "len(pars) must be mutiple of 6 got %s" % pars.size
                )
            self._ngauss = pars.size // 6
            self._npars = pars.size
            self.reset()
            self._fill(pars)
        else:
            self._ngauss = int(ngauss)
            self._npars = 6 * self._ngauss
            self.reset()

    # --- data access ---------------------------------------------------
    def reset(self):
        self._pars = np.zeros(self._npars)
        self._data = np.zeros((self._ngauss, 6))

    def get_data(self):
        """the underlying [n, 6] array (p, row, col, irr, irc, icc)"""
        return self._data

    def to_device(self, device=None, dtype=torch.float64):
        """the [n, 6] data as a tensor of dtype on device: the CUDA card
        unless the caller passes one (util.resolve_device)"""
        return torch.as_tensor(self._data, dtype=dtype, device=resolve_device(device))

    def _on(self, pixels):
        """the data on the device and in the dtype of a pixel struct"""
        return torch.as_tensor(self._data, dtype=pixels.val.dtype, device=pixels.val.device)

    def get_full_pars(self):
        return self._data.reshape(-1).copy()

    def __len__(self):
        return self._ngauss

    # --- filling ---------------------------------------------------------
    def fill(self, pars):
        pars = np.asarray(pars, dtype=np.float64).ravel()
        if pars.size != self._npars:
            raise ValueError(
                "model '%s' requires %s pars, got %s"
                % (self._model_name, self._npars, pars.size)
            )
        self._fill(pars)

    def _fill(self, pars):
        self._pars[:] = pars
        gm, flags = core.gmix_fill(self._model_name, _cpu(self._pars))
        _check_flags(flags)
        self._data[:] = _np(gm)

    # --- summary statistics ---------------------------------------------
    def get_cen(self):
        row, col, _ = core.gmix_get_cen(_cpu(self._data))
        return float(row), float(col)

    def set_cen(self, row, col):
        self._data[:] = _np(core.gmix_set_cen(_cpu(self._data), _cpu(row), _cpu(col)))

    def get_T(self):
        return float(core.gmix_get_T(_cpu(self._data)))

    def get_sigma(self):
        return np.sqrt(self.get_T() / 2.0)

    def get_e1e2T(self):
        e1, e2, T = core.gmix_get_e1e2T(_cpu(self._data))
        e1, e2, T = float(e1), float(e2), float(T)
        if np.isnan(T):
            raise GMixRangeError("T <= 0 or zero psum")
        return e1, e2, T

    def get_g1g2T(self):
        e1, e2, T = self.get_e1e2T()
        g1, g2 = e1e2_to_g1g2(_t(e1), _t(e2))
        return float(g1), float(g2), T

    def get_e1e2sigma(self):
        e1, e2, T = self.get_e1e2T()
        return e1, e2, np.sqrt(T / 2.0)

    def get_g1g2sigma(self):
        g1, g2, T = self.get_g1g2T()
        return g1, g2, np.sqrt(T / 2.0)

    def get_flux(self):
        return float(self._data[:, core.G_P].sum())

    get_psum = get_flux

    def set_flux(self, psum):
        self._data[:] = _np(core.gmix_set_flux(_cpu(self._data), _cpu(psum)))

    set_psum = set_flux

    def scale_T(self, scale):
        """scale the overall T"""
        if scale < 0.0:
            raise ValueError(f"Requested scale {scale} < 0")
        row0, col0 = self.get_cen()
        gm = self._data
        rt = np.sqrt(scale)
        gm[:, core.G_ROW] = (gm[:, core.G_ROW] - row0) * rt + row0
        gm[:, core.G_COL] = (gm[:, core.G_COL] - col0) * rt + col0
        gm[:, core.G_IRR] *= scale
        gm[:, core.G_IRC] *= scale
        gm[:, core.G_ICC] *= scale

    def get_gaussap_flux(self, fwhm=None, sigma=None, T=None):
        """the flux in a round gaussian aperture of the given fwhm,
        sigma or T: per gaussian of covariance M and weight W = sigma^2 I
        the factor 1 / sqrt(1 + T/sigma^2 + det(M)/sigma^4)"""
        if fwhm is not None:
            sigma = float(moments.fwhm_to_sigma(fwhm))
        elif T is not None:
            sigma = np.sqrt(T / 2.0)
        elif sigma is not None:
            sigma = float(sigma)
        else:
            raise ValueError("send weight function sigma, fwhm, or T")

        gm = self._data
        det = gm[:, core.G_IRR] * gm[:, core.G_ICC] - gm[:, core.G_IRC] ** 2
        Ti = gm[:, core.G_IRR] + gm[:, core.G_ICC]
        s2 = sigma * sigma
        good = det > 0
        fac = 1.0 / np.sqrt(1.0 + Ti / s2 + np.where(good, det, 1.0) / (s2 * s2))
        fac = np.where(good, np.minimum(fac, 1.0), 1.0)
        return float(np.sum(gm[:, core.G_P] * fac))

    # --- transforms ------------------------------------------------------
    def copy(self):
        gmix = GMix(ngauss=self._ngauss)
        gmix._data[:] = self._data
        return gmix

    def __copy__(self):
        return self.copy()

    def __deepcopy__(self, memo):
        result = self.copy()
        memo[id(self)] = result
        return result

    def __eq__(self, gm):
        if not isinstance(gm, GMix):
            raise ValueError(f"expected GMix, got {type(gm)}")
        return np.all(self.get_data() == gm.get_data())

    def get_sheared(self, s1, s2=None):
        if isinstance(s1, Shape):
            shear1, shear2 = s1.g1, s1.g2
        elif s2 is not None:
            shear1, shear2 = s1, s2
        else:
            raise ValueError("send a Shape or s1,s2")
        new = self.copy()
        new._data[:] = _np(core.gmix_get_sheared(_cpu(self._data), shear1, shear2))
        return new

    def make_round(self, preserve_size=False):
        gm = self.copy()
        if preserve_size:
            e1, e2, T = gm.get_e1e2T()
            irr, irc, icc = (float(x) for x in moments.e2mom(e1, e2, T))
            mat = np.array([[irr, irc], [irc, icc]])
            eigs = np.linalg.eigvals(mat)
            factor = eigs.max() / (T / 2.0)
            Ti = gm._data[:, core.G_IRR] + gm._data[:, core.G_ICC]
            gm._data[:, core.G_IRC] = 0.0
            gm._data[:, core.G_IRR] = 0.5 * Ti * factor
            gm._data[:, core.G_ICC] = 0.5 * Ti * factor
        else:
            gm._data[:] = _np(core.gmix_make_round(_cpu(self._data)))
        return gm

    def convolve(self, psf):
        if not isinstance(psf, GMix):
            raise TypeError(
                "Can only convolve with another GMix got type %s" % type(psf)
            )
        out = GMix(ngauss=len(self) * len(psf))
        out._data[:] = _np(core.gmix_convolve(_cpu(self._data), _cpu(psf._data)))
        return out

    # --- evaluation --------------------------------------------------------
    def make_image(self, dims, jacobian=None, fast_exp=False, device=None):
        """render into a new [nrows, ncols] numpy image through K2, on
        the CUDA card unless the caller passes a device"""
        dims = np.array(dims, ndmin=1, dtype="i8")
        if dims.size != 2:
            raise ValueError(
                "images must have two dimensions, got %s" % str(dims)
            )
        if jacobian is None:
            cen = (dims - 1.0) / 2.0
            jacobian = UnitJacobian(row=cen[0], col=cen[1])
        elif not isinstance(jacobian, Jacobian):
            raise TypeError("jacobian must be a Jacobian, got %s" % type(jacobian))

        coords = make_coords(tuple(dims), jacobian.to_device(device))
        im = core.render(self.to_device(device), coords, fast=fast_exp)
        return _np(im).reshape(dims[0], dims[1])

    def fill_fdiff(self, obs, fdiff, start=0):
        """fill (model - data) * ierr into the provided flat array"""
        pixels = obs.pixels
        out = _np(core.fill_fdiff(self._on(pixels), pixels))
        fdiff[start:start + out.size] = out

    def get_loglike(self, obs, more=False):
        pixels = obs.pixels
        res = core.get_loglike(self._on(pixels), pixels)
        if more:
            return {
                "loglike": float(res[0]),
                "s2n_numer": float(res[1]),
                "s2n_denom": float(res[2]),
                "npix": int(res[3]),
            }
        return float(res[0])

    def get_model_s2n_sum(self, obs):
        pixels = obs.pixels
        return float(core.get_model_s2n_sum(self._on(pixels), pixels))

    def get_model_s2n(self, obs):
        return np.sqrt(self.get_model_s2n_sum(obs))

    def get_weighted_sums(self, obs, maxrad=None, with_higher_order=False):
        """the weighted sums dict (tensors on the pixels' device)"""
        if maxrad is None:
            maxrad = 100 * np.sqrt(self.get_T() / 2)
        pixels = obs.pixels
        return core.get_weighted_sums(
            self._on(pixels), pixels, maxrad, higher_order=with_higher_order
        )

    def get_weighted_moments(self, obs, maxrad=None, with_higher_order=False):
        res = self.get_weighted_sums(
            obs, maxrad=maxrad, with_higher_order=with_higher_order
        )
        return get_weighted_moments_stats(res)

    def make_galsim_object(self, Tmin=1e-6, gsparams=None):  # pragma: no cover
        """galsim export kept for API parity; requires galsim"""
        import galsim

        if gsparams is not None and not isinstance(gsparams, galsim.GSParams):
            if isinstance(gsparams, dict):
                gsparams = galsim.GSParams(**gsparams)
            else:
                raise TypeError("gsparams must be dict or galsim.GSParams")

        data = self.get_data()
        gsobjects = []
        for i in range(len(self)):
            flux = data[i, core.G_P]
            T = data[i, core.G_IRR] + data[i, core.G_ICC]
            if T == 0:
                T = Tmin
            e1 = (data[i, core.G_ICC] - data[i, core.G_IRR]) / T
            e2 = 2.0 * data[i, core.G_IRC] / T
            g1, g2 = (float(x) for x in e1e2_to_g1g2(_t(e1), _t(e2)))
            Tround = max(float(moments.get_Tround(T, g1, g2)), Tmin)
            gsobj = galsim.Gaussian(
                flux=flux, sigma=np.sqrt(Tround / 2.0), gsparams=gsparams
            )
            gsobj = gsobj.shear(g1=g1, g2=g2)
            gsobj = gsobj.shift(data[i, core.G_COL], data[i, core.G_ROW])
            gsobjects.append(gsobj)
        return galsim.Add(gsobjects)

    def __repr__(self):
        fmt = "p: %.4g row: %.4g col: %.4g irr: %.4g irc: %.4g icc: %.4g"
        return "\n".join(fmt % tuple(row) for row in self._data)


class GMixModel(GMix):
    """mixture from a named model's parameter vector"""

    def __init__(self, pars, model):
        self._model = get_model_num(model)
        self._model_name = get_model_name(self._model)
        self._ngauss = get_model_ngauss(self._model)
        self._npars = get_model_npars(self._model)
        self.reset()
        self.fill(pars)

    def copy(self):
        return GMixModel(self._pars, self._model_name)

    def set_cen(self, row, col):
        super().set_cen(row, col)
        self._pars[0] = row
        self._pars[1] = col


class GMixCM(GMixModel):
    """composite exp+dev model of fixed fracdev and TdByTe"""

    def __init__(self, fracdev, TdByTe, pars):
        self._fracdev = fracdev
        self._TdByTe = TdByTe
        self._Tfactor = float(core.get_cm_Tfactor(_cpu(fracdev), _cpu(TdByTe)))
        super().__init__(pars, "cm")

    def copy(self):
        return GMixCM(self._fracdev, self._TdByTe, self._pars)

    def _fill(self, pars):
        self._pars[:] = pars
        gm, flags = core.fill_cm(_cpu(self._pars), self._fracdev, self._TdByTe)
        _check_flags(flags)
        self._data[:] = _np(gm)

    def __repr__(self):
        rep = super().__repr__()
        return "\n".join(
            ["fracdev: %g" % self._fracdev, "TdByTe:  %g" % self._TdByTe, rep]
        )


class GMixCoellip(GMixModel):
    """co-centric, co-elliptical mixture"""

    def __init__(self, pars):
        self._model = tables.GMIX_COELLIP
        self._model_name = "coellip"
        pars = np.asarray(pars, dtype=np.float64).ravel()
        ncheck = pars.size - 4
        if ncheck % 2 != 0:
            raise ValueError(
                "coellip must have len(pars)==4+2*ngauss, got %s" % pars.size
            )
        self._ngauss = ncheck // 2
        self._npars = pars.size
        self.reset()
        self._fill(pars)

    def copy(self):
        return GMixCoellip(self._pars)


def gmix_concat(gmixes):
    """concatenate GMix objects"""
    if len(gmixes) == 0:
        raise ValueError("send at least one gmix")
    pars = np.concatenate([g.get_full_pars() for g in gmixes])
    return GMix(pars=pars)


def get_weighted_moments_stats(ares):
    """sums dict -> full moments result dict"""
    res = dict(ares)
    res.update(
        moments.make_mom_result(
            res["sums"], res["sums_cov"], sums_norm=res.get("wsum")
        )
    )
    return res
