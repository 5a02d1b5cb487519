"""Metacal image engine of the host API: deconvolve, shear, reconvolve.

The port of ``ngmix_tpu/metacal/metacal.py`` over the port's k-space
operations (kops.py):

    I_t(x) = IFFT[ (I(k)/P(k))(M_s k) * T(k) ]

with M_s the shear's k-domain matrix mapped through the WCS, P the
pixel-convolved psf transform and T the target psf (a round gaussian
for the gauss, azgauss, fitgauss and analytic variants, the dilated
original psf times the pixel for the dilate variant).

One observation at a time on its device (the CUDA card unless it was
made with device="cpu"): the transforms, the deconvolution and the
remaps run in complex128 on a grid of N = good_fft_size(4 max(dims)),
with the matrix products in full float64 (no TF32). The images come
back as numpy arrays in new Observations.
"""
import copy
import logging

import numpy as np
import torch

from ..shape import Shape
from ..util import full_precision_matmuls
from . import kops
from .defaults import DEFAULT_STEP, METACAL_MINIMAL_TYPES, METACAL_TYPES

__all__ = [
    "MetacalDilatePSF",
    "MetacalAzGaussPSF",
    "MetacalGaussPSF",
    "MetacalFitGaussPSF",
    "MetacalAnalyticPSF",
]

logger = logging.getLogger(__name__)


def _check_shape(shape):
    if not isinstance(shape, Shape):
        raise TypeError("shape must be of type ngmix_tpu_torch.Shape")


def _dilation(shear):
    """dilation = 1 + 2|g|"""
    g = np.sqrt(shear.g1**2 + shear.g2**2)
    return 1.0 + 2.0 * g


class _KData(object):
    """the k-space data of one observation: the image and psf transforms,
    the deconvolved object and the pixel response, on the observation's
    device in complex128"""

    def __init__(self, obs):
        self.obs = obs
        if not obs.has_psf():
            raise ValueError("observation must have a psf observation set")

        im = obs.image
        psf_im = obs.psf.image
        jac = obs.jacobian
        psf_jac = obs.psf.jacobian

        # one k grid for the image and the psf: they must share the WCS
        # matrix (true for all survey stamps)
        m1 = np.array([[jac.dvdrow, jac.dvdcol], [jac.dudrow, jac.dudcol]])
        m2 = np.array(
            [[psf_jac.dvdrow, psf_jac.dvdcol],
             [psf_jac.dudrow, psf_jac.dudcol]]
        )
        if not np.allclose(m1, m2, rtol=1.0e-6):
            raise ValueError(
                "image and psf observations must share the same WCS "
                "matrix for the k-space metacal pipeline"
            )

        full_precision_matmuls()
        self.device = obs.device
        self.jac = jac
        self.dims = im.shape
        self.psf_dims = psf_im.shape
        self.N = kops.good_fft_size(4 * max(max(im.shape), max(psf_im.shape)))

        def dev(x):
            return torch.tensor(np.array(x, dtype="f8"), device=self.device)

        self.imhat = kops.centered_fft(dev(im), dev(jac.get_cen()), self.N)
        self.psfhat = kops.centered_fft(dev(psf_im), dev(psf_jac.get_cen()), self.N)
        # the psf at unit flux, so the deconvolution keeps the image's flux
        psfhat_n = self.psfhat / self.psfhat[0, 0].real
        self.objhat = kops.deconvolve_k(self.imhat, psfhat_n)
        self.pix = kops.pixel_kresponse(self.N, device=self.device)
        self.psf_flux = float(np.sum(psf_im))

    def sheared_objhat(self, shear):
        """the object transform resampled at the sheared k points"""
        S = kops.shear_matrix(shear.g1, shear.g2)
        M = kops.kmap_matrix(self.jac, S)
        return kops.remap_k(self.objhat, M)

    def render(self, khat, dims, cen):
        cen = torch.tensor(np.array(cen, dtype="f8"), device=self.device)
        return kops.centered_ifft(khat, cen, dims).cpu().numpy()


class MetacalDilatePSF(object):
    """metacal with the dilated original psf as the reconvolution target
    (ref: ngmix_tpu/metacal/metacal.py: MetacalDilatePSF)"""

    def __init__(self, obs):
        self.obs = obs
        self.kdata = _KData(obs)
        self._psf_cache = {}

    types_default = METACAL_TYPES

    def get_all(self, step=DEFAULT_STEP, types=None):
        """the metacal image dict"""
        if types is None:
            types = copy.deepcopy(self.types_default)
        else:
            for t in types:
                assert t in self.types_default, "bad metacal type: %s" % t

        if "noshear" in types and "1p" not in types:
            types.append("1p")

        shdict = {
            "1m": Shape(-step, 0.0),
            "1p": Shape(+step, 0.0),
            "2m": Shape(0.0, -step),
            "2p": Shape(0.0, +step),
        }
        for key in list(shdict.keys()):
            shdict["%s_psf" % key] = shdict[key].copy()

        odict = {}
        for type_ in types:
            if type_ == "noshear":
                continue
            sh = shdict[type_]
            if "psf" in type_:
                obs = self.get_obs_psfshear(sh)
            else:
                if type_ == "1p":
                    obs, obs_noshear = self.get_obs_galshear(
                        sh, get_unsheared=True
                    )
                    odict["noshear"] = obs_noshear
                else:
                    obs = self.get_obs_galshear(sh)
            odict[type_] = obs
        return {k: odict[k] for k in types if k in odict}

    def get_obs_galshear(self, shear, get_unsheared=False):
        """the sheared-galaxy observation"""
        _check_shape(shear)
        newpsf_image, that = self.get_target_psf(shear, "gal_shear")

        sheared_objhat = self.kdata.sheared_objhat(shear)
        sheared_image = self._draw_image(sheared_objhat * that)
        newobs = self._make_obs(sheared_image, newpsf_image)

        if get_unsheared:
            unsheared_image = self._draw_image(self.kdata.objhat * that)
            uobs = self._make_obs(unsheared_image, newpsf_image)
            return newobs, uobs
        return newobs

    def get_obs_psfshear(self, shear):
        """the sheared-psf observation"""
        _check_shape(shear)
        newpsf_image, that = self.get_target_psf(shear, "psf_shear")
        conv_image = self._draw_image(self.kdata.objhat * that)
        return self._make_obs(conv_image, newpsf_image)

    def get_target_psf(self, shear, type_):
        """the target psf image and k transform, cached a shear"""
        _check_shape(shear)
        doshear = type_ == "psf_shear"
        key = "%s-%s-%s" % (doshear, shear.g1, shear.g2)
        if key not in self._psf_cache:
            that = self._get_dilated_psf_k(shear, doshear=doshear)
            psf_image = self._draw_psf_image(that)
            self._psf_cache[key] = (psf_image, that)
        psf_image, that = self._psf_cache[key]
        return psf_image.copy(), that

    def _get_dilated_psf_k(self, shear, doshear=False):
        """the k transform of the dilated (and possibly sheared) original
        psf, reconvolved by the pixel"""
        kd = self.kdata
        psf_flux = kd.psfhat[0, 0].real
        pix = torch.where(torch.abs(kd.pix) > 1e-8, kd.pix, 1e-8)
        psf_nopix = kd.psfhat / pix / psf_flux

        d = _dilation(shear)
        M = np.eye(2) * d
        if doshear:
            S = kops.shear_matrix(shear.g1, shear.g2)
            M = kops.kmap_matrix(kd.jac, S) @ M
        dilated = kops.remap_k(psf_nopix, M)
        return dilated * kd.pix

    def _draw_image(self, khat):
        kd = self.kdata
        return kd.render(khat, kd.dims, kd.obs.jacobian.get_cen())

    def _draw_psf_image(self, that):
        kd = self.kdata
        return kd.render(that * kd.psf_flux, kd.psf_dims, kd.obs.psf.jacobian.get_cen())

    def _make_psf_obs(self, psf_im):
        new_psf_obs = self.obs.psf.copy()
        with new_psf_obs.writeable():
            new_psf_obs.image[:, :] = psf_im
        return new_psf_obs

    def _make_obs(self, im, psf_im):
        newobs = self.obs.copy()
        with newobs.writeable():
            newobs.image[:, :] = im
        newobs.psf = self._make_psf_obs(psf_im)
        return newobs


class MetacalAzGaussPSF(MetacalDilatePSF):
    """a round gaussian target from the azimuthally averaged k profile
    of the psf (ref: ngmix_tpu/metacal/metacal.py: MetacalAzGaussPSF)"""

    types_default = METACAL_MINIMAL_TYPES

    def __init__(self, obs, rng=None):
        super().__init__(obs=obs)
        self.rng = rng
        self._setup_psf_noise()

    def _setup_psf_noise(self):
        pim = self.obs.psf.image
        self.psf_flux = pim.sum()
        self.psf_noise = pim.max() / 50000.0
        if self.rng is not None:
            self.psf_noise_image = self.rng.normal(
                size=pim.shape, scale=self.psf_noise
            )
        else:
            self.psf_noise_image = None
        self.psf_weight = pim * 0 + 1.0 / self.psf_noise**2

    def _get_target_sigma(self):
        kd = self.kdata
        ksq = kops.sky_ksq(kd.N, kd.jac, device=kd.device)
        return float(kops.azgauss_target_sigma(kd.psfhat[None], ksq, nbin=kd.N)[0])

    def _get_dilated_psf_k(self, shear, doshear=False):
        assert doshear is False, "no shearing gauss psf"
        if not hasattr(self, "_target_sigma"):
            self._target_sigma = self._get_target_sigma()
        kd = self.kdata
        sigma = self._target_sigma * _dilation(shear)
        # no pixel factor: the gaussian-target modes never reconvolve
        # the pixel, whose sky-projected anisotropy would otherwise leak
        # into <e> under a non-diagonal WCS
        return kops.gauss_kprofile(kd.N, kd.jac, sigma, device=kd.device)

    def _make_psf_obs(self, psf_im):
        if self.psf_noise_image is not None:
            psf_im = psf_im + self.psf_noise_image
        new_psf_obs = self.obs.psf.copy()
        with new_psf_obs.writeable():
            new_psf_obs.image[:, :] = psf_im
            new_psf_obs.weight[:, :] = self.psf_weight
            cen = (np.array(psf_im.shape) - 1.0) / 2.0
            new_psf_obs.jacobian.set_cen(row=cen[0], col=cen[1])
        return new_psf_obs

    def _draw_psf_image(self, that):
        """the analytic gaussian psf drawn at the exact stamp center"""
        kd = self.kdata
        cen = (np.array(kd.psf_dims) - 1.0) / 2.0
        return kd.render(that * kd.psf_flux, kd.psf_dims, cen)


class MetacalGaussPSF(MetacalAzGaussPSF):
    """a round gaussian target from per-pixel k-power pinning
    (ref: ngmix_tpu/metacal/metacal.py: MetacalGaussPSF)"""

    def _get_target_sigma(self):
        kd = self.kdata
        ksq = kops.sky_ksq(kd.N, kd.jac, device=kd.device)
        return float(kops.gauss_target_sigma(kd.psfhat, ksq))


class MetacalFitGaussPSF(MetacalGaussPSF):
    """a round gaussian target from a gaussian fit to the psf
    (ref: ngmix_tpu/metacal/metacal.py: MetacalFitGaussPSF): adaptive
    moments through K2, falling back to Fitter("gauss") through K3"""

    def __init__(self, obs, rng=None):
        if rng is None:
            raise ValueError("send an rng to MetacalFitGaussPSF")
        super().__init__(obs=obs, rng=rng)

    def _get_target_sigma(self):
        from .fitgauss_target_psf import get_fitgauss_target_T

        T = get_fitgauss_target_T(self.obs.psf, rng=self.rng)
        return np.sqrt(T / 2.0)


class MetacalAnalyticPSF(MetacalGaussPSF):
    """an input round gaussian as the reconvolution kernel: a gaussian
    sky sigma or a GMix (whose T gives the sigma)"""

    def __init__(self, obs, psf, rng=None):
        from ..gmix.gmix import GMix

        if isinstance(psf, GMix):
            sigma = np.sqrt(psf.get_T() / 2.0)
        elif np.isscalar(psf):
            sigma = float(psf)
        else:
            raise ValueError(
                "psf must be a GMix or a gaussian sigma (sky units)"
            )
        self._analytic_sigma = sigma
        super().__init__(obs=obs, rng=rng)

    def _get_target_sigma(self):
        return self._analytic_sigma


# the reference's toggles for its caches; the port caches its host-built
# constants per grid and device (kops), so these do nothing

def turn_on_galsim_caching():
    pass


def turn_off_galsim_caching():
    pass
