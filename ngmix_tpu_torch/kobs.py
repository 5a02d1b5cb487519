"""k-space observation containers: the port of ``ngmix_tpu/kobs.py``.

KObservation, KObsList and KMultiBandObsList, with the k images made by
centered FFTs of the stamps (kops.centered_fft on the observation's
device, in complex128): the DFT of a compact stamp is its continuous
transform on the grid, so no interpolant is involved.

k images are complex numpy arrays in fftshift layout (k = 0 at the
canonical center) with the grid spacing in the ``scale`` attribute.
"""
import numpy as np
import torch

from .jacobian import DiagonalJacobian
from .metacal import kops
from .observation import _HasMetadata, get_mb_obs
from .util import resolve_device

__all__ = [
    "KObservation",
    "KObsList",
    "KMultiBandObsList",
    "make_kobs",
    "make_iilist",
    "get_kmb_obs",
]

DEFAULT_XINTERP = "lanczos15"  # the reference's; unused (exact FFTs)


class KObservation(_HasMetadata):
    """a k-space observation: a complex k image, its weight and an
    optional psf KObservation. The arrays are numpy; a fit of it runs on
    ``device``, the CUDA card unless the caller passes one"""

    def __init__(self, kimage, weight=None, psf=None, meta=None, scale=1.0, device=None):
        self.device = resolve_device(device)
        self._set_image(kimage, scale)
        self._set_weight(weight)
        self.set_psf(psf)
        self._set_jacobian()
        self.set_meta(meta)

    def _set_image(self, kimage, scale):
        kimage = np.asarray(kimage)
        if not np.iscomplexobj(kimage):
            raise ValueError("kimage must be complex")
        self.kimage = kimage
        self.scale = float(scale)

    def _set_weight(self, weight):
        if weight is None:
            weight = np.ones(self.kimage.shape)
        else:
            weight = np.asarray(weight)
            if weight.shape != self.kimage.shape:
                raise ValueError(
                    "weight kimage must have same shape as kimage"
                )
        self.weight = weight

    @property
    def psf(self):
        return self._psf

    def has_psf(self):
        return hasattr(self, "_psf")

    def set_psf(self, psf):
        if self.has_psf():
            del self._psf
        if psf is None:
            return
        assert isinstance(psf, KObservation)
        self._psf = psf
        if psf.kimage.shape != self.kimage.shape:
            raise ValueError("psf kimage must have same shape as kimage")
        assert np.allclose(psf.scale, self.scale)

    def _set_jacobian(self):
        """k = 0 at the canonical center"""
        dims = self.kimage.shape
        cen = np.zeros(2)
        for i in range(2):
            if dims[i] % 2 == 0:
                cen[i] = (dims[i] - 1.0) / 2.0 + 0.5
            else:
                cen[i] = (dims[i] - 1.0) / 2.0
        self.jacobian = DiagonalJacobian(
            scale=self.scale, row=cen[0], col=cen[1]
        )


class KObsList(list, _HasMetadata):
    """a list of KObservations"""

    def __init__(self, meta=None):
        super().__init__()
        self.set_meta(meta)

    def append(self, kobs):
        assert isinstance(kobs, KObservation), (
            "kobs should be of type KObservation, got %s" % type(kobs)
        )
        super().append(kobs)

    def __setitem__(self, index, kobs):
        assert isinstance(kobs, KObservation), (
            "kobs should be of type KObservation"
        )
        super().__setitem__(index, kobs)


class KMultiBandObsList(list, _HasMetadata):
    """a list of KObsLists, one a band"""

    def __init__(self, meta=None):
        super().__init__()
        self.set_meta(meta)

    def append(self, kobs_list):
        assert isinstance(kobs_list, KObsList), (
            "kobs_list should be of type KObsList"
        )
        super().append(kobs_list)

    def __setitem__(self, index, kobs_list):
        assert isinstance(kobs_list, KObsList), (
            "kobs_list should be of type KObsList"
        )
        super().__setitem__(index, kobs_list)


def _kimage_of_obs(image, cen, dim, device):
    """the [dim, dim] centered FFT of a stamp on device, fftshifted: the
    phases are referenced to the jacobian center, so the profile sits at
    the origin; dk = 2 pi / (dim * scale)"""
    img = torch.tensor(np.array(image, dtype="f8"), device=device)
    khat = kops.centered_fft(img, torch.tensor(np.array(cen, dtype="f8"), device=device), dim)
    return np.fft.fftshift(khat.cpu().numpy())


class ExactImageTransform:
    """the stand-in for galsim.InterpolatedImage in make_iilist's 'ii'
    slots: the stamp and its center, whose exact continuous transform
    on any k grid is the centered FFT, computed on ``device`` (the CUDA
    card unless the caller passes one)"""

    def __init__(self, image, cen, scale, device=None):
        self.image = np.asarray(image)
        self.cen = np.asarray(cen, dtype=float)
        self.scale = float(scale)
        self.device = resolve_device(device)

    def kimage(self, dim):
        """the [dim, dim] fftshifted k image; dk = 2 pi / (dim * scale)"""
        return _kimage_of_obs(self.image, self.cen, dim, self.device)

    @property
    def nyquist_scale(self):
        return np.pi / self.scale


def make_iilist(obs, interp=DEFAULT_XINTERP, pad_factor=4):
    """the reference's make_iilist: per band and epoch a dict of the
    "interpolated image" data, and the common (odd) dim and dk. The
    'ii' and 'psf_ii' slots hold ExactImageTransforms,
    'realspace_gsimage' the numpy stamp and 'wcs' the Jacobian; dim
    follows make_kobs's odd-dimension rule. Each transform runs on its
    observation's device."""
    del interp
    mb_obs = get_mb_obs(obs)

    maxdim = 0
    scale_at_max = None
    mb_iilist = []
    for obslist in mb_obs:
        iilist = []
        for o in obslist:
            scale = o.jacobian.scale
            entry = {
                "wcs": o.jacobian,
                "scale": scale,
                "ii": ExactImageTransform(
                    o.image, o.jacobian.get_cen(), scale, device=o.device
                ),
                "weight": o.weight,
                "meta": o.meta,
                "psf_ii": None,
                "psf_weight": None,
                "psf_meta": None,
                "realspace_gsimage": np.asarray(o.image),
            }
            this_dim = max(o.image.shape)
            if o.has_psf():
                psf = o.psf
                entry["psf_ii"] = ExactImageTransform(
                    psf.image / psf.image.sum(),
                    psf.jacobian.get_cen(), psf.jacobian.scale,
                    device=psf.device,
                )
                entry["psf_weight"] = psf.weight
                entry["psf_meta"] = psf.meta
                this_dim = max(this_dim, max(psf.image.shape))
            if this_dim > maxdim:
                maxdim = this_dim
                scale_at_max = scale
            iilist.append(entry)
        mb_iilist.append(iilist)

    dim = kops.good_fft_size(pad_factor * maxdim) + 1  # odd, like galsim
    dk = 2 * np.pi / (dim * scale_at_max)
    return mb_iilist, dim, dk


def make_kobs(mb_obs, interp=DEFAULT_XINTERP, pad_factor=4):
    """real-space observation(s) -> a KMultiBandObsList of one common
    dim and dk, the transforms on each observation's device"""
    del interp
    mb_obs = get_mb_obs(mb_obs)

    # one common (odd) dimension over every band and epoch
    maxdim = 0
    for obslist in mb_obs:
        for obs in obslist:
            maxdim = max(maxdim, max(obs.image.shape))
            if obs.has_psf():
                maxdim = max(maxdim, max(obs.psf.image.shape))
    dim = kops.good_fft_size(pad_factor * maxdim) + 1  # odd, like galsim

    mb_kobs = KMultiBandObsList()
    for obslist in mb_obs:
        kobs_list = KObsList()
        for obs in obslist:
            scale = obs.jacobian.scale
            dk = 2 * np.pi / (dim * scale)
            kimage = _kimage_of_obs(obs.image, obs.jacobian.get_cen(), dim, obs.device)

            useweight = obs.weight.max()
            weight = np.full(kimage.shape, 0.5 * useweight)
            # parseval's theorem
            weight *= 1.0 / weight.size

            if obs.has_psf():
                pimage = obs.psf.image / obs.psf.image.sum()
                psf_kimage = _kimage_of_obs(
                    pimage, obs.psf.jacobian.get_cen(), dim, obs.psf.device)
                psf_useweight = obs.psf.weight.max()
                psf_weight = np.full(kimage.shape, 0.5 * psf_useweight)
                psf_weight *= 1.0 / psf_weight.size
                psf_kobs = KObservation(
                    psf_kimage, weight=psf_weight, meta=dict(obs.psf.meta),
                    scale=dk, device=obs.device,
                )
            else:
                psf_kobs = None

            meta = dict(obs.meta)
            meta["scale"] = scale
            kobs_list.append(
                KObservation(
                    kimage, weight=weight, psf=psf_kobs, meta=meta, scale=dk,
                    device=obs.device,
                )
            )
        mb_kobs.append(kobs_list)
    return mb_kobs


def get_kmb_obs(obs_in):
    """a KObservation or KObsList promoted to a KMultiBandObsList"""
    if isinstance(obs_in, KObservation):
        kobs_list = KObsList()
        kobs_list.append(obs_in)
        obs = KMultiBandObsList()
        obs.append(kobs_list)
    elif isinstance(obs_in, KObsList):
        obs = KMultiBandObsList()
        obs.append(obs_in)
    elif isinstance(obs_in, KMultiBandObsList):
        obs = obs_in
    else:
        raise ValueError(
            "obs should be KObservation, KObsList, or KMultiBandObsList"
        )
    return obs
