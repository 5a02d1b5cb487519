"""Observation containers: image + weight + jacobian (+psf, masks, noise).

The port of ``ngmix_tpu/observation.py`` (Observation, ObsList,
MultiBandObsList, MetadataMixin, get_mb_obs):

- one shared ``_as_plane`` validator; the optional image attachments
  (bmask/ormask/noise/mfrac) live in a single dict keyed by name;
- arrays are numpy float64 and handed out as read-only views; mutation
  goes through the ``with obs.writeable():`` scope object, which
  re-derives the cached pixels when the scope closes;
- the cached ``pixels`` attribute is the port's Pixels struct (full
  grid, ierr = 0 masking) on the observation's device, which every
  fitter consumes. The device is the ``device=`` keyword, resolved by
  util.resolve_device: the CUDA card unless the caller passes one (it
  raises with no card). Batch packing across many observations lives
  in batch.py.
"""
import copy as _copy

import numpy as np

from .gmix.gmix import GMix
from .jacobian import Jacobian, UnitJacobian
from .pixels import make_pixels
from .util import resolve_device

__all__ = [
    "Observation",
    "ObsList",
    "MultiBandObsList",
    "MetadataMixin",
    "get_mb_obs",
]

# the optional per-pixel attachments an Observation can carry besides
# image/weight; all share the image's shape
_PLANES = ("bmask", "ormask", "noise", "mfrac")


def _as_plane(name, value, like=None, dtype=None):
    """coerce one per-pixel array to 2-d, checked against the image shape"""
    arr = np.asarray(value) if dtype is None else np.asarray(value, dtype)
    assert arr.ndim == 2, (
        "%s: expected a 2-d array, got ndim=%d" % (name, arr.ndim)
    )
    if like is not None:
        assert arr.shape == like, (
            "%s: shape %s does not match the image's %s"
            % (name, arr.shape, like)
        )
    return arr


class _HasMetadata:
    """mixin: a plain-dict ``meta`` attribute with type checking"""

    @staticmethod
    def _checked_meta(meta):
        if not isinstance(meta, dict):
            raise TypeError(
                "metadata takes a dict; got a %s" % type(meta).__name__
            )
        return meta

    @property
    def meta(self):
        return self._meta

    @meta.setter
    def meta(self, meta):
        self.set_meta(meta)

    def set_meta(self, meta):
        self._meta = self._checked_meta({} if meta is None else meta)

    def update_meta_data(self, meta):
        self._meta.update(self._checked_meta(meta))


# the reference exposes this mixin as a public name
MetadataMixin = _HasMetadata


class _WriteableScope:
    """context manager unlocking an Observation's array views; pixels
    are re-derived once when the scope closes"""

    def __init__(self, obs):
        self._obs = obs

    def __enter__(self):
        self._obs._unlocked = True
        return self._obs

    def __exit__(self, exc_type, exc, tb):
        self._obs._unlocked = False
        self._obs.update_pixels()
        return False


class Observation(_HasMetadata):
    """One image with its weight map, WCS jacobian and optional
    psf / bmask / ormask / noise / mfrac / gmix attachments.

    Views returned by the array properties are read-only; use the
    ``with obs.writeable():`` scope to mutate in place (the device
    pixel cache refreshes on exit). The stamp shape is fixed at
    construction. The pixels live on ``device``: the CUDA card unless
    the caller passes one.
    """

    def __init__(
        self,
        image,
        weight=None,
        bmask=None,
        ormask=None,
        noise=None,
        jacobian=None,
        gmix=None,
        psf=None,
        meta=None,
        mfrac=None,
        store_pixels=True,
        ignore_zero_weight=True,
        device=None,
    ):
        self._device = resolve_device(device)
        self._unlocked = False
        self._planes = {}
        self._ignore_zero_weight = ignore_zero_weight
        self._store_pixels = store_pixels

        self.set_image(image, update_pixels=False)
        self.set_weight(weight, update_pixels=False)
        self.set_jacobian(jacobian, update_pixels=False)
        self.update_pixels()

        self.set_meta(meta)
        for name, value in (
            ("bmask", bmask), ("ormask", ormask),
            ("noise", noise), ("mfrac", mfrac),
        ):
            self._set_plane(name, value)
        self.set_gmix(gmix)
        self.set_psf(psf)

    # --- the attachment-plane machinery --------------------------------
    def _view(self, arr):
        out = arr.view()
        out.flags["WRITEABLE"] = self._unlocked
        return out

    def _set_plane(self, name, value):
        if value is None:
            self._planes.pop(name, None)
        else:
            self._planes[name] = _as_plane(
                name, value, like=self._image.shape
            )

    def _get_plane(self, name):
        try:
            return self._view(self._planes[name])
        except KeyError:
            raise AttributeError(
                "no %s attached to this observation" % name
            ) from None

    def _has_plane(self, name):
        return name in self._planes

    # --- image / weight / jacobian -------------------------------------
    @property
    def image(self):
        return self._view(self._image)

    @image.setter
    def image(self, image):
        self.set_image(image)

    def set_image(self, image, update_pixels=True):
        new = _as_plane("image", image, dtype="f8")
        prev = getattr(self, "_image", None)
        assert prev is None or new.shape == prev.shape, (
            "an Observation's stamp shape is fixed at construction; "
            "cannot replace a %s image with a %s one"
            % (prev.shape if prev is not None else None, new.shape)
        )
        self._image = new
        if update_pixels:
            self.update_pixels()

    @property
    def weight(self):
        return self._view(self._weight)

    @weight.setter
    def weight(self, weight):
        self.set_weight(weight)

    def set_weight(self, weight, update_pixels=True):
        if weight is None:
            self._weight = np.ones_like(self._image)
        else:
            self._weight = _as_plane(
                "weight", weight, like=self._image.shape, dtype="f8"
            )
        if update_pixels:
            self.update_pixels()

    @property
    def jacobian(self):
        return self.get_jacobian()

    @jacobian.setter
    def jacobian(self, jacobian):
        self.set_jacobian(jacobian)

    def set_jacobian(self, jacobian, update_pixels=True):
        if jacobian is None:
            # center a unit WCS on the stamp
            r0, c0 = (np.array(self._image.shape) - 1.0) / 2.0
            self._jacobian = UnitJacobian(row=r0, col=c0)
        else:
            assert isinstance(jacobian, Jacobian), (
                "set_jacobian takes a Jacobian; got a %s"
                % type(jacobian).__name__
            )
            self._jacobian = jacobian.copy()
        if update_pixels:
            self.update_pixels()

    def get_jacobian(self):
        return self._jacobian.copy()

    # --- optional planes ------------------------------------------------
    @property
    def bmask(self):
        return self._get_plane("bmask")

    @bmask.setter
    def bmask(self, bmask):
        self._set_plane("bmask", bmask)

    def set_bmask(self, bmask):
        self._set_plane("bmask", bmask)

    def has_bmask(self):
        return self._has_plane("bmask")

    @property
    def ormask(self):
        return self._get_plane("ormask")

    @ormask.setter
    def ormask(self, ormask):
        self._set_plane("ormask", ormask)

    def set_ormask(self, ormask):
        self._set_plane("ormask", ormask)

    def has_ormask(self):
        return self._has_plane("ormask")

    @property
    def noise(self):
        return self._get_plane("noise")

    @noise.setter
    def noise(self, noise):
        self._set_plane("noise", noise)

    def set_noise(self, noise):
        self._set_plane("noise", noise)

    def has_noise(self):
        return self._has_plane("noise")

    @property
    def mfrac(self):
        return self._get_plane("mfrac")

    @mfrac.setter
    def mfrac(self, mfrac):
        self._set_plane("mfrac", mfrac)

    def set_mfrac(self, mfrac):
        self._set_plane("mfrac", mfrac)

    def has_mfrac(self):
        return self._has_plane("mfrac")

    # --- psf / gmix -----------------------------------------------------
    @property
    def psf(self):
        return getattr(self, "_psf", None)

    @psf.setter
    def psf(self, psf):
        self.set_psf(psf)

    def set_psf(self, psf):
        if psf is None:
            if self.has_psf():
                del self._psf
            return
        assert isinstance(psf, Observation), (
            "the psf attachment must itself be an Observation; got a %s"
            % type(psf).__name__
        )
        self._psf = psf

    def get_psf(self):
        if not self.has_psf():
            raise RuntimeError("psf requested but none is attached")
        return self._psf

    def has_psf(self):
        return getattr(self, "_psf", None) is not None

    def get_psf_gmix(self):
        if not self.has_psf_gmix():
            raise RuntimeError(
                "psf gmix requested but the psf has no fitted mixture"
            )
        return self._psf.get_gmix()

    def has_psf_gmix(self):
        return self.has_psf() and self._psf.has_gmix()

    @property
    def gmix(self):
        return self.get_gmix()

    @gmix.setter
    def gmix(self, gmix):
        self.set_gmix(gmix)

    def set_gmix(self, gmix):
        if gmix is None:
            if self.has_gmix():
                del self._gmix
            return
        assert isinstance(gmix, GMix), (
            "set_gmix takes a GMix; got a %s" % type(gmix).__name__
        )
        self._gmix = gmix.copy()

    def get_gmix(self):
        if not self.has_gmix():
            raise RuntimeError("gmix requested but none is attached")
        return self._gmix.copy()

    def has_gmix(self):
        return getattr(self, "_gmix", None) is not None

    # --- statistics -----------------------------------------------------
    def get_s2n_sums(self):
        """(sum(image), sum(1/weight), npix) over positive-weight pixels"""
        sel = self._weight > 0
        n = int(np.count_nonzero(sel))
        if n == 0:
            return 0.0, 0.0, 0
        return (
            float(self._image[sel].sum()),
            float((1.0 / self._weight[sel]).sum()),
            n,
        )

    def get_s2n(self):
        """simple flux S/N: sum(I) / sqrt(sum(1/w)); -9999 if empty"""
        isum, vsum, _ = self.get_s2n_sums()
        return isum / np.sqrt(vsum) if vsum > 0 else -9999.0

    # --- copying / equality ---------------------------------------------
    def copy(self, memo=None):
        planes = {k: v.copy() for k, v in self._planes.items()}
        return Observation(
            self._image.copy(),
            weight=self._weight.copy(),
            jacobian=self._jacobian,
            gmix=self._gmix if self.has_gmix() else None,
            psf=self._psf.copy() if self.has_psf() else None,
            meta=_copy.deepcopy(self._meta, memo=memo),
            store_pixels=self._store_pixels,
            ignore_zero_weight=self._ignore_zero_weight,
            device=self._device,
            **planes,
        )

    def __copy__(self):
        return self.copy()

    def __deepcopy__(self, memo):
        out = self.copy(memo=memo)
        memo[id(self)] = out
        return out

    def _eq_parts(self):
        """the components that participate in equality"""
        parts = {"image": self._image, "weight": self._weight,
                 "jacobian": self._jacobian}
        parts.update(self._planes)
        if self.has_gmix():
            parts["gmix"] = self._gmix
        if self.has_psf():
            parts["psf"] = self._psf
        return parts

    def __eq__(self, other):
        if not isinstance(other, Observation):
            raise ValueError(
                "cannot compare an Observation with a %s"
                % type(other).__name__
            )
        if self.meta != other.meta:
            return False
        a, b = self._eq_parts(), other._eq_parts()
        if a.keys() != b.keys():
            return False
        for key, val in a.items():
            if isinstance(val, np.ndarray):
                if not np.array_equal(val, b[key]):
                    return False
            elif val != b[key]:
                return False
        return True

    # --- device pixels --------------------------------------------------
    @property
    def device(self):
        """the torch.device of the pixels"""
        return self._device

    @property
    def pixels(self):
        """Pixels struct on the observation's device (rebuilt on
        mutation, never mutated in place)"""
        return self._pixels

    @property
    def store_pixels(self):
        return self._store_pixels

    @store_pixels.setter
    def store_pixels(self, store_pixels):
        changed = store_pixels != self._store_pixels
        self._store_pixels = store_pixels
        if changed:
            self.update_pixels()

    @property
    def ignore_zero_weight(self):
        return self._ignore_zero_weight

    @ignore_zero_weight.setter
    def ignore_zero_weight(self, ignore_zero_weight):
        changed = ignore_zero_weight != self._ignore_zero_weight
        self._ignore_zero_weight = ignore_zero_weight
        if changed:
            self.update_pixels()

    def update_pixels(self):
        """re-derive the device Pixels struct from the current arrays"""
        if not self._store_pixels:
            self._pixels = None
            return
        self._pixels = make_pixels(
            self._image,
            self._weight,
            self._jacobian.to_device(self._device),
            ignore_zero_weight=self._ignore_zero_weight,
        )

    def writeable(self):
        """scope that unlocks the array views for in-place mutation"""
        return _WriteableScope(self)

    # the reference allows ``with obs.writeable():`` where writeable()
    # returns the obs itself; support entering the obs directly too
    def __enter__(self):
        self._unlocked = True
        return self

    def __exit__(self, exc_type, exc, tb):
        self._unlocked = False
        self.update_pixels()
        return False


class _TypedList(list, _HasMetadata):
    """list restricted to one element type, with metadata and pooled
    S/N sums; base for the band/epoch containers"""

    _element_type = None

    def __init__(self, meta=None):
        super().__init__()
        self.set_meta(meta)

    def _checked(self, item):
        assert isinstance(item, self._element_type), (
            "%s holds %s elements; got a %s"
            % (
                type(self).__name__,
                self._element_type.__name__,
                type(item).__name__,
            )
        )
        return item

    def append(self, item):
        super().append(self._checked(item))

    def __setitem__(self, index, item):
        super().__setitem__(index, self._checked(item))

    def get_s2n_sums(self):
        isum = vsum = 0.0
        npix = 0
        for member in self:
            mi, mv, mn = member.get_s2n_sums()
            isum += mi
            vsum += mv
            npix += mn
        return isum, vsum, npix

    def get_s2n(self):
        isum, vsum, _ = self.get_s2n_sums()
        return isum / np.sqrt(vsum) if vsum > 0 else -9999.0

    def copy(self, memo=None):
        out = type(self)(meta=_copy.deepcopy(self._meta, memo))
        for member in self:
            out.append(member.copy(memo=memo))
        return out

    def __copy__(self):
        return self.copy()

    def __deepcopy__(self, memo):
        out = self.copy(memo=memo)
        memo[id(self)] = out
        return out

    def __eq__(self, other):
        if not isinstance(other, type(self)):
            raise ValueError(
                "cannot compare a %s with a %s"
                % (type(self).__name__, type(other).__name__)
            )
        return len(self) == len(other) and all(
            a == b for a, b in zip(self, other)
        )


class ObsList(_TypedList):
    """the epochs of one band"""

    _element_type = Observation


class MultiBandObsList(_TypedList):
    """one ObsList per band"""

    _element_type = ObsList


def get_mb_obs(obs_in):
    """wrap an Observation or ObsList up to a MultiBandObsList"""
    if isinstance(obs_in, MultiBandObsList):
        return obs_in
    if isinstance(obs_in, Observation):
        obslist = ObsList()
        obslist.append(obs_in)
    elif isinstance(obs_in, ObsList):
        obslist = obs_in
    else:
        raise ValueError(
            "get_mb_obs takes an Observation, ObsList or "
            "MultiBandObsList; got a %s" % type(obs_in).__name__
        )
    mbobs = MultiBandObsList()
    mbobs.append(obslist)
    return mbobs


# the k-space containers live in kobs.py and are re-exported here, as in
# the reference's namespace; the import sits at the bottom because kobs
# imports the classes above
from .kobs import (  # noqa: E402,F401
    DEFAULT_XINTERP,
    KMultiBandObsList,
    KObservation,
    KObsList,
    get_kmb_obs,
    make_iilist,
    make_kobs,
)

__all__ += [
    "KObservation",
    "KObsList",
    "KMultiBandObsList",
    "make_kobs",
    "make_iilist",
    "get_kmb_obs",
]
