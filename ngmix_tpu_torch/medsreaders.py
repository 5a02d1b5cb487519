"""MEDS survey-cutout readers that build the port's Observations: the
port of ``ngmix_tpu/medsreaders.py``.

Reading a MEDS file needs the optional ``meds`` package: without it
this module imports, and constructing ``NGMixMEDS`` raises
``ImportError``. ``NGMixMEDSMixin`` builds Observations over any
object with the MEDS raw-access interface (``meds.MEDS``, or an
in-memory stand-in). Each Observation's pixels go to the CUDA card
unless ``device="cpu"`` is passed to the getters or set as the
reader's ``device`` attribute.
"""
import logging
import os

import numpy as np

from .gexceptions import GMixFatalError
from .jacobian import Jacobian
from .observation import MultiBandObsList, Observation, ObsList

logger = logging.getLogger(__name__)

try:
    from meds import MEDS as _MEDS

    HAVE_MEDS = True
except ImportError:
    HAVE_MEDS = False

    class _MEDS(object):
        def __init__(self, *args, **kw):
            raise ImportError("the `meds` package is required for NGMixMEDS; it is an "
                              "optional dependency")


class MultiBandNGMixMEDS(object):
    """NGMixMEDS readers of several bands, one a band (ref:
    medsreaders.py:36-60); device: where the Observations' pixels go,
    None for the CUDA card"""

    def __init__(self, mlist, device=None):
        self.mlist = mlist
        self.device = device

    @property
    def nband(self):
        return len(self.mlist)

    @property
    def size(self):
        return self.mlist[0].size

    def get_mbobs_list(self, indices=None, weight_type="weight"):
        if indices is None:
            indices = np.arange(self.mlist[0].size)
        return [self.get_mbobs(iobj, weight_type=weight_type) for iobj in indices]

    def get_mbobs(self, iobj, weight_type="weight"):
        mbobs = MultiBandObsList()
        for m in self.mlist:
            mbobs.append(m.get_obslist(iobj, weight_type=weight_type, device=self.device))
        return mbobs


class NGMixMEDSMixin(object):
    """Observations from a MEDS-interface provider (ref:
    medsreaders.py:63-184): the base supplies ``_cat``, ``get_cutout``,
    ``get_jacobian``, ``get_image_info``, ``get_psf`` / ``has_psf`` and
    the weight builders (``get_uberseg``, ``get_cweight_cutout``,
    ``get_cseg_weight``). A getter's device None takes the reader's
    ``device`` attribute, None for the CUDA card."""

    device = None

    def _device(self, device):
        return self.device if device is None else device

    def get_obslist(self, iobj, weight_type="weight", device=None):
        obslist = ObsList()
        for icut in range(self._cat["ncutout"][iobj]):
            try:
                obslist.append(self.get_obs(iobj, icut, weight_type=weight_type,
                                            device=device))
            except GMixFatalError:
                logger.debug("zero weight observation found, skipping")
        if len(obslist) > 0:
            obs = obslist[0]
            if "flux" in obs.meta:
                obslist.meta["flux"] = obs.meta["flux"]
            if "T" in obs.meta:
                obslist.meta["T"] = obs.meta["T"]
        return obslist

    def get_ngmix_jacobian(self, iobj, icutout):
        jd = self.get_jacobian(iobj, icutout)
        return Jacobian(row=jd["row0"], col=jd["col0"], dudrow=jd["dudrow"],
                        dudcol=jd["dudcol"], dvdrow=jd["dvdrow"], dvdcol=jd["dvdcol"])

    def get_obs(self, iobj, icutout, weight_type="weight", device=None):
        im = self.get_cutout(iobj, icutout, type="image")

        def _try(type_):
            try:
                return self.get_cutout(iobj, icutout, type=type_)
            except Exception:
                return None

        bmask = _try("bmask")
        ormask = _try("ormask")
        noise = _try("noise")
        mfrac = _try("mfrac")

        if weight_type == "uberseg":
            wt = self.get_uberseg(iobj, icutout)
        elif weight_type == "cweight":
            wt = self.get_cweight_cutout(iobj, icutout, restrict_to_seg=True)
        elif weight_type == "weight":
            wt = self.get_cutout(iobj, icutout, type="weight")
        elif weight_type == "cseg":
            wt = self.get_cseg_weight(iobj, icutout)
        elif weight_type == "cseg-canonical":
            wt = self.get_cseg_weight(iobj, icutout, use_canonical_cen=True)
        else:
            raise ValueError("bad weight type '%s'" % weight_type)

        jacobian = self.get_ngmix_jacobian(iobj, icutout)
        c = self._cat
        ii = self.get_image_info()
        file_id = c["file_id"][iobj, icutout]
        file_path = os.path.basename(ii["image_path"][file_id]).strip()
        meta = dict(
            id=c["id"][iobj],
            index=iobj,
            icut=icutout,
            cutout_index=icutout,
            file_id=file_id,
            file_path=file_path,
            orig_row=c["orig_row"][iobj, icutout],
            orig_col=c["orig_col"][iobj, icutout],
            orig_start_row=c["orig_start_row"][iobj, icutout],
            orig_start_col=c["orig_start_col"][iobj, icutout],
            scale=ii["scale"][file_id],
        )
        if "flux_auto" in c.dtype.names:
            meta["flux"] = c["flux_auto"][iobj]
        if "x2" in c.dtype.names and "y2" in c.dtype.names:
            meta["T"] = c["x2"][iobj] + c["y2"][iobj]
        if "number" in c.dtype.names:
            meta["number"] = c["number"][iobj]

        device = self._device(device)
        psf_obs = self.get_psf_obs(iobj, icutout, device=device) if self.has_psf() else None
        return Observation(im, weight=wt, bmask=bmask, ormask=ormask, noise=noise, meta=meta,
                           jacobian=jacobian, psf=psf_obs, mfrac=mfrac, device=device)

    def get_psf_obs(self, iobj, icutout, device=None):
        psf_im = self.get_psf(iobj, icutout)
        noise = psf_im.max() / 1000.0
        weight = psf_im * 0 + 1.0 / noise**2
        jacobian = self.get_ngmix_jacobian(iobj, icutout)
        row, col = self._get_psf_cen(iobj, icutout)
        jacobian.set_cen(row=row, col=col)
        return Observation(psf_im, weight=weight, jacobian=jacobian,
                           device=self._device(device))

    def _get_psf_cen(self, iobj, icutout):
        c = self._cat
        return c["psf_cutout_row"][iobj, icutout], c["psf_cutout_col"][iobj, icutout]


class NGMixMEDS(NGMixMEDSMixin, _MEDS):
    """a MEDS file reader that builds Observations"""
