"""Carry state over from the JAX package.

This system has no weights. Its state is the pipeline configuration
and the arrays that go in: the MetacalConfig, LMConf, AdmomConf and
EMConf fields (the plain dict that a NamedTuple's ``_asdict()``
gives, or the attributes of a plain configuration object), the LM
priors with their generators' states (``prior_from_object``), mixtures and pixel planes as numpy
arrays, and the host data model: observations (with their psf and
attachments, in their lists), jacobians and mixtures
(``observation_from_object``, ``jacobian_from_object``,
``gmix_from_object``). Nothing here imports JAX or the JAX package:
objects are read through their attributes and numpy, by class name.
"""
import copy

import numpy as np
import torch

from . import joint_prior, priors
from .admom import AdmomConf
from .batch import MetacalConfig
from .em import EMConf
from .fitting.lm import LMConf
from .gmix.gmix import GMix, GMixCM, GMixCoellip, GMixModel
from .jacobian import Jacobian
from .observation import MultiBandObsList, Observation, ObsList
from .pixels import Pixels


def _from_fields(cls, fields):
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    kw = {}
    for k, v in fields.items():
        if k not in cls._fields:
            raise ValueError("%s has no field %r" % (cls.__name__, k))
        kw[k] = tuple(v) if isinstance(v, list) else v
    return cls(**kw)


def config_from_fields(fields):
    """a MetacalConfig from another package's config fields (a dict, or
    any object with ``_asdict()``); tuples stay tuples"""
    return _from_fields(MetacalConfig, fields)


def lm_conf_from_fields(fields):
    """an LMConf from another package's LM config fields, read like
    config_from_fields"""
    return _from_fields(LMConf, fields)


def admom_conf_from_fields(fields):
    """an AdmomConf from a dict of its fields or from another package's
    admom configuration object, read through its attributes (maxiter,
    shiftmax, etol, Ttol, cenonly)"""
    if not isinstance(fields, dict):
        fields = {k: getattr(fields, k) for k in AdmomConf._fields}
    return _from_fields(AdmomConf, fields)


def em_conf_from_fields(fields):
    """an EMConf from a dict of its fields or from another package's EM
    configuration object, read through its attributes (mode, miniter,
    maxiter, tol, vary_sky, fill_zero_weight)"""
    if not isinstance(fields, dict):
        fields = {k: getattr(fields, k) for k in EMConf._fields}
    return _from_fields(EMConf, fields)


def to_tensor(x, device="cpu", dtype=None):
    """an array (numpy, JAX, anything numpy can read) as a tensor"""
    return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)


def pixels_from_arrays(pixels, device="cpu"):
    """Pixels from any (v, u, area, val, ierr) tuple of arrays"""
    return Pixels(*(to_tensor(getattr(pixels, f), device) for f in Pixels._fields))


def to_numpy(tree):
    """tensors, and dicts of them, as numpy arrays"""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _num(x):
    return float(np.asarray(x))


# the priors the port has, by class name: the public attributes of
# another package's prior that make the port's, and its generator
_PRIOR_FIELDS = {
    "FlatPrior": lambda o, r: priors.FlatPrior(_num(o.minval), _num(o.maxval), rng=r),
    "TwoSidedErf": lambda o, r: priors.TwoSidedErf(_num(o.minval), _num(o.width_at_min),
                                                   _num(o.maxval), _num(o.width_at_max),
                                                   rng=r),
    "Normal": lambda o, r: priors.Normal(_num(o.mean), _num(o.sigma), bounds=o.bounds, rng=r),
    "LogNormal": lambda o, r: priors.LogNormal(
        _num(o.mean), _num(o.sigma), shift=None if o.shift is None else _num(o.shift), rng=r),
    "Sinh": lambda o, r: priors.Sinh(_num(o.mean), _num(o.scale), rng=r),
    "TruncatedGaussian": lambda o, r: priors.TruncatedGaussian(
        _num(o.mean), _num(o.sigma), _num(o.minval), _num(o.maxval), rng=r),
    "GPriorBA": lambda o, r: priors.GPriorBA(_num(o.sigma), A=_num(o.A), rng=r),
    "GPriorGauss": lambda o, r: priors.GPriorGauss(np.asarray(o.pars), rng=r),
    "ZDisk2D": lambda o, r: priors.ZDisk2D(_num(o.radius), rng=r),
    "CenPrior": lambda o, r: priors.CenPrior(_num(o.cen1), _num(o.cen2), _num(o.sigma1),
                                             _num(o.sigma2), rng=r),
}
# the joint priors: their components, converted with one generator
# memo, then the F prior(s)
_JOINT_FIELDS = {
    "PriorSimpleSep": (joint_prior.PriorSimpleSep, ("cen_prior", "g_prior", "T_prior")),
    "PriorBDFSep": (joint_prior.PriorBDFSep,
                    ("cen_prior", "g_prior", "T_prior", "fracdev_prior")),
    "PriorBDSep": (joint_prior.PriorBDSep, ("cen_prior", "g_prior", "T_prior",
                                            "logTratio_prior", "fracdev_prior")),
}


def _rng_copy(rng, memo):
    """a new RandomState in the state of rng (None for none), one for
    each distinct generator: components that share a generator share
    its copy, so their draws interleave as the original's do"""
    if rng is None:
        return None
    if id(rng) not in memo:
        copy_ = np.random.RandomState()
        copy_.set_state(rng.get_state())
        memo[id(rng)] = copy_
    return memo[id(rng)]


def prior_from_object(obj, _memo=None):
    """the port's prior of another package's prior (or any object) of
    the same class name, built from its public attributes read through
    numpy, with a copy of its generator's state; a joint prior's
    components are converted too, components that share a generator
    sharing one copy. Raises TypeError for a class the port does not
    have."""
    memo = {} if _memo is None else _memo
    name = type(obj).__name__
    if name in _JOINT_FIELDS:
        cls, fields = _JOINT_FIELDS[name]
        F = [prior_from_object(p, memo) for p in obj.F_priors]
        return cls(*(prior_from_object(getattr(obj, f), memo) for f in fields),
                   F if obj.nband > 1 else F[0])
    make = _PRIOR_FIELDS.get(name)
    if make is None:
        raise TypeError("no prior of the port for %s: the ported priors are %s"
                        % (name, ", ".join(sorted(list(_PRIOR_FIELDS) + list(_JOINT_FIELDS)))))
    return make(obj, _rng_copy(getattr(obj, "rng", None), memo))


def jacobian_from_object(jac):
    """the port's Jacobian of another package's jacobian (anything with
    row0, col0, dvdrow, dvdcol, dudrow and dudcol)"""
    return Jacobian(row=jac.row0, col=jac.col0, dvdrow=jac.dvdrow, dvdcol=jac.dvdcol,
                    dudrow=jac.dudrow, dudcol=jac.dudcol)


def gmix_from_object(gm):
    """the port's mixture of another package's GMix, GMixModel, GMixCM
    or GMixCoellip (by class name; any other class becomes a GMix of
    its full pars). The model's pars are read from its ``_pars`` and
    the [n, 6] data is copied as it is."""
    name = type(gm).__name__
    if name == "GMixModel":
        out = GMixModel(np.asarray(gm._pars), gm._model_name)
    elif name == "GMixCM":
        out = GMixCM(float(gm._fracdev), float(gm._TdByTe), np.asarray(gm._pars))
    elif name == "GMixCoellip":
        out = GMixCoellip(np.asarray(gm._pars))
    else:
        out = GMix(pars=np.asarray(gm.get_full_pars()))
    out.get_data()[:] = np.asarray(gm.get_data(), dtype=np.float64)
    return out


_PLANE_NAMES = ("bmask", "ormask", "noise", "mfrac")


def observation_from_object(obs, device=None):
    """the port's Observation, ObsList or MultiBandObsList of another
    package's (by class name), with the psf, the mixture, the planes
    bmask/ormask/noise/mfrac and the metadata; the pixels go on device
    (the CUDA card unless the caller passes one)"""
    name = type(obs).__name__
    if name in ("ObsList", "MultiBandObsList"):
        out = (ObsList if name == "ObsList" else MultiBandObsList)(meta=copy.deepcopy(obs.meta))
        for sub in obs:
            out.append(observation_from_object(sub, device=device))
        return out
    if name != "Observation":
        raise TypeError("expected an Observation, ObsList or MultiBandObsList, got %s" % name)
    planes = {k: np.array(getattr(obs, k)) for k in _PLANE_NAMES
              if getattr(obs, "has_" + k)()}
    return Observation(
        np.array(obs.image),
        weight=np.array(obs.weight),
        jacobian=jacobian_from_object(obs.jacobian),
        gmix=gmix_from_object(obs.get_gmix()) if obs.has_gmix() else None,
        psf=observation_from_object(obs.get_psf(), device=device) if obs.has_psf() else None,
        meta=copy.deepcopy(obs.meta),
        store_pixels=obs.store_pixels,
        ignore_zero_weight=obs.ignore_zero_weight,
        device=device,
        **planes,
    )
