"""Carry state over from the JAX package.

This system has no weights. Its state is the pipeline configuration
and the arrays that go in: the MetacalConfig, LMConf, AdmomConf and
EMConf fields (the plain dict that a NamedTuple's ``_asdict()``
gives, or the attributes of a plain configuration object), the LM
priors (``prior_from_object``) and mixtures and pixel planes as numpy
arrays. Nothing here imports JAX; JAX arrays are read through numpy.
"""
import numpy as np
import torch

from . import joint_prior, priors
from .admom import AdmomConf
from .batch import MetacalConfig
from .em import EMConf
from .fitting.lm import LMConf
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
# another package's prior that make the port's
_PRIOR_FIELDS = {
    "FlatPrior": lambda o: priors.FlatPrior(_num(o.minval), _num(o.maxval)),
    "TwoSidedErf": lambda o: priors.TwoSidedErf(_num(o.minval), _num(o.width_at_min),
                                                _num(o.maxval), _num(o.width_at_max)),
    "Normal": lambda o: priors.Normal(_num(o.mean), _num(o.sigma), bounds=o.bounds),
    "LogNormal": lambda o: priors.LogNormal(
        _num(o.mean), _num(o.sigma), shift=None if o.shift is None else _num(o.shift)),
    "Sinh": lambda o: priors.Sinh(_num(o.mean), _num(o.scale)),
    "TruncatedGaussian": lambda o: priors.TruncatedGaussian(
        _num(o.mean), _num(o.sigma), _num(o.minval), _num(o.maxval)),
    "GPriorBA": lambda o: priors.GPriorBA(_num(o.sigma), A=_num(o.A)),
    "GPriorGauss": lambda o: priors.GPriorGauss(np.asarray(o.pars)),
    "ZDisk2D": lambda o: priors.ZDisk2D(_num(o.radius)),
    "CenPrior": lambda o: priors.CenPrior(_num(o.cen1), _num(o.cen2), _num(o.sigma1),
                                          _num(o.sigma2)),
    "PriorSimpleSep": lambda o: joint_prior.PriorSimpleSep(
        *map(prior_from_object, (o.cen_prior, o.g_prior, o.T_prior)), _F_priors(o)),
    "PriorBDFSep": lambda o: joint_prior.PriorBDFSep(
        *map(prior_from_object, (o.cen_prior, o.g_prior, o.T_prior, o.fracdev_prior)),
        _F_priors(o)),
    "PriorBDSep": lambda o: joint_prior.PriorBDSep(
        *map(prior_from_object, (o.cen_prior, o.g_prior, o.T_prior, o.logTratio_prior,
                                 o.fracdev_prior)), _F_priors(o)),
}


def _F_priors(obj):
    """the F prior, or the list of them when the prior has nband > 1"""
    F = [prior_from_object(p) for p in obj.F_priors]
    return F if obj.nband > 1 else F[0]


def prior_from_object(obj):
    """the port's prior of another package's prior (or any object) of
    the same class name, built from its public attributes read through
    numpy; a joint prior's components are converted too. Raises
    TypeError for a class the port does not have."""
    make = _PRIOR_FIELDS.get(type(obj).__name__)
    if make is None:
        raise TypeError("no prior of the port for %s: the ported priors are %s"
                        % (type(obj).__name__, ", ".join(sorted(_PRIOR_FIELDS))))
    return make(obj)
