"""Carry state over from the JAX package.

This system has no weights. Its state is the pipeline configuration
and the arrays that go in: the MetacalConfig, LMConf, AdmomConf and
EMConf fields (the plain dict that a NamedTuple's ``_asdict()``
gives, or the attributes of a plain configuration object) and
mixtures and pixel planes as numpy arrays. Nothing here imports JAX; JAX arrays are read through
numpy.
"""
import numpy as np
import torch

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
