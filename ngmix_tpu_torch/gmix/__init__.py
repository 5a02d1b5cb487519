"""Gaussian mixtures as dense [..., n, 6] tensors (p, row, col, irr, irc,
icc), and the host mixture classes; the names of
``ngmix_tpu/gmix/__init__.py``."""
from . import core, tables  # noqa: F401
from .core import (  # noqa: F401
    apod_window,
    eval_gmix,
    fill_fdiff,
    get_cm_Tfactor,
    get_loglike,
    get_model_s2n_sum,
    get_weighted_sums,
    gmix_convolve,
    gmix_fill,
    render,
)
from .gmix import (  # noqa: F401
    GMix,
    GMixCM,
    GMixCoellip,
    GMixModel,
    get_coellip_ngauss,
    get_coellip_npars,
    get_model_name,
    get_model_ngauss,
    get_model_npars,
    get_model_num,
    get_weighted_moments_stats,
    gmix_concat,
    make_gmix_model,
)
from .gmix_lists import GMixList, MultiBandGMixList  # noqa: F401

# the reference's module paths: the roles of its numba modules are core's
gmix_nb = core
render_nb = core
