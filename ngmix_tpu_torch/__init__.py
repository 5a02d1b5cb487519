"""ngmix_tpu_torch: the PyTorch/CUDA port of ngmix_tpu.

Runs the batched metacal pipeline with the gaussmom, admom, LM (exp,
gauss, dev, bdf and bd models, optionally bounded and regularized by the
joint priors of joint_prior.py over priors/) and pre-psf (pgauss, ksigma)
measures and the gauss, azgauss, fitgauss and dilate psf modes on an
NVIDIA H100, and its multi-band, multi-epoch form (metacal_pipeline_mb:
a joint LM fit of every object over its epochs and bands, or pooled
moments), calibrated by the plain or the selection-corrected shear
responses; and the batched pre-psf moments
(prepsfmom_batch) and EM decomposition (em_batch) on their own. The
gaussian-mixture evaluation is the hand-written CUDA kernel K2
(ops/gmix_eval.py, csrc/gmix_eval.cu); the LM solve of every lane
is one launch of K3 (ops/lm_solve.py, csrc/lm_solve.cuh), and the joint
multi-band solve one launch of K3-mb (csrc/lm_solve_mb.cuh); their
plain versions are the host loop over K1,
the LM's normal equations (ops/normal_eqs.py, csrc/normal_eqs.cu).

The host single-object API keeps the JAX package's names: the data
model (Observation, ObsList, MultiBandObsList, Jacobian, GMix and its
models, Shape) with numpy arrays at the surface and the pixels on a
device; the single-object fitters of the batched measures
(admom.AdmomFitter, gaussmom.GaussMom, prepsfmom.KSigmaMom and
PGaussMom, em.EMFitter), each one lane of its batched loop, with the
mixture evaluations through K2; and the LM fitters (fitting.Fitter,
CoellipFitter, PSFFluxFitter) with their guessers and runners, a fit
that K3 or K3-mb can run being one launch of the kernel at B = 1 and
any other fit the residual-form LM (fitting.lm.run_lm); metacal's
image engines (metacal.get_all_metacal: deconvolve, shear and
reconvolve in k space, with the rot90 noise fix) and the bootstrappers
(Bootstrapper, MetacalBootstrapper) over those fitters; simobs; and
the k-space half: the k-space observations (kobs) and the fitters of
analytic k profiles (fitting.KSpaceFitter and its subclasses, the
residual-form LM with complex residuals).

Entry points run on the CUDA card unless the caller passes
device="cpu".
"""
__version__ = "0.5.0"

from . import defaults  # noqa: F401
from . import flags  # noqa: F401
from . import gexceptions  # noqa: F401
from . import jacobian  # noqa: F401
from . import moments  # noqa: F401
from . import pixels  # noqa: F401
from . import shape  # noqa: F401
from . import util  # noqa: F401
from .util import print_pars
from .gexceptions import (
    BootGalFailure,
    BootPSFFailure,
    FFTRangeError,
    GMixFatalError,
    GMixMaxIterEM,
    GMixRangeError,
    NGmixBaseException,
    PSFFluxFailure,
)
from .jacobian import DiagonalJacobian, Jacobian, UnitJacobian
from .shape import Shape
from . import gmix  # noqa: F401
from . import observation  # noqa: F401
from .observation import MultiBandObsList, Observation, ObsList, get_mb_obs
from .gmix.gmix import GMix, GMixCM, GMixCoellip, GMixModel, make_gmix_model
from .gmix.gmix_lists import GMixList, MultiBandGMixList
from . import em  # noqa: F401
from .em import EMFitter, run_em
from . import admom  # noqa: F401
from . import prepsfmom  # noqa: F401
from . import ksigmamom  # noqa: F401
from .prepsfmom import KSigmaMom, PGaussMom
from . import gaussmom  # noqa: F401
from . import fastexp  # noqa: F401
fastexp_nb = fastexp
from . import containers  # noqa: F401
from .admom import AdmomFitter, find_cen_admom, run_admom
from .gaussmom import GaussMom
from .admom import AdmomConf, admom_batch
from .batch import (
    MetacalConfig,
    make_metacal_pipeline_fn,
    make_metacal_pipeline_mb_fn,
    metacal_pipeline,
    metacal_pipeline_mb,
    psf_shear_response,
    shear_response,
    shear_response_select,
    shear_response_select_consistent,
)
from .em import EMConf, em_batch
from .fitting.lm import LMConf
from .prepsfmom import prepsfmom_batch
from .sims import make_sim_batch, make_sim_batch_hetero, make_sim_batch_mb
from . import priors  # noqa: F401
from .priors import srandu
from . import joint_prior  # noqa: F401
from . import fitting  # noqa: F401
from .fitting import CoellipFitter, Fitter, PSFFluxFitter
from . import guessers  # noqa: F401
from . import runners  # noqa: F401
from .runners import PSFRunner, Runner
from . import bootstrap  # noqa: F401
from .bootstrap import Bootstrapper
from . import simobs  # noqa: F401
from . import metacal  # noqa: F401
from .metacal import MetacalBootstrapper
from . import kobs  # noqa: F401
from .kobs import (
    KMultiBandObsList,
    KObservation,
    KObsList,
    get_kmb_obs,
    make_iilist,
    make_kobs,
)
from .fitting import KSpaceFitter
from . import batch  # noqa: F401
from . import checkpoint  # noqa: F401
from . import parallel  # noqa: F401
from . import ragged  # noqa: F401

__all__ = [
    "AdmomFitter",
    "Bootstrapper",
    "KMultiBandObsList",
    "KObservation",
    "KObsList",
    "KSpaceFitter",
    "MetacalBootstrapper",
    "get_kmb_obs",
    "make_iilist",
    "make_kobs",
    "CoellipFitter",
    "Fitter",
    "PSFFluxFitter",
    "PSFRunner",
    "Runner",
    "srandu",
    "BootGalFailure",
    "BootPSFFailure",
    "DiagonalJacobian",
    "EMFitter",
    "FFTRangeError",
    "GMix",
    "GMixCM",
    "GMixCoellip",
    "GMixFatalError",
    "GMixList",
    "GMixMaxIterEM",
    "GMixModel",
    "GMixRangeError",
    "GaussMom",
    "Jacobian",
    "KSigmaMom",
    "MultiBandGMixList",
    "MultiBandObsList",
    "NGmixBaseException",
    "ObsList",
    "Observation",
    "PGaussMom",
    "PSFFluxFailure",
    "Shape",
    "UnitJacobian",
    "find_cen_admom",
    "get_mb_obs",
    "make_gmix_model",
    "print_pars",
    "run_admom",
    "run_em",
    "AdmomConf",
    "EMConf",
    "LMConf",
    "MetacalConfig",
    "admom_batch",
    "em_batch",
    "make_metacal_pipeline_fn",
    "make_metacal_pipeline_mb_fn",
    "metacal_pipeline",
    "metacal_pipeline_mb",
    "prepsfmom_batch",
    "psf_shear_response",
    "shear_response",
    "shear_response_select",
    "shear_response_select_consistent",
    "make_sim_batch",
    "make_sim_batch_hetero",
    "make_sim_batch_mb",
]
