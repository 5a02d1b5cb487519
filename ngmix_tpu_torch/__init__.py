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
Entry points run on the CUDA card unless the caller passes
device="cpu".
"""
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

__all__ = [
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
