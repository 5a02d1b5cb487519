"""ngmix_tpu_torch: the PyTorch/CUDA port of ngmix_tpu.

Runs the batched metacal pipeline with the gaussmom and exp-LM measures
on an NVIDIA H100. The gaussian-mixture evaluation is the hand-written
CUDA kernel K2 (ops/gmix_eval.py, csrc/gmix_eval.cu) and the LM's
normal equations are K1 (ops/normal_eqs.py, csrc/normal_eqs.cu). Entry
points run on the CUDA card unless the caller passes device="cpu".
"""
from .batch import (
    MetacalConfig,
    make_metacal_pipeline_fn,
    metacal_pipeline,
    shear_response,
)
from .fitting.lm import LMConf
from .sims import make_sim_batch, make_sim_batch_hetero

__all__ = [
    "LMConf",
    "MetacalConfig",
    "make_metacal_pipeline_fn",
    "metacal_pipeline",
    "shear_response",
    "make_sim_batch",
    "make_sim_batch_hetero",
]
