"""ngmix_tpu_torch: the PyTorch/CUDA port of ngmix_tpu.

Runs the batched metacal pipeline with the gaussmom measure on an
NVIDIA H100; the gaussian-mixture evaluation is the hand-written CUDA
kernel K2 (ops/gmix_eval.py, csrc/gmix_eval.cu). Entry points run on
the CUDA card unless the caller passes device="cpu".
"""
from .batch import (
    MetacalConfig,
    make_metacal_pipeline_fn,
    metacal_pipeline,
    shear_response,
)
from .sims import make_sim_batch, make_sim_batch_hetero

__all__ = [
    "MetacalConfig",
    "make_metacal_pipeline_fn",
    "metacal_pipeline",
    "shear_response",
    "make_sim_batch",
    "make_sim_batch_hetero",
]
