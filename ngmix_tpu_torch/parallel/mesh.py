"""Multi-GPU scale-out: shard the stamp batch over the processes.

The port of ``ngmix_tpu/parallel/mesh.py``. The workload is parallel at
the object level: the stamps shard over the processes of a
torch.distributed group, one per GPU (parallel/distributed.py), each
process runs the whole metacal and measure pipeline on its slice, and
only the calibration statistics (per-type ellipticity sums and counts,
batch.shear_response_sums) cross processes, as one all-reduce (NCCL on
the cards, gloo on the CPU). Every rank then holds the same
calibration. Without a process group the functions run the one process
alone.
"""
import torch
import torch.distributed as tdist

from ..batch import (
    DEFAULT_STEP,
    MetacalConfig,
    make_metacal_pipeline_fn,
    make_metacal_pipeline_mb_fn,
    shear_response_from_sums,
    shear_response_sums,
)
from . import distributed


def _all_reduce_sums(sums, group=None):
    """the element-wise sum over the group's ranks of shear_response_sums'
    {type: {"se": [2], "n": []}}, as one all-reduce of the flattened
    values"""
    if not distributed.is_initialized():
        return sums
    types = list(sums)
    se = torch.stack([sums[t]["se"] for t in types])
    flat = torch.cat([se.reshape(-1), torch.stack([sums[t]["n"] for t in types]).to(se.dtype)])
    tdist.all_reduce(flat, op=tdist.ReduceOp.SUM, group=group)
    n_se = se.numel()
    se = flat[:n_se].reshape(se.shape)
    n = flat[n_se:].round().to(sums[types[0]]["n"].dtype)
    return {t: {"se": se[i], "n": n[i]} for i, t in enumerate(types)}


def sharded_shear_response(results, step=DEFAULT_STEP, group=None):
    """the calibration of the whole sharded catalog from this rank's
    per-stamp results: shear_response_sums on the rank's rows, an
    all-reduce over the group, then shear_response_from_sums, so every
    rank holds the same R and shear"""
    return shear_response_from_sums(_all_reduce_sums(shear_response_sums(results), group),
                                    step=step)


def make_sharded_pipeline_fn(conf: MetacalConfig, measure="gaussmom", measure_fwhm=1.2,
                             device=None, group=None, **pipeline_kw):
    """the pipeline of this rank's slice with the calibration of the whole
    catalog: fn(images, weights, cens, psf_images, psf_cens, noise) ->
    (results of the rank's stamps, calibration all-reduced over the
    group). The device is distributed.local_device(device), cuda:LOCAL_RANK
    by default; pipeline_kw (lm_conf, lm_prior, lm_bounds, max_chunk)
    passes to make_metacal_pipeline_fn."""
    fn = make_metacal_pipeline_fn(conf, measure=measure, measure_fwhm=measure_fwhm,
                                  device=distributed.local_device(device), **pipeline_kw)

    def run(images, weights, cens, psf_images, psf_cens, noise):
        results = fn(images, weights, cens, psf_images, psf_cens, noise)
        return results, sharded_shear_response(results, step=conf.step, group=group)

    return run


def make_sharded_mb_pipeline_fn(conf: MetacalConfig, band, nband, device=None, group=None,
                                **pipeline_kw):
    """the multi-band, multi-epoch pipeline of this rank's objects with
    the calibration of the whole catalog, as make_sharded_pipeline_fn.
    band: [E], each epoch's band for every object, or [B_local, E], the
    band map of this rank's objects (the rank's rows of a per-object
    map); pipeline_kw passes to make_metacal_pipeline_mb_fn."""
    fn = make_metacal_pipeline_mb_fn(conf, band, nband,
                                     device=distributed.local_device(device), **pipeline_kw)

    def run(images, weights, cens, psf_images, psf_cens, noise):
        results = fn(images, weights, cens, psf_images, psf_cens, noise)
        return results, sharded_shear_response(results, step=conf.step, group=group)

    return run
