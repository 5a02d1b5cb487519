"""One rank of tests/test_torch_scaleout.py's two-process run on the
CPU: joins a gloo group through a FileStore, runs the sharded flat
exp-LM and mb exp-LM pipelines on its slice of the inputs and saves its
rows and the all-reduced calibrations.

    python tests/_torch_shard_worker.py STORE RANK WORLD INPUTS.npz OUT.npz

Imports torch and the port only (no JAX), so a rank starts quickly.
"""
import sys

import numpy as np
import torch
import torch.distributed as tdist

from ngmix_tpu_torch import batch as tbatch
from ngmix_tpu_torch.parallel import (
    distributed as dist,
    make_sharded_mb_pipeline_fn,
    make_sharded_pipeline_fn,
)

torch.set_num_threads(1)

# the configurations of the sharded runs, which the test runs unsharded
FLAT_CONF = tbatch.MetacalConfig(dims=(49, 49), psf_dims=(25, 25),
                                 jac=(0.263, 0.0, 0.0, 0.263), fixnoise=True,
                                 pad_factor=1.3, fit_dims=(19, 19))
MB_CONF = FLAT_CONF._replace(pad_factor=2)
NBAND = 2


def flatten(prefix, tree, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            flatten(prefix + k + "/", v, out)
        else:
            out[prefix + k] = v.detach().cpu().numpy()
    return out


def main(store, rank, world, inputs, out):
    dist.initialize(store=tdist.FileStore(store, world), world_size=world, rank=rank,
                    backend="gloo")
    d = np.load(inputs)
    flat = [d["flat%d" % i] for i in range(6)]
    lo, hi = dist.host_shard_bounds(len(flat[0]))
    res, calib = make_sharded_pipeline_fn(FLAT_CONF, measure="exp-lm", device="cpu")(
        *dist.global_batch_from_local(*(a[lo:hi] for a in flat), device="cpu"))
    mb = [d["mb%d" % i] for i in range(6)]
    mlo, mhi = dist.host_shard_bounds(len(mb[0]))
    mres, mcalib = make_sharded_mb_pipeline_fn(MB_CONF, d["band"][mlo:mhi], NBAND,
                                               device="cpu")(
        *dist.global_batch_from_local(*(a[mlo:mhi] for a in mb), device="cpu"))
    rows = {}
    flatten("flat/", res, rows)
    flatten("calib/", calib, rows)
    flatten("mb/", mres, rows)
    flatten("mbcalib/", mcalib, rows)
    np.savez(out, lo=lo, hi=hi, **rows)
    tdist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
