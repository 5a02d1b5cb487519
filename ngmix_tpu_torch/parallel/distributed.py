"""Multi-process scale-out: one process per GPU over torch.distributed.

The port of ``ngmix_tpu/parallel/distributed.py``. Where the JAX package
runs one controller process per host over a global device mesh, the
port runs one process per GPU (launched by ``torchrun`` or any launcher
that sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT, or
given its rank and world size explicitly). Each process loads only its
slice of the catalog (host_shard_bounds), runs the pipeline on it on its
own card (``cuda:LOCAL_RANK``), and only the calibration sums cross
processes, as one all-reduce (parallel/mesh.py).

Usage in each process (the same program, a different rank)::

    from ngmix_tpu_torch.parallel import distributed as dist
    from ngmix_tpu_torch.parallel import make_sharded_pipeline_fn
    dist.initialize()                      # env:// from the launcher
    fn = make_sharded_pipeline_fn(conf, measure="exp-lm")
    lo, hi = dist.host_shard_bounds(ncatalog)
    local = dist.global_batch_from_local(*load_meds_slice(lo, hi))
    results, calib = fn(*local)            # calib the same on every rank
    rows = dist.local_results(results)     # this rank's rows, numpy
"""
import os

import numpy as np
import torch
import torch.distributed as tdist


def initialize(init_method=None, world_size=None, rank=None, backend=None, store=None,
               **kw):
    """torch.distributed.init_process_group, a no-op when the group is up.

    With no arguments the launcher's environment (env://) gives the
    address, the world size and the rank; otherwise pass init_method
    (e.g. "tcp://localhost:29500") or a store (e.g. a
    torch.distributed.FileStore), with world_size and rank. backend:
    NCCL when CUDA is available, else gloo (the CPU); kw passes to
    init_process_group.
    """
    if is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if store is not None:
        kw["store"] = store
    elif init_method is not None:
        kw["init_method"] = init_method
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    tdist.init_process_group(backend, **kw)


def is_initialized():
    """whether the process group is up (multi-process mode)"""
    return tdist.is_available() and tdist.is_initialized()


def _rank():
    return tdist.get_rank() if is_initialized() else 0


def _world_size():
    return tdist.get_world_size() if is_initialized() else 1


def local_device(device=None):
    """this process's device: device if given, else cuda:LOCAL_RANK (the
    launcher's, else the rank modulo the cards of the host)"""
    if device is not None:
        return torch.device(device)
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        local = _rank() % max(torch.cuda.device_count(), 1)
    return torch.device("cuda", int(local))


def host_shard_bounds(nobj, process_index=None, process_count=None):
    """[start, stop) of the catalog slice this process should load.

    A contiguous equal split: the local slices concatenate in rank order
    to the catalog. The catalog size must divide by the process count
    (pad it, as ngmix_tpu_torch.ragged pads, with zero-weight entries).
    """
    p = _rank() if process_index is None else process_index
    n = _world_size() if process_count is None else process_count
    if int(nobj) % n:
        raise ValueError(
            "catalog size %d does not divide by %d processes; pad the catalog to a "
            "divisible size (uneven local slices cannot be assembled into one "
            "uniformly-sharded global batch)" % (nobj, n)
        )
    per = int(nobj) // n
    return p * per, (p + 1) * per


def global_batch_from_local(*local_arrays, device=None):
    """this process's slice of the global batch, as tensors on its device
    (local_device). One process per GPU never assembles the global batch:
    it is the concatenation of the ranks' slices in rank order, and each
    rank's pipeline runs on its own slice."""
    dev = local_device(device)
    return tuple(torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a,
                                 device=dev) for a in local_arrays)


def local_results(results):
    """this process's rows of a sharded pipeline's results as numpy,
    nested dicts kept (its host copy; each rank persists its own rows,
    the write-side analog of host_shard_bounds)"""
    if isinstance(results, dict):
        return {k: local_results(v) for k, v in results.items()}
    if isinstance(results, torch.Tensor):
        return results.detach().cpu().numpy()
    return np.asarray(results)
