"""Per-stage timing and device traces: the port of
``ngmix_tpu/profiling.py``.

- ``timed(name, sync=None)``: a context manager that adds the stage's
  wall seconds to a registry; with ``sync`` (a tensor, or lists,
  tuples and dicts of them) it first waits, with
  ``torch.cuda.synchronize``, for each CUDA device that holds one of
  them, so that queued kernels count in the stage;
- ``trace(logdir)``: a ``torch.profiler`` session of the CPU and, where
  there is a card, CUDA activity, written to ``logdir`` as a Chrome
  trace (Perfetto, chrome://tracing);
- ``report()`` and ``print_report()``: the registry's table.
"""
import contextlib
import os
import time
from collections import defaultdict

import torch

_STAGES = defaultdict(lambda: [0.0, 0])


def _cuda_devices(tree, out):
    """the CUDA devices of the tensors in a nested structure, into out"""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


@contextlib.contextmanager
def timed(name, sync=None):
    """add the wall seconds of the block to the stage ``name``; with
    ``sync``, wait for the CUDA devices of its tensors first"""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        for dev in _cuda_devices(sync, set()):
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        _STAGES[name][0] += dt
        _STAGES[name][1] += 1


@contextlib.contextmanager
def trace(logdir):
    """profile the block with torch.profiler (CPU, and CUDA where there
    is a card) and write its Chrome trace into logdir"""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace_%d.json" % os.getpid()))


def report(reset=False):
    """dict stage -> (total seconds, calls, seconds a call)"""
    out = {k: (v[0], v[1], v[0] / v[1] if v[1] else 0.0) for k, v in _STAGES.items()}
    if reset:
        _STAGES.clear()
    return out


def print_report(reset=False, stream=None):
    import sys

    stream = stream or sys.stdout
    rep = report(reset=reset)
    width = max((len(k) for k in rep), default=10)
    stream.write("%-*s %10s %8s %12s\n" % (width, "stage", "total[s]", "calls", "per-call[s]"))
    for k, (tot, n, per) in sorted(rep.items(), key=lambda kv: -kv[1][0]):
        stream.write("%-*s %10.3f %8d %12.5f\n" % (width, k, tot, n, per))
