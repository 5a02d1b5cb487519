"""Where the main path's time goes on the card.

    python -m ngmix_tpu_torch.profile_main_path [B]

Runs the gaussmom metacal pipeline (bench.py's metacal_gaussmom
configuration, float32) on the port's homogeneous sims at B stamps
(default 10240): one warm-up call, then one call under torch.profiler.
Prints the call's wall time, the device's busy share (the union of
kernel intervals over the wall time), and the device time by kernel
class and by kernel name. Needs a CUDA card.
"""
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from . import make_metacal_pipeline_fn, make_sim_batch
from .sims import METACAL_GAUSSMOM_CONFIG as CONF

# kernel-name fragments -> class, first match wins
_CLASSES = (
    ("gmix_eval", "K2 gmix_eval"),
    ("fft", "FFT (cuFFT)"),
    ("gemm", "matrix products (cuBLAS)"),
    ("reduce", "reductions"),
    ("elementwise", "elementwise"),
)


def _kernel_class(name):
    low = name.lower()
    for frag, cls in _CLASSES:
        if frag in low:
            return cls
    return "other"


def _busy_us(events):
    """length of the union of the kernels' [start, end) intervals"""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main(B=10240):
    if not torch.cuda.is_available():
        print("profile_main_path: no CUDA device", file=sys.stderr)
        return 2
    fn = make_metacal_pipeline_fn(CONF, measure="gaussmom")
    args = make_sim_batch(torch.Generator(device="cuda").manual_seed(314), B,
                          device="cuda")
    fn(*args)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.time_range.end > e.time_range.start
    ]
    total = sum(e.time_range.end - e.time_range.start for e in kernels)
    by_class, by_name = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e in kernels:
        dt = e.time_range.end - e.time_range.start
        by_class[_kernel_class(e.name)] += dt
        by_name[e.name][0] += dt
        by_name[e.name][1] += 1

    print(torch.cuda.get_device_name(0))
    print("B=%d wall %.3f ms, kernel time %.3f ms, device busy %.1f%% "
          "(idle %.1f%%), %d kernels"
          % (B, wall_us / 1e3, total / 1e3, 100 * _busy_us(kernels) / wall_us,
             100 - 100 * _busy_us(kernels) / wall_us, len(kernels)))
    for cls, t in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print("  %-26s %9.3f ms %5.1f%%" % (cls, t / 1e3, 100 * t / total))
    print("top kernels:")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print("  %9.3f ms %4d x  %s" % (t / 1e3, n, name[:90]))
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:])))
