"""Where a main path's time goes on the card.

    python -m ngmix_tpu_torch.profile_main_path [--measure {gaussmom,exp-lm}] [B]

Runs the metacal pipeline with the given measure (default gaussmom) at
its main-path configuration (bench.py's metacal_gaussmom configuration
for gaussmom, its headline configuration for exp-lm; float32) on the
port's homogeneous sims at B stamps (default 10240): one warm-up call,
then one call under torch.profiler. Prints the call's wall time, the
device's busy share (the union of kernel intervals over the wall time),
and the device time by kernel class and by kernel name. Needs a CUDA
card.
"""
import argparse
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from . import make_metacal_pipeline_fn, make_sim_batch
from .batch import GALSHEAR_TYPES, _auto_cascade
from .fitting import lm
from .sims import METACAL_EXP_LM_CONFIG, METACAL_GAUSSMOM_CONFIG

CONFS = {"gaussmom": METACAL_GAUSSMOM_CONFIG, "exp-lm": METACAL_EXP_LM_CONFIG}

# kernel-name fragments -> class, first match wins
_CLASSES = (
    ("gmix_eval", "K2 gmix_eval"),
    ("normal_eqs", "K1 normal_eqs"),
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


def main(measure="gaussmom", B=10240):
    if not torch.cuda.is_available():
        print("profile_main_path: no CUDA device", file=sys.stderr)
        return 2
    fn = make_metacal_pipeline_fn(CONFS[measure], measure=measure)
    args = make_sim_batch(torch.Generator(device="cuda").manual_seed(314), B,
                          device="cuda")
    warm = fn(*args)
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
    print("measure=%s B=%d wall %.3f ms, kernel time %.3f ms, device busy %.1f%% "
          "(idle %.1f%%), %d kernels"
          % (measure, B, wall_us / 1e3, total / 1e3, 100 * _busy_us(kernels) / wall_us,
             100 - 100 * _busy_us(kernels) / wall_us, len(kernels)))
    for cls, t in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print("  %-26s %9.3f ms %5.1f%%" % (cls, t / 1e3, 100 * t / total))
    if measure == "exp-lm":
        nfev = torch.cat([warm[t]["nfev"] for t in GALSHEAR_TYPES])
        print("LM iterations per compaction level (lanes, iterations): %s"
              % (lm.compaction_levels(nfev, _auto_cascade(nfev.numel())),))
    print("top kernels:")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print("  %9.3f ms %4d x  %s" % (t / 1e3, n, name[:90]))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--measure", choices=sorted(CONFS), default="gaussmom")
    ap.add_argument("B", type=int, nargs="?", default=10240)
    args = ap.parse_args()
    sys.exit(main(args.measure, args.B))
