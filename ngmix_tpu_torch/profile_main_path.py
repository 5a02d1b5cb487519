"""Where a main path's time goes on the card.

    python -m ngmix_tpu_torch.profile_main_path [--measure MEASURE] [B]

MEASURE is one of admom, bd-lm, bdf-lm, dev-lm, em, exp-lm, exp-lm-mb,
gauss-lm, gaussmom, ksigma and pgauss. Runs the metacal pipeline with
the given measure (default gaussmom) at its main-path configuration
(bench.py's metacal_gaussmom and metacal_admom configurations for
gaussmom and admom, and with the pre-psf kernel of FWHM 2.0 for pgauss
and ksigma, its headline configuration for the LM measures, bdf-lm and
bd-lm inside sims.BDF_LM_BOUNDS and BD_LM_BOUNDS, its multi-band
workload for exp-lm-mb:
metacal_pipeline_mb on 3 epochs over 2 bands), or for em bench.py's
em1 workload (em_batch of one gaussian on the sky-shifted stamps,
default EMConf), in float32 on the port's homogeneous sims at B stamps
(default 10240), or for exp-lm-mb B objects (default 2048): one
warm-up call, then one call under torch.profiler. Prints the card's
name and power limit (nvidia-smi), the call's wall time, the device's
busy share (the union of kernel intervals over the wall time), and
the device time by kernel class and by kernel name. Needs a CUDA
card.
"""
import argparse
import subprocess
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from . import (
    EMConf,
    em_batch,
    make_metacal_pipeline_fn,
    make_metacal_pipeline_mb_fn,
    make_sim_batch,
    make_sim_batch_mb,
)
from .batch import _LM_MEASURES as LM_MEASURES, GALSHEAR_TYPES
from .sims import (
    BD_LM_BOUNDS,
    BDF_LM_BOUNDS,
    MB_BAND,
    MB_NBAND,
    METACAL_ADMOM_CONFIG,
    METACAL_EXP_LM_CONFIG,
    METACAL_GAUSSMOM_CONFIG,
    METACAL_MB_CONFIG,
    PREPSF_FWHM,
    em1_inputs,
)

CONFS = dict({"gaussmom": METACAL_GAUSSMOM_CONFIG, "admom": METACAL_ADMOM_CONFIG,
              "exp-lm-mb": METACAL_MB_CONFIG, "pgauss": METACAL_GAUSSMOM_CONFIG,
              "ksigma": METACAL_GAUSSMOM_CONFIG},
             **{m: METACAL_EXP_LM_CONFIG for m in LM_MEASURES})
# the pipeline options of a measure beyond its configuration
OPTIONS = {"pgauss": dict(measure_fwhm=PREPSF_FWHM), "ksigma": dict(measure_fwhm=PREPSF_FWHM),
           "bdf-lm": dict(lm_bounds=BDF_LM_BOUNDS), "bd-lm": dict(lm_bounds=BD_LM_BOUNDS)}
MEASURES = sorted(CONFS) + ["em"]

# kernel-name fragments -> class, first match wins
_CLASSES = (
    ("lm_solve_mb", "K3-mb lm_solve_mb"),
    ("lm_solve", "K3 lm_solve"),
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


def main(measure="gaussmom", B=None):
    if not torch.cuda.is_available():
        print("profile_main_path: no CUDA device", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(314)
    if measure == "exp-lm-mb":
        B = B or 2048
        fn = make_metacal_pipeline_mb_fn(CONFS[measure], MB_BAND, MB_NBAND)
        args = make_sim_batch_mb(gen, B, device="cuda")
    elif measure == "em":
        B = B or 10240
        args = em1_inputs(*make_sim_batch(gen, B, device="cuda")[:3])

        def fn(*a):
            return em_batch(*a, EMConf())
    else:
        B = B or 10240
        fn = make_metacal_pipeline_fn(CONFS[measure], measure=measure,
                                      **OPTIONS.get(measure, {}))
        args = make_sim_batch(gen, B, device="cuda")
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

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card or torch.cuda.get_device_name(0))
    print("measure=%s B=%d wall %.3f ms, kernel time %.3f ms, device busy %.1f%% "
          "(idle %.1f%%), %d kernels"
          % (measure, B, wall_us / 1e3, total / 1e3, 100 * _busy_us(kernels) / wall_us,
             100 - 100 * _busy_us(kernels) / wall_us, len(kernels)))
    for cls, t in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print("  %-26s %9.3f ms %5.1f%%" % (cls, t / 1e3, 100 * t / total))
    if measure in LM_MEASURES or measure == "exp-lm-mb":
        nfev = torch.cat([warm[t]["nfev"] for t in GALSHEAR_TYPES]).double()
        print("LM evaluations a lane (nfev): mean %.3f, p50 %g, max %d, sum %d"
              % (nfev.mean(), nfev.median(), nfev.max(), nfev.sum()))
    if measure in ("admom", "em"):
        numiter = (warm["numiter"] if measure == "em" else
                   torch.cat([warm[t]["numiter"] for t in GALSHEAR_TYPES])).double()
        print("%s iterations a lane (numiter): mean %.3f, p50 %g, max %d (the host "
              "loop's iterations a call)"
              % (measure, numiter.mean(), numiter.median(), numiter.max()))
    print("top kernels:")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print("  %9.3f ms %4d x  %s" % (t / 1e3, n, name[:90]))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--measure", choices=MEASURES, default="gaussmom")
    ap.add_argument("B", type=int, nargs="?", default=None)
    args = ap.parse_args()
    sys.exit(main(args.measure, args.B))
