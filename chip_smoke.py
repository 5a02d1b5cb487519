"""Smoke run of the PyTorch port (ngmix_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path once on the card, bench.py's
metacal_gaussmom workload at the production chunk size, and holds the
hand-written CUDA kernel K2 against its plain PyTorch version. Phases,
in order, each printing one timed line as soon as it ends:

1. card:   the card's name and power limit (nvidia-smi);
2. build:  nvcc builds K2 into build/ngmix_tpu_torch/ (first use);
3. kernel: K2 against its plain version on the same CUDA inputs over
           n in {1, 3, 18}, both modes, float32 and float64, ragged
           B in {1, 3, 10240} and P in {361, 625, 2401, 1000}, area a
           scalar and a [B, P] tensor, with a degenerate gaussian;
           rtol 1e-12 in float64, and in float32 rtol 1e-5 with an atol
           of 1e-6 times the lane's max |model|;
4. main:   the gaussmom metacal pipeline in float32 on the port's
           homogeneous and heterogeneous sims at B = 10240, gated like
           bench.py: |m| < 1e-3, |hetero m| < 1e-3, flagged lanes
           <= max(8, 0.5% B), and K2 launched;
5. cpu:    the first 256 stamps in float64 on the card and on the CPU:
           flags equal, pars and s2n to rtol 1e-8 and atol 1e-10;
6. times:  K2 at the main path's two shapes (n = 1 over [5 B, 361]
           with a [B, P] area, n = 18 over [B, 2401] with a scalar
           area), held against its plain version there at phase 3's
           tolerances, and timed beside its bound.

Needs one CUDA card and exits nonzero, printing the reason, on any
failure or without a card. The last line is the JSON result.
"""
import json
import subprocess
import sys
import time

import torch

import ngmix_tpu_torch as nt
from ngmix_tpu_torch.gmix import core as gcore
from ngmix_tpu_torch.gaussmom import make_weight_gmix
from ngmix_tpu_torch.ops import _build, gmix_eval

B_MAIN = 10240
NTYPES = 5
CONF = nt.sims.METACAL_GAUSSMOM_CONFIG
SHEAR_TRUE = nt.sims.SHEAR_TRUE

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# K2's arithmetic per (pixel, gaussian): offsets 2, chi2 9, exponent
# scale 1, exp 1, pnorm product 1, accumulate 1; plus the area product
# per pixel
OPS_PER_PIXEL_GAUSS = 15


class SmokeFailure(Exception):
    pass


def phase_line(name, t0, msg=""):
    print("[%s] %.2f s %s" % (name, time.perf_counter() - t0, msg), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _random_case(gen, B, n, P, dtype, degenerate):
    """[B, n, 6] mixtures with spread sizes and shapes over [B, P]
    coordinates; optionally a gaussian with det <= 0 and T <= 0 in the
    last lane"""
    dev = gen.device

    def U(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev, dtype=dtype) * (hi - lo) + lo

    T = U((B, n), 0.05, 3.0)
    e1 = U((B, n), -0.4, 0.4)
    e2 = U((B, n), -0.4, 0.4)
    gm = torch.stack(
        [U((B, n), 0.1, 2.0), U((B, n), -0.5, 0.5), U((B, n), -0.5, 0.5),
         0.5 * T * (1 - e1), 0.5 * T * e2, 0.5 * T * (1 + e1)],
        dim=-1,
    )
    if degenerate:
        gm[-1, 0, 3:] = torch.tensor([-0.5, 0.6, -0.5], dtype=dtype)
    v = U((B, P), -3.5, 3.5)
    u = U((B, P), -3.5, 3.5)
    area = U((B, P), 0.05, 0.08)
    return gm.contiguous(), v, u, area


def _plain_chunked(gm, v, u, area, fast, chunk=2048):
    """the plain version in lane chunks, bounding its [B, n, P] memory"""
    outs = []
    for i in range(0, gm.shape[0], chunk):
        a = area[i:i + chunk] if isinstance(area, torch.Tensor) else area
        outs.append(gmix_eval.eval_gmix_plain(
            gm[i:i + chunk], v[i:i + chunk], u[i:i + chunk], a, fast=fast
        ))
    return torch.cat(outs)


def compare(out, ref, what):
    """hold K2's output against its plain version's: rtol 1e-12 in
    float64; in float32 rtol 1e-5 with an atol of 1e-6 times the lane's
    max |model|. Returns the largest absolute and relative errors."""
    err = (out - ref).abs()
    if out.dtype == torch.float64:
        bad = err > 1e-12 * ref.abs()
    else:
        lane_max = ref.abs().amax(dim=-1, keepdim=True)
        bad = err > 1e-5 * ref.abs() + 1e-6 * lane_max
    if bool(bad.any()) or not bool(torch.isfinite(out).all()):
        raise SmokeFailure("K2 disagrees with its plain version: %s, max err %.3e"
                           % (what, float(err.max())))
    return float(err.max()), float((err / ref.abs().clamp_min(1e-300)).max())


def check_kernel(device):
    """K2 against its plain version over every listed case; returns the
    largest absolute error, the number of cases and the largest
    relative error per dtype"""
    gen = torch.Generator(device=device).manual_seed(2024)
    max_abs = 0.0
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    ncase = 0
    for dtype in (torch.float32, torch.float64):
        for n in (1, 3, 18):
            for fast in (True, False):
                for B in (1, 3, NTYPES * 2048):
                    for P in (361, 625, 2401, 1000):
                        gm, v, u, area = _random_case(gen, B, n, P, dtype, B >= 3)
                        for a in (area, 0.069):
                            out = gmix_eval.eval_gmix(gm, v, u, a, fast=fast)
                            ref = _plain_chunked(gm, v, u, a, fast)
                            err, rel = compare(
                                out, ref, "dtype=%s n=%d fast=%s B=%d P=%d area=%s"
                                % (dtype, n, fast, B, P, type(a).__name__))
                            worst[dtype] = max(worst[dtype], rel)
                            max_abs = max(max_abs, err)
                            ncase += 1
    return max_abs, ncase, worst


def m_of(sr):
    return float(sr["shear"][0]) / SHEAR_TRUE - 1.0


def run_main(device, B):
    """the main path: sims -> pipeline -> shear_response, homogeneous
    and heterogeneous, float32"""
    fn = nt.make_metacal_pipeline_fn(CONF, measure="gaussmom", device=device)
    gen = torch.Generator(device=device).manual_seed(314)
    hom = nt.make_sim_batch(gen, B, torch.float32, device=device)
    res = fn(*hom)
    sr = nt.shear_response(res)
    # timed calls after the first, which pays for FFT plans and library
    # setup; the median of three
    times = []
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        fn(*hom)
        _sync(device)
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[1]
    het = nt.make_sim_batch_hetero(torch.Generator(device=device).manual_seed(271),
                                   B, torch.float32, device=device)
    het_res = fn(*het)
    het_sr = nt.shear_response(het_res)
    _sync(device)
    out = dict(
        m=m_of(sr), het_m=m_of(het_sr), R11=float(sr["R"][0, 0]),
        flagged=int((res["noshear"]["flags"] != 0).sum()),
        het_flagged=int((het_res["noshear"]["flags"] != 0).sum()),
        stamps_per_s=B / dt, sec=dt, sec_range=(min(times), max(times)),
    )
    for r in (res, het_res):
        for t in nt.batch.GALSHEAR_TYPES:
            pars = r[t]["pars"]
            ok = r[t]["flags"] == 0
            if tuple(pars.shape) != (B, 6) or not bool(torch.isfinite(pars[ok]).all()):
                raise SmokeFailure("bad pars for type %s: shape %s or not finite"
                                   % (t, tuple(pars.shape)))
    return out, hom


def compare_card_cpu(hom, n=256):
    """per-lane float64 run of the first n stamps on the card and the CPU"""
    args = [a[:n].double() for a in hom]
    card = nt.make_metacal_pipeline_fn(CONF, device="cuda")(*args)
    cpu = nt.make_metacal_pipeline_fn(CONF, device="cpu")(*(a.cpu() for a in args))
    worst = 0.0
    for t in nt.batch.GALSHEAR_TYPES:
        if not torch.equal(card[t]["flags"].cpu(), cpu[t]["flags"]):
            raise SmokeFailure("flags differ between card and CPU for %s" % t)
        for k in ("pars", "s2n"):
            a, b = card[t][k].cpu(), cpu[t][k]
            err = (a - b).abs()
            if bool((err > 1e-10 + 1e-8 * b.abs()).any()):
                raise SmokeFailure("%s/%s differ between card and CPU: max %.3e"
                                   % (t, k, float(err.max())))
            worst = max(worst, float((err / b.abs().clamp_min(1e-300)).max()))
    return worst


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main_path_shapes(device, B):
    """K2's two inputs on the main path: the gaussmom weight over the
    stacked 19x19 fit windows ([5 B, 361], area a tensor) and the sims'
    galaxies over 49x49 stamps ([B, 2401], n = 18, scalar area)"""
    dtype = torch.float32
    gen = torch.Generator(device=device).manual_seed(7)
    nb = NTYPES * B
    g = torch.arange(19, dtype=dtype, device=device)
    rr, cc = torch.meshgrid(g, g, indexing="ij")
    cen = 9.0 + torch.rand((nb, 2), generator=gen, device=device, dtype=dtype) - 0.5
    v = ((rr.reshape(-1)[None] - cen[:, :1]) * 0.263).contiguous()
    u = ((cc.reshape(-1)[None] - cen[:, 1:]) * 0.263).contiguous()
    wt = make_weight_gmix(1.2, dtype=dtype, device=device).expand(nb, 1, 6).contiguous()
    gaussmom = (wt, v, u, torch.full_like(v, 0.263**2))

    gal_pars = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.5, 100.0], dtype=dtype,
                            device=device).expand(B, 6)
    gal, _ = gcore.fill_exp(gal_pars)
    psf, _ = gcore.fill_turb(torch.tensor([0.0, 0.0, 0.025, -0.01, 0.27, 1.0],
                                          dtype=dtype, device=device))
    conv = gcore.gmix_convolve(gcore.gmix_get_sheared(gal, SHEAR_TRUE, 0.0),
                               psf.expand(B, 3, 6)).contiguous()
    g49 = torch.arange(49, dtype=dtype, device=device)
    rr, cc = torch.meshgrid(g49, g49, indexing="ij")
    cens = 24.0 + torch.rand((B, 2), generator=gen, device=device, dtype=dtype) - 0.5
    sv = ((rr.reshape(-1)[None] - cens[:, :1]) * 0.263).contiguous()
    su = ((cc.reshape(-1)[None] - cens[:, 1:]) * 0.263).contiguous()
    sims = (conv, sv, su, 0.263**2)
    return {"gaussmom n=1 [%dx361]" % nb: gaussmom,
            "sims n=18 [%dx2401]" % B: sims}


def bound(gm, v, area):
    """least time (ms) for K2's work: each input read once and the
    output written once at the memory rate, or its operations at the
    float peak, whichever is larger"""
    Bn, n, _ = gm.shape
    P = v.shape[1]
    esize = v.element_size()
    nbytes = esize * (gm.numel() + 3 * Bn * P)
    if isinstance(area, torch.Tensor):
        nbytes += esize * Bn * P
    ops = Bn * P * (OPS_PER_PIXEL_GAUSS * n + 1)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[v.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_kernel(shapes):
    """K2 at each main-path shape: held against its plain version on
    the same inputs, then timed beside it and its bound"""
    rows = []
    for name, (gm, v, u, area) in shapes.items():
        err, rel = compare(gmix_eval.eval_gmix(gm, v, u, area, fast=False),
                           _plain_chunked(gm, v, u, area, False), name)
        ms = time_ms(lambda: gmix_eval.eval_gmix(gm, v, u, area, fast=False), 20)
        plain_ms = time_ms(
            lambda: gmix_eval.eval_gmix_plain(gm, v, u, area, fast=False), 3, warmup=1
        )
        b_ms, by = bound(gm, v, area)
        rows.append(dict(shape=name, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=by, max_abs_err=err, max_rel_err=rel))
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr, flush=True)
        return 2
    device = "cuda"
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase_line("1 card", t0, "%s, %d device(s)" % (kind, torch.cuda.device_count()))

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    phase_line("2 build", t0, str(path.relative_to(path.parents[2])))

    t0 = time.perf_counter()
    max_abs, ncase, worst = check_kernel(device)
    phase_line("3 kernel", t0, "%d cases agree; max abs err %.3e; max rel err "
               "f32 %.3e f64 %.3e" % (ncase, max_abs, worst[torch.float32],
                                      worst[torch.float64]))

    t0 = time.perf_counter()
    gmix_eval.launches = 0
    mp, hom = run_main(device, B_MAIN)
    launches = gmix_eval.launches
    limit = max(8, int(0.005 * B_MAIN))
    phase_line(
        "4 main", t0,
        "B=%d m=%.3e hetero_m=%.3e R11=%.4f flagged=%d hetero_flagged=%d "
        "k2_launches=%d stamps/s=%.1f (median %.4f s/call of 3, range "
        "%.4f-%.4f)"
        % (B_MAIN, mp["m"], mp["het_m"], mp["R11"], mp["flagged"],
           mp["het_flagged"], launches, mp["stamps_per_s"], mp["sec"],
           *mp["sec_range"]),
    )
    if launches <= 0:
        raise SmokeFailure("the main path did not launch K2")
    if not (abs(mp["m"]) < 1e-3 and abs(mp["het_m"]) < 1e-3):
        raise SmokeFailure("m gate failed: m=%.3e hetero m=%.3e"
                           % (mp["m"], mp["het_m"]))
    if mp["flagged"] > limit or mp["het_flagged"] > limit:
        raise SmokeFailure("too many flagged lanes: %d, %d > %d"
                           % (mp["flagged"], mp["het_flagged"], limit))

    t0 = time.perf_counter()
    worst_rel = compare_card_cpu(hom)
    phase_line("5 cpu", t0, "256 stamps float64: flags equal, pars/s2n max rel "
               "diff %.3e" % worst_rel)
    del hom

    t0 = time.perf_counter()
    rows = time_kernel(main_path_shapes(device, B_MAIN))
    for r in rows:
        print("    K2 %s: agrees (max abs err %.3e, rel %.3e); %.4f ms, plain "
              "%.4f ms, bound %.4f ms (%s)"
              % (r["shape"], r["max_abs_err"], r["max_rel_err"], r["ms"],
                 r["plain_ms"], r["bound_ms"], r["bound_by"]), flush=True)
    phase_line("6 times", t0, "total %.1f s" % (time.perf_counter() - t_all))

    top = rows[0]
    print(json.dumps({"kernels": [{
        "name": "gmix_eval",
        "route": "cuda",
        "source": "ngmix_tpu_torch/csrc/gmix_eval.cu",
        "replaces": "ngmix_tpu/ops/pallas_gmix.py:88",
        "launches": launches,
        "max_abs_err": max(max_abs, *(r["max_abs_err"] for r in rows)),
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
        "shapes": rows,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print("chip_smoke FAILED: %s" % exc, flush=True)
        sys.exit(1)
