"""Smoke run of the PyTorch port (ngmix_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths on the card, bench.py's
metacal_gaussmom workload and its exp-LM headline at the production
chunk size, and holds the hand-written CUDA kernels K2 (mixture
evaluation) and K1 (LM normal equations) against their plain PyTorch
versions. Phases, in order, each printing one timed line as soon as it
ends:

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
           tolerances, and timed beside its bound;
7. k1:     K1 against its plain version on the same CUDA inputs over
           n in {1, 6, 10}, float32 and float64, B in {1, 3, 51200}
           and P in {361, 1000, 1089}, with an invalid gaussian in one
           lane: in float64 cost to rtol 1e-10, Jtr and JtJ to rtol
           1e-8 with an atol of 1e-8 times the largest |value|
           (tests/test_pallas_lm.py:65-73); in float32 cost to rtol
           1e-5, Jtr and JtJ to rtol 1e-5 with an atol of 1e-5 times
           their Cauchy-Schwarz scale, sqrt(JtJ_kk cost) for Jtr_k and
           sqrt(JtJ_kk JtJ_mm) for JtJ_km, which bounds the sum of the
           absolute terms float32 rounds (the signed sums cancel);
8. exp-lm: the exp-LM metacal pipeline in float32 on the homogeneous
           and heterogeneous sims at B = 10240 (5 B = 51200 lanes),
           gated like bench.py: |m| < 1e-3, |hetero m| < 1e-3, flagged
           lanes <= max(8, 0.5% B), e1 equal to pars[:, 2] bit for
           bit, and K1 and K2 launched; prints nfev, the LM iterations
           per compaction level and the fraction of lanes frozen at
           their guess (flags 0, nfev <= 2, pars equal to the guess);
9. lm-cpu: the first 256 stamps in float64 on the card and on the CPU:
           flags equal, e1/e2/T/flux to rtol 1e-5 and atol 1e-7, nfev
           within 2 (tests/test_pallas_lm.py:107-123);
10. compact: the exp-LM measure at B = 2048 (10240 lanes) with the
           automatic compaction cascade and without: pars, flags, nfev,
           ier and cost bitwise equal;
11. k-times: K1 at its main-path shape (n = 6 over [5 B, 361], float32,
           the inputs of the pipeline's first normal-equation call) and
           K2 at the exp-LM path's new shape (n = 6, fast, over
           [5 B, 361], the inputs of get_loglike's call), each held
           against its plain version (K1 in float32: cost to rtol 1e-3,
           Jtr and JtJ to rtol 1e-3 with an atol of 1e-4 times their
           Cauchy-Schwarz scale, since the residual f ia - ve cancels to
           the noise level at a peak signal-to-noise of ~1e3; K2 at
           phase 3's tolerances) and timed beside its bound.

Needs one CUDA card and exits nonzero, printing the reason, on any
failure or without a card. The last line is the JSON result.
"""
import json
import subprocess
import sys
import time
from unittest import mock

import torch

import ngmix_tpu_torch as nt
from ngmix_tpu_torch.fitting import lm as tlm
from ngmix_tpu_torch.gmix import core as gcore
from ngmix_tpu_torch.gaussmom import make_weight_gmix
from ngmix_tpu_torch.ops import _build, gmix_eval, normal_eqs

B_MAIN = 10240
B_COMPACT = 2048
NTYPES = 5
CONF = nt.sims.METACAL_GAUSSMOM_CONFIG
LM_CONF = nt.sims.METACAL_EXP_LM_CONFIG
SHEAR_TRUE = nt.sims.SHEAR_TRUE

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# K2's arithmetic per (pixel, gaussian): offsets 2, chi2 9, exponent
# scale 1, exp 1, pnorm product 1, accumulate 1; plus the area product
# per pixel
OPS_PER_PIXEL_GAUSS = 15
# K1's arithmetic, counted from csrc/normal_eqs.cu with a fused
# multiply-add as 2 operations and an exp as 1: per (pixel, gaussian)
# the offsets and chi2 (11); per pair inside the window [0, 25) the
# exponential and its argument, the value, f, c, the six derivatives and
# the 36-term chain product (92); per pair in the apodized band
# (20, 25] the window and its derivative (14); per pixel the residual,
# the weighted J and the 28 running sums (64)
K1_OPS_PAIR, K1_OPS_INWIN, K1_OPS_HOT, K1_OPS_PIXEL = 11, 92, 14, 64


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
    err = (out.double() - ref.double()).abs()
    if out.dtype == torch.float64:
        thr = 1e-12 * ref.abs()
    else:
        lane_max = ref.abs().amax(dim=-1, keepdim=True)
        thr = 1e-5 * ref.abs().double() + 1e-6 * lane_max.double()
    # a NaN error or threshold fails too
    if not bool(torch.isfinite(ref).all()) or not bool((err <= thr).all()):
        raise SmokeFailure("K2 disagrees with its plain version or is not finite: "
                           "%s, max err %.3e" % (what, float(err.max())))
    tiny = torch.finfo(ref.dtype).tiny
    return float(err.max()), float((err / ref.abs().double().clamp_min(tiny)).max())


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


# ----------------------------------------------------------------------
# K1 and the exp-LM path

def _k1_case(gen, B, n, P, dtype):
    """K1's inputs: the reparametrized random mixtures of _random_case
    (with an invalid gaussian in the last lane), a random chain and
    random weighted planes"""
    gm, v, u, _ = _random_case(gen, B, n, P, dtype, True)
    dev = gen.device
    rp = normal_eqs.gmix_reparam(gm).contiguous()
    chain = torch.randn((B, n, 6, 6), generator=gen, device=dev, dtype=dtype)
    ia = torch.rand((B, P), generator=gen, device=dev, dtype=dtype) * 100.0 + 50.0
    ve = torch.randn((B, P), generator=gen, device=dev, dtype=dtype) * 20.0
    return rp, chain, v, u, ia, ve


def _k1_plain_chunked(rp, chain, v, u, ia, ve, chunk=2048):
    """K1's plain version in lane chunks, bounding its [B, n, P] memory"""
    outs = [
        normal_eqs.gmix_normal_eqs_plain(*(x[i:i + chunk] for x in (rp, chain, v, u, ia, ve)))
        for i in range(0, rp.shape[0], chunk)
    ]
    return [torch.cat(parts) for parts in zip(*outs)]


def k1_scale(cost, JtJ):
    """the natural error scale of K1's signed sums, by Cauchy-Schwarz:
    sum_p |J_k ia fd| <= sqrt(JtJ_kk cost) for Jtr_k and sum_p
    |J_k J_m| ia^2 <= sqrt(JtJ_kk JtJ_mm) for JtJ_km"""
    d = torch.diagonal(JtJ, dim1=-2, dim2=-1).clamp_min(0).double()
    cost = cost.double()
    return torch.sqrt(d * cost[:, None]), torch.sqrt(d[:, :, None] * d[:, None, :])


def compare_k1(out, ref, what, tol32=(1e-5, 1e-5)):
    """hold K1's (cost, Jtr, JtJ) against its plain version's. float64:
    cost to rtol 1e-10, Jtr and JtJ to rtol 1e-8 with an atol of 1e-8
    times the largest |value|. float32: cost to rtol tol32[0]; Jtr and
    JtJ to rtol tol32[0] with an atol of tol32[1] times their
    Cauchy-Schwarz scale (k1_scale), which bounds the sum of the
    absolute terms that float32 rounds. Errors, thresholds and scales
    are taken in float64; a value, threshold or error that is not
    finite fails. Returns the largest absolute error and the largest
    error relative to |value| plus its scale."""
    max_abs, max_rel = 0.0, 0.0
    scales = (torch.zeros_like(ref[0], dtype=torch.float64),) + k1_scale(ref[0], ref[2])
    for i, (a, b) in enumerate(zip(out, ref)):
        a64, b64 = a.double(), b.double()
        err = (a64 - b64).abs()
        if a.dtype == torch.float64:
            thr = 1e-10 * b64.abs() if i == 0 else 1e-8 * b64.abs() + 1e-8 * b64.abs().max()
        elif i == 0:
            thr = tol32[0] * b64.abs()
        else:
            thr = tol32[0] * b64.abs() + tol32[1] * scales[i]
        bad = ~(torch.isfinite(thr) & (err <= thr))
        if bool(bad.any()):
            lane = int(bad.reshape(bad.shape[0], -1).any(-1).nonzero()[0, 0])
            raise SmokeFailure(
                "K1 disagrees with its plain version or is not finite: %s, output %d, "
                "max err %.3e; first bad lane %d: kernel %s plain %s" % (
                    what, i, float(err.max()), lane, a[lane].tolist(), b[lane].tolist()))
        max_abs = max(max_abs, float(err.max()))
        denom = (b64.abs() + scales[i]).clamp_min(torch.finfo(b.dtype).tiny)
        max_rel = max(max_rel, float((err / denom).max()))
    return max_abs, max_rel


def check_k1(device):
    """K1 against its plain version over every listed case"""
    gen = torch.Generator(device=device).manual_seed(2025)
    max_abs, ncase = 0.0, 0
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    for dtype in (torch.float32, torch.float64):
        for n in (1, 6, 10):
            for B in (1, 3, NTYPES * B_MAIN):
                for P in (361, 1000, 1089):
                    args = _k1_case(gen, B, n, P, dtype)
                    err, rel = compare_k1(
                        normal_eqs.gmix_normal_eqs(*args), _k1_plain_chunked(*args),
                        "dtype=%s n=%d B=%d P=%d" % (dtype, n, B, P))
                    max_abs = max(max_abs, err)
                    worst[dtype] = max(worst[dtype], rel)
                    ncase += 1
    return max_abs, ncase, worst


def run_exp_lm(device, B):
    """the exp-LM main path: sims -> pipeline -> shear_response,
    homogeneous and heterogeneous, float32, with the kernels' launch
    counts of those two calls; then three timed calls and the guess of
    every lane (a run with maxfev = 1, which takes no step) for the
    frozen fraction"""
    fn = nt.make_metacal_pipeline_fn(LM_CONF, measure="exp-lm", device=device)
    hom = nt.make_sim_batch(torch.Generator(device=device).manual_seed(314), B,
                            torch.float32, device=device)
    het = nt.make_sim_batch_hetero(torch.Generator(device=device).manual_seed(271),
                                   B, torch.float32, device=device)
    _sync(device)
    normal_eqs.launches = gmix_eval.launches = 0
    res = fn(*hom)
    het_res = fn(*het)
    _sync(device)
    launches = dict(k1=normal_eqs.launches, k2=gmix_eval.launches)
    sr = nt.shear_response(res)
    het_sr = nt.shear_response(het_res)
    times = []
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        fn(*hom)
        _sync(device)
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[1]
    guess = nt.make_metacal_pipeline_fn(
        LM_CONF, measure="exp-lm", lm_conf=nt.LMConf(maxfev=1), device=device
    )(*hom)
    _sync(device)

    types = nt.batch.GALSHEAR_TYPES
    for r in (res, het_res):
        for t in types:
            if not torch.equal(r[t]["e1"], r[t]["pars"][:, 2]):
                raise SmokeFailure("e1 is not pars[:, 2] for type %s" % t)
            if tuple(r[t]["pars"].shape) != (B, 6):
                raise SmokeFailure("bad pars shape %s" % (tuple(r[t]["pars"].shape),))
            ok = r[t]["flags"] == 0
            if not bool(torch.isfinite(r[t]["pars"][ok]).all()):
                raise SmokeFailure("non-finite pars for type %s" % t)
    flags = torch.cat([res[t]["flags"] for t in types])
    nfev = torch.cat([res[t]["nfev"] for t in types])
    het_nfev = torch.cat([het_res[t]["nfev"] for t in types])
    cascade = nt.batch._auto_cascade(nfev.numel())
    frozen = (
        (flags == 0) & (nfev <= 2)
        & torch.all(torch.cat([res[t]["pars"] == guess[t]["pars"] for t in types]), dim=-1)
    )
    return dict(
        m=m_of(sr), het_m=m_of(het_sr), R11=float(sr["R"][0, 0]),
        flagged=int((res["noshear"]["flags"] != 0).sum()),
        het_flagged=int((het_res["noshear"]["flags"] != 0).sum()),
        nfev_p50=float(torch.quantile(nfev.double(), 0.5)), nfev_max=int(nfev.max()),
        levels=tlm.compaction_levels(nfev, cascade),
        het_levels=tlm.compaction_levels(het_nfev, cascade), launches=launches,
        frozen=float(frozen.double().mean()),
        stamps_per_s=B / dt, sec=dt, sec_range=(min(times), max(times)),
    ), hom


def compare_lm_card_cpu(hom, n=256):
    """per-lane float64 exp-LM run of the first n stamps on the card and
    the CPU"""
    args = [a[:n].double() for a in hom]
    card = nt.make_metacal_pipeline_fn(LM_CONF, measure="exp-lm", device="cuda")(*args)
    cpu = nt.make_metacal_pipeline_fn(LM_CONF, measure="exp-lm", device="cpu")(
        *(a.cpu() for a in args))
    worst, dnfev = 0.0, 0
    for t in nt.batch.GALSHEAR_TYPES:
        if not torch.equal(card[t]["flags"].cpu(), cpu[t]["flags"]):
            raise SmokeFailure("LM flags differ between card and CPU for %s" % t)
        d = int((card[t]["nfev"].cpu() - cpu[t]["nfev"]).abs().max())
        if d > 2:
            raise SmokeFailure("nfev differs by %d between card and CPU for %s" % (d, t))
        dnfev = max(dnfev, d)
        for k in ("e1", "e2", "T", "flux"):
            a, b = card[t][k].cpu(), cpu[t][k]
            err = (a - b).abs()
            if bool((err > 1e-7 + 1e-5 * b.abs()).any()):
                raise SmokeFailure("%s/%s differ between card and CPU: max %.3e"
                                   % (t, k, float(err.max())))
            worst = max(worst, float((err / b.abs().clamp_min(1e-300)).max()))
    return worst, dnfev


def check_compaction(hom, device):
    """the exp-LM pipeline at B_COMPACT stamps with the automatic
    compaction cascade and with none (the cascade patched to no
    levels): the per-lane results must be bitwise equal"""
    args = [a[:B_COMPACT] for a in hom]
    fn = nt.make_metacal_pipeline_fn(LM_CONF, measure="exp-lm", device=device)
    cascade = fn(*args)
    with mock.patch.object(nt.batch, "_auto_cascade", lambda B: ()):
        flat = fn(*args)
    for t in nt.batch.GALSHEAR_TYPES:
        for k in ("pars", "flags", "nfev", "ier", "cost"):
            if not torch.equal(cascade[t][k], flat[t][k]):
                raise SmokeFailure("compaction changed %s/%s" % (t, k))
    nfev = torch.cat([cascade[t]["nfev"] for t in nt.batch.GALSHEAR_TYPES])
    return (tlm.compaction_levels(nfev, nt.batch._auto_cascade(nfev.numel())),
            tlm.compaction_levels(nfev, None))


def capture_k_inputs(hom, device):
    """the inputs of the exp-LM path's first K1 call and of its K2 call
    with fast=True (get_loglike's s/n sums), from one pipeline call"""
    seen = {}
    k1, k2 = normal_eqs.gmix_normal_eqs, gmix_eval.eval_gmix

    def k1_spy(*a):
        seen.setdefault("k1", a)
        return k1(*a)

    def k2_spy(gm, v, u, area=1.0, fast=True):
        if fast:
            seen.setdefault("k2", (gm, v, u, area))
        return k2(gm, v, u, area, fast=fast)

    with mock.patch.object(normal_eqs, "gmix_normal_eqs", k1_spy), \
            mock.patch.object(gmix_eval, "eval_gmix", k2_spy):
        nt.make_metacal_pipeline_fn(LM_CONF, measure="exp-lm", device=device)(*hom)
    return seen["k1"], seen["k2"]


def k1_bound(rp, chain, v, u, ia, ve):
    """least time (ms) for K1's work on these inputs: each input read
    once and the outputs written once at the memory rate, or the
    operations this data needs (pairs inside the window and in its
    apodized band counted from chi2) at the float peak, whichever is
    larger"""
    Bn, n, _ = rp.shape
    P = v.shape[1]
    esize = v.element_size()
    nbytes = esize * (rp.numel() + chain.numel() + 4 * Bn * P + Bn * (1 + 6 + 36))
    inwin = hot = 0
    for i in range(0, Bn, 4096):
        q = rp[i:i + 4096, :, :, None]
        dv = v[i:i + 4096, None, :] - q[:, :, 1]
        du = u[i:i + 4096, None, :] - q[:, :, 2]
        chi2 = (q[:, :, 3] * dv + q[:, :, 4] * du) * dv + (q[:, :, 4] * dv + q[:, :, 5] * du) * du
        win = (chi2 >= 0) & (chi2 < 25.0)
        inwin += int(win.sum())
        hot += int((win & (chi2 > 20.0)).sum())
    ops = (K1_OPS_PAIR * Bn * n * P + K1_OPS_INWIN * inwin + K1_OPS_HOT * hot
           + K1_OPS_PIXEL * Bn * P)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[v.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_lm_kernels(hom, device):
    """K1 and K2 at the exp-LM path's shapes: held against their plain
    versions on the pipeline's own inputs, then timed beside their
    bounds"""
    k1_args, (gm, v, u, area) = capture_k_inputs(hom, device)
    rows = []
    err, rel = compare_k1(normal_eqs.gmix_normal_eqs(*k1_args), _k1_plain_chunked(*k1_args),
                          "main-path shape", tol32=(1e-3, 1e-4))
    ms = time_ms(lambda: normal_eqs.gmix_normal_eqs(*k1_args), 20)
    plain_ms = time_ms(lambda: normal_eqs.gmix_normal_eqs_plain(*k1_args), 3, warmup=1)
    b_ms, by = k1_bound(*k1_args)
    rows.append(dict(kernel="K1", shape="n=%d [%dx%d]" % (k1_args[0].shape[1], *k1_args[2].shape),
                     ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                     max_abs_err=err, max_rel_err=rel))
    err, rel = compare(gmix_eval.eval_gmix(gm, v, u, area, fast=True),
                       _plain_chunked(gm, v, u, area, True), "get_loglike shape")
    ms = time_ms(lambda: gmix_eval.eval_gmix(gm, v, u, area, fast=True), 20)
    plain_ms = time_ms(lambda: gmix_eval.eval_gmix_plain(gm, v, u, area, fast=True), 3,
                       warmup=1)
    b_ms, by = bound(gm, v, area)
    rows.append(dict(kernel="K2", shape="exp-lm get_loglike n=%d fast [%dx%d]"
                     % (gm.shape[1], *v.shape), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
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

    t0 = time.perf_counter()
    k1_abs, k1_ncase, k1_worst = check_k1(device)
    phase_line("7 k1", t0, "%d cases agree; max abs err %.3e; max err relative to "
               "|value| + scale f32 %.3e f64 %.3e"
               % (k1_ncase, k1_abs, k1_worst[torch.float32], k1_worst[torch.float64]))

    t0 = time.perf_counter()
    lp, hom = run_exp_lm(device, B_MAIN)
    k1_launches, k2_lm_launches = lp["launches"]["k1"], lp["launches"]["k2"]
    phase_line(
        "8 exp-lm", t0,
        "B=%d m=%.3e hetero_m=%.3e R11=%.4f flagged=%d hetero_flagged=%d "
        "nfev p50=%g max=%d frozen=%.4f launches of the hom and het calls: k1=%d k2=%d "
        "stamps/s=%.1f (median %.4f s/call of 3, range %.4f-%.4f)"
        % (B_MAIN, lp["m"], lp["het_m"], lp["R11"], lp["flagged"], lp["het_flagged"],
           lp["nfev_p50"], lp["nfev_max"], lp["frozen"], k1_launches, k2_lm_launches,
           lp["stamps_per_s"], lp["sec"], *lp["sec_range"]),
    )
    print("    LM iterations per level (lanes, iterations): hom %s het %s"
          % (lp["levels"], lp["het_levels"]), flush=True)
    if k1_launches <= 0 or k2_lm_launches <= 0:
        raise SmokeFailure("the exp-LM path did not launch K1 and K2: %d, %d"
                           % (k1_launches, k2_lm_launches))
    if not (abs(lp["m"]) < 1e-3 and abs(lp["het_m"]) < 1e-3):
        raise SmokeFailure("exp-LM m gate failed: m=%.3e hetero m=%.3e"
                           % (lp["m"], lp["het_m"]))
    if lp["flagged"] > limit or lp["het_flagged"] > limit:
        raise SmokeFailure("too many flagged exp-LM lanes: %d, %d > %d"
                           % (lp["flagged"], lp["het_flagged"], limit))

    t0 = time.perf_counter()
    lm_worst, dnfev = compare_lm_card_cpu(hom)
    phase_line("9 lm-cpu", t0, "256 stamps float64: flags equal, e1/e2/T/flux max "
               "rel diff %.3e, max nfev diff %d" % (lm_worst, dnfev))

    t0 = time.perf_counter()
    lv_cascade, lv_flat = check_compaction(hom, device)
    phase_line("10 compact", t0, "B=%d: cascade %s and no compaction %s bitwise equal"
               % (B_COMPACT, lv_cascade, lv_flat))

    t0 = time.perf_counter()
    lm_rows = time_lm_kernels(hom, device)
    del hom
    for r in lm_rows:
        print("    %s %s: agrees (max abs err %.3e, rel %.3e); %.4f ms, plain "
              "%.4f ms, bound %.4f ms (%s)"
              % (r["kernel"], r["shape"], r["max_abs_err"], r["max_rel_err"], r["ms"],
                 r["plain_ms"], r["bound_ms"], r["bound_by"]), flush=True)
    phase_line("11 k-times", t0, "total %.1f s" % (time.perf_counter() - t_all))

    top = rows[0]
    k1_row = lm_rows[0]
    print(json.dumps({"kernels": [{
        "name": "gmix_eval",
        "route": "cuda",
        "source": "ngmix_tpu_torch/csrc/gmix_eval.cu",
        "replaces": "ngmix_tpu/ops/pallas_gmix.py:88",
        "launches": launches + k2_lm_launches,
        "launches_by_path": {"gaussmom": launches, "exp-lm": k2_lm_launches},
        "max_abs_err": max(max_abs, *(r["max_abs_err"] for r in rows),
                           lm_rows[1]["max_abs_err"]),
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
        "shapes": rows + [lm_rows[1]],
    }, {
        "name": "normal_eqs",
        "route": "cuda",
        "source": "ngmix_tpu_torch/csrc/normal_eqs.cu",
        "replaces": "ngmix_tpu/ops/pallas_lm.py:149",
        "launches": k1_launches,
        "max_abs_err": max(k1_abs, k1_row["max_abs_err"]),
        "ms": k1_row["ms"],
        "plain_ms": k1_row["plain_ms"],
        "bound_ms": k1_row["bound_ms"],
        "bound_by": k1_row["bound_by"],
        "library_ms": None,
        "shapes": [k1_row],
    }]}, allow_nan=False), flush=True)
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
