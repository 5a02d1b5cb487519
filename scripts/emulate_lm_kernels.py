"""Run the CUDA sources of K3, its options kernel and K3-mb on the CPU,
one warp as 32 threads, and hold them against their plain versions.

    python scripts/emulate_lm_kernels.py [--B 8]

No card and no nvcc: g++ (C++20) builds ``csrc/lm_solve_opt.cuh`` and
``csrc/lm_solve_mb.cuh`` as they are, against a stub of the CUDA
runtime (below): ``__syncwarp`` is a ``std::barrier`` of 32
``std::thread``s, the shuffles and ``__any_sync`` pass through an
exchange buffer, ``cp.async`` copies, the launches (``<<<...>>>``) are
stripped. So the kernels' own code runs: the gaussians' records, the
pixel pass's tile, the LM state in the warp's shared memory, the step
split over the warp, the prior rows, the bounds chain. Each case captures a
measure's solve inputs from the pipeline on the CPU (the exp sims and
the bdf-truth sims of chip_smoke.py at B stamps; the mb bdf-truth sims
at B / 2 objects: bdf, exp and gauss, whose planes go into shared
memory, at nband 2, bd at nband 6), runs the emulated kernel in float64
and its plain version, and prints the largest relative difference of y,
cost and JtJ (scaled by each array's largest entry) and the lanes whose nfev, done,
ier flags or pinned dims differ; it exits nonzero if a float64 case
differs by more than rtol 1e-8 or in any of those. float32 cases print
the same, for reading: float32 rounding may part the solves.
"""
import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import ngmix_tpu_torch as nt  # noqa: E402
from ngmix_tpu_torch.fitting import lm as tlm  # noqa: E402
from ngmix_tpu_torch.ops import lm_solve  # noqa: E402

STUB = r"""// a stub of the CUDA runtime for a CPU emulation of the kernels: one
// warp as 32 std::threads, __syncwarp a std::barrier, the shuffles
// through an exchange buffer
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstddef>
using std::isfinite;
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __constant__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3 threadIdx;
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) double2 { double x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline double2 make_double2(double a, double b) { return {a, b}; }
inline std::barrier<>* g_bar = nullptr;
inline unsigned char g_xchg[32][8];
inline void __syncwarp(unsigned = 0xffffffffu) { g_bar->arrive_and_wait(); }
template <typename V> V __shfl_sync(unsigned, V v, int src) {
  std::memcpy(g_xchg[threadIdx.x], &v, sizeof(V));
  g_bar->arrive_and_wait();
  V r;
  std::memcpy(&r, g_xchg[src], sizeof(V));
  g_bar->arrive_and_wait();
  return r;
}
template <typename V> V __shfl_down_sync(unsigned, V v, int off) {
  std::memcpy(g_xchg[threadIdx.x], &v, sizeof(V));
  g_bar->arrive_and_wait();
  V r = v;
  if (threadIdx.x + off < 32) std::memcpy(&r, g_xchg[threadIdx.x + off], sizeof(V));
  g_bar->arrive_and_wait();
  return r;
}
inline unsigned __ballot_sync(unsigned, bool p) {
  g_xchg[threadIdx.x][0] = p;
  g_bar->arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= static_cast<unsigned>(g_xchg[i][0] != 0) << i;
  g_bar->arrive_and_wait();
  return r;
}
inline bool __any_sync(unsigned, bool p) {
  g_xchg[threadIdx.x][0] = p;
  g_bar->arrive_and_wait();
  bool r = false;
  for (int i = 0; i < 32; ++i) r = r || g_xchg[i][0];
  g_bar->arrive_and_wait();
  return r;
}
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline double __longlong_as_double(long long i) { double f; std::memcpy(&f, &i, 8); return f; }
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8, cudaDevAttrMultiProcessorCount = 16 };
struct cudaFuncAttributes { int numRegs; size_t sharedSizeBytes, localSizeBytes; };
template <typename K> int cudaFuncSetAttribute(K, int, int) { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return 0; }
template <typename K> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* v, K, int, size_t) { *v = 1; return 0; }
template <typename K> int cudaFuncGetAttributes(cudaFuncAttributes* a, K) { *a = {}; return 0; }
inline int cudaGetLastError() { return 0; }
"""

HARNESS = r"""// the kernels of K3, its options kernel and K3-mb run on the CPU, one
// warp as 32 threads (the CUDA emulation of cuda_runtime.h)
#include <thread>
#include <vector>
namespace {
__attribute__((aligned(16))) unsigned char smem_raw[1 << 20];
}
#include "lm_solve_opt.cuh"
#include "lm_solve_mb.cuh"

template <typename F>
void run_warp(F&& f) {
  std::barrier<> bar(32);
  g_bar = &bar;
  std::vector<std::thread> th;
  for (int t = 0; t < 32; ++t) th.emplace_back([&, t] { threadIdx.x = t; f(); });
  for (auto& t : th) t.join();
}

template <typename T>
Out<T> out_of(void** o) {
  return Out<T>{(T*)o[0], (T*)o[1], (T*)o[2], (T*)o[3], (T*)o[4], (T*)o[5], (int32_t*)o[6],
                (uint8_t*)o[7], (uint8_t*)o[8], (uint8_t*)o[9], (uint8_t*)o[10]};
}

template <typename T, typename M>
int k3(void** in, void** o, const double* prior, int B, int P, int nprior, int maxfev,
       const double* c, int at_floor, int mode, int niter, void** full) {
  Conf conf{c[0], c[1], c[2], c[3], c[4], c[5], c[6], maxfev, at_floor != 0};
  int counter = 0;
  Args<T> a{(const T*)in[0], (const T*)in[1], (const T*)in[2], (const T*)in[3], (const T*)in[4],
            (const T*)in[5], (const T*)in[6], (const T*)in[7], out_of<T>(o), &counter, prior, B,
            P, nprior, conf};
  if (mode == 0) {
    if (P <= kMaxP) run_warp([&] { lm_solve_kernel<T, M, true>(a); });
    else run_warp([&] { lm_solve_kernel<T, M, false>(a); });
  } else {
    a.conf.at_floor = false;
    OptArgs<T> op{mode, niter, 1.0e-6,
                  FullOut<T>{full ? (T*)full[0] : nullptr, full ? (T*)full[1] : nullptr,
                             full ? (T*)full[2] : nullptr, full ? (T*)full[3] : nullptr,
                             full ? (T*)full[4] : nullptr}, P <= kMaxP};
    run_warp([&] { lm_solve_opt_kernel<T, M>(a, op); });
  }
  return 0;
}

template <typename T, typename M, int NB>
int k3mb(void** in, void** o, const double* prior, int B, int E, int P, int nprior, int maxfev,
         const double* c, int at_floor) {
  int counter = 0;
  MbArgs<T> a{(const T*)in[0], (const T*)in[1], (const T*)in[2], (const T*)in[3],
              (const int32_t*)in[4], (const T*)in[5], (const T*)in[6], (const T*)in[7],
              (const T*)in[8], out_of<T>(o), &counter, prior, B, E, P, nprior,
              E * P <= kMaxP && Tuning<M>::kMbSharedPlanes,
              Conf{c[0], c[1], c[2], c[3], c[4], c[5], c[6], maxfev, at_floor != 0}};
  run_warp([&] { lm_solve_mb_kernel<T, M, NB>(a); });
  return 0;
}

#define K3(NAME, T, M)                                                                    \
  extern "C" int NAME(void** in, void** o, const double* prior, int B, int P, int nprior,  \
                      int maxfev, const double* c, int at_floor, int mode, int niter,      \
                      void** full) {                                                      \
    return k3<T, M>(in, o, prior, B, P, nprior, maxfev, c, at_floor, mode, niter, full);   \
  }
K3(emu_k3_exp_f64, double, ExpModel)
K3(emu_k3_exp_f32, float, ExpModel)
K3(emu_k3_bdf_f64, double, BdfModel)
K3(emu_k3_bdf_f32, float, BdfModel)
K3(emu_k3_bd_f64, double, BdModel)
K3(emu_k3_bd_f32, float, BdModel)
#define K3MB(NAME, T, M, NB)                                                               \
  extern "C" int NAME(void** in, void** o, const double* prior, int B, int E, int P,       \
                      int nprior, int maxfev, const double* c, int at_floor) {             \
    return k3mb<T, M, NB>(in, o, prior, B, E, P, nprior, maxfev, c, at_floor);             \
  }
K3MB(emu_k3mb_bdf2_f64, double, BdfModel, 2)
K3MB(emu_k3mb_bd6_f64, double, BdModel, 6)
K3MB(emu_k3mb_exp2_f32, float, ExpModel, 2)
K3MB(emu_k3mb_gauss2_f64, double, GaussModel, 2)
"""

CONF = tlm.LMConf()
EXACT = ("nfev", "done", "ier_small_step", "ier_small_cost", "pinned")


def build(out):
    """the emulation library in out, from the checkout's csrc"""
    out = Path(out)
    for f in (ROOT / "ngmix_tpu_torch" / "csrc").glob("*.cuh"):
        text = re.sub(r"<<<.*?>>>", "", f.read_text(), flags=re.S)
        # g++ ignores nvcc's unroll pragmas: their factors become static
        # assertions, which it does check
        text = re.sub(r"#pragma unroll \((.*)\)", r'static_assert((\1) > 0, "unroll");', text)
        (out / f.name).write_text(text)
    (out / "cuda_runtime.h").write_text(STUB)
    (out / "harness.cpp").write_text(HARNESS)
    lib = out / "emu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-I", str(out),
                    "-o", str(lib), str(out / "harness.cpp")], check=True)
    return ctypes.CDLL(str(lib))


def ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def conf_values():
    return (ctypes.c_double * 7)(CONF.ftol, CONF.xtol, CONF.lambda0, CONF.lambda_up,
                                 CONF.lambda_down, CONF.lambda_min, CONF.lambda_max)


def emu_k3(lib, model, args, prior=None, mode=0, niter=0):
    """the emulated K3 (mode 0), refine (1) or varpro (2) state"""
    g = args[0]
    out = lm_solve._empty_state(g)
    full = None
    if mode == 2:
        g = g.clone()
        g[:, -1] = 0.0
        full = {k: out[k].new_empty(out[k].shape) for k in ("y", "cost", "cost_pix", "Jtr", "JtJ")}
    args = (g,) + tuple(args[1:])
    tab, nprior = lm_solve._prior_table(prior, torch.device("cpu"))
    dt = "f64" if g.dtype == torch.float64 else "f32"
    getattr(lib, "emu_k3_%s_%s" % (model, dt))(
        ptrs(args), ptrs(list(out.values())),
        None if tab is None else ctypes.c_void_p(tab.data_ptr()), g.shape[0], args[4].shape[1],
        nprior, CONF.maxfev, conf_values(), 0, mode, niter,
        None if full is None else ptrs(list(full.values())))
    return out, full


def emu_mb(lib, name, args, prior=None):
    g = args[0]
    out = lm_solve._empty_state(g)
    band = torch.broadcast_to(args[4], args[5].shape[:2]).contiguous()
    a = list(args[:4]) + [band] + list(args[5:9])
    tab, nprior = lm_solve._prior_table(prior, torch.device("cpu"))
    getattr(lib, name)(ptrs(a), ptrs(list(out.values())),
                       None if tab is None else ctypes.c_void_p(tab.data_ptr()), g.shape[0],
                       args[5].shape[1], args[5].shape[2], nprior, CONF.maxfev, conf_values(), 0)
    return out


def compare(a, b, what, exact=True):
    """prints the largest scaled relative difference and the lanes that
    differ; returns whether a float64 case holds"""
    rel = {}
    for k in ("y", "cost", "JtJ"):
        x, y = a[k].double(), b[k].double()
        rel[k] = float(((x - y).abs() / (y.abs() + 1e-6 * y.abs().max() + 1e-300)).max())
    lanes = {k: int((a[k] != b[k].to(a[k].dtype)).reshape(len(a[k]), -1).any(-1).sum())
             for k in EXACT if k in a}
    print("%s: max rel %s; lanes differing %s of %d"
          % (what, ", ".join("%s %.2e" % kv for kv in rel.items()), lanes, len(a["y"])),
          flush=True)
    return not exact or (max(rel.values()) <= 1e-8 and not any(lanes.values()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, default=8, help="stamps (even; mb: B / 2 objects)")
    opts = ap.parse_args()
    torch.set_num_threads(4)
    tmp = tempfile.mkdtemp()
    lib = build(tmp)
    B = opts.B
    ok = True
    truth = nt.make_sim_batch_hetero(torch.Generator().manual_seed(271), B, torch.float64,
                                     device="cpu", gal_model="bdf")
    hom = nt.make_sim_batch(torch.Generator().manual_seed(314), B, torch.float64, device="cpu")
    for model, box in (("exp", None), ("bdf", nt.sims.BDF_LM_BOUNDS), ("bd", nt.sims.BD_LM_BOUNDS)):
        kw = {} if box is None else dict(lm_bounds=box)
        args = cs.capture_k3_inputs(truth if box else hom, "cpu", measure=model + "-lm", **kw)[0]
        args = tuple(x.contiguous() for x in args)
        for dt in (torch.float64, torch.float32):
            a = tuple(x.to(dt) for x in args)
            ok &= compare(emu_k3(lib, model, a)[0], lm_solve.lm_solve_plain(*a, CONF, model),
                          "K3 %s %s" % (model, dt), dt == torch.float64)
        prior = {"exp": cs.exp_prior(), "bdf": cs.bdf_prior()}.get(model)
        if prior is not None:
            ok &= compare(emu_k3(lib, model, args, prior)[0],
                          lm_solve.lm_solve_plain(*args, CONF, model, prior),
                          "K3 %s float64 with its prior" % model)
        if model == "exp":
            ok &= compare(emu_k3(lib, model, args, mode=1, niter=3)[0],
                          lm_solve.lm_solve_plain(*args, CONF, model, refine=3),
                          "refine exp float64")
            ev, full = emu_k3(lib, model, args, mode=2)
            pv = lm_solve.lm_solve_plain(*args, CONF, model, varpro=True)
            ev = {k: (v[:, :5] if k in ("y", "Jtr", "pinned") else v[:, :5, :5] if k == "JtJ"
                      else v) for k, v in ev.items()}
            ok &= compare(ev, pv, "varpro exp float64")
            ok &= compare(dict(full, nfev=pv["full"]["nfev"]), pv["full"],
                          "varpro exp float64, the full-width evaluation")
    mb = nt.make_sim_batch_mb(torch.Generator().manual_seed(271), B // 2, torch.float64,
                              device="cpu", hetero=True, gal_model="bdf")
    for model, name in (("bdf", "emu_k3mb_bdf2_f64"), ("exp", "emu_k3mb_exp2_f32"),
                        ("gauss", "emu_k3mb_gauss2_f64")):
        box = cs.mb_box(nt.sims.BDF_LM_BOUNDS, 2) if model == "bdf" else None
        fn = nt.make_metacal_pipeline_mb_fn(cs.MB_CONF, nt.sims.MB_BAND, 2, measure=model + "-lm",
                                            lm_bounds=box, device="cpu")
        a = cs.capture_mb_inputs(fn, *mb)[0]["k3mb"]
        f64 = name.endswith("f64")
        a = tuple((x if f64 or not x.is_floating_point() else x.float()).contiguous() for x in a)
        prior = cs.bdf_prior(2) if model == "bdf" else None
        ok &= compare(emu_mb(lib, name, a, prior),
                      lm_solve.lm_solve_mb_plain(*a, CONF, model, prior),
                      "K3-mb %s nband 2 %s" % (model, "float64" if f64 else "float32"), f64)
    # six bands, one epoch each (bd)
    fn = nt.make_metacal_pipeline_mb_fn(cs.MB_CONF, nt.sims.MB_BAND, 2, measure="bd-lm",
                                        lm_bounds=cs.mb_box(nt.sims.BD_LM_BOUNDS, 2), device="cpu")
    g, lo, hi, psf, band, v, u, ia, ve = cs.capture_mb_inputs(fn, *mb)[0]["k3mb"]
    ns = g.shape[1] - 2
    a = (torch.cat([g[:, :ns], g[:, ns:][:, [0, 0, 1, 0, 0, 1]]], 1).contiguous(),
         torch.cat([lo[:ns], lo[ns:ns + 1].expand(6)]).contiguous(),
         torch.cat([hi[:ns], hi[ns:ns + 1].expand(6)]).contiguous(),
         psf.repeat(1, 2, 1).contiguous(), torch.arange(6, dtype=torch.int32)) + tuple(
        x.repeat(1, 2, 1).contiguous() for x in (v, u, ia, ve))
    ok &= compare(emu_mb(lib, "emu_k3mb_bd6_f64", a), lm_solve.lm_solve_mb_plain(*a, CONF, "bd"),
                  "K3-mb bd nband 6 float64")
    print("float64 cases hold: %s" % ok)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
