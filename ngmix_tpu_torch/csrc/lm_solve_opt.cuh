// K3's options kernel: the refine and varpro modes of every lane's solve
// of a model (exp, gauss, dev, bdf or bd), for Hopper (sm_90a).
//
// Replaces, with K3 (lm_solve.cuh), ngmix_tpu/ops/pallas_lm.py:
// gmix_normal_eqs_pallas (K1) under the reference's two other loops:
//
// - refine (mode kModeRefine): ngmix_tpu/fitting/lm.py:
//   run_gn_refine_batched, niter unconditional damped Gauss-Newton steps
//   at the damping lam_gn from the guess (the sheared metacal types from
//   the noshear optimum), each K3's evaluation, pin test and damped
//   Cholesky step with no trial evaluation and no accept test; a step
//   that is not finite is dropped; one evaluation at the final point
//   writes the state (lm_common.cuh refine_lane);
// - varpro (mode kModeVarpro): ngmix_tpu/batch.py: _run_varpro, the
//   variable projection of the flux. Each evaluation fills the unit-flux
//   model, takes one value-only pass for sum m y and sum m^2 (m = f ia,
//   y = ve; value_pass) and the optimal flux F = sum m y / sum m^2, then
//   K1's pass at flux F, whose residuals F m - y are formed pixel by
//   pixel, and folds the flux's dependence on the shape into the shape
//   block:
//
//     dF_k = -(JtJ_kF + Jtr_k / F) / JtJ_FF
//     Jtr'_k = Jtr_k + dF_k Jtr_F
//     JtJ'_kl = JtJ_kl + dF_k JtJ_lF + dF_l JtJ_kF + dF_k dF_l JtJ_FF
//
//   (the reduced cost is the pass's own, never sum y^2 - F sum m y, which
//   cancels in float32 far below ftol x cost). The LM loop of
//   lm_common.cuh runs over the NP-wide state with the flux dim held at
//   internal 0 (the wrapper zeroes the guess's flux), its row and column
//   zeroed and its diagonal 1: its step is exactly 0 and never pinned
//   (the flux is unbounded), so the loop takes the reduced solve's
//   decisions. A bad point has the reference's cost P FDIFF_BAD^2 with
//   Jtr and JtJ 0. After the loop, at q* (the benign round unit-T point
//   where q* or the loop's cost is not finite or |q*| reaches 1e9) and
//   F(q*), one full-width evaluation in the reference's bad-point
//   convention goes to the full-width outputs.
//
// One instance a model and type, with the planes' placement chosen at
// run time by K3's rule (shared memory up to kMaxP pixels where the copy
// keeps two thirds of the blocks an SM, else global memory): the modes
// are off the main path, and this keeps K3's own instances as they
// were. lm_solve_opt.cu
// instantiates exp, lm_solve_opt_<model>.cu each other model, one unit a
// model.
#pragma once

#include "lm_solve.cuh"

namespace {

constexpr int kModeRefine = 1;
constexpr int kModeVarpro = 2;

// the full-width evaluation of the varpro mode: y, cost, cost_pix [B],
// jtr [B, NP], jtj [B, NP, NP]
template <typename T>
struct FullOut {
  T* y;
  T* cost;
  T* cost_pix;
  T* jtr;
  T* jtj;
};

template <typename T>
struct OptArgs {
  int mode;
  int niter;
  double lam_gn;
  FullOut<T> full;
  bool smem_planes;  // set by launch_opt
};

// the unit-flux model's optimal flux at the external shape columns
// s.x (the flux slot unused): fills the gaussians at flux 1 and takes
// the value pass; false where the point is bad (fill flags, gmix_flags,
// or sum m^2 not above the dtype's tiny), F then 0. The same bits on
// every thread
template <typename M, typename T, int NP = Dims<M>::kNP>
__device__ __forceinline__ bool vp_flux(const Warp<T>& w, const LmState<T, NP>& s, T& F) {
  constexpr int NX = M::kNX;
  const Shape<T> sh = fill_shape(s.x[2], s.x[3]);
  Extra<T, NX> xe;
#pragma unroll
  for (int j = 0; j < NX; ++j) xe.v[j] = s.x[5 + j];
  const bool lowdet =
      model_gaussians<M>(w.gs, w.lid, s.x[0], s.x[1], sh, s.x[4], xe, T(1), s.psf[0],
                         s.psf[1], s.psf[2]);
  F = T(0);
  if (sh.gbad || lowdet) return false;
  T smy, smm;
  value_pass<M>(w.gs, w.lid, w.v, w.u, w.ia, w.ve, w.P, smy, smm);
  if (!(smm > tiny_of<T>())) return false;
  F = smy / smm;
  return true;
}

// the reduced (variable-projection) normal equations at s.y[slot] over
// the NS = NP - 1 shape dims, laid out NP wide with the flux row and
// column 0 and its diagonal 1, in internal coordinates, into
// s.sum[slot]. Called by every thread; ends with a __syncwarp
template <typename M, typename T, int NP = Dims<M>::kNP>
__device__ __forceinline__ void vp_evaluate(const Warp<T>& w, LmState<T, NP>& s, int slot) {
  constexpr int NX = M::kNX;
  constexpr int NS = NP - 1;
  if (w.lid < NS) s.x[w.lid] = i2e(s.y[slot][w.lid], s.lo[w.lid], s.hi[w.lid]);
  if (w.lid == NS) s.x[NS] = T(0);
  __syncwarp();
  T F;
  const bool good = vp_flux<M>(w, s, F);
  T* sum = s.sum[slot];
  // 0 everywhere but the flux's diagonal, then the reduced system
  bad_sums(s, slot, w.lid, T(0), true);
  __syncwarp();
  if (good) {
    const Shape<T> sh = fill_shape(s.x[2], s.x[3]);
    Extra<T, NX> xe;
#pragma unroll
    for (int j = 0; j < NX; ++j) xe.v[j] = s.x[5 + j];
    model_gaussians<M>(w.gs, w.lid, s.x[0], s.x[1], sh, s.x[4], xe, F, s.psf[0], s.psf[1],
                       s.psf[2]);
    pixel_pass<M>(w.gs, tile_of(s), w.lid, w.v, w.u, w.ia, w.ve, w.P,
                  [&](int e, T x) { sum[e] = x; });
    __syncwarp();
    if (w.lid == 0) {
      // the full pass's sums, folded in place: every entry is read before
      // it is written, the flux row's last
      T* jtr = sum + 1;
      T* jtj = sum + 1 + NP;
      const T D = jtj[tri<NP>(NS, NS)];
      T dF[NS];
#pragma unroll
      for (int k = 0; k < NS; ++k) dF[k] = -(jtj[tri<NP>(k, NS)] + jtr[k] / F) / D;
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        jtr[k] = jtr[k] + dF[k] * jtr[NS];
#pragma unroll
        for (int m = k; m < NS; ++m) {
          jtj[tri<NP>(k, m)] = jtj[tri<NP>(k, m)] + dF[k] * jtj[tri<NP>(m, NS)] +
                               jtj[tri<NP>(k, NS)] * dF[m] + dF[k] * dF[m] * D;
        }
      }
      jtr[NS] = T(0);
#pragma unroll
      for (int k = 0; k < NS; ++k) jtj[tri<NP>(k, NS)] = T(0);
    }
  } else if (w.lid == 0) {
    sum[0] = static_cast<T>(kFdiffBad2 * static_cast<double>(w.P));
  }
  if (w.lid == 0) sum[1 + NP + tri<NP>(NS, NS)] = T(1);
  __syncwarp();
  if (w.lid == 0) s.cost_pix[slot] = sum[0];
  bounds_chain<T, NP>(s, slot, w.lid);
}

// one lane's variable-projection solve: the LM over the shape dims with
// vp_evaluate, its state to a.out, then the full-width evaluation at
// (q*, F(q*)) to o.full
template <typename M, typename T, int NP = Dims<M>::kNP>
__device__ void vp_lane(const Args<T>& a, const OptArgs<T>& o, const Warp<T>& w,
                        LmState<T, NP>& s, size_t b) {
  constexpr int NS = NP - 1;
  const int cur = solve_lane<T, NP>(
      a.conf, a.guess + NP * b, s, w.gs,
      [&](int slot) { vp_evaluate<M>(w, s, slot); }, a.out, b, w.lid);
  // q* = i2e of the solve's point, or the benign round unit-T point
  // where it or the loop's cost is not finite or |q*| reaches 1e9
  const int full = cur ^ 1;
  if (w.lid < NS) s.x[w.lid] = i2e(s.y[cur][w.lid], s.lo[w.lid], s.hi[w.lid]);
  __syncwarp();
  bool ok = finite(s.sum[cur][0]);
#pragma unroll
  for (int k = 0; k < NS; ++k) ok = ok && finite(s.x[k]) && dabs(s.x[k]) < T(1.0e9);
  __syncwarp();
  if (!ok && w.lid < NS) s.x[w.lid] = w.lid == 4 ? T(1) : T(0);
  __syncwarp();
  T F;
  vp_flux<M>(w, s, F);
  if (w.lid < NP) {
    const T xk = w.lid == NS ? F : s.x[w.lid];
    s.y[full][w.lid] = e2i(xk, s.lo[w.lid], s.hi[w.lid]);
  }
  __syncwarp();
  evaluate<M, true>(w, s, full);
  const T* sum = s.sum[full];
  if (w.lid == 0) {
    o.full.cost[b] = sum[0];
    o.full.cost_pix[b] = s.cost_pix[full];
  }
  if (w.lid < NP) {
    o.full.y[NP * b + w.lid] = s.y[full][w.lid];
    o.full.jtr[NP * b + w.lid] = sum[1 + w.lid];
  }
  for (int e = w.lid; e < NP * NP; e += 32) {
    o.full.jtj[NP * NP * b + e] = sum[1 + NP + tri<NP>(e / NP, e % NP)];
  }
}

template <typename T, typename M>
__global__ void __launch_bounds__(kThreads, MinBlocks<T, M, false>::k)
    lm_solve_opt_kernel(Args<T> a, OptArgs<T> o) {
  constexpr int NP = Dims<M>::kNP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = a.P;
  const bool smem_planes = o.smem_planes;
  const int lid = threadIdx.x & 31;
  T* base = reinterpret_cast<T*>(smem_raw) +
            static_cast<size_t>(threadIdx.x >> 5) * warp_values<T, M>(P, smem_planes);
  T* gs = smem_planes ? base + 4 * static_cast<size_t>(P) : base;
  LmState<T, NP>& s = warp_state<T, M>(gs);
  if (lid < NP) {
    s.lo[lid] = a.lo[lid];
    s.hi[lid] = a.hi[lid];
  }
  __syncwarp();
  const T lam_gn = static_cast<T>(o.lam_gn);
  for (;;) {
    int b = 0;
    if (lid == 0) b = atomicAdd(a.counter, 1);
    b = __shfl_sync(kFull, b, 0);
    if (b >= a.B) break;
    const size_t off = static_cast<size_t>(b) * P;
    if (smem_planes) {
      for (int p = lid; p < P; p += 32) {
        cp_async<sizeof(T)>(base + p, a.v + off + p);
        cp_async<sizeof(T)>(base + P + p, a.u + off + p);
        cp_async<sizeof(T)>(base + 2 * P + p, a.ia + off + p);
        cp_async<sizeof(T)>(base + 3 * P + p, a.ve + off + p);
      }
      cp_async_wait_all();
      __syncwarp();
    }
    const Warp<T> w = smem_planes
        ? Warp<T>{base, base + P, base + 2 * P, base + 3 * P, gs, a.prior, a.nprior, P, lid}
        : Warp<T>{a.v + off, a.u + off, a.ia + off, a.ve + off, gs, a.prior, a.nprior, P,
                  lid};
    const size_t lb = static_cast<size_t>(b);
    if (lid < 3) s.psf[lid] = a.psf[3 * lb + lid];
    if (o.mode == kModeRefine) {
      refine_lane<T, NP>(a.conf, o.niter, lam_gn, a.guess + NP * lb, s, gs,
                         [&](int slot) { evaluate<M>(w, s, slot); }, a.out, lb, lid);
    } else {
      vp_lane<M>(a, o, w, s, lb);
    }
    // every thread is done with the planes before the next copy
    __syncwarp();
  }
}

// whether a lane's planes go into shared memory, as K3's planes()
// decides for the one instance of either placement
template <typename T, typename M>
int planes_opt(int64_t P, bool* smem_planes) {
  *smem_planes = false;
  if (P > kMaxP) return 0;
  return smem_pays(lm_solve_opt_kernel<T, M>, smem_bytes<T, M>(P, true),
                   lm_solve_opt_kernel<T, M>, smem_bytes<T, M>(P, false), smem_planes);
}

template <typename T, typename M>
int launch_opt(const Args<T>& a, OptArgs<T> o, void* stream) {
  int err = planes_opt<T, M>(a.P, &o.smem_planes);
  if (err != 0) return err;
  const size_t smem = smem_bytes<T, M>(a.P, o.smem_planes);
  unsigned blocks = 0;
  err = grid_size(lm_solve_opt_kernel<T, M>, smem, a.B, &blocks);
  if (err != 0) return err;
  lm_solve_opt_kernel<T, M>
      <<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a, o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes, as NGMIX_LM_SOLVE's, with the
// full-width outputs of the varpro mode (fy, fcost, fcost_pix, fjtr,
// fjtj; unused by the refine mode), the mode, niter and the refine
// mode's damping lam_gn.
#define NGMIX_LM_SOLVE_OPT(NAME, T, M)                                               \
  extern "C" int NAME(                                                               \
      const void* guess, const void* lo, const void* hi, const void* psf,            \
      const void* v, const void* u, const void* ia, const void* ve, void* y,         \
      void* cost, void* cost_pix, void* jtr, void* jtj, void* lam, void* nfev,       \
      void* done, void* ier_small_step, void* ier_small_cost, void* pinned,          \
      void* counter, const void* prior, void* fy, void* fcost, void* fcost_pix,      \
      void* fjtr, void* fjtj, int64_t B, int64_t P, int64_t nprior, int64_t maxfev,  \
      int64_t mode, int64_t niter, double ftol, double xtol, double lambda0,         \
      double lambda_up, double lambda_down, double lambda_min, double lambda_max,    \
      double lam_gn, void* stream) {                                                 \
    if (B <= 0) return 0;                                                            \
    if (P < 1 || P > 2147483647LL || B > 2147483647LL || maxfev < 1 ||               \
        maxfev > 2147483647LL || nprior < 0 || nprior > kMaxPriorRows ||             \
        (nprior > 0 && prior == nullptr) || niter < 0 || niter > 2147483647LL ||     \
        (mode != kModeRefine && mode != kModeVarpro) ||                              \
        (mode == kModeVarpro && (nprior > 0 || fy == nullptr))) {                    \
      return static_cast<int>(cudaErrorInvalidValue);                                \
    }                                                                                \
    const Conf conf{ftol,       xtol,       lambda0, lambda_up, lambda_down,         \
                    lambda_min, lambda_max, static_cast<int>(maxfev), false};        \
    const Out<T> out{static_cast<T*>(y),       static_cast<T*>(cost),                \
                     static_cast<T*>(cost_pix), static_cast<T*>(jtr),                \
                     static_cast<T*>(jtj),     static_cast<T*>(lam),                 \
                     static_cast<int32_t*>(nfev), static_cast<uint8_t*>(done),       \
                     static_cast<uint8_t*>(ier_small_step),                          \
                     static_cast<uint8_t*>(ier_small_cost),                          \
                     static_cast<uint8_t*>(pinned)};                                 \
    const Args<T> a{static_cast<const T*>(guess), static_cast<const T*>(lo),         \
                    static_cast<const T*>(hi),    static_cast<const T*>(psf),        \
                    static_cast<const T*>(v),     static_cast<const T*>(u),          \
                    static_cast<const T*>(ia),    static_cast<const T*>(ve),         \
                    out,                          static_cast<int*>(counter),        \
                    static_cast<const double*>(prior), static_cast<int>(B),          \
                    static_cast<int>(P),          static_cast<int>(nprior),          \
                    conf};                                                           \
    const OptArgs<T> o{static_cast<int>(mode), static_cast<int>(niter), lam_gn,      \
                       FullOut<T>{static_cast<T*>(fy), static_cast<T*>(fcost),       \
                                  static_cast<T*>(fcost_pix), static_cast<T*>(fjtr), \
                                  static_cast<T*>(fjtj)},                            \
                       false};                                                       \
    return launch_opt<T, M>(a, o, stream);                                           \
  }                                                                                  \
  extern "C" int NAME##_attrs(int64_t P, int* out) {                                 \
    if (P < 1 || P > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);   \
    bool smem_planes = false;                                                        \
    const int err = planes_opt<T, M>(P, &smem_planes);                               \
    if (err != 0) return err;                                                        \
    return kernel_attrs(lm_solve_opt_kernel<T, M>, smem_bytes<T, M>(P, smem_planes), out); \
  }
