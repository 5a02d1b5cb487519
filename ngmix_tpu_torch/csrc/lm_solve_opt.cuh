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
// run time (shared memory up to kMaxP pixels, else global memory): the
// modes are off the main path, and this keeps K3's own instances as
// they were. lm_solve_opt.cu instantiates exp,
// lm_solve_opt_<model>.cu each other model, one unit a model.
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
};

// the unit-flux model's optimal flux at the external shape columns x
// (the flux slot unused): fills the gaussians at flux 1 and takes the
// value pass; false where the point is bad (fill flags, gmix_flags, or
// sum m^2 not above the dtype's tiny), F then 0
template <typename M, typename T, int NP = Dims<M>::kNP>
__device__ __forceinline__ bool vp_flux(const Warp<T>& w, const T (&x)[NP], T pirr, T pirc,
                                        T picc, T& F) {
  constexpr int NX = M::kNX;
  const Shape<T> sh = fill_shape(x[2], x[3]);
  Extra<T, NX> xe;
#pragma unroll
  for (int j = 0; j < NX; ++j) xe.v[j] = x[5 + j];
  const bool lowdet =
      model_gaussians<M>(w.gs, w.lid, x[0], x[1], sh, x[4], xe, T(1), pirr, pirc, picc);
  F = T(0);
  if (sh.gbad || lowdet) return false;
  T smy, smm;
  value_pass<M>(w.gs, w.lid, w.v, w.u, w.ia, w.ve, w.P, smy, smm);
  if (!(smm > tiny_of<T>())) return false;
  F = smy / smm;
  return true;
}

// the reduced (variable-projection) normal equations at y over the NS =
// NP - 1 shape dims, laid out NP wide with the flux row and column 0 and
// its diagonal 1, in internal coordinates; every thread returns the same
// bits
template <typename M, typename T, int NP = Dims<M>::kNP>
__device__ void vp_evaluate(const Warp<T>& w, const T (&y)[NP], const T (&lo)[NP],
                            const T (&hi)[NP], T pirr, T pirc, T picc, T& cost, T& cost_pix,
                            T (&jtr)[NP], T (&jtj)[NP * (NP + 1) / 2]) {
  constexpr int NX = M::kNX;
  constexpr int NS = NP - 1;
  constexpr int NT = NP * (NP + 1) / 2;
  T x[NP];
#pragma unroll
  for (int k = 0; k < NS; ++k) x[k] = i2e(y[k], lo[k], hi[k]);
  x[NS] = T(0);
  T F;
  const bool good = vp_flux<M>(w, x, pirr, pirc, picc, F);
#pragma unroll
  for (int i = 0; i < NT; ++i) jtj[i] = T(0);
#pragma unroll
  for (int k = 0; k < NP; ++k) jtr[k] = T(0);
  jtj[tri<NP>(NS, NS)] = T(1);
  if (good) {
    const Shape<T> sh = fill_shape(x[2], x[3]);
    Extra<T, NX> xe;
#pragma unroll
    for (int j = 0; j < NX; ++j) xe.v[j] = x[5 + j];
    model_gaussians<M>(w.gs, w.lid, x[0], x[1], sh, x[4], xe, F, pirr, pirc, picc);
    T acc[Dims<M>::kNSum];
    pixel_pass<M>(w.gs, w.lid, w.v, w.u, w.ia, w.ve, w.P, acc);
    const T* sj = acc + 1 + NP;
    const T D = sj[tri<NP>(NS, NS)];
    T dF[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) dF[k] = -(sj[tri<NP>(k, NS)] + acc[1 + k] / F) / D;
    cost = acc[0];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      jtr[k] = acc[1 + k] + dF[k] * acc[1 + NS];
#pragma unroll
      for (int m = k; m < NS; ++m) {
        jtj[tri<NP>(k, m)] = sj[tri<NP>(k, m)] + dF[k] * sj[tri<NP>(m, NS)] +
                             sj[tri<NP>(k, NS)] * dF[m] + dF[k] * dF[m] * D;
      }
    }
  } else {
    cost = static_cast<T>(kFdiffBad2 * static_cast<double>(w.P));
  }
  cost_pix = cost;
  bounds_chain<T, NP>(y, lo, hi, jtr, jtj);
}

// one lane's variable-projection solve: the LM over the shape dims with
// vp_evaluate, its state to a.out, then the full-width evaluation at
// (q*, F(q*)) to o.full
template <typename M, typename T, int NP = Dims<M>::kNP>
__device__ void vp_lane(const Args<T>& a, const OptArgs<T>& o, const Warp<T>& w,
                        const T (&lo)[NP], const T (&hi)[NP], T pirr, T pirc, T picc,
                        size_t b) {
  constexpr int NS = NP - 1;
  constexpr int NT = NP * (NP + 1) / 2;
  solve_lane<T, NP>(
      a.conf, a.guess + NP * b, lo, hi,
      [&](const T (&y)[NP], T& cost, T& cost_pix, T (&jtr)[NP], T (&jtj)[NT]) {
        vp_evaluate<M>(w, y, lo, hi, pirr, pirc, picc, cost, cost_pix, jtr, jtj);
      },
      a.out, b, w.lid);
  // thread 0's outputs are visible to the warp after the sync
  __syncwarp();
  bool ok = finite(a.out.cost[b]);
  T x[NP];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    x[k] = i2e(a.out.y[NP * b + k], lo[k], hi[k]);
    ok = ok && finite(x[k]) && dabs(x[k]) < T(1.0e9);
  }
  if (!ok) {
#pragma unroll
    for (int k = 0; k < NS; ++k) x[k] = k == 4 ? T(1) : T(0);
  }
  vp_flux<M>(w, x, pirr, pirc, picc, x[NS]);
  T y[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) y[k] = e2i(x[k], lo[k], hi[k]);
  T cost, cost_pix, jtr[NP], jtj[NT];
  evaluate<M, true>(w, y, lo, hi, pirr, pirc, picc, cost, cost_pix, jtr, jtj);
  if (w.lid == 0) {
    o.full.cost[b] = cost;
    o.full.cost_pix[b] = cost_pix;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      o.full.y[NP * b + k] = y[k];
      o.full.jtr[NP * b + k] = jtr[k];
#pragma unroll
      for (int m = 0; m < NP; ++m) o.full.jtj[(NP * b + k) * NP + m] = jtj[tri<NP>(k, m)];
    }
  }
}

template <typename T, typename M>
__global__ void __launch_bounds__(kThreads) lm_solve_opt_kernel(Args<T> a, OptArgs<T> o) {
  constexpr int NP = Dims<M>::kNP;
  constexpr int NT = NP * (NP + 1) / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = a.P;
  const bool smem_planes = P <= kMaxP;
  const int lid = threadIdx.x & 31;
  const size_t per_warp = (smem_planes ? 4 * static_cast<size_t>(P) : 0) + records<M>();
  T* base = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(threadIdx.x >> 5) * per_warp;
  T* gs = smem_planes ? base + 4 * static_cast<size_t>(P) : base;
  T lo[NP], hi[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    lo[k] = a.lo[k];
    hi[k] = a.hi[k];
  }
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
        ? Warp<T>{base, base + P, base + 2 * P, base + 3 * P, gs, gs, a.prior, a.nprior, P,
                  lid}
        : Warp<T>{a.v + off, a.u + off, a.ia + off, a.ve + off, gs, gs, a.prior, a.nprior,
                  P, lid};
    const size_t lb = static_cast<size_t>(b);
    const T pirr = a.psf[3 * lb], pirc = a.psf[3 * lb + 1], picc = a.psf[3 * lb + 2];
    if (o.mode == kModeRefine) {
      refine_lane<T, NP>(
          a.conf, o.niter, lam_gn, a.guess + NP * lb, lo, hi,
          [&](const T (&y)[NP], T& cost, T& cost_pix, T (&jtr)[NP], T (&jtj)[NT]) {
            evaluate<M>(w, y, lo, hi, pirr, pirc, picc, cost, cost_pix, jtr, jtj);
          },
          a.out, lb, lid);
    } else {
      vp_lane<M>(a, o, w, lo, hi, pirr, pirc, picc, lb);
    }
    // every thread is done with the planes before the next copy
    __syncwarp();
  }
}

template <typename T, typename M>
int launch_opt(const Args<T>& a, const OptArgs<T>& o, void* stream) {
  const size_t smem = smem_bytes<T, M>(a.P);
  unsigned blocks = 0;
  const int err = grid_size(lm_solve_opt_kernel<T, M>, smem, a.B, &blocks);
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
                    lambda_min, lambda_max, static_cast<int>(maxfev)};               \
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
                                  static_cast<T*>(fjtj)}};                           \
    return launch_opt<T, M>(a, o, stream);                                           \
  }                                                                                  \
  extern "C" int NAME##_attrs(int64_t P, int* out) {                                 \
    if (P < 1 || P > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);   \
    return kernel_attrs(lm_solve_opt_kernel<T, M>, smem_bytes<T, M>(P), out);        \
  }
