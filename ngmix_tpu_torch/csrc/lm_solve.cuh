// K3: every lane's whole Levenberg-Marquardt solve of a model (exp,
// gauss, dev, bdf or bd), for Hopper (sm_90a).
//
// Replaces ngmix_tpu/ops/pallas_lm.py: gmix_normal_eqs_pallas (K1, the
// normal equations) together with the loop around it,
// ngmix_tpu/fitting/lm.py: run_lm_normal_batched (its while_loop body).
// Per lane b, in the order of the port's fitting/lm.py _lm_step:
//
//   y = e2i(guess); (cost, Jtr, JtJ) = eval(y); nfev = 1
//   while (!done && nfev < maxfev):
//     pinned dims -> lam_eff; mask the pinned rows; damped Cholesky
//     solve; clip; eval at the trial point; accept if cost drops;
//     predicted reduction; ftol / xtol / stuck; damping update
//
// eval(y) is i2e, the model's fill (e = 2 g / (1 + |g|^2) with the clip
// at |g| = 1; NG = 6, 1 or 10 gaussians of fixed (p, f) for exp, gauss
// and dev; 16 for bdf and bd, whose (p, f) and size factor follow the
// lane's fracdev and bd's log10(Td/Te)), the convolution with the lane's
// one psf gaussian, the reparametrization q = (N, row, col, Fvv, Fvu,
// Fuu) of each of the NG gaussians, K1's pixel pass over the model's NP
// = 6, 7 (bdf) or 8 (bd) parameters
//
//   cost = sum_p (f ia - ve)^2, Jtr = sum_p (J ia)(f ia - ve),
//   JtJ = sum_p (J ia)(J ia)^T,  J_k = sum_g sum_j dq_j[g]/dpars_k dvalue/dq_j
//
// and the bounds chain rule. A point with |g| >= 1 or a low determinant
// gets cost 1e30, Jtr 0 and JtJ = I, as batch._exp_normal_fn does.
//
// Layouts (contiguous, row-major): guess [B, NP] = (row, col, g1, g2, T,
// [bd's log10(Td/Te),] [fracdev,] flux); lo, hi [NP] (+-inf for an open
// side); psf [B, 3] = (irr, irc, icc); v, u, ia = ierr * area, ve = val
// * ierr [B, P]. Outputs: y, jtr [B, NP]; cost, lam [B]; jtj [B, NP,
// NP]; nfev [B] int32; done, ier_small_step, ier_small_cost [B] and
// pinned [B, NP] as bytes 0/1. counter: one int32, zeroed by the
// caller.
//
// What bounds it on an H100: K1's arithmetic (about 80 floating
// operations and one exponential per pixel and gaussian) times the
// evaluations each lane needs, against the planes read from device
// memory once. The design:
// - one warp per lane, persistent: the grid fills the SMs, and each warp
//   takes its next lane from the atomic counter, so a slow lane holds one
//   warp and never the others, and there is no host round trip per
//   iteration;
// - the lane's four planes are copied into the warp's shared memory
//   once (cp.async) when P <= kMaxP; every evaluation reads them there.
//   A lane with more pixels reads its planes from global memory
//   (through L1 and L2), and the block's shared memory holds only the
//   gaussians. Where the planes live is a template argument of the
//   kernel, so each instance's pixel pass knows the address space of
//   its loads (a runtime choice made them generic loads, and the exp
//   model's main-path solve ~16% slower on an H100);
// - the chain is in closed form: row and col pass through, flux scales
//   N, and (g1, g2, T and the composite models' extra columns) reach N
//   and F through 4 coefficients each, so a (pixel, gaussian) pair costs
//   15 multiply-adds of chain at NP = 6 (23 at bd's 8), not NP^2.
//   Lanes 0 to NG - 1 of the warp compute one gaussian each into shared
//   memory, which the pixel pass reads as broadcasts;
// - each thread keeps 1 + NP + NP (NP + 1) / 2 running sums of its pixels
//   (28, 36 or 45); a fixed-order shuffle tree sums them and lane 0's
//   totals are broadcast, so every thread holds the same bits and takes
//   the same accept and stop decisions; the NP x NP algebra runs in
//   registers on all 32 threads;
// - nothing depends on which warp runs a lane or on the batch, so a
//   lane's bits do not depend on either.
//
// The model is a template argument (lm_common.cuh's ExpModel,
// GaussModel, DevModel, BdfModel, BdModel): each model and type is its
// own instance and C function, NGMIX_LM_SOLVE below. The simple models'
// instances are lm_solve.cu, each composite model's its own translation
// unit (lm_solve_<model>.cu), which nvcc builds in parallel. The gaussians, the pixel pass and the LM loop are
// lm_common.cuh's, shared with K3-mb (lm_solve_mb.cuh).
// exp is the full-precision libm routine: build without fast-math.
#pragma once

#include "lm_common.cuh"

namespace {

constexpr double kBadCost = 1.0e30;
// the reference's bad-point residual squared, FDIFF_BAD^2
constexpr double kFdiffBad2 = 1.0e20;

template <typename T>
struct Args {
  const T* guess;
  const T* lo;
  const T* hi;
  const T* psf;
  const T* v;
  const T* u;
  const T* ia;
  const T* ve;
  Out<T> out;
  int* counter;
  const double* prior;  // [nprior, kPriorCols], or null
  int B;
  int P;
  int nprior;
  Conf conf;
};

template <typename T>
struct Warp {
  const T* v;   // [P] planes of the warp's lane, shared or global memory
  const T* u;
  const T* ia;
  const T* ve;
  T* gs;        // [M::kNG * Dims<M>::kGStride], shared memory
  T* ps;        // prior scratch: gs, of prior_scratch(NP) values or more
  const double* prior;
  int nprior;
  int P;
  int lid;
};

// (cost, Jtr, JtJ) in internal coordinates at y over the model's NP
// parameters, with the prior rows, and the pixels' cost alone; every
// thread of the warp returns the same bits. A bad point gets cost 1e30,
// Jtr 0 and JtJ = I, or with kAdBad the reference's AD convention (every
// pixel row FDIFF_BAD = 1e10: cost P 1e20, Jtr 0, JtJ 0)
template <typename M, bool kAdBad = false, typename T, int NP = Dims<M>::kNP>
__device__ void evaluate(const Warp<T>& w, const T (&y)[NP], const T (&lo)[NP],
                         const T (&hi)[NP], T pirr, T pirc, T picc, T& cost, T& cost_pix,
                         T (&jtr)[NP], T (&jtj)[NP * (NP + 1) / 2]) {
  constexpr int NX = M::kNX;
  constexpr int NT = NP * (NP + 1) / 2;
  T x[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) x[k] = i2e(y[k], lo[k], hi[k]);
  const Shape<T> sh = fill_shape(x[2], x[3]);
  Extra<T, NX> xe;
#pragma unroll
  for (int j = 0; j < NX; ++j) xe.v[j] = x[5 + j];
  const bool lowdet = model_gaussians<M>(w.gs, w.lid, x[0], x[1], sh, x[4], xe, x[5 + NX],
                                         pirr, pirc, picc);
  if (sh.gbad || lowdet) {
    cost = static_cast<T>(kAdBad ? kFdiffBad2 * static_cast<double>(w.P) : kBadCost);
#pragma unroll
    for (int k = 0; k < NP; ++k) jtr[k] = T(0);
#pragma unroll
    for (int k = 0; k < NP; ++k) {
#pragma unroll
      for (int m = k; m < NP; ++m) jtj[tri<NP>(k, m)] = k == m && !kAdBad ? T(1) : T(0);
    }
  } else {
    T acc[Dims<M>::kNSum];
    pixel_pass<M>(w.gs, w.lid, w.v, w.u, w.ia, w.ve, w.P, acc);
    cost = acc[0];
#pragma unroll
    for (int k = 0; k < NP; ++k) jtr[k] = acc[1 + k];
#pragma unroll
    for (int i = 0; i < NT; ++i) jtj[i] = acc[1 + NP + i];
  }
  cost_pix = cost;
  add_prior<T, NP>(w.prior, w.nprior, w.ps, w.lid, y, lo, hi, cost, jtr, jtj);
  bounds_chain<T, NP>(y, lo, hi, jtr, jtj);
}

// a warp's records in shared memory: the model's gaussians, whose room
// the prior rows' scratch takes after the pixel pass
template <typename M>
__host__ __device__ constexpr int records() {
  return max_of(M::kNG * Dims<M>::kGStride, prior_scratch(Dims<M>::kNP));
}

// kSmemPlanes: the lane's planes are copied into shared memory (P <=
// kMaxP), or read from global memory
template <typename T, typename M, bool kSmemPlanes>
__global__ void __launch_bounds__(kThreads) lm_solve_kernel(Args<T> a) {
  constexpr int NP = Dims<M>::kNP;
  constexpr int NT = NP * (NP + 1) / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = a.P;
  const int lid = threadIdx.x & 31;
  const size_t per_warp = (kSmemPlanes ? 4 * static_cast<size_t>(P) : 0) + records<M>();
  T* base = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(threadIdx.x >> 5) * per_warp;
  T* gs = kSmemPlanes ? base + 4 * static_cast<size_t>(P) : base;
  T* ps = gs;
  T lo[NP], hi[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    lo[k] = a.lo[k];
    hi[k] = a.hi[k];
  }
  for (;;) {
    int b = 0;
    if (lid == 0) b = atomicAdd(a.counter, 1);
    b = __shfl_sync(kFull, b, 0);
    if (b >= a.B) break;
    const size_t off = static_cast<size_t>(b) * P;
    if (kSmemPlanes) {
      // the lane's planes into shared memory, each thread the pixels it
      // reads in the pixel pass
      for (int p = lid; p < P; p += 32) {
        cp_async<sizeof(T)>(base + p, a.v + off + p);
        cp_async<sizeof(T)>(base + P + p, a.u + off + p);
        cp_async<sizeof(T)>(base + 2 * P + p, a.ia + off + p);
        cp_async<sizeof(T)>(base + 3 * P + p, a.ve + off + p);
      }
      cp_async_wait_all();
      __syncwarp();
    }
    const Warp<T> w = kSmemPlanes
        ? Warp<T>{base, base + P, base + 2 * P, base + 3 * P, gs, ps, a.prior, a.nprior, P,
                  lid}
        : Warp<T>{a.v + off, a.u + off, a.ia + off, a.ve + off, gs, ps, a.prior, a.nprior,
                  P, lid};
    const size_t lb = static_cast<size_t>(b);
    const T pirr = a.psf[3 * lb], pirc = a.psf[3 * lb + 1], picc = a.psf[3 * lb + 2];
    solve_lane<T, NP>(
        a.conf, a.guess + NP * lb, lo, hi,
        [&](const T (&y)[NP], T& cost, T& cost_pix, T (&jtr)[NP], T (&jtj)[NT]) {
          evaluate<M>(w, y, lo, hi, pirr, pirc, picc, cost, cost_pix, jtr, jtj);
        },
        a.out, lb, lid);
    // every thread is done with the planes before the next copy
    __syncwarp();
  }
}

// the block's dynamic shared memory: each warp's planes (if P <=
// kMaxP, where they go into shared memory) and records (gaussians, then
// the prior rows' scratch)
template <typename T, typename M>
size_t smem_bytes(int64_t P) {
  return static_cast<size_t>(kWarps) *
         ((P <= kMaxP ? 4 * static_cast<size_t>(P) : 0) + records<M>()) * sizeof(T);
}

template <typename T, typename M, bool kSmemPlanes>
int launch_kernel(const Args<T>& a, void* stream) {
  const size_t smem = smem_bytes<T, M>(a.P);
  unsigned blocks = 0;
  const int err = grid_size(lm_solve_kernel<T, M, kSmemPlanes>, smem, a.B, &blocks);
  if (err != 0) return err;
  lm_solve_kernel<T, M, kSmemPlanes>
      <<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename M>
int launch(const void* guess, const void* lo, const void* hi, const void* psf,
           const void* v, const void* u, const void* ia, const void* ve,
           const Out<T>& out, void* counter, const void* prior, int64_t B, int64_t P,
           int64_t nprior, int64_t maxfev, Conf conf, void* stream) {
  if (B <= 0) return 0;
  if (P < 1 || P > 2147483647LL || B > 2147483647LL || maxfev < 1 ||
      maxfev > 2147483647LL || nprior < 0 || nprior > kMaxPriorRows ||
      (nprior > 0 && prior == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  conf.maxfev = static_cast<int>(maxfev);
  const Args<T> a{static_cast<const T*>(guess), static_cast<const T*>(lo),
                  static_cast<const T*>(hi), static_cast<const T*>(psf),
                  static_cast<const T*>(v), static_cast<const T*>(u),
                  static_cast<const T*>(ia), static_cast<const T*>(ve), out,
                  static_cast<int*>(counter), static_cast<const double*>(prior),
                  static_cast<int>(B), static_cast<int>(P), static_cast<int>(nprior),
                  conf};
  return P <= kMaxP ? launch_kernel<T, M, true>(a, stream)
                    : launch_kernel<T, M, false>(a, stream);
}

// kernel_attrs of the kernel at P pixels a lane, as launch() sets it up
template <typename T, typename M>
int attrs(int64_t P, int* out) {
  if (P < 1 || P > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T, M>(P);
  return P <= kMaxP ? kernel_attrs(lm_solve_kernel<T, M, true>, smem, out)
                    : kernel_attrs(lm_solve_kernel<T, M, false>, smem, out);
}

}  // namespace

// Plain C interface for ctypes. Each launches on `stream`, which must
// belong to the calling thread's current CUDA device (the wrapper makes
// the tensors' device current around the call), and returns the first
// CUDA error of the set-up or the launch (0 on success); the launch is
// asynchronous.
#define NGMIX_LM_SOLVE(NAME, T, M)                                             \
  extern "C" int NAME(                                                         \
      const void* guess, const void* lo, const void* hi, const void* psf,      \
      const void* v, const void* u, const void* ia, const void* ve, void* y,   \
      void* cost, void* cost_pix, void* jtr, void* jtj, void* lam, void* nfev, \
      void* done, void* ier_small_step, void* ier_small_cost, void* pinned,    \
      void* counter, const void* prior, int64_t B, int64_t P, int64_t nprior,  \
      int64_t maxfev, double ftol, double xtol, double lambda0,                \
      double lambda_up, double lambda_down, double lambda_min,                 \
      double lambda_max, void* stream) {                                       \
    const Conf conf{ftol, xtol, lambda0, lambda_up, lambda_down, lambda_min,   \
                    lambda_max, 0};                                            \
    const Out<T> out{static_cast<T*>(y), static_cast<T*>(cost),                \
                     static_cast<T*>(cost_pix), static_cast<T*>(jtr),          \
                     static_cast<T*>(jtj),                                     \
                     static_cast<T*>(lam), static_cast<int32_t*>(nfev),        \
                     static_cast<uint8_t*>(done),                              \
                     static_cast<uint8_t*>(ier_small_step),                    \
                     static_cast<uint8_t*>(ier_small_cost),                    \
                     static_cast<uint8_t*>(pinned)};                           \
    return launch<T, M>(guess, lo, hi, psf, v, u, ia, ve, out, counter, prior, \
                        B, P, nprior, maxfev, conf, stream);                   \
  }                                                                            \
  extern "C" int NAME##_attrs(int64_t P, int* out) { return attrs<T, M>(P, out); }
