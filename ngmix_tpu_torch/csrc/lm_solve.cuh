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
// memory once; in practice the latency of each pair's exponential and
// shared loads, which only resident warps hide. The design:
// - one warp per lane, persistent: the grid fills the SMs, and each warp
//   takes its next lane from the atomic counter, so a slow lane holds one
//   warp and never the others, and there is no host round trip per
//   iteration;
// - the lane's four planes are copied into the warp's shared memory
//   once (cp.async) when P <= kMaxP and the copy keeps two thirds of
//   the blocks an SM that the planes in global memory allow
//   (smem_pays); every evaluation reads them there. Otherwise the lane
//   reads its planes from global memory (through L1 and L2), and the
//   block's shared memory holds only each warp's gaussians, LM state
//   and tile. Where the planes live is a template argument of the
//   kernel, so each instance's pixel pass knows the address space of
//   its loads (a runtime choice made them generic loads, and the exp
//   model's main-path solve ~16% slower on an H100);
// - the chain is in closed form: row and col pass through, flux scales
//   N, and (g1, g2, T and the composite models' extra columns) reach N
//   and F through 4 coefficients each, so a (pixel, gaussian) pair costs
//   15 multiply-adds of chain at NP = 6 (23 at bd's 8), not NP^2.
//   Lanes 0 to NG - 1 of the warp compute one gaussian each into shared
//   memory, as 16-byte aligned 4-tuples that the pixel pass reads as
//   vector broadcasts (2 + NS loads a pair, not 7 + 4 NS);
// - the LM state lives once a warp in shared memory (lm_common.cuh
//   LmState), the step algebra is split over the warp's threads, and
//   the pixel pass keeps 28 running sums a thread (exp, gauss) or forms
//   its 28-45 sums through a tile (dev, bdf, bd): a float32 instance
//   needs at most 128 registers a thread, where the state in every
//   thread's registers took 218-242 (bdf, bd) and allowed 8 warps an
//   SM; MinBlocks sets the blocks each is compiled for;
// - nothing depends on which warp runs a lane or on the batch, so a
//   lane's bits do not depend on either.
//
// The model is a template argument (lm_common.cuh's ExpModel,
// GaussModel, DevModel, BdfModel, BdModel): each model and type is its
// own instance and C function, NGMIX_LM_SOLVE below. The simple models'
// instances are lm_solve.cu, each composite model's its own translation
// unit (lm_solve_<model>.cu), which nvcc builds in parallel. The
// gaussians, the pixel pass and the LM loop are lm_common.cuh's, shared
// with K3-mb (lm_solve_mb.cuh).
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
  T* gs;        // the records (records<M>() values, shared memory): the
                // gaussians, then the prior rows' or the step's scratch
  const double* prior;
  int nprior;
  int P;
  int lid;
};

// (cost, Jtr, JtJ) in internal coordinates at s.y[slot] over the
// model's NP parameters (convolved with the psf gaussian s.psf), with
// the prior rows, into s.sum[slot], and the pixels' cost alone into
// s.cost_pix[slot]. A bad point gets cost 1e30,
// Jtr 0 and JtJ = I, or with kAdBad the reference's AD convention (every
// pixel row FDIFF_BAD = 1e10: cost P 1e20, Jtr 0, JtJ 0). Called by
// every thread; ends with a __syncwarp
template <typename M, bool kAdBad = false, typename T, int NP = Dims<M>::kNP>
__device__ __forceinline__ void evaluate(const Warp<T>& w, LmState<T, NP>& s, int slot) {
  constexpr int NX = M::kNX;
  point_x(s, slot, w.lid);
  const Shape<T> sh = fill_shape(s.x[2], s.x[3]);
  Extra<T, NX> xe;
#pragma unroll
  for (int j = 0; j < NX; ++j) xe.v[j] = s.x[5 + j];
  const bool lowdet = model_gaussians<M>(w.gs, w.lid, s.x[0], s.x[1], sh, s.x[4], xe,
                                         s.x[5 + NX], s.psf[0], s.psf[1], s.psf[2]);
  if (sh.gbad || lowdet) {
    bad_sums(s, slot, w.lid,
             static_cast<T>(kAdBad ? kFdiffBad2 * static_cast<double>(w.P) : kBadCost), kAdBad);
  } else {
    T* sum = s.sum[slot];
    pixel_pass<M>(w.gs, tile_of(s), w.lid, w.v, w.u, w.ia, w.ve, w.P,
                  [&](int e, T x) { sum[e] = x; });
  }
  __syncwarp();
  if (w.lid == 0) s.cost_pix[slot] = s.sum[slot][0];
  add_prior<T, NP>(w.prior, w.nprior, w.gs, w.lid, s, slot);
  bounds_chain<T, NP>(s, slot, w.lid);
}

// a warp's records in shared memory: the model's gaussians, whose room
// the prior rows' scratch takes after the pixel pass and the step's
// scratch between evaluations; 16 bytes a float32 4-tuple
template <typename M>
__host__ __device__ constexpr int records() {
  return (max_of(max_of(M::kNG * Dims<M>::kGStride, prior_scratch(Dims<M>::kNP)),
                 step_scratch(Dims<M>::kNP)) + 3) / 4 * 4;
}

// a warp's shared memory in values: its planes (with smem_planes), its
// records, its LM state, its pixel pass's tile
template <typename T, typename M>
__host__ __device__ constexpr size_t warp_values(int64_t P, bool smem_planes) {
  return (smem_planes ? 4 * static_cast<size_t>(P) : 0) + records<M>() +
         state_size<T, Dims<M>::kNP>() + tile_values<M>();
}

// the LM state of the warp whose records start at gs
template <typename T, typename M>
__device__ __forceinline__ LmState<T, Dims<M>::kNP>& warp_state(T* gs) {
  return *reinterpret_cast<LmState<T, Dims<M>::kNP>*>(gs + records<M>());
}

// kSmemPlanes: the lane's planes are copied into shared memory (P <=
// kMaxP), or read from global memory
template <typename T, typename M, bool kSmemPlanes>
__global__ void __launch_bounds__(kThreads, MinBlocks<T, M, false>::k)
    lm_solve_kernel(Args<T> a) {
  constexpr int NP = Dims<M>::kNP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = a.P;
  const int lid = threadIdx.x & 31;
  T* base = reinterpret_cast<T*>(smem_raw) +
            static_cast<size_t>(threadIdx.x >> 5) * warp_values<T, M>(P, kSmemPlanes);
  T* gs = kSmemPlanes ? base + 4 * static_cast<size_t>(P) : base;
  LmState<T, NP>& s = warp_state<T, M>(gs);
  if (lid < NP) {
    s.lo[lid] = a.lo[lid];
    s.hi[lid] = a.hi[lid];
  }
  __syncwarp();
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
        ? Warp<T>{base, base + P, base + 2 * P, base + 3 * P, gs, a.prior, a.nprior, P, lid}
        : Warp<T>{a.v + off, a.u + off, a.ia + off, a.ve + off, gs, a.prior, a.nprior, P,
                  lid};
    const size_t lb = static_cast<size_t>(b);
    if (lid < 3) s.psf[lid] = a.psf[3 * lb + lid];
    solve_lane<T, NP>(a.conf, a.guess + NP * lb, s, gs,
                      [&](int slot) { evaluate<M>(w, s, slot); }, a.out, lb, lid);
    // every thread is done with the planes before the next copy
    __syncwarp();
  }
}

// the block's dynamic shared memory: each warp's planes (if P <=
// kMaxP, where they go into shared memory), records (gaussians, then
// the prior rows' or the step's scratch) and LM state
template <typename T, typename M>
size_t smem_bytes(int64_t P, bool smem_planes) {
  return static_cast<size_t>(kWarps) * warp_values<T, M>(P, smem_planes) * sizeof(T);
}

// whether a lane's planes go into shared memory: where they fit (kMaxP)
// and keep two thirds of the blocks an SM of the instance that reads
// them from global memory; 0 or a CUDA error
template <typename T, typename M>
int planes(int64_t P, bool* smem_planes) {
  *smem_planes = false;
  if (P > kMaxP) return 0;
  return smem_pays(lm_solve_kernel<T, M, true>, smem_bytes<T, M>(P, true),
                   lm_solve_kernel<T, M, false>, smem_bytes<T, M>(P, false), smem_planes);
}

template <typename T, typename M, bool kSmemPlanes>
int launch_kernel(const Args<T>& a, void* stream) {
  const size_t smem = smem_bytes<T, M>(a.P, kSmemPlanes);
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
  bool smem_planes = false;
  const int err = planes<T, M>(P, &smem_planes);
  if (err != 0) return err;
  return smem_planes ? launch_kernel<T, M, true>(a, stream)
                     : launch_kernel<T, M, false>(a, stream);
}

// kernel_attrs of the kernel at P pixels a lane, as launch() sets it up
template <typename T, typename M>
int attrs(int64_t P, int* out) {
  if (P < 1 || P > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  bool smem_planes = false;
  const int err = planes<T, M>(P, &smem_planes);
  if (err != 0) return err;
  const size_t smem = smem_bytes<T, M>(P, smem_planes);
  return smem_planes ? kernel_attrs(lm_solve_kernel<T, M, true>, smem, out)
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
      double lambda_max, int64_t at_floor, void* stream) {                     \
    const Conf conf{ftol,       xtol,       lambda0, lambda_up, lambda_down,   \
                    lambda_min, lambda_max, 0,       at_floor != 0};           \
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
