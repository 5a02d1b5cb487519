// K3-mb: every object's joint multi-band, multi-epoch
// Levenberg-Marquardt solve of a model (exp, gauss, dev, bdf or bd), for
// Hopper (sm_90a).
//
// Replaces ngmix_tpu/ops/pallas_lm.py: gmix_normal_eqs_pallas (K1, the
// normal equations) and the loop around it, ngmix_tpu/fitting/lm.py:
// run_lm_normal_batched, under the multi-band objective of
// ngmix_tpu/batch.py: _mb_epochwise_normal_fn_f. A lane is one object
// over its E epochs, with NP = NSH + NB parameters: the NSH = 5 + NX
// shape columns (row, col, g1, g2, T and the model's NX extra columns:
// none, bdf's fracdev, or bd's log10(Td/Te) and fracdev) and one flux a
// band. Per evaluation, for each epoch e of the lane:
//
//   the epoch's NSH + 1 effective parameters (the shape and the flux of
//   its band), K3's fill of the model, convolution with the epoch's own
//   psf gaussian and closed-form chain, and K1's pixel pass over its P
//   pixels into 28, 36 or 45 sums, reduced over the warp; then added
//   into the lane's sums: the shape block, the shape-flux column of the
//   epoch's band and that band's diagonal flux entry (the flux block is
//   diagonal: an epoch sees one band)
//
// and then the LM step of lm_common.cuh over NP parameters, as K3. A bad
// point in any epoch (|g| >= 1 or a low determinant) poisons the lane as
// in the reference: cost = E P FDIFF_BAD^2, Jtr = 0 and JtJ = 0
// (batch._mb_exp_normal_fn). A band outside [0, NB) gives its epoch no
// flux, as the reference's one-hot selection does.
//
// Layouts (contiguous, row-major): guess [B, NP]; lo, hi [NP]; psf
// [B, E, 3] = (irr, irc, icc); band [B, E] int32; v, u, ia = ierr * area,
// ve = val * ierr [B, E, P]. Outputs as K3's with NP parameters.
//
// The design is K3's (one warp a lane, persistent over an atomic lane
// counter, the LM state in the warp's shared memory, the step algebra
// split over the warp, the pixel pass's sums as running sums or through
// the tile), with these differences:
// - the lane reads its E P pixels from global memory (through L1 and
//   L2); the warp's shared memory holds its gaussians, LM state and
//   tile. At the mb path's E P = 1083 in float32 a copy of the planes
//   (17 KB a warp) would hold an SM to 2 or 3 blocks of 4 warps, where
//   the registers allow 4: on an H100 the composite solves were 1.3x
//   and the exp solve 1.04x slower with it. Only a model of under 6
//   gaussians (gauss; Tuning::kMbSharedPlanes), whose pass has too
//   little arithmetic to hide the loads, copies them (cp.async) where
//   E P <= kMaxP, with the same code from another base pointer;
// - an epoch's sums are added into the lane's sums in shared memory
//   (the 1 + NP + NP (NP + 1) / 2 values of cost, Jtr and JtJ, up to
//   105 at bd's 13 parameters) by the threads that hold them, in the
//   reference's order: per epoch, then over epochs. With the assembled
//   system in registers the float32 instances spilled 8-576 bytes a
//   thread at nband 1-6 (255 registers);
// - NB is a compile-time parameter, 1 to 6 (ugrizy); an epoch's band
//   selects its flux column by unrolled comparisons.
// - the model M is a compile-time parameter too (lm_common.cuh), so a
//   model and type hold 6 instances; each model's float32 and float64
//   instances are their own translation units (lm_solve_mb_<model>.cu
//   and lm_solve_mb_<model>_f64.cu, NGMIX_LM_SOLVE_MB below), which
//   nvcc builds in parallel with the others.
#pragma once

#include "lm_common.cuh"

namespace {

constexpr int kMaxBand = 6;
constexpr double kFdiffBad = 1.0e10;

template <typename T>
struct MbArgs {
  const T* guess;
  const T* lo;
  const T* hi;
  const T* psf;
  const int32_t* band;
  const T* v;
  const T* u;
  const T* ia;
  const T* ve;
  Out<T> out;
  int* counter;
  const double* prior;  // [nprior, kPriorCols], or null
  int B;
  int E;
  int P;
  int nprior;
  bool smem_planes;
  Conf conf;
};

template <typename T>
struct MbWarp {
  const T* v;   // [E P] planes of the warp's lane, shared or global memory
  const T* u;
  const T* ia;
  const T* ve;
  const T* psf;  // [E, 3]
  const int32_t* band;  // [E]
  T* gs;        // the records (records_mb<M, NB>() values, shared memory):
                // the gaussians, then the prior rows' or the step's scratch
  const double* prior;
  int nprior;
  int E;
  int P;
  int lid;
};

// the lane's sum entry (of NP parameters) that entry e of an epoch's
// NE-parameter sums adds to, for an epoch of band be; -1 for none (e
// past the sums, or a flux entry of a band outside [0, NP - NE + 1))
template <int NE, int NP>
__device__ __forceinline__ int mb_entry(int e, int be) {
  constexpr int NSH = NE - 1;
  const bool band_ok = be >= 0 && be < NP - NSH;
  if (e == 0) return 0;
  if (e <= NE) {
    const int k = e - 1;
    return k < NSH ? 1 + k : (band_ok ? 1 + NSH + be : -1);
  }
  if (e >= sums_of(NE)) return -1;
  int k, m;
  tri_km(NE, e - 1 - NE, k, m);
  if (m < NSH) return 1 + NP + tri<NP>(k, m);
  if (!band_ok) return -1;
  return 1 + NP + (k < NSH ? tri<NP>(k, NSH + be) : tri<NP>(NSH + be, NSH + be));
}

// (cost, Jtr, JtJ) in internal coordinates at s.y[slot] over the NP =
// NSH + NB parameters (NSH = 5 + M::kNX shape columns, then one flux a
// band), with the prior rows, into s.sum[slot], and the pixels' cost
// alone into s.cost_pix[slot]. Called by every thread; ends with a
// __syncwarp
template <typename M, typename T, int NB, int NP = 5 + M::kNX + NB>
__device__ __forceinline__ void evaluate_mb(const MbWarp<T>& w, LmState<T, NP>& s, int slot) {
  constexpr int NX = M::kNX;
  constexpr int NSH = 5 + NX;
  // an epoch's parameters: the shape columns and its band's flux
  constexpr int NE = Dims<M>::kNP;
  point_x(s, slot, w.lid);
  T* sum = s.sum[slot];
  for (int e = w.lid; e < sums_of(NP); e += 32) sum[e] = T(0);
  bool bad = fill_shape(s.x[2], s.x[3]).gbad;
  for (int e = 0; e < w.E && !bad; ++e) {
    // the shape terms again each epoch (the same bits), so that they are
    // not held through the pixel passes
    const Shape<T> sh = fill_shape(s.x[2], s.x[3]);
    Extra<T, NX> xe;
#pragma unroll
    for (int j = 0; j < NX; ++j) xe.v[j] = s.x[5 + j];
    const int be = w.band[e];
    T flux = T(0);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if (i == be) flux = s.x[NSH + i];
    }
    bad = model_gaussians<M>(w.gs, w.lid, s.x[0], s.x[1], sh, s.x[4], xe, flux, w.psf[3 * e],
                             w.psf[3 * e + 1], w.psf[3 * e + 2]);
    if (bad) break;
    const size_t off = static_cast<size_t>(e) * w.P;
    // each entry of the epoch's (cost, Jtr [NE], JtJ) over (the shape
    // columns, flux) adds into the lane's: the shape block, the
    // shape-flux column of the epoch's band and that band's diagonal
    // flux entry; a band outside [0, NB) adds no flux
    pixel_pass<M>(w.gs, tile_of(s), w.lid, w.v + off, w.u + off, w.ia + off, w.ve + off, w.P,
                  [&](int i, T x) {
                    const int g = mb_entry<NE, NP>(i, be);
                    if (g >= 0) sum[g] = sum[g] + x;
                  });
  }
  __syncwarp();
  if (bad) {
    bad_sums(s, slot, w.lid,
             static_cast<T>(kFdiffBad * kFdiffBad *
                            (static_cast<double>(w.E) * static_cast<double>(w.P))),
             true);
    __syncwarp();
  }
  if (w.lid == 0) s.cost_pix[slot] = sum[0];
  add_prior<T, NP>(w.prior, w.nprior, w.gs, w.lid, s, slot);
  bounds_chain<T, NP>(s, slot, w.lid);
}

// a warp's records in shared memory: the model's gaussians, whose room
// the prior rows' scratch of the NP = 5 + NX + NB parameters takes after
// the pixel passes, and the step's scratch between evaluations
template <typename M, int NB>
__host__ __device__ constexpr int records_mb() {
  return (max_of(max_of(M::kNG * Dims<M>::kGStride, prior_scratch(5 + M::kNX + NB)),
                 step_scratch(5 + M::kNX + NB)) + 3) / 4 * 4;
}

// a warp's shared memory in values: its planes (with smem_planes), its
// records, its LM state, its pixel pass's tile
template <typename T, typename M, int NB>
__host__ __device__ constexpr size_t warp_values_mb(int64_t EP, bool smem_planes) {
  return (smem_planes ? 4 * static_cast<size_t>(EP) : 0) + records_mb<M, NB>() +
         state_size<T, 5 + M::kNX + NB>() + tile_values<M>();
}

template <typename T, typename M, int NB>
__global__ void __launch_bounds__(kThreads, MinBlocks<T, M, true>::k)
    lm_solve_mb_kernel(MbArgs<T> a) {
  constexpr int NP = 5 + M::kNX + NB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int EP = a.E * a.P;
  const int lid = threadIdx.x & 31;
  T* base = reinterpret_cast<T*>(smem_raw) +
            static_cast<size_t>(threadIdx.x >> 5) * warp_values_mb<T, M, NB>(EP, a.smem_planes);
  T* gs = a.smem_planes ? base + 4 * static_cast<size_t>(EP) : base;
  LmState<T, NP>& s = *reinterpret_cast<LmState<T, NP>*>(gs + records_mb<M, NB>());
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
    const size_t lb = static_cast<size_t>(b);
    const size_t off = lb * EP;
    MbWarp<T> w{a.v + off, a.u + off, a.ia + off, a.ve + off, a.psf + 3 * a.E * lb,
                a.band + a.E * lb, gs, a.prior, a.nprior, a.E, a.P, lid};
    if (a.smem_planes) {
      // the lane's planes into shared memory, each thread the pixels it
      // reads in the pixel passes
      for (int p = lid; p < EP; p += 32) {
        cp_async<sizeof(T)>(base + p, a.v + off + p);
        cp_async<sizeof(T)>(base + EP + p, a.u + off + p);
        cp_async<sizeof(T)>(base + 2 * EP + p, a.ia + off + p);
        cp_async<sizeof(T)>(base + 3 * EP + p, a.ve + off + p);
      }
      cp_async_wait_all();
      __syncwarp();
      w.v = base;
      w.u = base + EP;
      w.ia = base + 2 * EP;
      w.ve = base + 3 * EP;
    }
    solve_lane<T, NP>(a.conf, a.guess + NP * lb, s, gs,
                      [&](int slot) { evaluate_mb<M, T, NB>(w, s, slot); }, a.out, lb, lid);
    // every thread is done with the lane's planes and state before the
    // next lane's
    __syncwarp();
  }
}

// whether a lane's E P pixels go into shared memory
// (Tuning::kMbSharedPlanes, where they fit), and the block's dynamic
// shared memory: each warp's planes (if they do), records (gaussians,
// then the prior rows' or the step's scratch), LM state and tile
template <typename T, typename M, int NB>
size_t smem_bytes_mb(int64_t EP, bool* smem_planes) {
  *smem_planes = Tuning<M>::kMbSharedPlanes && EP <= kMaxP;
  return static_cast<size_t>(kWarps) * warp_values_mb<T, M, NB>(EP, *smem_planes) * sizeof(T);
}

template <typename T, typename M, int NB>
int launch_mb(MbArgs<T> a, int64_t B, int64_t E, int64_t P, int64_t nprior,
              int64_t maxfev, void* stream) {
  if (B <= 0) return 0;
  if (E < 1 || P < 1 || B > 2147483647LL || E * P > 2147483647LL / 4 || maxfev < 1 ||
      maxfev > 2147483647LL || nprior < 0 || nprior > kMaxPriorRows ||
      (nprior > 0 && a.prior == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.nprior = static_cast<int>(nprior);
  a.conf.maxfev = static_cast<int>(maxfev);
  a.B = static_cast<int>(B);
  a.E = static_cast<int>(E);
  a.P = static_cast<int>(P);
  const size_t smem = smem_bytes_mb<T, M, NB>(E * P, &a.smem_planes);
  unsigned blocks = 0;
  const int err = grid_size(lm_solve_mb_kernel<T, M, NB>, smem, B, &blocks);
  if (err != 0) return err;
  lm_solve_mb_kernel<T, M, NB>
      <<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename M>
int launch_nb(const MbArgs<T>& a, int64_t nband, int64_t B, int64_t E, int64_t P,
              int64_t nprior, int64_t maxfev, void* stream) {
  switch (nband) {
    case 1: return launch_mb<T, M, 1>(a, B, E, P, nprior, maxfev, stream);
    case 2: return launch_mb<T, M, 2>(a, B, E, P, nprior, maxfev, stream);
    case 3: return launch_mb<T, M, 3>(a, B, E, P, nprior, maxfev, stream);
    case 4: return launch_mb<T, M, 4>(a, B, E, P, nprior, maxfev, stream);
    case 5: return launch_mb<T, M, 5>(a, B, E, P, nprior, maxfev, stream);
    case 6: return launch_mb<T, M, 6>(a, B, E, P, nprior, maxfev, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename M, int NB>
int attrs_nb(int64_t EP, int* out) {
  bool smem_planes = false;
  return kernel_attrs(lm_solve_mb_kernel<T, M, NB>, smem_bytes_mb<T, M, NB>(EP, &smem_planes),
                      out);
}

// kernel_attrs of the kernel at nband bands and E epochs of P pixels a
// lane, as launch_mb() sets it up
template <typename T, typename M>
int attrs_mb(int64_t nband, int64_t E, int64_t P, int* out) {
  if (E < 1 || P < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (nband) {
    case 1: return attrs_nb<T, M, 1>(E * P, out);
    case 2: return attrs_nb<T, M, 2>(E * P, out);
    case 3: return attrs_nb<T, M, 3>(E * P, out);
    case 4: return attrs_nb<T, M, 4>(E * P, out);
    case 5: return attrs_nb<T, M, 5>(E * P, out);
    case 6: return attrs_nb<T, M, 6>(E * P, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

static_assert(kMaxBand == 6, "the dispatch covers nband 1 to 6");

}  // namespace

// Plain C interface for ctypes, as K3's: launches on `stream` (of the
// calling thread's current device) and returns the first CUDA error of
// the set-up or the launch, 0 on success; an nband outside 1-6 is
// cudaErrorInvalidValue. NGMIX_LM_SOLVE_MB(NAME, T, M) defines NAME, the
// solve of model M in type T, and NAME_attrs.
#define NGMIX_LM_SOLVE_MB(NAME, T, M)                                          \
  extern "C" int NAME(                                                         \
      const void* guess, const void* lo, const void* hi, const void* psf,      \
      const void* band, const void* v, const void* u, const void* ia,          \
      const void* ve, void* y, void* cost, void* cost_pix, void* jtr,          \
      void* jtj, void* lam, void* nfev, void* done, void* ier_small_step,      \
      void* ier_small_cost, void* pinned, void* counter, const void* prior,    \
      int64_t B, int64_t E, int64_t P, int64_t nband, int64_t nprior,          \
      int64_t maxfev, double ftol, double xtol, double lambda0,                \
      double lambda_up, double lambda_down, double lambda_min,                 \
      double lambda_max, int64_t at_floor, void* stream) {                     \
    MbArgs<T> a{static_cast<const T*>(guess),                                  \
                static_cast<const T*>(lo),                                     \
                static_cast<const T*>(hi),                                     \
                static_cast<const T*>(psf),                                    \
                static_cast<const int32_t*>(band),                             \
                static_cast<const T*>(v),                                      \
                static_cast<const T*>(u),                                      \
                static_cast<const T*>(ia),                                     \
                static_cast<const T*>(ve),                                     \
                Out<T>{static_cast<T*>(y), static_cast<T*>(cost),              \
                       static_cast<T*>(cost_pix), static_cast<T*>(jtr),        \
                       static_cast<T*>(jtj),                                   \
                       static_cast<T*>(lam), static_cast<int32_t*>(nfev),      \
                       static_cast<uint8_t*>(done),                            \
                       static_cast<uint8_t*>(ier_small_step),                  \
                       static_cast<uint8_t*>(ier_small_cost),                  \
                       static_cast<uint8_t*>(pinned)},                         \
                static_cast<int*>(counter),                                    \
                static_cast<const double*>(prior),                             \
                0,                                                             \
                0,                                                             \
                0,                                                             \
                0,                                                             \
                false,                                                         \
                Conf{ftol, xtol, lambda0, lambda_up, lambda_down, lambda_min,  \
                     lambda_max, 0, at_floor != 0}};                           \
    return launch_nb<T, M>(a, nband, B, E, P, nprior, maxfev, stream);         \
  }                                                                            \
  extern "C" int NAME##_attrs(int64_t nband, int64_t E, int64_t P, int* out) { \
    return attrs_mb<T, M>(nband, E, P, out);                                   \
  }
