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
// counter, a fixed-order shuffle tree so every thread holds the same
// bits), with these differences:
// - the lane's E P pixels are copied into the warp's shared memory when
//   E P <= kMaxP; a lane with more pixels reads its planes from global
//   memory (through L1 and L2) with the same code from another base
//   pointer;
// - an epoch's sums are reduced over the warp once an epoch and
//   assembled in registers (the NP (NP + 3) / 2 values of cost, Jtr and
//   JtJ), in the reference's order: per epoch, then over epochs;
// - NB is a compile-time parameter, 1 to 6 (ugrizy); an epoch's band
//   selects its flux column by unrolled comparisons, never a register
//   index.
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
  T* gs;        // [M::kNG * Dims<M>::kGStride], shared memory
  T* ps;        // prior scratch: gs, of prior_scratch(NP) values or more
  const double* prior;
  int nprior;
  int E;
  int P;
  int lid;
};

// (cost, Jtr, JtJ) in internal coordinates at y over the NP = NSH + NB
// parameters (NSH = 5 + M::kNX shape columns, then one flux a band),
// with the prior rows, and the pixels' cost alone; every thread of the
// warp returns the same bits
template <typename M, typename T, int NB, int NP = 5 + M::kNX + NB>
__device__ void evaluate_mb(const MbWarp<T>& w, const T (&y)[NP], const T (&lo)[NP],
                            const T (&hi)[NP], T& cost, T& cost_pix, T (&jtr)[NP],
                            T (&jtj)[NP * (NP + 1) / 2]) {
  constexpr int NX = M::kNX;
  constexpr int NSH = 5 + NX;
  // an epoch's parameters: the shape columns and its band's flux
  constexpr int NE = Dims<M>::kNP;
  constexpr int NT = NP * (NP + 1) / 2;
  T x[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) x[k] = i2e(y[k], lo[k], hi[k]);
  const Shape<T> sh = fill_shape(x[2], x[3]);
  Extra<T, NX> xe;
#pragma unroll
  for (int j = 0; j < NX; ++j) xe.v[j] = x[5 + j];

  cost = T(0);
#pragma unroll
  for (int k = 0; k < NP; ++k) jtr[k] = T(0);
#pragma unroll
  for (int i = 0; i < NT; ++i) jtj[i] = T(0);
  bool bad = sh.gbad;
  for (int e = 0; e < w.E && !bad; ++e) {
    const int be = w.band[e];
    T flux = T(0);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if (i == be) flux = x[NSH + i];
    }
    bad = model_gaussians<M>(w.gs, w.lid, x[0], x[1], sh, x[4], xe, flux, w.psf[3 * e],
                             w.psf[3 * e + 1], w.psf[3 * e + 2]);
    if (bad) break;
    const size_t off = static_cast<size_t>(e) * w.P;
    T acc[Dims<M>::kNSum];
    pixel_pass<M>(w.gs, w.lid, w.v + off, w.u + off, w.ia + off, w.ve + off, w.P, acc);
    // acc holds (cost, Jtr [NE], JtJ) over (the shape columns, flux)
    cost = cost + acc[0];
#pragma unroll
    for (int k = 0; k < NSH; ++k) jtr[k] = jtr[k] + acc[1 + k];
#pragma unroll
    for (int k = 0; k < NSH; ++k) {
#pragma unroll
      for (int m = k; m < NSH; ++m) {
        jtj[tri<NP>(k, m)] = jtj[tri<NP>(k, m)] + acc[1 + NE + tri<NE>(k, m)];
      }
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if (i != be) continue;
      jtr[NSH + i] = jtr[NSH + i] + acc[1 + NSH];
#pragma unroll
      for (int k = 0; k < NSH; ++k) {
        jtj[tri<NP>(k, NSH + i)] = jtj[tri<NP>(k, NSH + i)] + acc[1 + NE + tri<NE>(k, NSH)];
      }
      jtj[tri<NP>(NSH + i, NSH + i)] =
          jtj[tri<NP>(NSH + i, NSH + i)] + acc[1 + NE + tri<NE>(NSH, NSH)];
    }
  }
  if (bad) {
    cost = static_cast<T>(kFdiffBad * kFdiffBad *
                          (static_cast<double>(w.E) * static_cast<double>(w.P)));
#pragma unroll
    for (int k = 0; k < NP; ++k) jtr[k] = T(0);
#pragma unroll
    for (int i = 0; i < NT; ++i) jtj[i] = T(0);
  }
  cost_pix = cost;
  add_prior<T, NP>(w.prior, w.nprior, w.ps, w.lid, y, lo, hi, cost, jtr, jtj);
  bounds_chain<T, NP>(y, lo, hi, jtr, jtj);
}

// a warp's records in shared memory: the model's gaussians, whose room
// the prior rows' scratch of the NP = 5 + NX + NB parameters takes after
// the pixel passes
template <typename M, int NB>
__host__ __device__ constexpr int records_mb() {
  return max_of(M::kNG * Dims<M>::kGStride, prior_scratch(5 + M::kNX + NB));
}

template <typename T, typename M, int NB>
__global__ void __launch_bounds__(kThreads) lm_solve_mb_kernel(MbArgs<T> a) {
  constexpr int NP = 5 + M::kNX + NB;
  constexpr int NT = NP * (NP + 1) / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int EP = a.E * a.P;
  const int lid = threadIdx.x & 31;
  const size_t per_warp = (a.smem_planes ? 4 * static_cast<size_t>(EP) : 0) +
                          records_mb<M, NB>();
  T* base = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(threadIdx.x >> 5) * per_warp;
  T* gs = a.smem_planes ? base + 4 * static_cast<size_t>(EP) : base;
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
    const size_t lb = static_cast<size_t>(b);
    const size_t off = lb * EP;
    MbWarp<T> w{a.v + off, a.u + off, a.ia + off, a.ve + off, a.psf + 3 * a.E * lb,
                a.band + a.E * lb, gs, ps, a.prior, a.nprior, a.E, a.P, lid};
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
    solve_lane<T, NP>(
        a.conf, a.guess + NP * lb, lo, hi,
        [&](const T (&yy)[NP], T& cost, T& cost_pix, T (&jtr)[NP], T (&jtj)[NT]) {
          evaluate_mb<M, T, NB>(w, yy, lo, hi, cost, cost_pix, jtr, jtj);
        },
        a.out, lb, lid);
    // every thread is done with the planes before the next copy
    __syncwarp();
  }
}

// whether a lane's E P pixels go into shared memory, and the block's
// dynamic shared memory: each warp's planes (if they do) and records
// (gaussians, then the prior rows' scratch)
template <typename T, typename M, int NB>
size_t smem_bytes_mb(int64_t EP, bool* smem_planes) {
  *smem_planes = EP <= kMaxP;
  return static_cast<size_t>(kWarps) *
         ((*smem_planes ? 4 * static_cast<size_t>(EP) : 0) + records_mb<M, NB>()) * sizeof(T);
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
      double lambda_max, void* stream) {                                       \
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
                     lambda_max, 0}};                                          \
    return launch_nb<T, M>(a, nband, B, E, P, nprior, maxfev, stream);         \
  }                                                                            \
  extern "C" int NAME##_attrs(int64_t nband, int64_t E, int64_t P, int* out) { \
    return attrs_mb<T, M>(nband, E, P, out);                                   \
  }
