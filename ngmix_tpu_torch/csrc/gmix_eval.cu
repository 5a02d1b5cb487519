// K2: batched gaussian-mixture evaluation for Hopper (sm_90a).
//
//   model[b, p] = area[b, p] * sum_i pnorm[b, i] * exp(-chi2[b, i, p] / 2) * w(chi2)
//
// Replaces ngmix_tpu/ops/pallas_gmix.py: eval_gmix_pallas (:88-148, its
// pallas_call at :121, body _eval_kernel_body :37-85). Layouts: gmix
// [B, n, 6] as (p, row, col, irr, irc, icc), 1 <= n <= 64; v, u, out
// [B, P]; area either [B, P] or one scalar (area == nullptr selects the
// scalar). All contiguous, row-major.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s float32), at the
// three shapes that reach it:
// - n = 1, exact, [51200, 361], area [B, P] (the gaussmom weight and the
//   exp-LM guess): 16 bytes a pixel against ~25 instructions: bytes,
//   0.089 ms;
// - n = 6, fast, [51200, 361], area [B, P] (the exp-LM s/n sums): bytes,
//   0.090 ms, but ~25 instructions a (pixel, gaussian), ~1e8 warp
//   instructions, make instruction issue about as long;
// - n = 18, exact, [10240, 2401], scalar area (the sims' renderer):
//   operations, 0.099 ms counting an exp as one; the full-precision expf
//   is ~8 instructions, so issue near 0.3 ms is the practical floor.
//
// The design:
// - v, u, area and out are flat [B * P] streams. After a head of `head`
//   elements (the inputs' common misalignment), they are cut into tiles
//   of `tile` elements: whole lanes where those fit in 16 KB an array,
//   else 16 KB of elements. Every tile's slices start on a 16-byte
//   boundary. ops/gmix_eval.py plans the tiling and passes it in.
// - A persistent grid: min(tiles, SMs x blocks an SM holds) blocks, each
//   walking tiles blockIdx.x, + gridDim.x, ...
// - A two-stage ring in dynamic shared memory: thread 0 issues 1-D TMA
//   bulk copies of the next tile's v, u (and area) slices, completing on
//   an mbarrier, while the block computes the current tile. The tile's
//   gaussian set-ups (row, col, dcc, drr, 2 drc, pnorm, padded to 8
//   values: two 16-byte reads in float32) are built once per (lane,
//   gaussian) into shared memory; the raw gaussians of the next tile are
//   loaded into registers before the current tile is computed.
// - Each thread takes 16 bytes of pixels (4 in float32, 2 in float64),
//   neighbouring threads on neighbouring addresses, and stores 16 bytes.
//   It finds the lane by a multiply-high with a magic number, not a
//   divide. Where every vector of a warp lies in one lane, a vector loads
//   each gaussian's set-up once and keeps it in registers over its
//   pixels; a warp with a vector across a lane boundary reads the set-ups
//   per pixel. n = 1 and n = 6 are compile-time (the gaussian loop
//   unrolled); one instantiation serves any other n. In FAST mode the
//   exponential and the window are computed for every pair and selected,
//   with no branch to diverge.
// - Plain loads take the head, a ragged last tile, and every tile when
//   the inputs disagree on their alignment to 16 bytes. Every path runs
//   the same per-pixel arithmetic, so a lane's bits do not depend on its
//   place in the batch.
// - No tensor cores. chi2 written as the product of [P, 6] monomials
//   (1, v, u, v^2, uv, u^2) with [6, n] coefficients cancels
//   catastrophically in float32: chi2 reaches ~1000 on the sims' stamps,
//   and exp multiplies chi2's absolute error by chi2. A depth of 6 fills
//   no MMA either.
//
// Validity is the TPU kernel's own rule: det > GMIX_LOW_DETVAL (cast to
// the element type, so 0 in float32) and T > 0. An invalid gaussian
// contributes exactly 0 (its pnorm and inverse-covariance terms are 0).
//
// FAST selects the apodized objective (C2 window from chi2 = 20 to 25,
// zero outside [0, 25)); otherwise the exponential is untruncated. exp is
// the full-precision libm routine: build without fast-math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxGauss = 64;
constexpr int kThreads = 256;
// values of one gaussian's set-up: row, col, dcc, drr, 2 drc, pnorm, pad
constexpr int kSetup = 8;

constexpr double kLowDetval = 1.0e-200;
constexpr double kMaxChi2 = 25.0;
constexpr double kApodChi2 = 20.0;
constexpr double kApodIWidth = 1.0 / (kMaxChi2 - kApodChi2);
constexpr double kTwoPi = 6.283185307179586;

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }

// Products and sums rounded one by one, never contracted into FMAs but
// where written as one. exp amplifies chi2's absolute round-off by chi2
// itself (up to ~1000 on the sims' stamps), so det and chi2 are computed
// in exactly the plain version's order and rounding; every path of the
// kernel runs these same operations.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// 16 bytes of elements: one vector load or store
template <typename T>
struct alignas(16) Vec {
  static constexpr int kN = 16 / sizeof(T);
  T x[kN];
};

template <typename T>
struct Args {
  const T* gmix;
  const T* v;
  const T* u;
  const T* area;  // nullptr: area_scalar
  T area_scalar;
  T* out;
  int n;
  uint32_t N;       // B * P
  uint32_t tile;    // elements a tile
  uint32_t head;    // elements before the first tile
  int ntiles;       // tiles after the head; the last may be ragged
  int nfull;        // the first nfull tiles are copied by the ring
  uint32_t magic;   // lane of element f: (umulhi(f, magic) + f) >> shift
  int shift;
};

__device__ __forceinline__ int lane_of(uint32_t f, uint32_t magic, int shift) {
  return static_cast<int>((static_cast<uint64_t>(__umulhi(f, magic)) + f) >> shift);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// 1-D TMA: bytes (a multiple of 16) from 16-byte aligned global memory
// into 16-byte aligned shared memory, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// one gaussian's set-up from its 6 raw values
template <typename T>
__device__ __forceinline__ void make_setup(const T (&g)[6], T* s) {
  const T p = g[0], irr = g[3], irc = g[4], icc = g[5];
  const T det = sub_rn(mul_rn(irr, icc), mul_rn(irc, irc));
  const T tsum = irr + icc;
  const bool valid = (det > static_cast<T>(kLowDetval)) && (tsum > T(0));
  const T idet = T(1) / (valid ? det : T(1));
  const T drc = valid ? irc * idet : T(0);
  s[0] = g[1];
  s[1] = g[2];
  s[2] = valid ? icc * idet : T(0);
  s[3] = valid ? irr * idet : T(0);
  // 2 drc is exact: chi2's last product rounds as the plain version's
  s[4] = mul_rn(T(2), drc);
  s[5] = valid ? p / (static_cast<T>(kTwoPi) * dev_sqrt(det)) : T(0);
  s[6] = T(0);
  s[7] = T(0);
}

template <typename T>
__device__ __forceinline__ void load_raw(const T* gmix, int n, int lane, int g, T (&r)[6]) {
  const T* src = gmix + (static_cast<size_t>(lane) * n + g) * 6;
#pragma unroll
  for (int k = 0; k < 6; ++k) r[k] = __ldg(src + k);
}

// the 6 used values of a set-up, as 16-byte shared-memory reads
template <typename T>
struct Setup {
  static constexpr int kReads = (6 * sizeof(T) + 15) / 16;
  T s[kReads * Vec<T>::kN];
  __device__ __forceinline__ explicit Setup(const T* p) {
#pragma unroll
    for (int r = 0; r < kReads; ++r) {
      const Vec<T> x = reinterpret_cast<const Vec<T>*>(p)[r];
#pragma unroll
      for (int k = 0; k < Vec<T>::kN; ++k) s[r * Vec<T>::kN + k] = x.x[k];
    }
  }
};

// dcc vd vd + drr ud ud - 2 drc vd ud, left to right
template <typename T>
__device__ __forceinline__ T chi2_of(const T* s, T v, T u) {
  const T vd = sub_rn(v, s[0]);
  const T ud = sub_rn(u, s[1]);
  return sub_rn(add_rn(mul_rn(mul_rn(s[2], vd), vd), mul_rn(mul_rn(s[3], ud), ud)),
                mul_rn(mul_rn(s[4], vd), ud));
}

// acc + pnorm * exp(-chi2 / 2) * w(chi2) for one (pixel, gaussian). In
// FAST mode the exponential and the window are computed for every pair
// and selected: on the exp-LM inputs most warps hold pairs inside and
// outside the window and its apodized band, so branches around them
// diverge, and they measured slower than the arithmetic they skip.
template <typename T, bool FAST>
__device__ __forceinline__ T term(const T* s, T chi2, T acc) {
  const T e = dev_exp(mul_rn(T(-0.5), chi2));
  T val = e;
  if (FAST) {
    const T t = mul_rn(sub_rn(static_cast<T>(kMaxChi2), chi2),
                       static_cast<T>(kApodIWidth));
    const T band = mul_rn(e, mul_rn(mul_rn(mul_rn(t, t), t),
                                    fma_rn(t, fma_rn(T(6), t, T(-15)), T(10))));
    const bool in_window = chi2 >= T(0) && chi2 < static_cast<T>(kMaxChi2);
    val = !in_window ? T(0) : (chi2 > static_cast<T>(kApodChi2) ? band : e);
  }
  return fma_rn(s[5], val, acc);
}

// the model at one pixel of local lane l (set-ups of the lane at setup +
// l n kSetup)
template <typename T, bool FAST, int NG>
__device__ __forceinline__ T eval_pixel(const T* setup, int n, int l, T v, T u) {
  T acc = T(0);
  const T* sl = setup + static_cast<size_t>(l) * n * kSetup;
#pragma unroll
  for (int g = 0; g < (NG > 0 ? NG : n); ++g) {
    const Setup<T> s(sl + g * kSetup);
    acc = term<T, FAST>(s.s, chi2_of(s.s, v, u), acc);
  }
  return acc;
}

// set-ups of every (lane, gaussian) that elements [start, end) touch,
// from local lane 0 = lane_of(start); item i is (lane i / n, gaussian
// i % n). Items below `from` are left to the caller.
template <typename T>
__device__ void build_setups(const Args<T>& a, uint32_t start, uint32_t end, T* setup,
                             int from) {
  const int l0 = lane_of(start, a.magic, a.shift);
  const int cnt = (lane_of(end - 1, a.magic, a.shift) - l0 + 1) * a.n;
  for (int i = from + static_cast<int>(threadIdx.x); i < cnt; i += kThreads) {
    T raw[6];
    load_raw(a.gmix, a.n, l0 + i / a.n, i % a.n, raw);
    make_setup(raw, setup + static_cast<size_t>(i) * kSetup);
  }
}

// elements [start, end) with plain loads and stores
template <typename T, bool FAST, int NG>
__device__ void plain_range(const Args<T>& a, uint32_t start, uint32_t end,
                            const T* setup) {
  const int l0 = lane_of(start, a.magic, a.shift);
  for (uint32_t f = start + threadIdx.x; f < end; f += kThreads) {
    const int l = lane_of(f, a.magic, a.shift) - l0;
    const T acc = eval_pixel<T, FAST, NG>(setup, a.n, l, __ldg(a.v + f), __ldg(a.u + f));
    a.out[f] = mul_rn(acc, a.area != nullptr ? __ldg(a.area + f) : a.area_scalar);
  }
}

// one full tile from the ring: sv, su, sa its slices in shared memory
template <typename T, bool FAST, int NG>
__device__ void tile_vectors(const Args<T>& a, uint32_t start, const T* sv, const T* su,
                             const T* sa, const T* setup) {
  constexpr int V = Vec<T>::kN;
  const int n = NG > 0 ? NG : a.n;
  const int l0 = lane_of(start, a.magic, a.shift);
  const int nvec = static_cast<int>(a.tile) / V;
  // every thread runs the same trips, so the warp vote sees all 32
  for (int jb = 0; jb < nvec; jb += kThreads) {
    const int j = jb + static_cast<int>(threadIdx.x);
    const bool active = j < nvec;
    const int e = active ? j * V : 0;
    const uint32_t f = start + static_cast<uint32_t>(e);
    const int la = lane_of(f, a.magic, a.shift) - l0;
    const int lb = lane_of(f + V - 1, a.magic, a.shift) - l0;
    const bool one_lane = __all_sync(0xffffffffu, !active || la == lb);
    if (!active) continue;
    const Vec<T> vv = *reinterpret_cast<const Vec<T>*>(sv + e);
    const Vec<T> uu = *reinterpret_cast<const Vec<T>*>(su + e);
    T acc[V];
    if (one_lane) {
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = T(0);
      const T* sl = setup + static_cast<size_t>(la) * n * kSetup;
#pragma unroll
      for (int g = 0; g < (NG > 0 ? NG : n); ++g) {
        const Setup<T> s(sl + g * kSetup);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          acc[k] = term<T, FAST>(s.s, chi2_of(s.s, vv.x[k], uu.x[k]), acc[k]);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int l = lane_of(f + k, a.magic, a.shift) - l0;
        acc[k] = eval_pixel<T, FAST, NG>(setup, n, l, vv.x[k], uu.x[k]);
      }
    }
    Vec<T> o;
    if (sa != nullptr) {
      const Vec<T> aa = *reinterpret_cast<const Vec<T>*>(sa + e);
#pragma unroll
      for (int k = 0; k < V; ++k) o.x[k] = mul_rn(acc[k], aa.x[k]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) o.x[k] = mul_rn(acc[k], a.area_scalar);
    }
    *reinterpret_cast<Vec<T>*>(a.out + f) = o;
  }
}

template <typename T, bool FAST, int NG>
__global__ void __launch_bounds__(kThreads) gmix_eval_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar[2];
  const int narr = a.area != nullptr ? 3 : 2;
  // stage s, array k (v, u, area) at ring + (s narr + k) tile
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* setup = ring + 2 * narr * static_cast<size_t>(a.tile);
  const uint32_t slice_bytes = a.tile * static_cast<uint32_t>(sizeof(T));

  auto tile_start = [&](int t) { return a.head + static_cast<uint32_t>(t) * a.tile; };
  auto tile_end = [&](int t) {
    const uint32_t e = tile_start(t) + a.tile;
    return e < a.N ? e : a.N;
  };
  // thread 0: copy tile t's slices into stage s
  auto issue = [&](int t, int s) {
    const uint32_t start = tile_start(t);
    T* dst = ring + s * narr * static_cast<size_t>(a.tile);
    // the block's generic reads of this stage are ordered before the
    // async proxy's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(&bar[s], slice_bytes * narr);
    bulk_copy(dst, a.v + start, slice_bytes, &bar[s]);
    bulk_copy(dst + a.tile, a.u + start, slice_bytes, &bar[s]);
    if (narr == 3) bulk_copy(dst + 2 * a.tile, a.area + start, slice_bytes, &bar[s]);
  };

  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int t = blockIdx.x;
  if (t < a.ntiles) {
    if (threadIdx.x == 0 && t < a.nfull) issue(t, 0);
    build_setups(a, tile_start(t), tile_end(t), setup, 0);
  }
  __syncthreads();
  for (uint32_t it = 0; t < a.ntiles; t += gridDim.x, ++it) {
    const int s = static_cast<int>(it & 1);
    const int next = t + static_cast<int>(gridDim.x);
    if (threadIdx.x == 0 && next < a.nfull) issue(next, s ^ 1);
    // the next tile's first set-up items, loaded now and built after
    // this tile, so their latency hides behind it
    T raw[6];
    bool pre = false;
    if (next < a.ntiles) {
      const uint32_t ns = tile_start(next);
      const int l0 = lane_of(ns, a.magic, a.shift);
      const int cnt = (lane_of(tile_end(next) - 1, a.magic, a.shift) - l0 + 1) * a.n;
      const int i = static_cast<int>(threadIdx.x);
      if (i < cnt) {
        load_raw(a.gmix, a.n, l0 + i / a.n, i % a.n, raw);
        pre = true;
      }
    }
    if (t < a.nfull) {
      mbar_wait(&bar[s], (it >> 1) & 1);
      const T* st = ring + s * narr * static_cast<size_t>(a.tile);
      tile_vectors<T, FAST, NG>(a, tile_start(t), st, st + a.tile,
                                narr == 3 ? st + 2 * a.tile : nullptr, setup);
    } else {
      plain_range<T, FAST, NG>(a, tile_start(t), tile_end(t), setup);
    }
    __syncthreads();
    if (next < a.ntiles) {
      if (pre) make_setup(raw, setup + static_cast<size_t>(threadIdx.x) * kSetup);
      build_setups(a, tile_start(next), tile_end(next), setup, kThreads);
    }
    __syncthreads();
  }
  if (a.head > 0 && blockIdx.x == gridDim.x - 1) {
    build_setups(a, 0, a.head, setup, 0);
    __syncthreads();
    plain_range<T, FAST, NG>(a, 0, a.head, setup);
  }
}

using KernelPtr = const void*;

template <typename T, bool FAST>
KernelPtr pick_n(int64_t n) {
  if (n == 1) return reinterpret_cast<KernelPtr>(gmix_eval_kernel<T, FAST, 1>);
  if (n == 6) return reinterpret_cast<KernelPtr>(gmix_eval_kernel<T, FAST, 6>);
  return reinterpret_cast<KernelPtr>(gmix_eval_kernel<T, FAST, 0>);
}

template <typename T>
KernelPtr pick(int fast, int64_t n) {
  return fast ? pick_n<T, true>(n) : pick_n<T, false>(n);
}

// registers a thread, static and dynamic shared memory, and blocks an SM
// of the kernel that serves n at `smem` bytes of dynamic shared memory
template <typename T>
int attrs(int fast, int64_t n, int64_t smem, int* out) {
  if (n < 1 || n > kMaxGauss || smem < 0 || smem > (1 << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const KernelPtr k = pick<T>(fast, n);
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, k)) != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads,
                                                      static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = per_sm;
  return 0;
}

template <typename T>
int launch(const void* gmix, const void* v, const void* u, const void* area,
           double area_scalar, void* out, int64_t B, int64_t n, int64_t P, int fast,
           int64_t tile, int64_t head, int64_t ntiles, int64_t nfull, int64_t magic,
           int64_t shift, int64_t grid, int64_t smem, void* stream) {
  constexpr int64_t V = Vec<T>::kN;
  if (B <= 0 || P <= 0) return 0;
  const int64_t N = B * P;
  // the plan's invariants (ops/gmix_eval.py: launch_plan)
  if (n < 1 || n > kMaxGauss || N >= (int64_t{1} << 31) || tile < V || tile % V != 0 ||
      head < 0 || head >= V || head > N ||
      ntiles != (N - head + tile - 1) / tile || nfull < 0 || nfull > (N - head) / tile ||
      magic < 0 || magic >= (int64_t{1} << 32) || shift < 0 || shift > 31 || grid < 1 ||
      grid > 2147483647LL || smem < 0 || smem > (1 << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the ring's two stages and the set-ups of the most lanes a tile spans
  const int64_t narr = area != nullptr ? 3 : 2;
  const int64_t span = (tile + P - 2) / P + 1;
  if (smem < (2 * narr * tile + span * n * kSetup) * static_cast<int64_t>(sizeof(T))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const KernelPtr k = pick<T>(fast, n);
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Args<T> a{static_cast<const T*>(gmix),
            static_cast<const T*>(v),
            static_cast<const T*>(u),
            static_cast<const T*>(area),
            static_cast<T>(area_scalar),
            static_cast<T*>(out),
            static_cast<int>(n),
            static_cast<uint32_t>(N),
            static_cast<uint32_t>(tile),
            static_cast<uint32_t>(head),
            static_cast<int>(ntiles),
            static_cast<int>(nfull),
            static_cast<uint32_t>(magic),
            static_cast<int>(shift)};
  void* params[] = {&a};
  err = cudaLaunchKernel(k, dim3(static_cast<unsigned>(grid)), dim3(kThreads), params,
                         static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Each launches on `stream`, which must
// belong to the calling thread's current CUDA device (the wrapper makes
// the tensors' device current around the call), and returns the first
// CUDA error of the set-up or the launch (0 on success); the launch is
// asynchronous. tile, head, ntiles, nfull, magic, shift, grid and smem
// are the wrapper's launch plan.
#define NGMIX_GMIX_EVAL(NAME, ATTRS, T)                                            \
  extern "C" int NAME(const void* gmix, const void* v, const void* u,              \
                      const void* area, double area_scalar, void* out, int64_t B,  \
                      int64_t n, int64_t P, int fast, int64_t tile, int64_t head,  \
                      int64_t ntiles, int64_t nfull, int64_t magic, int64_t shift, \
                      int64_t grid, int64_t smem, void* stream) {                  \
    return launch<T>(gmix, v, u, area, area_scalar, out, B, n, P, fast, tile, head, \
                     ntiles, nfull, magic, shift, grid, smem, stream);             \
  }                                                                                \
  extern "C" int ATTRS(int fast, int64_t n, int64_t smem, int* out) {              \
    return attrs<T>(fast, n, smem, out);                                           \
  }

NGMIX_GMIX_EVAL(ngmix_gmix_eval_f32, ngmix_gmix_eval_attrs_f32, float)
NGMIX_GMIX_EVAL(ngmix_gmix_eval_f64, ngmix_gmix_eval_attrs_f64, double)
