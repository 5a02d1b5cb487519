// K2: batched gaussian-mixture evaluation for Hopper (sm_90a).
//
//   model[b, p] = area[b, p] * sum_i pnorm[b, i] * exp(-chi2[b, i, p] / 2) * w(chi2)
//
// Replaces ngmix_tpu/ops/pallas_gmix.py: eval_gmix_pallas (body
// _eval_kernel_body). Layouts: gmix [B, n, 6] as (p, row, col, irr,
// irc, icc); v, u, out [B, P]; area either [B, P] or one scalar
// (area == nullptr selects the scalar). All contiguous, row-major.
//
// Design: one block per (lane, pixel tile). The block's first n threads
// turn the lane's n gaussians into (pnorm, row, col, dcc, drr, drc) in
// shared memory once; then every thread walks its pixels of the tile
// and loops over the gaussians. The kernel masks its own ragged edges
// (the last tile of a lane); there is no padding to tiles.
//
// Validity is the TPU kernel's own rule: det > GMIX_LOW_DETVAL (cast
// to the element type, so 0 in float32) and T > 0. An invalid gaussian
// contributes exactly 0 (its pnorm and inverse-covariance terms are 0).
//
// FAST selects the apodized objective (C2 window from chi2 = 20 to 25,
// zero outside [0, 25)); otherwise the exponential is untruncated.
// exp is the full-precision libm routine: build without fast-math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxGauss = 64;
constexpr int kThreads = 128;
constexpr int64_t kTileP = 1024;

constexpr double kLowDetval = 1.0e-200;
constexpr double kMaxChi2 = 25.0;
constexpr double kApodChi2 = 20.0;
constexpr double kApodIWidth = 1.0 / (kMaxChi2 - kApodChi2);
constexpr double kTwoPi = 6.283185307179586;

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }

// Products and sums rounded one by one, never contracted into FMAs.
// exp amplifies chi2's absolute round-off by chi2 itself (up to ~1000
// on the sims' stamps), so det and chi2 are computed in exactly the
// plain version's order and rounding.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T, bool FAST>
__global__ void __launch_bounds__(kThreads)
gmix_eval_kernel(const T* __restrict__ gmix, const T* __restrict__ v,
                 const T* __restrict__ u, const T* __restrict__ area,
                 T area_scalar, T* __restrict__ out, int n, int64_t P,
                 int64_t ntiles) {
  __shared__ T s_pnorm[kMaxGauss];
  __shared__ T s_row[kMaxGauss];
  __shared__ T s_col[kMaxGauss];
  __shared__ T s_dcc[kMaxGauss];
  __shared__ T s_drr[kMaxGauss];
  __shared__ T s_drc[kMaxGauss];

  const int64_t lane = blockIdx.x / ntiles;
  const int64_t tile = blockIdx.x - lane * ntiles;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const T* g = gmix + (lane * n + i) * 6;
    const T p = g[0], irr = g[3], irc = g[4], icc = g[5];
    const T det = sub_rn(mul_rn(irr, icc), mul_rn(irc, irc));
    const T tsum = irr + icc;
    const bool valid = (det > static_cast<T>(kLowDetval)) && (tsum > T(0));
    const T idet = T(1) / (valid ? det : T(1));
    s_row[i] = g[1];
    s_col[i] = g[2];
    s_drr[i] = valid ? irr * idet : T(0);
    s_drc[i] = valid ? irc * idet : T(0);
    s_dcc[i] = valid ? icc * idet : T(0);
    s_pnorm[i] = valid ? p / (static_cast<T>(kTwoPi) * dev_sqrt(det)) : T(0);
  }
  __syncthreads();

  const int64_t p0 = tile * kTileP;
  const int64_t p1 = (p0 + kTileP < P) ? p0 + kTileP : P;
  const T* vl = v + lane * P;
  const T* ul = u + lane * P;
  T* ol = out + lane * P;
  for (int64_t p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
    const T vv = vl[p];
    const T uu = ul[p];
    T acc = T(0);
    for (int i = 0; i < n; ++i) {
      const T vd = vv - s_row[i];
      const T ud = uu - s_col[i];
      // dcc vd vd + drr ud ud - 2 drc vd ud, left to right
      const T chi2 = sub_rn(
          add_rn(mul_rn(mul_rn(s_dcc[i], vd), vd),
                 mul_rn(mul_rn(s_drr[i], ud), ud)),
          mul_rn(mul_rn(mul_rn(T(2), s_drc[i]), vd), ud));
      T val;
      if (FAST) {
        if (chi2 >= T(0) && chi2 < static_cast<T>(kMaxChi2)) {
          T win = T(1);
          if (chi2 > static_cast<T>(kApodChi2)) {
            const T t = (static_cast<T>(kMaxChi2) - chi2) *
                        static_cast<T>(kApodIWidth);
            win = t * t * t * (T(10) + t * (T(-15) + T(6) * t));
          }
          val = dev_exp(T(-0.5) * chi2) * win;
        } else {
          val = T(0);
        }
      } else {
        val = dev_exp(T(-0.5) * chi2);
      }
      acc = acc + s_pnorm[i] * val;
    }
    ol[p] = acc * (area != nullptr ? area[lane * P + p] : area_scalar);
  }
}

template <typename T>
int launch(const void* gmix, const void* v, const void* u, const void* area,
           double area_scalar, void* out, int64_t B, int64_t n, int64_t P,
           int fast, void* stream) {
  if (B <= 0 || P <= 0) return 0;
  if (n < 1 || n > kMaxGauss) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ntiles = (P + kTileP - 1) / kTileP;
  const int64_t nblocks = B * ntiles;
  if (nblocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(nblocks));
  const dim3 block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* g = static_cast<const T*>(gmix);
  const T* vp = static_cast<const T*>(v);
  const T* up = static_cast<const T*>(u);
  const T* ap = static_cast<const T*>(area);
  T* op = static_cast<T*>(out);
  const T as = static_cast<T>(area_scalar);
  if (fast) {
    gmix_eval_kernel<T, true><<<grid, block, 0, s>>>(
        g, vp, up, ap, as, op, static_cast<int>(n), P, ntiles);
  } else {
    gmix_eval_kernel<T, false><<<grid, block, 0, s>>>(
        g, vp, up, ap, as, op, static_cast<int>(n), P, ntiles);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Each launches on `stream`, which must
// belong to the calling thread's current CUDA device (the wrapper makes
// the tensors' device current around the call), and returns
// cudaGetLastError() after the launch (0 on success); the launch is
// asynchronous.
extern "C" int ngmix_gmix_eval_f32(const void* gmix, const void* v,
                                   const void* u, const void* area,
                                   double area_scalar, void* out, int64_t B,
                                   int64_t n, int64_t P, int fast,
                                   void* stream) {
  return launch<float>(gmix, v, u, area, area_scalar, out, B, n, P, fast,
                       stream);
}

extern "C" int ngmix_gmix_eval_f64(const void* gmix, const void* v,
                                   const void* u, const void* area,
                                   double area_scalar, void* out, int64_t B,
                                   int64_t n, int64_t P, int fast,
                                   void* stream) {
  return launch<double>(gmix, v, u, area, area_scalar, out, B, n, P, fast,
                        stream);
}
