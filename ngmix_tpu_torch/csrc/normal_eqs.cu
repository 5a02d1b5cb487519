// K1: LM normal equations of a gaussian-mixture model fit, for Hopper
// (sm_90a).
//
// Replaces ngmix_tpu/ops/pallas_lm.py: gmix_normal_eqs_pallas (body
// _normal_kernel_body). For each lane b, with q = (N, row, col, Fvv,
// Fvu, Fuu) the reparametrized gaussians of the convolved model:
//
//   f(p)     = sum_g N_g e^{-chi2/2} w(chi2)          (C2 window 20..25)
//   J_k(p)   = sum_g sum_j chain[b, g, j, k] d f / d q_j[g]
//   cost     = sum_p (f ia - ve)^2
//   Jtr[k]   = sum_p (J_k ia) (f ia - ve)
//   JtJ[k,m] = sum_p (J_k ia) (J_m ia)
//
// Layouts (contiguous, row-major): rp [B, n, 6]; chain [B, n, 6, 6]
// (d rp[g, j] / d pars[k]); v, u, ia = ierr * area, ve = val * ierr
// [B, P]; outputs cost [B], jtr [B, 6], jtj [B, 6, 6].
//
// What bounds it on an H100: per pixel and gaussian about 80 floating
// operations (chi2, the window and its derivative, six closed-form
// derivatives, the 36-term chain product) and one exponential, against
// 16 bytes a pixel (four float32 planes) read once. At the main path's
// shape (n = 6, P = 361) that is ~30 operations a byte, above the
// card's float32 ratio of ~20, so the arithmetic bounds it, not the
// memory. The design keeps every intermediate on chip: one block per
// lane loads the lane's n gaussians and n x 36 chain entries into
// shared memory once, each thread streams pixels (neighbouring threads
// on neighbouring addresses) and keeps its own 1 + 6 + 21 partial sums
// in registers (JtJ is symmetric: the upper triangle is summed and
// mirrored on write), and a block reduction in a fixed order (warp
// shuffles, then the warps' partials in warp order) makes each lane's
// result deterministic and independent of how many lanes the launch
// holds. The LM's straggler compaction relies on that for bitwise-equal
// results. Any B and P: the ragged tail is masked in the loop bound.
//
// Sums accumulate in the element type, as the TPU kernel does. exp is
// the full-precision libm routine: build without fast-math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxGauss = 64;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kNPar = 6;
constexpr int kNSum = 1 + kNPar + kNPar * (kNPar + 1) / 2;  // 28

constexpr double kMaxChi2 = 25.0;
constexpr double kApodChi2 = 20.0;
constexpr double kApodIWidth = 1.0 / (kMaxChi2 - kApodChi2);

// (k, m) of the 21 upper-triangle sums, in the order they are kept
__constant__ int8_t kTriK[21] = {0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1,
                                 2, 2, 2, 2, 3, 3, 3, 4, 4, 5};
__constant__ int8_t kTriM[21] = {0, 1, 2, 3, 4, 5, 1, 2, 3, 4, 5,
                                 2, 3, 4, 5, 3, 4, 5, 4, 5, 5};

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
normal_eqs_kernel(const T* __restrict__ rp, const T* __restrict__ chain,
                  const T* __restrict__ v, const T* __restrict__ u,
                  const T* __restrict__ ia, const T* __restrict__ ve,
                  T* __restrict__ cost, T* __restrict__ jtr,
                  T* __restrict__ jtj, int n, int64_t P) {
  __shared__ T s_rp[kMaxGauss * 6];
  __shared__ T s_ch[kMaxGauss * 36];
  __shared__ T s_red[kWarps][kNSum];

  const int64_t lane = blockIdx.x;
  for (int i = threadIdx.x; i < n * 6; i += kThreads) {
    s_rp[i] = rp[lane * n * 6 + i];
  }
  for (int i = threadIdx.x; i < n * 36; i += kThreads) {
    s_ch[i] = chain[lane * n * 36 + i];
  }
  __syncthreads();

  T acc[kNSum];
#pragma unroll
  for (int i = 0; i < kNSum; ++i) acc[i] = T(0);

  const T* vl = v + lane * P;
  const T* ul = u + lane * P;
  const T* ial = ia + lane * P;
  const T* vel = ve + lane * P;
  for (int64_t p = threadIdx.x; p < P; p += kThreads) {
    const T vv = vl[p];
    const T uu = ul[p];
    T f = T(0);
    T J[kNPar];
#pragma unroll
    for (int k = 0; k < kNPar; ++k) J[k] = T(0);

    for (int g = 0; g < n; ++g) {
      const T* q = s_rp + g * 6;
      const T dv = vv - q[1];
      const T du = uu - q[2];
      const T gv = q[3] * dv + q[4] * du;
      const T gu = q[4] * dv + q[5] * du;
      const T chi2 = gv * dv + gu * du;
      // outside [0, 25) the window and its derivative are 0, so the
      // gaussian adds nothing to f or to any derivative
      if (!(chi2 >= T(0) && chi2 < static_cast<T>(kMaxChi2))) continue;
      T win = T(1);
      T dwin = T(0);
      if (chi2 > static_cast<T>(kApodChi2)) {
        const T t = (static_cast<T>(kMaxChi2) - chi2) *
                    static_cast<T>(kApodIWidth);
        win = t * t * t * (T(10) + t * (T(-15) + T(6) * t));
        const T tmt = t * (T(1) - t);
        dwin = T(-30) * tmt * tmt * static_cast<T>(kApodIWidth);
      }
      const T e = dev_exp(T(-0.5) * chi2);
      const T mw = e * win;
      f += q[0] * mw;
      // d(N e(chi2) w(chi2)) / d chi2
      const T c = q[0] * e * (dwin - T(0.5) * win);
      const T dq[6] = {mw,
                       T(-2) * c * gv,
                       T(-2) * c * gu,
                       c * dv * dv,
                       T(2) * c * dv * du,
                       c * du * du};
      const T* ch = s_ch + g * 36;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
#pragma unroll
        for (int k = 0; k < kNPar; ++k) J[k] += ch[j * kNPar + k] * dq[j];
      }
    }

    const T iap = ial[p];
    const T fd = f * iap - vel[p];
    T Jw[kNPar];
#pragma unroll
    for (int k = 0; k < kNPar; ++k) Jw[k] = J[k] * iap;
    acc[0] += fd * fd;
#pragma unroll
    for (int k = 0; k < kNPar; ++k) acc[1 + k] += Jw[k] * fd;
    int slot = 1 + kNPar;
#pragma unroll
    for (int k = 0; k < kNPar; ++k) {
#pragma unroll
      for (int m = k; m < kNPar; ++m) acc[slot++] += Jw[k] * Jw[m];
    }
  }

  // fixed-order block reduction: a shuffle tree inside each warp, then
  // the warps' partials summed in warp order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < kNSum; ++i) {
      acc[i] += __shfl_down_sync(0xffffffffu, acc[i], off);
    }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < kNSum; ++i) s_red[warp][i] = acc[i];
  }
  __syncthreads();
  const int i = threadIdx.x;
  if (i < kNSum) {
    T s = s_red[0][i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += s_red[w][i];
    if (i == 0) {
      cost[lane] = s;
    } else if (i <= kNPar) {
      jtr[lane * kNPar + (i - 1)] = s;
    } else {
      const int k = kTriK[i - 1 - kNPar];
      const int m = kTriM[i - 1 - kNPar];
      T* out = jtj + lane * kNPar * kNPar;
      out[k * kNPar + m] = s;
      out[m * kNPar + k] = s;
    }
  }
}

template <typename T>
int launch(const void* rp, const void* chain, const void* v, const void* u,
           const void* ia, const void* ve, void* cost, void* jtr, void* jtj,
           int64_t B, int64_t n, int64_t P, void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || n > kMaxGauss || P < 0 || B > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  normal_eqs_kernel<T><<<static_cast<unsigned int>(B), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rp), static_cast<const T*>(chain),
      static_cast<const T*>(v), static_cast<const T*>(u),
      static_cast<const T*>(ia), static_cast<const T*>(ve),
      static_cast<T*>(cost), static_cast<T*>(jtr), static_cast<T*>(jtj),
      static_cast<int>(n), P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Each launches on `stream`, which must
// belong to the calling thread's current CUDA device (the wrapper makes
// the tensors' device current around the call), and returns
// cudaGetLastError() after the launch (0 on success); the launch is
// asynchronous.
extern "C" int ngmix_normal_eqs_f32(const void* rp, const void* chain,
                                    const void* v, const void* u,
                                    const void* ia, const void* ve,
                                    void* cost, void* jtr, void* jtj,
                                    int64_t B, int64_t n, int64_t P,
                                    void* stream) {
  return launch<float>(rp, chain, v, u, ia, ve, cost, jtr, jtj, B, n, P,
                       stream);
}

extern "C" int ngmix_normal_eqs_f64(const void* rp, const void* chain,
                                    const void* v, const void* u,
                                    const void* ia, const void* ve,
                                    void* cost, void* jtr, void* jtj,
                                    int64_t B, int64_t n, int64_t P,
                                    void* stream) {
  return launch<double>(rp, chain, v, u, ia, ve, cost, jtr, jtj, B, n, P,
                        stream);
}
