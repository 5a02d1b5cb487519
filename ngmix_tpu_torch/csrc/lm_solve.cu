// K3: every lane's whole exp-model Levenberg-Marquardt solve, for Hopper
// (sm_90a).
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
// eval(y) is i2e, the exp fill (e = 2 g / (1 + |g|^2) with the clip at
// |g| = 1), the convolution with the lane's one psf gaussian, the
// reparametrization q = (N, row, col, Fvv, Fvu, Fuu) of each of the 6
// gaussians, K1's pixel pass
//
//   cost = sum_p (f ia - ve)^2, Jtr = sum_p (J ia)(f ia - ve),
//   JtJ = sum_p (J ia)(J ia)^T,  J_k = sum_g sum_j dq_j[g]/dpars_k dvalue/dq_j
//
// and the bounds chain rule. A point with |g| >= 1 or a low determinant
// gets cost 1e30, Jtr 0 and JtJ = I, as batch._exp_normal_fn does.
//
// Layouts (contiguous, row-major): guess [B, 6]; lo, hi [6] (+-inf for
// an open side); psf [B, 3] = (irr, irc, icc); v, u, ia = ierr * area,
// ve = val * ierr [B, P]. Outputs: y, jtr [B, 6]; cost, lam [B]; jtj
// [B, 6, 6]; nfev [B] int32; done, ier_small_step, ier_small_cost [B]
// and pinned [B, 6] as bytes 0/1. counter: one int32, zeroed by the
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
//   once (cp.async); every evaluation reads them there;
// - the chain is in closed form: row and col pass through, flux scales
//   N, and (g1, g2, T) reach N and F through 4 coefficients each, so a
//   (pixel, gaussian) pair costs 15 multiply-adds of chain, not 36.
//   Lanes 0-5 of the warp compute one gaussian each into shared memory,
//   which the pixel pass reads as broadcasts;
// - each thread keeps 28 running sums of its pixels; a fixed-order
//   shuffle tree sums them and lane 0's totals are broadcast, so every
//   thread holds the same bits and takes the same accept and stop
//   decisions; the 6x6 algebra runs in registers on all 32 threads;
// - nothing depends on which warp runs a lane or on the batch, so a
//   lane's bits do not depend on either.
//
// exp is the full-precision libm routine: build without fast-math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kNGauss = 6;
constexpr int kNPar = 6;
constexpr int kNTri = kNPar * (kNPar + 1) / 2;  // 21
constexpr int kMaxP = 1536;
// per gaussian in shared memory: q = (N, row, col, Fvv, Fvu, Fuu), then
// dN/dflux, then (dN, dFvv, dFvu, dFuu) / d g1, d g2, d T
constexpr int kGStride = 6 + 1 + 12;

constexpr double kMaxChi2 = 25.0;
constexpr double kApodChi2 = 20.0;
constexpr double kApodIWidth = 1.0 / (kMaxChi2 - kApodChi2);
constexpr double kLowDetval = 1.0e-200;
constexpr double kTwoPi = 6.283185307179586;
constexpr double kOneMinusEps = 0.9999999999999999;
constexpr double kYClip = 27.631021;       // ln(1e12)
constexpr double kNearBoth = 9.2103404;    // ln(1e4)
constexpr double kNearOne = 1.4142e-2;     // sqrt(2e-4)
constexpr double kBadCost = 1.0e30;
constexpr double kPredFloor = 1.0e-300;

// the exp model's fixed gaussian expansion (gmix/tables.py)
__constant__ double kPvals[kNGauss] = {
    0.00061601229677880041, 0.0079461395724623237, 0.053280454055540001,
    0.21797364640726541, 0.45496740582554868, 0.26521634184240478};
__constant__ double kFvals[kNGauss] = {
    0.002467115141477932, 0.018147435573256168, 0.07944063151366336,
    0.27137669897479122, 0.79782256866993773, 2.1623306025075739};

struct Conf {
  double ftol, xtol, lambda0, lambda_up, lambda_down, lambda_min, lambda_max;
  int maxfev;
};

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
  T* y;
  T* cost;
  T* jtr;
  T* jtj;
  T* lam;
  int32_t* nfev;
  uint8_t* done;
  uint8_t* ier_small_step;
  uint8_t* ier_small_cost;
  uint8_t* pinned;
  int* counter;
  int B;
  int P;
  Conf conf;
};

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }
__device__ __forceinline__ bool finite(float x) { return isfinite(x); }
__device__ __forceinline__ bool finite(double x) { return isfinite(x); }

template <typename T> __device__ __forceinline__ T inf_of();
template <> __device__ __forceinline__ float inf_of<float>() {
  return __int_as_float(0x7f800000);
}
template <> __device__ __forceinline__ double inf_of<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}
template <typename T> __device__ __forceinline__ T tiny_of();
template <> __device__ __forceinline__ float tiny_of<float>() {
  return 1.17549435e-38f;
}
template <> __device__ __forceinline__ double tiny_of<double>() {
  return 2.2250738585072014e-308;
}

// one-sided clamps as the plain version's: a nan stays nan
template <typename T> __device__ __forceinline__ T clamp_min(T x, T m) {
  return x < m ? m : x;
}
template <typename T> __device__ __forceinline__ T clamp_max(T x, T m) {
  return x > m ? m : x;
}
template <typename T> __device__ __forceinline__ T sigmoid(T y) {
  return T(1) / (T(1) + dexp(-y));
}

// index of (k, m), k <= m, in the 21 upper-triangle sums (K1's order)
__device__ __forceinline__ constexpr int tri(int k, int m) {
  return k <= m ? k * kNPar - k * (k - 1) / 2 + (m - k)
                : m * kNPar - m * (m - 1) / 2 + (k - m);
}

// ----------------------------------------------------------------------
// bounds maps (fitting/lm.py): logistic for two-sided dims, the sqrt
// forms for one-sided dims, identity for open dims

template <typename T>
__device__ __forceinline__ T i2e(T y, T lo, T hi) {
  const bool hl = finite(lo), hh = finite(hi);
  const T lo_s = hl ? lo : T(0);
  const T hi_s = hh ? hi : T(0);
  if (hl && hh) return lo_s + (hi_s - lo_s) * sigmoid(y);
  const T s = dsqrt(y * y + T(1));
  if (hl) return lo_s - T(1) + s;
  if (hh) return hi_s + T(1) - s;
  return y;
}

template <typename T>
__device__ __forceinline__ T i2e_grad(T y, T lo, T hi) {
  const bool hl = finite(lo), hh = finite(hi);
  if (hl && hh) return (hi - lo) * sigmoid(y) * sigmoid(-y);
  const T s = dsqrt(y * y + T(1));
  if (hl) return y / s;
  if (hh) return -y / s;
  return T(1);
}

template <typename T>
__device__ __forceinline__ T e2i(T x, T lo, T hi) {
  const bool hl = finite(lo), hh = finite(hi);
  const T lo_s = hl ? lo : T(0);
  const T hi_s = hh ? hi : T(1);
  if (hl && hh) {
    const T span = hi_s - lo_s;
    const T t = clamp_min(x - lo_s, T(1.0e-12) * span);
    const T u = clamp_min(hi_s - x, T(1.0e-12) * span);
    return dlog(t) - dlog(u);
  }
  if (hl) {
    const T a = x - lo_s + T(1);
    return dsqrt(clamp_min(a * a - T(1), T(0)));
  }
  if (hh) {
    const T a = hi_s - x + T(1);
    return dsqrt(clamp_min(a * a - T(1), T(0)));
  }
  return x;
}

// ----------------------------------------------------------------------
// one evaluation

template <typename T>
struct Warp {
  const T* v;   // [P] planes of the warp's lane, in shared memory
  const T* u;
  const T* ia;
  const T* ve;
  T* gs;        // [kNGauss * kGStride]
  int P;
  int lid;
};

// (cost, Jtr, JtJ) in internal coordinates at y; every thread of the
// warp returns the same bits
template <typename T>
__device__ void evaluate(const Warp<T>& w, const T (&y)[kNPar],
                         const T (&lo)[kNPar], const T (&hi)[kNPar],
                         T pirr, T pirc, T picc, T& cost, T (&jtr)[kNPar],
                         T (&jtj)[kNTri]) {
  T x[kNPar];
#pragma unroll
  for (int k = 0; k < kNPar; ++k) x[k] = i2e(y[k], lo[k], hi[k]);

  // the exp fill's shape: e(g) with the clip at |g| = 1
  const T g1 = x[2], g2 = x[3], tsz = x[4], flux = x[5];
  const T gsq = g1 * g1 + g2 * g2;
  const bool gbad = gsq >= T(1);
  const T scale = gbad ? T(kOneMinusEps) / dsqrt(gsq) : T(1);
  const T g1c = g1 * scale, g2c = g2 * scale;
  const T fac = T(2) / (T(1) + g1c * g1c + g2c * g2c);
  const T e1 = fac * g1c, e2 = fac * g2c;
  // de/dg inside |g| < 1; a point outside is bad and uses no chain
  const T f2 = fac * fac;
  const T de1_g1 = fac - f2 * g1c * g1c;
  const T de1_g2 = -f2 * g1c * g2c;
  const T de2_g2 = fac - f2 * g2c * g2c;

  // every thread has read the previous point's gaussians
  __syncwarp();
  bool lowdet = false;
  if (w.lid < kNGauss) {
    const int g = w.lid;
    const T fv = static_cast<T>(kFvals[g]);
    const T pv = static_cast<T>(kPvals[g]);
    const T h = T(0.5) * tsz * fv;
    const T irr = h * (T(1) - e1) + pirr;
    const T irc = h * e2 + pirc;
    const T icc = h * (T(1) + e1) + picc;
    const T det = irr * icc - irc * irc;
    const T tc = irr + icc;
    // gmix_flags' rule, then gmix_reparam's
    lowdet = det < static_cast<T>(kLowDetval) || tc <= static_cast<T>(kLowDetval);
    const bool valid = det > static_cast<T>(kLowDetval) && tc > T(0);
    T* q = w.gs + g * kGStride;
    q[1] = x[0];
    q[2] = x[1];
    if (valid) {
      const T idet = T(1) / det;
      const T denom = static_cast<T>(kTwoPi) * dsqrt(det);
      const T N = flux * pv / denom;
      const T Fvv = icc * idet, Fvu = -irc * idet, Fuu = irr * idet;
      q[0] = N;
      q[3] = Fvv;
      q[4] = Fvu;
      q[5] = Fuu;
      q[6] = pv / denom;
      // d (irr, irc, icc) / d (g1, g2, T)
      const T d_rr[3] = {-h * de1_g1, -h * de1_g2, T(0.5) * fv * (T(1) - e1)};
      const T d_rc[3] = {h * de1_g2, h * de2_g2, T(0.5) * fv * e2};
      const T d_cc[3] = {h * de1_g1, h * de1_g2, T(0.5) * fv * (T(1) + e1)};
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const T ddet = icc * d_rr[s] + irr * d_cc[s] - T(2) * irc * d_rc[s];
        q[7 + 4 * s] = T(-0.5) * N * ddet * idet;
        q[8 + 4 * s] = (d_cc[s] - Fvv * ddet) * idet;
        q[9 + 4 * s] = (-d_rc[s] - Fvu * ddet) * idet;
        q[10 + 4 * s] = (d_rr[s] - Fuu * ddet) * idet;
      }
    } else {
      // an invalid gaussian adds nothing: N = 0, unit inverse covariance
      q[0] = T(0);
      q[3] = T(1);
      q[4] = T(0);
      q[5] = T(1);
#pragma unroll
      for (int i = 6; i < kGStride; ++i) q[i] = T(0);
    }
  }
  const bool bad = gbad || __any_sync(kFull, lowdet);
  __syncwarp();

  if (bad) {
    cost = static_cast<T>(kBadCost);
#pragma unroll
    for (int k = 0; k < kNPar; ++k) jtr[k] = T(0);
#pragma unroll
    for (int k = 0; k < kNPar; ++k) {
#pragma unroll
      for (int m = k; m < kNPar; ++m) jtj[tri(k, m)] = k == m ? T(1) : T(0);
    }
  } else {
    T acc[1 + kNPar + kNTri];
#pragma unroll
    for (int i = 0; i < 1 + kNPar + kNTri; ++i) acc[i] = T(0);
    for (int p = w.lid; p < w.P; p += 32) {
      const T vv = w.v[p];
      const T uu = w.u[p];
      T f = T(0);
      T J[kNPar];
#pragma unroll
      for (int k = 0; k < kNPar; ++k) J[k] = T(0);
#pragma unroll
      for (int g = 0; g < kNGauss; ++g) {
        const T* q = w.gs + g * kGStride;
        const T dv = vv - q[1];
        const T du = uu - q[2];
        const T gv = q[3] * dv + q[4] * du;
        const T gu = q[4] * dv + q[5] * du;
        const T chi2 = gv * dv + gu * du;
        // outside [0, 25) the window and its derivative are 0
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
        const T e = dexp(T(-0.5) * chi2);
        const T mw = e * win;
        f += q[0] * mw;
        // d(N e(chi2) w(chi2)) / d chi2, then d value / d q
        const T c = q[0] * e * (dwin - T(0.5) * win);
        const T dq1 = T(-2) * c * gv;
        const T dq2 = T(-2) * c * gu;
        const T dq3 = c * dv * dv;
        const T dq4 = T(2) * c * dv * du;
        const T dq5 = c * du * du;
        J[0] += dq1;
        J[1] += dq2;
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          J[2 + s] += mw * q[7 + 4 * s] + dq3 * q[8 + 4 * s] +
                      dq4 * q[9 + 4 * s] + dq5 * q[10 + 4 * s];
        }
        J[5] += mw * q[6];
      }
      const T iap = w.ia[p];
      const T fd = f * iap - w.ve[p];
      T Jw[kNPar];
#pragma unroll
      for (int k = 0; k < kNPar; ++k) Jw[k] = J[k] * iap;
      acc[0] += fd * fd;
#pragma unroll
      for (int k = 0; k < kNPar; ++k) acc[1 + k] += Jw[k] * fd;
#pragma unroll
      for (int k = 0; k < kNPar; ++k) {
#pragma unroll
        for (int m = k; m < kNPar; ++m) acc[1 + kNPar + tri(k, m)] += Jw[k] * Jw[m];
      }
    }
    // fixed-order shuffle tree, then lane 0's totals to every thread
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < 1 + kNPar + kNTri; ++i) {
        acc[i] += __shfl_down_sync(kFull, acc[i], off);
      }
    }
#pragma unroll
    for (int i = 0; i < 1 + kNPar + kNTri; ++i) acc[i] = __shfl_sync(kFull, acc[i], 0);
    cost = acc[0];
#pragma unroll
    for (int k = 0; k < kNPar; ++k) jtr[k] = acc[1 + k];
#pragma unroll
    for (int i = 0; i < kNTri; ++i) jtj[i] = acc[1 + kNPar + i];
  }

  // the bounds chain rule J_int = J_ext diag(g)
  T gr[kNPar];
#pragma unroll
  for (int k = 0; k < kNPar; ++k) gr[k] = i2e_grad(y[k], lo[k], hi[k]);
#pragma unroll
  for (int k = 0; k < kNPar; ++k) {
    jtr[k] = jtr[k] * gr[k];
#pragma unroll
    for (int m = k; m < kNPar; ++m) jtj[tri(k, m)] = jtj[tri(k, m)] * gr[k] * gr[m];
  }
}

// ----------------------------------------------------------------------
// one lane's solve

template <typename T>
__device__ void solve_lane(const Args<T>& a, const Warp<T>& w, size_t b,
                           const T (&lo)[kNPar], const T (&hi)[kNPar]) {
  const Conf& cf = a.conf;
  const T ftol = static_cast<T>(cf.ftol);
  const T xtol = static_cast<T>(cf.xtol);
  const T lambda0 = static_cast<T>(cf.lambda0);
  const T pirr = a.psf[3 * b], pirc = a.psf[3 * b + 1], picc = a.psf[3 * b + 2];

  T y[kNPar];
#pragma unroll
  for (int k = 0; k < kNPar; ++k) y[k] = e2i(a.guess[kNPar * b + k], lo[k], hi[k]);
  T cost, jtr[kNPar], jtj[kNTri];
  evaluate(w, y, lo, hi, pirr, pirc, picc, cost, jtr, jtj);

  T lam = lambda0;
  int nfev = 1;
  bool done = false, ier_step = false, ier_cost = false;
  unsigned pinned = 0;
  while (!done && nfev < cf.maxfev) {
    // dims on a finite bound whose gradient points outward and whose
    // whole remaining improvement is below the ftol resolution
    unsigned pin = 0;
#pragma unroll
    for (int k = 0; k < kNPar; ++k) {
      const bool hl = finite(lo[k]), hh = finite(hi[k]);
      const T g = i2e_grad(y[k], lo[k], hi[k]);
      const T xk = i2e(y[k], lo[k], hi[k]);
      const bool near = (hl && hh) ? dabs(y[k]) >= static_cast<T>(kNearBoth)
                                   : dabs(y[k]) <= static_cast<T>(kNearOne);
      const bool to_lo = (jtr[k] * g > T(0)) && hl;
      const bool to_hi = (jtr[k] * g < T(0)) && hh;
      const T d_out = to_lo ? xk - lo[k] : (to_hi ? hi[k] - xk : inf_of<T>());
      const T g_safe = clamp_min(dabs(g), tiny_of<T>());
      const T available = T(2) * dabs(jtr[k]) * d_out / g_safe;
      if (near && (to_lo || to_hi) && available < ftol * cost) pin |= 1u << k;
    }
    const bool pin_changed = pin != pinned;
    const T lam_eff = pin_changed ? lambda0 : lam;

    // the masked normal equations, damped (Marquardt scaling), as the
    // lower triangle of A, and b = -Jtr over the free dims
    T free_[kNPar];
#pragma unroll
    for (int k = 0; k < kNPar; ++k) free_[k] = (pin >> k) & 1u ? T(0) : T(1);
    T A[kNPar][kNPar];
    T rhs[kNPar];
#pragma unroll
    for (int i = 0; i < kNPar; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) A[i][j] = jtj[tri(j, i)] * free_[i] * free_[j];
      if ((pin >> i) & 1u) A[i][i] = A[i][i] + T(1);
      const T d = A[i][i] > T(0) ? A[i][i] : T(1);
      A[i][i] = A[i][i] + lam_eff * d;
      rhs[i] = -(jtr[i] * free_[i]);
    }
    // unrolled Cholesky (ops/small_linalg.py's order); nan where A is
    // not positive definite
    T L[kNPar][kNPar];
#pragma unroll
    for (int j = 0; j < kNPar; ++j) {
      T s = A[j][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
      const T d = dsqrt(s);
      L[j][j] = d;
      const T inv_d = T(1) / d;
#pragma unroll
      for (int i = j + 1; i < kNPar; ++i) {
        T t = A[i][j];
#pragma unroll
        for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
        L[i][j] = t * inv_d;
      }
    }
    T z[kNPar];
#pragma unroll
    for (int i = 0; i < kNPar; ++i) {
      T s = rhs[i];
#pragma unroll
      for (int k = 0; k < i; ++k) s = s - L[i][k] * z[k];
      z[i] = s / L[i][i];
    }
    T dy[kNPar];
#pragma unroll
    for (int i = kNPar - 1; i >= 0; --i) {
      T s = z[i];
#pragma unroll
      for (int k = i + 1; k < kNPar; ++k) s = s - L[k][i] * dy[k];
      dy[i] = s / L[i][i];
    }
    bool step_ok = true;
#pragma unroll
    for (int k = 0; k < kNPar; ++k) step_ok = step_ok && finite(dy[k]);

    T y_try[kNPar];
#pragma unroll
    for (int k = 0; k < kNPar; ++k) {
      T t = y[k] + (step_ok ? dy[k] : T(0));
      if (finite(lo[k]) && finite(hi[k])) {
        t = clamp_max(clamp_min(t, static_cast<T>(-kYClip)), static_cast<T>(kYClip));
      }
      y_try[k] = t;
      dy[k] = t - y[k];
    }
    T cost_try, jtr_try[kNPar], jtj_try[kNTri];
    evaluate(w, y_try, lo, hi, pirr, pirc, picc, cost_try, jtr_try, jtj_try);
    if (!finite(cost_try)) cost_try = inf_of<T>();
    const bool accept = step_ok && cost_try < cost;

    // predicted reduction of the quadratic model, sums left to right
    T pred_g = dy[0] * (T(2) * jtr[0]);
    T pred_h = T(0);
#pragma unroll
    for (int i = 0; i < kNPar; ++i) {
      if (i > 0) pred_g = pred_g + dy[i] * (T(2) * jtr[i]);
      T Hdy = jtj[tri(i, 0)] * dy[0];
#pragma unroll
      for (int j = 1; j < kNPar; ++j) Hdy = Hdy + jtj[tri(i, j)] * dy[j];
      pred_h = i == 0 ? dy[0] * Hdy : pred_h + dy[i] * Hdy;
    }
    const T pred = clamp_min(-pred_g - pred_h, static_cast<T>(kPredFloor));
    const T actual = cost - cost_try;
    const bool small_cost =
        accept && actual <= ftol * cost && pred <= ftol * cost;
    // xtol over the free dims only
    T ysq = T(0), dsq = T(0);
#pragma unroll
    for (int k = 0; k < kNPar; ++k) {
      const T yf = y[k] * free_[k];
      ysq = k == 0 ? yf * yf : ysq + yf * yf;
      dsq = k == 0 ? dy[k] * dy[k] : dsq + dy[k] * dy[k];
    }
    const bool small_step =
        accept && dsqrt(dsq) <= xtol * (dsqrt(ysq) + xtol);
    const bool stuck = !accept && lam_eff >= static_cast<T>(cf.lambda_max);

    lam = accept
              ? clamp_min(lam_eff / static_cast<T>(cf.lambda_down),
                          static_cast<T>(cf.lambda_min))
              : clamp_max(lam_eff * static_cast<T>(cf.lambda_up),
                          static_cast<T>(cf.lambda_max * 10.0));
    if (accept) {
      cost = cost_try;
#pragma unroll
      for (int k = 0; k < kNPar; ++k) {
        y[k] = y_try[k];
        jtr[k] = jtr_try[k];
      }
#pragma unroll
      for (int i = 0; i < kNTri; ++i) jtj[i] = jtj_try[i];
    }
    nfev += 1;
    done = (small_cost || small_step || stuck) && !pin_changed;
    ier_step = small_step;
    ier_cost = small_cost;
    pinned = pin;
  }

  if (w.lid == 0) {
    a.cost[b] = cost;
    a.lam[b] = lam;
    a.nfev[b] = nfev;
    a.done[b] = done;
    a.ier_small_step[b] = ier_step;
    a.ier_small_cost[b] = ier_cost;
#pragma unroll
    for (int k = 0; k < kNPar; ++k) {
      a.y[kNPar * b + k] = y[k];
      a.jtr[kNPar * b + k] = jtr[k];
      a.pinned[kNPar * b + k] = (pinned >> k) & 1u;
#pragma unroll
      for (int m = 0; m < kNPar; ++m) {
        a.jtj[(kNPar * b + k) * kNPar + m] = jtj[tri(k, m)];
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
               "n"(N)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(kThreads) lm_solve_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = a.P;
  const int lid = threadIdx.x & 31;
  T* base = reinterpret_cast<T*>(smem_raw) +
            static_cast<size_t>(threadIdx.x >> 5) * (4 * P + kNGauss * kGStride);
  const Warp<T> w{base, base + P, base + 2 * P, base + 3 * P, base + 4 * P, P, lid};
  T lo[kNPar], hi[kNPar];
#pragma unroll
  for (int k = 0; k < kNPar; ++k) {
    lo[k] = a.lo[k];
    hi[k] = a.hi[k];
  }
  for (;;) {
    int b = 0;
    if (lid == 0) b = atomicAdd(a.counter, 1);
    b = __shfl_sync(kFull, b, 0);
    if (b >= a.B) break;
    // the lane's planes into shared memory, each thread the pixels it
    // reads in the pixel pass
    const size_t off = static_cast<size_t>(b) * P;
    for (int p = lid; p < P; p += 32) {
      cp_async<sizeof(T)>(base + p, a.v + off + p);
      cp_async<sizeof(T)>(base + P + p, a.u + off + p);
      cp_async<sizeof(T)>(base + 2 * P + p, a.ia + off + p);
      cp_async<sizeof(T)>(base + 3 * P + p, a.ve + off + p);
    }
    cp_async_wait_all();
    __syncwarp();
    solve_lane(a, w, static_cast<size_t>(b), lo, hi);
    // every thread is done with the planes before the next copy
    __syncwarp();
  }
}

// dynamic shared memory of a block: each warp's four planes and gaussians
template <typename T>
size_t smem_bytes(int64_t P) {
  return static_cast<size_t>(kWarps) *
         (4 * static_cast<size_t>(P) + kNGauss * kGStride) * sizeof(T);
}

template <typename T>
int launch(const void* guess, const void* lo, const void* hi, const void* psf,
           const void* v, const void* u, const void* ia, const void* ve,
           void* y, void* cost, void* jtr, void* jtj, void* lam, void* nfev,
           void* done, void* ier_small_step, void* ier_small_cost,
           void* pinned, void* counter, int64_t B, int64_t P, int64_t maxfev,
           Conf conf, void* stream) {
  if (B <= 0) return 0;
  if (P < 1 || P > kMaxP || B > 2147483647LL || maxfev < 1 ||
      maxfev > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  conf.maxfev = static_cast<int>(maxfev);
  const size_t smem = smem_bytes<T>(P);
  cudaError_t err = cudaFuncSetAttribute(
      lm_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, nsm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lm_solve_kernel<T>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t want = (B + kWarps - 1) / kWarps;
  const int64_t resident = static_cast<int64_t>(nsm) * per_sm;
  const unsigned blocks = static_cast<unsigned>(want < resident ? want : resident);

  Args<T> a{static_cast<const T*>(guess), static_cast<const T*>(lo),
            static_cast<const T*>(hi), static_cast<const T*>(psf),
            static_cast<const T*>(v), static_cast<const T*>(u),
            static_cast<const T*>(ia), static_cast<const T*>(ve),
            static_cast<T*>(y), static_cast<T*>(cost), static_cast<T*>(jtr),
            static_cast<T*>(jtj), static_cast<T*>(lam),
            static_cast<int32_t*>(nfev), static_cast<uint8_t*>(done),
            static_cast<uint8_t*>(ier_small_step),
            static_cast<uint8_t*>(ier_small_cost), static_cast<uint8_t*>(pinned),
            static_cast<int*>(counter), static_cast<int>(B), static_cast<int>(P),
            conf};
  lm_solve_kernel<T><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// registers a thread, static and dynamic shared memory, and blocks an SM
// of the kernel at P pixels a lane, as launch() sets it up
template <typename T>
int attrs(int64_t P, int* out) {
  if (P < 1 || P > kMaxP) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T>(P);
  cudaError_t err = cudaFuncSetAttribute(
      lm_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, lm_solve_kernel<T>)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lm_solve_kernel<T>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = per_sm;
  return 0;
}

}  // namespace

// Plain C interface for ctypes. Each launches on `stream`, which must
// belong to the calling thread's current CUDA device (the wrapper makes
// the tensors' device current around the call), and returns the first
// CUDA error of the set-up or the launch (0 on success); the launch is
// asynchronous.
#define NGMIX_LM_SOLVE(NAME, T)                                                \
  extern "C" int NAME(                                                         \
      const void* guess, const void* lo, const void* hi, const void* psf,      \
      const void* v, const void* u, const void* ia, const void* ve, void* y,   \
      void* cost, void* jtr, void* jtj, void* lam, void* nfev, void* done,     \
      void* ier_small_step, void* ier_small_cost, void* pinned, void* counter, \
      int64_t B, int64_t P, int64_t maxfev, double ftol, double xtol,          \
      double lambda0, double lambda_up, double lambda_down, double lambda_min, \
      double lambda_max, void* stream) {                                       \
    const Conf conf{ftol, xtol, lambda0, lambda_up, lambda_down, lambda_min,   \
                    lambda_max, 0};                                            \
    return launch<T>(guess, lo, hi, psf, v, u, ia, ve, y, cost, jtr, jtj, lam, \
                     nfev, done, ier_small_step, ier_small_cost, pinned,       \
                     counter, B, P, maxfev, conf, stream);                     \
  }

NGMIX_LM_SOLVE(ngmix_lm_solve_f32, float)
NGMIX_LM_SOLVE(ngmix_lm_solve_f64, double)

extern "C" int ngmix_lm_solve_attrs_f32(int64_t P, int* out) { return attrs<float>(P, out); }
extern "C" int ngmix_lm_solve_attrs_f64(int64_t P, int* out) { return attrs<double>(P, out); }
