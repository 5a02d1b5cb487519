// Device functions shared by K3 (lm_solve.cuh, one stamp a lane) and
// K3-mb (lm_solve_mb.cuh, one object over its epochs and bands a lane):
// the models' constants, the bounds maps of fitting/lm.py, one epoch's
// gaussians and pixel pass (K1's sums of its 6 + NX effective
// parameters), and the Levenberg-Marquardt loop of fitting/lm.py
// _lm_step over any number of parameters.
//
// A model is a compile-time parameter M with M::kNG gaussians and
// M::kNX extra shape columns between T and the flux. The simple models
// (NX = 0) are fill_simple over the fixed (p, f) tables of
// gmix/tables.py, M::pval(g) and M::fval(g): exp (6 gaussians), gauss
// (1) and dev (10). The composite bulge+disk models (fill_cm, 16
// gaussians) compute each lane's (p, f) and size factor from their
// extra columns, with the derivatives (M::weights): bdf (NX = 1,
// fracdev) and bd (NX = 2, log10(Td/Te) and fracdev). The fill, the
// closed-form chain and the pixel pass are one code for all of them.
//
// A warp runs one lane. What bounds the kernels on an H100 is the
// latency of each (pixel, gaussian) pair's exponential and shared
// loads, hidden only by the warps resident on an SM, which the
// registers a thread holds limit. The design holds a thread's
// registers to what its pixels need:
// - the lane's LM state (the point, its bounds, (cost, Jtr, JtJ) at the
//   current and the trial point) lives once in the warp's shared memory
//   (LmState), not in every thread's registers;
// - the step algebra is split over the warp (thread k < NP takes dim k:
//   the pin test by ballot, row k of the damped Cholesky factor in its
//   registers, the substitutions and the predicted reduction by
//   shuffles), so every thread holds the same bits of each decision by
//   construction, in loops of NP steps rather than lane 0's NP^3 / 6;
// - the gaussians' records are 16-byte aligned 4-tuples that the pixel
//   pass reads as vector broadcasts, in a loop over the gaussians that
//   is not unrolled (unrolled 16 times, the composite solves ran 1.5x
//   slower for the same registers and blocks);
// - the pixel pass forms its sums as running sums of every thread and
//   a shuffle tree (exp, gauss: 28 sums), or through a tile in the
//   warp's shared memory where each thread forms two of the sums (dev,
//   bdf, bd: 28, 36, 45 sums; Tuning).
// exp is the full-precision libm routine: build without fast-math.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// the largest pixel count of a lane whose planes fit the shared memory
// (4 warps x 4 planes x kMaxP float64 values per block, with each
// warp's records and LM state); a lane with more reads its planes from
// global memory
constexpr int kMaxP = 1536;

constexpr double kMaxChi2 = 25.0;
constexpr double kApodChi2 = 20.0;
constexpr double kApodIWidth = 1.0 / (kMaxChi2 - kApodChi2);
constexpr double kLowDetval = 1.0e-200;
constexpr double kTwoPi = 6.283185307179586;
constexpr double kOneMinusEps = 0.9999999999999999;
constexpr double kYClip = 27.631021;       // ln(1e12)
constexpr double kNearBoth = 9.2103404;    // ln(1e4)
constexpr double kNearOne = 1.4142e-2;     // sqrt(2e-4)
constexpr double kPredFloor = 1.0e-300;
constexpr double kLn10 = 2.302585092994046;

// the models' fixed gaussian expansions (gmix/tables.py)
__constant__ double kPvalsExp[6] = {
    0.00061601229677880041, 0.0079461395724623237, 0.053280454055540001,
    0.21797364640726541, 0.45496740582554868, 0.26521634184240478};
__constant__ double kFvalsExp[6] = {
    0.002467115141477932, 0.018147435573256168, 0.07944063151366336,
    0.27137669897479122, 0.79782256866993773, 2.1623306025075739};
__constant__ double kPvalsDev[10] = {
    6.5288960012625658e-05, 0.00044199216814302695, 0.0020859587871659754,
    0.0075913681418996841, 0.02260266219257237, 0.056532254390212859,
    0.11939049233042602, 0.20969545753234975, 0.29254151133139222,
    0.28905301416582552};
__constant__ double kFvalsDev[10] = {
    2.9934935706271918e-07, 3.4651596338231207e-06, 2.4807910570562753e-05,
    1.4307404300535354e-04, 7.2753169298239500e-04, 3.4582464394427260e-03,
    1.6086645440719100e-02, 7.7006776775654429e-02, 4.1012562102501476e-01,
    2.9812509778548648e00};

struct ExpModel {
  static constexpr int kNG = 6;
  static constexpr int kNX = 0;
  __device__ static double pval(int g) { return kPvalsExp[g]; }
  __device__ static double fval(int g) { return kFvalsExp[g]; }
};
struct GaussModel {
  static constexpr int kNG = 1;
  static constexpr int kNX = 0;
  __device__ static double pval(int) { return 1.0; }
  __device__ static double fval(int) { return 1.0; }
};
struct DevModel {
  static constexpr int kNG = 10;
  static constexpr int kNX = 0;
  __device__ static double pval(int g) { return kPvalsDev[g]; }
  __device__ static double fval(int g) { return kFvalsDev[g]; }
};

__device__ __forceinline__ float dpow10(float x) { return powf(10.0f, x); }
__device__ __forceinline__ double dpow10(double x) { return pow(10.0, x); }

// a composite model's extra shape columns x (after row, col, g1, g2, T)
template <typename T, int NX>
struct Extra {
  T v[NX > 0 ? NX : 1];
};

// one gaussian's weight p and size f (before the flux and T), the
// model's size factor tf = 1 / sum_g p_g f_g, and their derivatives in
// the extra columns
template <typename T, int NX>
struct Weights {
  T p, f, tf;
  T dp[NX > 0 ? NX : 1], df[NX > 0 ? NX : 1], dtf[NX > 0 ? NX : 1];
};

// the composite bulge+disk models of gmix/core.py fill_cm: 16 gaussians,
// the 6 exp ones of weight p_exp (1 - fracdev) and size f_exp, the 10 dev
// ones of weight p_dev fracdev and size f_dev Td/Te, every size scaled by
// Tfactor. NX = 1 is bdf (x = fracdev, Td/Te = 1), NX = 2 is bd (x =
// (l, fracdev), Td/Te = 10^l). dp/dfracdev is -p_exp or +p_dev, df/dl =
// ln 10 Td/Te f_dev, and dTfactor = -Tfactor^2 sum_g (dp_g f_g + p_g df_g)
// (batch._composite_pf).
template <int NX>
struct CompositeModel {
  static_assert(NX == 1 || NX == 2, "bdf or bd");
  static constexpr int kNG = 16;
  static constexpr int kNX = NX;

  template <typename T>
  __device__ static Weights<T, NX> weights(int g, const Extra<T, NX>& x) {
    const T d = x.v[NX - 1];
    const T R = NX == 2 ? dpow10(x.v[0]) : T(1);
    // the sums of p f and of its derivatives over the 16 gaussians, in
    // the fill's order
    T s = T(0), s_d = T(0), s_l = T(0);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const bool dev = j >= 6;
      const T pt = static_cast<T>(dev ? kPvalsDev[j - 6] : kPvalsExp[j]);
      const T ft = static_cast<T>(dev ? kFvalsDev[j - 6] : kFvalsExp[j]);
      const T p = dev ? pt * d : pt * (T(1) - d);
      const T f = dev ? ft * R : ft;
      s = s + p * f;
      s_d = s_d + (dev ? pt : -pt) * f;
      if (dev) s_l = s_l + p * (static_cast<T>(kLn10) * R * ft);
    }
    Weights<T, NX> w;
    const bool dev = g >= 6;
    const T pt = static_cast<T>(dev ? kPvalsDev[g - 6] : kPvalsExp[g]);
    const T ft = static_cast<T>(dev ? kFvalsDev[g - 6] : kFvalsExp[g]);
    w.p = dev ? pt * d : pt * (T(1) - d);
    w.f = dev ? ft * R : ft;
    w.tf = T(1) / s;
    w.dp[NX - 1] = dev ? pt : -pt;
    w.df[NX - 1] = T(0);
    w.dtf[NX - 1] = -w.tf * w.tf * s_d;
    if (NX == 2) {
      w.dp[0] = T(0);
      w.df[0] = dev ? static_cast<T>(kLn10) * R * ft : T(0);
      w.dtf[0] = -w.tf * w.tf * s_l;
    }
    return w;
  }
};
using BdfModel = CompositeModel<1>;
using BdModel = CompositeModel<2>;

// the sizes that follow from a model's extra columns
template <typename M>
struct Dims {
  // the parameters one stamp sees: row, col, g1, g2, T, the extra
  // columns, flux
  static constexpr int kNP = 6 + M::kNX;
  // the shape parameters that reach N and F: g1, g2, T and the extras
  static constexpr int kNS = 3 + M::kNX;
  // per gaussian in shared memory, in 4-tuples that one vector load
  // reads (16-byte aligned): (row, col, Fvv, Fvu), (Fuu, N, dN/dflux,
  // 0), then (dN, dFvv, dFvu, dFuu) / d each shape parameter
  static constexpr int kGStride = 8 + 4 * kNS;
  // one stamp's running sums: cost, Jtr [kNP], the upper triangle of
  // JtJ
  static constexpr int kNSum = 1 + kNP + kNP * (kNP + 1) / 2;
};

struct Conf {
  double ftol, xtol, lambda0, lambda_up, lambda_down, lambda_min, lambda_max;
  int maxfev;
  // end a lane at the cost floor (fitting/lm.py LMConf.at_floor)
  bool at_floor;
};

// a lane's finished solver state, as fitting.lm.run_lm_normal_state
// returns it: y, jtr [B, n]; cost, cost_pix (without the prior rows),
// lam [B]; jtj [B, n, n]; nfev [B] int32; done, ier_small_step,
// ier_small_cost [B] and pinned [B, n] as bytes 0/1
template <typename T>
struct Out {
  T* y;
  T* cost;
  T* cost_pix;
  T* jtr;
  T* jtj;
  T* lam;
  int32_t* nfev;
  uint8_t* done;
  uint8_t* ier_small_step;
  uint8_t* ier_small_cost;
  uint8_t* pinned;
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

// index of (k, m) in the upper-triangle sums of an n x n symmetric
// matrix, row by row (K1's order)
template <int N>
__device__ __forceinline__ constexpr int tri(int k, int m) {
  return k <= m ? k * N - k * (k - 1) / 2 + (m - k)
                : m * N - m * (m - 1) / 2 + (k - m);
}

// (k, m) of entry t of an np x np upper triangle, row by row (tri's
// inverse)
__device__ __forceinline__ void tri_km(int np, int t, int& k, int& m) {
  k = 0;
  while (t >= np - k) {
    t -= np - k;
    ++k;
  }
  m = k + t;
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
// one stamp: the model's gaussians and K1's pixel pass

// fill_simple's shape terms of (g1, g2): e(g) with the clip at |g| = 1,
// and de/dg inside |g| < 1 (a point outside is bad and uses no chain)
template <typename T>
struct Shape {
  bool gbad;
  T e1, e2, de1_g1, de1_g2, de2_g2;
};

template <typename T>
__device__ __forceinline__ Shape<T> fill_shape(T g1, T g2) {
  Shape<T> s;
  const T gsq = g1 * g1 + g2 * g2;
  s.gbad = gsq >= T(1);
  const T scale = s.gbad ? T(kOneMinusEps) / dsqrt(gsq) : T(1);
  const T g1c = g1 * scale, g2c = g2 * scale;
  const T fac = T(2) / (T(1) + g1c * g1c + g2c * g2c);
  s.e1 = fac * g1c;
  s.e2 = fac * g2c;
  const T f2 = fac * fac;
  s.de1_g1 = fac - f2 * g1c * g1c;
  s.de1_g2 = -f2 * g1c * g2c;
  s.de2_g2 = fac - f2 * g2c * g2c;
  return s;
}

// four consecutive values of a 16-byte aligned record in shared memory
// in one or two vector loads, and their store
__device__ __forceinline__ void ld4(const float* p, float& a, float& b, float& c, float& d) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  a = q.x;
  b = q.y;
  c = q.z;
  d = q.w;
}
__device__ __forceinline__ void ld4(const double* p, double& a, double& b, double& c,
                                    double& d) {
  const double2 q0 = *reinterpret_cast<const double2*>(p);
  const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
  a = q0.x;
  b = q0.y;
  c = q1.x;
  d = q1.y;
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void st4(double* p, double a, double b, double c, double d) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
  *reinterpret_cast<double2*>(p + 2) = make_double2(c, d);
}

// the M::kNG gaussians of the convolved model at (row, col, shape, tsz,
// extra columns xe, flux) with the psf gaussian (pirr, pirc, picc), and
// their chain terms, into gs [M::kNG * Dims<M>::kGStride] in the
// record layout of Dims: threads 0 to M::kNG - 1 of the warp compute
// one gaussian each. Returns, on every thread, whether a gaussian fails
// gmix_flags' rule (low determinant).
template <typename M, typename T>
__device__ __forceinline__ bool model_gaussians(T* gs, int lid, T row, T col,
                                                const Shape<T>& sh, T tsz,
                                                const Extra<T, M::kNX>& xe, T flux,
                                                T pirr, T pirc, T picc) {
  static_assert(M::kNG >= 1 && M::kNG <= 32, "one thread a gaussian");
  constexpr int NX = M::kNX;
  constexpr int NS = Dims<M>::kNS;
  constexpr int kStride = Dims<M>::kGStride;
  // every thread has read the previous point's gaussians
  __syncwarp();
  bool lowdet = false;
  if (lid < M::kNG) {
    const int g = lid;
    T pv, fv, h, dh_dT;
    // d h / d (the extra columns), and d p / d them, for the composite
    // models
    T dh_x[NX > 0 ? NX : 1], dp_x[NX > 0 ? NX : 1];
    if constexpr (NX == 0) {
      fv = static_cast<T>(M::fval(g));
      pv = static_cast<T>(M::pval(g));
      h = T(0.5) * tsz * fv;
      dh_dT = T(0.5) * fv;
    } else {
      const Weights<T, NX> w = M::template weights<T>(g, xe);
      fv = w.f;
      pv = w.p;
      h = T(0.5) * (tsz * w.tf) * fv;
      dh_dT = (T(0.5) * w.tf) * fv;
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        dh_x[j] = (T(0.5) * tsz) * (w.dtf[j] * fv + w.tf * w.df[j]);
        dp_x[j] = w.dp[j];
      }
    }
    const T irr = h * (T(1) - sh.e1) + pirr;
    const T irc = h * sh.e2 + pirc;
    const T icc = h * (T(1) + sh.e1) + picc;
    const T det = irr * icc - irc * irc;
    const T tc = irr + icc;
    // gmix_flags' rule, then gmix_reparam's
    lowdet = det < static_cast<T>(kLowDetval) || tc <= static_cast<T>(kLowDetval);
    const bool valid = det > static_cast<T>(kLowDetval) && tc > T(0);
    T* q = gs + g * kStride;
    if (valid) {
      const T idet = T(1) / det;
      const T denom = static_cast<T>(kTwoPi) * dsqrt(det);
      const T N = flux * pv / denom;
      const T Fvv = icc * idet, Fvu = -irc * idet, Fuu = irr * idet;
      st4(q, row, col, Fvv, Fvu);
      st4(q + 4, Fuu, N, pv / denom, T(0));
      // d (irr, irc, icc) / d (g1, g2, T, the extra columns)
      T d_rr[NS], d_rc[NS], d_cc[NS];
      d_rr[0] = -h * sh.de1_g1;
      d_rc[0] = h * sh.de1_g2;
      d_cc[0] = h * sh.de1_g1;
      d_rr[1] = -h * sh.de1_g2;
      d_rc[1] = h * sh.de2_g2;
      d_cc[1] = h * sh.de1_g2;
      d_rr[2] = dh_dT * (T(1) - sh.e1);
      d_rc[2] = dh_dT * sh.e2;
      d_cc[2] = dh_dT * (T(1) + sh.e1);
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        d_rr[3 + j] = dh_x[j] * (T(1) - sh.e1);
        d_rc[3 + j] = dh_x[j] * sh.e2;
        d_cc[3 + j] = dh_x[j] * (T(1) + sh.e1);
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const T ddet = icc * d_rr[s] + irr * d_cc[s] - T(2) * irc * d_rc[s];
        T dN = T(-0.5) * N * ddet * idet;
        // the extra columns also reach N through p: flux dp / (2 pi sqrt det)
        if (s >= 3) dN = dN + flux * dp_x[s >= 3 ? s - 3 : 0] / denom;
        st4(q + 8 + 4 * s, dN, (d_cc[s] - Fvv * ddet) * idet, (-d_rc[s] - Fvu * ddet) * idet,
            (d_rr[s] - Fuu * ddet) * idet);
      }
    } else {
      // an invalid gaussian adds nothing: N = 0, unit inverse covariance
      st4(q, row, col, T(1), T(0));
      st4(q + 4, T(1), T(0), T(0), T(0));
#pragma unroll
      for (int s = 0; s < NS; ++s) st4(q + 8 + 4 * s, T(0), T(0), T(0), T(0));
    }
  }
  const bool bad = __any_sync(kFull, lowdet);
  __syncwarp();
  return bad;
}

// the pixel pass of a model: kTile, whether it forms its sums through
// the warp's tile (below), which holds fewer registers a thread than
// running sums and pays for itself past 6 gaussians a pixel (dev and
// the composite models)
template <typename M> struct Tuning {
  static constexpr bool kTile = M::kNG > 6;
  // whether K3-mb copies a lane's planes into shared memory (where they
  // fit): for a pass of under 6 gaussians a pixel, too little arithmetic
  // to hide loads from global memory. On an H100 at E P = 1083 the
  // copy made gauss faster and exp (6 gaussians) 4% slower
  static constexpr bool kMbSharedPlanes = M::kNG < 6;
};

// the blocks an SM a kernel of model M is compiled for
// (__launch_bounds__'s second argument; kMb for K3-mb). float32: 5
// blocks of 128 threads (96 registers a thread) for K3's running-sum
// models (exp, gauss), 4 (128 registers) for the tile models and for
// K3-mb, whose passes need them without spills; measured on an H100,
// 5 blocks made exp 7% faster and the tile models 5-15% slower or
// spilling, 6 spilled everywhere. float64 (the host routes at B = 1,
// the card-against-CPU checks): 2
template <typename T, typename M, bool kMb>
struct MinBlocks {
  static constexpr int k = !kMb && !Tuning<M>::kTile ? 5 : 4;
};
template <typename M, bool kMb>
struct MinBlocks<double, M, kMb> {
  static constexpr int k = 2;
};

// one pixel's model value f and d value / d (the NP = 6 + M::kNX
// effective parameters: row, col, g1, g2, T, the extra columns, flux)
// into J, from the M::kNG gaussians gs at (vv, uu)
template <typename M, typename T>
__device__ __forceinline__ void pixel_row(const T* gs, T vv, T uu, T& f,
                                          T (&J)[Dims<M>::kNP]) {
  constexpr int NP = Dims<M>::kNP;
  constexpr int NS = Dims<M>::kNS;
  constexpr int kStride = Dims<M>::kGStride;
  f = T(0);
#pragma unroll
  for (int k = 0; k < NP; ++k) J[k] = T(0);
  // not unrolled: unrolled 16 times (bdf, bd), the composite solves ran
  // 1.5x slower on an H100 for the same registers and blocks
#pragma unroll 1
  for (int g = 0; g < M::kNG; ++g) {
    const T* q = gs + g * kStride;
    T row, col, fvv, fvu, fuu, N, pd, pad;
    ld4(q, row, col, fvv, fvu);
    ld4(q + 4, fuu, N, pd, pad);
    const T dv = vv - row;
    const T du = uu - col;
    const T gv = fvv * dv + fvu * du;
    const T gu = fvu * dv + fuu * du;
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
    f += N * mw;
    // d(N e(chi2) w(chi2)) / d chi2, then d value / d q
    const T c = N * e * (dwin - T(0.5) * win);
    const T dq1 = T(-2) * c * gv;
    const T dq2 = T(-2) * c * gu;
    const T dq3 = c * dv * dv;
    const T dq4 = T(2) * c * dv * du;
    const T dq5 = c * du * du;
    J[0] += dq1;
    J[1] += dq2;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      T dN, dfvv, dfvu, dfuu;
      ld4(q + 8 + 4 * s, dN, dfvv, dfvu, dfuu);
      J[2 + s] += mw * dN + dq3 * dfvv + dq4 * dfvu + dq5 * dfuu;
    }
    J[NP - 1] += mw * pd;
  }
}

// a warp's tile of the pixel pass: np + 1 columns (the weighted J of
// np parameters, the residual) of 32 pixels, each column padded to
// kTileStride values so that lanes reading different columns as 16-byte
// vectors hit different banks, then the totals of the pass's sums;
// none without Tuning<M>::kTile
constexpr int kTileStride = 36;
template <typename M>
__host__ __device__ constexpr int tile_values() {
  return Tuning<M>::kTile ? (Dims<M>::kNP + 1) * kTileStride + (Dims<M>::kNSum + 3) / 4 * 4
                          : 0;
}

// the tile columns (a, b) whose product over the pixels is sum entry e
__device__ __forceinline__ void entry_cols(int np, int e, int& a, int& b) {
  if (e == 0) {
    a = np;
    b = np;
  } else if (e <= np) {
    a = e - 1;
    b = np;
  } else {
    tri_km(np, e - 1 - np, a, b);
  }
}

// K1's sums over one stamp's P pixels (planes v, u, ia, ve, in shared
// or global memory) with the M::kNG gaussians gs: entry e of (cost, Jtr
// [NP], JtJ upper triangle) of the NP = 6 + M::kNX effective parameters
// goes to put(e, total), called by the thread that holds it. Called by
// every thread of the warp.
// - running sums (exp, gauss): each thread's running sums of its
//   pixels, then a fixed-order shuffle tree; thread 0 puts every entry.
// - the tile (Tuning<M>::kTile): 32 pixels at a time, one a thread,
//   each thread's weighted J row and residual go into the warp's tile,
//   and thread lid forms entries lid and lid + 32 over the tile's
//   pixels in four interleaved partial sums, added to their totals (in
//   shared memory, after the tile) in pixel order, which it puts. A
//   thread holds NP + 1 values of a pixel, not 36-45 running sums.
template <typename M, typename T, typename Put>
__device__ __forceinline__ void pixel_pass(const T* gs, T* tile, int lid, const T* v,
                                           const T* u, const T* ia, const T* ve, int P,
                                           Put&& put) {
  constexpr int NP = Dims<M>::kNP;
  constexpr int kNSum = Dims<M>::kNSum;
  if constexpr (!Tuning<M>::kTile) {
    T acc[kNSum];
#pragma unroll
    for (int i = 0; i < kNSum; ++i) acc[i] = T(0);
    for (int p = lid; p < P; p += 32) {
      T f, J[NP];
      pixel_row<M>(gs, v[p], u[p], f, J);
      const T iap = ia[p];
      const T fd = f * iap - ve[p];
      T Jw[NP];
#pragma unroll
      for (int k = 0; k < NP; ++k) Jw[k] = J[k] * iap;
      acc[0] += fd * fd;
#pragma unroll
      for (int k = 0; k < NP; ++k) acc[1 + k] += Jw[k] * fd;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
#pragma unroll
        for (int m = k; m < NP; ++m) acc[1 + NP + tri<NP>(k, m)] += Jw[k] * Jw[m];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < kNSum; ++i) acc[i] += __shfl_down_sync(kFull, acc[i], off);
    }
    if (lid == 0) {
#pragma unroll
      for (int i = 0; i < kNSum; ++i) put(i, acc[i]);
    }
  } else {
    // the entries' totals, after the tile's columns
    T* tot = tile + (NP + 1) * kTileStride;
    for (int e = lid; e < kNSum; e += 32) tot[e] = T(0);
    for (int p0 = 0; p0 < P; p0 += 32) {
      const int p = p0 + lid;
      T J[NP];
      T fd = T(0);
      if (p < P) {
        T f;
        pixel_row<M>(gs, v[p], u[p], f, J);
        const T iap = ia[p];
        fd = f * iap - ve[p];
#pragma unroll
        for (int k = 0; k < NP; ++k) J[k] = J[k] * iap;
      } else {
        // a pixel past P adds 0 to every entry
#pragma unroll
        for (int k = 0; k < NP; ++k) J[k] = T(0);
      }
#pragma unroll
      for (int k = 0; k < NP; ++k) tile[k * kTileStride + lid] = J[k];
      tile[NP * kTileStride + lid] = fd;
      __syncwarp();
      for (int e = lid; e < kNSum; e += 32) {
        int ca, cb;
        entry_cols(NP, e, ca, cb);
        const T* a = tile + ca * kTileStride;
        const T* b = tile + cb * kTileStride;
        T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
        // two vector pairs in flight: unrolled fully, the loads of all
        // eight took the registers that made K3-mb spill
#pragma unroll 2
        for (int i = 0; i < 32; i += 4) {
          T a0, a1, a2, a3, b0, b1, b2, b3;
          ld4(a + i, a0, a1, a2, a3);
          ld4(b + i, b0, b1, b2, b3);
          s0 += a0 * b0;
          s1 += a1 * b1;
          s2 += a2 * b2;
          s3 += a3 * b3;
        }
        tot[e] += (s0 + s1) + (s2 + s3);
      }
      // every thread has read the tile before the next pixels go in
      __syncwarp();
    }
    for (int e = lid; e < kNSum; e += 32) put(e, tot[e]);
  }
}

// the unit-flux model's sums over one stamp's P pixels with the gaussians
// gs (model_gaussians at flux 1): smy = sum m ve and smm = sum m^2, m =
// f ia the weighted model, f summed over the gaussians as pixel_pass
// sums it; the same bits on every thread
template <typename M, typename T>
__device__ __forceinline__ void value_pass(const T* gs, int lid, const T* v, const T* u,
                                           const T* ia, const T* ve, int P, T& smy,
                                           T& smm) {
  constexpr int kStride = Dims<M>::kGStride;
  T a = T(0), b = T(0);
  for (int p = lid; p < P; p += 32) {
    const T vv = v[p];
    const T uu = u[p];
    T f = T(0);
#pragma unroll
    for (int g = 0; g < M::kNG; ++g) {
      const T* q = gs + g * kStride;
      T row, col, fvv, fvu, fuu, N, pd, pad;
      ld4(q, row, col, fvv, fvu);
      ld4(q + 4, fuu, N, pd, pad);
      const T dv = vv - row;
      const T du = uu - col;
      const T gv = fvv * dv + fvu * du;
      const T gu = fvu * dv + fuu * du;
      const T chi2 = gv * dv + gu * du;
      if (!(chi2 >= T(0) && chi2 < static_cast<T>(kMaxChi2))) continue;
      T win = T(1);
      if (chi2 > static_cast<T>(kApodChi2)) {
        const T t = (static_cast<T>(kMaxChi2) - chi2) * static_cast<T>(kApodIWidth);
        win = t * t * t * (T(10) + t * (T(-15) + T(6) * t));
      }
      f += N * (dexp(T(-0.5) * chi2) * win);
    }
    const T mh = f * ia[p];
    a += mh * ve[p];
    b += mh * mh;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(kFull, a, off);
    b += __shfl_down_sync(kFull, b, off);
  }
  smy = __shfl_sync(kFull, a, 0);
  smm = __shfl_sync(kFull, b, 0);
}

// ----------------------------------------------------------------------
// prior rows (joint_prior.py): a table of nrows rows of kPriorCols
// float64 values, (kind, form, i0, i1, c0, c1, c2, c3): the row's kind
// of prior, its form, the parameter it depends on (and the second one
// of a 2-d prior, else -1) and its constants. Each kind gives ln p and
// d ln p / dx (form kPriorLnp, the row sqrt(max(-2 ln p, 0))) or a
// signed fdiff f and df / dx (kPriorFdiff), with the formulas of
// priors/*.py. Outside a prior's support ln p = -inf (and a signed row
// is inf), with derivative 0, so Jtr turns nan there (0 inf) as in the
// reference, and the trial point is rejected.

enum PriorKind {
  kPriorFlat = 0,       // FlatPrior (min, max)
  kPriorNormal = 1,     // Normal (mean, sigma)
  kPriorCen = 2,        // CenPrior, one dimension (cen, sinv, s2inv)
  kPriorErf = 3,        // TwoSidedErf (min, width_at_min, max, width_at_max)
  kPriorLogNormal = 4,  // LogNormal (shift, logmean, -logivar / 2, lnprob_max)
  kPriorSinh = 5,       // Sinh (mean, scale)
  kPriorTrunc = 6,      // TruncatedGaussian (mean, sinv, min, max)
  kPriorGBA = 7,        // GPriorBA, 2-d (sig2inv)
  kPriorZDisk = 8,      // ZDisk2D, 2-d (radius^2)
  kPriorLMBounds = 9,   // LMBounds: a box without weight, row 0 * x, derivative 0
};
constexpr int kPriorLnp = 0;
constexpr int kPriorFdiff = 1;
constexpr int kPriorCols = 8;
// the most rows a table holds (ops/lm_solve.py: MAX_PRIOR_ROWS)
constexpr int kMaxPriorRows = 16;
// a warp's shared scratch for the prior rows of np parameters
// (add_prior): each row's (row, d/dx_i0, d/dx_i1, i0, i1), the internal
// parameters and their bounds (y, lo, hi), and the sums of the cost, Jtr
// and the JtJ triangle. It reuses the warp's gaussian records, free
// after the pixel pass, where they are large enough
__host__ __device__ constexpr int prior_scratch(int np) {
  return 5 * kMaxPriorRows + 3 * np + 1 + np + np * (np + 1) / 2;
}
__host__ __device__ constexpr int max_of(int a, int b) { return a > b ? a : b; }
constexpr double kTwoOverSqrtPi = 1.1283791670955126;

__device__ __forceinline__ float derf(float x) { return erff(x); }
__device__ __forceinline__ double derf(double x) { return erf(x); }
__device__ __forceinline__ float dsinh(float x) { return sinhf(x); }
__device__ __forceinline__ double dsinh(double x) { return sinh(x); }
__device__ __forceinline__ float dcosh(float x) { return coshf(x); }
__device__ __forceinline__ double dcosh(double x) { return cosh(x); }

// one row of the table, r, at the parameters yl = (y, lo, hi) [3 np]
// (shared memory): (the row, its derivatives in x_i0 and x_i1, i0, i1)
// into q
template <typename T>
__device__ __forceinline__ void prior_row(const double* r, const T* yl, int np, T* q) {
  const int kind = static_cast<int>(r[0]);
  const bool lnp_form = static_cast<int>(r[1]) == kPriorLnp;
  const int i0 = static_cast<int>(r[2]), i1 = static_cast<int>(r[3]);
  const T x0 = i2e(yl[i0], yl[np + i0], yl[2 * np + i0]);
  const T x1 = i1 >= 0 ? i2e(yl[i1], yl[np + i1], yl[2 * np + i1]) : T(0);
  T row, d0, d1;
  const T c0 = static_cast<T>(r[4]), c1 = static_cast<T>(r[5]);
  const T c2 = static_cast<T>(r[6]), c3 = static_cast<T>(r[7]);
  const T ninf = -inf_of<T>();
  // lnp_form: v = ln p, d0 / d1 its derivatives; else v = fdiff
  T v = T(0);
  d0 = T(0);
  d1 = T(0);
  switch (kind) {
    case kPriorFlat: {
      const bool out = x0 < c0 || x0 > c1;
      v = out ? (lnp_form ? ninf : inf_of<T>()) : T(0);
      break;
    }
    case kPriorNormal: {
      const T z = (x0 - c0) / c1;
      const T dz = T(1) / c1;
      v = lnp_form ? (T(-0.5) * z) * z : z;
      d0 = lnp_form ? -(z * dz) : dz;
      break;
    }
    case kPriorCen: {
      if (lnp_form) {
        const T d = c0 - x0;
        v = ((T(-0.5) * d) * d) * c2;
        d0 = d * c2;
      } else {
        v = (x0 - c0) * c1;
        d0 = c1;
      }
      break;
    }
    case kPriorErf: {
      const T a = (x0 - c0) / c1;
      const T b = (c2 - x0) / c3;
      const T p = T(0.5) * (derf(a) + derf(b));
      const T k = static_cast<T>(kTwoOverSqrtPi);
      const T dp = T(0.5) * (k * ((T(1) / c1) * dexp(-(a * a))) +
                             k * ((T(-1) / c3) * dexp(-(b * b))));
      const bool ok = p > T(0);
      v = ok ? dlog(p) : ninf;
      d0 = ok ? dp / p : T(0);
      break;
    }
    case kPriorLogNormal: {
      const T val = x0 - c0;
      const bool ok = val > T(0);
      const T w = ok ? val : T(1);
      const T t = dlog(w);
      const T d = t - c1;
      const T dt = T(1) / w;
      v = ok ? (c2 * (d * d) - t) - c3 : ninf;
      d0 = ok ? c2 * (dt * (T(2) * d)) - dt : T(0);
      break;
    }
    case kPriorSinh: {
      const T u = (x0 - c0) / c1;
      const T f = dsinh(u);
      const T df = dcosh(u) * (T(1) / c1);
      v = lnp_form ? (T(-0.5) * f) * f : f;
      d0 = lnp_form ? -(f * df) : df;
      break;
    }
    case kPriorTrunc: {
      const bool out = x0 < c2 || x0 > c3;
      const T z = (x0 - c0) * c1;
      if (lnp_form) {
        v = out ? ninf : (T(-0.5) * z) * z;
        d0 = out ? T(0) : -(z * c1);
      } else {
        v = out ? inf_of<T>() : z;
        d0 = out ? T(0) : c1;
      }
      break;
    }
    case kPriorGBA: {
      const T gsq = x0 * x0 + x1 * x1;
      const T omgsq = T(1) - gsq;
      const bool ok = omgsq > T(0);
      const T om = ok ? omgsq : T(1);
      const T g1 = T(2) * x0, g2 = T(2) * x1;
      v = ok ? T(2) * dlog(om) - (T(0.5) * gsq) * c0 : ninf;
      d0 = ok ? T(2) * (-g1 / om) - (T(0.5) * g1) * c0 : T(0);
      d1 = ok ? T(2) * (-g2 / om) - (T(0.5) * g2) * c0 : T(0);
      break;
    }
    case kPriorZDisk: {
      v = x0 * x0 + x1 * x1 >= c0 ? ninf : T(0);
      break;
    }
    case kPriorLMBounds: {
      // the reference's 0 * val in both forms: ln p 0 gives the row 0
      v = T(0) * x0;
      break;
    }
    default:  // not a kind: nan
      v = T(0) * inf_of<T>();
  }
  if (lnp_form) {
    // sqrt(max(-2 ln p, 0)), 0 (and no derivative) where that is not
    // positive, a nan ln p included
    const T chi2 = clamp_min(T(-2) * v, T(0));
    const bool pos = chi2 > T(0);
    row = pos ? dsqrt(chi2) : T(0);
    const T half = T(0.5) / (pos ? row : T(1));
    d0 = pos ? (T(-2) * d0) * half : T(0);
    d1 = pos ? (T(-2) * d1) * half : T(0);
  } else {
    row = v;
  }
  q[0] = row;
  q[1] = d0;
  q[2] = d1;
  q[3] = static_cast<T>(i0);
  q[4] = static_cast<T>(i1);
}

// ----------------------------------------------------------------------
// a lane's LM state, in the warp's shared memory

// the sums of an evaluation, (cost, Jtr [np], the JtJ upper triangle),
// in K1's order: the pixel pass's acc, the prior's pout and what the
// step reads
__host__ __device__ constexpr int sums_of(int np) { return 1 + np + np * (np + 1) / 2; }

// the point y, its bounds and the sums at two points, slot cur the
// current one and cur ^ 1 the trial one (an accepted step flips cur);
// x and gr are an evaluation's i2e(y) and i2e_grad(y). Written by the
// lanes that own the entries; read by all after a __syncwarp
template <typename T, int NP>
struct LmState {
  static constexpr int kNT = NP * (NP + 1) / 2;
  static constexpr int kNSum = sums_of(NP);
  T lo[NP], hi[NP];
  T psf[3];  // K3's (irr, irc, icc) of the lane's psf gaussian
  T y[2][NP];
  T sum[2][kNSum];
  T cost_pix[2];
  T x[NP];
  T gr[NP];
  // the loop's values held through an evaluation (solve_lane): the
  // trial step (dim k's on thread k), the damping, the pins and the
  // flags of the last step (kStepOk, kPinChanged, kIerStep, kIerCost)
  T dy[NP];
  T lam, lam_eff;
  unsigned pin, pinned;
  int flags;
};
constexpr int kStepOk = 1, kPinChanged = 2, kIerStep = 4, kIerCost = 8;


// values a warp's LmState takes, rounded up to 16 bytes of float32
template <typename T, int NP>
__host__ __device__ constexpr int state_size() {
  return ((static_cast<int>(sizeof(LmState<T, NP>) / sizeof(T)) + 3) / 4) * 4;
}

// the pixel pass's tile of the warp whose LmState is s: right after it
template <typename T, int NP>
__device__ __forceinline__ T* tile_of(LmState<T, NP>& s) {
  return reinterpret_cast<T*>(&s) + state_size<T, NP>();
}

// the step's scratch in the warp's records (free between evaluations):
// the rows of the damped matrix's Cholesky factor
__host__ __device__ constexpr int step_scratch(int np) { return np * (np + 1) / 2; }

// the prior rows' sums of np parameters into the scratch ps, from the
// table's nrows rows and yl = (y, lo, hi) at ps + 5 kMaxPriorRows:
// thread i < nrows computes row i and its derivatives, then thread t
// the sums t, t + 32, ... of the 1 + np + np (np + 1) / 2 outputs (the
// cost, Jtr[k], JtJ[k][m] in triangle order), each over the rows in
// their order, into ps + 5 kMaxPriorRows + 3 np. Called by every thread
// of the warp.
template <typename T>
__device__ __forceinline__ void prior_sums(const double* tab, int nrows, int np, T* ps,
                                           int lid) {
  const T* yl = ps + 5 * kMaxPriorRows;
  T* pout = ps + 5 * kMaxPriorRows + 3 * np;
  if (lid < nrows) prior_row<T>(tab + kPriorCols * lid, yl, np, ps + 5 * lid);
  __syncwarp();
  for (int e = lid; e < 1 + np + np * (np + 1) / 2; e += 32) {
    // Jp[i][k] is row i's derivative in parameter k; k = m = -1 is the
    // row itself
    int k = -1, m = -1;
    if (e > np) {
      int q = e - 1 - np;
      k = 0;
      while (q >= np - k) {
        q -= np - k;
        ++k;
      }
      m = k + q;
    } else if (e > 0) {
      k = e - 1;
    }
    T s = T(0);
    for (int i = 0; i < nrows; ++i) {
      const T* q = ps + 5 * i;
      const T jk = k < 0 ? q[0]
                         : (q[3] == static_cast<T>(k) ? q[1]
                                                      : (q[4] == static_cast<T>(k) ? q[2]
                                                                                   : T(0)));
      const T jm = m < 0 ? q[0]
                         : (q[3] == static_cast<T>(m) ? q[1]
                                                      : (q[4] == static_cast<T>(m) ? q[2]
                                                                                   : T(0)));
      s = s + jk * jm;
    }
    pout[e] = s;
  }
}

// add the table's nrows prior rows at the external parameters i2e(y)
// of slot's point to its (cost, Jtr, JtJ) in external coordinates, as
// fitting/lm.py does: cost += sum rows^2, Jtr += Jp^T rows, JtJ += Jp^T
// Jp, each sum over the rows first, in the rows' order (prior_sums),
// then added entry by entry. ps: the warp's scratch of
// prior_scratch(NP) values, the gaussian records after the pixel pass.
template <typename T, int NP>
__device__ __forceinline__ void add_prior(const double* tab, int nrows, T* ps, int lid,
                                          LmState<T, NP>& s, int slot) {
  if (nrows == 0) return;
  T* yl = ps + 5 * kMaxPriorRows;
  // every thread is done with the gaussian records this reuses
  __syncwarp();
  if (lid < NP) {
    yl[lid] = s.y[slot][lid];
    yl[NP + lid] = s.lo[lid];
    yl[2 * NP + lid] = s.hi[lid];
  }
  __syncwarp();
  prior_sums<T>(tab, nrows, NP, ps, lid);
  __syncwarp();
  const T* pout = yl + 3 * NP;
  T* sum = s.sum[slot];
  for (int e = lid; e < sums_of(NP); e += 32) sum[e] = sum[e] + pout[e];
  __syncwarp();
}

// the bounds chain rule J_int = J_ext diag(g) on slot's sums, in
// place, g = i2e_grad(y) into s.gr
template <typename T, int NP>
__device__ __forceinline__ void bounds_chain(LmState<T, NP>& s, int slot, int lid) {
  if (lid < NP) s.gr[lid] = i2e_grad(s.y[slot][lid], s.lo[lid], s.hi[lid]);
  __syncwarp();
  T* sum = s.sum[slot];
  for (int e = 1 + lid; e < sums_of(NP); e += 32) {
    if (e <= NP) {
      sum[e] = sum[e] * s.gr[e - 1];
    } else {
      int k, m;
      tri_km(NP, e - 1 - NP, k, m);
      sum[e] = sum[e] * s.gr[k] * s.gr[m];
    }
  }
  __syncwarp();
}

// i2e of slot's point into s.x, for every thread
template <typename T, int NP>
__device__ __forceinline__ void point_x(LmState<T, NP>& s, int slot, int lid) {
  if (lid < NP) s.x[lid] = i2e(s.y[slot][lid], s.lo[lid], s.hi[lid]);
  __syncwarp();
}

// slot's sums at a bad point: cost, Jtr 0 and JtJ the identity (or 0
// with zero_jtj)
template <typename T, int NP>
__device__ __forceinline__ void bad_sums(LmState<T, NP>& s, int slot, int lid, T cost,
                                         bool zero_jtj) {
  T* sum = s.sum[slot];
  for (int e = lid; e < sums_of(NP); e += 32) {
    T val = T(0);
    if (e == 0) {
      val = cost;
    } else if (e > NP && !zero_jtj) {
      int k, m;
      tri_km(NP, e - 1 - NP, k, m);
      val = k == m ? T(1) : T(0);
    }
    sum[e] = val;
  }
}

// ----------------------------------------------------------------------
// one lane's solve, in the order of fitting/lm.py _lm_step, over NP
// parameters: evaluate(slot) gives (cost, Jtr, JtJ) in internal
// coordinates at s.y[slot] into s.sum[slot], JtJ as its upper triangle,
// and the cost without the prior rows into s.cost_pix[slot], and ends
// with a __syncwarp. The step algebra below is split over the warp's
// threads, thread k < NP taking dim k; its sums run in shuffles, in a
// fixed order, so every thread holds the same bits of each decision.

// the pinned dims as a bit mask: dims on a finite bound whose gradient
// points outward and whose whole remaining improvement is below the ftol
// resolution (fitting/lm.py _pinned_dims). Thread k < NP tests dim k, a
// ballot gathers the bits; every thread returns the mask
template <typename T, int NP>
__device__ __forceinline__ unsigned pin_mask(const T* y, const T* jtr, T cost, T ftol,
                                             const T* lo, const T* hi, int lid) {
  bool bit = false;
  if (lid < NP) {
    const int k = lid;
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
    bit = near && (to_lo || to_hi) && available < ftol * cost;
  }
  return __ballot_sync(kFull, bit);
}

// index of (i, j), j <= i, in a lower triangle stored row by row
__device__ __forceinline__ constexpr int low(int i, int j) { return i * (i + 1) / 2 + j; }

// the damped step of the masked normal equations (fitting/lm.py
// _mask_normal and _solve_damped, Marquardt scaling), split over the
// warp: thread i < NP holds row i of the damped matrix in registers and
// factors it into row i of its Cholesky factor column by column
// (ops/small_linalg.py's order), publishing each finished row to L [NP
// (NP + 1) / 2] in the warp's scratch for the rows below; the forward
// substitution passes each z_k by a shuffle, the backward one each dy_k,
// summing the terms of dy_i from the last row up. Thread i < NP returns
// dy_i in dy (0 on the other threads); every thread returns whether
// every dy is finite (nan where the matrix is not positive definite)
template <typename T, int NP>
__device__ __forceinline__ bool damped_step(const T* jtj, const T* jtr, unsigned pin,
                                            T lam_eff, T* L, int lid, T& dy) {
  const int i = lid;
  const bool mine = i < NP;
  const bool pin_i = mine && ((pin >> i) & 1u);
  const T fi = pin_i ? T(0) : T(1);
  // row i of the masked normal equations, damped (its lower part)
  T row[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const T fk = (pin >> k) & 1u ? T(0) : T(1);
    T a = mine && k <= i ? jtj[tri<NP>(k, i)] * fi * fk : T(0);
    if (k == i) {
      if (pin_i) a = a + T(1);
      const T d = a > T(0) ? a : T(1);
      a = a + lam_eff * d;
    }
    row[k] = a;
  }
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    if (i == j) {
      T s = row[j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - row[k] * row[k];
      row[j] = dsqrt(s);
#pragma unroll
      for (int k = 0; k <= j; ++k) L[low(j, k)] = row[k];
    }
    __syncwarp();
    if (i > j && mine) {
      T t = row[j];
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - row[k] * L[low(j, k)];
      row[j] = t * (T(1) / L[low(j, j)]);
    }
  }
  // L z = -Jtr over the free dims
  T z = mine ? -(jtr[i] * fi) : T(0);
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    if (i == k) z = z / row[k];
    const T zk = __shfl_sync(kFull, z, k);
    if (i > k && mine) z = z - row[k] * zk;
  }
  // L^T dy = z
  T d = T(0);
#pragma unroll
  for (int k = NP - 1; k >= 0; --k) {
    if (i == k) d = z / row[k];
    const T dk = __shfl_sync(kFull, d, k);
    if (i < k) z = z - L[low(k, i)] * dk;
  }
  dy = mine ? d : T(0);
  return __ballot_sync(kFull, mine && !finite(d)) == 0u;
}

// y + dy with the two-sided dims clipped to the e2i range
// (fitting/lm.py clip_internal)
template <typename T>
__device__ __forceinline__ T clip_step(T y, T dy, T lo, T hi) {
  T t = y + dy;
  if (finite(lo) && finite(hi)) {
    t = clamp_max(clamp_min(t, static_cast<T>(-kYClip)), static_cast<T>(kYClip));
  }
  return t;
}

// sum over k < NP of thread k's v, left to right, on every thread
template <typename T, int NP>
__device__ __forceinline__ T lane_sum(T v) {
  T s = __shfl_sync(kFull, v, 0);
#pragma unroll
  for (int k = 1; k < NP; ++k) s = s + __shfl_sync(kFull, v, k);
  return s;
}

// lane b's state into the outputs: slot's point and sums (every thread
// its entries) and the loop's scalars
template <typename T, int NP>
__device__ __forceinline__ void write_state(const Out<T>& o, size_t b, int lid,
                                            const LmState<T, NP>& s, int slot, T lam,
                                            int nfev, bool done, bool ier_step,
                                            bool ier_cost, unsigned pinned) {
  const T* sum = s.sum[slot];
  if (lid == 0) {
    o.cost[b] = sum[0];
    o.cost_pix[b] = s.cost_pix[slot];
    o.lam[b] = lam;
    o.nfev[b] = nfev;
    o.done[b] = done;
    o.ier_small_step[b] = ier_step;
    o.ier_small_cost[b] = ier_cost;
  }
  if (lid < NP) {
    o.y[NP * b + lid] = s.y[slot][lid];
    o.jtr[NP * b + lid] = sum[1 + lid];
    o.pinned[NP * b + lid] = (pinned >> lid) & 1u;
  }
  for (int e = lid; e < NP * NP; e += 32) {
    o.jtj[NP * NP * b + e] = sum[1 + NP + tri<NP>(e / NP, e % NP)];
  }
}

// the solve; s holds the bounds, scr is the step's scratch
// (step_scratch(NP) values). Every thread runs the loop and holds the
// same bits of its decisions; the loop has one call of evaluate, the
// first point's and then each trial point's, and the values it needs
// after an evaluation wait in s (thread 0 writes the scalars), not in
// registers that every thread would hold through the pixel pass.
// Returns the slot of the final point
template <typename T, int NP, typename Eval>
__device__ int solve_lane(const Conf& cf, const T* guess, LmState<T, NP>& s, T* scr,
                          Eval&& evaluate, const Out<T>& o, size_t b, int lid) {
  if (lid < NP) s.y[0][lid] = e2i(guess[lid], s.lo[lid], s.hi[lid]);
  if (lid == 0) {
    s.lam = static_cast<T>(cf.lambda0);
    s.pinned = 0;
    s.flags = 0;
  }
  __syncwarp();

  int cur = 0, trial = 0, nfev = 0;
  bool done = false;
  for (;;) {
    evaluate(trial);
    if (nfev > 0) {
      const T ftol = static_cast<T>(cf.ftol);
      const T xtol = static_cast<T>(cf.xtol);
      const unsigned pin = s.pin;
      const bool step_ok = s.flags & kStepOk, pin_changed = s.flags & kPinChanged;
      const T lam_eff = s.lam_eff;
      const T dy = lid < NP ? s.dy[lid] : T(0);
      const T yk = lid < NP ? s.y[cur][lid] : T(0);
      const T* sum = s.sum[cur];
      const T cost = sum[0];
      T cost_try = s.sum[trial][0];
      if (!finite(cost_try)) cost_try = inf_of<T>();
      const bool accept = step_ok && cost_try < cost;

      // predicted reduction of the quadratic model, sums left to right:
      // thread i forms (JtJ dy)_i, then every thread sums the rows
      T Hdy = T(0);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const T dj = __shfl_sync(kFull, dy, j);
        const T a = lid < NP ? sum[1 + NP + tri<NP>(lid, j)] : T(0);
        Hdy = j == 0 ? a * dj : Hdy + a * dj;
      }
      const T jtr_k = lid < NP ? sum[1 + lid] : T(0);
      const T pred_g = lane_sum<T, NP>(dy * (T(2) * jtr_k));
      const T pred_h = lane_sum<T, NP>(dy * Hdy);
      const T pred = clamp_min(-pred_g - pred_h, static_cast<T>(kPredFloor));
      const T actual = cost - cost_try;
      // with cf.at_floor (the host fitters' routes), a trial cost equal
      // to the current one where the model predicts less than ftol of
      // it ends the descent (fitting/lm.py _lm_step)
      const bool at_floor = cf.at_floor && step_ok && actual == T(0) && pred <= ftol * cost;
      const bool small_cost =
          at_floor || (accept && actual <= ftol * cost && pred <= ftol * cost);
      // xtol over the free dims only
      const T yf = yk * ((pin >> lid) & 1u ? T(0) : T(1));
      const T ysq = lane_sum<T, NP>(yf * yf);
      const T dsq = lane_sum<T, NP>(dy * dy);
      const bool small_step = accept && dsqrt(dsq) <= xtol * (dsqrt(ysq) + xtol);
      const bool stuck = !accept && lam_eff >= static_cast<T>(cf.lambda_max);
      const T lam = accept
                        ? clamp_min(lam_eff / static_cast<T>(cf.lambda_down),
                                    static_cast<T>(cf.lambda_min))
                        : clamp_max(lam_eff * static_cast<T>(cf.lambda_up),
                                    static_cast<T>(cf.lambda_max * 10.0));
      // every thread has read the values thread 0 now replaces
      __syncwarp();
      if (lid == 0) {
        s.lam = lam;
        s.pinned = pin;
        s.flags = (small_step ? kIerStep : 0) | (small_cost ? kIerCost : 0);
      }
      // an accepted trial point becomes the current one
      cur = accept ? trial : cur;
      done = (small_cost || small_step || stuck) && !pin_changed;
    }
    nfev += 1;
    if (done || nfev >= cf.maxfev) break;
    // every thread has read the sums the next evaluation overwrites
    __syncwarp();

    // the next trial point
    trial = cur ^ 1;
    const T* y = s.y[cur];
    const T* sum = s.sum[cur];
    const unsigned pin =
        pin_mask<T, NP>(y, sum + 1, sum[0], static_cast<T>(cf.ftol), s.lo, s.hi, lid);
    const bool pin_changed = pin != s.pinned;
    const T lam_eff = pin_changed ? static_cast<T>(cf.lambda0) : s.lam;
    T dy;
    const bool step_ok = damped_step<T, NP>(sum + 1 + NP, sum + 1, pin, lam_eff, scr, lid, dy);
    // thread k < NP: dim k of the clipped trial point and of its step
    if (lid < NP) {
      const T yk = y[lid];
      const T yt = clip_step(yk, step_ok ? dy : T(0), s.lo[lid], s.hi[lid]);
      s.y[trial][lid] = yt;
      s.dy[lid] = yt - yk;
    }
    if (lid == 0) {
      s.pin = pin;
      s.lam_eff = lam_eff;
      s.flags = (s.flags & (kIerStep | kIerCost)) | (step_ok ? kStepOk : 0) |
                (pin_changed ? kPinChanged : 0);
    }
    __syncwarp();
  }
  // thread 0's last scalars are visible to every thread
  __syncwarp();
  write_state<T, NP>(o, b, lid, s, cur, s.lam, nfev, done, s.flags & kIerStep,
                     s.flags & kIerCost, s.pinned);
  return cur;
}

// one lane's fixed-iteration damped Gauss-Newton refinement
// (fitting/lm.py run_gn_refine_state): niter steps at the damping lam,
// each at the current point with the LM's pin test and damped step and
// no trial evaluation (a step that is not finite is dropped), then one
// evaluation at the final point, whose state goes to the outputs with
// nfev = niter + 1, done and ier_small_step set. Works in slot 0, with
// one call of evaluate
template <typename T, int NP, typename Eval>
__device__ void refine_lane(const Conf& cf, int niter, T lam, const T* guess,
                            LmState<T, NP>& s, T* scr, Eval&& evaluate, const Out<T>& o,
                            size_t b, int lid) {
  const T ftol = static_cast<T>(cf.ftol);
  if (lid < NP) s.y[0][lid] = e2i(guess[lid], s.lo[lid], s.hi[lid]);
  __syncwarp();
  unsigned pin = 0;
  for (int it = 0;; ++it) {
    evaluate(0);
    if (it == niter) break;
    T* y = s.y[0];
    const T* sum = s.sum[0];
    pin = pin_mask<T, NP>(y, sum + 1, sum[0], ftol, s.lo, s.hi, lid);
    T dy;
    const bool ok = damped_step<T, NP>(sum + 1 + NP, sum + 1, pin, lam, scr, lid, dy);
    __syncwarp();
    if (lid < NP) y[lid] = clip_step(y[lid], ok ? dy : T(0), s.lo[lid], s.hi[lid]);
    __syncwarp();
  }
  write_state<T, NP>(o, b, lid, s, 0, lam, niter + 1, true, true, false, pin);
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
               "n"(N)
               : "memory");
#else
  // a compiler for the host (a CPU emulation of the kernels) copies
  for (int i = 0; i < N; ++i) static_cast<char*>(dst)[i] = static_cast<const char*>(src)[i];
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
#endif
}

// the persistent grid of a kernel: blocks of kThreads, as many as are
// resident on the device at smem bytes of dynamic shared memory a
// block, and no more than the lanes need; 0 or a CUDA error
template <typename K>
int grid_size(K kernel, size_t smem, int64_t lanes, unsigned* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, nsm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t want = (lanes + kWarps - 1) / kWarps;
  const int64_t resident = static_cast<int64_t>(nsm) * per_sm;
  *blocks = static_cast<unsigned>(want < resident ? want : resident);
  return 0;
}

// whether kernel a at smem_a bytes of dynamic shared memory a block
// (the planes in shared memory) keeps two thirds of the blocks an SM of
// kernel b at smem_b (the planes in global memory), into *pays; 0 or a
// CUDA error. On an H100 the shared planes won at 4 and 5 blocks
// against 5 (K3's simple models), global memory at 4 against 2 (K3-mb
// at E P = 1083)
template <typename Ka, typename Kb>
int smem_pays(Ka a, size_t smem_a, Kb b, size_t smem_b, bool* pays) {
  // one kernel may be both: each query follows its own attribute. The
  // planes may not fit a block's shared memory at all (float64 bd at
  // nband 6 and E P near kMaxP): then they do not pay, and the refused
  // attribute's error is cleared
  int na = 0, nb = 0;
  if (cudaFuncSetAttribute(a, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_a)) != cudaSuccess) {
    cudaGetLastError();
    *pays = false;
    return 0;
  }
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&na, a, kThreads, smem_a);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(b, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_b));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, b, kThreads, smem_b);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *pays = 3 * na >= 2 * nb;
  return 0;
}

// registers a thread, static and dynamic shared memory, blocks an SM and
// local memory a thread (the stack frame, spills included) of a kernel
// at smem bytes of dynamic shared memory a block, into out[5]
template <typename K>
int kernel_attrs(K kernel, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = per_sm;
  out[4] = static_cast<int>(fa.localSizeBytes);
  return 0;
}

}  // namespace
