// Device code shared by the fused posterior and the chunk stepper.
//
// - CUDA twins of the 13 zoo models (lisp_mcmc_torch/models/zoo.py), each
//   split into a per-walker setup (the walker-constant terms, hoisted out
//   of the point loop) and a per-point evaluation.  Keep MODEL_* in step
//   with DEVICE_MODELS there.  Where the float32 result depends on the
//   order of operations (a sine's argument), the twin rounds as the torch
//   model does (mul_rn/add_rn are never contracted into an FMA).
// - A posterior term (Term): its likelihood kind, its twin, the column of
//   each twin parameter (-1: an optional parameter the fit lacks, read as
//   0) and its data columns.  The twin is chosen at run time, once per
//   term and tile, outside the point loop; the point loop itself is
//   templated on twin and kind (term_sum).
// - The data tile: a block stages up to TILE points of each data column in
//   shared memory; every thread of the block then loops over them with its
//   own walker's parameters in registers, so the (walkers x points)
//   intermediate never reaches device memory.
// - The likelihood reductions (normal / normal_cutoff / poisson), the
//   bounds prior with the reference's exact constants, and the declared
//   constraints (priors.declared_constraints: the NV physics prior's).
// - The keyed counter hash of lisp_mcmc_tpu/ops/chunk_pallas.py:51-92.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace lmt {

enum {
  MODEL_LORDER_MIXED_BG = 0, MODEL_LINE = 1, MODEL_EXAMPLE_LINE = 2,
  MODEL_POLYNOMIAL = 3, MODEL_GAUSSIAN_PEAK = 4, MODEL_LORENTZIAN_BG = 5,
  MODEL_DOUBLE_LORENTZIAN_BG = 6, MODEL_EXPONENTIAL_DECAY = 7,
  MODEL_SINUSOID = 8, MODEL_DAMPED_SINUSOID = 9,
  MODEL_STRETCHED_EXPONENTIAL = 10, MODEL_POWER_LAW = 11,
  MODEL_PSEUDO_VOIGT = 12
};
enum { KIND_NORMAL = 0, KIND_NORMAL_CUTOFF = 1, KIND_POISSON = 2 };
// Keep in step with loglik_kernel.CONSTRAINT_IDS.
enum { CONSTRAINT_LE = 0, CONSTRAINT_DIFF_GE = 1, CONSTRAINT_RATIO_IN = 2 };
// Keep in step with loglik_kernel.DENSITY_IDS.
enum { DENSITY_GAUSS = 0, DENSITY_LOGN = 1, DENSITY_QUAD = 2 };

constexpr int TILE = 512;      // data points per shared-memory tile
constexpr int MAX_COLS = 5;    // x, y and up to three per-point constants
constexpr int MAX_NP = 16;     // parameters a twin reads (the polynomial's c0..c15)
constexpr int MAX_TERMS = 8;   // posterior terms of one launch

// Columns each likelihood kind reads: normal (x, y, inv_sigma),
// normal_cutoff (x, y, inv_sigma, c_pt, mask), poisson (x, y, mask).
__host__ __device__ __forceinline__ int kind_cols(int kind) {
  return kind == KIND_NORMAL_CUTOFF ? 5 : 3;
}

__device__ __forceinline__ float d_cos(float v) { return cosf(v); }
__device__ __forceinline__ double d_cos(double v) { return cos(v); }
__device__ __forceinline__ float d_sin(float v) { return sinf(v); }
__device__ __forceinline__ double d_sin(double v) { return sin(v); }
__device__ __forceinline__ float d_log(float v) { return logf(v); }
__device__ __forceinline__ double d_log(double v) { return log(v); }
__device__ __forceinline__ float d_exp(float v) { return expf(v); }
__device__ __forceinline__ double d_exp(double v) { return exp(v); }
// One rounding each, never merged into an FMA: where the torch model
// rounds a product and a sum apart and the result depends on it.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// Each twin: setup(p, np) from the parameters in DEVICE_MODELS order
// (np of them; only the polynomial reads np), eval(x) per point.
template <typename T, int MODEL> struct Model;

// lorder_mixed_bg, factored (zoo.py): params scale, linewidth, x0, mix,
// bg0, bg1.  Per point: one division and two FMAs' worth of arithmetic.
template <typename T> struct Model<T, MODEL_LORDER_MIXED_BG> {
  T x0, lw2, c1, c2, bg0, bg1;
  __device__ __forceinline__ void setup(const T* p, int) {
    const T scale = p[0], lw = p[1], mix = p[3];
    x0 = p[2];
    lw2 = lw * lw;
    c1 = T(-2) * d_cos(mix) * lw2 * scale;
    c2 = d_sin(mix) * lw * scale;
    bg0 = p[4];
    bg1 = p[5];
  }
  __device__ __forceinline__ T eval(T x) const {
    const T u = x - x0;
    const T u2 = u * u;
    const T s = u2 + lw2;
    const T num = c1 * u + c2 * (lw2 - u2);
    return num / (s * s) + bg0 + bg1 * x;
  }
};

// line: params b, m.
template <typename T> struct Model<T, MODEL_LINE> {
  T b, m;
  __device__ __forceinline__ void setup(const T* p, int) { b = p[0]; m = p[1]; }
  __device__ __forceinline__ T eval(T x) const { return b + m * x; }
};

// example_line: b + (-3 m) + (m - b/60) x; params b, m.
template <typename T> struct Model<T, MODEL_EXAMPLE_LINE> {
  T a, s;
  __device__ __forceinline__ void setup(const T* p, int) {
    a = p[0] + T(-3) * p[1];
    s = p[1] - p[0] / T(60);
  }
  __device__ __forceinline__ T eval(T x) const { return a + s * x; }
};

// polynomial: Horner over c0..c{np-1}, from the leading coefficient, each
// product and sum rounded apart as torch does.
template <typename T> struct Model<T, MODEL_POLYNOMIAL> {
  T c[MAX_NP];
  int np;
  __device__ __forceinline__ void setup(const T* p, int n) {
    np = n;
#pragma unroll
    for (int k = 0; k < MAX_NP; ++k) c[k] = p[k];
  }
  __device__ __forceinline__ T eval(T x) const {
    T acc = T(0);
#pragma unroll
    for (int k = MAX_NP - 1; k >= 0; --k) {
      if (k == np - 1) acc = c[k];
      else if (k < np - 1) acc = add_rn(mul_rn(acc, x), c[k]);
    }
    return acc;
  }
};

// gaussian_peak: scale exp(-z^2/2) + bg0 + bg1 x, z = (x - x0) / sigma;
// params scale, x0, sigma, bg0, bg1.
template <typename T> struct Model<T, MODEL_GAUSSIAN_PEAK> {
  T scale, x0, sigma, bg0, bg1;
  __device__ __forceinline__ void setup(const T* p, int) {
    scale = p[0]; x0 = p[1]; sigma = p[2]; bg0 = p[3]; bg1 = p[4];
  }
  __device__ __forceinline__ T eval(T x) const {
    const T z = (x - x0) / sigma;
    return scale * d_exp(T(-0.5) * z * z) + bg0 + bg1 * x;
  }
};

// lorentzian_bg: scale lw lw / (u^2 + lw^2) + bg0 + bg1 x; params scale,
// linewidth, x0, bg0, bg1.
template <typename T> struct Model<T, MODEL_LORENTZIAN_BG> {
  T num, lw2, x0, bg0, bg1;
  __device__ __forceinline__ void setup(const T* p, int) {
    const T lw = p[1];
    num = p[0] * lw * lw;
    lw2 = lw * lw;
    x0 = p[2]; bg0 = p[3]; bg1 = p[4];
  }
  __device__ __forceinline__ T eval(T x) const {
    const T u = x - x0;
    return num / (u * u + lw2) + bg0 + bg1 * x;
  }
};

// double_lorentzian_bg: bg0 - scale1 s2 / (u1^2 + s2) - scale2 s2 / (u2^2 +
// s2); params scale1, scale2, mu1, mu2, sigma, bg0.
template <typename T> struct Model<T, MODEL_DOUBLE_LORENTZIAN_BG> {
  T a1, a2, mu1, mu2, s2, bg0;
  __device__ __forceinline__ void setup(const T* p, int) {
    s2 = p[4] * p[4];
    a1 = p[0] * s2;
    a2 = p[1] * s2;
    mu1 = p[2]; mu2 = p[3]; bg0 = p[5];
  }
  __device__ __forceinline__ T eval(T x) const {
    const T u1 = x - mu1;
    const T u2 = x - mu2;
    return bg0 - a1 / (u1 * u1 + s2) - a2 / (u2 * u2 + s2);
  }
};

// exponential_decay: scale exp(-x / tau) + bg0; params scale, tau, bg0.
template <typename T> struct Model<T, MODEL_EXPONENTIAL_DECAY> {
  T scale, tau, bg0;
  __device__ __forceinline__ void setup(const T* p, int) {
    scale = p[0]; tau = p[1]; bg0 = p[2];
  }
  __device__ __forceinline__ T eval(T x) const { return scale * d_exp(-x / tau) + bg0; }
};

// sinusoid: scale sin(2 pi freq x + phase) + bg0; params scale, freq,
// phase, bg0.  The argument rounds (w x) and (+ phase) apart, as torch.
template <typename T> struct Model<T, MODEL_SINUSOID> {
  T scale, w, phase, bg0;
  __device__ __forceinline__ void setup(const T* p, int) {
    scale = p[0]; w = T(6.283185307179586) * p[1]; phase = p[2]; bg0 = p[3];
  }
  __device__ __forceinline__ T eval(T x) const {
    return scale * d_sin(add_rn(mul_rn(w, x), phase)) + bg0;
  }
};

// damped_sinusoid: scale exp(-x / tau) sin(2 pi freq x + phase) + bg0;
// params scale, tau, freq, phase, bg0.
template <typename T> struct Model<T, MODEL_DAMPED_SINUSOID> {
  T scale, tau, w, phase, bg0;
  __device__ __forceinline__ void setup(const T* p, int) {
    scale = p[0]; tau = p[1]; w = T(6.283185307179586) * p[2]; phase = p[3];
    bg0 = p[4];
  }
  __device__ __forceinline__ T eval(T x) const {
    const T osc = d_sin(add_rn(mul_rn(w, x), phase));
    return scale * d_exp(-x / tau) * osc + bg0;
  }
};

// stretched_exponential: scale exp(-(x/tau)^beta) + bg0 with the x/tau <= 0
// points masked before the log (they give scale + bg0); params scale, tau,
// beta, bg0.
template <typename T> struct Model<T, MODEL_STRETCHED_EXPONENTIAL> {
  T scale, tau, beta, bg0;
  __device__ __forceinline__ void setup(const T* p, int) {
    scale = p[0]; tau = p[1]; beta = p[2]; bg0 = p[3];
  }
  __device__ __forceinline__ T eval(T x) const {
    const T r = x / tau;
    const bool pos = r > T(0);
    const T pw = d_exp(beta * d_log(pos ? r : T(1)));
    return scale * d_exp(-(pos ? pw : T(0))) + bg0;
  }
};

// power_law: scale x^exponent + bg0, x <= 0 masked as above; params scale,
// exponent, bg0.
template <typename T> struct Model<T, MODEL_POWER_LAW> {
  T scale, expo, bg0;
  __device__ __forceinline__ void setup(const T* p, int) {
    scale = p[0]; expo = p[1]; bg0 = p[2];
  }
  __device__ __forceinline__ T eval(T x) const {
    const bool pos = x > T(0);
    const T pw = d_exp(expo * d_log(pos ? x : T(1)));
    return scale * (pos ? pw : T(0)) + bg0;
  }
};

// pseudo_voigt: scale (eta w2/(u2 + w2) + (1 - eta) exp(-ln2 u2 / w2)) +
// bg0 + bg1 x; params scale, x0, w, eta, bg0, bg1.
template <typename T> struct Model<T, MODEL_PSEUDO_VOIGT> {
  T scale, x0, w2, eta, one_m_eta, bg0, bg1;
  __device__ __forceinline__ void setup(const T* p, int) {
    scale = p[0]; x0 = p[1]; w2 = p[2] * p[2]; eta = p[3];
    one_m_eta = T(1) - eta; bg0 = p[4]; bg1 = p[5];
  }
  __device__ __forceinline__ T eval(T x) const {
    const T u = x - x0;
    const T u2 = u * u;
    const T lor = w2 / (u2 + w2);
    const T gau = d_exp(T(-0.6931471805599453) * u2 / w2);
    return scale * (eta * lor + one_m_eta * gau) + bg0 + bg1 * x;
  }
};

// One posterior term: data columns in device memory, n points, the
// likelihood kind, the twin and the column of each of its np parameters.
template <typename T> struct Term {
  const T* col[MAX_COLS];
  int n, model, kind, np;
  int pidx[MAX_NP];
};

template <typename T> struct Terms {
  Term<T> t[MAX_TERMS];
  int count;
};

// Copy points [t0, t0 + cnt) of each of a term's ncol columns to
// dst[c * stride + k].
template <typename T>
__device__ __forceinline__ void stage_cols(T* dst, int stride, const Term<T>& tm,
                                           int ncol, int t0, int cnt) {
  for (int k = threadIdx.x; k < cnt; k += blockDim.x)
    for (int c = 0; c < ncol; ++c) dst[c * stride + k] = tm.col[c][t0 + k];
}

// The likelihood's sum over cnt staged points (column c at
// cols[c * stride]) for one walker: sum z^2 (normal; finish_likelihood
// applies -1/2), sum max(-5000, c_pt - z^2/2) * mask (cutoff), or sum
// (y log mu - mu) * mask (poisson).
template <typename T, int MODEL, int KIND>
__device__ __forceinline__ T tile_sum(const Model<T, MODEL>& m, const T* cols,
                                      int stride, int cnt) {
  T acc = T(0);
  for (int k = 0; k < cnt; ++k) {
    const T x = cols[k];
    const T y = cols[stride + k];
    const T mu = m.eval(x);
    if (KIND == KIND_NORMAL) {
      const T z = (y - mu) * cols[2 * stride + k];
      acc += z * z;
    } else if (KIND == KIND_NORMAL_CUTOFF) {
      const T z = (y - mu) * cols[2 * stride + k];
      const T lp = cols[3 * stride + k] - T(0.5) * z * z;
      // max(-5000, lp) that keeps a NaN, as torch.clamp_min does.
      acc += (lp < T(-5000) ? T(-5000) : lp) * cols[4 * stride + k];
    } else {
      acc += (y * d_log(mu) - mu) * cols[2 * stride + k];
    }
  }
  return acc;
}

template <typename T, int MODEL, int KIND>
__device__ __forceinline__ T model_sum(const T* p, int np, const T* cols,
                                       int stride, int cnt) {
  Model<T, MODEL> m;
  m.setup(p, np);
  return tile_sum<T, MODEL, KIND>(m, cols, stride, cnt);
}

// The twin chosen at run time (uniform across the block), then the
// templated point loop.
template <typename T, int KIND>
__device__ __forceinline__ T kind_sum(int model, const T* p, int np, const T* cols,
                                   int stride, int cnt) {
  switch (model) {
#define LMT_CASE(M) case M: return model_sum<T, M, KIND>(p, np, cols, stride, cnt);
    LMT_CASE(MODEL_LORDER_MIXED_BG)
    LMT_CASE(MODEL_LINE)
    LMT_CASE(MODEL_EXAMPLE_LINE)
    LMT_CASE(MODEL_POLYNOMIAL)
    LMT_CASE(MODEL_GAUSSIAN_PEAK)
    LMT_CASE(MODEL_LORENTZIAN_BG)
    LMT_CASE(MODEL_DOUBLE_LORENTZIAN_BG)
    LMT_CASE(MODEL_EXPONENTIAL_DECAY)
    LMT_CASE(MODEL_SINUSOID)
    LMT_CASE(MODEL_DAMPED_SINUSOID)
    LMT_CASE(MODEL_STRETCHED_EXPONENTIAL)
    LMT_CASE(MODEL_POWER_LAW)
    LMT_CASE(MODEL_PSEUDO_VOIGT)
#undef LMT_CASE
  }
  return static_cast<T>(CUDART_NAN);  // an unknown id: the wrapper never passes one
}

// One term's (unfinished) likelihood sum over cnt points.
template <typename T>
__device__ __forceinline__ T term_sum(int kind, int model, const T* p, int np,
                                      const T* cols, int stride, int cnt) {
  if (kind == KIND_NORMAL) return kind_sum<T, KIND_NORMAL>(model, p, np, cols, stride, cnt);
  if (kind == KIND_NORMAL_CUTOFF)
    return kind_sum<T, KIND_NORMAL_CUTOFF>(model, p, np, cols, stride, cnt);
  return kind_sum<T, KIND_POISSON>(model, p, np, cols, stride, cnt);
}

template <typename T>
__device__ __forceinline__ T finish_likelihood(int kind, T acc) {
  return kind == KIND_NORMAL ? T(-0.5) * acc : acc;
}

// bound_penalty (priors.py, mcmc-fitting.lisp:358-360): 0 inside the open
// interval, -1e10 (exp(1e-5 dist) - 1) outside.
template <typename T>
__device__ __forceinline__ T bound_penalty(T v, T lo, T hi) {
  const T dist = fmin(fabs(v - hi), fabs(v - lo));
  const T outside = T(-1e10) * (d_exp(T(1e-5) * dist) - T(1));
  return (lo < v && v < hi) ? T(0) : outside;
}
__device__ __forceinline__ float bound_penalty(float v, float lo, float hi) {
  const float dist = fminf(fabsf(v - hi), fabsf(v - lo));
  const float outside = -1e10f * (expf(1e-5f * dist) - 1.0f);
  return (lo < v && v < hi) ? 0.0f : outside;
}

// The bounds prior: n entries, entry e bounds column col[e] to
// (lo[e], hi[e]); a column bounded by several terms has several entries.
template <typename T> struct Bounds {
  const int* col;
  const T* lo;
  const T* hi;
  int n;
};

// The declared constraints: n entries, entry e is (kind, column a, column
// b) at idx[3e..3e+2] and (lo, hi) at val[2e..2e+1], the constants in the
// fit's type (torch compares a column with a Python float in the column's
// type).
template <typename T> struct Constraints {
  const int* idx;
  const T* val;
  int n;
};

// The sum of the failed entries' -1e9 penalties, in order
// (priors.constraint_total): le p[a] <= p[b]; diff_ge p[b] - p[a] >= lo;
// ratio_in lo < p[a] / p[b] < hi, an IEEE division, so a NaN ratio
// (0 / 0) fails both comparisons as torch's does.  p(col) reads the
// walker's value of a column; idx and val may be in shared memory.
template <typename T, typename P>
__device__ __forceinline__ T constraint_total(int n, const int* idx, const T* val, P p) {
  T total = T(0);
  for (int e = 0; e < n; ++e) {
    const int kind = idx[3 * e];
    const T pa = p(idx[3 * e + 1]);
    const T pb = p(idx[3 * e + 2]);
    bool ok;
    if (kind == CONSTRAINT_LE) {
      ok = pa <= pb;
    } else if (kind == CONSTRAINT_DIFF_GE) {
      ok = sub_rn(pb, pa) >= val[2 * e];
    } else {
      const T ratio = div_rn(pa, pb);
      ok = val[2 * e] < ratio && ratio < val[2 * e + 1];
    }
    total = add_rn(total, ok ? T(0) : T(-1e9));
  }
  return total;
}

// The declared densities of a named prior (loglik_kernel.declared_densities):
// n entries, read in order.  Entry e's ints are (kind, k, k columns) and
// its values, for a Gaussian or a LogNormal (k = 1), (mu, 1/sigma, c); for
// a k-parameter quadratic form (mean[k], the k(k+1)/2 entries of M =
// chol^-1 row by row, log_norm).  Both arrays may be in shared memory.
template <typename T> struct Densities {
  const int* idx;
  const T* val;
  int n;
};

template <typename T> __device__ __forceinline__ T smallest_normal();
template <> __device__ __forceinline__ float smallest_normal<float>() { return 1.17549435e-38f; }
template <> __device__ __forceinline__ double smallest_normal<double>() {
  return 2.2250738585072014e-308;
}

// The sum of the entries' log densities, in order, every operation rounded
// apart (mul_rn/add_rn/sub_rn: no FMA), as loglik_kernel.densities_plain
// does: a Gaussian -0.5 z z + c with z = (x - mu) (1/sigma); a LogNormal
// the same of lx = log(max(x, smallest normal)), minus lx (a NaN x stays
// NaN); a quadratic form -0.5 |M (x - mean)|^2 + log_norm, row r of M
// (x - mean) summed over c = 0..r.  p(col) reads the walker's value of a
// column.
template <typename T, typename P>
__device__ __forceinline__ T density_total(int n, const int* idx, const T* val, P p) {
  T total = T(0);
  for (int e = 0, i = 0, v = 0; e < n; ++e) {
    const int kind = idx[i];
    const int k = idx[i + 1];
    const int* col = idx + i + 2;
    T term;
    if (kind == DENSITY_QUAD) {
      const T* mean = val + v;
      const T* m = mean + k;
      T q = T(0);
      for (int r = 0, o = 0; r < k; ++r) {
        T z = T(0);
        for (int c = 0; c <= r; ++c, ++o) z = add_rn(z, mul_rn(m[o], sub_rn(p(col[c]), mean[c])));
        q = add_rn(q, mul_rn(z, z));
      }
      term = add_rn(mul_rn(T(-0.5), q), m[k * (k + 1) / 2]);
      v += k + k * (k + 1) / 2 + 1;
    } else {
      T x = p(col[0]);
      T lx = T(0);
      if (kind == DENSITY_LOGN) {
        const T tiny = smallest_normal<T>();
        lx = d_log(x < tiny ? tiny : x);
        x = lx;
      }
      const T z = mul_rn(sub_rn(x, val[v]), val[v + 1]);
      T t = mul_rn(mul_rn(T(-0.5), z), z);
      if (kind == DENSITY_LOGN) t = sub_rn(t, lx);
      term = add_rn(t, val[v + 2]);
      v += 3;
    }
    total = add_rn(total, term);
    i += 2 + k;
  }
  return total;
}

// ---- keyed counter hash (chunk_pallas.py:_hash_bits, _uniform_from_bits)
__device__ __forceinline__ uint32_t fin(uint32_t x, uint32_t m1, uint32_t m2) {
  x ^= x >> 16;
  x *= m1;
  x ^= x >> 13;
  x *= m2;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t hash_bits(uint32_t idx, uint32_t key1,
                                              uint32_t key2) {
  return fin(fin(idx ^ key1, 0x7FEB352Du, 0x846CA68Bu) ^ key2, 0x85EBCA6Bu,
             0xC2B2AE35u);
}

// 23 mantissa bits into [1, 2), minus 1, kept off 0 so log(u) is finite.
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return fmaxf(f, 1.1754944e-38f);
}

// Host side: a Terms<T> from the wrapper's flat arrays.  meta holds, per
// term, (model, kind, n, np, pidx[MAX_NP]); cols MAX_COLS pointers per
// term (unused ones null).
constexpr int META_STRIDE = 4 + MAX_NP;

template <typename T>
Terms<T> make_terms(int count, const int* meta, const void* const* cols) {
  Terms<T> ts;
  ts.count = count;
  for (int i = 0; i < count && i < MAX_TERMS; ++i) {
    const int* m = meta + i * META_STRIDE;
    Term<T>& t = ts.t[i];
    t.model = m[0]; t.kind = m[1]; t.n = m[2]; t.np = m[3];
    for (int k = 0; k < MAX_NP; ++k) t.pidx[k] = m[4 + k];
    for (int c = 0; c < MAX_COLS; ++c)
      t.col[c] = static_cast<const T*>(cols[i * MAX_COLS + c]);
  }
  return ts;
}

}  // namespace lmt

extern "C" const char* lmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
