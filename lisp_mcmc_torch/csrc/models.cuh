// Device code shared by the fused posterior and the chunk stepper.
//
// - CUDA twins of the zoo models (lisp_mcmc_torch/models/zoo.py), split
//   into a per-walker setup (the walker-constant terms, hoisted out of the
//   point loop) and a per-point evaluation.  Keep MODEL_* in step with
//   DEVICE_MODELS there.
// - The data tile: a block stages up to TILE points of each data column in
//   shared memory; every thread of the block then loops over them with its
//   own walker's parameters in registers, so the (walkers x points)
//   intermediate never reaches device memory.
// - The likelihood reductions (normal / normal_cutoff / poisson) and the
//   bounds prior with the reference's exact constants.
// - The keyed counter hash of lisp_mcmc_tpu/ops/chunk_pallas.py:51-92.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lmt {

enum { MODEL_LORDER_MIXED_BG = 0, MODEL_LINE = 1 };
enum { KIND_NORMAL = 0, KIND_NORMAL_CUTOFF = 1, KIND_POISSON = 2 };

constexpr int TILE = 512;      // data points per shared-memory tile
constexpr int MAX_COLS = 5;    // x, y and up to three per-point constants

// Columns each likelihood kind reads: normal (x, y, inv_sigma),
// normal_cutoff (x, y, inv_sigma, c_pt, mask), poisson (x, y, mask).
template <int KIND> struct Cols { static constexpr int n = 3; };
template <> struct Cols<KIND_NORMAL_CUTOFF> { static constexpr int n = 5; };

__device__ __forceinline__ float d_cos(float v) { return cosf(v); }
__device__ __forceinline__ double d_cos(double v) { return cos(v); }
__device__ __forceinline__ float d_sin(float v) { return sinf(v); }
__device__ __forceinline__ double d_sin(double v) { return sin(v); }
__device__ __forceinline__ float d_log(float v) { return logf(v); }
__device__ __forceinline__ double d_log(double v) { return log(v); }
__device__ __forceinline__ float d_exp(float v) { return expf(v); }
__device__ __forceinline__ double d_exp(double v) { return exp(v); }

template <typename T, int MODEL> struct Model;

// lorder_mixed_bg, factored (zoo.py): params scale, linewidth, x0, mix,
// bg0, bg1.  Per point: one division and two FMAs' worth of arithmetic.
template <typename T> struct Model<T, MODEL_LORDER_MIXED_BG> {
  static constexpr int NP = 6;
  T x0, lw2, c1, c2, bg0, bg1;
  __device__ __forceinline__ void setup(const T* p) {
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
  static constexpr int NP = 2;
  T b, m;
  __device__ __forceinline__ void setup(const T* p) { b = p[0]; m = p[1]; }
  __device__ __forceinline__ T eval(T x) const { return b + m * x; }
};

// Data columns of one term in device memory.
template <typename T> struct Data {
  const T* col[MAX_COLS];
  int n;
};

// Copy points [t0, t0 + cnt) of each column into the block's tile.
template <typename T, int NCOL>
__device__ __forceinline__ void stage_tile(T (*tile)[TILE], const Data<T>& d,
                                           int t0, int cnt) {
  for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
#pragma unroll
    for (int c = 0; c < NCOL; ++c) tile[c][k] = d.col[c][t0 + k];
  }
}

// The likelihood's sum over the cnt staged points for one walker:
// sum z^2 (normal; the caller applies -1/2), sum max(-5000, c_pt - z^2/2)
// * mask (cutoff), or sum (y log mu - mu) * mask (poisson).
template <typename T, int MODEL, int KIND>
__device__ __forceinline__ T tile_sum(const Model<T, MODEL>& m,
                                      T (*tile)[TILE], int cnt) {
  T acc = T(0);
  for (int k = 0; k < cnt; ++k) {
    const T x = tile[0][k];
    const T y = tile[1][k];
    const T mu = m.eval(x);
    if (KIND == KIND_NORMAL) {
      const T z = (y - mu) * tile[2][k];
      acc += z * z;
    } else if (KIND == KIND_NORMAL_CUTOFF) {
      const T z = (y - mu) * tile[2][k];
      const T lp = tile[3][k] - T(0.5) * z * z;
      // max(-5000, lp) that keeps a NaN, as jnp.maximum does.
      acc += (lp < T(-5000) ? T(-5000) : lp) * tile[4][k];
    } else {
      acc += (y * d_log(mu) - mu) * tile[2][k];
    }
  }
  return acc;
}

template <int KIND, typename T>
__device__ __forceinline__ T finish_likelihood(T acc) {
  return KIND == KIND_NORMAL ? T(-0.5) * acc : acc;
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

// Bounds prior: flag[r] != 0 marks a bounded parameter r.
template <typename T> struct Bounds {
  const int* flag;
  const T* lo;
  const T* hi;
};

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

}  // namespace lmt

extern "C" const char* lmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
