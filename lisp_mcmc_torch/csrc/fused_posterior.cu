// Fused log-posterior: positions (W, d) -> (W,), one thread per walker.
//
// Replaces the TPU kernel lisp_mcmc_tpu/ops/loglik_pallas.py
// (build_fused_posterior).  For each posterior term in turn, as the Pallas
// kernel loops over its term_meta: the term's twin at every data point,
// residual times inv_sigma and the likelihood's masked reduction; then the
// bounds prior and the declared constraints of every term.  The
// walker-independent constant (log-normalisation, or -sum lgamma(y+1)) and
// whatever part of a prior is neither a bounds table nor declared
// constraints are added by the Python wrapper, as in the JAX package, so
// the f32 sum does not lose the digits that decide an MH step.
//
// What bounds it on an H100: arithmetic.  Per walker-point the flagship's
// lorder_mixed_bg term costs ~10 FP operations plus one IEEE division
// (a reciprocal and Newton steps, not --use_fast_math); the only device
// memory traffic is W*d values in and W out (~3.7 MB at the flagship's
// W = 131072, d = 6), while W*N = 44M walker-points of arithmetic are done.
// The design keeps it that way: the data columns of one tile (up to 512
// points) sit in shared memory and are read by every thread of the block
// as broadcasts, each thread holds its walker's hoisted model constants in
// registers and accumulates its sum in a register, so nothing of size
// W x N is ever written.  The twin is picked at run time once per term and
// tile (models.cuh: term_sum), outside the point loop.
#include "models.cuh"

namespace lmt {

template <typename T>
__global__ void __launch_bounds__(256)
fused_posterior_kernel(const T* __restrict__ pos, int W, int d, const Terms<T> terms,
                       const Bounds<T> bounds, const Constraints<T> cons,
                       T* __restrict__ out) {
  __shared__ T tile[MAX_COLS * TILE];
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = w < W;
  const T* row = pos + static_cast<size_t>(live ? w : 0) * d;

  T total = T(0);
  for (int i = 0; i < terms.count; ++i) {
    const Term<T>& tm = terms.t[i];
    T mp[MAX_NP];
#pragma unroll
    for (int k = 0; k < MAX_NP; ++k) {
      const int c = tm.pidx[k];
      mp[k] = (k < tm.np && c >= 0) ? row[c] : T(0);
    }
    const int ncol = kind_cols(tm.kind);
    T acc = T(0);
    for (int t0 = 0; t0 < tm.n; t0 += TILE) {
      const int cnt = min(TILE, tm.n - t0);
      __syncthreads();
      stage_cols(tile, TILE, tm, ncol, t0, cnt);
      __syncthreads();
      acc += term_sum(tm.kind, tm.model, mp, tm.np, tile, TILE, cnt);
    }
    total += finish_likelihood(tm.kind, acc);
  }
  if (!live) return;

  T prior = T(0);
  for (int e = 0; e < bounds.n; ++e)
    prior += bound_penalty(row[bounds.col[e]], bounds.lo[e], bounds.hi[e]);
  if (cons.n > 0)
    prior += constraint_total(cons.n, cons.idx, cons.val, [&](int c) { return row[c]; });
  out[w] = total + prior;
}

template <typename T>
cudaError_t launch(const void* pos, int W, int d, int n_terms, const int* meta,
                   const void* const* cols, const int* bcol, const void* blo,
                   const void* bhi, int nb, const int* cidx, const void* cval, int nc,
                   void* out, cudaStream_t s) {
  if (n_terms < 1 || n_terms > MAX_TERMS) return cudaErrorInvalidValue;
  const Terms<T> terms = make_terms<T>(n_terms, meta, cols);
  const Bounds<T> bounds{bcol, static_cast<const T*>(blo), static_cast<const T*>(bhi), nb};
  const Constraints<T> cons{cidx, static_cast<const T*>(cval), nc};
  const int threads = 256;
  const int blocks = (W + threads - 1) / threads;
  fused_posterior_kernel<T><<<blocks, threads, 0, s>>>(
      static_cast<const T*>(pos), W, d, terms, bounds, cons, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace lmt

// dtype: 0 = float32, 1 = float64.  meta and cols are host arrays of
// n_terms terms (models.cuh: make_terms); bcol, blo, bhi the nb bounds
// entries and cidx, cval the nc declared constraints (models.cuh:
// Constraints), all on the device.  Returns the cudaError_t of the launch.
extern "C" int lmt_fused_posterior(int dtype, const void* pos, int W, int d,
                                   int n_terms, const int* meta,
                                   const void* const* cols, const int* bcol,
                                   const void* blo, const void* bhi, int nb,
                                   const int* cidx, const void* cval, int nc,
                                   void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lmt::launch<float>(pos, W, d, n_terms, meta, cols, bcol, blo, bhi, nb,
                              cidx, cval, nc, out, s);
  if (dtype == 1)
    return lmt::launch<double>(pos, W, d, n_terms, meta, cols, bcol, blo, bhi, nb,
                               cidx, cval, nc, out, s);
  return cudaErrorInvalidValue;
}
