// Fused log-posterior: positions (W, d) -> (W,), one thread per walker.
//
// Replaces the TPU kernel lisp_mcmc_tpu/ops/loglik_pallas.py
// (build_fused_posterior): model at every data point, residual times
// inv_sigma, the likelihood's masked reduction and the bounds prior, all
// in registers.  The walker-independent constant (log-normalisation, or
// -sum lgamma(y+1)) is added by the Python wrapper, as in the JAX package,
// so the f32 sum does not lose the digits that decide an MH step.
//
// What bounds it on an H100: arithmetic.  Per walker-point the
// lorder_mixed_bg term costs ~10 FP operations plus one IEEE division
// (a reciprocal and Newton steps, not --use_fast_math); the only device
// memory traffic is W*d values in and W out (~3.7 MB at the flagship's
// W = 131072, d = 6), while W*N = 44M walker-points of arithmetic are done.
// The design keeps it that way: the data columns of one tile (up to 512
// points) sit in shared memory and are read by every thread of the block
// as broadcasts, each thread holds its walker's hoisted model constants in
// registers and accumulates its sum in a register, so nothing of size
// W x N is ever written.
#include "models.cuh"

namespace lmt {

template <typename T, int MODEL, int KIND>
__global__ void __launch_bounds__(256)
fused_posterior_kernel(const T* __restrict__ pos, int W, int d,
                       const int* __restrict__ pidx, Data<T> data,
                       Bounds<T> bounds, T* __restrict__ out) {
  __shared__ T tile[Cols<KIND>::n][TILE];
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = w < W;
  const T* row = pos + static_cast<size_t>(live ? w : 0) * d;

  Model<T, MODEL> m;
  T mp[Model<T, MODEL>::NP];
#pragma unroll
  for (int k = 0; k < Model<T, MODEL>::NP; ++k) mp[k] = row[pidx[k]];
  m.setup(mp);

  T acc = T(0);
  for (int t0 = 0; t0 < data.n; t0 += TILE) {
    const int cnt = min(TILE, data.n - t0);
    __syncthreads();
    stage_tile<T, Cols<KIND>::n>(tile, data, t0, cnt);
    __syncthreads();
    acc += tile_sum<T, MODEL, KIND>(m, tile, cnt);
  }
  if (!live) return;

  T total = finish_likelihood<KIND>(acc);
  T prior = T(0);
  for (int r = 0; r < d; ++r)
    if (bounds.flag[r]) prior += bound_penalty(row[r], bounds.lo[r], bounds.hi[r]);
  out[w] = total + prior;
}

template <typename T, int MODEL, int KIND>
cudaError_t launch(const T* pos, int W, int d, const int* pidx, Data<T> data,
                   Bounds<T> bounds, T* out, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (W + threads - 1) / threads;
  fused_posterior_kernel<T, MODEL, KIND>
      <<<blocks, threads, 0, stream>>>(pos, W, d, pidx, data, bounds, out);
  return cudaGetLastError();
}

template <typename T, int MODEL>
cudaError_t dispatch_kind(int kind, const T* pos, int W, int d, const int* pidx,
                          Data<T> data, Bounds<T> bounds, T* out,
                          cudaStream_t s) {
  switch (kind) {
    case KIND_NORMAL:
      return launch<T, MODEL, KIND_NORMAL>(pos, W, d, pidx, data, bounds, out, s);
    case KIND_NORMAL_CUTOFF:
      return launch<T, MODEL, KIND_NORMAL_CUTOFF>(pos, W, d, pidx, data, bounds, out, s);
    case KIND_POISSON:
      return launch<T, MODEL, KIND_POISSON>(pos, W, d, pidx, data, bounds, out, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(int model, int kind, const void* pos, int W, int d,
                     const int* pidx, const void* const* cols, int n,
                     const int* bflag, const void* blo, const void* bhi,
                     void* out, cudaStream_t s) {
  Data<T> data;
  for (int c = 0; c < MAX_COLS; ++c) data.col[c] = static_cast<const T*>(cols[c]);
  data.n = n;
  Bounds<T> bounds{bflag, static_cast<const T*>(blo), static_cast<const T*>(bhi)};
  const T* p = static_cast<const T*>(pos);
  T* o = static_cast<T*>(out);
  switch (model) {
    case MODEL_LORDER_MIXED_BG:
      return dispatch_kind<T, MODEL_LORDER_MIXED_BG>(kind, p, W, d, pidx, data, bounds, o, s);
    case MODEL_LINE:
      return dispatch_kind<T, MODEL_LINE>(kind, p, W, d, pidx, data, bounds, o, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace lmt

// dtype: 0 = float32, 1 = float64.  cols: five column pointers (unused
// ones may be null).  Returns the cudaError_t of the launch.
extern "C" int lmt_fused_posterior(int dtype, int model, int kind,
                                   const void* pos, int W, int d,
                                   const int* pidx, const void* c0,
                                   const void* c1, const void* c2,
                                   const void* c3, const void* c4, int n,
                                   const int* bflag, const void* blo,
                                   const void* bhi, void* out, void* stream) {
  const void* cols[lmt::MAX_COLS] = {c0, c1, c2, c3, c4};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lmt::dispatch<float>(model, kind, pos, W, d, pidx, cols, n, bflag,
                                blo, bhi, out, s);
  if (dtype == 1)
    return lmt::dispatch<double>(model, kind, pos, W, d, pidx, cols, n, bflag,
                                 blo, bhi, out, s);
  return cudaErrorInvalidValue;
}
