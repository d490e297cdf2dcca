// Whole-chunk random-walk Metropolis: `chunk` MH steps in one launch.
//
// Replaces the TPU kernel lisp_mcmc_tpu/ops/chunk_pallas.py
// (build_chunk_pallas).  One thread per walker loops over the steps; per
// step it takes the temperature (cosine anneal or override), draws z by
// Box-Muller on the keyed counter hash, proposes x + L z with the lower-
// triangular L, evaluates the fused posterior (models.cuh) with a finite
// floor, accepts by MH (or greedily), tracks its best point and adds the
// accepted move to its moment sums.  The walker's position, best point,
// L and the moment sums stay in registers for the whole chunk.
//
// Random stream: bit for bit the JAX kernel's.  Walker w sits in a
// *logical* block of wb walkers (wb = pick_block(W, 1024), independent of
// the CUDA block size): pid = w / wb, c = w % wb.  Parameter r's draws
// hash index r*wb + c; the accept draw hashes c; keys are
// seed*0x9E3779B9 + pid*0x85EBCA6B and step*0xB5297A4D (+ 0x68E31DA4 for
// u2, + 2*0x68E31DA4 for the accept uniform), all uint32 with wraparound.
// logf/cosf/sqrtf are the accurate library functions (no fast math), so
// the normals differ from the TPU's by rounding only.
//
// What bounds it on an H100: arithmetic, as in fused_posterior.cu, times
// `chunk` steps: device memory is touched once per chunk (state in and
// out, ~11 MB at W = 131072, d = 6), against 200 x W x N walker-points.
// The per-step trace (max, sum and min of the walkers' logprob) is reduced
// per CUDA block with warp shuffles and written as (blocks, chunk, 3)
// partials; the moment sums as (blocks, d) and (blocks, d, d) partials.
// The wrapper reduces the partials with torch: no atomics, so a chunk is
// deterministic.
#include <math_constants.h>

#include "models.cuh"

namespace lmt {

constexpr int CHUNK_THREADS = 128;
constexpr int CHUNK_WARPS = CHUNK_THREADS / 32;
constexpr int MAX_D = 8;

struct ChunkArgs {
  const float* pos;      // (W, D) in
  const float* lp;       // (W,)  logprob minus the scalar constant
  const float* best;     // (W, D)
  const float* best_lp;  // (W,)
  const float* L;        // (D, D) lower triangular
  const int* seed;       // (1,) on the device
  const int* pidx;       // (NP,) column of each model parameter
  Data<float> data;
  Bounds<float> bounds;
  float* pos_out;
  float* lp_out;
  float* best_out;
  float* best_lp_out;
  float* acc_out;        // (W,)
  float* msum_part;      // (blocks, D)
  float* mouter_part;    // (blocks, D, D)
  float* trace_part;     // (blocks, chunk, 3): max, sum, min
  int W;
  int wb;                // logical RNG block
  int chunk;
  int anneal_step;
  float temp_override;   // > 0 pins the temperature
  float ts;              // annealing constants (kernel.py:temperature_schedule)
  float phase_rate;
  float temp_amp;
  float neg_floor;       // finfo(float32).min / 4
  int greedy;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Register-resident select of v[idx] for a runtime idx (no local memory).
template <int D>
__device__ __forceinline__ float pick(const float (&v)[D], int idx) {
  float out = 0.0f;
#pragma unroll
  for (int r = 0; r < D; ++r) out = (r == idx) ? v[r] : out;
  return out;
}

template <int D, int MODEL, int KIND>
__global__ void __launch_bounds__(CHUNK_THREADS)
chunk_rwm_kernel(const ChunkArgs a) {
  constexpr int NP = Model<float, MODEL>::NP;
  constexpr int NCOL = Cols<KIND>::n;
  constexpr int NL = D * (D + 1) / 2;
  __shared__ float tile[NCOL][TILE];
  __shared__ float red[3][CHUNK_WARPS];
  __shared__ float red_m[CHUNK_WARPS][D + NL];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int w = blockIdx.x * CHUNK_THREADS + tid;
  const bool live = w < a.W;
  const int wr = live ? w : 0;  // dead tail threads shadow walker 0

  float pos[D], best[D], lo[D], hi[D], Lr[NL], msum[D], mouter[NL];
  bool bounded[D];
  int pidx[NP];
#pragma unroll
  for (int r = 0; r < D; ++r) {
    pos[r] = a.pos[static_cast<size_t>(wr) * D + r];
    best[r] = a.best[static_cast<size_t>(wr) * D + r];
    bounded[r] = a.bounds.flag[r] != 0;
    lo[r] = a.bounds.lo[r];
    hi[r] = a.bounds.hi[r];
    msum[r] = 0.0f;
#pragma unroll
    for (int c = 0; c <= r; ++c) {
      Lr[r * (r + 1) / 2 + c] = a.L[r * D + c];
      mouter[r * (r + 1) / 2 + c] = 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < NP; ++k) pidx[k] = a.pidx[k];
  float lp = a.lp[wr];
  float best_lp = a.best_lp[wr];
  float acc = 0.0f;

  const uint32_t c_idx = static_cast<uint32_t>(wr % a.wb);
  const uint32_t pid = static_cast<uint32_t>(wr / a.wb);
  const uint32_t key_sp =
      static_cast<uint32_t>(a.seed[0]) * 0x9E3779B9u + pid * 0x85EBCA6Bu;
  const uint32_t wbu = static_cast<uint32_t>(a.wb);
  const bool one_tile = a.data.n <= TILE;
  if (one_tile) {
    stage_tile<float, NCOL>(tile, a.data, 0, a.data.n);
    __syncthreads();
  }

  for (int i = 0; i < a.chunk; ++i) {
    // temperature: cosine anneal (kernel.py:temperature_schedule) or override
    const float step_i = static_cast<float>(a.anneal_step + i);
    float sched = fmaxf(1.0f, cosf(step_i * a.phase_rate) * a.temp_amp);
    sched = step_i < a.ts ? sched : 1.0f;
    const float temp = a.temp_override > 0.0f ? a.temp_override : sched;

    // proposal: z by Box-Muller on the keyed hash, step = L z
    const uint32_t key_step = static_cast<uint32_t>(i) * 0xB5297A4Du;
    float z[D], step[D], prop[D];
#pragma unroll
    for (int r = 0; r < D; ++r) {
      const uint32_t idx = static_cast<uint32_t>(r) * wbu + c_idx;
      const float u1 = uniform_from_bits(hash_bits(idx, key_sp, key_step));
      const float u2 =
          uniform_from_bits(hash_bits(idx, key_sp, key_step + 0x68E31DA4u));
      z[r] = sqrtf(-2.0f * logf(u1)) * cosf(6.2831855f * u2);
    }
#pragma unroll
    for (int r = 0; r < D; ++r) {
      float s = Lr[r * (r + 1) / 2] * z[0];
#pragma unroll
      for (int c = 1; c <= r; ++c) s = s + Lr[r * (r + 1) / 2 + c] * z[c];
      step[r] = s;
      prop[r] = pos[r] + s;
    }

    // posterior at the proposal
    float mp[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) mp[k] = pick<D>(prop, pidx[k]);
    Model<float, MODEL> m;
    m.setup(mp);
    float sum = 0.0f;
    if (one_tile) {
      sum = tile_sum<float, MODEL, KIND>(m, tile, a.data.n);
    } else {
      for (int t0 = 0; t0 < a.data.n; t0 += TILE) {
        const int cnt = min(TILE, a.data.n - t0);
        __syncthreads();
        stage_tile<float, NCOL>(tile, a.data, t0, cnt);
        __syncthreads();
        sum += tile_sum<float, MODEL, KIND>(m, tile, cnt);
      }
    }
    float lp_prop = finish_likelihood<KIND>(sum);
    float prior = 0.0f;
#pragma unroll
    for (int r = 0; r < D; ++r)
      if (bounded[r]) prior += bound_penalty(prop[r], lo[r], hi[r]);
    lp_prop = lp_prop + prior;
    if (!isfinite(lp_prop)) lp_prop = a.neg_floor;

    // MH accept (mcmc-fitting.lisp:1091-1092) or greedy (1117-1119)
    const float log_u = logf(uniform_from_bits(
        hash_bits(c_idx, key_sp, key_step + 2u * 0x68E31DA4u)));
    const bool accept = a.greedy ? (lp_prop > lp)
                                 : ((lp_prop > lp) || ((lp_prop - lp) / temp > log_u));
    const float accf = accept ? 1.0f : 0.0f;
    if (accept) {
#pragma unroll
      for (int r = 0; r < D; ++r) pos[r] = prop[r];
      lp = lp_prop;
    }
    // accepted-move moments (zero for a rejected step)
#pragma unroll
    for (int r = 0; r < D; ++r) {
      const float dr = step[r] * accf;
      msum[r] += dr;
#pragma unroll
      for (int c = 0; c <= r; ++c) mouter[r * (r + 1) / 2 + c] += dr * (step[c] * accf);
    }
    acc += accf;
    // best tracking (mcmc-fitting.lisp:553-555)
    if (lp > best_lp) {
#pragma unroll
      for (int r = 0; r < D; ++r) best[r] = pos[r];
      best_lp = lp;
    }

    // per-step trace partials: max, sum, min of this block's logprob
    float vmax = warp_max(live ? lp : -CUDART_INF_F);
    float vsum = warp_sum(live ? lp : 0.0f);
    float vmin = warp_min(live ? lp : CUDART_INF_F);
    if (lane == 0) {
      red[0][warp] = vmax;
      red[1][warp] = vsum;
      red[2][warp] = vmin;
    }
    __syncthreads();
    if (tid == 0) {
      for (int k = 1; k < CHUNK_WARPS; ++k) {
        vmax = fmaxf(vmax, red[0][k]);
        vsum += red[1][k];
        vmin = fminf(vmin, red[2][k]);
      }
      float* t = a.trace_part + (static_cast<size_t>(blockIdx.x) * a.chunk + i) * 3;
      t[0] = vmax;
      t[1] = vsum;
      t[2] = vmin;
    }
    __syncthreads();
  }

  if (live) {
#pragma unroll
    for (int r = 0; r < D; ++r) {
      a.pos_out[static_cast<size_t>(w) * D + r] = pos[r];
      a.best_out[static_cast<size_t>(w) * D + r] = best[r];
    }
    a.lp_out[w] = lp;
    a.best_lp_out[w] = best_lp;
    a.acc_out[w] = acc;
  }

  // per-block moment partials; the dead tail adds nothing
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float v = warp_sum(live ? msum[k] : 0.0f);
    if (lane == 0) red_m[warp][k] = v;
  }
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const float v = warp_sum(live ? mouter[k] : 0.0f);
    if (lane == 0) red_m[warp][D + k] = v;
  }
  __syncthreads();
  if (tid < D + NL) {
    float v = red_m[0][tid];
    for (int k = 1; k < CHUNK_WARPS; ++k) v += red_m[k][tid];
    if (tid < D) {
      a.msum_part[static_cast<size_t>(blockIdx.x) * D + tid] = v;
    } else {
      // lower-triangle entry (r, c) -> both (r, c) and (c, r)
      int k = tid - D, r = 0;
      while ((r + 1) * (r + 2) / 2 <= k) ++r;
      const int c = k - r * (r + 1) / 2;
      float* mo = a.mouter_part + static_cast<size_t>(blockIdx.x) * D * D;
      mo[r * D + c] = v;
      mo[c * D + r] = v;
    }
  }
}

template <int D, int MODEL>
cudaError_t dispatch_kind(int kind, const ChunkArgs& a, int blocks, cudaStream_t s) {
  switch (kind) {
    case KIND_NORMAL:
      chunk_rwm_kernel<D, MODEL, KIND_NORMAL><<<blocks, CHUNK_THREADS, 0, s>>>(a);
      break;
    case KIND_NORMAL_CUTOFF:
      chunk_rwm_kernel<D, MODEL, KIND_NORMAL_CUTOFF><<<blocks, CHUNK_THREADS, 0, s>>>(a);
      break;
    case KIND_POISSON:
      chunk_rwm_kernel<D, MODEL, KIND_POISSON><<<blocks, CHUNK_THREADS, 0, s>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_model(int model, int kind, const ChunkArgs& a, int blocks,
                           cudaStream_t s) {
  // A model reading NP parameters needs d >= NP; smaller d is never built.
  if (model == MODEL_LORDER_MIXED_BG) {
    if constexpr (D >= Model<float, MODEL_LORDER_MIXED_BG>::NP)
      return dispatch_kind<D, MODEL_LORDER_MIXED_BG>(kind, a, blocks, s);
  } else if (model == MODEL_LINE) {
    if constexpr (D >= Model<float, MODEL_LINE>::NP)
      return dispatch_kind<D, MODEL_LINE>(kind, a, blocks, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace lmt

extern "C" int lmt_chunk_blocks(int W) {
  return (W + lmt::CHUNK_THREADS - 1) / lmt::CHUNK_THREADS;
}

// d in 1..8.  Pointers as described in ChunkArgs; returns the cudaError_t
// of the launch.
extern "C" int lmt_chunk_rwm(
    int d, int model, int kind, const float* pos, const float* lp,
    const float* best, const float* best_lp, const float* L, const int* seed,
    const int* pidx, const float* c0, const float* c1, const float* c2,
    const float* c3, const float* c4, int n, const int* bflag,
    const float* blo, const float* bhi, float* pos_out, float* lp_out,
    float* best_out, float* best_lp_out, float* acc_out, float* msum_part,
    float* mouter_part, float* trace_part, int W, int wb, int chunk,
    int anneal_step, float temp_override, float ts, float phase_rate,
    float temp_amp, float neg_floor, int greedy, void* stream) {
  lmt::ChunkArgs a;
  a.pos = pos; a.lp = lp; a.best = best; a.best_lp = best_lp; a.L = L;
  a.seed = seed; a.pidx = pidx;
  a.data.col[0] = c0; a.data.col[1] = c1; a.data.col[2] = c2;
  a.data.col[3] = c3; a.data.col[4] = c4; a.data.n = n;
  a.bounds.flag = bflag; a.bounds.lo = blo; a.bounds.hi = bhi;
  a.pos_out = pos_out; a.lp_out = lp_out; a.best_out = best_out;
  a.best_lp_out = best_lp_out; a.acc_out = acc_out;
  a.msum_part = msum_part; a.mouter_part = mouter_part; a.trace_part = trace_part;
  a.W = W; a.wb = wb; a.chunk = chunk; a.anneal_step = anneal_step;
  a.temp_override = temp_override; a.ts = ts; a.phase_rate = phase_rate;
  a.temp_amp = temp_amp; a.neg_floor = neg_floor; a.greedy = greedy;
  const int blocks = lmt_chunk_blocks(W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return lmt::dispatch_model<1>(model, kind, a, blocks, s);
    case 2: return lmt::dispatch_model<2>(model, kind, a, blocks, s);
    case 3: return lmt::dispatch_model<3>(model, kind, a, blocks, s);
    case 4: return lmt::dispatch_model<4>(model, kind, a, blocks, s);
    case 5: return lmt::dispatch_model<5>(model, kind, a, blocks, s);
    case 6: return lmt::dispatch_model<6>(model, kind, a, blocks, s);
    case 7: return lmt::dispatch_model<7>(model, kind, a, blocks, s);
    case 8: return lmt::dispatch_model<8>(model, kind, a, blocks, s);
  }
  return cudaErrorInvalidValue;
}
