// Whole-chunk random-walk Metropolis: `chunk` MH steps in one launch.
//
// Replaces the TPU kernel lisp_mcmc_tpu/ops/chunk_pallas.py
// (build_chunk_pallas).  One thread per walker loops over the steps; per
// step it takes the temperature (cosine anneal or override), draws z by
// Box-Muller on the keyed counter hash, proposes x + L z with the lower-
// triangular L, evaluates the fused posterior of every term (models.cuh)
// with a finite floor, accepts by MH (or greedily), tracks its best point
// and adds the accepted move to the moment sums.
//
// Where the state lives.  L and the bounds table are the same for every
// walker: shared memory.  So is the data when every term fits one tile
// and all terms' columns, each at the tile's stride, fit RESIDENT_FLOATS:
// staged once for the whole chunk; otherwise each term is staged tile by
// tile every step.  The walker's position, best point,
// proposal and draws are registers in the bucketed variants (template
// D = 8 or 16: any d <= D, loops unrolled to D and cut at d) and local
// memory in the runtime-d variant (D = 0, d <= MAX_D_RUNTIME).  The
// accepted-move moments (d sums and the d(d+1)/2 lower triangle of the
// outer products) are per-thread accumulators in shared memory in the
// bucketed variants, and in the runtime-d variant are warp-summed every
// step into one shared row per warp (d = 64 would need 1 MB per block as
// per-thread rows).
//
// Random stream: bit for bit the JAX kernel's.  Walker w sits in a
// *logical* block of wb walkers (wb = pick_block(W, 1024), independent of
// the CUDA block size): pid = w / wb, c = w % wb.  Parameter r's draws
// hash index r*wb + c for every d; the accept draw hashes c; keys are
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
#include "models.cuh"

namespace lmt {

constexpr int CHUNK_THREADS = 128;
constexpr int CHUNK_WARPS = CHUNK_THREADS / 32;
constexpr int MAX_D_RUNTIME = 64;
constexpr int RESIDENT_FLOATS = 8192;  // 32 KB of data kept for the whole chunk

struct ChunkArgs {
  const float* pos;      // (W, d) in
  const float* lp;       // (W,)  logprob minus the scalar constant
  const float* best;     // (W, d)
  const float* best_lp;  // (W,)
  const float* L;        // (d, d) lower triangular
  const int* seed;       // (1,) on the device
  Terms<float> terms;
  Bounds<float> bounds;
  float* pos_out;
  float* lp_out;
  float* best_out;
  float* best_lp_out;
  float* acc_out;        // (W,)
  float* msum_part;      // (blocks, d)
  float* mouter_part;    // (blocks, d, d)
  float* trace_part;     // (blocks, chunk, 3): max, sum, min
  int d;
  int data_floats;       // every term's columns at the tile's stride, when resident
  int resident;
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

// v[idx] for a runtime idx, 0 for idx < 0: a register select in the
// bucketed variants (no local memory), an indexed load in the runtime one.
template <int D, int A>
__device__ __forceinline__ float pick(const float (&v)[A], int idx) {
  if constexpr (D == 0) {
    return idx >= 0 ? v[idx] : 0.0f;
  } else {
    float out = 0.0f;
#pragma unroll
    for (int r = 0; r < A; ++r) out = (r == idx) ? v[r] : out;
    return out;
  }
}

// Floats of dynamic shared memory: L, the bounds table (lo, hi, column),
// the moments (bucketed: one row per thread, then one per warp; runtime
// d: one row per warp), the data (resident, or one tile of each column)
// and the per-warp trace partials.
__host__ __device__ inline int moment_floats(int D, int d) {
  const int m = d + d * (d + 1) / 2;
  return m * ((D > 0 ? CHUNK_THREADS : 0) + CHUNK_WARPS);
}
__host__ __device__ inline int chunk_smem_floats(int D, int d, int nb, int resident,
                                                 int data_floats) {
  return d * d + 3 * nb + moment_floats(D, d) +
         (resident ? data_floats : MAX_COLS * TILE) + 3 * CHUNK_WARPS;
}

template <int D>
__global__ void __launch_bounds__(CHUNK_THREADS)
chunk_rwm_kernel(const ChunkArgs a) {
  constexpr int A = D > 0 ? D : MAX_D_RUNTIME;  // per-walker array length
  extern __shared__ float smem[];
  const int d = a.d;
  // Loops over parameters run to the constant D in the register variants
  // (fully unrolled, so every array index is a constant and the arrays
  // stay in registers; the iterations past d do nothing) and to the
  // runtime d in the runtime variant (not unrolled: local memory).
  const int NR = D > 0 ? D : d;
  const int nm = d + d * (d + 1) / 2;  // moment entries: sums, then the triangle
  const int nb = a.bounds.n;
  float* Ls = smem;
  float* blo = Ls + d * d;
  float* bhi = blo + nb;
  int* bcol = reinterpret_cast<int*>(bhi + nb);
  float* mom = reinterpret_cast<float*>(bcol + nb);   // thread rows (bucketed)
  float* wpart = mom + (D > 0 ? nm * CHUNK_THREADS : 0);  // warp rows
  float* data = mom + moment_floats(D, d);
  float* red = data + (a.resident ? a.data_floats : MAX_COLS * TILE);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int w = blockIdx.x * CHUNK_THREADS + tid;
  const bool live = w < a.W;
  const int wr = live ? w : 0;  // dead tail threads shadow walker 0

  for (int k = tid; k < d * d; k += CHUNK_THREADS) Ls[k] = a.L[k];
  for (int e = tid; e < nb; e += CHUNK_THREADS) {
    blo[e] = a.bounds.lo[e];
    bhi[e] = a.bounds.hi[e];
    bcol[e] = a.bounds.col[e];
  }
  for (int k = tid; k < moment_floats(D, d); k += CHUNK_THREADS) mom[k] = 0.0f;
  if (a.resident) {
    for (int i = 0, off = 0; i < a.terms.count; ++i) {
      const Term<float>& tm = a.terms.t[i];
      const int ncol = kind_cols(tm.kind);
      stage_cols(data + off, TILE, tm, ncol, 0, tm.n);
      off += ncol * TILE;
    }
  }
  __syncthreads();

  float pos[A], best[A];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (r >= d) continue;
    pos[r] = a.pos[static_cast<size_t>(wr) * d + r];
    best[r] = a.best[static_cast<size_t>(wr) * d + r];
  }
  float lp = a.lp[wr];
  float best_lp = a.best_lp[wr];
  float acc = 0.0f;

  const uint32_t c_idx = static_cast<uint32_t>(wr % a.wb);
  const uint32_t pid = static_cast<uint32_t>(wr / a.wb);
  const uint32_t key_sp =
      static_cast<uint32_t>(a.seed[0]) * 0x9E3779B9u + pid * 0x85EBCA6Bu;
  const uint32_t wbu = static_cast<uint32_t>(a.wb);

  // Add v to moment entry k: this thread's row (bucketed), or the warp's
  // sum to the warp's row (runtime d).  Dead tail threads add nothing.
  auto moment_add = [&](int k, float v) {
    v = live ? v : 0.0f;
    if constexpr (D > 0) {
      mom[k * CHUNK_THREADS + tid] += v;
    } else {
      v = warp_sum(v);
      if (lane == 0) wpart[warp * nm + k] += v;
    }
  };

  for (int i = 0; i < a.chunk; ++i) {
    // temperature: cosine anneal (kernel.py:temperature_schedule) or override
    const float step_i = static_cast<float>(a.anneal_step + i);
    float sched = fmaxf(1.0f, cosf(step_i * a.phase_rate) * a.temp_amp);
    sched = step_i < a.ts ? sched : 1.0f;
    const float temp = a.temp_override > 0.0f ? a.temp_override : sched;

    // proposal: z by Box-Muller on the keyed hash, step = L z
    const uint32_t key_step = static_cast<uint32_t>(i) * 0xB5297A4Du;
    float z[A], step[A], prop[A];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (r >= d) continue;
      const uint32_t idx = static_cast<uint32_t>(r) * wbu + c_idx;
      const float u1 = uniform_from_bits(hash_bits(idx, key_sp, key_step));
      const float u2 =
          uniform_from_bits(hash_bits(idx, key_sp, key_step + 0x68E31DA4u));
      z[r] = sqrtf(-2.0f * logf(u1)) * cosf(6.2831855f * u2);
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (r >= d) continue;
      const float* Lr = Ls + r * d;
      float s = Lr[0] * z[0];
#pragma unroll
      for (int c = 1; c <= r; ++c) s = s + Lr[c] * z[c];
      step[r] = s;
      prop[r] = pos[r] + s;
    }

    // posterior at the proposal: every term, then the bounds table
    float lp_prop = 0.0f;
    for (int t = 0, off = 0; t < a.terms.count; ++t) {
      const Term<float>& tm = a.terms.t[t];
      // the twin's parameters; the loop stops at np (uniform across the
      // block), so a 6-parameter twin pays 6 picks, not MAX_NP
      float mp[MAX_NP] = {};
#pragma unroll
      for (int k = 0; k < MAX_NP; ++k) {
        if (k >= tm.np) break;
        mp[k] = pick<D>(prop, tm.pidx[k]);
      }
      const int ncol = kind_cols(tm.kind);
      float sum = 0.0f;
      if (a.resident) {
        sum = term_sum(tm.kind, tm.model, mp, tm.np, data + off, TILE, tm.n);
        off += ncol * TILE;
      } else {
        for (int t0 = 0; t0 < tm.n; t0 += TILE) {
          const int cnt = min(TILE, tm.n - t0);
          __syncthreads();
          stage_cols(data, TILE, tm, ncol, t0, cnt);
          __syncthreads();
          sum += term_sum(tm.kind, tm.model, mp, tm.np, data, TILE, cnt);
        }
      }
      lp_prop += finish_likelihood(tm.kind, sum);
    }
    float prior = 0.0f;
    for (int e = 0; e < nb; ++e) prior += bound_penalty(pick<D>(prop, bcol[e]), blo[e], bhi[e]);
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
      for (int r = 0; r < NR; ++r) {
        if (r >= d) continue;
        pos[r] = prop[r];
      }
      lp = lp_prop;
    }
    // accepted-move moments (zero for a rejected step)
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (r >= d) continue;
      const float dr = step[r] * accf;
      moment_add(r, dr);
      const int row = d + r * (r + 1) / 2;
#pragma unroll
      for (int c = 0; c <= r; ++c) moment_add(row + c, dr * (step[c] * accf));
    }
    acc += accf;
    // best tracking (mcmc-fitting.lisp:553-555)
    if (lp > best_lp) {
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (r >= d) continue;
        best[r] = pos[r];
      }
      best_lp = lp;
    }

    // per-step trace partials: max, sum, min of this block's logprob
    float vmax = warp_max(live ? lp : -CUDART_INF_F);
    float vsum = warp_sum(live ? lp : 0.0f);
    float vmin = warp_min(live ? lp : CUDART_INF_F);
    if (lane == 0) {
      red[warp] = vmax;
      red[CHUNK_WARPS + warp] = vsum;
      red[2 * CHUNK_WARPS + warp] = vmin;
    }
    __syncthreads();
    if (tid == 0) {
      for (int k = 1; k < CHUNK_WARPS; ++k) {
        vmax = fmaxf(vmax, red[k]);
        vsum += red[CHUNK_WARPS + k];
        vmin = fminf(vmin, red[2 * CHUNK_WARPS + k]);
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
    for (int r = 0; r < NR; ++r) {
      if (r >= d) continue;
      a.pos_out[static_cast<size_t>(w) * d + r] = pos[r];
      a.best_out[static_cast<size_t>(w) * d + r] = best[r];
    }
    a.lp_out[w] = lp;
    a.best_lp_out[w] = best_lp;
    a.acc_out[w] = acc;
  }

  // per-block moment partials: in the bucketed variants warp-sum the
  // thread rows into the warp rows, then add the warps
  if constexpr (D > 0) {
    for (int k = 0; k < nm; ++k) {
      const float v = warp_sum(mom[k * CHUNK_THREADS + tid]);
      if (lane == 0) wpart[warp * nm + k] = v;
    }
  }
  __syncthreads();
  for (int k = tid; k < nm; k += CHUNK_THREADS) {
    float v = wpart[k];
    for (int q = 1; q < CHUNK_WARPS; ++q) v += wpart[q * nm + k];
    if (k < d) {
      a.msum_part[static_cast<size_t>(blockIdx.x) * d + k] = v;
    } else {
      // lower-triangle entry (r, c) -> both (r, c) and (c, r)
      const int j = k - d;
      int r = 0;
      while ((r + 1) * (r + 2) / 2 <= j) ++r;
      const int c = j - r * (r + 1) / 2;
      float* mo = a.mouter_part + static_cast<size_t>(blockIdx.x) * d * d;
      mo[r * d + c] = v;
      mo[c * d + r] = v;
    }
  }
}

template <int D>
cudaError_t launch(const ChunkArgs& a, int blocks, cudaStream_t s) {
  const size_t bytes = sizeof(float) * chunk_smem_floats(
      D, a.d, a.bounds.n, a.resident, a.data_floats);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_rwm_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  chunk_rwm_kernel<D><<<blocks, CHUNK_THREADS, bytes, s>>>(a);
  return cudaGetLastError();
}

}  // namespace lmt

extern "C" int lmt_chunk_blocks(int W) {
  return (W + lmt::CHUNK_THREADS - 1) / lmt::CHUNK_THREADS;
}

// The variant a d runs (8 or 16: registers; 0: runtime d), -1 above
// MAX_D_RUNTIME.
extern "C" int lmt_chunk_variant(int d) {
  if (d < 1) return -1;
  if (d <= 8) return 8;
  if (d <= 16) return 16;
  return d <= lmt::MAX_D_RUNTIME ? 0 : -1;
}

// d in 1..MAX_D_RUNTIME.  meta and cols are host arrays of n_terms terms
// (models.cuh: make_terms); the other pointers as described in ChunkArgs.
// Returns the cudaError_t of the launch.
extern "C" int lmt_chunk_rwm(
    int d, int n_terms, const int* meta, const void* const* cols,
    const float* pos, const float* lp, const float* best, const float* best_lp,
    const float* L, const int* seed, const int* bcol, const float* blo,
    const float* bhi, int nb, float* pos_out, float* lp_out, float* best_out,
    float* best_lp_out, float* acc_out, float* msum_part, float* mouter_part,
    float* trace_part, int W, int wb, int chunk, int anneal_step,
    float temp_override, float ts, float phase_rate, float temp_amp,
    float neg_floor, int greedy, void* stream) {
  if (n_terms < 1 || n_terms > lmt::MAX_TERMS) return cudaErrorInvalidValue;
  lmt::ChunkArgs a;
  a.pos = pos; a.lp = lp; a.best = best; a.best_lp = best_lp; a.L = L;
  a.seed = seed;
  a.terms = lmt::make_terms<float>(n_terms, meta, cols);
  a.bounds.col = bcol; a.bounds.lo = blo; a.bounds.hi = bhi; a.bounds.n = nb;
  a.pos_out = pos_out; a.lp_out = lp_out; a.best_out = best_out;
  a.best_lp_out = best_lp_out; a.acc_out = acc_out;
  a.msum_part = msum_part; a.mouter_part = mouter_part; a.trace_part = trace_part;
  a.d = d;
  // resident: every term within one tile, each column at the tile's
  // stride (a constant in the point loop), all within RESIDENT_FLOATS
  a.data_floats = 0;
  bool one_tile = true;
  for (int i = 0; i < n_terms; ++i) {
    one_tile = one_tile && a.terms.t[i].n <= lmt::TILE;
    a.data_floats += lmt::kind_cols(a.terms.t[i].kind) * lmt::TILE;
  }
  a.resident = one_tile && a.data_floats <= lmt::RESIDENT_FLOATS;
  a.W = W; a.wb = wb; a.chunk = chunk; a.anneal_step = anneal_step;
  a.temp_override = temp_override; a.ts = ts; a.phase_rate = phase_rate;
  a.temp_amp = temp_amp; a.neg_floor = neg_floor; a.greedy = greedy;
  const int blocks = lmt_chunk_blocks(W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lmt_chunk_variant(d)) {
    case 8: return lmt::launch<8>(a, blocks, s);
    case 16: return lmt::launch<16>(a, blocks, s);
    case 0: return lmt::launch<0>(a, blocks, s);
  }
  return cudaErrorInvalidValue;
}
