// Whole-chunk random-walk Metropolis: `chunk` MH steps in one launch.
//
// Replaces the TPU kernel lisp_mcmc_tpu/ops/chunk_pallas.py
// (build_chunk_pallas).  One thread per walker loops over the steps; per
// step it takes the temperature (cosine anneal or override), draws z by
// Box-Muller on the keyed counter hash, proposes x + L z with the lower-
// triangular L, evaluates the fused posterior of every term (models.cuh)
// plus the bounds table, the declared constraints and the declared
// densities, with a finite floor, accepts by MH (or greedily), tracks its
// best point and adds the accepted move to the moment sums.
//
// What bounds it on an H100: arithmetic, as in fused_posterior.cu, times
// `chunk` steps: device memory is touched once per chunk (state in and
// out, ~11 MB at W = 131072, d = 6), against 200 x W x N walker-points,
// each a model evaluation with an IEEE division.  The point loop is a
// chain of dependent FP operations and shared-memory broadcasts, so its
// time depends on how many warps each SM holds to hide that latency, and
// on how evenly the blocks fill the SMs.  The card is short of registers
// (65536 per SM), so the design spends them on the point loop only:
//
// - One kernel for every d <= MAX_D.  The walker's position and its step
//   (first z, then L z in place) are rows of shared memory, s[r * B + tid]
//   (thread-major: no bank conflicts); the proposal is read as pos + step
//   where a parameter is needed.  The point loop holds in registers only
//   the twin's parameters and constants, its sum and the loop-invariant
//   scalars (lp, best_lp, acc, the keys).  The best point goes straight
//   to the output in device memory when it improves.  __launch_bounds__
//   caps the registers at 64, so 1024 threads (32 warps) fit an SM, as in
//   the fused kernel.
// - L, the bounds table, the constraints and the densities are shared
//   memory (a density table's size counts in the plan).  So is the
//   data when every term fits one tile and all terms' columns, each at the
//   tile's stride, fit RESIDENT_FLOATS, staged once for the whole chunk,
//   unless staging each term tile by tile every step (one tile's shared
//   memory) lets more warps reside; otherwise it is staged so.
// - The accepted-move moments (d sums and the d(d+1)/2 lower triangle of
//   the outer products) are summed over each warp every step, GROUP
//   entries at a time by a transposing butterfly (GROUP - 1 + 2 shuffles
//   for GROUP entries), into one shared row per warp.
// - The block size (256 threads, or 128 where the shared memory of 256
//   does not fit or fills the SMs in fewer, fuller waves) and whether the
//   data stays resident are picked from d, the shared-memory need and the
//   residency that cudaOccupancyMaxActiveBlocksPerMultiprocessor reports
//   (chunk_plan), once per fit and walker count: the wrapper keeps the
//   plan and passes it to every launch, which checks it.
//
// Every walker does the same arithmetic in the same order as the register
// design this replaces compiled to (L z: row r's first two products as
// fma(L[r][0], z[0], L[r][1] z[1]), then an FMA for each further c
// ascending; each term's points in order; the bounds, the constraints,
// then the densities; the finite floor; the MH test; best tracking), so
// position, logprob, best point and accept count are bit for bit the
// same, and do not depend on the block size; only the trace sums and the
// moments are summed in another order.
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
// The per-step trace (max, sum and min of the walkers' logprob) is reduced
// per CUDA block with warp shuffles and written as (blocks, chunk, 3)
// partials; the moment sums as (blocks, d) and (blocks, d, d) partials.
// The wrapper reduces the partials with torch: no atomics, so a chunk is
// deterministic.
#include "models.cuh"

namespace lmt {

constexpr int MAX_D = 64;
constexpr int RESIDENT_FLOATS = 8192;  // 32 KB of data kept for the whole chunk
constexpr int GROUP = 8;               // moment entries warp-summed together
constexpr unsigned FULL = 0xffffffffu;

struct ChunkArgs {
  const float* pos;      // (W, d) in
  const float* lp;       // (W,)  logprob minus the scalar constant
  const float* best;     // (W, d)
  const float* best_lp;  // (W,)
  const float* L;        // (d, d) lower triangular
  const int* seed;       // (1,) on the device
  Terms<float> terms;
  Bounds<float> bounds;
  Constraints<float> cons;
  Densities<float> dens;
  int dens_ints;         // didx entries
  int dens_vals;         // dval entries
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
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// One round of the transposing butterfly: a lane keeps the half of its
// first 2 HALF values that its BIT picks, and adds the partner's (lane ^
// BIT) values of that half, which the partner hands over.
template <int HALF, int BIT>
__device__ __forceinline__ void fold(float (&v)[GROUP], int lane) {
  const bool up = lane & BIT;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? v[i] : v[i + HALF];
    const float keep = up ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, BIT);
  }
}

// The warp sums of GROUP = 8 values at once.  After three folds lane l
// holds entry (l >> 2) & 7 summed over the 8 lanes that share l's two low
// bits; two plain rounds finish the sum.  9 shuffles for 8 entries, in a
// fixed order.
__device__ __forceinline__ float group_warp_sum(float (&v)[GROUP], int lane) {
  fold<4, 16>(v, lane);
  fold<2, 8>(v, lane);
  fold<1, 4>(v, lane);
  v[0] += __shfl_xor_sync(FULL, v[0], 2);
  v[0] += __shfl_xor_sync(FULL, v[0], 1);
  return v[0];
}

// Floats of dynamic shared memory for a block of B threads: L, the bounds
// table (lo, hi, column), the constraints (lo/hi, then kind and columns),
// the densities (nd 4-byte values and ints), the position and step rows,
// one moment row per warp, the data (resident, or one tile of each column)
// and the per-warp trace partials.
__host__ __device__ inline int chunk_smem_floats(int B, int d, int nb, int nc, int nd,
                                                 int resident, int data_floats) {
  const int nm = d + d * (d + 1) / 2;
  const int warps = B / 32;
  return d * d + 3 * nb + 5 * nc + nd + 2 * d * B + nm * warps +
         (resident ? data_floats : MAX_COLS * TILE) + 3 * warps;
}

template <int B>
__global__ void __launch_bounds__(B, 1024 / B)
chunk_rwm_kernel(const ChunkArgs a) {
  constexpr int WARPS = B / 32;
  extern __shared__ float smem[];
  const int d = a.d;
  const int nm = d + d * (d + 1) / 2;  // moment entries: sums, then the triangle
  const int nb = a.bounds.n;
  const int nc = a.cons.n;
  float* Ls = smem;
  float* blo = Ls + d * d;
  float* bhi = blo + nb;
  int* bcol = reinterpret_cast<int*>(bhi + nb);
  float* cval = reinterpret_cast<float*>(bcol + nb);
  int* cidx = reinterpret_cast<int*>(cval + 2 * nc);
  float* dval = reinterpret_cast<float*>(cidx + 3 * nc);
  int* didx = reinterpret_cast<int*>(dval + a.dens_vals);
  float* spos = reinterpret_cast<float*>(didx + a.dens_ints);
  float* sstep = spos + d * B;
  float* wmom = sstep + d * B;
  float* data = wmom + nm * WARPS;
  float* red = data + (a.resident ? a.data_floats : MAX_COLS * TILE);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int w = blockIdx.x * B + tid;
  const bool live = w < a.W;
  const int wr = live ? w : 0;  // dead tail threads shadow walker 0
  float* pos = spos + tid;      // this walker's rows: pos[r * B], step[r * B]
  float* step = sstep + tid;

  for (int k = tid; k < d * d; k += B) Ls[k] = a.L[k];
  for (int e = tid; e < nb; e += B) {
    blo[e] = a.bounds.lo[e];
    bhi[e] = a.bounds.hi[e];
    bcol[e] = a.bounds.col[e];
  }
  for (int e = tid; e < 2 * nc; e += B) cval[e] = a.cons.val[e];
  for (int e = tid; e < 3 * nc; e += B) cidx[e] = a.cons.idx[e];
  for (int e = tid; e < a.dens_vals; e += B) dval[e] = a.dens.val[e];
  for (int e = tid; e < a.dens_ints; e += B) didx[e] = a.dens.idx[e];
  for (int k = tid; k < nm * WARPS; k += B) wmom[k] = 0.0f;
  if (a.resident) {
    for (int i = 0, off = 0; i < a.terms.count; ++i) {
      const Term<float>& tm = a.terms.t[i];
      const int ncol = kind_cols(tm.kind);
      stage_cols(data + off, TILE, tm, ncol, 0, tm.n);
      off += ncol * TILE;
    }
  }
  for (int r = 0; r < d; ++r) pos[r * B] = a.pos[static_cast<size_t>(wr) * d + r];
  if (live)
    for (int r = 0; r < d; ++r)
      a.best_out[static_cast<size_t>(w) * d + r] = a.best[static_cast<size_t>(w) * d + r];
  __syncthreads();

  float lp = a.lp[wr];
  float best_lp = a.best_lp[wr];
  float acc = 0.0f;

  const uint32_t c_idx = static_cast<uint32_t>(wr % a.wb);
  const uint32_t pid = static_cast<uint32_t>(wr / a.wb);
  const uint32_t key_sp =
      static_cast<uint32_t>(a.seed[0]) * 0x9E3779B9u + pid * 0x85EBCA6Bu;
  const uint32_t wbu = static_cast<uint32_t>(a.wb);
  // the proposal's parameter in column c
  auto prop = [&](int c) { return pos[c * B] + step[c * B]; };

  for (int i = 0; i < a.chunk; ++i) {
    // temperature: cosine anneal (kernel.py:temperature_schedule) or override
    const float step_i = static_cast<float>(a.anneal_step + i);
    float sched = fmaxf(1.0f, cosf(step_i * a.phase_rate) * a.temp_amp);
    sched = step_i < a.ts ? sched : 1.0f;
    const float temp = a.temp_override > 0.0f ? a.temp_override : sched;

    // proposal: z by Box-Muller on the keyed hash into the step rows, then
    // step = L z in place, from the last row: row r reads z[0..r], which
    // the rows not yet written still hold
    const uint32_t key_step = static_cast<uint32_t>(i) * 0xB5297A4Du;
    for (int r = 0; r < d; ++r) {
      const uint32_t idx = static_cast<uint32_t>(r) * wbu + c_idx;
      const float u1 = uniform_from_bits(hash_bits(idx, key_sp, key_step));
      const float u2 =
          uniform_from_bits(hash_bits(idx, key_sp, key_step + 0x68E31DA4u));
      step[r * B] = sqrtf(-2.0f * logf(u1)) * cosf(6.2831855f * u2);
    }
    for (int r = d - 1; r >= 0; --r) {
      const float* Lr = Ls + r * d;
      float s;
      if (r == 0) {
        s = Lr[0] * step[0];
      } else {
        s = __fmaf_rn(Lr[0], step[0], __fmul_rn(Lr[1], step[B]));
        for (int c = 2; c <= r; ++c) s = __fmaf_rn(Lr[c], step[c * B], s);
      }
      step[r * B] = s;
    }

    // posterior at the proposal: every term, then the bounds table, the
    // constraints and the densities
    float lp_prop = 0.0f;
    for (int t = 0, off = 0; t < a.terms.count; ++t) {
      const Term<float>& tm = a.terms.t[t];
      // the twin's parameters; the loop stops at np (uniform across the
      // block), so a 6-parameter twin pays 6 reads, not MAX_NP
      float mp[MAX_NP] = {};
#pragma unroll
      for (int k = 0; k < MAX_NP; ++k) {
        if (k >= tm.np) break;
        const int c = tm.pidx[k];
        mp[k] = c >= 0 ? prop(c) : 0.0f;
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
    for (int e = 0; e < nb; ++e) prior += bound_penalty(prop(bcol[e]), blo[e], bhi[e]);
    if (nc > 0) prior += constraint_total(nc, cidx, cval, prop);
    if (a.dens.n > 0) prior += density_total(a.dens.n, didx, dval, prop);
    lp_prop = lp_prop + prior;
    if (!isfinite(lp_prop)) lp_prop = a.neg_floor;

    // MH accept (mcmc-fitting.lisp:1091-1092) or greedy (1117-1119)
    const float log_u = logf(uniform_from_bits(
        hash_bits(c_idx, key_sp, key_step + 2u * 0x68E31DA4u)));
    const bool accept = a.greedy ? (lp_prop > lp)
                                 : ((lp_prop > lp) || ((lp_prop - lp) / temp > log_u));
    if (accept) {
      for (int r = 0; r < d; ++r) pos[r * B] = pos[r * B] + step[r * B];
      lp = lp_prop;
    }
    acc += accept ? 1.0f : 0.0f;

    // accepted-move moments (zero for a rejected step or a dead thread):
    // entry k < d is step[k], then (r, c), c <= r, row by row, is
    // step[r] * step[c]; GROUP entries at a time into the warp's row
    const bool take = live && accept;
    for (int g = 0, tr = 0, tc = 0; g < nm; g += GROUP) {
      float v[GROUP];
#pragma unroll
      for (int e = 0; e < GROUP; ++e) {
        const int k = g + e;
        float x = 0.0f;
        if (k < d) {
          x = step[k * B];
        } else if (k < nm) {
          x = step[tr * B] * step[tc * B];
          if (++tc > tr) {
            ++tr;
            tc = 0;
          }
        }
        v[e] = take ? x : 0.0f;
      }
      const float sum = group_warp_sum(v, lane);
      const int k = g + ((lane >> 2) & (GROUP - 1));
      if ((lane & 3) == 0 && k < nm) wmom[warp * nm + k] += sum;
    }

    // best tracking (mcmc-fitting.lisp:553-555)
    if (lp > best_lp) {
      if (live)
        for (int r = 0; r < d; ++r) a.best_out[static_cast<size_t>(w) * d + r] = pos[r * B];
      best_lp = lp;
    }

    // per-step trace partials: max, sum, min of this block's logprob
    float vmax = warp_max(live ? lp : -CUDART_INF_F);
    float vsum = warp_sum(live ? lp : 0.0f);
    float vmin = warp_min(live ? lp : CUDART_INF_F);
    if (lane == 0) {
      red[warp] = vmax;
      red[WARPS + warp] = vsum;
      red[2 * WARPS + warp] = vmin;
    }
    __syncthreads();
    if (tid == 0) {
      for (int k = 1; k < WARPS; ++k) {
        vmax = fmaxf(vmax, red[k]);
        vsum += red[WARPS + k];
        vmin = fminf(vmin, red[2 * WARPS + k]);
      }
      float* t = a.trace_part + (static_cast<size_t>(blockIdx.x) * a.chunk + i) * 3;
      t[0] = vmax;
      t[1] = vsum;
      t[2] = vmin;
    }
    __syncthreads();
  }

  if (live) {
    for (int r = 0; r < d; ++r) a.pos_out[static_cast<size_t>(w) * d + r] = pos[r * B];
    a.lp_out[w] = lp;
    a.best_lp_out[w] = best_lp;
    a.acc_out[w] = acc;
  }

  // per-block moment partials: the warps' rows added in order
  __syncthreads();
  for (int k = tid; k < nm; k += B) {
    float v = wmom[k];
    for (int q = 1; q < WARPS; ++q) v += wmom[q * nm + k];
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

// The launch of one chunk: threads per block, blocks, blocks resident per
// SM, the SM count, whether the data stays resident and the dynamic
// shared memory.
struct Plan {
  int threads, blocks, per_sm, sms, resident;
  size_t smem;
};

// Allow B-thread blocks `bytes` of dynamic shared memory; with per_sm,
// also read how many such blocks an SM holds.
template <int B>
cudaError_t residency(size_t bytes, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      chunk_rwm_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess || per_sm == nullptr) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, chunk_rwm_kernel<B>, B, bytes);
}

// Pick the block size and the data's place: of 256 and 128 threads, with
// the data resident (where it may be) and staged tile by tile, the
// launches whose shared memory fits a block; the one whose waves cost
// least (waves x resident threads per SM: the thread-slots the SMs hold
// until the last wave ends), then the one with more resident threads,
// then the first of resident 256, resident 128, staged 256, staged 128.
cudaError_t chunk_plan(int d, int nb, int nc, int nd, int resident_ok, int data_floats,
                       int W, Plan* plan) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  bool found = false;
  long best_cost = 0;
  const int sizes[2] = {256, 128};
  for (int resident = resident_ok; resident >= 0; --resident) {
    for (int B : sizes) {
      const size_t bytes =
          sizeof(float) * chunk_smem_floats(B, d, nb, nc, nd, resident, data_floats);
      if (bytes > static_cast<size_t>(optin)) continue;
      int per_sm = 0;
      err = B == 256 ? residency<256>(bytes, &per_sm) : residency<128>(bytes, &per_sm);
      if (err != cudaSuccess) return err;
      if (per_sm < 1) continue;
      const int blocks = (W + B - 1) / B;
      const long waves = (blocks + per_sm * sms - 1) / (per_sm * sms);
      const long cost = waves * per_sm * B;
      if (!found || cost < best_cost ||
          (cost == best_cost && per_sm * B > plan->per_sm * plan->threads)) {
        *plan = Plan{B, blocks, per_sm, sms, resident, bytes};
        best_cost = cost;
        found = true;
      }
    }
  }
  return found ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// Data that may stay resident: every term within one tile, each column at
// the tile's stride (a constant in the point loop), all within
// RESIDENT_FLOATS.
void data_layout(const Terms<float>& terms, int* resident, int* data_floats) {
  bool one_tile = true;
  *data_floats = 0;
  for (int i = 0; i < terms.count; ++i) {
    one_tile = one_tile && terms.t[i].n <= TILE;
    *data_floats += kind_cols(terms.t[i].kind) * TILE;
  }
  *resident = one_tile && *data_floats <= RESIDENT_FLOATS;
}

}  // namespace lmt

// The plan to launch lmt_chunk_rwm with, for these terms, tables and W on
// the current card: out = (threads per block, blocks, blocks resident per
// SM, SMs, dynamic shared memory bytes, data resident); nd counts the
// density table's ints and values together.  Planning leaves
// each block size's shared-memory attribute at its last candidate's;
// lmt_chunk_rwm sets it again.  Returns a cudaError_t.
extern "C" int lmt_chunk_plan(int d, int n_terms, const int* meta, int nb, int nc, int nd,
                              int W, int* out) {
  if (d < 1 || d > lmt::MAX_D || n_terms < 1 || n_terms > lmt::MAX_TERMS)
    return cudaErrorInvalidValue;
  const void* cols[lmt::MAX_TERMS * lmt::MAX_COLS] = {};
  const lmt::Terms<float> terms = lmt::make_terms<float>(n_terms, meta, cols);
  int resident = 0, data_floats = 0;
  lmt::data_layout(terms, &resident, &data_floats);
  lmt::Plan p{};
  const cudaError_t err = lmt::chunk_plan(d, nb, nc, nd, resident, data_floats, W, &p);
  if (err != cudaSuccess) return err;
  out[0] = p.threads;
  out[1] = p.blocks;
  out[2] = p.per_sm;
  out[3] = p.sms;
  out[4] = static_cast<int>(p.smem);
  out[5] = p.resident;
  return cudaSuccess;
}

// d in 1..MAX_D.  meta and cols are host arrays of n_terms terms
// (models.cuh: make_terms); bcol/blo/bhi the nb bounds entries,
// cidx/cval the nc constraints and didx/dval the nd densities (ndi ints,
// ndv values) on the device; threads, blocks, smem and
// resident are lmt_chunk_plan's plan for these terms, tables and W, which
// also sized the partial buffers (checked against W and the shared-memory
// layout here).  Returns the cudaError_t of the launch.
extern "C" int lmt_chunk_rwm(
    int d, int n_terms, const int* meta, const void* const* cols,
    const float* pos, const float* lp, const float* best, const float* best_lp,
    const float* L, const int* seed, const int* bcol, const float* blo,
    const float* bhi, int nb, const int* cidx, const float* cval, int nc,
    const int* didx, const float* dval, int nd, int ndi, int ndv,
    float* pos_out, float* lp_out, float* best_out, float* best_lp_out, float* acc_out,
    float* msum_part, float* mouter_part, float* trace_part,
    int W, int wb, int chunk, int anneal_step, float temp_override,
    float ts, float phase_rate, float temp_amp,
    float neg_floor, int greedy, int threads, int blocks, int smem, int resident,
    void* stream) {
  if (d < 1 || d > lmt::MAX_D || n_terms < 1 || n_terms > lmt::MAX_TERMS)
    return cudaErrorInvalidValue;
  lmt::ChunkArgs a;
  a.pos = pos; a.lp = lp; a.best = best; a.best_lp = best_lp; a.L = L;
  a.seed = seed;
  a.terms = lmt::make_terms<float>(n_terms, meta, cols);
  a.bounds.col = bcol; a.bounds.lo = blo; a.bounds.hi = bhi; a.bounds.n = nb;
  a.cons.idx = cidx; a.cons.val = cval; a.cons.n = nc;
  a.dens.idx = didx; a.dens.val = dval; a.dens.n = nd;
  a.dens_ints = ndi; a.dens_vals = ndv;
  a.pos_out = pos_out; a.lp_out = lp_out; a.best_out = best_out;
  a.best_lp_out = best_lp_out; a.acc_out = acc_out;
  a.msum_part = msum_part; a.mouter_part = mouter_part; a.trace_part = trace_part;
  a.d = d;
  int may_reside = 0;
  lmt::data_layout(a.terms, &may_reside, &a.data_floats);
  a.W = W; a.wb = wb; a.chunk = chunk; a.anneal_step = anneal_step;
  a.temp_override = temp_override; a.ts = ts; a.phase_rate = phase_rate;
  a.temp_amp = temp_amp; a.neg_floor = neg_floor; a.greedy = greedy;
  a.resident = resident;
  // a plan for other terms, tables or W would overrun the partial buffers
  // or the shared memory
  if ((threads != 256 && threads != 128) || blocks != (W + threads - 1) / threads ||
      resident < 0 || resident > may_reside || nd < 0 || ndi < 0 || ndv < 0 ||
      static_cast<size_t>(smem) != sizeof(float) * lmt::chunk_smem_floats(
                                       threads, d, nb, nc, ndi + ndv, resident, a.data_floats))
    return cudaErrorInvalidValue;
  // the attribute is per kernel: another plan may have set it since
  cudaError_t err = threads == 256 ? lmt::residency<256>(smem, nullptr)
                                   : lmt::residency<128>(smem, nullptr);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads == 256)
    lmt::chunk_rwm_kernel<256><<<blocks, 256, smem, s>>>(a);
  else
    lmt::chunk_rwm_kernel<128><<<blocks, 128, smem, s>>>(a);
  return cudaGetLastError();
}
