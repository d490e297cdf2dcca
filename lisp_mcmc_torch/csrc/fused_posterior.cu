// Fused log-posterior: positions (W, d) -> (W,).
//
// Replaces the TPU kernel lisp_mcmc_tpu/ops/loglik_pallas.py
// (build_fused_posterior).  For each posterior term in turn, as the Pallas
// kernel loops over its term_meta: the term's twin at every data point,
// residual times inv_sigma and the likelihood's masked reduction; then the
// bounds prior, the declared constraints and the declared densities (a
// named prior's Gaussian, LogNormal and quadratic-form terms) of every
// term; then the
// walker-independent constant (log-normalisation, or -sum lgamma(y+1)),
// added last as (total + prior) + constant, the order in which the JAX
// package adds it, so the float32 sum does not lose the digits that decide
// an MH step.  Whatever part of a prior is not a declared table is added
// by the Python wrapper, in torch.
//
// What bounds it on an H100: arithmetic.  Per walker-point the flagship's
// lorder_mixed_bg term costs ~15 FP operations and one IEEE division (a
// reciprocal and Newton steps, not --use_fast_math); the only device
// memory traffic is W*d values in and W out, while W*N = 44M walker-points
// of arithmetic are done at the flagship's W = 131072, N = 334.  The
// design keeps the (walkers x points) intermediate out of device memory
// and spends the SM's issue slots on the arithmetic:
//
// - Packed point records.  Each term's points sit in device memory as
//   records of four values, (x, y, inv_sigma | mask, 0), and the cutoff
//   kind as two, (x, y, inv_sigma, c_pt) and (mask, 0, 0, 0), built once
//   by loglik_kernel.prepare_fused_terms.  A block copies them to shared
//   memory with cp.async, a whole term at once where it fits in one
//   buffer, else tile by tile into two buffers, the next tile (of this term
//   or the next) in flight while the block works on the current one.  One
//   point is then one vector load (LDS.128 in float32).
// - R walkers a thread (template), S threads a walker (run time).  A
//   thread loads each of its points once and evaluates it for its R
//   walkers, so a walker-point costs 1/R shared loads, and the R walkers
//   are independent chains the scheduler interleaves.  The S threads of a
//   walker take every S-th point and combine their sums by xor shuffles,
//   always in the same order: no atomics, the same input gives the same
//   bits.  S multiplies the threads where W alone would leave the SMs
//   short of warps (W/2 in the red-black samplers).
// - A kernel per twin class (template): a launch whose terms all share a
//   twin runs a kernel compiled for that twin alone, so its registers are
//   that twin's, not the largest twin's; the polynomial comes in 4-, 8-
//   and 16-coefficient classes.  A launch that mixes twins runs the kernel
//   that picks each term's twin at run time (R = 1).
// - The launch plan (lmt_fused_plan) picks the block size, R and S for W
//   on this card from the occupancy the card reports for each candidate
//   kernel, its registers and its shared memory.
#include <utility>

#include "models.cuh"

namespace lmt {

// Kernel 1's twin classes: MODEL_* (the polynomial's class holds 16
// coefficients), then the polynomial in 4 and 8 coefficient registers,
// then TWIN_ANY (the twin is chosen per term at run time).
enum { TWIN_POLY4 = 13, TWIN_POLY8 = 14, TWIN_ANY = 15, N_CLASSES = 16 };
constexpr int MAX_BLOCK = 256;       // threads a block, at most
constexpr int BUF_BYTES = 16384;     // shared memory of one record buffer
constexpr int REC = 4;               // values a record
constexpr int MAX_TWIN_P = 6;        // parameters of the non-polynomial twins

// The polynomial twin of kernel 1: Horner over c0..c{np-1} from the
// leading coefficient, each product and sum rounded apart, as
// models.cuh's Model<T, MODEL_POLYNOMIAL> (kernel 2's) and in the same
// order, so the same bits.  Poly<T, NPC> holds NPC coefficient registers
// (np <= NPC); setup picks the leading one, so eval runs the np - 1 steps
// below it, each guarded by np alone (the term's, the same at every
// point).  On an H100 at W = 131072 the 4-coefficient polynomial takes
// 0.021 ms this way, 0.055 ms as 4 steps guarded by two compares each
// (kernel 2's form) and 0.15 ms as 16 of them; in kernel 2, under its
// 64-register cap, this form spilled and slowed every shape by 6-15 %, so
// kernel 2 keeps its own.
template <typename T, int NPC> struct Poly {
  T c[NPC - 1];
  T lead;
  int np;
  __device__ __forceinline__ void setup(const T* p, int n) {
    np = n;
    lead = T(0);
#pragma unroll
    for (int k = 0; k < NPC; ++k) {
      if (k < NPC - 1) c[k] = p[k];
      if (k == n - 1) lead = p[k];
    }
  }
  __device__ __forceinline__ T eval(T x) const {
    T acc = lead;
#pragma unroll
    for (int k = NPC - 2; k >= 0; --k)
      if (k < np - 1) acc = add_rn(mul_rn(acc, x), c[k]);
    return acc;
  }
};

template <typename T, int TC> struct TwinOf { using type = Model<T, TC>; };
template <typename T> struct TwinOf<T, MODEL_POLYNOMIAL> { using type = Poly<T, MAX_NP>; };
template <typename T> struct TwinOf<T, TWIN_POLY4> { using type = Poly<T, 4>; };
template <typename T> struct TwinOf<T, TWIN_POLY8> { using type = Poly<T, 8>; };

// The parameter registers a twin's setup reads.
template <int TC> __host__ __device__ constexpr int twin_np() {
  return TC == TWIN_POLY4 ? 4 : TC == TWIN_POLY8 ? 8
         : TC == MODEL_POLYNOMIAL ? MAX_NP : MAX_TWIN_P;
}

__host__ __device__ __forceinline__ int recs_per_point(int kind) {
  return kind == KIND_NORMAL_CUTOFF ? 2 : 1;
}

// One term as kernel 1 reads it: its packed records in device memory.
template <typename T> struct PackedTerm {
  const T* rec;
  int n, model, kind, np;
  int pidx[MAX_NP];
};

template <typename T> struct FusedArgs {
  const T* pos;
  T* out;
  const T* cst;            // the scalar constant, one value on the device
  int W, d, S;
  int cap;                 // records a buffer holds
  int n_terms;
  PackedTerm<T> t[MAX_TERMS];
  Bounds<T> bounds;
  Constraints<T> cons;
  Densities<T> dens;
};

// ---- staging: cp.async of 16-byte chunks, one commit group per tile
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// The stream of tiles over every term in turn: tile j of the launch is
// points [t0, t0 + cnt) of term i; it goes to buffer j % 2 (one buffer
// when the launch has one tile).
template <typename T> struct TileStream {
  const FusedArgs<T>& a;
  T* buf;
  int j;        // the tile being computed
  int next_i, next_t0;  // the tile after it, next_i == n_terms: none

  __device__ __forceinline__ int tile_pts(int i) const {
    return a.cap / recs_per_point(a.t[i].kind);
  }
  // The tile after (i, t0): the rest of term i, or the first point of the
  // next term that has any.
  __device__ __forceinline__ void advance(int i, int t0) {
    t0 += tile_pts(i);
    if (t0 >= a.t[i].n) {
      t0 = 0;
      do { ++i; } while (i < a.n_terms && a.t[i].n == 0);
    }
    next_i = i;
    next_t0 = t0;
  }
  __device__ __forceinline__ void issue(int slot) {
    if (next_i < a.n_terms) {
      const PackedTerm<T>& tm = a.t[next_i];
      const int rpp = recs_per_point(tm.kind);
      const int cnt = min(tile_pts(next_i), tm.n - next_t0);
      const int chunks = cnt * rpp * REC * static_cast<int>(sizeof(T)) / 16;
      const char* src = reinterpret_cast<const char*>(tm.rec + static_cast<size_t>(next_t0) * rpp * REC);
      char* dst = reinterpret_cast<char*>(buf + static_cast<size_t>(slot) * a.cap * REC);
      for (int c = threadIdx.x; c < chunks; c += blockDim.x)
        cp_async16(dst + 16 * c, src + 16 * c);
    }
    cp_async_commit();
  }
  __device__ __forceinline__ void start() {
    j = 0;
    int i = 0;
    while (i < a.n_terms && a.t[i].n == 0) ++i;
    next_i = i;
    next_t0 = 0;
    issue(0);
  }
  // Wait for tile j (term i, from t0) and put the one after it in flight;
  // returns tile j's records.
  __device__ __forceinline__ const T* acquire(int i, int t0) {
    __syncthreads();  // every thread is done with tile j - 1, whose buffer is reused
    advance(i, t0);
    issue((j + 1) & 1);
    cp_async_wait_one();
    __syncthreads();
    return buf + static_cast<size_t>(j & 1) * a.cap * REC;
  }
};

__device__ __forceinline__ void load_rec(const float* p, float& x, float& y, float& w, float& c) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x = v.x; y = v.y; w = v.z; c = v.w;
}
__device__ __forceinline__ void load_rec(const double* p, double& x, double& y, double& w,
                                         double& c) {
  const double2 v0 = reinterpret_cast<const double2*>(p)[0];
  const double2 v1 = reinterpret_cast<const double2*>(p)[1];
  x = v0.x; y = v0.y; w = v1.x; c = v1.y;
}

// One tile's points k = sub, sub + S, ... < cnt for R walkers, into acc
// (the kind's masked sum as models.cuh's tile_sum takes it).
template <typename T, int R, typename M, int KIND>
__device__ __forceinline__ void tile_points(const M (&m)[R], const T* recs, int cnt, int sub,
                                            int S, T (&acc)[R]) {
  constexpr int RPP = KIND == KIND_NORMAL_CUTOFF ? 2 : 1;
  // Four points an iteration give the scheduler R x 4 independent chains
  // between the divisions' branches (on an H100: one a loop is 14-18 %
  // slower, two 3-6 %, eight no faster).
#pragma unroll 4
  for (int k = sub; k < cnt; k += S) {
    const T* p = recs + RPP * REC * k;
    T x, y, w, c;
    load_rec(p, x, y, w, c);
    T mask = T(0);
    if (KIND == KIND_NORMAL_CUTOFF) mask = p[REC];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T mu = m[r].eval(x);
      if (KIND == KIND_NORMAL) {
        const T z = (y - mu) * w;
        acc[r] += z * z;
      } else if (KIND == KIND_NORMAL_CUTOFF) {
        const T z = (y - mu) * w;
        const T lp = c - T(0.5) * z * z;
        // max(-5000, lp) that keeps a NaN, as torch.clamp_min does.
        acc[r] += (lp < T(-5000) ? T(-5000) : lp) * mask;
      } else {
        acc[r] += (y * d_log(mu) - mu) * w;
      }
    }
  }
}

// Term i's unfinished sum for R walkers with twin M: the twins' setup from
// the walkers' rows, then every tile of the term.
template <typename T, int R, typename M, int NPT, int KIND>
__device__ __forceinline__ void term_tiles(TileStream<T>& ts, int i, const T* const (&row)[R],
                                           int sub, T (&acc)[R]) {
  const PackedTerm<T>& tm = ts.a.t[i];
  M m[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    T p[NPT];
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
      const int c = tm.pidx[k];
      p[k] = (k < tm.np && c >= 0) ? row[r][c] : T(0);
    }
    m[r].setup(p, tm.np);
  }
  const int per_tile = ts.tile_pts(i);
  for (int t0 = 0; t0 < tm.n; t0 += per_tile) {
    const T* recs = ts.acquire(i, t0);
    tile_points<T, R, M, KIND>(m, recs, min(per_tile, tm.n - t0), sub, ts.a.S, acc);
    ++ts.j;
  }
}

template <typename T, int R, int TC>
__device__ __forceinline__ void term_twin(TileStream<T>& ts, int i, const T* const (&row)[R],
                                          int sub, T (&acc)[R]) {
  using M = typename TwinOf<T, TC>::type;
  constexpr int NPT = twin_np<TC>();
  const int kind = ts.a.t[i].kind;
  if (kind == KIND_NORMAL)
    term_tiles<T, R, M, NPT, KIND_NORMAL>(ts, i, row, sub, acc);
  else if (kind == KIND_NORMAL_CUTOFF)
    term_tiles<T, R, M, NPT, KIND_NORMAL_CUTOFF>(ts, i, row, sub, acc);
  else
    term_tiles<T, R, M, NPT, KIND_POISSON>(ts, i, row, sub, acc);
}

// A term of the TWIN_ANY kernel: its twin picked at run time (uniform
// across the launch), outside the point loop.
template <typename T, int R>
__device__ __forceinline__ void term_any(TileStream<T>& ts, int i, const T* const (&row)[R],
                                         int sub, T (&acc)[R]) {
  switch (ts.a.t[i].model) {
#define LMT_CASE(M) case M: term_twin<T, R, M>(ts, i, row, sub, acc); return;
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
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = static_cast<T>(CUDART_NAN);  // never passed
}

template <typename T, int R, int TC>
__global__ void __launch_bounds__(MAX_BLOCK)
fused_posterior_kernel(const __grid_constant__ FusedArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.S;
  const int G = blockDim.x / S;                 // walker groups a block
  const int g = threadIdx.x / S;
  const int sub = threadIdx.x - g * S;
  const T cst = *a.cst;
  int w[R];
  const T* row[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    w[r] = (blockIdx.x * R + r) * G + g;        // a warp's walkers are neighbours
    row[r] = a.pos + static_cast<size_t>(w[r] < a.W ? w[r] : 0) * a.d;
  }

  TileStream<T> ts{a, reinterpret_cast<T*>(smem), 0, 0, 0};
  ts.start();
  T total[R];
#pragma unroll
  for (int r = 0; r < R; ++r) total[r] = T(0);
  for (int i = 0; i < a.n_terms; ++i) {
    T acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = T(0);
    if constexpr (TC == TWIN_ANY) term_any<T, R>(ts, i, row, sub, acc);
    else term_twin<T, R, TC>(ts, i, row, sub, acc);
    for (int o = 1; o < S; o <<= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) total[r] += finish_likelihood(a.t[i].kind, acc[r]);
  }
  if (sub != 0) return;

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (w[r] >= a.W) continue;
    const T* rw = row[r];
    T prior = T(0);
    for (int e = 0; e < a.bounds.n; ++e)
      prior += bound_penalty(rw[a.bounds.col[e]], a.bounds.lo[e], a.bounds.hi[e]);
    if (a.cons.n > 0)
      prior += constraint_total(a.cons.n, a.cons.idx, a.cons.val, [&](int c) { return rw[c]; });
    if (a.dens.n > 0)
      prior += density_total(a.dens.n, a.dens.idx, a.dens.val, [&](int c) { return rw[c]; });
    a.out[w[r]] = (total[r] + prior) + cst;
  }
}

// ---- the kernel table and the launch plan

using KernelPtr = const void*;

template <typename T, int R, int... TC>
void fill_row(KernelPtr* row, std::integer_sequence<int, TC...>) {
  ((row[TC] = reinterpret_cast<KernelPtr>(&fused_posterior_kernel<T, R, TC>)), ...);
}

struct KernelTable {
  KernelPtr k[2][3][N_CLASSES];  // [dtype][R = 1, 2, 4][class]; TWIN_ANY only at R = 1
};

KernelTable make_table() {
  KernelTable t{};
  fill_row<float, 1>(t.k[0][0], std::make_integer_sequence<int, N_CLASSES>());
  fill_row<float, 2>(t.k[0][1], std::make_integer_sequence<int, TWIN_ANY>());
  fill_row<float, 4>(t.k[0][2], std::make_integer_sequence<int, TWIN_ANY>());
  fill_row<double, 1>(t.k[1][0], std::make_integer_sequence<int, N_CLASSES>());
  fill_row<double, 2>(t.k[1][1], std::make_integer_sequence<int, TWIN_ANY>());
  fill_row<double, 4>(t.k[1][2], std::make_integer_sequence<int, TWIN_ANY>());
  return t;
}

// The kernel of (dtype, R, class), or null where there is none.
KernelPtr kernel_for(int dtype, int R, int tc) {
  static const KernelTable table = make_table();
  const int ri = R == 1 ? 0 : R == 2 ? 1 : R == 4 ? 2 : -1;
  if (dtype < 0 || dtype > 1 || ri < 0 || tc < 0 || tc >= N_CLASSES) return nullptr;
  return table.k[dtype][ri][tc];
}

// The twin class of a launch from the host metadata (make_terms' rows):
// the terms' common twin, the polynomial by its largest np, or TWIN_ANY.
int twin_class(int n_terms, const int* meta) {
  int model = meta[0], np = 0;
  for (int i = 0; i < n_terms; ++i) {
    const int* m = meta + i * META_STRIDE;
    if (m[0] != model) return TWIN_ANY;
    np = m[3] > np ? m[3] : np;
  }
  if (model == MODEL_POLYNOMIAL) return np <= 4 ? TWIN_POLY4 : np <= 8 ? TWIN_POLY8 : model;
  return model;
}

// Records a buffer holds and buffers a block uses: the largest term whole
// where it fits one buffer; one buffer when the launch has one tile.
void buffers(int dtype, int n_terms, const int* meta, int* cap, int* nbuf) {
  const int rec_bytes = REC * (dtype == 0 ? 4 : 8);
  const int cap_max = BUF_BYTES / rec_bytes;
  int need = 2;
  for (int i = 0; i < n_terms; ++i) {
    const int* m = meta + i * META_STRIDE;
    const int recs = m[2] * recs_per_point(m[1]);
    need = recs > need ? recs : need;
  }
  *cap = ((need < cap_max ? need : cap_max) + 1) / 2 * 2;  // whole cutoff points
  int tiles = 0;
  for (int i = 0; i < n_terms; ++i) {
    const int* m = meta + i * META_STRIDE;
    const int per = *cap / recs_per_point(m[1]);
    tiles += (m[2] + per - 1) / per;
  }
  *nbuf = tiles > 1 ? 2 : 1;
}

struct Plan {
  int threads, R, S, blocks, blocks_per_sm, sms, smem_bytes, cap, nbuf, twin_class;
};

// The twins whose walker-point is a few flops (line, example_line, the
// polynomial): there the shared load and the per-thread setup weigh
// against the arithmetic, so R pays more and S costs more.
bool light_twin(int tc) {
  return tc == MODEL_LINE || tc == MODEL_EXAMPLE_LINE || tc == MODEL_POLYNOMIAL ||
         tc == TWIN_POLY4 || tc == TWIN_POLY8;
}

// The cost of a plan, in walker-points of the busiest SM at full issue:
// the walkers that SM evaluates (its share of the blocks, rounded up),
// times (1 + L/R + F S/N) for the shared load a walker-point pays at R
// walkers a thread and the S-fold per-thread setup over N points, over
// how well the resident warps keep the schedulers fed: fewer than 4 warps
// a scheduler leave issue slots empty, and fewer than 16 independent
// walker chains (warps x R) a scheduler leave latency showing; a small
// charge for small blocks (each stages the points again).  L, F and the
// feeding terms are fitted to timings of every (block, R, S) on an H100
// (python -m lisp_mcmc_torch.kernel_ab --plans prints them).
double plan_cost(const Plan& p, int n_points) {
  const bool light = light_twin(p.twin_class);
  const double L = light ? 0.7 : 0.1, F = light ? 13.0 : 3.0;
  const double wpb = static_cast<double>(p.threads / p.S * p.R);
  const int per_sm = (p.blocks + p.sms - 1) / p.sms;
  const int resident = per_sm < p.blocks_per_sm ? per_sm : p.blocks_per_sm;
  const double warps = resident * (p.threads / 32.0) / 4.0;    // a scheduler
  const double chains = warps * p.R;
  const double fed = (warps < 4.0 ? warps / 4.0 : 1.0) *
                     (chains < 16.0 ? 1.0 - 0.045 * log2(16.0 / chains) : 1.0);
  const double n = n_points > 0 ? n_points : 1;
  return per_sm * wpb * (1.0 + L / p.R + F * p.S / n) / fed * (1.0 + 2.56 / p.threads);
}

}  // namespace lmt

namespace {

template <typename T>
cudaError_t launch(const lmt::Plan& p, const void* pos, int W, int d, int n_terms,
                   const int* meta, const void* const* recs, const int* bcol,
                   const void* blo, const void* bhi, int nb, const int* cidx,
                   const void* cval, int nc, const int* didx, const void* dval, int nd,
                   const void* cst, void* out, cudaStream_t s) {
  using namespace lmt;
  FusedArgs<T> a{};
  a.pos = static_cast<const T*>(pos);
  a.out = static_cast<T*>(out);
  a.cst = static_cast<const T*>(cst);
  a.W = W;
  a.d = d;
  a.S = p.S;
  a.cap = p.cap;
  a.n_terms = n_terms;
  for (int i = 0; i < n_terms; ++i) {
    const int* m = meta + i * META_STRIDE;
    PackedTerm<T>& t = a.t[i];
    t.rec = static_cast<const T*>(recs[i]);
    t.model = m[0]; t.kind = m[1]; t.n = m[2]; t.np = m[3];
    for (int k = 0; k < MAX_NP; ++k) t.pidx[k] = m[4 + k];
  }
  a.bounds = Bounds<T>{bcol, static_cast<const T*>(blo), static_cast<const T*>(bhi), nb};
  a.cons = Constraints<T>{cidx, static_cast<const T*>(cval), nc};
  a.dens = Densities<T>{didx, static_cast<const T*>(dval), nd};
  const void* k = kernel_for(sizeof(T) == 4 ? 0 : 1, p.R, p.twin_class);
  if (k == nullptr) return cudaErrorInvalidValue;
  void* args[] = {&a};
  return cudaLaunchKernel(k, dim3(p.blocks), dim3(p.threads), args,
                          static_cast<size_t>(p.smem_bytes), s);
}

int plan_for(int dtype, int W, int n_terms, const int* meta, int threads_f, int R_f,
             int S_f, int r_mask, lmt::Plan* out) {
  using namespace lmt;
  if (dtype < 0 || dtype > 1 || W < 1 || n_terms < 1 || n_terms > MAX_TERMS)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  Plan base{};
  base.sms = sms;
  base.twin_class = twin_class(n_terms, meta);
  buffers(dtype, n_terms, meta, &base.cap, &base.nbuf);
  base.smem_bytes = base.nbuf * base.cap * REC * (dtype == 0 ? 4 : 8);
  int n_points = 0;
  for (int i = 0; i < n_terms; ++i) n_points += meta[i * META_STRIDE + 2];
  const int threads_c[] = {64, 128, 256};
  const int rs_c[] = {1, 2, 4};
  Plan cand[27];
  double cost[27];
  int n = 0;
  for (int threads : threads_c) {
    if (threads_f > 0 && threads != threads_f) continue;
    for (int ri = 0; ri < 3; ++ri) {
      const int R = rs_c[ri];
      if (R_f > 0 ? R != R_f : !(r_mask >> ri & 1)) continue;
      if (base.twin_class == TWIN_ANY && R != 1) continue;
      for (int S : rs_c) {
        if (S_f > 0 && S != S_f) continue;
        Plan p = base;
        p.threads = threads;
        p.R = R;
        p.S = S;
        const long long wpb = threads / S * R;
        p.blocks = static_cast<int>((W + wpb - 1) / wpb);
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &p.blocks_per_sm, kernel_for(dtype, R, p.twin_class), threads, p.smem_bytes);
        if (e != cudaSuccess) return e;
        if (p.blocks_per_sm < 1) continue;
        cand[n] = p;
        cost[n++] = plan_cost(p, n_points);
      }
    }
  }
  if (n == 0) return cudaErrorInvalidConfiguration;
  // Of the plans within 3 % of the cheapest (closer than the model can
  // tell apart), the one that keeps the most warps resident: it hides
  // latency the model does not see.
  double best = cost[0];
  for (int k = 1; k < n; ++k) best = cost[k] < best ? cost[k] : best;
  int pick = -1, pick_warps = 0;
  for (int k = 0; k < n; ++k) {
    if (cost[k] > best * 1.03) continue;
    const int per_sm = (cand[k].blocks + sms - 1) / sms;
    const int warps = (per_sm < cand[k].blocks_per_sm ? per_sm : cand[k].blocks_per_sm) *
                      cand[k].threads / 32;
    if (pick < 0 || warps > pick_warps || (warps == pick_warps && cost[k] < cost[pick])) {
      pick = k;
      pick_warps = warps;
    }
  }
  *out = cand[pick];
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  meta: n_terms host rows of models.cuh's
// make_terms ((model, kind, n, np, pidx[MAX_NP]) each).  threads, R, S: 0
// lets the plan choose, else it takes that value (and fails if no such
// plan exists).  r_mask: the R the plan may choose (bit 0: 1, bit 1: 2,
// bit 2: 4; a forced R ignores it).  out: threads, R, S, blocks,
// blocks_per_sm, sms, smem_bytes, cap, nbuf, twin_class.  Returns a
// cudaError_t.
extern "C" int lmt_fused_plan(int dtype, int W, int n_terms, const int* meta, int threads,
                              int R, int S, int r_mask, int* out) {
  lmt::Plan p{};
  const int code = plan_for(dtype, W, n_terms, meta, threads, R, S, r_mask, &p);
  if (code != 0) return code;
  const int v[] = {p.threads, p.R, p.S, p.blocks, p.blocks_per_sm, p.sms,
                   p.smem_bytes, p.cap, p.nbuf, p.twin_class};
  for (int k = 0; k < 10; ++k) out[k] = v[k];
  return 0;
}

// plan: the 10 values lmt_fused_plan gave for this dtype, W and terms.
// recs: n_terms device pointers to the packed records; bcol, blo, bhi the
// nb bounds entries, cidx, cval the nc declared constraints
// (models.cuh: Constraints), didx, dval the nd declared densities
// (models.cuh: Densities), cst the scalar constant (one value), all on
// the device.  Returns the cudaError_t of the launch.
extern "C" int lmt_fused_posterior(int dtype, const int* plan, const void* pos, int W,
                                   int d, int n_terms, const int* meta,
                                   const void* const* recs, const int* bcol,
                                   const void* blo, const void* bhi, int nb,
                                   const int* cidx, const void* cval, int nc,
                                   const int* didx, const void* dval, int nd,
                                   const void* cst, void* out, void* stream) {
  lmt::Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6], plan[7],
              plan[8], plan[9]};
  const long long wpb = p.S > 0 ? static_cast<long long>(p.threads / p.S) * p.R : 0;
  if (n_terms < 1 || n_terms > lmt::MAX_TERMS || wpb < 1 || p.threads > lmt::MAX_BLOCK ||
      p.threads % 32 != 0 || (p.S != 1 && p.S != 2 && p.S != 4) ||
      static_cast<long long>(p.blocks) * wpb < W || p.twin_class != lmt::twin_class(n_terms, meta))
    return cudaErrorInvalidValue;
  int cap = 0, nbuf = 0;
  lmt::buffers(dtype, n_terms, meta, &cap, &nbuf);
  if (cap != p.cap || nbuf != p.nbuf || p.smem_bytes != nbuf * cap * lmt::REC * (dtype == 0 ? 4 : 8))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(p, pos, W, d, n_terms, meta, recs, bcol, blo, bhi, nb, cidx, cval,
                         nc, didx, dval, nd, cst, out, s);
  if (dtype == 1)
    return launch<double>(p, pos, W, d, n_terms, meta, recs, bcol, blo, bhi, nb, cidx, cval,
                          nc, didx, dval, nd, cst, out, s);
  return cudaErrorInvalidValue;
}
