// Per-op issue-rate probe: P independent chains of one op, U-unrolled, K times.
//
// Replaces the TPU kernel built in benchmarks/roofline.py:70-93
// (microbench_ceilings, pl.pallas_call at :87).  For each element i of x,
// P = 4 chains start at x[i] + j*1e-6 (j = 0..3); each outer iteration
// applies the op U times to every chain; after K iterations out[i] is the
// sum of the chains.  The five ops of roofline.py:100-104, and one more:
//
//   fma  x * 1.0000001 + 1e-7   (one FFMA / DFMA, counted as 2 flops)
//   div  1.0001 / (x + 1e-6)    (an IEEE division: reciprocal + Newton steps)
//   cos  cos(x)
//   exp  exp(x * 1e-6)
//   log  log(x + 1)
//   add  x + 1e-6               (one FADD / DADD: the add or multiply that
//                                the div, exp and log probes apply besides
//                                their op, timed alone so it can be taken out)
//
// U is 8, as in the JAX probe, except for fma, whose body is one issue slot
// per application: at U = 8 the loop's add, compare and branch would take 3
// of every 35 slots; at U = 32 they take 3 of 131.
//
// What bounds it on an H100: the issue rate of the op's instruction class
// on the SMs.  Each thread touches device memory once (x[i] in, out[i]
// out); everything else lives in registers.  The chains are independent so
// that each SM sub-partition always has P ready instructions per thread:
// one serial chain would wait out the op's latency at every step and
// measure latency, not throughput.  Every constant is written T(...) so a
// float chain is never promoted to double; K is a runtime argument under
// `#pragma unroll 1` and out[i] depends on every chain, so the compiler can
// neither fold the loop nor drop a chain.  The library is built with the
// same flags as the posterior kernels (no fast math), so div, cos, exp and
// log here are the IEEE/accurate sequences those kernels execute.
//
// With a non-null clk, thread 0 of block 0 writes the SM cycles and the
// nanoseconds its own run took: their ratio is the SM clock under the load.
#include "models.cuh"

namespace lmt {

enum { OP_FMA = 0, OP_DIV = 1, OP_COS = 2, OP_EXP = 3, OP_LOG = 4, OP_ADD = 5 };
constexpr int CHAINS = 4;       // P
constexpr int UNROLL = 8;       // U of every op but fma
constexpr int UNROLL_FMA = 32;  // U of fma
constexpr int PROBE_THREADS = 256;

template <typename T, int OP> struct ProbeOp;
template <typename T> struct ProbeOp<T, OP_FMA> {
  __device__ __forceinline__ static T apply(T x) { return x * T(1.0000001) + T(1e-7); }
};
template <typename T> struct ProbeOp<T, OP_DIV> {
  __device__ __forceinline__ static T apply(T x) { return T(1.0001) / (x + T(1e-6)); }
};
template <typename T> struct ProbeOp<T, OP_COS> {
  __device__ __forceinline__ static T apply(T x) { return d_cos(x); }
};
template <typename T> struct ProbeOp<T, OP_EXP> {
  __device__ __forceinline__ static T apply(T x) { return d_exp(x * T(1e-6)); }
};
template <typename T> struct ProbeOp<T, OP_LOG> {
  __device__ __forceinline__ static T apply(T x) { return d_log(x + T(1)); }
};
template <typename T> struct ProbeOp<T, OP_ADD> {
  __device__ __forceinline__ static T apply(T x) { return x + T(1e-6); }
};

// Timer reads with a memory clobber: the load of x[i] stays after the
// first, the store of out[i] before the second.
__device__ __forceinline__ long long sm_cycles() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}

template <typename T, int OP>
__global__ void __launch_bounds__(PROBE_THREADS)
chain_kernel(const T* __restrict__ x, T* __restrict__ out, int n, int K,
             long long* __restrict__ clk) {
  constexpr int U = OP == OP_FMA ? UNROLL_FMA : UNROLL;
  const int i = blockIdx.x * PROBE_THREADS + threadIdx.x;
  if (i >= n) return;
  const bool timer = clk != nullptr && i == 0;
  long long c0 = 0, g0 = 0;
  if (timer) {
    c0 = sm_cycles();
    g0 = global_ns();
  }
  const T xi = x[i];
  T c[CHAINS];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) c[j] = xi + T(j * 1e-6);
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < CHAINS; ++j) c[j] = ProbeOp<T, OP>::apply(c[j]);
    }
  }
  T s = c[0];
#pragma unroll
  for (int j = 1; j < CHAINS; ++j) s = s + c[j];
  out[i] = s;
  if (timer) {
    clk[0] = sm_cycles() - c0;
    clk[1] = global_ns() - g0;
  }
}

template <typename T>
cudaError_t dispatch(int op, const void* x, void* out, int n, int K,
                     long long* clk, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  const int blocks = (n + PROBE_THREADS - 1) / PROBE_THREADS;
  switch (op) {
    case OP_FMA: chain_kernel<T, OP_FMA><<<blocks, PROBE_THREADS, 0, s>>>(xp, o, n, K, clk); break;
    case OP_DIV: chain_kernel<T, OP_DIV><<<blocks, PROBE_THREADS, 0, s>>>(xp, o, n, K, clk); break;
    case OP_COS: chain_kernel<T, OP_COS><<<blocks, PROBE_THREADS, 0, s>>>(xp, o, n, K, clk); break;
    case OP_EXP: chain_kernel<T, OP_EXP><<<blocks, PROBE_THREADS, 0, s>>>(xp, o, n, K, clk); break;
    case OP_LOG: chain_kernel<T, OP_LOG><<<blocks, PROBE_THREADS, 0, s>>>(xp, o, n, K, clk); break;
    case OP_ADD: chain_kernel<T, OP_ADD><<<blocks, PROBE_THREADS, 0, s>>>(xp, o, n, K, clk); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace lmt

// dtype: 0 = float32, 1 = float64; op: OP_* above; n >= 1, K >= 0; clk:
// null, or two int64 on the device for block 0's cycles and nanoseconds.
// Returns the cudaError_t of the launch.
extern "C" int lmt_chain_probe(int dtype, int op, const void* x, void* out,
                               int n, int K, long long* clk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || K < 0) return cudaErrorInvalidValue;
  if (dtype == 0) return lmt::dispatch<float>(op, x, out, n, K, clk, s);
  if (dtype == 1) return lmt::dispatch<double>(op, x, out, n, K, clk, s);
  return cudaErrorInvalidValue;
}
