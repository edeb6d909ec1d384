// Gossip combine driven by a source table, over the A agents of one card:
//
//     out[a] = Σₖ w[k, a] · x[src[k, a]]        k = 0 … K−1, a = 0 … A−1
//
// where x and out are (A, n) — the agent-stacked bus or a parameter leaf,
// agent a's n elements a contiguous row block — and src (int32) and w
// (f32) are (K, A) tables in device memory.  Agent a's block starts
// a · x_stride elements into x and a · out_stride into out: a policy
// group's rows bus[:, r0:r1, :] of a larger bus are read and written in
// place (DESIGN §12); a dense tensor passes n for both.
//
// Replaces, with per-agent sources and weights, the Pallas TPU kernel
// repro/kernels/edm_update.py::_axpy_kernel where the JAX package reaches it
// with one weight per agent: a liveness-masked round at one agent per device
// (repro/core/mixing.py, the masked B = 1 branch of mix_ppermute) and the
// overlap pipeline's complete over a K-stack of payloads, with late slots
// swapped for the self payload (make_overlap_mixer).  With several agents on
// a device the JAX package takes a plain gather instead (masked_gather_mix).
// On one card every agent's payload is a row block of one buffer, so the
// permuted copies and the (K, A, n) stack of the TPU path are never made:
// term k of agent a reads row block src[k, a] in place.  A masked round, a
// late slot (its source set to the agent itself, its weight kept) and a
// weight-0 pad slot are all just table entries.
//
// The tables are device data, read at every launch, so a captured CUDA graph
// replays with new tables written into the same buffers before the replay
// (the LR scale of the graphed train step travels the same way).  Each block
// copies them into shared memory once.
//
// Design: one thread owns a column — four consecutive elements of every
// agent's row block (one element where n or a stride is not a multiple of
// four, since the row blocks are then not 16-byte aligned) — and walks the
// agents.  For A ≤ kRegAgents the whole column of every agent is loaded into
// registers first, so each source row is read once per column however many
// terms and agents read it, and the terms pick their operand from registers.
// Larger A reads each term's operand from memory (repeated rows then hit L1).
// Each output element is written once.  A grid-stride loop over the columns,
// the grid sized by the occupancy calculator so every block is resident at
// once.
//
// Bound on an H100: device-memory bytes — each x element read once and each
// out element written once (2 × 4 B per element in f32) against 2K − 1
// flops per output element.
//
// Rounding: terms in slot order k = 0 … K−1, from w₀·o₀, every product and
// sum an explicitly rounded intrinsic (no FMA contraction), one rounding to
// the output dtype on store — the sequence of csrc/gossip_axpy.cu and of the
// plain version, so the three agree bit for bit.  A weight-0 slot is a real
// term: 0·x is computed, so an Inf or NaN it reads and the sign of a zero
// come out as in the plain version's stack-and-combine.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTerms = 16;
constexpr int kMaxAgents = 1024;
constexpr int kRegAgents = 8;
constexpr int kThreads = 256;

template <int V>
struct Vec {
  float v[V];
};

__device__ __forceinline__ void load(const float* p, long long i,
                                     Vec<4>& out) {
  const float4 t = reinterpret_cast<const float4*>(p)[i];
  out.v[0] = t.x;
  out.v[1] = t.y;
  out.v[2] = t.z;
  out.v[3] = t.w;
}

__device__ __forceinline__ void load(const __nv_bfloat16* p, long long i,
                                     Vec<4>& out) {
  const uint2 t = reinterpret_cast<const uint2*>(p)[i];
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  out.v[0] = a.x;
  out.v[1] = a.y;
  out.v[2] = b.x;
  out.v[3] = b.y;
}

__device__ __forceinline__ void load(const float* p, long long i,
                                     Vec<1>& out) {
  out.v[0] = p[i];
}

__device__ __forceinline__ void load(const __nv_bfloat16* p, long long i,
                                     Vec<1>& out) {
  out.v[0] = __bfloat162float(p[i]);
}

__device__ __forceinline__ void store(float* p, long long i, const Vec<4>& a) {
  reinterpret_cast<float4*>(p)[i] = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
}

__device__ __forceinline__ void store(__nv_bfloat16* p, long long i,
                                      const Vec<4>& a) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a.v[0], a.v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(a.v[2], a.v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&lo);
  t.y = *reinterpret_cast<const uint32_t*>(&hi);
  reinterpret_cast<uint2*>(p)[i] = t;
}

__device__ __forceinline__ void store(float* p, long long i, const Vec<1>& a) {
  p[i] = a.v[0];
}

__device__ __forceinline__ void store(__nv_bfloat16* p, long long i,
                                      const Vec<1>& a) {
  p[i] = __float2bfloat16_rn(a.v[0]);
}

template <int V>
__device__ __forceinline__ void first_term(Vec<V>& acc, float w,
                                           const Vec<V>& o) {
#pragma unroll
  for (int e = 0; e < V; ++e) acc.v[e] = __fmul_rn(w, o.v[e]);
}

template <int V>
__device__ __forceinline__ void add_term(Vec<V>& acc, float w,
                                         const Vec<V>& o) {
#pragma unroll
  for (int e = 0; e < V; ++e) acc.v[e] = __fadd_rn(acc.v[e], __fmul_rn(w, o.v[e]));
}

// The register copy of row s of the column: static indices only, so the
// column stays in registers (a runtime index would spill it to the stack).
template <int V>
__device__ __forceinline__ Vec<V> pick(const Vec<V> (&col)[kRegAgents],
                                       int s) {
  Vec<V> r = col[0];
#pragma unroll
  for (int i = 1; i < kRegAgents; ++i)
    if (s == i) r = col[i];
  return r;
}

// x, out: n_agents row blocks of n elements, block a at a · xs (x) and
// a · os (out) V-element groups; V elements a thread (V = 4 needs n and
// both strides multiples of 4); cols = n / V.  src, w: (n_terms, n_agents)
// tables.  REG: the whole column held in registers (n_agents ≤ kRegAgents).
template <typename In, typename Out, int V, bool REG>
__global__ void table_combine_kernel(const In* __restrict__ x,
                                     Out* __restrict__ out,
                                     const int* __restrict__ src,
                                     const float* __restrict__ w,
                                     int n_terms, int n_agents, long long cols,
                                     long long xs, long long os) {
  extern __shared__ unsigned char smem[];
  const int n_tab = n_terms * n_agents;
  int* s_src = reinterpret_cast<int*>(smem);
  float* s_w = reinterpret_cast<float*>(smem + sizeof(int) * n_tab);
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) {
    s_src[i] = src[i];
    s_w[i] = w[i];
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < cols; j += stride) {
    if (REG) {
      Vec<V> col[kRegAgents];
#pragma unroll
      for (int i = 0; i < kRegAgents; ++i)
        if (i < n_agents) load(x, (long long)i * xs + j, col[i]);
      for (int a = 0; a < n_agents; ++a) {
        Vec<V> acc;
        first_term(acc, s_w[a], pick(col, s_src[a]));
#pragma unroll
        for (int k = 1; k < kMaxTerms; ++k) {   // static indices: no stack
          if (k < n_terms)
            add_term(acc, s_w[k * n_agents + a],
                     pick(col, s_src[k * n_agents + a]));
        }
        store(out, (long long)a * os + j, acc);
      }
    } else {
      for (int a = 0; a < n_agents; ++a) {
        Vec<V> acc, o;
        load(x, (long long)s_src[a] * xs + j, o);
        first_term(acc, s_w[a], o);
#pragma unroll
        for (int k = 1; k < kMaxTerms; ++k) {
          if (k < n_terms) {
            load(x, (long long)s_src[k * n_agents + a] * xs + j, o);
            add_term(acc, s_w[k * n_agents + a], o);
          }
        }
        store(out, (long long)a * os + j, acc);
      }
    }
  }
}

template <typename In, typename Out, int V, bool REG>
cudaError_t launch_v(const void* x, void* out, const int* src, const float* w,
                     int n_terms, int n_agents, long long n, long long xs,
                     long long os, cudaStream_t stream) {
  auto kernel = table_combine_kernel<In, Out, V, REG>;
  const long long cols = n / V;
  const size_t smem = (size_t)n_terms * n_agents * (sizeof(int) + sizeof(float));
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  long long blocks = (cols + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const In*>(x), static_cast<Out*>(out), src, w, n_terms,
      n_agents, cols, xs / V, os / V);
  return cudaGetLastError();
}

template <typename In, typename Out>
cudaError_t launch(const void* x, void* out, const int* src, const float* w,
                   int n_terms, int n_agents, long long n, long long xs,
                   long long os, cudaStream_t stream) {
  const bool reg = n_agents <= kRegAgents;
  if (n % 4 == 0 && xs % 4 == 0 && os % 4 == 0)
    return reg ? launch_v<In, Out, 4, true>(x, out, src, w, n_terms, n_agents,
                                            n, xs, os, stream)
               : launch_v<In, Out, 4, false>(x, out, src, w, n_terms,
                                             n_agents, n, xs, os, stream);
  return reg ? launch_v<In, Out, 1, true>(x, out, src, w, n_terms, n_agents, n,
                                          xs, os, stream)
             : launch_v<In, Out, 1, false>(x, out, src, w, n_terms, n_agents,
                                           n, xs, os, stream);
}

}  // namespace

extern "C" int table_combine_max_terms() { return kMaxTerms; }
extern "C" int table_combine_max_agents() { return kMaxAgents; }

// x: (n_agents, n) of in_dtype, agent a's n elements at a · x_stride;
// out: (n_agents, n) of out_dtype at a · out_stride, aliasing no byte of x
// (the wrapper checks); strides ≥ n (n for a dense tensor); src:
// (n_terms, n_agents) int32 agent indices in [0, n_agents); w: (n_terms,
// n_agents) f32; all device pointers, 16-byte aligned.  dtype codes: 0 =
// float32, 1 = bfloat16.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int table_combine_launch(const void* x, void* out, const int* src,
                                    const float* w, int n_terms, int n_agents,
                                    long long n, long long x_stride,
                                    long long out_stride, int in_dtype,
                                    int out_dtype, void* stream) {
  if (n_terms < 1 || n_terms > kMaxTerms || n_agents < 1 ||
      n_agents > kMaxAgents || x_stride < n || out_stride < n)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const long long xs = x_stride, os = out_stride;
  if (in_dtype == 0 && out_dtype == 0)
    err = launch<float, float>(x, out, src, w, n_terms, n_agents, n, xs, os,
                               s);
  else if (in_dtype == 1 && out_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, out, src, w, n_terms,
                                               n_agents, n, xs, os, s);
  else if (in_dtype == 1 && out_dtype == 0)
    err = launch<__nv_bfloat16, float>(x, out, src, w, n_terms, n_agents, n,
                                       xs, os, s);
  else if (in_dtype == 0 && out_dtype == 1)
    err = launch<float, __nv_bfloat16>(x, out, src, w, n_terms, n_agents, n,
                                       xs, os, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
