// Gossip combine driven by a source table across ranks, through peer
// pointers: the multi-rank form of csrc/table_combine.cu, as
// csrc/ring_peer.cu is csrc/ring_combine.cu's.  Each rank holds one agent's
// f32 payload (1, rows, 128) and computes
//
//     out = Σₖ wₖ · payload[srcₖ]        k = 0 … K−1
//
// in the source table's term order, where srcₖ is any rank of the round on
// this host (their payloads mapped once through CUDA IPC handles).  A late
// slot of the overlap pipeline and a masked-out term of a churn round are
// table entries that point at the rank itself; a weight-0 pad slot too.
//
// Replaces, with per-rank sources, the Pallas TPU kernel
// repro/kernels/edm_update.py::_axpy_kernel where the JAX package reaches
// it across devices with one weight column per agent: the masked B = 1
// branch of mix_ppermute and the overlap pipeline's complete over the
// K-stack of permuted payloads (repro/core/mixing.py, make_overlap_mixer),
// late slots swapped for the self payload before the combine.  There every
// term's payload is first shipped by a collective-permute; here the
// sources' payloads are read where they lie.
//
// Synchronisation (the host side, kernels/table_peer.py, drives it): each
// rank's shared allocation holds two payload slots, then a READY and a DONE
// epoch flag and an error word.  Epoch e's payload goes into slot e mod 2;
// before writing it the owner waits until every rank that read the slot's
// previous payload (epoch e − 2) has DONE ≥ e − 2, then signals READY = e.
// A reader waits for READY ≥ e of the sources it reads (never of a late
// source, which it does not read), runs this combine, and signals DONE = e.
// The waits and signals are one-thread kernels (a combine block never
// spins: ranks sharing one card run in contexts the card time-slices),
// each wait bounded by the global timer: past its timeout it stores
// 1 + the index of the flag it waited on into the error word, which the
// host reads after the step and raises on.
//
// The combine: the distinct sources' payloads (at most kMaxSrc) are loaded
// once per float4 column into registers and each term picks its operand
// from them (static indices: no stack; the register slots are a template
// argument sized to the round, 2, 4, 8 or 16); one thread a column, a
// grid-stride loop, the grid sized by the occupancy calculator; loads and
// stores stream (evict-first).  Element indices are 64-bit.
//
// Rounding: terms in table order from w₀·o₀, every product and sum an
// explicitly rounded intrinsic (no FMA contraction) — the sequence of
// table_combine.cu, gossip_axpy.cu, ring_peer.cu and the plain version, so
// a multi-rank run is bit-equal to the one-process run; a weight-0 slot is
// a real term (0·Inf is NaN), NaN and ±Inf propagate as in the plain sum.
//
// Bound on an H100: device-memory bytes — each distinct source payload
// read once and the output written once (4 B an element each), against
// 2K − 1 flops an element.
//
// The block form (table_peer_block_launch): each rank holds B agents, a
// (B, rows, 128) payload of f32 or bf16, and computes
//
//     out[b] = Σₖ w[k, b] · block[src[k, b]]      b = 0 … B−1
//
// with per-agent (K, B) tables whose entries are (rank, agent) blocks of
// the round's ranks — csrc/table_combine.cu's per-agent table over peer
// pointers, and with bf16 sources the bf16 wire's decode-combine
// (csrc/gossip_axpy.cu's bf16 → f32 path: the widening is exact, the sum
// f32).  One thread a column loads the column of every distinct source
// block once into registers and writes every agent's output column from
// them, so each source block is read once however many of the rank's
// agents read it; the output is f32, agent b's block b · out_stride
// elements in (a policy group's rows of a larger bus).  An f32 payload of
// one agent takes the kernel above, unchanged.  Bound: each distinct
// source block read once (4 or 2 B an element), B blocks written (4 B).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSrc = 16;
constexpr int kMaxTerms = 16;
constexpr int kMaxBlock = 8;   // agents a rank (the block form)
constexpr int kThreads = 256;

struct Sources {
  const float4* p[kMaxSrc];
};

struct Terms {
  int u[kMaxTerms];  // index into Sources
  float w[kMaxTerms];
};

struct Flags {
  const unsigned* f[kMaxSrc];
};

template <int N>
__device__ __forceinline__ float4 pick(const float4 (&v)[N], int u) {
  float4 r = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i)
    if (u == i) r = v[i];
  return r;
}

__device__ __forceinline__ float4 scale4(float w, const float4& v) {
  return make_float4(__fmul_rn(w, v.x), __fmul_rn(w, v.y),
                     __fmul_rn(w, v.z), __fmul_rn(w, v.w));
}

__device__ __forceinline__ float4 axpy4(const float4& acc, float w,
                                        const float4& v) {
  return make_float4(__fadd_rn(acc.x, __fmul_rn(w, v.x)),
                     __fadd_rn(acc.y, __fmul_rn(w, v.y)),
                     __fadd_rn(acc.z, __fmul_rn(w, v.z)),
                     __fadd_rn(acc.w, __fmul_rn(w, v.w)));
}

// N: the register slots for the distinct sources (≥ n_src; the launch
// picks the smallest of 2, 4, 8, 16, so that a round reading three
// payloads keeps the registers — and the occupancy — of csrc/ring_peer.cu)
template <int N>
__global__ void table_peer_kernel(Sources srcs, int n_src,
                                  float4* __restrict__ out, Terms terms,
                                  int n_terms, long long n4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < n4; j += stride) {
    float4 v[N];
#pragma unroll
    for (int i = 0; i < N; ++i)
      v[i] = i < n_src ? __ldcs(srcs.p[i] + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 acc = scale4(terms.w[0], pick(v, terms.u[0]));
#pragma unroll
    for (int k = 1; k < kMaxTerms; ++k) {   // static indices: no stack
      if (k < n_terms) acc = axpy4(acc, terms.w[k], pick(v, terms.u[k]));
    }
    __stcs(out + j, acc);
  }
}

template <int N>
cudaError_t launch_n(const Sources& s, int n_src, float4* out,
                     const Terms& terms, int n_terms, long long n4,
                     cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, table_peer_kernel<N>, kThreads, 0);
  if (err != cudaSuccess) return err;
  long long blocks = (n4 + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > cap) blocks = cap;
  table_peer_kernel<N><<<(unsigned)blocks, kThreads, 0, stream>>>(
      s, n_src, out, terms, n_terms, n4);
  return cudaGetLastError();
}

// The block form's sources (distinct (rank, agent) blocks) and tables:
// term k of agent b reads block u[b][k] under weight w[b][k].
struct BlockSources {
  const void* p[kMaxSrc];
};

struct BlockTerms {
  int u[kMaxBlock][kMaxTerms];
  float w[kMaxBlock][kMaxTerms];
};

// Four consecutive elements (column j) of a source block, as f32 (exact).
__device__ __forceinline__ float4 load4(const float* p, long long j) {
  return __ldcs(reinterpret_cast<const float4*>(p) + j);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, long long j) {
  const uint2 t = __ldcs(reinterpret_cast<const uint2*>(p) + j);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T, int N>
__global__ void table_peer_kernel_blk(BlockSources srcs, int n_src,
                                      float* __restrict__ out,
                                      long long out_stride, BlockTerms terms,
                                      int n_terms, int n_agents,
                                      long long n4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < n4; j += stride) {
    float4 v[N];
#pragma unroll
    for (int i = 0; i < N; ++i)
      v[i] = i < n_src ? load4(static_cast<const T*>(srcs.p[i]), j)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int b = 0; b < kMaxBlock; ++b) {
      if (b < n_agents) {
        float4 acc = scale4(terms.w[b][0], pick(v, terms.u[b][0]));
#pragma unroll
        for (int k = 1; k < kMaxTerms; ++k) {
          if (k < n_terms)
            acc = axpy4(acc, terms.w[b][k], pick(v, terms.u[b][k]));
        }
        __stcs(reinterpret_cast<float4*>(out + b * out_stride) + j, acc);
      }
    }
  }
}

template <typename T, int N>
cudaError_t launch_blk(const BlockSources& s, int n_src, float* out,
                       long long out_stride, const BlockTerms& terms,
                       int n_terms, int n_agents, long long n4,
                       cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, table_peer_kernel_blk<T, N>, kThreads, 0);
  if (err != cudaSuccess) return err;
  long long blocks = (n4 + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > cap) blocks = cap;
  table_peer_kernel_blk<T, N><<<(unsigned)blocks, kThreads, 0, stream>>>(
      s, n_src, out, out_stride, terms, n_terms, n_agents, n4);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_blk_t(const BlockSources& s, int n_src, float* out,
                         long long out_stride, const BlockTerms& terms,
                         int n_terms, int n_agents, long long n4,
                         cudaStream_t st) {
  if (n_src <= 2)
    return launch_blk<T, 2>(s, n_src, out, out_stride, terms, n_terms,
                            n_agents, n4, st);
  if (n_src <= 4)
    return launch_blk<T, 4>(s, n_src, out, out_stride, terms, n_terms,
                            n_agents, n4, st);
  if (n_src <= 8)
    return launch_blk<T, 8>(s, n_src, out, out_stride, terms, n_terms,
                            n_agents, n4, st);
  return launch_blk<T, 16>(s, n_src, out, out_stride, terms, n_terms,
                           n_agents, n4, st);
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One thread: wait until every flag f[i] ≥ target (i < n), or set *err to
// 1 + i of the first flag still short when timeout_ns has passed.
__global__ void table_peer_wait_kernel(Flags flags, int n, unsigned target,
                                       int* err,
                                       unsigned long long timeout_ns) {
  const unsigned long long t0 = global_ns();
  for (int i = 0; i < n; ++i) {
    while (load_acquire(flags.f[i]) < target) {
      if (global_ns() - t0 > timeout_ns) {
        if (*err == 0) *err = 1 + i;
        __threadfence_system();
        return;
      }
      __nanosleep(1000);
    }
  }
}

// One thread: publish `value` after everything before it in the stream.
__global__ void table_peer_signal_kernel(unsigned* flag, unsigned value) {
  __threadfence_system();
  store_release(flag, value);
}

}  // namespace

// srcs: n_src distinct payloads (n4 float4 each; any may be a peer pointer,
// none aliasing out); u / weights: n_terms terms, u[k] the index of term
// k's payload in srcs.  Launches on `stream`, returns cudaGetLastError().
extern "C" int table_peer_launch(const void* const* srcs, int n_src,
                                 void* out, const int* u,
                                 const float* weights, int n_terms,
                                 long long n4, void* stream) {
  if (n_src < 1 || n_src > kMaxSrc || n_terms < 1 || n_terms > kMaxTerms ||
      n4 < 0)
    return (int)cudaErrorInvalidValue;
  if (n4 == 0) return (int)cudaSuccess;
  Sources s = {};
  for (int i = 0; i < n_src; ++i) s.p[i] = static_cast<const float4*>(srcs[i]);
  Terms terms = {};
  for (int k = 0; k < n_terms; ++k) {
    if (u[k] < 0 || u[k] >= n_src) return (int)cudaErrorInvalidValue;
    terms.u[k] = u[k];
    terms.w[k] = weights[k];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* o = static_cast<float4*>(out);
  if (n_src <= 2) return (int)launch_n<2>(s, n_src, o, terms, n_terms, n4, st);
  if (n_src <= 4) return (int)launch_n<4>(s, n_src, o, terms, n_terms, n4, st);
  if (n_src <= 8) return (int)launch_n<8>(s, n_src, o, terms, n_terms, n4, st);
  return (int)launch_n<16>(s, n_src, o, terms, n_terms, n4, st);
}

// The block form: srcs are n_src distinct (rank, agent) source blocks of
// n elements each (f32 when dtype is 0, bf16 when 1; any may be a peer
// pointer, none aliasing out); u / weights are n_agents × n_terms,
// agent-major: term k of agent b reads srcs[u[b·n_terms + k]].  out: f32,
// agent b's n elements from b · out_stride.  One f32 agent takes
// table_peer_launch's kernel.  Launches on `stream`, returns
// cudaGetLastError().
extern "C" int table_peer_block_launch(const void* const* srcs, int n_src,
                                       void* out, long long out_stride,
                                       const int* u, const float* weights,
                                       int n_terms, int n_agents,
                                       long long n, int dtype, void* stream) {
  if (n_src < 1 || n_src > kMaxSrc || n_terms < 1 || n_terms > kMaxTerms ||
      n_agents < 1 || n_agents > kMaxBlock || n < 0 || n % 4 ||
      (dtype != 0 && dtype != 1) ||
      (n_agents > 1 && (out_stride < n || out_stride % 4)))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_agents * n_terms; ++i)
    if (u[i] < 0 || u[i] >= n_src) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  if (dtype == 0 && n_agents == 1)
    return table_peer_launch(srcs, n_src, out, u, weights, n_terms, n / 4,
                             stream);
  BlockSources s = {};
  for (int i = 0; i < n_src; ++i) s.p[i] = srcs[i];
  BlockTerms terms = {};
  for (int b = 0; b < n_agents; ++b)
    for (int k = 0; k < n_terms; ++k) {
      terms.u[b][k] = u[b * n_terms + k];
      terms.w[b][k] = weights[b * n_terms + k];
    }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    return (int)launch_blk_t<float>(s, n_src, o, out_stride, terms, n_terms,
                                    n_agents, n / 4, st);
  return (int)launch_blk_t<__nv_bfloat16>(s, n_src, o, out_stride, terms,
                                          n_terms, n_agents, n / 4, st);
}

// Wait (one thread, on `stream`) until each of the n flags ≥ target; on a
// timeout store 1 + the flag's index into *err.
extern "C" int table_peer_wait_launch(const void* const* flags, int n,
                                      unsigned target, void* err,
                                      unsigned long long timeout_ns,
                                      void* stream) {
  if (n < 0 || n > kMaxSrc) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Flags f = {};
  for (int i = 0; i < n; ++i) f.f[i] = static_cast<const unsigned*>(flags[i]);
  table_peer_wait_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      f, n, target, static_cast<int*>(err), timeout_ns);
  return (int)cudaGetLastError();
}

extern "C" int table_peer_signal_launch(void* flag, unsigned value,
                                        void* stream) {
  table_peer_signal_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(flag), value);
  return (int)cudaGetLastError();
}

// The shared allocation of one rank: `bytes` of device memory (the payload
// slots, then the flags), zeroed, and its IPC handle in `handle`.
extern "C" int table_peer_alloc(unsigned long long bytes, void** ptr,
                                void* handle) {
  cudaError_t err = cudaMalloc(ptr, bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemset(*ptr, 0, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaIpcMemHandle_t h;
  err = cudaIpcGetMemHandle(&h, *ptr);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < (int)sizeof(h); ++i)
    static_cast<char*>(handle)[i] = h.reserved[i];
  return (int)cudaSuccess;
}

// Open another rank's allocation from its handle (peer access enabled on
// first use when it lies on another card).
extern "C" int table_peer_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  for (int i = 0; i < (int)sizeof(h); ++i)
    h.reserved[i] = static_cast<const char*>(handle)[i];
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int table_peer_close(void* ptr) {
  return (int)cudaIpcCloseMemHandle(ptr);
}

extern "C" int table_peer_free(void* ptr) { return (int)cudaFree(ptr); }

extern "C" int table_peer_handle_bytes() {
  return (int)sizeof(cudaIpcMemHandle_t);
}
