// Ring gossip combine across ranks through peer pointers: the multi-rank
// form of csrc/ring_combine.cu.  Each rank holds one agent's f32 payload
// (1, rows, 128) and computes
//
//     out = Σₖ wₖ · x_srcₖ        srcₖ ∈ {self, left (a − 1), right (a + 1)}
//
// in topology term order, reading its neighbours' payloads in place
// through pointers to their memory (CUDA IPC handles, opened once).
//
// Replaces the Pallas TPU kernel repro/kernels/ring_dma.py::_ring_kernel
// (called by ring_combine_shard), in its multi-device form: there each
// device ships its shard to both ring neighbours by remote DMA, behind an
// entry barrier, and acknowledges each landed chunk.  Here the neighbours'
// payloads are read where they lie, so nothing is copied; what the TPU
// kernel's barrier and acks guarantee — that no device reads a shard its
// owner is still writing, and that no owner overwrites a shard a reader is
// still reading — is kept by two monotonic epoch flags per rank in its
// shared allocation, each written with a system-scope release and read
// with a system-scope acquire:
//
//   ready = t + 1   after the owner wrote step t's payload (the EDM update);
//   done  = t + 1   after the rank finished reading its neighbours' step-t
//                   payloads (its combine of step t).
//
// Per step t a rank's stream runs: wait(neighbours' done ≥ t) → the EDM
// update writes its payload → signal(ready = t + 1) → wait(neighbours'
// ready ≥ t + 1) → this combine → signal(done = t + 1).  The waits and
// signals are one-thread kernels of their own, so no block of the combine
// ever spins: ranks that share one card run in separate CUDA contexts,
// which the card time-slices, and a combine block spinning on a flag would
// hold its slice while the writer waits for one.  Every wait is bounded by
// the card's global timer: past its timeout it stores a nonzero error word
// (1 + the flag it waited on) and returns; the wrapper reads the word after
// the step and raises, so a protocol fault fails the step instead of
// hanging the card.  The epochs are host integers passed per launch, so the
// step is eager (a graph capture would bake them in).
//
// The combine: one thread per float4 column, a grid-stride loop, the grid
// sized by the occupancy calculator; loads and stores stream (evict-first).
// Rounding: terms in topology order from w₀·o₀, every product and sum an
// explicitly rounded intrinsic (no FMA contraction) — the sequence of
// ring_combine.cu, gossip_axpy.cu and the plain version, so a multi-rank
// run is bit-equal to the one-process run, NaN and ±Inf included.
//
// Bound on an H100: each rank reads three payloads and writes one, 16 B of
// device memory per element on one card; across NVLink the two remote
// reads at the link's rate.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTerms = 8;
constexpr int kThreads = 256;

struct Terms {
  int src[kMaxTerms];
  float w[kMaxTerms];
};

__device__ __forceinline__ float4 pick(int src, const float4& self,
                                       const float4& left,
                                       const float4& right) {
  return src == 0 ? self : (src == 1 ? left : right);
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

// need: bit 0 the self payload, bit 1 the left, bit 2 the right
__global__ void ring_peer_kernel(const float4* __restrict__ self,
                                 const float4* __restrict__ left,
                                 const float4* __restrict__ right,
                                 float4* __restrict__ out, Terms terms,
                                 int n_terms, int need, long long n4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < n4; j += stride) {
    const float4 s = (need & 1) ? __ldcs(self + j) : zero;
    const float4 l = (need & 2) ? __ldcs(left + j) : zero;
    const float4 r = (need & 4) ? __ldcs(right + j) : zero;
    float4 acc = scale4(terms.w[0], pick(terms.src[0], s, l, r));
#pragma unroll
    for (int k = 1; k < kMaxTerms; ++k) {   // static indices: no stack
      if (k < n_terms) acc = axpy4(acc, terms.w[k], pick(terms.src[k], s, l, r));
    }
    __stcs(out + j, acc);
  }
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
__global__ void flag_wait_kernel(const unsigned* f0, const unsigned* f1,
                                 int n, unsigned target, int* err,
                                 unsigned long long timeout_ns) {
  const unsigned* flags[2] = {f0, f1};
  const unsigned long long t0 = global_ns();
  for (int i = 0; i < n; ++i) {
    while (load_acquire(flags[i]) < target) {
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
__global__ void flag_signal_kernel(unsigned* flag, unsigned value) {
  __threadfence_system();
  store_release(flag, value);
}

}  // namespace

// self / left / right: the three payloads (n4 float4 each; left / right
// may be peer pointers, may coincide with each other, never with out);
// src / weights: n_terms terms, src codes 0 self, 1 left, 2 right.
extern "C" int ring_peer_launch(const void* self, const void* left,
                                const void* right, void* out,
                                const int* src, const float* weights,
                                int n_terms, long long n4, void* stream) {
  if (n_terms < 1 || n_terms > kMaxTerms || n4 < 0)
    return (int)cudaErrorInvalidValue;
  if (n4 == 0) return (int)cudaSuccess;
  Terms terms = {};
  int need = 0;
  for (int k = 0; k < n_terms; ++k) {
    if (src[k] < 0 || src[k] > 2) return (int)cudaErrorInvalidValue;
    terms.src[k] = src[k];
    terms.w[k] = weights[k];
    need |= 1 << src[k];
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ring_peer_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n4 + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > cap) blocks = cap;
  ring_peer_kernel<<<(unsigned)blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(self), static_cast<const float4*>(left),
      static_cast<const float4*>(right), static_cast<float4*>(out), terms,
      n_terms, need, n4);
  return (int)cudaGetLastError();
}

extern "C" int ring_peer_wait_launch(const void* f0, const void* f1, int n,
                                     unsigned target, void* err,
                                     unsigned long long timeout_ns,
                                     void* stream) {
  if (n < 1 || n > 2) return (int)cudaErrorInvalidValue;
  flag_wait_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(f0), static_cast<const unsigned*>(f1), n,
      target, static_cast<int*>(err), timeout_ns);
  return (int)cudaGetLastError();
}

extern "C" int ring_peer_signal_launch(void* flag, unsigned value,
                                       void* stream) {
  flag_signal_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(flag), value);
  return (int)cudaGetLastError();
}

// The shared allocation of one rank: `bytes` of device memory (payload,
// then the flags), zeroed, and its IPC handle (64 bytes) in `handle`.
extern "C" int ring_peer_alloc(unsigned long long bytes, void** ptr,
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

// Open a neighbour's allocation from its handle (peer access enabled on
// first use when it lies on another card).
extern "C" int ring_peer_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  for (int i = 0; i < (int)sizeof(h); ++i)
    h.reserved[i] = static_cast<const char*>(handle)[i];
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int ring_peer_close(void* ptr) {
  return (int)cudaIpcCloseMemHandle(ptr);
}

extern "C" int ring_peer_free(void* ptr) { return (int)cudaFree(ptr); }

extern "C" int ring_peer_handle_bytes() {
  return (int)sizeof(cudaIpcMemHandle_t);
}
