// Ring gossip combine with the agent-axis rolls fused in, over the packed
// (A, rows, 128) f32 bus of all A agents on one card:
//
//     out[a] = Σₖ wₖ · x[(a − shiftₖ) mod A]        shiftₖ ∈ {0, +1, −1}
//
// Replaces the Pallas TPU kernel repro/kernels/ring_dma.py::_ring_kernel
// (called by ring_combine_shard), which ships each device's bus shard to
// both ring neighbours by remote DMA and combines the chunks as they land,
// so the neighbours' payloads never exist in HBM.
//
// On one card the A agents are row blocks of one buffer, so a neighbour's
// shard is an address in the same HBM: the TPU kernel's protocol (chunked
// remote copies, double-buffered landing slots, per-direction acks, the
// entry barrier) has nothing to do here and is not carried over.  What the
// kernel keeps is the point of that protocol: the permuted payloads are
// never written out.  The unfused path rolls the bus twice (two full
// copies) and then reads three buses in the combine; this kernel reads
// every element of the bus once and writes every output element once.
// The multi-rank form, one agent a rank, is csrc/ring_peer.cu: it reads
// the neighbours' payloads through peer pointers (CUDA IPC) and replaces
// the barrier semaphore by epoch flags, so that no rank reads a payload its
// owner is still writing or overwrites one a neighbour still reads.
//
// Design: one thread owns a float4 column position j of an agent's row
// block and walks the agents a = 0 … A−1 with x[a−1], x[a], x[a+1] in
// registers; x[0] and x[A−1] are loaded first and kept, so the wrap-around
// reads nothing twice.  Loads and stores stream (evict-first): nothing is
// reused after its column.  A grid-stride loop over the columns, with the
// grid sized by the occupancy calculator so that every block is resident
// in one wave.
//
// Bound on an H100: device-memory bytes, 2 × 4 B per element (one read,
// one write) against 2n − 1 flops per element for n terms.
//
// Agent strides: agent a's row block starts a · x_stride4 float4 into x and
// a · out_stride4 into out, so the kernel reads and writes a policy group's
// rows bus[:, r0:r1, :] of a larger bus in place (DESIGN §12).  The
// ungrouped bus passes n4 for both: the arithmetic and the bits are those
// of the dense walk.
//
// Rounding: terms are taken in topology order, starting from w₀·o₀, every
// product and sum an explicitly rounded intrinsic (no FMA contraction) —
// the sequence of csrc/gossip_axpy.cu and of the plain version (rolls,
// then the weighted sum), so the three agree bit for bit, NaN and ±Inf
// included.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTerms = 8;
constexpr int kThreads = 256;

// src[k]: where term k's operand of agent a lies — 0: row block a itself,
// 1: block a − 1 (a +1 shift, "from the left"), 2: block a + 1 (−1 shift).
struct Terms {
  int src[kMaxTerms];
  float w[kMaxTerms];
};

__device__ __forceinline__ float4 pick(int src, const float4& prev,
                                       const float4& cur,
                                       const float4& next) {
  return src == 0 ? cur : (src == 1 ? prev : next);
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

// x, out: A row blocks of n4 float4 each, block a at a · xs (x) and a · os
// (out) float4 (n4 for a dense bus); out aliases no byte of x.
__global__ void ring_combine_kernel(const float4* __restrict__ x,
                                    float4* __restrict__ out, Terms terms,
                                    int n_terms, int n_agents, long long n4,
                                    long long xs, long long os) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long last_block = (long long)(n_agents - 1) * xs;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < n4; j += stride) {
    const float4 first = __ldcs(x + j);
    const float4 last = n_agents > 1 ? __ldcs(x + last_block + j) : first;
    float4 prev = last, cur = first;
    for (int a = 0; a < n_agents; ++a) {
      float4 next;
      if (a + 1 == n_agents)
        next = first;
      else if (a + 2 == n_agents)
        next = last;
      else
        next = __ldcs(x + (long long)(a + 1) * xs + j);
      float4 acc = scale4(terms.w[0], pick(terms.src[0], prev, cur, next));
#pragma unroll
      for (int k = 1; k < kMaxTerms; ++k) {   // static indices: no stack
        if (k < n_terms)
          acc = axpy4(acc, terms.w[k], pick(terms.src[k], prev, cur, next));
      }
      __stcs(out + (long long)a * os + j, acc);
      prev = cur;
      cur = next;
    }
  }
}

}  // namespace

// x, out: (n_agents, rows, 128) f32 buses, 16-byte aligned, not
// overlapping (the wrapper checks); n4 = rows · 32 float4 per agent;
// x_stride4 / out_stride4: float4 from one agent's block to the next (n4
// for a dense bus, ≥ n4).  src / weights: n_terms entries (src codes as in
// Terms).  Launches on `stream` and returns cudaGetLastError().
extern "C" int ring_combine_launch(const void* x, void* out, const int* src,
                                   const float* weights, int n_terms,
                                   int n_agents, long long n4,
                                   long long x_stride4, long long out_stride4,
                                   void* stream) {
  if (n_terms < 1 || n_terms > kMaxTerms || n_agents < 1 || x_stride4 < n4 ||
      out_stride4 < n4)
    return (int)cudaErrorInvalidValue;
  if (n4 <= 0) return (int)cudaSuccess;
  Terms terms = {};
  for (int k = 0; k < n_terms; ++k) {
    if (src[k] < 0 || src[k] > 2) return (int)cudaErrorInvalidValue;
    terms.src[k] = src[k];
    terms.w[k] = weights[k];
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ring_combine_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n4 + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > cap) blocks = cap;
  ring_combine_kernel<<<(unsigned)blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(out), terms,
      n_terms, n_agents, n4, x_stride4, out_stride4);
  return (int)cudaGetLastError();
}
