// Dequantize-and-combine of int8 gossip payloads across ranks, through
// peer pointers: the multi-rank form of csrc/gossip_axpy_q8.cu, driven by
// a source table as csrc/table_peer.cu is.  Each rank holds B agents' int8
// payload (B, rows, 128) and its per-tile f32 scales (B, rows / block_rows)
// in one slot of its shared allocation (kernels/table_peer.py), and
// computes
//
//     out[b] = Σₖ coef[k, b, tile] · f32(q[src[k, b]])
//     coef[k, b, tile] = w[k, b] · scale[src[k, b]][tile]
//
// for b = 0 … B−1, where src[k, b] is a (rank, agent) block of any rank of
// the round on this host — a ring neighbour, an exponential hop, a
// time-varying schedule's round, a masked column, a late slot (the agent
// itself) — read where it lies.
//
// Replaces, across devices, the Pallas TPU kernel repro/kernels/
// edm_update.py::_axpy_q8_kernel (called by gossip_axpy_q8_flat), which the
// JAX package reaches through repro/core/mixing.py's combine_wire /
// body_wire (gossip_axpy_wire) on the int8 wire: there every term's q and
// scale are first shipped by a collective-permute, here they are read in
// place.  The coefficient is the one-device fused path's
// (kernels/ops.py::gossip_axpy_wire and ::table_combine_wire build
// w · scale as one f32 product per tile), so a multi-rank run is bit-equal
// to the one-process run, masked rounds and late slots included.
//
// Rounding: each coefficient one f32 product; f32 accumulation in term
// order k = 0 … K−1 from coef₀·q₀, every product and sum an explicitly
// rounded intrinsic (no FMA contraction); int8 → f32 is exact — the
// sequence of gossip_axpy_q8.cu and of the plain version.  A NaN or ±Inf
// scale propagates as in the plain sum.
//
// Design: one thread owns a 16-element group of a row (one int4 load a
// source block) and loads it from every distinct source block once, with
// that block's scale of the group's tile, into registers (static indices:
// the register slots are a template argument sized to the round, 2, 4, 8
// or 16); each of the rank's agents then sums its terms from them and
// writes 16 f32 (four float4 stores).  A grid-stride loop over the groups,
// the grid sized by the occupancy calculator; loads and stores stream.
// Element indices are 64-bit.  The synchronisation (READY / DONE epochs)
// is csrc/table_peer.cu's; this file holds the combine only.
//
// Bound on an H100: device-memory bytes — each distinct source block read
// once (1 B an element, plus its scales) and B f32 blocks written (4 B an
// element), against 2K flops an element.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSrc = 16;
constexpr int kMaxTerms = 16;
constexpr int kMaxBlock = 8;   // agents a rank
constexpr int kThreads = 256;

struct Sources {
  const int4* q[kMaxSrc];
  const float* scale[kMaxSrc];
};

struct Terms {
  int u[kMaxBlock][kMaxTerms];   // index into Sources
  float w[kMaxBlock][kMaxTerms];
};

// The 16 int8 of a 16-byte word as f32 (exact).
__device__ __forceinline__ void widen16(int4 w, float v[16]) {
  const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      v[4 * j + b] = (float)(signed char)((words[j] >> (8 * b)) & 0xff);
  }
}

template <int N>
__device__ __forceinline__ int4 pick_q(const int4 (&q)[N], int u) {
  int4 r = q[0];
#pragma unroll
  for (int i = 1; i < N; ++i)
    if (u == i) r = q[i];
  return r;
}

template <int N>
__device__ __forceinline__ float pick_s(const float (&s)[N], int u) {
  float r = s[0];
#pragma unroll
  for (int i = 1; i < N; ++i)
    if (u == i) r = s[i];
  return r;
}

// n16: 16-element groups an agent block; tile16: groups a scale tile.
template <int N>
__global__ void table_peer_q8_kernel(Sources srcs, int n_src,
                                     float* __restrict__ out,
                                     long long out_stride, Terms terms,
                                     int n_terms, int n_agents,
                                     long long tile16, long long n16) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < n16; j += stride) {
    const long long tile = j / tile16;
    int4 q[N];
    float s[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      q[i] = i < n_src ? __ldcs(srcs.q[i] + j) : make_int4(0, 0, 0, 0);
      s[i] = i < n_src ? __ldg(srcs.scale[i] + tile) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kMaxBlock; ++b) {
      if (b < n_agents) {
        float acc[16], v[16];
        int u = terms.u[b][0];
        float c = __fmul_rn(terms.w[b][0], pick_s(s, u));
        widen16(pick_q(q, u), v);
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] = __fmul_rn(c, v[e]);
#pragma unroll
        for (int k = 1; k < kMaxTerms; ++k) {   // static indices: no stack
          if (k < n_terms) {
            u = terms.u[b][k];
            c = __fmul_rn(terms.w[b][k], pick_s(s, u));
            widen16(pick_q(q, u), v);
#pragma unroll
            for (int e = 0; e < 16; ++e)
              acc[e] = __fadd_rn(acc[e], __fmul_rn(c, v[e]));
          }
        }
        float4* o = reinterpret_cast<float4*>(out + b * out_stride) + 4 * j;
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4)
          __stcs(o + e4, make_float4(acc[4 * e4], acc[4 * e4 + 1],
                                     acc[4 * e4 + 2], acc[4 * e4 + 3]));
      }
    }
  }
}

template <int N>
cudaError_t launch_n(const Sources& s, int n_src, float* out,
                     long long out_stride, const Terms& terms, int n_terms,
                     int n_agents, long long tile16, long long n16,
                     cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, table_peer_q8_kernel<N>, kThreads, 0);
  if (err != cudaSuccess) return err;
  long long blocks = (n16 + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > cap) blocks = cap;
  table_peer_q8_kernel<N><<<(unsigned)blocks, kThreads, 0, stream>>>(
      s, n_src, out, out_stride, terms, n_terms, n_agents, tile16, n16);
  return cudaGetLastError();
}

}  // namespace

// qs / scales: n_src distinct (rank, agent) source blocks, each n int8 and
// n / (block_rows · 128) f32 scales (any may be a peer pointer, none
// aliasing out); u / weights: n_agents × n_terms, agent-major (term k of
// agent b reads source u[b · n_terms + k]); out: f32, agent b's n elements
// from b · out_stride.  n is a multiple of block_rows · 128, every pointer
// 16-byte aligned (checked by the wrapper).  Launches on `stream`, returns
// cudaGetLastError().
extern "C" int table_peer_q8_launch(const void* const* qs,
                                    const void* const* scales, int n_src,
                                    void* out, long long out_stride,
                                    const int* u, const float* weights,
                                    int n_terms, int n_agents, int block_rows,
                                    long long n, void* stream) {
  if (n_src < 1 || n_src > kMaxSrc || n_terms < 1 || n_terms > kMaxTerms ||
      n_agents < 1 || n_agents > kMaxBlock || block_rows <= 0 || n < 0 ||
      (n_agents > 1 && (out_stride < n || out_stride % 4)))
    return (int)cudaErrorInvalidValue;
  const long long tile = (long long)block_rows * 128;
  if (n % tile) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_agents * n_terms; ++i)
    if (u[i] < 0 || u[i] >= n_src) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Sources s = {};
  for (int i = 0; i < n_src; ++i) {
    s.q[i] = static_cast<const int4*>(qs[i]);
    s.scale[i] = static_cast<const float*>(scales[i]);
  }
  Terms terms = {};
  for (int b = 0; b < n_agents; ++b)
    for (int k = 0; k < n_terms; ++k) {
      terms.u[b][k] = u[b * n_terms + k];
      terms.w[b][k] = weights[b * n_terms + k];
    }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const long long tile16 = tile / 16, n16 = n / 16;
  if (n_src <= 2)
    return (int)launch_n<2>(s, n_src, o, out_stride, terms, n_terms,
                            n_agents, tile16, n16, st);
  if (n_src <= 4)
    return (int)launch_n<4>(s, n_src, o, out_stride, terms, n_terms,
                            n_agents, tile16, n16, st);
  if (n_src <= 8)
    return (int)launch_n<8>(s, n_src, o, out_stride, terms, n_terms,
                            n_agents, tile16, n16, st);
  return (int)launch_n<16>(s, n_src, o, out_stride, terms, n_terms,
                           n_agents, tile16, n16, st);
}
