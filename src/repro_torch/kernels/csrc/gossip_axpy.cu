// n-ary gossip combine  out = Σₖ wₖ · operandₖ  over flat buffers.
//
// Replaces the Pallas TPU kernel repro/kernels/edm_update.py::_axpy_kernel
// (called by gossip_axpy_flat).  One operand per gossip term (center /
// left / right for the paper's ring, more for exp and hierarchical
// graphs), up to kMaxOperands = 16, which covers every topology the JAX
// package builds at A ≤ 64.
//
// Bound on an H100: device-memory bytes, (n + 1) element reads/writes
// against 2n flops per element.  As in the EDM kernel the design only
// streams: four elements per thread per iteration (16 B per f32 operand,
// 8 B per bf16 operand), coalesced, grid-stride over a grid that fills
// every SM.
//
// Weights are runtime data, as in the TPU kernel (an SMEM operand there):
// they arrive by value in a kernel-argument struct, so one compiled kernel
// per (operand dtype, output dtype) serves every topology and weight set.
// The operand pointers travel the same way.
//
// Any element count: the float4 / 8-byte body covers the first n − n % 4
// elements and up to three tail elements go one per thread, so a
// parameter leaf of any shape combines in place of the bus.
//
// Agent strides: the operands and the output are n_agents blocks of n
// elements, block a of operand k at a · stride[k] and of the output at
// a · out_stride (grid y = the agent).  A policy group's rows
// bus[:, r0:r1, :] of a larger bus are then read (the unshifted self term)
// and written (x' of the group) in place (DESIGN §12).  A dense call is one
// block of all elements: the grid and the arithmetic of the flat walk.
//
// Rounding: accumulation is f32 in term order k = 0 … n−1, starting from
// w₀·o₀, with every product and sum an explicitly rounded intrinsic (no
// FMA contraction), and one rounding to the output dtype on store — the
// plain PyTorch version's exact sequence, so the two agree bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOperands = 16;
constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

struct Operands {
  const void* ptr[kMaxOperands];
  long long stride[kMaxOperands];   // elements between agents' blocks
};

struct Weights {
  float w[kMaxOperands];
};

// Load four consecutive elements (index i counts groups of four) as f32.
__device__ __forceinline__ void load4(const float* p, long long i, float v[4]) {
  const float4 t = reinterpret_cast<const float4*>(p)[i];
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, long long i,
                                      float v[4]) {
  const uint2 t = reinterpret_cast<const uint2*>(p)[i];
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, long long i,
                                       const float v[4]) {
  reinterpret_cast<float4*>(p)[i] = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, long long i,
                                       const float v[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&lo);
  t.y = *reinterpret_cast<const uint32_t*>(&hi);
  reinterpret_cast<uint2*>(p)[i] = t;
}

__device__ __forceinline__ float load1(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load1(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store1(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store1(__nv_bfloat16* p, long long i,
                                       float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Operand k of agent a (blockIdx.y): its block's first element.
template <typename In, bool kStrided>
__device__ __forceinline__ const In* block_of(const Operands& ops, int k) {
  const In* p = static_cast<const In*>(ops.ptr[k]);
  return kStrided ? p + blockIdx.y * ops.stride[k] : p;
}

// kStrided: agents' blocks apart (grid y = the agent); a dense call runs the
// flat walk with no offset arithmetic at all — with the offsets (one kernel
// for both) the dense f32 3-ary combine on the full smollm_360m bus took
// 8.79–8.83 ms against 8.64–8.66 (tools/time_combines.py, H100 80GB HBM3 at
// 700 W).  The launch bound holds the kernel at 32 registers, so
// kBlocksPerSM blocks of kThreads fit on an SM at once and the grid below
// is one wave: the per-operand offsets would otherwise push it to 40 (6
// blocks an SM, 1.33 waves; ~10 % slower on the same bus and card).
template <typename In, typename Out, bool kStrided>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
gossip_axpy_kernel(Operands ops, Weights ws, int n_ops, Out* out,
                   long long out_stride, long long n) {
  if (kStrided) out += blockIdx.y * out_stride;
  const long long n4 = n / 4;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long tail = n4 * 4 + first;
  if (tail < n) {   // the last n % 4 elements, one per thread, same order
    float acc =
        __fmul_rn(ws.w[0], load1(block_of<In, kStrided>(ops, 0), tail));
#pragma unroll
    for (int k = 1; k < kMaxOperands; ++k) {   // static indices: no stack
      if (k < n_ops)
        acc = __fadd_rn(acc, __fmul_rn(ws.w[k], load1(
            block_of<In, kStrided>(ops, k), tail)));
    }
    store1(out, tail, acc);
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = first; i < n4; i += stride) {
    float acc[4], v[4];
    load4(block_of<In, kStrided>(ops, 0), i, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = __fmul_rn(ws.w[0], v[e]);
#pragma unroll
    for (int k = 1; k < kMaxOperands; ++k) {
      if (k < n_ops) {
        load4(block_of<In, kStrided>(ops, k), i, v);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(ws.w[k], v[e]));
      }
    }
    store4(out, i, acc);
  }
}

template <typename In, typename Out>
cudaError_t launch(const Operands& ops, const Weights& ws, int n_ops,
                   void* out, long long out_stride, int n_agents, long long n,
                   cudaStream_t stream) {
  const long long n4 = n / 4 > 0 ? n / 4 : 1;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  long long blocks = (n4 + kThreads - 1) / kThreads;
  // the grid fills the card over all agents' blocks together
  long long cap = (long long)sms * kBlocksPerSM / n_agents;
  if (cap < 1) cap = 1;
  if (blocks > cap) blocks = cap;
  const dim3 grid((unsigned)blocks, (unsigned)n_agents);
  if (n_agents > 1)
    gossip_axpy_kernel<In, Out, true><<<grid, kThreads, 0, stream>>>(
        ops, ws, n_ops, static_cast<Out*>(out), out_stride, n);
  else
    gossip_axpy_kernel<In, Out, false><<<grid, kThreads, 0, stream>>>(
        ops, ws, n_ops, static_cast<Out*>(out), out_stride, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gossip_axpy_max_operands() { return kMaxOperands; }

// operands: n_ops device pointers, all of one dtype, each n_agents blocks
// of n elements (any count) with strides[k] elements from one agent's block
// to the next; weights: n_ops f32; out: n_agents blocks of n at out_stride.
// A dense call passes n_agents = 1.  dtype codes: 0 = float32, 1 =
// bfloat16.  Every block 16-byte aligned (checked by the wrapper).
extern "C" int gossip_axpy_launch(const void* const* operands,
                                  const long long* strides,
                                  const float* weights, int n_ops,
                                  int in_dtype, int out_dtype, void* out,
                                  long long out_stride, int n_agents,
                                  long long n, void* stream) {
  if (n_ops < 1 || n_ops > kMaxOperands || n_agents < 1 ||
      n_agents > 65535 || out_stride < n)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  Operands ops = {};
  Weights ws = {};
  for (int k = 0; k < n_ops; ++k) {
    if (strides[k] < n) return (int)cudaErrorInvalidValue;
    ops.ptr[k] = operands[k];
    ops.stride[k] = strides[k];
    ws.w[k] = weights[k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_dtype == 0 && out_dtype == 0)
    err = launch<float, float>(ops, ws, n_ops, out, out_stride,
                               n_agents, n, s);
  else if (in_dtype == 1 && out_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(ops, ws, n_ops, out,
                                               out_stride, n_agents, n, s);
  else if (in_dtype == 1 && out_dtype == 0)
    err = launch<__nv_bfloat16, float>(ops, ws, n_ops, out, out_stride,
                                       n_agents, n, s);
  else if (in_dtype == 0 && out_dtype == 1)
    err = launch<float, __nv_bfloat16>(ops, ws, n_ops, out, out_stride,
                                       n_agents, n, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
