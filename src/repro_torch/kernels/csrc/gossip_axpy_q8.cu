// Dequantize-and-combine of int8 gossip payloads:
//
//     out = Σₖ coef[k, tile] · f32(qₖ)          coef[k, t] = wₖ · scaleₖ[t]
//
// over flat (A·rows, 128) int8 buffers, f32 out.
//
// Replaces the Pallas TPU kernel repro/kernels/edm_update.py::
// _axpy_q8_kernel (called by gossip_axpy_q8_flat): the int8 wire's decode
// folded into the n-ary combine, so each payload widens to f32 once,
// already weighted and dequantized.  One operand per gossip term, up to
// kMaxOperands = 16, as gossip_axpy.cu.
//
// Bound on an H100: device-memory bytes, n int8 reads and one f32 write
// per element — 7 B for the ring's 3-ary combine — against 2n flops.  The
// design streams: each thread reads 16 int8 (16 B) per operand and writes
// 16 f32 (four float4 stores), coalesced, grid-stride over a grid that
// fills every SM.  The 16 elements lie in one 128-wide row and so in one
// (block_rows, 128) scale tile: one coefficient load per operand per
// iteration.
//
// The coefficients are a device array (n, n_tiles) and block_rows a
// runtime argument, so every weight set, scale set and tile height reuses
// one build; the operand pointers arrive by value in a kernel-argument
// struct.
//
// Output agent stride: the operands are fresh encoded payloads, dense
// (n_agents blocks of n elements each); the output's block a starts
// a · out_stride elements in, so the mix lands in a policy group's rows
// x'[:, r0:r1, :] of a larger bus in place (DESIGN §12).  Grid y is the
// agent; a dense call is one block of all elements.  The coefficients stay
// per tile of the flat operands, agent-major.
//
// Rounding: f32 accumulation in term order k = 0 … n−1, starting from
// coef₀·q₀, every product and sum an explicitly rounded intrinsic (no FMA
// contraction); int8 → f32 is exact.  The plain PyTorch version does the
// same operations in the same order, so the two agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOperands = 16;
constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

struct Operands {
  const int4* ptr[kMaxOperands];
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

// n16: 16-element groups per agent; agent a (blockIdx.y) reads its
// operands from group a · n16 and writes its output from float4
// a · out_stride4 (a dense call: one agent, no offset).
__global__ void gossip_axpy_q8_kernel(Operands ops, int n_ops,
                                      const float* coefs, long long n_tiles,
                                      long long tile16, float4* out,
                                      long long out_stride4, long long n16) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long base = blockIdx.y * n16;
  out += blockIdx.y * out_stride4;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n16;
       j += stride) {
    const long long i = base + j;
    const long long tile = i / tile16;
    float acc[16], v[16];
    widen16(ops.ptr[0][i], v);
    const float c0 = __ldg(coefs + tile);
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = __fmul_rn(c0, v[e]);
#pragma unroll
    for (int k = 1; k < kMaxOperands; ++k) {
      if (k < n_ops) {
        widen16(ops.ptr[k][i], v);
        const float ck = __ldg(coefs + (long long)k * n_tiles + tile);
#pragma unroll
        for (int e = 0; e < 16; ++e)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(ck, v[e]));
      }
    }
#pragma unroll
    for (int e4 = 0; e4 < 4; ++e4)
      out[4 * j + e4] = make_float4(acc[4 * e4], acc[4 * e4 + 1],
                                    acc[4 * e4 + 2], acc[4 * e4 + 3]);
  }
}

}  // namespace

extern "C" int gossip_axpy_q8_max_operands() { return kMaxOperands; }

// operands: n_ops device pointers to n_agents · n int8 each (dense);
// coefs: device pointer to (n_ops, n_agents · n / (block_rows·128)) f32;
// out: n_agents blocks of n f32, out_stride elements apart (≥ n, a
// multiple of 4).  n is a multiple of block_rows·128 and every pointer
// 16-byte aligned (checked by the wrapper).  A dense call passes
// n_agents = 1.
extern "C" int gossip_axpy_q8_launch(const void* const* operands, int n_ops,
                                     const void* coefs, int block_rows,
                                     void* out, long long out_stride,
                                     int n_agents, long long n, void* stream) {
  if (n_ops < 1 || n_ops > kMaxOperands || block_rows <= 0 || n_agents < 1 ||
      n_agents > 65535 || out_stride < n || out_stride % 4)
    return (int)cudaErrorInvalidValue;
  const long long tile = (long long)block_rows * 128;
  if (n % tile) return (int)cudaErrorInvalidValue;
  const long long n16 = n / 16;
  if (n16 == 0) return (int)cudaSuccess;
  Operands ops = {};
  for (int k = 0; k < n_ops; ++k)
    ops.ptr[k] = static_cast<const int4*>(operands[k]);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n16 + kThreads - 1) / kThreads;
  // the grid fills the card over all agents' blocks together
  long long cap = (long long)sms * kBlocksPerSM / n_agents;
  if (cap < 1) cap = 1;
  if (blocks > cap) blocks = cap;
  const dim3 grid((unsigned)blocks, (unsigned)n_agents);
  gossip_axpy_q8_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      ops, n_ops, static_cast<const float*>(coefs), n_agents * (n / tile),
      tile / 16, static_cast<float4*>(out), out_stride / 4, n16);
  return (int)cudaGetLastError();
}
