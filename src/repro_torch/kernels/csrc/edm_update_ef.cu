// Fused EDM update with the error-feedback quantized gossip wire, over the
// packed (A·rows, 128) f32 bus.
//
// Replaces the Pallas TPU kernels repro/kernels/edm_update.py::
// _edm_ef_bf16_kernel and ::_edm_ef_int8_kernel (called by
// edm_update_ef_flat).  Per element:
//
//     m'  = β m + (1−β) g
//     ψ'  = x − α m'
//     c   = ((ψ' + x) − ψ) + e          (φ plus the carried residual)
//
// bf16 wire: q = bf16(c) (round to nearest even), e' = c − f32(q).
// int8 wire: per (block_rows, 128) tile of the flattened bus, the wire
// format's scale block,
//
//     absmax = max |c| over the tile's finite values
//     scale  = absmax / 127
//     inv    = absmax > 0 ? 127 / max(absmax, 1e-30) : 0
//     qf     = clip(rint(c · inv), −127, 127), 0 where c is NaN
//     e'     = c − qf · scale
//     q      = int8(qf), 0 where qf is NaN
//
// (qf is NaN only for ±Inf in a tile whose finite values are all 0: there
// e' is NaN and q is 0, as the Pallas kernel gives on the JAX CPU backend.)
//
// Bound on an H100: device-memory bytes.  bf16: 5 f32 reads, 3 f32 writes
// and one bf16 write = 34 B per element; int8: 5 + 3 f32 and one int8 =
// 33 B per element (plus 4 B per 65,536-element tile of scale), against
// about a dozen flops per element — far below the card's f32 ridge.
//
// bf16 design: a pure stream, as edm_update.cu — each thread moves 16 B
// per f32 operand (float4) and stores 4 bf16 (8 B), grid-stride over a grid
// that fills every SM.
//
// int8 design: every q of a tile needs the tile's absmax.  On the TPU one
// grid step holds the whole 256 KB tile in VMEM; here it does not fit one
// block's shared memory (227 KB at most) or its registers.  So one block
// owns one tile at a time and makes two passes over it:
//   pass 1 computes m', ψ' and c, writes m' and ψ', stashes c in the e'
//          output, and reduces the finite absmax (warp shuffles, then
//          shared memory);
//   pass 2 re-reads c from e' — each thread the same float4s it wrote, so
//          no fence is needed beyond program order — and writes q and
//          e' = c − q·scale over it.
// The stash was just written and is mostly still in the 50 MB L2: blocks
// are persistent (kBlocksPerSMInt8 per SM, looping over tiles), which caps
// the tiles in flight, and so the stash that must stay resident, at
// 132 · 2 · 256 KB.  Where L2 misses, the stash costs up to 8 B per element
// more.  A thread-block cluster holding the tile in distributed shared
// memory would make this one pass; that is for a later change.
//
// Tiles never straddle agents (rows % block_rows == 0 per agent), and
// block_rows is a runtime argument: it is the wire format's scale block,
// whatever the CUDA block shape.
//
// Rounding: every product, sum and quotient is an explicitly rounded
// intrinsic (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn), never
// contracted into an FMA; rintf rounds half to even as torch.round does;
// __float2bfloat16_rn rounds as torch's bf16 cast.  (1−β) arrives from the
// host.  Kernel and plain PyTorch version therefore agree bit for bit.
// The clip is written with comparisons, which keep a NaN (fminf/fmaxf
// would drop it).
//
// In place: m_out may alias m, psi_out psi and e_out e.  Each thread reads
// an element's inputs before it writes that element's outputs, and no other
// thread touches that element; the pointers are not __restrict__.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;
constexpr int kThreadsInt8 = 512;
constexpr int kBlocksPerSMInt8 = 2;

struct Chain {
  float alpha, beta, one_minus_beta;
};

// c and the two state outputs of one element.
__device__ __forceinline__ float chain(const Chain& k, float x, float g,
                                       float m, float psi, float e,
                                       float& m_new, float& psi_new) {
  m_new = __fadd_rn(__fmul_rn(k.beta, m), __fmul_rn(k.one_minus_beta, g));
  psi_new = __fsub_rn(x, __fmul_rn(k.alpha, m_new));
  return __fadd_rn(__fsub_rn(__fadd_rn(psi_new, x), psi), e);
}

__device__ __forceinline__ float4 chain4(const Chain& k, float4 x, float4 g,
                                         float4 m, float4 psi, float4 e,
                                         float4& m_new, float4& psi_new) {
  float4 c;
  c.x = chain(k, x.x, g.x, m.x, psi.x, e.x, m_new.x, psi_new.x);
  c.y = chain(k, x.y, g.y, m.y, psi.y, e.y, m_new.y, psi_new.y);
  c.z = chain(k, x.z, g.z, m.z, psi.z, e.z, m_new.z, psi_new.z);
  c.w = chain(k, x.w, g.w, m.w, psi.w, e.w, m_new.w, psi_new.w);
  return c;
}

__global__ void edm_ef_bf16_kernel(const float4* x, const float4* g,
                                   const float4* m, const float4* psi,
                                   const float4* e, float4* m_out,
                                   float4* psi_out, uint2* q_out,
                                   float4* e_out, long long n4, Chain k) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 mn, pn;
    const float4 c = chain4(k, x[i], g[i], m[i], psi[i], e[i], mn, pn);
    const __nv_bfloat16 q0 = __float2bfloat16_rn(c.x);
    const __nv_bfloat16 q1 = __float2bfloat16_rn(c.y);
    const __nv_bfloat16 q2 = __float2bfloat16_rn(c.z);
    const __nv_bfloat16 q3 = __float2bfloat16_rn(c.w);
    float4 en;
    en.x = __fsub_rn(c.x, __bfloat162float(q0));
    en.y = __fsub_rn(c.y, __bfloat162float(q1));
    en.z = __fsub_rn(c.z, __bfloat162float(q2));
    en.w = __fsub_rn(c.w, __bfloat162float(q3));
    uint2 qv;
    qv.x = (uint32_t)__bfloat16_as_ushort(q0) |
           ((uint32_t)__bfloat16_as_ushort(q1) << 16);
    qv.y = (uint32_t)__bfloat16_as_ushort(q2) |
           ((uint32_t)__bfloat16_as_ushort(q3) << 16);
    m_out[i] = mn;
    psi_out[i] = pn;
    q_out[i] = qv;
    e_out[i] = en;
  }
}

// NaN and ±Inf tests by comparison, independent of the math headers'
// macro or overload of isnan / isfinite.
__device__ __forceinline__ bool is_nan(float v) { return v != v; }

__device__ __forceinline__ float finite_abs(float v) {
  const float a = fabsf(v);
  return a <= 3.402823466e38f ? a : 0.0f;   // NaN and ±Inf fail the test
}

// One element of pass 2: the f32 q (may be NaN, see the header) and e'.
__device__ __forceinline__ signed char quant(float c, float scale, float inv,
                                             float& e_new) {
  float qf = rintf(__fmul_rn(c, inv));
  qf = qf < -127.0f ? -127.0f : (qf > 127.0f ? 127.0f : qf);
  if (is_nan(c)) qf = 0.0f;
  e_new = __fsub_rn(c, __fmul_rn(qf, scale));
  return is_nan(qf) ? (signed char)0 : (signed char)(int)qf;
}

// The second bound caps registers at 64 a thread so that kBlocksPerSMInt8
// blocks fit on an SM (uncapped, ptxas takes 78 and only one fits).
__global__ void __launch_bounds__(kThreadsInt8, kBlocksPerSMInt8)
edm_ef_int8_kernel(const float4* x, const float4* g, const float4* m,
                   const float4* psi, const float4* e, float4* m_out,
                   float4* psi_out, char4* q_out, float* s_out,
                   float4* e_out, long long n_tiles, int tile4, Chain k) {
  __shared__ float warp_max[kThreadsInt8 / 32];
  __shared__ float tile_max;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long base = t * tile4;
    // pass 1: the EDM chain, the stash of c, the finite absmax
    float amax = 0.0f;
    for (int j = threadIdx.x; j < tile4; j += kThreadsInt8) {
      const long long i = base + j;
      float4 mn, pn;
      const float4 c = chain4(k, x[i], g[i], m[i], psi[i], e[i], mn, pn);
      m_out[i] = mn;
      psi_out[i] = pn;
      e_out[i] = c;
      amax = fmaxf(amax, fmaxf(fmaxf(finite_abs(c.x), finite_abs(c.y)),
                               fmaxf(finite_abs(c.z), finite_abs(c.w))));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) warp_max[warp] = amax;
    __syncthreads();
    if (warp == 0) {
      amax = lane < kThreadsInt8 / 32 ? warp_max[lane] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      if (lane == 0) {
        tile_max = amax;
        s_out[t] = __fdiv_rn(amax, 127.0f);
      }
    }
    __syncthreads();
    const float absmax = tile_max;
    const float scale = __fdiv_rn(absmax, 127.0f);
    const float inv =
        absmax > 0.0f ? __fdiv_rn(127.0f, fmaxf(absmax, 1e-30f)) : 0.0f;
    // pass 2: quantize the stashed c, write q and the residual over it
    for (int j = threadIdx.x; j < tile4; j += kThreadsInt8) {
      const long long i = base + j;
      const float4 c = e_out[i];
      float4 en;
      char4 qv;
      qv.x = quant(c.x, scale, inv, en.x);
      qv.y = quant(c.y, scale, inv, en.y);
      qv.z = quant(c.z, scale, inv, en.z);
      qv.w = quant(c.w, scale, inv, en.w);
      q_out[i] = qv;
      e_out[i] = en;
    }
    __syncthreads();   // tile_max and warp_max are reused by the next tile
  }
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace

// fmt: 1 = bf16 (q is n bf16, scale unused), 2 = int8 (q is n int8, scale
// is n / (block_rows·128) f32).  n: f32 elements, a multiple of
// block_rows·128 for int8 and of 4 for bf16; every pointer 16-byte aligned
// (the Python wrapper checks all of it).  Launches on `stream` and returns
// cudaGetLastError() so a refused launch is reported to the caller.
extern "C" int edm_update_ef_launch(const void* x, const void* g,
                                    const void* m, const void* psi,
                                    const void* e, void* m_out, void* psi_out,
                                    void* q_out, void* scale_out, void* e_out,
                                    long long n, int fmt, int block_rows,
                                    float alpha, float beta,
                                    float one_minus_beta, void* stream) {
  const Chain k = {alpha, beta, one_minus_beta};
  const long long n4 = n / 4;
  if (n4 == 0) return (int)cudaSuccess;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fmt == 1) {
    long long blocks = (n4 + kThreads - 1) / kThreads;
    const long long cap = (long long)sms * kBlocksPerSM;
    if (blocks > cap) blocks = cap;
    edm_ef_bf16_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float4*>(x), static_cast<const float4*>(g),
        static_cast<const float4*>(m), static_cast<const float4*>(psi),
        static_cast<const float4*>(e), static_cast<float4*>(m_out),
        static_cast<float4*>(psi_out), static_cast<uint2*>(q_out),
        static_cast<float4*>(e_out), n4, k);
  } else if (fmt == 2) {
    if (block_rows <= 0) return (int)cudaErrorInvalidValue;
    const long long tile = (long long)block_rows * 128;
    if (n % tile) return (int)cudaErrorInvalidValue;
    const long long n_tiles = n / tile;
    long long blocks = n_tiles;
    const long long cap = (long long)sms * kBlocksPerSMInt8;
    if (blocks > cap) blocks = cap;
    edm_ef_int8_kernel<<<(unsigned)blocks, kThreadsInt8, 0, s>>>(
        static_cast<const float4*>(x), static_cast<const float4*>(g),
        static_cast<const float4*>(m), static_cast<const float4*>(psi),
        static_cast<const float4*>(e), static_cast<float4*>(m_out),
        static_cast<float4*>(psi_out), static_cast<char4*>(q_out),
        static_cast<float*>(scale_out), static_cast<float4*>(e_out),
        n_tiles, (int)(tile / 4), k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
