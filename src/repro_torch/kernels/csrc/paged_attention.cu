// Paged decode attention: one query token per slot over a paged KV cache.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py::_paged_kernel
// (called by paged_attention_kernel_call).  For slot b and KV head k, the G
// query rows of that head's group attend over the slot's first kv_len[b]
// KV rows; row t lives at row t % page_size of physical page
// page_table[b, t / page_size] of the (num_pages, page_size, K, hd) pools.
//
//     out[b, k, g] = Σ_t softmax_t(scale · q[b, k, g] · K[t]) · V[t]
//
// Bound on an H100: device-memory bytes.  Each KV row is read once per
// (slot, head) and used by G query rows, so there are 4·G flops per KV
// element (2 for q·k, 2 for p·v): 12 at G = 3, against the ~295 flop/B
// the card needs before its bf16 tensor-core rate (989 TFLOP/s) and not
// its 3.35 TB/s bind.  The design therefore streams the KV rows once and
// does the arithmetic in f32 on the CUDA cores:
//
// * one block per (slot, KV head), covering that head's G query rows, so
//   a KV row is read from device memory once for the whole group;
// * the TPU's sequential page grid axis becomes a loop inside the block
//   over tiles of `tile_rows` logical rows (several pages), each gathered
//   through the block's own page-table entries with 16-byte loads, with
//   an online softmax (running max, denominator and accumulator in shared
//   memory);
// * only rows t < kv_len are loaded, so no page past the last used one,
//   max(ceil(kv_len / page_size) − 1, 0), is touched and no row past
//   kv_len reaches the accumulator; kv_len is clamped to the page table's
//   n_pages · page_size rows, as the TPU grid is;
// * a slot with kv_len == 0 loads nothing and writes a zero tile
//   (0 / max(0, 1e-30) = 0), with no NaN.
//
// Accumulation is f32; the output is rounded once to the query dtype.
// No wgmma or TMA yet: the arithmetic is a small share of the time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 64;

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory, in floats: q·scale (G·hd), acc (G·hd), K tile
// (tile·(hd+1), padded so that threads on neighbouring rows hit different
// banks), V tile (tile·hd), scores / probabilities (G·tile), and the
// running max, denominator and rescale factor (3·G).
__host__ __device__ __forceinline__ long long smem_floats(int G, int hd,
                                                          int tile) {
  return 2LL * G * hd + (long long)tile * (2 * hd + 1) + (long long)G * tile +
         3LL * G;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ page_table,
                       const int* __restrict__ kv_len, T* __restrict__ out,
                       int K, int G, int hd, int page_size, int n_pages,
                       float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int hd8 = hd / 8;
  const int ks_stride = hd + 1;
  float* qs = smem;
  float* acc = qs + G * hd;
  float* ks = acc + G * hd;
  float* vs = ks + kTileRows * ks_stride;
  float* sc = vs + kTileRows * hd;
  float* m_s = sc + G * kTileRows;
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  const int len = max(0, min(kv_len[b], n_pages * page_size));
  const int* pt = page_table + (long long)b * n_pages;
  const long long qo = ((long long)b * K + kh) * G * hd;

  for (int i = tid; i < G * hd8; i += kThreads) {
    float v8[8];
    load8(q + qo + i * 8, v8);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qs[i * 8 + e] = v8[e] * scale;
      acc[i * 8 + e] = 0.f;
    }
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += kTileRows) {
    const int rows = min(kTileRows, len - t0);
    // gather the tile's K/V rows of head kh through the page table
    for (int i = tid; i < rows * hd8; i += kThreads) {
      const int r = i / hd8, c = (i % hd8) * 8;
      const int t = t0 + r;
      const long long phys = pt[t / page_size];
      const long long off =
          ((phys * page_size + t % page_size) * K + kh) * hd + c;
      float v8[8];
      load8(k_pool + off, v8);
#pragma unroll
      for (int e = 0; e < 8; ++e) ks[r * ks_stride + c + e] = v8[e];
      load8(v_pool + off, v8);
#pragma unroll
      for (int e = 0; e < 8; ++e) vs[r * hd + c + e] = v8[e];
    }
    __syncthreads();
    // scores: one (query row, key row) dot product per thread and step
    for (int i = tid; i < G * rows; i += kThreads) {
      const int g = i / rows, r = i % rows;
      const float* qg = qs + g * hd;
      const float* kr = ks + r * ks_stride;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qg[d], kr[d], s);
      sc[g * kTileRows + r] = s;
    }
    __syncthreads();
    // online softmax, one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float* sg = sc + g * kTileRows;
      float mx = -INFINITY;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, sg[r]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const float p = expf(sg[r] - m_new);
        sg[r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);   // 0 on the first tile
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc = α·acc + p·V, one (query row, lane of hd) per thread and step
    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd, d = i % hd;
      const float* pg = sc + g * kTileRows;
      float a = acc[i] * a_s[g];
      for (int r = 0; r < rows; ++r) a = fmaf(pg[r], vs[r * hd + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd;
    store(acc[i] / fmaxf(l_s[g], 1e-30f), out + qo + i);
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_table, const void* kv_len, void* out, int B,
           int K, int G, int hd, int page_size, int n_pages, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats(G, hd, kTileRows) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)B, (unsigned)K);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(kv_len), static_cast<T*>(out), K, G, hd,
      page_size, n_pages, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (B, K, G, hd); pools: (num_pages, page_size, K, hd), all of one
// dtype (0 = f32, 1 = bf16), contiguous, 16-byte aligned, hd a multiple of
// 8; page_table: (B, n_pages) int32; kv_len: (B,) int32 (the wrapper checks
// all of it).  Launches on `stream` and returns cudaGetLastError().
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* page_table,
                                      const void* kv_len, void* out,
                                      int dtype, int B, int K, int G, int hd,
                                      int page_size, int n_pages, float scale,
                                      void* stream) {
  if (B == 0 || K == 0 || G == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, page_table, kv_len, out, B, K, G,
                         hd, page_size, n_pages, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, page_table, kv_len, out,
                                 B, K, G, hd, page_size, n_pages, scale, s);
  return (int)cudaErrorInvalidValue;
}
