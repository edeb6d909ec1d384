// Paged prefill attention: one C-token prompt chunk of ONE slot.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_prefill.py::_prefill_kernel
// (called by paged_prefill_kernel_call).  The chunk's C·G query rows of KV
// head k (row i·G + g is chunk token i, group member g, at absolute
// position start + i) attend to
//
// * the slot's earlier rows in the (num_pages, page_size, K, hd) pools,
//   row r at row r % page_size of page pt_row[r / page_size], holding key
//   position r (linear) or (start−1) − ((start−1−r) mod window) (ring); a
//   row is valid iff 0 ≤ pos < start and r < min(start, window), and the
//   window mask pos > (start + i) − window applies per element, because a
//   ring page mixes positions from two windows;
// * the in-flight chunk's own keys (K, C, hd), not yet in the pools:
//   key jk is valid iff jk ≤ i, jk < chunk_len and jk > i − window.
//
// Bound on an H100: at the serving shapes (C = 128, G = 3, up to 768
// earlier rows, hd = 64) it is small work either way: the KV rows read
// (once) against 3.35 TB/s and 4·C·G flops per KV element against
// 989 TFLOP/s bf16 both take about a microsecond, so launch latency and
// the serial loop inside a block dominate.  The design keeps the loop
// short and every block busy:
//
// * one block per (tile of 32 query rows, KV head); each block loops over
//   the slot's used pool rows, then over the chunk's keys, in tiles of 32
//   rows with an online softmax (running max, denominator and accumulator
//   in shared memory): the TPU's sequential page grid axis becomes this
//   loop;
// * only rows r < min(start, window) are loaded (clamped to the page
//   table's n_pages · page_size rows), so no page past the last used one
//   is read, and only chunk keys jk < chunk_len;
// * a masked key is skipped in the p·v product, not multiplied by a zero
//   weight, so a NaN in a dead row can never reach the accumulator;
// * start, chunk_len and window are kernel arguments: one build serves
//   every prompt length and chunk position.
//
// Accumulation is f32; the output is rounded once to the query dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kQRows = 32;
constexpr int kKRows = 32;

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

// Shared memory, in floats: q·scale (kQRows·hd), acc (kQRows·hd), K tile
// (kKRows·(hd+1), padded against bank conflicts), V tile (kKRows·hd),
// probabilities (kQRows·kKRows), running max / denominator / rescale
// (3·kQRows), and the key positions of the tile (kKRows ints).
__host__ __device__ __forceinline__ long long smem_floats(int hd) {
  return 2LL * kQRows * hd + (long long)kKRows * (2 * hd + 1) +
         (long long)kQRows * kKRows + 3LL * kQRows + kKRows;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_chunk,
                     const T* __restrict__ v_chunk,
                     const T* __restrict__ k_pool,
                     const T* __restrict__ v_pool,
                     const int* __restrict__ pt_row, T* __restrict__ out,
                     int K, int C, int G, int hd, int page_size, int n_pages,
                     int start, int chunk_len, int window, float scale) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * kQRows;
  const int kh = blockIdx.y;
  const int CG = C * G;
  const int nq = min(kQRows, CG - q0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int hd8 = hd / 8;
  const int ks_stride = hd + 1;
  float* qs = smem;
  float* acc = qs + kQRows * hd;
  float* ks = acc + kQRows * hd;
  float* vs = ks + kKRows * ks_stride;
  float* sc = vs + kKRows * hd;
  float* m_s = sc + kQRows * kKRows;
  float* l_s = m_s + kQRows;
  float* a_s = l_s + kQRows;
  int* kpos = reinterpret_cast<int*>(a_s + kQRows);

  const long long qo = ((long long)kh * CG + q0) * hd;
  for (int i = tid; i < nq * hd8; i += kThreads) {
    float v8[8];
    load8(q + qo + i * 8, v8);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qs[i * 8 + e] = v8[e] * scale;
      acc[i * 8 + e] = 0.f;
    }
  }
  for (int r = tid; r < kQRows; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  // pool rows the chunk may see: the occupied prefix, within the table
  int prev = window ? min(start, window) : start;
  prev = max(0, min(prev, n_pages * page_size));
  const int n_chunk = max(0, min(chunk_len, C));
  const int n_pool_tiles = (prev + kKRows - 1) / kKRows;
  const int n_tiles = n_pool_tiles + (n_chunk + kKRows - 1) / kKRows;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const bool pool = tile < n_pool_tiles;
    const int t0 = (pool ? tile : tile - n_pool_tiles) * kKRows;
    const int rows = min(kKRows, (pool ? prev : n_chunk) - t0);
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < rows * hd8; i += kThreads) {
      const int r = i / hd8, c = (i % hd8) * 8;
      const int t = t0 + r;
      const T* ksrc;
      const T* vsrc;
      if (pool) {
        const long long phys = pt_row[t / page_size];
        const long long off =
            ((phys * page_size + t % page_size) * K + kh) * hd + c;
        ksrc = k_pool + off;
        vsrc = v_pool + off;
      } else {
        const long long off = ((long long)kh * C + t) * hd + c;
        ksrc = k_chunk + off;
        vsrc = v_chunk + off;
      }
      float v8[8];
      load8(ksrc, v8);
#pragma unroll
      for (int e = 0; e < 8; ++e) ks[r * ks_stride + c + e] = v8[e];
      load8(vsrc, v8);
#pragma unroll
      for (int e = 0; e < 8; ++e) vs[r * hd + c + e] = v8[e];
    }
    for (int r = tid; r < rows; r += kThreads) {
      const int t = t0 + r;
      // ring row t holds the newest earlier position congruent to t
      // (t < prev <= start, so start−1−t >= 0 and % is the floored mod)
      kpos[r] = pool ? (window ? (start - 1) - (start - 1 - t) % window : t)
                     : t;
    }
    __syncthreads();
    // masked scores: one (query row, key row) per thread and step
    for (int i = tid; i < nq * rows; i += kThreads) {
      const int qr = i / rows, r = i % rows;
      const int qi = (q0 + qr) / G;
      const int kp = kpos[r];
      bool valid;
      if (pool) {
        valid = kp >= 0 && kp < start && (!window || kp > start + qi - window);
      } else {
        valid = kp <= qi && kp < n_chunk && (!window || kp > qi - window);
      }
      float s = -INFINITY;
      if (valid) {
        const float* qq = qs + qr * hd;
        const float* kr = ks + r * ks_stride;
        s = 0.f;
        for (int d = 0; d < hd; ++d) s = fmaf(qq[d], kr[d], s);
      }
      sc[qr * kKRows + r] = s;
    }
    __syncthreads();
    // online softmax, one warp per query row; a row with no valid key in
    // this tile keeps its state (p = 0, α = 1)
    for (int qr = warp; qr < nq; qr += kWarps) {
      float* sq = sc + qr * kKRows;
      float mx = -INFINITY;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, sq[r]);
      mx = warp_max(mx);
      const float m_prev = m_s[qr];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const float p = m_new == -INFINITY ? 0.f : expf(sq[r] - m_new);
        sq[r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = m_new == -INFINITY ? 1.f : expf(m_prev - m_new);
        a_s[qr] = alpha;
        l_s[qr] = alpha * l_s[qr] + sum;
        m_s[qr] = m_new;
      }
    }
    __syncthreads();
    // acc = α·acc + Σ p·v over the keys with a weight: masked keys skipped
    for (int i = tid; i < nq * hd; i += kThreads) {
      const int qr = i / hd, d = i % hd;
      const float* pq = sc + qr * kKRows;
      float a = acc[i] * a_s[qr];
      for (int r = 0; r < rows; ++r) {
        const float p = pq[r];
        if (p != 0.f) a = fmaf(p, vs[r * hd + d], a);
      }
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < nq * hd; i += kThreads) {
    const int qr = i / hd;
    store(acc[i] / fmaxf(l_s[qr], 1e-30f), out + qo + i);
  }
}

template <typename T>
int launch(const void* q, const void* k_chunk, const void* v_chunk,
           const void* k_pool, const void* v_pool, const void* pt_row,
           void* out, int K, int C, int G, int hd, int page_size, int n_pages,
           int start, int chunk_len, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats(hd) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_prefill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((C * G + kQRows - 1) / kQRows), (unsigned)K);
  paged_prefill_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_chunk),
      static_cast<const T*>(v_chunk), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(pt_row),
      static_cast<T*>(out), K, C, G, hd, page_size, n_pages, start, chunk_len,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (K, C·G, hd); k_chunk, v_chunk: (K, C, hd); pools:
// (num_pages, page_size, K, hd); all of one dtype (0 = f32, 1 = bf16),
// contiguous, 16-byte aligned, hd a multiple of 8; pt_row: (n_pages,)
// int32 (the wrapper checks all of it).  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int paged_prefill_launch(const void* q, const void* k_chunk,
                                    const void* v_chunk, const void* k_pool,
                                    const void* v_pool, const void* pt_row,
                                    void* out, int dtype, int K, int C, int G,
                                    int hd, int page_size, int n_pages,
                                    int start, int chunk_len, int window,
                                    float scale, void* stream) {
  if (K == 0 || C == 0 || G == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_chunk, v_chunk, k_pool, v_pool, pt_row, out, K,
                         C, G, hd, page_size, n_pages, start, chunk_len,
                         window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_chunk, v_chunk, k_pool, v_pool, pt_row,
                                 out, K, C, G, hd, page_size, n_pages, start,
                                 chunk_len, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
