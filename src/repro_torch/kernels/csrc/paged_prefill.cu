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
// 989 TFLOP/s bf16 both take well under a microsecond (~0.35 GFLOP,
// ~1.5 MB), so what costs is latency: the length of each block's serial
// chain and how much of the card the grid fills.
//
// bf16: tensor cores (mma.sync.m16n8k16, operands through ldmatrix), fed
// by cp.async, with the key range split across blocks:
//
// * the slot's keys — its prev = min(start, window) pool rows, then the
//   chunk's keys — form one index range, split into n_split ranges of
//   split_keys keys (a multiple of the 64-key tile; the plan is
//   paged_prefill.py::split_plan, chosen so the grid of (64-row query
//   tile, KV head, split) blocks fills the card's SMs);
// * a block gathers its keys tile by tile: each 16-byte segment of a row
//   (pool rows K·hd elements apart, through the block's slice of the page
//   table, staged once in shared memory) goes into a double-buffered,
//   padded shared tile by cp.async, the next tile's gather in flight
//   during this tile's products.  Rows past the split's end, chunk keys
//   at or past chunk_len, chunk keys a query tile cannot see (causal),
//   and columns past hd are zero-filled, never loaded: a NaN-poisoned
//   pool row outside the live range cannot reach any product;
// * each warp owns 16 query rows: scores by mma.sync, the masks (ring
//   positions, per-element window, causal within the chunk) on the f32
//   scores in registers, the online softmax in the accumulator layout,
//   and O += P·V with P as P_hi + P_lo (two bf16 terms: attn_mma.cuh);
// * each block writes its partial (o, m, l) to scratch the wrapper
//   allocates; the last block of a query tile to finish (an atomic
//   ticket) merges the n_split partials in split order, so the result is
//   deterministic and one launch does it all, then resets its ticket.
//   With one split the block writes the output directly;
// * start, chunk_len and window are kernel arguments: one build serves
//   every prompt length and chunk position.
//
// f32: SIMT, one block per (tile of 32 query rows, KV head) looping over
// 32-row key tiles with the online softmax in shared memory; a masked key
// is skipped in the p·v product.  The tensor cores' only f32 input type is
// TF32, which would break the f32 gate (atol 2e-5) and the f32 serving
// engine's exact greedy tokens.
//
// Accumulation is f32; the output is rounded once to the query dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "attn_mma.cuh"

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

__device__ __forceinline__ void store(float v, float* p) { *p = v; }

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

// ---------------------------------------------------------------------------
// bf16: mma.sync fed by cp.async, the key range split across blocks
// ---------------------------------------------------------------------------

constexpr int kMThreads = 128;   // 4 warps × 16 query rows
constexpr int kMQ = 64;          // query rows per block
constexpr int kSplitUnit = 64;   // a split holds whole 64-key units
constexpr int kMaxSplits = 64;

// shared memory: Q (kMQ rows), K and V (2 stages × KT rows each), rows of
// HDP + 8 bf16 (the pad keeps ldmatrix's 8 rows on distinct banks); the
// tiles' key positions (2 × KT ints) and the block's page-table slice;
// the merge reuses it for n_split × kMQ weights and kMQ denominators
__host__ __device__ __forceinline__ size_t mma_smem_bytes(int hdp, int kt,
                                                          int n_pt,
                                                          int n_split) {
  const size_t tiles = (size_t)(kMQ + 4 * kt) * (hdp + 8) * 2 + 2 * kt * 4 +
                       (size_t)n_pt * 4;
  const size_t merge = (size_t)(n_split + 1) * kMQ * 4;
  return tiles > merge ? tiles : merge;
}

// HDP, KT: see MmaCfg
template <int HDP, int KT>
__global__ void __launch_bounds__(kMThreads)
paged_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k_chunk,
                         const __nv_bfloat16* __restrict__ v_chunk,
                         const __nv_bfloat16* __restrict__ k_pool,
                         const __nv_bfloat16* __restrict__ v_pool,
                         const int* __restrict__ pt_row,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ o_part,
                         float* __restrict__ ml_part,
                         int* __restrict__ tickets, int K, int C, int G,
                         int hd, int page_size, int n_pages, int start,
                         int chunk_len, int window, float scale_log2,
                         int split_keys, int n_split) {
  constexpr int RS = HDP + 8;
  constexpr int SEGS = HDP / 8;                 // 16-byte segments a row
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kMQ * RS;            // stage i at + i·KT·RS
  __nv_bfloat16* vs = ks + 2 * KT * RS;
  int* kpos = reinterpret_cast<int*>(vs + 2 * KT * RS);
  int* pts = kpos + 2 * KT;
  __shared__ int is_last;

  const int qt = blockIdx.x, kh = blockIdx.y, sp = blockIdx.z;
  const int CG = C * G;
  const int q0 = qt * kMQ;
  const int nq = min(kMQ, CG - q0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the block's keys: [kb, ke) of the slot's pool rows then chunk keys,
  // cut to the chunk keys its last query token can see
  int prev = window ? min(start, window) : start;
  prev = max(0, min(prev, n_pages * page_size));
  const int n_chunk = max(0, min(chunk_len, C));
  const int i_max = (q0 + nq - 1) / G;
  const int kb = sp * split_keys;
  const int ke = min(kb + split_keys, prev + min(n_chunk, i_max + 1));
  const int n_tiles = ke > kb ? (ke - kb + KT - 1) / KT : 0;

  const int pool_end = min(ke, prev);
  const int pg0 = kb / page_size;
  if (pool_end > kb)
    for (int i = tid; i <= (pool_end - 1) / page_size - pg0; i += kMThreads)
      pts[i] = pt_row[pg0 + i];
  __syncthreads();

  auto load_tile = [&](int t, int st) {
    const int t0 = kb + t * KT;
    __nv_bfloat16* kd = ks + st * KT * RS;
    __nv_bfloat16* vd = vs + st * KT * RS;
    for (int i = tid; i < KT * SEGS; i += kMThreads) {
      const int r = i / SEGS, c = (i % SEGS) * 8;
      const int kk = t0 + r;
      const __nv_bfloat16* ksrc = k_chunk;
      const __nv_bfloat16* vsrc = v_chunk;
      int bytes = 0;
      if (kk < ke && c < hd) {
        bytes = 16;
        long long off;
        if (kk < prev) {
          const long long page = pts[kk / page_size - pg0];
          off = ((page * page_size + kk % page_size) * K + kh) * hd + c;
          ksrc = k_pool + off;
          vsrc = v_pool + off;
        } else {
          off = ((long long)kh * C + (kk - prev)) * hd + c;
          ksrc = k_chunk + off;
          vsrc = v_chunk + off;
        }
      }
      attn::cp_async_16(attn::smem_u32(kd + r * RS + c), ksrc, bytes);
      attn::cp_async_16(attn::smem_u32(vd + r * RS + c), vsrc, bytes);
    }
    // key positions; INT_MAX (visible to no query) past the block's keys
    for (int r = tid; r < KT; r += kMThreads) {
      const int kk = t0 + r;
      int pos = INT_MAX;
      if (kk < ke)
        pos = kk < prev
                  ? (window ? (start - 1) - (start - 1 - kk) % window : kk)
                  : start + (kk - prev);
      kpos[st * KT + r] = pos;
    }
  };

  float o[HDP / 8][4];
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int lr0 = 16 * warp + lane / 4, lr1 = lr0 + 8;   // rows in the tile
  const int qpos0 = start + (q0 + lr0) / G, qpos1 = start + (q0 + lr1) / G;
  const int cq = 2 * (lane % 4);

  if (n_tiles > 0) {
    for (int i = tid; i < kMQ * SEGS; i += kMThreads) {
      const int r = i / SEGS, c = (i % SEGS) * 8;
      const bool ok = r < nq && c < hd;
      attn::cp_async_16(attn::smem_u32(qs + r * RS + c),
                        ok ? q + ((long long)kh * CG + q0 + r) * hd + c : q,
                        ok ? 16 : 0);
    }
    load_tile(0, 0);
    attn::cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      load_tile(t + 1, st ^ 1);
      attn::cp_async_commit();
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = ks + st * KT * RS;
    const __nv_bfloat16* vt = vs + st * KT * RS;
    const int* kp_t = kpos + st * KT;

    // S = Q·Kᵀ: 16 rows × KT keys a warp
    float sc[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kq = 0; kq < HDP / 16; ++kq) {
      uint32_t a[4];
      attn::ldmatrix_x4(a, attn::smem_u32(qs + (16 * warp + lane % 16) * RS +
                                          kq * 16 + (lane / 16) * 8));
#pragma unroll
      for (int np = 0; np < KT / 16; ++np) {
        uint32_t bb[4];
        attn::ldmatrix_x4(
            bb, attn::smem_u32(kt + (np * 16 + lane % 8 + (lane / 16) * 8) * RS +
                               kq * 16 + ((lane / 8) % 2) * 8));
        attn::mma_16816(sc[2 * np], a, bb[0], bb[1]);
        attn::mma_16816(sc[2 * np + 1], a, bb[2], bb[3]);
      }
    }

    // masks, then the online softmax in the exp2 domain (the scale folded
    // into one FMA an element)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = kp_t[8 * j + cq + (e & 1)];
        const int qp = e < 2 ? qpos0 : qpos1;
        const bool ok = kp <= qp && (!window || kp > qp - window);
        const float x = ok ? sc[j][e] : -INFINITY;
        sc[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    float mu0, mu1;
    const float a0 =
        attn::online_step(attn::quad_max(mx0) * scale_log2, m0, mu0);
    const float a1 =
        attn::online_step(attn::quad_max(mx1) * scale_log2, m1, mu1);
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      o[j][0] *= a0; o[j][1] *= a0;
      o[j][2] *= a1; o[j][3] *= a1;
    }

    // O += P·V, 16 keys a step, P as hi + lo
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = 2 * kk + hf;
        const float p00 = attn::fast_exp2(fmaf(sc[j][0], scale_log2, -mu0));
        const float p01 = attn::fast_exp2(fmaf(sc[j][1], scale_log2, -mu0));
        const float p10 = attn::fast_exp2(fmaf(sc[j][2], scale_log2, -mu1));
        const float p11 = attn::fast_exp2(fmaf(sc[j][3], scale_log2, -mu1));
        l0 += p00 + p01;
        l1 += p10 + p11;
        attn::split_bf16(p00, p01, ph[2 * hf], pl[2 * hf]);
        attn::split_bf16(p10, p11, ph[2 * hf + 1], pl[2 * hf + 1]);
      }
#pragma unroll
      for (int np = 0; np < HDP / 16; ++np) {
        uint32_t bb[4];
        attn::ldmatrix_x4_trans(
            bb, attn::smem_u32(vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                   RS + np * 16 + (lane / 16) * 8));
        attn::mma_16816(o[2 * np], ph, bb[0], bb[1]);
        attn::mma_16816(o[2 * np], pl, bb[0], bb[1]);
        attn::mma_16816(o[2 * np + 1], ph, bb[2], bb[3]);
        attn::mma_16816(o[2 * np + 1], pl, bb[2], bb[3]);
      }
    }
    __syncthreads();   // this stage's readers are done before its next load
  }

  l0 = attn::quad_sum(l0);
  l1 = attn::quad_sum(l1);
  if (n_split == 1) {
    __nv_bfloat16* ob = out + ((long long)kh * CG + q0) * hd;
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col >= hd) continue;
      if (lr0 < nq)
        *reinterpret_cast<uint32_t*>(ob + lr0 * hd + col) =
            attn::pack_bf16(o[j][0] / d0, o[j][1] / d0);
      if (lr1 < nq)
        *reinterpret_cast<uint32_t*>(ob + lr1 * hd + col) =
            attn::pack_bf16(o[j][2] / d1, o[j][3] / d1);
    }
    return;
  }

  // this split's partial: unnormalised o, running max m (exp2 domain), l
  const long long prow = ((long long)sp * K + kh) * CG + q0;
  float* op = o_part + prow * hd;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int col = 8 * j + cq;
    if (col >= hd) continue;
    if (lr0 < nq)
      *reinterpret_cast<float2*>(op + lr0 * hd + col) = make_float2(o[j][0], o[j][1]);
    if (lr1 < nq)
      *reinterpret_cast<float2*>(op + lr1 * hd + col) = make_float2(o[j][2], o[j][3]);
  }
  if (lane % 4 == 0) {
    if (lr0 < nq)
      *reinterpret_cast<float2*>(ml_part + (prow + lr0) * 2) = make_float2(m0, l0);
    if (lr1 < nq)
      *reinterpret_cast<float2*>(ml_part + (prow + lr1) * 2) = make_float2(m1, l1);
  }
  __threadfence();
  __syncthreads();
  int* ticket = tickets + kh * gridDim.x + qt;
  if (tid == 0) is_last = atomicAdd(ticket, 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the last block merges the splits' partials, in split order: first each
  // row's weights 2^(m_s − M) and denominator (into the tiles' shared
  // memory, no longer read), then every element's weighted sum
  float* wsm = reinterpret_cast<float*>(smem_raw);     // [n_split][kMQ]
  float* dsm = wsm + n_split * kMQ;                    // [kMQ]
  const float2* ml2 = reinterpret_cast<const float2*>(ml_part);
  const long long prow0 = (long long)kh * CG + q0;     // split 0's row 0
  const long long split_rows = (long long)K * CG;
  for (int r = tid; r < nq; r += kMThreads) {
    float M = -INFINITY;
    for (int sp2 = 0; sp2 < n_split; ++sp2)
      M = fmaxf(M, __ldcg(ml2 + sp2 * split_rows + prow0 + r).x);
    float L = 0.f;
    for (int sp2 = 0; sp2 < n_split; ++sp2) {
      const float2 ml = __ldcg(ml2 + sp2 * split_rows + prow0 + r);
      const float w = M == -INFINITY ? 0.f : exp2f(ml.x - M);
      wsm[sp2 * kMQ + r] = w;
      L += ml.y * w;
    }
    dsm[r] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  const int c4 = hd / 4;
  for (int i = tid; i < nq * c4; i += kMThreads) {
    const int r = i / c4, c = (i % c4) * 4;
    const float4* src =
        reinterpret_cast<const float4*>(o_part + (prow0 + r) * hd + c);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int sp2 = 0; sp2 < n_split; ++sp2) {
      const float w = wsm[sp2 * kMQ + r];
      const float4 v = __ldcg(src + sp2 * split_rows * c4);
      acc.x += w * v.x; acc.y += w * v.y;
      acc.z += w * v.z; acc.w += w * v.w;
    }
    const float d = dsm[r];
    uint2 pk;
    pk.x = attn::pack_bf16(acc.x / d, acc.y / d);
    pk.y = attn::pack_bf16(acc.z / d, acc.w / d);
    *reinterpret_cast<uint2*>(out + (prow0 + r) * hd + c) = pk;
  }
  if (tid == 0) *ticket = 0;    // ready for the next launch
}

// a variant: HDP (hd padded to a multiple of 16), KT keys per tile (64;
// 32 at HDP 256, where O alone is 128 registers a thread)
template <int HDP, int KT>
struct MmaCfg {
  static constexpr int kHDP = HDP, kKT = KT;
};

// the variant that serves head dim hd (padded to the next of 16, 32, 64,
// 128, 256): f(MmaCfg<...>{})
template <class F>
auto with_variant(int hd, F&& f) {
  if (hd <= 16) return f(MmaCfg<16, 64>{});
  if (hd <= 32) return f(MmaCfg<32, 64>{});
  if (hd <= 64) return f(MmaCfg<64, 64>{});
  if (hd <= 128) return f(MmaCfg<128, 64>{});
  return f(MmaCfg<256, 32>{});
}

size_t bf16_smem_bytes(int hd, int split_keys, int page_size, int n_split) {
  return with_variant(hd, [&](auto cfg) {
    using Cfg = decltype(cfg);
    return mma_smem_bytes(Cfg::kHDP, Cfg::kKT, split_keys / page_size + 2,
                          n_split);
  });
}

int launch_bf16(const void* q, const void* k_chunk, const void* v_chunk,
                const void* k_pool, const void* v_pool, const void* pt_row,
                void* out, void* o_part, void* ml_part, void* tickets, int K,
                int C, int G, int hd, int page_size, int n_pages, int start,
                int chunk_len, int window, float scale, int split_keys,
                int n_split, cudaStream_t stream) {
  return with_variant(hd, [&](auto cfg) {
    using Cfg = decltype(cfg);
    const auto kernel = paged_prefill_mma_kernel<Cfg::kHDP, Cfg::kKT>;
    const size_t smem = bf16_smem_bytes(hd, split_keys, page_size, n_split);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((unsigned)((C * G + kMQ - 1) / kMQ), (unsigned)K,
                    (unsigned)n_split);
    using bf16 = __nv_bfloat16;
    kernel<<<grid, kMThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k_chunk),
        static_cast<const bf16*>(v_chunk), static_cast<const bf16*>(k_pool),
        static_cast<const bf16*>(v_pool), static_cast<const int*>(pt_row),
        static_cast<bf16*>(out), static_cast<float*>(o_part),
        static_cast<float*>(ml_part), static_cast<int*>(tickets), K, C, G,
        hd, page_size, n_pages, start, chunk_len, window,
        scale * attn::kLog2e, split_keys, n_split);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// bytes of dynamic shared memory a block of the bf16 kernel takes (the
// build report prints it beside ptxas's registers)
extern "C" int paged_prefill_smem_bytes(int hd, int split_keys,
                                        int page_size, int n_split) {
  return (int)bf16_smem_bytes(hd, split_keys, page_size, n_split);
}

// q, out: (K, C·G, hd); k_chunk, v_chunk: (K, C, hd); pools:
// (num_pages, page_size, K, hd); all of one dtype (0 = f32, 1 = bf16),
// contiguous, 16-byte aligned, hd a multiple of 8 up to 256; pt_row:
// (n_pages,) int32 (the wrapper checks all of it).  bf16 only: o_part
// (n_split, K, C·G, hd) and ml_part (n_split, K, C·G, 2) f32 scratch,
// tickets (K · ceil(C·G / 64)) int32, zero on entry and left zero; the
// split plan n_split (≤ 64) × split_keys (a multiple of 64) covers the
// slot's keys.  Launches on `stream` and returns cudaGetLastError().
extern "C" int paged_prefill_launch(const void* q, const void* k_chunk,
                                    const void* v_chunk, const void* k_pool,
                                    const void* v_pool, const void* pt_row,
                                    void* out, void* o_part, void* ml_part,
                                    void* tickets, int dtype, int K, int C,
                                    int G, int hd, int page_size, int n_pages,
                                    int start, int chunk_len, int window,
                                    float scale, int split_keys, int n_split,
                                    void* stream) {
  if (K == 0 || C == 0 || G == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_chunk, v_chunk, k_pool, v_pool, pt_row, out, K,
                         C, G, hd, page_size, n_pages, start, chunk_len,
                         window, scale, s);
  if (dtype == 1) {
    if (hd % 8 || hd <= 0 || hd > 256 || n_split < 1 ||
        n_split > kMaxSplits ||
        split_keys < kSplitUnit || split_keys % kSplitUnit || page_size < 1)
      return (int)cudaErrorInvalidValue;
    return launch_bf16(q, k_chunk, v_chunk, k_pool, v_pool, pt_row, out,
                       o_part, ml_part, tickets, K, C, G, hd, page_size,
                       n_pages, start, chunk_len, window, scale, split_keys,
                       n_split, s);
  }
  return (int)cudaErrorInvalidValue;
}
