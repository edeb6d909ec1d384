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
// Bound on an H100: device-memory bytes for the launch as a whole: each KV
// row is read once per (slot, head) and used by G query rows, 4·G flops per
// KV element (12 at G = 3, 6 flop/B in bf16), far below the ~295 flop/B at
// which the bf16 tensor cores would bind.  What a serving batch is held
// back by is its longest slot: that slot's keys are one block's serial
// chain unless they are split, and each split's arithmetic sits on the
// chain.  So the design:
//
// * the key range of each (slot, KV head) is split across the n_split
//   blocks of one thread-block cluster: grid (n_split, K·ceil(G/8), B),
//   cluster (n_split, 1, 1), n_split ≤ 8 (the portable cluster size).
//   Block s covers the page-aligned keys [s·split_keys, (s+1)·split_keys)
//   ∩ [0, kv_len).  The plan (paged_attention.py::split_plan) depends on
//   shapes only — never on kv_len — so the launch reads nothing back and
//   stays capturable; a block whose range is empty loads nothing but
//   still joins the merge;
// * a block gathers its keys' K/V rows through the page table into shared
//   memory by 16-byte cp.async (attn_mma.cuh), tile by tile, two tiles in
//   flight: a tile's page-table reads are issued together, then its
//   copies.  Rows past kv_len are zero-filled and read nothing, so no page
//   past the last live one, ceil(kv_len / page_size) − 1, is addressed and
//   no row past kv_len reaches a product; kv_len is clamped to the page
//   table's n_pages · page_size rows, as the TPU grid is;
// * bf16: each warp takes 16 keys of a 64-key tile on the tensor cores
//   (mma.sync m16n8k16), the G ≤ 8 query rows as the first rows of the
//   16-row A operand (its fragments loaded once, straight from q): S = Q·Kᵀ
//   in registers, the online softmax in the accumulator layout in the exp2
//   domain, O += P·V with P as P_hi + P_lo (two bf16 terms, so the
//   products keep ~16 bits of p: attn_mma.cuh).  A key then costs the CUDA
//   cores a few instructions; with the arithmetic on them alone a 64-key
//   tile takes ~1 µs on an H100, which sets the longest split's time;
// * f32: SIMT, as the tensor cores' only f32 input type is TF32, which
//   would break the f32 gate (atol 2e-5) and the f32 engine's exact greedy
//   tokens: a key is handled by a group of lanes (hd/8 rounded up to a
//   power of two), each lane holding 8 elements of q (G rows), of the key
//   row and of the value row; scores reduced by shuffles within the group,
//   an online softmax in registers per group; the groups of a warp merge
//   by shuffles;
// * the four warps' partials (m, l, acc[G·hd]) merge through shared memory
//   into the block's, and the blocks of the cluster through distributed
//   shared memory: each block leaves its partial in its own shared memory,
//   cluster.sync(), then block r reads every peer's partial
//   (map_shared_rank, in split order: deterministic) for its slice of the
//   G·hd outputs and writes them rounded once to q's dtype; a second
//   cluster.sync() keeps every block resident until its peers have read
//   it.  No atomics, no scratch, no state between launches;
// * a split, warp or lane group that saw no key has m = −inf: every merge
//   subtracts max(m) only when it is finite, so exp2(−inf) = 0 and an idle
//   slot (kv_len == 0) writes an exact zero tile (0 / max(0, 1e-30)).
//
// More than 8 query rows a KV head (G > 8) take ceil(G/8) blocks along
// grid y, each re-reading the head's keys for its 8 rows.  Accumulation
// is f32; scores are scaled into the exp2 domain once, in f32.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 8;        // query rows of a group a block takes
constexpr int kMaxSplits = 8;           // blocks a cluster (portable maximum)
constexpr int kStages = 2;              // K/V tiles in flight a block
constexpr int kMmaKeys = 16 * kWarps;   // keys a bf16 tile
constexpr int kSimtStageBytes = 16384;  // K and V rows of an f32 tile
constexpr float kLog2e = 1.4426950408889634f;

// the max to subtract: m itself, or 0 while nothing was seen (m = −inf),
// so that exp2(−inf − 0) = 0 and no merge makes a NaN
__device__ __forceinline__ float finite_or_zero(float m) {
  return m == -INFINITY ? 0.f : m;
}

__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// shared memory: the partials, then the K/V stages
// ---------------------------------------------------------------------------

// The four warps' partials, then the block's, each (m[Gc], l[Gc],
// acc[Gc·hd]) in floats; the block's sits at one offset in every block of
// the cluster, where its peers read it.  The stages follow, 16-byte
// aligned: kStages × (K tile, V tile) of `rows` rows of `rs` elements.
__host__ __device__ __forceinline__ int partial_floats(int Gc, int hd) {
  return Gc * (hd + 2);
}
__host__ __device__ __forceinline__ int partials_bytes(int Gc, int hd) {
  return ((kWarps + 1) * partial_floats(Gc, hd) * 4 + 15) / 16 * 16;
}

// f32 tiles: rows padded by 16 bytes (the lanes of neighbouring keys read
// one column chunk), as many rows as kSimtStageBytes holds
__host__ __device__ __forceinline__ int simt_rs(int hd) { return hd + 4; }
__host__ __device__ __forceinline__ int simt_rows(int hd) {
  const int r = kSimtStageBytes / (2 * simt_rs(hd) * 4);
  return r > 0 ? r : 1;
}
// bf16 tiles: hd padded to HDP (16, 32, 64, 128 or 256), plus 16 bytes a
// row so that ldmatrix's eight row addresses fall in distinct banks
__host__ __device__ __forceinline__ int mma_hdp(int hd) {
  int p = 16;
  while (p < hd) p *= 2;
  return p;
}

__host__ __device__ __forceinline__ int smem_bytes(int Gc, int hd,
                                                   int elem_bytes) {
  const int stage = elem_bytes == 4
                        ? 2 * simt_rows(hd) * simt_rs(hd) * 4
                        : 2 * kMmaKeys * (mma_hdp(hd) + 8) * 2;
  return partials_bytes(Gc, hd) + kStages * stage;
}

// ---------------------------------------------------------------------------
// the gather: page table → cp.async → a stage
// ---------------------------------------------------------------------------

// Pool rows (phys · page_size + t % page_size) of this thread's copies of
// tile rows [t0, t0 + rows), `segs` 16-byte copies a row; −1 for a row at
// or past `end`.  The page-table reads are independent, so they are in
// flight together.
template <int NITEMS>
__device__ __forceinline__ void tile_pool_rows(int (&prow)[NITEMS],
                                               const int* __restrict__ pt,
                                               int t0, int end, int rows,
                                               int segs, int page_size) {
#pragma unroll
  for (int n = 0; n < NITEMS; ++n) {
    const int r = (threadIdx.x + n * kThreads) / segs;
    const int t = t0 + r;
    prow[n] = -1;
    if (r < rows && t < end)
      prow[n] = pt[t / page_size] * page_size + t % page_size;
  }
}

// Copy them into one stage (K tile, V tile; row r at r·rs) as one cp.async
// commit group.  A row past `end`, and a column past hd, is zero-filled and
// reads nothing.
template <typename T, int NITEMS>
__device__ __forceinline__ void tile_copy(
    T* ks, T* vs, const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const int (&prow)[NITEMS], int rows, int segs, int rs, int hd,
    long long row_stride, int kh) {
  constexpr int kChunk = 16 / (int)sizeof(T);   // elements a 16-byte copy
#pragma unroll
  for (int n = 0; n < NITEMS; ++n) {
    const int i = threadIdx.x + n * kThreads;
    const int r = i / segs, c = (i % segs) * kChunk;
    if (r >= rows) continue;
    const int so = r * rs + c;
    if (prow[n] >= 0 && c < hd) {
      const long long off = prow[n] * row_stride + (long long)kh * hd + c;
      attn::cp_async_16(attn::smem_u32(ks + so), k_pool + off, 16);
      attn::cp_async_16(attn::smem_u32(vs + so), v_pool + off, 16);
    } else {
      attn::cp_async_16(attn::smem_u32(ks + so), k_pool, 0);
      attn::cp_async_16(attn::smem_u32(vs + so), v_pool, 0);
    }
  }
}

// Issue the gather of the tile of keys [t0, t0 + rows) ∩ [t0, end) into a
// stage as one commit group (an empty group past `end`).
template <typename T, int NITEMS>
__device__ __forceinline__ void gather(T* ks, const T* __restrict__ k_pool,
                                       const T* __restrict__ v_pool,
                                       const int* __restrict__ pt, int t0,
                                       int end, int rows, int segs, int rs,
                                       int hd, int page_size,
                                       long long row_stride, int kh) {
  if (t0 < end) {
    int prow[NITEMS];
    tile_pool_rows(prow, pt, t0, end, rows, segs, page_size);
    tile_copy(ks, ks + rows * rs, k_pool, v_pool, prow, rows, segs, rs, hd,
              row_stride, kh);
  }
  attn::cp_async_commit();
}

// Run `tile(ks, vs, live_rows)` on every tile of keys [lo, end), `rows`
// keys a tile, the gather of the next tile in flight meanwhile.
template <typename T, int NITEMS, typename F>
__device__ __forceinline__ void for_each_tile(
    T* stage0, const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const int* __restrict__ pt, int lo, int end, int rows, int segs, int rs,
    int hd, int page_size, long long row_stride, int kh, F&& tile) {
  const int n_tiles = (end - lo + rows - 1) / rows;
  const int stage_elems = 2 * rows * rs;
  {
    // both stages' page-table reads first, then both stages' copies
    int prow[kStages][NITEMS];
#pragma unroll
    for (int st = 0; st < kStages; ++st)
      tile_pool_rows(prow[st], pt, lo + st * rows, end, rows, segs,
                     page_size);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      if (st < n_tiles) {
        T* ks = stage0 + st * stage_elems;
        tile_copy(ks, ks + rows * rs, k_pool, v_pool, prow[st], rows, segs,
                  rs, hd, row_stride, kh);
      }
      attn::cp_async_commit();
    }
  }
  for (int it = 0; it < n_tiles; ++it) {
    attn::cp_async_wait<kStages - 1>();    // tile `it` has landed
    __syncthreads();
    T* ks = stage0 + (it % kStages) * stage_elems;
    tile(ks, ks + rows * rs, min(rows, end - (lo + it * rows)));
    __syncthreads();                       // the stage is free again
    gather<T, NITEMS>(ks, k_pool, v_pool, pt, lo + (it + kStages) * rows,
                      end, rows, segs, rs, hd, page_size, row_stride, kh);
  }
}

// ---------------------------------------------------------------------------
// the merges: warps → block (shared memory), blocks → cluster (DSMEM)
// ---------------------------------------------------------------------------

// The block's partial from the four warps' (written to smem before).
__device__ __forceinline__ void merge_warps(const float* smem, float* part,
                                            int Gc, int hd) {
  __syncthreads();
  const int pf = partial_floats(Gc, hd);
  for (int i = threadIdx.x; i < Gc * hd; i += kThreads) {
    const int g = i / hd;
    float mw = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mw = fmaxf(mw, smem[w * pf + g]);
    const float m_use = finite_or_zero(mw);
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(smem[w * pf + g] - m_use);
      a += wt * smem[w * pf + 2 * Gc + i];
      lsum += wt * smem[w * pf + Gc + g];
    }
    part[2 * Gc + i] = a;
    if (i % hd == 0) {
      part[g] = mw;
      part[Gc + g] = lsum;
    }
  }
}

// Which slot, KV head, query rows and keys a block takes.
struct Block {
  int b, kh, g0, Gc, split, lo, end;
};

__device__ __forceinline__ Block block_of(const int* __restrict__ kv_len,
                                          int G, int page_size, int n_pages,
                                          int split_keys) {
  const int n_gch = (G + kRowsPerBlock - 1) / kRowsPerBlock;
  Block k;
  k.split = blockIdx.x;
  k.kh = blockIdx.y / n_gch;
  k.g0 = (blockIdx.y % n_gch) * kRowsPerBlock;
  k.Gc = min(kRowsPerBlock, G - k.g0);
  k.b = blockIdx.z;
  const int len = max(0, min(kv_len[k.b], n_pages * page_size));
  k.lo = k.split * split_keys;
  k.end = min(len, k.lo + split_keys);
  return k;
}

// An empty partial, for a block whose split holds no key.
__device__ __forceinline__ void empty_partial(float* part, int Gc, int hd) {
  for (int i = threadIdx.x; i < Gc * hd; i += kThreads)
    part[2 * Gc + i] = 0.f;
  if (threadIdx.x < Gc) {
    part[threadIdx.x] = -INFINITY;
    part[Gc + threadIdx.x] = 0.f;
  }
}

// Block r of the cluster writes its slice of the Gc·hd outputs from every
// block's partial, in split order (the peers' values loaded together), then
// stays until its peers have read its own.
template <typename T>
__device__ __forceinline__ void merge_cluster(float* part, T* __restrict__ out,
                                              const Block& k, int K, int G,
                                              int hd, int n_split) {
  cg::cluster_group cluster = cg::this_cluster();
  if (n_split > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  const int Gc = k.Gc, total = Gc * hd;
  const int per = (total + n_split - 1) / n_split;
  const int i_lo = k.split * per, i_hi = min(total, i_lo + per);
  T* o = out + (((long long)k.b * K + k.kh) * G + k.g0) * hd;
  for (int i = i_lo + threadIdx.x; i < i_hi; i += kThreads) {
    const int g = i / hd;
    const float* pr[kMaxSplits];
    float ms[kMaxSplits];
    float m_max = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < n_split) {
        pr[r] = n_split > 1 ? cluster.map_shared_rank(part, r) : part;
        ms[r] = pr[r][g];
        m_max = fmaxf(m_max, ms[r]);
      }
    }
    const float m_use = finite_or_zero(m_max);
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < n_split) {
        const float wt = exp2f(ms[r] - m_use);
        a += wt * pr[r][2 * Gc + i];
        lsum += wt * pr[r][Gc + g];
      }
    }
    store(a / fmaxf(lsum, 1e-30f), o + i);
  }
  if (n_split > 1) cluster.sync();
}

// ---------------------------------------------------------------------------
// f32: SIMT
// ---------------------------------------------------------------------------

template <int MAXG>
__global__ void __launch_bounds__(kThreads)
paged_decode_simt_kernel(const float* __restrict__ q,
                         const float* __restrict__ k_pool,
                         const float* __restrict__ v_pool,
                         const int* __restrict__ page_table,
                         const int* __restrict__ kv_len,
                         float* __restrict__ out, int K, int G, int hd,
                         int page_size, int n_pages, float scale,
                         int split_keys, int n_split) {
  constexpr int U = 2;        // keys a lane group takes from a tile at once
  constexpr int NITEMS = 4;   // ≥ simt_rows(hd) · (hd / 4) / kThreads
  extern __shared__ __align__(16) float smem[];
  const Block k = block_of(kv_len, G, page_size, n_pages, split_keys);
  const int Gc = k.Gc, pf = partial_floats(Gc, hd);
  float* part = smem + kWarps * pf;
  if (k.lo >= k.end) {
    empty_partial(part, Gc, hd);
    merge_cluster(part, out, k, K, G, hd, n_split);
    return;
  }
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // lanes of a key group: hd/8 rounded up to a power of two (≤ 32)
  const int hd8 = hd / 8;
  int lpk = 1;
  while (lpk < hd8) lpk <<= 1;
  const int kpw = 32 / lpk;            // keys a warp handles at once
  const int j = lane / lpk, c = lane % lpk;
  const bool has_cols = c < hd8;
  const int keys_per_step = kWarps * kpw;

  float qr[MAXG][8], acc[MAXG][8], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qr[g][e] = 0.f;
      acc[g][e] = 0.f;
    }
    if (g < Gc && has_cols) {
      const float4* qg = reinterpret_cast<const float4*>(
          q + (((long long)k.b * K + k.kh) * G + k.g0 + g) * hd + c * 8);
      const float4 x = __ldg(qg), y = __ldg(qg + 1);
      const float v8[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[g][e] = v8[e] * (scale * kLog2e);
    }
  }

  const int rs = simt_rs(hd);
  float* stage0 = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem) + partials_bytes(Gc, hd));
  for_each_tile<float, NITEMS>(
      stage0, k_pool, v_pool, page_table + (long long)k.b * n_pages, k.lo,
      k.end, simt_rows(hd), hd / 4, rs, hd, page_size, (long long)K * hd,
      k.kh, [&](const float* ks, const float* vs, int live_rows) {
        for (int r0 = 0; r0 < live_rows; r0 += keys_per_step * U) {
          float kf[U][8], vf[U][8];
          bool live[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int r = r0 + u * keys_per_step + warp * kpw + j;
            live[u] = r < live_rows;
#pragma unroll
            for (int e = 0; e < 8; ++e) kf[u][e] = vf[u][e] = 0.f;
            if (live[u] && has_cols) {
              const float4* kp =
                  reinterpret_cast<const float4*>(ks + r * rs + c * 8);
              const float4* vp =
                  reinterpret_cast<const float4*>(vs + r * rs + c * 8);
              const float4 k0 = kp[0], k1 = kp[1], v0 = vp[0], v1 = vp[1];
              kf[u][0] = k0.x; kf[u][1] = k0.y; kf[u][2] = k0.z;
              kf[u][3] = k0.w; kf[u][4] = k1.x; kf[u][5] = k1.y;
              kf[u][6] = k1.z; kf[u][7] = k1.w;
              vf[u][0] = v0.x; vf[u][1] = v0.y; vf[u][2] = v0.z;
              vf[u][3] = v0.w; vf[u][4] = v1.x; vf[u][5] = v1.y;
              vf[u][6] = v1.z; vf[u][7] = v1.w;
            }
          }
          float s[U][MAXG];
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int g = 0; g < MAXG; ++g) {
              float d = 0.f;
#pragma unroll
              for (int e = 0; e < 8; ++e) d = fmaf(qr[g][e], kf[u][e], d);
              s[u][g] = d;
            }
          // dot products across the group's lanes (groups are aligned
          // blocks of lpk lanes, so xor offsets below lpk stay inside one)
          for (int o = lpk >> 1; o > 0; o >>= 1) {
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
              for (int g = 0; g < MAXG; ++g)
                s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);
          }
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            float mx = -INFINITY;
#pragma unroll
            for (int u = 0; u < U; ++u) {
              s[u][g] = live[u] ? s[u][g] : -INFINITY;
              mx = fmaxf(mx, s[u][g]);
            }
            const float m_new = fmaxf(m[g], mx);
            const float m_use = finite_or_zero(m_new);
            const float alpha = exp2f(m[g] - m_use);
            l[g] *= alpha;
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
            m[g] = m_new;
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const float p = exp2f(s[u][g] - m_use);   // a dead key: 0
              l[g] += p;
#pragma unroll
              for (int e = 0; e < 8; ++e)
                acc[g][e] = fmaf(p, vf[u][e], acc[g][e]);
            }
          }
        }
      });

  // merge the warp's groups (same column chunk c, lanes lpk apart)
  for (int o = lpk; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float m_new = fmaxf(m[g], m_o);
      const float m_use = finite_or_zero(m_new);
      const float a = exp2f(m[g] - m_use), bo = exp2f(m_o - m_use);
      l[g] = l[g] * a + l_o * bo;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = acc[g][e] * a + acc_o * bo;
      }
      m[g] = m_new;
    }
  }
  float* wpart = smem + warp * pf;
  if (j == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= Gc) break;
      if (c == 0) {
        wpart[g] = m[g];
        wpart[Gc + g] = l[g];
      }
      if (has_cols) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          wpart[2 * Gc + g * hd + c * 8 + e] = acc[g][e];
      }
    }
  }
  merge_warps(smem, part, Gc, hd);
  merge_cluster(part, out, k, K, G, hd, n_split);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// HDP: hd padded to 16, 32, 64, 128 or 256 (columns past hd are zero).
template <int HDP>
__global__ void __launch_bounds__(kThreads)
paged_decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k_pool,
                        const __nv_bfloat16* __restrict__ v_pool,
                        const int* __restrict__ page_table,
                        const int* __restrict__ kv_len,
                        __nv_bfloat16* __restrict__ out, int K, int G, int hd,
                        int page_size, int n_pages, float scale,
                        int split_keys, int n_split) {
  constexpr int RS = HDP + 8;
  constexpr int SEGS = HDP / 8;                      // 16-byte copies a row
  constexpr int NITEMS = kMmaKeys * SEGS / kThreads;
  extern __shared__ __align__(16) float smem[];
  const Block k = block_of(kv_len, G, page_size, n_pages, split_keys);
  const int Gc = k.Gc, pf = partial_floats(Gc, hd);
  float* part = smem + kWarps * pf;
  if (k.lo >= k.end) {
    empty_partial(part, Gc, hd);
    merge_cluster(part, out, k, K, G, hd, n_split);
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, cq = 2 * (lane % 4);   // accumulator row, columns
  const float scale_log2 = scale * kLog2e;

  // A fragments of Q, row g (rows 8–15 of the operand are zero), a k-step
  // of 16 columns: a0 = columns cq, cq + 1; a2 = columns 8 + cq, 9 + cq
  uint32_t qa[HDP / 16][2];
  const __nv_bfloat16* qg =
      q + (((long long)k.b * K + k.kh) * G + k.g0 + g) * hd;
#pragma unroll
  for (int kq = 0; kq < HDP / 16; ++kq)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = kq * 16 + h * 8 + cq;
      qa[kq][h] = g < Gc && col < hd
                      ? __ldg(reinterpret_cast<const unsigned int*>(qg + col))
                      : 0u;
    }

  float o[HDP / 8][4];
#pragma unroll
  for (int jj = 0; jj < HDP / 8; ++jj)
    o[jj][0] = o[jj][1] = o[jj][2] = o[jj][3] = 0.f;
  float m0 = -INFINITY, l0 = 0.f;

  __nv_bfloat16* stage0 = reinterpret_cast<__nv_bfloat16*>(
      reinterpret_cast<char*>(smem) + partials_bytes(Gc, hd));
  for_each_tile<__nv_bfloat16, NITEMS>(
      stage0, k_pool, v_pool, page_table + (long long)k.b * n_pages, k.lo,
      k.end, kMmaKeys, SEGS, RS, hd, page_size, (long long)K * hd, k.kh,
      [&](const __nv_bfloat16* kt, const __nv_bfloat16* vt, int live_rows) {
        const int r0 = 16 * warp;               // this warp's 16 keys
        if (r0 >= live_rows) return;
        // S = Q·Kᵀ: 16 query rows (Gc live) × 16 keys
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kq = 0; kq < HDP / 16; ++kq) {
          const uint32_t a[4] = {qa[kq][0], 0u, qa[kq][1], 0u};
          uint32_t bb[4];
          attn::ldmatrix_x4(
              bb, attn::smem_u32(kt + (r0 + lane % 8 + (lane / 16) * 8) * RS +
                                 kq * 16 + ((lane / 8) % 2) * 8));
          attn::mma_16816(sc[0], a, bb[0], bb[1]);
          attn::mma_16816(sc[1], a, bb[2], bb[3]);
        }
        // the online softmax of row g; keys past the live rows are −inf
        float mx = -INFINITY;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok = r0 + 8 * h + cq + e < live_rows;
            sc[h][e] = ok ? sc[h][e] : -INFINITY;
            mx = fmaxf(mx, sc[h][e]);
          }
        float mu;
        const float alpha =
            attn::online_step(attn::quad_max(mx) * scale_log2, m0, mu);
        l0 *= alpha;
#pragma unroll
        for (int jj = 0; jj < HDP / 8; ++jj) {
          o[jj][0] *= alpha;
          o[jj][1] *= alpha;
        }
        // O += P·V over the 16 keys, P as hi + lo (rows 8–15 zero)
        uint32_t ph[4] = {0u, 0u, 0u, 0u}, pl[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p0 = attn::fast_exp2(fmaf(sc[h][0], scale_log2, -mu));
          const float p1 = attn::fast_exp2(fmaf(sc[h][1], scale_log2, -mu));
          l0 += p0 + p1;
          attn::split_bf16(p0, p1, ph[2 * h], pl[2 * h]);
        }
#pragma unroll
        for (int np = 0; np < HDP / 16; ++np) {
          uint32_t bb[4];
          attn::ldmatrix_x4_trans(
              bb, attn::smem_u32(
                      vt + (r0 + lane % 8 + ((lane / 8) % 2) * 8) * RS +
                      np * 16 + (lane / 16) * 8));
          attn::mma_16816(o[2 * np], ph, bb[0], bb[1]);
          attn::mma_16816(o[2 * np], pl, bb[0], bb[1]);
          attn::mma_16816(o[2 * np + 1], ph, bb[2], bb[3]);
          attn::mma_16816(o[2 * np + 1], pl, bb[2], bb[3]);
        }
      });

  l0 = attn::quad_sum(l0);
  float* wpart = smem + warp * pf;
  if (g < Gc) {
    if (lane % 4 == 0) {
      wpart[g] = m0;
      wpart[Gc + g] = l0;
    }
#pragma unroll
    for (int jj = 0; jj < HDP / 8; ++jj) {
      const int col = 8 * jj + cq;
      if (col < hd) {
        wpart[2 * Gc + g * hd + col] = o[jj][0];
        wpart[2 * Gc + g * hd + col + 1] = o[jj][1];
      }
    }
  }
  merge_warps(smem, part, Gc, hd);
  merge_cluster(part, out, k, K, G, hd, n_split);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T>
struct LaunchArgs {
  const T* q;
  const T* k_pool;
  const T* v_pool;
  const int* page_table;
  const int* kv_len;
  T* out;
  int B, K, G, hd, page_size, n_pages;
  float scale;
  int split_keys, n_split;
  cudaStream_t stream;
};

// One launch of `kernel` over grid (n_split, K·ceil(G/8), B) in clusters
// of n_split blocks.
template <typename T, typename... KArgs>
int launch_with(void (*kernel)(KArgs...), const LaunchArgs<T>& a) {
  const int smem = smem_bytes(a.G < kRowsPerBlock ? a.G : kRowsPerBlock,
                              a.hd, (int)sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_gch = (a.G + kRowsPerBlock - 1) / kRowsPerBlock;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =
      dim3((unsigned)a.n_split, (unsigned)(a.K * n_gch), (unsigned)a.B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, a.q, a.k_pool, a.v_pool, a.page_table, a.kv_len, a.out,
      a.K, a.G, a.hd, a.page_size, a.n_pages, a.scale, a.split_keys,
      a.n_split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch(const LaunchArgs<float>& a) {
  // registers hold MAXG query rows: the smallest bucket that fits G
  if (a.G <= 1) return launch_with(paged_decode_simt_kernel<1>, a);
  if (a.G <= 2) return launch_with(paged_decode_simt_kernel<2>, a);
  if (a.G <= 3) return launch_with(paged_decode_simt_kernel<3>, a);
  if (a.G <= 4) return launch_with(paged_decode_simt_kernel<4>, a);
  return launch_with(paged_decode_simt_kernel<8>, a);
}

int launch(const LaunchArgs<__nv_bfloat16>& a) {
  switch (mma_hdp(a.hd)) {
    case 16: return launch_with(paged_decode_mma_kernel<16>, a);
    case 32: return launch_with(paged_decode_mma_kernel<32>, a);
    case 64: return launch_with(paged_decode_mma_kernel<64>, a);
    case 128: return launch_with(paged_decode_mma_kernel<128>, a);
    default: return launch_with(paged_decode_mma_kernel<256>, a);
  }
}

template <typename T>
int launch_typed(const void* q, const void* k_pool, const void* v_pool,
                 const void* page_table, const void* kv_len, void* out, int B,
                 int K, int G, int hd, int page_size, int n_pages, float scale,
                 int split_keys, int n_split, cudaStream_t stream) {
  const LaunchArgs<T> a{
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(kv_len), static_cast<T*>(out), B, K, G, hd,
      page_size, n_pages, scale, split_keys, n_split, stream};
  return launch(a);
}

}  // namespace

// Dynamic shared memory of one block for G query rows a KV head at head
// dim hd, for dtype 0 (f32) or 1 (bf16): what chip_smoke.py reports.
extern "C" int paged_attention_smem_bytes(int G, int hd, int dtype) {
  return smem_bytes(G < kRowsPerBlock ? G : kRowsPerBlock, hd,
                    dtype == 0 ? 4 : 2);
}

// q, out: (B, K, G, hd); pools: (num_pages, page_size, K, hd), all of one
// dtype (0 = f32, 1 = bf16), contiguous, 16-byte aligned, hd a multiple of
// 8 up to 256; page_table: (B, n_pages) int32; kv_len: (B,) int32 (the
// wrapper checks all of it).  The key split (split_keys, a multiple of
// page_size; n_split in [1, 8], with n_split·split_keys ≥ n_pages·
// page_size) is the wrapper's split_plan.  Launches on `stream` and returns
// the launch's CUDA status.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* page_table,
                                      const void* kv_len, void* out,
                                      int dtype, int B, int K, int G, int hd,
                                      int page_size, int n_pages, float scale,
                                      int split_keys, int n_split,
                                      void* stream) {
  if (B == 0 || K == 0 || G == 0) return (int)cudaSuccess;
  if (n_split < 1 || n_split > kMaxSplits || split_keys < 1 || hd % 8 ||
      hd > 256)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(q, k_pool, v_pool, page_table, kv_len, out, B,
                               K, G, hd, page_size, n_pages, scale,
                               split_keys, n_split, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k_pool, v_pool, page_table, kv_len,
                                       out, B, K, G, hd, page_size, n_pages,
                                       scale, split_keys, n_split, s);
  return (int)cudaErrorInvalidValue;
}
