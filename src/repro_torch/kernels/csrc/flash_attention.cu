// Flash GQA attention, forward only: causal and sliding-window masks.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// _flash_kernel (called by flash_attention_kernel_call).  q (B, H, Sq, hd),
// k and v (B, K, Sk, hd), H % K == 0; query head h reads KV head
// h / (H/K).  Positions are absolute from 0 on both axes (top-left
// aligned when Sq != Sk); key k is live for query q iff (not causal or
// k <= q) and (window == 0 or k > q − window).  Scores are (q·scale)·k
// with scale = hd^-0.5, the softmax is online and accumulated in f32, and
// the output is rounded once to q's dtype.  A row with no live key
// outputs 0 (its denominator stays 0 and is clamped to 1e-30, as in the
// TPU kernel).
//
// Bound on an H100: operations.  Each live (query, key) pair costs 4·hd
// flops (the score's and the p·v product's multiply-adds) against
// 2·hd·(2 or 4) bytes of K and V that every query head of a group shares:
// at the smollm_360m shapes (G = 3, hd = 64) that is hundreds of flops per
// byte, above the card's ridge in bf16 and far above it in f32.
//
// bf16: tensor cores (wgmma, 989 TFLOP/s), fed by TMA.  One block per
// (128 query positions, query head, batch): three warpgroups, a producer
// and two consumers of 64 query rows each; setmaxnreg gives the
// producer's registers (24 a thread) to the consumers (240).  The G query
// heads of a KV head are separate blocks; their K/V re-reads come from L2.
//
// * The producer's one thread loads the block's Q tile once and then the
//   K and V tiles of the block's live key range — keys < q_hi + 1 when
//   causal, > q_lo − window with a window — by TMA (2-D tensor maps over
//   (rows, hd), encoded on the host per call, 128-byte swizzle) into a
//   ring of 2 stages gated by full / empty mbarriers, so the next
//   tiles' loads overlap this tile's products.  Fully masked tiles are
//   never loaded, and a window's cost scales with the window.
// * Each consumer computes its 64 × BK scores by wgmma (bf16 in, f32
//   accumulate, Q and K from shared memory), masks them in registers
//   (only tiles that cross the diagonal, the window's edge or the range's
//   end test each element), and runs the online softmax in the
//   accumulator layout (a row's reductions are two shuffles of a quad),
//   in the exp2 domain with the scale folded into one FMA an element.
// * O += P·V by wgmma with P from registers (as P_hi + P_lo, two bf16
//   terms: see attn_mma.cuh) and V from shared memory, transposed.
// * hd is padded to a multiple of 64 (the TMA box's zero fill past the
//   tensor's last column); the key tile is 128 at hd ≤ 64 and 64 above,
//   and hd 256 takes one consumer warpgroup (registers: see WgCfg).
// * NaN safety: TMA fills zeros only past the tensor's edge.  Keys past
//   k_end inside the block's last tile are real memory, and 0·NaN is NaN
//   inside a tensor-core product, so that tile's V rows past k_end are
//   zeroed in shared memory before P·V; their scores are masked to −inf
//   by a select, so their K rows never matter.
// * Causal blocks are issued heaviest first (the last query block first).
//
// The tensor work is 1.5× a plain flash kernel's (P·V twice, for P_hi and
// P_lo); at the smollm_360m shapes what bounds it beyond that is each
// 128-key tile's softmax (the consumers run at 168 registers) and each
// block's first-tile latency (one block an SM).
//
// f32: SIMT, a thread computing a 4 × 4 tile of scores and a 4 × DPT tile
// of the output with f32 FMAs (67 TFLOP/s at most).  The tensor cores'
// only f32 input type is TF32, which rounds q, k and v to 10-bit
// mantissas, far outside the f32 gate (atol 2e-5):
//
// * one block per (tile of TQ query positions, KV head, batch) holds all
//   G = H/K query heads of its KV head (TQ·G ≤ 64 rows), so each K/V
//   tile is read from device memory once per group;
// * a loop over 64-key tiles of the block's live key range only;
// * K is stored transposed in shared memory and each thread computes a
//   4 rows × 4 keys tile of scores in registers (one float4 of K and four
//   broadcast q values per depth step), then a 4 rows × DPT dims tile of
//   the output (one vector of V and four broadcast probabilities per key);
// * the running max and denominator of a row live in the registers of the
//   16 threads that share the row; their reductions are shuffles.
//
// Inside a live tile a masked key gets probability exactly 0 and is
// multiplied by it, as in the TPU kernel; keys outside the live range are
// never read (f32) or never reach a product (bf16), so a NaN there cannot
// reach any output.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 16;             // row groups; key / dim groups
constexpr int kMR = 4;                  // query rows per row group
constexpr int kRows = kGroups * kMR;    // query rows per block (TQ·G)
constexpr int kTK = 64;                 // keys per tile, 4 per key group
constexpr int kPS = kTK + 1;            // probability tile row stride

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void store(float v, float* p) { *p = v; }

// reductions over the 16 lanes of a half-warp (one row group)
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// DPT output dims per thread; the V tile rows are kGroups·DPT ≥ hd wide,
// zero past hd.
template <int DPT>
__host__ __device__ constexpr int v_stride() { return kGroups * DPT; }

// Shared memory, in floats: q·scale (kRows × (hd+1)), Kᵀ tile (hd × kTK),
// V tile (kTK × v_stride), probabilities (kRows × kPS).
template <int DPT>
__host__ __device__ inline long long smem_floats(int hd) {
  return (long long)kRows * (hd + 1) + (long long)hd * kTK +
         (long long)kTK * v_stride<DPT>() + (long long)kRows * kPS;
}

template <int DPT>
__device__ __forceinline__ void load_v(const float* p, float* out) {
  if constexpr (DPT == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    out[0] = a.x; out[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < DPT / 4; ++i) {
      const float4 a = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = a.x; out[4 * i + 1] = a.y;
      out[4 * i + 2] = a.z; out[4 * i + 3] = a.w;
    }
  }
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int K, int Sq, int Sk, int hd, int G, int TQ,
                       int causal, int window, float scale) {
  extern __shared__ float smem[];
  constexpr int VS = v_stride<DPT>();
  const int qs_stride = hd + 1;
  float* qs = smem;
  float* ks = qs + kRows * qs_stride;
  float* vs = ks + hd * kTK;
  float* ps = vs + kTK * VS;

  const int q0 = blockIdx.x * TQ;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lo = tid & (kGroups - 1);   // key group (scores), dim group (p·v)
  const int rg = tid / kGroups;         // row group: rows rg·kMR + i
  const int R = TQ * G;                 // block row r = g·TQ + i
  const int nq = min(TQ, Sq - q0);
  const int hd8 = hd / 8;

  for (int idx = tid; idx < R * hd8; idx += kThreads) {
    const int r = idx / hd8, c = (idx % hd8) * 8;
    const int g = r / TQ, i = r % TQ;
    float v8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (i < nq)
      load8(q + (((long long)b * H + (long long)kh * G + g) * Sq + q0 + i) *
                    hd + c, v8);
#pragma unroll
    for (int e = 0; e < 8; ++e) qs[r * qs_stride + c + e] = v8[e] * scale;
  }
  if (VS > hd) {
    for (int idx = tid; idx < kTK * (VS - hd); idx += kThreads)
      vs[(idx / (VS - hd)) * VS + hd + idx % (VS - hd)] = 0.f;
  }

  int qpos[kMR];
  bool live_row[kMR];
  float m_i[kMR], l_i[kMR], acc[kMR][DPT];
#pragma unroll
  for (int i = 0; i < kMR; ++i) {
    const int r = rg * kMR + i;
    live_row[i] = r < R && (r % TQ) < nq;
    qpos[i] = q0 + (r % TQ);
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;
  }

  // the block's live key range
  const int q_hi = q0 + nq - 1;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int k_start = window ? max(0, q0 - window + 1) : 0;
  const long long kv_base = ((long long)b * K + kh) * Sk;

  for (int k0 = k_start; k0 < k_end; k0 += kTK) {
    const int n = min(kTK, k_end - k0);
    __syncthreads();   // the previous tile's readers are done
    // Kᵀ: consecutive threads take consecutive keys (conflict-free stores)
    for (int idx = tid; idx < kTK * hd8; idx += kThreads) {
      const int j = idx % kTK, c = (idx / kTK) * 8;
      float v8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (j < n) load8(k + (kv_base + k0 + j) * hd + c, v8);
#pragma unroll
      for (int e = 0; e < 8; ++e) ks[(c + e) * kTK + j] = v8[e];
    }
    for (int idx = tid; idx < kTK * hd8; idx += kThreads) {
      const int j = idx / hd8, c = (idx % hd8) * 8;
      float v8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (j < n) load8(v + (kv_base + k0 + j) * hd + c, v8);
#pragma unroll
      for (int e = 0; e < 8; ++e) vs[j * VS + c + e] = v8[e];
    }
    __syncthreads();

    // scores: rows rg·kMR + i, keys lo·4 + jj
    float s[kMR][4];
#pragma unroll
    for (int i = 0; i < kMR; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    const float* qrow = qs + rg * kMR * qs_stride;
    for (int d = 0; d < hd; ++d) {
      const float4 kv = *reinterpret_cast<const float4*>(ks + d * kTK + lo * 4);
#pragma unroll
      for (int i = 0; i < kMR; ++i) {
        const float qv = qrow[i * qs_stride + d];
        s[i][0] = fmaf(qv, kv.x, s[i][0]);
        s[i][1] = fmaf(qv, kv.y, s[i][1]);
        s[i][2] = fmaf(qv, kv.z, s[i][2]);
        s[i][3] = fmaf(qv, kv.w, s[i][3]);
      }
    }

    // mask, then the online softmax of each row
#pragma unroll
    for (int i = 0; i < kMR; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = lo * 4 + jj, kp = k0 + j;
        const bool ok = live_row[i] && j < n &&
                        (!causal || kp <= qpos[i]) &&
                        (!window || kp > qpos[i] - window);
        if (!ok) s[i][jj] = -INFINITY;
        mx = fmaxf(mx, s[i][jj]);
      }
      mx = group_max(mx);
      const float m_new = fmaxf(m_i[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = m_new == -INFINITY ? 0.f : expf(s[i][jj] - m_new);
        s[i][jj] = p;
        sum += p;
      }
      sum = group_sum(sum);
      const float alpha = m_new == -INFINITY ? 1.f : expf(m_i[i] - m_new);
      l_i[i] = alpha * l_i[i] + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[i][d] *= alpha;
      float* prow = ps + (rg * kMR + i) * kPS + lo * 4;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) prow[jj] = s[i][jj];
    }
    __syncthreads();

    // acc += p · v over the tile's keys; this thread's dims lo·DPT + d
    const float* prow = ps + rg * kMR * kPS;
    for (int j = 0; j < n; ++j) {
      float vv[DPT];
      load_v<DPT>(vs + j * VS + lo * DPT, vv);
#pragma unroll
      for (int i = 0; i < kMR; ++i) {
        const float p = prow[i * kPS + j];
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[i][d] = fmaf(p, vv[d], acc[i][d]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMR; ++i) {
    if (!live_row[i]) continue;
    const int r = rg * kMR + i;
    const int g = r / TQ;
    T* orow = out + (((long long)b * H + (long long)kh * G + g) * Sq +
                     qpos[i]) * hd;
    const float denom = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int d = 0; d < DPT; ++d) {
      const int dd = lo * DPT + d;
      if (dd < hd) store(acc[i][d] / denom, orow + dd);
    }
  }
}

template <typename T, int DPT>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int K, int Sq, int Sk, int hd, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<DPT>(hd) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int G = H / K;
  const int TQ = kRows / G;
  const dim3 grid((unsigned)((Sq + TQ - 1) / TQ), (unsigned)K, (unsigned)B);
  flash_attention_kernel<T, DPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, K, Sq, Sk, hd, G, TQ,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int H, int K, int Sq, int Sk, int hd, int causal, int window,
              float scale, cudaStream_t s) {
  if (hd <= 2 * kGroups)
    return launch<T, 2>(q, k, v, out, B, H, K, Sq, Sk, hd, causal, window,
                        scale, s);
  if (hd <= 4 * kGroups)
    return launch<T, 4>(q, k, v, out, B, H, K, Sq, Sk, hd, causal, window,
                        scale, s);
  if (hd <= 8 * kGroups)
    return launch<T, 8>(q, k, v, out, B, H, K, Sq, Sk, hd, causal, window,
                        scale, s);
  return launch<T, 16>(q, k, v, out, B, H, K, Sq, Sk, hd, causal, window,
                       scale, s);
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int kStages = 2;   // K/V stages (3 measured slower: the first
                             // tile shares the start with two more)

// A variant: HDP (hd padded to a multiple of 64), BK keys per tile, NWG
// consumer warpgroups of 64 query rows each.  ptxas sizes the consumers'
// code to the launch bound's 65,536 / threads registers a thread (168
// for three warpgroups, 255 for two; setmaxnreg moves registers at run
// time but does not raise that), so the accumulators — O (HDP/2 floats),
// S (BK/2) and P as hi + lo (BK/2 words) — must fit it: hd ≤ 64 takes
// 128-key tiles, hd ≤ 192 64-key tiles, hd 256 one consumer warpgroup.
template <int HDP, int BK, int NWG>
struct WgCfg {
  static constexpr int kHDP = HDP, kBK = BK, kNWG = NWG;
  static constexpr int kBQ = 64 * NWG;            // query rows per block
  static constexpr int kThreads = 128 * (NWG + 1);
  static constexpr int kConsumers = 128 * NWG;
  // shared memory: Q (HDP/64 blocks × kBQ rows × 128 B), K and V stages
  // (HDP/64 blocks × BK rows × 128 B each), then the barriers; plus 1,024
  // bytes to align the tiles to the swizzle's 1,024-byte groups
  static constexpr uint32_t kQBytes = (HDP / 64) * kBQ * 128;
  static constexpr uint32_t kKVBytes = (HDP / 64) * BK * 128;
  static constexpr uint32_t kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 2 * kStages);
};

template <int HDP, int BK, int NWG>
__global__ void __launch_bounds__(WgCfg<HDP, BK, NWG>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                   const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv,
                   __nv_bfloat16* __restrict__ out, int H, int K, int Sq,
                   int Sk, int hd, int causal, int window, float scale_log2) {
  using Cfg = WgCfg<HDP, BK, NWG>;
  constexpr int NCB = HDP / 64;                   // 64-column blocks
  constexpr int kBQ = Cfg::kBQ;
  constexpr int kConsumerThreads = Cfg::kConsumers;
  constexpr uint32_t QB = Cfg::kQBytes;
  constexpr uint32_t KVB = Cfg::kKVBytes;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = attn::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + QB;                  // stage i at + i·KVB
  const uint32_t v_s = k_s + kStages * KVB;
  const uint32_t q_bar = v_s + kStages * KVB;
  const uint32_t full_bar = q_bar + 8;            // stage i at + 8·i
  const uint32_t empty_bar = full_bar + 8 * kStages;

  // the block's query rows and live key range; causal blocks heaviest first
  const int qb = causal ? (int)gridDim.x - 1 - (int)blockIdx.x
                        : (int)blockIdx.x;
  const int q0 = qb * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int nq = min(kBQ, Sq - q0);
  const int k_end = causal ? min(Sk, q0 + nq) : Sk;
  const int k_start = window ? max(0, q0 - window + 1) : 0;
  const int n_tiles = k_end > k_start ? (k_end - k_start + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full_bar + 8 * s, 1);
      hopper::mbar_init(empty_bar + 8 * s, kConsumerThreads);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every load
    if constexpr (NWG == 2) hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(q_bar, QB);
      const int q_row = (b * H + h) * Sq + q0;
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
        hopper::tma_load_2d(q_s + cb * kBQ * 128, &tmq, q_bar, cb * 64, q_row);
      const int kv_row = (b * K + kh) * Sk + k_start;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages)
          hopper::mbar_wait(empty_bar + 8 * s, ((t / kStages) - 1) & 1);
        hopper::mbar_expect_tx(full_bar + 8 * s, 2 * KVB);
        const int row = kv_row + t * BK;
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb) {
          hopper::tma_load_2d(k_s + s * KVB + cb * BK * 128, &tmk,
                              full_bar + 8 * s, cb * 64, row);
          hopper::tma_load_2d(v_s + s * KVB + cb * BK * 128, &tmv,
                              full_bar + 8 * s, cb * 64, row);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows q0 + 64·cw ... + 63
  if constexpr (NWG == 2) hopper::setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int ct = threadIdx.x - 128;               // consumer thread
  const int warp = (ct % 128) / 32, lane = ct % 32;
  const int wg_lo = q0 + 64 * cw;
  const int r0 = wg_lo + 16 * warp + lane / 4;    // rows of d[4j], d[4j+1]
  const int r1 = r0 + 8;                          // rows of d[4j+2], d[4j+3]
  const int cq = 2 * (lane % 4);                  // column within a chunk

  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const uint32_t q_wg = q_s + cw * 64 * 128;

  hopper::mbar_wait(q_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    hopper::mbar_wait(full_bar + 8 * s, (t / kStages) & 1);
    const int k0 = k_start + t * BK;
    const int n = min(BK, k_end - k0);
    const uint32_t ks = k_s + s * KVB, vs = v_s + s * KVB;
    if (n < BK) {
      // the range's last tile: zero V rows n .. BK−1 (real memory that may
      // hold NaN) before any product reads them
      uint4* vp = reinterpret_cast<uint4*>(base_ptr + (vs - base));
      const int rows = BK - n;
      for (int i = ct; i < rows * 8 * NCB; i += kConsumerThreads) {
        const int cb = i / (rows * 8), rem = i % (rows * 8);
        vp[(cb * BK + n + rem / 8) * 8 + rem % 8] = make_uint4(0, 0, 0, 0);
      }
      hopper::fence_proxy_async();
      asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumerThreads) : "memory");
    }

    // S = Q·Kᵀ, 64 × BK, f32
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;   // 16-deep slice of a block
      hopper::WgmmaSS<BK>::mma(
          sc, hopper::desc_kmajor(q_wg + (kk / 4) * kBQ * 128 + off),
          hopper::desc_kmajor(ks + (kk / 4) * BK * 128 + off), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // mask, then the online softmax in the exp2 domain (the scale folded
    // into one FMA an element)
    const bool need_mask = n < BK || (causal && k0 + BK - 1 > wg_lo) ||
                           (window && k0 <= wg_lo + 63 - window);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e];
        if (need_mask) {
          const int kp = k0 + 8 * j + cq + (e & 1);
          const int qp = e < 2 ? r0 : r1;
          const bool ok = kp < k_end && (!causal || kp <= qp) &&
                          (!window || kp > qp - window);
          x = ok ? x : -INFINITY;
        }
        sc[4 * j + e] = x;
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
      o[4 * j] *= a0; o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1; o[4 * j + 3] *= a1;
    }
    // P as hi + lo bf16 A fragments: k-slice kk holds chunks 2kk, 2kk + 1
    uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p00 = attn::fast_exp2(fmaf(sc[4 * j], scale_log2, -mu0));
      const float p01 = attn::fast_exp2(fmaf(sc[4 * j + 1], scale_log2, -mu0));
      const float p10 = attn::fast_exp2(fmaf(sc[4 * j + 2], scale_log2, -mu1));
      const float p11 = attn::fast_exp2(fmaf(sc[4 * j + 3], scale_log2, -mu1));
      l0 += p00 + p01;
      l1 += p10 + p11;
      const int kk = j / 2, hf = 2 * (j % 2);
      attn::split_bf16(p00, p01, ph[kk][hf], pl[kk][hf]);
      attn::split_bf16(p10, p11, ph[kk][hf + 1], pl[kk][hf + 1]);
    }

    // O += P·V
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = hopper::desc_mnmajor(vs + kk * 16 * 128, BK * 128);
      hopper::WgmmaRS<HDP>::mma(o, ph[kk], dv);
      hopper::WgmmaRS<HDP>::mma(o, pl[kk], dv);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::mbar_arrive(empty_bar + 8 * s);
  }

  // normalise, round once, store the live rows and columns
  const float d0 = fmaxf(attn::quad_sum(l0), 1e-30f);
  const float d1 = fmaxf(attn::quad_sum(l1), 1e-30f);
  const int q_end = q0 + nq;
  __nv_bfloat16* orow0 = out + ((long long)(b * H + h) * Sq + r0) * hd;
  __nv_bfloat16* orow1 = orow0 + 8LL * hd;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int col = 8 * j + cq;
    if (col >= hd) continue;
    if (r0 < q_end)
      *reinterpret_cast<uint32_t*>(orow0 + col) =
          attn::pack_bf16(o[4 * j] / d0, o[4 * j + 1] / d0);
    if (r1 < q_end)
      *reinterpret_cast<uint32_t*>(orow1 + col) =
          attn::pack_bf16(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (the
// build links no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Encode failures come back as kTensorMapError + the CUresult.
constexpr int kTensorMapError = 10000;

// a (rows, hd) bf16 matrix, boxes of 64 columns × box_rows rows, 128-byte
// swizzle, zeros past the edges
int tensor_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int hd,
               long long rows, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)hd, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)hd * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(ptr), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

// the variant that serves head dim hd: f(WgCfg<...>{})
template <class F>
int with_variant(int hd, F&& f) {
  if (hd <= 64) return f(WgCfg<64, 128, 2>{});
  if (hd <= 128) return f(WgCfg<128, 64, 2>{});
  if (hd <= 192) return f(WgCfg<192, 64, 2>{});
  return f(WgCfg<256, 64, 1>{});
}

template <class Cfg>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int H, int K, int Sq, int Sk, int hd, int causal,
                 int window, float scale, cudaStream_t stream) {
  constexpr int HDP = Cfg::kHDP, BK = Cfg::kBK, NWG = Cfg::kNWG;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return kTensorMapError;
  CUtensorMap tq, tk, tv;
  int err = tensor_map(enc, &tq, q, hd, (long long)B * H * Sq, Cfg::kBQ);
  if (!err) err = tensor_map(enc, &tk, k, hd, (long long)B * K * Sk, BK);
  if (!err) err = tensor_map(enc, &tv, v, hd, (long long)B * K * Sk, BK);
  if (err) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma_kernel<HDP, BK, NWG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((Sq + Cfg::kBQ - 1) / Cfg::kBQ), (unsigned)H,
                  (unsigned)B);
  flash_wgmma_kernel<HDP, BK, NWG>
      <<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), H, K, Sq, Sk, hd, causal,
      window, scale * attn::kLog2e);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, int B,
                int H, int K, int Sq, int Sk, int hd, int causal, int window,
                float scale, cudaStream_t s) {
  return with_variant(hd, [&](auto cfg) {
    return launch_wgmma<decltype(cfg)>(q, k, v, out, B, H, K, Sq, Sk, hd,
                                       causal, window, scale, s);
  });
}

}  // namespace

extern "C" int flash_attention_max_group() { return kRows; }



// bytes of dynamic shared memory a block of the bf16 kernel takes at head
// dim hd (the build report prints it beside ptxas's registers)
extern "C" int flash_attention_smem_bytes(int hd) {
  return with_variant(hd, [](auto cfg) { return (int)decltype(cfg)::kSmem; });
}

// q, out: (B, H, Sq, hd); k, v: (B, K, Sk, hd); one dtype (0 = f32,
// 1 = bf16), contiguous, 16-byte aligned, hd a multiple of 8 up to 256,
// H a multiple of K with H / K ≤ 64 (the wrapper checks all of it).
// Launches on `stream` and returns cudaGetLastError() (bf16: or
// kTensorMapError + the CUresult if a tensor map cannot be encoded).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int B, int H, int K, int Sq, int Sk,
                                      int hd, int causal, int window,
                                      float scale, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return (int)cudaSuccess;
  if (K <= 0 || H % K || H / K > kRows || hd % 8 || hd <= 0 ||
      hd > 16 * kGroups)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(q, k, v, out, B, H, K, Sq, Sk, hd, causal,
                            window, scale, s);
  if (dtype == 1)
    return launch_bf16(q, k, v, out, B, H, K, Sq, Sk, hd, causal, window,
                       scale, s);
  return (int)cudaErrorInvalidValue;
}
