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
// byte, above the card's ridge in bf16 and far above it in f32.  This
// first version is SIMT (f32 FMAs, no tensor cores), so its own ceiling
// is the 67 TFLOP/s f32 rate, not the 989 TFLOP/s bf16 one; the design
// keeps those FMAs fed:
//
// * one block per (tile of TQ query positions, KV head, batch) holds all
//   G = H/K query heads of its KV head (TQ·G ≤ 64 rows), so each K/V
//   tile is read from device memory once per group;
// * the TPU's sequential kv grid axis becomes a loop over 64-key tiles of
//   the block's live key range only — keys < q_hi + 1 when causal,
//   > q_lo − window with a window — so fully masked tiles are never
//   loaded (the TPU kernel's block skip) and a window's cost scales with
//   the window, not the context;
// * K is stored transposed in shared memory and each thread computes a
//   4 rows × 4 keys tile of scores in registers (one float4 of K and four
//   broadcast q values per depth step), then a 4 rows × DPT dims tile of
//   the output (one vector of V and four broadcast probabilities per key);
// * the running max and denominator of a row live in the registers of the
//   16 threads that share the row; their reductions are shuffles.
//
// Inside a live tile a masked key gets probability exactly 0 and is
// multiplied by it, as in the TPU kernel; keys outside the live range are
// never read, so a NaN there cannot reach any output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

}  // namespace

extern "C" int flash_attention_max_group() { return kRows; }

// q, out: (B, H, Sq, hd); k, v: (B, K, Sk, hd); one dtype (0 = f32,
// 1 = bf16), contiguous, 16-byte aligned, hd a multiple of 8 up to 256,
// H a multiple of K with H / K ≤ 64 (the wrapper checks all of it).
// Launches on `stream` and returns cudaGetLastError().
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
    return launch_hd<__nv_bfloat16>(q, k, v, out, B, H, K, Sq, Sk, hd,
                                    causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
