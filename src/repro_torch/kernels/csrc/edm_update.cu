// Fused EDM optimizer update over the packed (A·rows, 128) f32 bus.
//
// Replaces the Pallas TPU kernel repro/kernels/edm_update.py::_edm_kernel
// (called by edm_update_flat).  Per element:
//
//     m'  = β m + (1−β) g
//     ψ'  = x − α m'
//     φ   = ψ' + x − ψ
//
// Bound on an H100: device-memory bytes.  4 reads + 3 writes of f32 = 28 B
// per element against 7 flops, far below the card's ~20 flop/B ridge for
// f32.  The design therefore only has to stream: each thread moves 16 B per
// operand (float4), neighbouring threads touch neighbouring addresses, and a
// grid-stride loop over a grid sized to fill every SM keeps enough loads in
// flight.  No shared memory: nothing is reused.
//
// Rounding: every operation is an explicitly rounded intrinsic
// (__fmul_rn / __fadd_rn / __fsub_rn), which nvcc never contracts into an
// FMA.  The kernel therefore rounds exactly where the plain PyTorch chain
// does and matches it bit for bit.  (1−β) arrives from the host, computed
// in double and rounded once to f32, as the JAX kernel's Python constant.
//
// In place: m_out may alias m and psi_out may alias psi.  Each thread reads
// all four inputs of an element before it writes any output of that
// element, and no other thread touches that element, so aliasing is safe;
// the pointers are deliberately not __restrict__.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void edm_lane(float x, float g, float m, float psi,
                                         float alpha, float beta,
                                         float one_minus_beta, float& m_new,
                                         float& psi_new, float& phi) {
  m_new = __fadd_rn(__fmul_rn(beta, m), __fmul_rn(one_minus_beta, g));
  psi_new = __fsub_rn(x, __fmul_rn(alpha, m_new));
  phi = __fsub_rn(__fadd_rn(psi_new, x), psi);
}

__global__ void edm_update_kernel(const float4* x, const float4* g,
                                  const float4* m, const float4* psi,
                                  float4* m_out, float4* psi_out,
                                  float4* phi_out, long long n4, float alpha,
                                  float beta, float one_minus_beta) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 xv = x[i];
    const float4 gv = g[i];
    const float4 mv = m[i];
    const float4 pv = psi[i];
    float4 mn, pn, ph;
    edm_lane(xv.x, gv.x, mv.x, pv.x, alpha, beta, one_minus_beta, mn.x, pn.x,
             ph.x);
    edm_lane(xv.y, gv.y, mv.y, pv.y, alpha, beta, one_minus_beta, mn.y, pn.y,
             ph.y);
    edm_lane(xv.z, gv.z, mv.z, pv.z, alpha, beta, one_minus_beta, mn.z, pn.z,
             ph.z);
    edm_lane(xv.w, gv.w, mv.w, pv.w, alpha, beta, one_minus_beta, mn.w, pn.w,
             ph.w);
    m_out[i] = mn;
    psi_out[i] = pn;
    phi_out[i] = ph;
  }
}

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

}  // namespace

// n: number of f32 elements, a multiple of 4; every pointer 16-byte aligned
// (the Python wrapper checks both).  Launches on `stream` and returns
// cudaGetLastError() so a refused launch is reported to the caller.
extern "C" int edm_update_launch(const void* x, const void* g, const void* m,
                                 const void* psi, void* m_out, void* psi_out,
                                 void* phi_out, long long n, float alpha,
                                 float beta, float one_minus_beta,
                                 void* stream) {
  const long long n4 = n / 4;
  if (n4 == 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n4 + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSM;
  if (blocks > cap) blocks = cap;
  edm_update_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float4*>(g),
      static_cast<const float4*>(m), static_cast<const float4*>(psi),
      static_cast<float4*>(m_out), static_cast<float4*>(psi_out),
      static_cast<float4*>(phi_out), n4, alpha, beta, one_minus_beta);
  return (int)cudaGetLastError();
}
