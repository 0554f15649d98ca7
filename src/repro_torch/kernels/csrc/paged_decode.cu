// Paged one-token GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_decode_pallas` in
// src/repro/kernels/paged_attention.py:277 (body `_decode_kernel`, :224).
// The plain PyTorch version is `paged_decode_gather` in
// src/repro_torch/kernels/paged_attention.py; the wrapper that launches
// this kernel is `paged_decode_cuda` in the same module.
//
// What it computes: for each sequence b and KV head kv, the G grouped
// query rows q[b, kv] (G, hd) attend to the keys at logical positions
// max(0, q_pos-window+1) .. q_pos, which live in the page pool
// k/v_pages (N, ps, KV, hd) through the per-sequence page table
// page_table[b, :] (P,).  Logits are scaled by 1/sqrt(hd), optionally
// soft-capped, masked, and reduced with an f32 online softmax; the
// output is acc / max(l, 1e-30) in q's dtype.
//
// What bounds it: bytes.  Each decode step reads every used K/V page
// once and does ~4 flops per K/V element read, far below the card's
// flops-per-byte balance, so the least time is the used KV bytes over
// the memory rate.
//
// Design (correct first):
//  * one thread block per (b, kv); the block loads its own q_pos[b] and
//    page_table[b, p] (clamped into [0, N-1], so a bad table entry can
//    never read outside the pool), as the TPU kernel's scalar prefetch
//    did;
//  * a loop inside the block over the logical pages first..min(last,P-1)
//    replaces the TPU grid's sequential page axis; pages outside the
//    live span are never read;
//  * per page: K and V are staged in shared memory as f32 (K rows padded
//    to hd+1 floats against bank conflicts), the G x ps score tile is
//    computed, the per-row running max m, sum l and rescale factor are
//    updated, and the G x hd accumulator (shared memory, f32) is
//    rescaled and accumulated.
//
// Known underfill: B x KV blocks (32 for 4 slots of llama3.2-1b) on 132
// SMs, four block-wide barriers per page and no overlap of the page
// loads with the math.  Splitting over KV pages (flash-decoding) and
// cp.async/TMA staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int32_t* __restrict__ page_table,
    const int32_t* __restrict__ q_pos, T* __restrict__ out, int KV, int G,
    int hd, int N, int ps, int P, int window, float softcap, float scale) {
  const int b = blockIdx.x / KV;
  const int kv = blockIdx.x - b * KV;
  const int tid = threadIdx.x;
  const int ks = hd + 1;  // padded K row stride in shared memory

  extern __shared__ float smem[];
  float* q_s = smem;              // (G, hd)
  float* acc_s = q_s + G * hd;    // (G, hd)
  float* k_s = acc_s + G * hd;    // (ps, hd + 1)
  float* v_s = k_s + ps * ks;     // (ps, hd)
  float* p_s = v_s + ps * hd;     // (G, ps) scores, then probabilities
  float* m_s = p_s + G * ps;      // (G,) running max
  float* l_s = m_s + G;           // (G,) running sum
  float* a_s = l_s + G;           // (G,) rescale factor of this page

  const long long q_off = ((long long)b * KV + kv) * G * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    q_s[i] = to_f32(q[q_off + i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int pos = q_pos[b];
  const int last = pos / ps;
  const int first = window > 0 ? max(pos - (window - 1), 0) / ps : 0;
  const int end = min(last, P - 1);
  const long long row_stride = (long long)KV * hd;   // token rows of a page
  const long long page_stride = (long long)ps * row_stride;
  __syncthreads();

  for (int p = first; p <= end; ++p) {
    const int pid = min(max(page_table[(long long)b * P + p], 0), N - 1);
    const T* kp = k_pages + pid * page_stride + (long long)kv * hd;
    const T* vp = v_pages + pid * page_stride + (long long)kv * hd;
    for (int i = tid; i < ps * hd; i += kThreads) {
      const int t = i / hd;
      const int d = i - t * hd;
      k_s[t * ks + d] = to_f32(kp[t * row_stride + d]);
      v_s[i] = to_f32(vp[t * row_stride + d]);
    }
    __syncthreads();

    for (int i = tid; i < G * ps; i += kThreads) {
      const int g = i / ps;
      const int t = i - g * ps;
      const float* qr = q_s + g * hd;
      const float* kr = k_s + t * ks;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const int kpos = p * ps + t;
      bool ok = kpos <= pos;
      if (window > 0) ok = ok && (kpos > pos - window);
      p_s[i] = ok ? s : kNegInf;
    }
    __syncthreads();

    for (int g = tid; g < G; g += kThreads) {
      float* pr = p_s + g * ps;
      float mx = pr[0];
      for (int t = 1; t < ps; ++t) mx = fmaxf(mx, pr[t]);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float e = expf(pr[t] - m_new);
        pr[t] = e;
        sum += e;
      }
      l_s[g] = l_s[g] * alpha + sum;
      m_s[g] = m_new;
      a_s[g] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd;
      const int d = i - g * hd;
      const float* pr = p_s + g * ps;
      float a = acc_s[i] * a_s[g];
      for (int t = 0; t < ps; ++t) a = fmaf(pr[t], v_s[t * hd + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * hd; i += kThreads) {
    store(&out[q_off + i], acc_s[i] / fmaxf(l_s[i / hd], 1e-30f));
  }
}

constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

// Raises the kernel's dynamic shared-memory limit where a block needs more
// than the default 48 KiB; once per device and instantiation, since the
// decode loop launches it every layer.  A size above what the card allows
// comes back as cudaFuncSetAttribute's error.
template <typename T>
cudaError_t ensure_smem(size_t smem) {
  static size_t configured[kMaxDevices] = {};
  if (smem <= kDefaultSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && configured[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(paged_decode_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) configured[dev] = smem;
  return err;
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* page_table, const void* q_pos, void* out, int B,
                   int KV, int G, int hd, int N, int ps, int P, int window,
                   float softcap, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)2 * G * hd + (size_t)ps * (hd + 1) +
                       (size_t)ps * hd + (size_t)G * ps + 3 * (size_t)G);
  cudaError_t err = ensure_smem<T>(smem);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T><<<B * KV, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(q_pos), static_cast<T*>(out), KV, G, hd, N,
      ps, P, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched).  dtype: 0 = float32, 1 = bfloat16
// (q, the pages and out share it).  window <= 0 disables the sliding
// window; softcap <= 0 disables soft-capping.
int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                 const void* page_table, const void* q_pos, void* out, int B,
                 int KV, int G, int hd, int N, int ps, int P, int window,
                 float softcap, float scale, int dtype, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || N <= 0 || ps <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128 && hd != 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k_pages, v_pages, page_table, q_pos, out, B,
                              KV, G, hd, N, ps, P, window, softcap, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, q_pos,
                                      out, B, KV, G, hd, N, ps, P, window,
                                      softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
