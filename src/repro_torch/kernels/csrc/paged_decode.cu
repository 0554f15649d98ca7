// Paged one-token GQA decode attention for Hopper (sm_90a), split over the
// KV pages (flash-decoding).
//
// Replaces the TPU kernel `paged_decode_pallas` in
// src/repro/kernels/paged_attention.py:277 (body `_decode_kernel`, :224).
// The plain PyTorch version is `paged_decode_gather` in
// src/repro_torch/kernels/paged_attention.py; the wrapper that launches
// this kernel is `paged_decode_cuda` in the same module, which also picks
// the split count (`decode_splits`).
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
// the memory rate.  A decode batch is small (B x KV = 32-64 (b, kv)
// pairs for 4-8 slots), so the card fills only if each pair's pages are
// split over many blocks, and each block must keep page loads in flight.
//
// Design:
//  * the grid is (B * KV, splits); block (bkv, s) owns the contiguous
//    logical pages [s * pps, (s + 1) * pps) of its sequence's table,
//    intersected with the live span first..min(last, P-1).  The wrapper
//    picks splits from the shapes alone (B * KV against the SMs, and P),
//    never from q_pos, which lives on the card: no host sync.  A block
//    whose range lies wholly outside the live span writes an empty
//    partial (m = -1e30, l = 0, acc = 0);
//  * each block loads its own q_pos[b] and page_table[b, p] (clamped into
//    [0, N-1], so a bad table entry can never read outside the pool), as
//    the TPU kernel's scalar prefetch did;
//  * inside a block, warp w takes the block's pages w, w + nw, ... (nw <=
//    4 warps, fewer where shared memory is short) and keeps its own
//    running max m, sum l and (G, hd) f32 accumulator.  Its K/V pages are
//    staged in their own dtype (rows padded by 16 bytes) with `cp.async`,
//    double-buffered, so the next page's load overlaps this page's math;
//    only `__syncwarp` separates the score, softmax and accumulate steps
//    of a page (no block-wide barrier inside the loop);
//  * one block-wide barrier at the end merges the warps in warp order.
//    With one split the block writes the output itself; otherwise it
//    writes its (m, l, acc) partial in f32 to scratch the wrapper
//    allocates, and a combine kernel launched by the same entry point
//    merges the splits of each (b, kv) in split order.  Every sum runs in
//    a fixed order, so two calls give bit-equal outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxWarps = 4;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;  // a block's limit on Hopper
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// q . k over hd, in order of d, from 16-byte shared loads.
__device__ __forceinline__ float dot_row(const float* q, const float* k,
                                         int hd) {
  float s = 0.f;
  for (int d = 0; d < hd; d += 4) {
    const float4 a = *reinterpret_cast<const float4*>(q + d);
    const float4 b = *reinterpret_cast<const float4*>(k + d);
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
    s = fmaf(a.z, b.z, s);
    s = fmaf(a.w, b.w, s);
  }
  return s;
}
__device__ __forceinline__ float dot_row(const float* q,
                                         const __nv_bfloat16* k, int hd) {
  float s = 0.f;
  for (int d = 0; d < hd; d += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(k + d);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float4 qa = *reinterpret_cast<const float4*>(q + d);
    const float4 qb = *reinterpret_cast<const float4*>(q + d + 4);
    const float2 k0 = __bfloat1622float2(h[0]), k1 = __bfloat1622float2(h[1]);
    const float2 k2 = __bfloat1622float2(h[2]), k3 = __bfloat1622float2(h[3]);
    s = fmaf(qa.x, k0.x, s);
    s = fmaf(qa.y, k0.y, s);
    s = fmaf(qa.z, k1.x, s);
    s = fmaf(qa.w, k1.y, s);
    s = fmaf(qb.x, k2.x, s);
    s = fmaf(qb.y, k2.y, s);
    s = fmaf(qb.z, k3.x, s);
    s = fmaf(qb.w, k3.y, s);
  }
  return s;
}

// Shared memory of a block: q (G, hd) f32, then per warp two stages of a
// K and a V page (ps rows of RS elements each), the page's scores (G, ps),
// m, l and the rescale factor (G each) and the accumulator (G, hd), f32.
struct Smem {
  int rs;        // padded row stride of a staged page, elements
  size_t kv;     // bytes of the two stages of K and V
  size_t warp;   // bytes of one warp's region (a multiple of 16)
  size_t total;  // bytes of the block with nw warps
  __host__ __device__ Smem(int G, int hd, int ps, int el, int nw) {
    rs = hd + 16 / el;
    kv = (size_t)4 * ps * rs * el;
    const size_t f = (size_t)4 * (G * ps + 3 * G + G * hd);
    warp = (kv + f + 15) / 16 * 16;
    total = (size_t)4 * G * hd + nw * warp;
  }
};

template <typename T>
__global__ void __launch_bounds__(32 * kMaxWarps) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int32_t* __restrict__ page_table,
    const int32_t* __restrict__ q_pos, T* __restrict__ out,
    float* __restrict__ part, int KV, int G, int hd, int N, int ps, int P,
    int pps, int window, float softcap, float scale) {
  const int bkv = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int b = bkv / KV, kv = bkv - b * KV;
  const int tid = threadIdx.x, nw = blockDim.x >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  const Smem L(G, hd, ps, (int)sizeof(T), nw);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  unsigned char* w_raw = smem_raw + (size_t)4 * G * hd;
  // warp w's region
  unsigned char* mine = w_raw + warp * L.warp;
  T* kv_s = reinterpret_cast<T*>(mine);
  float* p_w = reinterpret_cast<float*>(mine + L.kv);  // (G, ps)
  float* m_w = p_w + G * ps;
  float* l_w = m_w + G;
  float* a_w = l_w + G;
  float* acc_w = a_w + G;                              // (G, hd)

  const long long q_off = (long long)bkv * G * hd;
  for (int i = tid; i < G * hd; i += blockDim.x) q_s[i] = to_f32(q[q_off + i]);
  for (int i = lane; i < G * hd; i += 32) acc_w[i] = 0.f;
  for (int g = lane; g < G; g += 32) {
    m_w[g] = kNegInf;
    l_w[g] = 0.f;
  }

  const int pos = q_pos[b];
  const int first = window > 0 ? max(pos - (window - 1), 0) / ps : 0;
  const int end = min(pos / ps, P - 1);
  const int lo = max(first, split * pps);
  const int hi = min(end, split * pps + pps - 1);
  const long long row_stride = (long long)KV * hd;  // token rows of a page
  const long long page_stride = (long long)ps * row_stride;
  const int rs = L.rs;
  constexpr int EPC = 16 / sizeof(T);
  const int CH = hd / EPC;  // 16-byte chunks of a row

  auto load_page = [&](int p, int st) {
    const int pid = min(max(page_table[(long long)b * P + p], 0), N - 1);
    const T* kp = k_pages + pid * page_stride + (long long)kv * hd;
    const T* vp = v_pages + pid * page_stride + (long long)kv * hd;
    T* kd = kv_s + st * 2 * ps * rs;
    T* vd = kd + ps * rs;
    for (int i = lane; i < ps * CH; i += 32) {
      const int t = i / CH, c = (i - t * CH) * EPC;
      cp_async16(kd + t * rs + c, kp + t * row_stride + c);
      cp_async16(vd + t * rs + c, vp + t * row_stride + c);
    }
  };

  __syncthreads();  // q_s is whole
  int p = lo + warp;
  if (p <= hi) load_page(p, 0);
  cp_async_commit();
  for (int it = 0; p <= hi; ++it, p += nw) {
    if (p + nw <= hi) {
      load_page(p + nw, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const T* ks = kv_s + (it & 1) * 2 * ps * rs;
    const T* vs = ks + ps * rs;

    for (int i = lane; i < G * ps; i += 32) {
      const int g = i / ps, t = i - g * ps;
      float s = dot_row(q_s + g * hd, ks + t * rs, hd) * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const int kpos = p * ps + t;
      bool ok = kpos <= pos;
      if (window > 0) ok = ok && (kpos > pos - window);
      p_w[i] = ok ? s : kNegInf;
    }
    __syncwarp();
    for (int g = lane; g < G; g += 32) {
      float* pr = p_w + g * ps;
      float mx = pr[0];
      for (int t = 1; t < ps; ++t) mx = fmaxf(mx, pr[t]);
      const float m_new = fmaxf(m_w[g], mx);
      const float alpha = expf(m_w[g] - m_new);
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float e = expf(pr[t] - m_new);
        pr[t] = e;
        sum += e;
      }
      l_w[g] = l_w[g] * alpha + sum;
      m_w[g] = m_new;
      a_w[g] = alpha;
    }
    __syncwarp();
    for (int i = lane; i < G * hd; i += 32) {
      const int g = i / hd, d = i - g * hd;
      const float* pr = p_w + g * ps;
      float a = acc_w[i] * a_w[g];
      for (int t = 0; t < ps; ++t) a = fmaf(pr[t], to_f32(vs[t * rs + d]), a);
      acc_w[i] = a;
    }
    __syncwarp();  // this stage is refilled two pages on
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the warps, in warp order
  float* mine_part = part + ((long long)bkv * splits + split) *
                                ((long long)G * hd + 2 * G);
  for (int i = tid; i < G * hd; i += blockDim.x) {
    const int g = i / hd;
    float M = kNegInf;
    for (int w = 0; w < nw; ++w) {
      const float* mw = reinterpret_cast<const float*>(
          w_raw + w * L.warp + L.kv) + G * ps;
      M = fmaxf(M, mw[g]);
    }
    float l = 0.f, a = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float* mw = reinterpret_cast<const float*>(
          w_raw + w * L.warp + L.kv) + G * ps;
      const float f = expf(mw[g] - M);
      l += mw[G + g] * f;
      a += mw[3 * G + i] * f;  // acc_w of warp w
    }
    if (splits == 1) {
      store(&out[q_off + i], a / fmaxf(l, 1e-30f));
    } else {
      mine_part[i] = a;
      if (i - g * hd == 0) {
        mine_part[G * hd + g] = M;
        mine_part[G * hd + G + g] = l;
      }
    }
  }
}

// Merges the splits of each (b, kv): part (B * KV, splits, G * hd + 2 G)
// holds each split's acc (G, hd), m (G) and l (G).
template <typename T>
__global__ void __launch_bounds__(128) paged_decode_combine(
    const float* __restrict__ part, T* __restrict__ out, int G, int hd,
    int splits) {
  const long long bkv = blockIdx.x;
  const long long stride = (long long)G * hd + 2 * G;
  const float* base = part + bkv * splits * stride;
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
    const int g = i / hd;
    float M = kNegInf;
    for (int s = 0; s < splits; ++s)
      M = fmaxf(M, base[s * stride + G * hd + g]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float* ps_ = base + s * stride;
      const float f = expf(ps_[G * hd + g] - M);
      l += ps_[G * hd + G + g] * f;
      a += ps_[i] * f;
    }
    store(&out[bkv * G * hd + i], a / fmaxf(l, 1e-30f));
  }
}

// Raises the kernel's dynamic shared-memory limit where a block needs more
// than the default 48 KiB; once per device and instantiation, since the
// decode loop launches it every layer.
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
                   const void* page_table, const void* q_pos, void* out,
                   void* part, int B, int KV, int G, int hd, int N, int ps,
                   int P, int splits, int pps, int window, float softcap,
                   float scale, cudaStream_t stream) {
  // as many warps (up to 4, and no more than the split's pages) as fit
  int nw = min(kMaxWarps, pps);
  while (nw > 1 && Smem(G, hd, ps, sizeof(T), nw).total > kMaxSmem) --nw;
  const size_t smem = Smem(G, hd, ps, sizeof(T), nw).total;
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = ensure_smem<T>(smem);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T><<<dim3(B * KV, splits), 32 * nw, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(q_pos), static_cast<T*>(out),
      static_cast<float*>(part), KV, G, hd, N, ps, P, pps, window, softcap,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  paged_decode_combine<T><<<B * KV, 128, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), G, hd, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched).  dtype: 0 = float32, 1 = bfloat16
// (q, the pages and out share it).  window <= 0 disables the sliding
// window; softcap <= 0 disables soft-capping.  splits: blocks per (b, kv),
// split s over the logical pages [s * pps, (s + 1) * pps), which must cover
// the P pages with none empty; with splits > 1, part is f32 scratch of
// B * KV * splits * (G * hd + 2 * G) floats, otherwise unused.
int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                 const void* page_table, const void* q_pos, void* out,
                 void* part, int B, int KV, int G, int hd, int N, int ps,
                 int P, int splits, int pps, int window, float softcap,
                 float scale, int dtype, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || N <= 0 || ps <= 0 || P <= 0 ||
      splits <= 0 || pps <= 0 || (long long)splits * pps < P ||
      (long long)(splits - 1) * pps >= P || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * KV > 0x7fffffffLL || splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128 && hd != 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k_pages, v_pages, page_table, q_pos, out,
                              part, B, KV, G, hd, N, ps, P, splits, pps,
                              window, softcap, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, q_pos,
                                      out, part, B, KV, G, hd, N, ps, P,
                                      splits, pps, window, softcap, scale,
                                      s);
  return (int)cudaErrorInvalidValue;
}

const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
