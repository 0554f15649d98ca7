// MoE capacity-slab dispatch and combine for Hopper (sm_90a).
//
// Replaces the TPU kernels in src/repro/kernels/moe.py:
//   * `dispatch_pallas` (:119, body `_dispatch_kernel` :108)
//       out[g, e, c, :] = slot_w[g, e, c] * x[g, max(slot_src[g, e, c], 0), :]
//     formed in f32 and cast to x's dtype once;
//   * `combine_pallas` (:170, body `_combine_kernel` :151)
//       out[g, s, :] = sum_{k=0..K-1} w[g, s, k] * buf[g, eid[g,s,k], pos[g,s,k], :]
//     with an f32 accumulator, k in order, cast to buf's dtype once.
// The plain PyTorch versions are `dispatch_slot` / `combine_slot` in
// src/repro_torch/kernels/moe.py; the wrappers that launch these kernels are
// `moe_dispatch_cuda` / `moe_combine_cuda` in the same module.
//
// What bounds them: bytes.  Each output element costs one multiply (and one
// add in combine) per element read, far below the card's flops-per-byte
// balance.  Dispatch writes the whole (G, E, C, D) slab and reads each
// distinct source row; combine reads the K expert rows of each token and
// writes one row.
//
// Design (correct first):
//  * the TPU grid (G, E, C) resp. (G, S, K) with a sequential k axis becomes
//    one CUDA block per slot (dispatch) resp. per token (combine) along
//    blockIdx.x, and blockIdx.y splits D into chunks of kThreads * VEC
//    elements, so even the decode shape (4 tokens) has several blocks;
//  * the TPU kernels' scalar-prefetched indices become each block loading
//    its own slot_src / (eid, pos) and weight;
//  * indices are clamped into the arrays (src to [0, S-1] after max(., 0),
//    eid to [0, E-1], pos to [0, C-1]), so a bad index never reads out of
//    bounds; an empty slot holds 0 * x[g, 0] exactly as the TPU kernel
//    computes it (not a literal zero);
//  * rows move as 16-byte vectors (4 float32 or 8 bfloat16) when D and the
//    pointers allow it, else one element a thread;
//  * combine's sum over k runs inside the thread in order (the TPU grid's
//    sequential k axis), in f32 registers; products and sums are rounded
//    separately (__fmul_rn / __fadd_rn), as the TPU kernel forms them;
//  * combine reads the slab through its g/e/c strides, so the expert
//    product's permuted output needs no copy; only the D axis must be
//    contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) dispatch_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ slot_src,
    const float* __restrict__ slot_w, T* __restrict__ out, int S, int EC,
    int D) {
  const long long slot = blockIdx.x;  // flat (g, e, c)
  const int d0 = (blockIdx.y * kThreads + threadIdx.x) * VEC;
  if (d0 >= D) return;
  const int g = (int)(slot / EC);
  const int src = min(max(slot_src[slot], 0), S - 1);
  const float w = slot_w[slot];
  const T* row = x + ((long long)g * S + src) * D + d0;
  Vec<T, VEC> a = *reinterpret_cast<const Vec<T, VEC>*>(row);
  Vec<T, VEC> o;
#pragma unroll
  for (int i = 0; i < VEC; ++i) from_f32(&o.v[i], __fmul_rn(to_f32(a.v[i]), w));
  *reinterpret_cast<Vec<T, VEC>*>(out + slot * D + d0) = o;
}

// The slab may be any (G, E, C, D) view whose rows are contiguous: the
// expert product leaves it as a permuted view of a batched matmul, and
// the kernel reads it through its g/e/c strides (in elements) instead of
// a copy.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) combine_kernel(
    const T* __restrict__ buf, const int32_t* __restrict__ eid,
    const int32_t* __restrict__ pos, const float* __restrict__ w,
    T* __restrict__ out, int S, int K, int E, int C, int D, long long sg,
    long long se, long long sc) {
  const long long tok = blockIdx.x;  // flat (g, s)
  const int d0 = (blockIdx.y * kThreads + threadIdx.x) * VEC;
  if (d0 >= D) return;
  const T* slab = buf + (tok / S) * sg + d0;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  for (int k = 0; k < K; ++k) {
    const long long j = tok * K + k;
    const int e = min(max(eid[j], 0), E - 1);
    const int p = min(max(pos[j], 0), C - 1);
    const float wk = w[j];
    const Vec<T, VEC> a =
        *reinterpret_cast<const Vec<T, VEC>*>(slab + e * se + p * sc);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      acc[i] = __fadd_rn(acc[i], __fmul_rn(to_f32(a.v[i]), wk));
  }
  Vec<T, VEC> o;
#pragma unroll
  for (int i = 0; i < VEC; ++i) from_f32(&o.v[i], acc[i]);
  *reinterpret_cast<Vec<T, VEC>*>(out + tok * D + d0) = o;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
cudaError_t launch_dispatch(const void* x, const void* slot_src,
                            const void* slot_w, void* out, int G, int S, int E,
                            int C, int D, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long slots = (long long)G * E * C;
  if (slots > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = D % kVec == 0 && aligned16(x) && aligned16(out);
  const int per_block = kThreads * (vec ? kVec : 1);
  const dim3 grid((unsigned)slots, (D + per_block - 1) / per_block);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const T* xs = static_cast<const T*>(x);
  const int32_t* src = static_cast<const int32_t*>(slot_src);
  const float* w = static_cast<const float*>(slot_w);
  T* o = static_cast<T*>(out);
  if (vec)
    dispatch_kernel<T, kVec><<<grid, kThreads, 0, stream>>>(xs, src, w, o, S,
                                                           E * C, D);
  else
    dispatch_kernel<T, 1><<<grid, kThreads, 0, stream>>>(xs, src, w, o, S,
                                                        E * C, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_combine(const void* buf, const void* eid, const void* pos,
                           const void* w, void* out, int G, int S, int K,
                           int E, int C, int D, long long sg, long long se,
                           long long sc, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long toks = (long long)G * S;
  if (toks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = D % kVec == 0 && sg % kVec == 0 && se % kVec == 0 &&
                   sc % kVec == 0 && aligned16(buf) && aligned16(out);
  const int per_block = kThreads * (vec ? kVec : 1);
  const dim3 grid((unsigned)toks, (D + per_block - 1) / per_block);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const T* b = static_cast<const T*>(buf);
  const int32_t* e = static_cast<const int32_t*>(eid);
  const int32_t* p = static_cast<const int32_t*>(pos);
  const float* ws = static_cast<const float*>(w);
  T* o = static_cast<T*>(out);
  if (vec)
    combine_kernel<T, kVec><<<grid, kThreads, 0, stream>>>(
        b, e, p, ws, o, S, K, E, C, D, sg, se, sc);
  else
    combine_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        b, e, p, ws, o, S, K, E, C, D, sg, se, sc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Both return a cudaError_t (0 = launched).  dtype: 0 = float32,
// 1 = bfloat16 (x/buf and out share it); indices are int32, weights float32.
// x and out are contiguous; buf's rows are, and sg/se/sc are its g/e/c
// strides in elements.
int moe_dispatch(const void* x, const void* slot_src, const void* slot_w,
                 void* out, int G, int S, int E, int C, int D, int dtype,
                 void* stream) {
  if (G <= 0 || S <= 0 || E <= 0 || C <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dispatch<float>(x, slot_src, slot_w, out, G, S, E, C,
                                       D, s);
  if (dtype == 1)
    return (int)launch_dispatch<__nv_bfloat16>(x, slot_src, slot_w, out, G, S,
                                               E, C, D, s);
  return (int)cudaErrorInvalidValue;
}

int moe_combine(const void* buf, const void* eid, const void* pos,
                const void* w, void* out, int G, int S, int K, int E, int C,
                int D, long long sg, long long se, long long sc, int dtype,
                void* stream) {
  if (G <= 0 || S <= 0 || K <= 0 || E <= 0 || C <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_combine<float>(buf, eid, pos, w, out, G, S, K, E, C, D,
                                      sg, se, sc, s);
  if (dtype == 1)
    return (int)launch_combine<__nv_bfloat16>(buf, eid, pos, w, out, G, S, K,
                                              E, C, D, sg, se, sc, s);
  return (int)cudaErrorInvalidValue;
}

const char* moe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
