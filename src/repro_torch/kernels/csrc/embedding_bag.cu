// Embedding bag (sum pooling) for Hopper (sm_90a).
//
// Replaces the TPU kernel `embedding_bag` in
// src/repro/kernels/embedding_bag.py (:43, pallas_call at :61, body
// `_kernel` :28):
//     out[n, :] = cast(sum_{b=0..bag-1} f32(table[ids[n, b], :]))
// with the sum over the bag taken in f32, in bag order, and cast to the
// table's dtype once.  The plain PyTorch version is `embedding_bag_ref` in
// src/repro_torch/kernels/embedding_bag.py; `embedding_bag_cuda` there
// launches this kernel.
//
// What bounds it: bytes.  One add per element read, far below the card's
// flops-per-byte balance: the least time is the ids plus the rows the bags
// name read once, and the (N, dim) output written once.
//
// Design (correct first):
//  * the TPU grid (N, bag) walks one table row per step, the bag axis
//    sequential, with the sum in a VMEM scratch.  Here a group of
//    `lanes` threads owns one bag: each thread owns 16-byte column vectors
//    of the row (4 float32 or 8 bfloat16; one element when dim or the
//    pointers do not allow it) and loops over the bag itself, its sum in f32
//    registers, in bag order;
//  * `lanes` is the smallest power of two (at most 32) that covers the
//    row's vectors, and a 256-thread block packs 256 / lanes bags: at the
//    CTR width (dim 16, float32: 4 vectors) that is 4 threads and 64 bags a
//    block, where one block per bag would leave most threads idle; rows
//    wider than 32 vectors are walked by the same lanes in strides;
//  * every thread of a group loads the bag's ids itself (the TPU kernel's
//    scalar prefetch) four at a time, so four row loads are in flight
//    before the first add, and the adds stay in bag order;
//  * ids are clamped into [0, V-1], as a clamping gather does, so a bad id
//    never reads outside the table;
//  * any N, bag, V and dim: no lane alignment is needed (the TPU path wants
//    dim % 128 == 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// One group of `lanes` threads per bag; column vector c of the row is
// owned by lane c % lanes.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) embedding_bag_kernel(
    const int32_t* __restrict__ ids, const T* __restrict__ table,
    T* __restrict__ out, long long N, int bag, int V, int dim, int lanes) {
  const int per_block = kThreads / lanes;
  const long long n = (long long)blockIdx.x * per_block + threadIdx.x / lanes;
  if (n >= N) return;
  const int lane = threadIdx.x % lanes;
  const int nvec = (dim + VEC - 1) / VEC;
  const int32_t* my_ids = ids + n * bag;
  for (int c = lane; c < nvec; c += lanes) {
    const int d0 = c * VEC;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    int b = 0;
    for (; b + 4 <= bag; b += 4) {
      Vec<T, VEC> r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int id = min(max(my_ids[b + j], 0), V - 1);
        r[j] = *reinterpret_cast<const Vec<T, VEC>*>(
            table + (long long)id * dim + d0);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[i] = __fadd_rn(acc[i], to_f32(r[j].v[i]));
    }
    for (; b < bag; ++b) {
      const int id = min(max(my_ids[b], 0), V - 1);
      const Vec<T, VEC> r = *reinterpret_cast<const Vec<T, VEC>*>(
          table + (long long)id * dim + d0);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = __fadd_rn(acc[i], to_f32(r.v[i]));
    }
    Vec<T, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) from_f32(&o.v[i], acc[i]);
    *reinterpret_cast<Vec<T, VEC>*>(out + n * dim + d0) = o;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
cudaError_t launch(const void* ids, const void* table, void* out, long long N,
                   int bag, int V, int dim, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = dim % kVec == 0 && aligned16(table) && aligned16(out);
  const int nvec = vec ? dim / kVec : dim;
  int lanes = 1;
  while (lanes < nvec && lanes < 32) lanes *= 2;
  const long long per_block = kThreads / lanes;
  const long long blocks = (N + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int32_t* i = static_cast<const int32_t*>(ids);
  const T* t = static_cast<const T*>(table);
  T* o = static_cast<T*>(out);
  if (vec)
    embedding_bag_kernel<T, kVec><<<(unsigned)blocks, kThreads, 0, stream>>>(
        i, t, o, N, bag, V, dim, lanes);
  else
    embedding_bag_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        i, t, o, N, bag, V, dim, lanes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched).  ids: (N, bag) int32, table:
// (V, dim), out: (N, dim), all contiguous; dtype: 0 = float32,
// 1 = bfloat16 (table and out share it).
int embedding_bag(const void* ids, const void* table, void* out, long long N,
                  int bag, int V, int dim, int dtype, void* stream) {
  if (N <= 0 || bag <= 0 || V <= 0 || dim <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(ids, table, out, N, bag, V, dim, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(ids, table, out, N, bag, V, dim, s);
  return (int)cudaErrorInvalidValue;
}

const char* embedding_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
