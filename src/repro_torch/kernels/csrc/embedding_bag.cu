// Embedding bag (sum pooling) for Hopper (sm_90a).
//
// Replaces the TPU kernel `embedding_bag` in
// src/repro/kernels/embedding_bag.py (:43, pallas_call at :61, body
// `_kernel` :28):
//     out[n, :] = cast(sum_{b=0..bag-1} f32(table[clamp(ids[n, b]), :]))
// with the sum over the bag taken in f32, in bag order, from 0, one
// rounded add (__fadd_rn) a row, and cast to the table's dtype once.  The
// plain PyTorch versions are `embedding_bag_ref` and, summing in this
// kernel's order, `embedding_bag_ordered` (bit-equal to every path below)
// in src/repro_torch/kernels/embedding_bag.py; `embedding_bag_cuda` there
// launches this kernel.
//
// What bounds it: bytes.  One add per element read, far below the card's
// flops-per-byte balance: the least time is the ids plus the rows the bags
// name read once, and the (N, dim) output written once.  At the pooled
// shapes of the reference benchmark and the paper's CTR (a few hundred
// bags of 26 rows of 512 bytes) that is ~1 us, so what bounds a call there
// is latency: how many dependent trips to device memory a bag makes, and
// how many SMs share them.  A bag that loads its rows a few at a time
// makes bag / 4 such trips.  With thousands of bags, what bounds a call
// is how many bytes the SMs keep in flight.
//
// Design, by what the launch finds:
//  * few pooled bags (bag > 1; every block of the launch fits on the card
//    at once), rows of a multiple of 16 bytes, 16-byte aligned table and
//    output: staged.  A group of `lanes` threads (a power of two, at most
//    a warp) owns one bag and one column chunk of at most 512 bytes
//    (wider rows are split over gridDim.y).  The group reads the bag's
//    ids in one coalesced read (lane j reads ids j, j + lanes, ...),
//    clamps them, and each lane copies its rows' chunks into shared memory
//    with cp.async.bulk (TMA's 1-D copy) onto the group's mbarrier: all
//    rows of a stage in flight at once, issued by the lane that read the
//    id, so no id is shared or read twice.  Lane c then sums vector c of
//    every row of the stage from shared memory in bag order.  A stage
//    holds up to 64 rows (16 KB a block); a longer bag walks a two-stage
//    ring: stage s + 2 is issued into the buffer that stage s has just
//    been summed from, so a bag of up to two stages has every row in
//    flight from the start.  Blocks are one warp, so a bag of the
//    benchmark's shape (dim 128 f32: 13 KB staged) leaves room for 16 on
//    an SM; when the bags are too few to give every SM two blocks, each
//    bag gets a whole warp (N 256 at dim 16 gives 256 blocks, not 32);
//  * many pooled bags: streamed through registers.  A group of `lanes`
//    threads per bag in 256-thread blocks, each lane owning 16-byte
//    vectors of the row; the group reads 32 ids at a time in one coalesced
//    read into shared memory, and each lane loads four rows before the
//    first add.  Staging loses here: an SM holds fewer bags, and every
//    row is one bulk copy; by the rows moved per second, the copies issue
//    more slowly than register loads when L2 holds the table (PERF.md);
//  * a bag of one (the CTR hot-cache lookup): a gather, one thread per
//    16-byte vector of a row, 128-thread blocks.  Each warp reads its
//    bags' ids in one coalesced read and shares them by shuffle; then one
//    load of the row and one store: one trip for the ids, one for the
//    rows.  The sum is 0 + row, exact (and so bit-equal to a gather,
//    except that -0 becomes +0 as in every sum from 0);
//  * fallbacks, for a misaligned table or output or rows that are not a
//    multiple of 16 bytes (an odd dim): the gather and the streamed
//    kernel one element a lane;
//  * staging was also measured, on an H100 SXM, against registers alone
//    (16 or 32 rows a lane, one-warp blocks: slower at every pooled
//    shape, their registers cap the warps an SM holds) and cp.async (16
//    bytes a lane: tied where latency bounds, mixed where bytes do);
//  * ids are clamped into [0, V-1], as a clamping gather does, so a bad id
//    never reads outside the table; any N, bag, V and dim (the TPU path
//    wants dim % 128 == 0).  No atomics: each output element is written by
//    one thread, so a launch is bit-equal on repeat.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kChunkVecs = 32;        // 16-byte vectors of a column chunk
constexpr int kStageBytes = 16384;    // rows of one stage, a whole block
constexpr int kSmemPerSm = 232448;    // shared memory an SM's blocks share
constexpr int kMaxStageRows = 64;
constexpr int kIdsPerLane = 8;        // a stage's ids a lane reads
constexpr int kBarBytes = 512;        // the mbarriers, before the rows
constexpr int kGatherThreads = 128;
constexpr int kStreamThreads = 256;
constexpr int kIdChunk = 32;          // ids a streamed group reads at once
constexpr int kInFlight = 4;          // rows a streamed lane loads at once

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

__device__ __forceinline__ int clamp_id(int id, int V) {
  return min(max(id, 0), V - 1);
}

// --------------------------------------------------------------------------
// mbarrier and 1-D bulk copy (PTX, sm_90)
// --------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// global -> shared, `bytes` a multiple of 16, both addresses 16-byte
// aligned; completes `bytes` on the mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// --------------------------------------------------------------------------
// pooled bags, staged in shared memory
// --------------------------------------------------------------------------

// One-warp blocks; block (x, y) holds bags [x * groups, (x + 1) * groups)
// (groups = 32 / lanes), columns [y * kChunkVecs * VEC, ...).  Shared
// memory: the groups' two mbarriers each, then each group's `nbuf`
// buffers of `rows` rows of `pitch` bytes.
template <typename T>
__global__ void __launch_bounds__(kWarp) embedding_bag_staged(
    const int32_t* __restrict__ ids, const T* __restrict__ table,
    T* __restrict__ out, long long N, int bag, int V, int dim, int lanes,
    int rows, int nbuf, int pitch) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const int g = threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  const long long n = (long long)blockIdx.x * (kWarp / lanes) + g;
  if (n >= N) return;  // the whole group: the others sync on their masks
  const unsigned gmask =
      lanes == kWarp ? kFull : ((1u << lanes) - 1u) << (g * lanes);
  const int c0 = blockIdx.y * kChunkVecs;  // first vector of the chunk
  const int cv = min(kChunkVecs, dim / VEC - c0);
  const uint32_t cbytes = cv * 16;
  const T* col = table + (long long)c0 * VEC;
  const int32_t* my_ids = ids + n * bag;
  unsigned char* buf = smem + kBarBytes + (size_t)g * nbuf * rows * pitch;
  const uint32_t bar0 = smem_u32(smem + 16 * g);
  const uint32_t bar1 = bar0 + 8;
  if (lane == 0) {
    mbar_init(bar0, 1);
    if (nbuf == 2) mbar_init(bar1, 1);
  }
  __syncwarp(gmask);

  // stage s: rows [s * rows, ...) of the bag into buffer s % 2; the ids of
  // the stage are all read before the first copy is issued
  auto issue = [&](int s) {
    const int b0 = s * rows;
    const int nr = min(rows, bag - b0);
    const uint32_t bar = (s & 1) ? bar1 : bar0;
    const uint32_t dst = smem_u32(buf + (size_t)(s & 1) * rows * pitch);
    int id[kIdsPerLane];
#pragma unroll
    for (int k = 0; k < kIdsPerLane; ++k) {
      const int j = lane + k * lanes;
      id[k] = j < nr ? clamp_id(my_ids[b0 + j], V) : 0;
    }
    if (lane == 0) mbar_arrive_expect_tx(bar, nr * cbytes);
    __syncwarp(gmask);
#pragma unroll
    for (int k = 0; k < kIdsPerLane; ++k) {
      const int j = lane + k * lanes;
      if (j < nr)
        bulk_load(dst + j * pitch, col + (long long)id[k] * dim, cbytes, bar);
    }
  };

  const int stages = (bag + rows - 1) / rows;
  issue(0);
  if (stages > 1) issue(1);
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  const bool active = lane < cv;
  for (int s = 0; s < stages; ++s) {
    mbar_wait((s & 1) ? bar1 : bar0, (s >> 1) & 1);
    const int nr = min(rows, bag - s * rows);
    const unsigned char* src =
        buf + (size_t)(s & 1) * rows * pitch + lane * 16;
    if (active)
      for (int j = 0; j < nr; ++j) {
        const Vec<T, VEC> r =
            *reinterpret_cast<const Vec<T, VEC>*>(src + (size_t)j * pitch);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[i] = __fadd_rn(acc[i], to_f32(r.v[i]));
      }
    if (s + 2 < stages) {
      __syncwarp(gmask);  // every lane has read the buffer
      issue(s + 2);
    }
  }
  if (active) {
    Vec<T, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) from_f32(&o.v[i], acc[i]);
    *reinterpret_cast<Vec<T, VEC>*>(out + n * dim + (long long)(c0 + lane) *
                                                        VEC) = o;
  }
}

// --------------------------------------------------------------------------
// a bag of one: the gather
// --------------------------------------------------------------------------

// `lanes` threads a bag (a power of two, at most a warp), each owning
// 16-byte vectors (VEC elements; one when the fast path does not apply)
// c = lane, lane + lanes, ... of the row.
template <typename T, int VEC>
__global__ void __launch_bounds__(kGatherThreads) embedding_bag_gather(
    const int32_t* __restrict__ ids, const T* __restrict__ table,
    T* __restrict__ out, long long N, int V, int dim, int lanes) {
  const int per_warp = kWarp / lanes;
  const int wl = threadIdx.x % kWarp;
  const long long first =
      (long long)blockIdx.x * (kGatherThreads / lanes) +
      (long long)(threadIdx.x / kWarp) * per_warp;  // the warp's first bag
  int id = 0;
  if (wl < per_warp && first + wl < N) id = clamp_id(ids[first + wl], V);
  id = __shfl_sync(kFull, id, wl / lanes);
  const long long n = first + wl / lanes;
  if (n >= N) return;
  const int lane = wl % lanes;
  const int nvec = dim / VEC;
  const T* row = table + (long long)id * dim;
  for (int c = lane; c < nvec; c += lanes) {
    const Vec<T, VEC> r = reinterpret_cast<const Vec<T, VEC>*>(row)[c];
    Vec<T, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      from_f32(&o.v[i], __fadd_rn(0.f, to_f32(r.v[i])));
    reinterpret_cast<Vec<T, VEC>*>(out + n * dim)[c] = o;
  }
}

// --------------------------------------------------------------------------
// pooled bags, streamed through registers
// --------------------------------------------------------------------------

// `lanes` threads a bag (a power of two, at most a warp), each owning
// VEC-element vectors c = lane, lane + lanes, ... of the row (VEC = 1 on
// the fallback).  The group reads kIdChunk ids at a time in one
// coalesced read into shared memory; each lane then loads kInFlight rows
// before the first add.  Dynamic shared memory: kIdChunk ints a group.
template <typename T, int VEC>
__global__ void __launch_bounds__(kStreamThreads) embedding_bag_streamed(
    const int32_t* __restrict__ ids, const T* __restrict__ table,
    T* __restrict__ out, long long N, int bag, int V, int dim, int lanes) {
  extern __shared__ int s_ids[];
  const int g = threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  const long long n = (long long)blockIdx.x * (kStreamThreads / lanes) + g;
  if (n >= N) return;  // the whole group: the others sync on their masks
  const unsigned gmask =
      lanes == kWarp ? kFull
                     : ((1u << lanes) - 1u) << (g * lanes % kWarp);
  int* my_s = s_ids + g * kIdChunk;
  const int32_t* my_ids = ids + n * bag;
  const int nvec = dim / VEC;
  for (int c0 = 0; c0 < nvec; c0 += lanes) {
    const int c = c0 + lane;
    const bool active = c < nvec;
    const T* col = table + (long long)c * VEC;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int b0 = 0; b0 < bag; b0 += kIdChunk) {
      const int nb = min(kIdChunk, bag - b0);
      __syncwarp(gmask);  // the last chunk's ids are read
      for (int j = lane; j < nb; j += lanes)
        my_s[j] = clamp_id(my_ids[b0 + j], V);
      __syncwarp(gmask);
      if (!active) continue;
      int j = 0;
      for (; j + kInFlight <= nb; j += kInFlight) {
        Vec<T, VEC> r[kInFlight];
#pragma unroll
        for (int k = 0; k < kInFlight; ++k)
          r[k] = *reinterpret_cast<const Vec<T, VEC>*>(
              col + (long long)my_s[j + k] * dim);
#pragma unroll
        for (int k = 0; k < kInFlight; ++k)
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            acc[i] = __fadd_rn(acc[i], to_f32(r[k].v[i]));
      }
      for (; j < nb; ++j) {
        const Vec<T, VEC> r = *reinterpret_cast<const Vec<T, VEC>*>(
            col + (long long)my_s[j] * dim);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[i] = __fadd_rn(acc[i], to_f32(r.v[i]));
      }
    }
    if (active) {
      Vec<T, VEC> o;
#pragma unroll
      for (int i = 0; i < VEC; ++i) from_f32(&o.v[i], acc[i]);
      reinterpret_cast<Vec<T, VEC>*>(out + n * dim)[c] = o;
    }
  }
}

// --------------------------------------------------------------------------
// launch
// --------------------------------------------------------------------------

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x && p < kWarp) p *= 2;
  return p;
}

int sm_count() {
  static int counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return counts[dev];
}

template <typename T>
cudaError_t launch(const void* ids_v, const void* table_v, void* out_v,
                   long long N, int bag, int V, int dim, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int32_t* ids = static_cast<const int32_t*>(ids_v);
  const T* table = static_cast<const T*>(table_v);
  T* out = static_cast<T*>(out_v);
  const bool vec = dim % kVec == 0 && aligned16(table) && aligned16(out);
  if (bag == 1) {
    const int nvec = vec ? dim / kVec : dim;
    const int lanes = pow2_at_least(nvec);
    const long long per_block = kGatherThreads / lanes;
    const long long blocks = (N + per_block - 1) / per_block;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    if (vec)
      embedding_bag_gather<T, kVec>
          <<<(unsigned)blocks, kGatherThreads, 0, stream>>>(ids, table, out,
                                                            N, V, dim, lanes);
    else
      embedding_bag_gather<T, 1>
          <<<(unsigned)blocks, kGatherThreads, 0, stream>>>(ids, table, out,
                                                            N, V, dim, lanes);
    return cudaGetLastError();
  }
  if (vec) {
    const int row_vecs = dim / kVec;
    const int chunks = (row_vecs + kChunkVecs - 1) / kChunkVecs;
    const int pitch = min(row_vecs, kChunkVecs) * 16;
    int lanes = pow2_at_least(min(row_vecs, kChunkVecs));
    // too few bags to give every SM two blocks: a warp a bag
    if ((N + kWarp / lanes - 1) / (kWarp / lanes) * chunks < 2LL * sm_count())
      lanes = kWarp;
    const int groups = kWarp / lanes;
    const long long blocks = (N + groups - 1) / groups;
    const int rows = min(min(min(kMaxStageRows, kIdsPerLane * lanes), bag),
                         kStageBytes / (groups * pitch));
    const int nbuf = bag > rows ? 2 : 1;
    const size_t smem = kBarBytes + (size_t)groups * nbuf * rows * pitch;
    // staged only when every block fits on the card at once (latency);
    // many bags stream through registers (bytes)
    const long long resident =
        (long long)sm_count() * min(kWarp, (int)(kSmemPerSm / smem));
    if (chunks <= 65535 && blocks * chunks <= resident) {
      embedding_bag_staged<T>
          <<<dim3((unsigned)blocks, chunks), kWarp, smem, stream>>>(
              ids, table, out, N, bag, V, dim, lanes, rows, nbuf, pitch);
      return cudaGetLastError();
    }
  }
  const int lanes = pow2_at_least(vec ? dim / kVec : dim);
  const int groups = kStreamThreads / lanes;
  const long long blocks = (N + groups - 1) / groups;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = (size_t)groups * kIdChunk * sizeof(int);
  if (vec)
    embedding_bag_streamed<T, kVec>
        <<<(unsigned)blocks, kStreamThreads, smem, stream>>>(
            ids, table, out, N, bag, V, dim, lanes);
  else
    embedding_bag_streamed<T, 1>
        <<<(unsigned)blocks, kStreamThreads, smem, stream>>>(
            ids, table, out, N, bag, V, dim, lanes);
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
