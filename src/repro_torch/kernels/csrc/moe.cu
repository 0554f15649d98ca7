// MoE capacity-slab dispatch and combine for Hopper (sm_90a).
//
// Replaces the TPU kernels in src/repro/kernels/moe.py:
//   * `dispatch_pallas` (:119, body `_dispatch_kernel` :108)
//       out[g, e, c, :] = slot_w[g, e, c] * x[g, max(slot_src[g, e, c], 0), :]
//     formed in f32 and cast to x's dtype once;
//   * `combine_pallas` (:170, body `_combine_kernel` :151)
//       out[g, s, :] = sum_{k=0..K-1} w[g, s, k] * buf[g, eid[g,s,k], pos[g,s,k], :]
//     with an f32 accumulator, k in order, cast to buf's dtype once.
// The plain PyTorch versions are `dispatch_slot` / `combine_slot` (and
// `combine_slot_ordered`, which sums in the kernel's order) in
// src/repro_torch/kernels/moe.py; the wrappers that launch these kernels
// are `moe_dispatch_cuda` / `moe_combine_cuda` in the same module.
//
// What bounds them on this card.  Both do one multiply (and, in combine,
// one add) per element moved, far below the card's flops-per-byte balance,
// so the floor is bytes: dispatch writes the whole (G, E, C, D) slab (16.8
// MB at OLMoE's decode shape, 5 us at 3.35 TB/s), and one block per slot
// already wrote it near that rate; combine reads K rows per token.  At
// decode, combine moves only ~0.3 MB (0.1 us), so what bounds it there is
// latency: how many dependent trips to device memory a thread makes
// before its store.  A k loop that loads index, then row, then adds pays
// 2K of them.  At prefill (thousands of blocks) what bounds both is how
// many bytes each SM keeps in flight, which needs full occupancy.
//
// Design:
//  * combine: one block per (token, column chunk).  Its first K threads
//    load the token's (eid, pos, w) in one coalesced read, clamp them into
//    slab offsets and share them through shared memory, so no thread
//    loads an index.  Then each thread requests all its rows of a group
//    of up to 8 pairs (16-byte loads) before the first add, and sums them
//    in k order: __fadd_rn(acc, __fmul_rn(row, w_k)) from 0 in f32
//    registers, the TPU grid's sequential k axis.  The chain is index,
//    rows, store.  K above 8 runs in groups of 8, 4, 2, 1 (k order kept);
//    above 32, the offsets come in groups of 32.  Few blocks (OLMoE decode:
//    4 tokens) get one warp a block, so they spread over 64 SMs, and
//    registers for every row in flight; many (prefill) get four warps a
//    block and at most 32 registers, so an SM holds 64 warps;
//  * dispatch: one block per tile of consecutive slots of a group (8, or 4
//    when the group has 8 tokens or more) by a 2 KB column chunk.  Warp 0
//    loads the tile's slot_src / slot_w in one read, clamps them, finds
//    the distinct source rows (at decode every slot of a group reads the
//    same row) and copies each distinct row chunk once into shared memory
//    with cp.async.bulk (TMA's 1-D copy), all completing on one mbarrier
//    armed with the byte count.  Then each thread forms w * row for every
//    slot of the tile from shared memory and writes it with 16-byte
//    stores.  OLMoE decode runs 1,024 such blocks of 128 threads, not
//    8,192 blocks of one slot;
//  * the arithmetic and clamping are the TPU kernels': src clamped to
//    [0, S-1] after max(., 0), eid to [0, E-1], pos to [0, C-1], so a bad
//    index never reads out of bounds; an empty slot holds 0 * x[g, 0]
//    (not a literal zero); products and sums rounded separately.  No
//    atomics: each output element is written by one thread, so a launch is
//    bit-equal on repeat;
//  * combine reads the slab through its g/e/c strides, so the expert
//    product's permuted output needs no copy; only the D axis must be
//    contiguous;
//  * fallbacks, for what the fast paths cannot take: bulk copies and
//    16-byte vectors need D, the strides and the pointers to be multiples
//    of 16 bytes; otherwise both move one element a thread, and dispatch
//    reads each slot's row from x (not staged).  Every path forms the same
//    bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kChunkBytes = 2048;     // bytes of a row in a dispatch tile
constexpr int kDispatchThreads = 128;
constexpr int kCombineThreads = 128;
constexpr int kGroup = 8;             // combine rows in flight a thread

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
__device__ __forceinline__ Vec<T, VEC> scaled(const Vec<T, VEC>& a, float w) {
  Vec<T, VEC> o;
#pragma unroll
  for (int i = 0; i < VEC; ++i) from_f32(&o.v[i], __fmul_rn(to_f32(a.v[i]), w));
  return o;
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
// dispatch
// --------------------------------------------------------------------------

template <int SLOTS>
struct DispatchSmem {
  alignas(128) unsigned char rows[SLOTS][kChunkBytes];  // distinct rows
  unsigned long long bar;
  int row_of[SLOTS];  // each slot's row in `rows`
  int src[SLOTS];     // each distinct row's source token
  float w[SLOTS];
};

// grid (G * runs, column chunks): block (g * runs + r, ch) writes slots
// [SLOTS r, SLOTS (r + 1)) of group g (flat e * C + c), columns
// [ch * chunk, ...).  BULK: the fast path (16-byte vectors, rows staged by
// cp.async.bulk); otherwise each slot reads its row from x.
template <typename T, bool BULK, int SLOTS>
__global__ void __launch_bounds__(kDispatchThreads) dispatch_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ slot_src,
    const float* __restrict__ slot_w, T* __restrict__ out, int S, int EC,
    int D, int runs) {
  constexpr int VEC = BULK ? 16 / sizeof(T) : 1;
  constexpr int kChunk = kChunkBytes / sizeof(T);
  __shared__ DispatchSmem<SLOTS> sm;
  const int g = blockIdx.x / runs;
  const int c0 = (blockIdx.x - g * runs) * SLOTS;
  const int ns = min(SLOTS, EC - c0);
  const int d0 = blockIdx.y * kChunk;
  const int dc = min(kChunk, D - d0);
  const long long slot0 = (long long)g * EC + c0;
  const T* xg = x + (long long)g * S * D + d0;
  const uint32_t bar = smem_u32(&sm.bar);
  const int tid = threadIdx.x;

  if (tid < kWarp) {
    const int lane = tid;
    if (BULK && lane == 0) mbar_init(bar, 1);
    int src = -1;
    float w = 0.f;
    if (lane < ns) {
      src = min(max(slot_src[slot0 + lane], 0), S - 1);
      w = slot_w[slot0 + lane];
    }
    // the first slot of the tile that reads the same row leads it
    int first = lane;
#pragma unroll
    for (int j = SLOTS - 1; j >= 0; --j) {
      const int sj = __shfl_sync(kFull, src, j);
      if (j < lane && sj == src) first = j;
    }
    const bool lead = lane < ns && first == lane;
    const unsigned leads = __ballot_sync(kFull, lead);
    const int rank = __popc(leads & ((1u << lane) - 1u));
    const int row = __shfl_sync(kFull, rank, first);
    if (lane < ns) {
      sm.row_of[lane] = row;
      sm.w[lane] = w;
    }
    if (lead) sm.src[rank] = src;
    if (BULK) {
      const uint32_t bytes = dc * sizeof(T);
      if (lane == 0) mbar_arrive_expect_tx(bar, __popc(leads) * bytes);
      __syncwarp();
      if (lead)
        bulk_load(smem_u32(sm.rows[rank]), xg + (long long)src * D, bytes,
                  bar);
    }
  }
  __syncthreads();
  if (BULK) mbar_wait(bar, 0);
  const int nv = dc / VEC;
  for (int i = 0; i < ns; ++i) {
    const float w = sm.w[i];
    const int r = sm.row_of[i];
    const Vec<T, VEC>* row = reinterpret_cast<const Vec<T, VEC>*>(
        BULK ? reinterpret_cast<const T*>(sm.rows[r])
             : xg + (long long)sm.src[r] * D);
    Vec<T, VEC>* o = reinterpret_cast<Vec<T, VEC>*>(out + (slot0 + i) * D + d0);
    for (int j = tid; j < nv; j += kDispatchThreads) o[j] = scaled(row[j], w);
  }
}

// --------------------------------------------------------------------------
// combine
// --------------------------------------------------------------------------

// Pairs k .. k+N-1 of the block's group (their slab offsets and weights in
// shared memory): all N rows are loaded before the first add, then summed
// in k order.
template <typename T, int VEC, int N>
__device__ __forceinline__ void accumulate(float (&acc)[VEC],
                                           const T* __restrict__ col,
                                           const long long* off,
                                           const float* w) {
  Vec<T, VEC> a[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    a[i] = *reinterpret_cast<const Vec<T, VEC>*>(col + off[i]);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      acc[v] = __fadd_rn(acc[v], __fmul_rn(to_f32(a[i].v[v]), w[i]));
}

// The slab may be any (G, E, C, D) view whose rows are contiguous: the
// expert product leaves it as a permuted view of a batched matmul, and
// the kernel reads it through its g/e/c strides (in elements).
// grid (G * S, column chunks of THREADS vectors); THREADS >= 32.
// MIN_BLOCKS: the blocks an SM must hold, which caps the registers (and so
// how many rows the compiler keeps in flight).
template <typename T, int VEC, int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) combine_kernel(
    const T* __restrict__ buf, const int32_t* __restrict__ eid,
    const int32_t* __restrict__ pos, const float* __restrict__ w,
    T* __restrict__ out, int S, int K, int E, int C, int D, long long sg,
    long long se, long long sc) {
  __shared__ long long s_off[kWarp];  // a group's clamped slab offsets
  __shared__ float s_w[kWarp];
  const long long tok = blockIdx.x;  // flat (g, s)
  const int j = blockIdx.y * THREADS + threadIdx.x;
  const bool active = j < D / VEC;
  const T* col = buf + (tok / S) * sg + (long long)j * VEC;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kWarp) {  // one group unless K > 32
    const int n = min(kWarp, K - k0);
    if (k0 > 0) __syncthreads();  // the last group's offsets are read
    if (threadIdx.x < n) {        // one coalesced read of the group
      const long long i = tok * K + k0 + threadIdx.x;
      const int e = min(max(eid[i], 0), E - 1);
      const int p = min(max(pos[i], 0), C - 1);
      s_off[threadIdx.x] = e * se + p * sc;
      s_w[threadIdx.x] = w[i];
    }
    __syncthreads();
    if (!active) continue;
    int k = 0;
    for (; k + kGroup <= n; k += kGroup)
      accumulate<T, VEC, kGroup>(acc, col, s_off + k, s_w + k);
    if (n - k >= 4) {
      accumulate<T, VEC, 4>(acc, col, s_off + k, s_w + k);
      k += 4;
    }
    if (n - k >= 2) {
      accumulate<T, VEC, 2>(acc, col, s_off + k, s_w + k);
      k += 2;
    }
    if (n - k >= 1) accumulate<T, VEC, 1>(acc, col, s_off + k, s_w + k);
  }
  if (active) {
    Vec<T, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) from_f32(&o.v[i], acc[i]);
    *reinterpret_cast<Vec<T, VEC>*>(out + tok * D + (long long)j * VEC) = o;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int SLOTS>
cudaError_t launch_dispatch_tile(const T* x, const int32_t* src,
                                 const float* w, T* out, int G, int S, int EC,
                                 int D, bool vec, cudaStream_t stream) {
  constexpr int kChunk = kChunkBytes / sizeof(T);
  const int runs = (EC + SLOTS - 1) / SLOTS;
  const dim3 grid((unsigned)((long long)G * runs), (D + kChunk - 1) / kChunk);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (vec)
    dispatch_kernel<T, true, SLOTS><<<grid, kDispatchThreads, 0, stream>>>(
        x, src, w, out, S, EC, D, runs);
  else
    dispatch_kernel<T, false, SLOTS><<<grid, kDispatchThreads, 0, stream>>>(
        x, src, w, out, S, EC, D, runs);
  return cudaGetLastError();
}

// A group of fewer than 8 tokens (decode: one) makes a tile's slots share
// rows, so a tile of 8 stages few; otherwise a tile's rows are mostly
// distinct, and tiles of 4 (8 KB of staging) let an SM hold more blocks.
template <typename T>
cudaError_t launch_dispatch(const void* x, const void* slot_src,
                            const void* slot_w, void* out, int G, int S, int E,
                            int C, int D, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if ((long long)G * E * C > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = D % kVec == 0 && aligned16(x) && aligned16(out);
  const T* xs = static_cast<const T*>(x);
  const int32_t* src = static_cast<const int32_t*>(slot_src);
  const float* w = static_cast<const float*>(slot_w);
  T* o = static_cast<T*>(out);
  if (S < 8)
    return launch_dispatch_tile<T, 8>(xs, src, w, o, G, S, E * C, D, vec,
                                      stream);
  return launch_dispatch_tile<T, 4>(xs, src, w, o, G, S, E * C, D, vec,
                                    stream);
}

// Few blocks (decode): one warp a block, so that the blocks spread over
// the SMs, and as many registers as the compiler likes, so that a thread
// keeps a group's rows in flight.  Many blocks (prefill): four warps a
// block and at most 32 registers, so that an SM holds 64 warps.
template <typename T, int VEC>
cudaError_t launch_combine_vec(const T* buf, const int32_t* eid,
                               const int32_t* pos, const float* w, T* out,
                               int G, int S, int K, int E, int C, int D,
                               long long sg, long long se, long long sc,
                               cudaStream_t stream) {
  const long long toks = (long long)G * S;
  const long long chunks = (D / VEC + kCombineThreads - 1) / kCombineThreads;
  if (toks * chunks < 256)
    combine_kernel<T, VEC, kWarp, 1>
        <<<dim3((unsigned)toks, (D / VEC + kWarp - 1) / kWarp), kWarp, 0,
           stream>>>(buf, eid, pos, w, out, S, K, E, C, D, sg, se, sc);
  else if (chunks > 65535)
    return cudaErrorInvalidValue;
  else
    combine_kernel<T, VEC, kCombineThreads, 16>
        <<<dim3((unsigned)toks, (unsigned)chunks), kCombineThreads, 0,
           stream>>>(buf, eid, pos, w, out, S, K, E, C, D, sg, se, sc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_combine(const void* buf, const void* eid, const void* pos,
                           const void* w, void* out, int G, int S, int K,
                           int E, int C, int D, long long sg, long long se,
                           long long sc, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if ((long long)G * S > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = D % kVec == 0 && sg % kVec == 0 && se % kVec == 0 &&
                   sc % kVec == 0 && aligned16(buf) && aligned16(out);
  const T* b = static_cast<const T*>(buf);
  const int32_t* e = static_cast<const int32_t*>(eid);
  const int32_t* p = static_cast<const int32_t*>(pos);
  const float* ws = static_cast<const float*>(w);
  T* o = static_cast<T*>(out);
  if (vec)
    return launch_combine_vec<T, kVec>(b, e, p, ws, o, G, S, K, E, C, D, sg,
                                       se, sc, stream);
  return launch_combine_vec<T, 1>(b, e, p, ws, o, G, S, K, E, C, D, sg, se,
                                  sc, stream);
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
