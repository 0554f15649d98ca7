// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py:85 (body `_kernel`, :33).  The TPU
// package has no backward kernel (its training differentiates the jnp
// scan); the backward here is written for the port's training path.  The
// plain PyTorch version is `flash_attention_ref` in
// src/repro_torch/kernels/flash_attention.py; the wrappers that launch these
// kernels are `flash_fwd_cuda`, `flash_bwd_dkdv_cuda` and `flash_bwd_dq_cuda`
// in the same module, tied together by its `FlashAttention` autograd
// Function.
//
// What it computes, per (batch*head) row bh of q (Sq, hd), k, v (Sk, hd):
//   s[r, c] = softcap(scale * q[r] . k[c])      scale = 1/sqrt(hd),
//             softcap(u) = cap * tanh(u / cap) when cap > 0
//   masked:  s = -1e30 where (causal and r < c) or (window and r - c >= window)
//   o[r]    = sum_c softmax_c(s[r, :]) v[c]      (f32 online softmax)
//   lse[r]  = m[r] + log(l[r])                   (f32, kept for the backward)
// Masked logits are -1e30, not -inf, as in the TPU kernel.  Key tiles that
// lie wholly above the diagonal (causal) or wholly before the window are not
// visited: for a row that sees some key their weights are exactly 0.  A
// window leaves the rows r >= Sk + window - 1 (there are such rows only when
// Sq > Sk) with no key at all; such a row averages every key uniformly, as
// in the TPU kernel, so a tile that holds one visits every key tile, and the
// backward gives each key of such a row the weight 1 / Sk.
// Rows and keys past Sq / Sk (the last, partial tile) do not exist: their
// loads read zeros and their weights are exactly 0.
//
// Backward, two deterministic passes (no atomics; every output element is
// accumulated by one thread's tensor-core fragments, in a fixed order):
//   flash_bwd_dkdv: D[r] = sum_d dO[r, d] * o[r, d]   (one warp per row)
//                   then one block per key tile loops over the query tiles
//                   that see it: p = exp(s - lse), dP = dO v^T,
//                   dS = p * (dP - D) * (1 - tanh^2(u / cap)),
//                   dV += p^T dO,  dK += scale * dS^T q;
//   flash_bwd_dq:   one block per query tile loops over its key tiles:
//                   dQ += scale * dS k.
//
// What bounds it: operations.  The forward needs 2 products of 2*hd flops
// per visible (query, key) pair (S = Q K^T and P V), the backward 5 (the
// two passes run 7: the dQ pass scores S and dP again), on 4 * B*H*S*hd
// elements; at S = 2048 that is hundreds to thousands of flops per byte,
// above the card's balance, so the least time is the flops over the tensor
// cores' rate: 989 TFLOP/s in bf16, and 495/3 TFLOP/s for f32-accurate
// products in the 3xTF32 split below (the f32 CUDA cores give only 67).
//
// Design, both directions:
//  * every product runs on the tensor cores through per-warp `mma.sync`
//    fragments: m16n8k16 bf16 with f32 accumulators; for f32 inputs
//    m16n8k8 TF32 in the 3xTF32 split (x = hi + lo, hi = x rounded to
//    TF32, lo = x - hi, of which the tensor cores read TF32's bits;
//    acc += lo*hi + hi*lo + hi*hi), which keeps f32-level accuracy;
//  * a block owns ROWS = 16 * WM rows and streams tiles of the other side;
//    warp (wm, wn) owns 16 of the rows and HD / WN output columns (WN > 1
//    where one warp's accumulators for the whole head would not fit in
//    registers; those warps repeat the score products of their rows);
//  * the score fragments stay in registers, and so do p and dS: the
//    accumulator layout of a score tile is the A-operand layout of the
//    next product (bf16: two n-tiles make one k16 step; TF32: one n-tile
//    is one k8 step whose k order is permuted, 2t -> t and 2t+1 -> t+4,
//    and the B operand is read in the same order), so neither reaches
//    shared or device memory;
//  * elements of a tile that is wholly visible (no mask, no soft cap, no
//    missing key) take a short path: the exponent is one FMA of the raw
//    dot product (scale * log2(e) folded in) and one ex2.approx;
//  * f32 operands are split by integer ops on the bits, not by
//    cvt.rna.tf32 (a slow conversion), and each tile's f32 products are
//    summed in a fresh accumulator added with one rounded add (the tensor
//    cores' f32 adds do not round to nearest);
//  * tiles are staged in shared memory in their own type, rows padded by
//    16 bytes so that `ldmatrix` (bf16) and the 32-bit fragment loads (f32)
//    hit distinct banks; the streamed tiles are double-buffered with
//    `cp.async`, so the next tile's load overlaps the current tile's
//    products;
//  * causal tiles are scheduled heaviest first across all heads: the grid
//    is (B*H, tiles), so every head's heaviest tile (the last query tile
//    of the forward and the dQ pass, key tile 0 of the dK/dV pass) starts
//    in the first wave and none is left for the tail.
//
// The forward: one block per (bh, query tile) loops over its key tiles with
// an online softmax on the score fragments (running max and sum in log2
// units; each row's 4 owning lanes reduce the tile's max with two shuffles;
// the sum stays per lane until the end).  bf16 holds the warp's Q rows as A
// fragments, loaded once, and rounds p to bf16 for P V (the TPU kernel
// forms P V in f32); f32 reads Q from its tile and splits it at each k
// step (hi and lo of a whole row would take HD registers).
//
// Backward specifics: the dK/dV pass computes S^T = K Q^T and dP^T = V dO^T
// (keys as rows), so p^T and dS^T are already the A operands of dV += p^T
// dO and dK += dS^T Q; bf16 takes a tile in two halves of its columns,
// each scored, packed to bf16 and accumulated before the next, so fewer
// registers are live and more blocks fit an SM; the visible-tile path is
// p = 2^(s * scale * log2(e) - lse * log2(e)), dS = p (dP - D).
//
// `wgmma` with a TMA producer warp, and GQA without expanded heads, are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;  // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The logit of query r and key c from the raw dot product: scaled,
// soft-capped and masked.  Keys past Sk do not exist (-inf: weight 0 even in
// a row with nothing else seen yet).
__device__ __forceinline__ float logit(float dot, int r, int c, int Sk,
                                       int causal, int window, float scale,
                                       float softcap) {
  float x = dot * scale;
  if (softcap > 0.f) x = softcap * tanhf(x / softcap);
  bool ok = true;
  if (causal) ok = r >= c;
  if (window > 0) ok = ok && (r - c) < window;
  if (!ok) x = kMasked;
  return c < Sk ? x : -INFINITY;
}

// The key tiles [k_begin, k_end) that rows [q0, q0 + rows) must visit: all
// of them when a row sees no key (it averages every key).
template <int BN>
__device__ __forceinline__ void key_span(int q0, int rows, int Sk, int causal,
                                         int window, int& k_begin, int& k_end) {
  const int q_last = q0 + rows - 1;
  if (window > 0 && q_last >= Sk + window - 1) {
    k_begin = 0;
    k_end = Sk;
    return;
  }
  k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_lo / BN) * BN;
}

// ------------------------------------------------------ tensor-core tiles

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + C::COLS) of a (S, HD) matrix into a (C::COLS, C::RS)
// tile in 16-byte copies by C::THREADS threads; rows past S are
// zero-filled.  C is the kernel's tile shape (Fwd or Bwd).
template <typename T, int HD, class C>
__device__ __forceinline__ void async_tile(T* dst, const T* __restrict__ src,
                                           int row0, int S) {
  constexpr int EPC = 16 / sizeof(T), CH = HD / EPC;
  for (int i = threadIdx.x; i < C::COLS * CH; i += C::THREADS) {
    const int r = i / CH, c = i - r * CH, g = row0 + r;
    const bool ok = g < S;
    cp_async16(dst + r * C::RS + c * EPC,
               src + (long long)(ok ? g : 0) * HD + c * EPC, ok);
  }
}
// Entries [row0, row0 + n) of a float row vector; past S read zeros.
__device__ __forceinline__ void async_row(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int n, int S, int nthr) {
  for (int i = threadIdx.x; i < n; i += nthr) {
    const bool ok = row0 + i < S;
    cp_async4(dst + i, src + (ok ? row0 + i : 0), ok);
  }
}

// x = hi + lo: hi is x rounded to TF32's 10 mantissa bits (to nearest, by
// integer ops on the bits: cheaper than cvt.rna.tf32), lo = x - hi exactly;
// the tensor cores read only lo's top 19 bits, so the pair keeps ~21 bits.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// The double-buffered ring of streamed tiles: tile i goes to buffer i % 2,
// one cp.async group per tile.  ring_start loads tile 0; ring_next, before
// tile i's products, starts tile i + 1's load and waits for tile i;
// ring_done, after them, holds the buffer until every warp is done with it.
template <typename F>
__device__ __forceinline__ void ring_start(int n, F&& stage) {
  if (n > 0) stage(0);
  cp_async_commit();
}
template <typename F>
__device__ __forceinline__ void ring_next(int i, int n, F&& stage) {
  if (i + 1 < n) {
    stage(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
}
__device__ __forceinline__ void ring_done() { __syncthreads(); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// acc += a b in the 3xTF32 split, small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// s += A1 B1^T and, when NP = 2, dp += A2 B2^T over d in [k_begin,
// k_end), f32 in the 3xTF32 split (the layout of warp_scores).
template <int RS, int NT, int NP>
__device__ __forceinline__ void tf32_scores(const float* A1, const float* B1,
                                            const float* A2, const float* B2,
                                            int k_begin, int k_end, int lane,
                                            float (&s)[NT][4],
                                            float (&dp)[NT][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = k_begin; k0 < k_end; k0 += 8) {
    uint32_t a1h[4], a1l[4], a2h[4], a2l[4];
    const float* p1 = A1 + g * RS + k0 + t;
    split(p1[0], a1h[0], a1l[0]);
    split(p1[8 * RS], a1h[1], a1l[1]);
    split(p1[4], a1h[2], a1l[2]);
    split(p1[8 * RS + 4], a1h[3], a1l[3]);
    if constexpr (NP == 2) {
      const float* p2 = A2 + g * RS + k0 + t;
      split(p2[0], a2h[0], a2l[0]);
      split(p2[8 * RS], a2h[1], a2l[1]);
      split(p2[4], a2h[2], a2l[2]);
      split(p2[8 * RS + 4], a2h[3], a2l[3]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bh[2], bl[2];
      const float* q1 = B1 + (8 * j + g) * RS + k0 + t;
      split(q1[0], bh[0], bl[0]);
      split(q1[4], bh[1], bl[1]);
      mma3(s[j], a1h, a1l, bh, bl);
      if constexpr (NP == 2) {
        const float* q2 = B2 + (8 * j + g) * RS + k0 + t;
        split(q2[0], bh[0], bl[0]);
        split(q2[4], bh[1], bl[1]);
        mma3(dp[j], a2h, a2l, bh, bl);
      }
    }
  }
}

// s = A1 B1^T and dp = A2 B2^T for one warp: A1, A2 point at the warp's 16
// rows, B1, B2 at the COLS streamed rows, all (rows, HD) tiles of row
// stride RS; the sum runs over HD.  Fragment layout (g = lane / 4,
// t = lane % 4): s[j][e] is row g + 8 (e / 2), column 8 j + 2 t + e % 2.
// NP = 1 (f32 only) forms s alone; A2, B2 and dp are not touched.
template <typename T, int HD, int RS, int NT, int NP = 2>
__device__ __forceinline__ void warp_scores(const T* A1, const T* B1,
                                            const T* A2, const T* B2,
                                            int lane, float (&s)[NT][4],
                                            float (&dp)[NT][4]) {
  static_assert(NP == 2 || sizeof(T) == 4, "one product: f32 only");
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = 0.f;
      if constexpr (NP == 2) dp[j][e] = 0.f;
    }
  if constexpr (sizeof(T) == 4) {
    if constexpr (HD <= 128) {
      tf32_scores<RS, NT, NP>(A1, B1, A2, B2, 0, HD, lane, s, dp);
    } else {
      // 64-wide chunks of d, each summed in fresh accumulators and added
      // with one rounded add (see warp_accum_tf32)
#pragma unroll 1
      for (int c0 = 0; c0 < HD; c0 += 64) {
        float cs[NT][4], cdp[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) cs[j][e] = cdp[j][e] = 0.f;
        tf32_scores<RS, NT, NP>(A1, B1, A2, B2, c0, c0 + 64, lane, cs, cdp);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] += cs[j][e];
            if constexpr (NP == 2) dp[j][e] += cdp[j][e];
          }
      }
    }
  } else {
    const int ar = lane & 15, ac = (lane >> 4) * 8;
    const int mi = lane >> 3;
    const int br = (lane & 7) + ((mi >> 1) << 3), bc = (mi & 1) * 8;
#pragma unroll
    for (int k0 = 0; k0 < HD; k0 += 16) {
      uint32_t a1[4], a2[4];
      ldsm_x4(a1, A1 + ar * RS + k0 + ac);
      ldsm_x4(a2, A2 + ar * RS + k0 + ac);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, B1 + (8 * j + br) * RS + k0 + bc);
        mma_bf16(s[j], a1, b[0], b[1]);
        mma_bf16(s[j + 1], a1, b[2], b[3]);
        ldsm_x4(b, B2 + (8 * j + br) * RS + k0 + bc);
        mma_bf16(dp[j], a2, b[0], b[1]);
        mma_bf16(dp[j + 1], a2, b[2], b[3]);
      }
    }
  }
}

// The bf16 A operand of warp_accum_bf16 from a score tile in the fragment
// layout of warp_scores: n-tiles 2 kk and 2 kk + 1 make k16 step kk.
template <int NT>
__device__ __forceinline__ void pack_a(const float (&w)[NT][4],
                                       uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    a[kk][0] = pack_bf16(w[2 * kk][0], w[2 * kk][1]);
    a[kk][1] = pack_bf16(w[2 * kk][2], w[2 * kk][3]);
    a[kk][2] = pack_bf16(w[2 * kk + 1][0], w[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(w[2 * kk + 1][2], w[2 * kk + 1][3]);
  }
}

// acc += W Y for one warp, bf16: W (16, 16 * KK) packed by pack_a (kept in
// registers), Y points at column 0 of the warp's DT * 8 output columns in a
// (16 * KK, RS) tile; the sum runs over the rows of Y, in order.  acc[n][e]
// is row g + 8 (e / 2), column 8 n + 2 t + e % 2.
template <int RS, int KK, int DT>
__device__ __forceinline__ void warp_accum_bf16(const uint32_t (&a)[KK][4],
                                                const __nv_bfloat16* Y,
                                                int lane,
                                                float (&acc)[DT][4]) {
  const int mi = lane >> 3;
  const int yr = (lane & 7) + ((mi & 1) << 3), yc = (mi >> 1) * 8;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int n = 0; n < DT; n += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, Y + (16 * kk + yr) * RS + 8 * n + yc);
      mma_bf16(acc[n], a[kk], b[0], b[1]);
      mma_bf16(acc[n + 1], a[kk], b[2], b[3]);
    }
}

// acc += W Y for one warp, f32 in the 3xTF32 split: W (16, 8 NT) is a score
// tile in the fragment layout of warp_scores, Y as for warp_accum_bf16.  K
// step j is score n-tile j, its k order permuted (2t -> t, 2t+1 -> t + 4)
// on both operands.  The tile's products are summed in a fresh accumulator
// and added to acc with one rounded add: the tensor cores' f32 adds do not
// round to nearest, and over the hundreds of MMAs of a long sequence their
// error builds up in one running sum (5e-5 relative at S = 2048).
template <int RS, int NT, int DT>
__device__ __forceinline__ void warp_accum_tf32(const float (&w)[NT][4],
                                                const float* Y, int lane,
                                                float (&acc)[DT][4]) {
  const int g = lane >> 2, t = lane & 3;
  float tile[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) tile[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t ah[4], al[4];
    split(w[j][0], ah[0], al[0]);
    split(w[j][2], ah[1], al[1]);
    split(w[j][1], ah[2], al[2]);
    split(w[j][3], ah[3], al[3]);
    const float* y = Y + (8 * j + 2 * t) * RS + g;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      uint32_t bh[2], bl[2];
      split(y[8 * n], bh[0], bl[0]);
      split(y[RS + 8 * n], bh[1], bl[1]);
      mma3(tile[n], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += tile[n][e];
}

// 2^x in one MUFU instruction (ex2.approx: within 2 ulp; results below
// 2^-126 flush to 0, far below anything a softmax weight contributes).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Writes a warp's (16, DT * 8) accumulator times mul into rows row0 ..
// row0 + 15 (those below S) and columns col0 .. of a (S, HD) matrix.
template <typename T, int HD, int DT>
__device__ __forceinline__ void store_acc(T* __restrict__ dst,
                                          const float (&acc)[DT][4], int row0,
                                          int col0, int S, float mul,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    if (r >= S) continue;
    T* row = dst + (long long)r * HD + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      store(row + 8 * n, acc[n][2 * h] * mul);
      store(row + 8 * n + 1, acc[n][2 * h + 1] * mul);
    }
  }
}

// ------------------------------------------------------------------ forward

// Per head dim: WM x WN warps; a block owns ROWS = 16 * WM query rows and
// streams key tiles of COLS = ROWS rows; warp (wm, wn) scores rows 16 wm ..
// 16 wm + 15 against the whole key tile and accumulates output columns
// DW wn .. DW wn + DW - 1 (WN = 2 only at hd 256).  Shared memory holds the
// Q tile and two stages of the K and V tiles.
template <typename T, int HD>
struct Fwd {
  static constexpr int WM = HD >= 256 ? 2 : 4;
  static constexpr int WN = HD >= 256 ? 2 : 1;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int ROWS = 16 * WM;
  static constexpr int COLS = ROWS;
  static constexpr int NT = COLS / 8;         // score n-tiles of a warp
  static constexpr int DW = HD / WN;
  static constexpr int DT = DW / 8;           // output n-tiles of a warp
  static constexpr int RS = HD + 16 / (int)sizeof(T);  // padded row stride
  static constexpr int TILE = COLS * RS;      // elements of one tile
  static constexpr size_t SMEM = 5 * TILE * sizeof(T);
  // blocks an SM should hold (registers are capped to fit them): at hd
  // <= 64, bf16 has the shared memory for 4 and f32 for 2
  static constexpr int BLOCKS = HD > 64 ? 1 : sizeof(T) == 2 ? 4 : 2;
};

// s = Q K^T for one warp of the forward: its 16 query rows against the
// 8 NT rows of the key tile Kt, summed over HD.  bf16 takes A from the
// warp's Q fragments qa; f32 from its rows of the Q tile, Qw.
template <typename T, int HD, int RS, int NT>
__device__ __forceinline__ void fwd_scores(const uint32_t (*qa)[4],
                                           const T* Qw, const T* Kt,
                                           int lane, float (&s)[NT][4]) {
  if constexpr (sizeof(T) == 4) {
    warp_scores<T, HD, RS, NT, 1>(Qw, Kt, nullptr, nullptr, lane, s, s);
  } else {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const int mi = lane >> 3;
    const int br = (lane & 7) + ((mi >> 1) << 3), bc = (mi & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, Kt + (8 * j + br) * RS + 16 * kk + bc);
        mma_bf16(s[j], qa[kk], b[0], b[1]);
        mma_bf16(s[j + 1], qa[kk], b[2], b[3]);
      }
  }
}

// One block per (bh, query tile): o and lse of ROWS queries, looping over
// their key tiles with an online softmax.
template <typename T, int HD>
__global__ void __launch_bounds__((Fwd<T, HD>::THREADS),
                                  (Fwd<T, HD>::BLOCKS)) fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int causal,
    int window, float softcap, float scale) {
  using C = Fwd<T, HD>;
  constexpr int RS = C::RS, TILE = C::TILE, COLS = C::COLS, NT = C::NT;
  constexpr int DT = C::DT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ss = Qs + TILE;  // buffer b: k at Ss + 2 b TILE, v one TILE further

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % C::WM, wn = warp / C::WM;
  const int g = lane >> 2, t = lane & 3;
  // query tiles along y, the last (the heaviest when causal) first for
  // all heads
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * C::ROWS, r0 = q0 + wm * 16;
  const long long bh = blockIdx.x;
  const T* kg = k + bh * Sk * HD;
  const T* vg = v + bh * Sk * HD;
  async_tile<T, HD, C>(Qs, q + bh * Sq * HD, q0, Sq);
  cp_async_commit();  // Q in a group of its own, ahead of the ring's

  int k_begin, k_end;
  key_span<COLS>(q0, min(C::ROWS, Sq - q0), Sk, causal, window, k_begin,
                 k_end);
  const int n_tiles = (k_end - k_begin + COLS - 1) / COLS;
  // tiles with no mask, no soft cap and no missing key take a short path
  const bool plain = softcap <= 0.f && window <= 0;
  const float scale_log2 = scale * kLog2e;

  auto stage = [&](int i) {
    T* dst = Ss + (i & 1) * 2 * TILE;
    async_tile<T, HD, C>(dst, kg, k_begin + i * COLS, Sk);
    async_tile<T, HD, C>(dst + TILE, vg, k_begin + i * COLS, Sk);
  };
  ring_start(n_tiles, stage);

  const T* Qw = Qs + wm * 16 * RS;
  uint32_t qa[sizeof(T) == 2 ? HD / 16 : 1][4];
  if constexpr (sizeof(T) == 2) {
    cp_async_wait<1>();  // the Q tile's group (tile 0's may be in flight)
    __syncthreads();
    const int ar = lane & 15, ac = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldsm_x4(qa[kk], Qw + ar * RS + 16 * kk + ac);
  }

  // rows r0 + g (h = 0) and r0 + g + 8 (h = 1): the running max in log2
  // units (-inf until the first tile: a row that sees no key then holds
  // the masked logit and weighs every key 1), this lane's share of the
  // running sum, and the output columns DW wn ..
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    ring_next(i, n_tiles, stage);
    const T* Kt = Ss + (i & 1) * 2 * TILE;
    const T* Vt = Kt + TILE;
    const int kb = k_begin + i * COLS;
    const bool full =
        plain && kb + COLS <= Sk && (!causal || r0 >= kb + COLS - 1);
    float s[NT][4];
    fwd_scores<T, HD, RS, NT>(qa, Qw, Kt, lane, s);
    // s * mul is the logit in log2 units: a visible tile keeps the raw
    // dot products and folds scale * log2(e) into the exponent's FMA
    const float mul = full ? scale_log2 : 1.f;
    if (!full) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = kLog2e * logit(s[j][e], r0 + g + 8 * (e >> 1),
                                   kb + 8 * j + 2 * t + (e & 1), Sk, causal,
                                   window, scale, softcap);
    }
    float mx[2] = {-INFINITY, -INFINITY}, alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h] * mul);
      alpha[h] = fast_exp2(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(fmaf(s[j][e], mul, -m[e >> 1]));
        s[j][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    if constexpr (sizeof(T) == 2) {
      uint32_t pa[NT / 2][4];
      pack_a<NT>(s, pa);
      warp_accum_bf16<RS, NT / 2, DT>(pa, Vt + wn * C::DW, lane, acc);
    } else {
      warp_accum_tf32<RS, NT, DT>(s, Vt + wn * C::DW, lane, acc);
    }
    ring_done();
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= inv[e >> 1];
  store_acc<T, HD, DT>(o + bh * Sq * HD, acc, r0, wn * C::DW, Sq, 1.f, lane);
  if (wn == 0 && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      if (r < Sq) lse[bh * Sq + r] = (m[h] + log2f(l[h])) * kLn2;
    }
  }
}

// ----------------------------------------------------------------- backward

// D[row] = sum_d dO[row, d] * o[row, d], one warp per row.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ delta, long long rows) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32)
    acc = fmaf(to_f32(dout[row * HD + d]), to_f32(o[row * HD + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// p = exp(x - lse) and dS = p * (dP - D) * softcap'(u) for one entry of
// logit x.  A masked or missing key has dS = 0 exactly (its logit has no
// tanh to differentiate) and p = 0, except a masked key of a row that sees
// no key (lse = -1e30 + log Sk, which rounds to -1e30): its weight is 1/Sk.
__device__ __forceinline__ void grad_entry(float x, float dp, float lse_r,
                                           float d_r, float softcap,
                                           float inv_sk, float& p, float& ds) {
  if (x <= kMasked) {
    p = x == kMasked && lse_r <= 0.5f * kMasked ? inv_sk : 0.f;
    ds = 0.f;
    return;
  }
  p = expf(x - lse_r);
  ds = p * (dp - d_r);
  if (softcap > 0.f) {
    const float t = x / softcap;  // tanh(u / cap) of an unmasked logit
    ds *= 1.f - t * t;
  }
}

// Per head dim: WM x WN warps; a block owns ROWS = 16 * WM rows and streams
// tiles of COLS = ROWS rows; warp (wm, wn) owns rows 16 wm .. 16 wm + 15 and
// output columns DW wn .. DW wn + DW - 1.  Shared memory holds six (COLS,
// HD) tiles: the block's own two and two stages of the two streamed ones.
template <typename T, int HD>
struct Bwd {
  static constexpr int WM = HD >= 256 ? 2 : 4;
  static constexpr int WN = HD >= 128 ? HD / 64 : 1;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int ROWS = 16 * WM;
  static constexpr int COLS = ROWS;
  static constexpr int NT = COLS / 8;         // score n-tiles of a warp
  static constexpr int DW = HD / WN;
  static constexpr int DT = DW / 8;           // output n-tiles of a warp
  static constexpr int RS = HD + 16 / (int)sizeof(T);  // padded row stride
  static constexpr int TILE = COLS * RS;      // elements of one tile
  static constexpr size_t SMEM =
      6 * TILE * sizeof(T) + 4 * COLS * sizeof(float);
  // blocks an SM should hold (registers are capped to fit them); bf16 at
  // hd <= 64 has the shared memory for 3 dK/dV or 4 dQ blocks
  static constexpr bool SMALL = sizeof(T) == 2 && HD <= 64;
  static constexpr int DKDV_BLOCKS = SMALL ? 3 : 1;
  static constexpr int DQ_BLOCKS = SMALL ? 4 : 1;
};

// What the two passes share of a tile's element-wise step.
struct Mask {
  int Sq, Sk, causal, window;
  float softcap, scale, scale_log2, inv_sk;
};

// The dK/dV pass's scores of one warp over NP n-tiles from column col0 of
// the streamed tile: s = K Q^T becomes p and dp = V dO^T becomes dS
// (transposed: rows are the warp's keys c0 .., columns queries q0 +
// col0 ..).  full: every pair of the tile is seen and exists.
template <typename T, int HD, int RS, int NP>
__device__ __forceinline__ void dkdv_part(
    const T* Kw, const T* Vw, const T* Qt, const T* dOt, int col0,
    const float* lse_s, const float* d_s, bool full, int c0, int q0,
    const Mask& mk, int lane, float (&s)[NP][4], float (&dp)[NP][4]) {
  warp_scores<T, HD, RS, NP>(Kw, Qt + col0 * RS, Vw, dOt + col0 * RS, lane,
                             s, dp);
  const int g = lane >> 2, t = lane & 3;
  if (full) {
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = col0 + 8 * j + 2 * t + (e & 1);
        const float p =
            fast_exp2(fmaf(s[j][e], mk.scale_log2, -lse_s[rr] * kLog2e));
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - d_s[rr]);
      }
    return;
  }
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + g + 8 * (e >> 1);
      const int rr = col0 + 8 * j + 2 * t + (e & 1);
      const int r = q0 + rr;
      float p = 0.f, ds = 0.f;
      if (r < mk.Sq) {
        const float x = logit(s[j][e], r, c, mk.Sk, mk.causal, mk.window,
                              mk.scale, mk.softcap);
        grad_entry(x, dp[j][e], lse_s[rr], d_s[rr], mk.softcap, mk.inv_sk, p,
                   ds);
      }
      s[j][e] = p;
      dp[j][e] = ds;
    }
}

// The dQ pass's scores of one warp over NP n-tiles from column col0 of the
// streamed tile: s = Q K^T, and dp = dO V^T becomes dS (rows are the
// warp's queries r0 .., columns keys kb + col0 ..); lse2 = lse * log2(e).
template <typename T, int HD, int RS, int NP>
__device__ __forceinline__ void dq_part(
    const T* Qw, const T* dOw, const T* Kt, const T* Vt, int col0,
    const float (&lse_r)[2], const float (&lse2_r)[2], const float (&d_r)[2],
    bool full, int r0, int kb, const Mask& mk, int lane,
    float (&dp)[NP][4]) {
  float s[NP][4];
  warp_scores<T, HD, RS, NP>(Qw, Kt + col0 * RS, dOw, Vt + col0 * RS, lane,
                             s, dp);
  const int g = lane >> 2, t = lane & 3;
  if (full) {
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = fast_exp2(fmaf(s[j][e], mk.scale_log2, -lse2_r[h]));
        dp[j][e] = p * (dp[j][e] - d_r[h]);
      }
    return;
  }
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const int r = r0 + g + 8 * h;
      const int c = kb + col0 + 8 * j + 2 * t + (e & 1);
      float p = 0.f, ds = 0.f;
      if (r < mk.Sq) {
        const float x = logit(s[j][e], r, c, mk.Sk, mk.causal, mk.window,
                              mk.scale, mk.softcap);
        grad_entry(x, dp[j][e], lse_r[h], d_r[h], mk.softcap, mk.inv_sk, p,
                   ds);
      }
      dp[j][e] = ds;
    }
}

// One block per (key tile, bh): dK and dV of ROWS keys, looping over the
// query tiles that see them.
template <typename T, int HD>
__global__ void __launch_bounds__((Bwd<T, HD>::THREADS),
                                  (Bwd<T, HD>::DKDV_BLOCKS)) dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int Sq, int Sk, int causal, int window, float softcap, float scale) {
  using C = Bwd<T, HD>;
  constexpr int RS = C::RS, TILE = C::TILE, COLS = C::COLS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + TILE;
  T* Ss = Vs + TILE;  // buffer b: q at Ss + 2 b TILE, dO one TILE further
  float* rows_s = reinterpret_cast<float*>(Ss + 4 * TILE);  // lse, D

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % C::WM, wn = warp / C::WM;
  const int g = lane >> 2, t = lane & 3;
  // key tiles along y, so all heads' key tile 0 (the heaviest when
  // causal) starts first
  const int k0 = blockIdx.y * C::ROWS;
  const long long bh = blockIdx.x;
  const T* qg = q + bh * Sq * HD;
  const T* dog = dout + bh * Sq * HD;
  const float* lseg = lse + bh * Sq;
  const float* dg = delta + bh * Sq;
  async_tile<T, HD, C>(Ks, k + bh * Sk * HD, k0, Sk);
  async_tile<T, HD, C>(Vs, v + bh * Sk * HD, k0, Sk);

  // query rows that see keys k0 .. k_last, and the rows r >= Sk + window - 1
  // that see no key (they weigh every key)
  const int k_last = min(k0 + C::ROWS, Sk) - 1;
  const int r_lo = causal ? k0 : 0;
  const int r_hi = window > 0 && Sq < Sk + window ? min(Sq, k_last + window)
                                                  : Sq;
  const int first = (r_lo / COLS) * COLS;
  const int n_tiles = r_hi > first ? (r_hi - first + COLS - 1) / COLS : 0;
  const Mask mk{Sq, Sk, causal, window, softcap, scale, scale * kLog2e,
                1.f / Sk};
  // tiles with no mask, no soft cap and no missing key take a short path
  const bool plain = softcap <= 0.f && window <= 0 && k0 + C::ROWS <= Sk;

  auto stage = [&](int i) {
    const int q0 = first + i * COLS;
    T* dst = Ss + (i & 1) * 2 * TILE;
    float* rdst = rows_s + (i & 1) * 2 * COLS;
    async_tile<T, HD, C>(dst, qg, q0, Sq);
    async_tile<T, HD, C>(dst + TILE, dog, q0, Sq);
    async_row(rdst, lseg, q0, COLS, Sq, C::THREADS);
    async_row(rdst + COLS, dg, q0, COLS, Sq, C::THREADS);
  };
  ring_start(n_tiles, stage);

  float dka[C::DT][4], dva[C::DT][4];
#pragma unroll
  for (int n = 0; n < C::DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    ring_next(i, n_tiles, stage);
    const T* Qt = Ss + (i & 1) * 2 * TILE;
    const T* dOt = Qt + TILE;
    const float* lse_s = rows_s + (i & 1) * 2 * COLS;
    const float* d_s = lse_s + COLS;
    const int q0 = first + i * COLS;
    const bool full =
        plain && q0 + COLS <= Sq && (!causal || q0 >= k0 + C::ROWS - 1);
    const T* Kw = Ks + wm * 16 * RS;
    const T* Vw = Vs + wm * 16 * RS;
    if constexpr (sizeof(T) == 2) {
      // the tile's columns in two halves, each scored, packed to bf16 and
      // accumulated before the next, so fewer score registers are live
      constexpr int NH = C::NT / 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s[NH][4], dp[NH][4];
        uint32_t pa[NH / 2][4], da[NH / 2][4];
        dkdv_part<T, HD, RS, NH>(Kw, Vw, Qt, dOt, 8 * NH * h, lse_s, d_s,
                                 full, k0 + wm * 16, q0, mk, lane, s, dp);
        pack_a<NH>(s, pa);
        pack_a<NH>(dp, da);
        const int off = 8 * NH * h * RS + wn * C::DW;  // the half's rows
        warp_accum_bf16<RS, NH / 2, C::DT>(pa, dOt + off, lane, dva);
        warp_accum_bf16<RS, NH / 2, C::DT>(da, Qt + off, lane, dka);
      }
    } else {
      float s[C::NT][4], dp[C::NT][4];
      dkdv_part<T, HD, RS, C::NT>(Kw, Vw, Qt, dOt, 0, lse_s, d_s, full,
                                  k0 + wm * 16, q0, mk, lane, s, dp);
      warp_accum_tf32<RS, C::NT, C::DT>(s, dOt + wn * C::DW, lane, dva);
      warp_accum_tf32<RS, C::NT, C::DT>(dp, Qt + wn * C::DW, lane, dka);
    }
    ring_done();
  }
  cp_async_wait<0>();

  const long long base = bh * Sk * HD;
  store_acc<T, HD, C::DT>(dk + base, dka, k0 + wm * 16, wn * C::DW, Sk, scale,
                          lane);
  store_acc<T, HD, C::DT>(dv + base, dva, k0 + wm * 16, wn * C::DW, Sk, 1.f,
                          lane);
}

// One block per (query tile, bh): dQ of ROWS queries, looping over its key
// tiles.
template <typename T, int HD>
__global__ void __launch_bounds__((Bwd<T, HD>::THREADS),
                                  (Bwd<T, HD>::DQ_BLOCKS)) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk,
    int causal, int window, float softcap, float scale) {
  using C = Bwd<T, HD>;
  constexpr int RS = C::RS, TILE = C::TILE, COLS = C::COLS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + TILE;
  T* Ss = dOs + TILE;  // buffer b: k at Ss + 2 b TILE, v one TILE further

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % C::WM, wn = warp / C::WM;
  const int g = lane >> 2, t = lane & 3;
  // query tiles along y, the last (the heaviest when causal) first for
  // all heads
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * C::ROWS;
  const long long bh = blockIdx.x;
  const T* kg = k + bh * Sk * HD;
  const T* vg = v + bh * Sk * HD;
  async_tile<T, HD, C>(Qs, q + bh * Sq * HD, q0, Sq);
  async_tile<T, HD, C>(dOs, dout + bh * Sq * HD, q0, Sq);

  float lse_r[2], d_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + wm * 16 + g + 8 * h;
    lse_r[h] = r < Sq ? lse[bh * Sq + r] : 0.f;
    d_r[h] = r < Sq ? delta[bh * Sq + r] : 0.f;
  }
  int k_begin, k_end;
  key_span<COLS>(q0, min(C::ROWS, Sq - q0), Sk, causal, window, k_begin,
                 k_end);
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + COLS - 1) / COLS : 0;
  const Mask mk{Sq, Sk, causal, window, softcap, scale, scale * kLog2e,
                1.f / Sk};
  // tiles with no mask, no soft cap and no missing row take a short path
  const bool plain = softcap <= 0.f && window <= 0 && q0 + C::ROWS <= Sq;
  const float lse2_r[2] = {lse_r[0] * kLog2e, lse_r[1] * kLog2e};

  auto stage = [&](int i) {
    T* dst = Ss + (i & 1) * 2 * TILE;
    async_tile<T, HD, C>(dst, kg, k_begin + i * COLS, Sk);
    async_tile<T, HD, C>(dst + TILE, vg, k_begin + i * COLS, Sk);
  };
  ring_start(n_tiles, stage);

  float dqa[C::DT][4];
#pragma unroll
  for (int n = 0; n < C::DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    ring_next(i, n_tiles, stage);
    const T* Kt = Ss + (i & 1) * 2 * TILE;
    const T* Vt = Kt + TILE;
    const int kb = k_begin + i * COLS;
    const bool full =
        plain && kb + COLS <= Sk && (!causal || q0 >= kb + COLS - 1);
    const T* Qw = Qs + wm * 16 * RS;
    const T* dOw = dOs + wm * 16 * RS;
    if constexpr (sizeof(T) == 2) {
      constexpr int NH = C::NT / 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float dp[NH][4];
        uint32_t da[NH / 2][4];
        dq_part<T, HD, RS, NH>(Qw, dOw, Kt, Vt, 8 * NH * h, lse_r, lse2_r,
                               d_r, full, q0 + wm * 16, kb, mk, lane, dp);
        pack_a<NH>(dp, da);
        warp_accum_bf16<RS, NH / 2, C::DT>(
            da, Kt + 8 * NH * h * RS + wn * C::DW, lane, dqa);
      }
    } else {
      float dp[C::NT][4];
      dq_part<T, HD, RS, C::NT>(Qw, dOw, Kt, Vt, 0, lse_r, lse2_r, d_r, full,
                                q0 + wm * 16, kb, mk, lane, dp);
      warp_accum_tf32<RS, C::NT, C::DT>(dp, Kt + wn * C::DW, lane, dqa);
    }
    ring_done();
  }
  cp_async_wait<0>();

  store_acc<T, HD, C::DT>(dq + bh * Sq * HD, dqa, q0 + wm * 16, wn * C::DW,
                          Sq, scale, lane);
}

// ------------------------------------------------------------------ launch

constexpr int kMaxDevices = 64;

// Raises a kernel's dynamic shared-memory limit above the default 48 KiB,
// once per device and kernel (kernels of one signature share a type, so the
// kernel itself is the template argument).
template <auto kernel>
cudaError_t ensure_smem(size_t smem) {
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && configured[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) configured[dev] = true;
  return err;
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float *lse, *delta;
  int BH, Sq, Sk, causal, window;
  float softcap, scale;
};

template <typename T, int HD>
cudaError_t run_fwd(const Args& a, void* o, float* lse, cudaStream_t s) {
  using C = Fwd<T, HD>;
  cudaError_t err = ensure_smem<fwd_kernel<T, HD>>(C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.BH, (a.Sq + C::ROWS - 1) / C::ROWS);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  fwd_kernel<T, HD><<<grid, C::THREADS, C::SMEM, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(o), lse, a.Sq, a.Sk,
      a.causal, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t run_dkdv(const Args& a, float* delta, void* dk, void* dv,
                     cudaStream_t s) {
  using C = Bwd<T, HD>;
  const long long rows = (long long)a.BH * a.Sq;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  delta_kernel<T, HD><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = ensure_smem<dkdv_kernel<T, HD>>(C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.BH, (a.Sk + C::ROWS - 1) / C::ROWS);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  dkdv_kernel<T, HD><<<grid, C::THREADS, C::SMEM, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), a.Sq, a.Sk, a.causal,
      a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t run_dq(const Args& a, void* dq, cudaStream_t s) {
  using C = Bwd<T, HD>;
  cudaError_t err = ensure_smem<dq_kernel<T, HD>>(C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.BH, (a.Sq + C::ROWS - 1) / C::ROWS);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  dq_kernel<T, HD><<<grid, C::THREADS, C::SMEM, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dq), a.Sq, a.Sk, a.causal, a.window,
      a.softcap, a.scale);
  return cudaGetLastError();
}

bool valid(int BH, int Sq, int Sk) {
  return BH > 0 && BH <= 65535 && Sq > 0 && Sk > 0;
}

// Dispatch on dtype (0 = float32, 1 = bfloat16) and head dim.
#define FLASH_DISPATCH(FN, ...)                                         \
  do {                                                                  \
    if (dtype == 0) {                                                   \
      if (hd == 32) return (int)FN<float, 32>(__VA_ARGS__);             \
      if (hd == 64) return (int)FN<float, 64>(__VA_ARGS__);             \
      if (hd == 128) return (int)FN<float, 128>(__VA_ARGS__);           \
      if (hd == 256) return (int)FN<float, 256>(__VA_ARGS__);           \
    } else if (dtype == 1) {                                            \
      if (hd == 32) return (int)FN<__nv_bfloat16, 32>(__VA_ARGS__);     \
      if (hd == 64) return (int)FN<__nv_bfloat16, 64>(__VA_ARGS__);     \
      if (hd == 128) return (int)FN<__nv_bfloat16, 128>(__VA_ARGS__);   \
      if (hd == 256) return (int)FN<__nv_bfloat16, 256>(__VA_ARGS__);   \
    }                                                                   \
    return (int)cudaErrorInvalidValue;                                  \
  } while (0)

}  // namespace

extern "C" {

// All return a cudaError_t (0 = launched).  q, o, dout: (BH, Sq, hd); k, v:
// (BH, Sk, hd); all contiguous, one dtype (0 = float32, 1 = bfloat16), hd
// 32, 64, 128 or 256.  lse and delta: (BH, Sq) float32.  window <= 0 disables
// the sliding window, softcap <= 0 the soft cap.

// o and lse from q, k, v.
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, int BH, int Sq, int Sk, int hd, int causal,
              int window, float softcap, float scale, int dtype,
              void* stream) {
  if (!valid(BH, Sq, Sk)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, nullptr, nullptr, nullptr, BH, Sq, Sk, causal,
               window, softcap, scale};
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(run_fwd, a, o, l, s);
}

// delta = rowsum(dout * o), then dk and dv.
int flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* delta, void* dk,
                   void* dv, int BH, int Sq, int Sk, int hd, int causal,
                   int window, float softcap, float scale, int dtype,
                   void* stream) {
  if (!valid(BH, Sq, Sk)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), nullptr,
               BH, Sq, Sk, causal, window, softcap, scale};
  float* d = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(run_dkdv, a, d, dk, dv, s);
}

// dq from the delta that flash_bwd_dkdv wrote.
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int BH, int Sq, int Sk, int hd, int causal,
                 int window, float softcap, float scale, int dtype,
                 void* stream) {
  if (!valid(BH, Sq, Sk)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, nullptr, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), BH, Sq, Sk, causal, window,
               softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(run_dq, a, dq, s);
}

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
