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
// Backward, deterministic (no atomics; every output element is summed by one
// thread, in a fixed order):
//   flash_bwd_dkdv: D[r] = sum_d dO[r, d] * o[r, d]   (one warp per row)
//                   then one block per key tile loops over the query tiles
//                   that see it: p = exp(s - lse), dP = dO v^T,
//                   dS = p * (dP - D) * (1 - tanh^2(u / cap)),
//                   dV += p^T dO,  dK += scale * dS^T q;
//   flash_bwd_dq:   one block per query tile loops over its key tiles:
//                   dQ += scale * dS k.
//
// What bounds it: operations.  A causal forward does 2*B*H*S^2*hd flops on
// 4 * B*H*S*hd elements; at S = 2048 that is ~1000 flops per byte, far
// above the card's balance.  This first version runs the products on the
// CUDA cores in f32 (also for bfloat16 inputs, which are widened on load),
// so its ceiling is the f32 rate, not the tensor cores'.
//
// Design (correct first):
//  * the TPU grid (B*H, q blocks, kv blocks) with the kv axis sequential
//    becomes one block of 256 threads per (q tile, bh) that loops over its
//    key tiles (forward, dQ), or per (key tile, bh) that loops over its query
//    tiles (dK/dV); the running max m, sum l and the accumulators live in
//    registers;
//  * tiles of 64 rows (32 at hd 256) are staged in shared memory as f32,
//    rows padded to hd + 4 floats so that the 16-byte reads of 8
//    consecutive rows hit distinct banks;
//  * a thread (ty, tx) of the 16 x 16 layout owns the score-tile entries
//    (ty + 16 i, tx + 16 j) and the output entries (ty + 16 i, 4 tx + 64 c
//    .. +3), so the row statistics of its rows stay in its registers and
//    are reduced over the 16 lanes of a half-warp with shuffles;
//  * causal query tiles are scheduled heaviest first.
// Tensor cores (wgmma), TMA staging and GQA without expanded heads are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Tile shapes per head dim: BM rows of the tile a block owns, BN rows of the
// tile it streams (both 64, or 32 at hd 256 to fit shared memory).
template <int HD>
struct Tiles {
  static constexpr int BM = HD >= 256 ? 32 : 64;
  static constexpr int BN = BM;
  static constexpr int SP = HD + 4;   // row stride of a (rows, hd) tile
  static constexpr int PS = BN + 16;  // row stride of a score tile
  static constexpr int RM = BM / 16;  // owned rows per thread
  static constexpr int RN = BN / 16;  // streamed rows per thread
  static constexpr int NC = HD / 64;  // float4 chunks of a row per thread
};

// Rows [row0, row0 + rows) of a (S, HD) matrix into a (rows, SP) f32 tile;
// rows past S read zeros.
template <typename T, int HD, int SP>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int rows, int S) {
  for (int idx = threadIdx.x; idx < rows * HD; idx += kThreads) {
    const int r = idx / HD, d = idx - r * HD;
    const int g = row0 + r;
    dst[r * SP + d] = g < S ? to_f32(src[(long long)g * HD + d]) : 0.f;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][j] = sum_d A[(ty + 16 i)][d] * B[(tx + 16 j)][d] over one tile pair.
template <int HD, int SP, int RA, int RB>
__device__ __forceinline__ void tile_dot(const float* A, const float* B,
                                         int ty, int tx, float (&acc)[RA][RB]) {
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int j = 0; j < RB; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[RA], b[RB];
#pragma unroll
    for (int i = 0; i < RA; ++i) a[i] = ld4(A + (ty + 16 * i) * SP + d);
#pragma unroll
    for (int j = 0; j < RB; ++j) b[j] = ld4(B + (tx + 16 * j) * SP + d);
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < RB; ++j) acc[i][j] = dot4(a[i], b[j], acc[i][j]);
  }
}

// out[i][4c + e] += sum_k W[(ty + 16 i) * ws + k] * X[k * SP + 4 tx + 64 c + e]
// for k < K: the (rows, K) weight tile W times the (K, HD) tile X.
template <int HD, int SP, int R, int NC>
__device__ __forceinline__ void tile_acc(const float* W, int ws, const float* X,
                                         int K, int ty, int tx,
                                         float (&out)[R][4 * NC]) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float w[R];
#pragma unroll
    for (int i = 0; i < R; ++i) w[i] = W[(ty + 16 * i) * ws + k];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 x = ld4(X + k * SP + 4 * tx + 64 * c);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        out[i][4 * c + 0] = fmaf(w[i], x.x, out[i][4 * c + 0]);
        out[i][4 * c + 1] = fmaf(w[i], x.y, out[i][4 * c + 1]);
        out[i][4 * c + 2] = fmaf(w[i], x.z, out[i][4 * c + 2]);
        out[i][4 * c + 3] = fmaf(w[i], x.w, out[i][4 * c + 3]);
      }
    }
  }
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

// Sum / max over the 16 lanes of a half-warp (one row's threads).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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

// ------------------------------------------------------------------ forward

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int causal,
    int window, float softcap, float scale) {
  using L = Tiles<HD>;
  constexpr int BM = L::BM, BN = L::BN, SP = L::SP, PS = L::PS;
  constexpr int RM = L::RM, RN = L::RN, NC = L::NC;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * SP;
  float* Vs = Ks + BN * SP;
  float* Ps = Vs + BN * SP;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BM;
  const long long bh = blockIdx.y;
  const T* qg = q + bh * Sq * HD;
  const T* kg = k + bh * Sk * HD;
  const T* vg = v + bh * Sk * HD;

  load_tile<T, HD, SP>(Qs, qg, q0, BM, Sq);
  int k_begin, k_end;
  key_span<BN>(q0, min(BM, Sq - q0), Sk, causal, window, k_begin, k_end);

  float m[RM], l[RM], acc[RM][4 * NC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * NC; ++e) acc[i][e] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, HD, SP>(Ks, kg, k0, BN, Sk);
    load_tile<T, HD, SP>(Vs, vg, k0, BN, Sk);
    __syncthreads();
    float s[RM][RN];
    tile_dot<HD, SP, RM, RN>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        s[i][j] = logit(s[i][j], r, k0 + tx + 16 * j, Sk, causal, window,
                        scale, softcap);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < 4 * NC; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();
    tile_acc<HD, SP, RM, NC>(Ps, PS, Vs, BN, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (bh * Sq + r) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(&orow[4 * tx + 64 * c + e], acc[i][4 * c + e] / denom);
    if (tx == 0) lse[bh * Sq + r] = m[i] + logf(l[i]);
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

// One block per (key tile, bh): dK and dV of BN keys, looping over the
// query tiles that see them.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int Sq, int Sk, int causal, int window, float softcap, float scale) {
  using L = Tiles<HD>;
  constexpr int BM = L::BM, BN = L::BN, SP = L::SP;
  constexpr int PT = BM + 16;  // row stride of the transposed score tiles
  constexpr int RM = L::RM, RN = L::RN, NC = L::NC;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BN * SP;
  float* Qs = Vs + BN * SP;
  float* dOs = Qs + BM * SP;
  float* PTs = dOs + BM * SP;   // (BN keys, BM queries)
  float* dSTs = PTs + BN * PT;  // (BN keys, BM queries)
  float* lse_s = dSTs + BN * PT;
  float* d_s = lse_s + BM;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int k0 = blockIdx.x * BN;
  const long long bh = blockIdx.y;
  const T* qg = q + bh * Sq * HD;
  const T* dog = dout + bh * Sq * HD;
  load_tile<T, HD, SP>(Ks, k + bh * Sk * HD, k0, BN, Sk);
  load_tile<T, HD, SP>(Vs, v + bh * Sk * HD, k0, BN, Sk);

  // query rows that see keys k0 .. k_last, and the rows r >= Sk + window - 1
  // that see no key (they weigh every key)
  const int k_last = min(k0 + BN, Sk) - 1;
  const int r_lo = causal ? k0 : 0;
  const int r_hi = window > 0 && Sq < Sk + window ? min(Sq, k_last + window)
                                                  : Sq;
  const float inv_sk = 1.f / Sk;

  float dka[RN][4 * NC], dva[RN][4 * NC];
#pragma unroll
  for (int i = 0; i < RN; ++i)
#pragma unroll
    for (int e = 0; e < 4 * NC; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int q0 = (r_lo / BM) * BM; q0 < r_hi; q0 += BM) {
    __syncthreads();
    load_tile<T, HD, SP>(Qs, qg, q0, BM, Sq);
    load_tile<T, HD, SP>(dOs, dog, q0, BM, Sq);
    for (int r = threadIdx.x; r < BM; r += kThreads) {
      const bool in = q0 + r < Sq;
      lse_s[r] = in ? lse[bh * Sq + q0 + r] : 0.f;
      d_s[r] = in ? delta[bh * Sq + q0 + r] : 0.f;
    }
    __syncthreads();
    float s[RN][RM], dp[RN][RM];
    tile_dot<HD, SP, RN, RM>(Ks, Qs, ty, tx, s);
    tile_dot<HD, SP, RN, RM>(Vs, dOs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < RN; ++i) {
      const int c = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const int rr = tx + 16 * j;
        const int r = q0 + rr;
        float p = 0.f, ds = 0.f;
        if (r < Sq) {
          const float x = logit(s[i][j], r, c, Sk, causal, window, scale,
                                softcap);
          grad_entry(x, dp[i][j], lse_s[rr], d_s[rr], softcap, inv_sk, p,
                     ds);
        }
        PTs[(ty + 16 * i) * PT + rr] = p;
        dSTs[(ty + 16 * i) * PT + rr] = ds;
      }
    }
    __syncthreads();
    tile_acc<HD, SP, RN, NC>(PTs, PT, dOs, BM, ty, tx, dva);
    tile_acc<HD, SP, RN, NC>(dSTs, PT, Qs, BM, ty, tx, dka);
  }

#pragma unroll
  for (int i = 0; i < RN; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= Sk) continue;
    T* krow = dk + (bh * Sk + c) * HD;
    T* vrow = dv + (bh * Sk + c) * HD;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        store(&krow[4 * tx + 64 * cc + e], dka[i][4 * cc + e] * scale);
        store(&vrow[4 * tx + 64 * cc + e], dva[i][4 * cc + e]);
      }
  }
}

// One block per (query tile, bh): dQ of BM rows, looping over its key tiles.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk,
    int causal, int window, float softcap, float scale) {
  using L = Tiles<HD>;
  constexpr int BM = L::BM, BN = L::BN, SP = L::SP, PS = L::PS;
  constexpr int RM = L::RM, RN = L::RN, NC = L::NC;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BM * SP;
  float* Ks = dOs + BM * SP;
  float* Vs = Ks + BN * SP;
  float* dSs = Vs + BN * SP;  // (BM queries, BN keys)

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BM;
  const long long bh = blockIdx.y;
  const T* kg = k + bh * Sk * HD;
  const T* vg = v + bh * Sk * HD;
  load_tile<T, HD, SP>(Qs, q + bh * Sq * HD, q0, BM, Sq);
  load_tile<T, HD, SP>(dOs, dout + bh * Sq * HD, q0, BM, Sq);

  float lse_r[RM], d_r[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < Sq ? lse[bh * Sq + r] : 0.f;
    d_r[i] = r < Sq ? delta[bh * Sq + r] : 0.f;
  }
  int k_begin, k_end;
  key_span<BN>(q0, min(BM, Sq - q0), Sk, causal, window, k_begin, k_end);

  float dqa[RM][4 * NC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int e = 0; e < 4 * NC; ++e) dqa[i][e] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BN) {
    __syncthreads();
    load_tile<T, HD, SP>(Ks, kg, k0, BN, Sk);
    load_tile<T, HD, SP>(Vs, vg, k0, BN, Sk);
    __syncthreads();
    float s[RM][RN], dp[RM][RN];
    tile_dot<HD, SP, RM, RN>(Qs, Ks, ty, tx, s);
    tile_dot<HD, SP, RM, RN>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        float p = 0.f, ds = 0.f;
        if (r < Sq) {
          const float x = logit(s[i][j], r, k0 + tx + 16 * j, Sk, causal,
                                window, scale, softcap);
          grad_entry(x, dp[i][j], lse_r[i], d_r[i], softcap, 1.f / Sk, p,
                     ds);
        }
        dSs[(ty + 16 * i) * PS + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    tile_acc<HD, SP, RM, NC>(dSs, PS, Ks, BN, ty, tx, dqa);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    T* row = dq + (bh * Sq + r) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(&row[4 * tx + 64 * c + e], dqa[i][4 * c + e] * scale);
  }
}

// ------------------------------------------------------------------ launch

template <int HD>
constexpr size_t fwd_smem() {
  using L = Tiles<HD>;
  return sizeof(float) * ((L::BM + 2 * L::BN) * L::SP + L::BM * L::PS);
}
template <int HD>
constexpr size_t dkdv_smem() {
  using L = Tiles<HD>;
  return sizeof(float) * (2 * (L::BN + L::BM) * L::SP +
                          2 * L::BN * (L::BM + 16) + 2 * L::BM);
}
template <int HD>
constexpr size_t dq_smem() {
  using L = Tiles<HD>;
  return sizeof(float) * (2 * (L::BM + L::BN) * L::SP + L::BM * L::PS);
}

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
  constexpr size_t smem = fwd_smem<HD>();
  cudaError_t err = ensure_smem<fwd_kernel<T, HD>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + Tiles<HD>::BM - 1) / Tiles<HD>::BM, a.BH);
  fwd_kernel<T, HD><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(o), lse, a.Sq, a.Sk,
      a.causal, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t run_dkdv(const Args& a, float* delta, void* dk, void* dv,
                     cudaStream_t s) {
  const long long rows = (long long)a.BH * a.Sq;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  delta_kernel<T, HD><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = dkdv_smem<HD>();
  err = ensure_smem<dkdv_kernel<T, HD>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sk + Tiles<HD>::BN - 1) / Tiles<HD>::BN, a.BH);
  dkdv_kernel<T, HD><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), a.Sq, a.Sk, a.causal,
      a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t run_dq(const Args& a, void* dq, cudaStream_t s) {
  constexpr size_t smem = dq_smem<HD>();
  cudaError_t err = ensure_smem<dq_kernel<T, HD>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + Tiles<HD>::BM - 1) / Tiles<HD>::BM, a.BH);
  dq_kernel<T, HD><<<grid, kThreads, smem, s>>>(
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
      if (hd == 64) return (int)FN<float, 64>(__VA_ARGS__);             \
      if (hd == 128) return (int)FN<float, 128>(__VA_ARGS__);           \
      if (hd == 256) return (int)FN<float, 256>(__VA_ARGS__);           \
    } else if (dtype == 1) {                                            \
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
// 64, 128 or 256.  lse and delta: (BH, Sq) float32.  window <= 0 disables
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
