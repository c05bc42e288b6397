// The f32 FMA contraction core shared by K3 f32 (mlp.cu::fused_point_mlp_kernel),
// K2 f32 (sweep.cu::lattice_sweep_kernel) and K6 f32
// (point_query.cu::level_fc0_kernel): the f32 counterpart of mma_bf16.cuh.  Every product is an f32 FMA on the CUDA cores (no tensor
// cores, no TF32), and each output sums its K terms in order k = 0, 1, ...,
// K - 1 from 0, as the plain version's contraction does up to the order of
// its own sums.
//
// A block owns a tile of kM points x HP columns and contracts
//
//     acc[point][col] += sum_k A[k][point] * B[k][col]
//
// over K rows in chunks of kK rows.  A chunk of A is [kK][kM] f32 and a
// chunk of B [kK][HP] f32, both in shared memory.  B is a weight's rows
// (row-major (K, H), the (in, out) layout) and streams through a
// two-stage cp.async ring, read once per kM points; A is streamed too (K3's
// features, K2's and K6's gathered features) or resident (the hidden
// activations of fma_decoder_tail).
//
// Register blocking: thread (ty, tx) owns an 8 x 8 outer-product tile,
// points {4 ty + i, kM/2 + 4 ty + i} and columns {4 tx + j, HP/2 + 4 tx + j}
// (i, j < 4).  Per k it reads two float4 of A and two of B for 64 FMAs, 16
// FMAs a shared-memory load.  A warp is WY x WX threads (4 x 8, or 2 x 16
// when kM / 8 is not a multiple of 4), so its A reads are WY distinct
// float4 and its B reads WX distinct float4: one or two wavefronts each, no
// bank conflicts.
//
// The chunk loop (contract) waits for chunk c's copies, lets the A source
// finish chunk c (K6 combines its gathered corners there), passes one
// barrier, issues chunk c + 1's copies into the other stage, then runs
// chunk c's FMAs: the copies of one chunk overlap the FMAs of the one
// before, and there is one barrier a chunk.
//
// Edges: rows past K and columns past H load as zeros (cp.async zero fill),
// so a ragged last chunk and padded columns add exactly nothing (fmaf(0, 0,
// acc) == acc); 16-byte copies where the row length is a multiple of 4 and
// the source 16-byte aligned, else 4-byte copies.  store_relu writes bias +
// ReLU of the tile into a [HP][kM] activation buffer, the A operand of the
// next layer (fc1 and fc2 in fma_decoder_tail, the decoder after fc0 that K3
// f32 and K2 f32 share): padded columns hold relu(0 + 0) = 0, so they add
// nothing downstream, and nothing past H is ever stored to device memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

// rows [r0, r0 + kRows) and columns [c0, c0 + kCols) of a row-major (n_rows,
// n_cols) f32 matrix into dst [kRows][kCols], zeros outside the matrix; vec:
// 16-byte copies (n_cols % 4 == 0, src 16-byte aligned, c0 % 4 == 0, so a
// quad of columns is all in or all out)
template <int kRows, int kCols, int NT>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int n_rows,
                                          int n_cols, int r0, int c0, bool vec) {
  // fixed trip counts, so that the index arithmetic of each copy is a few
  // instructions and not a loop's (it runs once a chunk beside 1,024 FMAs)
  if (vec) {
    constexpr int kQuads = kCols / 4, kItems = kRows * kQuads;
#pragma unroll
    for (int u = 0; u < (kItems + NT - 1) / NT; ++u) {
      const int i = threadIdx.x + u * NT;
      if (kItems % NT != 0 && i >= kItems) break;
      const int r = i / kQuads, q = i - r * kQuads;
      const int row = r0 + r, col = c0 + 4 * q;
      const bool in = row < n_rows && col < n_cols;
      cp_async16_zfill(dst + r * kCols + 4 * q, in ? src + (int64_t)row * n_cols + col : src,
                       in ? 16 : 0);
    }
  } else {
    constexpr int kItems = kRows * kCols;
#pragma unroll
    for (int u = 0; u < (kItems + NT - 1) / NT; ++u) {
      const int i = threadIdx.x + u * NT;
      if (kItems % NT != 0 && i >= kItems) break;
      const int r = i / kCols, q = i - r * kCols;
      const int row = r0 + r, col = c0 + q;
      const bool in = row < n_rows && col < n_cols;
      cp_async4_zfill(dst + i, in ? src + (int64_t)row * n_cols + col : src, in ? 4 : 0);
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int kM_, int HP_>
struct FmaTile {
  static constexpr int kM = kM_, HP = HP_;
  static constexpr int TY = kM / 8, TX = HP / 8;
  static constexpr int NT = TX * TY;
  static constexpr int WY = TY % 4 == 0 ? 4 : 2, WX = 32 / WY;
  static constexpr int kK = 4096 / HP;  // rows a chunk: each B stage is 16 KB
  static_assert(kM % 8 == 0 && HP % 8 == 0 && TY % WY == 0 && TX % WX == 0, "tile shape");
  // shared memory of the two B stages
  static constexpr int kBBytes = 2 * kK * HP * 4;

  float acc[8][8];  // [point i][column j]
  int ty, tx;

  __device__ __forceinline__ void init() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    constexpr int kWarpsX = TX / WX;
    tx = (warp % kWarpsX) * WX + lane % WX;
    ty = (warp / kWarpsX) * WY + lane / WX;
    zero();
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  // the tile's point of row i and column of column j
  __device__ __forceinline__ int point(int i) const {
    return (i < 4 ? 4 * ty : kM / 2 + 4 * ty - 4) + i;
  }
  __device__ __forceinline__ int col(int j) const {
    return (j < 4 ? 4 * tx : HP / 2 + 4 * tx - 4) + j;
  }

  // acc += a[k][.] b[k][.] for k < kK; a [kK][kM], b [kK][HP] in shared memory
  __device__ __forceinline__ void mac(const float* a, const float* b) {
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + k * kM + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(a + k * kM + kM / 2 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(b + k * HP + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(b + k * HP + HP / 2 + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  // act[c][p] = relu(acc + bias[c]) for the tile's columns c < h_out, 0 for
  // the padded ones; acc zeroed.  The caller has passed a barrier since the
  // last read of act.
  __device__ __forceinline__ void store_relu(float* act, const float* __restrict__ bias,
                                             int h_out) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col(j);
      const bool in = c < h_out;
      const float bj = in ? __ldg(bias + c) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 v;
        v.x = in ? fmaxf(acc[4 * h][j] + bj, 0.f) : 0.f;
        v.y = in ? fmaxf(acc[4 * h + 1][j] + bj, 0.f) : 0.f;
        v.z = in ? fmaxf(acc[4 * h + 2][j] + bj, 0.f) : 0.f;
        v.w = in ? fmaxf(acc[4 * h + 3][j] + bj, 0.f) : 0.f;
        *reinterpret_cast<float4*>(act + c * kM + point(4 * h)) = v;
      }
    }
    zero();
  }
};

// An A operand that lies whole in shared memory ([K][kM], rows past K zero
// up to the last chunk): the decoder's hidden activations.
template <int kM, int kK>
struct ResidentA {
  const float* a;
  __device__ __forceinline__ void issue(int) {}
  __device__ __forceinline__ void finish(int) {}
  __device__ __forceinline__ const float* chunk(int c) const { return a + c * kK * kM; }
};

// acc += A (K x kM) B, B = rows [0, K) and columns [c0, c0 + HP) of the
// row-major (K, h_out) weight w streamed through bring ([2][kK][HP] shared
// memory).  src supplies A chunk by chunk: issue(c) starts chunk c's copies
// (before the commit that also holds B's), finish(c) completes it after they
// landed (before the barrier), chunk(c) is its [kK][kM] tile.  On return
// every thread has finished its FMAs, but other threads may still read the
// last stages: pass a barrier before reusing them.
template <class Tile, class ASrc>
__device__ __forceinline__ void contract(Tile& t, ASrc& src, const float* __restrict__ w, int K,
                                         int h_out, int c0, float* bring) {
  constexpr int kK = Tile::kK, HP = Tile::HP, NT = Tile::NT;
  const bool vec = h_out % 4 == 0 && aligned16(w);
  const int chunks = (K + kK - 1) / kK;
  load_tile<kK, HP, NT>(bring, w, K, h_out, 0, c0, vec);
  src.issue(0);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<0>();
    src.finish(c);
    __syncthreads();  // chunk c complete for all; every thread is past chunk c - 1's FMAs
    if (c + 1 < chunks) {
      load_tile<kK, HP, NT>(bring + ((c + 1) & 1) * kK * HP, w, K, h_out, (c + 1) * kK, c0, vec);
      src.issue(c + 1);
      cp_async_commit();
    }
    t.mac(src.chunk(c), bring + (c & 1) * kK * HP);
  }
}

// The IF-Net decoder after fc0, one copy for K3 f32 and K2 f32: t holds the
// tile's fc0 sums.  bias + ReLU into act ([HP][kM], shared memory over the
// caller's fc0 A operand, which no thread reads any more once the first
// barrier is passed), fc1 (h0 -> h1) and fc2 (h1 -> h2) by contract() on the
// resident activations with their row-major (in, out) weights streamed
// through bring, then fc_out: TP threads a point, each a strided share of
// the h2 terms, summed over the shares in order in shared memory (over the
// B ring), plus b3.  out[p] for the tile's points p < valid.
template <class Tile>
__device__ __forceinline__ void fma_decoder_tail(Tile& t, float* act, float* bring,
                                                 const float* __restrict__ b0,
                                                 const float* __restrict__ w1t,
                                                 const float* __restrict__ b1,
                                                 const float* __restrict__ w2t,
                                                 const float* __restrict__ b2,
                                                 const float* __restrict__ w3,
                                                 const float* __restrict__ b3,
                                                 float* __restrict__ out, int valid, int h0,
                                                 int h1, int h2) {
  constexpr int kM = Tile::kM, kK = Tile::kK, NT = Tile::NT;
  static_assert(Tile::HP * kM >= 2 * kK * kM && Tile::kBBytes >= NT * 4, "shared-memory reuse");
  __syncthreads();  // the fc0 A operand (under act) and the B ring are read
  t.store_relu(act, b0, h0);
  ResidentA<kM, kK> hidden{act};
  contract(t, hidden, w1t, h0, h1, 0, bring);
  __syncthreads();
  t.store_relu(act, b1, h1);
  contract(t, hidden, w2t, h1, h2, 0, bring);
  __syncthreads();
  t.store_relu(act, b2, h2);
  __syncthreads();

  constexpr int TP = NT / kM;
  const int p = threadIdx.x % kM, part = threadIdx.x / kM;
  float s = 0.f;
  for (int c = part; c < h2; c += TP) s = fmaf(act[c * kM + p], __ldg(w3 + c), s);
  bring[part * kM + p] = s;
  __syncthreads();
  if (threadIdx.x < kM && p < valid) {
    float r = bring[p];
#pragma unroll
    for (int q = 1; q < TP; ++q) r += bring[q * kM + p];
    out[p] = r + __ldg(b3);
  }
}

}  // namespace
