// bf16 tensor-core building blocks shared by the three kernels that run a
// tile of points through mma.sync: K2 bf16 (sweep.cu::lattice_sweep_bf16_kernel),
// K3 bf16 (mlp.cu::fused_point_mlp_bf16_kernel) and K6 bf16
// (point_query.cu::level_fc0_bf16_kernel).
//
// The tile: kM = 64 points, 4 m-tiles of 16 rows (K3 bf16 also
// instantiates 2 m-tiles, 32 points, at H0 512), its A chunk (a point's
// features of one group, up to 128 of them) row-major bf16 in shared
// memory with rows padded to kAStride.  B (a weight matrix) arrives in the fragment order of
// ops/cuda/layouts.py::mma_b_fragments through a per-warp cp.async ring
// (BStream).  gather_group fills an A chunk from a channels-last bf16 level:
// per point, 8 corners (32-bit element offset, f32 weight) that the caller
// computed into shared memory, interpolated in f32 and rounded to bf16 once
// (round to nearest even).  decoder_tail is the IF-Net decoder after fc0's
// sums, one copy for K2 bf16 and K3 bf16: bias + ReLU rounded to bf16, fc1
// and fc2 on the tensor cores, fc_out as an f32 dot.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kM = 64;          // points per tile: 4 m-tiles of 16 rows
constexpr int kAStride = 136;   // bf16 per A row: up to 128 channels + 8, 272 bytes = 17
                                // 16-byte units, so ldmatrix's 8 rows hit 8 distinct banks
constexpr int kStages = 3;      // depth of each warp's cp.async ring of B fragments

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// One warp's stream of B fragments (a weight matrix laid out by
// ops/cuda/layouts.py::mma_b_fragments: per 16-row chunk of K, per pair of
// 8-column n-tiles, per lane, the 8 bf16 of that lane's fragments of both
// tiles) through a kDepth-deep cp.async ring in shared memory (kStages for
// K2 bf16, K6 bf16 and the decoder tail; K3 bf16's fc0 keeps a deeper one).
// Each lane copies and later reads back only its own 16 bytes per pair, so
// the ring needs no barrier: cp.async.wait_group orders a lane's own copies.
template <int kPairs, int kDepth = kStages>
struct BStream {
  const uint4* src;  // this warp's first pair in chunk 0
  int stride;        // uint4 per chunk (all pairs of the matrix x 32 lanes)
  int n_chunks;
  uint4* ring;       // this warp's ring: kDepth x kPairs x 32 uint4
  int lane;
  int next;

  __device__ __forceinline__ void fetch() {
    if (next < n_chunks) {
      uint4* dst = ring + (next % kDepth) * kPairs * 32 + lane;
      const uint4* s = src + (int64_t)next * stride + lane;
#pragma unroll
      for (int p = 0; p < kPairs; ++p) cp_async16(dst + p * 32, s + p * 32);
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
    ++next;
  }
  __device__ __forceinline__ void start() {
    next = 0;
#pragma unroll
    for (int i = 0; i < kDepth - 1; ++i) fetch();
  }
  // chunk k's fragments, k = 0, 1, 2, ... in turn: b[t] for the warp's n-tile t
  __device__ __forceinline__ void get(int k, uint32_t (&b)[2 * kPairs][2]) {
    fetch();
    cp_async_wait<kDepth - 1>();
    const uint4* r = ring + (k % kDepth) * kPairs * 32 + lane;
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const uint4 v = r[p * 32];
      b[2 * p][0] = v.x;
      b[2 * p][1] = v.y;
      b[2 * p + 1][0] = v.z;
      b[2 * p + 1][1] = v.w;
    }
  }
};

// acc[mt][nt] += A[mt*16.., col..col+16) x B chunk, A row-major bf16 in
// shared memory with a row stride of `stride`; the warp takes all kMT * 16 rows
template <int kNT, int kMT>
__device__ __forceinline__ void mma_chunk(float (&acc)[kMT][kNT][4], const bf16* a, int stride,
                                          int col, const uint32_t (&b)[kNT][2], int lane) {
  const bf16* p = a + (lane & 15) * stride + col + (lane >> 4) * 8;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    uint32_t af[4];
    ldmatrix_x4(af, p + mt * 16 * stride);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) mma_bf16(acc[mt][nt], af, b[nt][0], b[nt][1]);
  }
}

// The A chunk of one group: a[p][c] = sum_j w_j * vol[corner j][c] in f32,
// rounded to bf16 once, from the tile's corners off[p * 8 + j] (element
// offsets into the channels-last bf16 level, c channels a voxel) and w[p * 8
// + j].  One item is a point's 8 channels: each corner's 8 channels are one
// 16-byte read.  c % 8 == 0.
template <int NT>
__device__ __forceinline__ void gather_group(const bf16* __restrict__ vol, int c, const int* off,
                                             const float* w, bf16* a) {
  const int pieces = c >> 3;
  for (int i = threadIdx.x; i < kM * pieces; i += NT) {
    const int p = i / pieces, piece = i - p * pieces;
    const bf16* src = vol + piece * 8;
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint4 raw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        raw[j] = __ldg(reinterpret_cast<const uint4*>(src + off[p * 8 + half * 4 + j]));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float wj = w[p * 8 + half * 4 + j];
        const uint32_t u[4] = {raw[j].x, raw[j].y, raw[j].z, raw[j].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[2 * q] = fmaf(wj, bf16_lo(u[q]), acc[2 * q]);
          acc[2 * q + 1] = fmaf(wj, bf16_hi(u[q]), acc[2 * q + 1]);
        }
      }
    }
    const uint4 v = make_uint4(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]),
                               pack_bf16(acc[4], acc[5]), pack_bf16(acc[6], acc[7]));
    *reinterpret_cast<uint4*>(a + p * kAStride + piece * 8) = v;
  }
}

// relu(acc + bias) rounded to bf16 into h[row][n0 + col] (the mma
// accumulator layout: rows lane/4 and lane/4 + 8, columns 2 (lane % 4) + 0, 1)
template <int kNT, int kMT>
__device__ __forceinline__ void store_hidden(const float (&acc)[kMT][kNT][4],
                                             const float* __restrict__ bias, bf16* h, int hs,
                                             int n0, int lane) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int col = n0 + nt * 8 + (lane & 3) * 2;
    const float c0 = __ldg(bias + col), c1 = __ldg(bias + col + 1);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int row = mt * 16 + (lane >> 2);
      const float* v = acc[mt][nt];
      *reinterpret_cast<uint32_t*>(h + row * hs + col) =
          pack_bf16(fmaxf(v[0] + c0, 0.f), fmaxf(v[1] + c1, 0.f));
      *reinterpret_cast<uint32_t*>(h + (row + 8) * hs + col) =
          pack_bf16(fmaxf(v[2] + c0, 0.f), fmaxf(v[3] + c1, 0.f));
    }
  }
}

// One hidden layer of 256 outputs on the tile: h (kMT*16 x k_chunks*16 bf16)
// is replaced by relu(W h + b) rounded to bf16 (its first 256 columns).
template <int kNT, int kMT>
__device__ __forceinline__ void dense_bf16(bf16* h, int hs, int k_chunks, BStream<kNT / 2>& bs,
                                           const float* __restrict__ bias, int n0, int lane) {
  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  bs.start();
  for (int k = 0; k < k_chunks; ++k) {
    uint32_t b[kNT][2];
    bs.get(k, b);
    mma_chunk<kNT>(acc, h, hs, k * 16, b, lane);
  }
  __syncthreads();  // every warp has read h
  store_hidden<kNT>(acc, bias, h, hs, n0, lane);
  __syncthreads();
}

// The decoder after fc0 on a tile of kMT * 16 points, NW warps, H0 = 32 NW:
// acc holds warp w's fc0 sums, columns [32 w, 32 w + 32) of every point.
// bias + ReLU rounded to bf16 into h ([kMT * 16][H0 + 8] bf16, shared
// memory that no warp reads any more), fc1 (H0 -> 256) and fc2 (256 -> 256)
// as MMAs with their weights (mma_b_fragments order) streamed through the
// warp's ring, each ReLU output rounded to bf16, then fc_out: a 256-term
// f32 dot a point of the bf16 hidden values and w3 (bf16 values held in
// f32), NW * 32 / (kMT * 16) threads a point, plus b3.  out[p] for the
// tile's points p < valid.
template <int NW, int kMT>
__device__ __forceinline__ void decoder_tail(const float (&acc)[kMT][4][4], bf16* h,
                                             const float* __restrict__ b0,
                                             const uint4* __restrict__ w1f,
                                             const float* __restrict__ b1,
                                             const uint4* __restrict__ w2f,
                                             const float* __restrict__ b2,
                                             const float* __restrict__ w3,
                                             const float* __restrict__ b3, uint4* ring,
                                             float* __restrict__ out, int valid) {
  constexpr int H0 = NW * 32;
  constexpr int HS = H0 + 8;        // hidden row stride (bf16): an odd number of 16-byte units
  constexpr int kTailNT = 32 / NW;  // n-tiles per warp in fc1 and fc2
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  store_hidden<4>(acc, b0, h, HS, warp * 32, lane);
  __syncthreads();
  BStream<kTailNT / 2> bs1{w1f + warp * (kTailNT / 2) * 32, 16 * 32, H0 / 16, ring, lane, 0};
  dense_bf16<kTailNT, kMT>(h, HS, H0 / 16, bs1, b1, warp * (256 / NW), lane);
  BStream<kTailNT / 2> bs2{w2f + warp * (kTailNT / 2) * 32, 16 * 32, 16, ring, lane, 0};
  dense_bf16<kTailNT, kMT>(h, HS, 16, bs2, b2, warp * (256 / NW), lane);

  constexpr int TP = NW * 32 / (kMT * 16);
  const int p = tid / TP, part = tid % TP;
  float s = 0.f;
  for (int c = part; c < 256; c += TP) s = fmaf(__bfloat162float(h[p * HS + c]), __ldg(w3 + c), s);
#pragma unroll
  for (int o = TP / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (part == 0 && p < valid) out[p] = s + __ldg(b3);
}

}  // namespace
