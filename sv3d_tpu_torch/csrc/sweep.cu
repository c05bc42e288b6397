// Dense-lattice sweep for Hopper: trilinear features of the 7 displaced
// lattice copies at every pyramid level, fc0, and the IF-Net decoder MLP,
// fused per tile of lattice points.  Two kernels, one per compute dtype of
// IFNet.query_lattice:
//
//   K2 f32   lattice_sweep_kernel       (compute_dtype float32, the parity route)
//   K2 bf16  lattice_sweep_bf16_kernel  (compute_dtype bfloat16, the serving default)
//
// Both replace the TPU kernel sv3d_tpu/ops/pallas/sweep.py::fused_sweep_tail.
// The contract is not that kernel's input layout (pre-resized axis-0/1
// partials, m2 stacks, 8-channel padding) but the lattice logits of the
// unfused query_lattice math (sv3d_tpu/models/ifnet.py:648-735) for lattice
// rows [row_offset, row_offset + rows): the sweep plan
// (ops/cuda/sweep.py::SweepPlan) hands the kernels the per-axis 2-tap tables
// of the whole lattice once per sweep (ops/lattice.py::axis_taps, the
// nonzeros of interp_matrix), indexed on axis 0 by the lattice row, so
// out-of-range taps and rows past the lattice weigh 0 and both
// align_corners conventions are the tables' business.  A slab's launch does
// no host work beyond the launch itself.
//
// f32 design: a block owns kTile consecutive lattice points (flattened over
// (row, r1, r2), so no tile is wasted at a row's end).  For each displacement
// d (center, -d0, +d0, -d1, +d1, -d2, +d2) and level l it interpolates the
// tile's C_l features into shared memory and accumulates them straight into
// the fc0 pre-activations held in registers, h[o][t] += W0[o, d*sumC+cg+c] *
// f[c][t]; the 2583-wide feature vector is never whole anywhere.  bias+ReLU,
// fc1, fc2 and fc_out then run in the block on the hidden tile in shared
// memory.  Each thread owns 2 fc0 outputs x kTile points of accumulators, so
// one shared-memory float4 broadcast feeds 8 FMAs.  Bound on the H100: f32
// FMA issue.  fc0 is 2 * 2583 * 256 flop per point, about 2.1 Tflop for the
// 1.62M-point full-scale lattice (fc1 + fc2 add 0.4), against 67 Tflop/s of
// f32 FMA; fc0's weights (2.6 MB) stay in L2 and each block reads them once.
// It agrees with the plain f32 torch version to f32 summation order.
//
// bf16 design: the JAX fused tail's precision class -- levels rounded to
// bf16 (the plan stages them channels-last once a sweep), the feature
// interpolated in f32 with f32 tap weights and rounded to bf16 once (round
// to nearest even), fc0/fc1/fc2/fc_out weights in bf16, f32 accumulation and
// f32 biases, each ReLU output rounded to bf16, fc_out summed in f32; the
// plain version (lattice_sweep_plain with compute_dtype=torch.bfloat16)
// applies exactly those rounding points.  On the H100 the f32 kernel is
// bound by f32 FMA: fc0's 2.1 TFLOP over the lattice take at least 32 ms at
// 67 TFLOP/s, against 2.2 ms at the tensor cores' 989 TFLOP/s in bf16.  Here
// fc0, fc1 and fc2 run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate), so what is left is the gather: 8 corners x 2583 features a
// point, 8 f32 FMAs of interpolation each, at the f32 rate.  A block owns kM =
// 64 lattice points and all H0 fc0 outputs; warp w owns 32 fc0 columns
// (64 f32 accumulators a lane) for all 64 points.  fc0's K runs over (d,
// level) groups in a fixed order (the plan's: each one-channel level's 7
// copies packed into one k16 chunk, then d-major the levels of C % 16 == 0,
// C / 16 chunks each), so a point's logits do not depend on the slab it
// came in.  Per group the tile's 64 x 8 corners (32-bit offset, f32 weight)
// are computed once into shared memory, then each item -- a point's 8
// channels -- reads one 16-byte run of each corner from the channels-last
// bf16 level, sums in f32, rounds, and stores 16 bytes into the A chunk
// (64 x C bf16, rows padded to 136 for conflict-free ldmatrix).  A chunks and
// corner tables are double-buffered, so one barrier a group suffices and a
// warp that finishes its MMAs starts the next group's gather while others
// still multiply (how far the two phases overlap at the 2 blocks an SM that
// 128 registers allow is not measured).  B (the weights) arrives in mma fragment order, laid out
// once by the plan, through a 3-deep cp.async ring per warp: a warp's
// columns are its own, so shared memory buys no reuse across warps, and
// each lane copies and reads back only its own 16 bytes, needing no barrier.
// mma.sync rather than wgmma: a 64-row warpgroup tile would need the 64 x K
// A chunk in wgmma's swizzled shared-memory layout and descriptors, written
// by a gather whose rows are points, which this first tensor-core version
// keeps simple; the MMAs are not what bounds it (a point's 2583 bf16 MACs of
// fc0 cost less than its 8 x 2583 gathered values).  The tail is
// mma_bf16.cuh's decoder_tail, one copy with K3 bf16: bias + ReLU + bf16
// into shared memory over the A buffers (64 x (H0 + 8)), fc1 and fc2 as
// MMAs with their weights streamed the same way, fc_out as a 256-term f32
// dot per point, the ragged tail's stores masked.  Levels need C = 1 or
// C % 16 == 0 with C <= 128 (every IF-Net configuration); the wrapper raises
// otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kTile = 32;    // lattice points per block
constexpr int kMeta = 8;     // per level: C, g0, g1, g2, tap0, tap1, tap2, cg
constexpr int kHidden = 256; // fc1 / fc2 width

// One hidden layer on the tile: reads x[k][t] (k < K) from smem, writes
// relu(W x + b) for its NO outputs back into smem[o*NT + tid][t].
// wt is the transposed weight (K, NO*NT).
template <int NT, int NO, int K>
__device__ __forceinline__ void dense_relu(float* smem, const float* __restrict__ wt,
                                           const float* __restrict__ bias,
                                           float (&acc)[2][kTile], int tid) {
#pragma unroll
  for (int o = 0; o < NO; ++o)
#pragma unroll
    for (int t = 0; t < kTile; ++t) acc[o][t] = 0.f;
  const float4* x4 = reinterpret_cast<const float4*>(smem);
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float w[NO];
#pragma unroll
    for (int o = 0; o < NO; ++o) w[o] = __ldg(wt + (int64_t)k * (NO * NT) + o * NT + tid);
#pragma unroll
    for (int q = 0; q < kTile / 4; ++q) {
      const float4 v = x4[k * (kTile / 4) + q];
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        acc[o][4 * q + 0] += w[o] * v.x;
        acc[o][4 * q + 1] += w[o] * v.y;
        acc[o][4 * q + 2] += w[o] * v.z;
        acc[o][4 * q + 3] += w[o] * v.w;
      }
    }
  }
  __syncthreads();  // every read of x is done before it is overwritten
#pragma unroll
  for (int o = 0; o < NO; ++o) {
    const int k = o * NT + tid;
    const float bb = __ldg(bias + k);
#pragma unroll
    for (int t = 0; t < kTile; ++t) smem[k * kTile + t] = fmaxf(acc[o][t] + bb, 0.f);
  }
  __syncthreads();
}

template <int H0>
__global__ void __launch_bounds__(H0 / 2)
lattice_sweep_kernel(const float* const* __restrict__ vols, const int* __restrict__ meta,
                     int n_levels, const int* __restrict__ tap_idx,
                     const float* __restrict__ tap_w, const float* __restrict__ w0t,
                     const float* __restrict__ b0, const float* __restrict__ w1t,
                     const float* __restrict__ b1, const float* __restrict__ w2t,
                     const float* __restrict__ b2, const float* __restrict__ w3,
                     const float* __restrict__ b3, float* __restrict__ out, int rows,
                     int row_offset, int r0, int r1, int r2, int sum_c) {
  constexpr int NT = H0 / 2;         // threads; each owns fc0 outputs tid, tid+NT
  constexpr int OH = kHidden / NT;   // hidden outputs per thread
  extern __shared__ float4 smem4[];  // [max(C_l, H0)][kTile]
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int s_a[kTile], s_x[kTile], s_y[kTile];

  const int n = rows * r1 * r2;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  if (tid < kTile) {
    const int p = min(p0 + tid, n - 1);  // the ragged tail repeats a point; its store is masked
    s_y[tid] = p % r2;
    const int q = p / r2;
    s_x[tid] = q % r1;
    s_a[tid] = row_offset + q / r1;  // the lattice row
  }
  float acc[2][kTile];
#pragma unroll
  for (int o = 0; o < 2; ++o)
#pragma unroll
    for (int t = 0; t < kTile; ++t) acc[o][t] = 0.f;
  __syncthreads();

  for (int d = 0; d < 7; ++d) {
    // tap variant (0 center, 1 minus, 2 plus) of each axis for displacement d
    const int v0 = d == 1 ? 1 : (d == 2 ? 2 : 0);
    const int v1 = d == 3 ? 1 : (d == 4 ? 2 : 0);
    const int v2 = d == 5 ? 1 : (d == 6 ? 2 : 0);
    for (int l = 0; l < n_levels; ++l) {
      const int* m = meta + l * kMeta;
      const int C = m[0], g1 = m[2], g2 = m[3];
      const int64_t G = (int64_t)m[1] * g1 * g2;
      const float* vol = vols[l] + (int64_t)b * C * G;
      const int e0 = m[4] + v0 * r0, e1 = m[5] + v1 * r1, e2 = m[6] + v2 * r2;

      for (int i = tid; i < C * kTile; i += NT) {
        const int c = i / kTile, t = i % kTile;
        // rows past the lattice (the padded last slab) weigh 0
        const bool row_ok = s_a[t] < r0;
        const int ea = 2 * (e0 + (row_ok ? s_a[t] : 0));
        const int ex = 2 * (e1 + s_x[t]), ey = 2 * (e2 + s_y[t]);
        const float* vc = vol + c * G;
        const int k0 = __ldg(tap_idx + ey), k1 = __ldg(tap_idx + ey + 1);
        const float wk0 = __ldg(tap_w + ey), wk1 = __ldg(tap_w + ey + 1);
        float s = 0.f;
#pragma unroll
        for (int ca = 0; ca < 2; ++ca) {
          const int ia = __ldg(tap_idx + ea + ca);
          const float wa = row_ok ? __ldg(tap_w + ea + ca) : 0.f;
#pragma unroll
          for (int cb = 0; cb < 2; ++cb) {
            const int ib = __ldg(tap_idx + ex + cb);
            const float wab = wa * __ldg(tap_w + ex + cb);
            const float* row = vc + ((int64_t)ia * g1 + ib) * g2;
            s += wab * (wk0 * __ldg(row + k0) + wk1 * __ldg(row + k1));
          }
        }
        smem[i] = s;  // i == c * kTile + t
      }
      __syncthreads();

      const float* wcol = w0t + (int64_t)(d * sum_c + m[7]) * H0 + tid;
#pragma unroll 2
      for (int c = 0; c < C; ++c) {
        const float wa = __ldg(wcol + (int64_t)c * H0);
        const float wb = __ldg(wcol + (int64_t)c * H0 + NT);
#pragma unroll
        for (int q = 0; q < kTile / 4; ++q) {
          const float4 v = smem4[c * (kTile / 4) + q];
          acc[0][4 * q + 0] += wa * v.x;
          acc[0][4 * q + 1] += wa * v.y;
          acc[0][4 * q + 2] += wa * v.z;
          acc[0][4 * q + 3] += wa * v.w;
          acc[1][4 * q + 0] += wb * v.x;
          acc[1][4 * q + 1] += wb * v.y;
          acc[1][4 * q + 2] += wb * v.z;
          acc[1][4 * q + 3] += wb * v.w;
        }
      }
      __syncthreads();
    }
  }

  // fc0 bias + ReLU -> smem[k][t]
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    const int k = o * NT + tid;
    const float bb = __ldg(b0 + k);
#pragma unroll
    for (int t = 0; t < kTile; ++t) smem[k * kTile + t] = fmaxf(acc[o][t] + bb, 0.f);
  }
  __syncthreads();
  dense_relu<NT, OH, H0>(smem, w1t, b1, acc, tid);
  dense_relu<NT, OH, kHidden>(smem, w2t, b2, acc, tid);

  if (tid < kTile && p0 + tid < n) {
    float s = __ldg(b3);
    for (int k = 0; k < kHidden; ++k) s += __ldg(w3 + k) * smem[k * kTile + tid];
    out[(int64_t)b * n + p0 + tid] = s;
  }
}

template <int H0>
cudaError_t launch(const float* const* vols, const int* meta, int n_levels, const int* tap_idx,
                   const float* tap_w, const float* w0t, const float* b0, const float* w1t,
                   const float* b1, const float* w2t, const float* b2, const float* w3,
                   const float* b3, float* out, int batch, int rows, int row_offset, int r0,
                   int r1, int r2, int sum_c, int max_c, cudaStream_t stream) {
  const int n = rows * r1 * r2;
  const size_t smem = (size_t)(max_c > H0 ? max_c : H0) * kTile * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(lattice_sweep_kernel<H0>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n + kTile - 1) / kTile), (unsigned)batch);
  lattice_sweep_kernel<H0><<<grid, H0 / 2, smem, stream>>>(
      vols, meta, n_levels, tap_idx, tap_w, w0t, b0, w1t, b1, w2t, b2, w3, b3, out, rows,
      row_offset, r0, r1, r2, sum_c);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sv3d_lattice_sweep(const void* vols, const void* meta, int n_levels,
                                  const void* tap_idx, const void* tap_w, const void* w0t,
                                  const void* b0, const void* w1t, const void* b1,
                                  const void* w2t, const void* b2, const void* w3,
                                  const void* b3, void* out, int batch, int rows,
                                  int row_offset, int r0, int r1, int r2, int sum_c, int h0,
                                  int max_c, void* stream) {
  auto* v = (const float* const*)vols;
  auto* mt = (const int*)meta;
  auto* ti = (const int*)tap_idx;
  auto* tw = (const float*)tap_w;
  auto* o = (float*)out;
  auto s = (cudaStream_t)stream;
  if (h0 == 256)
    return (int)launch<256>(v, mt, n_levels, ti, tw, (const float*)w0t, (const float*)b0,
                            (const float*)w1t, (const float*)b1, (const float*)w2t,
                            (const float*)b2, (const float*)w3, (const float*)b3, o, batch,
                            rows, row_offset, r0, r1, r2, sum_c, max_c, s);
  if (h0 == 512)
    return (int)launch<512>(v, mt, n_levels, ti, tw, (const float*)w0t, (const float*)b0,
                            (const float*)w1t, (const float*)b1, (const float*)w2t,
                            (const float*)b2, (const float*)w3, (const float*)b3, o, batch,
                            rows, row_offset, r0, r1, r2, sum_c, max_c, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K2 bf16 (see the note at the top).

namespace {

// Corner j (bits: axis 0, 1, 2) of lattice point (row, x, y) displaced by
// copy d on a level: its element offset voxel * C in the channels-last
// level and its trilinear weight wa * wb * wc from the plan's 2-tap tables
// (meta m: C, g0, g1, g2 and the level's table offsets); a row past the
// lattice (the padded last slab) weighs 0.
__device__ __forceinline__ void lattice_corner(const int* m, int d, int row, int x, int y, int j,
                                               int r0, int r1, int r2,
                                               const int* __restrict__ tap_idx,
                                               const float* __restrict__ tap_w, int& off,
                                               float& w) {
  const int v0 = d == 1 ? 1 : (d == 2 ? 2 : 0);
  const int v1 = d == 3 ? 1 : (d == 4 ? 2 : 0);
  const int v2 = d == 5 ? 1 : (d == 6 ? 2 : 0);
  const bool row_ok = row < r0;
  const int ea = 2 * (m[4] + v0 * r0 + (row_ok ? row : 0)) + (j >> 2);
  const int ex = 2 * (m[5] + v1 * r1 + x) + ((j >> 1) & 1);
  const int ey = 2 * (m[6] + v2 * r2 + y) + (j & 1);
  const float wa = row_ok ? __ldg(tap_w + ea) : 0.f;
  off = ((__ldg(tap_idx + ea) * m[2] + __ldg(tap_idx + ex)) * m[3] + __ldg(tap_idx + ey)) * m[0];
  w = wa * __ldg(tap_w + ex) * __ldg(tap_w + ey);
}

struct Tile {
  const int* row;  // per point: lattice row, axis-1 and axis-2 index (shared memory)
  const int* x;
  const int* y;
  int r0, r1, r2;
  const int* tap_idx;
  const float* tap_w;
};

// the 8 corners of copy d on level m for every point of the tile, once,
// into off[p * 8 + j] and w[p * 8 + j]
template <int NT>
__device__ __forceinline__ void tile_corners(const Tile& T, const int* m, int d, int* off,
                                             float* w) {
  for (int i = threadIdx.x; i < kM * 8; i += NT) {
    const int p = i >> 3;
    lattice_corner(m, d, T.row[p], T.x[p], T.y[p], i & 7, T.r0, T.r1, T.r2, T.tap_idx, T.tap_w,
                   off[i], w[i]);
  }
}

// The packed chunk of a one-channel level: a[p][d] for the 7 copies, zeros
// in columns 7..15; each item computes its own 8 corners.
template <int NT>
__device__ __forceinline__ void gather_packed(const Tile& T, const bf16* __restrict__ vol,
                                              const int* m, bf16* a) {
  for (int i = threadIdx.x; i < kM * 16; i += NT) {
    const int p = i >> 4, d = i & 15;
    float acc = 0.f;
    if (d < 7) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int off;
        float w;
        lattice_corner(m, d, T.row[p], T.x[p], T.y[p], j, T.r0, T.r1, T.r2, T.tap_idx, T.tap_w,
                       off, w);
        acc = fmaf(w, __bfloat162float(vol[off]), acc);
      }
    }
    a[p * kAStride + d] = __float2bfloat16_rn(acc);
  }
}

// NW warps, H0 = 32 NW fc0 outputs: warp w owns fc0 columns [32 w, 32 w + 32)
// and 256 / NW columns of fc1 and fc2, for all kM points of the tile.
template <int NW>
__global__ void __launch_bounds__(NW * 32, NW == 8 ? 2 : 1)
lattice_sweep_bf16_kernel(const bf16* const* __restrict__ vols, const int* __restrict__ meta,
                          const int4* __restrict__ groups, int n_groups,
                          const int* __restrict__ tap_idx, const float* __restrict__ tap_w,
                          const uint4* __restrict__ w0f, int k0_chunks,
                          const float* __restrict__ b0, const uint4* __restrict__ w1f,
                          const float* __restrict__ b1, const uint4* __restrict__ w2f,
                          const float* __restrict__ b2, const float* __restrict__ w3,
                          const float* __restrict__ b3, float* __restrict__ out, int rows,
                          int row_offset, int r0, int r1, int r2) {
  constexpr int NT = NW * 32;
  constexpr int H0 = NW * 32;
  constexpr int kABytes = 2 * kM * kAStride * 2;
  constexpr int kHBytes = kM * (H0 + 8) * 2;  // decoder_tail's hidden tile
  constexpr int kUBytes = kABytes > kHBytes ? kABytes : kHBytes;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* abuf = reinterpret_cast<bf16*>(smem);  // A[2][kM][kAStride]; after fc0 the hidden [kM][HS]
  int* s_off = reinterpret_cast<int*>(smem + kUBytes);        // [2][kM * 8]
  float* s_w = reinterpret_cast<float*>(s_off + 2 * kM * 8);  // [2][kM * 8]
  uint4* ring = reinterpret_cast<uint4*>(s_w + 2 * kM * 8);   // [NW][kStages][2][32]
  __shared__ int s_row[kM], s_x[kM], s_y[kM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = rows * r1 * r2;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kM;
  if (tid < kM) {
    const int p = min(p0 + tid, n - 1);  // the ragged tail repeats a point; its store is masked
    s_y[tid] = p % r2;
    const int q = p / r2;
    s_x[tid] = q % r1;
    s_row[tid] = row_offset + q / r1;
  }
  const Tile T{s_row, s_x, s_y, r0, r1, r2, tap_idx, tap_w};
  uint4* my_ring = ring + warp * kStages * 2 * 32;
  BStream<2> bs0{w0f + warp * 2 * 32, (H0 / 16) * 32, k0_chunks, my_ring, lane, 0};
  bs0.start();
  __syncthreads();

  // groups: (level, d or -1 for a packed one-channel level, k16 chunks, -);
  // corners of group g live in buffer g % 2, its A chunk in A buffer g % 2
  auto corners_of = [&](int g) {
    if (g >= n_groups) return;
    const int4 gr = __ldg(groups + g);
    if (gr.y >= 0) {
      tile_corners<NT>(T, meta + gr.x * 8, gr.y, s_off + (g & 1) * kM * 8,
                       s_w + (g & 1) * kM * 8);
    }
  };
  auto gather = [&](int g) {
    const int4 gr = __ldg(groups + g);
    const int* m = meta + gr.x * 8;
    const bf16* vol = vols[gr.x] + (int64_t)b * m[1] * m[2] * m[3] * m[0];
    bf16* a = abuf + (g & 1) * kM * kAStride;
    if (gr.y < 0) {
      gather_packed<NT>(T, vol, m, a);
    } else {
      gather_group<NT>(vol, m[0], s_off + (g & 1) * kM * 8, s_w + (g & 1) * kM * 8, a);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  corners_of(0);
  corners_of(1);
  __syncthreads();
  gather(0);
  __syncthreads();
  int k = 0;  // fc0 chunk, in the plan's fixed order
  for (int g = 0; g < n_groups; ++g) {
    const int chunks = __ldg(groups + g).z;
    const bf16* a = abuf + (g & 1) * kM * kAStride;
    for (int q = 0; q < chunks; ++q, ++k) {
      uint32_t bf[4][2];
      bs0.get(k, bf);
      mma_chunk<4>(acc, a, kAStride, q * 16, bf, lane);
    }
    // warps that finish their MMAs start the next gather while others still
    // multiply; one barrier a group
    if (g + 1 < n_groups) gather(g + 1);
    corners_of(g + 2);
    __syncthreads();
  }

  // the decoder tail over the A buffers (mma_bf16.cuh, shared with K3 bf16)
  decoder_tail<NW, 4>(acc, abuf, b0, w1f, b1, w2f, b2, w3, b3, my_ring,
                      out + (int64_t)b * n + p0, n - p0);
}

template <int NW>
cudaError_t launch_bf16(const void* vols, const void* meta, const void* groups, int n_groups,
                        const void* tap_idx, const void* tap_w, const void* w0f, int k0_chunks,
                        const void* b0, const void* w1f, const void* b1, const void* w2f,
                        const void* b2, const void* w3, const void* b3, void* out, int batch,
                        int rows, int row_offset, int r0, int r1, int r2, cudaStream_t stream) {
  constexpr int H0 = NW * 32;
  constexpr int kABytes = 2 * kM * kAStride * 2;
  constexpr int kHBytes = kM * (H0 + 8) * 2;
  const size_t smem = (size_t)(kABytes > kHBytes ? kABytes : kHBytes) + 2 * kM * 8 * 8 +
                      (size_t)NW * kStages * 2 * 32 * 16;
  cudaError_t err = cudaFuncSetAttribute(lattice_sweep_bf16_kernel<NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n = rows * r1 * r2;
  const dim3 grid((unsigned)((n + kM - 1) / kM), (unsigned)batch);
  lattice_sweep_bf16_kernel<NW><<<grid, NW * 32, smem, stream>>>(
      (const bf16* const*)vols, (const int*)meta, (const int4*)groups, n_groups,
      (const int*)tap_idx, (const float*)tap_w, (const uint4*)w0f, k0_chunks, (const float*)b0,
      (const uint4*)w1f, (const float*)b1, (const uint4*)w2f, (const float*)b2,
      (const float*)w3, (const float*)b3, (float*)out, rows, row_offset, r0, r1, r2);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sv3d_lattice_sweep_bf16(const void* vols, const void* meta, const void* groups,
                                       int n_groups, const void* tap_idx, const void* tap_w,
                                       const void* w0f, int k0_chunks, const void* b0,
                                       const void* w1f, const void* b1, const void* w2f,
                                       const void* b2, const void* w3, const void* b3,
                                       void* out, int batch, int rows, int row_offset, int r0,
                                       int r1, int r2, int h0, void* stream) {
  if (rows * r1 * r2 <= 0 || batch <= 0) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (h0 == 256)
    return (int)launch_bf16<8>(vols, meta, groups, n_groups, tap_idx, tap_w, w0f, k0_chunks, b0,
                               w1f, b1, w2f, b2, w3, b3, out, batch, rows, row_offset, r0, r1,
                               r2, s);
  if (h0 == 512)
    return (int)launch_bf16<16>(vols, meta, groups, n_groups, tap_idx, tap_w, w0f, k0_chunks, b0,
                                w1f, b1, w2f, b2, w3, b3, out, batch, rows, row_offset, r0, r1,
                                r2, s);
  return (int)cudaErrorInvalidValue;
}
