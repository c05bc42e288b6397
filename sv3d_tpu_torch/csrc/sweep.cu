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
// f32 design (the parity route, f32 FMA on the CUDA cores: no tensor cores,
// no TF32).  Bound on the H100: f32 FMA issue.  fc0 is 2 * 2583 * 256 flop a
// point, about 2.1 Tflop for the 1.62M-point full-scale lattice (fc1 + fc2
// add 0.4), against 67 Tflop/s of f32 FMA.  The block tile is fma_f32.cuh's
// FmaTile, as K3 f32's: kM consecutive lattice points (flattened over (row,
// r1, r2), so no tile is wasted at a row's end) x all H0 fc0 columns, each
// thread an 8 x 8 register tile, 16 FMAs a shared-memory load; kM = 96 at
// H0 256 (384 threads, 128 KB of shared memory, one block an SM: 16,866
// blocks for the full lattice, 128 waves of 132) and 48 at H0 512.  fc0's
// K runs in the plan's fixed order (fc0_chunk_order, K2 bf16's): the 7
// copies of each one-channel level packed into one 16-row chunk, then
// d-major each (d, level) group of C % 16 == 0 channels, C / 16 chunks; fc0
// comes as row-major (K, H0) f32 rows in that order, zeros where the order
// puts none, so a point's sums have one order whatever slab it came in, and
// a chunk of the core (16 rows at H0 256, 8 at 512) never crosses a group.
// The A operand is gathered (LatticeA, the pattern of K6 f32's GatherA):
// the plan stages the pyramid channels-last once a sweep; per group the
// tile's 8 corners a point (32-bit element offset, f32 weight, from the
// plan's 2-tap tables) are computed once into shared memory, double
// buffered; an item is 4 channels of one point, whose 8 corners' float4 are
// copied with cp.async when the chunk before is multiplied and summed, j =
// 0..7, into the A chunk after they land; the packed one-channel chunk is
// gathered with scalar loads.  fc0's weights stream through the core's
// two-stage cp.async ring, read once per kM points from L2 (2.65 MB at
// net_res 128).  Then fma_decoder_tail, one copy with K3 f32: bias + ReLU
// into a [HP][kM] activation buffer over fc0's shared memory, fc1 and fc2
// by the same core on it, fc_out an f32 dot a point, the ragged tail's
// stores masked.  Each output sums its K terms in order from 0; it agrees
// with the plain f32 torch version to f32 summation order.  Levels need C =
// 1 or C % 16 == 0 with C <= 128 (every IF-Net configuration); the wrapper
// raises otherwise.
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

#include "fma_f32.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kMeta = 8;     // per level: C, g0, g1, g2, tap0, tap1, tap2, cg
constexpr int kHidden = 256; // fc1 / fc2 width

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

// ---------------------------------------------------------------------------
// K2 f32 (see the note at the top).

// K2 f32's A operand: fc0's K rows in the plan's order for the tile's kM
// points, chunk c (rows [kK c, kK c + kK), inside one 16-row chunk of the
// plan's table and so inside one (d, level) group) in stage c % 2 of a
// [2][kK][kM] ring.  chunks[k16]: (level, d or -1, first channel, group) of
// each 16 rows.  A group's corners lie in shared memory, off[(g % 2) * 8 *
// kM + j * kM + p] (element offset into the channels-last level) and w
// likewise, computed once a group; the next group's in the finish() of a
// group's first chunk, so that they are there before the barrier after
// which contract() issues that group's first copies, and written into the
// buffer of the group before, which no thread reads any more.  An item is 4
// channels of one point, a point's kK / 4 items on adjacent lanes (one
// 16-byte piece of each corner's run each): issue() copies its 8 corners'
// float4 into the thread's own slots of the staging buffer by cp.async,
// finish() sums them, j = 0..7, into 4 rows of the A chunk.  A packed
// one-channel chunk (row d < 7 the level at copy d, rows 7..15 zeros) is
// gathered in finish() by scalar loads, each item computing its own 8
// corners.
template <int kM, int kK, int NT>
struct LatticeA {
  static constexpr int kQ = kK / 4;       // a point's items a chunk
  static constexpr int kItems = kQ * kM;  // items a chunk
  static constexpr int kPer = (kItems + NT - 1) / NT;
  float* ring;
  float4* stage;  // [8][kItems]: corner j of item i at j * kItems + i
  int* off;       // [2][8][kM]
  float* w;       // [2][8][kM]
  const Tile& T;
  const float* const* vols;  // the channels-last levels
  const int* meta;
  const int4* __restrict__ chunks;
  int k16;  // 16-row chunks of K
  int b;    // the batch element

  __device__ __forceinline__ const float* level(int l) const {
    const int* m = meta + l * kMeta;
    return vols[l] + (int64_t)b * m[0] * m[1] * m[2] * m[3];
  }
  // the corners of copy d of level l for the tile's points, into buffer buf
  __device__ __forceinline__ void corners(int buf, int l, int d) {
#pragma unroll
    for (int u = 0; u < (8 * kM + NT - 1) / NT; ++u) {
      const int i = threadIdx.x + u * NT;
      if ((8 * kM) % NT != 0 && i >= 8 * kM) break;
      const int j = i / kM, p = i - j * kM;
      lattice_corner(meta + l * kMeta, d, T.row[p], T.x[p], T.y[p], j, T.r0, T.r1, T.r2,
                     T.tap_idx, T.tap_w, off[buf * 8 * kM + i], w[buf * 8 * kM + i]);
    }
  }
  // group 0's corners, before contract() (a barrier must follow)
  __device__ __forceinline__ void start() {
    const int4 t = __ldg(chunks);
    if (t.y >= 0) corners(t.w & 1, t.x, t.y);
  }

  __device__ __forceinline__ void issue(int c) {
    const int row = c * kK;
    const int4 t = __ldg(chunks + (row >> 4));
    if (t.y < 0) return;
    const float* vol = level(t.x) + t.z + (row & 15);
    const int* o = off + (t.w & 1) * 8 * kM;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = threadIdx.x + r * NT;
      if (kItems % NT != 0 && i >= kItems) break;
      const int p = i / kQ;
      const float* src = vol + 4 * (i - p * kQ);
#pragma unroll
      for (int j = 0; j < 8; ++j) cp_async16(stage + j * kItems + i, src + o[j * kM + p]);
    }
  }
  __device__ __forceinline__ void finish(int c) {
    const int row = c * kK;
    const int4 t = __ldg(chunks + (row >> 4));
    float* a = ring + (c & 1) * kK * kM;
    if (t.y < 0) {
      const int* m = meta + t.x * kMeta;
      const float* vol = level(t.x);
#pragma unroll
      for (int u = 0; u < (kK * kM + NT - 1) / NT; ++u) {
        const int i = threadIdx.x + u * NT;
        if ((kK * kM) % NT != 0 && i >= kK * kM) break;
        const int r = i / kM, p = i - r * kM;
        const int d = (row & 15) + r;
        float s = 0.f;
        if (d < 7) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            int o;
            float wj;
            lattice_corner(m, d, T.row[p], T.x[p], T.y[p], j, T.r0, T.r1, T.r2, T.tap_idx,
                           T.tap_w, o, wj);
            s = fmaf(wj, __ldg(vol + o), s);
          }
        }
        a[i] = s;  // i == r * kM + p
      }
    } else {
      const float* wt = w + (t.w & 1) * 8 * kM;
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int i = threadIdx.x + r * NT;
        if (kItems % NT != 0 && i >= kItems) break;
        const int p = i / kQ, q = i - p * kQ;
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 x = stage[j * kItems + i];
          const float wj = wt[j * kM + p];
          s.x = fmaf(wj, x.x, s.x);
          s.y = fmaf(wj, x.y, s.y);
          s.z = fmaf(wj, x.z, s.z);
          s.w = fmaf(wj, x.w, s.w);
        }
        a[(4 * q) * kM + p] = s.x;
        a[(4 * q + 1) * kM + p] = s.y;
        a[(4 * q + 2) * kM + p] = s.z;
        a[(4 * q + 3) * kM + p] = s.w;
      }
    }
    if ((row & 15) == 0 && t.z == 0) {  // a group's first chunk: the next group's corners
      const int next = (row >> 4) + (t.y < 0 ? 1 : meta[t.x * kMeta] / 16);
      if (next < k16) {
        const int4 u = __ldg(chunks + next);
        if (u.y >= 0) corners(u.w & 1, u.x, u.y);
      }
    }
  }
  __device__ __forceinline__ const float* chunk(int c) const { return ring + (c & 1) * kK * kM; }
};

// K2 f32's tile and shared memory: fc0's staging, A ring and corner tables,
// then (over them) the decoder's [HP][kM] activations, then the B ring
template <int kM_, int HP>
struct SweepF32 {
  using Tile = FmaTile<kM_, HP>;
  static constexpr int kM = kM_, kK = Tile::kK, NT = Tile::NT;
  using A = LatticeA<kM, kK, NT>;
  static constexpr int kStageBytes = 8 * A::kItems * 16;
  static constexpr int kRingBytes = 2 * kK * kM * 4;
  static constexpr int kCornerBytes = 2 * 8 * kM * 4;  // off, and w
  static constexpr int kFc0Bytes = kStageBytes + kRingBytes + 2 * kCornerBytes;
  static constexpr int kActBytes = HP * kM * 4;
  static constexpr int kUnion = kFc0Bytes > kActBytes ? kFc0Bytes : kActBytes;
  static constexpr int kBytes = kUnion + Tile::kBBytes;
  // the blocks an SM holds by shared memory (227 KB, 1 KB reserved a
  // block, the point indices): the register budget __launch_bounds__ asks for
  static constexpr int kBlocks = 232448 / (kBytes + 1024 + 3 * kM * 4);
  static_assert(kBlocks >= 1 && kK % 4 == 0 && 16 % kK == 0, "K2 f32 tile");
};

// K2 f32: the block's tile is kM consecutive points of the slab's lattice
// points (row, r1, r2) flattened, of batch element blockIdx.y, and all H0
// fc0 columns (HP >= H0, padded columns zero).
template <int kM, int HP>
__global__ void __launch_bounds__(SweepF32<kM, HP>::NT, SweepF32<kM, HP>::kBlocks)
lattice_sweep_kernel(const float* const* __restrict__ vols, const int* __restrict__ meta,
                     const int4* __restrict__ chunks, int k16, const int* __restrict__ tap_idx,
                     const float* __restrict__ tap_w, const float* __restrict__ w0k,
                     const float* __restrict__ b0, const float* __restrict__ w1t,
                     const float* __restrict__ b1, const float* __restrict__ w2t,
                     const float* __restrict__ b2, const float* __restrict__ w3,
                     const float* __restrict__ b3, float* __restrict__ out, int rows,
                     int row_offset, int r0, int r1, int r2, int h0) {
  using S = SweepF32<kM, HP>;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* stage = reinterpret_cast<float4*>(smem);
  float* ring = reinterpret_cast<float*>(smem + S::kStageBytes);
  int* s_off = reinterpret_cast<int*>(smem + S::kStageBytes + S::kRingBytes);
  float* s_w = reinterpret_cast<float*>(smem + S::kStageBytes + S::kRingBytes + S::kCornerBytes);
  float* act = reinterpret_cast<float*>(smem);
  float* bring = reinterpret_cast<float*>(smem + S::kUnion);
  __shared__ int s_row[kM], s_x[kM], s_y[kM];

  const int n = rows * r1 * r2;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kM;
  for (int i = threadIdx.x; i < kM; i += S::NT) {
    const int p = min(p0 + i, n - 1);  // the ragged tail repeats a point; its store is masked
    s_y[i] = p % r2;
    const int q = p / r2;
    s_x[i] = q % r1;
    s_row[i] = row_offset + q / r1;
  }
  __syncthreads();
  const Tile T{s_row, s_x, s_y, r0, r1, r2, tap_idx, tap_w};
  typename S::A src{ring, stage, s_off, s_w, T, vols, meta, chunks, k16, b};
  src.start();
  __syncthreads();

  typename S::Tile t;
  t.init();
  contract(t, src, w0k, 16 * k16, h0, 0, bring);
  // the decoder tail over fc0's shared memory (fma_f32.cuh, shared with K3 f32)
  fma_decoder_tail(t, act, bring, b0, w1t, b1, w2t, b2, w3, b3, out + (int64_t)b * n + p0,
                   n - p0, h0, kHidden, kHidden);
}

template <int kM, int HP>
cudaError_t launch_f32(const void* vols, const void* meta, const void* chunks, int k16,
                       const void* tap_idx, const void* tap_w, const void* w0k, const void* b0,
                       const void* w1t, const void* b1, const void* w2t, const void* b2,
                       const void* w3, const void* b3, void* out, int batch, int rows,
                       int row_offset, int r0, int r1, int r2, int h0, cudaStream_t stream) {
  using S = SweepF32<kM, HP>;
  cudaError_t err = cudaFuncSetAttribute(lattice_sweep_kernel<kM, HP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (err != cudaSuccess) return err;
  const int n = rows * r1 * r2;
  const dim3 grid((unsigned)((n + kM - 1) / kM), (unsigned)batch);
  lattice_sweep_kernel<kM, HP><<<grid, S::NT, S::kBytes, stream>>>(
      (const float* const*)vols, (const int*)meta, (const int4*)chunks, k16,
      (const int*)tap_idx, (const float*)tap_w, (const float*)w0k, (const float*)b0,
      (const float*)w1t, (const float*)b1, (const float*)w2t, (const float*)b2,
      (const float*)w3, (const float*)b3, (float*)out, rows, row_offset, r0, r1, r2, h0);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sv3d_lattice_sweep(const void* vols, const void* meta, const void* chunks,
                                  int k16, const void* tap_idx, const void* tap_w,
                                  const void* w0k, const void* b0, const void* w1t,
                                  const void* b1, const void* w2t, const void* b2,
                                  const void* w3, const void* b3, void* out, int batch, int rows,
                                  int row_offset, int r0, int r1, int r2, int h0, void* stream) {
  if (rows * r1 * r2 <= 0 || batch <= 0) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (h0 == 256)
    return (int)launch_f32<96, 256>(vols, meta, chunks, k16, tap_idx, tap_w, w0k, b0, w1t, b1,
                                    w2t, b2, w3, b3, out, batch, rows, row_offset, r0, r1, r2,
                                    h0, s);
  if (h0 == 512)
    return (int)launch_f32<48, 512>(vols, meta, chunks, k16, tap_idx, tap_w, w0k, b0, w1t, b1,
                                    w2t, b2, w3, b3, out, batch, rows, row_offset, r0, r1, r2,
                                    h0, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K2 bf16 (see the note at the top).

namespace {

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
