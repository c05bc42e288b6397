// Fused IF-Net point query for Hopper: one pyramid level's trilinear features
// at the 7 displaced copies of arbitrary query points, both halves of its
// backward, and the inference-only variants.
//
//   K4 level_features_kernel<f32, f32>
//                                    replaces sv3d_tpu/ops/pallas/point_query.py::level_features
//   K5 level_features_kernel<f32 or bf16, bf16>
//                                    replaces sv3d_tpu/ops/pallas/point_query.py::level_features_banded
//   K6 level_fc0_kernel (f32), level_fc0_bf16_kernel (bf16)
//                                    replace sv3d_tpu/ops/pallas/point_query.py::level_fc0_banded
//   K7 level_grad_points_kernel      replaces sv3d_tpu/ops/pallas/point_query_bwd.py::level_grad_points
//   K8 level_grad_vol_kernel         replaces sv3d_tpu/ops/pallas/point_query_bwd.py::level_grad_vol
//
// Contract (the plain versions in sv3d_tpu_torch/ops/point_query.py): the
// level is the port's flat (B, C, G0*G1*G2) f32; coordinates are three
// (B, N) f32 arrays in [-1, 1]; copy d of point n samples at p + s_d * disp
// on one axis (order center, -0, +0, -1, +1, -2, +2); features are
// (B, N, 7*C), index d*C + c; out-of-range corners weigh 0 (torch
// grid_sample zero padding); both align_corners conventions.  The coordinate
// math uses the plain sampler's f32 operation order with no FMA contraction
// (__fadd_rn / __fmul_rn), so both pick the same corners.
//
// The TPU kernels exist because a TPU has no fast gather: they bucket the
// queries by axis-0 slab, DMA a row window of the level into VMEM and turn
// the interpolation into banded MXU products, in bf16.  None of that is
// ported.  Here every (point, channel) reads its 8 corners directly and
// interpolates in f32: K4, K7, K8 and K6 f32 are as exact as the gather path;
// K5 and K6 bf16 round where the JAX kernels compute in bf16.
//
// K4 and K5 read the level channels-last, (B, G, C) -- the JAX kernel's own
// layout, (B, g0, g1, g2, C).  Their wrappers take a level that already lies
// channels-last as it is (C = 1 always does) and otherwise stage the copy
// with torch's transpose copy (ops/cuda/point_query.py::stage_channels_last);
// evaluate_points stages its pyramid once a call.  What bounds them is
// the sector traffic of the gathers: the finest level (C = 16 at full dims,
// 104 MB a sample) is twice the 50 MB L2, so its corners come from device
// memory, while the coarser levels stay in L2.  Channel-major, each 4-byte
// read of vol[c, corner] was its own 32-byte sector (1/8 used); channels-last,
// the C channels of a corner are one run of 4C bytes, and the corners
// (a, b, e) and (a, b, e + 1) two adjacent runs, so every sector fetched is
// used whole.  A group of L lanes owns one point: each lane takes 4
// consecutive channels as one float4 when C % 4 == 0 and the pointers are
// 16-byte aligned (L = min(32, pow2 >= C / 4): C = 16 gives 4 lanes and 8
// points a warp, C = 128 one point a warp), else one channel (L = min(32,
// pow2 >= C)); lanes stride over the chunks, the tail masked.  The point's 8
// corner offsets and weights are computed once per copy -- lane j of the
// group computes corner j (a lane of a group narrower than 8 computes 8 / L
// of them) -- and handed to the group by __shfl_sync; the undisplaced axis
// taps are computed once per point.  Each lane issues its 8 corner loads
// before it sums them in the plain order j = 0..7, then stores its chunk:
// a float4 for K4, 4 bf16 (8 bytes) for K5, contiguous across the group.
// Offsets are 32-bit inside one sample (the wrapper checks G * C < 2^31),
// with a 64-bit batch base.
//
// K7 (the coordinates' gradient) reads the same channels-last layout, which
// its wrapper stages again in the backward: saving the forward's copy would
// hold it beside the pyramid's flats and raise the train step's peak
// memory.  It is K4's template -- L lanes a point, lane j computing
// corner j of each copy once (32-bit offset and the three d w / d ix) and
// handing the offsets over by __shfl_sync, float4 chunks of the level and of
// g[pt, d*C + c] (scalar for C % 4 != 0 or a misaligned pointer) -- and
// contracts in the order e_j = sum_c g[d, c] * v[corner j, c] per lane, a
// butterfly sum of the 8 e_j over the group, then sum_j e_j * dw_j on the
// corner's owner lane, one group sum of the three results per point, scaled
// by dix/dp: (G-1)/2 with align_corners, G/2 without.  Like K4 it is bound by
// the sectors of the corners it reads; channel-major, each 4-byte read was
// its own sector and every lane recomputed all 8 corners with 64-bit
// offsets.  Derivative convention: the floor/frac one of the plain
// version's autograd (d frac / d ix = 1; +1 at integer ix, where the JAX
// kernel's _dhat gives 0 -- a set of measure zero).  Deterministic.
//
// K8 (the level's gradient) writes the JAX kernel's channels-last layout:
// a zeroed (B, G, C) f32 buffer, which its wrapper hands back as the (B, C,
// G) transposed view (through flatten_grid's reshape, the channels_last_3d
// memory cuDNN gives the conv outputs).  It is K4's template: L lanes a
// point, lane j computing corner j of each copy once (32-bit offset and
// weight, handed over by __shfl_sync), a lane reading 4 channels of g at
// once and adding them into each in-range corner's run with Hopper's vector
// atomic (atomicAdd(float4*), red.global.add.v4.f32); a scalar path for C %
// 4 != 0 or a misaligned pointer.  Channel-major, the old kernel issued one
// scalar atomic a (point, copy, corner, channel), each its own 32-byte
// sector: 677M a training backward (B=4 x 8192, C = 1/16/32/64/128/128).
// The coarse levels also contend: on a level of 336 voxels each (voxel,
// channel) takes ~1,365 adds a sample, which the L2's atomic units absorb;
// privatizing that level in shared memory saved 0.1 ms a backward, nothing
// a train step could show (PERF.md).  Atomics sum in a run-dependent order:
// a voxel that k (point, copy) pairs touch differs between orders by about
// k * 2^-24 of its magnitude, so K8 is held to its plain version at 1e-5
// relative to the gradient's largest magnitude (chip_smoke.py,
// tests/test_torch_cuda.py).
//
// K6 f32 reads the channels-last level too (its wrapper stages any other
// layout; evaluate_points stages its pyramid once a call): a corner's
// channels are one run, read 16 bytes at a time.
//
// K5 is K4 with its features stored as bf16 (round to nearest even), the
// output type of the TPU's 2-D (slab, band) bucketed kernel; the bucketing
// itself, and with it the band count, has no counterpart here.  It writes
// (B, N, 7C) bf16, so it moves the same gathers as K4 and half of K4's
// output bytes.  It reads an f32 level, or a bf16 one (the JAX kernel
// reads its level as bf16): evaluate_points' bf16 bands=None route hands it
// the pyramid rounded to bf16 and staged channels-last once a call, a lane
// widening 4 channels of one 8-byte read exactly to f32, so the gathers move
// half the sectors.
//
// K6 (f32, the parity route) is K4 with the level's block of fc0 contracted
// in the kernel: out[b, n, h] = sum_{d, c} feat[b, n, d*C + c] * w0l[d*C +
// c, h], feat being K4's exact f32 features, so the (B, N, 7C) features
// never reach device memory (what the TPU kernel keeps out of HBM).  It does
// 2 * 7C * H flop a point in f32 FMA: 346.7 GFLOP at 262,144 points and the
// six net_res-128 levels, at least 5.2 ms at the f32 rate, so operations
// bound it.  It runs on fma_f32.cuh's core, K3 f32's: a block owns kM = 64
// points (of the B*N flattened) and 256 columns of H (blockIdx.y takes the
// next 256, so H up to 1024), each thread an 8 x 8 register tile; the
// corners of all 7 copies of its points (32-bit offset and weight) go into
// shared memory once; the 7C feature rows are the A operand, gathered 16
// rows a chunk: an item is 4 channels of one point (4 adjacent lanes read
// one corner's 64-byte run), its 8 corners copied by 16-byte cp.async into
// the thread's staging slots while the chunk before runs its FMAs, then
// summed in the plain order j = 0..7 into the chunk (a scalar gather for C
// % 4 != 0 or a misaligned level); the level's block of fc0 streams through
// the B ring, read once per 64 points.  With accumulate set it adds into out,
// so the caller sums the six partials in one buffer.  On the H100 it runs
// at about half its bound, a few percent ahead of K4 plus cuBLAS's f32
// matmul over the same levels (PERF.md): the core runs at K3 f32's rate,
// and the gathers (8 corner reads a feature, through the shared-memory
// staging) take the SM's load/store path that the core's operand reads
// need too.
//
// K6 bf16 (the point query's default, the JAX kernel's precision class): the
// level rounded to bf16 and read from a channels-last bf16 copy (staged once
// a call by evaluate_points), f32 interpolation with each feature rounded
// once to bf16, w0l in bf16, products by mma.sync.m16n8k16 with f32
// accumulation, the level's partial rounded to bf16 and then added into the
// caller's f32 (B, N, H) buffer (JAX: h + partial.astype(f32)).  The same
// tensor-core tile as K2 bf16 (mma_bf16.cuh): a block owns kM = 64 points and
// all H outputs, warp w 32 columns; per copy the tile's 64 x 8 corners
// (32-bit offset, weight) go once into shared memory, each item gathers a
// point's 8 channels as one 16-byte read a corner into the A chunk, corners
// and A chunks are double-buffered (one barrier a copy), and the level's
// block of fc0 streams in fragment order through a per-warp cp.async ring,
// read once per 64 points.
// A one-channel level packs its 7 copies into one k16 chunk.  Levels need C
// = 1 or C % 16 == 0 up to 128 and H of 256 or 512 (every IF-Net
// configuration); the wrapper raises otherwise.  Bound: the tensor cores'
// 346.7 GFLOP, ~0.35 ms at 262,144 points.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fma_f32.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;

__constant__ int kDisp[7][3] = {{0, 0, 0},  {-1, 0, 0}, {1, 0, 0}, {0, -1, 0},
                                {0, 1, 0},  {0, 0, -1}, {0, 0, 1}};

struct Level {
  int g0, g1, g2;
  int64_t gsize;
  int c;
  int ac;
  float disp;
};

// torch grid_sample's index mapping, in the plain sampler's operation order
__device__ __forceinline__ float axis_ix(float p, int size, int ac) {
  const float q = __fadd_rn(p, 1.0f);
  if (ac) return __fmul_rn(__fmul_rn(q, 0.5f), (float)size - 1.0f);
  return __fmul_rn(__fadd_rn(__fmul_rn(q, (float)size), -1.0f), 0.5f);
}

// floor index and frac of one displaced axis coordinate
__device__ __forceinline__ void axis_tap(float p, int s, float disp, int size,
                                         int ac, int& i, float& f) {
  const float pd = s ? __fadd_rn(p, s * disp) : p;
  const float ix = axis_ix(pd, size, ac);
  const float fl = floorf(ix);
  i = (int)fl;
  f = ix - fl;
}

// -- K4 / K5 on the channels-last level --------------------------------------

// Corner j (bits: axis 0, 1, 2) of a displaced point on a channels-last
// level: its element offset voxel * C (32-bit inside one sample) and its
// trilinear weight, both 0 when the corner is out of range.
__device__ __forceinline__ void corner(const Level& L, int j, int i0, int i1,
                                       int i2, float f0, float f1, float f2,
                                       int& off, float& w) {
  const int c0 = j >> 2, c1 = (j >> 1) & 1, c2 = j & 1;
  const int a = i0 + c0, b = i1 + c1, e = i2 + c2;
  const bool valid = a >= 0 && a < L.g0 && b >= 0 && b < L.g1 && e >= 0 && e < L.g2;
  const float w0 = c0 ? f0 : 1.0f - f0;
  const float w1 = c1 ? f1 : 1.0f - f1;
  const float w2 = c2 ? f2 : 1.0f - f2;
  off = valid ? ((a * L.g1 + b) * L.g2 + e) * L.c : 0;
  w = valid ? w0 * w1 * w2 : 0.0f;
}

// Corner j's offset, as corner() gives it, and d w / d ix of its weight per
// axis (the floor/frac convention), all 0 when the corner is out of range.
__device__ __forceinline__ void corner_grad(const Level& L, int j, int i0, int i1,
                                            int i2, float f0, float f1, float f2,
                                            int& off, float (&dw)[3]) {
  const int c0 = j >> 2, c1 = (j >> 1) & 1, c2 = j & 1;
  const int a = i0 + c0, b = i1 + c1, e = i2 + c2;
  const bool valid = a >= 0 && a < L.g0 && b >= 0 && b < L.g1 && e >= 0 && e < L.g2;
  const float w0 = c0 ? f0 : 1.0f - f0;
  const float w1 = c1 ? f1 : 1.0f - f1;
  const float w2 = c2 ? f2 : 1.0f - f2;
  off = valid ? ((a * L.g1 + b) * L.g2 + e) * L.c : 0;
  dw[0] = valid ? (c0 ? 1.0f : -1.0f) * w1 * w2 : 0.0f;
  dw[1] = valid ? w0 * (c1 ? 1.0f : -1.0f) * w2 : 0.0f;
  dw[2] = valid ? w0 * w1 * (c2 ? 1.0f : -1.0f) : 0.0f;
}

// Corner j's value of x, held by lane j % kLanes of the group in slot
// j / kLanes (see the kernel).
template <int kLanes, typename T, int kSlots>
__device__ __forceinline__ T from_corner(const T (&x)[kSlots], int j) {
  if constexpr (kLanes == 1) {
    return x[j];
  } else {
    return __shfl_sync(0xffffffffu, x[j / kLanes], j % kLanes, kLanes);
  }
}

__device__ __forceinline__ void load(const float* p, float& v) { v = __ldg(p); }
__device__ __forceinline__ void load(const float* p, float4& v) {
  v = __ldg(reinterpret_cast<const float4*>(p));
}
// a bf16 level (K5 on evaluate_points' bf16 pyramid): one value, or 4
// consecutive channels as one 8-byte read, widened exactly to f32
__device__ __forceinline__ void load(const __nv_bfloat16* p, float& v) {
  v = __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float4& v) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  v = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                  __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void zero(float& v) { v = 0.0f; }
__device__ __forceinline__ void zero(float4& v) { v = make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ void fma_into(float w, float v, float& acc) { acc = fmaf(w, v, acc); }
__device__ __forceinline__ void fma_into(float w, const float4& v, float4& acc) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

__device__ __forceinline__ float dot(float a, float b) { return a * b; }
__device__ __forceinline__ float dot(const float4& a, const float4& b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

struct alignas(8) Bf16x4 {
  __nv_bfloat162 lo, hi;
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float4& v) {
  Bf16x4 u;
  u.lo = __floats2bfloat162_rn(v.x, v.y);
  u.hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<Bf16x4*>(p) = u;
}

// VecT float4: a lane takes 4 consecutive channels (C % 4 == 0, aligned
// level and output); float: one channel.  kLanes lanes own a point.  InT is
// the level's type: float, or bf16 for K5 on a level rounded to bf16.
template <typename InT, typename OutT, typename VecT, int kLanes>
__global__ void __launch_bounds__(kThreads, 4)
level_features_kernel(const InT* __restrict__ vol, const float* __restrict__ q0,
                      const float* __restrict__ q1, const float* __restrict__ q2,
                      OutT* __restrict__ out, int batch, int n, Level L) {
  constexpr int kW = sizeof(VecT) / sizeof(float);      // channels a lane loads at once
  constexpr int kSlots = kLanes >= 8 ? 1 : 8 / kLanes;  // corners a lane computes
  const int64_t total = (int64_t)batch * n;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x % kLanes;
  // every lane of a warp reaches the shuffles: lanes past the last point
  // redo the last point and store nothing
  const bool active = t / kLanes < total;
  const int64_t pt = active ? t / kLanes : total - 1;
  const int b = (int)(pt / n);
  const float p0 = q0[pt], p1 = q1[pt], p2 = q2[pt];
  const InT* v = vol + (int64_t)b * L.gsize * L.c;
  OutT* o = out + pt * 7 * L.c;
  const int chunks = L.c / kW;
  int ci0, ci1, ci2;  // the undisplaced taps; copy d > 0 moves one axis
  float cf0, cf1, cf2;
  axis_tap(p0, 0, L.disp, L.g0, L.ac, ci0, cf0);
  axis_tap(p1, 0, L.disp, L.g1, L.ac, ci1, cf1);
  axis_tap(p2, 0, L.disp, L.g2, L.ac, ci2, cf2);
  for (int d = 0; d < 7; ++d) {
    int i0 = ci0, i1 = ci1, i2 = ci2;
    float f0 = cf0, f1 = cf1, f2 = cf2;
    const int s = (d & 1) ? -1 : 1;  // kDisp's sign on the moved axis
    if (d == 1 || d == 2) {
      axis_tap(p0, s, L.disp, L.g0, L.ac, i0, f0);
    } else if (d == 3 || d == 4) {
      axis_tap(p1, s, L.disp, L.g1, L.ac, i1, f1);
    } else if (d >= 5) {
      axis_tap(p2, s, L.disp, L.g2, L.ac, i2, f2);
    }
    // lane l computes corners k * kLanes + l (lanes of a group wider than 8
    // repeat corner l & 7 and share none of it)
    int off[kSlots];
    float w[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      corner(L, (k * kLanes + lane) & 7, i0, i1, i2, f0, f1, f2, off[k], w[k]);
    }
    // the same trip count on every lane of the warp (chunks is the level's)
    for (int c0 = 0; c0 < chunks; c0 += kLanes) {
      const int ck = c0 + lane;
      const InT* vc = v + (ck < chunks ? ck : 0) * kW;  // the tail re-reads chunk 0
      VecT val[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) load(vc + from_corner<kLanes>(off, j), val[j]);
      VecT acc;
      zero(acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) fma_into(from_corner<kLanes>(w, j), val[j], acc);
      if (active && ck < chunks) store(o + d * L.c + ck * kW, acc);
    }
  }
}

// K7 on the channels-last level, K4's template: kLanes lanes own a point,
// lane j of the group computes corner j of each copy once (its offset before
// the channel loop, its three d w / d ix after it), a lane reads kW channels
// of the level and of g at once.
// Per copy each lane sums e_j = sum_c g[d, c] * v[corner j, c] over its
// chunks; the group sums the e_j (butterfly: every lane ends with all 8);
// each corner's owner lane adds e_j * dw_j to the point's three sums, which
// the group reduces once at the end.  No atomics: deterministic.
template <typename VecT, int kLanes>
__global__ void __launch_bounds__(kThreads, kLanes == 1 ? 3 : 4)  // one lane holds all 8 corners
level_grad_points_kernel(const float* __restrict__ vol, const float* __restrict__ q0,
                         const float* __restrict__ q1, const float* __restrict__ q2,
                         const float* __restrict__ g, float* __restrict__ out, int batch,
                         int n, Level L) {
  constexpr int kW = sizeof(VecT) / sizeof(float);
  constexpr int kSlots = kLanes >= 8 ? 1 : 8 / kLanes;
  const int64_t total = (int64_t)batch * n;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x % kLanes;
  const bool active = t / kLanes < total;
  const int64_t pt = active ? t / kLanes : total - 1;
  const int b = (int)(pt / n);
  const float p0 = q0[pt], p1 = q1[pt], p2 = q2[pt];
  const float* v = vol + (int64_t)b * L.gsize * L.c;
  const float* gp = g + pt * 7 * L.c;
  const int chunks = L.c / kW;
  int ci0, ci1, ci2;
  float cf0, cf1, cf2;
  axis_tap(p0, 0, L.disp, L.g0, L.ac, ci0, cf0);
  axis_tap(p1, 0, L.disp, L.g1, L.ac, ci1, cf1);
  axis_tap(p2, 0, L.disp, L.g2, L.ac, ci2, cf2);
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  for (int d = 0; d < 7; ++d) {
    int i0 = ci0, i1 = ci1, i2 = ci2;
    float f0 = cf0, f1 = cf1, f2 = cf2;
    const int s = (d & 1) ? -1 : 1;
    if (d == 1 || d == 2) {
      axis_tap(p0, s, L.disp, L.g0, L.ac, i0, f0);
    } else if (d == 3 || d == 4) {
      axis_tap(p1, s, L.disp, L.g1, L.ac, i1, f1);
    } else if (d >= 5) {
      axis_tap(p2, s, L.disp, L.g2, L.ac, i2, f2);
    }
    int off[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      float w;
      corner(L, (k * kLanes + lane) & 7, i0, i1, i2, f0, f1, f2, off[k], w);
    }
    float e[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = 0.0f;
    for (int c0 = 0; c0 < chunks; c0 += kLanes) {
      const int ck = c0 + lane;
      const bool live = ck < chunks;
      const float* vc = v + (live ? ck : 0) * kW;  // the tail re-reads chunk 0 ...
      VecT gv;
      if (live) {
        load(gp + d * L.c + ck * kW, gv);
      } else {
        zero(gv);  // ... against a zero cotangent
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // 4 corners at a time keeps K7 within 64 registers
        VecT val[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) load(vc + from_corner<kLanes>(off, 4 * h + j), val[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j) e[4 * h + j] += dot(gv, val[j]);
      }
    }
#pragma unroll
    for (int o = kLanes >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] += __shfl_xor_sync(0xffffffffu, e[j], o);
    }
    // corner j's owner: lane j % kLanes, slot j / kLanes (lanes past 8 of a
    // wider group repeat a corner and add nothing)
    if (kLanes < 8 || lane < 8) {
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int j = (k * kLanes + lane) & 7;
        int unused;
        float dw[3];  // computed here, not held through the channel loop
        corner_grad(L, j, i0, i1, i2, f0, f1, f2, unused, dw);
        float ej = 0.0f;  // e[j] by selects: a lane-dependent index would put e in local memory
#pragma unroll
        for (int i = 0; i < 8; ++i) ej = i == j ? e[i] : ej;
        s0 = fmaf(ej, dw[0], s0);
        s1 = fmaf(ej, dw[1], s1);
        s2 = fmaf(ej, dw[2], s2);
      }
    }
  }
#pragma unroll
  for (int o = kLanes >> 1; o > 0; o >>= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  if (active && lane == 0) {
    const float a0 = L.ac ? 0.5f * (L.g0 - 1.0f) : 0.5f * L.g0;
    const float a1 = L.ac ? 0.5f * (L.g1 - 1.0f) : 0.5f * L.g1;
    const float a2 = L.ac ? 0.5f * (L.g2 - 1.0f) : 0.5f * L.g2;
    out[pt * 3 + 0] = s0 * a0;
    out[pt * 3 + 1] = s1 * a1;
    out[pt * 3 + 2] = s2 * a2;
  }
}

// Hopper's vector atomic for 4 consecutive floats (red.global.add.v4.f32,
// sm_90): one operation and one sector for a float4 chunk of a corner.
__device__ __forceinline__ void atomic_add(float* p, float v) { atomicAdd(p, v); }
__device__ __forceinline__ void atomic_add(float* p, const float4& v) {
  atomicAdd(reinterpret_cast<float4*>(p), v);
}
__device__ __forceinline__ float scale(float w, float v) { return w * v; }
__device__ __forceinline__ float4 scale(float w, const float4& v) {
  return make_float4(w * v.x, w * v.y, w * v.z, w * v.w);
}

// K8: K4's template on the channels-last (B, G, C) gradient.
// kLanes lanes own a point, lane j computes corner j of each copy once (its
// 32-bit offset voxel * C and its weight) and the group gets all 8 by
// __shfl_sync; a lane reads kW channels of g[pt, d*C + c] once and adds
// w_j * g into each in-range corner's run with one atomic (a vector one for
// float4).
template <typename VecT, int kLanes>
__global__ void __launch_bounds__(kThreads, 4)
level_grad_vol_kernel(const float* __restrict__ q0, const float* __restrict__ q1,
                      const float* __restrict__ q2, const float* __restrict__ g,
                      float* __restrict__ gvol, int batch, int n, Level L) {
  constexpr int kW = sizeof(VecT) / sizeof(float);
  constexpr int kSlots = kLanes >= 8 ? 1 : 8 / kLanes;
  const int64_t total = (int64_t)batch * n;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x % kLanes;
  const bool active = t / kLanes < total;  // inactive lanes join the shuffles only
  const int64_t pt = active ? t / kLanes : total - 1;
  const int b = (int)(pt / n);
  const float p0 = q0[pt], p1 = q1[pt], p2 = q2[pt];
  float* gv = gvol + (int64_t)b * L.gsize * L.c;
  const float* gp = g + pt * 7 * L.c;
  const int chunks = L.c / kW;
  int ci0, ci1, ci2;
  float cf0, cf1, cf2;
  axis_tap(p0, 0, L.disp, L.g0, L.ac, ci0, cf0);
  axis_tap(p1, 0, L.disp, L.g1, L.ac, ci1, cf1);
  axis_tap(p2, 0, L.disp, L.g2, L.ac, ci2, cf2);
  for (int d = 0; d < 7; ++d) {
    int i0 = ci0, i1 = ci1, i2 = ci2;
    float f0 = cf0, f1 = cf1, f2 = cf2;
    const int s = (d & 1) ? -1 : 1;
    if (d == 1 || d == 2) {
      axis_tap(p0, s, L.disp, L.g0, L.ac, i0, f0);
    } else if (d == 3 || d == 4) {
      axis_tap(p1, s, L.disp, L.g1, L.ac, i1, f1);
    } else if (d >= 5) {
      axis_tap(p2, s, L.disp, L.g2, L.ac, i2, f2);
    }
    int off[kSlots];
    float w[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      corner(L, (k * kLanes + lane) & 7, i0, i1, i2, f0, f1, f2, off[k], w[k]);
    }
    int offj[8];
    float wj[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      offj[j] = from_corner<kLanes>(off, j);
      wj[j] = from_corner<kLanes>(w, j);
    }
    if (!active) continue;
    for (int ck = lane; ck < chunks; ck += kLanes) {
      VecT gd;
      load(gp + d * L.c + ck * kW, gd);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (wj[j] != 0.0f) atomic_add(gv + offj[j] + ck * kW, scale(wj[j], gd));
      }
    }
  }
}

// -- K6 f32 (see the note at the top) -----------------------------------------

constexpr int kFc0H = 256;   // columns a block (blockIdx.y picks the slice of H)

// K6 f32's A operand: chunk c holds rows [kK c, kK c + kK) of the level's
// 7C features (row d*C + ch: channel ch of copy d) for the tile's kM points,
// in stage c % 2 of a [2][kK][kM] ring.  The corners of all 7 copies lie in
// shared memory (off[(d * 8 + j) * kM + p]: 32-bit element offset into the
// sample's channels-last level, w likewise, base[p] the sample's first
// element).  vec (C % 4 == 0, level 16-byte aligned): an item is 4 channels
// of one point, and the 4 items of a point's chunk lie on adjacent lanes (one
// 64-byte run of each corner a quarter-warp); issue() copies its 8 corners'
// float4 into the thread's own slots of the staging buffer by cp.async,
// finish() sums them, j = 0..7, into 4 rows of the A chunk.
// Otherwise finish() gathers each (row, point) with 8 scalar loads.  Rows
// past 7C are zeros.
template <int kM, int kK, int NT>
struct GatherA {
  static constexpr int kQ = kK / 4;         // a point's items a chunk, on adjacent lanes
  static constexpr int kItems = kQ * kM;    // vec items a chunk
  static constexpr int kPer = (kItems + NT - 1) / NT;
  float* ring;
  float4* stage;  // [8][kItems]: corner j of item i at j * kItems + i
  const float* __restrict__ vol;
  const int* off;
  const float* w;
  const int64_t* base;
  int c, k_total;
  bool vec;
  float inv_c;  // 1 / c, so that copy() needs no integer division

  // the copy of feature row k < 7c, k / c: (k + 1/2) / c lies 1 / (2c) or
  // more from an integer, and the f32 product errs by under 7 * 2^-23, so
  // it is exact for c < 2^19 (the entry refuses larger c)
  __device__ __forceinline__ int copy(int k) const {
    return (int)(((float)k + 0.5f) * inv_c);
  }

  __device__ __forceinline__ void issue(int ch) {
    if (!vec) return;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = threadIdx.x + r * NT;
      const int p = i / kQ, k = ch * kK + 4 * (i % kQ);
      if ((kItems % NT != 0 && i >= kItems) || k >= k_total) continue;
      const int d = copy(k);
      const float* src = vol + base[p] + (k - d * c);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        cp_async16(stage + j * kItems + i, src + off[(d * 8 + j) * kM + p]);
    }
  }
  __device__ __forceinline__ void finish(int ch) {
    float* a = ring + (ch & 1) * kK * kM;
    if (vec) {
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int i = threadIdx.x + r * NT;
        if (kItems % NT != 0 && i >= kItems) continue;
        const int p = i / kQ, q = i % kQ, k = ch * kK + 4 * q;
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k < k_total) {
          const int d = copy(k);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 x = stage[j * kItems + i];
            const float wj = w[(d * 8 + j) * kM + p];
            s.x = fmaf(wj, x.x, s.x);
            s.y = fmaf(wj, x.y, s.y);
            s.z = fmaf(wj, x.z, s.z);
            s.w = fmaf(wj, x.w, s.w);
          }
        }
        a[(4 * q) * kM + p] = s.x;
        a[(4 * q + 1) * kM + p] = s.y;
        a[(4 * q + 2) * kM + p] = s.z;
        a[(4 * q + 3) * kM + p] = s.w;
      }
    } else {
      // a fixed trip count, so that every load of the thread is in flight at once
#pragma unroll
      for (int u = 0; u < (kK * kM + NT - 1) / NT; ++u) {
        const int i = threadIdx.x + u * NT;
        if ((kK * kM) % NT != 0 && i >= kK * kM) continue;
        const int r = i / kM, p = i - r * kM;
        const int k = ch * kK + r;
        float s = 0.f;
        if (k < k_total) {
          const int d = copy(k);
          const float* src = vol + base[p] + (k - d * c);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            s = fmaf(w[(d * 8 + j) * kM + p], __ldg(src + off[(d * 8 + j) * kM + p]), s);
        }
        a[i] = s;
      }
    }
  }
  __device__ __forceinline__ const float* chunk(int ch) const {
    return ring + (ch & 1) * kK * kM;
  }
};

// K6 f32's tile and shared memory: 64 points x 256 columns, 256 threads,
// chunks of 16 rows; 101 KB, two blocks an SM (127 registers, no spills).
// evaluate_points' tile of 65,536 points is 1,024 blocks, 3.9 waves of 264;
// 96 points (one block of 384 threads an SM) made 683 blocks, 5.2 waves of
// 132, and ran slower at 65,536 and at 262,144 points on the H100.
struct Fc0Smem {
  using Tile = FmaTile<64, kFc0H>;
  static constexpr int kM = Tile::kM, kK = Tile::kK;
  static constexpr int NT = Tile::NT;
  using Gather = GatherA<kM, kK, NT>;
  static constexpr int kCornerBytes = 7 * 8 * kM * 4;  // off, and w
  static constexpr int kBaseBytes = kM * 8;
  static constexpr int kStageBytes = 8 * Gather::kItems * 16;
  static constexpr int kRingBytes = 2 * kK * kM * 4;
  static constexpr int kBytes =
      2 * kCornerBytes + kBaseBytes + kStageBytes + kRingBytes + Tile::kBBytes;
  static_assert(2 * (kBytes + 1024) <= 232448, "two blocks an SM");
};

// K6 f32: the block's tile is points [kM blockIdx.x, + kM) of the B*N
// flattened and columns [256 blockIdx.y, + 256) of H; vol the channels-last
// (B, G, C) level, w0l the level's (7C, H) block of fc0, out (B, N, H).
__global__ void __launch_bounds__(Fc0Smem::NT, 2)
level_fc0_kernel(const float* __restrict__ vol, const float* __restrict__ w0l,
                 const float* __restrict__ q0, const float* __restrict__ q1,
                 const float* __restrict__ q2, float* __restrict__ out, int batch, int n,
                 Level L, int h_dim, int accumulate) {
  using S = Fc0Smem;
  constexpr int kM = S::kM, NT = S::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* stage = reinterpret_cast<float4*>(smem);
  float* bring = reinterpret_cast<float*>(smem + S::kStageBytes);
  float* aring = bring + S::Tile::kBBytes / 4;
  int* s_off = reinterpret_cast<int*>(aring + S::kRingBytes / 4);
  float* s_w = reinterpret_cast<float*>(s_off + 7 * 8 * kM);
  int64_t* s_base = reinterpret_cast<int64_t*>(s_w + 7 * 8 * kM);

  const int64_t total = (int64_t)batch * n;
  const int64_t pt0 = (int64_t)blockIdx.x * kM;
  const int c0 = blockIdx.y * kFc0H;
  // the corners of every (point, copy); the ragged tail repeats the last
  // point, its stores masked
  for (int i = threadIdx.x; i < 7 * kM; i += NT) {
    const int p = i % kM, d = i / kM;
    const int64_t pt = pt0 + p < total ? pt0 + p : total - 1;
    int i0, i1, i2;
    float f0, f1, f2;
    axis_tap(q0[pt], kDisp[d][0], L.disp, L.g0, L.ac, i0, f0);
    axis_tap(q1[pt], kDisp[d][1], L.disp, L.g1, L.ac, i1, f1);
    axis_tap(q2[pt], kDisp[d][2], L.disp, L.g2, L.ac, i2, f2);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      corner(L, j, i0, i1, i2, f0, f1, f2, s_off[(d * 8 + j) * kM + p], s_w[(d * 8 + j) * kM + p]);
    if (d == 0) s_base[p] = (pt / n) * L.gsize * L.c;
  }
  __syncthreads();

  S::Tile t;
  t.init();
  S::Gather ga{aring, stage, vol, s_off, s_w, s_base, L.c, 7 * L.c,
               L.c % 4 == 0 && aligned16(vol), 1.0f / L.c};
  contract(t, ga, w0l, 7 * L.c, h_dim, c0, bring);

  // out[pt, c] (+)= acc: float4 stores of 4 columns where H % 4 == 0 and out
  // is 16-byte aligned.  The earlier partials of 4 points are loaded before
  // their first store, so that those 8 loads are in flight together (a store
  // between two loads would order the second after it).
  const bool vec = h_dim % 4 == 0 && aligned16(out);
#pragma unroll
  for (int i0 = 0; i0 < 8; i0 += 4) {
    if (accumulate) {
      float4 prev[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t pt = pt0 + t.point(i0 + i);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + t.col(4 * h);
          const float* o = out + pt * h_dim + c;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (pt < total && vec && c < h_dim) {
            v = *reinterpret_cast<const float4*>(o);
          } else if (pt < total && !vec) {
            if (c < h_dim) v.x = o[0];
            if (c + 1 < h_dim) v.y = o[1];
            if (c + 2 < h_dim) v.z = o[2];
            if (c + 3 < h_dim) v.w = o[3];
          }
          prev[i][h] = v;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* a = t.acc[i0 + i] + 4 * h;
          a[0] = prev[i][h].x + a[0];
          a[1] = prev[i][h].y + a[1];
          a[2] = prev[i][h].z + a[2];
          a[3] = prev[i][h].w + a[3];
        }
    }
#pragma unroll
    for (int i = i0; i < i0 + 4; ++i) {
      const int64_t pt = pt0 + t.point(i);
      if (pt >= total) continue;
      float* o = out + pt * h_dim;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + t.col(4 * h);
        if (vec) {
          if (c < h_dim)
            *reinterpret_cast<float4*>(o + c) = make_float4(
                t.acc[i][4 * h], t.acc[i][4 * h + 1], t.acc[i][4 * h + 2], t.acc[i][4 * h + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c + e < h_dim) o[c + e] = t.acc[i][4 * h + e];
        }
      }
    }
  }
}

// -- K6 bf16 (see the note at the top) ----------------------------------------

// Corner j of point (p0, p1, p2) displaced by copy d, as K4 computes it.
__device__ __forceinline__ void point_corner(const Level& L, float p0, float p1, float p2,
                                             int d, int j, int& off, float& w) {
  int i0, i1, i2;
  float f0, f1, f2;
  axis_tap(p0, kDisp[d][0], L.disp, L.g0, L.ac, i0, f0);
  axis_tap(p1, kDisp[d][1], L.disp, L.g1, L.ac, i1, f1);
  axis_tap(p2, kDisp[d][2], L.disp, L.g2, L.ac, i2, f2);
  corner(L, j, i0, i1, i2, f0, f1, f2, off, w);
}

// The packed chunk of a one-channel level: a[p][d] for the 7 copies, zeros
// in columns 7..15; each item computes its own 8 corners.
template <int NT>
__device__ __forceinline__ void gather_packed_points(const Level& L, const bf16* __restrict__ vol,
                                                     const float (*pts)[kM], bf16* a) {
  for (int i = threadIdx.x; i < kM * 16; i += NT) {
    const int p = i >> 4, d = i & 15;
    float acc = 0.f;
    if (d < 7) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int off;
        float w;
        point_corner(L, pts[0][p], pts[1][p], pts[2][p], d, j, off, w);
        acc = fmaf(w, __bfloat162float(vol[off]), acc);
      }
    }
    a[p * kAStride + d] = __float2bfloat16_rn(acc);
  }
}

// NW warps, H = 32 NW outputs: warp w owns columns [32 w, 32 w + 32) for all
// kM points of the block's tile (points [64 blockIdx.x, +64) of sample
// blockIdx.y).  Groups are the 7 copies (C / 16 chunks each), or one packed
// chunk for C = 1.
template <int NW>
__global__ void __launch_bounds__(NW * 32, NW == 8 ? 2 : 1)
level_fc0_bf16_kernel(const bf16* __restrict__ vol, const uint4* __restrict__ w0f,
                      const float* __restrict__ q0, const float* __restrict__ q1,
                      const float* __restrict__ q2, float* __restrict__ out, int n, Level L,
                      int accumulate) {
  constexpr int NT = NW * 32;
  constexpr int H = NW * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* abuf = reinterpret_cast<bf16*>(smem);                         // [2][kM][kAStride]
  int* s_off = reinterpret_cast<int*>(smem + 2 * kM * kAStride * 2);  // [2][kM * 8]
  float* s_w = reinterpret_cast<float*>(s_off + 2 * kM * 8);          // [2][kM * 8]
  uint4* ring = reinterpret_cast<uint4*>(s_w + 2 * kM * 8);           // [NW][kStages][2][32]
  __shared__ float s_p[3][kM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kM;
  if (tid < kM) {
    // the ragged tail repeats the last point; its stores are masked
    const int64_t pt = (int64_t)b * n + min(p0 + tid, n - 1);
    s_p[0][tid] = q0[pt];
    s_p[1][tid] = q1[pt];
    s_p[2][tid] = q2[pt];
  }
  const bf16* v = vol + (int64_t)b * L.gsize * L.c;
  const bool packed = L.c == 1;
  const int n_groups = packed ? 1 : 7;
  const int chunks = packed ? 1 : L.c / 16;
  BStream<2> bs{w0f + warp * 2 * 32, (H / 16) * 32, n_groups * chunks,
                ring + warp * kStages * 2 * 32, lane, 0};
  bs.start();
  __syncthreads();

  // corners of copy g live in buffer g % 2, its A chunk in A buffer g % 2
  auto corners_of = [&](int g) {
    if (packed || g >= n_groups) return;
    int* off = s_off + (g & 1) * kM * 8;
    float* w = s_w + (g & 1) * kM * 8;
    for (int i = tid; i < kM * 8; i += NT) {
      const int p = i >> 3;
      point_corner(L, s_p[0][p], s_p[1][p], s_p[2][p], g, i & 7, off[i], w[i]);
    }
  };
  auto gather = [&](int g) {
    bf16* a = abuf + (g & 1) * kM * kAStride;
    if (packed) {
      gather_packed_points<NT>(L, v, s_p, a);
    } else {
      gather_group<NT>(v, L.c, s_off + (g & 1) * kM * 8, s_w + (g & 1) * kM * 8, a);
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
  int k = 0;
  for (int g = 0; g < n_groups; ++g) {
    const bf16* a = abuf + (g & 1) * kM * kAStride;
    for (int q = 0; q < chunks; ++q, ++k) {
      uint32_t bf[4][2];
      bs.get(k, bf);
      mma_chunk<4>(acc, a, kAStride, q * 16, bf, lane);
    }
    // warps that finish their MMAs start the next gather; one barrier a copy
    if (g + 1 < n_groups) gather(g + 1);
    corners_of(g + 2);
    __syncthreads();
  }

  // the partial rounded to bf16, then added into (or written to) the f32
  // output: rows lane/4 and lane/4 + 8 of each m-tile, columns 2 (lane % 4)
  // + 0, 1 of each n-tile
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = warp * 32 + nt * 8 + (lane & 3) * 2;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = p0 + mt * 16 + (lane >> 2) + 8 * half;
        if (row < n) {
          float2* o = reinterpret_cast<float2*>(out + ((int64_t)b * n + row) * H + col);
          float2 r = make_float2(__bfloat162float(__float2bfloat16_rn(acc[mt][nt][2 * half])),
                                 __bfloat162float(__float2bfloat16_rn(acc[mt][nt][2 * half + 1])));
          if (accumulate) {
            const float2 prev = *o;
            r.x += prev.x;
            r.y += prev.y;
          }
          *o = r;
        }
      }
    }
  }
}

template <int NW>
int launch_fc0_bf16(const void* vol, const void* w0f, const void* q0, const void* q1,
                    const void* q2, void* out, int batch, int n, const Level& L, int accumulate,
                    cudaStream_t stream) {
  const int smem = 2 * kM * kAStride * 2 + 2 * kM * 8 * 8 + NW * kStages * 2 * 32 * 16;
  const cudaError_t err = cudaFuncSetAttribute(level_fc0_bf16_kernel<NW>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + kM - 1) / kM), (unsigned)batch);
  level_fc0_bf16_kernel<NW><<<grid, NW * 32, smem, stream>>>(
      (const bf16*)vol, (const uint4*)w0f, (const float*)q0, (const float*)q1, (const float*)q2,
      (float*)out, n, L, accumulate);
  return (int)cudaGetLastError();
}

int lanes_for(int c) {
  int l = 1;
  while (l < c && l < 32) l <<= 1;
  return l;
}

unsigned blocks_for(int64_t threads_total, int threads) {
  return (unsigned)((threads_total + threads - 1) / threads);
}

template <typename InT, typename OutT, typename VecT>
void launch_features(int lanes, const InT* vol, const float* q0, const float* q1,
                     const float* q2, OutT* out, int batch, int n, const Level& L,
                     cudaStream_t stream) {
  auto kernel = level_features_kernel<InT, OutT, VecT, 32>;
  switch (lanes) {
    case 1: kernel = level_features_kernel<InT, OutT, VecT, 1>; break;
    case 2: kernel = level_features_kernel<InT, OutT, VecT, 2>; break;
    case 4: kernel = level_features_kernel<InT, OutT, VecT, 4>; break;
    case 8: kernel = level_features_kernel<InT, OutT, VecT, 8>; break;
    case 16: kernel = level_features_kernel<InT, OutT, VecT, 16>; break;
    default: break;
  }
  kernel<<<blocks_for((int64_t)batch * n * lanes, kThreads), kThreads, 0, stream>>>(
      vol, q0, q1, q2, out, batch, n, L);
}

template <typename VecT>
void launch_grad_points(int lanes, const float* const (&a)[5], float* out, int batch, int n,
                        const Level& L, cudaStream_t stream) {
  auto kernel = level_grad_points_kernel<VecT, 32>;
  switch (lanes) {
    case 1: kernel = level_grad_points_kernel<VecT, 1>; break;
    case 2: kernel = level_grad_points_kernel<VecT, 2>; break;
    case 4: kernel = level_grad_points_kernel<VecT, 4>; break;
    case 8: kernel = level_grad_points_kernel<VecT, 8>; break;
    case 16: kernel = level_grad_points_kernel<VecT, 16>; break;
    default: break;
  }
  kernel<<<blocks_for((int64_t)batch * n * lanes, kThreads), kThreads, 0, stream>>>(
      a[0], a[1], a[2], a[3], a[4], out, batch, n, L);
}

template <typename VecT>
void launch_grad_vol(int lanes, const float* q0, const float* q1, const float* q2,
                     const float* g, float* gvol, int batch, int n, const Level& L,
                     cudaStream_t stream) {
  auto kernel = level_grad_vol_kernel<VecT, 32>;
  switch (lanes) {
    case 1: kernel = level_grad_vol_kernel<VecT, 1>; break;
    case 2: kernel = level_grad_vol_kernel<VecT, 2>; break;
    case 4: kernel = level_grad_vol_kernel<VecT, 4>; break;
    case 8: kernel = level_grad_vol_kernel<VecT, 8>; break;
    case 16: kernel = level_grad_vol_kernel<VecT, 16>; break;
    default: break;
  }
  kernel<<<blocks_for((int64_t)batch * n * lanes, kThreads), kThreads, 0, stream>>>(
      q0, q1, q2, g, gvol, batch, n, L);
}

// K4 (OutT float) and K5 (bf16) on a channels-last (B, G, C) level of InT.
template <typename InT, typename OutT>
int level_features_entry(const void* vol, const void* q0, const void* q1,
                         const void* q2, void* out, int batch, int n, int c,
                         int g0, int g1, int g2, int align_corners, float disp,
                         void* stream) {
  const Level L{g0, g1, g2, (int64_t)g0 * g1 * g2, c, align_corners, disp};
  if (L.gsize * c >= (int64_t{1} << 31)) return (int)cudaErrorInvalidValue;
  if ((int64_t)batch * n > 0) {
    const bool vec = c % 4 == 0 && (uintptr_t)vol % (4 * sizeof(InT)) == 0 &&
                     (uintptr_t)out % (4 * sizeof(OutT)) == 0;
    if (vec) {
      launch_features<InT, OutT, float4>(lanes_for(c / 4), (const InT*)vol, (const float*)q0,
                                         (const float*)q1, (const float*)q2, (OutT*)out,
                                         batch, n, L, (cudaStream_t)stream);
    } else {
      launch_features<InT, OutT, float>(lanes_for(c), (const InT*)vol, (const float*)q0,
                                        (const float*)q1, (const float*)q2, (OutT*)out, batch,
                                        n, L, (cudaStream_t)stream);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sv3d_level_features(const void* vol, const void* q0,
                                   const void* q1, const void* q2, void* out,
                                   int batch, int n, int c, int g0, int g1,
                                   int g2, int align_corners, float disp,
                                   void* stream) {
  return level_features_entry<float, float>(vol, q0, q1, q2, out, batch, n, c, g0, g1, g2,
                                            align_corners, disp, stream);
}

// K5: level_bf16 0 reads an f32 level, 1 a bf16 one.
extern "C" int sv3d_level_features_bf16(const void* vol, const void* q0,
                                        const void* q1, const void* q2,
                                        void* out, int level_bf16, int batch, int n,
                                        int c, int g0, int g1, int g2,
                                        int align_corners, float disp,
                                        void* stream) {
  if (level_bf16)
    return level_features_entry<__nv_bfloat16, __nv_bfloat16>(
        vol, q0, q1, q2, out, batch, n, c, g0, g1, g2, align_corners, disp, stream);
  return level_features_entry<float, __nv_bfloat16>(vol, q0, q1, q2, out, batch, n, c, g0,
                                                    g1, g2, align_corners, disp, stream);
}

// K6 f32: vol the channels-last (B, G, C) f32 level, w0l the level's (7C, H)
// block of fc0, out (B, N, H) f32; H up to 1024 (four 256-column slices).
extern "C" int sv3d_level_fc0(const void* vol, const void* w0l, const void* q0,
                              const void* q1, const void* q2, void* out,
                              int h_dim, int accumulate, int batch, int n,
                              int c, int g0, int g1, int g2, int align_corners,
                              float disp, void* stream) {
  const Level L{g0, g1, g2, (int64_t)g0 * g1 * g2, c, align_corners, disp};
  if (h_dim < 1 || h_dim > 1024 || c < 1 || c >= (1 << 19) ||
      L.gsize * c >= (int64_t{1} << 31))
    return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)batch * n;
  if (total <= 0) return (int)cudaGetLastError();
  const cudaError_t err = cudaFuncSetAttribute(
      level_fc0_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Fc0Smem::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(blocks_for(total, Fc0Smem::kM), (unsigned)((h_dim + kFc0H - 1) / kFc0H));
  level_fc0_kernel<<<grid, Fc0Smem::NT, Fc0Smem::kBytes, (cudaStream_t)stream>>>(
      (const float*)vol, (const float*)w0l, (const float*)q0, (const float*)q1, (const float*)q2,
      (float*)out, batch, n, L, h_dim, accumulate);
  return (int)cudaGetLastError();
}

// K6 bf16: vol the channels-last (B, G, C) bf16 level, w0f the level's fc0
// block (H, K) in mma fragment order (K = 7C, or 16 with the 7 copies packed
// for C = 1), out (B, N, H) f32.
extern "C" int sv3d_level_fc0_bf16(const void* vol, const void* w0f, const void* q0,
                                   const void* q1, const void* q2, void* out, int h_dim,
                                   int accumulate, int batch, int n, int c, int g0, int g1,
                                   int g2, int align_corners, float disp, void* stream) {
  const Level L{g0, g1, g2, (int64_t)g0 * g1 * g2, c, align_corners, disp};
  if (!(c == 1 || (c % 16 == 0 && c <= 128)) || L.gsize * c >= (int64_t{1} << 31) ||
      (uintptr_t)vol % 16 != 0 || (uintptr_t)w0f % 16 != 0 || (uintptr_t)out % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)batch * n <= 0) return (int)cudaGetLastError();
  const auto s = (cudaStream_t)stream;
  if (h_dim == 256)
    return launch_fc0_bf16<8>(vol, w0f, q0, q1, q2, out, batch, n, L, accumulate, s);
  if (h_dim == 512)
    return launch_fc0_bf16<16>(vol, w0f, q0, q1, q2, out, batch, n, L, accumulate, s);
  return (int)cudaErrorInvalidValue;
}

// K7 on a channels-last (B, G, C) level.
extern "C" int sv3d_level_grad_points(const void* vol, const void* q0,
                                      const void* q1, const void* q2,
                                      const void* g, void* out, int batch,
                                      int n, int c, int g0, int g1, int g2,
                                      int align_corners, float disp,
                                      void* stream) {
  const Level L{g0, g1, g2, (int64_t)g0 * g1 * g2, c, align_corners, disp};
  if (L.gsize * c >= (int64_t{1} << 31)) return (int)cudaErrorInvalidValue;
  if ((int64_t)batch * n > 0) {
    const bool vec = c % 4 == 0 && (uintptr_t)vol % 16 == 0 && (uintptr_t)g % 16 == 0;
    const float* args[] = {(const float*)vol, (const float*)q0, (const float*)q1,
                           (const float*)q2, (const float*)g};
    if (vec) {
      launch_grad_points<float4>(lanes_for(c / 4), args, (float*)out, batch, n, L,
                                 (cudaStream_t)stream);
    } else {
      launch_grad_points<float>(lanes_for(c), args, (float*)out, batch, n, L,
                                (cudaStream_t)stream);
    }
  }
  return (int)cudaGetLastError();
}

// K8 into a zeroed channels-last (B, G, C) gradient.
extern "C" int sv3d_level_grad_vol(const void* q0, const void* q1, const void* q2,
                                   const void* g, void* gvol, int batch, int n, int c, int g0,
                                   int g1, int g2, int align_corners, float disp, void* stream) {
  const Level L{g0, g1, g2, (int64_t)g0 * g1 * g2, c, align_corners, disp};
  if (L.gsize * c >= (int64_t{1} << 31)) return (int)cudaErrorInvalidValue;
  if ((int64_t)batch * n <= 0) return (int)cudaGetLastError();
  const auto s = (cudaStream_t)stream;
  const float *a0 = (const float*)q0, *a1 = (const float*)q1, *a2 = (const float*)q2,
              *ag = (const float*)g;
  float* out = (float*)gvol;
  const bool vec = c % 4 == 0 && (uintptr_t)g % 16 == 0 && (uintptr_t)gvol % 16 == 0;
  if (vec) {
    launch_grad_vol<float4>(lanes_for(c / 4), a0, a1, a2, ag, out, batch, n, L, s);
  } else {
    launch_grad_vol<float>(lanes_for(c), a0, a1, a2, ag, out, batch, n, L, s);
  }
  return (int)cudaGetLastError();
}
