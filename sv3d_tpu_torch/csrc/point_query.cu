// Fused IF-Net point query for Hopper: one pyramid level's trilinear features
// at the 7 displaced copies of arbitrary query points, both halves of its
// backward, and the inference-only variants.
//
//   K4 level_features_kernel<float>  replaces sv3d_tpu/ops/pallas/point_query.py::level_features
//   K5 level_features_kernel<bf16>   replaces sv3d_tpu/ops/pallas/point_query.py::level_features_banded
//   K6 level_fc0_kernel              replaces sv3d_tpu/ops/pallas/point_query.py::level_fc0_banded
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
// ported.  Here every (point, channel) reads its 8 corners directly, in f32,
// so the port's fused path is as exact as the gather path (the JAX fused path
// is bf16 with f32 accumulation).
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
// K7, K8 and K6 read the channel-major flat as it is.  Their thread mapping:
// lanes go to (point, channel) pairs.  A group of L = min(32, next power of
// two >= C) lanes owns one point (B*N points in all) and strides over its
// channels, so C = 1 gives one point per lane, C = 16 two points per warp,
// C >= 32 one point per warp.  Each lane recomputes the point's 8 corner
// indices and weights per copy.  Lanes of one group read vol[c, corner] at a
// stride of G: each read is its own 32-byte sector, which bounds these
// kernels by gather latency and sector traffic, not by arithmetic.  Reads of
// g in K7/K8 are contiguous across a group's lanes.
//
// K7 sums g[d, c] * vol[c, corner] * dw/dix over 7 copies x 8 corners x the
// lane's channels, reduces the group with shuffles (the tail of the last warp
// joins with zeros), and scales by dix/dp: (G-1)/2 with align_corners, G/2
// without.  Derivative convention: the floor/frac one of the plain version's
// autograd (d frac / d ix = 1; +1 at integer ix, where the JAX kernel's _dhat
// gives 0 -- a set of measure zero).  Deterministic.
//
// K8 adds g[d, c] * w_corner into a zeroed (B, C, G) gradient with atomicAdd.
// Atomics sum in a run-dependent order: a voxel that k (point, copy) pairs
// touch differs between orders by about k * 2^-24 of its magnitude, so the
// kernel is held to its plain version at 1e-5 relative to the gradient's
// largest magnitude (chip_smoke.py, tests/test_torch_cuda.py).
//
// K5 is K4 with its features stored as bf16 (round to nearest even), the
// output type of the TPU's 2-D (slab, band) bucketed kernel; the bucketing
// itself, and with it the band count, has no counterpart here.  It writes
// (B, N, 7C) bf16, so it moves the same gathers as K4 and half of K4's
// output bytes.  No port path calls it (as in the JAX package).
//
// K6 is K4 with the level's block of fc0 contracted in the kernel: out[b, n, h]
// = sum_{d, c} feat[b, n, d*C + c] * w0l[d*C + c, h], feat being K4's exact
// f32 features, so the (B, N, 7C) features never reach device memory (what
// the TPU kernel keeps out of HBM).  A block owns kFc0Points consecutive
// points and all H outputs, one thread per h, a register accumulator per
// point.  Per displacement, the first warp computes the points' 8 corners
// (K4's arithmetic) into shared memory; the block gathers the (C, T)
// features of that copy into shared memory, kFc0Chans channels a round; then
// every thread contracts them with rows d*C + c of w0l, read coalesced along
// h, the feature reads being shared-memory broadcasts.  It does 2 * 7C * H
// flop per point in f32 FMA (no tensor cores yet): at H = 256 and the six
// net_res-128 levels that is 1.3 MFLOP a point, so it is bound by the card's
// f32 rate, not by its bytes.  With accumulate set it adds into out, so the
// caller sums the six levels' partials in one (B, N, H) buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

struct Corners {
  int64_t lin[8];
  float w[8];       // trilinear weight, 0 when the corner is out of range
  float dw[8][3];   // d w / d ix per axis, 0 when out of range
};

__device__ __forceinline__ void corners(const Level& L, float p0, float p1,
                                        float p2, int d, Corners& k) {
  int i0, i1, i2;
  float f0, f1, f2;
  axis_tap(p0, kDisp[d][0], L.disp, L.g0, L.ac, i0, f0);
  axis_tap(p1, kDisp[d][1], L.disp, L.g1, L.ac, i1, f1);
  axis_tap(p2, kDisp[d][2], L.disp, L.g2, L.ac, i2, f2);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c0 = j >> 2, c1 = (j >> 1) & 1, c2 = j & 1;
    const int a = i0 + c0, b = i1 + c1, e = i2 + c2;
    const bool valid = a >= 0 && a < L.g0 && b >= 0 && b < L.g1 && e >= 0 && e < L.g2;
    const float w0 = c0 ? f0 : 1.0f - f0;
    const float w1 = c1 ? f1 : 1.0f - f1;
    const float w2 = c2 ? f2 : 1.0f - f2;
    k.lin[j] = valid ? ((int64_t)a * L.g1 + b) * L.g2 + e : 0;
    k.w[j] = valid ? w0 * w1 * w2 : 0.0f;
    k.dw[j][0] = valid ? (c0 ? 1.0f : -1.0f) * w1 * w2 : 0.0f;
    k.dw[j][1] = valid ? w0 * (c1 ? 1.0f : -1.0f) * w2 : 0.0f;
    k.dw[j][2] = valid ? w0 * w1 * (c2 ? 1.0f : -1.0f) : 0.0f;
  }
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
__device__ __forceinline__ void zero(float& v) { v = 0.0f; }
__device__ __forceinline__ void zero(float4& v) { v = make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ void fma_into(float w, float v, float& acc) { acc = fmaf(w, v, acc); }
__device__ __forceinline__ void fma_into(float w, const float4& v, float4& acc) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
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

// VecT float4: a lane takes 4 consecutive channels (C % 4 == 0, 16-byte
// aligned level and output); float: one channel.  kLanes lanes own a point.
template <typename OutT, typename VecT, int kLanes>
__global__ void __launch_bounds__(kThreads, 4)
level_features_kernel(const float* __restrict__ vol, const float* __restrict__ q0,
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
  const float* v = vol + (int64_t)b * L.gsize * L.c;
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
      const float* vc = v + (ck < chunks ? ck : 0) * kW;  // the tail re-reads chunk 0
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

__global__ void level_grad_points_kernel(const float* __restrict__ vol,
                                         const float* __restrict__ q0,
                                         const float* __restrict__ q1,
                                         const float* __restrict__ q2,
                                         const float* __restrict__ g,
                                         float* __restrict__ out, int batch,
                                         int n, Level L, int lanes) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t pt = t / lanes;
  const bool active = pt < (int64_t)batch * n;
  const int lane = (int)(t % lanes);
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  if (active) {
    const int b = (int)(pt / n);
    const float p0 = q0[pt], p1 = q1[pt], p2 = q2[pt];
    const float* v = vol + (int64_t)b * L.c * L.gsize;
    const float* gp = g + pt * 7 * L.c;
    Corners k;
    for (int d = 0; d < 7; ++d) {
      corners(L, p0, p1, p2, d, k);
      for (int c = lane; c < L.c; c += lanes) {
        const float* vc = v + (int64_t)c * L.gsize;
        const float gd = gp[d * L.c + c];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float common = gd * vc[k.lin[j]];
          s0 += common * k.dw[j][0];
          s1 += common * k.dw[j][1];
          s2 += common * k.dw[j][2];
        }
      }
    }
  }
  // reduce within the lane group (groups are aligned, power-of-two wide)
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, off);
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
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

__global__ void level_grad_vol_kernel(const float* __restrict__ q0,
                                      const float* __restrict__ q1,
                                      const float* __restrict__ q2,
                                      const float* __restrict__ g,
                                      float* __restrict__ gvol, int batch, int n,
                                      Level L, int lanes) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t pt = t / lanes;
  if (pt >= (int64_t)batch * n) return;
  const int lane = (int)(t % lanes);
  const int b = (int)(pt / n);
  const float p0 = q0[pt], p1 = q1[pt], p2 = q2[pt];
  float* gv = gvol + (int64_t)b * L.c * L.gsize;
  const float* gp = g + pt * 7 * L.c;
  Corners k;
  for (int d = 0; d < 7; ++d) {
    corners(L, p0, p1, p2, d, k);
    for (int c = lane; c < L.c; c += lanes) {
      float* gc = gv + (int64_t)c * L.gsize;
      const float gd = gp[d * L.c + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (k.w[j] != 0.0f) atomicAdd(gc + k.lin[j], k.w[j] * gd);
      }
    }
  }
}

constexpr int kFc0Points = 32;  // points per block (register accumulators)
constexpr int kFc0Chans = 128;  // channels gathered per shared-memory round

// K6: blockDim.x >= h_dim threads; thread h owns output column h for the
// block's kFc0Points points (of the B*N flattened).
__global__ void level_fc0_kernel(const float* __restrict__ vol,
                                 const float* __restrict__ w0l,
                                 const float* __restrict__ q0,
                                 const float* __restrict__ q1,
                                 const float* __restrict__ q2,
                                 float* __restrict__ out, int batch, int n,
                                 Level L, int h_dim, int accumulate) {
  __shared__ __align__(16) float feat[kFc0Chans][kFc0Points];
  __shared__ int64_t lin[kFc0Points][8];
  __shared__ float wt[kFc0Points][8];
  __shared__ int64_t base[kFc0Points];
  const int h = threadIdx.x;
  const int64_t total = (int64_t)batch * n;
  const int64_t pt0 = (int64_t)blockIdx.x * kFc0Points;
  float acc[kFc0Points];
#pragma unroll
  for (int t = 0; t < kFc0Points; ++t) acc[t] = 0.0f;

  for (int d = 0; d < 7; ++d) {
    // corners of copy d (the previous copy's gathers are done: every thread
    // passed the barrier before its contraction)
    if (threadIdx.x < kFc0Points) {
      const int t = threadIdx.x;
      const int64_t pt = pt0 + t;
      if (pt < total) {
        Corners k;
        corners(L, q0[pt], q1[pt], q2[pt], d, k);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          lin[t][j] = k.lin[j];
          wt[t][j] = k.w[j];
        }
        base[t] = (pt / n) * L.c * L.gsize;
      } else {  // padding lanes read voxel 0 with weight 0
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          lin[t][j] = 0;
          wt[t][j] = 0.0f;
        }
        base[t] = 0;
      }
    }
    for (int c0 = 0; c0 < L.c; c0 += kFc0Chans) {
      const int cc = min(kFc0Chans, L.c - c0);
      __syncthreads();  // corners written; the previous round's readers done
      for (int i = threadIdx.x; i < cc * kFc0Points; i += blockDim.x) {
        const int c = i / kFc0Points, t = i % kFc0Points;
        const float* vc = vol + base[t] + (int64_t)(c0 + c) * L.gsize;
        float v = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) v += wt[t][j] * vc[lin[t][j]];
        feat[c][t] = v;
      }
      __syncthreads();
      if (h < h_dim) {
        const float* wrow = w0l + ((int64_t)d * L.c + c0) * h_dim + h;
        for (int c = 0; c < cc; ++c) {
          const float w = wrow[(int64_t)c * h_dim];
#pragma unroll
          for (int t = 0; t < kFc0Points; ++t) acc[t] = fmaf(feat[c][t], w, acc[t]);
        }
      }
    }
  }
  if (h < h_dim) {
#pragma unroll
    for (int t = 0; t < kFc0Points; ++t) {
      const int64_t pt = pt0 + t;
      if (pt < total) {
        float* o = out + pt * h_dim + h;
        *o = accumulate ? *o + acc[t] : acc[t];
      }
    }
  }
}

int lanes_for(int c) {
  int l = 1;
  while (l < c && l < 32) l <<= 1;
  return l;
}

unsigned blocks_for(int64_t threads_total, int threads) {
  return (unsigned)((threads_total + threads - 1) / threads);
}

template <typename OutT, typename VecT>
void launch_features(int lanes, const float* vol, const float* q0, const float* q1,
                     const float* q2, OutT* out, int batch, int n, const Level& L,
                     cudaStream_t stream) {
  auto kernel = level_features_kernel<OutT, VecT, 32>;
  switch (lanes) {
    case 1: kernel = level_features_kernel<OutT, VecT, 1>; break;
    case 2: kernel = level_features_kernel<OutT, VecT, 2>; break;
    case 4: kernel = level_features_kernel<OutT, VecT, 4>; break;
    case 8: kernel = level_features_kernel<OutT, VecT, 8>; break;
    case 16: kernel = level_features_kernel<OutT, VecT, 16>; break;
    default: break;
  }
  kernel<<<blocks_for((int64_t)batch * n * lanes, kThreads), kThreads, 0, stream>>>(
      vol, q0, q1, q2, out, batch, n, L);
}

// K4 (OutT float) and K5 (bf16) on a channels-last (B, G, C) level.
template <typename OutT>
int level_features_entry(const void* vol, const void* q0, const void* q1,
                         const void* q2, void* out, int batch, int n, int c,
                         int g0, int g1, int g2, int align_corners, float disp,
                         void* stream) {
  const Level L{g0, g1, g2, (int64_t)g0 * g1 * g2, c, align_corners, disp};
  if (L.gsize * c >= (int64_t{1} << 31)) return (int)cudaErrorInvalidValue;
  if ((int64_t)batch * n > 0) {
    const bool vec = c % 4 == 0 && (uintptr_t)vol % 16 == 0 &&
                     (uintptr_t)out % (4 * sizeof(OutT)) == 0;
    if (vec) {
      launch_features<OutT, float4>(lanes_for(c / 4), (const float*)vol, (const float*)q0,
                                    (const float*)q1, (const float*)q2, (OutT*)out, batch,
                                    n, L, (cudaStream_t)stream);
    } else {
      launch_features<OutT, float>(lanes_for(c), (const float*)vol, (const float*)q0,
                                   (const float*)q1, (const float*)q2, (OutT*)out, batch, n,
                                   L, (cudaStream_t)stream);
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
  return level_features_entry<float>(vol, q0, q1, q2, out, batch, n, c, g0, g1, g2,
                                     align_corners, disp, stream);
}

extern "C" int sv3d_level_features_bf16(const void* vol, const void* q0,
                                        const void* q1, const void* q2,
                                        void* out, int batch, int n, int c,
                                        int g0, int g1, int g2,
                                        int align_corners, float disp,
                                        void* stream) {
  return level_features_entry<__nv_bfloat16>(vol, q0, q1, q2, out, batch, n, c, g0, g1,
                                             g2, align_corners, disp, stream);
}

extern "C" int sv3d_level_fc0(const void* vol, const void* w0l, const void* q0,
                              const void* q1, const void* q2, void* out,
                              int h_dim, int accumulate, int batch, int n,
                              int c, int g0, int g1, int g2, int align_corners,
                              float disp, void* stream) {
  if (h_dim < 1 || h_dim > 1024) return (int)cudaErrorInvalidValue;
  const Level L{g0, g1, g2, (int64_t)g0 * g1 * g2, c, align_corners, disp};
  const int64_t total = (int64_t)batch * n;
  if (total > 0) {
    // whole warps, and at least one warp for the corner pass
    const int threads = (h_dim + 31) / 32 * 32;
    level_fc0_kernel<<<blocks_for(total, kFc0Points), threads, 0,
                       (cudaStream_t)stream>>>(
        (const float*)vol, (const float*)w0l, (const float*)q0,
        (const float*)q1, (const float*)q2, (float*)out, batch, n, L, h_dim,
        accumulate);
  }
  return (int)cudaGetLastError();
}

extern "C" int sv3d_level_grad_points(const void* vol, const void* q0,
                                      const void* q1, const void* q2,
                                      const void* g, void* out, int batch,
                                      int n, int c, int g0, int g1, int g2,
                                      int align_corners, float disp,
                                      void* stream) {
  const Level L{g0, g1, g2, (int64_t)g0 * g1 * g2, c, align_corners, disp};
  const int lanes = lanes_for(c);
  // whole warps, so every lane of a warp reaches the shuffles
  const int64_t total = ((int64_t)batch * n * lanes + 31) / 32 * 32;
  if (total > 0) {
    level_grad_points_kernel<<<blocks_for(total, kThreads), kThreads, 0,
                               (cudaStream_t)stream>>>(
        (const float*)vol, (const float*)q0, (const float*)q1, (const float*)q2,
        (const float*)g, (float*)out, batch, n, L, lanes);
  }
  return (int)cudaGetLastError();
}

extern "C" int sv3d_level_grad_vol(const void* q0, const void* q1,
                                   const void* q2, const void* g, void* gvol,
                                   int batch, int n, int c, int g0, int g1,
                                   int g2, int align_corners, float disp,
                                   void* stream) {
  const Level L{g0, g1, g2, (int64_t)g0 * g1 * g2, c, align_corners, disp};
  const int lanes = lanes_for(c);
  const int64_t total = (int64_t)batch * n * lanes;
  if (total > 0) {
    level_grad_vol_kernel<<<blocks_for(total, kThreads), kThreads, 0,
                            (cudaStream_t)stream>>>(
        (const float*)q0, (const float*)q1, (const float*)q2, (const float*)g,
        (float*)gvol, batch, n, L, lanes);
  }
  return (int)cudaGetLastError();
}
