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
// level is the port's channel-major flat (B, C, G0*G1*G2) f32; coordinates are
// three (B, N) f32 arrays in [-1, 1]; copy d of point n samples at
// p + s_d * disp on one axis (order center, -0, +0, -1, +1, -2, +2); features
// are (B, N, 7*C), index d*C + c; out-of-range corners weigh 0 (torch
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
// Thread mapping, shared by the three kernels: lanes go to (point, channel)
// pairs.  A group of L = min(32, next power of two >= C) lanes owns one point
// (B*N points in all) and strides over its channels, so C = 1 gives one point
// per lane, C = 16 two points per warp, C >= 32 one point per warp.  Each lane
// recomputes the point's 8 corner indices and weights per copy (a few dozen
// ALU operations, no memory).  The level stays channel-major: a transpose to
// channels-last would cost a full pass over every level per step (the finest
// level is 104 MB a sample at full dims) for reads that are scattered gathers
// anyway.  Lanes of one group read vol[c, corner] at a stride of G: each read
// is its own 32-byte sector, which bounds all three kernels by gather
// latency and sector traffic, not by arithmetic.  Writes of K4 (d*C + c) and
// reads of g in K7/K8 are contiguous across a group's lanes.
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
// (B, N, 7C) bf16, so it is bound by the same gathers as K4 plus half of K4's
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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void level_features_kernel(const float* __restrict__ vol,
                                      const float* __restrict__ q0,
                                      const float* __restrict__ q1,
                                      const float* __restrict__ q2,
                                      OutT* __restrict__ out, int batch, int n,
                                      Level L, int lanes) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t pt = t / lanes;
  if (pt >= (int64_t)batch * n) return;
  const int lane = (int)(t % lanes);
  const int b = (int)(pt / n);
  const float p0 = q0[pt], p1 = q1[pt], p2 = q2[pt];
  const float* v = vol + (int64_t)b * L.c * L.gsize;
  OutT* o = out + pt * 7 * L.c;
  Corners k;
  for (int d = 0; d < 7; ++d) {
    corners(L, p0, p1, p2, d, k);
    for (int c = lane; c < L.c; c += lanes) {
      const float* vc = v + (int64_t)c * L.gsize;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc += k.w[j] * vc[k.lin[j]];
      store(o + d * L.c + c, acc);
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

constexpr int kThreads = 256;

}  // namespace

extern "C" int sv3d_level_features(const void* vol, const void* q0,
                                   const void* q1, const void* q2, void* out,
                                   int batch, int n, int c, int g0, int g1,
                                   int g2, int align_corners, float disp,
                                   void* stream) {
  const Level L{g0, g1, g2, (int64_t)g0 * g1 * g2, c, align_corners, disp};
  const int lanes = lanes_for(c);
  const int64_t total = (int64_t)batch * n * lanes;
  if (total > 0) {
    level_features_kernel<float><<<blocks_for(total, kThreads), kThreads, 0,
                                   (cudaStream_t)stream>>>(
        (const float*)vol, (const float*)q0, (const float*)q1, (const float*)q2,
        (float*)out, batch, n, L, lanes);
  }
  return (int)cudaGetLastError();
}

extern "C" int sv3d_level_features_bf16(const void* vol, const void* q0,
                                        const void* q1, const void* q2,
                                        void* out, int batch, int n, int c,
                                        int g0, int g1, int g2,
                                        int align_corners, float disp,
                                        void* stream) {
  const Level L{g0, g1, g2, (int64_t)g0 * g1 * g2, c, align_corners, disp};
  const int lanes = lanes_for(c);
  const int64_t total = (int64_t)batch * n * lanes;
  if (total > 0) {
    level_features_kernel<__nv_bfloat16><<<blocks_for(total, kThreads), kThreads,
                                           0, (cudaStream_t)stream>>>(
        (const float*)vol, (const float*)q0, (const float*)q1, (const float*)q2,
        (__nv_bfloat16*)out, batch, n, L, lanes);
  }
  return (int)cudaGetLastError();
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
