// Trilinear point-cloud scatter (voxelization) for Hopper, and its backward.
// lo / hi are the border bounds -0.5+eps / 0.5-eps, rounded to f32 on the host
// exactly as the plain version's comparisons round them.
//
// --- K1, the forward (sv3d_scatter_voxels) ---
//
// Replaces the TPU kernel sv3d_tpu/ops/pallas/voxelize.py::_scatter_pallas_raw
// (public scatter_voxels_pallas).  Same function: each normed point p in
// (-0.5+eps, 0.5-eps)^3 adds its trilinear weights to the 8 voxels around
// ix = (p + 0.5) * (d - 1); points outside are dropped; the grid is clamped
// to [0, 1] after.  One C call enqueues the whole of it on the caller's
// stream into one buffer: cudaMemsetAsync zeroes the grid, the scatter adds,
// clamp_unit_kernel clamps it in place (float4), unless the caller asks for
// the raw sums.
//
// Bound on the H100: the memory latency of the scattered read-modify-writes,
// plus the zeroing and the clamp of the grid (139 x 104 x 112 f32 = 6.48 MB a
// sample, written by the memset, read and written by the clamp; it stays in
// the 50 MB L2).  One thread per point adds 8 weights, one a corner slot.
// Consecutive points are consecutive pixels of one image row, and on a real
// depth map they land in the same voxels: the lanes of a warp that add to
// one address combine first, and only the group's lowest lane issues the
// atomic.  Within a corner slot two lanes share an address exactly when they
// share the base voxel floor(ix), so one __match_any_sync on the base voxel
// groups the lanes for all 8 slots; a shuffle tree sums each slot's weights
// over the group (sum_over_peers).  Counted on the host at 76,800 points an
// image (chip_smoke.py::k1_atomics), 614,400 atomics fall to 203,040 on the
// box-before-a-wall depth of write_smoke_dataset, 144,000 on a plane at
// 3 m, and 602,464 on a uniform random depth per pixel, which has no
// spatial coherence.  On the H100 the kernel alone took 4.5 us on the box depth
// against 10.7 us on the random one (PERF.md).
//
// The TPU design (slab bucketing of the points, a banded W^T H2 MXU
// contraction per tile, an XLA fold of the overlapping slab windows) exists
// because the TPU has no fast scattered atomics and its matrix unit wants
// dense tiles; on the H100 the atomics resolve in L2, so none of it is
// carried over.
//
// Determinism: atomics make the f32 summation order vary from run to run.
// A voxel summing k contributions differs between two orders by at most
// ~2 k 2^-24 of its value; after the [0, 1] clamp the grid is held to the
// plain torch scatter at atol 1e-5 (chip_smoke.py), the raw sums at that
// bound relative to the largest sum.
//
// --- K1b, the backward (sv3d_scatter_voxels_bwd) ---
//
// Replaces sv3d_tpu/ops/pallas/voxelize.py::_scatter_bwd (the XLA custom-VJP
// backward of scatter_voxels_pallas): the gradient of clamp(raw grid, 0, 1)
// in the points.  The clamp passes the gradient where 0 < raw < 1, which
// holds exactly where 0 < clamp(raw, 0, 1) < 1, so the kernel reads the mask
// from the clamped grid that autograd keeps anyway (the raw grid is not
// kept).  One thread per point recomputes the border mask, floor and frac,
// issues all 16 corner loads (8 of the clamped grid, 8 of the cotangent)
// before it uses any, so one round of memory latency serves a point, and
// writes d/dp = sum of g * (+-(d-1) on the axis, the other two weights) as
// (B, N, 3).  A pure gather: no atomics, deterministic.  Bound by the
// latency of those scattered reads; both grids sit in L2 right after the
// blur's backward wrote the cotangent.  The cotangent arrives from the blur's
// einsum backward with its batch and axis-0 strides swapped, so the kernel
// takes its four strides instead of the wrapper copying it.  K4's template
// (8 lanes a point, lane j on corner j, a shuffle sum) was timed against
// this design on the H100 and lost on the coherent box depth, 20.2 us
// against 9.8 us, though it won on the random one, 23.6 us against 30.8
// (PERF.md); depths that users send are coherent.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// Sum w[0..7] over the lanes of `peers` (a __match_any_sync group that holds
// the calling lane); the sums land in the group's lowest lane, the other
// lanes keep partial sums.  A tree over the group's ranks: in each round a
// lane adds the partial of the next remaining peer above it, and the lanes
// of odd rank drop out.  Every lane of the warp must call it.
__device__ __forceinline__ void sum_over_peers(unsigned peers, float (&w)[8]) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & ~((2u << lane) - 1u);  // 2u << 31 wraps to 0
  while (__any_sync(kFullMask, above != 0u)) {
    const int next = __ffs(above);  // 1-based; 0: no peer above
    const int src = next ? next - 1 : lane;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float t = __shfl_sync(kFullMask, w[c], src);
      if (next) w[c] += t;
    }
    above &= ~__ballot_sync(kFullMask, rank & 1);
    rank >>= 1;
  }
}

__global__ void scatter_voxels_kernel(const float* __restrict__ points,
                                      float* __restrict__ grid, int batch,
                                      int n, int d0, int d1, int d2,
                                      float lo, float hi) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // No early return: every lane reaches the warp collectives.  A tail lane
  // or a dropped point carries the key -1 and adds nothing.
  long long key = -1;  // the base voxel, linear over the batch's grids
  int i0 = 0, i1 = 0, i2 = 0;
  float w[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) w[c] = 0.0f;
  if (idx < (int64_t)batch * n) {
    const int b = (int)(idx / n);
    const float* p = points + idx * 3;
    const float p0 = p[0], p1 = p[1], p2 = p[2];
    if (p0 > lo && p0 < hi && p1 > lo && p1 < hi && p2 > lo && p2 < hi) {
      const float g0 = (p0 + 0.5f) * (d0 - 1.0f);
      const float g1 = (p1 + 0.5f) * (d1 - 1.0f);
      const float g2 = (p2 + 0.5f) * (d2 - 1.0f);
      const float fl0 = floorf(g0), fl1 = floorf(g1), fl2 = floorf(g2);
      i0 = (int)fl0;
      i1 = (int)fl1;
      i2 = (int)fl2;
      const float f0 = g0 - fl0, f1 = g1 - fl1, f2 = g2 - fl2;
      // the border drop keeps the base voxel inside the grid; the test
      // only keeps the key unique (one voxel) in a rounding edge case
      if (i0 >= 0 && i0 < d0 && i1 >= 0 && i1 < d1 && i2 >= 0 && i2 < d2)
        key = (((long long)b * d0 + i0) * d1 + i1) * d2 + i2;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float w0 = (c & 4) ? f0 : 1.0f - f0;
        const float w01 = w0 * ((c & 2) ? f1 : 1.0f - f1);
        w[c] = w01 * ((c & 1) ? f2 : 1.0f - f2);
      }
    }
  }
  const unsigned peers = __match_any_sync(kFullMask, key);
  sum_over_peers(peers, w);
  if (key < 0 || (threadIdx.x & 31) != __ffs(peers) - 1) return;
  float* base = grid + key;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int a = i0 + (c >> 2), bb = i1 + ((c >> 1) & 1), k = i2 + (c & 1);
    // a base voxel on the grid's last plane (a rounding edge case only)
    if (a >= d0 || bb >= d1 || k >= d2) continue;
    atomicAdd(base + ((int64_t)(c >> 2) * d1 + ((c >> 1) & 1)) * d2 + (c & 1), w[c]);
  }
}

// clamp(x, 0, 1) in place over n floats; the grid's base is 16-byte aligned
// (a torch allocation), so the first n / 4 * 4 go as float4.
__global__ void clamp_unit_kernel(float* __restrict__ grid, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n4 = n / 4;
  if (i < n4) {
    float4 v = reinterpret_cast<float4*>(grid)[i];
    v.x = fminf(fmaxf(v.x, 0.0f), 1.0f);
    v.y = fminf(fmaxf(v.y, 0.0f), 1.0f);
    v.z = fminf(fmaxf(v.z, 0.0f), 1.0f);
    v.w = fminf(fmaxf(v.w, 0.0f), 1.0f);
    reinterpret_cast<float4*>(grid)[i] = v;
  } else if (i < n4 + n % 4) {
    float* x = grid + 4 * n4 + (i - n4);
    *x = fminf(fmaxf(*x, 0.0f), 1.0f);
  }
}

__global__ void scatter_voxels_bwd_kernel(const float* __restrict__ points,
                                          const float* __restrict__ clamped,
                                          const float* __restrict__ grad,
                                          float* __restrict__ out, int batch,
                                          int n, int d0, int d1, int d2,
                                          int64_t gsb, int64_t gs0,
                                          int64_t gs1, int64_t gs2, float lo,
                                          float hi) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)batch * n) return;
  const int b = (int)(idx / n);
  const float* p = points + idx * 3;
  float* o = out + idx * 3;
  const float p0 = p[0], p1 = p[1], p2 = p[2];
  if (!(p0 > lo && p0 < hi && p1 > lo && p1 < hi && p2 > lo && p2 < hi)) {
    o[0] = 0.0f;
    o[1] = 0.0f;
    o[2] = 0.0f;
    return;
  }
  const float s0 = d0 - 1.0f, s1 = d1 - 1.0f, s2 = d2 - 1.0f;
  const float g0 = __fmul_rn(__fadd_rn(p0, 0.5f), s0);
  const float g1 = __fmul_rn(__fadd_rn(p1, 0.5f), s1);
  const float g2 = __fmul_rn(__fadd_rn(p2, 0.5f), s2);
  const float fl0 = floorf(g0), fl1 = floorf(g1), fl2 = floorf(g2);
  const int i0 = (int)fl0, i1 = (int)fl1, i2 = (int)fl2;
  const float f0 = g0 - fl0, f1 = g1 - fl1, f2 = g2 - fl2;
  const float* cb = clamped + (int64_t)b * d0 * d1 * d2;
  const float* gb = grad + b * gsb;

  float cv[8], gv[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int a = i0 + (c >> 2), bb = i1 + ((c >> 1) & 1), k = i2 + (c & 1);
    // the forward dropped such corners (a rounding edge case only)
    const bool in = a >= 0 && a < d0 && bb >= 0 && bb < d1 && k >= 0 && k < d2;
    cv[c] = in ? __ldg(cb + ((int64_t)a * d1 + bb) * d2 + k) : 0.0f;
    gv[c] = in ? __ldg(gb + a * gs0 + bb * gs1 + k * gs2) : 0.0f;
  }
  float gp0 = 0.0f, gp1 = 0.0f, gp2 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w0 = (c & 4) ? f0 : 1.0f - f0, dw0 = (c & 4) ? s0 : -s0;
    const float w1 = (c & 2) ? f1 : 1.0f - f1, dw1 = (c & 2) ? s1 : -s1;
    const float w2 = (c & 1) ? f2 : 1.0f - f2, dw2 = (c & 1) ? s2 : -s2;
    const float g = (cv[c] > 0.0f && cv[c] < 1.0f) ? gv[c] : 0.0f;
    gp0 += g * dw0 * w1 * w2;
    gp1 += g * w0 * dw1 * w2;
    gp2 += g * w0 * w1 * dw2;
  }
  o[0] = gp0;
  o[1] = gp1;
  o[2] = gp2;
}

}  // namespace

extern "C" int sv3d_scatter_voxels(const void* points, void* grid, int batch,
                                   int n, int d0, int d1, int d2, float lo,
                                   float hi, int clamp, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t cells = (int64_t)batch * d0 * d1 * d2;
  cudaError_t err = cudaMemsetAsync(grid, 0, (size_t)cells * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const int64_t total = (int64_t)batch * n;
  if (total > 0) {
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    scatter_voxels_kernel<<<blocks, threads, 0, s>>>(
        (const float*)points, (float*)grid, batch, n, d0, d1, d2, lo, hi);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (clamp && cells > 0) {
    const int64_t work = cells / 4 + cells % 4;
    const unsigned blocks = (unsigned)((work + threads - 1) / threads);
    clamp_unit_kernel<<<blocks, threads, 0, s>>>((float*)grid, cells);
  }
  return (int)cudaGetLastError();
}

extern "C" int sv3d_scatter_voxels_bwd(const void* points, const void* clamped,
                                       const void* grad, void* out, int batch,
                                       int n, int d0, int d1, int d2,
                                       long long gsb, long long gs0,
                                       long long gs1, long long gs2, float lo,
                                       float hi, void* stream) {
  const int64_t total = (int64_t)batch * n;
  if (total > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    scatter_voxels_bwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)points, (const float*)clamped, (const float*)grad,
        (float*)out, batch, n, d0, d1, d2, gsb, gs0, gs1, gs2, lo, hi);
  }
  return (int)cudaGetLastError();
}
