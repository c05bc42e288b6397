// Trilinear point-cloud scatter (voxelization) for Hopper, and its backward.
// lo / hi are the border bounds -0.5+eps / 0.5-eps, rounded to f32 on the host
// exactly as the plain version's comparisons round them.
//
// --- K1, the forward (scatter_voxels_kernel) ---
//
// Replaces the TPU kernel sv3d_tpu/ops/pallas/voxelize.py::_scatter_pallas_raw
// (public scatter_voxels_pallas).  Same function: each normed point p in
// (-0.5+eps, 0.5-eps)^3 adds its trilinear weights to the 8 voxels around
// ix = (p + 0.5) * (d - 1); points outside are dropped.  The wrapper zeroes
// the grid before and clamps it to [0, 1] after.
//
// Bound on the H100: memory latency of the scattered read-modify-writes.
// 76,800 points per 240x320 image make 614,400 f32 atomics into a 6.5 MB grid
// that stays in the 50 MB L2, so the kernel is a few microseconds of atomics
// and the launch dominates.  The TPU design (slab bucketing, a banded W^T H2
// MXU contraction per tile, an XLA fold of overlapping windows) exists only
// because the TPU has no fast scattered atomics; none of it is ported: one
// thread per point, eight atomicAdd(float*).
//
// Determinism: atomics make the f32 summation order vary from run to run.
// A voxel summing k contributions of weight <= 1 differs between orders by
// at most ~k * 2^-24 * sum; after the [0, 1] clamp the grid is held to the
// plain torch scatter at atol 1e-5 (chip_smoke.py), which covers k up to a
// few hundred points per voxel.
//
// --- K1b, the backward (scatter_voxels_bwd_kernel) ---
//
// Replaces sv3d_tpu/ops/pallas/voxelize.py::_scatter_bwd (the XLA custom-VJP
// backward of scatter_voxels_pallas): the gradient of clamp(raw grid, 0, 1)
// in the points.  One thread per point recomputes the border mask, floor and
// frac, gathers the incoming gradient at its 8 corners where the clamp is
// open (0 < raw < 1, strict), and writes d/dp = sum of g * (+-(d-1) on the
// axis, the other two weights) as (B, N, 3).  A pure gather: 8 reads of g and
// 8 of raw per point, no atomics, deterministic.  Bound by the latency of
// those scattered reads; the grid (6.5 MB a sample at full dims) sits in L2
// right after the forward's blur backward wrote it.  The wrapper keeps the
// raw grid of the forward (the in-place clamp of the forward-only version
// discarded it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void scatter_voxels_bwd_kernel(const float* __restrict__ points,
                                          const float* __restrict__ raw,
                                          const float* __restrict__ grad,
                                          float* __restrict__ out, int batch,
                                          int n, int d0, int d1, int d2,
                                          float lo, float hi) {
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
  const int64_t base = (int64_t)b * d0 * d1 * d2;
  float gp0 = 0.0f, gp1 = 0.0f, gp2 = 0.0f;

#pragma unroll
  for (int c0 = 0; c0 < 2; ++c0) {
    const int a = i0 + c0;
    const float w0 = c0 ? f0 : 1.0f - f0;
    const float dw0 = c0 ? s0 : -s0;
#pragma unroll
    for (int c1 = 0; c1 < 2; ++c1) {
      const int bb = i1 + c1;
      const float w1 = c1 ? f1 : 1.0f - f1;
      const float dw1 = c1 ? s1 : -s1;
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int k = i2 + c2;
        // the forward dropped such corners (a rounding edge case only)
        if (a < 0 || a >= d0 || bb < 0 || bb >= d1 || k < 0 || k >= d2) continue;
        const float w2 = c2 ? f2 : 1.0f - f2;
        const float dw2 = c2 ? s2 : -s2;
        const int64_t lin = base + ((int64_t)a * d1 + bb) * d2 + k;
        const float r = raw[lin];
        const float gv = (r > 0.0f && r < 1.0f) ? grad[lin] : 0.0f;
        gp0 += gv * dw0 * w1 * w2;
        gp1 += gv * w0 * dw1 * w2;
        gp2 += gv * w0 * w1 * dw2;
      }
    }
  }
  o[0] = gp0;
  o[1] = gp1;
  o[2] = gp2;
}

__global__ void scatter_voxels_kernel(const float* __restrict__ points,
                                      float* __restrict__ grid, int batch,
                                      int n, int d0, int d1, int d2,
                                      float lo, float hi) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)batch * n) return;
  const int b = (int)(idx / n);
  const float* p = points + idx * 3;
  const float p0 = p[0], p1 = p[1], p2 = p[2];
  if (!(p0 > lo && p0 < hi && p1 > lo && p1 < hi && p2 > lo && p2 < hi)) return;

  const float g0 = (p0 + 0.5f) * (d0 - 1.0f);
  const float g1 = (p1 + 0.5f) * (d1 - 1.0f);
  const float g2 = (p2 + 0.5f) * (d2 - 1.0f);
  const float fl0 = floorf(g0), fl1 = floorf(g1), fl2 = floorf(g2);
  const int i0 = (int)fl0, i1 = (int)fl1, i2 = (int)fl2;
  const float f0 = g0 - fl0, f1 = g1 - fl1, f2 = g2 - fl2;
  float* out = grid + (int64_t)b * d0 * d1 * d2;

#pragma unroll
  for (int c0 = 0; c0 < 2; ++c0) {
    const int a = i0 + c0;
    const float w0 = c0 ? f0 : 1.0f - f0;
#pragma unroll
    for (int c1 = 0; c1 < 2; ++c1) {
      const int bb = i1 + c1;
      const float w01 = w0 * (c1 ? f1 : 1.0f - f1);
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int k = i2 + c2;
        // the border drop keeps every corner inside the grid; the guard
        // only protects memory against a rounding edge case
        if (a < 0 || a >= d0 || bb < 0 || bb >= d1 || k < 0 || k >= d2) continue;
        const float w = w01 * (c2 ? f2 : 1.0f - f2);
        atomicAdd(out + ((int64_t)a * d1 + bb) * d2 + k, w);
      }
    }
  }
}

}  // namespace

extern "C" int sv3d_scatter_voxels(const void* points, void* grid, int batch,
                                   int n, int d0, int d1, int d2, float lo,
                                   float hi, void* stream) {
  const int64_t total = (int64_t)batch * n;
  if (total > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    scatter_voxels_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)points, (float*)grid, batch, n, d0, d1, d2, lo, hi);
  }
  return (int)cudaGetLastError();
}

extern "C" int sv3d_scatter_voxels_bwd(const void* points, const void* raw,
                                       const void* grad, void* out, int batch,
                                       int n, int d0, int d1, int d2, float lo,
                                       float hi, void* stream) {
  const int64_t total = (int64_t)batch * n;
  if (total > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    scatter_voxels_bwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)points, (const float*)raw, (const float*)grad, (float*)out,
        batch, n, d0, d1, d2, lo, hi);
  }
  return (int)cudaGetLastError();
}
