// Dense-lattice sweep for Hopper: trilinear features of the 7 displaced
// lattice copies at every pyramid level, fc0, and the IF-Net decoder MLP,
// fused per tile of lattice points.
//
// Replaces the TPU kernel sv3d_tpu/ops/pallas/sweep.py::fused_sweep_tail.  The
// contract is not that kernel's input layout (pre-resized axis-0/1 partials,
// m2 stacks, 8-channel padding) but the lattice logits of the unfused
// query_lattice math (sv3d_tpu/models/ifnet.py:648-735) for lattice rows
// [row_offset, row_offset + rows): the wrapper hands the kernel the per-axis
// 2-tap tables of the slab (ops/lattice.py::axis_taps, the nonzeros of
// interp_matrix), so out-of-range taps weigh 0 and both align_corners
// conventions are the tables' business.
//
// Design: a block owns kTile consecutive lattice points (flattened over
// (row, r1, r2), so no tile is wasted at a row's end).  For each displacement
// d (center, -d0, +d0, -d1, +d1, -d2, +d2) and level l it interpolates the
// tile's C_l features into shared memory and accumulates them straight into
// the fc0 pre-activations held in registers, h[o][t] += W0[o, d*sumC+cg+c] *
// f[c][t]; the 2583-wide feature vector is never whole anywhere.  bias+ReLU,
// fc1, fc2 and fc_out then run in the block on the hidden tile in shared
// memory.  Each thread owns 2 fc0 outputs x kTile points of accumulators, so
// one shared-memory float4 broadcast feeds 8 FMAs.
//
// Bound on the H100: f32 FMA issue.  fc0 is 2 * 2583 * 256 flop per point,
// about 2.1 Tflop for the 1.62M-point full-scale lattice (fc1 + fc2 add 0.4),
// against 67 Tflop/s of f32 FMA; fc0's weights (2.6 MB) stay in L2 and each
// block reads them once.  The feature gathers read each level's 2x2x2
// neighbourhoods through L1/L2.  Tensor cores (bf16 / TF32 wgmma) and TMA
// are later work; this kernel is plain f32 FMA and agrees with the plain
// torch version to f32 summation order.

#include <cuda_runtime.h>
#include <stdint.h>

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
                     int r1, int r2, int sum_c) {
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
    s_a[tid] = q / r1;
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
      const int e0 = m[4] + v0 * rows, e1 = m[5] + v1 * r1, e2 = m[6] + v2 * r2;

      for (int i = tid; i < C * kTile; i += NT) {
        const int c = i / kTile, t = i % kTile;
        const int ea = 2 * (e0 + s_a[t]), ex = 2 * (e1 + s_x[t]), ey = 2 * (e2 + s_y[t]);
        const float* vc = vol + c * G;
        const int k0 = __ldg(tap_idx + ey), k1 = __ldg(tap_idx + ey + 1);
        const float wk0 = __ldg(tap_w + ey), wk1 = __ldg(tap_w + ey + 1);
        float s = 0.f;
#pragma unroll
        for (int ca = 0; ca < 2; ++ca) {
          const int ia = __ldg(tap_idx + ea + ca);
          const float wa = __ldg(tap_w + ea + ca);
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
                   const float* b3, float* out, int batch, int rows, int r1, int r2, int sum_c,
                   int max_c, cudaStream_t stream) {
  const int n = rows * r1 * r2;
  const size_t smem = (size_t)(max_c > H0 ? max_c : H0) * kTile * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(lattice_sweep_kernel<H0>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n + kTile - 1) / kTile), (unsigned)batch);
  lattice_sweep_kernel<H0><<<grid, H0 / 2, smem, stream>>>(
      vols, meta, n_levels, tap_idx, tap_w, w0t, b0, w1t, b1, w2t, b2, w3, b3, out, rows, r1,
      r2, sum_c);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sv3d_lattice_sweep(const void* vols, const void* meta, int n_levels,
                                  const void* tap_idx, const void* tap_w, const void* w0t,
                                  const void* b0, const void* w1t, const void* b1,
                                  const void* w2t, const void* b2, const void* w3,
                                  const void* b3, void* out, int batch, int rows, int r1,
                                  int r2, int sum_c, int h0, int max_c, void* stream) {
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
                            rows, r1, r2, sum_c, max_c, s);
  if (h0 == 512)
    return (int)launch<512>(v, mt, n_levels, ti, tw, (const float*)w0t, (const float*)b0,
                            (const float*)w1t, (const float*)b1, (const float*)w2t,
                            (const float*)b2, (const float*)w3, (const float*)b3, o, batch,
                            rows, r1, r2, sum_c, max_c, s);
  return (int)cudaErrorInvalidValue;
}
