// Fused IF-Net decoder for Hopper: the whole point MLP from a materialized
// feature matrix.
//
//   K3 fused_point_mlp_kernel  replaces sv3d_tpu/ops/pallas/mlp.py::fused_point_mlp
//
// Contract (the plain version in sv3d_tpu_torch/ops/mlp.py): f (F, N) f32
// features, row-major; logits[n] = fc_out(relu(fc2(relu(fc1(relu(fc0(f[:, n])))))))
// with fc0 F -> H0 (2583 -> 256 at net_res 128, 2247 -> 512 at 32), fc1
// H0 -> H1, fc2 H1 -> H2, fc_out H2 -> 1, biases and ReLUs in the kernel.
// The weights come transposed to (in, out) so that reads along the outputs
// are coalesced.  f32 FMA throughout.  In the JAX kernel's bf16 class
// (compute_dtype=torch.bfloat16) the wrapper hands it the features and the
// four weights rounded to bf16 and round_hidden set, and it rounds each ReLU
// output to bf16 (round to nearest even) as the JAX kernel does; the
// products of bf16 values are exact in f32, and the sums stay f32.
//
// What bounds it: 2 * (F*H0 + H0*H1 + H1*H2 + H2) flop a point (1.8 MFLOP at
// net_res 128) against F*4 bytes of features, so at the card's f32 rate it is
// compute-bound, as the TPU kernel is bound by its MXU.  What the design keeps
// out of device memory is what the TPU kernel keeps out of HBM: the (H, N)
// hidden activations.  A block owns kMlpPoints points; fc0 streams the
// block's (F, T) tile of f through shared memory kMlpChunk rows at a time,
// each thread accumulating R output rows (j = threadIdx.x + r * 256) for all
// T points in registers; the activations of each layer go to one (maxH, T)
// shared buffer that the next layer reads as broadcasts, and only the logits
// are written.  F need not be a multiple of anything: the last chunk is
// masked, and every load is a scalar load (no alignment assumed).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMlpPoints = 32;   // T: points per block
constexpr int kMlpThreads = 256;
constexpr int kMlpChunk = 32;    // rows of f per shared-memory round

// acc[r][t] += sum_k xs[k][t] * wt[(k0 + k) * h_out + j_r] for k < kk
template <int R>
__device__ __forceinline__ void dense_rows(const float* __restrict__ xs, int kk,
                                           const float* __restrict__ wt,
                                           int h_out, int k0,
                                           float (&acc)[R][kMlpPoints]) {
  for (int k = 0; k < kk; ++k) {
    const float* x = xs + k * kMlpPoints;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = threadIdx.x + r * kMlpThreads;
      if (j < h_out) {
        const float w = wt[(int64_t)(k0 + k) * h_out + j];
#pragma unroll
        for (int t = 0; t < kMlpPoints; ++t) acc[r][t] = fmaf(x[t], w, acc[r][t]);
      }
    }
  }
}

// hs[j][t] = relu(acc[r][t] + bias[j]) for this thread's rows, rounded to
// bf16 when round_hidden is set; zero acc
template <int R>
__device__ __forceinline__ void store_relu(float* __restrict__ hs,
                                           const float* __restrict__ bias,
                                           int h_out, int round_hidden,
                                           float (&acc)[R][kMlpPoints]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = threadIdx.x + r * kMlpThreads;
    if (j < h_out) {
      const float bj = bias[j];
#pragma unroll
      for (int t = 0; t < kMlpPoints; ++t) {
        const float v = fmaxf(acc[r][t] + bj, 0.0f);
        hs[j * kMlpPoints + t] = round_hidden ? __bfloat162float(__float2bfloat16_rn(v)) : v;
      }
    }
#pragma unroll
    for (int t = 0; t < kMlpPoints; ++t) acc[r][t] = 0.0f;
  }
}

template <int R>
__global__ void __launch_bounds__(kMlpThreads)
fused_point_mlp_kernel(const float* __restrict__ f, int n_feat, int n,
                       const float* __restrict__ w0t, const float* __restrict__ b0,
                       const float* __restrict__ w1t, const float* __restrict__ b1,
                       const float* __restrict__ w2t, const float* __restrict__ b2,
                       const float* __restrict__ w3, const float* __restrict__ b3,
                       float* __restrict__ out, int h0, int h1, int h2,
                       int round_hidden) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                                 // (R * 256, T) activations
  float* fs = smem + R * kMlpThreads * kMlpPoints;  // (kMlpChunk, T) tile of f
  const int64_t n0 = (int64_t)blockIdx.x * kMlpPoints;
  float acc[R][kMlpPoints];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int t = 0; t < kMlpPoints; ++t) acc[r][t] = 0.0f;

  // fc0: stream f through shared memory, kMlpChunk rows a round
  for (int k0 = 0; k0 < n_feat; k0 += kMlpChunk) {
    const int kk = min(kMlpChunk, n_feat - k0);
    __syncthreads();  // the previous round's readers are done
    for (int i = threadIdx.x; i < kMlpChunk * kMlpPoints; i += kMlpThreads) {
      const int k = i / kMlpPoints, t = i % kMlpPoints;
      const int64_t col = n0 + t;
      fs[i] = (k < kk && col < n) ? f[(int64_t)(k0 + k) * n + col] : 0.0f;
    }
    __syncthreads();
    dense_rows<R>(fs, kk, w0t, h0, k0, acc);
  }
  store_relu<R>(hs, b0, h0, round_hidden, acc);
  __syncthreads();
  dense_rows<R>(hs, h0, w1t, h1, 0, acc);
  __syncthreads();  // every thread has read fc0's activations
  store_relu<R>(hs, b1, h1, round_hidden, acc);
  __syncthreads();
  dense_rows<R>(hs, h1, w2t, h2, 0, acc);
  __syncthreads();
  store_relu<R>(hs, b2, h2, round_hidden, acc);
  __syncthreads();
  // fc_out: one thread a point
  if (threadIdx.x < kMlpPoints) {
    const int t = threadIdx.x;
    float s = 0.0f;
    for (int k = 0; k < h2; ++k) s = fmaf(hs[k * kMlpPoints + t], w3[k], s);
    if (n0 + t < n) out[n0 + t] = s + b3[0];
  }
}

template <int R>
int launch(const float* f, int n_feat, int n, const float* w0t, const float* b0,
           const float* w1t, const float* b1, const float* w2t, const float* b2,
           const float* w3, const float* b3, float* out, int h0, int h1, int h2,
           int round_hidden, cudaStream_t stream) {
  const int smem = (R * kMlpThreads + kMlpChunk) * kMlpPoints * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_point_mlp_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(((int64_t)n + kMlpPoints - 1) / kMlpPoints);
  fused_point_mlp_kernel<R><<<blocks, kMlpThreads, smem, stream>>>(
      f, n_feat, n, w0t, b0, w1t, b1, w2t, b2, w3, b3, out, h0, h1, h2, round_hidden);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sv3d_fused_point_mlp(const void* f, const void* w0t, const void* b0,
                                    const void* w1t, const void* b1, const void* w2t,
                                    const void* b2, const void* w3, const void* b3,
                                    void* out, int n_feat, int n, int h0, int h1,
                                    int h2, int round_hidden, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int hmax = h0 > h1 ? (h0 > h2 ? h0 : h2) : (h1 > h2 ? h1 : h2);
  auto* s = (cudaStream_t)stream;
  const float *F = (const float*)f, *W0 = (const float*)w0t, *B0 = (const float*)b0,
              *W1 = (const float*)w1t, *B1 = (const float*)b1, *W2 = (const float*)w2t,
              *B2 = (const float*)b2, *W3 = (const float*)w3, *B3 = (const float*)b3;
  if (hmax <= kMlpThreads)
    return launch<1>(F, n_feat, n, W0, B0, W1, B1, W2, B2, W3, B3, (float*)out, h0, h1, h2,
                     round_hidden, s);
  if (hmax <= 2 * kMlpThreads)
    return launch<2>(F, n_feat, n, W0, B0, W1, B1, W2, B2, W3, B3, (float*)out, h0, h1, h2,
                     round_hidden, s);
  return (int)cudaErrorInvalidValue;
}
