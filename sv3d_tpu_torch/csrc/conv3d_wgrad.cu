// The weight gradient of the IF-Net pyramid's f32 3x3x3, stride-1, pad-1
// Conv3d layers in training (models/ifnet.py::_ConvBlock), over the
// channels-last (NDHWC) tensors in which cuDNN hands the port's conv
// outputs and their gradients:
//
//     dW[co][ci][kd][kh][kw] = sum_{b,d,h,w} dy[b][d][h][w][co] x[b][d+kd-1][h+kh-1][w+kw-1][ci]
//
// with x zero outside the grid.  It replaces no TPU kernel: the JAX package
// leaves its convolutions to XLA.  It was added because cuDNN's f32
// heuristics pick a direct kernel (wgrad2d_grouped_direct_kernel) at the
// pyramid's first two shapes, one input channel at the full grid and 16 at
// the half grid, which held ~165 ms of a 286 ms B=4 training step.
//
// The shape is a short and fat GEMM with a huge reduction: M = Cout, N =
// Cin * 27, K = B * D * H * W (millions of voxels against a few hundred to a
// few thousand outputs).  What bounds it on the H100: for Cin = 1 the bytes
// (dy is streamed once, 16 times the bytes of x); for Cin >= 16 the f32
// FMAs, 2 Cout Cin 27 B D H W operations at 67 TFLOP/s.  Every product is an
// f32 FMA on the CUDA cores (no tensor cores, no TF32).
//
// Design: split K.  A column is th rows (b, h0 .. h0 + th - 1) of one sample
// through all depths; a step is one depth d of a column.  A block owns a
// tile of CO_T output and CI_T input channels and a contiguous range of
// steps (its split), which it walks in order along d.  It keeps in shared
// memory, channels-last as the tensors are, a ring of four x slices (depths
// d - 1, d, d + 1 and the next one arriving) of its input channels with a
// one-voxel halo in h and w, and two dy slices of its output channels (W
// padded to a multiple of 4): the copies of step d + 1 (one new x slice and
// one dy slice, by cp.async with zero fill outside the tensors) run while
// step d's FMAs do, and one barrier a step separates them.  Warp k of the 9
// owns the tap pair (kd, kh) = (k / 3, k % 3); its lanes own TCO consecutive
// output by TCI consecutive input channels (and, with RS > 1, a share of the
// rows) and keep all three kw of them in registers: for 4 voxels along w a
// lane reads 4 vectors of TCO dy values and 4 new vectors of TCI x values
// (the x window of 6 voxels slides along w) for 4 * TCO * TCI * 3 FMAs; the
// lanes of a warp read 128 contiguous bytes of dy and 64 of x at a time.
// Each block writes its sums to its own partial ([parts][Cout][Cin][27]),
// and a second kernel adds the partials in a fixed order: the result does
// not depend on the run (no atomics).  The two instances: Wide (Cin >= 16;
// 32 output x 16 input channels a block, 4 x 4 a lane, 2 blocks a
// multiprocessor) and Narrow (Cin < 16; 16 output channels and one input
// channel a block, a lane 2 output channels of every 4th row, 3 blocks a
// multiprocessor; x is then read along w, 4 voxels a vector).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

template <int TCO_, int NCOG_, int TCI_, int NCIG_, int RS_, int MINB_>
struct WgradShape {
  static constexpr int TCO = TCO_, NCOG = NCOG_, TCI = TCI_, NCIG = NCIG_, RS = RS_;
  static constexpr int CO_T = TCO * NCOG, CI_T = TCI * NCIG, MINB = MINB_;
  static constexpr int NT = 32 * 9;  // a warp a tap pair (kd, kh)
  static_assert(NCOG * NCIG * RS == 32, "the lanes of a warp");
};
using Wide = WgradShape<4, 8, 4, 4, 1, 2>;
using Narrow = WgradShape<2, 8, 1, 1, 4, 3>;
static_assert(Wide::TCI == 4 && Narrow::TCI == 1, "x is read 4 channels or 4 voxels a vector");

struct Geom {
  int B, Cin, Cout, D, H, W;
  int th;     // rows a column
  int hb;     // columns along H
  int wp;     // W padded to a multiple of 4
  int steps;  // B * hb * D
  int nsplit;
};

// Shared-memory rows: dy [wp][CO_T], 16 floats more where a warp reads
// several rows (RS > 1), so that two rows fall in two halves of the banks;
// x [wp + 2][CI_T] (voxel w at w + 1) for channel vectors, or [wp + 8]
// (voxel w at w + 4, 16-byte aligned) for one channel read along w.
template <class S>
__host__ __device__ int dy_row(int wp) { return wp * S::CO_T + (S::RS > 1 ? 16 : 0); }
template <class S>
__host__ __device__ int x_row(int wp) { return S::CI_T == 1 ? wp + 8 : (wp + 2) * S::CI_T; }

// 16 bytes (vec) or 4 bytes from src into dst, zeros where !in
__device__ __forceinline__ void copy(float* dst, const float* src, bool in, bool vec) {
  if (vec) {
    cp_async16_zfill(dst, src, in ? 16 : 0);
  } else {
    cp_async4_zfill(dst, src, in ? 4 : 0);
  }
}

// the x slice at depth dd of column (b, h0) for input channels ci0 .. into
// xs, zeros outside x: rows rr = 0 .. th + 1 hold h0 + rr - 1
template <class S>
__device__ __forceinline__ void stage_x(float* xs, const float* __restrict__ x, const Geom& g,
                                        int b, int dd, int h0, int ci0, bool vec) {
  const int rows = g.th + 2, rx = x_row<S>(g.wp);
  const bool d_in = dd >= 0 && dd < g.D;
  if (S::CI_T == 1) {  // one channel: vectors of 4 voxels along w (vec: Cin 1)
    const int per = vec ? 4 : 1, items = rows * (rx / per);
    for (int i = threadIdx.x; i < items; i += S::NT) {
      const int rr = i / (rx / per), s = (i - rr * (rx / per)) * per, w = s - 4;
      const int h = h0 + rr - 1;
      const bool in = d_in && ci0 < g.Cin && h >= 0 && h < g.H && w >= 0 && w < g.W;
      const float* src = x + ((((int64_t)b * g.D + dd) * g.H + h) * g.W + w) * g.Cin + ci0;
      copy(xs + rr * rx + s, in ? src : x, in, vec);
    }
  } else {  // channel vectors: [voxel][CI_T], vec: 4 channels a copy
    const int per = vec ? 4 : 1, q = S::CI_T / per, items = rows * (g.wp + 2) * q;
    for (int i = threadIdx.x; i < items; i += S::NT) {
      const int v = i / q, c = (i - v * q) * per, rr = v / (g.wp + 2), s = v - rr * (g.wp + 2);
      const int h = h0 + rr - 1, w = s - 1;
      const bool in = d_in && ci0 + c < g.Cin && h >= 0 && h < g.H && w >= 0 && w < g.W;
      const float* src = x + ((((int64_t)b * g.D + dd) * g.H + h) * g.W + w) * g.Cin + ci0 + c;
      copy(xs + rr * rx + s * S::CI_T + c, in ? src : x, in, vec);
    }
  }
}

// the dy slice at depth d of column (b, h0) for output channels co0 .. into
// dys ([th][wp][CO_T], rows dy_row apart), zeros outside dy and past W
template <class S>
__device__ __forceinline__ void stage_dy(float* dys, const float* __restrict__ dy, const Geom& g,
                                         int b, int d, int h0, int co0, bool vec) {
  const int per = vec ? 4 : 1, q = S::CO_T / per, items = g.th * g.wp * q;
  const int rd = dy_row<S>(g.wp);
  for (int i = threadIdx.x; i < items; i += S::NT) {
    const int v = i / q, c = (i - v * q) * per, r = v / g.wp, w = v - r * g.wp;
    const int h = h0 + r;
    const bool in = co0 + c < g.Cout && h < g.H && w < g.W;
    const float* src = dy + ((((int64_t)b * g.D + d) * g.H + h) * g.W + w) * g.Cout + co0 + c;
    copy(dys + r * rd + w * S::CO_T + c, in ? src : dy, in, vec);
  }
}

template <int N>
__device__ __forceinline__ void load_vec(float (&v)[N], const float* p) {
  if (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = p[k];
  }
}

// The partial sums of one split of the steps for one tile of channels: grid
// (channel tiles, nsplit), S::NT threads; shared memory [2][th][dy_row] dy
// slices, then [4][th + 2][x_row] x slices.
template <class S>
__global__ void __launch_bounds__(S::NT, S::MINB)
    conv3d_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                        float* __restrict__ part, Geom g, bool vec_x, bool vec_dy) {
  extern __shared__ __align__(16) float smem[];
  const int rd = dy_row<S>(g.wp), rx = x_row<S>(g.wp);
  const int dy_slice = g.th * rd, x_slice = (g.th + 2) * rx;
  float* dy_buf = smem;
  float* x_ring = smem + 2 * dy_slice;
  const int n_co_t = (g.Cout + S::CO_T - 1) / S::CO_T;
  const int co0 = (blockIdx.x % n_co_t) * S::CO_T, ci0 = (blockIdx.x / n_co_t) * S::CI_T;
  const int split = blockIdx.y;
  const int t0 = (int)((long long)split * g.steps / g.nsplit);
  const int t1 = (int)((long long)(split + 1) * g.steps / g.nsplit);

  const int lane = threadIdx.x & 31, tap = threadIdx.x >> 5;
  const int cog = lane % S::NCOG, cig = (lane / S::NCOG) % S::NCIG;
  const int rs = lane / (S::NCOG * S::NCIG);
  const int kd = tap / 3, kh = tap - 3 * kd;

  float acc[S::TCO][S::TCI][3];
#pragma unroll
  for (int i = 0; i < S::TCO; ++i)
#pragma unroll
    for (int j = 0; j < S::TCI; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) acc[i][j][k] = 0.f;

  // step t0's column (b, h0) and depth d
  const int col = t0 / g.D;
  int d = t0 - col * g.D, b = col / g.hb, h0 = (col - b * g.hb) * g.th;
  if (t0 < t1) {
    for (int k = -1; k <= 1; ++k) {
      stage_x<S>(x_ring + ((d + k) & 3) * x_slice, x, g, b, d + k, h0, ci0, vec_x);
    }
    stage_dy<S>(dy_buf + (d & 1) * dy_slice, dy, g, b, d, h0, co0, vec_dy);
  }
  cp_async_commit();
  for (int t = t0; t < t1; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // step t's slices have landed; step t - 1's reads are done
    const bool same = t + 1 < t1 && d + 1 < g.D;
    if (same) {  // step t + 1's new x slice and dy slice, while step t computes
      stage_x<S>(x_ring + ((d + 2) & 3) * x_slice, x, g, b, d + 2, h0, ci0, vec_x);
      stage_dy<S>(dy_buf + ((d + 1) & 1) * dy_slice, dy, g, b, d + 1, h0, co0, vec_dy);
    }
    cp_async_commit();

    const float* dys = dy_buf + (d & 1) * dy_slice;
    const float* xs = x_ring + ((d + kd - 1) & 3) * x_slice;
    const int rows = min(g.th, g.H - h0);
    for (int r = rs; r < rows; r += S::RS) {
      const float* dr = dys + r * rd + cog * S::TCO;
      const float* xr = xs + (r + kh) * rx;
      // xv[k]: x at voxel w - 1 + k (k < 6), the window of voxels w .. w + 3;
      // one channel (CI_T 1): xm = x[w - 1] and xb = x[w .. w + 3] carried
      float xv[6][S::TCI], xm = 0.f, xb[4] = {0.f, 0.f, 0.f, 0.f};
      if (S::CI_T == 1) {
        xm = xr[3];
        load_vec<4>(xb, xr + 4);
      } else {
        load_vec<S::TCI>(xv[4], xr + cig * S::TCI);
        load_vec<S::TCI>(xv[5], xr + S::CI_T + cig * S::TCI);
      }
#pragma unroll 2
      for (int w = 0; w < g.wp; w += 4) {
        if (S::CI_T == 1) {
          float xc[4];
          load_vec<4>(xc, xr + w + 8);
          xv[0][0] = xm;
#pragma unroll
          for (int k = 0; k < 4; ++k) xv[k + 1][0] = xb[k];
          xv[5][0] = xc[0];
          xm = xb[3];
#pragma unroll
          for (int k = 0; k < 4; ++k) xb[k] = xc[k];
        } else {
#pragma unroll
          for (int j = 0; j < S::TCI; ++j) {
            xv[0][j] = xv[4][j];
            xv[1][j] = xv[5][j];
          }
#pragma unroll
          for (int k = 2; k < 6; ++k) {
            load_vec<S::TCI>(xv[k], xr + (w + k) * S::CI_T + cig * S::TCI);
          }
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          float dv[S::TCO];
          load_vec<S::TCO>(dv, dr + (w + p) * S::CO_T);
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
#pragma unroll
            for (int i = 0; i < S::TCO; ++i)
#pragma unroll
              for (int j = 0; j < S::TCI; ++j)
                acc[i][j][kw] = fmaf(dv[i], xv[p + kw][j], acc[i][j][kw]);
        }
      }
    }

    if (same) {
      ++d;
    } else if (t + 1 < t1) {  // the next column: its first three slices anew
      d = 0;
      h0 += g.th;
      if (h0 >= g.H) {
        h0 = 0;
        ++b;
      }
      __syncthreads();  // every warp is past this step's reads of the ring
      for (int k = -1; k <= 1; ++k) {
        stage_x<S>(x_ring + (k & 3) * x_slice, x, g, b, k, h0, ci0, vec_x);
      }
      stage_dy<S>(dy_buf, dy, g, b, 0, h0, co0, vec_dy);
      cp_async_commit();
    }
  }

  const long long p = (long long)split * S::RS + rs;
#pragma unroll
  for (int i = 0; i < S::TCO; ++i) {
    const int co = co0 + cog * S::TCO + i;
#pragma unroll
    for (int j = 0; j < S::TCI; ++j) {
      const int ci = ci0 + cig * S::TCI + j;
      if (co < g.Cout && ci < g.Cin) {
        float* o = part + ((p * g.Cout + co) * g.Cin + ci) * 27 + kd * 9 + kh * 3;
#pragma unroll
        for (int k = 0; k < 3; ++k) o[k] = acc[i][j][k];
      }
    }
  }
}

// out[e] = sum over p of part[p][e] in a fixed order.  G groups of threads
// share an element (G 8 where there are many partials of few elements, else
// 1): group q sums p = q, q + G, ... in four interleaved sums (so that four
// loads are in flight), added in order, and the G sums are added in order.
template <int G>
__global__ void __launch_bounds__(256) conv3d_wgrad_sum(const float* __restrict__ part,
                                                        float* __restrict__ out, int parts,
                                                        int n) {
  constexpr int kE = 256 / G;  // elements a block
  __shared__ float sums[G][kE];
  const int k = threadIdx.x % kE, q = threadIdx.x / kE;
  const int e = blockIdx.x * kE + k;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  if (e < n) {
    int p = q;
    for (; p + 3 * G < parts; p += 4 * G) {
#pragma unroll
      for (int u = 0; u < 4; ++u) s[u] += part[(int64_t)(p + u * G) * n + e];
    }
    for (; p < parts; p += G) s[0] += part[(int64_t)p * n + e];
  }
  const float t = (s[0] + s[1]) + (s[2] + s[3]);
  if (G == 1) {
    if (e < n) out[e] = t;
    return;
  }
  sums[q][k] = t;
  __syncthreads();
  if (q == 0 && e < n) {
    float r = sums[0][k];
#pragma unroll
    for (int u = 1; u < G; ++u) r += sums[u][k];
    out[e] = r;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <class S>
int launch(const float* x, const float* dy, float* part, float* out, int B, int Cin, int Cout,
           int D, int H, int W, int th, int nsplit, int parts, cudaStream_t stream) {
  if (B < 1 || Cin < 1 || Cout < 1 || D < 1 || H < 1 || W < 1 || th < 1 || th > H ||
      nsplit < 1 || nsplit > 65535 || parts != nsplit * S::RS) {
    return cudaErrorInvalidValue;
  }
  Geom g;
  g.B = B, g.Cin = Cin, g.Cout = Cout, g.D = D, g.H = H, g.W = W;
  g.th = th;
  g.hb = (H + th - 1) / th;
  g.wp = (W + 3) / 4 * 4;
  const long long steps = (long long)B * g.hb * D;
  if (steps > 0x7fffffff || nsplit > steps) return cudaErrorInvalidValue;
  g.steps = (int)steps;
  g.nsplit = nsplit;
  const size_t bytes =
      (2 * (size_t)th * dy_row<S>(g.wp) + 4 * (size_t)(th + 2) * x_row<S>(g.wp)) * sizeof(float);
  if (bytes > 232448) return cudaErrorInvalidValue;
  // the instance's shared-memory limit, raised once per device to the most a
  // block may take
  static bool raised[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(conv3d_wgrad_kernel<S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  // 16-byte copies: 4 channels (or, for one channel, 4 voxels along w) a copy
  const bool vec_x = (S::CI_T == 1 ? Cin == 1 && W % 4 == 0 : Cin % 4 == 0) && aligned16(x);
  const bool vec_dy = Cout % 4 == 0 && aligned16(dy);
  const int tiles = ((Cout + S::CO_T - 1) / S::CO_T) * ((Cin + S::CI_T - 1) / S::CI_T);
  conv3d_wgrad_kernel<S>
      <<<dim3(tiles, nsplit), S::NT, bytes, stream>>>(x, dy, part, g, vec_x, vec_dy);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = Cout * Cin * 27;
  if (parts > 64) {
    conv3d_wgrad_sum<8><<<(n + 31) / 32, 256, 0, stream>>>(part, out, parts, n);
  } else {
    conv3d_wgrad_sum<1><<<(n + 255) / 256, 256, 0, stream>>>(part, out, parts, n);
  }
  return cudaGetLastError();
}

}  // namespace

// dW (Cout, Cin, 3, 3, 3) of a 3x3x3 stride-1 pad-1 conv from x (B, Cin, D,
// H, W) and dy (B, Cout, D, H, W), both f32 in channels-last (NDHWC)
// memory, dW contiguous; part is scratch of
// parts x Cout x Cin x 27 floats, parts = nsplit (Cin >= 16) or 4 nsplit
// (Cin < 16), nsplit at most B ceil(H / th) D; th rows a column (1 .. H);
// two dy slices and four x slices in shared memory, at most 227 KB.
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for arguments it does not take.
extern "C" int sv3d_conv3d_wgrad(const float* x, const float* dy, float* part, float* out, int B,
                                 int Cin, int Cout, int D, int H, int W, int th, int nsplit,
                                 int parts, cudaStream_t stream) {
  if (Cin < 16) {
    return launch<Narrow>(x, dy, part, out, B, Cin, Cout, D, H, W, th, nsplit, parts, stream);
  }
  return launch<Wide>(x, dy, part, out, B, Cin, Cout, D, H, W, th, nsplit, parts, stream);
}
