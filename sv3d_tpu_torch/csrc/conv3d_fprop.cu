// The forward of the f32 3x3x3, stride-1, pad-1 Conv3d layers of training
// whose input arrives channel-major (NCDHW), as ConvONet's U-Net holds its
// activations (models/wgrad.py::WgradConv3d):
//
//     y[b][co][d][h][w] = bias[co] + sum_{ci,kd,kh,kw} x[b][ci][d+kd-1][h+kh-1][w+kw-1] W[co][ci][kd][kh][kw]
//
// with x zero outside the grid.  It replaces no TPU kernel: the JAX package
// leaves its convolutions to XLA.  It was added because cuDNN's f32 forward
// of the U-Net's 14 convs (an implicit GEMM) held ~134 ms of a 589 ms
// training step, at about half of what the card allows.
//
// It is the input gradient's implicit GEMM (csrc/conv3d_dgrad.cu) with x in
// dy's place and the weights read unflipped: M = B D H W output voxels, N =
// Cout, K = 27 Cin (864 to 10,368), so no split of K, no partials and no
// atomics.  What bounds it on the H100: the f32 FMAs, 2 Cout Cin 27 B D H W
// operations at 67 TFLOP/s.  Every product is an f32 FMA on the CUDA cores
// (no tensor cores, no TF32).  Each thread keeps a tile of 8 voxels along w
// by 8 output channels in registers, and for one input channel ci and one
// tap pair (kd, kh) reads 10 x values (the 8 voxels and their two
// neighbours along w, shared by the three kw) and 3 x 8 weights for 192
// FMAs.
//
// Design: a block owns a tile of voxels (td depths by th rows of one sample,
// wt groups of 8 voxels along w) by a tile of NC = 8 NCG output channels, and
// walks Cin in chunks of KC channels.  For each chunk it stages, by cp.async
// and double-buffered, the chunk's x slab with a one-voxel halo in d, h and
// w ([KC][td + 2][th + 2][ws], voxel w at w + 4 so that 16-byte vectors
// stay aligned, zeros outside x), and the chunk's weights ([KC][27][NC], from
// a copy laid out [Cin][27][Cout] once a call by conv3d_fprop_weights).  A
// thread's 8 channels are two runs of 4, NC / 2 apart.  x and y are read and
// written along w in 16-byte vectors where W % 4 == 0 (4-byte copies
// otherwise); no layout copies.  The sums run in a fixed order (chunk,
// channel, kd, kh, kw), the bias added last, so two calls give the same
// bits.  The two instances, picked by the wrapper's plan on Cout: Narrow (32
// channels, 64 groups of 8 voxels) and Wide (64 channels, 32 groups), 256
// threads and one block a multiprocessor.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kNT = 256;  // threads a block
constexpr int kKC = 8;    // input channels (x) a chunk

template <int NCG_>
struct FpropShape {
  static constexpr int NCG = NCG_;          // channel groups of 8
  static constexpr int NC = 8 * NCG;        // output channels a block
  static constexpr int LG_NC = NCG == 4 ? 5 : 6;
  static constexpr int VPW = 32 / NCG;      // voxel groups a warp
  static constexpr int NVG = kNT / NCG;     // voxel groups a block
};
using Narrow = FpropShape<4>;
using Wide = FpropShape<8>;

struct FpropGeom {
  int B, Cin, Cout, D, H, W;
  int td, th, wt;  // a tile: td depths, th rows, wt groups of 8 voxels along w
  int ws;          // a slab row: wt * 8 + 8 floats (voxel w at w + 4)
  int n_dt, n_ht, n_wt, n_ct;
  float r_vpr, r_rows_k, r_th2;  // 1 / (vectors a slab row, rows a channel, th + 2)
};

// n / d for n, d >= 0 and n + d < 2^22, from r = 1.0f / d (conv3d_dgrad.cu's)
__device__ __forceinline__ int fdiv(int n, float r) {
  return __float2int_rz(((float)n + 0.5f) * r);
}

__host__ __device__ inline int slab_floats(const FpropGeom& g) {
  return kKC * (g.td + 2) * (g.th + 2) * g.ws;
}
template <class S>
__host__ __device__ inline int weight_floats() {
  return kKC * 27 * S::NC;
}

// The x slab of chunk k0 for the tile at (b, d0, h0, w0) into xs: rows
// (k, s, rr) hold x[b][k0 + k][d0 - 1 + s][h0 - 1 + rr], float i of a row
// voxel w0 - 4 + i; zeros outside x.
__device__ __forceinline__ void stage_x(float* xs, const float* __restrict__ x,
                                        const FpropGeom& g, int b, int k0, int d0, int h0,
                                        int w0, bool vec) {
  const int rows_k = (g.td + 2) * (g.th + 2);
  const int per = vec ? 4 : 1, vpr = g.ws / per, items = kKC * rows_k * vpr;
  for (int i = threadIdx.x; i < items; i += kNT) {
    const int row = fdiv(i, g.r_vpr), v = i - row * vpr;
    const int k = fdiv(row, g.r_rows_k), sr = row - k * rows_k;
    const int s = fdiv(sr, g.r_th2), rr = sr - s * (g.th + 2);
    const int ci = k0 + k, d = d0 - 1 + s, h = h0 - 1 + rr, w = w0 - 4 + v * per;
    // a vector lies wholly inside or outside [0, W) (W % 4 == 0, w0 % 8 == 0)
    const bool in = ci < g.Cin && d >= 0 && d < g.D && h >= 0 && h < g.H && w >= 0 && w < g.W;
    const float* src = x + ((((int64_t)b * g.Cin + ci) * g.D + d) * g.H + h) * g.W + w;
    float* dst = xs + row * g.ws + v * per;
    if (vec) {
      cp_async16_zfill(dst, in ? src : x, in ? 16 : 0);
    } else {
      cp_async4_zfill(dst, in ? src : x, in ? 4 : 0);
    }
  }
}

// The weights of chunk k0 for output channels co0 .. co0 + NC - 1 into wsm
// ([KC][27][NC]) from wt ([Cin][27][Cout]); zeros past Cin and Cout.
template <class S>
__device__ __forceinline__ void stage_w(float* wsm, const float* __restrict__ wt,
                                        const FpropGeom& g, int k0, int co0, bool vec) {
  const int per = vec ? 4 : 1, lg = vec ? S::LG_NC - 2 : S::LG_NC, items = kKC * 27 << lg;
  for (int i = threadIdx.x; i < items; i += kNT) {
    const int row = i >> lg, c = (i - (row << lg)) * per;
    const int k = row / 27, tap = row - k * 27;
    const int ci = k0 + k, co = co0 + c;
    const bool in = ci < g.Cin && co < g.Cout;  // Cout % 4 == 0 where vec
    const float* src = wt + ((int64_t)ci * 27 + tap) * g.Cout + co;
    float* dst = wsm + row * S::NC + c;
    if (vec) {
      cp_async16_zfill(dst, in ? src : wt, in ? 16 : 0);
    } else {
      cp_async4_zfill(dst, in ? src : wt, in ? 4 : 0);
    }
  }
}

// wt[ci][tap][co] = w[co][ci][tap]: the weights with the output channels
// innermost, once a call
__global__ void __launch_bounds__(256) conv3d_fprop_weights(const float* __restrict__ w,
                                                            float* __restrict__ wt, int Cin,
                                                            int Cout) {
  const int n = Cout * 27 * Cin;
  for (int o = blockIdx.x * 256 + threadIdx.x; o < n; o += gridDim.x * 256) {
    const int co = o % Cout, r = o / Cout, tap = r % 27, ci = r / 27;
    wt[o] = w[((int64_t)co * Cin + ci) * 27 + tap];
  }
}

// y for one tile of voxels by one tile of output channels: grid (n_ct x
// tiles of voxels), the channel tile fastest, so that blocks running
// together share their x slab in L2; shared memory [2][slab] x slabs, then
// [2][KC][27][NC] weights.
template <class S>
__global__ void __launch_bounds__(kNT, 1)
    conv3d_fprop_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                        const float* __restrict__ bias, float* __restrict__ y, FpropGeom g,
                        bool vec_x, bool vec_w, bool vec_y) {
  extern __shared__ __align__(16) float smem[];
  const int slab = slab_floats(g);
  float* xs = smem;
  float* wsm = smem + 2 * slab;

  int t = blockIdx.x;
  const int ct = t % g.n_ct;
  t /= g.n_ct;
  const int wti = t % g.n_wt;
  t /= g.n_wt;
  const int hti = t % g.n_ht;
  t /= g.n_ht;
  const int dti = t % g.n_dt;
  const int b = t / g.n_dt;
  const int d0 = dti * g.td, h0 = hti * g.th, w0 = wti * g.wt * 8, co0 = ct * S::NC;

  // this thread: voxel group vg (depth dd, row r, group wg of the tile) and
  // channel group cg; a voxel group past the tile computes a copy of group 0
  // and writes nothing
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int vg = warp * S::VPW + lane % S::VPW, cg = lane / S::VPW;
  const int groups = g.td * g.th * g.wt;
  const bool live = vg < groups;
  const int v = live ? vg : 0;
  const int dd = v / (g.th * g.wt), r = (v / g.wt) % g.th, wg = v % g.wt;

  float acc[8][8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[j][c] = 0.f;

  const int n_chunks = (g.Cin + kKC - 1) / kKC;
  stage_x(xs, x, g, b, 0, d0, h0, w0, vec_x);
  stage_w<S>(wsm, wt, g, 0, co0, vec_w);
  cp_async_commit();
  const int row_k = (g.td + 2) * (g.th + 2) * g.ws;  // a channel of the slab
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    if (chunk + 1 < n_chunks) {  // the next chunk's copies, while this one computes
      const int nb = (chunk + 1) & 1;
      stage_x(xs + nb * slab, x, g, b, (chunk + 1) * kKC, d0, h0, w0, vec_x);
      stage_w<S>(wsm + nb * weight_floats<S>(), wt, g, (chunk + 1) * kKC, co0, vec_w);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this chunk's slab and weights have landed

    const float* xb = xs + (chunk & 1) * slab + (dd * (g.th + 2) + r) * g.ws + wg * 8 + 3;
    const float* wb = wsm + (chunk & 1) * weight_floats<S>() + cg * 4;
#pragma unroll 1
    for (int k = 0; k < kKC; ++k) {
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          // x at depth slab row dd + kd, row r + kh, voxels w - 1 .. w + 8
          const float* p = xb + k * row_k + (kd * (g.th + 2) + kh) * g.ws;
          float xv[10];
          xv[0] = p[0];
          const float4 a = *reinterpret_cast<const float4*>(p + 1);
          const float4 e = *reinterpret_cast<const float4*>(p + 5);
          xv[1] = a.x, xv[2] = a.y, xv[3] = a.z, xv[4] = a.w;
          xv[5] = e.x, xv[6] = e.y, xv[7] = e.z, xv[8] = e.w;
          xv[9] = p[9];
          const float* q = wb + (k * 27 + kd * 9 + kh * 3) * S::NC;
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const float4 lo = *reinterpret_cast<const float4*>(q + kw * S::NC);
            const float4 hi = *reinterpret_cast<const float4*>(q + kw * S::NC + S::NC / 2);
            const float wv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int c = 0; c < 8; ++c) acc[j][c] = fmaf(xv[j + kw], wv[c], acc[j][c]);
          }
        }
      }
    }
    __syncthreads();  // every warp is past this chunk's buffers before they are refilled
  }

  const int d = d0 + dd, h = h0 + r, wx = w0 + wg * 8;
  if (!live || d >= g.D || h >= g.H) return;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int co = co0 + (c / 4) * (S::NC / 2) + cg * 4 + c % 4;
    if (co >= g.Cout) continue;
    if (bias != nullptr) {
      const float bc = bias[co];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j][c] += bc;
    }
    float* o = y + ((((int64_t)b * g.Cout + co) * g.D + d) * g.H + h) * g.W + wx;
    if (vec_y) {  // W % 4 == 0: each vector wholly inside or outside the row
      if (wx < g.W) {
        *reinterpret_cast<float4*>(o) = make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
      }
      if (wx + 4 < g.W) {
        *reinterpret_cast<float4*>(o + 4) =
            make_float4(acc[4][c], acc[5][c], acc[6][c], acc[7][c]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (wx + j < g.W) o[j] = acc[j][c];
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <class S>
int launch(const float* x, const float* w, const float* bias, float* wt, float* y, int B,
           int Cin, int Cout, int D, int H, int W, int td, int th, int wtile,
           cudaStream_t stream) {
  if (B < 1 || Cin < 1 || Cout < 1 || D < 1 || H < 1 || W < 1 || td < 1 || td > D || th < 1 ||
      th > H || wtile < 1 || td * th * wtile > S::NVG) {
    return cudaErrorInvalidValue;
  }
  FpropGeom g;
  g.B = B, g.Cin = Cin, g.Cout = Cout, g.D = D, g.H = H, g.W = W;
  g.td = td, g.th = th, g.wt = wtile;
  g.ws = wtile * 8 + 8;
  g.n_dt = (D + td - 1) / td;
  g.n_ht = (H + th - 1) / th;
  g.n_wt = (W + wtile * 8 - 1) / (wtile * 8);
  g.n_ct = (Cout + S::NC - 1) / S::NC;
  const long long blocks = (long long)B * g.n_dt * g.n_ht * g.n_wt * g.n_ct;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  // (the slab's items, fdiv's numerators, then lie far below 2^22)
  const size_t bytes = 2 * ((size_t)slab_floats(g) + weight_floats<S>()) * sizeof(float);
  if (bytes > 232448) return cudaErrorInvalidValue;
  const bool vec_x = W % 4 == 0 && aligned16(x);
  const bool vec_w = Cout % 4 == 0 && aligned16(wt);
  const bool vec_y = W % 4 == 0 && aligned16(y);
  g.r_vpr = 1.0f / (vec_x ? g.ws / 4 : g.ws);
  g.r_rows_k = 1.0f / ((td + 2) * (th + 2));
  g.r_th2 = 1.0f / (th + 2);
  // the instance's shared-memory limit, raised once per device to the most a
  // block may take
  static bool raised[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(conv3d_fprop_kernel<S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  const int n = Cout * 27 * Cin;
  conv3d_fprop_weights<<<(n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024, 256, 0, stream>>>(
      w, wt, Cin, Cout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  conv3d_fprop_kernel<S><<<(unsigned)blocks, kNT, bytes, stream>>>(x, wt, bias, y, g, vec_x,
                                                                   vec_w, vec_y);
  return cudaGetLastError();
}

}  // namespace

// y (B, Cout, D, H, W) of a 3x3x3 stride-1 pad-1 conv of x (B, Cin, D, H,
// W) with its weight w (Cout, Cin, 3, 3, 3) and bias (Cout, or null), all
// f32 and contiguous (NCDHW); wt is scratch of Cin x 27 x Cout floats.  ncg
// is the instance (4 Narrow, 8 Wide); a tile of voxels is td depths by th
// rows by wtile groups of 8 voxels along w, at most the instance's 64 or 32
// groups, and its two x slabs and two weight chunks take at most 227 KB.
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for arguments it does not take.
extern "C" int sv3d_conv3d_fprop(const float* x, const float* w, const float* bias, float* wt,
                                 float* y, int B, int Cin, int Cout, int D, int H, int W,
                                 int ncg, int td, int th, int wtile, cudaStream_t stream) {
  if (ncg == Narrow::NCG) {
    return launch<Narrow>(x, w, bias, wt, y, B, Cin, Cout, D, H, W, td, th, wtile, stream);
  }
  if (ncg == Wide::NCG) {
    return launch<Wide>(x, w, bias, wt, y, B, Cin, Cout, D, H, W, td, th, wtile, stream);
  }
  return cudaErrorInvalidValue;
}
