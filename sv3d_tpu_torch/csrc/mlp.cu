// Fused IF-Net decoder for Hopper: the whole point MLP from a materialized
// feature matrix.  Two kernels, one per compute dtype:
//
//   K3 bf16  fused_point_mlp_bf16_kernel  (compute_dtype bfloat16, the JAX kernel's class)
//   K3 f32   fused_point_mlp_kernel       (compute_dtype float32, the parity route)
//
// Both replace sv3d_tpu/ops/pallas/mlp.py::fused_point_mlp.  Contract (the
// plain version in sv3d_tpu_torch/ops/mlp.py): f (F, N) f32 features,
// row-major; logits[n] = fc_out(relu(fc2(relu(fc1(relu(fc0(f[:, n])))))))
// with fc0 F -> H0 (2583 -> 256 at net_res 128, 2247 -> 512 at 32), fc1
// H0 -> H1, fc2 H1 -> H2, fc_out H2 -> 1, biases and ReLUs in the kernel.
//
// bf16 design.  The JAX kernel's class: the features, the four weights and
// each ReLU output rounded to bf16 (round to nearest even), products exact,
// sums and biases f32, fc_out an f32 dot.  What bounds it: one read of f, F
// x 4 bytes a point (120 MB for a lattice row of 11,648 points at net_res
// 128: 0.036 ms at 3.35 TB/s), against 2 (F H0 + H0 H1 + H1 H2) tensor flops
// a point (0.019 ms at 989 TFLOP/s), so the bytes; the hidden activations
// never leave the block.  The block tile is K2 bf16's (sweep.cu): kM = 16
// kMT points (64 at H0 256; 32 at H0 512, for the registers) and all H0
// fc0 columns, NW = H0 / 32 warps, warp w owning columns [32 w, 32 w +
// 32) for every point of the tile, mma.sync m16n8k16 bf16 -> f32 through
// mma_bf16.cuh, fc0's sums promoted from a partial every chunk (Fc0Sums),
// one block an SM.  fc0 streams the tile's (F, kM) slice of f in chunks of
// 128 features: each item (8 features x 4 points) is 8 float4 loads,
// coalesced along the points of a feature row (a scalar path where N % 4
// != 0 or f is not 16-byte aligned), rounded to bf16 in registers and
// stored as four 16-byte rows of the [point][feature] A tile (rows padded
// to kAStride; a quarter-warp's 8 stores are 8 feature groups of one row,
// 128 contiguous bytes, conflict-free), double buffered, so mma_chunk's
// ldmatrix reads it as it is.  The loads of chunk i + 1 are issued before
// the MMAs of chunk i, one barrier a chunk.  W0 (bf16, rows padded to a
// multiple of 16 with zeros, mma_b_fragments order, made once by
// ops/cuda/mlp.py::mlp_operands) streams through each warp's cp.async ring
// (BStream), a chunk's 8 steps deep; features past F load as zeros, so the
// padded last chunk adds nothing.  Then decoder_tail (mma_bf16.cuh, one
// copy with K2 bf16): bias + ReLU + bf16 into shared memory over the A
// buffers, fc1 and fc2 as MMAs, fc_out as an f32 dot a point.  On the H100
// it runs at about a quarter of its bound (PERF.md): two accumulator sets
// and the next chunk take 254 registers, so 8 warps an SM leave the
// mma.sync chain latency-bound; 182 tiles of 64 fill 132 SMs in two waves;
// each block re-reads W0 from L2 (1.33 MB in bf16, 241 MB a row against
// 120 MB of features from HBM); kM = 128 halves that but was slower on the
// H100 (PERF.md: 91 blocks for 132 SMs, its sums spilled out of the
// registers).  Widths: H0 256 or 512,
// H1 = H2 = 256 (IF-Net's two configurations); the wrapper raises on
// others.
//
// f32 design (the port's own parity route, f32 FMA throughout, no tensor
// cores): the weights come transposed to (in, out), rows of H contiguous.
// What bounds it: 2 * (F*H0 + H0*H1 + H1*H2 + H2) flop a point on the f32
// units (1.58 MFLOP at net_res 128: 18.46 GFLOP a lattice row, 0.2756 ms
// at 67 TFLOP/s) against F*4 bytes of features (0.036 ms), so operations.
// The block tile is fma_f32.cuh's FmaTile: kM points x HP columns, HP = 256
// (every width <= 256) or 512 (up to 512), widths padded in the kernel
// (columns past a layer's width load as zeros and hold relu(0 + 0) = 0),
// each thread an 8 x 8 register tile, 16 FMAs a shared-memory load.  fc0
// streams the tile's (F, kM) slice of f through a two-stage cp.async ring
// (16-byte copies where N % 4 == 0 and f is 16-byte aligned, else 4-byte
// ones; features past F and points past N are zeros) and W0's rows through
// the B ring, read once per kM points; the next chunk's copies are in
// flight during this chunk's FMAs, one barrier a chunk.  fc0's bias + ReLU
// go into a shared (HP, kM) activation buffer (over the A ring), which fc1
// and then fc2 read as their resident A operand, their weights streamed
// through the same B ring; fc_out is an f32 dot a point, TP threads a point
// summed in shared memory.  Only the logits are written.  Tile: kM = 96
// at HP 256 (384 threads, 128 KB of shared memory, one block an SM: 122
// blocks for a lattice row of 11,648 points, one wave on 132 SMs; 64
// points would make 182 blocks, two on 50 SMs and one on the rest), kM = 48
// at HP 512 (384 threads, 128 KB).  Each output sums its terms in order k =
// 0, 1, ... from 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fma_f32.cuh"
#include "mma_bf16.cuh"

namespace {

// fc0's A operand: the tile's (kK, kM) slice of f, chunk c in stage c % 2
// of a [2][kK][kM] ring; 16-byte copies where N % 4 == 0 and f is 16-byte
// aligned (a quad of points is then all in or all out), else 4-byte copies;
// features past F and points past N are zeros.
template <int kM, int kK, int NT>
struct FeatureA {
  float* ring;
  const float* f;
  int n_feat, n, n0;
  bool vec;
  __device__ __forceinline__ void issue(int c) {
    load_tile<kK, kM, NT>(ring + (c & 1) * kK * kM, f, n_feat, n, c * kK, n0, vec);
  }
  __device__ __forceinline__ void finish(int) {}
  __device__ __forceinline__ const float* chunk(int c) const { return ring + (c & 1) * kK * kM; }
};

// K3 f32's shared memory: the activations, then the B ring
template <int kM, int HP>
constexpr int k3_smem() {
  return HP * kM * 4 + FmaTile<kM, HP>::kBBytes;
}

// the blocks an SM holds by shared memory (227 KB, 1 KB reserved a block):
// the register budget that __launch_bounds__ asks for
template <int kM, int HP>
constexpr int k3_blocks() {
  return 232448 / (k3_smem<kM, HP>() + 1024) > 0 ? 232448 / (k3_smem<kM, HP>() + 1024) : 1;
}

// K3 f32: a block owns kM points and all HP (>= every hidden width, padded)
// columns of each layer.
template <int kM, int HP>
__global__ void __launch_bounds__(FmaTile<kM, HP>::NT, (k3_blocks<kM, HP>()))
fused_point_mlp_kernel(const float* __restrict__ f, int n_feat, int n,
                       const float* __restrict__ w0t, const float* __restrict__ b0,
                       const float* __restrict__ w1t, const float* __restrict__ b1,
                       const float* __restrict__ w2t, const float* __restrict__ b2,
                       const float* __restrict__ w3, const float* __restrict__ b3,
                       float* __restrict__ out, int h0, int h1, int h2) {
  using T = FmaTile<kM, HP>;
  constexpr int NT = T::NT, kK = T::kK;
  extern __shared__ __align__(16) float smem[];
  float* act = smem;              // [HP][kM] activations; fc0's A ring at its start
  float* bring = smem + HP * kM;  // [2][kK][HP] weight rows
  const int n0 = blockIdx.x * kM;

  T t;
  t.init();
  FeatureA<kM, kK, NT> fa{act, f, n_feat, n, n0, (n & 3) == 0 && aligned16(f)};
  contract(t, fa, w0t, n_feat, h0, 0, bring);
  // the decoder tail over the A ring (fma_f32.cuh, shared with K2 f32)
  fma_decoder_tail(t, act, bring, b0, w1t, b1, w2t, b2, w3, b3, out + n0, n - n0, h0, h1, h2);
}

template <int kM, int HP>
int launch(const float* f, int n_feat, int n, const float* w0t, const float* b0,
           const float* w1t, const float* b1, const float* w2t, const float* b2,
           const float* w3, const float* b3, float* out, int h0, int h1, int h2,
           cudaStream_t stream) {
  constexpr int smem = k3_smem<kM, HP>();
  cudaError_t err = cudaFuncSetAttribute(fused_point_mlp_kernel<kM, HP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(((int64_t)n + kM - 1) / kM);
  fused_point_mlp_kernel<kM, HP><<<blocks, FmaTile<kM, HP>::NT, smem, stream>>>(
      f, n_feat, n, w0t, b0, w1t, b1, w2t, b2, w3, b3, out, h0, h1, h2);
  return (int)cudaGetLastError();
}

}  // namespace

// K3 f32: w0t, w1t, w2t the transposed (in, out) weights, w3 (1, h2); hidden
// widths up to 512, each padded in the kernel to HP = 256 or 512
extern "C" int sv3d_fused_point_mlp(const void* f, const void* w0t, const void* b0,
                                    const void* w1t, const void* b1, const void* w2t,
                                    const void* b2, const void* w3, const void* b3,
                                    void* out, int n_feat, int n, int h0, int h1,
                                    int h2, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int hmax = h0 > h1 ? (h0 > h2 ? h0 : h2) : (h1 > h2 ? h1 : h2);
  auto* s = (cudaStream_t)stream;
  const float *F = (const float*)f, *W0 = (const float*)w0t, *B0 = (const float*)b0,
              *W1 = (const float*)w1t, *B1 = (const float*)b1, *W2 = (const float*)w2t,
              *B2 = (const float*)b2, *W3 = (const float*)w3, *B3 = (const float*)b3;
  if (hmax <= 256)
    return launch<96, 256>(F, n_feat, n, W0, B0, W1, B1, W2, B2, W3, B3, (float*)out,
                                     h0, h1, h2, s);
  if (hmax <= 512)
    return launch<48, 512>(F, n_feat, n, W0, B0, W1, B1, W2, B2, W3, B3, (float*)out, h0, h1,
                           h2, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K3 bf16 (see the note at the top).

namespace {

constexpr int kFChunk = 128;  // features of f a chunk of fc0: 8 k16 steps, one A row of kAStride

// A tile's share of one chunk of f, held in registers between its load and
// its store.  Item i: features [8 g, 8 g + 8) of the chunk for points
// [4 q, 4 q + 4) of the tile (g = i % 16, q = i / 16); thread t holds items
// t, t + NT, ...
template <int NT, int kTM>
struct FChunk {
  static constexpr int kItems = (kFChunk / 8) * (kTM / 4);
  static constexpr int kPer = (kItems + NT - 1) / NT;
  float4 v[kPer][8];

  // the loads of the chunk at feature k0 for the tile at point n0; features
  // past F and points past N read as zeros; vec: float4 loads (N % 4 == 0 and
  // f 16-byte aligned, so a quad of points is all in or all out)
  __device__ __forceinline__ void load(const float* __restrict__ f, int n_feat, int n, int n0,
                                       int k0, bool vec) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * NT;
      if (kItems % NT != 0 && i >= kItems) continue;
      const int col = n0 + 4 * (i >> 4);
      const int row0 = k0 + 8 * (i & 15);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float* src = f + (int64_t)(row0 + r) * n + col;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row0 + r < n_feat) {
          if (vec) {
            if (col < n) x = __ldcs(reinterpret_cast<const float4*>(src));
          } else {
            if (col < n) x.x = __ldcs(src);
            if (col + 1 < n) x.y = __ldcs(src + 1);
            if (col + 2 < n) x.z = __ldcs(src + 2);
            if (col + 3 < n) x.w = __ldcs(src + 3);
          }
        }
        v[j][r] = x;
      }
    }
  }

  // rounded to bf16 (round to nearest even) into the [point][feature] A
  // tile a: per item four 16-byte stores, a point's 8 features each
  __device__ __forceinline__ void store(bf16* a) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * NT;
      if (kItems % NT != 0 && i >= kItems) continue;
      uint4* dst = reinterpret_cast<uint4*>(a + 4 * (i >> 4) * kAStride + 8 * (i & 15));
      const float4(&x)[8] = v[j];
      constexpr int kRow = kAStride / 8;  // uint4 a row
      dst[0] = make_uint4(pack_bf16(x[0].x, x[1].x), pack_bf16(x[2].x, x[3].x),
                          pack_bf16(x[4].x, x[5].x), pack_bf16(x[6].x, x[7].x));
      dst[kRow] = make_uint4(pack_bf16(x[0].y, x[1].y), pack_bf16(x[2].y, x[3].y),
                             pack_bf16(x[4].y, x[5].y), pack_bf16(x[6].y, x[7].y));
      dst[2 * kRow] = make_uint4(pack_bf16(x[0].z, x[1].z), pack_bf16(x[2].z, x[3].z),
                                 pack_bf16(x[4].z, x[5].z), pack_bf16(x[6].z, x[7].z));
      dst[3 * kRow] = make_uint4(pack_bf16(x[0].w, x[1].w), pack_bf16(x[2].w, x[3].w),
                                 pack_bf16(x[4].w, x[5].w), pack_bf16(x[6].w, x[7].w));
    }
  }
};

// fc0's running sums.  The tensor cores add a k16 step's products to the
// accumulator rounding toward zero, not to nearest, a bias that grows with
// the steps: summed in one accumulator over fc0's 162 steps at net_res 128,
// the logits' mean error against the plain version reached
// K3_BF16_REL_MEAN_TOL on the H100.  So each chunk's 8 steps go into a fresh
// partial (part) that is then added to the running sums in f32, rounded to
// nearest.
template <int kMT>
struct Fc0Sums {
  float s[kMT][4][4];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[mt][nt][i] = 0.f;
  }
  // s += part; part = 0
  __device__ __forceinline__ void add(float (&part)[kMT][4][4]) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[mt][nt][i] += part[mt][nt][i];
          part[mt][nt][i] = 0.f;
        }
  }
  __device__ __forceinline__ void get(float (&part)[kMT][4][4]) const {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = s[mt][nt][i];
  }
};

template <int NW, int kMT>
struct K3Smem {
  static constexpr int kTM = kMT * 16;
  static constexpr int kABytes = 2 * kTM * kAStride * 2;
  static constexpr int kHBytes = kTM * (NW * 32 + 8) * 2;  // decoder_tail's hidden tile
  static constexpr int kUBytes = kABytes > kHBytes ? kABytes : kHBytes;
  static constexpr int kDepth = kFChunk / 16;  // fc0's B ring: a chunk's 8 steps ahead
  static constexpr int kBytes = kUBytes + NW * kDepth * 2 * 32 * 16;
};

// NW warps, H0 = 32 NW fc0 outputs, kTM = 16 kMT points a block: warp w owns
// fc0 columns [32 w, 32 w + 32) and 256 / NW columns of fc1 and fc2, for
// all kTM points of the tile.
template <int NW, int kMT>
__global__ void __launch_bounds__(NW * 32, 1)
fused_point_mlp_bf16_kernel(const float* __restrict__ f, int n_feat, int n,
                            const uint4* __restrict__ w0f, const float* __restrict__ b0,
                            const uint4* __restrict__ w1f, const float* __restrict__ b1,
                            const uint4* __restrict__ w2f, const float* __restrict__ b2,
                            const float* __restrict__ w3, const float* __restrict__ b3,
                            float* __restrict__ out) {
  using S = K3Smem<NW, kMT>;
  constexpr int NT = NW * 32, H0 = NW * 32, kTM = S::kTM;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  bf16* abuf = reinterpret_cast<bf16*>(smem_bytes);  // A[2][kTM][kAStride], then the hidden
  uint4* ring = reinterpret_cast<uint4*>(smem_bytes + S::kUBytes);  // [NW][kDepth][2][32]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kTM;
  const int k16 = (n_feat + 15) >> 4;  // fc0's k16 steps: W0's rows, padded
  const int n_chunks = (n_feat + kFChunk - 1) / kFChunk;
  const bool vec = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(f) & 15) == 0;
  uint4* my_ring = ring + warp * S::kDepth * 2 * 32;
  BStream<2, S::kDepth> bs0{w0f + warp * 2 * 32, (H0 / 16) * 32, k16, my_ring, lane, 0};
  bs0.start();
  Fc0Sums<kMT> sums;
  sums.init();

  // chunk c's A tile lives in buffer c % 2; the registers hold chunk c + 1
  // while chunk c is multiplied
  FChunk<NT, kTM> fc;
  fc.load(f, n_feat, n, n0, 0, vec);
  fc.store(abuf);
  if (n_chunks > 1) fc.load(f, n_feat, n, n0, kFChunk, vec);
  __syncthreads();

  float part[kMT][4][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;

  int k = 0;  // fc0's k16 step
  for (int c = 0; c < n_chunks; ++c) {
    const bf16* a = abuf + (c & 1) * kTM * kAStride;
    const int steps = min(kFChunk / 16, k16 - k);
    for (int s = 0; s < steps; ++s, ++k) {
      uint32_t bf[4][2];
      bs0.get(k, bf);
      mma_chunk<4>(part, a, kAStride, s * 16, bf, lane);
    }
    sums.add(part);
    // the other buffer's readers finished at the last barrier
    if (c + 1 < n_chunks) {
      fc.store(abuf + ((c + 1) & 1) * kTM * kAStride);
      if (c + 2 < n_chunks) fc.load(f, n_feat, n, n0, (c + 2) * kFChunk, vec);
    }
    __syncthreads();
  }
  sums.get(part);

  decoder_tail<NW, kMT>(part, abuf, b0, w1f, b1, w2f, b2, w3, b3, my_ring, out + n0, n - n0);
}

template <int NW, int kMT>
int launch_bf16(const float* f, int n_feat, int n, const void* w0f, const void* b0,
                const void* w1f, const void* b1, const void* w2f, const void* b2, const void* w3,
                const void* b3, float* out, cudaStream_t stream) {
  constexpr int smem = K3Smem<NW, kMT>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(fused_point_mlp_bf16_kernel<NW, kMT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int kTM = kMT * 16;
  const unsigned blocks = (unsigned)(((int64_t)n + kTM - 1) / kTM);
  fused_point_mlp_bf16_kernel<NW, kMT><<<blocks, NW * 32, smem, stream>>>(
      f, n_feat, n, (const uint4*)w0f, (const float*)b0, (const uint4*)w1f, (const float*)b1,
      (const uint4*)w2f, (const float*)b2, (const float*)w3, (const float*)b3, out);
  return (int)cudaGetLastError();
}

}  // namespace

// K3 bf16: w0f, w1f, w2f in mma_b_fragments order (w0f's rows padded to a
// multiple of 16), w3 rounded to bf16 and held in f32; 64 points a block at
// h0 256, 32 at h0 512
extern "C" int sv3d_fused_point_mlp_bf16(const void* f, const void* w0f, const void* b0,
                                         const void* w1f, const void* b1, const void* w2f,
                                         const void* b2, const void* w3, const void* b3,
                                         void* out, int n_feat, int n, int h0, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  auto* s = (cudaStream_t)stream;
  const float* F = (const float*)f;
  if (h0 == 256)
    return launch_bf16<8, 4>(F, n_feat, n, w0f, b0, w1f, b1, w2f, b2, w3, b3, (float*)out, s);
  if (h0 == 512)
    return launch_bf16<16, 2>(F, n_feat, n, w0f, b0, w1f, b1, w2f, b2, w3, b3, (float*)out, s);
  return (int)cudaErrorInvalidValue;
}
