// 2-D convolution (NCHW, OIHW, stride 1, "same" padding) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/conv2d/conv2d.py::conv2d_windows
// together with the sliding-window re-layout its wrapper makes
// (repro/kernels/conv2d/ops.py::conv2d). It computes the same function:
//   y[n,k,h,w] = sum_{c,r,s} w[k,c,r,s] * x[n,c,h+r-pt,w+s-pl]
// with zero outside the input, an fp32 accumulator, and the result cast to
// the input type (fp32 or bf16). pt = (R-1)/2 and pl = (S-1)/2 pad before;
// R/2 and S/2 pad after.
//
// What bounds it on the H100. A 3x3 layer does 2*9*C multiply-adds for
// each output element it writes, so every VGG-16 layer with C >= 64 needs
// far more operations than bytes (compute bound: in bf16 by the tensor
// cores' 989 TFLOP/s, in fp32 by the CUDA cores' 67); the first layer
// (C = 3) writes 64 output channels from 3 input channels and is bound by
// memory.
//
// What the design does about it: two routes, chosen by the Python plan
// (conv2d.py) and checked here.
//
//  * wgmma (bf16, C % 64 == 0, K % 8 == 0): an implicit GEMM on the tensor
//    cores, on the matmul's TMA + mbarrier + wgmma mainloop (the helpers in
//    kernels/include/hopper.cuh). Pixels are the GEMM's M, output channels
//    its N, (tap, channel) its reduction. A transpose kernel first writes x
//    as NHWC and w as an (R*S*C, K) matrix, K contiguous, into scratch the
//    wrapper allocates (one launch for both). A block computes 128 pixels
//    (a box of BW x BH pixels of one image, BW * BH = 128) x BN = 128
//    output channels (64 where K <= 64, which would leave half of each
//    m64n128 product unstored). K step `it` is tap t = it / (C/64),
//    channel chunk c0 = (it % (C/64)) * 64: the producer warp loads A as
//    one 4-D TMA box of 64 channels x BW x BH pixels at
//    (c0, w0 + s - pl, h0 + r - pt, n), whose signed coordinates run off the
//    image at the border and are zero-filled there (the "same" padding,
//    with no padded copy and no bounds checks), and B as the matmul's
//    64 x 64 boxes at row t*C + c0. The box lands as 128 rows of 64
//    channels, 128-byte swizzled: the matmul's K-major A tile, so its
//    descriptors serve unchanged. Two consumer warpgroups run m64nBNk16 on
//    the ring; two blocks share an SM, so that one's epilogue overlaps the
//    other's loads. The epilogue maps fragment row -> pixel
//    (h0 + row / BW, w0 + row % BW), masks pixels past H or W and channels
//    past K, and writes NCHW from the fragment. Where the tiles alone leave
//    SMs idle (14 x 14 at batch 8), one block per SM with a deeper ring,
//    and the (tap, channel) steps are cut into splits whose fp32 partials a
//    second kernel adds in a fixed order into NCHW.
//  * tf32x3 (fp32, C % 32 == 0): the same implicit GEMM on fp32 split into
//    TF32 halves, x = x_hi + x_lo (hopper.cuh): one TF32 product misses
//    the fp32 tolerance, the three products x_lo w_hi + x_hi w_lo + x_hi
//    w_hi per k8 into one fp32 accumulator carry an fp32 product's error,
//    at 165 TFLOP/s of fp32-accurate work against 67 of fp32 FMA. The
//    re-layout (hopper::split_kernel, one launch) writes x_hi, x_lo as NHWC
//    and w_hi, w_lo as (K, R*S*C), row k holding tap t = r*S + s of channel
//    c at column t*C + c: .tf32 wgmma takes no transpose, so the weights
//    go K-major, each output channel's (tap, channel) run contiguous. A K
//    step is 32 channels (one 128-byte swizzle row of fp32): the producer
//    loads x_hi's and x_lo's 4-D boxes of 32 channels x BW x BH pixels
//    (the same signed coordinates and halo zero fill) and w_hi's and
//    w_lo's boxes of 32 columns x BN rows at column t*C + c0. A stage is
//    2 x 16 KB of pixels and 2 x BN x 128 bytes of weights: 3 stages at
//    BN = 128, 4 at 64, 192 KB, one block per SM; the tensor-core partial
//    sum goes to an fp32 sum in registers every 4 steps (the tensor
//    cores' additions truncate: hopper::TF32X3_PROMOTE). The epilogue and
//    the split reduction are the bf16 route's, writing fp32.
//  * direct (fp32 with C % 32 != 0 (VGG's first layer, C = 3), and bf16
//    shapes TMA cannot take: C % 64 != 0, K % 8 != 0): the CUDA-core
//    kernel of the port's first version. Each
//    block computes BK = 64 output channels x (TH x TW) = (8 x 16) output
//    pixels of one image from the unpadded NCHW input: it stages the
//    TH + R - 1 input rows it needs (the paper's line buffer), zero outside
//    the image, and the weight slice, one chunk of input channels at a
//    time, in shared memory as fp32. Each thread keeps 8 channels x 4
//    adjacent pixels of sums in registers, sliding its input values along
//    the S taps: 32 FMAs for every 3 shared-memory loads. Its ceiling is
//    the 67 TFLOP/s fp32 rate.
//
// The kernels allocate nothing and launch on the stream they are given;
// each entry point returns cudaGetLastError() (or the error of a refused
// argument) and the Python wrapper raises when that is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"  // kernels/include: PTX helpers, tensor-map encoders

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// ---------------------------------------------------------------------------
// direct route: CUDA cores, fp32 arithmetic
// ---------------------------------------------------------------------------

namespace direct {

constexpr int BK = 64;         // output channels per block
constexpr int TH = 8;          // output rows per block
constexpr int TW = 16;         // output columns per block
constexpr int THREADS = 256;   // 8 warps
constexpr int KPT = 8;         // output channels per thread (one warp shares them)
constexpr int PPT = 4;         // adjacent output columns per thread
constexpr int WPAD = BK + 4;   // smem stride of one weight tap: keeps 16-byte
                               // alignment and spreads the loader's stores over banks
constexpr int SMEM_BUDGET = 48 * 1024;

static_assert(THREADS == (BK / KPT) * 32, "one warp per group of KPT channels");
static_assert(TH * (TW / PPT) == 32, "one pixel group per lane");

struct Shape {
  int n, c, h, w, k, r, s, pt, pl, cc;  // cc: input channels per smem chunk
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv2d_direct(const T* __restrict__ x, const T* __restrict__ wt, T* __restrict__ y, Shape p) {
  extern __shared__ __align__(16) float smem[];
  const int rs = p.r * p.s;
  const int xh = TH + p.r - 1;
  const int xw = TW + p.s - 1;
  float* ws = smem;                    // [cc * R * S][WPAD], output channel fastest
  float* xs = smem + p.cc * rs * WPAD; // [cc][xh][xw]

  const int tiles_w = (p.w + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int k0 = blockIdx.y * BK;
  const int n = blockIdx.z;

  const int tid = threadIdx.x;
  const int kg = tid / 32;                  // this warp's channel group
  const int lane = tid % 32;
  const int row = lane / (TW / PPT);        // output row within the tile
  const int col0 = (lane % (TW / PPT)) * PPT;

  float acc[KPT][PPT];
#pragma unroll
  for (int a = 0; a < KPT; ++a)
#pragma unroll
    for (int j = 0; j < PPT; ++j) acc[a][j] = 0.f;

  const size_t hw = (size_t)p.h * p.w;
  const T* xn = x + (size_t)n * p.c * hw;
  const size_t w_stride_k = (size_t)p.c * rs;

  for (int c0 = 0; c0 < p.c; c0 += p.cc) {
    const int cc = min(p.cc, p.c - c0);
    __syncthreads();  // the previous chunk's reads are done

    // Weights: the cc*R*S values of one output channel are contiguous in
    // (K, C, R, S), so consecutive threads read consecutive addresses.
    const int wn = cc * rs;
    for (int i = tid; i < BK * wn; i += THREADS) {
      const int kk = i / wn;
      const int crs = i - kk * wn;
      const int k = k0 + kk;
      float v = 0.f;
      if (k < p.k) v = to_f32(wt[(size_t)k * w_stride_k + (size_t)c0 * rs + crs]);
      ws[crs * WPAD + kk] = v;
    }
    // Input: rows h0-pt .. h0-pt+xh-1 and columns w0-pl .. w0-pl+xw-1 of
    // each channel of the chunk; zero outside the image (the padding).
    const int plane = xh * xw;
    for (int i = tid; i < cc * plane; i += THREADS) {
      const int c = i / plane;
      const int rem = i - c * plane;
      const int hr = rem / xw;
      const int wc = rem - hr * xw;
      const int gh = h0 - p.pt + hr;
      const int gw = w0 - p.pl + wc;
      float v = 0.f;
      if (gh >= 0 && gh < p.h && gw >= 0 && gw < p.w)
        v = to_f32(xn[(size_t)(c0 + c) * hw + (size_t)gh * p.w + gw]);
      xs[i] = v;
    }
    __syncthreads();

    for (int c = 0; c < cc; ++c) {
      for (int r = 0; r < p.r; ++r) {
        const float* xrow = xs + (c * xh + row + r) * xw + col0;
        const float* wtap = ws + (c * rs + r * p.s) * WPAD + kg * KPT;
        float xv[PPT];
#pragma unroll
        for (int j = 0; j < PPT; ++j) xv[j] = xrow[j];
        for (int s = 0; s < p.s; ++s) {
          if (s > 0) {  // slide the window one column right
#pragma unroll
            for (int j = 0; j < PPT - 1; ++j) xv[j] = xv[j + 1];
            xv[PPT - 1] = xrow[s + PPT - 1];
          }
          const float4 wa = *reinterpret_cast<const float4*>(wtap + s * WPAD);
          const float4 wb = *reinterpret_cast<const float4*>(wtap + s * WPAD + 4);
          const float wv[KPT] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int a = 0; a < KPT; ++a)
#pragma unroll
            for (int j = 0; j < PPT; ++j) acc[a][j] = fmaf(wv[a], xv[j], acc[a][j]);
        }
      }
    }
  }

  const int oh = h0 + row;
  if (oh >= p.h) return;
#pragma unroll
  for (int a = 0; a < KPT; ++a) {
    const int k = k0 + kg * KPT + a;
    if (k < p.k) {
      T* yrow = y + ((size_t)n * p.k + k) * hw + (size_t)oh * p.w;
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const int ow = w0 + col0 + j;
        if (ow < p.w) yrow[ow] = from_f32<T>(acc[a][j]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, Shape p, cudaStream_t stream) {
  // As many input channels per chunk as fit the budget, at least one.
  const int per_c =
      (p.r * p.s * WPAD + (TH + p.r - 1) * (TW + p.s - 1)) * (int)sizeof(float);
  int cc = SMEM_BUDGET / per_c;
  cc = cc < 1 ? 1 : (cc > p.c ? p.c : cc);
  p.cc = cc;
  const int smem = cc * per_c;
  if (smem > SMEM_BUDGET) {  // only a very large R x S gets here
    const cudaError_t e = cudaFuncSetAttribute(
        conv2d_direct<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(((p.h + TH - 1) / TH) * ((p.w + TW - 1) / TW), (p.k + BK - 1) / BK, p.n);
  conv2d_direct<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), p);
  return cudaGetLastError();
}

}  // namespace direct

// ---------------------------------------------------------------------------
// wgmma route: implicit GEMM on TMA + mbarrier ring + tensor cores, bf16
// ---------------------------------------------------------------------------

namespace wg {

using hopper::ATOM;            // bf16 values in one 128-byte swizzle row
constexpr int BM = 128;        // pixels per block: two consumer warpgroups of 64
constexpr int BK = 64;         // input channels per K step
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * CONSUMERS + 32;  // consumer warpgroups, producer warp
constexpr int A_BYTES = BM * BK * 2;
constexpr int ATOM_BYTES = BK * ATOM * 2;  // one 64 (k) x 64 (n) box of B: 8 KB
constexpr uint32_t GROUP_BYTES = 1024;     // descriptor stride between groups of 8 rows
static_assert(A_BYTES % 1024 == 0 && ATOM_BYTES % 1024 == 0, "1024-byte aligned tiles");

// A block's output channels (BN: 128, or 64 where K <= 64 would leave half
// of each m64n128 product unstored), its ring depth and how many blocks
// share an SM (two: one block's epilogue overlaps the other's loads).
template <int BN_, int STAGES_, int MIN_BLOCKS_>
struct Cfg {
  static constexpr int BN = BN_, STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int STAGE_BYTES = A_BYTES + BK * BN * 2;
  // the stages, 1024-byte aligned inside the block's window, then the barriers
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
  static_assert(BN == 64 || BN == 128, "one or two 64-wide atoms of B");
};

struct Geo {
  int n, c, h, w, k, r, s, pt, pl;
  int bw, bh;                     // the pixel box: bw columns x bh rows, bw * bh == BM
  int tiles_w, tiles_h, tiles_k;  // boxes across W and H, BN-wide tiles across K
  int steps, kchunk;              // K steps (R * S * C / BK), steps per split
};

// The K chunk of `splits` splits of `steps`; 0 if the count does not come
// back from the chunk (the plan settles on counts that do).
int kchunk_of(int steps, int splits) {
  if (splits < 1 || splits > steps) return 0;
  const int kchunk = ceil_div(steps, splits);
  return ceil_div(steps, kchunk) == splits ? kchunk : 0;
}

// The epilogue of both implicit-GEMM routes: this consumer thread's part of
// a 128-pixel x BN-channel tile (at pixel (h0, w0) of image img, output
// channel n0) from the m64nBN fragment, cast and written to y, or as an
// fp32 partial to ws[blockIdx.z] (laid out as y is) when ws is given.
// Warp w of warpgroup wgi holds rows 16w + lane/4 (+ 8), columns 8j +
// 2 (lane % 4) (+ 1) in acc[4j + {0, 1}] (+ {2, 3}). Row i of the box is
// pixel (h0 + i / bw, w0 + i % bw); column j is output channel n0 + j.
// Written straight from the fragment: 16-byte runs of one channel per
// store; staging the tile through shared memory for whole sectors measured
// 1-10 % slower at every VGG-16 shape (PERF.md).
template <int BN, typename T>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2], T* __restrict__ y,
                                           float* __restrict__ ws, const Geo& g, int img, int h0,
                                           int w0, int n0) {
  const int tid = threadIdx.x, wgi = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const size_t hw = (size_t)g.h * g.w;
  size_t pix[2];
  bool inside[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wgi * 64 + warp * 16 + lane / 4 + 8 * h;
    const int ph = h0 + row / g.bw, pw = w0 + row % g.bw;
    inside[h] = ph < g.h && pw < g.w;
    pix[h] = (size_t)img * g.k * hw + (size_t)ph * g.w + pw;
  }
  float* part = ws == nullptr ? nullptr : ws + (size_t)blockIdx.z * g.n * g.k * hw;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int col = n0 + 8 * j + 2 * (lane % 4) + b;
      if (col >= g.k) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!inside[h]) continue;
        const size_t at = pix[h] + (size_t)col * hw;
        const float v = acc[4 * j + 2 * h + b];
        if (part != nullptr)
          part[at] = v;
        else
          y[at] = from_f32<T>(v);
      }
    }
  }
}

// One split (blockIdx.z) of one 128-pixel x BN-channel tile. With
// ws == nullptr the tile is cast and written to y; otherwise its fp32
// partial goes to ws[blockIdx.z], laid out as y is.
template <typename CF>
__global__ void __launch_bounds__(THREADS, CF::MIN_BLOCKS)
conv2d_wgmma(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
             __nv_bfloat16* __restrict__ y, float* __restrict__ ws, const Geo g) {
  using namespace hopper;
  constexpr int STAGES = CF::STAGES, BN = CF::BN, STAGE_BYTES = CF::STAGE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = base + STAGES * STAGE_BYTES, empty0 = full0 + STAGES * 8;

  // Blocks walk the output-channel tiles fastest, so the blocks in flight
  // share their pixel boxes in L2; the weights (at most a few MB) stay there.
  const int n0 = (blockIdx.x % g.tiles_k) * BN;
  int rest = blockIdx.x / g.tiles_k;
  const int w0 = (rest % g.tiles_w) * g.bw;
  rest /= g.tiles_w;
  const int h0 = (rest % g.tiles_h) * g.bh;
  const int img = rest / g.tiles_h;
  const int it0 = blockIdx.z * g.kchunk;
  const int n_k = min(g.steps, it0 + g.kchunk) - it0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);                  // the producer's expect_tx
      mbar_init(empty0 + 8 * s, CONSUMERS * 128);  // every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS * 128) {  // the producer warp; one thread issues
    if (tid == CONSUMERS * 128) {
      const int chunks = g.c / BK;
      // A second atom of B wholly past K is not loaded: the channels it
      // would feed are not stored.
      const bool two = BN == 128 && n0 + ATOM < g.k;
      for (int it = 0; it < n_k; ++it) {
        const int st = it % STAGES;
        mbar_wait(empty0 + 8 * st, ((it / STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * st, sa = base + st * STAGE_BYTES;
        const uint32_t sb = sa + A_BYTES;
        const int step = it0 + it;
        const int t = step / chunks, c0 = (step - t * chunks) * BK;
        const int r = t / g.s, s = t - r * g.s;
        // The A box counts whole, its zero fill included.
        mbar_arrive_expect_tx(full, A_BYTES + (two ? 2 : 1) * ATOM_BYTES);
        tma_load_4d(sa, &map_x, full, c0, w0 + s - g.pl, h0 + r - g.pt, img);
        tma_load_2d(sb, &map_w, full, n0, t * g.c + c0);
        if (two) tma_load_2d(sb + ATOM_BYTES, &map_w, full, n0 + ATOM, t * g.c + c0);
      }
    }
    return;
  }

  const int wgi = tid / 128;  // this consumer warpgroup's 64 pixels of the box
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_operands(acc);
  for (int it = 0; it < n_k; ++it) {
    const int st = it % STAGES;
    mbar_wait(full0 + 8 * st, (it / STAGES) & 1);
    const uint32_t sa = base + st * STAGE_BYTES + wgi * 64 * 128;
    const uint32_t sb = base + st * STAGE_BYTES + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {  // 16 channels a product: 32 bytes along A's rows
      const uint64_t da = make_desc(sa + kk * 32, 16, GROUP_BYTES);
      const uint64_t db = make_desc(sb + kk * 16 * 128, ATOM_BYTES, GROUP_BYTES);
      if constexpr (BN == 128)
        wgmma_m64n128k16(acc, da, db);
      else
        wgmma_m64n64k16(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's group has retired: release that stage
    if (it > 0) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_operands(acc);
  store_tile<BN>(acc, y, ws, g, img, h0, w0, n0);
}

// y = cast(sum over z of ws[z]), the partials added in order z = 0, 1, ...
template <typename T>
__global__ void __launch_bounds__(256)
splitk_reduce(const float* __restrict__ ws, T* __restrict__ y, size_t total, int splits) {
  for (size_t i = (size_t)blockIdx.x * 256 + threadIdx.x; i < total;
       i += (size_t)gridDim.x * 256) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * total + i];
    y[i] = from_f32<T>(s);
  }
}

template <typename T>
cudaError_t reduce(const float* ws, T* y, const Geo& g, int splits, cudaStream_t stream) {
  const size_t total = (size_t)g.n * g.k * g.h * g.w;
  const long long rb = ((long long)total + 255) / 256;
  splitk_reduce<T><<<(int)(rb < 8 * 132 ? rb : 8 * 132), 256, 0, stream>>>(ws, y, total, splits);
  return cudaGetLastError();
}

// The operands' re-layout: in (batch, P, Q) -> out (batch, Q, P), row
// q = c * RS + t of the transpose going to row t * (Q / RS) + c. x
// (N, C, H*W) with RS = 1 gives NHWC; w (K, C*R*S) with RS = R*S gives the
// (R*S*C, K) matrix, row t*C + c holding tap t of channel c. One launch
// does both: its first blocks take x's 64 x 64 tiles, the rest w's.
struct Transpose {
  const __nv_bfloat16* in;
  __nv_bfloat16* out;
  int p_n, q_n, rs;      // in is (batch, p_n, q_n)
  int tiles_q, tiles_p;  // 64 x 64 tiles of one plane
  bool pairs;            // 4-byte accesses: p_n and q_n even, both pointers 4-byte aligned
};

// [p][q], rows of 66: 4-byte aligned pairs, and the column reads of the
// write pass fall on distinct banks but for pairs of lanes.
using Tile = __nv_bfloat16[64][66];

// Tile b of job j through shared memory: reads run along q and writes
// along p, V elements a thread (V = 2: a warp moves 128 contiguous bytes).
template <int V>
__device__ __forceinline__ void transpose_tile(const Transpose j, int b, Tile& tile) {
  constexpr int TPR = 64 / V;     // threads along one 64-wide row of the tile
  constexpr int RPP = 256 / TPR;  // rows a pass covers
  const int per_plane = j.tiles_q * j.tiles_p;
  const int z = b / per_plane, rest = b - z * per_plane;
  const int q0 = (rest % j.tiles_q) * 64, p0 = (rest / j.tiles_q) * 64;
  const size_t plane = (size_t)j.p_n * j.q_n;
  const __nv_bfloat16* in = j.in + z * plane;
  __nv_bfloat16* out = j.out + z * plane;
  const int lo = (threadIdx.x % TPR) * V, row = threadIdx.x / TPR;
#pragma unroll
  for (int i = row; i < 64; i += RPP) {
    const int p = p0 + i, q = q0 + lo;  // with V = 2, q_n is even: q + 1 < q_n too
    const bool ok = p < j.p_n && q < j.q_n;
    if constexpr (V == 2) {
      __nv_bfloat162 v = __float2bfloat162_rn(0.f);
      if (ok) v = *reinterpret_cast<const __nv_bfloat162*>(in + (size_t)p * j.q_n + q);
      *reinterpret_cast<__nv_bfloat162*>(&tile[i][lo]) = v;
    } else {
      tile[i][lo] = ok ? in[(size_t)p * j.q_n + q] : __float2bfloat16(0.f);
    }
  }
  __syncthreads();
  const int per = j.q_n / j.rs;
#pragma unroll
  for (int i = row; i < 64; i += RPP) {
    const int q = q0 + i, p = p0 + lo;  // with V = 2, p_n is even: p + 1 < p_n too
    if (q >= j.q_n || p >= j.p_n) continue;
    __nv_bfloat16* dst = out + ((size_t)(q % j.rs) * per + q / j.rs) * j.p_n + p;
    if constexpr (V == 2) {
      __nv_bfloat162 v;
      v.x = tile[lo][i];
      v.y = tile[lo + 1][i];
      *reinterpret_cast<__nv_bfloat162*>(dst) = v;
    } else {
      *dst = tile[lo][i];
    }
  }
}

// Each branch reads its own parameter struct by value: no copy of either to
// local memory.
__global__ void __launch_bounds__(256)
relayout_kernel(const Transpose x, const Transpose w, int blocks_x) {
  __shared__ __align__(16) Tile tile;
  const int b = blockIdx.x;
  if (b < blocks_x) {
    if (x.pairs)
      transpose_tile<2>(x, b, tile);
    else
      transpose_tile<1>(x, b, tile);
  } else if (w.pairs) {
    transpose_tile<2>(w, b - blocks_x, tile);
  } else {
    transpose_tile<1>(w, b - blocks_x, tile);
  }
}

Transpose transpose_job(const void* in, void* out, int p_n, int q_n, int rs) {
  const bool pairs = p_n % 2 == 0 && q_n % 2 == 0 && ((uintptr_t)in | (uintptr_t)out) % 4 == 0;
  return Transpose{static_cast<const __nv_bfloat16*>(in), static_cast<__nv_bfloat16*>(out), p_n,
                   q_n, rs, ceil_div(q_n, 64), ceil_div(p_n, 64), pairs};
}

// x (N, C, H, W) -> xt (N, H, W, C); w (K, C, R, S) -> wt (R * S * C, K).
cudaError_t relayout(const void* x, const void* w, void* xt, void* wt, const Geo& g,
                     cudaStream_t stream) {
  const Transpose tx = transpose_job(x, xt, g.c, g.h * g.w, 1);
  const Transpose tw = transpose_job(w, wt, g.k, g.c * g.r * g.s, g.r * g.s);
  const long long bx = (long long)tx.tiles_q * tx.tiles_p * g.n;
  const long long blocks = bx + (long long)tw.tiles_q * tw.tiles_p;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  relayout_kernel<<<(unsigned)blocks, 256, 0, stream>>>(tx, tw, (int)bx);
  return cudaGetLastError();
}

// x: NCHW, w: (K, C, R, S), y: NCHW, all bf16; xt and wt: the re-laid-out
// operands (written here first), 16-byte aligned. The re-layout is queued
// before the tensor maps are encoded, so the card starts while the host
// encodes.
template <typename CF>
cudaError_t launch(const void* x, const void* w, void* y, void* xt, void* wt, float* ws, Geo g,
                   int splits, int device, cudaStream_t stream) {
  if (g.c % BK || g.k % 8 || g.bw < 1 || g.bh < 1 || g.bw * g.bh != BM ||
      ((uintptr_t)xt | (uintptr_t)wt) % 16 || (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  g.steps = g.r * g.s * (g.c / BK);
  g.kchunk = kchunk_of(g.steps, splits);
  g.tiles_w = ceil_div(g.w, g.bw);
  g.tiles_h = ceil_div(g.h, g.bh);
  g.tiles_k = ceil_div(g.k, CF::BN);
  const long long blocks = (long long)g.tiles_k * g.tiles_w * g.tiles_h * g.n;
  if (g.kchunk == 0 || blocks > 0x7fffffffLL || splits > 65535) return cudaErrorInvalidValue;
  cudaError_t e = relayout(x, w, xt, wt, g, stream);
  if (e != cudaSuccess) return e;
  CUtensorMap map_x, map_w;
  if (!hopper::encode_4d(&map_x, xt, g.n, g.h, g.w, g.c, g.bw, g.bh) ||
      !hopper::encode_2d(&map_w, wt, g.r * g.s * g.c, g.k, BK))
    return cudaErrorInvalidValue;
  // Above 48 KB of dynamic shared memory a kernel must opt in, once per device.
  static std::atomic<unsigned long long> ready{0};
  const unsigned long long bit = 1ull << (device & 63);
  if (!(ready.load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(conv2d_wgmma<CF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             CF::SMEM);
    if (e != cudaSuccess) return e;
    ready.fetch_or(bit);
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(y);
  conv2d_wgmma<CF><<<dim3((unsigned)blocks, 1, splits), THREADS, CF::SMEM, stream>>>(
      map_x, map_w, out, splits > 1 ? ws : nullptr, g);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return reduce(ws, out, g, splits, stream);
}

// (tile_n, blocks per SM) -> the kernel's configuration.
cudaError_t dispatch(int tile_n, int blocks, const void* x, const void* w, void* y, void* xt,
                     void* wt, float* ws, const Geo& g, int splits, int device,
                     cudaStream_t stream) {
  switch (tile_n * 4 + blocks) {
    case 128 * 4 + 1: return launch<Cfg<128, 4, 1>>(x, w, y, xt, wt, ws, g, splits, device, stream);
    case 128 * 4 + 2: return launch<Cfg<128, 3, 2>>(x, w, y, xt, wt, ws, g, splits, device, stream);
    case 64 * 4 + 1: return launch<Cfg<64, 4, 1>>(x, w, y, xt, wt, ws, g, splits, device, stream);
    case 64 * 4 + 2: return launch<Cfg<64, 4, 2>>(x, w, y, xt, wt, ws, g, splits, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// tf32x3 route: the implicit GEMM on fp32 split into TF32 halves
// ---------------------------------------------------------------------------

namespace tf {

using wg::Geo;
constexpr int BM = 128;                   // pixels per block: two consumer warpgroups of 64
constexpr int BK = hopper::ATOM_F32;      // input channels per K step, one 128-byte swizzle row
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * CONSUMERS + 32;  // consumer warpgroups, producer warp
constexpr int A_BYTES = BM * BK * 4;           // one half of the pixel box: 16 KB

// BN output channels a block (128, or 64 where K <= 64) and the ring depth
// that fills 192 KB: one block per SM.
template <int BN_, int STAGES_>
struct Cfg {
  static constexpr int BN = BN_, STAGES = STAGES_;
  static constexpr int B_BYTES = BN * BK * 4;
  static constexpr int STAGE_BYTES = 2 * A_BYTES + 2 * B_BYTES;  // x_hi, x_lo, w_hi, w_lo
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
  static_assert(BN == 64 || BN == 128, "m64n64k8 or m64n128k8");
  static_assert(B_BYTES % 1024 == 0, "1024-byte aligned tiles");
};

// The split operands: x_hi, x_lo (N, H, W, C) and w_hi, w_lo (K, R*S*C).
struct Split {
  float *x_hi, *x_lo, *w_hi, *w_lo;
};

// x (N, C, H, W) -> x_hi, x_lo (N, H, W, C); w (K, C, R, S) -> w_hi, w_lo
// (K, R*S*C); one launch.
cudaError_t split(const void* x, const void* w, const Split& o, const Geo& g,
                  cudaStream_t stream) {
  return hopper::split_launch(
      hopper::split_job(x, o.x_hi, o.x_lo, g.c, g.h * g.w, g.c, true), g.n,
      hopper::split_job(w, o.w_hi, o.w_lo, g.c, g.r * g.s, g.c, true), g.k, stream);
}

// One split (blockIdx.z) of one 128-pixel x BN-channel tile; as
// wg::conv2d_wgmma, on four maps and in fp32.
template <typename CF>
__global__ void __launch_bounds__(THREADS, 1)
conv2d_tf32x3(const __grid_constant__ CUtensorMap map_xhi, const __grid_constant__ CUtensorMap map_xlo,
              const __grid_constant__ CUtensorMap map_whi, const __grid_constant__ CUtensorMap map_wlo,
              float* __restrict__ y, float* __restrict__ ws, const Geo g) {
  using namespace hopper;
  constexpr int STAGES = CF::STAGES, BN = CF::BN, STAGE_BYTES = CF::STAGE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = base + STAGES * STAGE_BYTES, empty0 = full0 + STAGES * 8;

  const int n0 = (blockIdx.x % g.tiles_k) * BN;
  int rest = blockIdx.x / g.tiles_k;
  const int w0 = (rest % g.tiles_w) * g.bw;
  rest /= g.tiles_w;
  const int h0 = (rest % g.tiles_h) * g.bh;
  const int img = rest / g.tiles_h;
  const int it0 = blockIdx.z * g.kchunk;
  const int n_k = min(g.steps, it0 + g.kchunk) - it0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);                  // the producer's expect_tx
      mbar_init(empty0 + 8 * s, CONSUMERS * 128);  // every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS * 128) {  // the producer warp; one thread issues
    if (tid == CONSUMERS * 128) {
      const int chunks = g.c / BK;
      for (int it = 0; it < n_k; ++it) {
        const int st = it % STAGES;
        mbar_wait(empty0 + 8 * st, ((it / STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * st, sa = base + st * STAGE_BYTES;
        const uint32_t sb = sa + 2 * A_BYTES;
        const int step = it0 + it;
        const int t = step / chunks, c0 = (step - t * chunks) * BK;
        const int r = t / g.s, s = t - r * g.s;
        const int cw = w0 + s - g.pl, ch = h0 + r - g.pt;
        // Every box counts whole, its zero fill included.
        mbar_arrive_expect_tx(full, STAGE_BYTES);
        tma_load_4d(sa, &map_xhi, full, c0, cw, ch, img);
        tma_load_4d(sa + A_BYTES, &map_xlo, full, c0, cw, ch, img);
        tma_load_2d(sb, &map_whi, full, t * g.c + c0, n0);
        tma_load_2d(sb + CF::B_BYTES, &map_wlo, full, t * g.c + c0, n0);
      }
    }
    return;
  }

  const int wgi = tid / 128;  // this consumer warpgroup's 64 pixels of the box
  float acc[BN / 2];
  tf32x3_consume<BN, BK, STAGES, STAGE_BYTES, A_BYTES, CF::B_BYTES>(acc, base, full0, empty0,
                                                                    n_k, wgi * 64 * 128);
  wg::store_tile<BN>(acc, y, ws, g, img, h0, w0, n0);
}

// x: NCHW, w: (K, C, R, S), y: NCHW, all fp32; o: the split operands
// (written here first), 16-byte aligned.
template <typename CF>
cudaError_t launch(const void* x, const void* w, void* y, const Split& o, float* ws, Geo g,
                   int splits, int device, cudaStream_t stream) {
  if (g.c % BK || g.bw < 1 || g.bh < 1 || g.bw * g.bh != BM ||
      ((uintptr_t)o.x_hi | (uintptr_t)o.x_lo | (uintptr_t)o.w_hi | (uintptr_t)o.w_lo) % 16 ||
      (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  g.steps = g.r * g.s * (g.c / BK);
  g.kchunk = wg::kchunk_of(g.steps, splits);
  g.tiles_w = ceil_div(g.w, g.bw);
  g.tiles_h = ceil_div(g.h, g.bh);
  g.tiles_k = ceil_div(g.k, CF::BN);
  const long long blocks = (long long)g.tiles_k * g.tiles_w * g.tiles_h * g.n;
  if (g.kchunk == 0 || blocks > 0x7fffffffLL || splits > 65535) return cudaErrorInvalidValue;
  cudaError_t e = split(x, w, o, g, stream);
  if (e != cudaSuccess) return e;
  const int rsc = g.r * g.s * g.c;
  CUtensorMap xhi, xlo, whi, wlo;
  if (!hopper::encode_4d_f32(&xhi, o.x_hi, g.n, g.h, g.w, g.c, g.bw, g.bh) ||
      !hopper::encode_4d_f32(&xlo, o.x_lo, g.n, g.h, g.w, g.c, g.bw, g.bh) ||
      !hopper::encode_2d_f32(&whi, o.w_hi, g.k, rsc, CF::BN) ||
      !hopper::encode_2d_f32(&wlo, o.w_lo, g.k, rsc, CF::BN))
    return cudaErrorInvalidValue;
  // Above 48 KB of dynamic shared memory a kernel must opt in, once per device.
  static std::atomic<unsigned long long> ready{0};
  const unsigned long long bit = 1ull << (device & 63);
  if (!(ready.load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(conv2d_tf32x3<CF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             CF::SMEM);
    if (e != cudaSuccess) return e;
    ready.fetch_or(bit);
  }
  float* out = static_cast<float*>(y);
  conv2d_tf32x3<CF><<<dim3((unsigned)blocks, 1, splits), THREADS, CF::SMEM, stream>>>(
      xhi, xlo, whi, wlo, out, splits > 1 ? ws : nullptr, g);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return wg::reduce(ws, out, g, splits, stream);
}

cudaError_t dispatch(int tile_n, const void* x, const void* w, void* y, const Split& o, float* ws,
                     const Geo& g, int splits, int device, cudaStream_t stream) {
  switch (tile_n) {
    case 128: return launch<Cfg<128, 3>>(x, w, y, o, ws, g, splits, device, stream);
    case 64: return launch<Cfg<64, 4>>(x, w, y, o, ws, g, splits, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tf

}  // namespace

extern "C" {

// The direct route. dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t
// (0 on success).
int repro_conv2d(const void* x, const void* w, void* y, int n, int c, int h, int wd, int k,
                 int r, int s, int dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const direct::Shape p{n, c, h, wd, k, r, s, (r - 1) / 2, (s - 1) / 2, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)direct::launch<float>(x, w, y, p, st);
    case 1: return (int)direct::launch<__nv_bfloat16>(x, w, y, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

static cudaError_t on_device(int device) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  return e;
}

// The wgmma route, bf16 only: x (N, C, H, W), w (K, C, R, S), y (N, K, H,
// W); xt (N, H, W, C) and wt (R * S * C, K) are scratch the call fills with
// the re-laid-out operands; a box of bw x bh = 128 pixels; splits > 1 takes
// an fp32 workspace of splits * N * K * H * W values; blocks per SM: 1 or 2;
// tile_n: output channels per block, 128 or 64. Returns a cudaError_t (0 on
// success).
int repro_conv2d_wgmma(const void* x, const void* w, void* y, void* xt, void* wt, void* ws,
                       int n, int c, int h, int wd, int k, int r, int s, int bw, int bh,
                       int splits, int blocks, int tile_n, int device, void* stream) {
  cudaError_t e = on_device(device);
  if (e != cudaSuccess) return (int)e;
  const wg::Geo g{n, c, h, wd, k, r, s, (r - 1) / 2, (s - 1) / 2, bw, bh, 0, 0, 0, 0, 0};
  return (int)wg::dispatch(tile_n, blocks, x, w, y, xt, wt, static_cast<float*>(ws), g, splits,
                           device, static_cast<cudaStream_t>(stream));
}

// The wgmma route's re-layout alone (x -> xt, w -> wt as above), for tests
// and timing.
int repro_conv2d_relayout(const void* x, const void* w, void* xt, void* wt, int n, int c,
                          int h, int wd, int k, int r, int s, int device, void* stream) {
  cudaError_t e = on_device(device);
  if (e != cudaSuccess) return (int)e;
  const wg::Geo g{n, c, h, wd, k, r, s, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  return (int)wg::relayout(x, w, xt, wt, g, static_cast<cudaStream_t>(stream));
}

// The tf32x3 route, fp32 only: x, w, y as the wgmma route's; x_hi, x_lo
// (N, H, W, C) and w_hi, w_lo (K, R * S * C) are scratch the call fills with
// the split operands, 16-byte aligned; a box of bw x bh = 128 pixels; splits
// > 1 takes an fp32 workspace of splits * N * K * H * W values; tile_n:
// output channels per block, 128 or 64. Returns a cudaError_t (0 on
// success).
int repro_conv2d_tf32x3(const void* x, const void* w, void* y, void* x_hi, void* x_lo,
                        void* w_hi, void* w_lo, void* ws, int n, int c, int h, int wd, int k,
                        int r, int s, int bw, int bh, int splits, int tile_n, int device,
                        void* stream) {
  cudaError_t e = on_device(device);
  if (e != cudaSuccess) return (int)e;
  const wg::Geo g{n, c, h, wd, k, r, s, (r - 1) / 2, (s - 1) / 2, bw, bh, 0, 0, 0, 0, 0};
  const tf::Split o{static_cast<float*>(x_hi), static_cast<float*>(x_lo),
                    static_cast<float*>(w_hi), static_cast<float*>(w_lo)};
  return (int)tf::dispatch(tile_n, x, w, y, o, static_cast<float*>(ws), g, splits, device,
                           static_cast<cudaStream_t>(stream));
}

// The tf32x3 route's split re-layout alone (x -> x_hi, x_lo; w -> w_hi,
// w_lo as above), for tests and timing.
int repro_conv2d_split(const void* x, const void* w, void* x_hi, void* x_lo, void* w_hi,
                       void* w_lo, int n, int c, int h, int wd, int k, int r, int s, int device,
                       void* stream) {
  cudaError_t e = on_device(device);
  if (e != cudaSuccess) return (int)e;
  const wg::Geo g{n, c, h, wd, k, r, s, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  const tf::Split o{static_cast<float*>(x_hi), static_cast<float*>(x_lo),
                    static_cast<float*>(w_hi), static_cast<float*>(w_lo)};
  return (int)tf::split(x, w, o, g, static_cast<cudaStream_t>(stream));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
