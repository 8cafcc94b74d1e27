// Direct 2-D convolution (NCHW, OIHW, stride 1, "same" padding) for Hopper.
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
// far more operations than bytes (compute bound); the first layer (C = 3)
// writes 64 output channels from 3 input channels and is bound by memory.
// This kernel runs on the CUDA cores in fp32 (bf16 is widened on the load),
// so its ceiling is the 67 TFLOP/s fp32 rate, not the tensor cores.
//
// What the design does about it.
//  * No padded or windowed copy in device memory: the tile loader checks
//    bounds and writes zeros for the halo, so each input element is read
//    from device memory once per block that needs it, not R times.
//  * Each block computes BK = 64 output channels x (TH x TW) = (8 x 16)
//    output pixels of one image. It stages the TH + R - 1 input rows it
//    needs (the paper's line buffer) and the weight slice, one chunk of
//    input channels at a time, in shared memory, converted to fp32.
//  * Each thread keeps 8 channels x 4 adjacent pixels (32 sums) in fp32
//    registers. Per (c, r) it loads 4 + (S - 1) input values once and slides
//    them along the S taps, and per tap two 16-byte weight loads that the
//    whole warp shares: 32 FMAs for every 3 shared-memory loads.
//  * Tensor cores (wgmma), TMA and double buffering are later work.
//
// The kernel allocates nothing, launches on the stream it is given and
// returns cudaGetLastError(); the Python wrapper raises when that is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
int repro_conv2d(const void* x, const void* w, void* y, int n, int c, int h, int wd, int k,
                 int r, int s, int dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Shape p{n, c, h, wd, k, r, s, (r - 1) / 2, (s - 1) / 2, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(x, w, y, p, st);
    case 1: return (int)launch<__nv_bfloat16>(x, w, y, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
