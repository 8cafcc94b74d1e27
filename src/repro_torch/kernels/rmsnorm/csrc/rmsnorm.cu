// Fused RMSNorm over the rows of an (N, D) matrix, for Hopper.
//
// Replaces the TPU kernel repro/kernels/rmsnorm/rmsnorm.py::rmsnorm_rows
// (wrapper repro/kernels/rmsnorm/ops.py::rmsnorm). It computes the same
// function, that of repro/models/layers.py::rms_norm:
//   y[n, :] = (x[n, :] * rsqrt(mean(x[n, :]^2) + eps)) * scale
// in fp32, cast back to the type of x. x and y are fp32 or bf16; scale is
// fp32 or bf16 on its own (fp32 weights normalise bf16 activations).
//
// What bounds it on the H100. Two flops and a few conversions per element
// against 2 bytes read and 2 written (bf16): far below the ~295 flops per
// byte where the card stops being bound by memory, so the bound is the
// bytes, x read once and y written once. At StarCoder2-3B's prefill
// (2048 x 3072 bf16) that is 25 MB, 7.5 us at 3.35 TB/s; at decode (4 rows)
// it is the launch.
//
// What the design does about it.
//  * One block of 256 threads per row. The row is read from device memory
//    once, neighbouring threads on neighbouring elements, into shared
//    memory as fp32, while each thread sums its squares.
//  * A warp-shuffle reduction, then one across the 8 warps, gives the
//    mean square; the row is scaled from shared memory and written once.
//    So each element is read once and written once: the Pallas kernel's
//    "one read + one write" without its row padding.
//  * Rows wider than 12288 fp32 values (48 KB) ask for more dynamic
//    shared memory; the card gives a block up to 227 KB (58,112 values).
//
// The kernel allocates nothing, launches on the stream it is given and
// returns cudaGetLastError(); the Python wrapper raises when that is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_DEFAULT = 48 * 1024;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, typename S>
__global__ void __launch_bounds__(THREADS)
rmsnorm_rows(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ y,
             int d, float eps) {
  extern __shared__ float row[];  // d values of this row, fp32
  __shared__ float partial[WARPS];
  const T* xr = x + (size_t)blockIdx.x * d;
  T* yr = y + (size_t)blockIdx.x * d;
  const int tid = threadIdx.x;

  float ss = 0.f;
  for (int i = tid; i < d; i += THREADS) {
    const float v = to_f32(xr[i]);
    row[i] = v;
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if (tid % 32 == 0) partial[tid / 32] = ss;
  __syncthreads();
  if (tid < 32) {
    float t = tid < WARPS ? partial[tid] : 0.f;
    t = warp_sum(t);
    if (tid == 0) partial[0] = t;
  }
  __syncthreads();
  const float inv = rsqrtf(partial[0] / (float)d + eps);
  for (int i = tid; i < d; i += THREADS) yr[i] = from_f32<T>(row[i] * inv * to_f32(scale[i]));
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, void* y, int n, int d, float eps,
                   cudaStream_t stream) {
  const int smem = d * (int)sizeof(float);
  if (smem > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        rmsnorm_rows<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  rmsnorm_rows<T, S><<<n, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(y), d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x_dtype, s_dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
int repro_rmsnorm(const void* x, const void* scale, void* y, int n, int d, float eps,
                  int x_dtype, int s_dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype * 2 + s_dtype) {
    case 0: return (int)launch<float, float>(x, scale, y, n, d, eps, st);
    case 1: return (int)launch<float, __nv_bfloat16>(x, scale, y, n, d, eps, st);
    case 2: return (int)launch<__nv_bfloat16, float>(x, scale, y, n, d, eps, st);
    case 3: return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, scale, y, n, d, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
