// Fused RMSNorm over the rows of an (N, D) matrix, for Hopper.
//
// Replaces the TPU kernel repro/kernels/rmsnorm/rmsnorm.py::rmsnorm_rows
// (wrapper repro/kernels/rmsnorm/ops.py::rmsnorm). It computes the same
// function, that of repro/models/layers.py::rms_norm:
//   y[n, :] = (x[n, :] * rsqrt(mean(x[n, :]^2) + eps)) * scale
// in fp32, cast back to the type of x. x and y are fp32 or bf16; scale is
// fp32 or bf16 on its own (fp32 weights normalise bf16 activations). No
// residual add and no gate are fused: the function is rmsnorm_rows'.
//
// What bounds it on the H100. Two flops and a few conversions per element
// against 2 bytes read and 2 written (bf16): far below the ~295 flops per
// byte where the card stops being bound by memory, so the bound is the
// bytes, x read once and y written once. At the LMs' prefill (2048 rows,
// bf16) that is 7.5 us at D = 3072, 6.3 us at 2560 and 12.5 us at 5120 at
// 3.35 TB/s; at decode (4 rows) it is the launch.
//
// What the design does about it: two routes, planned in Python
// (rmsnorm.py::plan, which passes the shape of the work) and checked here.
//  * registers (every row of up to 2048 16-byte vectors: bf16 D <= 16384,
//    fp32 D <= 8192). A row is read once with 16-byte loads (8 bf16 or 4
//    fp32 values a thread a load, neighbouring threads on neighbouring
//    vectors) and stays in registers: VPT vectors a thread (a template
//    argument, 1, 2 or 4) on TPR threads (1-32, a power of two, or a
//    multiple of 32 up to 512; 96 at D = 2560 and 3072, 160 at 5120 in
//    bf16), held as raw 32-bit words (4 a vector) so that a thread's
//    registers stay few and more rows are in flight on each SM. Rows of 32
//    threads or fewer reduce their sum of squares by shuffles alone, and a
//    block holds 256 / TPR of them; wider rows reduce by shuffles, then
//    across their warps through a double-buffered shared array: one block
//    barrier a row, none to reuse the array. The scale is loaded into
//    registers once per thread and reused for every row the block walks:
//    the grid is cut to the blocks the card holds at once, and each block
//    strides over the rows, the loads of its next row issued before the
//    current row's reduction, so they are in flight while it reduces and
//    writes. Rows whose width is not a multiple of the vector (or whose
//    storage is not 16-byte aligned) take the same layout with scalar loads
//    and stores and a bounds check per element.
//  * shared (rows wider than the registers hold, up to 58,112 fp32 values):
//    the port's first kernel. One block of 256 threads a row, the row
//    staged in shared memory as fp32, reduced across the 8 warps, then
//    scaled from shared memory.
//
// The kernels allocate nothing, launch on the stream they are given, and
// the entry point returns cudaGetLastError() (or the error of a refused
// argument); the Python wrapper raises when that is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// registers route
// ---------------------------------------------------------------------------

namespace reg {

constexpr int MAX_THREADS = 512;

// Values are held as raw 32-bit words: a 16-byte vector of x is 4 words
// (8 bf16 or 4 fp32), its scale 2, 4 or 8 words.
template <typename S>
__device__ __forceinline__ float word_value(const uint32_t* w, int v);
template <>
__device__ __forceinline__ float word_value<float>(const uint32_t* w, int v) {
  return __uint_as_float(w[v]);
}
template <>
__device__ __forceinline__ float word_value<__nv_bfloat16>(const uint32_t* w, int v) {
  const uint32_t x = w[v >> 1];
  return __uint_as_float((v & 1) ? (x & 0xffff0000u) : (x << 16));
}

__device__ __forceinline__ uint32_t bits(float s) { return __float_as_uint(s); }
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 s) { return __bfloat16_as_ushort(s); }

// The V values of S at element e0 of a row of d into w: one 8-, 16- or
// 32-byte load, or scalar loads with a bounds check; 0 past d.
template <typename S, int V>
__device__ __forceinline__ void load_words(const S* row, int e0, int d, bool vec,
                                           uint32_t (&w)[V * sizeof(S) / 4]) {
  constexpr int W = V * (int)sizeof(S) / 4;
#pragma unroll
  for (int i = 0; i < W; ++i) w[i] = 0;
  if (vec) {
    if (e0 >= d) return;
    if constexpr (W == 2) {
      const uint2 u = *reinterpret_cast<const uint2*>(row + e0);
      w[0] = u.x;
      w[1] = u.y;
    } else {
#pragma unroll
      for (int q = 0; q < W / 4; ++q) {
        const uint4 u = reinterpret_cast<const uint4*>(row + e0)[q];
        w[4 * q] = u.x;
        w[4 * q + 1] = u.y;
        w[4 * q + 2] = u.z;
        w[4 * q + 3] = u.w;
      }
    }
  } else {
    constexpr int PER_WORD = 4 / (int)sizeof(S);
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (e0 + v < d) w[v / PER_WORD] |= bits(row[e0 + v]) << (32 / PER_WORD * (v % PER_WORD));
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* row, int e0, int d, bool vec, const float (&f)[V]) {
  if (vec) {
    if (e0 >= d) return;
    uint4 u;
    if constexpr (V == 8) {
      const __nv_bfloat162 p0 = __floats2bfloat162_rn(f[0], f[1]);
      const __nv_bfloat162 p1 = __floats2bfloat162_rn(f[2], f[3]);
      const __nv_bfloat162 p2 = __floats2bfloat162_rn(f[4], f[5]);
      const __nv_bfloat162 p3 = __floats2bfloat162_rn(f[6], f[7]);
      u = make_uint4(*reinterpret_cast<const uint32_t*>(&p0), *reinterpret_cast<const uint32_t*>(&p1),
                     *reinterpret_cast<const uint32_t*>(&p2), *reinterpret_cast<const uint32_t*>(&p3));
    } else {
      u = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                     __float_as_uint(f[3]));
    }
    *reinterpret_cast<uint4*>(row + e0) = u;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (e0 + v < d) row[e0 + v] = from_f32<T>(f[v]);
  }
}

// Thread t of a row slot holds the vectors k * tpr + t (k < VPT) of V
// values, as raw words: the scale once, the current row, and the next row
// the slot takes, whose loads are in flight during this row's reduction.
template <typename T, typename S, int VPT>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_rows(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ y,
             long long n, int d, float eps, int tpr, int rows_per_block, int vec) {
  constexpr int V = 16 / (int)sizeof(T);        // values of a 16-byte vector of x
  constexpr int SW = V * (int)sizeof(S) / 4;    // words of its scale
  __shared__ float partial[2][MAX_THREADS / 32];
  const int tid = threadIdx.x;
  const int slot = tid / tpr, t = tid - slot * tpr;
  const int warp = tid / 32, lane = tid % 32;
  const int wpr = tpr / 32;  // warps of a row when tpr >= 32
  const long long stride = (long long)gridDim.x * rows_per_block;

  uint32_t sw[VPT][SW], cur[VPT][4], nxt[VPT][4];
#pragma unroll
  for (int k = 0; k < VPT; ++k) load_words<S, V>(scale, (k * tpr + t) * V, d, vec, sw[k]);
  long long row = (long long)blockIdx.x * rows_per_block + slot;
#pragma unroll
  for (int k = 0; k < VPT; ++k)
    load_words<T, V>(x + (row < n ? row : 0) * d, (k * tpr + t) * V, row < n ? d : 0, vec,
                     cur[k]);

  int parity = 0;
  for (long long r0 = row - slot; r0 < n; r0 += stride, row += stride, parity ^= 1) {
    const long long next = row + stride;
#pragma unroll
    for (int k = 0; k < VPT; ++k)
      load_words<T, V>(x + (next < n ? next : 0) * d, (k * tpr + t) * V, next < n ? d : 0, vec,
                       nxt[k]);
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float f = word_value<T>(cur[k], v);
        ss = fmaf(f, f, ss);
      }
    if (tpr <= 32) {  // the row's lanes are an aligned power-of-two group
      for (int off = tpr / 2; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    } else {
      ss = warp_sum(ss);
      if (lane == 0) partial[parity][warp] = ss;
      __syncthreads();
      ss = 0.f;
      for (int w = slot * wpr; w < (slot + 1) * wpr; ++w) ss += partial[parity][w];
    }
    const float inv = rsqrtf(ss / (float)d + eps);
    if (row < n) {
      T* yr = y + row * d;
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        float o[V];
#pragma unroll
        for (int v = 0; v < V; ++v) o[v] = word_value<T>(cur[k], v) * inv * word_value<S>(sw[k], v);
        store<T, V>(yr, (k * tpr + t) * V, d, vec, o);
      }
    }
#pragma unroll
    for (int k = 0; k < VPT; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) cur[k][i] = nxt[k][i];
  }
}

// The blocks of rmsnorm_rows<T, S, VPT> the card holds at once at a block
// size (a multiple of 32), cached per instantiation and block size.
template <typename T, typename S, int VPT>
int resident_blocks(int threads, int device) {
  static int sms[64] = {0};
  static int per_sm[MAX_THREADS / 32 + 1] = {0};
  int& count = sms[device & 63];
  if (count == 0 &&
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    count = 0;
  int& occ = per_sm[threads / 32];
  if (occ == 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &occ, rmsnorm_rows<T, S, VPT>, threads, 0) != cudaSuccess)
    occ = 0;
  return count * occ;
}

template <typename T, typename S, int VPT>
cudaError_t launch(const void* x, const void* scale, void* y, long long n, int d, float eps,
                   int tpr, int rows, int vec, int device, cudaStream_t stream) {
  const int threads = tpr * rows;
  const long long blocks = (n + rows - 1) / rows;
  const int resident = resident_blocks<T, S, VPT>(threads, device);
  // Each block walks the same number of row groups, within one.
  long long grid = blocks;
  if (resident > 0 && blocks > resident) {
    const long long per = (blocks + resident - 1) / resident;
    grid = (blocks + per - 1) / per;
  }
  rmsnorm_rows<T, S, VPT><<<(unsigned)grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(y), n, d, eps,
      tpr, rows, vec);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t dispatch(const void* x, const void* scale, void* y, long long n, int d, float eps,
                     int vpt, int tpr, int rows, int vec, int device, cudaStream_t stream) {
  switch (vpt) {
    case 1: return launch<T, S, 1>(x, scale, y, n, d, eps, tpr, rows, vec, device, stream);
    case 2: return launch<T, S, 2>(x, scale, y, n, d, eps, tpr, rows, vec, device, stream);
    case 4: return launch<T, S, 4>(x, scale, y, n, d, eps, tpr, rows, vec, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace reg

// ---------------------------------------------------------------------------
// shared route: one block a row, the row staged in shared memory
// ---------------------------------------------------------------------------

namespace smem {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_DEFAULT = 48 * 1024;

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
cudaError_t dispatch(const void* x, const void* scale, void* y, long long n, int d, float eps,
                     cudaStream_t stream) {
  if (n > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = d * (int)sizeof(float);
  if (smem > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        rmsnorm_rows<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  rmsnorm_rows<T, S><<<(unsigned)n, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(y), d, eps);
  return cudaGetLastError();
}

}  // namespace smem

template <typename T, typename S>
cudaError_t dispatch(const void* x, const void* scale, void* y, long long n, int d, float eps,
                     int route, int vpt, int tpr, int rows, int vec, int device,
                     cudaStream_t stream) {
  if (route == 1) return smem::dispatch<T, S>(x, scale, y, n, d, eps, stream);
  return reg::dispatch<T, S>(x, scale, y, n, d, eps, vpt, tpr, rows, vec, device, stream);
}

cudaError_t on_device(int device) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  return e;
}

}  // namespace

extern "C" {

// x, y (n, d), scale (d,), contiguous. x_dtype, s_dtype: 0 = float32, 1 =
// bfloat16. route 0 = registers: vpt (1, 2, 4) 16-byte vectors a thread,
// tpr threads a row (a power of two up to 32, or a multiple of 32 up to
// 512) that cover d, rows rows a block (tpr * rows <= 512), vec 1 for
// 16-byte loads and stores (d a multiple of the vector, x, y and scale
// 16-byte aligned); route 1 = shared (d fp32 values in a block's shared
// memory). Returns a cudaError_t (0 on success).
int repro_rmsnorm(const void* x, const void* scale, void* y, long long n, int d, float eps,
                  int x_dtype, int s_dtype, int route, int vpt, int tpr, int rows, int vec,
                  int device, void* stream) {
  cudaError_t e = on_device(device);
  if (e != cudaSuccess) return (int)e;
  if (n < 1 || d < 1) return (int)cudaErrorInvalidValue;
  if (route == 0) {
    const int v = x_dtype == 0 ? 4 : 8;  // values of a 16-byte vector of x
    const bool shape_ok = (tpr <= 32 ? (tpr >= 1 && (tpr & (tpr - 1)) == 0) : tpr % 32 == 0) &&
                          rows >= 1 && (long long)tpr * rows <= reg::MAX_THREADS &&
                          (long long)vpt * tpr * v >= d;
    const bool vec_ok = !vec || (d % v == 0 && ((uintptr_t)x | (uintptr_t)y | (uintptr_t)scale) % 16 == 0);
    if (!shape_ok || !vec_ok) return (int)cudaErrorInvalidValue;
  } else if (route != 1) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype * 2 + s_dtype) {
    case 0:
      return (int)dispatch<float, float>(x, scale, y, n, d, eps, route, vpt, tpr, rows, vec,
                                         device, st);
    case 1:
      return (int)dispatch<float, __nv_bfloat16>(x, scale, y, n, d, eps, route, vpt, tpr, rows,
                                                 vec, device, st);
    case 2:
      return (int)dispatch<__nv_bfloat16, float>(x, scale, y, n, d, eps, route, vpt, tpr, rows,
                                                 vec, device, st);
    case 3:
      return (int)dispatch<__nv_bfloat16, __nv_bfloat16>(x, scale, y, n, d, eps, route, vpt,
                                                         tpr, rows, vec, device, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
