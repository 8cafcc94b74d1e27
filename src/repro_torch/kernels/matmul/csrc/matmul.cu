// Tiled matrix product C = A @ B with an fp32 accumulator, for Hopper.
//
// Replaces the TPU kernel repro/kernels/matmul/matmul.py::matmul_blocked
// (wrapper repro/kernels/matmul/ops.py::matmul). It computes the same
// function: A (M, K) @ B (K, N), both fp32 or both bf16, row-major, summed
// in fp32 and cast to the output type (fp32 or bf16). There is no padding:
// the tile loaders check bounds and write zeros past the edges.
//
// What bounds it on the H100. At StarCoder2-3B's prefill (M = 2048 rows of
// activations against K x N weights of 3072 x 3072 up to 3072 x 49152) a
// product does 2*M*K*N operations on (M*K + K*N + M*N) elements: hundreds
// of operations per byte, so it is bound by operations, and in bf16 the
// bound is the tensor cores' 989 TFLOP/s. This kernel runs on the CUDA
// cores in fp32 (bf16 is widened on the load), so its ceiling is the
// 67 TFLOP/s fp32 rate. At decode (M = 4) every weight is used for 4 rows
// only: a product is bound by reading B once, 6.4 GB per decode step of
// the model, 1.9 ms at 3.35 TB/s.
//
// What the design does about it.
//  * Two tile shapes. For M > 64, a block computes a 128 x 128 tile of C
//    with 256 threads, each holding an 8 x 8 block of fp32 sums in
//    registers: per K step it reads 8 + 8 values from shared memory (as
//    16-byte loads) for 64 FMAs. For M <= 64 (decode) the block is
//    16 x 128 (one row and 8 columns a thread), so a 4-row product wastes
//    12 of 16 rows, not 124 of 128.
//  * Tiles of A (stored transposed, so a thread's rows are contiguous) and
//    B go through shared memory one K step at a time; the next step's
//    tiles are loaded into registers while the current one is computed.
//  * Split K. When the tiles of C give fewer than two blocks per SM (every
//    decode product, and the narrow K/V projections at prefill), the K
//    range is cut into chunks of at least 256, each block writes an fp32
//    partial tile into a workspace the wrapper allocates, and a second
//    kernel adds the partials in a fixed order and casts. So the 24 tiles
//    of a 4 x 3072 decode product still keep ~264 blocks reading weights.
//  * Tensor cores (wgmma), TMA and a multi-stage pipeline are later work.
//
// The kernels allocate nothing, launch on the stream they are given and
// the entry point returns cudaGetLastError(); the Python wrapper raises
// when that is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr int SMALL_M = 64;        // M at or below this takes the 16-row tile
constexpr int MIN_KCHUNK = 256;    // split K no finer than this
constexpr int BLOCKS_PER_SM = 2;   // split K until the grid has this many blocks per SM

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

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

template <int BM_, int BN_, int BK_, int TM_, int TN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int AP = BM + 4;  // row stride of the transposed A tile: 16-byte rows
  static constexpr int A_PER = BM * BK / THREADS;  // A elements each thread loads
  static constexpr int B_PER = BK * BN / THREADS;
  static_assert((BM / TM) * (BN / TN) == THREADS, "one TM x TN block of C per thread");
  static_assert(BM * BK % THREADS == 0 && BK * BN % THREADS == 0, "even tile loads");
};
using Large = Tile<128, 128, 16, 8, 8>;
using Small = Tile<16, 128, 32, 1, 8>;

// One K chunk (blockIdx.z) of one BM x BN tile of C. With ws == nullptr the
// tile is cast and written to c; otherwise its fp32 partial goes to
// ws[blockIdx.z].
template <typename TL, typename TA, typename TC>
__global__ void __launch_bounds__(THREADS)
matmul_tiled(const TA* __restrict__ a, const TA* __restrict__ b, TC* __restrict__ c,
             float* __restrict__ ws, int m, int n, int k, int kchunk) {
  constexpr int BM = TL::BM, BN = TL::BN, BK = TL::BK, TM = TL::TM, TN = TL::TN;
  __shared__ __align__(16) float as[BK][TL::AP];
  __shared__ __align__(16) float bs[BK][BN];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * kchunk;
  const int ke = min(k, kb + kchunk);
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  float ra[TL::A_PER], rb[TL::B_PER];  // the next K step's tiles, in flight
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < TL::A_PER; ++j) {
      const int i = tid + j * THREADS;
      const int gm = m0 + i / BK, gk = k0 + i % BK;
      ra[j] = (gm < m && gk < ke) ? to_f32(a[(size_t)gm * k + gk]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < TL::B_PER; ++j) {
      const int i = tid + j * THREADS;
      const int gk = k0 + i / BN, gn = n0 + i % BN;
      rb[j] = (gk < ke && gn < n) ? to_f32(b[(size_t)gk * n + gn]) : 0.f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int j = 0; j < TL::A_PER; ++j) {
      const int i = tid + j * THREADS;
      as[i % BK][i / BK] = ra[j];
    }
#pragma unroll
    for (int j = 0; j < TL::B_PER; ++j) {
      const int i = tid + j * THREADS;
      bs[i / BN][i % BN] = rb[j];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  fetch(kb);
  for (int k0 = kb; k0 < ke; k0 += BK) {
    __syncthreads();  // the previous step's reads of the tiles are done
    stash();
    __syncthreads();
    if (k0 + BK < ke) fetch(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
      load_vec<TM>(&as[kk][ty * TM], av);
      load_vec<TN>(&bs[kk][tx * TN], bv);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= n) continue;
      if (ws != nullptr)
        ws[((size_t)blockIdx.z * m + gm) * n + gn] = acc[i][j];
      else
        c[(size_t)gm * n + gn] = from_f32<TC>(acc[i][j]);
    }
  }
}

// c = cast(sum over z of ws[z]), the partials added in order z = 0, 1, ...
template <typename TC>
__global__ void __launch_bounds__(THREADS)
splitk_reduce(const float* __restrict__ ws, TC* __restrict__ c, size_t mn, int splits) {
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * THREADS) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
    c[i] = from_f32<TC>(s);
  }
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

template <typename TL>
int kchunk_of(int k, int splits) { return ceil_div(ceil_div(k, splits), TL::BK) * TL::BK; }

template <typename TL>
int plan_splits(int m, int n, int k, int sms) {
  const long long tiles = (long long)ceil_div(m, TL::BM) * ceil_div(n, TL::BN);
  const long long want = (long long)BLOCKS_PER_SM * sms;
  if (tiles >= want || k < 2 * MIN_KCHUNK) return 1;
  int splits = ceil_div(want, tiles);
  const int most = k / MIN_KCHUNK;
  if (splits > most) splits = most;
  // A split covers whole K steps, so rounding the chunk up may leave fewer
  // splits; settle on a count that the chunk of that count gives back (the
  // count only falls, so this ends), so that no split is empty.
  for (;;) {
    const int fewer = ceil_div(k, kchunk_of<TL>(k, splits));
    if (fewer == splits) return splits;
    splits = fewer;
  }
}

template <typename TL, typename TA, typename TC>
cudaError_t launch(const void* a, const void* b, void* c, float* ws, int m, int n, int k,
                   int splits, cudaStream_t stream) {
  if (splits < 1 || splits > k) return cudaErrorInvalidValue;
  const int kchunk = kchunk_of<TL>(k, splits);
  if (ceil_div(k, kchunk) != splits || (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid(ceil_div(n, TL::BN), ceil_div(m, TL::BM), splits);
  matmul_tiled<TL, TA, TC><<<grid, THREADS, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TA*>(b), static_cast<TC*>(c),
      splits > 1 ? ws : nullptr, m, n, k, kchunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const size_t mn = (size_t)m * n;
  const long long blocks = ((long long)mn + THREADS - 1) / THREADS;
  splitk_reduce<TC><<<(int)(blocks < 8 * 132 ? blocks : 8 * 132), THREADS, 0, stream>>>(
      ws, static_cast<TC*>(c), mn, splits);
  return cudaGetLastError();
}

template <typename TA, typename TC>
cudaError_t dispatch(const void* a, const void* b, void* c, float* ws, int m, int n, int k,
                     int splits, cudaStream_t stream) {
  if (m <= SMALL_M) return launch<Small, TA, TC>(a, b, c, ws, m, n, k, splits, stream);
  return launch<Large, TA, TC>(a, b, c, ws, m, n, k, splits, stream);
}

}  // namespace

extern "C" {

// How many K chunks the product is cut into (1: no workspace needed; else
// the wrapper passes an fp32 workspace of splits * m * n values).
int repro_matmul_plan(int m, int n, int k, int device, int* splits) {
  int sms = 0;
  const cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  *splits = m <= SMALL_M ? plan_splits<Small>(m, n, k, sms) : plan_splits<Large>(m, n, k, sms);
  return 0;
}

// in_dtype, out_dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
int repro_matmul(const void* a, const void* b, void* c, void* ws, int m, int n, int k,
                 int splits, int in_dtype, int out_dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  switch (in_dtype * 2 + out_dtype) {
    case 0: return (int)dispatch<float, float>(a, b, c, w, m, n, k, splits, st);
    case 1: return (int)dispatch<float, __nv_bfloat16>(a, b, c, w, m, n, k, splits, st);
    case 2: return (int)dispatch<__nv_bfloat16, float>(a, b, c, w, m, n, k, splits, st);
    case 3: return (int)dispatch<__nv_bfloat16, __nv_bfloat16>(a, b, c, w, m, n, k, splits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
