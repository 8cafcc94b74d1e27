// Matrix product C = A @ B with an fp32 accumulator, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/matmul/matmul.py::matmul_blocked
// (wrapper repro/kernels/matmul/ops.py::matmul). It computes the same
// function: A (M, K) @ B (K, N), both fp32 or both bf16, row-major, summed
// in fp32 and cast to the output type (fp32 or bf16). There is no padding:
// the loads stop at the edges and the stores check bounds.
//
// What bounds it on the H100. At prefill (M = 2048 rows of activations
// against K x N weights of 2560 x 80 up to 3072 x 49152) a product does
// 2*M*K*N operations on (M*K + K*N + M*N) elements, hundreds of operations
// per byte: bound by operations, in bf16 by the tensor cores' 989 TFLOP/s.
// At decode (M = 4 rows, one per serving slot) every weight is used for 4
// rows only: a product is bound by reading B once, 3.35 TB/s.
//
// What the design does about it: two routes, chosen by the Python plan
// (matmul.py) and checked here.
//
//  * wgmma (bf16 operands whose rows are multiples of 16 bytes, K % 8 == 0
//    and N % 8 == 0, at 16-byte-aligned addresses: what TMA takes). A
//    block computes a BM x 128 tile of C, BM = 128 (two consumer
//    warpgroups of 64 rows) for M > 64, BM = 64 (one) for M <= 64. One
//    producer warp keeps a ring of 4 shared-memory stages full with
//    TMA loads of a BM x 64 tile of A and a 64 x 128 tile of B (two
//    64-wide boxes), 128-byte swizzled; each stage has a "full" mbarrier
//    (the TMA bytes arrived) and an "empty" one (every consumer thread is
//    done with it). The consumers run wgmma m64n128k16 (bf16 -> fp32, B
//    MN-major through the transpose bit) on each stage, keep one group in
//    flight and release a stage once the group that read it has retired.
//    The fp32 sums go from registers to C (cast) or to the split-K
//    workspace, with bounds checks on the ragged edge of M and N. Rows of
//    A past M are zero-filled by TMA and cost no bytes, so at decode the
//    64-row tile wastes only tensor work, which stays under the bytes
//    bound (2*64*K*N at 989 TFLOP/s is 0.13 ps per weight, reading it
//    0.60 ps): the decode path is this kernel on 64-row tiles, split along
//    K so that ~2 blocks per SM stream B. Blocks walk M fastest, so the
//    blocks in flight share a column of B tiles and A stays in L2.
//  * tf32x3 (fp32 with M > 64, whatever the alignment): fp32 on the
//    tensor cores. One TF32 product (10 mantissa bits) misses the fp32
//    tolerance of 2e-4 (3e-4 at K = 3072); split into TF32 halves, x =
//    x_hi + x_lo, the three products a_lo b_hi + a_hi b_lo + a_hi b_hi
//    carry the error of an fp32 product (a_lo b_lo, below 2^-22 of it, is
//    left out). Three products at the card's 495 TFLOP/s of dense TF32 are
//    165 TFLOP/s of fp32-accurate work, 2.5x the 67 TFLOP/s of fp32 FMA. A
//    split pass (hopper::split_kernel, one launch) first writes A_hi, A_lo
//    (M, Kp) and Bt_hi, Bt_lo (N, Kp), K zero-padded to whole 32-deep steps
//    (Kp), into scratch the wrapper allocates: .tf32 wgmma takes no
//    transpose, so B goes K-major, and the main loop needs no alignment
//    condition. Then the wgmma route's shape at BK = 32 (one 128-byte
//    swizzle row of fp32): 128 x 128 tiles, one producer warp filling a
//    ring of 3 stages of four 16 KB tiles (A_hi, A_lo, B_hi, B_lo: 192 KB,
//    one block per SM), two consumer warpgroups issuing the three
//    m64n128k8 products per k8 into one tensor-core accumulator, added to
//    an fp32 sum in registers every 4 stages (the tensor cores' additions
//    truncate: hopper::TF32X3_PROMOTE).
//  * stream (fp32 with M <= 64 that TMA can read: K % 4 == 0, N % 4 == 0,
//    both operands 16-byte aligned): the fp32 decode tick. It computes
//    what simt computes, fp32 FMA in k order with no TF32 anywhere, so its
//    error is an fp32 product's. Bounds: reading B once, 4 K N bytes at
//    3.35 TB/s, against 2 M K N operations at 67 TFLOP/s: bytes bound it
//    up to M = 40 (the tick, M = 4, does a tenth of the operations the
//    bytes would allow), the FMA rate from there to 64. So the design
//    streams B: one producer warp keeps a ring of 4 stages full with TMA
//    loads (16-byte-aligned rows, unswizzled) of a 32 (k) x 128 tile of B
//    and the block's MT x 32 slice of A (MT = M padded to 4, 8, 16, 32 or
//    64; the rows past M, the columns past N and the k rows past K are
//    zero-filled), full and empty mbarriers a stage; 8 consumer warps read
//    each row of B as 16-byte vectors (a warp's 32 lanes, 512 contiguous
//    bytes: 4 columns a lane) and A as broadcast 16-byte reads (4 k of a
//    row), and each thread sums RT = 4 or 8 rows x its 4 columns in
//    registers. At small M the warps split the stage's k rows (8 warps x 4
//    rows at MT <= 8; at MT = 64 the 8 warps split M instead), and their
//    partial tiles meet in the freed ring and are added in a fixed order.
//    A stage is 17-24 KB, a block 70-99 KB: two blocks an SM keep 128 KB
//    of B in flight an SM, four times the 3.35 TB/s x ~1.3 us / 132 SMs =
//    32 KB that hides the memory's latency. K is split (below) until the grid
//    has two blocks an SM. A is re-read from L2 by each column tile; at
//    M = 4 it is a 4 / 128 share of B's bytes.
//  * simt (fp32 with M <= 64 that TMA cannot read, and bf16 operands TMA
//    cannot take): the CUDA-core kernel of the port's first version. 128 x
//    128 tiles (256 threads, an 8 x 8 block of sums each) for M > 64, 16 x
//    128 for M <= 64; tiles of A (transposed) and B staged through shared
//    memory, the next K step loaded into registers while the current one
//    is computed. Its ceiling is the 67 TFLOP/s fp32 rate; at the tick it
//    loads B as 4-byte values with one 32-deep step in flight. fp32
//    reaches the 128 x 128 tile only from tools/tf32x3_probe.py, which
//    times tf32x3 against it.
//
// Split K (every route). When the tiles of C give fewer than two blocks
// per SM (decode, the narrow K/V, B/C and dt projections at prefill), K is
// cut into chunks of at least 256 (whole K steps), each block writes an
// fp32 partial tile into a workspace the wrapper allocates, and a second
// kernel adds the partials in a fixed order and casts, so results are
// deterministic.
//
// The kernels allocate nothing and launch on the stream they are given;
// the entry point returns cudaGetLastError() (or the error of a refused
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

// The K chunk of `splits` splits in steps of bk; 0 if the count does not
// come back from the chunk (the plan settles on counts that do).
int kchunk_of(int k, int splits, int bk) {
  if (splits < 1 || splits > k) return 0;
  const int kchunk = ceil_div(ceil_div(k, splits), bk) * bk;
  return ceil_div(k, kchunk) == splits ? kchunk : 0;
}

// ---------------------------------------------------------------------------
// simt route: CUDA cores, fp32 arithmetic
// ---------------------------------------------------------------------------

namespace simt {

constexpr int THREADS = 256;

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

template <typename TL, typename TA, typename TC>
cudaError_t launch(const void* a, const void* b, void* c, float* ws, int m, int n, int k,
                   int splits, cudaStream_t stream) {
  const int kchunk = kchunk_of(k, splits, TL::BK);
  if (kchunk == 0 || m > 65535 * TL::BM) return cudaErrorInvalidValue;
  const dim3 grid(ceil_div(n, TL::BN), ceil_div(m, TL::BM), splits);
  matmul_tiled<TL, TA, TC><<<grid, THREADS, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TA*>(b), static_cast<TC*>(c),
      splits > 1 ? ws : nullptr, m, n, k, kchunk);
  return cudaGetLastError();
}

template <typename TA, typename TC>
cudaError_t dispatch(int tile, const void* a, const void* b, void* c, float* ws, int m, int n,
                     int k, int splits, cudaStream_t stream) {
  switch (tile) {
    case 0: return launch<Large, TA, TC>(a, b, c, ws, m, n, k, splits, stream);
    case 1: return launch<Small, TA, TC>(a, b, c, ws, m, n, k, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// wgmma route: TMA + mbarrier ring + tensor cores, bf16 operands
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BN = 128, BK = 64;
using hopper::ATOM;                       // bf16 values in one 128-byte swizzle row
constexpr int ATOM_BYTES = BK * ATOM * 2;  // one 64 (k) x 64 (n) box of B: 8 KB
// Descriptor strides: from one group of 8 rows (8 x 128 bytes) to the next,
// for A's rows of M and B's rows of k; B's atoms along N sit ATOM_BYTES apart.
constexpr uint32_t GROUP_BYTES = 1024;

template <int CONSUMERS_, int STAGES_, int MIN_BLOCKS_>
struct Cfg {
  static constexpr int CONSUMERS = CONSUMERS_, STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int BM = 64 * CONSUMERS;
  static constexpr int THREADS = 128 * CONSUMERS + 32;  // consumer warpgroups, producer warp
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // the stages, 1024-byte aligned inside the block's window, then the barriers
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
  static_assert(A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0, "1024-byte aligned tiles");
};
// At prefill one block per SM with 4 stages (128 KB) beat two blocks of 3
// stages and one of 6 on both LMs' shapes (tools/matmul_stage_sweep.py,
// numbers in PERF.md). At decode two blocks of 4 stages (96 KB each) keep
// 128 KB of weights in flight per SM.
using Large = Cfg<2, 4, 1>;  // 128 x 128 tiles, M > 64
using Small = Cfg<1, 4, 2>;  // 64 x 128 tiles, M <= 64 (decode)

template <typename CF, typename TC>
__global__ void __launch_bounds__(CF::THREADS, CF::MIN_BLOCKS)
matmul_wgmma(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
             TC* __restrict__ c, float* __restrict__ ws, int m, int n, int k, int kchunk) {
  using namespace hopper;
  constexpr int STAGES = CF::STAGES, BM = CF::BM;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = base + STAGES * CF::STAGE_BYTES, empty0 = full0 + STAGES * 8;

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kb = blockIdx.z * kchunk;
  const int n_k = (min(k, kb + kchunk) - kb + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);                       // the producer's expect_tx
      mbar_init(empty0 + 8 * s, CF::CONSUMERS * 128);  // every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CF::CONSUMERS * 128) {  // the producer warp; one thread issues
    if (tid == CF::CONSUMERS * 128) {
      for (int it = 0; it < n_k; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s, sa = base + s * CF::STAGE_BYTES;
        const uint32_t sb = sa + CF::A_BYTES;
        const int k0 = kb + it * BK;
        // A box counts whole, zero fill included. A second atom of B wholly
        // past N is not loaded: the columns it would feed are not stored.
        const bool two = n0 + ATOM < n;
        mbar_arrive_expect_tx(full, CF::A_BYTES + (two ? 2 : 1) * ATOM_BYTES);
        tma_load_2d(sa, &map_a, full, k0, m0);
        tma_load_2d(sb, &map_b, full, n0, k0);
        if (two) tma_load_2d(sb + ATOM_BYTES, &map_b, full, n0 + ATOM, k0);
      }
    }
    return;
  }

  const int wgi = tid / 128;  // this consumer warpgroup's 64 rows of the tile
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_operands(acc);
  for (int it = 0; it < n_k; ++it) {
    const int s = it % STAGES;
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    const uint32_t sa = base + s * CF::STAGE_BYTES + wgi * 64 * 128;
    const uint32_t sb = base + s * CF::STAGE_BYTES + CF::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)  // 16 k a product: 32 bytes along A's rows, 16 rows of B
      wgmma_m64n128k16(acc, make_desc(sa + kk * 32, 16, GROUP_BYTES),
                       make_desc(sb + kk * 16 * 128, ATOM_BYTES, GROUP_BYTES));
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's group has retired: release that stage
    if (it > 0) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // Fragment of m64n128: warp w of the warpgroup holds rows 16w + lane/4
  // (+ 8), columns 8j + 2 (lane % 4) (+ 1) in acc[4j + {0, 1}] (+ {2, 3}).
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int row0 = m0 + wgi * 64 + warp * 16 + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = col0 + 8 * j;  // even, and n is a multiple of 8: col + 1 < n too
    if (col >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= m) continue;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (ws != nullptr) {
        *reinterpret_cast<float2*>(ws + ((size_t)blockIdx.z * m + row) * n + col) =
            make_float2(v0, v1);
      } else if constexpr (sizeof(TC) == 4) {
        *reinterpret_cast<float2*>(c + (size_t)row * n + col) = make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(c + (size_t)row * n + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <typename CF, typename TC>
cudaError_t launch(const void* a, const void* b, void* c, float* ws, int m, int n, int k,
                   int splits, int device, cudaStream_t stream) {
  const int kchunk = kchunk_of(k, splits, BK);
  if (kchunk == 0 || k % 8 || n % 8 || ((uintptr_t)a | (uintptr_t)b) % 16 ||
      ceil_div(n, BN) > 65535)
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  if (!hopper::encode_2d(&map_a, a, m, k, CF::BM) || !hopper::encode_2d(&map_b, b, k, n, BK))
    return cudaErrorInvalidValue;
  // Above 48 KB of dynamic shared memory a kernel must opt in, once per device.
  static std::atomic<unsigned long long> ready{0};
  const unsigned long long bit = 1ull << (device & 63);
  if (!(ready.load(std::memory_order_relaxed) & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        matmul_wgmma<CF, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize, CF::SMEM);
    if (e != cudaSuccess) return e;
    ready.fetch_or(bit);
  }
  const dim3 grid(ceil_div(m, CF::BM), ceil_div(n, BN), splits);
  matmul_wgmma<CF, TC><<<grid, CF::THREADS, CF::SMEM, stream>>>(
      map_a, map_b, static_cast<TC*>(c), splits > 1 ? ws : nullptr, m, n, k, kchunk);
  return cudaGetLastError();
}

template <typename TC>
cudaError_t dispatch(int tile, const void* a, const void* b, void* c, float* ws, int m, int n,
                     int k, int splits, int device, cudaStream_t stream) {
  switch (tile) {
    case 0: return launch<Large, TC>(a, b, c, ws, m, n, k, splits, device, stream);
    case 1: return launch<Small, TC>(a, b, c, ws, m, n, k, splits, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// tf32x3 route: fp32 split into TF32 halves, three tensor-core products
// ---------------------------------------------------------------------------

namespace tf {

constexpr int BM = 128, BN = 128, BK = hopper::ATOM_F32;  // one 128-byte swizzle row of fp32
constexpr int STAGES = 3, CONSUMERS = 2;
constexpr int THREADS = 128 * CONSUMERS + 32;  // consumer warpgroups, producer warp
constexpr int TILE_BYTES = 128 * BK * 4;       // 128 rows (of M or N) x 32 fp32: 16 KB
constexpr int STAGE_BYTES = 4 * TILE_BYTES;    // A_hi, A_lo, B_hi, B_lo
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;

// The split operands: A_hi, A_lo (m, kp) and Bt_hi, Bt_lo (n, kp), kp % BK == 0.
struct Split {
  float *a_hi, *a_lo, *b_hi, *b_lo;
};

// a (m, k) -> A_hi, A_lo (m, kp); b (k, n) -> Bt_hi, Bt_lo (n, kp); one launch.
cudaError_t split(const void* a, const void* b, const Split& w, int m, int n, int k, int kp,
                  cudaStream_t stream) {
  return hopper::split_launch(hopper::split_job(a, w.a_hi, w.a_lo, m, k, kp, false), 1,
                              hopper::split_job(b, w.b_hi, w.b_lo, k, n, kp, true), 1, stream);
}

// One K chunk (blockIdx.z) of one 128 x 128 tile of C; as wg::matmul_wgmma.
template <typename TC>
__global__ void __launch_bounds__(THREADS, 1)
matmul_tf32x3(const __grid_constant__ CUtensorMap map_ahi, const __grid_constant__ CUtensorMap map_alo,
              const __grid_constant__ CUtensorMap map_bhi, const __grid_constant__ CUtensorMap map_blo,
              TC* __restrict__ c, float* __restrict__ ws, int m, int n, int kp, int kchunk) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = base + STAGES * STAGE_BYTES, empty0 = full0 + STAGES * 8;

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kb = blockIdx.z * kchunk;
  const int n_k = (min(kp, kb + kchunk) - kb) / BK;
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
      for (int it = 0; it < n_k; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s, st = base + s * STAGE_BYTES;
        const int k0 = kb + it * BK;
        // Every box counts whole, the zero fill past M or N included.
        mbar_arrive_expect_tx(full, STAGE_BYTES);
        tma_load_2d(st, &map_ahi, full, k0, m0);
        tma_load_2d(st + TILE_BYTES, &map_alo, full, k0, m0);
        tma_load_2d(st + 2 * TILE_BYTES, &map_bhi, full, k0, n0);
        tma_load_2d(st + 3 * TILE_BYTES, &map_blo, full, k0, n0);
      }
    }
    return;
  }

  const int wgi = tid / 128;  // this consumer warpgroup's 64 rows of the tile
  float acc[64];
  tf32x3_consume<BN, BK, STAGES, STAGE_BYTES, TILE_BYTES, TILE_BYTES>(acc, base, full0, empty0,
                                                                      n_k, wgi * 64 * 128);

  // Fragment of m64n128 as in wg::matmul_wgmma; N has no alignment here, so
  // a pair of columns is stored as one 8-byte vector only where n is even.
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int row0 = m0 + wgi * 64 + warp * 16 + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
  float* part = ws == nullptr ? nullptr : ws + (size_t)blockIdx.z * m * n;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = col0 + 8 * j;
    if (col >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= m) continue;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      const size_t at = (size_t)row * n + col;
      if (part != nullptr) {
        if (n % 2 == 0) {
          *reinterpret_cast<float2*>(part + at) = make_float2(v0, v1);
        } else {
          part[at] = v0;
          if (col + 1 < n) part[at + 1] = v1;
        }
      } else {
        c[at] = from_f32<TC>(v0);
        if (col + 1 < n) c[at + 1] = from_f32<TC>(v1);
      }
    }
  }
}

// a (m, k), b (k, n) fp32, any alignment; w: the split operands (16-byte
// aligned, written here first). The split is queued before the tensor maps
// are encoded, so the card starts while the host encodes.
template <typename TC>
cudaError_t launch(const void* a, const void* b, void* c, const Split& w, float* ws, int m, int n,
                   int k, int splits, int device, cudaStream_t stream) {
  const int kp = ceil_div(k, BK) * BK;
  const int kchunk = kchunk_of(kp, splits, BK);
  if (kchunk == 0 || ceil_div(n, BN) > 65535 || splits > 65535 ||
      ((uintptr_t)w.a_hi | (uintptr_t)w.a_lo | (uintptr_t)w.b_hi | (uintptr_t)w.b_lo) % 16)
    return cudaErrorInvalidValue;
  cudaError_t e = split(a, b, w, m, n, k, kp, stream);
  if (e != cudaSuccess) return e;
  CUtensorMap ahi, alo, bhi, blo;
  if (!hopper::encode_2d_f32(&ahi, w.a_hi, m, kp, BM) ||
      !hopper::encode_2d_f32(&alo, w.a_lo, m, kp, BM) ||
      !hopper::encode_2d_f32(&bhi, w.b_hi, n, kp, BN) ||
      !hopper::encode_2d_f32(&blo, w.b_lo, n, kp, BN))
    return cudaErrorInvalidValue;
  // Above 48 KB of dynamic shared memory a kernel must opt in, once per device.
  static std::atomic<unsigned long long> ready{0};
  const unsigned long long bit = 1ull << (device & 63);
  if (!(ready.load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(matmul_tf32x3<TC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return e;
    ready.fetch_or(bit);
  }
  const dim3 grid(ceil_div(m, BM), ceil_div(n, BN), splits);
  matmul_tf32x3<TC><<<grid, THREADS, SMEM, stream>>>(ahi, alo, bhi, blo, static_cast<TC*>(c),
                                                     splits > 1 ? ws : nullptr, m, n, kp, kchunk);
  return cudaGetLastError();
}

}  // namespace tf

// ---------------------------------------------------------------------------
// stream route: fp32 at M <= 64, B streamed by TMA, fp32 FMA on the CUDA cores
// ---------------------------------------------------------------------------

namespace st {

constexpr int BN = 128;  // columns a block: 32 lanes x 4
constexpr int BK = 32;   // k rows a stage
constexpr int STAGES = 4;
constexpr int WARPS = 8;                    // consumer warps
constexpr int CONSUMERS = 32 * WARPS;
constexpr int THREADS = CONSUMERS + 32;     // and one producer warp
constexpr int B_BYTES = BK * BN * 4;        // one stage of B: 16 KB

// MT: the rows of A a block covers (M padded: every row of C is in one
// block); WM: consumer warps along M, the other WK = WARPS / WM along K,
// each taking KW = BK / WK of a stage's k rows. A thread sums RT = MT / WM
// rows x 4 columns.
template <int MT_, int WM_>
struct Cfg {
  static constexpr int MT = MT_, WM = WM_, WK = WARPS / WM_;
  static constexpr int RT = MT / WM, KW = BK / WK;
  static constexpr int A_BYTES = MT * BK * 4;
  static constexpr int A_STRIDE = (A_BYTES + 1023) / 1024 * 1024;
  // the B stages, then the A stages, 1024-byte aligned inside the block's
  // window, then the barriers
  static constexpr int SMEM = 1024 + STAGES * (B_BYTES + A_STRIDE) + 2 * STAGES * 8;
  static_assert(RT % 4 == 0 && KW % 4 == 0, "float4 reads of A and B");
  static_assert(WK * MT * BN * 4 <= STAGES * B_BYTES, "the partial sums reuse the B ring");
};
using M4 = Cfg<4, 1>;
using M8 = Cfg<8, 1>;
using M16 = Cfg<16, 2>;
using M32 = Cfg<32, 4>;
using M64 = Cfg<64, 8>;

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// One K chunk (blockIdx.y) of one MT x BN tile of C (blockIdx.x). With ws
// == nullptr the tile is cast and written to c; otherwise its fp32 partial
// goes to ws[blockIdx.y].
template <typename CF, typename TC>
__global__ void __launch_bounds__(THREADS, 2)
matmul_stream(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
              TC* __restrict__ c, float* __restrict__ ws, int m, int n, int k, int kchunk) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);  // the same address, generic
  const uint32_t a0 = base + STAGES * B_BYTES;
  const uint32_t full0 = a0 + STAGES * CF::A_STRIDE, empty0 = full0 + STAGES * 8;

  const int n0 = blockIdx.x * BN;
  const int kb = blockIdx.y * kchunk;
  const int n_k = (min(k, kb + kchunk) - kb + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);           // the producer's expect_tx
      mbar_init(empty0 + 8 * s, CONSUMERS);  // every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp; one thread issues
    if (tid == CONSUMERS) {
      for (int it = 0; it < n_k; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const int k0 = kb + it * BK;
        // Both boxes count whole: A's rows past M, B's columns past N and
        // the k rows past K are zero-filled.
        mbar_arrive_expect_tx(full, CF::A_BYTES + B_BYTES);
        tma_load_2d(a0 + s * CF::A_STRIDE, &map_a, full, k0, 0);
        tma_load_2d(base + s * B_BYTES, &map_b, full, n0, k0);
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = (warp % CF::WM) * CF::RT;  // this thread's first row of the tile
  const int wk = warp / CF::WM;
  const int kr0 = wk * CF::KW;              // its first k row of a stage
  float acc[CF::RT][4];
#pragma unroll
  for (int r = 0; r < CF::RT; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;

  for (int it = 0; it < n_k; ++it) {
    const int s = it % STAGES;
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    const float* as = reinterpret_cast<const float*>(gbase + STAGES * B_BYTES + s * CF::A_STRIDE);
    const float* bs = reinterpret_cast<const float*>(gbase + s * B_BYTES);
#pragma unroll
    for (int kk = 0; kk < CF::KW; kk += 4) {
      float4 av[CF::RT];  // 4 k of each row: one broadcast read a row
#pragma unroll
      for (int r = 0; r < CF::RT; ++r)
        av[r] = *reinterpret_cast<const float4*>(as + (r0 + r) * BK + kr0 + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // a warp reads 512 contiguous bytes of a row of B
        const float4 bv = *reinterpret_cast<const float4*>(bs + (kr0 + kk + j) * BN + 4 * lane);
#pragma unroll
        for (int r = 0; r < CF::RT; ++r) {
          const float a = lane_of(av[r], j);
          acc[r][0] = fmaf(a, bv.x, acc[r][0]);
          acc[r][1] = fmaf(a, bv.y, acc[r][1]);
          acc[r][2] = fmaf(a, bv.z, acc[r][2]);
          acc[r][3] = fmaf(a, bv.w, acc[r][3]);
        }
      }
    }
    mbar_arrive(empty0 + 8 * s);  // this thread is done with the stage
  }

  // The WK partial tiles meet in the B ring, which every stage's loads have
  // left (each consumer waited for all of them) once every consumer is past
  // its last read; they are added in the order wk = 0, 1, ...
  named_sync(1, CONSUMERS);
  float* red = reinterpret_cast<float*>(gbase);  // [WK][MT][BN]
#pragma unroll
  for (int r = 0; r < CF::RT; ++r)
    *reinterpret_cast<float4*>(red + (wk * CF::MT + r0 + r) * BN + 4 * lane) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  named_sync(1, CONSUMERS);
  float* part = ws == nullptr ? nullptr : ws + (size_t)blockIdx.y * m * n;
  for (int i = tid; i < CF::MT * BN; i += CONSUMERS) {
    const int row = i / BN, col = n0 + i % BN;
    if (row >= m || col >= n) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < CF::WK; ++w) v += red[w * CF::MT * BN + i];
    if (part != nullptr)
      part[(size_t)row * n + col] = v;
    else
      c[(size_t)row * n + col] = from_f32<TC>(v);
  }
}

// a (m, k), b (k, n) fp32, row-major, k % 4 == 0 and n % 4 == 0 (rows of
// 16-byte multiples), both 16-byte aligned: what TMA reads.
template <typename CF, typename TC>
cudaError_t launch(const void* a, const void* b, void* c, float* ws, int m, int n, int k,
                   int splits, int device, cudaStream_t stream) {
  const int kchunk = kchunk_of(k, splits, BK);
  if (kchunk == 0 || m > CF::MT || k % 4 || n % 4 || ((uintptr_t)a | (uintptr_t)b) % 16 ||
      splits > 65535)
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  if (!hopper::encode_2d_f32_rows(&map_a, a, m, k, CF::MT, BK) ||
      !hopper::encode_2d_f32_rows(&map_b, b, k, n, BK, BN))
    return cudaErrorInvalidValue;
  // Above 48 KB of dynamic shared memory a kernel must opt in, once per device.
  static std::atomic<unsigned long long> ready{0};
  const unsigned long long bit = 1ull << (device & 63);
  if (!(ready.load(std::memory_order_relaxed) & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        matmul_stream<CF, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize, CF::SMEM);
    if (e != cudaSuccess) return e;
    ready.fetch_or(bit);
  }
  const dim3 grid(ceil_div(n, BN), splits);
  matmul_stream<CF, TC><<<grid, THREADS, CF::SMEM, stream>>>(
      map_a, map_b, static_cast<TC*>(c), splits > 1 ? ws : nullptr, m, n, k, kchunk);
  return cudaGetLastError();
}

template <typename TC>
cudaError_t dispatch(int tile, const void* a, const void* b, void* c, float* ws, int m, int n,
                     int k, int splits, int device, cudaStream_t stream) {
  switch (tile) {
    case 0: return launch<M4, TC>(a, b, c, ws, m, n, k, splits, device, stream);
    case 1: return launch<M8, TC>(a, b, c, ws, m, n, k, splits, device, stream);
    case 2: return launch<M16, TC>(a, b, c, ws, m, n, k, splits, device, stream);
    case 3: return launch<M32, TC>(a, b, c, ws, m, n, k, splits, device, stream);
    case 4: return launch<M64, TC>(a, b, c, ws, m, n, k, splits, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace st

// c = cast(sum over z of ws[z]), the partials added in order z = 0, 1, ...
template <typename TC>
__global__ void __launch_bounds__(256)
splitk_reduce(const float* __restrict__ ws, TC* __restrict__ c, size_t mn, int splits) {
  for (size_t i = (size_t)blockIdx.x * 256 + threadIdx.x; i < mn; i += (size_t)gridDim.x * 256) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
    c[i] = from_f32<TC>(s);
  }
}

// The split-K reduction after a route's launch `e` (nothing when unsplit).
template <typename TC>
cudaError_t reduce(cudaError_t e, const float* ws, void* c, int m, int n, int splits,
                   cudaStream_t stream) {
  if (e != cudaSuccess || splits == 1) return e;
  const size_t mn = (size_t)m * n;
  const long long blocks = ((long long)mn + 255) / 256;
  splitk_reduce<TC><<<(int)(blocks < 8 * 132 ? blocks : 8 * 132), 256, 0, stream>>>(
      ws, static_cast<TC*>(c), mn, splits);
  return cudaGetLastError();
}

template <typename TA, typename TC>
cudaError_t run(int route, int tile, const void* a, const void* b, void* c, float* ws, int m,
                int n, int k, int splits, int device, cudaStream_t stream) {
  if (splits > 1 && ws == nullptr) return cudaErrorInvalidValue;
  cudaError_t e;
  if (route == 0) {
    e = simt::dispatch<TA, TC>(tile, a, b, c, ws, m, n, k, splits, stream);
  } else if constexpr (sizeof(TA) == 2) {
    e = route == 1 ? wg::dispatch<TC>(tile, a, b, c, ws, m, n, k, splits, device, stream)
                   : cudaErrorInvalidValue;
  } else {  // the wgmma route takes bf16 operands only, the stream route fp32
    e = route == 3 ? st::dispatch<TC>(tile, a, b, c, ws, m, n, k, splits, device, stream)
                   : cudaErrorInvalidValue;
  }
  return reduce<TC>(e, ws, c, m, n, splits, stream);
}

cudaError_t on_device(int device) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  return e;
}

}  // namespace

extern "C" {

// route: 0 = simt, 1 = wgmma, 3 = stream (the tf32x3 route has its own
// entry point). tile: simt 0 = 128 x 128, 1 = 16 x 128; wgmma 0 = 128 x
// 128, 1 = 64 x 128; stream 0-4 = 4, 8, 16, 32, 64 x 128. splits > 1 takes
// an fp32 workspace of splits * m * n values.
// in_dtype, out_dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0
// on success).
int repro_matmul(const void* a, const void* b, void* c, void* ws, int m, int n, int k,
                 int splits, int route, int tile, int in_dtype, int out_dtype, int device,
                 void* stream) {
  cudaError_t e = on_device(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  switch (in_dtype * 2 + out_dtype) {
    case 0: return (int)run<float, float>(route, tile, a, b, c, w, m, n, k, splits, device, st);
    case 1:
      return (int)run<float, __nv_bfloat16>(route, tile, a, b, c, w, m, n, k, splits, device, st);
    case 2:
      return (int)run<__nv_bfloat16, float>(route, tile, a, b, c, w, m, n, k, splits, device, st);
    case 3:
      return (int)run<__nv_bfloat16, __nv_bfloat16>(route, tile, a, b, c, w, m, n, k, splits,
                                                     device, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tf32x3 route: a (m, k), b (k, n) fp32, c (m, n) in out_dtype (0 =
// float32, 1 = bfloat16); a_hi, a_lo (m, kp) and b_hi, b_lo (n, kp), kp =
// k rounded up to a multiple of 32, 16-byte aligned: scratch the call
// fills with the split operands; splits > 1 takes an fp32 workspace of
// splits * m * n values. Returns a cudaError_t (0 on success).
int repro_matmul_tf32x3(const void* a, const void* b, void* c, void* a_hi, void* a_lo,
                        void* b_hi, void* b_lo, void* ws, int m, int n, int k, int splits,
                        int out_dtype, int device, void* stream) {
  cudaError_t e = on_device(device);
  if (e != cudaSuccess) return (int)e;
  if (splits > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const tf::Split w{static_cast<float*>(a_hi), static_cast<float*>(a_lo),
                    static_cast<float*>(b_hi), static_cast<float*>(b_lo)};
  float* f = static_cast<float*>(ws);
  switch (out_dtype) {
    case 0:
      return (int)reduce<float>(tf::launch<float>(a, b, c, w, f, m, n, k, splits, device, st), f,
                                c, m, n, splits, st);
    case 1:
      return (int)reduce<__nv_bfloat16>(
          tf::launch<__nv_bfloat16>(a, b, c, w, f, m, n, k, splits, device, st), f, c, m, n,
          splits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tf32x3 route's split pass alone (a -> a_hi, a_lo; b -> b_hi, b_lo as
// above), for tests and timing.
int repro_matmul_split(const void* a, const void* b, void* a_hi, void* a_lo, void* b_hi,
                       void* b_lo, int m, int n, int k, int device, void* stream) {
  cudaError_t e = on_device(device);
  if (e != cudaSuccess) return (int)e;
  const tf::Split w{static_cast<float*>(a_hi), static_cast<float*>(a_lo),
                    static_cast<float*>(b_hi), static_cast<float*>(b_lo)};
  return (int)tf::split(a, b, w, m, n, k, ceil_div(k, tf::BK) * tf::BK,
                        static_cast<cudaStream_t>(stream));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
