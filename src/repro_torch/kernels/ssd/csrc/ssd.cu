// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd/ssd.py::ssd_scan (wrapper
// repro/kernels/ssd/ops.py::ssd). For x (B, S, H, P), dt (B, S, H) fp32,
// a (H,) fp32 (a = -exp(a_log), taken by the wrapper) and b, c (B, S, N)
// (one B/C group), all in the model's own layout, it computes what
// repro/models/ssm.py::ssd_chunked computes. Per (batch b, head h) and per
// chunk of q rows, with xdt = x * dt (fp32) and dacum the in-chunk
// cumulative sum of dt * a:
//   y    = ((C B^T) o L) xdt + exp(dacum) o (C state^T),
//          L[i, j] = exp(dacum_i - dacum_j) for j <= i, 0 above the diagonal
//   state <- exp(da_tot) state + xdt^T (B o exp(da_tot - dacum))
// with the (P, N) state starting at 0; y is cast to x's type.
//
// What bounds it on the H100. Zamba2-2.7B's prefill at batch 4 x 512: x
// (4, 512, 80, 64) bf16, b and c (4, 512, 64), chunk 256. The work y needs,
// on the causal triangle: C B^T once per (batch, chunk), Q(Q + 1)N, shared
// by every head; per (batch, head, chunk) its product with xdt, Q(Q + 1)P;
// per (batch, head) the state update of every chunk but the last and
// C state^T of every chunk but the first, 2QPN each (chip_smoke.py::
// ssd_work): 4.07 GFLOP per call, on 43 MB in bf16 (x and y dominate): 94
// operations per byte, below the bf16 ridge (295), so in bf16 the bytes
// bound it (12.9 us; 4.1 us by the tensor cores at 989 TFLOP/s) and in
// fp32 the CUDA-core rate does (60.8 us at 67 TFLOP/s).
//
// What the design does about it: three routes, chosen by the Python plan
// (ssd.py) and checked here.
//
//  * wgmma (bf16; P and N multiples of 8 up to 64; chunks of q <= MAX_Q
//    rows; x, b, c, y at 16-byte-aligned addresses: what TMA takes). Two
//    kernels, one ctypes call, in the split of Mamba2's own kernels:
//     - ssd_states: one block per (h, b), 320 at Zamba2's shape (one
//       wave: 132 SMs hold two or three each), walks the chunks in order
//       and keeps the fp32 master state in the wgmma accumulator; per
//       chunk it adds x^T (B o dt o exp(da_tot - dacum)) on m64n64k16:
//       A = x^T straight from the TMA'd x tile (the transpose-A bit), B =
//       the chunk's B rows scaled in place in shared memory and rounded to
//       bf16. After each chunk but the last it writes the state entering
//       the next one, rounded to bf16, to a scratch of (B, NC - 1, H, 64,
//       64) (5.2 MB at Zamba2's shape); the last chunk's update is never
//       read, so it is not computed (at 2 chunks a sequence, one chunk).
//     - ssd_outputs: one block per (h, b, chunk, 64-row tile), 2560 at
//       Zamba2's shape, the tiles with the most work launched first (4.8
//       waves of 4 blocks per SM; the last blocks are the light ones).
//       One producer warp brings by TMA the C tile, the state copy and a
//       2-stage ring of B and x tiles of 64 rows for the column tiles at or
//       below the diagonal only (those above are 0 in L); one consumer
//       warpgroup computes
//         y = exp(dacum_i) (C_i state^T)        m64n64k16, state K-major
//         S = C_i B_j^T                         m64n64k16, B K-major: C and
//             B as stored, N as the depth; products of bf16 are exact in
//             fp32, so S is the reference's fp32 C B^T up to sum order
//         G = S exp(dacum_i - dacum_j) dt_j     on the fragment, fp32. On
//             the diagonal tile it is masked before the exponent (j > i,
//             rows past the chunk), so nothing overflows into inf * 0;
//             below it, it is S u_i (w_j dt_j) with u_i = exp(dacum_i - m)
//             and w_j = exp(m - dacum_j) about m, the column tile's last
//             dacum: both at most 1, so neither overflows, and the
//             exponent a G element cost (the kernel's largest share, found
//             by tools/ssd_knockout.py) becomes two multiplies
//         y += G x_j                            m64n64k16 RS: G packed to
//             bf16 in registers as the A fragment (the flash kernel's P),
//             x_j straight from TMA as an MN-major B: dt folded into G's
//             columns instead of an x * dt pass
//       then stages the tile in bf16 through the C tile's buffer and
//       writes it as 16-byte pieces, 8 lanes a 128-byte row; rows past the
//       chunk and columns past P masked.
//    P and N below 64 are zero-filled by TMA to one 64-wide atom; a tile
//    that runs past a ragged chunk (q not a multiple of 64) reads the next
//    chunk's rows, which the masks above (G, the B rows of the state
//    update) multiply by 0, so inputs must be finite there; rows past S
//    are zero-filled.
//    Rounding points against ssd_ref (which keeps x * dt, C B^T, L and
//    every product in fp32): G in bf16, the B rows of the state update
//    (B o dt o exp(da_tot - dacum)) in bf16, the state copy read by
//    C state^T in bf16; exp taken as 2^x of log2(e)-scaled dacum by
//    ex2.approx.ftz (results below 2^-126 are 0), below the diagonal as the
//    product u_i w_j; every sum and the master state stay fp32. Tolerance
//    2e-2 normalised (tests/test_torch_ssd.py, which walks this tiling in
//    plain torch).
//  * tf32x3 (fp32 under the wgmma route's shape rules). In fp32 the
//    CUDA-core rate bounds the call (60.8 us above); one TF32 product a k8
//    misses fp32's tolerance (above 2e-4 normalised against float64:
//    tests/test_torch_ssd.py), so,
//    as the matmul's, the conv's and flash attention's fp32 routes do, each
//    operand is split into TF32 halves, x = hi + lo, and each product is
//    three TF32 wgmmas a k8, lo_a hi_b + hi_a lo_b + hi_a hi_b, into one fp32
//    tensor-core sum: 3 x 4.07 GFLOP at 495 TFLOP/s, 24.7 us a call, under
//    the 25.5 us in which fp32's 85.6 MB cross memory, so the bytes bound
//    it. The split of the wgmma route, two kernels in one ctypes call:
//     - ssd_states_tf32x3: one block per (h, b) walks the chunks; the fp32
//       master state (P rows, N columns) lives in registers. .tf32 wgmma
//       takes no transpose: both operands must hold the depth (the chunk
//       rows) contiguous, and x and B hold P and N contiguous. So each
//       64-row tile of x and of B arrives raw by TMA (a 2-stage ring) and the
//       warpgroup writes it transposed and split into K-major tiles, x
//       scaled by its row weight w_j = dt_j exp(da_tot - dacum_j) on the
//       way (rows past the chunk 0): the state's update (x o w)^T B is
//       m64n64k8 with M = P, N = N, 8 k8 steps a tile, summed apart in a
//       fresh accumulator and added to the state in fp32 registers (the
//       tensor cores' sum truncates: this promotes every 8 k8 steps, inside
//       hopper::TF32X3_PROMOTE's window of 16). A transposing split pass
//       over x (42 MB read and 84 MB written at Zamba2's shape, ~38 us of
//       bytes against the 49 us bound) was the other way; in shared memory
//       it costs the warpgroup 16 scalar stores a float4, and no bytes. The
//       state entering each next chunk is written as its TF32 halves, hi
//       and lo (2 x (B, NC - 1, H, 64, 64) fp32, 5.2 MB a half at Zamba2's
//       shape), which the next kernel reads as they are.
//     - ssd_outputs_tf32x3: one block per (h, b, chunk, pair of 64-row
//       tiles), heaviest first, two consumer warpgroups, one tile each. C
//       of both tiles arrives raw and is split in place (hi in its buffer,
//       lo beside it), the state's halves arrive by TMA; then per column
//       tile at or below the pair's diagonal, B_j arrives raw and is split
//       in place and x_j arrives raw and is written transposed and split
//       (x_j^T: P rows, the chunk rows contiguous), both by all 256 threads
//       for both tiles, and each warpgroup computes
//         y = exp(dacum_i) (C_i state^T)   depth N, both as stored
//         S = C_i B_j^T                    depth N, both as stored
//         G = S exp(dacum_i - dacum_j) dt_j on the fragment: S u_i (w_j
//             dt_j) below the diagonal tile, as the wgmma route's; on it,
//             masked before the exponent in its 8 x 8 blocks on the
//             diagonal and S u_i (w_j dt_j) below them, about the column
//             group's last dacum (6 exponents a thread, not 32)
//         y += G x_j                       G's TF32 halves from registers
//             (hopper::wgmma_m64n64k8_tf32_rs): an m64n64 accumulator's
//             columns 2t, 2t + 1 of each 8 are the A fragment's k = t, t +
//             4, so x_j^T's columns are written in that order and G never
//             goes through shared memory; depth 64 chunk rows, summed apart
//             in a fresh accumulator and added in fp32 registers
//       and writes y from the fragment as fp32 pairs. A warpgroup skips
//       the pair's last column tile when it lies above its diagonal.
//    Shared memory: a split 64 x 64 fp32 tile is 32 KB, four times a bf16
//    one. ssd_outputs_tf32x3 holds C of both tiles (64 KB), the state then
//    x^T (32 KB, one buffer: the state is read once, before the first x^T)
//    and 2 stages of B split and raw x (48 KB each): 192 KB, with dacum,
//    dt and w_j dt_j of q <= MAX_Q rows (32 KB) 225 of the 227 KB; one
//    block an SM. ssd_states_tf32x3 holds 2 stages of raw x and B (64 KB)
//    and the two split transposes (64 KB).
//    Widths: N in one or two 32-wide atoms (a template), the second loaded
//    and read only when N > 32; P in one or two, rows of x^T past P (never
//    loaded) only reach output columns and state rows past P, which are
//    never written or read. dacum is scanned in fp64 and kept as two fp32
//    halves (chunk_scan64: in fp32 its ulp at Zamba2's chunk ends, 3e-5,
//    put 1.25e-5 into the output); each exponent is ex2.approx of a
//    difference of the halves scaled by log2(e). Every sum stays
//    fp32-accurate: held to 1e-5 of float64, normalised
//    (tests/test_torch_ssd.py, which walks this route in plain
//    torch, kernels/tf32.py::ssd_tf32x3).
//    What holds it back (tools/ssd_tf32x3_knockout.py; PERF.md, PR 27):
//    the warpgroups' CUDA-core work between the products (the scan, the
//    splits and the transpose, G's exponents and split), which runs in
//    lockstep with the tensor work; and shared-memory bandwidth, by the
//    published rates (not measured): an SS m64n64k8 tf32 wgmma reads 4 KB,
//    32 cycles at 128 bytes a cycle, as long as its tensor time.
//    C B^T is the same for every head and is computed once a head (80
//    times at Zamba2's shape, a third of the kernel's tensor work, which the
//    bound above counts once); computing it once per (batch, chunk, tile
//    pair) is left open.
//  * simt (fp32 and bf16 shapes the tensor-core routes do not take): the
//    CUDA-core kernel of the port's first version. One block of 256 threads per
//    (batch, head) walks that head's chunks in order with the (P, N) fp32
//    state in shared memory; 64-row tiles at and below the diagonal, one
//    64 x 64 tile of (C B^T) o L at a time in shared memory; B and C read
//    by index (no head replication), L masked before the exponent; any q
//    up to the shared-memory limit; P, N <= 64. Every product and sum is
//    fp32, held to 1e-5.
//
// The kernels allocate nothing (the wrapper passes the state scratch) and
// launch on the stream they are given; the entry point returns
// cudaGetLastError() (or the error of a refused argument) and the Python
// wrapper raises when that is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"  // kernels/include: PTX helpers, tensor-map encoders

namespace {

// ---------------------------------------------------------------------------
// simt route: CUDA cores, fp32 arithmetic
// ---------------------------------------------------------------------------

namespace simt {

constexpr int TQ = 64;        // rows of a tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int RPT = TQ / 16;  // tile rows (and tile columns of G) per thread
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

struct Shape {
  int s, h, p, n, q;  // q: rows of a chunk; s % q == 0
};

// Floats of dynamic shared memory the kernel needs.
size_t smem_floats(const Shape& sh) {
  const int np1 = sh.n + 1;
  const int pv = (sh.p + 15) / 16 * 16;
  return (size_t)sh.p * np1   // state [P][N + 1]
         + (size_t)TQ * np1   // C tile [TQ][N + 1]
         + (size_t)TQ * np1   // B tile [TQ][N + 1]
         + (size_t)TQ * pv    // xdt tile [TQ][pv], zero past P
         + (size_t)TQ * (TQ + 1)  // (C B^T) o L tile
         + 2 * (size_t)sh.q;  // dt and dacum of the chunk
}

template <typename T, int PMAX, int NMAX>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_scan(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ bm,
               const T* __restrict__ cm, T* __restrict__ y, Shape sh) {
  constexpr int PJ = PMAX / 16;  // output columns per thread, at most
  constexpr int NJ = NMAX / 16;  // state columns per thread, at most
  extern __shared__ float smem[];
  const int P = sh.p, N = sh.n, Q = sh.q, H = sh.h;
  const int np1 = N + 1;
  const int pv = (P + 15) / 16 * 16;
  const int pj = pv / 16;
  const int nj = (N + 15) / 16;
  float* st = smem;                 // [P][N + 1]
  float* cs = st + P * np1;         // [TQ][N + 1]
  float* bs = cs + TQ * np1;        // [TQ][N + 1]
  float* xs = bs + TQ * np1;        // [TQ][pv]
  float* gs = xs + TQ * pv;         // [TQ][TQ + 1]
  float* dts = gs + TQ * (TQ + 1);  // [Q]
  float* dac = dts + Q;             // [Q]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const float ah = a[h];
  const size_t x_row = (size_t)H * P;  // stride of s in x and y
  const T* xb = x + (size_t)b * sh.s * x_row + (size_t)h * P;
  T* yb = y + (size_t)b * sh.s * x_row + (size_t)h * P;
  const float* dtb = dt + (size_t)b * sh.s * H + h;
  const T* bb = bm + (size_t)b * sh.s * N;
  const T* cb = cm + (size_t)b * sh.s * N;
  const int n_tiles = (Q + TQ - 1) / TQ;

  for (int i = tid; i < P * np1; i += THREADS) st[i] = 0.f;

  for (int t0 = 0; t0 < sh.s; t0 += Q) {  // the chunks of this (b, h), in order
    // dt and da = dt * a of the chunk; dacum = inclusive cumsum of da.
    for (int i = tid; i < Q; i += THREADS) {
      const float d = dtb[(size_t)(t0 + i) * H];
      dts[i] = d;
      dac[i] = d * ah;
    }
    __syncthreads();
    if (warp == 0) {
      const int per = (Q + 31) / 32;
      const int lo = min(lane * per, Q), hi = min(lo + per, Q);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        run += dac[i];
        dac[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      for (int i = lo; i < hi; ++i) dac[i] += excl;
    }
    __syncthreads();
    const float da_tot = dac[Q - 1];

    for (int it = 0; it < n_tiles; ++it) {  // output row tiles
      const int i0 = it * TQ;
      __syncthreads();  // the previous tile's reads of cs are done
      for (int e = tid; e < TQ * N; e += THREADS) {
        const int r = e / N, k = e - r * N;
        cs[r * np1 + k] = i0 + r < Q ? to_f32(cb[(size_t)(t0 + i0 + r) * N + k]) : 0.f;
      }
      __syncthreads();

      // inter-chunk part: acc[i][p] = exp(dacum_i) * sum_n C[i, n] state[p, n]
      float acc[RPT][PJ];
#pragma unroll
      for (int ri = 0; ri < RPT; ++ri)
#pragma unroll
        for (int c = 0; c < PJ; ++c) acc[ri][c] = 0.f;
      for (int k = 0; k < N; ++k) {
        float cv[RPT];
#pragma unroll
        for (int ri = 0; ri < RPT; ++ri) cv[ri] = cs[(ty + 16 * ri) * np1 + k];
#pragma unroll
        for (int c = 0; c < PJ; ++c) {
          const int pp = tx + 16 * c;
          if (c < pj && pp < P) {
            const float sv = st[pp * np1 + k];
#pragma unroll
            for (int ri = 0; ri < RPT; ++ri) acc[ri][c] = fmaf(cv[ri], sv, acc[ri][c]);
          }
        }
      }
#pragma unroll
      for (int ri = 0; ri < RPT; ++ri) {
        const int i = i0 + ty + 16 * ri;
        const float dec = i < Q ? expf(dac[i]) : 0.f;
#pragma unroll
        for (int c = 0; c < PJ; ++c) acc[ri][c] *= dec;
      }

      // intra-chunk part, over the column tiles at or below the diagonal
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TQ;
        __syncthreads();  // the previous column tile's reads of bs, xs, gs are done
        for (int e = tid; e < TQ * N; e += THREADS) {
          const int r = e / N, k = e - r * N;
          bs[r * np1 + k] = j0 + r < Q ? to_f32(bb[(size_t)(t0 + j0 + r) * N + k]) : 0.f;
        }
        for (int e = tid; e < TQ * pv; e += THREADS) {
          const int r = e / pv, pp = e - r * pv;
          xs[e] = j0 + r < Q && pp < P
                      ? to_f32(xb[(size_t)(t0 + j0 + r) * x_row + pp]) * dts[j0 + r]
                      : 0.f;
        }
        __syncthreads();

        // G[i][j] = (C_i . B_j) * L[i, j], masked before the exponent
        float g[RPT][RPT];
#pragma unroll
        for (int ri = 0; ri < RPT; ++ri)
#pragma unroll
          for (int rj = 0; rj < RPT; ++rj) g[ri][rj] = 0.f;
        for (int k = 0; k < N; ++k) {
          float cv[RPT], bv[RPT];
#pragma unroll
          for (int ri = 0; ri < RPT; ++ri) cv[ri] = cs[(ty + 16 * ri) * np1 + k];
#pragma unroll
          for (int rj = 0; rj < RPT; ++rj) bv[rj] = bs[(tx + 16 * rj) * np1 + k];
#pragma unroll
          for (int ri = 0; ri < RPT; ++ri)
#pragma unroll
            for (int rj = 0; rj < RPT; ++rj) g[ri][rj] = fmaf(cv[ri], bv[rj], g[ri][rj]);
        }
#pragma unroll
        for (int ri = 0; ri < RPT; ++ri) {
          const int i = i0 + ty + 16 * ri;
#pragma unroll
          for (int rj = 0; rj < RPT; ++rj) {
            const int j = j0 + tx + 16 * rj;
            const bool ok = j <= i && i < Q && j < Q;
            gs[(ty + 16 * ri) * (TQ + 1) + tx + 16 * rj] =
                ok ? g[ri][rj] * expf(dac[i] - dac[j]) : 0.f;
          }
        }
        __syncthreads();

        // acc[i][p] += sum_j G[i][j] xdt[j][p]
        for (int j = 0; j < TQ; ++j) {
          float gv[RPT];
#pragma unroll
          for (int ri = 0; ri < RPT; ++ri) gv[ri] = gs[(ty + 16 * ri) * (TQ + 1) + j];
#pragma unroll
          for (int c = 0; c < PJ; ++c) {
            if (c < pj) {
              const float xv = xs[j * pv + tx + 16 * c];
#pragma unroll
              for (int ri = 0; ri < RPT; ++ri) acc[ri][c] = fmaf(gv[ri], xv, acc[ri][c]);
            }
          }
        }
      }

#pragma unroll
      for (int ri = 0; ri < RPT; ++ri) {
        const int i = i0 + ty + 16 * ri;
        if (i >= Q) continue;
        T* yrow = yb + (size_t)(t0 + i) * x_row;
#pragma unroll
        for (int c = 0; c < PJ; ++c) {
          const int pp = tx + 16 * c;
          if (c < pj && pp < P) yrow[pp] = from_f32<T>(acc[ri][c]);
        }
      }
    }

    // state <- exp(da_tot) state + xdt^T (B o exp(da_tot - dacum)); the
    // thread owns state[ty + 16 r][tx + 16 c].
    float upd[PJ][NJ];
    const float keep = expf(da_tot);
#pragma unroll
    for (int r = 0; r < PJ; ++r)
#pragma unroll
      for (int c = 0; c < NJ; ++c) {
        const int pp = ty + 16 * r, k = tx + 16 * c;
        upd[r][c] = r < pj && c < nj && pp < P && k < N ? keep * st[pp * np1 + k] : 0.f;
      }
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * TQ;
      __syncthreads();  // every read of bs, xs (and of the old state) is done
      for (int e = tid; e < TQ * N; e += THREADS) {
        const int r = e / N, k = e - r * N;
        const int j = j0 + r;
        bs[r * np1 + k] =
            j < Q ? to_f32(bb[(size_t)(t0 + j) * N + k]) * expf(da_tot - dac[j]) : 0.f;
      }
      for (int e = tid; e < TQ * pv; e += THREADS) {
        const int r = e / pv, pp = e - r * pv;
        xs[e] = j0 + r < Q && pp < P
                    ? to_f32(xb[(size_t)(t0 + j0 + r) * x_row + pp]) * dts[j0 + r]
                    : 0.f;
      }
      __syncthreads();
      const int rows = min(TQ, Q - j0);
      for (int j = 0; j < rows; ++j) {
        float xv[PJ], bv[NJ];
#pragma unroll
        for (int r = 0; r < PJ; ++r) xv[r] = r < pj ? xs[j * pv + ty + 16 * r] : 0.f;
#pragma unroll
        for (int c = 0; c < NJ; ++c) bv[c] = tx + 16 * c < N ? bs[j * np1 + tx + 16 * c] : 0.f;
#pragma unroll
        for (int r = 0; r < PJ; ++r)
#pragma unroll
          for (int c = 0; c < NJ; ++c) upd[r][c] = fmaf(xv[r], bv[c], upd[r][c]);
      }
    }
    __syncthreads();  // every read of the old state is done
#pragma unroll
    for (int r = 0; r < PJ; ++r)
#pragma unroll
      for (int c = 0; c < NJ; ++c) {
        const int pp = ty + 16 * r, k = tx + 16 * c;
        if (r < pj && c < nj && pp < P && k < N) st[pp * np1 + k] = upd[r][c];
      }
    __syncthreads();  // the new state is written before the next chunk reads it
  }
}

template <typename T, int PMAX, int NMAX>
cudaError_t launch(const void* x, const float* dt, const float* a, const void* b,
                   const void* c, void* y, int batch, const Shape& sh, cudaStream_t stream) {
  const int smem = (int)(smem_floats(sh) * sizeof(float));
  if (smem > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_scan<T, PMAX, NMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(sh.h, batch);
  ssd_chunk_scan<T, PMAX, NMAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<T*>(y), sh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const float* dt, const float* a, const void* b,
                     const void* c, void* y, int batch, const Shape& sh, cudaStream_t stream) {
  if (sh.p <= 64 && sh.n <= 64) return launch<T, 64, 64>(x, dt, a, b, c, y, batch, sh, stream);
  return cudaErrorInvalidValue;
}

}  // namespace simt

// ---------------------------------------------------------------------------
// wgmma route: TMA + mbarrier ring + tensor cores, bf16
// ---------------------------------------------------------------------------

namespace wg {

constexpr int TILE = 64;                            // rows of a tile; P and N in one atom
constexpr uint32_t ROW_BYTES = 128;                 // one swizzle row: 64 bf16
constexpr uint32_t TILE_BYTES = TILE * ROW_BYTES;   // 8 KB
constexpr uint32_t KSTEP_BYTES = 16 * ROW_BYTES;    // 16 k rows of an MN-major tile
constexpr uint32_t GROUP_BYTES = 1024;              // descriptor stride of 8 rows
constexpr int MAX_Q = 2048;                         // chunk rows (dt, dacum in shared memory)
constexpr int STAGES = 2;                           // B and x tiles in flight
constexpr int CONSUMERS = 128;                      // one warpgroup
constexpr int THREADS = CONSUMERS + 32;             // and one producer warp
constexpr uint32_t CONSUMER_BAR = 1;                // named barrier of the warpgroup
constexpr int STATE_TILES = 2 * STAGES;             // ssd_states: x and B per stage
constexpr int OUT_TILES = 2 + 2 * STAGES;           // ssd_outputs: C, the state copy, B and x
constexpr float LOG2E = 1.4426950408889634f;

struct Geo {
  int s, h, p, n, q, nc, nt;  // nc chunks of q rows; nt 64-row tiles a chunk
};

// Tiles (1024-byte aligned), two float arrays of q and the scan's warp
// totals, then `bars` mbarriers.
constexpr int PART = CONSUMERS / 32;
size_t smem_bytes(int tiles, int q, int bars) {
  return 1024 + (size_t)tiles * TILE_BYTES + sizeof(float) * (2 * (size_t)q + PART) +
         8 * (size_t)bars;
}

// 2^x, subnormal results flushed to 0 (the decays here are at most 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The consumer warpgroup: dts[i] = dt and dac[i] = unit * (the inclusive
// cumulative sum of dt * a) over rows [0, rows) of the chunk that starts at
// row t0 of dt_bh (stride h_stride). Each thread sums a segment of
// consecutive rows in order (its loads issued together), the segments are
// joined by a shuffle scan and the 4 warp totals in `part`; it ends with a
// barrier of the warpgroup, so every thread may read any row after it.
__device__ void chunk_scan(const float* __restrict__ dt_bh, int h_stride, int t0, int rows,
                           float ah, float unit, float* dts, float* dac, float* part, int tid) {
  const int per = (rows + CONSUMERS - 1) / CONSUMERS;
  const int lo = min(tid * per, rows), hi = min(lo + per, rows);
  const int lane = tid % 32, warp = tid / 32;
  float run = 0.f;
#pragma unroll 4
  for (int i = lo; i < hi; ++i) {
    const float d = dt_bh[(size_t)(t0 + i) * h_stride];
    dts[i] = d;
    run += d * ah;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) part[warp] = incl;
  hopper::named_sync(CONSUMER_BAR, CONSUMERS);
  float acc = incl - run;  // the rows before this thread's segment
  for (int w = 0; w < warp; ++w) acc += part[w];
  for (int i = lo; i < hi; ++i) {
    acc += dts[i] * ah;
    dac[i] = acc * unit;
  }
  hopper::named_sync(CONSUMER_BAR, CONSUMERS);
}

// The states entering chunks 1 .. NC - 1 of one (head, batch), in bf16.
__global__ void __launch_bounds__(THREADS, 1)
ssd_states(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_b,
           const float* __restrict__ dt, const float* __restrict__ a,
           __nv_bfloat16* __restrict__ states, const Geo g) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t tiles = (base + 1023) & ~1023u;
  uint8_t* tiles_p = smem_raw + (tiles - base);
  float* ws = reinterpret_cast<float*>(tiles_p + STATE_TILES * TILE_BYTES);  // [q] row weights
  float* dac = ws + g.q;                                                      // [q] dacum
  float* part = dac + g.q;                                                    // [PART]
  const uint32_t full0 = tiles + STATE_TILES * TILE_BYTES + 4 * (2 * g.q + PART);
  const uint32_t empty0 = full0 + 8 * STAGES;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int chunks = g.nc - 1;  // the last chunk's update is never read

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp; one thread issues
    if (tid == CONSUMERS) {
      int it = 0;
      for (int c = 0; c < chunks; ++c)
        for (int t = 0; t < g.nt; ++t, ++it) {
          const int st = it % STAGES;
          mbar_wait(empty0 + 8 * st, ((it / STAGES) & 1) ^ 1);
          const uint32_t full = full0 + 8 * st, xs = tiles + st * 2 * TILE_BYTES;
          const int row = c * g.q + t * TILE;
          mbar_arrive_expect_tx(full, 2 * TILE_BYTES);
          tma_load_4d(xs, &map_x, full, 0, h, row, b);
          tma_load_2d(xs + TILE_BYTES, &map_b, full, 0, b * g.s + row);
        }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const float ah = a[h];
  const float* dtb = dt + (size_t)b * g.s * g.h + h;
  float acc[32];  // the (P, N) state: rows p, columns n
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  fence_operands(acc);

  int it = 0;
  for (int c = 0; c < chunks; ++c) {
    named_sync(CONSUMER_BAR, CONSUMERS);  // the chunk before is done with ws
    chunk_scan(dtb, g.h, c * g.q, g.q, ah, 1.f, ws, dac, part, tid);
    const float tot = dac[g.q - 1];
    for (int i = tid; i < g.q; i += CONSUMERS) ws[i] *= ex2((tot - dac[i]) * LOG2E);
    named_sync(CONSUMER_BAR, CONSUMERS);
    const float keep = ex2(tot * LOG2E);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= keep;

    for (int t = 0; t < g.nt; ++t, ++it) {
      const int st = it % STAGES;
      const uint32_t xs = tiles + st * 2 * TILE_BYTES, bs = xs + TILE_BYTES;
      mbar_wait(full0 + 8 * st, (it / STAGES) & 1);
      // B row j -> B_j dt_j exp(da_tot - dacum_j) in bf16, in place (the
      // swizzle moves 16-byte pieces within their row only); rows past the
      // chunk -> 0.
      uint4* piece = reinterpret_cast<uint4*>(tiles_p + st * 2 * TILE_BYTES + TILE_BYTES);
      for (int k = tid; k < TILE * 8; k += CONSUMERS) {
        const int j = t * TILE + k / 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (j < g.q) {
          const float w = ws[j];
          v = piece[k];
          __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h2[e]);
            h2[e] = __floats2bfloat162_rn(f.x * w, f.y * w);
          }
        }
        piece[k] = v;
      }
      fence_proxy_async();
      named_sync(CONSUMER_BAR, CONSUMERS);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 16 chunk rows a step
        wgmma_m64n64k16<1, 1>(acc, make_desc(xs + kk * KSTEP_BYTES, TILE_BYTES, GROUP_BYTES),
                              make_desc(bs + kk * KSTEP_BYTES, TILE_BYTES, GROUP_BYTES));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      mbar_arrive(empty0 + 8 * st);
    }

    // The state entering chunk c + 1, rounded to bf16, as (P, N) rows of 64.
    __nv_bfloat16* out = states + (((size_t)b * chunks + c) * g.h + h) * TILE * TILE;
    const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(out + (r0 + 8 * hh) * TILE + 8 * j + c0) =
            pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
}

// y for one 64-row tile of one chunk of one (head, batch).
__global__ void __launch_bounds__(THREADS)
ssd_outputs(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_b,
            const __grid_constant__ CUtensorMap map_c, const __grid_constant__ CUtensorMap map_st,
            const float* __restrict__ dt, const float* __restrict__ a,
            __nv_bfloat16* __restrict__ y, const Geo g) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t tiles = (base + 1023) & ~1023u;
  uint8_t* tiles_p = smem_raw + (tiles - base);
  const uint32_t sc = tiles, sst = tiles + TILE_BYTES, ring = tiles + 2 * TILE_BYTES;
  float* dts = reinterpret_cast<float*>(tiles_p + OUT_TILES * TILE_BYTES);  // [q] dt
  float* dac = dts + g.q;                                                    // [q] dacum log2(e)
  float* part = dac + g.q;                                                   // [PART]
  const uint32_t c_bar = tiles + OUT_TILES * TILE_BYTES + 4 * (2 * g.q + PART);
  const uint32_t full0 = c_bar + 8, empty0 = full0 + 8 * STAGES;
  const int h = blockIdx.x % g.h, bc = blockIdx.x / g.h;  // heads fastest: they share C, B
  const int b = bc / g.nc, c = bc - b * g.nc;
  const int it = g.nt - 1 - blockIdx.y;  // the tiles with the most column tiles first
  const int i0 = it * TILE, t0 = c * g.q;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(c_bar, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp; one thread issues
    if (tid == CONSUMERS) {
      mbar_arrive_expect_tx(c_bar, (c > 0 ? 2 : 1) * TILE_BYTES);
      tma_load_2d(sc, &map_c, c_bar, 0, b * g.s + t0 + i0);
      if (c > 0) tma_load_2d(sst, &map_st, c_bar, 0, ((b * (g.nc - 1) + c - 1) * g.h + h) * TILE);
      for (int jt = 0; jt <= it; ++jt) {  // the column tiles at or below the diagonal
        const int st = jt % STAGES;
        mbar_wait(empty0 + 8 * st, ((jt / STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * st, bs = ring + st * 2 * TILE_BYTES;
        mbar_arrive_expect_tx(full, 2 * TILE_BYTES);
        tma_load_2d(bs, &map_b, full, 0, b * g.s + t0 + jt * TILE);
        tma_load_4d(bs + TILE_BYTES, &map_x, full, 0, h, t0 + jt * TILE, b);
      }
    }
    return;
  }

  chunk_scan(dt + (size_t)b * g.s * g.h + h, g.h, t0, min(i0 + TILE, g.q), a[h], LOG2E, dts,
             dac, part, tid);
  // Below the diagonal tile, exp(dacum_i - dacum_j) = u_i w_j about m, the
  // dacum of the column tile's last row: u_i = 2^(dac_i - m) and w_j =
  // 2^(m - dac_j) are at most 1 (dacum falls), so neither overflows. Here
  // dts[j] becomes w_j dt_j for the rows of those tiles (all whole).
  for (int j = tid; j < i0; j += CONSUMERS) dts[j] *= ex2(dac[j | (TILE - 1)] - dac[j]);
  named_sync(CONSUMER_BAR, CONSUMERS);

  // Fragment of m64n64: warp w holds rows 16w + lane/4 (+ 8), columns
  // 8j + 2 (lane % 4) (+ 1) in d[4j + {0, 1}] (+ {2, 3}).
  const int warp = tid / 32, lane = tid % 32;
  const int c0 = 2 * (lane % 4);
  int ri[2];
  bool rv[2];
  float dr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    ri[hh] = i0 + 16 * warp + lane / 4 + 8 * hh;
    rv[hh] = ri[hh] < g.q;  // rows past a ragged chunk are not the chunk's
    dr[hh] = rv[hh] ? dac[ri[hh]] : 0.f;
  }
  float acc[32], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = s[i] = 0.f;
  fence_operands(acc);
  fence_operands(s);
  mbar_wait(c_bar, 0);

  if (c > 0) {  // y = exp(dacum_i) (C_i state^T)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16<0>(acc, make_desc(sc + kk * 32, 16, GROUP_BYTES),
                         make_desc(sst + kk * 32, 16, GROUP_BYTES), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float decay = rv[hh] ? ex2(dr[hh]) : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[4 * j + 2 * hh] *= decay;
        acc[4 * j + 2 * hh + 1] *= decay;
      }
    }
  }

  for (int jt = 0; jt <= it; ++jt) {
    const int st = jt % STAGES;
    const uint32_t bs = ring + st * 2 * TILE_BYTES, xs = bs + TILE_BYTES;
    mbar_wait(full0 + 8 * st, (jt / STAGES) & 1);
    wgmma_fence();  // S = C_i B_j^T
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16<0>(s, make_desc(sc + kk * 32, 16, GROUP_BYTES),
                         make_desc(bs + kk * 32, 16, GROUP_BYTES), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);

    // G = S exp(dacum_i - dacum_j) dt_j. On the diagonal tile it is taken
    // whole, masked before the exponent (j > i, rows past the chunk give 0);
    // below it as S u_i (w_j dt_j).
    if (jt == it) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          const int col = i0 + 8 * j + c0 + bb;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float& v = s[4 * j + 2 * hh + bb];
            v = rv[hh] && col <= ri[hh] ? v * ex2(dr[hh] - dac[col]) * dts[col] : 0.f;
          }
        }
    } else {
      const float m = dac[jt * TILE + TILE - 1];
      float u[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) u[hh] = rv[hh] ? ex2(dr[hh] - m) : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          const float w = dts[jt * TILE + 8 * j + c0 + bb];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) s[4 * j + 2 * hh + bb] *= u[hh] * w;
        }
    }
    uint32_t ga[4][4];  // G in bf16 as the A fragments of the 4 steps of 16 rows of x
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) ga[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    fence_operands(acc);
    wgmma_fence();  // y += G x_j
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_rs(acc, ga[kk], make_desc(xs + kk * KSTEP_BYTES, TILE_BYTES, GROUP_BYTES));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    mbar_arrive(empty0 + 8 * st);  // this thread is done with the stage
  }

  // The tile in bf16 through the C tile's buffer (its last reader, the
  // last S, has completed): each warp writes its 16 rows there, swizzled
  // by 16-byte pieces so that the 8 rows of a store hit 8 bank groups, then
  // copies them out as 16-byte pieces, 8 lanes a 128-byte row. Rows past
  // the chunk and pieces past P are not written.
  uint8_t* stage = tiles_p + 16 * warp * ROW_BYTES;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = lane / 4 + 8 * hh;  // row within the warp's 16
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(stage + r * ROW_BYTES + ((j ^ (r % 8)) * 16) + 2 * c0) =
          pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = 4 * k + lane / 8, piece = lane % 8;  // 16 rows x 8 pieces over 4 steps
    const int row = i0 + 16 * warp + r;
    if (row < g.q && piece * 8 < g.p)
      *reinterpret_cast<uint4*>(y + (((size_t)b * g.s + t0 + row) * g.h + h) * g.p + piece * 8) =
          *reinterpret_cast<const uint4*>(stage + r * ROW_BYTES + ((piece ^ (r % 8)) * 16));
  }
}

// Above 48 KB of dynamic shared memory a kernel must opt in, once per device.
template <typename K>
cudaError_t opt_in(K kernel, size_t bytes, int device, std::atomic<unsigned long long>& ready) {
  const unsigned long long bit = 1ull << (device & 63);
  if (ready.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) ready.fetch_or(bit);
  return e;
}

cudaError_t launch(const void* x, const float* dt, const float* a, const void* b, const void* c,
                   void* y, void* states, int batch, const Geo& g, int device,
                   cudaStream_t stream) {
  const bool chained = g.nc > 1;
  CUtensorMap map_x, map_b, map_c, map_st;
  if (!hopper::encode_4d(&map_x, x, batch, g.s, g.h, g.p, 1, TILE) ||
      !hopper::encode_2d(&map_b, b, batch * g.s, g.n, TILE) ||
      !hopper::encode_2d(&map_c, c, batch * g.s, g.n, TILE))
    return cudaErrorInvalidValue;
  if (chained) {
    if (!hopper::encode_2d(&map_st, states, batch * (g.nc - 1) * g.h * TILE, TILE, TILE))
      return cudaErrorInvalidValue;
  } else {
    map_st = map_c;  // not read: chunk 0 starts from the zero state
  }
  static std::atomic<unsigned long long> ready_states{0}, ready_outputs{0};
  cudaError_t e = opt_in(ssd_states, smem_bytes(STATE_TILES, MAX_Q, 2 * STAGES), device,
                         ready_states);
  if (e == cudaSuccess)
    e = opt_in(ssd_outputs, smem_bytes(OUT_TILES, MAX_Q, 1 + 2 * STAGES), device,
               ready_outputs);
  if (e != cudaSuccess) return e;
  if (chained) {
    ssd_states<<<dim3(g.h, batch), THREADS, smem_bytes(STATE_TILES, g.q, 2 * STAGES),
                 stream>>>(map_x, map_b, dt, a, static_cast<__nv_bfloat16*>(states), g);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  ssd_outputs<<<dim3(g.h * batch * g.nc, g.nt), THREADS,
                smem_bytes(OUT_TILES, g.q, 1 + 2 * STAGES), stream>>>(
      map_x, map_b, map_c, map_st, dt, a, static_cast<__nv_bfloat16*>(y), g);
  return cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// tf32x3 route: fp32 split into TF32 halves, three tensor-core products
// ---------------------------------------------------------------------------

namespace tf {

using hopper::ATOM_F32;                                // fp32 values in one 128-byte swizzle row
using wg::CONSUMER_BAR;
using wg::LOG2E;
using wg::TILE;
constexpr uint32_t ROW_BYTES = 128;                    // one swizzle row: 32 fp32
constexpr uint32_t ATOM_BYTES = TILE * ROW_BYTES;      // 64 rows x 32 fp32: 8 KB
constexpr uint32_t HALF_BYTES = 2 * ATOM_BYTES;        // 64 rows x 64 fp32: one TF32 half
constexpr uint32_t SPLIT_BYTES = 2 * HALF_BYTES;       // hi and lo
constexpr int STAGES = 2;                              // raw tiles in flight
// ssd_states_tf32x3: one consumer warpgroup; STAGES x (raw x, raw B), then
// (x o w)^T and B^T split
constexpr int STATE_CONSUMERS = 128;
constexpr uint32_t STATE_STAGE = 2 * HALF_BYTES;
constexpr uint32_t STATE_BYTES = STAGES * STATE_STAGE + 2 * SPLIT_BYTES;
// ssd_outputs_tf32x3: two consumer warpgroups, one 64-row tile each; C of
// both tiles split, the state split (then x^T split), STAGES x (B split, raw x)
constexpr int OUT_CONSUMERS = 256;
constexpr uint32_t OUT_STAGE = SPLIT_BYTES + HALF_BYTES;
constexpr uint32_t OUT_BYTES = 2 * SPLIT_BYTES + SPLIT_BYTES + STAGES * OUT_STAGE;

// After the tiles: the scan's warp totals (fp64), then dacum as two fp32
// halves (hi, lo), dt and (ssd_outputs) w_j dt_j, `rows` fp32 arrays of q,
// and `extra` fp32, padded to 8 bytes; then `bars` mbarriers.
__host__ __device__ inline size_t scan_bytes(int q, int consumers, int rows, int extra) {
  return 8 * (size_t)(consumers / 32) + 8 * (((size_t)rows * q + extra + 1) / 2);
}
size_t smem_bytes(uint32_t tiles_bytes, int q, int consumers, int rows, int extra, int bars) {
  return 1024 + tiles_bytes + scan_bytes(q, consumers, rows, extra) + 8 * (size_t)bars;
}
// ssd_outputs_tf32x3's w_j dt_j about each 8-row group's last dacum over its
// two diagonal tiles, and the decays across those 16 groups.
constexpr int OUT_EXTRA = 2 * TILE + 16;

// wg::chunk_scan with an fp64 sum, by NT consumer threads: dts[i] = dt and
// the inclusive cumulative sum of dt * a, over rows [0, rows) of the chunk
// that starts at row t0 of dt_bh (stride h_stride), as two fp32 halves
// dhi[i] + dlo[i]. In fp32, dacum reaches ~-400 at the end of Zamba2's
// chunks, where its ulp (3e-5) puts ~1e-5 into exp(dacum_i - dacum_j) near
// the diagonal (with an fp32 scan this route misses the plain version by
// 1.25e-5 at Zamba2's prefill shape); a difference of the halves, (hi_i -
// hi_j) + (lo_i - lo_j), is the fp64 difference to fp32's own rounding, in
// fp32 arithmetic. Ends with a barrier of the NT threads.
template <int NT>
__device__ void chunk_scan64(const float* __restrict__ dt_bh, int h_stride, int t0, int rows,
                             double ah, float* dts, float* dhi, float* dlo, double* part, int tid) {
  const int per = (rows + NT - 1) / NT;
  const int lo = min(tid * per, rows), hi = min(lo + per, rows);
  const int lane = tid % 32, warp = tid / 32;
  double run = 0.0;
#pragma unroll 4
  for (int i = lo; i < hi; ++i) {
    const float d = dt_bh[(size_t)(t0 + i) * h_stride];
    dts[i] = d;
    run += (double)d * ah;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) part[warp] = incl;
  hopper::named_sync(CONSUMER_BAR, NT);
  double acc = incl - run;  // the rows before this thread's segment
  for (int w = 0; w < warp; ++w) acc += part[w];
  for (int i = lo; i < hi; ++i) {
    acc += (double)dts[i] * ah;
    const float h = (float)acc;
    dhi[i] = h;
    dlo[i] = (float)(acc - (double)h);
  }
  hopper::named_sync(CONSUMER_BAR, NT);
}

// exp(a - b) of two dacum values given as fp32 halves.
__device__ __forceinline__ float exp_diff(float ah, float al, float bh, float bl) {
  return wg::ex2(((ah - bh) + (al - bl)) * LOG2E);
}

__device__ __forceinline__ float4 split4(float4& x) {
  float4 lo;
  hopper::split_tf32(x.x, x.x, lo.x);
  hopper::split_tf32(x.y, x.y, lo.y);
  hopper::split_tf32(x.z, x.z, lo.z);
  hopper::split_tf32(x.w, x.w, lo.w);
  return lo;
}

// ATOMS 32-wide atoms of a raw 64-row fp32 tile at `hi`, split in place by
// NT consumer threads: the hi halves stay there, the lo halves go to the
// same offsets from `lo` (the swizzle moves both copies alike).
template <int ATOMS, int NT>
__device__ __forceinline__ void split_in_place(uint8_t* hi, uint8_t* lo, int tid) {
  float4* h = reinterpret_cast<float4*>(hi);
  float4* l = reinterpret_cast<float4*>(lo);
  constexpr int N = ATOMS * (int)(ATOM_BYTES / 16) / NT;
  float4 x[N];
#pragma unroll
  for (int k = 0; k < N; ++k) x[k] = h[tid + k * NT];  // every load in flight first
#pragma unroll
  for (int k = 0; k < N; ++k) {
    l[tid + k * NT] = split4(x[k]);
    h[tid + k * NT] = x[k];
  }
}

// The raw 64-row tile at `raw` (row r, 64 columns k in two 32-wide atoms,
// TMA's 128-byte swizzle: the 16-byte piece c of a row at c ^ (r % 8))
// written transposed and split by NT consumer threads into the K-major
// tiles at `hi` and `lo` (row k, the 64 r in two atoms, the same swizzle):
// hi + lo = scale[r] in[r][k] (scale nullptr: 1), and 0 for r >= valid.
// PERM writes row r of each 8 at column (r % 8) / 2 + 4 (r % 2) of its 8:
// the order in which an m64n64 accumulator's columns are a register A
// fragment (hopper::wgmma_m64n64k8_tf32_rs). A warp reads 32 consecutive
// rows of one piece (the swizzle spreads them over every bank) and writes
// 32 consecutive r of one row k (one 128-byte row): no bank conflicts.
template <int NT, bool PERM>
__device__ __forceinline__ void transpose_split(const uint8_t* raw, uint8_t* hi, uint8_t* lo,
                                                const float* scale, int valid, int tid) {
  constexpr int N = TILE * 16 / NT;
  float4 v[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {  // every load in flight first
    const int i = tid + k * NT, r = i % TILE, atom = i / (8 * TILE), c = (i / TILE) % 8;
    v[k] = r < valid ? *reinterpret_cast<const float4*>(raw + atom * ATOM_BYTES + r * ROW_BYTES +
                                                        ((c ^ (r % 8)) * 16))
                     : make_float4(0.f, 0.f, 0.f, 0.f);  // whatever the raw rows hold
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int i = tid + k * NT, r = i % TILE, atom = i / (8 * TILE), c = (i / TILE) % 8;
    if (scale != nullptr && r < valid) {
      const float w = scale[r];
      v[k].x *= w;
      v[k].y *= w;
      v[k].z *= w;
      v[k].w *= w;
    }
    const float4 l4 = split4(v[k]);
    const float hv[4] = {v[k].x, v[k].y, v[k].z, v[k].w}, lv[4] = {l4.x, l4.y, l4.z, l4.w};
    const int rp = PERM ? (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2) : r;
    const uint32_t at = (rp / ATOM_F32) * ATOM_BYTES + (rp % 4) * 4, rc = (rp % ATOM_F32) / 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kr = atom * ATOM_F32 + 4 * c + e;  // the output row
      const uint32_t off = at + kr * ROW_BYTES + ((rc ^ (kr % 8)) * 16);
      *reinterpret_cast<float*>(hi + off) = hv[e];
      *reinterpret_cast<float*>(lo + off) = lv[e];
    }
  }
}

// The states entering chunks 1 .. NC - 1 of one (head, batch), as their TF32
// halves: `hi` and `lo` (B, NC - 1, H, 64, 64), rows p, columns n. NA: 32-wide
// atoms of N.
template <int NA>
__global__ void __launch_bounds__(STATE_CONSUMERS + 32, 1)
ssd_states_tf32x3(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_b, const float* __restrict__ dt,
                  const float* __restrict__ a, float* __restrict__ hi, float* __restrict__ lo,
                  const wg::Geo g) {
  using namespace hopper;
  constexpr int NT = STATE_CONSUMERS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t tiles = (base + 1023) & ~1023u;
  uint8_t* tp = smem_raw + (tiles - base);
  // ring: STAGES x (raw x, raw B); then (x o w)^T hi, lo and B^T hi, lo
  const uint32_t sxw = tiles + STAGES * STATE_STAGE, sbt = sxw + SPLIT_BYTES;
  double* part = reinterpret_cast<double*>(tp + STATE_BYTES);  // [NT / 32]
  float* dhi = reinterpret_cast<float*>(part + NT / 32);       // [q] dacum, hi half
  float* dlo = dhi + g.q;                                      // [q] dacum, lo half
  float* ws = dlo + g.q;                                       // [q] row weights
  const uint32_t full0 = tiles + STATE_BYTES + scan_bytes(g.q, NT, 3, 0);
  const uint32_t empty0 = full0 + 8 * STAGES;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int chunks = g.nc - 1;  // the last chunk's update is never read
  const int pa = (g.p + ATOM_F32 - 1) / ATOM_F32;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, NT);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NT) {  // the producer warp; one thread issues
    if (tid == NT) {
      int it = 0;
      for (int c = 0; c < chunks; ++c)
        for (int t = 0; t < g.nt; ++t, ++it) {
          const int st = it % STAGES;
          mbar_wait(empty0 + 8 * st, ((it / STAGES) & 1) ^ 1);
          const uint32_t full = full0 + 8 * st, xs = tiles + st * STATE_STAGE;
          const int row = c * g.q + t * TILE;
          mbar_arrive_expect_tx(full, (pa + NA) * ATOM_BYTES);
          for (int at = 0; at < pa; ++at)
            tma_load_4d(xs + at * ATOM_BYTES, &map_x, full, at * ATOM_F32, h, row, b);
#pragma unroll
          for (int at = 0; at < NA; ++at)
            tma_load_2d(xs + HALF_BYTES + at * ATOM_BYTES, &map_b, full, at * ATOM_F32,
                        b * g.s + row);
        }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const double ah = a[h];
  const float* dtb = dt + (size_t)b * g.s * g.h + h;
  float acc[32], upd[32];  // the (P, N) state: rows p, columns n; one tile's update
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = upd[i] = 0.f;
  fence_operands(acc);
  fence_operands(upd);

  int it = 0;
  for (int c = 0; c < chunks; ++c) {
    named_sync(CONSUMER_BAR, NT);  // the chunk before is done with ws
    chunk_scan64<NT>(dtb, g.h, c * g.q, g.q, ah, ws, dhi, dlo, part, tid);
    const float th = dhi[g.q - 1], tl = dlo[g.q - 1];
    for (int i = tid; i < g.q; i += NT) ws[i] *= exp_diff(th, tl, dhi[i], dlo[i]);
    named_sync(CONSUMER_BAR, NT);
    const float keep = wg::ex2((th + tl) * LOG2E);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= keep;

    for (int t = 0; t < g.nt; ++t, ++it) {
      const int st = it % STAGES;
      const uint8_t* xs = tp + st * STATE_STAGE;
      mbar_wait(full0 + 8 * st, (it / STAGES) & 1);
      named_sync(CONSUMER_BAR, NT);  // every warp's product of the tile before retired
      // (x o w)^T: row j of x times w_j, 0 past the chunk; B^T as it is
      // (rows past the chunk meet those zeros).
      transpose_split<NT, false>(xs, tp + (sxw - tiles), tp + (sxw - tiles) + HALF_BYTES,
                                 ws + t * TILE, g.q - t * TILE, tid);
      transpose_split<NT, false>(xs + HALF_BYTES, tp + (sbt - tiles),
                                 tp + (sbt - tiles) + HALF_BYTES, nullptr, TILE, tid);
      fence_proxy_async();
      named_sync(CONSUMER_BAR, NT);
      mbar_arrive(empty0 + 8 * st);  // the raw tiles are copied out
      wgmma_fence();
#pragma unroll
      for (int at = 0; at < 2; ++at)  // 64 chunk rows: 8 k8 steps
        tf32x3_stage<64, ATOM_F32>(upd, sxw + at * ATOM_BYTES, sxw + HALF_BYTES + at * ATOM_BYTES,
                                   sbt + at * ATOM_BYTES, sbt + HALF_BYTES + at * ATOM_BYTES,
                                   at == 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(upd);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += upd[i];  // promoted into fp32
      fence_operands(upd);
    }

    // The state entering chunk c + 1, as its TF32 halves, (P, N) rows of 64.
    const size_t at = (((size_t)b * chunks + c) * g.h + h) * TILE * TILE;
    const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float2 vh, vl;
        split_tf32(acc[4 * j + 2 * hh], vh.x, vl.x);
        split_tf32(acc[4 * j + 2 * hh + 1], vh.y, vl.y);
        const size_t off = at + (r0 + 8 * hh) * TILE + 8 * j + c0;
        *reinterpret_cast<float2*>(hi + off) = vh;
        *reinterpret_cast<float2*>(lo + off) = vl;
      }
  }
}

// y for two 64-row tiles (2 i2 and 2 i2 + 1) of one chunk of one (head,
// batch), one warpgroup each. No producer warp: a block of 288 threads gets
// the registers of 384 (warps are allocated by fours), and ptxas then
// spills G's fragments; thread 0 issues the loads. NA: 32-wide atoms of N.
template <int NA>
__global__ void __launch_bounds__(OUT_CONSUMERS, 1)
ssd_outputs_tf32x3(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_b,
                   const __grid_constant__ CUtensorMap map_c,
                   const __grid_constant__ CUtensorMap map_sh,
                   const __grid_constant__ CUtensorMap map_sl, const float* __restrict__ dt,
                   const float* __restrict__ a, float* __restrict__ y, const wg::Geo g) {
  using namespace hopper;
  constexpr int NT = OUT_CONSUMERS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t tiles = (base + 1023) & ~1023u;
  uint8_t* tp = smem_raw + (tiles - base);
  // C of tile 0 hi, lo, of tile 1 hi, lo | state hi, lo, then x^T hi, lo |
  // STAGES x (B hi, lo, raw x)
  const uint32_t sc = tiles, sx = sc + 2 * SPLIT_BYTES, ring = sx + SPLIT_BYTES;
  double* part = reinterpret_cast<double*>(tp + OUT_BYTES);  // [NT / 32]
  float* dhi = reinterpret_cast<float*>(part + NT / 32);     // [q] dacum, hi half
  float* dlo = dhi + g.q;                                    // [q] dacum, lo half
  float* dts = dlo + g.q;                                    // [q] dt
  float* wdt = dts + g.q;                                    // [q] w_j dt_j
  float* w8 = wdt + g.q;                                     // [2 TILE] w_j dt_j, 8-row groups
  float* eg = w8 + 2 * TILE;                                 // [16] decays across the groups
  const uint32_t c_bar = tiles + OUT_BYTES + scan_bytes(g.q, NT, 4, OUT_EXTRA);
  const uint32_t full0 = c_bar + 8;
  const int h = blockIdx.x % g.h, bc = blockIdx.x / g.h;  // heads fastest: they share C, B
  const int b = bc / g.nc, c = bc - b * g.nc;
  const int pairs = (g.nt + 1) / 2;
  const int i2 = pairs - 1 - blockIdx.y;        // the tiles with the most column tiles first
  const int last = min(2 * i2 + 1, g.nt - 1);   // the block's last column tile
  const int t0 = c * g.q;
  const int tid = threadIdx.x;
  const int pa = (g.p + ATOM_F32 - 1) / ATOM_F32;

  // B_j and x_j, raw, into stage jt % STAGES (thread 0).
  const auto load_tile = [&](int jt) {
    const int st = jt % STAGES;
    const uint32_t full = full0 + 8 * st, bs = ring + st * OUT_STAGE;
    mbar_arrive_expect_tx(full, (NA + pa) * ATOM_BYTES);
#pragma unroll
    for (int at = 0; at < NA; ++at)
      tma_load_2d(bs + at * ATOM_BYTES, &map_b, full, at * ATOM_F32, b * g.s + t0 + jt * TILE);
    for (int at = 0; at < pa; ++at)
      tma_load_4d(bs + SPLIT_BYTES + at * ATOM_BYTES, &map_x, full, at * ATOM_F32, h,
                  t0 + jt * TILE, b);
  };
  if (tid == 0) {
    mbar_init(c_bar, 1);
    for (int st = 0; st < STAGES; ++st) mbar_init(full0 + 8 * st, 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(c_bar, (c > 0 ? 4 : 2) * NA * ATOM_BYTES);
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int at = 0; at < NA; ++at)
        tma_load_2d(sc + w * SPLIT_BYTES + at * ATOM_BYTES, &map_c, c_bar, at * ATOM_F32,
                    b * g.s + t0 + (2 * i2 + w) * TILE);
    if (c > 0) {
      const int row = ((b * (g.nc - 1) + c - 1) * g.h + h) * TILE;
#pragma unroll
      for (int at = 0; at < NA; ++at) {
        tma_load_2d(sx + at * ATOM_BYTES, &map_sh, c_bar, at * ATOM_F32, row);
        tma_load_2d(sx + HALF_BYTES + at * ATOM_BYTES, &map_sl, c_bar, at * ATOM_F32, row);
      }
    }
    for (int jt = 0; jt < STAGES && jt <= last; ++jt) load_tile(jt);
  }
  __syncthreads();

  chunk_scan64<NT>(dt + (size_t)b * g.s * g.h + h, g.h, t0, min((last + 1) * TILE, g.q), a[h],
                   dts, dhi, dlo, part, tid);
  // Below the diagonal tile, exp(dacum_i - dacum_j) = u_i w_j about m, the
  // dacum of the column tile's last row, as the wgmma route takes it: wdt[j]
  // = w_j dt_j for the rows of those tiles (all whole). The diagonal tile
  // of one warpgroup is below the other's, so dt stays beside it.
  for (int j = tid; j < last * TILE; j += NT) {
    const int m = j | (TILE - 1);
    wdt[j] = dts[j] * exp_diff(dhi[m], dlo[m], dhi[j], dlo[j]);
  }
  // Within the two diagonal tiles, the same about each 8-row group's last
  // dacum: w8 for their rows, and eg[k] = exp(dacum at the end of group k -
  // at the end of group k - 1), the decay across group k; rows past the
  // chunk 0.
  for (int j = tid; j < 2 * TILE; j += NT) {
    const int r = 2 * i2 * TILE + j, m = min(r | 7, g.q - 1);
    w8[j] = r < g.q ? dts[r] * exp_diff(dhi[m], dlo[m], dhi[r], dlo[r]) : 0.f;
    if (j < 16) {
      const int e = 2 * i2 * TILE + 8 * j + 7;
      eg[j] = j % 8 > 0 && e < g.q ? exp_diff(dhi[e], dlo[e], dhi[e - 8], dlo[e - 8]) : 0.f;
    }
  }

  // This warpgroup's tile, and its fragment of m64n64: warp w holds rows
  // 16w + lane/4 (+ 8), columns 8j + 2 (lane % 4) (+ 1) in d[4j + {0, 1}]
  // (+ {2, 3}).
  const int wgi = tid / 128, wtid = tid % 128;
  const int it = 2 * i2 + wgi, i0 = it * TILE;  // it == nt: the warpgroup has no rows
  const uint32_t scw = sc + wgi * SPLIT_BYTES;
  const int warp = wtid / 32, lane = wtid % 32;
  const int c0 = 2 * (lane % 4);
  int ri[2];
  bool rv[2];
  float drh[2], drl[2];
  float acc[32], s[32], pv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = s[i] = pv[i] = 0.f;
  fence_operands(acc);
  fence_operands(s);
  fence_operands(pv);

  mbar_wait(c_bar, 0);
  split_in_place<NA, NT>(tp, tp + HALF_BYTES, tid);  // C of both tiles
  split_in_place<NA, NT>(tp + SPLIT_BYTES, tp + SPLIT_BYTES + HALF_BYTES, tid);
  fence_proxy_async();
  named_sync(CONSUMER_BAR, NT);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    ri[hh] = i0 + 16 * warp + lane / 4 + 8 * hh;
    rv[hh] = ri[hh] < g.q;  // rows past a ragged chunk are not the chunk's
    drh[hh] = rv[hh] ? dhi[ri[hh]] : 0.f;
    drl[hh] = rv[hh] ? dlo[ri[hh]] : 0.f;
  }

  if (c > 0) {  // y = exp(dacum_i) (C_i state^T)
    wgmma_fence();
#pragma unroll
    for (int at = 0; at < NA; ++at)
      tf32x3_stage<64, ATOM_F32>(acc, scw + at * ATOM_BYTES, scw + HALF_BYTES + at * ATOM_BYTES,
                                 sx + at * ATOM_BYTES, sx + HALF_BYTES + at * ATOM_BYTES, at == 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float decay = rv[hh] ? wg::ex2((drh[hh] + drl[hh]) * LOG2E) : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[4 * j + 2 * hh] *= decay;
        acc[4 * j + 2 * hh + 1] *= decay;
      }
    }
  }

  for (int jt = 0; jt <= last; ++jt) {
    const int st = jt % STAGES;
    const uint32_t bs = ring + st * OUT_STAGE;
    uint8_t* bp = tp + (bs - tiles);
    const bool active = jt <= it && it < g.nt;  // at or below this warpgroup's diagonal
    named_sync(CONSUMER_BAR, NT);  // every warp's products of the tile before retired
    // so tile jt - 1's stage (its B split read by S, its raw x copied out)
    // is free: tile jt + 1 loads into it while tile jt runs.
    if (tid == 0 && jt >= 1 && jt + 1 <= last) load_tile(jt + 1);
    mbar_wait(full0 + 8 * st, (jt / STAGES) & 1);
    split_in_place<NA, NT>(bp, bp + HALF_BYTES, tid);  // B_j
    transpose_split<NT, true>(bp + SPLIT_BYTES, tp + (sx - tiles), tp + (sx - tiles) + HALF_BYTES,
                              nullptr, TILE, tid);  // x_j^T, in the A fragment's order
    fence_proxy_async();
    named_sync(CONSUMER_BAR, NT);

    if (active) {
      wgmma_fence();  // S = C_i B_j^T
#pragma unroll
      for (int at = 0; at < NA; ++at)
        tf32x3_stage<64, ATOM_F32>(s, scw + at * ATOM_BYTES, scw + HALF_BYTES + at * ATOM_BYTES,
                                   bs + at * ATOM_BYTES, bs + HALF_BYTES + at * ATOM_BYTES,
                                   at == 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);
    }
    if (!active) continue;

    // G = S exp(dacum_i - dacum_j) dt_j. Below the diagonal tile it is S
    // u_i (w_j dt_j) about the column tile's last dacum. On the diagonal
    // tile, the 8 x 8 blocks on the diagonal are taken whole, masked before
    // the exponent (j > i, rows past the chunk give 0), and the blocks
    // below them are S u_i (w_j dt_j) about the column group's last dacum,
    // u_i walked down the groups by their decays: both factors at most 1,
    // and 6 exponents a thread where 32 were. The warp's rows lie in
    // groups 2 warp (hh 0) and 2 warp + 1 of the tile.
    if (jt == it) {
      const float* w8t = w8 + (it - 2 * i2) * TILE;
      const float* egt = eg + (it - 2 * i2) * 8;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int gr = 2 * warp + hh;
        const int m = i0 + 8 * gr - 1;  // the last row of the group before
        float u = rv[hh] && gr > 0 ? exp_diff(drh[hh], drl[hh], dhi[m], dlo[m]) : 0.f;
#pragma unroll
        for (int j = 7; j >= 0; --j) {
#pragma unroll
          for (int bb = 0; bb < 2; ++bb) {
            float& v = s[4 * j + 2 * hh + bb];
            const int col = i0 + 8 * j + c0 + bb;
            if (j > gr)
              v = 0.f;
            else if (j == gr)
              v = rv[hh] && col <= ri[hh]
                      ? v * exp_diff(drh[hh], drl[hh], dhi[col], dlo[col]) * dts[col]
                      : 0.f;
            else
              v *= u * w8t[8 * j + c0 + bb];
          }
          if (j < gr) u *= egt[j];  // about the end of group j - 1 next
        }
      }
    } else {
      const int m = jt * TILE + TILE - 1;
      float u[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        u[hh] = rv[hh] ? exp_diff(drh[hh], drl[hh], dhi[m], dlo[m]) : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          const float w = wdt[jt * TILE + 8 * j + c0 + bb];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) s[4 * j + 2 * hh + bb] *= u[hh] * w;
        }
    }
    // G's columns [8k, 8k + 8) as the register A fragment of k8 step k
    // (columns 2t and 2t + 1 at k and k + 4), split into TF32 halves.
    uint32_t gh[8][4], gl[8][4];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float v[4] = {s[4 * k], s[4 * k + 2], s[4 * k + 1], s[4 * k + 3]};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float vh, vl;
        split_tf32(v[r], vh, vl);
        gh[k][r] = __float_as_uint(vh);
        gl[k][r] = __float_as_uint(vl);
      }
    }
    fence_operands(pv);
    wgmma_fence();  // y += G x_j, summed apart (the tensor cores' sum truncates)
#pragma unroll
    for (int k = 0; k < 8; ++k) {  // 64 chunk rows: 8 k8 steps
      const uint32_t off = (k / 4) * ATOM_BYTES + (k % 4) * 32;
      const uint64_t xh = make_desc(sx + off, 16, 1024);
      const uint64_t xl = make_desc(sx + HALF_BYTES + off, 16, 1024);
      wgmma_m64n64k8_tf32_rs(pv, gl[k], xh, k > 0);
      wgmma_m64n64k8_tf32_rs(pv, gh[k], xl);
      wgmma_m64n64k8_tf32_rs(pv, gh[k], xh);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(pv);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += pv[i];
  }

  // fp32 pairs straight from the fragment; rows past the chunk and columns
  // past P are not written.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!rv[hh]) continue;
    float* yrow = y + (((size_t)b * g.s + t0 + ri[hh]) * g.h + h) * g.p;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + c0;  // even, and P % 8 == 0: col + 1 < P too
      if (col < g.p)
        *reinterpret_cast<float2*>(yrow + col) =
            make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
  }
}

template <int NA>
cudaError_t launch_na(const CUtensorMap& map_x, const CUtensorMap& map_b,
                      const CUtensorMap& map_c, const CUtensorMap& map_sh,
                      const CUtensorMap& map_sl, const float* dt, const float* a, float* y,
                      float* s_hi, float* s_lo, int batch, const wg::Geo& g, int device,
                      cudaStream_t stream) {
  static std::atomic<unsigned long long> ready_states{0}, ready_outputs{0};
  const auto states_smem = [](int q) {
    return smem_bytes(STATE_BYTES, q, STATE_CONSUMERS, 3, 0, 2 * STAGES);
  };
  const auto outputs_smem = [](int q) {
    return smem_bytes(OUT_BYTES, q, OUT_CONSUMERS, 4, OUT_EXTRA, 1 + STAGES);
  };
  cudaError_t e = wg::opt_in(ssd_states_tf32x3<NA>, states_smem(wg::MAX_Q), device, ready_states);
  if (e == cudaSuccess)
    e = wg::opt_in(ssd_outputs_tf32x3<NA>, outputs_smem(wg::MAX_Q), device, ready_outputs);
  if (e != cudaSuccess) return e;
  if (g.nc > 1) {
    ssd_states_tf32x3<NA><<<dim3(g.h, batch), STATE_CONSUMERS + 32, states_smem(g.q), stream>>>(
        map_x, map_b, dt, a, s_hi, s_lo, g);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  ssd_outputs_tf32x3<NA><<<dim3(g.h * batch * g.nc, (g.nt + 1) / 2), OUT_CONSUMERS,
                           outputs_smem(g.q), stream>>>(map_x, map_b, map_c, map_sh, map_sl, dt,
                                                        a, y, g);
  return cudaGetLastError();
}

// x, y (B, S, H, P), b, c (B, S, N) fp32; `states` the fp32 scratch of the
// states' hi then lo halves, 2 x (B, NC - 1, H, 64, 64), when NC > 1.
cudaError_t launch(const void* x, const float* dt, const float* a, const void* b, const void* c,
                   void* y, void* states, int batch, const wg::Geo& g, int device,
                   cudaStream_t stream) {
  CUtensorMap map_x, map_b, map_c, map_sh, map_sl;
  if (!hopper::encode_4d_f32(&map_x, x, batch, g.s, g.h, g.p, 1, TILE) ||
      !hopper::encode_2d_f32(&map_b, b, batch * g.s, g.n, TILE) ||
      !hopper::encode_2d_f32(&map_c, c, batch * g.s, g.n, TILE))
    return cudaErrorInvalidValue;
  float* s_hi = static_cast<float*>(states);
  float* s_lo = nullptr;
  if (g.nc > 1) {
    const int rows = batch * (g.nc - 1) * g.h * TILE;
    s_lo = s_hi + (size_t)rows * TILE;
    if (!hopper::encode_2d_f32(&map_sh, s_hi, rows, TILE, TILE) ||
        !hopper::encode_2d_f32(&map_sl, s_lo, rows, TILE, TILE))
      return cudaErrorInvalidValue;
  } else {
    map_sh = map_sl = map_c;  // not read: chunk 0 starts from the zero state
  }
  float* yf = static_cast<float*>(y);
  return g.n <= ATOM_F32
             ? launch_na<1>(map_x, map_b, map_c, map_sh, map_sl, dt, a, yf, s_hi, s_lo, batch, g,
                            device, stream)
             : launch_na<2>(map_x, map_b, map_c, map_sh, map_sl, dt, a, yf, s_hi, s_lo, batch, g,
                            device, stream);
}

}  // namespace tf

cudaError_t on_device(int device) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  return e;
}

}  // namespace

extern "C" {

// x, y (B, S, H, P); dt (B, S, H) fp32; a (H,) fp32; b, c (B, S, N); all
// contiguous, x, b, c and y of one type (dtype 0 = float32, 1 = bfloat16).
// q is the chunk length and divides S. route: 0 = simt, 1 = wgmma (bf16, P
// and N multiples of 8 in [8, 64], q <= 2048, x, b, c, y 16-byte aligned;
// `states` a bf16 scratch of B (S / q - 1) H 64 64 values, 16-byte aligned,
// when S / q > 1), 2 = tf32x3 (fp32 under the same rules; `states` an fp32
// scratch of twice as many values, the hi halves then the lo). Returns a
// cudaError_t (0 on success).
int repro_ssd(const void* x, const void* dt, const void* a, const void* b, const void* c,
              void* y, void* states, int batch, int s, int h, int p, int n, int q, int dtype,
              int route, int device, void* stream) {
  cudaError_t e = on_device(device);
  if (e != cudaSuccess) return (int)e;
  if (q < 1 || s % q != 0) return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    const simt::Shape sh{s, h, p, n, q};
    switch (dtype) {
      case 0: return (int)simt::dispatch<float>(x, dtf, af, b, c, y, batch, sh, st);
      case 1: return (int)simt::dispatch<__nv_bfloat16>(x, dtf, af, b, c, y, batch, sh, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const int nc = s / q, nt = (q + wg::TILE - 1) / wg::TILE;
  const long long rows = (long long)batch * s;
  const long long state_rows = (long long)batch * (nc - 1) * h * wg::TILE;
  const bool tf32 = route == 2;
  if ((route != 1 && !tf32) || dtype != (tf32 ? 0 : 1) || p % 8 || n % 8 || p < 8 || n < 8 ||
      p > 64 || n > 64 ||
      q > wg::MAX_Q || ((uintptr_t)x | (uintptr_t)b | (uintptr_t)c | (uintptr_t)y) % 16 ||
      (nc > 1 && (states == nullptr || (uintptr_t)states % 16)) ||
      batch > 65535 || nt > 65535 || (long long)batch * nc * h > 0x7fffffffLL ||
      rows > 0x7fffffffLL ||
      state_rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const wg::Geo g{s, h, p, n, q, nc, nt};
  if (tf32) return (int)tf::launch(x, dtf, af, b, c, y, states, batch, g, device, st);
  return (int)wg::launch(x, dtf, af, b, c, y, states, batch, g, device, st);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
