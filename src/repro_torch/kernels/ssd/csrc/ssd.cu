// Mamba2 SSD chunked scan for Hopper.
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
// with the (P, N) state starting at 0. Every product, sum and decay is
// fp32, C B^T included (as in the Pallas kernel and in the compiled
// ssd_chunked, where XLA keeps that product in fp32); y is cast to x's
// type (fp32 or bf16).
//
// What bounds it on the H100. Zamba2-2.7B's prefill at batch 4 x 512: x
// (4, 512, 80, 64) bf16, b and c (4, 512, 64), chunk 256. Per (batch, head,
// chunk) the work on the causal triangle is Q(Q + 1)(N + P) + 4QPN = 12.6
// MFLOP, 8.07 GFLOP per call, on 43 MB in bf16 (x and y dominate): 187
// operations per byte, below the bf16 ridge (295), so in bf16 the bytes
// bound it (12.9 us) and in fp32 the CUDA-core rate does (121 us at 67
// TFLOP/s). This kernel runs on the CUDA cores in fp32, so its ceiling is
// the fp32 rate in both types.
//
// What the design does about it.
//  * One block of 256 threads per (batch, head) walks that head's chunks in
//    order; the (P, N) fp32 state (16 KB at 64 x 64) stays in shared memory
//    from chunk to chunk and never goes to device memory, as the Pallas
//    kernel keeps it in VMEM. At batch 4 that is 320 blocks, two per SM.
//  * B and C are read in their (B, S, N) layout for every head, by index:
//    no head replication (the Pallas wrapper's repeat is 84 MB of extra
//    traffic per layer at full width) and no transposes of x or y. The 80
//    heads of one batch row read the same B and C rows, which L2 serves.
//  * A whole chunk does not fit: at Q = 256 the (Q, Q) matrix (C B^T) o L
//    alone is 256 KB in fp32. The chunk is cut into row tiles of 64; for
//    each output tile only the column tiles at or below the diagonal are
//    computed (L is 0 above it), one 64 x 64 tile of (C B^T) o L at a
//    time in shared memory, then multiplied into the tile's fp32 output
//    registers. The state update then walks the chunk's tiles once more.
//  * L is masked before the exponent: above the diagonal dacum_i - dacum_j
//    is positive and could overflow, and inf * 0 would be NaN.
//  * Ragged chunks: any q up to the shared-memory limit works, whole
//    multiples of 64 or not; rows past q are loaded as 0 and not written.
//  * Each thread owns 4 rows x P/16 columns of the output tile and 4 x 4
//    entries of the (C B^T) o L tile in registers; shared-memory strides
//    are padded (N + 1, 65) so the inner loops are free of bank conflicts.
//    Tensor cores (wgmma on bf16) and TMA are later work.
//
// The kernel allocates nothing, launches on the stream it is given and
// returns cudaGetLastError(); the Python wrapper raises when that is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

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

}  // namespace

extern "C" {

// x, y (B, S, H, P); dt (B, S, H) fp32; a (H,) fp32; b, c (B, S, N); all
// contiguous, x, b, c and y of one type (0 = float32, 1 = bfloat16). q is
// the chunk length and divides S. Returns a cudaError_t (0 on success).
int repro_ssd(const void* x, const void* dt, const void* a, const void* b, const void* c,
              void* y, int batch, int s, int h, int p, int n, int q, int dtype, int device,
              void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (q < 1 || s % q != 0) return (int)cudaErrorInvalidValue;
  const Shape sh{s, h, p, n, q};
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch<float>(x, dtf, af, b, c, y, batch, sh, st);
    case 1: return (int)dispatch<__nv_bfloat16>(x, dtf, af, b, c, y, batch, sh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
