// Flash attention (online softmax, GQA, causal, sliding window) for Hopper (sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd
// (wrappers repro/kernels/flash_attention/ops.py::flash_attention and
// attn_fn). For q (B, S, H, hd) and k, v (B, Sk, KV, hd), in the model's own
// layout, it computes
//   out[b, s, h, :] = softmax_t(q[b, s, h, :] . k[b, t, g, :] / sqrt(hd)) v[b, t, g, :]
// with g = h / (H / KV), over the keys t that the mask allows: causal with
// the queries aligned to the end of the key timeline (query s sits at
// position s + Sk - S, as repro/kernels/flash_attention/ref.py and
// layers.gqa_attention align it), and with a window, t > pos - window. The
// running max, sum and output are fp32; the output is cast to the input
// type (fp32 or bf16). Masked probabilities are exactly 0 and the sum is
// clamped at 1e-30, so a row with no key gives 0, not NaN.
//
// What bounds it on the H100. StarCoder2-3B's prefill at batch 4 x 512
// tokens: q (4, 512, 24, 128), k and v (4, 512, 2, 128), causal. The
// causal half of 4*B*H*S*Sk*hd is 6.4 GFLOP, 6.5 us on the bf16 tensor
// cores; reading q, k, v and writing the output is 27 MB, 8.1 us at
// 3.35 TB/s: bytes bound it, narrowly. Zamba2-2.7B's (32 heads of 80, no
// GQA) is the same picture at 5.4 GFLOP and 42 MB.
//
// What the design does about it: two routes, chosen by the Python plan
// (flash_attention.py) and checked here.
//
//  * wgmma (bf16, hd % 8 == 0 and hd <= 128, q, k, v at 16-byte-aligned
//    addresses: what TMA takes). One block per (b, h, 128 query rows), the
//    heaviest causal query blocks launched first so that the triangle
//    leaves no tail. q, k and v are 4-D tensor maps over (hd, heads, S, B)
//    in boxes of 64 hd (one 128-byte swizzle row) x 1 head x rows x 1:
//    hd > 64 takes two boxes, and TMA zero-fills the columns past hd (hd =
//    80: the JAX wrapper's padding of hd to 128, with no padded copy) and
//    the key rows past Sk. One producer warp loads the Q tile once and
//    keeps a 2-stage ring of K and V tiles of 64 keys full (full and empty
//    mbarriers). Two consumer warpgroups own 64 query rows each:
//     - S = Q K^T on wgmma m64n64k16, A = Q and B = K as stored (keys x hd,
//       hd contiguous: K-major, transpose bit clear), ceil(hd / 16) k
//       steps (the all-zero steps past hd are skipped);
//     - the online softmax on the accumulator fragment in registers: row
//       max and sum across the 4 lanes that share a row by shuffles, exp2
//       with the scale folded into log2(e), the mask computed only on
//       tiles that cut the diagonal, the window's edge or Sk; tiles fully
//       masked for the warpgroup's rows are not computed, and tiles fully
//       masked for the block are never loaded;
//     - O += P V on wgmma m64nNk16 with A from registers: the accumulator
//       fragment of S columns [16j, 16j + 16), rounded to bf16 pairs, is
//       the A fragment of k step j, so P never touches shared memory (P in
//       bf16 is the one numerical change from the Pallas kernel, which
//       keeps P in fp32); B = V as stored (keys x hd, hd contiguous:
//       MN-major, transpose bit set), N = 64 or 128 (hd padded to whole
//       atoms);
//     - the epilogue scales by 1 / max(l, 1e-30) and writes bf16 pairs
//       straight from the fragment into (B, S, H, hd), rows past S and
//       columns past hd masked.
//    Not done here: ping-pong between the warpgroups, the softmax
//    overlapped with the next Q K^T, persistent blocks, N = 80 for PV.
//  * tf32x3 (fp32, hd % 8 == 0 and hd <= 128, q, k, v at 16-byte-aligned
//    addresses). In fp32 the same prefills are bound by operations: 6.4
//    and 5.4 GFLOP of fp32-accurate work are 96 and 81 us at the 67
//    TFLOP/s of FMA, and one TF32 product misses the fp32 tolerance (about
//    4e-4 normalised). Split into TF32 halves, x = x_hi + x_lo, the three
//    products a_lo b_hi + a_hi b_lo + a_hi b_hi carry an fp32 product's
//    error at 495 / 3 = 165 TFLOP/s (as the matmul's tf32x3 route does):
//    39 and 33 us. Design:
//     - a split pass (hopper::split_kernel, one launch) writes K_hi, K_lo
//       as (B, Sk, KV, hd) and V^T_hi, V^T_lo as (B, KV, hd, Skp), keys
//       zero-padded to whole tiles, into scratch the wrapper allocates:
//       .tf32 wgmma takes no transpose, so PV's B operand (keys along K)
//       is V^T. Q is loaded raw and split in shared memory by the
//       warpgroup (in place for Q_hi, beside it for Q_lo);
//     - one block per (b, h, 64 query rows), the blocks of one KV head
//       together (its split K and V^T read once into L2), heaviest query
//       blocks first, one consumer warpgroup and one producer warp: split
//       fp32 tiles are four times bf16's, so at hd 128 Q_hi + Q_lo (64
//       KB), one 64-key K_hi + K_lo tile (64 KB), one V^T_hi + V^T_lo tile
//       (64 KB) and P_hi + P_lo (32 KB) fill 224 of the 227 KB: no second
//       warpgroup, no second stage. Instead K and V^T have a buffer and a full/empty barrier
//       pair each, so K of tile j + 1 loads during tile j's softmax and
//       PV, V^T of tile j + 1 during tile j + 1's Q K^T;
//     - S = Q K^T: three m64n64k8 tf32 wgmmas a k8 of hd (hd in whole
//       32-wide atoms, TMA zero-filling past hd) into a fresh accumulator:
//       at hd <= 128 one promotion window (hopper::TF32X3_PROMOTE);
//     - the online softmax of the wgmma route on the fragment; P =
//       exp2(s - m) split into TF32 halves and written to shared memory
//       in the 128-byte-swizzled K-major layout TMA gives the A tiles;
//     - PV: three m64nNk8 wgmmas a k8 of keys (N = hd padded to 64 or
//       128; V^T's rows past hd zero-filled) into a fresh accumulator per
//       tile, then added to the rescaled fp32 O in registers: the tensor
//       cores' sum truncates, so each tile's sum is promoted;
//     - the epilogue of the wgmma route, in fp32 pairs.
//  * simt (fp32 and bf16 shapes TMA cannot take): the CUDA-core kernel of
//    the port's first version. One block of 256 threads per (b, h, 64
//    queries); Q, K and V tiles of 64 rows staged in shared memory as fp32,
//    read from the KV head by index, bounds-checked, any hd up to 256;
//    each thread owns 4 rows x 4 keys of the score tile and 4 rows x hd/16
//    output columns in registers, P goes through shared memory. Its ceiling
//    is the 67 TFLOP/s fp32 rate.
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

// ---------------------------------------------------------------------------
// simt route: CUDA cores, fp32 arithmetic
// ---------------------------------------------------------------------------

namespace simt {

struct Shape {
  int s, sk, h, kv, hd, window;  // window <= 0: none
  int causal;
  float scale;
};

constexpr int BQ = 64;        // queries per block
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int RPT = BQ / 16;  // query rows per thread
constexpr int KPT = BKV / 16; // keys per thread in the score tile
constexpr float NEG_INF = -1e30f;
constexpr int SMEM_DEFAULT = 48 * 1024;

// Reduce across the 16 threads of one query row (lanes tx = 0..15 of a half warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

size_t smem_floats(int hd) {
  const int hv = (hd + 15) / 16 * 16;
  return (size_t)BQ * (hd + 1) + (size_t)BKV * (hd + 1) + (size_t)BKV * hv +
         (size_t)BQ * (BKV + 1);
}

template <typename T, int HD_MAX>
__global__ void __launch_bounds__(THREADS)
flash_attention(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, Shape p) {
  constexpr int NJ_MAX = HD_MAX / 16;  // output columns per thread, at most
  extern __shared__ float smem[];
  const int hd = p.hd;
  const int hq = hd + 1;                 // padded stride of the Q and K tiles
  const int hv = (hd + 15) / 16 * 16;    // stride of the V tile: whole 16-column groups
  const int nj = hv / 16;
  float* qs = smem;                      // [BQ][hd + 1]
  float* ks = qs + BQ * hq;              // [BKV][hd + 1]
  float* vs = ks + BKV * hq;             // [BKV][hv], zero past hd
  float* ps = vs + BKV * hv;             // [BQ][BKV + 1]

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int h = bh % p.h;
  const int g = h / (p.h / p.kv);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int shift = p.sk - p.s;          // position of query 0 in the key timeline
  const size_t q_row = (size_t)p.h * hd;   // stride of s in q and o
  const size_t kv_row = (size_t)p.kv * hd; // stride of t in k and v
  const T* qb = q + (size_t)b * p.s * q_row + (size_t)h * hd;
  const T* kb = k + (size_t)b * p.sk * kv_row + (size_t)g * hd;
  const T* vb = v + (size_t)b * p.sk * kv_row + (size_t)g * hd;

  for (int i = tid; i < BQ * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd;
    qs[r * hq + d] = q0 + r < p.s ? to_f32(qb[(size_t)(q0 + r) * q_row + d]) : 0.f;
  }

  // The keys this block's queries can see: [t_lo, t_hi).
  const int pos_lo = q0 + shift;
  const int pos_hi = min(q0 + BQ, p.s) - 1 + shift;
  int t_hi = p.sk;
  if (p.causal) t_hi = min(t_hi, pos_hi + 1);
  int t_lo = 0;
  if (p.window > 0) t_lo = max(0, pos_lo - p.window + 1) / BKV * BKV;

  float m[RPT], l[RPT], acc[RPT][NJ_MAX];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ_MAX; ++j) acc[i][j] = 0.f;
  }

  for (int t0 = t_lo; t0 < t_hi; t0 += BKV) {
    __syncthreads();  // the previous tile's reads are done (and Q is stored)
    for (int i = tid; i < BKV * hd; i += THREADS) {
      const int r = i / hd, d = i - r * hd;
      const bool ok = t0 + r < p.sk;
      const size_t off = (size_t)(t0 + r) * kv_row + d;
      ks[r * hq + d] = ok ? to_f32(kb[off]) : 0.f;
      vs[r * hv + d] = ok ? to_f32(vb[off]) : 0.f;
    }
    for (int i = tid; i < BKV * (hv - hd); i += THREADS) {
      const int r = i / (hv - hd);
      vs[r * hv + hd + (i - r * (hv - hd))] = 0.f;
    }
    __syncthreads();

    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[RPT], kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty + 16 * i) * hq + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) kv[j] = ks[(tx + 16 * j) * hq + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int pos = q0 + ty + 16 * i + shift;
      bool ok[KPT];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int t = t0 + tx + 16 * j;
        ok[j] = t < p.sk && (!p.causal || t <= pos) && (p.window <= 0 || t > pos - p.window);
        s[i][j] = ok[j] ? s[i][j] * p.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float pj = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * (BKV + 1) + tx + 16 * j] = pj;
        rs += pj;
      }
      l[i] = alpha * l[i] + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ_MAX; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int t = 0; t < BKV; ++t) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(ty + 16 * i) * (BKV + 1) + t];
#pragma unroll
      for (int j = 0; j < NJ_MAX; ++j) {
        if (j < nj) {
          const float vv = vs[t * hv + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.s) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + (size_t)b * p.s * q_row + (size_t)r * q_row + (size_t)h * hd;
#pragma unroll
    for (int j = 0; j < NJ_MAX; ++j) {
      const int d = tx + 16 * j;
      if (j < nj && d < hd) orow[d] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int HD_MAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, Shape p,
                   cudaStream_t stream) {
  const int smem = (int)(smem_floats(p.hd) * sizeof(float));
  if (smem > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention<T, HD_MAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.s + BQ - 1) / BQ, batch * p.h);
  flash_attention<T, HD_MAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int batch, Shape p,
                     cudaStream_t stream) {
  if (p.hd <= 64) return launch<T, 64>(q, k, v, o, batch, p, stream);
  if (p.hd <= 128) return launch<T, 128>(q, k, v, o, batch, p, stream);
  if (p.hd <= 256) return launch<T, 256>(q, k, v, o, batch, p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace simt

// ---------------------------------------------------------------------------
// wgmma route: TMA + mbarrier ring + tensor cores, bf16
// ---------------------------------------------------------------------------

namespace wg {

using hopper::ATOM;                   // bf16 values in one 128-byte swizzle row
constexpr int BQ = 128;               // query rows per block
constexpr int CONSUMERS = 2;          // warpgroups of 64 rows
constexpr int THREADS = 128 * CONSUMERS + 32;  // and one producer warp
constexpr uint32_t ROW_BYTES = 128;   // one swizzle row: 64 values of hd
// Descriptor stride from one group of 8 rows (8 x 128 bytes) to the next.
constexpr uint32_t GROUP_BYTES = 1024;
constexpr float LOG2E = 1.4426950408889634f;

// 64-key tiles in a 2-stage ring: the warpgroups skip more of the causal
// diagonal than with 128-key tiles, and a third stage gained nothing
// (PERF.md, the sweep of this kernel's bring-up).
constexpr int BK = 64;      // keys per K/V tile: the S wgmma's N
constexpr int STAGES = 2;   // K/V tiles in flight

template <int N_>
struct Cfg {
  static constexpr int N = N_;            // hd padded to whole atoms: 64 or 128
  static constexpr int ATOMS = N / ATOM;  // boxes per row of q, k or v
  static constexpr int Q_ATOM_BYTES = BQ * ROW_BYTES;
  static constexpr int KV_ATOM_BYTES = BK * ROW_BYTES;
  static constexpr int KV_BYTES = ATOMS * KV_ATOM_BYTES;  // the K (or V) tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // Q, the stages, 1024-byte aligned inside the block's window, then the
  // barriers (Q's, the full ones, the empty ones)
  static constexpr int SMEM = 1024 + ATOMS * Q_ATOM_BYTES + STAGES * STAGE_BYTES +
                              (1 + 2 * STAGES) * 8;
  static_assert(N == 64 || N == 128, "one or two atoms of hd");
  static_assert(SMEM <= 232448, "fits the block's shared memory");
};

struct Geo {
  int s, sk, h, kv, hd, window, causal;  // window <= 0: none
  float scale_log2;                      // 1 / sqrt(hd) * log2(e)
};

// S (64 x BK) = Q (64 rows at qa) @ K^T (BK rows at kb), both K-major in
// shared memory, over KSTEPS steps of 16 of hd (32 bytes along the rows;
// step kk in atom kk / 4), then committed. KSTEPS is a constant so that
// nothing but the products runs between the fence and the commit: a branch
// there serializes the products (ptxas C7515).
template <typename CF, int KSTEPS>
__device__ __forceinline__ void qk_tile(float (&s)[BK / 2], uint32_t qa, uint32_t kb) {
  using namespace hopper;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t da = make_desc(qa + (kk / 4) * CF::Q_ATOM_BYTES + off, 16, GROUP_BYTES);
    const uint64_t db = make_desc(kb + (kk / 4) * CF::KV_ATOM_BYTES + off, 16, GROUP_BYTES);
    wgmma_m64n64k16<0>(s, da, db, kk > 0);
  }
  wgmma_commit();
}

// qk_tile over the ceil(hd / 16) steps that are not all zero.
template <typename CF>
__device__ __forceinline__ void qk(int ksteps, float (&s)[BK / 2], uint32_t qa, uint32_t kb) {
  if constexpr (CF::N == 64) {
    switch (ksteps) {
      case 1: qk_tile<CF, 1>(s, qa, kb); break;
      case 2: qk_tile<CF, 2>(s, qa, kb); break;
      case 3: qk_tile<CF, 3>(s, qa, kb); break;
      default: qk_tile<CF, 4>(s, qa, kb); break;
    }
  } else {
    switch (ksteps) {
      case 1: qk_tile<CF, 1>(s, qa, kb); break;
      case 2: qk_tile<CF, 2>(s, qa, kb); break;
      case 3: qk_tile<CF, 3>(s, qa, kb); break;
      case 4: qk_tile<CF, 4>(s, qa, kb); break;
      case 5: qk_tile<CF, 5>(s, qa, kb); break;
      case 6: qk_tile<CF, 6>(s, qa, kb); break;
      case 7: qk_tile<CF, 7>(s, qa, kb); break;
      default: qk_tile<CF, 8>(s, qa, kb); break;
    }
  }
}

// O (64 x N) += P (registers) @ V (MN-major in shared memory).
template <int N>
__device__ __forceinline__ void pv_step(float (&o)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 128)
    hopper::wgmma_m64n128k16_rs(o, a, db);
  else
    hopper::wgmma_m64n64k16_rs(o, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename CF>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
            const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
            const Geo g) {
  using namespace hopper;
  constexpr int N = CF::N, ATOMS = CF::ATOMS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t kv0 = sq + ATOMS * CF::Q_ATOM_BYTES;
  const uint32_t q_bar = kv0 + STAGES * CF::STAGE_BYTES;
  const uint32_t full0 = q_bar + 8, empty0 = full0 + STAGES * 8;

  // Blocks walk the heads fastest (the query heads of one KV head share its
  // tiles in L2), then the query blocks, heaviest first.
  const int b = blockIdx.x / g.h, h = blockIdx.x - b * g.h;
  const int grp = h / (g.h / g.kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int shift = g.sk - g.s;  // position of query 0 in the key timeline
  // The keys the block's queries can see, [t_lo, t_hi), in tiles from t_lo.
  const int pos_lo = q0 + shift, pos_hi = min(q0 + BQ, g.s) - 1 + shift;
  const int t_hi = g.causal ? min(g.sk, pos_hi + 1) : g.sk;
  const int t_lo = g.window > 0 ? max(0, pos_lo - g.window + 1) / BK * BK : 0;
  const int n_tiles = t_hi > t_lo ? (t_hi - t_lo + BK - 1) / BK : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);                 // the producer's expect_tx
      mbar_init(empty0 + 8 * st, CONSUMERS * 128);  // every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS * 128) {  // the producer warp; one thread issues
    if (tid == CONSUMERS * 128) {
      // Boxes count whole on the barriers, their zero fill included.
      mbar_arrive_expect_tx(q_bar, ATOMS * CF::Q_ATOM_BYTES);
      for (int a = 0; a < ATOMS; ++a)
        tma_load_4d(sq + a * CF::Q_ATOM_BYTES, &map_q, q_bar, a * ATOM, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        mbar_wait(empty0 + 8 * st, ((it / STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * st, sk = kv0 + st * CF::STAGE_BYTES;
        const int t0 = t_lo + it * BK;
        mbar_arrive_expect_tx(full, CF::STAGE_BYTES);
        for (int a = 0; a < ATOMS; ++a) {
          tma_load_4d(sk + a * CF::KV_ATOM_BYTES, &map_k, full, a * ATOM, grp, t0, b);
          tma_load_4d(sk + CF::KV_BYTES + a * CF::KV_ATOM_BYTES, &map_v, full, a * ATOM, grp,
                      t0, b);
        }
      }
    }
    return;
  }

  // Fragment of m64nX: warp w of the warpgroup holds rows 16w + lane/4
  // (+ 8), columns 8j + 2 (lane % 4) (+ 1) in d[4j + {0, 1}] (+ {2, 3}).
  const int wgi = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r_wg = q0 + wgi * 64;                    // the warpgroup's first row
  const int w_lo = r_wg + shift, w_hi = w_lo + 63;   // and its positions
  const int row0 = r_wg + warp * 16 + lane / 4;      // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane % 4);
  const int ksteps = (g.hd + 15) / 16;               // Q K^T steps that are not all zero
  const uint32_t qa = sq + wgi * 64 * ROW_BYTES;

  float acc[N / 2], s[BK / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's partial sums
  fence_operands(acc);
  mbar_wait(q_bar, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    const int t0 = t_lo + it * BK;
    mbar_wait(full0 + 8 * st, (it / STAGES) & 1);
    const bool skip = r_wg >= g.s || t0 >= g.sk || (g.causal && t0 > w_hi) ||
                      (g.window > 0 && t0 + BK - 1 <= w_lo - g.window);
    if (!skip) {
      const uint32_t kb = kv0 + st * CF::STAGE_BYTES, vb = kb + CF::KV_BYTES;
      qk<CF>(ksteps, s, qa, kb);
      wgmma_wait<0>();
      fence_operands(s);

      // Scores in log2 units; masked ones -inf, on the tiles that need a mask.
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] *= g.scale_log2;
      const bool edge = t0 + BK > g.sk || (g.causal && t0 + BK - 1 > w_lo) ||
                        (g.window > 0 && t0 <= w_hi - g.window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int pos = row0 + 8 * hh + shift;
#pragma unroll
            for (int bb = 0; bb < 2; ++bb) {
              const int t = t0 + 8 * j + col0 + bb;
              const bool ok = t < g.sk && (!g.causal || t <= pos) &&
                              (g.window <= 0 || t > pos - g.window);
              if (!ok) s[4 * j + 2 * hh + bb] = -INFINITY;
            }
          }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          mx[hh] = fmaxf(mx[hh], fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
      float alpha[2], mu[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // the 4 lanes of a row
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        mu[hh] = mx[hh] == -INFINITY ? 0.f : mx[hh];  // a row with no key yet: p = 0
        alpha[hh] = exp2f(m[hh] - mu[hh]);
        m[hh] = mx[hh];
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int bb = 0; bb < 2; ++bb) {
            float& x = s[4 * j + 2 * hh + bb];
            x = exp2f(x - mu[hh]);
            rs[hh] += x;
          }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + rs[hh];
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
      // P in bf16, as the A fragments of the PV steps (16 keys each).
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // 16 keys a step: 16 rows of V
        pv_step<N>(acc, pa[kk],
                   make_desc(vb + kk * 16 * ROW_BYTES, CF::KV_ATOM_BYTES, GROUP_BYTES));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
    }
    mbar_arrive(empty0 + 8 * st);  // this thread is done with the stage
  }

  // Epilogue: the row sums across the 4 lanes, 1 / max(l, 1e-30), bf16
  // pairs straight from the fragment; rows past S and columns past hd masked.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = l[hh];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int row = row0 + 8 * hh;
    if (row >= g.s) continue;
    __nv_bfloat16* orow = o + (((size_t)b * g.s + row) * g.h + h) * g.hd;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + col0;  // even, and hd % 8 == 0: col + 1 < hd too
      if (col < g.hd)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh] * inv, acc[4 * j + 2 * hh + 1] * inv);
    }
  }
}

template <typename CF>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, const Geo& g,
                   int device, cudaStream_t stream) {
  const long long q_blocks = (g.s + BQ - 1) / BQ;
  if (q_blocks > 65535 || (long long)batch * g.h > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v;
  if (!hopper::encode_4d(&map_q, q, batch, g.s, g.h, g.hd, 1, BQ) ||
      !hopper::encode_4d(&map_k, k, batch, g.sk, g.kv, g.hd, 1, BK) ||
      !hopper::encode_4d(&map_v, v, batch, g.sk, g.kv, g.hd, 1, BK))
    return cudaErrorInvalidValue;
  // Above 48 KB of dynamic shared memory a kernel must opt in, once per device.
  static std::atomic<unsigned long long> ready{0};
  const unsigned long long bit = 1ull << (device & 63);
  if (!(ready.load(std::memory_order_relaxed) & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma<CF>, cudaFuncAttributeMaxDynamicSharedMemorySize, CF::SMEM);
    if (e != cudaSuccess) return e;
    ready.fetch_or(bit);
  }
  flash_wgmma<CF><<<dim3(batch * g.h, (unsigned)q_blocks), THREADS, CF::SMEM, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), g);
  return cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// tf32x3 route: fp32 split into TF32 halves, three tensor-core products
// ---------------------------------------------------------------------------

namespace tf {

using hopper::ATOM_F32;             // fp32 values in one 128-byte swizzle row
constexpr int BQ = 64;              // query rows per block: one consumer warpgroup
constexpr int BK = 64;              // keys per K and V^T tile: the S wgmma's N, PV's depth
constexpr int KEY_ATOMS = BK / ATOM_F32;
constexpr int THREADS = 128 + 32;   // the warpgroup and one producer warp
constexpr uint32_t ROW_BYTES = 128;  // one swizzle row: 32 fp32

// ATOMS: 32-wide atoms of hd (hd padded to whole atoms, TMA zero-filling
// the rest); NV: PV's N, hd padded to 64 or 128 (V^T's rows past hd are
// zero-filled). Each tile is written split: a hi and a lo copy.
template <int ATOMS_, int NV_>
struct Cfg {
  static constexpr int ATOMS = ATOMS_, NV = NV_;
  static constexpr int Q_ATOM = BQ * ROW_BYTES;            // 64 rows x 32 hd: 8 KB
  static constexpr int K_ATOM = BK * ROW_BYTES;            // 64 keys x 32 hd: 8 KB
  static constexpr int V_ATOM = NV * ROW_BYTES;            // NV rows of hd x 32 keys
  static constexpr int P_ATOM = BQ * ROW_BYTES;            // 64 rows x 32 keys
  static constexpr int Q_BYTES = ATOMS * Q_ATOM, K_BYTES = ATOMS * K_ATOM;
  static constexpr int V_BYTES = KEY_ATOMS * V_ATOM, P_BYTES = KEY_ATOMS * P_ATOM;
  // Q_hi, Q_lo, K_hi, K_lo, V^T_hi, V^T_lo, P_hi, P_lo, 1024-byte aligned
  // inside the block's window, then the barriers (Q's, K's full and empty,
  // V's full and empty)
  static constexpr int SMEM = 1024 + 2 * (Q_BYTES + K_BYTES + V_BYTES + P_BYTES) + 5 * 8;
  static_assert(NV == 64 || NV == 128, "m64n64k8 or m64n128k8");
  static_assert(ATOMS * ATOM_F32 <= NV, "hd fits PV's N");
  static_assert(SMEM <= 232448, "fits the block's shared memory");
};

// The split operands: K_hi, K_lo (B, Sk, KV, hd) and V^T_hi, V^T_lo (B, KV,
// hd, Skp), Skp = Sk padded to whole key tiles (zero past Sk).
struct Split {
  float *k_hi, *k_lo, *v_hi, *v_lo;
};

template <typename CF>
__global__ void __launch_bounds__(THREADS, 1)
flash_tf32x3(const __grid_constant__ CUtensorMap map_q,
             const __grid_constant__ CUtensorMap map_khi,
             const __grid_constant__ CUtensorMap map_klo,
             const __grid_constant__ CUtensorMap map_vhi,
             const __grid_constant__ CUtensorMap map_vlo, float* __restrict__ o, const wg::Geo g) {
  using namespace hopper;
  constexpr int ATOMS = CF::ATOMS, NV = CF::NV;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sqh = (raw + 1023) & ~1023u;
  uint8_t* const gq = smem_raw + (sqh - raw);  // the same address, generic
  const uint32_t sql = sqh + CF::Q_BYTES;
  const uint32_t skh = sql + CF::Q_BYTES, skl = skh + CF::K_BYTES;
  const uint32_t svh = skl + CF::K_BYTES, svl = svh + CF::V_BYTES;
  const uint32_t sph = svl + CF::V_BYTES, spl = sph + CF::P_BYTES;
  const uint32_t q_bar = spl + CF::P_BYTES;
  const uint32_t full_k = q_bar + 8, empty_k = q_bar + 16, full_v = q_bar + 24,
                 empty_v = q_bar + 32;

  // Every block of one KV head runs before the next head's: its query heads
  // fastest, then its query blocks, heaviest first. The split K and V^T of
  // a head (four times bf16's bytes: 655 KB at Zamba2's hd 80 and 512
  // keys) are then read from device memory once and shared in L2 by its
  // blocks, where walking the heads fastest re-read them for every query
  // block once the heads in flight outgrew the 50 MB L2 (no GQA: 84 MB).
  const int per_head = g.h / g.kv, q_blocks = (g.s + BQ - 1) / BQ;
  const int per_kv = per_head * q_blocks;
  const int kv_lin = blockIdx.x / per_kv, rest = blockIdx.x - kv_lin * per_kv;
  const int b = kv_lin / g.kv, grp = kv_lin - b * g.kv;
  const int h = grp * per_head + rest % per_head;
  const int q0 = (q_blocks - 1 - rest / per_head) * BQ;
  const int shift = g.sk - g.s;  // position of query 0 in the key timeline
  // The keys the block's queries can see, [t_lo, t_hi), in tiles from t_lo:
  // every tile holds a key some row of the block sees.
  const int w_lo = q0 + shift, w_hi = min(q0 + BQ, g.s) - 1 + shift;
  const int t_hi = g.causal ? min(g.sk, w_hi + 1) : g.sk;
  const int t_lo = g.window > 0 ? max(0, w_lo - g.window + 1) / BK * BK : 0;
  const int n_tiles = t_hi > t_lo ? (t_hi - t_lo + BK - 1) / BK : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    mbar_init(full_k, 1);      // the producer's expect_tx
    mbar_init(empty_k, 128);   // every consumer thread
    mbar_init(full_v, 1);
    mbar_init(empty_v, 128);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warp; one thread issues
    if (tid == 128) {
      // Boxes count whole on the barriers, their zero fill included.
      mbar_arrive_expect_tx(q_bar, CF::Q_BYTES);
      for (int a = 0; a < ATOMS; ++a)
        tma_load_4d(sqh + a * CF::Q_ATOM, &map_q, q_bar, a * ATOM_F32, h, q0, b);
      // One K and one V^T buffer: K of tile it + 1 loads while tile it's
      // softmax and PV run, V^T of tile it + 1 while its Q K^T runs.
      for (int it = 0; it < n_tiles; ++it) {
        const int t0 = t_lo + it * BK;
        const uint32_t parity = (it & 1) ^ 1;
        mbar_wait(empty_k, parity);
        mbar_arrive_expect_tx(full_k, 2 * CF::K_BYTES);
        for (int a = 0; a < ATOMS; ++a) {
          tma_load_4d(skh + a * CF::K_ATOM, &map_khi, full_k, a * ATOM_F32, grp, t0, b);
          tma_load_4d(skl + a * CF::K_ATOM, &map_klo, full_k, a * ATOM_F32, grp, t0, b);
        }
        mbar_wait(empty_v, parity);
        mbar_arrive_expect_tx(full_v, 2 * CF::V_BYTES);
        for (int a = 0; a < KEY_ATOMS; ++a) {
          tma_load_4d(svh + a * CF::V_ATOM, &map_vhi, full_v, t0 + a * ATOM_F32, 0, grp, b);
          tma_load_4d(svl + a * CF::V_ATOM, &map_vlo, full_v, t0 + a * ATOM_F32, 0, grp, b);
        }
      }
    }
    return;
  }

  // Q arrives raw; the warpgroup splits it in place (Q_hi) and beside it
  // (Q_lo), element by element: the swizzle moves both copies alike.
  mbar_wait(q_bar, 0);
  {
    float4* qh = reinterpret_cast<float4*>(gq);
    float4* ql = reinterpret_cast<float4*>(gq + CF::Q_BYTES);
    for (int i = tid; i < CF::Q_BYTES / 16; i += 128) {
      float4 x = qh[i], lo;
      split_tf32(x.x, x.x, lo.x);
      split_tf32(x.y, x.y, lo.y);
      split_tf32(x.z, x.z, lo.z);
      split_tf32(x.w, x.w, lo.w);
      qh[i] = x;
      ql[i] = lo;
    }
  }
  fence_proxy_async();  // the writes, before the wgmmas read them
  named_sync(1, 128);

  // Fragment of m64nX: warp w holds rows 16w + lane/4 (+ 8), columns
  // 8j + 2 (lane % 4) (+ 1) in d[4j + {0, 1}] (+ {2, 3}).
  const int warp = tid / 32, lane = tid % 32;
  const int rloc = warp * 16 + lane / 4;  // this thread's rows in the block: rloc, rloc + 8
  const int row0 = q0 + rloc;
  const int col0 = 2 * (lane % 4);
  float acc[NV / 2], pv[NV / 2], s[BK / 2];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) acc[i] = pv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's partial sums
  fence_operands(acc);

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_lo + it * BK;
    // S = Q K^T: three TF32 products a k8 over hd (at most 128: one
    // promotion window, TF32X3_PROMOTE), into a fresh accumulator.
    mbar_wait(full_k, it & 1);
    fence_operands(s);
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < ATOMS; ++a)
      tf32x3_stage<BK, ATOM_F32>(s, sqh + a * CF::Q_ATOM, sql + a * CF::Q_ATOM,
                                 skh + a * CF::K_ATOM, skl + a * CF::K_ATOM, a == 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    mbar_arrive(empty_k);

    // The online softmax, as the wgmma route's, in log2 units.
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] *= g.scale_log2;
    const bool edge = t0 + BK > g.sk || (g.causal && t0 + BK - 1 > w_lo) ||
                      (g.window > 0 && t0 <= w_hi - g.window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int pos = row0 + 8 * hh + shift;
#pragma unroll
          for (int bb = 0; bb < 2; ++bb) {
            const int t = t0 + 8 * j + col0 + bb;
            const bool ok = t < g.sk && (!g.causal || t <= pos) &&
                            (g.window <= 0 || t > pos - g.window);
            if (!ok) s[4 * j + 2 * hh + bb] = -INFINITY;
          }
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        mx[hh] = fmaxf(mx[hh], fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
    float alpha[2], mu[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {  // the 4 lanes of a row
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      mu[hh] = mx[hh] == -INFINITY ? 0.f : mx[hh];  // a row with no key yet: p = 0
      alpha[hh] = exp2f(m[hh] - mu[hh]);
      m[hh] = mx[hh];
    }
    // P = exp2(s - mu), split into TF32 halves and written as PV's A: two
    // 32-key atoms of 64 rows, 128-byte swizzled (16-byte chunk c of row r
    // at c ^ (r % 8)), as TMA would have written them.
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float p0 = exp2f(s[4 * j + 2 * hh] - mu[hh]);
        const float p1 = exp2f(s[4 * j + 2 * hh + 1] - mu[hh]);
        rs[hh] += p0 + p1;
        const int r = rloc + 8 * hh, c = 8 * (j % 4) + col0;  // c: the column in the atom
        const uint32_t off = (j / 4) * CF::P_ATOM + r * ROW_BYTES +
                             (((c / 4) ^ (r % 8)) * 16) + (c % 4) * 4;
        float2 hi, lo;
        split_tf32(p0, hi.x, lo.x);
        split_tf32(p1, hi.y, lo.y);
        *reinterpret_cast<float2*>(gq + (sph - sqh) + off) = hi;
        *reinterpret_cast<float2*>(gq + (spl - sqh) + off) = lo;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + rs[hh];
#pragma unroll
    for (int j = 0; j < NV / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    fence_proxy_async();  // P's writes, before the wgmmas read them
    named_sync(1, 128);

    // PV: the tile's sum in a fresh tensor-core accumulator (the tensor
    // cores' additions truncate), then added to the fp32 O in registers.
    mbar_wait(full_v, it & 1);
    fence_operands(pv);
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < KEY_ATOMS; ++a)
      tf32x3_stage<NV, ATOM_F32>(pv, sph + a * CF::P_ATOM, spl + a * CF::P_ATOM,
                                 svh + a * CF::V_ATOM, svl + a * CF::V_ATOM, a == 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(pv);
    mbar_arrive(empty_v);
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) acc[i] += pv[i];
  }

  // Epilogue: the row sums across the 4 lanes, 1 / max(l, 1e-30), fp32
  // pairs straight from the fragment; rows past S and columns past hd masked.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = l[hh];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int row = row0 + 8 * hh;
    if (row >= g.s) continue;
    float* orow = o + (((size_t)b * g.s + row) * g.h + h) * g.hd;
#pragma unroll
    for (int j = 0; j < NV / 8; ++j) {
      const int col = 8 * j + col0;  // even, and hd % 8 == 0: col + 1 < hd too
      if (col < g.hd)
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(acc[4 * j + 2 * hh] * inv, acc[4 * j + 2 * hh + 1] * inv);
    }
  }
}

// q (B, S, H, hd), k, v (B, Sk, KV, hd) fp32; w: the split operands
// (16-byte aligned), written here first by one split launch (K copied, V
// transposed). The split is queued before the tensor maps are encoded, so
// the card starts while the host encodes.
template <typename CF>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const Split& w,
                   int batch, const wg::Geo& g, int device, cudaStream_t stream) {
  const long long blocks = (long long)batch * g.h * ((g.s + BQ - 1) / BQ);
  const int skp = (g.sk + BK - 1) / BK * BK;
  if (blocks > 0x7fffffffLL ||
      ((uintptr_t)w.k_hi | (uintptr_t)w.k_lo | (uintptr_t)w.v_hi | (uintptr_t)w.v_lo) % 16)
    return cudaErrorInvalidValue;
  const int row = g.kv * g.hd;  // k and v seen as (B, Sk, KV * hd)
  cudaError_t e = hopper::split_launch(
      hopper::split_job(k, w.k_hi, w.k_lo, g.sk, row, row, false), batch,
      hopper::split_job(v, w.v_hi, w.v_lo, g.sk, row, skp, true), batch, stream);
  if (e != cudaSuccess) return e;
  CUtensorMap mq, mkh, mkl, mvh, mvl;
  if (!hopper::encode_4d_f32(&mq, q, batch, g.s, g.h, g.hd, 1, BQ) ||
      !hopper::encode_4d_f32(&mkh, w.k_hi, batch, g.sk, g.kv, g.hd, 1, BK) ||
      !hopper::encode_4d_f32(&mkl, w.k_lo, batch, g.sk, g.kv, g.hd, 1, BK) ||
      !hopper::encode_4d_f32(&mvh, w.v_hi, batch, g.kv, g.hd, skp, CF::NV, 1) ||
      !hopper::encode_4d_f32(&mvl, w.v_lo, batch, g.kv, g.hd, skp, CF::NV, 1))
    return cudaErrorInvalidValue;
  // Above 48 KB of dynamic shared memory a kernel must opt in, once per device.
  static std::atomic<unsigned long long> ready{0};
  const unsigned long long bit = 1ull << (device & 63);
  if (!(ready.load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(flash_tf32x3<CF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             CF::SMEM);
    if (e != cudaSuccess) return e;
    ready.fetch_or(bit);
  }
  flash_tf32x3<CF><<<(unsigned)blocks, THREADS, CF::SMEM, stream>>>(
      mq, mkh, mkl, mvh, mvl, static_cast<float*>(o), g);
  return cudaGetLastError();
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

// q, o (B, S, H, hd); k, v (B, Sk, KV, hd), contiguous; H a multiple of KV.
// window <= 0: no window. dtype: 0 = float32, 1 = bfloat16. route: 0 =
// simt, 1 = wgmma (bf16, hd % 8 == 0, hd <= 128, q, k, v 16-byte aligned);
// the tf32x3 route has its own entry point. Returns a cudaError_t (0 on
// success).
int repro_flash_attention(const void* q, const void* k, const void* v, void* o, int batch,
                          int s, int sk, int h, int kv, int hd, int causal, int window,
                          float scale, int dtype, int route, int device,
                          void* stream) {
  cudaError_t e = on_device(device);
  if (e != cudaSuccess) return (int)e;
  if (kv < 1 || h % kv != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    const simt::Shape p{s, sk, h, kv, hd, window, causal, scale};
    switch (dtype) {
      case 0: return (int)simt::dispatch<float>(q, k, v, o, batch, p, st);
      case 1: return (int)simt::dispatch<__nv_bfloat16>(q, k, v, o, batch, p, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (route != 1 || dtype != 1 || hd % 8 || hd < 8 || hd > 128 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 || (uintptr_t)o % 4)
    return (int)cudaErrorInvalidValue;
  const wg::Geo g{s, sk, h, kv, hd, window, causal, scale * wg::LOG2E};
  // hd padded to whole atoms picks the configuration
  return (int)(hd <= 64 ? wg::launch<wg::Cfg<64>>(q, k, v, o, batch, g, device, st)
                        : wg::launch<wg::Cfg<128>>(q, k, v, o, batch, g, device, st));
}

// The tf32x3 route: q, o (B, S, H, hd), k, v (B, Sk, KV, hd) fp32,
// contiguous, hd % 8 == 0, hd <= 128, q 16-byte aligned; k_hi, k_lo (B, Sk,
// KV, hd) and v_hi, v_lo (B, KV, hd, Skp), Skp = Sk rounded up to a
// multiple of 64, 16-byte aligned: scratch the call fills with the split
// K and V^T. window <= 0: no window. Returns a cudaError_t (0 on success).
int repro_flash_attention_tf32x3(const void* q, const void* k, const void* v, void* o,
                                 void* k_hi, void* k_lo, void* v_hi, void* v_lo, int batch,
                                 int s, int sk, int h, int kv, int hd, int causal, int window,
                                 float scale, int device, void* stream) {
  cudaError_t e = on_device(device);
  if (e != cudaSuccess) return (int)e;
  if (kv < 1 || h % kv != 0 || hd % 8 || hd < 8 || hd > 128 || (uintptr_t)q % 16 ||
      (uintptr_t)o % 8)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const tf::Split w{static_cast<float*>(k_hi), static_cast<float*>(k_lo),
                    static_cast<float*>(v_hi), static_cast<float*>(v_lo)};
  const wg::Geo g{s, sk, h, kv, hd, window, causal, scale * wg::LOG2E};
  // hd in whole 32-wide atoms picks the configuration
  switch ((hd + 31) / 32) {
    case 1: return (int)tf::launch<tf::Cfg<1, 64>>(q, k, v, o, w, batch, g, device, st);
    case 2: return (int)tf::launch<tf::Cfg<2, 64>>(q, k, v, o, w, batch, g, device, st);
    case 3: return (int)tf::launch<tf::Cfg<3, 128>>(q, k, v, o, w, batch, g, device, st);
    default: return (int)tf::launch<tf::Cfg<4, 128>>(q, k, v, o, w, batch, g, device, st);
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
