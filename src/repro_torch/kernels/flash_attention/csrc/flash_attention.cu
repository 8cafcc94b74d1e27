// Flash attention (online softmax, GQA, causal, sliding window) for Hopper.
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
// running max, sum and output are fp32, as in the Pallas kernel (so P stays
// fp32 for the PV product); the output is cast to the input type (fp32 or
// bf16). Masked scores are -1e30 and masked probabilities exactly 0, and
// the sum is clamped at 1e-30, so a row with no key gives 0, not NaN.
//
// What bounds it on the H100. StarCoder2-3B's prefill at batch 4 x 512
// tokens: q (4, 512, 24, 128), k and v (4, 512, 2, 128), causal. The
// causal half of 4*B*H*S*Sk*hd is 6.4 GFLOP on 13 MB: ~500 operations per
// byte, so operations bound it, and in bf16 the bound is the tensor cores.
// This kernel runs on the CUDA cores in fp32 (bf16 is widened on the
// load), so its ceiling is the 67 TFLOP/s fp32 rate.
//
// What the design does about it.
//  * One block of 256 threads per (b, h, 64 queries). The Q tile stays in
//    shared memory; K and V tiles of 64 keys are staged in shared memory
//    one after another, read from the KV head g by index (no K or V
//    replication for GQA) and with bounds checks in place of padding, so
//    any head dim up to 256 and any S, Sk work.
//  * Key tiles that the causal structure or the window masks completely are
//    never loaded: the loop runs only over the tiles the block's queries
//    can see, which halves the work of causal prefill.
//  * Each thread owns 4 query rows x 4 keys of the score tile and 4 rows x
//    hd/16 columns of the output, all in fp32 registers. The row max and
//    sum are reduced across the 16 threads of a row with warp shuffles, so
//    m and l never leave registers; P goes through shared memory for the
//    PV product. Padded strides (hd + 1) keep the shared-memory reads free
//    of bank conflicts.
//  * Tensor cores (wgmma on bf16), TMA and overlapping loads with compute
//    are later work.
//
// The kernel allocates nothing, launches on the stream it is given and
// returns cudaGetLastError(); the Python wrapper raises when that is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int RPT = BQ / 16;  // query rows per thread
constexpr int KPT = BKV / 16; // keys per thread in the score tile
constexpr float NEG_INF = -1e30f;
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

struct Shape {
  int s, sk, h, kv, hd, window;  // window <= 0: none
  int causal;
  float scale;
};

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

}  // namespace

extern "C" {

// q, o (B, S, H, hd); k, v (B, Sk, KV, hd), contiguous; H a multiple of KV.
// window <= 0: no window. dtype: 0 = float32, 1 = bfloat16. Returns a
// cudaError_t (0 on success).
int repro_flash_attention(const void* q, const void* k, const void* v, void* o, int batch,
                          int s, int sk, int h, int kv, int hd, int causal, int window,
                          float scale, int dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (h % kv != 0) return (int)cudaErrorInvalidValue;
  const Shape p{s, sk, h, kv, hd, window, causal, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch<float>(q, k, v, o, batch, p, st);
    case 1: return (int)dispatch<__nv_bfloat16>(q, k, v, o, batch, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
