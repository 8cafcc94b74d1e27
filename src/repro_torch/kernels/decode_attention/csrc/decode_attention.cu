// Decode attention over a KV cache updated in place, for Hopper (sm_90a).
//
// Replaces no TPU kernel: decode attention is plain array code in both
// packages (repro/models/layers.py::gqa_decode_attention, and the port's
// counterpart, repro_torch/models/layers.py). There, one decode tick writes
// each sequence's new K/V row by a one-hot blend that rewrites every row of
// the cache, and attends with a masked softmax over every row, valid or
// not. On a serving tick of StarCoder2-3B (64 slots of 4096 positions, 30
// layers, 2 KV heads of 128) that is ~57 ms of device work and ~60 eager
// ops a layer of host enqueue, to store 64 rows a layer and read ~505 valid
// positions a slot. Two kernels a layer replace it, on the caller's
// stacked cache, which they update in place:
//
//  * rope_append: the tick's q and k rotated as layers.apply_rope rotates
//    them (angles pos * freq in fp32 from the frequency table the wrapper
//    caches, cos and sin in fp32, x1 cos - x2 sin and x2 cos + x1 sin with
//    each product rounded on its own, as the separate tensor ops round
//    them), each result rounded to the cache's type. q goes to a small
//    output; k and v to row write_pos[b] of the layer's cache. A write_pos
//    outside [0, S) writes nothing, as the blend's all-zero one-hot row
//    drops it (ROADMAP fault 6). A thread a pair of values (i, i + hd / 2)
//    of one head, so a sequence's loads are in flight together.
//  * decode_attend: flash-decoding. out[b, h] = softmax_t(q[b, h] .
//    k[b, t, j] / sqrt(hd)) v[b, t, j] with j = h / (H / KV), over the
//    positions t <= valid_upto[b] (clamped to S - 1: a full ring takes all
//    S). The grid is one block for each (chunk of positions, KV head, slot)
//    and is sized from S, never from the lengths: a block reads
//    valid_upto[b] on the device and returns at once past it, so there is
//    no host sync and the call can be captured in a CUDA graph. The g = H /
//    KV query heads of a group share every K/V tile (GQA by index), so
//    each valid K/V byte is read once, not once a head.
//
// What bounds it on the H100. Bytes. At the tick above a layer reads ~33 MB
// of valid K/V (64 slots x ~505 positions x 2 heads x 128 x 2 bytes x K and
// V): 10 us at 3.35 TB/s, 0.3 ms over the 30 layers. The products are
// ~6 GFMA a tick (QK^T and PV over those positions for 24 heads), ~0.2 ms
// at the CUDA cores' 67 TFLOP/s fp32: below the bytes on paper, but fed
// from shared memory they cost more instructions than the bytes allow (the
// first, CUDA-core version of this kernel read 82 us a layer back to back,
// 12 % of the bound), so bf16 takes the tensor cores (mma.sync; wgmma's
// 64-row tiles would be three-quarters empty at 12 heads a group).
//
// What the design does about it:
//  * Both routes stream K and V tiles into shared memory by cp.async, 16
//    bytes a thread, in a 2-stage ring: tile i + 1 loads while tile i is
//    used. Rows past the block's last valid position are zero-filled, never
//    read from the cache. Rows are padded by 16 bytes (no bank conflicts).
//  * mma (bf16, hd % 16 == 0, hd <= 128; the serving cell): tiles of 64
//    positions, 16 for each of the 4 warps. The group's query heads are the
//    16 rows of m16n8k16 (rows past g zero), held in registers as A
//    fragments for the whole block. Each warp keeps its own running max,
//    sum and output fragment (fp32) over its positions: S = Q K^T (K as
//    stored is the B operand, ldmatrix), the online softmax on the
//    accumulator fragment (exp2, the scale folded into log2(e)), then P,
//    rounded to bf16 pairs in registers (the plain path rounds P to bf16
//    likewise), as the A operand of O += P V (V through ldmatrix.trans).
//    The warps' (m, l, O) merge in shared memory at the end, in a fixed
//    order.
//  * simt (fp32, and bf16 heads the mma route does not take): tiles of 64
//    (bf16) or 32 (fp32) positions. Thread (t, part) scores position t for
//    the heads part, part + 128 / TILE, ... from its K row and q (fp32,
//    staged once a block) as broadcasts; a warp a head runs the online
//    softmax; thread (4-column group, head set) keeps 4 output columns of
//    up to 8 heads in fp32 registers and reads each V row once for all of
//    them. P stays fp32 for PV.
//  * Partials: where S spans several chunks, each block writes its (m, l,
//    acc) in fp32; decode_combine (one block a (head, slot), in the same
//    call) merges the chunks that hold a valid position in a fixed order
//    (deterministic: no atomics) and rounds the output to the cache's type.
//    Where one chunk covers S the block writes the output itself.
//  * A slot with no valid position (valid_upto < 0) reads NaN, as the
//    masked softmax over no position does.
//
// The kernels allocate nothing, launch on the stream they are given, and
// each entry point returns cudaGetLastError() (or the error of a refused
// argument); the Python wrapper raises when that is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int ROPE_THREADS = 128;
constexpr int THREADS = 128;      // decode_attend: 4 warps
constexpr int COMBINE_THREADS = 128;
constexpr int G_MAX = 16;         // query heads a KV head
constexpr int PAD_BYTES = 16;     // a shared K/V row's padding

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
struct Tile;
template <>
struct Tile<__nv_bfloat16> { static constexpr int N = 64; };
template <>
struct Tile<float> { static constexpr int N = 32; };

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16 bytes global -> shared, asynchronously; zeros where !valid (src-size 0).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 8 values from 16-byte-aligned shared memory (one bf16 vector, two fp32).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// 4 values from 8-byte-aligned (bf16) or 16-byte-aligned (fp32) memory.
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&f)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                            *reinterpret_cast<const uint32_t*>(&hi));
}
__device__ __forceinline__ void store4(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

// ---------------------------------------------------------------------------
// rope_append: a thread a pair of values (i, i + hd / 2) of one head of q, k
// or v; grid (pairs / ROPE_THREADS, b), so the loads of a sequence are all
// in flight at once
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(ROPE_THREADS)
rope_append(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ freqs, const long long* __restrict__ write_pos,
            const long long* __restrict__ rope_pos, T* __restrict__ q_out,
            T* __restrict__ k_cache, T* __restrict__ v_cache, int h, int kv, int hd,
            long long s_slots) {
  const int b = blockIdx.y, half = hd / 2;
  const int p = blockIdx.x * ROPE_THREADS + threadIdx.x;
  if (p >= (h + 2 * kv) * half) return;
  const int head = p / half, i = p - head * half;  // heads: q's h, then k's kv, then v's kv
  const size_t row = (size_t)kv * hd;
  // every load is issued before the first branch on one, so they are in
  // flight together
  const T* src = head < h ? q + ((size_t)b * h + head) * hd
                          : (head < h + kv ? k : v) + (size_t)b * row + (size_t)((head - h) % kv) * hd;
  const T x1 = src[i], x2 = src[i + half];
  const long long wp = write_pos[b];
  const float pos = (float)rope_pos[b];  // RoPE's angle takes the position as fp32, as apply_rope
  const float freq = freqs != nullptr ? freqs[i] : 0.f;
  const bool keep = wp >= 0 && wp < s_slots;  // else the write is dropped
  if (head >= h && !keep) return;
  const size_t at = ((size_t)b * s_slots + (keep ? wp : 0)) * row;
  if (head >= h + kv) {  // v: copied
    T* dst = v_cache + at + (size_t)(head - h - kv) * hd;
    dst[i] = x1;
    dst[i + half] = x2;
    return;
  }
  const float f1 = to_f32(x1), f2 = to_f32(x2);
  float o1 = f1, o2 = f2;
  if (freqs != nullptr) {
    const float ang = __fmul_rn(pos, freq);
    const float c = cosf(ang), sn = sinf(ang);
    o1 = __fsub_rn(__fmul_rn(f1, c), __fmul_rn(f2, sn));
    o2 = __fadd_rn(__fmul_rn(f2, c), __fmul_rn(f1, sn));
  }
  T* dst = head < h ? q_out + ((size_t)b * h + head) * hd : k_cache + at + (size_t)(head - h) * hd;
  dst[i] = from_f32<T>(o1);
  dst[i + half] = from_f32<T>(o2);
}

// ---------------------------------------------------------------------------
// decode_attend, simt route: one block a (chunk of positions, KV head, slot),
// the products on the CUDA cores
// ---------------------------------------------------------------------------

// Shared memory of a block: q (g x hd fp32), the tile's scores (g x TILE),
// per head m, l and the rescale factor, then the K and V rings.
template <typename T>
size_t attend_smem(int g, int hd) {
  constexpr int TILE = Tile<T>::N;
  const size_t ld = (size_t)hd * sizeof(T) + PAD_BYTES;  // bytes of a shared row
  return sizeof(float) * ((size_t)g * hd + (size_t)g * TILE + 3 * G_MAX) + 2 * 2 * TILE * ld;
}

// HD_MAX (128 or 256) bounds the heads a thread sums in PV: a group of 4
// columns spans hd / 4 threads, so 128 / (hd / 4) head sets share the block.
template <typename T, int HD_MAX>
__global__ void __launch_bounds__(THREADS)
decode_attend(const T* __restrict__ q, const T* __restrict__ k_cache,
              const T* __restrict__ v_cache, const long long* __restrict__ valid_upto,
              T* __restrict__ out, float* __restrict__ part, int h, int kv, int hd,
              long long s_slots, int chunk, float scale_log2) {
  constexpr int TILE = Tile<T>::N;
  constexpr int PARTS = THREADS / TILE;                      // head sets of the scores
  constexpr int QH = (G_MAX + PARTS - 1) / PARTS;            // heads a thread scores
  constexpr int PH = (G_MAX + THREADS / (HD_MAX / 4) - 1) / (THREADS / (HD_MAX / 4));
  constexpr int EV = 16 / (int)sizeof(T);                    // values of a 16-byte vector

  const int g = h / kv;
  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nch = gridDim.x;
  long long last = valid_upto[b];
  if (last > s_slots - 1) last = s_slots - 1;
  const long long start = (long long)c * chunk;
  if (part != nullptr && start > last) return;  // no valid position in this chunk
  const long long end = last + 1 < start + chunk ? last + 1 : start + chunk;
  const int ntiles = end > start ? (int)((end - start + TILE - 1) / TILE) : 0;

  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sP = sQ + g * hd;
  float* sM = sP + g * TILE;
  float* sL = sM + G_MAX;
  float* sA = sL + G_MAX;
  const int ld = hd + PAD_BYTES / (int)sizeof(T);  // values of a shared row
  T* sK = reinterpret_cast<T*>(sA + G_MAX);
  T* sV = sK + 2 * TILE * ld;

  const int tid = threadIdx.x;
  const T* qg = q + ((size_t)b * h + (size_t)kvh * g) * hd;
  for (int e = tid; e < g * hd; e += THREADS) sQ[e] = to_f32(qg[e]);
  if (tid < G_MAX) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }

  const size_t row = (size_t)kv * hd;  // values between positions
  const T* kb = k_cache + (size_t)b * s_slots * row + (size_t)kvh * hd;
  const T* vb = v_cache + (size_t)b * s_slots * row + (size_t)kvh * hd;
  const int vecs = hd / EV;  // 16-byte vectors a row
  auto load_tile = [&](int i, int buf) {
    const long long t0 = start + (long long)i * TILE;
    for (int e = tid; e < TILE * vecs; e += THREADS) {
      const int r = e / vecs, cv = e - r * vecs;
      const bool ok = t0 + r < end;
      const size_t off = (size_t)(ok ? t0 + r : start) * row + (size_t)cv * EV;
      const int at = (buf * TILE + r) * ld + cv * EV;
      cp_async16(sK + at, kb + off, ok);
      cp_async16(sV + at, vb + off, ok);
    }
    cp_async_commit();
  };

  // PV: thread (dg, hs) keeps columns [4 dg, 4 dg + 4) of heads hs, hs + nhs, ...
  const int ndg = hd / 4, nhs = THREADS / ndg;
  const int dg = tid % ndg, hs = tid / ndg;
  const bool pv = hs < nhs;
  float acc[PH][4];
#pragma unroll
  for (int j = 0; j < PH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if (ntiles > 0) load_tile(0, 0);
  __syncthreads();  // sQ, sM, sL
  for (int i = 0; i < ntiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < ntiles) {
      load_tile(i + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const long long t0 = start + (long long)i * TILE;
    const int nrows = end - t0 < TILE ? (int)(end - t0) : TILE;

    {  // scores of position t for heads part, part + PARTS, ...
      const int t = tid % TILE, part_id = tid / TILE;
      float s[QH];
#pragma unroll
      for (int j = 0; j < QH; ++j) s[j] = 0.f;
      const T* kr = sK + (buf * TILE + t) * ld;
      for (int d0 = 0; d0 < hd; d0 += 8) {
        float kf[8];
        load8(kr + d0, kf);
#pragma unroll
        for (int j = 0; j < QH; ++j) {
          const int hq = part_id + PARTS * j;
          if (hq < g) {
            float qf[8];
            load8(sQ + hq * hd + d0, qf);
#pragma unroll
            for (int e = 0; e < 8; ++e) s[j] = fmaf(qf[e], kf[e], s[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < QH; ++j) {
        const int hq = part_id + PARTS * j;
        if (hq < g) sP[hq * TILE + t] = t < nrows ? s[j] * scale_log2 : -INFINITY;
      }
    }
    __syncthreads();

    {  // online softmax: a warp a head
      const int lane = tid % 32;
      for (int hq = tid / 32; hq < g; hq += THREADS / 32) {
        float* pr = sP + hq * TILE;
        const float v0 = pr[lane];
        const float v1 = TILE > 32 ? pr[lane + 32] : -INFINITY;
        const float m_old = sM[hq];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(v0, v1)));  // finite: a valid row
        const float p0 = exp2f(v0 - m_new), p1 = exp2f(v1 - m_new);
        pr[lane] = p0;
        if (TILE > 32) pr[lane + 32] = p1;
        const float sum = warp_sum(p0 + p1);
        if (lane == 0) {
          const float a = exp2f(m_old - m_new);
          sA[hq] = a;
          sL[hq] = sL[hq] * a + sum;
          sM[hq] = m_new;
        }
      }
    }
    __syncthreads();

    if (pv) {
      float a[PH];
#pragma unroll
      for (int j = 0; j < PH; ++j) {
        const int hp = hs + nhs * j;
        a[j] = hp < g ? sA[hp] : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= a[j];
      }
      const T* vr = sV + buf * TILE * ld + dg * 4;
      for (int t = 0; t < nrows; ++t) {
        float vf[4];
        load4(vr + t * ld, vf);
#pragma unroll
        for (int j = 0; j < PH; ++j) {
          const int hp = hs + nhs * j;
          if (hp < g) {
            const float p = sP[hp * TILE + t];
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = fmaf(p, vf[e], acc[j][e]);
          }
        }
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this buffer
  }

  if (!pv) return;
  const int B = gridDim.z;
#pragma unroll
  for (int j = 0; j < PH; ++j) {
    const int hp = hs + nhs * j;
    if (hp >= g) continue;
    const int head = kvh * g + hp;
    if (part == nullptr) {  // single route: the output itself
      const float inv = 1.f / sL[hp];  // l = 0 (no valid position): NaN, as the masked softmax
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = acc[j][e] * inv;
      store4(out + ((size_t)b * h + head) * hd + dg * 4, o);
    } else {
      const size_t slot = ((size_t)b * nch + c) * h + head;
      store4(part + slot * hd + dg * 4, acc[j]);
      if (dg == 0) {
        float* ml = part + (size_t)B * nch * h * hd + slot * 2;
        ml[0] = sM[hp];
        ml[1] = sL[hp];
      }
    }
  }
}

// The split route's merge: one block a (head, slot), the chunks that hold a
// valid position in order.
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
decode_combine(const float* __restrict__ part, const long long* __restrict__ valid_upto,
               T* __restrict__ out, int h, int hd, long long s_slots, int chunk, int nch) {
  const int head = blockIdx.x, b = blockIdx.y, B = gridDim.y;
  long long last = valid_upto[b];
  if (last > s_slots - 1) last = s_slots - 1;
  const int used = last < 0 ? 0 : (int)(last / chunk) + 1;
  const float* ml = part + (size_t)B * nch * h * hd;
  const size_t slot0 = (size_t)b * nch * h + head;  // chunk c at slot0 + c * h
  float m = -INFINITY;
  for (int c = 0; c < used; ++c) m = fmaxf(m, ml[(slot0 + (size_t)c * h) * 2]);
  float l = 0.f;
  for (int c = 0; c < used; ++c) {
    const size_t s = slot0 + (size_t)c * h;
    l += ml[s * 2 + 1] * exp2f(ml[s * 2] - m);
  }
  for (int d = threadIdx.x; d < hd; d += COMBINE_THREADS) {
    float o = 0.f;
    for (int c = 0; c < used; ++c) {
      const size_t s = slot0 + (size_t)c * h;
      o += part[s * hd + d] * exp2f(ml[s * 2] - m);
    }
    out[((size_t)b * h + head) * hd + d] = from_f32<T>(o / l);  // used = 0: NaN
  }
}

// ---------------------------------------------------------------------------
// decode_attend, mma route (bf16, hd % 16 == 0, hd <= 128): the products on
// the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int TILE = 64;   // positions a tile, 16 for each of the 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int HD = 128;    // the widest head
constexpr int LD = HD + 8;  // bf16 values of a shared row: 272 bytes, ldmatrix without conflicts

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// d += a b on m16n8k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

size_t smem_bytes() { return sizeof(bf16) * (size_t)(16 + 2 * 2 * TILE) * LD; }

// Warp w takes positions [16 w, 16 w + 16) of every tile with its own
// running max, sum and output (the query heads as the 16 rows of the mma,
// rows past g zero): S = Q K^T on 2 x hd / 16 mma (K as stored is the B
// operand), the online softmax on the accumulator fragment, then P, rounded
// to bf16 pairs in registers (the plain path rounds P to bf16 likewise), as
// the A operand of O += P V on hd / 8 mma (V through ldmatrix.trans). The
// four warps' (m, l, O) merge in shared memory at the end, in a fixed order.
__global__ void __launch_bounds__(THREADS)
decode_attend(const bf16* __restrict__ q, const bf16* __restrict__ k_cache,
              const bf16* __restrict__ v_cache, const long long* __restrict__ valid_upto,
              bf16* __restrict__ out, float* __restrict__ part, int h, int kv, int hd,
              long long s_slots, int chunk, float scale_log2) {
  const int g = h / kv;
  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nch = gridDim.x;
  long long last = valid_upto[b];
  if (last > s_slots - 1) last = s_slots - 1;
  const long long start = (long long)c * chunk;
  if (part != nullptr && start > last) return;  // no valid position in this chunk
  const long long end = last + 1 < start + chunk ? last + 1 : start + chunk;
  const int ntiles = end > start ? (int)((end - start + TILE - 1) / TILE) : 0;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + 16 * LD;
  bf16* sV = sK + 2 * TILE * LD;
  __shared__ float sMW[WARPS][16], sLW[WARPS][16];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4, tig = lane % 4;
  const int vecs = hd / 8, nks = hd / 16;
  const bf16* qg = q + ((size_t)b * h + (size_t)kvh * g) * hd;
  for (int e = tid; e < 16 * vecs; e += THREADS) {
    const int r = e / vecs, cv = e - r * vecs;
    *reinterpret_cast<uint4*>(sQ + r * LD + cv * 8) =
        r < g ? *reinterpret_cast<const uint4*>(qg + (size_t)r * hd + cv * 8)
              : make_uint4(0u, 0u, 0u, 0u);
  }

  const size_t row = (size_t)kv * hd;
  const bf16* kb = k_cache + (size_t)b * s_slots * row + (size_t)kvh * hd;
  const bf16* vb = v_cache + (size_t)b * s_slots * row + (size_t)kvh * hd;
  auto load_tile = [&](int i, int buf) {
    const long long t0 = start + (long long)i * TILE;
    for (int e = tid; e < TILE * vecs; e += THREADS) {
      const int r = e / vecs, cv = e - r * vecs;
      const bool ok = t0 + r < end;
      const size_t off = (size_t)(ok ? t0 + r : start) * row + (size_t)cv * 8;
      const int at = (buf * TILE + r) * LD + cv * 8;
      cp_async16(sK + at, kb + off, ok);
      cp_async16(sV + at, vb + off, ok);
    }
    cp_async_commit();
  };

  if (ntiles > 0) load_tile(0, 0);
  __syncthreads();  // sQ
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    if (ks < nks)
      ldmatrix_x4(qf[ks], sQ + (lane % 8 + ((lane / 8) & 1) * 8) * LD + ks * 16 + (lane / 16) * 8);

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};  // rows grp, grp + 8

  for (int i = 0; i < ntiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < ntiles) {
      load_tile(i + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const long long w0 = start + (long long)i * TILE + warp * 16;  // the warp's first position
    if (w0 < end) {
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const bf16* kt = sK + (buf * TILE + warp * 16) * LD;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        if (ks < nks) {
          uint32_t kf[4];  // n-tiles 0 and 1 (positions 0-7, 8-15), k halves 0-7 and 8-15
          ldmatrix_x4(kf, kt + ((lane / 16) * 8 + lane % 8) * LD + ks * 16 + ((lane / 8) & 1) * 8);
          mma(s[0], qf[ks], kf[0], kf[1]);
          mma(s[1], qf[ks], kf[2], kf[3]);
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = w0 + j * 8 + tig * 2 + (e & 1) < end;
          s[j][e] = ok ? s[j][e] * scale_log2 : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float base[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        base[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = exp2f(m_r[r] - base[r]);
        m_r[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(s[j][e] - base[e >> 1]);
          rs[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rs[r];
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      const uint32_t pa[4] = {pack(s[0][0], s[0][1]), pack(s[0][2], s[0][3]),
                              pack(s[1][0], s[1][1]), pack(s[1][2], s[1][3])};
      const bf16* vt = sV + (buf * TILE + warp * 16) * LD;
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        if (np < nks) {
          uint32_t vf[4];  // positions 0-7 and 8-15 of hd columns 16 np + 0-7, then + 8-15
          ldmatrix_x4_trans(vf, vt + (((lane / 8) & 1) * 8 + lane % 8) * LD + np * 16 +
                                    (lane / 16) * 8);
          mma(o[2 * np], pa, vf[0], vf[1]);
          mma(o[2 * np + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    if (tig == 0) {
      sMW[warp][grp + 8 * r] = m_r[r];
      sLW[warp][grp + 8 * r] = l_r[r];
    }
  }
  __syncthreads();
  float* sO = reinterpret_cast<float*>(sK);  // [WARPS][16][HD] fp32, over the ring
  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mb = -INFINITY;
    for (int w = 0; w < WARPS; ++w) mb = fmaxf(mb, sMW[w][grp + 8 * r]);
    f[r] = exp2f(m_r[r] - (mb == -INFINITY ? 0.f : mb));
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (n < 2 * nks) {
      float* o0 = sO + (warp * 16 + grp) * HD + n * 8 + tig * 2;
      *reinterpret_cast<float2*>(o0) = make_float2(o[n][0] * f[0], o[n][1] * f[0]);
      *reinterpret_cast<float2*>(o0 + 8 * HD) = make_float2(o[n][2] * f[1], o[n][3] * f[1]);
    }
  }
  __syncthreads();
  const int B = gridDim.z;
  for (int e = tid; e < g * hd; e += THREADS) {
    const int r = e / hd, d = e - r * hd;
    float mb = -INFINITY;
    for (int w = 0; w < WARPS; ++w) mb = fmaxf(mb, sMW[w][r]);
    const float base = mb == -INFINITY ? 0.f : mb;
    float l = 0.f, acc = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      l += sLW[w][r] * exp2f(sMW[w][r] - base);
      acc += sO[(w * 16 + r) * HD + d];
    }
    const int head = kvh * g + r;
    if (part == nullptr) {
      out[((size_t)b * h + head) * hd + d] = __float2bfloat16(acc / l);  // l = 0: NaN
    } else {
      const size_t slot = ((size_t)b * nch + c) * h + head;
      part[slot * hd + d] = acc;
      if (d == 0) {
        float* ml = part + (size_t)B * nch * h * hd + slot * 2;
        ml[0] = mb;
        ml[1] = l;
      }
    }
  }
}

}  // namespace tc

cudaError_t on_device(int device) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  return e;
}

template <typename T>
cudaError_t launch_rope(const void* q, const void* k, const void* v, const void* freqs,
                        const void* write_pos, const void* rope_pos, void* q_out,
                        void* k_cache, void* v_cache, int b, int h, int kv, int hd,
                        long long s_slots, cudaStream_t stream) {
  const int pairs = (h + 2 * kv) * (hd / 2);
  rope_append<T><<<dim3((pairs + ROPE_THREADS - 1) / ROPE_THREADS, b), ROPE_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(freqs), static_cast<const long long*>(write_pos),
      static_cast<const long long*>(rope_pos), static_cast<T*>(q_out),
      static_cast<T*>(k_cache), static_cast<T*>(v_cache), h, kv, hd, s_slots);
  return cudaGetLastError();
}

// The shared-memory opt-in above 48 KB and the carveout that lets the
// blocks of the largest request share an SM, once a kernel and device.
template <typename K>
cudaError_t opt_in(K kernel, size_t most, int device, bool (&done)[64]) {
  if (done[device & 63]) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)most);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) done[device & 63] = true;
  return e;
}

// decode_attend of either route on grid (chunks, kv, b), then, on the split
// route (part not null), decode_combine.
template <typename T, typename K>
cudaError_t launch_attend(K kernel, size_t smem, const void* q, const void* k_cache,
                          const void* v_cache, const void* valid_upto, void* out, void* part,
                          int b, int h, int kv, int hd, long long s_slots, int chunk, float scale,
                          cudaStream_t stream) {
  const int nch = (int)((s_slots + chunk - 1) / chunk);
  const float scale_log2 = scale * 1.4426950408889634f;
  kernel<<<dim3(nch, kv, b), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache), static_cast<const T*>(v_cache),
      static_cast<const long long*>(valid_upto), static_cast<T*>(out),
      static_cast<float*>(part), h, kv, hd, s_slots, chunk, scale_log2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || part == nullptr) return e;
  decode_combine<T><<<dim3(h, b), COMBINE_THREADS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const long long*>(valid_upto),
      static_cast<T*>(out), h, hd, s_slots, chunk, nch);
  return cudaGetLastError();
}

template <typename T, int HD_MAX>
cudaError_t launch_simt(const void* q, const void* k_cache, const void* v_cache,
                        const void* valid_upto, void* out, void* part, int b, int h, int kv,
                        int hd, long long s_slots, int chunk, float scale, int device,
                        cudaStream_t stream) {
  static bool done[64] = {false};
  const cudaError_t e = opt_in(decode_attend<T, HD_MAX>, attend_smem<T>(G_MAX, HD_MAX), device,
                               done);
  if (e != cudaSuccess) return e;
  return launch_attend<T>(decode_attend<T, HD_MAX>, attend_smem<T>(h / kv, hd), q, k_cache,
                          v_cache, valid_upto, out, part, b, h, kv, hd, s_slots, chunk, scale,
                          stream);
}

cudaError_t launch_mma(const void* q, const void* k_cache, const void* v_cache,
                       const void* valid_upto, void* out, void* part, int b, int h, int kv,
                       int hd, long long s_slots, int chunk, float scale, int device,
                       cudaStream_t stream) {
  static bool done[64] = {false};
  const cudaError_t e = opt_in(tc::decode_attend, tc::smem_bytes(), device, done);
  if (e != cudaSuccess) return e;
  return launch_attend<__nv_bfloat16>(tc::decode_attend, tc::smem_bytes(), q, k_cache, v_cache,
                                      valid_upto, out, part, b, h, kv, hd, s_slots, chunk, scale,
                                      stream);
}

bool shape_ok(int b, int h, int kv, int hd, long long s_slots) {
  return b >= 1 && b <= 65535 && kv >= 1 && kv <= 65535 && h >= kv && h % kv == 0 &&
         h / kv <= G_MAX && hd >= 8 && hd <= 256 && hd % 8 == 0 && s_slots >= 1;
}

}  // namespace

extern "C" {

// q, k, v: the tick's products, (b, h, hd), (b, kv, hd), (b, kv, hd);
// k_cache, v_cache (b, s_slots, kv, hd), written at row write_pos[b] where
// 0 <= write_pos[b] < s_slots; q_out (b, h, hd). write_pos and rope_pos
// (b,) int64 on the device. freqs: hd / 2 fp32 RoPE frequencies, or null for
// no rotation. dtype 0 = float32, 1 = bfloat16, for every tensor but freqs.
// Returns a cudaError_t (0 on success).
int repro_rope_append(const void* q, const void* k, const void* v, const void* freqs,
                      const void* write_pos, const void* rope_pos, void* q_out, void* k_cache,
                      void* v_cache, int b, int h, int kv, int hd, long long s_slots, int dtype,
                      int device, void* stream) {
  cudaError_t e = on_device(device);
  if (e != cudaSuccess) return (int)e;
  if (!shape_ok(b, h, kv, hd, s_slots)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_rope<float>(q, k, v, freqs, write_pos, rope_pos, q_out, k_cache,
                                     v_cache, b, h, kv, hd, s_slots, st);
    case 1:
      return (int)launch_rope<__nv_bfloat16>(q, k, v, freqs, write_pos, rope_pos, q_out,
                                             k_cache, v_cache, b, h, kv, hd, s_slots, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q (b, h, hd); k_cache, v_cache (b, s_slots, kv, hd), 16-byte aligned;
// valid_upto (b,) int64 on the device; out (b, h, hd). route 0 = simt
// (CUDA-core products; fp32 or bf16), 1 = mma (tensor cores; bf16 with
// hd % 16 == 0, hd <= 128). chunk: positions a block, a multiple of the
// route's tile (mma 64; simt 64 bf16, 32 fp32). part: null where one chunk
// covers s_slots, else fp32 scratch of b * ceil(s_slots / chunk) * h *
// (hd + 2) values (acc, then m and l). scale: the scores' factor (1 /
// sqrt(hd)). Returns a cudaError_t.
int repro_decode_attend(const void* q, const void* k_cache, const void* v_cache,
                        const void* valid_upto, void* out, void* part, int b, int h, int kv,
                        int hd, long long s_slots, int route, int chunk, float scale, int dtype,
                        int device, void* stream) {
  cudaError_t e = on_device(device);
  if (e != cudaSuccess) return (int)e;
  const int tile = route == 1 ? tc::TILE : dtype == 0 ? Tile<float>::N : Tile<__nv_bfloat16>::N;
  const bool aligned = ((uintptr_t)q | (uintptr_t)k_cache | (uintptr_t)v_cache |
                        (uintptr_t)out | (uintptr_t)part) % 16 == 0;
  const bool route_ok = route == 0 || (route == 1 && dtype == 1 && hd % 16 == 0 && hd <= tc::HD);
  if (!shape_ok(b, h, kv, hd, s_slots) || !aligned || !route_ok || chunk < tile ||
      chunk % tile || (part == nullptr) != (s_slots <= chunk) ||
      (s_slots + chunk - 1) / chunk > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1)
    return (int)launch_mma(q, k_cache, v_cache, valid_upto, out, part, b, h, kv, hd, s_slots,
                           chunk, scale, device, st);
  switch (dtype * 2 + (int)(hd > 128)) {
    case 0:
      return (int)launch_simt<float, 128>(q, k_cache, v_cache, valid_upto, out, part, b, h, kv,
                                          hd, s_slots, chunk, scale, device, st);
    case 1:
      return (int)launch_simt<float, 256>(q, k_cache, v_cache, valid_upto, out, part, b, h, kv,
                                          hd, s_slots, chunk, scale, device, st);
    case 2:
      return (int)launch_simt<__nv_bfloat16, 128>(q, k_cache, v_cache, valid_upto, out, part, b,
                                                  h, kv, hd, s_slots, chunk, scale, device, st);
    case 3:
      return (int)launch_simt<__nv_bfloat16, 256>(q, k_cache, v_cache, valid_upto, out, part, b,
                                                  h, kv, hd, s_slots, chunk, scale, device, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
