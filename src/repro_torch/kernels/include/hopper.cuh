// Hopper building blocks shared by the port's TMA kernels (the matmul's,
// the conv's, the flash attention's and the SSD's wgmma routes, the fp32
// tf32x3 routes of the matmul, the conv, flash attention and the SSD, and
// the matmul's fp32 stream route), in inline PTX for sm_90a: mbarriers, TMA
// tile loads (2-D and 4-D), the m64n128k16 and m64n64k16 bf16 wgmmas and
// the m64n128k8 and m64n64k8 tf32 ones (A from shared memory; m64n64k8
// also from registers, the SSD's G) with their shared-memory descriptors, the proxy fence and a named barrier; the
// split of fp32 into two TF32 halves and the pass that writes split (and
// transposed) operands; and, on the host, the bf16 and fp32 tensor-map
// encoders (128-byte swizzled for the wgmmas, unswizzled for the stream
// route's CUDA-core reads).
// kernels/_build.py passes this directory to nvcc with -I and hashes it into
// every kernel's cache key.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: nothing of libcuda is linked
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and the
// other threads; a __syncthreads() follows it.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A fresh barrier is
// in phase 0, so waiting on parity 1 passes at once (the producer's first
// pass over the empty barriers).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA -------------------------------------------------------------------

// One 2-D box of `map` at (c0 innermost, c1) into shared memory at `dst`;
// completion is counted in bytes on `bar`. Elements past the tensor's edge
// are written as zeros and read no memory.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// One 4-D box at (c0 innermost, c1, c2, c3). Coordinates are signed: a box
// that starts before 0 or runs past the end is zero-filled there, and its
// bytes still count whole on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy accesses of it (a wgmma reading a tile the threads wrote, a
// TMA load overwriting it); a barrier among the writers follows it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Barrier `id` (1-15; 0 is __syncthreads) among `count` threads, whole warps.
__device__ __forceinline__ void named_sync(uint32_t id, uint32_t count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor of a tile written by TMA with 128-byte
// swizzle (layout type 1). Offsets are in bytes; the tile is 1024-byte
// aligned, so the base-offset field stays 0.
//  * K-major (A): rows of 64 bf16 along K, 128 bytes each; `sbo` is the
//    stride between groups of 8 rows (1024); `lbo` is unused.
//  * MN-major (B, N contiguous): each 128-byte row holds 64 values along N
//    for one k; `lbo` is the stride between 64-wide atoms along N, `sbo`
//    the stride between groups of 8 k rows.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pins the accumulators in program order around the asynchronous products,
// so the compiler neither reads them before wgmma_wait nor moves them.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, fp32, the warpgroup's fragment) += A (64 x 16, K-major) @
// B (16 x 128, MN-major: transpose bit set), both bf16 in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 64, fp32) (+)= A (64 x 16) @ B (16 x 64): the same product on one
// 64-wide atom of B. B is MN-major (N contiguous: transpose bit set,
// TRANS_B = 1, the conv's weights) or K-major (each of its 64 rows of N
// holds K contiguous, as A's rows do: TRANS_B = 0, the flash kernel's K
// tile); a K-major B takes A's descriptor form. A is K-major (TRANS_A = 0)
// or MN-major (TRANS_A = 1: its 64 rows of M contiguous along each k, the
// SSD's x tile read as x^T), which takes the MN-major B's descriptor form.
// scale_d = 0 overwrites d instead of adding to it.
template <int TRANS_B = 1, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %36, %35;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A));
}

// d (64 x N, fp32) += A (64 x 16, bf16 in registers) @ B (16 x N, bf16 in
// shared memory, MN-major: transpose bit set). A is the m64k16 register
// fragment: warp w of the warpgroup holds rows 16w + lane/4 (+ 8) and, per
// register, two adjacent k: a[0] (row, k = 2 (lane % 4) + {0, 1}), a[1]
// (row + 8, same k), a[2] (row, k + 8), a[3] (row + 8, k + 8), the lower k
// in the low half. That is the accumulator fragment of a 64 x 16 slice of
// a wgmma's output (d[8j .. 8j + 7] for columns [16j, 16j + 16)), packed
// to bf16 pairs: the flash kernel's P never leaves registers.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ---- tf32 wgmma -------------------------------------------------------------
//
// .tf32 has no transpose immediates: both operands are K-major. A's 64 rows
// of M and B's rows of N each hold 32 fp32 along K in one 128-byte swizzle
// row (a TMA box of ATOM_F32 x rows), so a tile's descriptor is the bf16
// K-major A's: make_desc(tile + kk * 32, 16, 1024) for the k8 slice kk of
// the row (8 fp32 are 32 bytes, as 16 bf16 are), `sbo` the 1024 bytes from
// one group of 8 rows to the next, `lbo` unused.

// d (64 x 128, fp32) (+)= A (64 x 8) @ B (8 x 128), tf32 in shared memory;
// scale_d = 0 overwrites d instead of adding to it.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], uint64_t desc_a,
                                                     uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, fp32) (+)= A (64 x 8) @ B (8 x 64), tf32 in shared memory.
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, fp32) (+)= A (64 x 8, tf32 in registers) @ B (8 x 64, tf32 in
// shared memory, K-major). A is the m64k8 register fragment: warp w of the
// warpgroup holds rows 16w + lane/4 (+ 8) and, per register, one k: a[0]
// (row, k = lane % 4), a[1] (row + 8, same k), a[2] (row, k + 4), a[3]
// (row + 8, k + 4). Of an m64n64 accumulator (columns 8j + 2 (lane % 4) +
// {0, 1}), columns [8j, 8j + 8) are that fragment when B's k row t holds
// the accumulator's column 2t and row t + 4 its column 2t + 1: the SSD's
// G x_j, whose x_j^T the kernel writes in that order.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// One stage of a tf32x3 product: for each of the BK / 8 k8 slices of the
// stage's 128-byte rows, the three TF32 products a_lo b_hi, a_hi b_lo and
// a_hi b_hi (the small terms first) into one fp32 accumulator, which the
// first product overwrites when `fresh`. The four tiles are K-major and
// 128-byte swizzled (see above); a_lo b_lo (below 2^-22 of the product) is
// left out. BN = 128 or 64 rows of B.
template <int BN, int BK>
__device__ __forceinline__ void tf32x3_stage(float (&d)[BN / 2], uint32_t a_hi, uint32_t a_lo,
                                             uint32_t b_hi, uint32_t b_lo, bool fresh) {
  static_assert(BN == 128 || BN == 64, "m64n128k8 or m64n64k8");
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const uint64_t ah = make_desc(a_hi + kk * 32, 16, 1024), al = make_desc(a_lo + kk * 32, 16, 1024);
    const uint64_t bh = make_desc(b_hi + kk * 32, 16, 1024), bl = make_desc(b_lo + kk * 32, 16, 1024);
    const int first = (kk == 0 && fresh) ? 0 : 1;
    if constexpr (BN == 128) {
      wgmma_m64n128k8_tf32(d, al, bh, first);
      wgmma_m64n128k8_tf32(d, ah, bl);
      wgmma_m64n128k8_tf32(d, ah, bh);
    } else {
      wgmma_m64n64k8_tf32(d, al, bh, first);
      wgmma_m64n64k8_tf32(d, ah, bl);
      wgmma_m64n64k8_tf32(d, ah, bh);
    }
  }
}

// Stages a tensor-core partial sum runs before it is added to the fp32 sum
// in registers. The tensor cores add into their accumulator with
// truncation, an error that grows with the number of additions: run
// unbroken over the LMs' K (thousands), a tf32x3 product's error grew
// tens of times past an fp32 product's (PERF.md). Four stages (K = 128)
// hold it to the fp32 product's order; the two round to nearest.
constexpr int TF32X3_PROMOTE = 4;

// The consumer warpgroup's side of a tf32x3 ring of STAGES stages, each
// A_hi, A_lo (A_BYTES each), B_hi, B_lo (B_BYTES each) from `base`; this
// warpgroup's 64 rows of A start `rows` bytes into A's tiles. n_k stages:
// wait on each stage's full barrier, run tf32x3_stage into `part`, keep one
// group in flight and release a stage once the group that read it has
// retired; every TF32X3_PROMOTE stages (and at the last) wait for the
// products and add `part` into `acc` on the CUDA cores.
template <int BN, int BK, int STAGES, int STAGE_BYTES, int A_BYTES, int B_BYTES>
__device__ __forceinline__ void tf32x3_consume(float (&acc)[BN / 2], uint32_t base, uint32_t full0,
                                               uint32_t empty0, int n_k, uint32_t rows) {
  float part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
  fence_operands(acc);
  fence_operands(part);
  int freed = 0;  // stages [0, freed) released
  for (int it = 0; it < n_k; ++it) {
    const int s = it % STAGES;
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    const uint32_t st = base + s * STAGE_BYTES;
    wgmma_fence();
    tf32x3_stage<BN, BK>(part, st + rows, st + A_BYTES + rows, st + 2 * A_BYTES,
                         st + 2 * A_BYTES + B_BYTES, it % TF32X3_PROMOTE == 0);
    wgmma_commit();
    const bool promote = it % TF32X3_PROMOTE == TF32X3_PROMOTE - 1 || it == n_k - 1;
    if (promote) {
      wgmma_wait<0>();
      fence_operands(part);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
      fence_operands(part);
    } else {
      wgmma_wait<1>();  // the previous stage's group has retired
    }
    for (const int done = promote ? it + 1 : it; freed < done; ++freed)
      mbar_arrive(empty0 + 8 * (freed % STAGES));
  }
}

// ---- split TF32 --------------------------------------------------------------

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero), as
// fp32 bits with the low 13 mantissa bits zero. A wgmma that reads raw fp32
// as TF32 truncates, so both halves of the split are rounded here.
__device__ __forceinline__ float round_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xFFFFE000u);
}

// x = hi + lo + e, hi and lo TF32 values, |e| <= 2^-22 |x| for normal x
// (x - hi is exact in fp32).
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - hi);
}

// One operand of a tf32x3 route, written split: in is (batch, rows, cols),
// cols contiguous. Copying (transpose 0), out is (batch, rows, out_cols),
// out_cols >= cols, the columns past cols zero: the matmul's A padded to
// whole K steps. Transposing (1), out is (batch, cols, out_cols), out_cols
// >= rows, out[z][c][r] = in[z][r][c] and zero for r >= rows: the matmul's
// B (K, N) as Bt (N, K padded), the conv's x (N, C, H*W) as NHWC and w
// (K, C, R*S) as (K, R*S*C). The 32 x 32 tiles cover in's extent with the
// padding: tiles_c x tiles_r a plane.
struct SplitJob {
  const float* in;
  float* hi;
  float* lo;
  int rows, cols, out_cols, transpose;
  int tiles_c, tiles_r;
};

inline SplitJob split_job(const void* in, void* hi, void* lo, int rows, int cols, int out_cols,
                          bool transpose) {
  const int ec = transpose ? cols : out_cols, er = transpose ? out_cols : rows;
  return SplitJob{static_cast<const float*>(in), static_cast<float*>(hi), static_cast<float*>(lo),
                  rows, cols, out_cols, transpose ? 1 : 0, (ec + 31) / 32, (er + 31) / 32};
}

// Tile b of job j, 256 threads: a warp reads 32 contiguous fp32 of a row
// (128 bytes) and writes 32 contiguous fp32 of an output row.
__device__ __forceinline__ void split_tile(const SplitJob& j, long long b, float (&tile)[32][33]) {
  const long long per = (long long)j.tiles_c * j.tiles_r;
  const int z = (int)(b / per), rest = (int)(b - z * per);
  const int c0 = (rest % j.tiles_c) * 32, r0 = (rest / j.tiles_c) * 32;
  const float* in = j.in + (size_t)z * j.rows * j.cols;
  const size_t plane = (size_t)(j.transpose ? j.cols : j.rows) * j.out_cols;
  float* hi = j.hi + z * plane;
  float* lo = j.lo + z * plane;
  const int lane = threadIdx.x % 32, row = threadIdx.x / 32;
  if (!j.transpose) {
#pragma unroll
    for (int i = row; i < 32; i += 8) {
      const int r = r0 + i, c = c0 + lane;
      if (r >= j.rows || c >= j.out_cols) continue;
      float h, l;
      split_tf32(c < j.cols ? in[(size_t)r * j.cols + c] : 0.f, h, l);
      hi[(size_t)r * j.out_cols + c] = h;
      lo[(size_t)r * j.out_cols + c] = l;
    }
    return;
  }
#pragma unroll
  for (int i = row; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + lane;
    tile[i][lane] = (r < j.rows && c < j.cols) ? in[(size_t)r * j.cols + c] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = row; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + lane;  // output row c, column r
    if (c >= j.cols || r >= j.out_cols) continue;
    float h, l;
    split_tf32(tile[lane][i], h, l);
    hi[(size_t)c * j.out_cols + r] = h;
    lo[(size_t)c * j.out_cols + r] = l;
  }
}

// Two split jobs in one launch: blocks [0, blocks_a) take a's tiles, the
// rest b's. Each branch reads its own parameter struct. A template (and so
// split_launch), so that only the sources that launch it build it.
template <int = 0>
__global__ void __launch_bounds__(256)
split_kernel(const SplitJob a, const SplitJob b, long long blocks_a) {
  __shared__ float tile[32][33];
  const long long blk = blockIdx.x;
  if (blk < blocks_a)
    split_tile(a, blk, tile);
  else
    split_tile(b, blk - blocks_a, tile);
}

template <int I = 0>
cudaError_t split_launch(const SplitJob& a, int batch_a, const SplitJob& b, int batch_b,
                         cudaStream_t stream) {
  const long long ba = (long long)a.tiles_c * a.tiles_r * batch_a;
  const long long blocks = ba + (long long)b.tiles_c * b.tiles_r * batch_b;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  split_kernel<I><<<(unsigned)blocks, 256, 0, stream>>>(a, b, ba);
  return cudaGetLastError();
}

// ---- tensor maps (host) ----------------------------------------------------

constexpr int ATOM = 64;      // bf16 values in one 128-byte swizzle row: every box's inner width
constexpr int ATOM_F32 = 32;  // fp32 values in one

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (no -lcuda).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A tensor of `type` and `rank` dimensions (innermost first, `strides` in
// bytes for dimensions 1..rank-1) in boxes of `box`, 128-byte swizzled
// (box[0] must then fill one swizzle row) or, with `swizzle` NONE, stored
// row after row as they are in memory; reads outside the tensor give zeros.
inline bool encode_swizzled(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int rank,
                            const cuuint64_t* dims, const cuuint64_t* strides,
                            const cuuint32_t* box,
                            CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bf16: box[0] == ATOM.
inline bool encode_bf16(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                        const cuuint64_t* strides, const cuuint32_t* box) {
  return encode_swizzled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, rank, dims, strides, box);
}

// fp32 (the tf32x3 routes' split halves, copied bit for bit): box[0] == ATOM_F32.
inline bool encode_f32(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box) {
  return encode_swizzled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, rank, dims, strides, box);
}

// A row-major bf16 (rows, cols) matrix in boxes of box_rows x 64 columns.
inline bool encode_2d(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)ATOM, (cuuint32_t)box_rows};
  return encode_bf16(map, ptr, 2, dims, strides, box);
}

// A bf16 (d3, d2, d1, d0) array, d0 contiguous, in boxes of 64 x b1 x b2 x 1
// (innermost first): the conv's NHWC input as (N, H, W, C) in boxes of 64
// channels x b1 columns x b2 rows of one image.
inline bool encode_4d(CUtensorMap* map, const void* ptr, int d3, int d2, int d1, int d0, int b1,
                      int b2) {
  const cuuint64_t dims[4] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2, (cuuint64_t)d3};
  const cuuint64_t strides[3] = {(cuuint64_t)d0 * 2, (cuuint64_t)d0 * d1 * 2,
                                 (cuuint64_t)d0 * d1 * d2 * 2};
  const cuuint32_t box[4] = {(cuuint32_t)ATOM, (cuuint32_t)b1, (cuuint32_t)b2, 1};
  return encode_bf16(map, ptr, 4, dims, strides, box);
}

// A row-major fp32 (rows, cols) matrix, cols % 4 == 0 (16-byte rows), in
// boxes of box_rows x 32 columns.
inline bool encode_2d_f32(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)ATOM_F32, (cuuint32_t)box_rows};
  return encode_f32(map, ptr, 2, dims, strides, box);
}

// A row-major fp32 (rows, cols) matrix, cols % 4 == 0, in unswizzled boxes
// of box_rows x box_cols (box_cols % 4 == 0, both <= 256): each box lands
// in shared memory as a row-major [box_rows][box_cols] array, the stream
// route's tiles of A and B, read by the CUDA cores.
inline bool encode_2d_f32_rows(CUtensorMap* map, const void* ptr, int rows, int cols,
                               int box_rows, int box_cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return encode_swizzled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, 2, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
}

// An fp32 (d3, d2, d1, d0) array, d0 % 4 == 0 contiguous, in boxes of
// 32 x b1 x b2 x 1: the conv's NHWC input halves; the flash route's q as
// (B, S, H, hd), its K halves as (B, Sk, KV, hd) and its V^T halves as
// (B, KV, hd, Sk padded).
inline bool encode_4d_f32(CUtensorMap* map, const void* ptr, int d3, int d2, int d1, int d0,
                          int b1, int b2) {
  const cuuint64_t dims[4] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2, (cuuint64_t)d3};
  const cuuint64_t strides[3] = {(cuuint64_t)d0 * 4, (cuuint64_t)d0 * d1 * 4,
                                 (cuuint64_t)d0 * d1 * d2 * 4};
  const cuuint32_t box[4] = {(cuuint32_t)ATOM_F32, (cuuint32_t)b1, (cuuint32_t)b2, 1};
  return encode_f32(map, ptr, 4, dims, strides, box);
}

}  // namespace hopper
