// The bf16 implicit-GEMM core of kernels 3 and 9 on Hopper's tensor
// cores: warpgroup MMA (wgmma.mma_async m64n128k16, f32 sums) with A in
// registers and B in shared memory, fed through a ring of shared-memory
// stages guarded by mbarriers (full: a stage's data is in; empty: its
// readers are done).  Producers fill B with cp.async and let each
// thread's copies arrive on the stage's full barrier when they land
// (cp_async_arrive), so no producer waits for its own copies; consumers
// fence the async proxy after the wait, before wgmma reads B.
//
// A comes from registers, loaded with ldmatrix.x4 from one row address a
// lane: a 3x3 tap's shift or a sampled pixel is only another row address,
// so neither kernel builds an im2col buffer.  Each warp of a warpgroup
// holds rows 16w..16w+15 of the 64-row tile; lane l gives the address of
// row l % 16, 16-byte column chunk l / 16 of the k16 slice.
//
// B is a [K rows][128 columns] bf16 tile with the columns contiguous (the
// HWIO weights' [Cin, Cout] as they lie in memory, so the transpose bit,
// not a re-layout), stored as two 64-column atoms of [rows][128 bytes]
// with the 128-byte swizzle: 16-byte chunk c of row r sits at chunk
// c ^ (r % 8).  A stage's base is 1024-byte aligned.
//
// The accumulator of a thread: d[i] is row 16 (warp % 4) + lane / 4
// + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2.
#pragma once

#include "common.cuh"

namespace wg {

constexpr int N = 128;    // columns of one warpgroup's tile
constexpr int ACC = 64;   // f32 accumulators a thread

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// -- the B tile ---------------------------------------------------------
// byte offset of 16-byte chunk q (0..15) of row r in a tile of `rows` rows
__device__ __forceinline__ uint32_t b_offset(int r, int q, int rows) {
  return (uint32_t)((q >> 3) * rows * 128 + r * 128 +
                    (((q & 7) ^ (r & 7)) << 4));
}

// matrix descriptor of the k16 slice of a B tile starting at `addr`
// (row 16 s of the tile: addr = base + 2048 s): 128-byte swizzle, the
// next 8 rows 1024 bytes on, the next 64 columns `rows` x 128 bytes on
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, int rows) {
  const uint64_t lbo = (uint64_t)(rows * 128) >> 4;
  const uint64_t sbo = 1024 >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (lbo << 16) | (sbo << 32) |
         (1ull << 62);
}

// -- A from shared memory into registers -------------------------------
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

// -- warpgroup MMA ------------------------------------------------------
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
}
// keep the compiler from moving accumulator accesses across an MMA
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += a . B, a the warp's 16 x 16 slice of A, B the k16 slice at `desc`
__device__ __forceinline__ void mma(float (&d)[ACC], const uint32_t (&a)[4],
                                    uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// -- the ring: mbarriers, cp.async, proxy fence ------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// wait for the completion of the phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// 16 bytes global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}
// arrive on `bar` once this thread's cp.async copies so far are in
// (counted in the barrier's init count)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// order shared-memory writes this thread has seen (by the generic proxy,
// cp.async included) before its later wgmma reads (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a barrier of `count` threads with id `id` (0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

}  // namespace wg
