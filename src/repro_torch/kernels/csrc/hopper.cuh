// hopper.cuh — the Hopper (sm_90a) pieces that the tensor-core kernels
// share: flash_fwd.cu and flash_bwd.cu (through flash_common.cuh) and
// conv1d_bwd_weight.cu.  Included, not compiled; build.py hashes it with
// each library that lists it among its sources.
//
//   * cp.async copies from global to shared memory, their groups and waits;
//   * the 128-byte swizzled tile layout and the wgmma shared-memory
//     descriptor of a K-major operand in it;
//   * wgmma's fence, commit and wait.
//
// A tile of R rows lives in shared memory as column blocks of (R, 128
// bytes): 64 bf16 or 32 fp32 (tf32) values a row.  The 16-byte chunk c of
// a row sits at chunk c ^ (row % 8): the 128-byte swizzle that a wgmma
// descriptor of layout B128 names.  Every tile starts 1024-byte aligned
// (the swizzle is taken on the address bits).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WG = 128;          // threads of a warpgroup
constexpr int WG_M = 64;         // rows of one wgmma (M)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros when !valid
// (src must still be a valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
// the first `bytes` (0 to 16) of 16 from global to shared memory,
// asynchronously, the rest zeros (src must still be a valid address)
__device__ __forceinline__ void cp_async16_part(uint32_t dst, const void* src,
                                                int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// make this thread's shared-memory writes visible to wgmma's reads (the
// async proxy); a barrier after it makes all threads' visible
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The byte offset of 16-byte chunk c (8 bf16 or 4 fp32 columns) of row rr
// in an R-row tile of the swizzled layout.
template <int R>
__device__ __forceinline__ uint32_t sw128(int rr, int c) {
  return (c >> 3) * (R * 128) + rr * 128 + (((c & 7) ^ (rr & 7)) << 4);
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (each in 16-byte units), layout B128 (bits 62-63).
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major: k-step kk of the rows of an R-row tile that starts at tile, 32
// bytes a row (16 bf16 or 8 tf32 columns: one wgmma's k); rows 8 apart by
// 1024 bytes; the 32-byte step inside a 128-byte row is taken before the
// swizzle.
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc_b128(tile + (kk >> 2) * (R * 128) + (kk & 3) * 32, 16, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// a wgmma fence or wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

}  // namespace
