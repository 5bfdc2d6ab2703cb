// flash_common.cuh — what flash_fwd.cu and flash_bwd.cu share.  Included
// by both sources (build.py hashes it with them, and hopper.cuh, which it
// includes).
//
//   * the fp32 path (FMA bodies): its tile sizes, 4-element fp32 loads and
//     stores, and the strided loads of a row tile and a key tile into
//     padded shared memory;
//   * the bf16 path (tensor cores, sm_90a): cp.async 16-byte loads of a row
//     or key tile into the 128-byte-swizzled layout (hopper.cuh), its
//     N-major wgmma descriptor (the K-major one is hopper.cuh's), the wgmma
//     products used (m64n64k16 from shared memory; m64n64k16, m64n128k16
//     and m64n192k16 with A in registers), and the split of an fp32
//     accumulator into two bf16 A operands, hi and lo;
//   * the dtype and error codes and the row index of lse, o and dq.
//
// Head dimensions: 64, 112, 128 and 192.  A tile is HP = pad64(HD)
// columns wide (64, 128, 128, 192): a row of hd 112 is loaded into 128
// columns whose last 16 are zeros, so one layout and the n64, n128 and
// n192 wgmma forms serve all four.  A product that sums over hd (Q.K^T and its kin) takes HD/16
// k-steps and never reads the zero columns; a product whose n is hd (P.V
// and its kin) runs at n = HP, its zero columns give zero outputs, and
// only the HD real columns are stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;           // fp32 path: query rows (position x group
constexpr int BK = 64;           // head) per tile, keys per tile,
constexpr int THREADS = 256;     // threads as 16 x 16
constexpr int DT_F32 = 0;        // dtype codes: 0 fp32, 1 bf16
constexpr int ERR_HEAD_DIM = -1; // hd other than 64, 112, 128, 192
constexpr int ERR_GRID = -2;     // B * KV beyond the grid's limit

// a tile's width: hd rounded up to a multiple of 64
__host__ __device__ constexpr int pad64(int hd) { return (hd + 63) / 64 * 64; }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float4 scale4(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

// Rows r0 .. r0+BM (row r = t*G + g) of (B, Tq, KV, G, hd)-strided x,
// already offset to its batch and KV head, into (BM, HP + 4) fp32 shared
// memory, times mul; rows past nrows and columns past HD are zeros.
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, const float* x,
                                          long long st, long long sg, int r0,
                                          int nrows, int G, float mul) {
  constexpr int HP = pad64(HD), LD = HP + 4;
  for (int idx = threadIdx.x; idx < BM * (HP / 4); idx += THREADS) {
    const int rr = idx / (HP / 4), d = (idx % (HP / 4)) * 4;
    const int r = r0 + rr;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows && d < HD)
      val = scale4(load4(x + (r / G) * st + (r % G) * sg + d), mul);
    store4(dst + rr * LD + d, val);
  }
}

// Keys k0 .. k0+BK of (B, Tk, KV, hd)-strided x, already offset to its
// batch and KV head, into (BK, HP + 4) fp32 shared memory; keys past Tk
// and columns past HD are zeros.
template <int HD>
__device__ __forceinline__ void load_keys(float* dst, const float* x,
                                          long long st, int k0, int Tk) {
  constexpr int HP = pad64(HD), LD = HP + 4;
  for (int idx = threadIdx.x; idx < BK * (HP / 4); idx += THREADS) {
    const int jj = idx / (HP / 4), d = (idx % (HP / 4)) * 4;
    const int j = k0 + jj;
    store4(dst + jj * LD + d, j < Tk && d < HD
                                  ? load4(x + j * st + d)
                                  : make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// The index of row r (= t*G + g) of KV head kv of batch b in contiguous
// (B, Tq, KV, G).
__device__ __forceinline__ long long row_index(int b, int kv, int r, int Tq,
                                               int KV, int G) {
  return (((long long)b * Tq + r / G) * KV + kv) * G + r % G;
}

// ---- the bf16 path: Hopper's tensor cores through wgmma (sm_90a) ---------
//
// A tile of R rows by HD bf16 columns lives in shared memory as HP/64
// column blocks of (R, 64) in hopper.cuh's 128-byte swizzled layout (the
// columns past HD zeros), so
// one layout serves both ways of reading it: K-major (hd as the k
// dimension: Q.K^T and its kin) and N-major (the rows as the k dimension:
// P.V and its kin, wgmma's transposed B).

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Rows r0 .. r0+R (row r = t*G + g) of (B, Tq, KV, G, hd)-strided x,
// already offset to its batch and KV head, into the swizzled (R, HD) tile
// at dst (HP columns), by NT threads with cp.async; rows past nrows and
// columns past HD are zeros.
template <int R, int HD, int NT>
__device__ __forceinline__ void cp_rows(uint32_t dst, const bf16* x,
                                        long long st, long long sg, int r0,
                                        int nrows, int G) {
  constexpr int CH = pad64(HD) / 8;  // 16-byte chunks a tile row
  static_assert(R * CH % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < R * CH / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int rr = idx / CH, c = idx % CH, r = r0 + rr;
    const bool ok = r < nrows && c < HD / 8;
    const bf16* src = ok ? x + (r / G) * st + (r % G) * sg + c * 8 : x;
    cp_async16(dst + sw128<R>(rr, c), src, ok);
  }
}

// Keys k0 .. k0+R of (B, Tk, KV, hd)-strided x, already offset to its
// batch and KV head, into the swizzled (R, HD) tile at dst (HP columns);
// keys past Tk and columns past HD are zeros.
template <int R, int HD, int NT>
__device__ __forceinline__ void cp_keys(uint32_t dst, const bf16* x,
                                        long long st, int k0, int Tk) {
  constexpr int CH = pad64(HD) / 8;
  static_assert(R * CH % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < R * CH / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int jj = idx / CH, c = idx % CH, j = k0 + jj;
    const bool ok = j < Tk && c < HD / 8;
    cp_async16(dst + sw128<R>(jj, c), ok ? x + j * st + c * 8 : x, ok);
  }
}

// N-major (transposed B): rows 16kk .. 16kk+15 of an (R, HD) tile as the k
// dimension, its HD columns as n (column blocks R * 128 bytes apart).
template <int R>
__device__ __forceinline__ uint64_t desc_n(uint32_t tile, int kk) {
  return desc_b128(tile + kk * 2048, R * 128, 1024);
}

// d (64 x 64, fp32) += A (64 x 16) . B (16 x 64), both bf16 in shared memory
// through their descriptors, B K-major; d is zeroed first unless accumulate.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 fragments in registers) . B (16 x
// 64), B bf16 in shared memory, N-major (transposed: its rows are the k
// dimension).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, bf16 fragments in registers) . B (16 x
// 128), B bf16 in shared memory, N-major (transposed: its rows are the k
// dimension).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 192, fp32) += A (64 x 16, bf16 fragments in registers) . B (16 x
// 192), B bf16 in shared memory, N-major (transposed: its rows are the k
// dimension; its three 64-column blocks one descriptor stride apart).
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x HP) += A . B with A in registers: m64n64k16, m64n128k16 or
// m64n192k16, one instruction whatever the width
template <int HP>
__device__ __forceinline__ void wgmma_rs(float (&d)[HP / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  static_assert(HP == 64 || HP == 128 || HP == 192,
                "a tile is 64, 128 or 192 columns wide");
  if constexpr (HP == 64) wgmma_rs_n64(d, a, b);
  else if constexpr (HP == 128) wgmma_rs_n128(d, a, b);
  else wgmma_rs_n192(d, a, b);
}

// The accumulator of an m64nN wgmma: thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 + 8 h (h = 0, 1) and columns 8 j + 2 (t % 4) +
// c (c = 0, 1) at d[4 j + 2 h + c].  The A fragment of the 16 columns
// 16 kk .. 16 kk + 15 is d[8 kk .. 8 kk + 7] in pairs: the layout lines up,
// so an accumulator becomes the next product's A without moving.

// x0, x1 -> hi = bf16(x), lo = bf16(x - hi), each as a bf16 pair (x0 in
// the low half); hi + lo carries x to about 2^-16 of its value
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
// columns 16 kk .. 16 kk + 15 of a (64, N) fp32 accumulator as two bf16 A
// operands, hi and lo
template <int NA>
__device__ __forceinline__ void split_frag(const float (&d)[NA], int kk,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split2(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1], hi[i], lo[i]);
}

// two fp32 values as a bf16 pair, rounded to nearest even
__device__ __forceinline__ void store2(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

}  // namespace
