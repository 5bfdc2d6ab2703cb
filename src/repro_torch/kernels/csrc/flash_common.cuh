// flash_common.cuh — what flash_fwd.cu and flash_bwd.cu share: the tile
// sizes, the dtype and error codes, 4-element fp32/bf16 loads and stores,
// and the strided loads of a row tile and a key tile into fp32 shared
// memory.  Included by both sources (build.py hashes it with them).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;           // query rows (position x group head) per tile
constexpr int BK = 64;           // keys per tile
constexpr int THREADS = 256;     // 16 x 16
constexpr int DT_F32 = 0;        // dtype codes: 0 fp32, 1 bf16
constexpr int ERR_HEAD_DIM = -1; // hd other than 64 or 128
constexpr int ERR_GRID = -2;     // B * KV beyond the grid's limit

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
// rounds to nearest even, as torch's .to(torch.bfloat16)
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float4 scale4(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

// Rows r0 .. r0+BM (row r = t*G + g) of (B, Tq, KV, G, hd)-strided x,
// already offset to its batch and KV head, into (BM, HD + 4) fp32 shared
// memory, times mul; rows past nrows are zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* x, long long st,
                                          long long sg, int r0, int nrows,
                                          int G, float mul) {
  constexpr int LD = HD + 4;
  for (int idx = threadIdx.x; idx < BM * (HD / 4); idx += THREADS) {
    const int rr = idx / (HD / 4), d = (idx % (HD / 4)) * 4;
    const int r = r0 + rr;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows) val = scale4(load4(x + (r / G) * st + (r % G) * sg + d), mul);
    store4(dst + rr * LD + d, val);
  }
}

// Keys k0 .. k0+BK of (B, Tk, KV, hd)-strided x, already offset to its
// batch and KV head, into (BK, HD + 4) fp32 shared memory; keys past Tk
// are zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_keys(float* dst, const T* x, long long st,
                                          int k0, int Tk) {
  constexpr int LD = HD + 4;
  for (int idx = threadIdx.x; idx < BK * (HD / 4); idx += THREADS) {
    const int jj = idx / (HD / 4), d = (idx % (HD / 4)) * 4;
    const int j = k0 + jj;
    store4(dst + jj * LD + d,
           j < Tk ? load4(x + j * st + d) : make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// The index of row r (= t*G + g) of KV head kv of batch b in contiguous
// (B, Tq, KV, G).
__device__ __forceinline__ long long row_index(int b, int kv, int r, int Tq,
                                               int KV, int G) {
  return (((long long)b * Tq + r / G) * KV + kv) * G + r % G;
}

}  // namespace
