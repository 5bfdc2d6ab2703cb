// depthwise_conv1d_fwd — the depthwise (grouped, C == K) dilated conv1d
// forward with its fused epilogue, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/conv1d_brgemm.py:
// depthwise_conv1d_fwd (bodies _dw_fwd_kernel and _dw_fwd_kernel_pipe;
// epilogue _epilogue_on_acc).
//
//   out[n,c,q] = act( sum_s w[s,c] * x[n,c,q+s*d] + bias[c]
//                     + residual[n,c,q] )
//
//   x (N, C, Wp) already padded by the caller, Wp = Q + (S-1)*d
//   w (S, C), bias (C,), residual (N, C, Q), out (N, C, Q)
//   x, w, bias, residual share one dtype (fp32 or bf16); out is fp32 or
//   bf16.  Sums and the epilogue run in fp32; out is cast once, at its
//   store.  preact (N, C, Q) fp32, optional: the pre-activation
//   conv + bias + residual, stored beside out for the gelu/silu gradient.
//
// The same kernel is the data gradient: the caller passes the cotangent
// zero-padded by the span on both sides as x and the flipped taps
// w[::-1] as w (no transpose: each channel is its own filter).
//
// Bound.  A Mamba2 layer (C = 2304, S = 4) does 2*S = 8 flops per output
// element against 2 + 4 (+ 4 with preact) bytes moved: memory-bound by
// far.  At batch 8 x 2,048 the forward moves 75.6 MB in and 302 MB out,
// 0.113 ms at the H100 SXM's published 3.35 TB/s (700 W); no tensor-core
// form has a place here.
//
// Design (a 16-byte memory path):
//   * one thread computes V = 8 consecutive outputs of one channel row:
//     one 16-byte load of bf16 input, one 16-byte store of bf16 output or
//     two of fp32 (out and preact alike).  A block is BLOCK threads along
//     one row; nothing goes through shared memory;
//   * the rows are not 16-byte aligned (Wp = 2,051 forward and 2,054
//     bwd-data in the Mamba2 layer): a thread loads the aligned 16-byte
//     chunks that cover its inputs and shifts them into place in registers
//     by the row's misalignment (uniform over the row, so the shift is a
//     branch the whole warp takes).  Its outputs are anchored to the
//     output row's 16-byte grid, so every full group of V stores 16 bytes
//     at a time; the first and last group of a misaligned row store
//     element by element;
//   * dilation 1 (the Mamba2 conv and its bwd-data): the (S-1)-column halo
//     comes in the same chunks, up to 3 (bf16) or 5 (fp32) independent
//     16-byte loads a thread, all issued before the first use; the
//     neighbouring threads' overlapping chunks hit L1.  Any other dilation
//     loads each tap's chunks apart (they hit L1 and L2 for the taps that
//     neighbouring threads and blocks share), so there is no footprint
//     limit;
//   * the S taps and the bias sit in registers; each output is summed with
//     fmaf in tap order s = 0..S-1, then bias, residual, preact,
//     activation and one cast, per element;
//   * the ragged width edge is masked in the kernel: no round-up of the
//     width to a tile;
//   * at most MAX_TAPS taps (registers).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLOCK = 128;               // threads per block, along a row
constexpr int V = 8;                     // outputs a thread
constexpr int TQ = BLOCK * V;            // outputs a block
constexpr int MAX_TAPS = 8;              // taps kept in registers

constexpr int ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3;
constexpr int DT_F32 = 0;                // dtype codes: 0 fp32, 1 bf16
constexpr int ERR_TAPS = -2;             // more than MAX_TAPS taps
constexpr int ERR_SHAPE = -3;            // batch beyond the grid's limit

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// Same formulas as repro_torch/kernels/epilogue.py (gelu: tanh form) and
// conv1d_fwd.cu.
__device__ __forceinline__ float activate(float u, int act) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(u, 0.f);
    case ACT_GELU: {
      const float k0 = 0.7978845608028654f;  // sqrt(2/pi)
      const float k1 = 0.044715f;
      return 0.5f * u * (1.f + tanhf(k0 * (u + k1 * u * u * u)));
    }
    case ACT_SILU:
      return u / (1.f + expf(-u));
    case ACT_NONE:
    default:
      return u;
  }
}

// Elements of T in 16 bytes, and a pointer's offset past the 16-byte grid.
template <typename T> __host__ __device__ constexpr int epc() {
  return 16 / int(sizeof(T));
}
template <typename T> __device__ __forceinline__ int misalign(const T* p) {
  return int(reinterpret_cast<uintptr_t>(p) & 15) / int(sizeof(T));
}

__device__ __forceinline__ void unpack(float* v, uint4 r, const float*) {
  v[0] = __uint_as_float(r.x);
  v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z);
  v[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(float* v, uint4 r,
                                       const __nv_bfloat16*) {
  const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little-endian: element 2i in the low half
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// v <- row[e0 - a .. e0 - a + NCH*E) as fp32, from NCH aligned 16-byte
// chunks (row + e0 - a is 16-byte aligned), then shifted left by a so
// that v[i] = row[e0 + i].  Chunks past the first `need` values or wholly
// outside the row [0, Wp) are not loaded (zeros); a loaded chunk lies in
// the 16 bytes around a row element, so it never leaves the allocation.
// a is uniform over a row: the shifts are branches the warp takes
// together.
template <typename T, int NCH>
__device__ __forceinline__ void load_window(float (&v)[NCH * epc<T>()],
                                            const T* __restrict__ row, int e0,
                                            int Wp, int need) {
  constexpr int E = epc<T>();
  const int a = misalign(row + e0);
  const int base = e0 - a;
  uint4 raw[NCH];
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int e = base + i * E;
    raw[i] = make_uint4(0u, 0u, 0u, 0u);
    if (i * E < a + need && e < Wp && e + E > 0)
      raw[i] = __ldg(reinterpret_cast<const uint4*>(row + e));
  }
#pragma unroll
  for (int i = 0; i < NCH; ++i) unpack(v + i * E, raw[i], row);
  if (E >= 8 && (a & 4)) {
#pragma unroll
    for (int i = 0; i + 4 < NCH * E; ++i) v[i] = v[i + 4];
  }
  if (E >= 4 && (a & 2)) {
#pragma unroll
    for (int i = 0; i + 2 < NCH * E; ++i) v[i] = v[i + 2];
  }
  if (a & 1) {
#pragma unroll
    for (int i = 0; i + 1 < NCH * E; ++i) v[i] = v[i + 1];
  }
}

// V values of a row at element q: 16 bytes at a time where they lie in
// [0, n) and start on the 16-byte grid, else element by element.
template <typename T>
__device__ __forceinline__ void load_v(float (&v)[V], const T* __restrict__ p,
                                       int q, int n) {
  if (q >= 0 && q + V <= n && misalign(p + q) == 0) {
#pragma unroll
    for (int h = 0; h < V / epc<T>(); ++h)
      unpack(v + h * epc<T>(),
             __ldg(reinterpret_cast<const uint4*>(p + q) + h), p);
    return;
  }
#pragma unroll
  for (int i = 0; i < V; ++i)
    v[i] = q + i >= 0 && q + i < n ? to_f32(p[q + i]) : 0.f;
}

__device__ __forceinline__ uint4 pack(const float* y, float*) {
  return make_uint4(__float_as_uint(y[0]), __float_as_uint(y[1]),
                    __float_as_uint(y[2]), __float_as_uint(y[3]));
}
__device__ __forceinline__ uint4 pack(const float* y, __nv_bfloat16*) {
  unsigned u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
    u[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// Store V values at element q of a row of n: 16 bytes at a time where
// the group lies in [0, n) and starts on the 16-byte grid, else element by
// element (the first and last group of a misaligned row).
template <typename T>
__device__ __forceinline__ void store_v(T* __restrict__ p, int q, int n,
                                        const float (&y)[V]) {
  if (q >= 0 && q + V <= n && misalign(p + q) == 0) {
#pragma unroll
    for (int h = 0; h < V / epc<T>(); ++h)
      reinterpret_cast<uint4*>(p + q)[h] = pack(y + h * epc<T>(), p);
    return;
  }
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (q + i >= 0 && q + i < n) p[q + i] = from_f32<T>(y[i]);
}

template <typename T, typename OutT>
__global__ void __launch_bounds__(BLOCK)
dw_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const T* __restrict__ bias, const T* __restrict__ residual,
              OutT* __restrict__ out, float* __restrict__ preact, int C,
              int S, int Wp, int Q, int dilation, int tiles, int act) {
  constexpr int E = epc<T>();
  const int c = blockIdx.x / tiles;
  const int tile = blockIdx.x - c * tiles;
  const long long row = (long long)blockIdx.y * C + c;
  OutT* orow = out + row * Q;
  // the thread's first output, on the output row's 16-byte grid
  const int q = (tile * BLOCK + threadIdx.x) * V - misalign(orow);
  if (q >= Q) return;
  const T* xrow = x + row * Wp;

  float wr[MAX_TAPS];
#pragma unroll
  for (int s = 0; s < MAX_TAPS; ++s)
    wr[s] = s < S ? to_f32(w[(long long)s * C + c]) : 0.f;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;

  if (dilation == 1) {
    // one window of V + S - 1 inputs for all taps
    constexpr int NCH = (E - 1 + V + MAX_TAPS - 1 + E - 1) / E;
    float v[NCH * E];
    load_window<T, NCH>(v, xrow, q, Wp, V + S - 1);
#pragma unroll
    for (int s = 0; s < MAX_TAPS; ++s)
      if (s < S)
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = fmaf(wr[s], v[i + s], acc[i]);
  } else {
    constexpr int NCH = (E - 1 + V + E - 1) / E;
#pragma unroll
    for (int s = 0; s < MAX_TAPS; ++s) {
      if (s < S) {
        float v[NCH * E];
        load_window<T, NCH>(v, xrow, q + s * dilation, Wp, V);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = fmaf(wr[s], v[i], acc[i]);
      }
    }
  }

  float u[V];
  const float b = bias != nullptr ? to_f32(bias[c]) : 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) u[i] = bias != nullptr ? acc[i] + b : acc[i];
  if (residual != nullptr) {
    float r[V];
    load_v(r, residual + row * Q, q, Q);
#pragma unroll
    for (int i = 0; i < V; ++i) u[i] += r[i];
  }
  if (preact != nullptr) store_v(preact + row * Q, q, Q, u);
  float y[V];
#pragma unroll
  for (int i = 0; i < V; ++i) y[i] = activate(u[i], act);
  store_v(orow, q, Q, y);
}

template <typename T, typename OutT>
int launch(const void* x, const void* w, const void* bias,
           const void* residual, void* out, float* preact, int N, int C,
           int S, int Wp, int dilation, int act, cudaStream_t stream) {
  const int Q = Wp - (S - 1) * dilation;
  // a misaligned output row shifts its groups left by up to 15 bytes
  const bool aligned = Q * sizeof(OutT) % 16 == 0 &&
                       (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int tiles = (Q + (aligned ? 0 : epc<OutT>() - 1) + TQ - 1) / TQ;
  if ((long long)tiles * C > 0x7fffffff) return ERR_SHAPE;
  const dim3 grid(tiles * C, N);
  dw_fwd_kernel<T, OutT><<<grid, BLOCK, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<const T*>(residual),
      static_cast<OutT*>(out), preact, C, S, Wp, Q, dilation, tiles, act);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` of GPU `device` and returns cudaGetLastError()
// after the launch (0 on success), or a negative code for a shape the
// kernel does not take: -2 more than MAX_TAPS taps, -3 a batch beyond the
// grid's limit 65535 (or more than 2^31 - 1 row tiles).  dtype /
// out_dtype: 0 = fp32, 1 = bf16.  bias, residual and preact (fp32) may be
// null.
int depthwise_conv1d_fwd(const void* x, const void* w, const void* bias,
                         const void* residual, void* out, void* preact,
                         int N, int C, int S, int Wp, int dilation, int act,
                         int dtype, int out_dtype, int device, void* stream) {
  if (S > MAX_TAPS) return ERR_TAPS;
  if (N > 65535) return ERR_SHAPE;
  // this library links its own CUDA runtime: select the tensors' GPU in it
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pre = static_cast<float*>(preact);
  if (dtype == DT_F32 && out_dtype == DT_F32)
    return launch<float, float>(x, w, bias, residual, out, pre, N, C, S, Wp,
                                dilation, act, st);
  if (dtype == DT_F32)
    return launch<float, __nv_bfloat16>(x, w, bias, residual, out, pre, N, C,
                                        S, Wp, dilation, act, st);
  if (out_dtype == DT_F32)
    return launch<__nv_bfloat16, float>(x, w, bias, residual, out, pre, N, C,
                                        S, Wp, dilation, act, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(x, w, bias, residual, out, pre,
                                              N, C, S, Wp, dilation, act, st);
}

const char* depthwise_conv1d_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
