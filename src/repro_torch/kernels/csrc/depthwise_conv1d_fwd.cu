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
// 0.113 ms at 3.35 TB/s; no tensor-core form has a place here.
//
// Design (simple and right first):
//   * one block per (column tile of TQ columns, channel tile of CB
//     channels, sample); BLOCK = TQ threads run along the width, one
//     column each, so every global load and store of a row coalesces;
//   * the tile's footprint x[n, c-tile, q0 : q0+TQ+(S-1)d] is staged in
//     shared memory once (as fp32) and read by all S taps;
//   * per channel the S taps and the bias are read into registers (one
//     broadcast load each), then the thread sums its column with fmaf in
//     tap order s = 0..S-1 and applies the epilogue on the accumulator;
//   * the ragged width edge is masked in the kernel (staged as zeros past
//     Wp, no store past Q): no round-up of the width to a tile;
//   * at most MAX_TAPS taps (registers); any dilation whose footprint fits
//     in shared memory (opt-in up to 227 KiB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;               // threads per block
constexpr int TQ = BLOCK;                // output columns per block
constexpr int CB = 8;                    // channels per block
constexpr int MAX_TAPS = 8;              // taps kept in registers
constexpr int SMEM_BUDGET = 48 * 1024;   // default shared memory per block
constexpr int SMEM_MAX = 232448;         // Hopper's per-block opt-in limit

constexpr int ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3;
constexpr int DT_F32 = 0;                // dtype codes: 0 fp32, 1 bf16
constexpr int ERR_FOOTPRINT = -1;        // the footprint does not fit
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

template <typename T, typename OutT>
__global__ void __launch_bounds__(BLOCK)
dw_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const T* __restrict__ bias, const T* __restrict__ residual,
              OutT* __restrict__ out, float* __restrict__ preact, int C,
              int S, int Wp, int Q, int dilation, int act) {
  extern __shared__ float xs[];  // (CB, F)
  const int F = TQ + (S - 1) * dilation;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TQ;
  const int c0 = blockIdx.y * CB;
  const int n = blockIdx.z;
  const int cb = min(CB, C - c0);

  for (int ci = 0; ci < cb; ++ci) {
    const T* row = x + ((long long)n * C + c0 + ci) * Wp;
    for (int j = tid; j < F; j += BLOCK) {
      const int col = q0 + j;
      xs[ci * F + j] = col < Wp ? to_f32(row[col]) : 0.f;
    }
  }
  __syncthreads();

  const int q = q0 + tid;
  if (q >= Q) return;
  for (int ci = 0; ci < cb; ++ci) {
    const int c = c0 + ci;
    float wr[MAX_TAPS];
#pragma unroll
    for (int s = 0; s < MAX_TAPS; ++s)
      wr[s] = s < S ? to_f32(w[(long long)s * C + c]) : 0.f;
    const float* xr = xs + ci * F + tid;
    float acc = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_TAPS; ++s)
      if (s < S) acc = fmaf(wr[s], xr[s * dilation], acc);

    const long long o = ((long long)n * C + c) * Q + q;
    float u = acc;
    if (bias != nullptr) u += to_f32(bias[c]);
    if (residual != nullptr) u += to_f32(residual[o]);
    if (preact != nullptr) preact[o] = u;
    out[o] = from_f32<OutT>(activate(u, act));
  }
}

size_t smem_bytes(int S, int dilation) {
  return sizeof(float) * size_t(CB) * (size_t(TQ) + size_t(S - 1) * dilation);
}

template <typename T, typename OutT>
int launch(const void* x, const void* w, const void* bias,
           const void* residual, void* out, float* preact, int N, int C,
           int S, int Wp, int dilation, int act, cudaStream_t stream) {
  const size_t smem = smem_bytes(S, dilation);
  auto kernel = dw_fwd_kernel<T, OutT>;
  if (smem > SMEM_BUDGET) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const int Q = Wp - (S - 1) * dilation;
  const dim3 grid((Q + TQ - 1) / TQ, (C + CB - 1) / CB, N);
  kernel<<<grid, BLOCK, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<const T*>(residual),
      static_cast<OutT*>(out), preact, C, S, Wp, Q, dilation, act);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` of GPU `device` and returns cudaGetLastError()
// after the launch (0 on success), or a negative code for a shape the
// kernel does not take: -1 the footprint does not fit in shared memory,
// -2 more than MAX_TAPS taps, -3 a batch beyond the grid's limit 65535.
// dtype / out_dtype: 0 = fp32, 1 = bf16.  bias, residual and preact
// (fp32) may be null.
int depthwise_conv1d_fwd(const void* x, const void* w, const void* bias,
                         const void* residual, void* out, void* preact,
                         int N, int C, int S, int Wp, int dilation, int act,
                         int dtype, int out_dtype, int device, void* stream) {
  if (S > MAX_TAPS) return ERR_TAPS;
  if (N > 65535) return ERR_SHAPE;
  if (smem_bytes(S, dilation) > size_t(SMEM_MAX)) return ERR_FOOTPRINT;
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
