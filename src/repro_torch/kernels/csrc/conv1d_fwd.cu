// conv1d_fwd — the BRGEMM dilated conv1d forward with its fused epilogue,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/conv1d_brgemm.py:conv1d_fwd
// (bodies _fwd_kernel and _fwd_kernel_pipe; epilogue _epilogue_on_acc).
//
//   out[n,k,q] = act( sum_s sum_c w[s,k,c] * x[n,c,q+s*d] + bias[k]
//                     + residual[n,k,q] )
//
//   x (N, C, Wp) already padded by the caller, Wp = Q + (S-1)*d
//   w (S, K, C), bias (K,), residual (N, K, Q), out (N, K, Q)
//   x, w, bias, residual share one dtype (fp32 or bf16); out is fp32 or
//   bf16.  Sums and the epilogue run in fp32; out is cast once, at its store.
//   preact (N, K, Q) fp32, optional (the Pallas kernel's save_preact): the
//   pre-activation conv + bias + residual, stored beside out for the
//   gelu/silu gradient.
//
// The same kernel is the data gradient (Alg. 3): the caller passes the
// cotangent zero-padded by the span on both sides as x and the flipped
// taps with K and C swapped, w[::-1].transpose(0, 2, 1), as w.
//
// Bound.  At the AtacWorks shapes (C=K=15, S=51, d=8) a layer does
// 2*C*S = 1530 flops per output element against a few bytes of traffic, so
// in plain fp32 (no tensor cores) it is bound by fp32 FMA throughput, not
// by memory.
//
// Design (simple and right first):
//   * one block per (output-column tile of TQ columns, filter tile of KT
//     filters, sample); BLOCK threads, each owning CPT columns strided by
//     BLOCK and all KT filters, so every thread keeps CPT*KT fp32
//     accumulators in registers (KT = 1 for K = 1, else 8, the tile past K
//     masked);
//   * the dilated footprint x[n, c-chunk, q0 : q0+TQ+(S-1)d] is staged in
//     shared memory ONCE and read by all S taps (the paper's BRGEMM reuse,
//     what the Pallas _overlap_spec does in VMEM); the weight tile of the
//     same channel chunk is staged beside it as (S, CC, KT), zero-filled
//     past K;
//   * channels are walked in chunks of CC so shared memory stays within a
//     48 KiB budget for any C and span (one channel row may opt in to more;
//     a row that cannot fit even in 227 KiB is refused);
//   * the epilogue (bias, residual, activation, cast) runs in registers
//     before one masked store: the kernel masks its own ragged edge, no
//     width round-up;
//   * plain fp32 FMA, no TF32, no tensor cores.
//
// Summation order.  Every output element is summed as: channel chunks in
// order, inside a chunk taps s = 0..S-1, inside a tap channels in order, one
// fmaf each.  CC depends only on (C, S, span, KT) — never on the column's
// position, on Q, on N or on the tile — so a streamed chunk and a one-shot
// pass give bitwise equal outputs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 128;                // threads per block
constexpr int CPT = 2;                    // output columns per thread
constexpr int TQ = BLOCK * CPT;           // output columns per block
constexpr int SMEM_BUDGET = 48 * 1024;    // default shared memory per block
constexpr int SMEM_MAX = 232448;          // Hopper's per-block opt-in limit

constexpr int ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3;
constexpr int DT_F32 = 0;                 // dtype codes: 0 fp32, 1 bf16
constexpr int ERR_FOOTPRINT = -1;         // one channel row does not fit

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

// Same formulas as repro_torch/kernels/epilogue.py (gelu: tanh form).
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

// Floats of the staged footprint, rounded up so the weight tile after it
// starts 16-byte aligned.
__host__ __device__ __forceinline__ int xs_floats(int cc, int F) {
  return (cc * F + 3) & ~3;
}

__host__ __forceinline__ size_t smem_bytes(int cc, int F, int S, int KT) {
  return sizeof(float) * (size_t(xs_floats(cc, F)) + size_t(S) * cc * KT);
}

// Largest channel chunk whose footprint + weight tile fit the budget; 1 if
// only one channel row fits (with the opt-in); 0 if not even that.
__host__ int channel_chunk(int C, int S, int span, int KT) {
  const int F = TQ + span;
  for (int cc = C; cc >= 1; --cc)
    if (smem_bytes(cc, F, S, KT) <= SMEM_BUDGET) return cc;
  return smem_bytes(1, F, S, KT) <= SMEM_MAX ? 1 : 0;
}

template <typename T, typename OutT, int KT>
__global__ void __launch_bounds__(BLOCK)
conv1d_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ bias, const T* __restrict__ residual,
                  OutT* __restrict__ out, float* __restrict__ preact, int C,
                  int K, int S, int Wp, int Q, int dilation, int cc_max,
                  int act) {
  extern __shared__ __align__(16) float smem[];
  const int F = TQ + (S - 1) * dilation;
  float* xs = smem;                           // (cc_max, F)
  float* ws = smem + xs_floats(cc_max, F);    // (S, cc_max, KT)

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TQ;
  const int k0 = blockIdx.y * KT;
  const int n = blockIdx.z;
  const T* xn = x + (long long)n * C * Wp;

  float acc[CPT][KT];
#pragma unroll
  for (int j = 0; j < CPT; ++j)
#pragma unroll
    for (int k = 0; k < KT; ++k) acc[j][k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += cc_max) {
    const int cc = min(cc_max, C - c0);
    __syncthreads();  // the previous chunk's readers are done with smem
    for (int c = 0; c < cc; ++c) {
      const T* row = xn + (long long)(c0 + c) * Wp;
      for (int j = tid; j < F; j += BLOCK) {
        const int col = q0 + j;
        xs[c * F + j] = col < Wp ? to_f32(row[col]) : 0.f;
      }
    }
    for (int i = tid; i < S * cc * KT; i += BLOCK) {
      const int k = i % KT;
      const int c = (i / KT) % cc;
      const int s = i / (KT * cc);
      float v = 0.f;
      if (k0 + k < K) v = to_f32(w[((long long)s * K + k0 + k) * C + c0 + c]);
      ws[(s * cc_max + c) * KT + k] = v;
    }
    __syncthreads();

    for (int s = 0; s < S; ++s) {
      const float* xr = xs + s * dilation + tid;
      const float* wr = ws + s * cc_max * KT;
      for (int c = 0; c < cc; ++c) {
        float xv[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) xv[j] = xr[c * F + j * BLOCK];
        float wv[KT];
        if constexpr (KT % 4 == 0) {
          const float4* w4 = reinterpret_cast<const float4*>(wr + c * KT);
#pragma unroll
          for (int k4 = 0; k4 < KT / 4; ++k4) {
            const float4 v = w4[k4];
            wv[4 * k4] = v.x;
            wv[4 * k4 + 1] = v.y;
            wv[4 * k4 + 2] = v.z;
            wv[4 * k4 + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int k = 0; k < KT; ++k) wv[k] = wr[c * KT + k];
        }
#pragma unroll
        for (int k = 0; k < KT; ++k)
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            acc[j][k] = fmaf(wv[k], xv[j], acc[j][k]);
      }
    }
  }

  // Fused epilogue on the fp32 accumulators: act(acc + bias + residual).
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int q = q0 + tid + j * BLOCK;
    if (q >= Q) continue;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      if (k0 + k >= K) continue;
      const long long o = ((long long)n * K + k0 + k) * Q + q;
      float u = acc[j][k];
      if (bias != nullptr) u += to_f32(bias[k0 + k]);
      if (residual != nullptr) u += to_f32(residual[o]);
      if (preact != nullptr) preact[o] = u;
      out[o] = from_f32<OutT>(activate(u, act));
    }
  }
}

template <typename T, typename OutT, int KT>
int launch(const void* x, const void* w, const void* bias,
           const void* residual, void* out, float* preact, int N, int C,
           int K, int S, int Wp, int dilation, int act, cudaStream_t stream) {
  const int span = (S - 1) * dilation;
  const int Q = Wp - span;
  const int cc = channel_chunk(C, S, span, KT);
  if (cc == 0) return ERR_FOOTPRINT;
  const size_t smem = smem_bytes(cc, TQ + span, S, KT);
  auto kernel = conv1d_fwd_kernel<T, OutT, KT>;
  if (smem > SMEM_BUDGET) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const dim3 grid((Q + TQ - 1) / TQ, (K + KT - 1) / KT, N);
  kernel<<<grid, BLOCK, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<const T*>(residual),
      static_cast<OutT*>(out), preact, C, K, S, Wp, Q, dilation, cc, act);
  return int(cudaGetLastError());
}

// Filter-tile width: 1 for the K=1 heads, else 8 (K=15 and K=16 take two
// tiles; the second is masked past K).
int filter_tile(int K) { return K == 1 ? 1 : 8; }

template <typename T, typename OutT>
int launch_kt(int K, const void* x, const void* w, const void* bias,
              const void* residual, void* out, float* preact, int N, int C,
              int S, int Wp, int dilation, int act, cudaStream_t stream) {
  if (filter_tile(K) == 1)
    return launch<T, OutT, 1>(x, w, bias, residual, out, preact, N, C, K, S,
                              Wp, dilation, act, stream);
  return launch<T, OutT, 8>(x, w, bias, residual, out, preact, N, C, K, S,
                            Wp, dilation, act, stream);
}

}  // namespace

extern "C" {

// Launches on `stream` of GPU `device` and returns cudaGetLastError()
// after the launch (0 on success), or -1 when the footprint cannot fit in
// shared memory.  dtype / out_dtype: 0 = fp32, 1 = bf16.  bias, residual
// and preact (fp32) may be null.
int conv1d_fwd(const void* x, const void* w, const void* bias,
               const void* residual, void* out, void* preact, int N, int C,
               int K, int S, int Wp, int dilation, int act, int dtype,
               int out_dtype, int device, void* stream) {
  // this library links its own CUDA runtime: select the tensors' GPU in it
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pre = static_cast<float*>(preact);
  if (dtype == DT_F32 && out_dtype == DT_F32)
    return launch_kt<float, float>(K, x, w, bias, residual, out, pre, N, C,
                                   S, Wp, dilation, act, st);
  if (dtype == DT_F32)
    return launch_kt<float, __nv_bfloat16>(K, x, w, bias, residual, out, pre,
                                           N, C, S, Wp, dilation, act, st);
  if (out_dtype == DT_F32)
    return launch_kt<__nv_bfloat16, float>(K, x, w, bias, residual, out, pre,
                                           N, C, S, Wp, dilation, act, st);
  return launch_kt<__nv_bfloat16, __nv_bfloat16>(
      K, x, w, bias, residual, out, pre, N, C, S, Wp, dilation, act, st);
}

const char* conv1d_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
