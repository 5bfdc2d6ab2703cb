// depthwise_conv1d_bwd_weight — the depthwise (grouped, C == K) dilated
// conv1d weight gradient with the bias gradient fused, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/conv1d_brgemm.py:
// depthwise_conv1d_bwd_weight (bodies _dw_bwd_w_kernel and
// _dw_bwd_w_kernel_pipe).
//
//   dw[s,c]  = sum_n sum_q g[n,c,q] * x[n,c,q+s*d]          (S, C) fp32
//   dbias[c] = sum_n sum_q g[n,c,q]                         (C,)   fp32
//
//   x (N, C, Wp) is the forward's padded input, Wp = Q + (S-1)*d; g
//   (N, C, Q) is the cotangent of the pre-activation.  x and g each come
//   in their own dtype (fp32 or bf16), as the Pallas body casts each to
//   fp32 inside the kernel: the Mamba2 layer's bf16 input is never copied
//   to fp32 to meet its fp32 cotangent.  Every sum runs in fp32.
//
// Bound.  Each channel is a reduction over N*Q columns (16,384 at batch
// 8 x 2,048) with 2*S + 1 flops per column against 2 + 4 bytes read: the
// pass is memory-bound, 75.6 + 151.0 MB in 0.068 ms at 3.35 TB/s for a
// Mamba2 layer (C = 2304, S = 4).
//
// Design (simple and right first):
//   * The TPU kernel carries the (S, C) gradient block in VMEM across a
//     sequential grid over the batch and the width.  Blocks on Hopper run
//     in no order, so this is a split reduction with no atomics, as in
//     conv1d_bwd_weight.cu.  Pass 1 (dw_bwd_weight_partial): one block per
//     (column range of at most RQ columns, channel tile of WARPS channels,
//     sample); one warp per channel walks the range with its 32 lanes on
//     neighbouring columns (coalesced loads), keeping S + 1 fp32 sums in
//     registers, then adds them across the warp with a fixed butterfly of
//     shuffles and writes one row of `partial` per (sample, column range)
//     into scratch the wrapper allocates.  Pass 2 (dw_reduce_partials):
//     one thread per output element sums the rows in the fixed order
//     0..P-1.  Two launches on the same inputs on the same card give
//     bitwise equal dw and dbias.
//   * x[n, c, q + s*d] is read straight from global memory: the S taps of
//     neighbouring lanes overlap, so after the first tap the reads hit L1.
//   * The ragged edge: a lane past the range's end does nothing; there is
//     no width round-up.
//   * at most MAX_TAPS taps (registers); any dilation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;                 // channels per block, one warp each
constexpr int BLOCK = 32 * WARPS;        // threads per block
constexpr int RQ = 2048;                 // columns per range (pass 1 block)
constexpr int MAX_TAPS = 8;              // taps kept in registers
constexpr int RBLOCK = 256;              // threads per block of pass 2
constexpr int DT_F32 = 0;                // dtype codes: 0 fp32, 1 bf16
constexpr int ERR_TAPS = -2;             // more than MAX_TAPS taps
constexpr int ERR_SHAPE = -3;            // batch beyond the grid's limit

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

int ranges(int Q) { return (Q + RQ - 1) / RQ; }

template <typename TX, typename TG>
__global__ void __launch_bounds__(BLOCK)
dw_bwd_weight_partial(const TX* __restrict__ x, const TG* __restrict__ g,
                      float* __restrict__ partial, int C, int S, int Wp,
                      int Q, int dilation, int row_len, int with_dbias) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.y * WARPS + (threadIdx.x >> 5);
  const int part = blockIdx.x;
  const int n = blockIdx.z;
  if (c >= C) return;  // whole warps only: no shuffle loses a partner
  const TX* xr = x + ((long long)n * C + c) * Wp;
  const TG* gr = g + ((long long)n * C + c) * Q;
  const int q_end = min(Q, (part + 1) * RQ);

  float acc[MAX_TAPS];
#pragma unroll
  for (int s = 0; s < MAX_TAPS; ++s) acc[s] = 0.f;
  float db = 0.f;
#pragma unroll 4
  for (int q = part * RQ + lane; q < q_end; q += 32) {
    const float gv = to_f32(gr[q]);
    db += gv;
#pragma unroll
    for (int s = 0; s < MAX_TAPS; ++s)
      if (s < S) acc[s] = fmaf(gv, to_f32(xr[q + s * dilation]), acc[s]);
  }

  float* row = partial + (long long)(n * gridDim.x + part) * row_len;
#pragma unroll
  for (int s = 0; s < MAX_TAPS; ++s) {
    if (s >= S) break;
    const float v = warp_sum(acc[s]);
    if (lane == 0) row[(long long)s * C + c] = v;
  }
  if (with_dbias) {
    const float v = warp_sum(db);
    if (lane == 0) row[(long long)S * C + c] = v;
  }
}

// out[o] = sum_{p=0..P-1} partial[p][o], in that order; o < n_dw goes to
// dw, the rest to dbias.
__global__ void __launch_bounds__(RBLOCK)
dw_reduce_partials(const float* __restrict__ partial, float* __restrict__ dw,
                   float* __restrict__ dbias, int P, int row_len, int n_dw) {
  const int o = blockIdx.x * RBLOCK + threadIdx.x;
  if (o >= row_len) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += partial[(long long)p * row_len + o];
  if (o < n_dw)
    dw[o] = s;
  else
    dbias[o - n_dw] = s;
}

template <typename TX, typename TG>
int launch(const void* x, const void* g, float* partial, float* dw,
           float* dbias, int N, int C, int S, int Wp, int dilation,
           cudaStream_t stream) {
  const int Q = Wp - (S - 1) * dilation;
  const int n_dw = S * C;
  const int row_len = n_dw + (dbias != nullptr ? C : 0);
  const dim3 grid(ranges(Q), (C + WARPS - 1) / WARPS, N);
  dw_bwd_weight_partial<TX, TG><<<grid, BLOCK, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TG*>(g), partial, C, S,
      Wp, Q, dilation, row_len, dbias != nullptr);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  dw_reduce_partials<<<(row_len + RBLOCK - 1) / RBLOCK, RBLOCK, 0, stream>>>(
      partial, dw, dbias, N * ranges(Q), row_len, n_dw);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows of fp32 partial sums depthwise_conv1d_bwd_weight needs as scratch,
// each S*C (+C with dbias) long: one per (sample, column range).
int depthwise_conv1d_bwd_weight_rows(int N, int Q) { return N * ranges(Q); }

// Launches both passes on `stream` of GPU `device` and returns
// cudaGetLastError() after them (0 on success), or a negative code for a
// shape the kernel does not take: -2 more than MAX_TAPS taps, -3 a batch
// beyond the grid's limit 65535.  x_dtype / g_dtype: 0 = fp32, 1 = bf16.
// dbias may be null (then no bias gradient is summed).  `partial` holds
// depthwise_conv1d_bwd_weight_rows(N, Q) rows.
int depthwise_conv1d_bwd_weight(const void* x, const void* g, void* partial,
                                void* dw, void* dbias, int N, int C, int S,
                                int Wp, int dilation, int x_dtype,
                                int g_dtype, int device, void* stream) {
  if (S > MAX_TAPS) return ERR_TAPS;
  if (N > 65535) return ERR_SHAPE;
  // this library links its own CUDA runtime: select the tensors' GPU in it
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* w = static_cast<float*>(dw);
  float* b = static_cast<float*>(dbias);
  if (x_dtype == DT_F32 && g_dtype == DT_F32)
    return launch<float, float>(x, g, part, w, b, N, C, S, Wp, dilation, st);
  if (x_dtype == DT_F32)
    return launch<float, __nv_bfloat16>(x, g, part, w, b, N, C, S, Wp,
                                        dilation, st);
  if (g_dtype == DT_F32)
    return launch<__nv_bfloat16, float>(x, g, part, w, b, N, C, S, Wp,
                                        dilation, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(x, g, part, w, b, N, C, S, Wp,
                                              dilation, st);
}

const char* depthwise_conv1d_bwd_weight_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
