// conv1d_bwd_weight — the BRGEMM dilated conv1d weight gradient (the
// paper's Algorithm 4) with the bias gradient fused, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/conv1d_brgemm.py:
// conv1d_bwd_weight (bodies _bwd_w_kernel and _bwd_w_kernel_pipe).
//
//   dw[s,k,c] = sum_n sum_q g[n,k,q] * x[n,c,q+s*d]        (S, K, C) fp32
//   dbias[k]  = sum_n sum_q g[n,k,q]                        (K,)      fp32
//
//   x (N, C, Wp) is the forward's padded input, Wp = Q + (S-1)*d; g
//   (N, K, Q) is the cotangent of the pre-activation.  x and g share one
//   dtype (fp32 or bf16); every sum runs in fp32.
//
// Bound.  At the AtacWorks shapes (C=K=15, S=51, d=8) the pass does
// 2*K*C*S = 22,950 flops per input column against 4*(C+K) bytes read, so
// in plain fp32 (no tensor cores) it is bound by fp32 FMA throughput.
//
// Design (simple and right first):
//   * The TPU kernel carries the (S, K, C) gradient block in VMEM across a
//     sequential grid over the batch and the width.  Blocks on Hopper run
//     in no order, so this is a split reduction with no atomics.  Pass 1
//     (bwd_weight_partial): one block per (column range, filter group x
//     pair chunk, sample); each writes its partial sums, one row of
//     `partial` per (sample, column range), into scratch the wrapper
//     allocates.  Pass 2 (reduce_partials): one thread per output element
//     sums the rows in the fixed order 0..P-1.  Two launches on the same
//     inputs on the same card give bitwise equal dw and dbias.
//   * Inside a block a loop over its column tiles takes the place of the
//     sequential grid.  Per tile of TQ columns the dilated footprint
//     x[n, :, q0 : q0+TQ+(S-1)d] is staged in shared memory once and read
//     by all S taps (what the Pallas _overlap_spec does in VMEM), beside
//     the cotangent tile g[n, k-group, q0 : q0+TQ] stored as (TQ, KT).
//   * Each thread owns UPT (tap, channel) pairs and the KT filters of its
//     block's group: UPT*KT fp32 accumulators in registers.  Per column it
//     reads KT cotangent values (one broadcast float4 per 4) and UPT input
//     values, and issues UPT*KT fmaf.  Footprint rows have an odd stride
//     so the channels of one tap fall in different banks.
//   * dbias is summed by KT threads of the first pair chunk from the
//     cotangent tile already in shared memory.
//   * The ragged width edge is masked in the kernel: g is staged as zeros
//     past Q and x past Wp; there is no width round-up.
//   * plain fp32 FMA, no TF32, no tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;               // threads per block
constexpr int UPT = 3;                   // (tap, channel) pairs per thread
constexpr int TQ = 128;                  // columns per tile
constexpr int SMEM_BUDGET = 48 * 1024;   // default shared memory per block
constexpr int SMEM_MAX = 232448;         // Hopper's per-block opt-in limit
constexpr int BLOCKS_PER_SM = 2;         // resident blocks the grid aims at
constexpr int DT_F32 = 0;                // dtype codes: 0 fp32, 1 bf16
constexpr int ERR_FOOTPRINT = -1;        // the footprint does not fit
constexpr int ERR_SHAPE = -2;            // batch beyond the grid's limit
constexpr int ERR_DEVICE = -3;           // the SM count cannot be read

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Plan of pass 1, shared by the host functions below.
struct Plan {
  int KT, kgroups, pchunks, ntiles, tiles_per_part, parts, stride;
  size_t smem;
};

// Row stride of the staged cotangent tile (TQ, KT): 4 floats of padding
// keep its float4 reads aligned and spread its transposing stores over 8
// banks instead of 2.
__host__ __device__ __forceinline__ constexpr int gs_stride(int KT) {
  return KT == 1 ? 1 : KT + 4;
}

// Row stride of the staged footprint: odd, so that the UPT pairs of
// neighbouring threads (consecutive channels of one tap) hit other banks.
__host__ __device__ __forceinline__ int row_stride(int span) {
  return (TQ + span) | 1;
}

// Floats of the staged footprint, rounded up so the cotangent tile after
// it starts 16-byte aligned.
__host__ __device__ __forceinline__ int xs_floats(int C, int stride) {
  return (C * stride + 3) & ~3;
}

int make_plan(int N, int C, int K, int S, int Wp, int dilation, int device,
              Plan* p) {
  const int span = (S - 1) * dilation;
  const int Q = Wp - span;
  if (N > 65535) return ERR_SHAPE;
  p->KT = K == 1 ? 1 : 16;
  p->kgroups = (K + p->KT - 1) / p->KT;
  p->pchunks = (S * C + BLOCK * UPT - 1) / (BLOCK * UPT);
  p->ntiles = (Q + TQ - 1) / TQ;
  p->stride = row_stride(span);
  p->smem = sizeof(float) * (size_t(xs_floats(C, p->stride)) +
                             size_t(TQ) * gs_stride(p->KT));
  if (p->smem > SMEM_MAX) return ERR_FOOTPRINT;
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return ERR_DEVICE;
  // enough column ranges that the grid fills the card about once
  const int per_part = p->kgroups * p->pchunks * N;
  const int want = (BLOCKS_PER_SM * sms + per_part - 1) / per_part;
  const int target = want < 1 ? 1 : (want > p->ntiles ? p->ntiles : want);
  p->tiles_per_part = (p->ntiles + target - 1) / target;
  p->parts = (p->ntiles + p->tiles_per_part - 1) / p->tiles_per_part;
  return 0;
}

template <typename T, int KT>
__global__ void __launch_bounds__(BLOCK, BLOCKS_PER_SM)
bwd_weight_partial(const T* __restrict__ x, const T* __restrict__ g,
                   float* __restrict__ partial, int C, int K, int S, int Wp,
                   int Q, int dilation, int stride, int ntiles,
                   int tiles_per_part, int pchunks, int row_len,
                   int with_dbias) {
  extern __shared__ __align__(16) float smem[];
  const int span = (S - 1) * dilation;
  const int F = TQ + span;
  float* xs = smem;                          // (C, stride)
  float* gs = smem + xs_floats(C, stride);   // (TQ, GS), GS >= KT
  constexpr int GS = gs_stride(KT);

  const int tid = threadIdx.x;
  const int part = blockIdx.x;
  const int kg = blockIdx.y / pchunks;
  const int pc = blockIdx.y % pchunks;
  const int n = blockIdx.z;
  const int k0 = kg * KT;
  const int pairs = S * C;
  const T* xn = x + (long long)n * C * Wp;
  const T* gn = g + (long long)n * K * Q;
  const bool sums_dbias = with_dbias && pc == 0 && tid < KT;

  // this thread's (tap, channel) pairs: consecutive threads take
  // consecutive channels of one tap
  int pair[UPT], xoff[UPT];
#pragma unroll
  for (int i = 0; i < UPT; ++i) {
    pair[i] = (pc * UPT + i) * BLOCK + tid;
    const int pr = pair[i] < pairs ? pair[i] : 0;  // idle slots read row 0
    xoff[i] = (pr % C) * stride + (pr / C) * dilation;
  }
  float acc[UPT][KT];
#pragma unroll
  for (int i = 0; i < UPT; ++i)
#pragma unroll
    for (int k = 0; k < KT; ++k) acc[i][k] = 0.f;
  float db = 0.f;

  const int t_end = min(ntiles, (part + 1) * tiles_per_part);
  for (int t = part * tiles_per_part; t < t_end; ++t) {
    const int q0 = t * TQ;
    __syncthreads();  // the previous tile's readers are done with smem
    for (int c = 0; c < C; ++c) {
      const T* row = xn + (long long)c * Wp;
      for (int j = tid; j < F; j += BLOCK) {
        const int col = q0 + j;
        xs[c * stride + j] = col < Wp ? to_f32(row[col]) : 0.f;
      }
    }
    for (int i = tid; i < KT * TQ; i += BLOCK) {
      const int k = i / TQ;
      const int j = i % TQ;
      const int col = q0 + j;
      float v = 0.f;
      if (k0 + k < K && col < Q) v = to_f32(gn[(long long)(k0 + k) * Q + col]);
      gs[j * GS + k] = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < TQ; ++j) {
      float gv[KT];
      if constexpr (KT % 4 == 0) {
        const float4* g4 = reinterpret_cast<const float4*>(gs + j * GS);
#pragma unroll
        for (int k4 = 0; k4 < KT / 4; ++k4) {
          const float4 v = g4[k4];
          gv[4 * k4] = v.x;
          gv[4 * k4 + 1] = v.y;
          gv[4 * k4 + 2] = v.z;
          gv[4 * k4 + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < KT; ++k) gv[k] = gs[j * GS + k];
      }
#pragma unroll
      for (int i = 0; i < UPT; ++i) {
        const float xv = xs[xoff[i] + j];
#pragma unroll
        for (int k = 0; k < KT; ++k) acc[i][k] = fmaf(gv[k], xv, acc[i][k]);
      }
    }
    if (sums_dbias)
      for (int j = 0; j < TQ; ++j) db += gs[j * GS + tid];
  }

  // one row of partial sums per (sample, column range)
  float* row = partial + (long long)(n * gridDim.x + part) * row_len;
#pragma unroll
  for (int i = 0; i < UPT; ++i) {
    if (pair[i] >= pairs) continue;
    const int s = pair[i] / C, c = pair[i] % C;
#pragma unroll
    for (int k = 0; k < KT; ++k)
      if (k0 + k < K) row[((long long)s * K + k0 + k) * C + c] = acc[i][k];
  }
  if (sums_dbias && k0 + tid < K) row[S * K * C + k0 + tid] = db;
}

// out[o] = sum_{p=0..P-1} partial[p][o], in that order; o < n_dw goes to
// dw, the rest to dbias.
__global__ void __launch_bounds__(BLOCK)
reduce_partials(const float* __restrict__ partial, float* __restrict__ dw,
                float* __restrict__ dbias, int P, int row_len, int n_dw) {
  const int o = blockIdx.x * BLOCK + threadIdx.x;
  if (o >= row_len) return;
  float s = 0.f;
  int p = 0;
  for (; p + 8 <= P; p += 8) {  // eight loads in flight, summed in order
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = partial[(long long)(p + i) * row_len + o];
#pragma unroll
    for (int i = 0; i < 8; ++i) s += v[i];
  }
  for (; p < P; ++p) s += partial[(long long)p * row_len + o];
  if (o < n_dw)
    dw[o] = s;
  else
    dbias[o - n_dw] = s;
}

template <typename T, int KT>
int launch(const Plan& pl, const void* x, const void* g, float* partial,
           float* dw, float* dbias, int N, int C, int K, int S, int Wp,
           int dilation, cudaStream_t stream) {
  auto kernel = bwd_weight_partial<T, KT>;
  if (pl.smem > SMEM_BUDGET) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(pl.smem));
    if (e != cudaSuccess) return int(e);
  }
  const int Q = Wp - (S - 1) * dilation;
  const int n_dw = S * K * C;
  const int row_len = n_dw + (dbias != nullptr ? K : 0);
  const dim3 grid(pl.parts, pl.kgroups * pl.pchunks, N);
  kernel<<<grid, BLOCK, pl.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, C, K, S,
      Wp, Q, dilation, pl.stride, pl.ntiles, pl.tiles_per_part, pl.pchunks,
      row_len, dbias != nullptr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  reduce_partials<<<(row_len + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
      partial, dw, dbias, N * pl.parts, row_len, n_dw);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows of fp32 partial sums conv1d_bwd_weight needs as scratch, each
// S*K*C (+K with dbias) long: one per (sample, column range).  A negative
// value is an error: -1 the footprint cannot fit in shared memory, -2 a
// batch beyond the grid's limit, -3 the SM count could not be read.
int conv1d_bwd_weight_rows(int N, int C, int K, int S, int Wp, int dilation,
                           int device) {
  Plan pl;
  const int rc = make_plan(N, C, K, S, Wp, dilation, device, &pl);
  return rc != 0 ? rc : N * pl.parts;
}

// Launches both passes on `stream` of GPU `device` and returns
// cudaGetLastError() after them (0 on success), or a negative code as
// conv1d_bwd_weight_rows.  dtype: 0 = fp32, 1 = bf16.  dbias may be null
// (then no bias gradient is summed).  `partial` holds
// conv1d_bwd_weight_rows(...) rows.
int conv1d_bwd_weight(const void* x, const void* g, void* partial, void* dw,
                      void* dbias, int N, int C, int K, int S, int Wp,
                      int dilation, int dtype, int device, void* stream) {
  // this library links its own CUDA runtime: select the tensors' GPU in it
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  Plan pl;
  const int rc = make_plan(N, C, K, S, Wp, dilation, device, &pl);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* w = static_cast<float*>(dw);
  float* b = static_cast<float*>(dbias);
  if (dtype == DT_F32) {
    if (pl.KT == 1)
      return launch<float, 1>(pl, x, g, part, w, b, N, C, K, S, Wp, dilation,
                              st);
    return launch<float, 16>(pl, x, g, part, w, b, N, C, K, S, Wp, dilation,
                             st);
  }
  if (pl.KT == 1)
    return launch<__nv_bfloat16, 1>(pl, x, g, part, w, b, N, C, K, S, Wp,
                                    dilation, st);
  return launch<__nv_bfloat16, 16>(pl, x, g, part, w, b, N, C, K, S, Wp,
                                   dilation, st);
}

const char* conv1d_bwd_weight_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
