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
// by memory: 11.0 GFLOP a 15->15 training layer (batch 8 x 60,000), 0.164
// ms at the H100 SXM's published 67 TFLOP/s (700 W).
//
// Design (a register-tiled fp32 FMA body):
//   * one block of BLOCK threads per (column tile, filter tile of KT
//     filters, sample).  Each thread owns J output columns spaced d apart
//     (q, q+d, ..., q+(J-1)d) and the KT filters: J*KT fp32 accumulators.
//     Tap s of column j reads x[q+(s+j)d], so a window of J inputs in
//     registers slides by one value per tap: each (tap, channel) costs one
//     shared-memory load of x and KT/4 broadcast float4 loads of the
//     weights for J*KT FMAs (96 at J = 6, KT = 16), and the FMA units set
//     the pace;
//   * the threads of a block form BLOCK/d groups of d (r = 0..d-1), each
//     group covering J*d contiguous columns (BLOCK*J columns a block when
//     d divides BLOCK; with J = 1 thread t owns column t, at any dilation);
//   * the kernel picks the tile (J, KT) from the shape: the largest one
//     whose grid still gives every SM a block.  A training layer (K = 15)
//     takes J = 6, KT = 16: K padded to 16 in registers and masked at the
//     store, one filter tile, so the footprint is staged once (K > 16 runs
//     in tiles of 16).  Smaller grids take fewer columns and filters a
//     thread (the stream step J = 2, KT = 4); K = 1 (the heads) gives all
//     of a thread's registers to columns (J = 16 in training).  A caller
//     (the tuner) may pin any tile of the list instead; `legal` decides
//     for both, and a pinned tile that may not run is refused, never
//     replaced;
//   * the dilated footprint x[n, c, q0 : q0+TQ+(S-1)d] of a channel chunk
//     and its weights (S, CC, KT) are staged in shared memory as fp32 and
//     read by all S taps: 16-byte cp.async where the rows are 16-byte
//     aligned fp32, else element by element (with the bf16 conversion), 8
//     loads in flight a thread.  A row is stored skewed, d floats after
//     every group of J*d columns, so the 32 lanes of a warp read 32 banks;
//   * channels in chunks of CC so two blocks fit an SM's shared memory
//     (one channel row may take up to 227 KiB; a row that cannot fit even
//     that is refused);
//   * the accumulators then go through shared memory, so the epilogue
//     (bias, residual, activation, cast) is one short loop whose stores
//     coalesce; it masks the ragged edge itself, no width round-up;
//   * plain fp32 FMA, no TF32, no tensor cores.
//
// Summation order.  Every output element is summed as: channels c = 0..C-1
// in order, inside a channel taps s = 0..S-1 in order, one fmaf each into
// one fp32 accumulator that starts at 0; then bias, residual, preact,
// activation, one cast.  The order depends on (C, S) alone: not on the
// column's position, Q, N, the tile (J, KT), the block width or the channel
// chunk.  So a streamed chunk and a one-shot pass, which take different
// tiles, give bitwise equal outputs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLOCK = 128;                // threads per block
constexpr int SMEM_TARGET = 113 * 1024;   // two blocks an SM
constexpr int SMEM_MAX = 232448;          // Hopper's per-block opt-in limit
constexpr int SMEM_DEFAULT = 48 * 1024;   // without the opt-in
constexpr int BATCH = 8;                  // loads in flight a thread

constexpr int ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3;
constexpr int DT_BF16 = 1;                // dtype codes: 0 fp32, 1 bf16
constexpr int ERR_FOOTPRINT = -1;         // one channel row does not fit
constexpr int ERR_TILE = -4;              // a pinned tile that may not run

__device__ __forceinline__ float load_f32(const void* p, long long i,
                                          bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
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

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}

// Column-tile geometry of a J-column tile at dilation d: output columns a
// block, threads that own columns, and the skew (floats after each group
// of J*d staged columns).  J > 1 needs d <= BLOCK.
struct Geom {
  int TQ, active, skew;
};

__host__ __device__ __forceinline__ Geom geometry(int J, int d) {
  if (J == 1) return {BLOCK, BLOCK, 0};
  const int groups = BLOCK / d;
  return {groups * J * d, groups * d, d < 32 && J % 2 == 0 ? d : 0};
}

// Floats of one staged channel row of F columns, rounded up to 16 bytes.
__host__ int row_floats(int J, int d, int F) {
  const int last = F - 1 + (F - 1) / (J * d) * geometry(J, d).skew;
  return (last + 4) & ~3;
}

__host__ size_t smem_bytes(int cc, int Fs, int S, int KT) {
  return sizeof(float) * (size_t(cc) * Fs + size_t(S) * cc * KT);
}

// Channels staged at once: the most that keep two blocks an SM, evened out
// over the chunks; one if only one row fits (with the opt-in); 0 if not
// even that.
__host__ int channel_chunk(int C, int Fs, int S, int KT) {
  int cc = C;
  while (cc > 1 && smem_bytes(cc, Fs, S, KT) > SMEM_TARGET) --cc;
  if (smem_bytes(cc, Fs, S, KT) > SMEM_MAX) return 0;
  const int chunks = (C + cc - 1) / cc;
  return (C + chunks - 1) / chunks;
}

// One tap of one channel: acc[j][k] += w[k] * window[j], the window being
// buf rotated by u (buf[(u+j) % J] holds column j's input of this tap).
template <int J, int KT>
__device__ __forceinline__ void tap(float (&acc)[J][KT], const float (&buf)[J],
                                    int u, const float* __restrict__ wr) {
  float wv[KT];
  if constexpr (KT % 4 == 0) {
#pragma unroll
    for (int k4 = 0; k4 < KT / 4; ++k4) {
      const float4 v = reinterpret_cast<const float4*>(wr)[k4];
      wv[4 * k4] = v.x;
      wv[4 * k4 + 1] = v.y;
      wv[4 * k4 + 2] = v.z;
      wv[4 * k4 + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < KT; ++k) wv[k] = wr[k];
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float xv = buf[(u + j) % J];
#pragma unroll
    for (int k = 0; k < KT; ++k) acc[j][k] = fmaf(wv[k], xv, acc[j][k]);
  }
}

// All S taps of one staged channel, in order.  xr: the thread's first
// column in the skewed row; wr: the channel's weights of tap 0, wstep
// floats between taps.  Input m of the thread (column q + m*d) sits at
// xr[m*d + (m/J)*skew] and goes to buf[m % J].
template <int J, int KT>
__device__ __forceinline__ void channel(float (&acc)[J][KT],
                                        const float* __restrict__ xr,
                                        const float* __restrict__ wr,
                                        int wstep, int S, int d, int skew) {
  float buf[J];
#pragma unroll
  for (int u = 0; u < J - 1; ++u) buf[u] = xr[u * d];
  const float* xp = xr + (J - 1) * d;  // input s + J - 1 at tap s
  int s = 0;
  for (; s + J <= S; s += J) {
#pragma unroll
    for (int u = 0; u < J; ++u) {
      buf[(u + J - 1) % J] = xp[u * d + (u > 0 ? skew : 0)];
      tap<J, KT>(acc, buf, u, wr + (s + u) * wstep);
    }
    xp += J * d + skew;
  }
#pragma unroll
  for (int u = 0; u < J - 1; ++u) {  // the last S % J taps
    if (s + u < S) {
      buf[(u + J - 1) % J] = xp[u * d + (u > 0 ? skew : 0)];
      tap<J, KT>(acc, buf, u, wr + (s + u) * wstep);
    }
  }
}

// Rows c = 0..cc-1 of x from row0 (Wp apart), columns q0 .. q0+F-1 (zeros
// past Wp), into the skewed staged rows, element by element with the bf16
// conversion: BATCH loads in flight a thread.
__device__ __forceinline__ void stage_rows(float* xs, const void* x,
                                           long long row0, int cc, int F,
                                           int Fs, int Wp, int q0, int JD,
                                           int skew, bool bf16) {
  const int n = cc * F;
  for (int i0 = threadIdx.x; i0 < n; i0 += BATCH * BLOCK) {
    float v[BATCH];
    int dst[BATCH];
#pragma unroll
    for (int h = 0; h < BATCH; ++h) {
      const int i = i0 + h * BLOCK;
      const int c = i / F, e = i - c * F;
      const int col = q0 + e;
      dst[h] = i < n ? c * Fs + e + e / JD * skew : -1;
      v[h] = i < n && col < Wp
                 ? load_f32(x, row0 + (long long)c * Wp + col, bf16)
                 : 0.f;
    }
#pragma unroll
    for (int h = 0; h < BATCH; ++h)
      if (dst[h] >= 0) xs[dst[h]] = v[h];
  }
}

// Weights w[s, k0+k, c0+c] into ws (S, cc, KT), zeros past K; read with c
// fastest (w's rows run along c), BATCH loads in flight a thread.
template <int KT>
__device__ __forceinline__ void stage_weights(float* ws, const void* w,
                                              int S, int K, int C, int c0,
                                              int cc, int k0, bool bf16) {
  const int n = S * KT * cc;
  for (int i0 = threadIdx.x; i0 < n; i0 += BATCH * BLOCK) {
    float v[BATCH];
    int dst[BATCH];
#pragma unroll
    for (int h = 0; h < BATCH; ++h) {
      const int i = i0 + h * BLOCK;
      const int sk = i / cc, c = i - sk * cc;  // sk = s * KT + k
      const int s = sk / KT, k = sk - s * KT;
      dst[h] = i < n ? (s * cc + c) * KT + k : -1;
      v[h] = i < n && k0 + k < K
                 ? load_f32(w, ((long long)s * K + k0 + k) * C + c0 + c, bf16)
                 : 0.f;
    }
#pragma unroll
    for (int h = 0; h < BATCH; ++h)
      if (dst[h] >= 0) ws[dst[h]] = v[h];
  }
}

template <int J, int KT>
__global__ void __launch_bounds__(BLOCK)
conv1d_fwd_kernel(const void* __restrict__ x, const void* __restrict__ w,
                  const void* __restrict__ bias,
                  const void* __restrict__ residual, void* __restrict__ out,
                  float* __restrict__ preact, int C, int K, int S, int Wp,
                  int Q, int d, int CC, int Fs, int act, int in_bf16,
                  int out_bf16, int async_rows) {
  extern __shared__ __align__(16) float smem[];
  const Geom geo = geometry(J, d);
  const int JD = J * d;
  const int F = geo.TQ + (S - 1) * d;
  float* xs = smem;            // (CC, Fs), skewed rows
  float* ws = smem + CC * Fs;  // (S, cc, KT)
  const bool bf16 = in_bf16 != 0;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * geo.TQ;
  const int k0 = blockIdx.y * KT;
  const int n = blockIdx.z;
  // this thread's first column in the tile, and where it sits in a row
  int ql = tid, sb = tid;
  if (J > 1) {
    const int g = tid / d;
    ql = g * JD + (tid - g * d);
    sb = ql + g * geo.skew;
  }
  const bool live = tid < geo.active;

  float acc[J][KT];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int k = 0; k < KT; ++k) acc[j][k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    const int cc = min(CC, C - c0);
    const long long row0 = ((long long)n * C + c0) * Wp;
    __syncthreads();  // the previous chunk's readers are done with smem
    if (async_rows) {
      const float* xf = static_cast<const float*>(x) + row0;
      const int F4 = (F + 3) / 4;
      for (int i = tid; i < cc * F4; i += BLOCK) {
        const int c = i / F4, e = (i - c * F4) * 4;
        const int col = q0 + e;
        const int bytes = max(0, min(16, (Wp - col) * 4));
        cp_async16(xs + c * Fs + e + e / JD * geo.skew,
                   xf + (long long)c * Wp + (bytes ? col : 0), bytes);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    } else {
      stage_rows(xs, x, row0, cc, F, Fs, Wp, q0, JD, geo.skew, bf16);
    }
    stage_weights<KT>(ws, w, S, K, C, c0, cc, k0, bf16);
    if (async_rows) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (live)
      for (int c = 0; c < cc; ++c)
        channel<J, KT>(acc, xs + c * Fs + sb, ws + c * KT, cc * KT, S, d,
                       geo.skew);
  }

  // The accumulators go through shared memory, (KT, TQ), so the epilogue
  // is one short loop whose stores coalesce.
  __syncthreads();  // every thread is done with the staged operands
  if (live)
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int k = 0; k < KT; ++k) smem[k * geo.TQ + ql + j * d] = acc[j][k];
  __syncthreads();

  // Fused epilogue on the fp32 sums: act(acc + bias + residual); BATCH
  // residual loads in flight a thread.
  const int lim = min(geo.TQ, Q - q0);
  for (int k = 0; k < KT && k0 + k < K; ++k) {
    const float b = bias != nullptr ? load_f32(bias, k0 + k, bf16) : 0.f;
    const long long o0 = ((long long)n * K + k0 + k) * Q + q0;
    for (int p0 = tid; p0 < lim; p0 += BATCH * BLOCK) {
      float r[BATCH];
      if (residual != nullptr)
#pragma unroll
        for (int h = 0; h < BATCH; ++h) {
          const int p = p0 + h * BLOCK;
          r[h] = p < lim ? load_f32(residual, o0 + p, bf16) : 0.f;
        }
#pragma unroll
      for (int h = 0; h < BATCH; ++h) {
        const int p = p0 + h * BLOCK;
        if (p >= lim) break;
        float u = smem[k * geo.TQ + p];
        if (bias != nullptr) u += b;
        if (residual != nullptr) u += r[h];
        if (preact != nullptr) preact[o0 + p] = u;
        const float y = activate(u, act);
        if (out_bf16)
          static_cast<__nv_bfloat16*>(out)[o0 + p] = __float2bfloat16(y);
        else
          static_cast<float*>(out)[o0 + p] = y;
      }
    }
  }
}

struct Args {
  const void *x, *w, *bias, *residual;
  void* out;
  float* preact;
  int N, C, K, S, Wp, d, act, in_bf16, out_bf16;
  cudaStream_t stream;
};

// The register tile (J columns x KT filters a thread), in order of
// preference: the first whose grid gives every SM a block, else the last.
struct Tile {
  int J, KT;
};
constexpr Tile WIDE[] = {{6, 16}, {4, 8}, {2, 4}, {1, 4}};  // K > 1
constexpr Tile SINGLE[] = {{16, 1}, {2, 1}, {1, 1}};        // K = 1

__host__ bool fits(Tile t, int C, int S, int d) {
  const int F = geometry(t.J, d).TQ + (S - 1) * d;
  return channel_chunk(C, row_floats(t.J, d, F), S, t.KT) > 0;
}

// Whether tile t may run this shape: one of the list for K (K > 1 or
// K = 1), J > 1 only at d <= BLOCK, and a channel row that fits in shared
// memory.  The one rule for the kernel's own choice and for a pinned tile.
__host__ bool legal(Tile t, int C, int K, int S, int d) {
  const Tile* list = K == 1 ? SINGLE : WIDE;
  const int count = K == 1 ? 3 : 4;
  bool listed = false;
  for (int i = 0; i < count; ++i)
    listed |= list[i].J == t.J && list[i].KT == t.KT;
  return listed && !(t.J > 1 && d > BLOCK) && fits(t, C, S, d);
}

// The tile for a shape on a card of `sms` SMs; {0, 0} if no tile's
// channel row fits in shared memory.
__host__ Tile choose(int N, int C, int K, int S, int Wp, int d, int sms) {
  const Tile* list = K == 1 ? SINGLE : WIDE;
  const int count = K == 1 ? 3 : 4;
  const int Q = Wp - (S - 1) * d;
  Tile best{0, 0};
  for (int i = 0; i < count; ++i) {
    const Tile t = list[i];
    if (!legal(t, C, K, S, d)) continue;
    best = t;
    const long long TQ = geometry(t.J, d).TQ;
    const long long blocks =
        (Q + TQ - 1) / TQ * ((K + t.KT - 1) / t.KT) * (long long)N;
    if (blocks >= sms) break;
  }
  return best;
}

// The tile of a launch: the pinned one (code J * 100 + KT) if it is legal
// here, the kernel's own choice for code 0; {0, 0} with *err set if none.
__host__ Tile resolve(int code, int N, int C, int K, int S, int Wp, int d,
                      int sms, int* err) {
  if (code != 0) {
    const Tile t{code / 100, code % 100};
    *err = legal(t, C, K, S, d) ? 0 : ERR_TILE;
    return *err ? Tile{0, 0} : t;
  }
  const Tile t = choose(N, C, K, S, Wp, d, sms);
  *err = t.J == 0 ? ERR_FOOTPRINT : 0;
  return t;
}

template <int J, int KT>
int launch(const Args& a) {
  const Geom geo = geometry(J, a.d);
  const int span = (a.S - 1) * a.d;
  const int Q = a.Wp - span;
  const int Fs = row_floats(J, a.d, geo.TQ + span);
  const int cc = channel_chunk(a.C, Fs, a.S, KT);
  if (cc == 0) return ERR_FOOTPRINT;
  const size_t stage = smem_bytes(cc, Fs, a.S, KT);
  const size_t tile = sizeof(float) * KT * geo.TQ;  // the epilogue's
  const size_t smem = stage > tile ? stage : tile;
  auto kernel = conv1d_fwd_kernel<J, KT>;
  if (smem > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  // cp.async needs fp32 rows and tiles that start 16-byte aligned and a
  // skew that keeps each 16-byte chunk of a row in one piece
  const bool async_rows =
      !a.in_bf16 && a.Wp % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(a.x) & 15) == 0 && geo.TQ % 4 == 0 &&
      (J == 1 || (J * a.d % 4 == 0 && geo.skew % 4 == 0));
  const dim3 grid((Q + geo.TQ - 1) / geo.TQ, (a.K + KT - 1) / KT, a.N);
  kernel<<<grid, BLOCK, smem, a.stream>>>(
      a.x, a.w, a.bias, a.residual, a.out, a.preact, a.C, a.K, a.S, a.Wp, Q,
      a.d, cc, Fs, a.act, a.in_bf16, a.out_bf16, int(async_rows));
  return int(cudaGetLastError());
}

int dispatch(Tile t, const Args& a) {
  switch (t.J * 100 + t.KT) {
    case 616: return launch<6, 16>(a);
    case 408: return launch<4, 8>(a);
    case 204: return launch<2, 4>(a);
    case 104: return launch<1, 4>(a);
    case 1601: return launch<16, 1>(a);
    case 201: return launch<2, 1>(a);
    default: return launch<1, 1>(a);
  }
}

int sm_count(int device, int* sms) {
  return int(cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                    device));
}

}  // namespace

extern "C" {

// Launches on `stream` of GPU `device` and returns cudaGetLastError()
// after the launch (0 on success), -1 when the footprint cannot fit in
// shared memory, or -4 when the pinned tile may not run this shape.
// dtype / out_dtype: 0 = fp32, 1 = bf16.  bias, residual and preact
// (fp32) may be null.  tile: J * 100 + KT pins the register tile (one of
// 616, 408, 204, 104 for K > 1; 1601, 201, 101 for K = 1); 0 lets the
// kernel choose.
int conv1d_fwd(const void* x, const void* w, const void* bias,
               const void* residual, void* out, void* preact, int N, int C,
               int K, int S, int Wp, int dilation, int act, int dtype,
               int out_dtype, int tile, int device, void* stream) {
  // this library links its own CUDA runtime: select the tensors' GPU in it
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  int sms = 0;
  if (const int rc = sm_count(device, &sms)) return rc;
  int err = 0;
  const Tile t = resolve(tile, N, C, K, S, Wp, dilation, sms, &err);
  if (err) return err;
  const Args a{x, w, bias, residual, out, static_cast<float*>(preact), N, C,
               K, S, Wp, dilation, act, int(dtype == DT_BF16),
               int(out_dtype == DT_BF16), static_cast<cudaStream_t>(stream)};
  return dispatch(t, a);
}

// The tile a launch at this shape with this `tile` argument takes on GPU
// `device`, as J * 100 + KT, or a negative code as conv1d_fwd's: the
// kernel's own choice for tile 0, else whether the pinned tile may run.
int conv1d_fwd_tile(int N, int C, int K, int S, int Wp, int dilation,
                    int tile, int device) {
  int sms = 0;
  if (const int rc = sm_count(device, &sms)) return -rc;
  int err = 0;
  const Tile t = resolve(tile, N, C, K, S, Wp, dilation, sms, &err);
  return err ? err : t.J * 100 + t.KT;
}

const char* conv1d_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
