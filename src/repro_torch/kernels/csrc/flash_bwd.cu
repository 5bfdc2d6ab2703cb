// flash_bwd — the gradient of grouped-query softmax attention, hand-written
// for Hopper (sm_90a): one kernel for dQ, one for dK and dV.
//
// Replaces the Pallas TPU kernels of repro/kernels/flash_attention.py:
// flash_bwd (bodies _bwd_dq_kernel and _bwd_dkv_kernel).
//
//   P  = exp(s - lse)          s recomputed as in the forward (scaled q . k,
//                              NEG_INF above the causal diagonal)
//   dP = dO . v^T              dS = P * (dP - delta)
//   dq = (dS . k) * scale      dk = dS^T . (q * scale)      dv = P^T . dO
//
//   q, dO, o (B, Tq, KV, G, hd) and k, v (B, Tk, KV, hd) read through
//   their element strides (last dimension contiguous), fp32 or bf16, one
//   dtype; lse and delta (B, Tq, KV, G) contiguous fp32 (delta =
//   rowsum(dO * o), computed by the caller from the stored o, as the TPU
//   wrapper does); dq, dk, dv contiguous in the inputs' dtype.  hd is 64
//   or 128.  Products and sums in fp32, as the TPU kernels compute them.
//
// Bound.  At StarCoder2-3B's training shape (B 4, T 4,096, 24 heads over
// 2 KV heads, hd 128, causal) the backward needs five products, each the
// size of one of the forward's two (s, dP, dq, dk, dv), 1.03e12 flops with
// the causal half skipped: 1.04 ms at 989 TFLOP/s bf16, against about
// 0.35 GB moved (0.1 ms at 3.35 TB/s): operations bound it.  s and dP are
// recomputed in both kernels (seven products in all), and they run as
// fp32 FMAs outside the tensor cores, so the kernels cannot come within
// 20x of that bound; the tensor-core form is later work.
//
// Design (simple and right first):
//   * dQ: one block per (batch, KV head, tile of BM query rows; a row is
//     one (position, group head) pair, as in flash_fwd.cu), looping over
//     the key tiles up to the tile's diagonal; dq is summed in registers;
//   * dK/dV: one block per (batch, KV head, tile of BK keys), looping over
//     the row tiles from the diagonal on; a row tile holds all G heads of
//     its positions, so the sum over the group is part of the loop; dk
//     and dv are summed in registers;
//   * no atomics and a fixed order of every sum: two launches on the same
//     inputs give bitwise equal results;
//   * the causal mask and the ragged edges as in flash_fwd.cu: tiles wholly
//     above the diagonal are skipped, P is 0 for masked entries, rows and
//     keys past the end are not stored.
#include "flash_common.cuh"

namespace {

__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float comp(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

struct Params {
  const void* q; const void* k; const void* v; const void* d_o;
  const float* lse; const float* delta;
  void* dq; void* dk; void* dv;
  int Tq, Tk, KV, G, causal;
  long long q_sb, q_st, q_skv, q_sg;    // q's element strides
  long long do_sb, do_st, do_skv, do_sg;
  long long k_sb, k_st, k_skv;
  long long v_sb, v_st, v_skv;
  float scale;
};

// dQ: one block per (row tile, batch x KV head).  Thread (ty, tx) owns rows
// ty + 16 i (i < 4) and, of S, dP and dS, keys tx + 16 c (c < 4); of dq,
// columns 64 h + 4 tx .. +3.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(Params p) {
  constexpr int LD = HD + 4, LDS = BK + 4, DH = HD / 64;
  extern __shared__ float smem[];
  float* Qs = smem;                  // (BM, LD) scaled q
  float* dOs = Qs + BM * LD;         // (BM, LD)
  float* Ks = dOs + BM * LD;         // (BK, LD)
  float* Vs = Ks + BK * LD;          // (BK, LD)
  float* dSs = Vs + BK * LD;         // (BM, LDS)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nrows = p.Tq * p.G;
  const int ntiles = (nrows + BM - 1) / BM;
  const int r0 = (ntiles - 1 - (int)blockIdx.x) * BM;  // heaviest first
  const int b = blockIdx.y / p.KV, kv = blockIdx.y % p.KV;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + kv * p.q_skv;
  const T* d_o = static_cast<const T*>(p.d_o) + b * p.do_sb + kv * p.do_skv;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kv * p.k_skv;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kv * p.v_skv;

  load_rows<T, HD>(Qs, q, p.q_st, p.q_sg, r0, nrows, p.G, p.scale);
  load_rows<T, HD>(dOs, d_o, p.do_st, p.do_sg, r0, nrows, p.G, 1.f);
  int qpos[4];
  float lse[4], delta[4];
  float4 acc[4][DH];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    const bool ok = r < nrows;
    qpos[i] = ok ? r / p.G : -1;
    lse[i] = ok ? p.lse[row_index(b, kv, r, p.Tq, p.KV, p.G)] : 0.f;
    delta[i] = ok ? p.delta[row_index(b, kv, r, p.Tq, p.KV, p.G)] : 0.f;
#pragma unroll
    for (int h = 0; h < DH; ++h) acc[i][h] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int last = min(r0 + BM, nrows) - 1;
  const int kend = p.causal ? min(p.Tk, last / p.G + 1) : p.Tk;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and dS are consumed
    load_keys<T, HD>(Ks, k, p.k_st, k0, p.Tk);
    load_keys<T, HD>(Vs, v, p.v_st, k0, p.Tk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = load4(Qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) kb[c] = load4(Ks + (tx + 16 * c) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = dot4(qa[i], kb[c], s[i][c]);
    }
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 oa[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) oa[i] = load4(dOs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) vb[c] = load4(Vs + (tx + 16 * c) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) dp[i][c] = dot4(oa[i], vb[c], dp[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        const bool ok = qpos[i] >= 0 && j < p.Tk && (!p.causal || j <= qpos[i]);
        const float pr = ok ? expf(s[i][c] - lse[i]) : 0.f;
        dSs[(ty + 16 * i) * LDS + tx + 16 * c] = pr * (dp[i][c] - delta[i]);
      }
    __syncthreads();

    // dq += dS K
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 sa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = load4(dSs + (ty + 16 * i) * LDS + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int h = 0; h < DH; ++h) {
          const float4 kb = load4(Ks + (j + jj) * LD + 64 * h + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) fma4(acc[i][h], comp(sa[i], jj), kb);
        }
    }
  }

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= nrows) continue;
    const long long row = row_index(b, kv, r, p.Tq, p.KV, p.G);
#pragma unroll
    for (int h = 0; h < DH; ++h)
      store4(dq + row * HD + 64 * h + tx * 4, scale4(acc[i][h], p.scale));
  }
}

// dK/dV: one block per (key tile, batch x KV head).  Thread (ty, tx) owns
// keys ty + 16 i (i < 4) and, of S^T, dP^T and dS^T, rows tx + 16 c
// (c < 4); of dk and dv, columns 64 h + 4 tx .. +3.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(Params p) {
  constexpr int LD = HD + 4, LDT = BM + 4, DH = HD / 64;
  extern __shared__ float smem[];
  float* Ks = smem;                  // (BK, LD)
  float* Vs = Ks + BK * LD;          // (BK, LD)
  float* Qs = Vs + BK * LD;          // (BM, LD) scaled q
  float* dOs = Qs + BM * LD;         // (BM, LD)
  float* Pt = dOs + BM * LD;         // (BK, LDT)
  float* dSt = Pt + BK * LDT;        // (BK, LDT)
  float* lse_s = dSt + BK * LDT;     // (BM,)
  float* delta_s = lse_s + BM;       // (BM,)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nrows = p.Tq * p.G;
  const int k0 = blockIdx.x * BK;    // the first key tiles see the most rows
  const int b = blockIdx.y / p.KV, kv = blockIdx.y % p.KV;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + kv * p.q_skv;
  const T* d_o = static_cast<const T*>(p.d_o) + b * p.do_sb + kv * p.do_skv;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kv * p.k_skv;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kv * p.v_skv;

  load_keys<T, HD>(Ks, k, p.k_st, k0, p.Tk);
  load_keys<T, HD>(Vs, v, p.v_st, k0, p.Tk);
  float4 dk[4][DH], dv[4][DH];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < DH; ++h)
      dk[i][h] = dv[i][h] = make_float4(0.f, 0.f, 0.f, 0.f);

  // rows before position k0 see none of these keys
  const int rstart = p.causal ? (k0 * p.G) / BM * BM : 0;
  for (int r0 = rstart; r0 < nrows; r0 += BM) {
    __syncthreads();  // the previous row tile's Q, dO, P and dS are consumed
    load_rows<T, HD>(Qs, q, p.q_st, p.q_sg, r0, nrows, p.G, p.scale);
    load_rows<T, HD>(dOs, d_o, p.do_st, p.do_sg, r0, nrows, p.G, 1.f);
    for (int rr = tid; rr < BM; rr += THREADS) {
      const int r = r0 + rr;
      lse_s[rr] = r < nrows ? p.lse[row_index(b, kv, r, p.Tq, p.KV, p.G)] : 0.f;
      delta_s[rr] = r < nrows ? p.delta[row_index(b, kv, r, p.Tq, p.KV, p.G)] : 0.f;
    }
    __syncthreads();

    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[i][c] = dpt[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 ka[4], qb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ka[i] = load4(Ks + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) qb[c] = load4(Qs + (tx + 16 * c) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) st[i][c] = dot4(qb[c], ka[i], st[i][c]);
    }
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 va[4], ob[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) va[i] = load4(Vs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) ob[c] = load4(dOs + (tx + 16 * c) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) dpt[i][c] = dot4(ob[c], va[i], dpt[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + ty + 16 * i, rr = tx + 16 * c, r = r0 + rr;
        const bool ok = r < nrows && j < p.Tk && (!p.causal || j <= r / p.G);
        const float pr = ok ? expf(st[i][c] - lse_s[rr]) : 0.f;
        Pt[(ty + 16 * i) * LDT + rr] = pr;
        dSt[(ty + 16 * i) * LDT + rr] = pr * (dpt[i][c] - delta_s[rr]);
      }
    __syncthreads();

    // dv += P^T dO, dk += dS^T (q * scale)
#pragma unroll 2
    for (int r = 0; r < BM; r += 4) {
      float4 pa[4], sa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = load4(Pt + (ty + 16 * i) * LDT + r);
        sa[i] = load4(dSt + (ty + 16 * i) * LDT + r);
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int h = 0; h < DH; ++h) {
          const float4 ob = load4(dOs + (r + rr) * LD + 64 * h + tx * 4);
          const float4 qb = load4(Qs + (r + rr) * LD + 64 * h + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            fma4(dv[i][h], comp(pa[i], rr), ob);
            fma4(dk[i][h], comp(sa[i], rr), qb);
          }
        }
    }
  }

  T* dkp = static_cast<T*>(p.dk);
  T* dvp = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = k0 + ty + 16 * i;
    if (j >= p.Tk) continue;
    // contiguous (B, Tk, KV, hd)
    const long long row = ((long long)b * p.Tk + j) * p.KV + kv;
#pragma unroll
    for (int h = 0; h < DH; ++h) {
      store4(dkp + row * HD + 64 * h + tx * 4, dk[i][h]);
      store4(dvp + row * HD + 64 * h + tx * 4, dv[i][h]);
    }
  }
}

template <typename T, int HD>
int launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int LD = HD + 4;
  const int smem_dq = (2 * BM * LD + 2 * BK * LD + BM * (BK + 4)) * (int)sizeof(float);
  const int smem_dkv = (2 * BK * LD + 2 * BM * LD + 2 * BK * (BM + 4) + 2 * BM)
                       * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_dq);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkv);
  if (e != cudaSuccess) return (int)e;
  const int nrows = p.Tq * p.G;
  flash_bwd_dq_kernel<T, HD><<<dim3((nrows + BM - 1) / BM, B * p.KV), THREADS,
                               smem_dq, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkv_kernel<T, HD><<<dim3((p.Tk + BK - 1) / BK, B * p.KV), THREADS,
                                smem_dkv, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: q's (b, t, kv, g), dO's (b, t, kv, g), k's (b, t, kv), v's
// (b, t, kv), in elements.  Returns 0, a CUDA error code, or a negative
// code for a shape the kernels do not take.
int flash_bwd(const void* q, const void* k, const void* v, const void* d_o,
              const float* lse, const float* delta, void* dq, void* dk,
              void* dv, int B, int Tq, int Tk, int KV, int G, int hd,
              const long long* strides, int causal, float scale, int dtype,
              int device, void* stream) {
  if (hd != 64 && hd != 128) return ERR_HEAD_DIM;
  if ((long long)B * KV > 65535) return ERR_GRID;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long* s = strides;
  Params p{q, k, v, d_o, lse, delta, dq, dk, dv, Tq, Tk, KV, G, causal,
           s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
           s[8], s[9], s[10], s[11], s[12], s[13], scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return hd == 128 ? launch<float, 128>(p, B, st) : launch<float, 64>(p, B, st);
  return hd == 128 ? launch<__nv_bfloat16, 128>(p, B, st)
                   : launch<__nv_bfloat16, 64>(p, B, st);
}

const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
