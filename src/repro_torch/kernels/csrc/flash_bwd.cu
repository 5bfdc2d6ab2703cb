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
//   wrapper does); dq, dk, dv contiguous in the inputs' dtype.  hd is 64,
//   112, 128 or 192 (112 in a tile of 128 columns, the last 16 zeros:
//   flash_common.cuh; 192 is DeepSeek-V3's MLA, v zero-padded from 128 by
//   the caller, as the JAX package pads it).
//
// Bound.  At StarCoder2-3B's training shape (B 4, T 4,096, 24 heads over
// 2 KV heads, hd 128, causal) the backward needs five products, each the
// size of one of the forward's two (s, dP, dq, dk, dv), 1.03e12 flops with
// the causal half skipped: 1.04 ms at 989 TFLOP/s bf16, against about
// 0.35 GB moved (0.1 ms at 3.35 TB/s): operations bound it, and only
// wgmma reaches the tensor cores' rate.
//
// Both bodies keep two kernels, no atomics and a fixed order of every sum,
// so two launches on the same inputs give bitwise equal results; the
// causal mask and the ragged edges as in flash_fwd.cu (tiles wholly above
// the diagonal are skipped, P is 0 for masked entries, rows and keys past
// the end are not stored).  Two bodies, chosen by dtype in launch<> and
// sharing only the header:
//
//   * bf16 (flash_bwd_dq_wgmma_kernel, flash_bwd_dkv_wgmma_kernel): the
//     products on the tensor cores.  S and dP (Q.K^T and dO.V^T, their
//     inputs the model's bf16 tensors) are one exact bf16 product each
//     with fp32 sums; P and dS are formed in fp32 registers.  dS rounded
//     once to bf16 breaks the check's per-element bound (dq used 1.99 of
//     it, by a CPU emulation of the rounding) and P nearly fills it, so
//     every product with P or dS runs as two bf16 products, on hi = bf16(x)
//     and lo = bf16(x - hi), into one fp32 accumulator: with s and dP
//     recomputed in both kernels, 10 products where the bound counts 5.
//       - dQ: one block per (tile of 128 rows, batch x KV head), heaviest
//         first across all heads; two warpgroups of 64 rows (a row is one
//         (position, group head) pair, as in flash_fwd.cu) loop over 64-key
//         tiles up to the diagonal through a 2-stage cp.async ring of K
//         and V; S and dP by wgmma from shared memory; dQ += dS_hi.K +
//         dS_lo.K with dS from the accumulator in registers and K read
//         N-major; dq summed in registers;
//       - dK/dV (keys as M, as FlashAttention-3 lays it out): one block per
//         (tile of 128 keys, batch x KV head), the first key tiles (which
//         see the most rows) first; two warpgroups of 64 keys loop over
//         64-row tiles (Q, dO, and each row's lse, delta and position in a
//         2-stage cp.async ring) from the diagonal on; a row tile holds all
//         G heads of its positions, so the loop is the sum over the group.
//         S^T = K.Q^T and dP^T = V.dO^T from shared memory; dV += P^T_hi.dO
//         + P^T_lo.dO and dK += dS^T_hi.Q + dS^T_lo.Q with both A operands
//         from the accumulators; dk and dv summed in registers (128 fp32 a
//         thread at hd 112 and 128, where ptxas reports 255 registers).
//         At hd 192 dk and dv alone would take 192 fp32 a thread, S^T and
//         dP^T 64 more: past the 255 a thread can hold.  There the kernel
//         runs as two launches of one template, each holding one
//         accumulator: a dV pass (S^T, then dV += P^T.dO) and a dK pass
//         (S^T and dP^T, then dK += dS^T.Q): 5 products where the fused
//         kernel does 4 (S^T twice), the same sums in the same order.
//   * fp32 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel): products and sums
//     in fp32 as FMAs outside the tensor cores, as the TPU kernels compute
//     them.  fp32 attention runs only where the JAX kernels' exact fp32
//     arithmetic is the point (parity checks), so this body stays the
//     simple one: dQ one block per (batch, KV head, tile of BM rows) over
//     the key tiles up to the diagonal; dK/dV one block per (batch, KV
//     head, tile of BK keys) over the row tiles from the diagonal on; the
//     tiles in padded fp32 shared memory, 256 threads as 16 x 16.  dK/dV
//     keeps one (BK, BM) tile for P^T and then dS^T, its two products in
//     turn (two buffers would need 236,032 bytes at hd 192, past the
//     232,448 a block may have).
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
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(Params p) {
  constexpr int HP = pad64(HD), LD = HP + 4, LDS = BK + 4, DH = HP / 64;
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
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + kv * p.q_skv;
  const float* d_o =
      static_cast<const float*>(p.d_o) + b * p.do_sb + kv * p.do_skv;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kv * p.k_skv;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kv * p.v_skv;

  load_rows<HD>(Qs, q, p.q_st, p.q_sg, r0, nrows, p.G, p.scale);
  load_rows<HD>(dOs, d_o, p.do_st, p.do_sg, r0, nrows, p.G, 1.f);
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
    load_keys<HD>(Ks, k, p.k_st, k0, p.Tk);
    load_keys<HD>(Vs, v, p.v_st, k0, p.Tk);
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

  float* dq = static_cast<float*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= nrows) continue;
    const long long row = row_index(b, kv, r, p.Tq, p.KV, p.G);
#pragma unroll
    for (int h = 0; h < DH; ++h)
      if (HD % 64 == 0 || 64 * h + tx * 4 < HD)  // not a zero column
        store4(dq + row * HD + 64 * h + tx * 4, scale4(acc[i][h], p.scale));
  }
}

// dK/dV: one block per (key tile, batch x KV head).  Thread (ty, tx) owns
// keys ty + 16 i (i < 4) and, of S^T, dP^T and dS^T, rows tx + 16 c
// (c < 4); of dk and dv, columns 64 h + 4 tx .. +3.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(Params p) {
  constexpr int HP = pad64(HD), LD = HP + 4, LDT = BM + 4, DH = HP / 64;
  extern __shared__ float smem[];
  float* Ks = smem;                  // (BK, LD)
  float* Vs = Ks + BK * LD;          // (BK, LD)
  float* Qs = Vs + BK * LD;          // (BM, LD) scaled q
  float* dOs = Qs + BM * LD;         // (BM, LD)
  float* Ts = dOs + BM * LD;         // (BK, LDT): P^T, then dS^T
  float* lse_s = Ts + BK * LDT;      // (BM,)
  float* delta_s = lse_s + BM;       // (BM,)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nrows = p.Tq * p.G;
  const int k0 = blockIdx.x * BK;    // the first key tiles see the most rows
  const int b = blockIdx.y / p.KV, kv = blockIdx.y % p.KV;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + kv * p.q_skv;
  const float* d_o =
      static_cast<const float*>(p.d_o) + b * p.do_sb + kv * p.do_skv;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kv * p.k_skv;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kv * p.v_skv;

  load_keys<HD>(Ks, k, p.k_st, k0, p.Tk);
  load_keys<HD>(Vs, v, p.v_st, k0, p.Tk);
  float4 dk[4][DH], dv[4][DH];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < DH; ++h)
      dk[i][h] = dv[i][h] = make_float4(0.f, 0.f, 0.f, 0.f);

  // rows before position k0 see none of these keys
  const int rstart = p.causal ? (k0 * p.G) / BM * BM : 0;
  for (int r0 = rstart; r0 < nrows; r0 += BM) {
    __syncthreads();  // the previous row tile's Q, dO and dS are consumed
    load_rows<HD>(Qs, q, p.q_st, p.q_sg, r0, nrows, p.G, p.scale);
    load_rows<HD>(dOs, d_o, p.do_st, p.do_sg, r0, nrows, p.G, 1.f);
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
        Ts[(ty + 16 * i) * LDT + rr] = pr;
        st[i][c] = pr * (dpt[i][c] - delta_s[rr]);  // dS^T
      }
    __syncthreads();

    // dv += P^T dO
#pragma unroll 2
    for (int r = 0; r < BM; r += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = load4(Ts + (ty + 16 * i) * LDT + r);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int h = 0; h < DH; ++h) {
          const float4 ob = load4(dOs + (r + rr) * LD + 64 * h + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) fma4(dv[i][h], comp(pa[i], rr), ob);
        }
    }
    __syncthreads();  // P^T is consumed
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        Ts[(ty + 16 * i) * LDT + tx + 16 * c] = st[i][c];
    __syncthreads();

    // dk += dS^T (q * scale)
#pragma unroll 2
    for (int r = 0; r < BM; r += 4) {
      float4 sa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = load4(Ts + (ty + 16 * i) * LDT + r);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int h = 0; h < DH; ++h) {
          const float4 qb = load4(Qs + (r + rr) * LD + 64 * h + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) fma4(dk[i][h], comp(sa[i], rr), qb);
        }
    }
  }

  float* dkp = static_cast<float*>(p.dk);
  float* dvp = static_cast<float*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = k0 + ty + 16 * i;
    if (j >= p.Tk) continue;
    // contiguous (B, Tk, KV, hd)
    const long long row = ((long long)b * p.Tk + j) * p.KV + kv;
#pragma unroll
    for (int h = 0; h < DH; ++h) {
      if (HD % 64 && 64 * h + tx * 4 >= HD) continue;  // a zero column
      store4(dkp + row * HD + 64 * h + tx * 4, dk[i][h]);
      store4(dvp + row * HD + 64 * h + tx * 4, dv[i][h]);
    }
  }
}

// ---- bf16: the wgmma bodies ----------------------------------------------

constexpr int NWG = 2;              // consumer warpgroups a block
constexpr int ROWS = NWG * WG_M;    // dQ: rows a block (128)
constexpr int KEYS = 64;            // dQ: keys a tile
constexpr int BKEYS = NWG * WG_M;   // dK/dV: keys a block (128)
constexpr int RT = 64;              // dK/dV: rows a tile
// what a dK/dV launch computes: both (hd <= 128), or at hd 192 one pass
// for dV and one for dK
constexpr int DV_PASS = 1, DK_PASS = 2, DKV_FUSED = 3;

template <int HD>
constexpr int dq_smem_bytes() {     // Q, dO, then two stages of K and V
  return 1024 + (2 * ROWS + 4 * KEYS) * pad64(HD) * 2;
}
// a dK/dV stage: Q and dO, then each row's lse, delta and position (3 x
// RT x 4 bytes, padded so that the next stage's tiles start 1024-aligned)
template <int HD>
__host__ __device__ constexpr int dkv_stage_bytes() {
  return 2 * RT * pad64(HD) * 2 + 1024;
}
template <int HD>
constexpr int dkv_smem_bytes() {    // K, V, then two stages
  return 1024 + 2 * BKEYS * pad64(HD) * 2 + 2 * dkv_stage_bytes<HD>();
}

// dQ: one block per (tile of 128 rows, batch x KV head), heaviest first;
// two warpgroups of 64 rows loop over the 64-key tiles up to the diagonal.
template <int HD>
__global__ void __launch_bounds__(NWG * WG, 1)
flash_bwd_dq_wgmma_kernel(Params p) {
  constexpr int HP = pad64(HD);
  constexpr int TILE = ROWS * HP * 2, KV_BYTES = KEYS * HP * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Qs = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t dOs = Qs + TILE, ring = dOs + TILE;  // stage s: K, V

  const int nrows = p.Tq * p.G;
  const int ntiles = (nrows + ROWS - 1) / ROWS;
  const int nbk = gridDim.x / ntiles;
  const int r0 = (ntiles - 1 - (int)blockIdx.x / nbk) * ROWS;
  const int b = blockIdx.x % nbk / p.KV, kv = blockIdx.x % nbk % p.KV;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + kv * p.q_skv;
  const bf16* d_o =
      static_cast<const bf16*>(p.d_o) + b * p.do_sb + kv * p.do_skv;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + kv * p.k_skv;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + kv * p.v_skv;

  const int last = min(r0 + ROWS, nrows) - 1;
  const int kend = p.causal ? min(p.Tk, last / p.G + 1) : p.Tk;
  const int ntk = (kend + KEYS - 1) / KEYS;

  cp_rows<ROWS, HD, NWG * WG>(Qs, q, p.q_st, p.q_sg, r0, nrows, p.G);
  cp_rows<ROWS, HD, NWG * WG>(dOs, d_o, p.do_st, p.do_sg, r0, nrows, p.G);
  cp_keys<KEYS, HD, NWG * WG>(ring, k, p.k_st, 0, p.Tk);
  cp_keys<KEYS, HD, NWG * WG>(ring + KV_BYTES, v, p.v_st, 0, p.Tk);
  cp_async_commit();

  const int w = threadIdx.x / WG, t = threadIdx.x % WG;
  const int rw = w * WG_M + (t / 32) * 16 + (t % 32) / 4;   // and rw + 8
  const int cq = 2 * (t % 4);
  int qpos[2];
  float lse2[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + rw + 8 * h;
    const bool ok = r < nrows;
    const long long row = ok ? row_index(b, kv, r, p.Tq, p.KV, p.G) : 0;
    qpos[h] = ok ? r / p.G : -1;
    lse2[h] = ok ? p.lse[row] * LOG2E : 0.f;
    delta[h] = ok ? p.delta[row] : 0.f;
  }
  const uint32_t Qw = Qs + w * WG_M * 128, dOw = dOs + w * WG_M * 128;
  const float sl2 = p.scale * LOG2E;
  float dq[HP / 2];
#pragma unroll
  for (int e = 0; e < HP / 2; ++e) dq[e] = 0.f;

  for (int it = 0; it < ntk; ++it) {
    const uint32_t Ks = ring + (it & 1) * 2 * KV_BYTES, Vs = Ks + KV_BYTES;
    if (it + 1 < ntk) {
      const uint32_t nK = ring + ((it + 1) & 1) * 2 * KV_BYTES;
      cp_keys<KEYS, HD, NWG * WG>(nK, k, p.k_st, (it + 1) * KEYS, p.Tk);
      cp_keys<KEYS, HD, NWG * WG>(nK + KV_BYTES, v, p.v_st, (it + 1) * KEYS,
                                  p.Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();

    // S = Q K^T and dP = dO V^T
    float s[KEYS / 2], dp[KEYS / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, desc_k<ROWS>(Qw, kk), desc_k<KEYS>(Ks, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(dp, desc_k<ROWS>(dOw, kk), desc_k<KEYS>(Vs, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);

    // P = exp(s - lse), 0 where masked; dS = P (dP - delta), into s
    const int k0 = it * KEYS;
#pragma unroll
    for (int e = 0; e < KEYS / 2; ++e) {
      const int j = k0 + 8 * (e / 4) + cq + (e % 2), h = (e / 2) % 2;
      const bool ok = qpos[h] >= 0 && j < p.Tk && (!p.causal || j <= qpos[h]);
      const float pr = ok ? exp2f(s[e] * sl2 - lse2[h]) : 0.f;
      s[e] = pr * (dp[e] - delta[h]);
    }

    // dQ += dS_hi K + dS_lo K
    uint32_t dh[KEYS / 16][4], dl[KEYS / 16][4];
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) split_frag(s, kk, dh[kk], dl[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) {
      wgmma_rs<HP>(dq, dh[kk], desc_n<KEYS>(Ks, kk));
      wgmma_rs<HP>(dq, dl[kk], desc_n<KEYS>(Ks, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dq);
    __syncthreads();  // this stage's K and V are consumed
  }

  bf16* dqp = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + rw + 8 * h;
    if (r >= nrows) continue;
    const long long row = row_index(b, kv, r, p.Tq, p.KV, p.G);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      store2(dqp + row * HD + 8 * j + cq, dq[4 * j + 2 * h] * p.scale,
             dq[4 * j + 2 * h + 1] * p.scale);
  }
}

// dK/dV: one block per (tile of 128 keys, batch x KV head), the first key
// tiles (which see the most rows) first; two warpgroups of 64 keys (keys as
// wgmma's M) loop over the 64-row tiles from the diagonal on, each tile
// holding all G heads of its positions, so the loop is the sum over the
// group.  S^T = K Q^T and dP^T = V dO^T from shared memory; then dV +=
// P^T_hi dO + P^T_lo dO and dK += dS^T_hi Q + dS^T_lo Q with both A
// operands from the accumulators.  PASS: DKV_FUSED both; DV_PASS only S^T
// and dV (no V, no dP^T); DK_PASS S^T, dP^T and dK.
template <int HD, int PASS>
__global__ void __launch_bounds__(NWG * WG, 1)
flash_bwd_dkv_wgmma_kernel(Params p) {
  constexpr bool DV = PASS & DV_PASS, DK = PASS & DK_PASS;
  constexpr int HP = pad64(HD);
  constexpr int KTILE = BKEYS * HP * 2, RTILE = RT * HP * 2;
  constexpr int STAGE = dkv_stage_bytes<HD>();
  static_assert(3 * RT * 4 <= 1024, "row data fits its padding");
  static_assert(3 * RT <= NWG * WG, "a thread for each row datum");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t Ks = base, Vs = Ks + KTILE, ring = Vs + KTILE;

  const int nrows = p.Tq * p.G;
  const int nkt = (p.Tk + BKEYS - 1) / BKEYS;
  const int nbk = gridDim.x / nkt;
  const int k0 = (int)blockIdx.x / nbk * BKEYS;
  const int b = blockIdx.x % nbk / p.KV, kv = blockIdx.x % nbk % p.KV;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + kv * p.q_skv;
  const bf16* d_o =
      static_cast<const bf16*>(p.d_o) + b * p.do_sb + kv * p.do_skv;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + kv * p.k_skv;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + kv * p.v_skv;
  const long long lse0 = row_index(b, kv, 0, p.Tq, p.KV, p.G);

  // rows before position k0 see none of these keys
  const int rstart = p.causal ? (k0 * p.G) / RT * RT : 0;
  const int nrt = rstart < nrows ? (nrows - rstart + RT - 1) / RT : 0;

  // row tile i into stage s: Q and dO by cp.async, lse and delta of each
  // row (4 bytes each, contiguous (B, Tq, KV, G): row r of this head is at
  // lse0 + (r / G) * KV * G + r % G), and its position (-1 past the end)
  auto load_tile = [&](int i, int s) {
    const uint32_t st = ring + s * STAGE;
    const int r0 = rstart + i * RT;
    cp_rows<RT, HD, NWG * WG>(st, q, p.q_st, p.q_sg, r0, nrows, p.G);
    cp_rows<RT, HD, NWG * WG>(st + RTILE, d_o, p.do_st, p.do_sg, r0, nrows,
                              p.G);
    // threads 0 .. 2 RT - 1 copy lse and delta, the next RT the positions
    const int tid = threadIdx.x;
    if (tid < 2 * RT) {
      const int rr = tid % RT, r = r0 + rr;
      const bool ok = r < nrows;
      const long long at =
          ok ? lse0 + (long long)(r / p.G) * p.KV * p.G + r % p.G : 0;
      cp_async4(st + 2 * RTILE + tid * 4, (tid < RT ? p.lse : p.delta) + at,
                ok);
    } else if (tid < 3 * RT) {
      const int rr = tid - 2 * RT, r = r0 + rr;
      reinterpret_cast<int*>(gbase + (st - base) + 2 * RTILE)[2 * RT + rr] =
          r < nrows ? r / p.G : -1;
    }
  };

  cp_keys<BKEYS, HD, NWG * WG>(Ks, k, p.k_st, k0, p.Tk);
  if constexpr (DK) cp_keys<BKEYS, HD, NWG * WG>(Vs, v, p.v_st, k0, p.Tk);
  if (nrt > 0) load_tile(0, 0);
  cp_async_commit();

  const int w = threadIdx.x / WG, t = threadIdx.x % WG;
  const int kw = w * WG_M + (t / 32) * 16 + (t % 32) / 4;   // and kw + 8
  const int cq = 2 * (t % 4);
  const int jpos[2] = {k0 + kw, k0 + kw + 8};
  const uint32_t Kw = Ks + w * WG_M * 128, Vw = Vs + w * WG_M * 128;
  const float sl2 = p.scale * LOG2E;
  float dk[HP / 2], dv[HP / 2];
#pragma unroll
  for (int e = 0; e < HP / 2; ++e) dk[e] = dv[e] = 0.f;

  for (int it = 0; it < nrt; ++it) {
    const uint32_t Qt = ring + (it & 1) * STAGE, dOt = Qt + RTILE;
    const uint8_t* meta = gbase + (Qt - base) + 2 * RTILE;
    const float* lse_s = reinterpret_cast<const float*>(meta);
    const float* delta_s = lse_s + RT;
    const int* pos_s = reinterpret_cast<const int*>(delta_s + RT);
    if (it + 1 < nrt) {
      load_tile(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T (keys x rows)
    float s[RT / 2], dp[RT / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, desc_k<BKEYS>(Kw, kk), desc_k<RT>(Qt, kk), kk > 0);
    if constexpr (DK) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(dp, desc_k<BKEYS>(Vw, kk), desc_k<RT>(dOt, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    if constexpr (DK) reg_fence(dp);

    // P^T = exp(s - lse), 0 where masked, into s; dS^T = P^T (dP^T -
    // delta), into dp
#pragma unroll
    for (int e = 0; e < RT / 2; ++e) {
      const int c = 8 * (e / 4) + cq + (e % 2), h = (e / 2) % 2;
      const int pos = pos_s[c];
      const bool ok =
          pos >= 0 && jpos[h] < p.Tk && (!p.causal || jpos[h] <= pos);
      const float pr = ok ? exp2f(s[e] * sl2 - lse_s[c] * LOG2E) : 0.f;
      s[e] = pr;
      if constexpr (DK) dp[e] = pr * (dp[e] - delta_s[c]);
    }

    // dV += P^T_hi dO + P^T_lo dO;  dK += dS^T_hi Q + dS^T_lo Q
    uint32_t ph[RT / 16][4], pl[RT / 16][4], dh[RT / 16][4], dl[RT / 16][4];
#pragma unroll
    for (int kk = 0; kk < RT / 16; ++kk) {
      if constexpr (DV) split_frag(s, kk, ph[kk], pl[kk]);
      if constexpr (DK) split_frag(dp, kk, dh[kk], dl[kk]);
    }
    wgmma_fence();
    if constexpr (DV) {
#pragma unroll
      for (int kk = 0; kk < RT / 16; ++kk) {
        wgmma_rs<HP>(dv, ph[kk], desc_n<RT>(dOt, kk));
        wgmma_rs<HP>(dv, pl[kk], desc_n<RT>(dOt, kk));
      }
    }
    if constexpr (DK) {
#pragma unroll
      for (int kk = 0; kk < RT / 16; ++kk) {
        wgmma_rs<HP>(dk, dh[kk], desc_n<RT>(Qt, kk));
        wgmma_rs<HP>(dk, dl[kk], desc_n<RT>(Qt, kk));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    if constexpr (DV) reg_fence(dv);
    if constexpr (DK) reg_fence(dk);
    __syncthreads();  // this stage's Q, dO and row data are consumed
  }
  if (nrt == 0) cp_async_wait<0>();

  // dk = scale * dS^T Q (JAX: dS^T (q * scale)); contiguous (B, Tk, KV, hd)
  bf16* dkp = static_cast<bf16*>(p.dk);
  bf16* dvp = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (jpos[h] >= p.Tk) continue;
    const long long row = ((long long)b * p.Tk + jpos[h]) * p.KV + kv;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if constexpr (DK)
        store2(dkp + row * HD + 8 * j + cq, dk[4 * j + 2 * h] * p.scale,
               dk[4 * j + 2 * h + 1] * p.scale);
      if constexpr (DV)
        store2(dvp + row * HD + 8 * j + cq, dv[4 * j + 2 * h],
               dv[4 * j + 2 * h + 1]);
    }
  }
}

template <int HD, int PASS>
int launch_dkv(const Params& p, int B, cudaStream_t stream) {
  const int smem = dkv_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<HD, PASS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkv_wgmma_kernel<HD, PASS>
      <<<(p.Tk + BKEYS - 1) / BKEYS * B * p.KV, NWG * WG, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch(const Params& p, int B, cudaStream_t stream) {
  const int nrows = p.Tq * p.G;
  if constexpr (sizeof(T) == 2) {  // bf16: wgmma
    const int smem_dq = dq_smem_bytes<HD>();
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_wgmma_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
    if (e != cudaSuccess) return (int)e;
    flash_bwd_dq_wgmma_kernel<HD><<<(nrows + ROWS - 1) / ROWS * B * p.KV,
                                    NWG * WG, smem_dq, stream>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if constexpr (HD <= 128) {
      return launch_dkv<HD, DKV_FUSED>(p, B, stream);
    } else {  // one accumulator a launch (see the header)
      const int rc = launch_dkv<HD, DV_PASS>(p, B, stream);
      return rc != 0 ? rc : launch_dkv<HD, DK_PASS>(p, B, stream);
    }
  } else {  // fp32: FMAs
    constexpr int LD = pad64(HD) + 4;
    const int smem_dq =
        (2 * BM * LD + 2 * BK * LD + BM * (BK + 4)) * (int)sizeof(float);
    const int smem_dkv =
        (2 * BK * LD + 2 * BM * LD + BK * (BM + 4) + 2 * BM) *
        (int)sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dkv);
    if (e != cudaSuccess) return (int)e;
    flash_bwd_dq_kernel<HD><<<dim3((nrows + BM - 1) / BM, B * p.KV),
                                     THREADS, smem_dq, stream>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    flash_bwd_dkv_kernel<HD><<<dim3((p.Tk + BK - 1) / BK, B * p.KV),
                                      THREADS, smem_dkv, stream>>>(p);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int launch_hd(const Params& p, int B, int hd, cudaStream_t stream) {
  if (hd == 64) return launch<T, 64>(p, B, stream);
  if (hd == 112) return launch<T, 112>(p, B, stream);
  if (hd == 128) return launch<T, 128>(p, B, stream);
  return launch<T, 192>(p, B, stream);
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
  if (hd != 64 && hd != 112 && hd != 128 && hd != 192) return ERR_HEAD_DIM;
  if ((long long)B * KV > 65535) return ERR_GRID;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long* s = strides;
  Params p{q, k, v, d_o, lse, delta, dq, dk, dv, Tq, Tk, KV, G, causal,
           s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
           s[8], s[9], s[10], s[11], s[12], s[13], scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return launch_hd<float>(p, B, hd, st);
  return launch_hd<__nv_bfloat16>(p, B, hd, st);
}

const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
