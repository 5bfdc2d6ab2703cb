// flash_fwd — grouped-query softmax attention forward with the per-row
// logsumexp, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_fwd (body _fwd_kernel).
//
//   s[t,g,j] = (q[t,g,:] * scale) . k[j,:]          masked to NEG_INF where
//                                                    causal and j > t + q_offset
//   o[t,g,:] = softmax_j(s[t,g,:]) @ v                lse[t,g] = m + log(l)
//
//   q (B, Tq, KV, G, hd), k and v (B, Tk, KV, hd), read through their
//   element strides (the last dimension contiguous), fp32 or bf16, one
//   dtype; o (B, Tq, KV, G, hd) contiguous in q's dtype; lse (B, Tq, KV, G)
//   contiguous fp32.  hd is 64, 112, 128 or 192 (112 in a tile of 128
//   columns, the last 16 zeros: flash_common.cuh).  hd 192 is
//   DeepSeek-V3's MLA (models/mla.py): q and k of 128 + 64 columns, v of
//   128 padded with zeros to 192 by the caller, as the JAX package's
//   _flash_mla pads it, so one head dim runs through every product.
//
// Bound.  At StarCoder2-3B's training shape (B 4, T 4,096, 24 heads over
// 2 KV heads, hd 128, causal) one launch needs 4.12e11 flops (the causal
// half of 4*B*H*T^2*hd) against 0.2 GB of q, k, v and o: 0.417 ms at
// 989 TFLOP/s bf16 against 0.06 ms at 3.35 TB/s, so operations bound it,
// and only wgmma reaches the tensor cores' rate.
//
// Two bodies, chosen by dtype in launch<> and sharing only the header:
//
//   * bf16 (flash_fwd_wgmma_kernel): the products on the tensor cores.
//     S = Q.K^T is one bf16 product: its inputs are the model's bf16
//     tensors, so every product is exact and the sum fp32; the scale (with
//     log2(e) folded in for exp2) and the mask are applied to S in fp32.
//     P = exp(S - m) cannot go in as one bf16 rounding without eating most
//     of the check's per-element bound (0.8 of it where two terms use 0.45,
//     by a CPU emulation of the rounding), so P.V runs as two bf16
//     products, on hi = bf16(p) and lo = bf16(p - hi), into one fp32
//     accumulator: 3 products where the bound counts 2.  l sums the fp32
//     p.  The design:
//       - one block per (tile of 128 rows, batch x KV head), heaviest
//         tiles first across all heads (a 1-D grid); a row is one
//         (position, group head) pair, r = t*G + g, read through q's
//         strides, so every K/V tile serves all G heads of its positions;
//       - two consumer warpgroups, 64 rows each (wgmma's M); each holds its
//         S (64 x 64 keys, 32 fp32 a thread) and O (64 x hd) accumulators
//         and its rows' running max and sum in registers;
//       - a 2-stage cp.async ring of 64-key K and V tiles in the 128-byte-
//         swizzled layout (flash_common.cuh), the next tile loading while
//         the current one is used; Q is loaded once;
//       - S = Q.K^T from shared memory (m64n64k16, K K-major); the online
//         softmax in registers (exp2f, each row's four lanes joined by
//         shuffles); then O += P_hi.V + P_lo.V (m64n64k16 at hd 64,
//         m64n128k16 at hd 112 and 128, m64n192k16 at 192: one
//         instruction a k-step, O 96 fp32 a thread) with P from
//         the S accumulator in registers, whose layout is A's, and V read
//         N-major (wgmma's transpose of bf16 B);
//       - the causal tile skip, the ragged masks and NEG_INF = -1e30 as in
//         the fp32 body.
//   * fp32 (flash_fwd_kernel): every product and sum in fp32 from fp32
//     inputs as FMAs outside the tensor cores, as the TPU kernel computes
//     them.  fp32 attention runs only where the JAX kernel's exact fp32
//     arithmetic is the point (parity checks), so this body stays the
//     simple one: one block per (batch, KV head, tile of BM rows), the key
//     axis a loop over BK-key tiles with an online softmax, the tiles and
//     P in padded fp32 shared memory, 256 threads as 16 x 16 each owning 4
//     rows x 4 keys of S and 4 rows x hd/16 columns of O, tiles issued
//     heaviest first; a key tile wholly above every row's diagonal is
//     skipped; rows past the end are not stored, keys past it get p = 0.
#include "flash_common.cuh"

namespace {

constexpr int RPT = BM / 16;     // rows per thread
constexpr int CPT = BK / 16;     // keys per thread in S
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q; const void* k; const void* v;
  void* o; float* lse;
  int Tq, Tk, KV, G, causal, q_offset;
  long long q_sb, q_st, q_skv, q_sg;   // q's element strides
  long long k_sb, k_st, k_skv;         // k's
  long long v_sb, v_st, v_skv;         // v's
  float scale;
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(Params p) {
  constexpr int HP = pad64(HD);      // the tile's columns
  constexpr int LD = HP + 4;        // row stride of Q, K, V in shared memory
  constexpr int LDP = BK + 4;       // row stride of P
  constexpr int DH = HP / 64;       // float4 column groups per thread in O
  extern __shared__ float smem[];
  float* Qs = smem;                 // (BM, LD) scaled q
  float* Ks = Qs + BM * LD;         // (BK, LD)
  float* Vs = Ks + BK * LD;         // (BK, LD)
  float* Ps = Vs + BK * LD;         // (BM, LDP)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nrows = p.Tq * p.G;
  const int ntiles = (nrows + BM - 1) / BM;
  const int r0 = (ntiles - 1 - (int)blockIdx.x) * BM;  // heaviest first
  const int b = blockIdx.y / p.KV, kv = blockIdx.y % p.KV;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + kv * p.q_skv;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kv * p.k_skv;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kv * p.v_skv;

  // the Q tile, cast to fp32 and scaled once (JAX: q.astype(f32) * scale)
  load_rows<HD>(Qs, q, p.q_st, p.q_sg, r0, nrows, p.G, p.scale);

  int qpos[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + ty + 16 * i;
    qpos[i] = r < nrows ? r / p.G + p.q_offset : -1;
  }
  float m[RPT], l[RPT];
  float4 acc[RPT][DH];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int h = 0; h < DH; ++h) acc[i][h] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // keys past the last row's position are masked for every row: skip them
  const int last = min(r0 + BM, nrows) - 1;
  const int kend = p.causal ? min(p.Tk, last / p.G + p.q_offset + 1) : p.Tk;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_keys<HD>(Ks, k, p.k_st, k0, p.Tk);
    load_keys<HD>(Vs, v, p.v_st, k0, p.Tk);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[RPT], ka[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qa[i] = load4(Qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int c = 0; c < CPT; ++c) ka[c] = load4(Ks + (tx + 16 * c) * LD + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          s[i][c] = fmaf(qa[i].x, ka[c].x, s[i][c]);
          s[i][c] = fmaf(qa[i].y, ka[c].y, s[i][c]);
          s[i][c] = fmaf(qa[i].z, ka[c].z, s[i][c]);
          s[i][c] = fmaf(qa[i].w, ka[c].w, s[i][c]);
        }
    }

    // online softmax; a row's 64 keys live on the 16 lanes of its ty
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float tmax = NEG_INF;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = k0 + tx + 16 * c;
        const bool ok = j < p.Tk && (!p.causal || j <= qpos[i]);
        s[i][c] = ok ? s[i][c] : NEG_INF;
        tmax = fmaxf(tmax, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off, 16));
      const float mn = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - mn);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = k0 + tx + 16 * c;
        const float e = j < p.Tk ? expf(s[i][c] - mn) : 0.f;
        Ps[(ty + 16 * i) * LDP + tx + 16 * c] = e;
        psum += e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off, 16);
      l[i] = l[i] * alpha + psum;
      m[i] = mn;
#pragma unroll
      for (int h = 0; h < DH; ++h) {
        acc[i][h].x *= alpha; acc[i][h].y *= alpha;
        acc[i][h].z *= alpha; acc[i][h].w *= alpha;
      }
    }
    __syncthreads();

    // O += P V
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pa[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pa[i] = load4(Ps + (ty + 16 * i) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int h = 0; h < DH; ++h) {
          const float4 vb = load4(Vs + (j + jj) * LD + 64 * h + tx * 4);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float pv = jj == 0 ? pa[i].x : jj == 1 ? pa[i].y
                           : jj == 2 ? pa[i].z : pa[i].w;
            acc[i][h].x = fmaf(pv, vb.x, acc[i][h].x);
            acc[i][h].y = fmaf(pv, vb.y, acc[i][h].y);
            acc[i][h].z = fmaf(pv, vb.z, acc[i][h].z);
            acc[i][h].w = fmaf(pv, vb.w, acc[i][h].w);
          }
        }
      }
    }
  }

  // o = acc / l in q's dtype; lse = m + log(l)
  float* o = static_cast<float*>(p.o);
  const long long HDl = HD;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= nrows) continue;
    const long long row = row_index(b, kv, r, p.Tq, p.KV, p.G);
    const float inv = 1.f / l[i];
#pragma unroll
    for (int h = 0; h < DH; ++h) {
      if (HD % 64 && 64 * h + tx * 4 >= HD) continue;  // a zero column
      float4 y = acc[i][h];
      y.x *= inv; y.y *= inv; y.z *= inv; y.w *= inv;
      store4(o + row * HDl + 64 * h + tx * 4, y);
    }
    if (tx == 0) p.lse[row] = m[i] + logf(l[i]);
  }
}

// ---- bf16: the wgmma body ------------------------------------------------

constexpr int NWG = 2;              // consumer warpgroups a block
constexpr int ROWS = NWG * WG_M;    // rows a block: 128
constexpr int KEYS = 64;            // keys a tile (the S product's N)

template <int HD>
constexpr int fwd_smem_bytes() {    // Q, then two stages of K and V
  return 1024 + (ROWS + 4 * KEYS) * pad64(HD) * 2;
}

template <int HD>
__global__ void __launch_bounds__(NWG * WG, 1)
flash_fwd_wgmma_kernel(Params p) {
  constexpr int HP = pad64(HD), KV_BYTES = KEYS * HP * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Qs = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = Qs + ROWS * HP * 2;   // stage s: K, then V

  const int nrows = p.Tq * p.G;
  const int ntiles = (nrows + ROWS - 1) / ROWS;
  const int nbk = gridDim.x / ntiles;         // batch x KV heads
  const int r0 = (ntiles - 1 - (int)blockIdx.x / nbk) * ROWS;  // heaviest first
  const int b = blockIdx.x % nbk / p.KV, kv = blockIdx.x % nbk % p.KV;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + kv * p.q_skv;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + kv * p.k_skv;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + kv * p.v_skv;

  // keys past the last row's position are masked for every row: skip them
  const int last = min(r0 + ROWS, nrows) - 1;
  const int kend = p.causal ? min(p.Tk, last / p.G + p.q_offset + 1) : p.Tk;
  const int ntk = (kend + KEYS - 1) / KEYS;

  cp_rows<ROWS, HD, NWG * WG>(Qs, q, p.q_st, p.q_sg, r0, nrows, p.G);
  cp_keys<KEYS, HD, NWG * WG>(ring, k, p.k_st, 0, p.Tk);
  cp_keys<KEYS, HD, NWG * WG>(ring + KV_BYTES, v, p.v_st, 0, p.Tk);
  cp_async_commit();

  // this thread's two rows (wgmma's accumulator layout) and key columns
  const int w = threadIdx.x / WG, t = threadIdx.x % WG;
  const int rw = w * WG_M + (t / 32) * 16 + (t % 32) / 4;   // and rw + 8
  const int cq = 2 * (t % 4);
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + rw + 8 * h;
    qpos[h] = r < nrows ? r / p.G + p.q_offset : -1;
  }
  const uint32_t Qw = Qs + w * WG_M * 128;   // this warpgroup's 64 rows
  const float sl2 = p.scale * LOG2E;         // s in log2 units
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[HP / 2];
#pragma unroll
  for (int e = 0; e < HP / 2; ++e) o[e] = 0.f;

  for (int it = 0; it < ntk; ++it) {
    const uint32_t Ks = ring + (it & 1) * 2 * KV_BYTES, Vs = Ks + KV_BYTES;
    if (it + 1 < ntk) {  // the next tile into the other stage
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

    // S = Q K^T
    float s[KEYS / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, desc_k<ROWS>(Qw, kk), desc_k<KEYS>(Ks, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);

    // scale and mask (log2 units), then the online softmax; a row's 64 keys
    // live on its four lanes
    const int k0 = it * KEYS;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int e = 0; e < KEYS / 2; ++e) {
      const int j = k0 + 8 * (e / 4) + cq + (e % 2), h = (e / 2) % 2;
      const bool ok = j < p.Tk && (!p.causal || j <= qpos[h]);
      s[e] = ok ? s[e] * sl2 : NEG_INF;
      mx[h] = fmaxf(mx[h], s[e]);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f(m[h] - mn);
      m[h] = mn;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int e = 0; e < KEYS / 2; ++e) {
      const int j = k0 + 8 * (e / 4) + cq + (e % 2), h = (e / 2) % 2;
      s[e] = j < p.Tk ? exp2f(s[e] - m[h]) : 0.f;
      l[h] += s[e];
    }
#pragma unroll
    for (int e = 0; e < HP / 2; ++e) o[e] *= alpha[(e / 2) % 2];

    // O += P_hi V + P_lo V
    uint32_t ph[KEYS / 16][4], pl[KEYS / 16][4];
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) split_frag(s, kk, ph[kk], pl[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) {
      wgmma_rs<HP>(o, ph[kk], desc_n<KEYS>(Vs, kk));
      wgmma_rs<HP>(o, pl[kk], desc_n<KEYS>(Vs, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
    __syncthreads();  // this stage's K and V are consumed
  }

  // o = O / l in bf16; lse = m + log(l), m back in natural units
  bf16* op = static_cast<bf16*>(p.o);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = r0 + rw + 8 * h;
    if (r >= nrows) continue;
    const long long row = row_index(b, kv, r, p.Tq, p.KV, p.G);
    const float inv = 1.f / l[h];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      store2(op + row * HD + 8 * j + cq, o[4 * j + 2 * h] * inv,
             o[4 * j + 2 * h + 1] * inv);
    if (t % 4 == 0) p.lse[row] = m[h] * LN2 + logf(l[h]);
  }
}

template <typename T, int HD>
int launch(const Params& p, int B, cudaStream_t stream) {
  const int nrows = p.Tq * p.G;
  if constexpr (sizeof(T) == 2) {  // bf16: wgmma
    const int smem = fwd_smem_bytes<HD>();
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    const int grid = (nrows + ROWS - 1) / ROWS * B * p.KV;
    flash_fwd_wgmma_kernel<HD><<<grid, NWG * WG, smem, stream>>>(p);
  } else {  // fp32: FMAs
    constexpr int LD = pad64(HD) + 4;
    const int smem =
        (BM * LD + 2 * BK * LD + BM * (BK + 4)) * (int)sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((nrows + BM - 1) / BM, B * p.KV);
    flash_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(p);
  }
  return (int)cudaGetLastError();
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

// strides: q's (b, t, kv, g), then k's (b, t, kv), then v's (b, t, kv), in
// elements.  Returns 0, a CUDA error code, or a negative code for a shape
// the kernel does not take.
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int Tq, int Tk, int KV, int G, int hd,
              const long long* strides, int causal, int q_offset,
              float scale, int dtype, int device, void* stream) {
  if (hd != 64 && hd != 112 && hd != 128 && hd != 192) return ERR_HEAD_DIM;
  if ((long long)B * KV > 65535) return ERR_GRID;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Params p{q, k, v, o, lse, Tq, Tk, KV, G, causal, q_offset,
           strides[0], strides[1], strides[2], strides[3],
           strides[4], strides[5], strides[6],
           strides[7], strides[8], strides[9], scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return launch_hd<float>(p, B, hd, s);
  return launch_hd<__nv_bfloat16>(p, B, hd, s);
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
