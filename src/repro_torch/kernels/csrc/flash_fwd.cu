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
//   contiguous fp32.  hd is 64 or 128.  Every product and sum in fp32 from
//   fp32-cast inputs, as the TPU kernel computes them.
//
// Bound.  At StarCoder2-3B's training shape (B 4, T 4,096, 24 heads over
// 2 KV heads, hd 128, causal) one launch needs 4.12e11 flops (the causal
// half of 4*B*H*T^2*hd) against 0.2 GB of q, k, v and o: 0.417 ms at
// 989 TFLOP/s bf16 against 0.06 ms at 3.35 TB/s, so operations bound it.
// This kernel runs the products as fp32 FMAs outside the tensor cores
// (67 TFLOP/s at best), so it cannot come within 15x of that bound; the
// tensor-core form (wgmma on bf16 tiles) is later work.
//
// Design (simple and right first):
//   * one block per (batch, KV head, tile of BM query rows), where a row
//     is one (position, group head) pair: rows r = t*G + g of one KV head
//     are its G query heads at each position, so every K/V tile a block
//     loads serves all G heads (G = 12 for StarCoder2-3B);
//   * the key axis is a loop over tiles of BK keys with an online softmax
//     (running max m and sum l per row, fp32), since a whole K/V row of a
//     head does not fit in shared memory at T = 4,096;
//   * causal: a key tile that lies wholly above the diagonal of every row
//     of the block is skipped (it contributes exp(NEG_INF - m) = 0);
//     inside a tile the mask is NEG_INF = -1e30, as in the TPU kernel;
//   * ragged edges (Tq*G or Tk not a multiple of the tile) are masked in
//     the kernel: rows past the end are not stored, keys past the end get
//     p = 0;
//   * shared memory holds the scaled fp32 Q tile, the K and V tiles and P
//     (rows padded by 4 floats so 16-byte reads do not collide); 256
//     threads as 16 x 16, each owning 4 rows x 4 keys of S and 4 rows x
//     hd/16 columns of O, rows and keys interleaved by 16;
//   * the tiles are issued heaviest first (the last query tiles see the
//     most keys).
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

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(Params p) {
  constexpr int LD = HD + 4;        // row stride of Q, K, V in shared memory
  constexpr int LDP = BK + 4;       // row stride of P
  constexpr int DH = HD / 64;       // float4 column groups per thread in O
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
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + kv * p.q_skv;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kv * p.k_skv;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kv * p.v_skv;

  // the Q tile, cast to fp32 and scaled once (JAX: q.astype(f32) * scale)
  load_rows<T, HD>(Qs, q, p.q_st, p.q_sg, r0, nrows, p.G, p.scale);

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
    load_keys<T, HD>(Ks, k, p.k_st, k0, p.Tk);
    load_keys<T, HD>(Vs, v, p.v_st, k0, p.Tk);
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
  T* o = static_cast<T*>(p.o);
  const long long HDl = HD;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= nrows) continue;
    const long long row = row_index(b, kv, r, p.Tq, p.KV, p.G);
    const float inv = 1.f / l[i];
#pragma unroll
    for (int h = 0; h < DH; ++h) {
      float4 y = acc[i][h];
      y.x *= inv; y.y *= inv; y.z *= inv; y.w *= inv;
      store4(o + row * HDl + 64 * h + tx * 4, y);
    }
    if (tx == 0) p.lse[row] = m[i] + logf(l[i]);
  }
}

template <typename T, int HD>
int launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int LD = HD + 4;
  const int smem = (BM * LD + 2 * BK * LD + BM * (BK + 4)) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int nrows = p.Tq * p.G;
  const dim3 grid((nrows + BM - 1) / BM, B * p.KV);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
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
  if (hd != 64 && hd != 128) return ERR_HEAD_DIM;
  if ((long long)B * KV > 65535) return ERR_GRID;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Params p{q, k, v, o, lse, Tq, Tk, KV, G, causal, q_offset,
           strides[0], strides[1], strides[2], strides[3],
           strides[4], strides[5], strides[6],
           strides[7], strides[8], strides[9], scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return hd == 128 ? launch<float, 128>(p, B, s) : launch<float, 64>(p, B, s);
  return hd == 128 ? launch<__nv_bfloat16, 128>(p, B, s)
                   : launch<__nv_bfloat16, 64>(p, B, s);
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
