// conv1d_bwd_weight — the BRGEMM dilated conv1d weight gradient (the
// paper's Algorithm 4) with the bias gradient fused, hand-written for
// Hopper (sm_90a) on its tensor cores.
//
// Replaces the Pallas TPU kernel repro/kernels/conv1d_brgemm.py:688
// conv1d_bwd_weight (pallas_call at :751; bodies _bwd_w_kernel and
// _bwd_w_kernel_pipe).  The layout is that of its tap_packed algorithm
// (:322 _packed_bwd_w): the (S*C, K) gradient as one GEMM.
//
//   dw[s,k,c] = sum_n sum_q g[n,k,q] * x[n,c,q+s*d]        (S, K, C) fp32
//   dbias[k]  = sum_n sum_q g[n,k,q]                        (K,)      fp32
//
//   x (N, C, Wp) is the forward's padded input, Wp = Q + (S-1)*d; g
//   (N, K, Q) is the cotangent of the pre-activation.  x and g share one
//   dtype (fp32 or bf16); every sum runs in fp32.
//
// Bound on an H100.  At the AtacWorks layer (C=K=15, S=51, d=8, batch 8 x
// 60,000) the pass is 11.0 GFLOP over 57.8 MB.  In fp32 FMAs (67 TFLOP/s)
// that is 0.164 ms, the bound of the FMA kernel this one replaces.  On the
// TF32 tensor cores (495 TFLOP/s) the (S*C, K) GEMM in three terms is
// 33.0 GFLOP, 0.0668 ms; the bytes take 0.017 ms.  So the layer is bound
// by the tensor cores' operations.  The stem (1->15) and the heads (15->1)
// do 2.2 GFLOP in three terms (0.0045 ms) and are bound by their bytes
// (about 31 MB, 0.0092 ms).  The bodies below pad that work to wgmma's
// tiles (a head's 15 x 51 products a column run as 64 x 64).
//
// Design:
//   * fp32 in three TF32 terms: each operand v = hi + lo, hi = tf32(v) and
//     lo = tf32(v - hi), both rounded to nearest, ties away (cvt.rna's
//     rule, done as two integer operations); per k-step the products
//     lo.hi, hi.lo and hi.hi, small terms first, into one fp32
//     accumulator.  A product then carries about 2^-22 of its value, where
//     one term (2^-11) would miss chip_smoke's 1e-4 of max|dw|.  bf16 is
//     exact in tf32: one term.
//   * The reduction runs over the batch's columns, 8 at a time (wgmma
//     m64nNk8, tf32); A, built from the input, comes from registers; B,
//     built from the cotangent, from shared memory.  An n16 wgmma costs
//     about as much issue time as an n32 one on this card, so each body
//     makes its products as wide in N as the shape allows.
//   * The taps body (bwd_weight_partial_taps; K > 1 with d % 4 == 0, and
//     K == 1) puts the taps in wgmma's N.  Eight rows of the cotangent are
//     the eight rows of wgmma's core matrices (no swizzle), and the
//     descriptor's stride between groups of eight rows shifts each group
//     by taps:
//       - K > 1: the rows are 8 filters; TT = 13 groups, one tap (d
//         columns) apart, make n104 (S = 51 is 4 groups of 13).  A row
//         (c, j) is x[c, v + 13 j d], so D[(c, j), (G, r)] = dw[12 - G +
//         13 j, r, c]: M = C * ceil(S / 13) rows (60 of 64 at 15->15), and
//         6 wgmmas a k-step cover 16 filters where the (tap, channel) x
//         filter GEMM takes 36 n16 ones.  Its padded work is 8% over that
//         GEMM's at n16, 16% over the unpadded 765 x 15.
//       - K == 1: the rows are the cotangent shifted by 0..7 taps; 8
//         groups, 8 taps apart, make n64 = 64 taps.  A row c is x[c, v],
//         so D[c, n] = dw[S-1-n, 0, c].
//     A row of ones in A sums dbias against the unshifted group.  One
//     producer warpgroup fills a ring of stages (the input rows by
//     cp.async, the cotangent's hi and lo copies) while two consumer
//     warpgroups run the products: the two filter halves, or for K == 1
//     the two halves of each tile's k-steps.  Named barriers hand the
//     stages over.
//   * The unit body (bwd_weight_partial; the rest: the stem, d % 4 != 0):
//     rows M are the (tap, channel) pairs, columns N the filters (16 a
//     block, n16).  The block stages the dilated footprint x[n, :, q0 :
//     q0+TQ+(S-1)d] and the cotangent tile, split into hi and lo tiles
//     (128-byte swizzled); the element of row (s, c) and column j is
//     xs[c][j + s*d], read straight into wgmma's A fragment (no im2col).
//     Rows come in units of TAPS consecutive taps of one channel; a thread
//     carries two units, its six rows of three M tiles.  NWG warpgroups x
//     3 M tiles cover 256 units; with 64 or fewer (the stem: 17) the
//     warpgroups share them and split each tile's k-steps instead.  A
//     spare unit reads a row of ones: dbias.  A ring of up to 4 cp.async
//     stages.
//   * A's registers come in two sets: the next k-step's loads go to the
//     set that no product in flight reads, and each set is kept (keep())
//     past the wait that retires its products.  Rewriting a register an
//     in-flight wgmma reads, or a wgmma under a branch that differs
//     between warpgroups, makes ptxas serialize every wgmma of the
//     kernel; a wgmma under a branch while another group was in flight
//     gave wrong sums with no warning, so no loop has one.
//   * A split reduction with no atomics: block p (one an SM) takes a
//     contiguous range of the list of (sample, column tile) and writes one
//     row of partial sums; warpgroups that split k-steps add theirs in
//     warpgroup order; reduce_partials sums rows 0..P-1 in order.  Two
//     launches on the same inputs on the same card are bitwise equal.
//   * The ragged edges are masked in the kernel: the cotangent is staged
//     as zeros outside [0, Q), the input past Wp; no width round-up.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NWG = 4;                    // warpgroups a block
constexpr int BLOCK = NWG * WG;           // threads a block
constexpr int KSTEP = 8;                  // columns of one wgmma (k8 tf32)
constexpr int TQS[] = {384, 192};         // columns a tile, by preference
constexpr int MAX_STAGES = 4;             // cp.async ring, at most
constexpr int TT = 13;                    // taps body, K > 1: taps a group
constexpr int TR = 64;                    // taps body, K == 1: taps (n64)
constexpr int NF = 16;                    // filters a block (unit, taps)
constexpr int TAPS = 3;                   // unit body: taps of a unit
constexpr int UNITS = 2 * NWG * 32;       // unit body: units a block
constexpr int RBLOCK = 256;               // threads of reduce_partials
constexpr int SMEM_MAX = 232448;          // Hopper's per-block opt-in limit
constexpr int DT_F32 = 0;                 // dtype codes: 0 fp32, 1 bf16
constexpr int ERR_FOOTPRINT = -1;         // the footprint does not fit
constexpr int ERR_SHAPE = -2;             // beyond the grid's limits
constexpr int ERR_DEVICE = -3;            // the SM count cannot be read
constexpr int ERR_BODY = -4;              // a pinned body that may not run

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to tf32 (10 mantissa bits) to nearest, ties away from zero:
// for finite v what cvt.rna.tf32.f32 gives, in two integer operations
// where that instruction takes four
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v -> hi = tf32(v), lo = tf32(v - hi); bf16 (exact in tf32) -> hi = v,
// lo = 0
template <typename T>
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  if constexpr (sizeof(T) == 2) {
    hi = __float_as_uint(v);
    lo = 0u;
  } else {
    hi = tf32_rna(v);
    lo = tf32_rna(v - __uint_as_float(hi));
  }
}

// Keeps the values of a wgmma's A fragment in their registers up to this
// point.  The compiler sees the wgmma's inline asm read them at issue and
// may give their registers to later values, while the hardware reads them
// until wgmma_wait retires the group: each fragment is kept past the wait
// that retires its group.
template <int N>
__device__ __forceinline__ void keep(const uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" :: "r"(a[i]));
}

// wait until at most n (0 to MAX_STAGES - 1) cp.async groups are pending
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// d (64 x N, fp32) += A (64 x 8, tf32 fragments in registers) . B (8 x N),
// B tf32 in shared memory, K-major; N = 16, 64 or 104 (d has N / 2).
// A fragment: thread t of warp w holds rows 16w + t/4 (a[0], a[2]) and
// 16w + t/4 + 8 (a[1], a[3]), columns t%4 (a[0], a[1]) and t%4 + 4 (a[2],
// a[3]).  The accumulator: rows 16w + t/4 + 8h, columns 8j + 2(t%4) + c at
// d[4j + 2h + c].
#define WGMMA_TF32_OUT8(o)                                               \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),          \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
__device__ __forceinline__ void wgmma_tf32(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;"
      "\n}\n"
      : WGMMA_TF32_OUT8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WGMMA_TF32_OUT8(0), WGMMA_TF32_OUT8(8), WGMMA_TF32_OUT8(16),
        WGMMA_TF32_OUT8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[52],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51}, {%52, %53, %54, %55}, %56, p, 1, 1;\n}\n"
      : WGMMA_TF32_OUT8(0), WGMMA_TF32_OUT8(8), WGMMA_TF32_OUT8(16),
        WGMMA_TF32_OUT8(24), WGMMA_TF32_OUT8(32), WGMMA_TF32_OUT8(40),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef WGMMA_TF32_OUT8

// One k-step of one accumulator: the small terms first, then hi.hi; bf16
// (ONE) has no lo and takes hi.hi alone.
template <bool ONE, int NA>
__device__ __forceinline__ void terms(float (&d)[NA], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], uint64_t bh,
                                      uint64_t bl) {
  if constexpr (!ONE) {
    wgmma_tf32(d, al, bh);
    wgmma_tf32(d, ah, bl);
  }
  wgmma_tf32(d, ah, bh);
}

// wgmma's descriptor of a K-major operand with no swizzle: 8-row core
// matrices of 16-byte rows (128 contiguous bytes each); lbo the byte step
// to the next 4 columns (16 bytes of k), sbo the byte step to the next 8
// rows.
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// Bytes of one staged row of `cols` elements: rounded up to 16 (mod 128)
// bytes, so that rows start 16-byte aligned and consecutive rows fall 4
// banks apart.
__host__ __device__ __forceinline__ int row_bytes(int cols, int esize) {
  return (cols * esize + 111) / 128 * 128 + 16;
}

// The geometry of a launch, shared by the host functions and the kernels.
struct Geo {
  int body;        // BODY_UNIT or BODY_TAPS
  int rep;         // taps body with K == 1: shifted copies of one row
  int TQ, ns;      // columns a tile; stages of the ring
  int lag;         // taps body: the cotangent is read from v0 - lag on
  int xcols, xrow;      // staged input columns a row; row stride (elems)
  int grow;        // raw cotangent row stride (elements), if staged
  int ccols;       // taps body: columns of each copy of a cotangent row
  size_t fixed, stage;  // bytes outside and inside each stage
};
constexpr int BODY_UNIT = 0, BODY_TAPS = 1;

// Bytes the k-split warpgroups hand over at the end: NWG x WG x 24 fp32.
constexpr size_t SPLIT_BYTES = size_t(NWG) * WG * 24 * 4;

void geometry(int body, int C, int K, int S, int d, int TQ, int esize,
              Geo* g) {
  g->body = body;
  g->rep = body == BODY_TAPS && K == 1;
  g->TQ = TQ;
  g->grow = g->ccols = 0;
  if (body == BODY_UNIT) {
    g->lag = 0;
    g->xcols = TQ + ((S + TAPS - 1) / TAPS * TAPS - 1) * d;
    g->xrow = row_bytes(g->xcols, esize) / esize;
    g->grow = row_bytes(TQ, esize) / esize;
    // the hi and lo cotangent tiles (NF, TQ), 128-byte swizzled; a stage:
    // the input rows and a row of ones, then the raw cotangent rows
    g->fixed = 2 * size_t(NF) * TQ * 4;
    g->stage = (size_t(C + 1) * g->xrow + size_t(NF) * g->grow) * esize;
  } else {
    g->lag = (g->rep ? S - 1 : TT - 1) * d;
    g->xcols = g->rep ? TQ : TQ + ((S + TT - 1) / TT - 1) * TT * d;
    g->xrow = row_bytes(g->xcols, esize) / esize;
    g->ccols = g->rep ? TQ + (TR - 8) * d : TQ + g->lag;
    // a stage: the input rows and a row of ones, the hi and lo copies (8
    // shifted ones, or 16 filters' rows), and for the shifted copies the
    // raw cotangent row they are made from (copy 7 reads 7 taps on)
    g->grow = g->rep ? row_bytes(g->ccols + 7 * d, esize) / esize : 0;
    g->fixed = 0;
    g->stage = size_t(C + 1) * g->xrow * esize +
               2 * size_t(g->rep ? 8 : NF) * g->ccols * 4 +
               size_t(g->grow) * esize;
  }
  g->ns = 0;
  for (int ns = MAX_STAGES; ns >= 2; --ns) {
    const size_t b = g->fixed + ns * g->stage;
    if (1024 + (b > SPLIT_BYTES ? b : SPLIT_BYTES) <= SMEM_MAX) {
      g->ns = ns;
      break;
    }
  }
}

size_t smem_bytes(const Geo& g) {
  const size_t b = g.fixed + g.ns * g.stage;
  return 1024 + (b > SPLIT_BYTES ? b : SPLIT_BYTES);
}

// Plan of pass 1, shared by the host functions below: the body, TQ
// columns a tile, and as many column ranges (blocks along the grid's x,
// partial rows) as the card has SMs.  TQ does not depend on the dtype, so
// the rows conv1d_bwd_weight_rows reports hold for both.  `body` pins the
// body (PIN_UNIT, PIN_TAPS) or lets the shape choose it (PIN_NONE); the
// taps body needs K > 1 with C > 1 and d % 4 == 0 (its group stride is d
// columns, 16-byte aligned), or K == 1 with S <= TR.  A pinned body that
// may not run is refused (ERR_BODY), never replaced.
struct Plan {
  int body, TQ, ntiles, tiles, parts;
};
constexpr int PIN_NONE = 0, PIN_UNIT = 1, PIN_TAPS = 2;

int make_plan(int N, int C, int K, int S, int Wp, int dilation, int body,
              int device, Plan* p) {
  const int Q = Wp - (S - 1) * dilation;
  const bool taps_ok = (K == 1 && S <= TR) || (K > 1 && C > 1 &&
                                               dilation % 4 == 0);
  if ((body == PIN_TAPS && !taps_ok) || body < PIN_NONE || body > PIN_TAPS)
    return ERR_BODY;
  const bool taps = body == PIN_NONE ? taps_ok : body == PIN_TAPS;
  p->body = taps ? BODY_TAPS : BODY_UNIT;
  p->TQ = 0;
  Geo g;
  for (int tq : TQS) {
    geometry(p->body, C, K, S, dilation, tq, 4, &g);
    if (g.ns >= 2) {
      p->TQ = tq;
      break;
    }
  }
  if (p->TQ == 0) return ERR_FOOTPRINT;
  const int cols = Q + (taps ? g.lag : 0);
  p->ntiles = (cols + p->TQ - 1) / p->TQ;
  const long long tiles = (long long)N * p->ntiles;
  if (tiles > (1 << 30)) return ERR_SHAPE;
  p->tiles = int(tiles);
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return ERR_DEVICE;
  p->parts = p->tiles < sms ? p->tiles : sms;
  return 0;
}

struct Params {
  const void* x;
  const void* g;
  float* partial;
  int C, K, S, Wp, Q, d;
  Geo geo;
  int ntiles, tiles;        // tiles a sample, N * ntiles
  int rows;                 // taps body: A rows C * ceil(S / TT), or C
  int real_units, units;    // unit body: C * ceil(S / TAPS), + 1 (ones)
  int dbias;                // a bias gradient is summed
  int ks;                   // unit body: warpgroups that split k-steps
  int kgroups, row_len;     // filter groups; length of a partial row
  int vec_x, vec_g;         // 16-byte copies line up
};

// Columns [col0, col0 + count) of `rows` rows (row r at src + r * sstride;
// rows from nvalid on and columns outside [0, len) read as zeros) into
// shared memory at dst, row stride dstride, by cp.async: 16 bytes at a
// time when vec (src, sstride and col0 16-byte aligned), else one element
// at a time (bf16 by plain loads).
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int dstride, const T* src,
                                           long long sstride, int rows,
                                           int nvalid, int col0, int count,
                                           int len, bool vec, int tid,
                                           int nthreads) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int nch = (count + V - 1) / V;
    for (int i = tid; i < rows * nch; i += nthreads) {
      const int r = i / nch, j = i % nch * V, col = col0 + j;
      const int left = r < nvalid && col >= 0 ? len - col : 0;
      const int bytes =
          left <= 0 ? 0 : (left >= V ? 16 : left * int(sizeof(T)));
      cp_async16_part(smem_u32(dst + r * dstride + j),
                      bytes ? src + r * sstride + col : src, bytes);
    }
  } else {
    for (int i = tid; i < rows * count; i += nthreads) {
      const int r = i / count, j = i % count, col = col0 + j;
      const bool ok = r < nvalid && col >= 0 && col < len;
      if constexpr (sizeof(T) == 4)
        cp_async4(smem_u32(dst + r * dstride + j),
                  ok ? src + r * sstride + col : src, ok);
      else
        dst[r * dstride + j] =
            ok ? src[r * sstride + col] : from_f32<T>(0.f);
    }
  }
}

// The input rows of tile `tile` of the (sample, tile) list into a stage,
// by threads tid, tid + nthreads, ...: columns [v0, v0 + xcols), zeros
// past Wp.
template <typename T>
__device__ __forceinline__ void stage_x(const Params& p, uint8_t* stage,
                                        int tile, int tid, int nthreads) {
  const int n = tile / p.ntiles, v0 = tile % p.ntiles * p.geo.TQ;
  stage_rows(reinterpret_cast<T*>(stage), p.geo.xrow,
             static_cast<const T*>(p.x) + (long long)n * p.C * p.Wp, p.Wp,
             p.C, p.C, v0, p.geo.xcols, p.Wp, p.vec_x, tid, nthreads);
}

// The unit body's stage: the input rows, then the raw cotangent rows k0 ..
// k0 + NF, columns [v0, v0 + TQ) (zeros past K and Q).
template <typename T>
__device__ __forceinline__ void stage_tile(const Params& p, uint8_t* stage,
                                           int tile, int k0) {
  const Geo& G = p.geo;
  const int n = tile / p.ntiles, v0 = tile % p.ntiles * G.TQ;
  stage_x<T>(p, stage, tile, threadIdx.x, BLOCK);
  stage_rows(reinterpret_cast<T*>(stage) + (p.C + 1) * G.xrow, G.grow,
             static_cast<const T*>(p.g) + ((long long)n * p.K + k0) * p.Q,
             p.Q, NF, p.K - k0, v0, G.TQ, p.Q, p.vec_g, threadIdx.x, BLOCK);
}

// The block's shared memory: past 1024-byte alignment, the fixed part,
// then the stages; the row of ones (row C of each stage's input rows) is
// written once, by the block's nthreads threads.
template <typename T>
__device__ __forceinline__ uint8_t* smem_base(const Params& p,
                                              int nthreads) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* const base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  for (int st = 0; st < p.geo.ns; ++st) {
    T* ones = reinterpret_cast<T*>(base + p.geo.fixed + st * p.geo.stage) +
              p.C * p.geo.xrow;
    for (int j = threadIdx.x; j < p.geo.xrow; j += nthreads)
      ones[j] = from_f32<T>(1.f);
  }
  return base;
}

// The ring of stages around a tile's work: before the loop, the first
// ns - 1 tiles are in flight; tile it waits for its own copies, and the
// tile ns - 1 ahead is issued into the stage tile it-1 freed.
template <typename T>
__device__ __forceinline__ void ring_start(const Params& p, uint8_t* stages,
                                           int t_begin, int ntl, int k0) {
  for (int s = 0; s + 1 < p.geo.ns; ++s) {
    if (s < ntl) stage_tile<T>(p, stages + s * p.geo.stage, t_begin + s, k0);
    cp_async_commit();
  }
}
template <typename T>
__device__ __forceinline__ const uint8_t* ring_next(const Params& p,
                                                    uint8_t* stages, int it,
                                                    int t_begin, int ntl,
                                                    int k0) {
  const int ns = p.geo.ns, nxt = it + ns - 1;
  __syncthreads();  // tile it-1 is done with its stage and the fixed part
  if (nxt < ntl)
    stage_tile<T>(p, stages + nxt % ns * p.geo.stage, t_begin + nxt, k0);
  cp_async_commit();
  cp_async_wait_n(ns - 1);
  __syncthreads();  // tile it's copies are visible to all
  return stages + it % ns * p.geo.stage;
}

// Warpgroups that split k-steps hand their sums to the first of their set
// (part 0), which adds them in part order; every thread of the block
// calls it.  Warpgroup w is part w / nsets of set w % nsets.
template <int N>
__device__ __forceinline__ void gather_split(float* scratch, float* acc,
                                             int nsets) {
  const int wg = threadIdx.x / WG, t = threadIdx.x % WG;
  __syncthreads();  // every warpgroup is done with shared memory
  if (wg >= nsets)
#pragma unroll
    for (int e = 0; e < N; ++e) scratch[(wg * N + e) * WG + t] = acc[e];
  __syncthreads();
  if (wg < nsets)
    for (int w = wg + nsets; w < NWG; w += nsets)
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] += scratch[(w * N + e) * WG + t];
}

// ---- the taps body ---------------------------------------------------------

constexpr int TCONS = 2;                          // consumer warpgroups
constexpr int TBLOCK = (TCONS + 1) * WG;          // and one producer
constexpr int BAR_FULL = 1;                       // named barriers: FULL + s,
constexpr int BAR_EMPTY = BAR_FULL + MAX_STAGES;  // EMPTY + s, the
constexpr int BAR_CONS = BAR_EMPTY + MAX_STAGES;  // consumers alone,
constexpr int BAR_PROD = BAR_CONS + 1;            // the producer alone

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// The producer's cotangent: the hi and lo copies of a stage, made by the
// producer's thread t.  REP: copy r (0..7) at column j is raw[j + r d],
// raw (staged) being g[v0 - lag, ...); else row r of set s is filter k0 +
// 8s + r at column v0 - lag + j, read from device memory; zeros outside
// [0, Q) and past K.  As core matrices: columns 4m..4m+3 of row r are 16
// bytes at 128m + 16r.  Each thread has the loads of BATCH chunks of 4
// columns in flight before it splits them.
template <typename T, bool REP>
__device__ __forceinline__ void make_copies(const Params& p, uint8_t* copies,
                                            const T* raw, int tile, int k0,
                                            int t) {
  constexpr bool ONE = sizeof(T) == 2;
  constexpr int NSETS = REP ? 1 : 2;
  constexpr int BATCH = 4;
  const Geo& G = p.geo;
  const int n = tile / p.ntiles, v0 = tile % p.ntiles * G.TQ;
  const T* g = static_cast<const T*>(p.g) + (long long)n * p.K * p.Q;
  const int cbytes = 8 * G.ccols * 4, per = 2 * G.ccols;
  const int total = NSETS * per;
  for (int i0 = t; i0 < total; i0 += BATCH * WG) {
    float f[BATCH][4];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int i = i0 + b * WG;
      const int s = i / per, m = i % per, r = m % 8, j = m / 8 * 4;
      if constexpr (REP) {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          f[b][v] = i < total ? to_f32(raw[j + v + r * p.d]) : 0.f;
      } else {
        const int k = k0 + 8 * s + r, c0 = v0 - G.lag + j;
        const bool ok = i < total && k < p.K;
        const T* row = g + (long long)(ok ? k : 0) * p.Q;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int c = c0 + v;
          f[b][v] = ok && c >= 0 && c < p.Q ? to_f32(row[c]) : 0.f;
        }
      }
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int i = i0 + b * WG;
      if (i >= total) break;
      const int s = i / per, m = i % per;
      uint32_t hv[4], lv[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) split_tf32<T>(f[b][v], hv[v], lv[v]);
      *reinterpret_cast<uint4*>(copies + s * cbytes + 16 * m) =
          make_uint4(hv[0], hv[1], hv[2], hv[3]);
      if constexpr (!ONE)
        *reinterpret_cast<uint4*>(copies + (NSETS + s) * cbytes + 16 * m) =
            make_uint4(lv[0], lv[1], lv[2], lv[3]);
    }
  }
}

// Pass 1, the taps body.  Block (part, kgroup + kgroups * mchunk) sums the
// tiles [part * tiles / P, (part + 1) * tiles / P) of the (sample, tile)
// list, over the columns v of x, for 64 rows of A and 16 filters in
// groups of TT taps (or the one filter of K == 1).  Warpgroup TCONS (the
// producer) fills a ring of stages, each tile's input rows (cp.async) and
// cotangent copies; warpgroups 0 and 1 (the consumers: the two filter
// halves, or REP two halves of each tile's k-steps) run the products.
// Named barriers: FULL + s when a stage is filled, EMPTY + s when its
// products are done.  REP: K == 1.
template <typename T, bool REP>
__global__ void __launch_bounds__(TBLOCK, 1)
bwd_weight_partial_taps(const Params p) {
  constexpr bool ONE = sizeof(T) == 2;   // bf16: one term
  constexpr int NB = REP ? TR : 8 * TT;  // wgmma's N: 64 or 104
  constexpr int NA = NB / 2;             // accumulators a thread
  constexpr int NSETS = REP ? 1 : 2;     // filter halves
  constexpr int NPART = TCONS / NSETS;   // k-step shares a tile
  const Geo& G = p.geo;
  uint8_t* const base = smem_base<T>(p, TBLOCK);
  const int xbytes = (p.C + 1) * G.xrow * int(sizeof(T));
  const int cbytes = 8 * G.ccols * 4;    // 8 copies or 8 filters' rows

  const int tid = threadIdx.x, wg = tid / WG, t = tid % WG, q = t % 4;
  const int part = blockIdx.x;
  const int kg = blockIdx.y % p.kgroups, mc = blockIdx.y / p.kgroups;
  const int k0 = kg * NF;
  const int t_begin = (long long)part * p.tiles / gridDim.x;
  const int ntl = (long long)(part + 1) * p.tiles / gridDim.x - t_begin;
  const int ns = G.ns;
  __syncthreads();  // the rows of ones are written

  if (wg == TCONS) {  // the producer
    for (int it = 0; it < ntl; ++it) {
      const int s = it % ns;
      uint8_t* stage = base + s * G.stage;
      if (it >= ns) bar_sync(BAR_EMPTY + s, TBLOCK);
      stage_x<T>(p, stage, t_begin + it, t, WG);
      T* raw = reinterpret_cast<T*>(stage + xbytes + 2 * NSETS * cbytes);
      if constexpr (REP) {  // the raw row, for the copies to read
        const int tile = t_begin + it;
        stage_rows(raw, G.grow,
                   static_cast<const T*>(p.g) +
                       (long long)(tile / p.ntiles) * p.Q,
                   p.Q, 1, 1, tile % p.ntiles * G.TQ - G.lag, G.grow, p.Q,
                   p.vec_g, t, WG);
        cp_async_commit();
        cp_async_wait<0>();
        bar_sync(BAR_PROD, WG);
      } else {
        cp_async_commit();
      }
      make_copies<T, REP>(p, stage + xbytes, raw, t_begin + it, k0, t);
      cp_async_wait<0>();
      fence_async_smem();  // the copies are visible to wgmma
      bar_arrive(BAR_FULL + s, TBLOCK);
    }
    return;
  }

  const int set = wg % NSETS, share = wg / NSETS;
  const int steps = G.TQ / KSTEP;
  const int kb = share * steps / NPART, ke = (share + 1) * steps / NPART;
  // this thread's A rows 64 mc + 16 (t / 32) + t % 32 / 4 + 8h: row j C +
  // c is x[c, v + TT j d] (REP: j = 0), then the row of ones; the rest
  // (padding, whose sums are dropped) read row 0
  int off[2], row[2];
  bool has[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * mc + t / 32 * 16 + t % 32 / 4 + 8 * h;
    row[h] = r;
    has[h] = r < p.rows || (r == p.rows && p.dbias);
    off[h] = (r < p.rows ? r % p.C * G.xrow + r / p.C * TT * p.d
                         : has[h] ? p.C * G.xrow : 0) + q;
  }
  // B: the next 4 columns' core matrix is 128 bytes on; the next 8 rows
  // are one tap (d columns) on, or eight taps for the shifted copies; k-step
  // kk starts 8 columns (2 core matrices, 256 bytes) on
  const uint32_t sbo = (REP ? 8 : 1) * p.d / 4 * 128;
  float acc[NA];
#pragma unroll
  for (int e = 0; e < NA; ++e) acc[e] = 0.f;

  for (int it = 0; it < ntl; ++it) {
    const int s = it % ns;
    const uint8_t* stage = base + s * G.stage;
    bar_sync(BAR_FULL + s, TBLOCK);
    const T* xs = reinterpret_cast<const T*>(stage);
    const uint32_t cs = smem_u32(stage + xbytes);
    const uint64_t dh = desc_plain(cs + set * cbytes, 128, sbo);
    const uint64_t dl = desc_plain(cs + (NSETS + set) * cbytes, 128, sbo);
    // A's fragment: rows h = 0, 1 at a[h] (column q) and a[h + 2] (q + 4),
    // two sets: one step's products stay in flight while the next step's
    // A is loaded into the set no product in flight reads (steps a share
    // are even: TQ is a multiple of 192)
    uint32_t ah[2][4], al[2][4];
    auto load = [&](int kk, uint32_t (&h4)[4], uint32_t (&l4)[4]) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int v = 0; v < 2; ++v)
          split_tf32<T>(to_f32(xs[off[h] + kk * KSTEP + 4 * v]),
                        h4[h + 2 * v], l4[h + 2 * v]);
    };
    auto step = [&](int kk, int i) {  // issue step kk from set i
      wgmma_fence();
      terms<ONE>(acc, ah[i], al[i], dh + 16 * kk, dl + 16 * kk);
      wgmma_commit();
    };
    // step kb, then steps kk + 1 and kk + 2 a pass, each issued before the
    // previous one is waited for; no wgmma under a branch
    load(kb, ah[0], al[0]);
    step(kb, 0);
    int kk = kb;
    for (; kk + 2 < ke; kk += 2) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        load(kk + i + 1, ah[i ^ 1], al[i ^ 1]);
        step(kk + i + 1, i ^ 1);
        wgmma_wait<1>();  // step kk + i's products are done
        keep(ah[i]);
        keep(al[i]);
      }
    }
    load(kk + 1, ah[1], al[1]);  // the last step (a share's steps are even)
    step(kk + 1, 1);
    wgmma_wait<1>();
    keep(ah[0]);
    keep(al[0]);
    wgmma_wait<0>();
    keep(ah[1]);
    keep(al[1]);
    if (it + ns < ntl) bar_arrive(BAR_EMPTY + s, TBLOCK);
  }
  reg_fence(acc);
  if constexpr (NPART > 1) {  // the second share hands its sums over
    float* scratch = reinterpret_cast<float*>(base);
    bar_sync(BAR_CONS, TCONS * WG);  // both are done with shared memory
    if (share > 0)
#pragma unroll
      for (int e = 0; e < NA; ++e) scratch[e * WG + t] = acc[e];
    bar_sync(BAR_CONS, TCONS * WG);
    if (share > 0) return;
#pragma unroll
    for (int e = 0; e < NA; ++e) acc[e] += scratch[e * WG + t];
  }

  // D's rows row[h], columns 8j + 2q + cc at acc[4j + 2h + cc]: group j,
  // row 2q + cc of its 8
  float* out = p.partial + (long long)part * p.row_len;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!has[h]) continue;
    const int r = row[h];
#pragma unroll
    for (int j = 0; j < NB / 8; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const float v = acc[4 * j + 2 * h + cc];
        const int n = 8 * j + 2 * q + cc;
        // tap s and filter k of column n: REP n -> (S-1-n, 0); else group
        // j is tap TT-1-j of row r's TT, 2q + cc the set's filter
        const int s = REP ? p.S - 1 - n : TT - 1 - j + r / p.C * TT;
        const int k = REP ? 0 : k0 + 8 * set + 2 * q + cc;
        if (k >= p.K || s < 0) continue;
        if (r < p.rows) {
          if (s < p.S) out[((long long)s * p.K + k) * p.C + r % p.C] = v;
        } else if (REP ? n == p.S - 1 : j == TT - 1) {  // unshifted: dbias
          out[(long long)p.S * p.K * p.C + k] = v;
        }
      }
  }
}

// ---- the unit body ---------------------------------------------------------

// The two values (columns q and q + 4 of a k-step) of one row at element
// offset off of the footprint, as tf32 hi and lo.
template <typename T>
__device__ __forceinline__ void load_row(const T* xs, int off,
                                         uint32_t (&hi)[2],
                                         uint32_t (&lo)[2]) {
#pragma unroll
  for (int v = 0; v < 2; ++v)
    split_tf32<T>(to_f32(xs[off + 4 * v]), hi[v], lo[v]);
}

// The A fragment of M tile i of a thread: its rows 2i (a[0], a[2]) and
// 2i + 1 (a[1], a[3]), row r being tap r % TAPS of unit r / TAPS.
template <int I>
__device__ __forceinline__ void frag(const uint32_t (&w)[2][TAPS][2],
                                     uint32_t (&a)[4]) {
  constexpr int r0 = 2 * I, r1 = 2 * I + 1;
  a[0] = w[r0 / TAPS][r0 % TAPS][0];
  a[1] = w[r1 / TAPS][r1 % TAPS][0];
  a[2] = w[r0 / TAPS][r0 % TAPS][1];
  a[3] = w[r1 / TAPS][r1 % TAPS][1];
}

// Pass 1, the unit body.  Block (part, kgroup + kgroups * mchunk) sums the
// column tiles [part * tiles / P, (part + 1) * tiles / P) of the (sample,
// tile) list for its filter group and its units into one row of partial
// sums.  B3: some slot has a second unit, so M tile 2 (the second
// unit's taps 1 and 2) has rows.  Every warpgroup runs every product of
// its tiles, padding included: a wgmma under a branch that differs
// between warpgroups makes ptxas serialize them all.
template <typename T, bool B3>
__global__ void __launch_bounds__(BLOCK, 1)
bwd_weight_partial(const Params p) {
  constexpr bool ONE = sizeof(T) == 2;  // bf16: one term
  constexpr int NA = NF / 2;            // accumulators a thread an M tile
  const Geo& G = p.geo;
  uint8_t* const base = smem_base<T>(p, BLOCK);
  const int gbytes = NF * G.TQ * 4;     // one cotangent tile, hi or lo
  uint8_t* const ghi = base;
  uint8_t* const glo = base + gbytes;
  // K-major, swizzled: k-step kk is 32 bytes on inside a 128-byte row,
  // the next 4 k-steps NF rows of 128 bytes on
  const uint64_t dh = desc_k<NF>(smem_u32(ghi), 0);
  const uint64_t dl = desc_k<NF>(smem_u32(glo), 0);
  uint8_t* const stages = base + G.fixed;

  const int tid = threadIdx.x;
  const int part = blockIdx.x;
  const int kg = blockIdx.y % p.kgroups, mc = blockIdx.y / p.kgroups;
  const int k0 = kg * NF;
  const int t_begin = (long long)part * p.tiles / gridDim.x;
  const int ntl = (long long)(part + 1) * p.tiles / gridDim.x - t_begin;

  // this thread's row slot (a warp's group of 4 lanes) and its two units,
  // u0 and u0 + half: real units tap-major (consecutive units on
  // consecutive channels), then the ones unit, then padding (row 0).  The
  // ks warpgroups of a set share its slots and split its k-steps.
  const int wg = tid / WG, t = tid % WG, q = t % 4;
  const int nsets = NWG / p.ks, set = wg % nsets, share = wg / nsets;
  const int cap = UNITS / p.ks, half = cap / 2;
  const int first = mc * cap + set * 32;  // the set's first unit
  const int u0 = first + t / 4;
  int off[2];  // element offset of the unit's tap 0 at column q
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int u = u0 + h * half;
    int c = 0, s = 0;
    if (u < p.real_units) {
      c = u % p.C;
      s = u / p.C * TAPS;
    } else if (u < p.units) {
      c = p.C;  // the row of ones
    }
    off[h] = c * G.xrow + s * p.d + q;
  }
  float acc[3][NA];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int e = 0; e < NA; ++e) acc[i][e] = 0.f;
  const int steps = G.TQ / KSTEP;
  const int kb = share * steps / p.ks, ke = (share + 1) * steps / p.ks;

  ring_start<T>(p, stages, t_begin, ntl, k0);
  for (int it = 0; it < ntl; ++it) {
    const uint8_t* stage = ring_next<T>(p, stages, it, t_begin, ntl, k0);
    const T* xs = reinterpret_cast<const T*>(stage);
    const T* gs = xs + (p.C + 1) * G.xrow;
    // the cotangent tile as tf32 hi and lo, K-major and swizzled
    for (int j = tid; j < NF * G.TQ / 4; j += BLOCK) {
      const int r = j / (G.TQ / 4), c4 = j % (G.TQ / 4);
      uint32_t hv[4], lv[4];
#pragma unroll
      for (int v = 0; v < 4; ++v)
        split_tf32<T>(to_f32(gs[r * G.grow + 4 * c4 + v]), hv[v], lv[v]);
      const uint32_t o = sw128<NF>(r, c4);
      *reinterpret_cast<uint4*>(ghi + o) =
          make_uint4(hv[0], hv[1], hv[2], hv[3]);
      if constexpr (!ONE)
        *reinterpret_cast<uint4*>(glo + o) =
            make_uint4(lv[0], lv[1], lv[2], lv[3]);
    }
    fence_async_smem();
    __syncthreads();  // the hi and lo tiles are visible to wgmma

    // w[set][unit][tap][value]: each unit's taps at a step, two sets: the
    // next step's go to the set no product in flight reads (a warpgroup's
    // steps are even: TQ is a multiple of 192)
    uint32_t wh[2][2][TAPS][2], wl[2][2][TAPS][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < TAPS; ++e)
        load_row(xs, off[h] + e * p.d + kb * KSTEP, wh[0][h][e], wl[0][h][e]);
    for (int kk = kb; kk < ke; kk += 2) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t ah[3][4], al[3][4];
        frag<0>(wh[i], ah[0]);
        frag<1>(wh[i], ah[1]);
        frag<2>(wh[i], ah[2]);
        frag<0>(wl[i], al[0]);
        frag<1>(wl[i], al[1]);
        frag<2>(wl[i], al[2]);
        const int k1 = kk + i;
        const int kd = (k1 >> 2) * NF * 8 + (k1 & 3) * 2;  // 16-byte units
        const uint64_t bh = dh + kd, bl = dl + kd;
        wgmma_fence();
        terms<ONE>(acc[0], ah[0], al[0], bh, bl);
        terms<ONE>(acc[1], ah[1], al[1], bh, bl);
        if constexpr (B3) terms<ONE>(acc[2], ah[2], al[2], bh, bl);
        wgmma_commit();
        // the taps at step k1 + 1 while the products run (past the last
        // step they are read within the stage and go unused)
        const int col = (k1 + 1) * KSTEP;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < TAPS; ++e)
            load_row(xs, off[h] + e * p.d + col, wh[i ^ 1][h][e],
                     wl[i ^ 1][h][e]);
        wgmma_wait<0>();
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          keep(ah[m]);
          keep(al[m]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) reg_fence(acc[i]);
  }
  if (p.ks > 1) {
    gather_split<3 * NA>(reinterpret_cast<float*>(base), &acc[0][0], nsets);
    if (share > 0) return;
  }

  // one row of partial sums per column range: thread row r = 2i + h of M
  // tile i holds filters 8j + 2q + cc at acc[i][4j + 2h + cc]
  float* out = p.partial + (long long)part * p.row_len;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 2 * i + h;
      const int u = u0 + r / TAPS * half, e = r % TAPS;
      long long o0;  // index of filter 0; filter k at o0 + k * step
      int step;
      if (u < p.real_units) {
        const int s = u / p.C * TAPS + e;
        if (s >= p.S) continue;
        o0 = (long long)s * p.K * p.C + u % p.C;
        step = p.C;
      } else if (u < p.units && e == 0) {  // the ones unit: dbias
        o0 = (long long)p.S * p.K * p.C;
        step = 1;
      } else {
        continue;
      }
#pragma unroll
      for (int j = 0; j < NF / 8; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int k = k0 + 8 * j + 2 * q + cc;
          if (k < p.K)
            out[o0 + (long long)k * step] = acc[i][4 * j + 2 * h + cc];
        }
    }
}

// out[o] = sum_{p=0..P-1} partial[p][o], in that order; o < n_dw goes to
// dw, the rest to dbias.
__global__ void __launch_bounds__(RBLOCK)
reduce_partials(const float* __restrict__ partial, float* __restrict__ dw,
                float* __restrict__ dbias, int P, int row_len, int n_dw) {
  const int o = blockIdx.x * RBLOCK + threadIdx.x;
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

template <typename Kernel>
int launch(Kernel kernel, int threads, const Params& p, dim3 grid,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(p.geo);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  kernel<<<grid, threads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename T>
int launch_dtype(const Params& p, dim3 grid, cudaStream_t stream) {
  if (p.geo.body == BODY_TAPS)
    return p.geo.rep ? launch(bwd_weight_partial_taps<T, true>, TBLOCK, p,
                              grid, stream)
                     : launch(bwd_weight_partial_taps<T, false>, TBLOCK, p,
                              grid, stream);
  // a second unit in some slot: more units than the first halves hold
  return p.units > UNITS / p.ks / 2
             ? launch(bwd_weight_partial<T, true>, BLOCK, p, grid, stream)
             : launch(bwd_weight_partial<T, false>, BLOCK, p, grid, stream);
}

}  // namespace

extern "C" {

// Rows of fp32 partial sums conv1d_bwd_weight needs as scratch, each
// S*K*C (+K with dbias) long: one per column range.  A negative value is
// an error: -1 the footprint cannot fit in shared memory, -2 a shape
// beyond the grid's limits, -3 the SM count could not be read, -4 the
// pinned body may not run this shape.  body: 0 the shape's own choice,
// 1 the unit body, 2 the taps body.
int conv1d_bwd_weight_rows(int N, int C, int K, int S, int Wp, int dilation,
                           int body, int device) {
  Plan pl;
  const int rc = make_plan(N, C, K, S, Wp, dilation, body, device, &pl);
  return rc != 0 ? rc : pl.parts;
}

// The body a launch with this `body` argument takes (1 unit, 2 taps), or
// a negative code as conv1d_bwd_weight_rows.
int conv1d_bwd_weight_body(int N, int C, int K, int S, int Wp, int dilation,
                           int body, int device) {
  Plan pl;
  const int rc = make_plan(N, C, K, S, Wp, dilation, body, device, &pl);
  return rc != 0 ? rc : pl.body == BODY_TAPS ? PIN_TAPS : PIN_UNIT;
}

// Launches both passes on `stream` of GPU `device` and returns
// cudaGetLastError() after them (0 on success), or a negative code as
// conv1d_bwd_weight_rows.  dtype: 0 = fp32, 1 = bf16.  dbias may be null
// (then no bias gradient is summed).  `partial` holds
// conv1d_bwd_weight_rows(...) rows for the same `body`.
int conv1d_bwd_weight(const void* x, const void* g, void* partial, void* dw,
                      void* dbias, int N, int C, int K, int S, int Wp,
                      int dilation, int dtype, int body, int device,
                      void* stream) {
  // this library links its own CUDA runtime: select the tensors' GPU in it
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  Plan pl;
  const int rc = make_plan(N, C, K, S, Wp, dilation, body, device, &pl);
  if (rc != 0) return rc;
  const int esize = dtype == DT_F32 ? 4 : 2;
  Params p;
  p.x = x;
  p.g = g;
  p.partial = static_cast<float*>(partial);
  p.C = C;
  p.K = K;
  p.S = S;
  p.Wp = Wp;
  p.Q = Wp - (S - 1) * dilation;
  p.d = dilation;
  geometry(pl.body, C, K, S, dilation, pl.TQ, esize, &p.geo);
  p.ntiles = pl.ntiles;
  p.tiles = pl.tiles;
  p.dbias = dbias != nullptr;
  const int n_dw = S * K * C;
  p.row_len = n_dw + (p.dbias ? K : 0);
  p.kgroups = (K + NF - 1) / NF;
  // 16-byte copies: rows and their first columns 16-byte aligned
  p.vec_x = reinterpret_cast<uintptr_t>(x) % 16 == 0 && Wp * esize % 16 == 0;
  p.vec_g = reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
            p.Q * esize % 16 == 0 && p.geo.lag * esize % 16 == 0;
  long long mchunks;
  if (pl.body == BODY_TAPS) {
    p.rows = C * (p.geo.rep ? 1 : (S + TT - 1) / TT);
    p.real_units = p.units = 0;
    p.ks = 1;
    mchunks = (p.rows + p.dbias + WG_M - 1) / WG_M;
  } else {
    p.rows = 0;
    p.real_units = C * ((S + TAPS - 1) / TAPS);
    p.units = p.real_units + p.dbias;
    // a unit set that fits one warpgroup's slots: all four split its steps
    p.ks = p.units <= UNITS / NWG ? NWG : 1;
    mchunks = (p.units + UNITS / p.ks - 1) / (UNITS / p.ks);
  }
  const long long gy = p.kgroups * mchunks;
  if (gy > 65535) return ERR_SHAPE;
  const dim3 grid(pl.parts, unsigned(gy));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lr = dtype == DT_F32 ? launch_dtype<float>(p, grid, st)
                                 : launch_dtype<bf16>(p, grid, st);
  if (lr != 0) return lr;
  reduce_partials<<<(p.row_len + RBLOCK - 1) / RBLOCK, RBLOCK, 0, st>>>(
      p.partial, static_cast<float*>(dw), static_cast<float*>(dbias),
      pl.parts, p.row_len, n_dw);
  return int(cudaGetLastError());
}

const char* conv1d_bwd_weight_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
