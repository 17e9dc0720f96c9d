// Flash-attention backward for Hopper (sm_90a) on the tensor cores, with a
// plain C interface that vaeplay_torch/ops/attention.py binds with ctypes.
//
// Replaces no Pallas kernel: the TPU side's backward is the JAX package's
// einsum VJP vaeplay_tpu/ops/attention.py:_pallas_attention_bwd (XLA's
// products, the N x N softmax in memory). This computes the same gradients
// of unscaled softmax attention, out = softmax(q k^T) v, with no N x N
// buffer in device memory:
//
//   S  = q k^T, recomputed tile by tile;  P = exp(min(S - lse, 0)), lse each
//        query row's log-sum-exp, written by the forward kernel;
//   dV = P^T g;   dP = g v^T;   dS = P o (dP - delta), delta_i = g_i . out_i;
//   dQ = dS k;    dK = dS^T q.
//
// q, k: (B, N, Dk); v, out, g: (B, N, Dv); f32 (flash_attention_bwd) or bf16
// (flash_attention_bwd_bf16), each with its element strides (batch, position,
// channel), read where the model keeps them; the gradients are written in
// the inputs' type with their own strides.
//
// Arithmetic: every product on the TF32 tensor cores, f32-accurate. An f32
// operand is split into big = tf32(x) and small = tf32(x - big), a product
// is big*big + big*small + small*big summed in f32 (3xTF32, as the forward
// kernel). A bf16 operand is exact in TF32 (small = 0), so the passes with a
// zero small part are skipped: S and dP take one pass, dV, dK and dQ two (P
// and dS split against the exact side). P and dS are never rounded to bf16.
// delta comes from out as the forward leaves it, as flash attention's
// backward takes it: with bf16 operands that is the bf16 output (P rounded
// to bf16 in its P.V, the result rounded once), where the plain
// attention_backward recomputes the output in f32. dS's rows then sum to
// that rounding rather than to 0, and dQ and dK lie up to about 5e-3 of
// their largest magnitude from the plain version's (tests/
// test_torch_attention.py emulates it); dV, which delta does not reach,
// agrees to f32 rounding.
//
// The recomputed scores. S is recomputed here in other instructions and
// another order than the forward's, so it differs from the scores behind lse
// by its rounding, which grows with |S| (about 2^-21 of sum_c |q_c k_c| for
// 3xTF32). Unscaled attention, as the models have it, reaches |S| of 1e5 to
// 1e10 once training grows q and k. There S - lse can lie thousands above or
// below 0: exp would overflow to inf and dS to NaN, or drop the row's max.
// And there nearly every row is one-hot: its true dS is 0 (the plain
// backward's exactly, as delta = sum_j P dP then equals the max's dP), but
// delta = g . out and dP, computed apart, differ by their rounding, and that
// difference times k or q would be a gradient of noise where the true one
// is 0. So the forward flags the one-hot rows (hopper.cuh: ONE_HOT) beside
// lse, and here a one-hot row's dS is 0 (the dK/dQ kernel takes its P as
// exp(S - inf) = 0) and its P for dV is exp(min(S - lse + T, 0)) with T =
// 2^-19 |lse| + 2^-12 above the rounding: 1 at its max, and elsewhere at
// most e^T times the true share, which is under 2^-20 (every other key lies
// at least 13.8 below the max). Every other row's P is bounded by its true
// bound, P <= 1, which changes nothing where |S| is moderate; a row with
// large scores that is not one-hot has P off by exp of the rounding, as any
// recomputation from lse has (ROADMAP queue 4 item 1).
//
// What bounds it on this card. At BP's training shape (B 8, N 2048, Dk 90,
// Dv 720) one call is 2 B N^2 (3 Dk + 2 Dv) = 114.8 GFLOP of products on
// about 0.2 GB of inputs and gradients: bound by operations, 0.70 ms as
// 3xTF32 at 495 TFLOP/s (bf16 operands: S and dP once at the bf16 rate of
// 989 TFLOP/s, dV, dK and dQ two TF32 passes: 0.30 ms). The
// design executes 2 B N^2 ((3 x 96 + 768) + (736 + 3 x 96)), 1.22x that, and
// streams the key tile's v and the query tile's g through shared memory
// for dP, which no tile of registers can hold at Dv = 720.
//
// Design: on the caller's stream, the scratch zeroed, then five launches.
//   1. delta = sum_c g out in f32, 4 threads a row, and what the next two
//      take from S for P (lse, but in a one-hot row: the note above).
//   2. dV: grid (key tiles of 128, value slices, B), 2 warpgroups of 64 keys.
//      A slice is up to 4 chunks of 64 columns (the fewest slices, 3 at Dv =
//      720). Over query tiles of 32: the Q tile split and transposed into
//      rows of queries (in the score order below), the g tile split into
//      rows of value columns, both in the 128-byte swizzle; S^T = K Q^T on
//      wgmma m64n32k8 (A = the staged K, split in registers, an atom of 32
//      channels loading while the last one's products run); P = exp(S^T -
//      lse); dV += P^T g on wgmma (m64n256k8 over a full slice, else
//      m64n64k8 a chunk) with A = P straight from the score accumulators: a
//      score column g of n-tile j is query 8j + sigma(g), sigma(2t) = t and
//      sigma(2t + 1) = t + 4, so the columns 2t, 2t + 1 a thread holds are
//      the k columns t, t + 4 of an A fragment.
//   3. dK and dQ: grid (key tiles of 128, query groups, B), 2 warpgroups of
//      64 keys; the groups share out the query tiles so that about 128
//      blocks, a wave, work on one batch. Over query tiles of 128: dP^T =
//      v g^T on wgmma m64n128k8 over Dv in chunks of 32 channels (A = the
//      warp's keys of the v chunk, split in registers; B = the g chunk split
//      and transposed into rows of queries), the chunks through a ring of
//      two cp.async slots (one where shared memory is short). Then per
//      half tile of 64 queries: the Q half split into rows of channels; S^T
//      on mma.sync m16n8k8 (each pass over all n-tiles in turn); dS^T = P o
//      (dP^T - delta) in registers (0 at N = 1, where a softmax has no score
//      gradient); dK += dS^T q on wgmma (m64nNk8, N = Dk rounded up to 32);
//      dS^T to shared memory, dQ = dS k on mma.sync, the half's dQ added
//      into an f32 (B, N, Dkp) sum by one bulk reduction of the TMA engine
//      (cp.reduce.async.bulk), and at the end the block's dK likewise.
//   4, 5. dq and dk written from their sums in q's and k's type and layout
//      (32 x 32 transposes through shared memory).
// Tiles are filled by cp.async (16, 8 or 4 bytes, as the operand's strides
// and address allow) or, for any other strides, by the threads' own loads;
// positions past N and channels past Dk or Dv arrive as zeros, and P is 0
// for keys and queries past N. Staged rows are padded to 8 mod 32 words, so
// that the fragment reads (4 rows of 8 neighbours) are free of bank
// conflicts.

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = uint16_t;  // the bits of a bfloat16

constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_DK = 128;
constexpr int BKEY = 128;     // keys per block (dV and dK/dQ kernels)
constexpr int DV_BQ = 32;     // queries per tile, dV kernel
constexpr int BQ = 128;       // queries per tile of the dP product, dK/dQ kernel
constexpr int HQ = 64;        // queries per half tile of its other products
constexpr int CHUNK = 32;     // value channels per chunk of the dP product
constexpr int VCOLS = 64;     // value columns per chunk of the dV product (m64n64k8)
constexpr int MAX_VC = 4;     // dV chunks a block, at most (128 accumulators a thread)
constexpr int MAX_DKC = 4;    // Dk chunks of 32 (dK's m64n32k8): MAX_DK / 32
constexpr int MAX_NKT = 8;    // Dk n-tiles per warp in dQ: (MAX_DK / 8) / 2
constexpr int TILE = 32 * 32; // floats of a swizzled tile of 32 rows of 128 bytes
constexpr int SMEM_MAX = 232448;

// Operand types: f32 (split into two TF32 parts) or bf16 (exact in TF32).
template <typename T>
struct Op;
template <>
struct Op<float> {
  static constexpr bool EXACT = false;
  static __device__ float get(float x) { return x; }
  static __device__ float put(float x) { return x; }
};
template <>
struct Op<bf16> {
  static constexpr bool EXACT = true;
  static __device__ float get(bf16 x) { return __uint_as_float(uint32_t(x) << 16); }
  static __device__ bf16 put(float x) {
    bf16 r;
    asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(r) : "f"(x));
    return r;
  }
};

// Row stride, in elements, of a staged tile of `pos` positions a channel
// row: 8 mod 32 words, so that fragment reads of 4 rows of 8 neighbours are
// free of bank conflicts; a multiple of 16 bytes.
template <typename T>
__host__ __device__ constexpr int stride_a(int pos) { return pos + 32 / int(sizeof(T)); }

// The TF32 split, as csrc/flash_attention.cu: the tensor cores read the top
// 19 bits; adding 0x1000 first rounds to nearest, big is masked so that
// x - big is exact.
__device__ __forceinline__ uint32_t tf32_round(uint32_t bits) { return bits + 0x1000u; }
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  if (EXACT) {
    big = __float_as_uint(x);
    small = 0;
  } else {
    big = tf32_round(__float_as_uint(x)) & 0xffffe000u;
    small = tf32_round(__float_as_uint(x - __uint_as_float(big)));
  }
}

struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};
template <bool EXACT>
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split<EXACT>(a0, f.big[0], f.small[0]);
  split<EXACT>(a1, f.big[1], f.small[1]);
  split<EXACT>(a2, f.big[2], f.small[2]);
  split<EXACT>(a3, f.big[3], f.small[3]);
  return f;
}
template <bool EXACT>
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split<EXACT>(b0, f.big[0], f.small[0]);
  split<EXACT>(b1, f.big[1], f.small[1]);
  return f;
}

// c += a . b on one 16x8x8 TF32 tile (PTX fragment layouts: a row-major
// 16x8, b column-major 8x8, c 16x8 in f32).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// c[j] += a . b[j] for j < nb in the passes the operands need, the small
// terms first (small*big where A is not exact, big*small where B is not,
// big*big), pass by pass over the n-tiles
template <bool AX, bool BX, int NB>
__device__ __forceinline__ void mma_rows(float (&c)[NB][4], const FragA& a, const FragB (&b)[NB],
                                         int nb) {
  if (!AX)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j < nb) mma(c[j], a.small, b[j].big);
  if (!BX)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j < nb) mma(c[j], a.big, b[j].small);
#pragma unroll
  for (int j = 0; j < NB; ++j)
    if (j < nb) mma(c[j], a.big, b[j].big);
}

// The query a score product's n-tile column reads: column g of n-tile j is
// query 8j + sigma(g), so that accumulator columns 2t and 2t + 1 are queries
// t and t + 4, the k columns of an A fragment.
__device__ __forceinline__ int sigma(int g) { return (g >> 1) | ((g & 1) << 2); }

template <int WIDTH>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, int bytes) {
  if (WIDTH == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(WIDTH), "r"(bytes)
                 : "memory");
}

// Copies positions pos0 .. pos0 + npos - 1 of channels ch0 .. ch0 + rows - 1
// of batch b of src (element strides s: batch, position, channel) into rows
// 0 .. rows - 1 of a tile of row stride ld elements; zeros for positions
// past n and channels past `limit`. width: bytes a cp.async copy (16, 8 or
// 4: position stride 1, address and strides aligned to it; neighbouring
// threads take neighbouring units of a row), or 0: the threads' own loads
// from any strides (neighbouring threads on neighbouring positions where
// the position stride is 1, else on neighbouring channels). Every thread of
// the block calls it.
template <int WIDTH, typename T>
__device__ __forceinline__ void load_rows_async(T* dst, int ld, const T* src, const T* base,
                                                int64_t cs, int pos0, int npos, int ch0, int rows,
                                                int n, int limit) {
  // npos and the elements a copy are powers of two, so a thread keeps one
  // unit of a row and steps down the rows by fixed strides
  constexpr int PER = WIDTH / int(sizeof(T));
  const int units = npos / PER, rstep = THREADS / units, r0 = threadIdx.x / units;
  const int u = threadIdx.x & (units - 1), pos = pos0 + u * PER;
  const int bytes = min(max(n - pos, 0), PER) * int(sizeof(T));
  const T* from = base + pos + (ch0 + r0) * cs;
  T* to = dst + r0 * ld + u * PER;
  for (int r = r0; r < rows; r += rstep, from += rstep * cs, to += rstep * ld) {
    const int got = ch0 + r < limit ? bytes : 0;
    cp_async_zfill<WIDTH>(to, got ? from : src, got);
  }
}

template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, const int64_t (&s)[3],
                                          int64_t b, int pos0, int npos, int ch0, int rows, int n,
                                          int limit, int width) {
  const T* base = src + b * s[0];
  const int tid = threadIdx.x;
  if (width == 16) return load_rows_async<16>(dst, ld, src, base, s[2], pos0, npos, ch0, rows, n, limit);
  if (width == 8) return load_rows_async<8>(dst, ld, src, base, s[2], pos0, npos, ch0, rows, n, limit);
  if (width == 4) return load_rows_async<4>(dst, ld, src, base, s[2], pos0, npos, ch0, rows, n, limit);
  const bool pos_fast = s[1] == 1;
  constexpr int BATCH = 4;
  for (int e0 = tid; e0 < rows * npos; e0 += BATCH * THREADS) {
    T x[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int e = e0 + i * THREADS;
      const int r = pos_fast ? e / npos : e % rows, j = pos_fast ? e % npos : e / rows;
      const int pos = pos0 + j, ch = ch0 + r;
      x[i] = e < rows * npos && pos < n && ch < limit ? base[pos * s[1] + int64_t(ch) * s[2]] : T(0);
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int e = e0 + i * THREADS;
      if (e >= rows * npos) break;
      const int r = pos_fast ? e / npos : e % rows, j = pos_fast ? e % npos : e / rows;
      dst[r * ld + j] = x[i];
    }
  }
}

// wgmma m64nNk8 TF32 (N = 8 NT) with A from registers (this warp's 16 rows
// in the mma.sync A layout) and B K-major from a swizzled tile (hopper.cuh:
// tile_desc): d (64 x N, this thread's part in the mma C layout of NT
// n-tiles) += A . B.
template <int NT>
__device__ __forceinline__ void wgmma_tf32(float (&d)[NT][4], const uint32_t (&a)[4], uint64_t b) {
  static_assert(NT == 4 || NT == 8 || NT == 12 || NT == 16 || NT == 32, "an instantiated N");
  if constexpr (NT == 4) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
  if constexpr (NT == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
  if constexpr (NT == 12) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
  if constexpr (NT == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
  if constexpr (NT == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]), "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]), "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]), "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]), "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]), "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]), "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]), "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]), "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]), "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]), "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]), "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]), "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]), "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]), "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}
// d += A . B in the passes the operands need, the small terms first; B's
// big and small parts are two tiles of one layout, `big` and `small` the
// k-step's start in each
template <bool AX, bool BX, int NT>
__device__ __forceinline__ void wgmma3(float (&d)[NT][4], const FragA& a, const float* big,
                                       const float* small) {
  if (!AX) wgmma_tf32(d, a.small, tile_desc(big));
  if (!BX) wgmma_tf32(d, a.big, tile_desc(small));
  wgmma_tf32(d, a.big, tile_desc(big));
}
// NT n-tiles of an accumulator of more, from n-tile j
template <int NT, int ALL>
__device__ __forceinline__ float (&part(float (&d)[ALL][4], int j))[NT][4] {
  return *reinterpret_cast<float(*)[NT][4]>(&d[j]);
}
// Keeps the compiler from moving an accumulator while a wgmma owns it.
template <int NT>
__device__ __forceinline__ void pin(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// Four neighbouring elements of a staged row (16 bytes of f32, 8 of bf16,
// aligned so) as f32
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(v.x << 16), x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16), x[3] = __uint_as_float(v.y & 0xffff0000u);
}

// Keeps a fragment set in its registers up to this point: the wgmma that
// read it may still be running, so its registers must not be reused.
__device__ __forceinline__ void keep(const FragA (&f)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" ::"r"(f[k].big[e]), "r"(f[k].small[e]));
}
__device__ __forceinline__ void wgmma_wait_prior() {  // all but the newest committed group
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Split passes: a staged tile (rows of T, row stride ld) into the big and
// (unless exact) small parts of swizzled f32 tiles of 128-byte rows, 16
// bytes (4 positions) a unit. As it is: row r, positions 32s..32s+31 of the
// staged rows go to row r of sub-tile s (sub-tiles `sub` floats apart);
// rows from `rows` on are zeros.
template <typename T>
__device__ __forceinline__ void split_rows(float* big, float* small, int sub, const T* st, int ld,
                                           int rows, int out_rows, int npos) {
  constexpr bool X = Op<T>::EXACT;
  const int units = npos / 4, lg = __ffs(units) - 1;  // (npos: 32 or 64)
  for (int e = threadIdx.x; e < out_rows * units; e += THREADS) {
    const int r = e >> lg, u = e & (units - 1), s = u >> 3, uu = u & 7;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < rows) load4(st + r * ld + 4 * u, x);
    uint4 b4, s4;
    split<X>(x[0], b4.x, s4.x);
    split<X>(x[1], b4.y, s4.y);
    split<X>(x[2], b4.z, s4.z);
    split<X>(x[3], b4.w, s4.w);
    const int at = s * (sub / 4) + 8 * r + (uu ^ (r & 7));
    reinterpret_cast<uint4*>(big)[at] = b4;
    if (!X) reinterpret_cast<uint4*>(small)[at] = s4;
  }
}
// Transposed: channels c0..c0+3 of staged position column q (staged rows are
// channels, `rows` of them, then zeros) go to row r of the swizzled tile,
// where q = 8 (r / 8) + sigma(r % 8) (the score products' column order),
// channels 32a..32a+31 to sub-tile a (`sub` floats apart).
template <typename T>
__device__ __forceinline__ void split_cols(float* big, float* small, int sub, const T* st, int ld,
                                           int rows, int out_rows, int chans) {
  constexpr bool X = Op<T>::EXACT;
  const int units = chans / 4, lg = __ffs(out_rows) - 1;  // (out_rows: 32 or 64)
  for (int e = threadIdx.x; e < out_rows * units; e += THREADS) {
    const int r = e & (out_rows - 1), u = e >> lg, a = u >> 3, uu = u & 7;
    const int q = (r & ~7) | sigma(r & 7);
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = 4 * u + i < rows ? Op<T>::get(st[(4 * u + i) * ld + q]) : 0.f;
    uint4 b4, s4;
    split<X>(x[0], b4.x, s4.x);
    split<X>(x[1], b4.y, s4.y);
    split<X>(x[2], b4.z, s4.z);
    split<X>(x[3], b4.w, s4.w);
    const int at = a * (sub / 4) + 8 * r + (uu ^ (r & 7));
    reinterpret_cast<uint4*>(big)[at] = b4;
    if (!X) reinterpret_cast<uint4*>(small)[at] = s4;
  }
}

// Floats of the dK/dQ kernel's two aliased regions: the split half Q tile,
// dS^T or the staged dK; the transposed g chunk or the staged half Q tile
// (whole 1024-float units, so that what follows stays aligned).
__host__ __device__ inline int qsw_region(int dkc) {
  return 4 * dkc * TILE > BKEY * stride_a<float>(HQ) ? 4 * dkc * TILE : BKEY * stride_a<float>(HQ);
}
template <typename T>
__host__ __device__ inline int gsw_region(int dkp) {
  const int staged = (dkp * stride_a<T>(HQ) * int(sizeof(T)) / 4 + TILE - 1) / TILE * TILE;
  return 8 * TILE > staged ? 8 * TILE : staged;
}

template <typename T>
struct Params {
  const T *q, *k, *v, *out, *g;
  const float* lse;     // (B, N) f32, contiguous
  const float* onehot;  // (B, N) f32, contiguous: 1 where the row is one-hot, else 0
  float* delta;         // (B, N) f32, contiguous
  float *ldv, *lkq;     // (B, N) f32, contiguous: what the dV and dK/dQ kernels take from S
  float *dq_acc, *dk_acc;  // (B, N, dkp) f32, contiguous, zeroed
  T *dq, *dk, *dv;
  int64_t sq[3], sk[3], sv[3], so[3], sg[3], sdq[3], sdk[3], sdv[3];  // (batch, position, channel)
  int n, dk_, dv_, dkp;
  int dkc;             // Dk in chunks of 32 (the swizzled Q tiles' rows or sub-tiles)
  int wq, wk, wv, wg;  // cp.async widths (bytes) of q, k, v, g; 0: the threads' loads
  int chunks, slices;  // dV kernel: value chunks of 64 in all; blocks along Dv
  int vc;              // dV kernel: chunks a block at most (shared memory is sized for it)
  int cslots;          // dK/dQ kernel: slots of the value-chunk ring (2, or 1 where 2 do not fit)
  int qgroups;         // dK/dQ kernel: blocks a key tile, each over a share of the query tiles
};

// acc[...] += a dense f32 tile staged in shared memory, by the TMA engine's
// bulk reduction (one instruction, issued by one thread after a barrier that
// follows every thread's writes and proxy fence); `bytes` a multiple of 16.
// The staging may be written again once bulk_wait_read has returned.
__device__ __forceinline__ void bulk_reduce_add(float* acc, const float* staged, int bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;"
               ::"l"(acc), "r"(smem_addr(staged)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;" ::: "memory"); }

// delta[b, i] = sum_c g[b, i, c] out[b, i, c] in f32: a block of 256
// threads takes 64 rows, 4 threads a row (each every 4th channel, so that a
// warp reads 32 neighbouring rows of channel-major g and out at a time),
// their sums added by shuffles
template <typename T>
__global__ void __launch_bounds__(256) flash_attention_bwd_delta(const Params<T> p) {
  const int r = threadIdx.x & 63, part = threadIdx.x >> 6;
  const int i = blockIdx.x * 64 + r;
  const int64_t b = blockIdx.y;
  __shared__ float sums[4][64];
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (i < p.n) {
    const T* g = p.g + b * p.sg[0] + i * p.sg[1];
    const T* o = p.out + b * p.so[0] + i * p.so[1];
    int c = part;
    for (; c + 12 < p.dv_; c += 16)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        acc[u] = fmaf(Op<T>::get(g[(c + 4 * u) * p.sg[2]]), Op<T>::get(o[(c + 4 * u) * p.so[2]]),
                      acc[u]);
    for (; c < p.dv_; c += 4)
      acc[0] = fmaf(Op<T>::get(g[c * p.sg[2]]), Op<T>::get(o[c * p.so[2]]), acc[0]);
  }
  sums[part][r] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  __syncthreads();
  if (part == 0 && i < p.n) {
    p.delta[b * p.n + i] = (sums[0][r] + sums[1][r]) + (sums[2][r] + sums[3][r]);
    // P = exp(min(S - l, 0)): l = lse, but in a one-hot row (the note on the
    // recomputed scores) lse less the recomputation's rounding for dV, so
    // that P is 1 at the row's max and at most e^T times its true share,
    // under 2^-20, elsewhere; and +inf for dK/dQ, so that P and dS are 0
    const float l = p.lse[b * p.n + i];
    const bool hot = p.onehot[b * p.n + i] != 0.f;
    p.ldv[b * p.n + i] = hot ? l - (0x1p-19f * fabsf(l) + 0x1p-12f) : l;
    p.lkq[b * p.n + i] = hot ? __int_as_float(0x7f800000) : l;
  }
}

// dV = P^T g over one key tile and one value slice. Per query tile of 32:
// S^T (64 keys a warpgroup x 32 queries) on wgmma m64n32k8 with A = K from
// the staged key tile (split in registers) and B = the Q tile transposed
// into rows of Dk (queries in the score order); P = exp(S^T - lse); dV +=
// P^T g on wgmma m64n64k8, A = P from the score accumulators, B = the g tile
// (rows of 32 queries, one per value column) in chunks of 64 columns.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_bwd_dv(const Params<T> p) {
  constexpr bool X = Op<T>::EXACT;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int n = p.n, dkp = p.dkp, dkc = p.dkc, vc = p.vc;
  constexpr int LDK = stride_a<T>(BKEY), LDS = stride_a<T>(DV_BQ);
  float* gsw = reinterpret_cast<float*>(smem);  // big, small: [vc x 64 rows][32 queries]
  float* qsw = gsw + 2 * vc * 2 * TILE;         // big, small: [dkc atoms][32 queries][32]
  T* ks = reinterpret_cast<T*>(qsw + 2 * dkc * TILE);  // [dkp][LDK]: K of the key tile
  T* qst = ks + dkp * LDK;                             // [dkp][LDS]: staged Q tile
  T* gst = qst + dkp * LDS;                            // [vc x 64][LDS]: staged g tile
  float* ls = reinterpret_cast<float*>(gst + vc * 64 * LDS);  // 2 x [DV_BQ]: ldv

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BKEY;
  const int ch0 = blockIdx.y * p.chunks / p.slices;
  const int nc = (blockIdx.y + 1) * p.chunks / p.slices - ch0, c0 = ch0 * VCOLS;
  const int64_t b = blockIdx.z;
  const int nq = (n + DV_BQ - 1) / DV_BQ;
  const int64_t lse_s[3] = {n, 1, 0};
  float* gbig = gsw;
  float* gsmall = gsw + vc * 2 * TILE;
  float* qbig = qsw;
  float* qsmall = qsw + dkc * TILE;

  auto issue = [&](int it) {
    load_rows(qst, LDS, p.q, p.sq, b, it * DV_BQ, DV_BQ, 0, dkp, n, p.dk_, p.wq);
    load_rows(gst, LDS, p.g, p.sg, b, it * DV_BQ, DV_BQ, c0, nc * VCOLS, n, p.dv_, p.wg);
    load_rows(ls + (it & 1) * DV_BQ, DV_BQ, p.ldv, lse_s, b, it * DV_BQ, DV_BQ, 0, 1, n, 1, 4);
  };
  load_rows(ks, LDK, p.k, p.sk, b, k0, BKEY, 0, dkp, n, p.dk_, p.wk);
  issue(0);
  cp_async_commit();

  float acc[MAX_VC * 8][4];  // n-tile 8c + j: column 64c + 8j of the slice
#pragma unroll
  for (int j = 0; j < MAX_VC * 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int kr = 16 * w + g;  // the thread's first key row in the tile

  for (int it = 0; it < nq; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it staged; every warpgroup is done with the swizzled tiles
    split_cols(qbig, qsmall, TILE, qst, LDS, dkp, 32, 32 * dkc);
    split_rows(gbig, gsmall, 0, gst, LDS, nc * VCOLS, nc * VCOLS, DV_BQ);
    fence_proxy_async();  // for the wgmma reads
    __syncthreads();
    if (it + 1 < nq) issue(it + 1);  // the staging is free
    cp_async_commit();

    // S^T = K Q^T over dkp / 8 k-steps, 4 (an atom of 32 channels) at a
    // time with A in registers, two fragment sets: atom a + 1's fragments
    // load and its products queue while atom a's run
    float s[4][4] = {};
    FragA fa[2][4];
    auto k_frags = [&](int a, FragA(&f)[4]) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (32 * a + 8 * kk >= dkp) break;  // (the staged K has dkp rows)
        const T* kr0 = ks + (32 * a + 8 * kk + t) * LDK + kr;
        f[kk] = frag_a<X>(Op<T>::get(kr0[0]), Op<T>::get(kr0[8]), Op<T>::get(kr0[4 * LDK]),
                          Op<T>::get(kr0[4 * LDK + 8]));
      }
    };
    k_frags(0, fa[0]);
    pin(s);
#pragma unroll
    for (int a = 0; a < MAX_DKC; ++a) {
      if (a >= dkc) break;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (32 * a + 8 * kk < dkp)
          wgmma3<X, X>(s, fa[a & 1][kk], qbig + a * TILE + 8 * kk, qsmall + a * TILE + 8 * kk);
      wgmma_commit();
      if (a + 1 < dkc) {
        if (a > 0) {
          wgmma_wait_prior();  // atom a - 1's products: its fragment set is free
          keep(fa[(a + 1) & 1]);
        }
        k_frags(a + 1, fa[(a + 1) & 1]);
      }
    }
    wgmma_wait_all();
    keep(fa[0]);
    keep(fa[1]);
    pin(s);
    // P = exp(min(S^T - ldv, 0)), 0 for queries past N (keys past N are never
    // stored); ldv is lse but in a one-hot row (the delta kernel)
    const int q0 = it * DV_BQ;
    const float* l_t = ls + (it & 1) * DV_BQ;
    FragA fp[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float pr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + t + 4 * (e & 1);
        pr[e] = q0 + qi < n ? __expf(fminf(s[j][e] - l_t[qi], 0.f)) : 0.f;
      }
      // k-step j is queries 8j..: the accumulator columns 2t, 2t + 1 are its k columns t, t + 4
      fp[j] = frag_a<false>(pr[0], pr[2], pr[1], pr[3]);
    }
    // dV += P^T g: one m64n256k8 a pass over a slice of 4 chunks, else one
    // m64n64k8 a chunk
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (nc == MAX_VC) {
        wgmma3<false, X>(acc, fp[j], gbig + 8 * j, gsmall + 8 * j);
      } else {
#pragma unroll
        for (int c = 0; c < MAX_VC - 1; ++c)
          if (c < nc)
            wgmma3<false, X>(part<8>(acc, 8 * c), fp[j], gbig + c * 2 * TILE + 8 * j,
                             gsmall + c * 2 * TILE + 8 * j);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
  }

  T* out = p.dv + b * p.sdv[0];
#pragma unroll
  for (int j = 0; j < MAX_VC * 8; ++j) {
    if (j >= 8 * nc) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + kr + 8 * (e >> 1), col = c0 + 8 * j + 2 * t + (e & 1);
      if (key < n && col < p.dv_) out[key * p.sdv[1] + col * p.sdv[2]] = Op<T>::put(acc[j][e]);
    }
  }
}

// dK and dQ over one key tile. Per query tile of 128: dP^T = v g^T on
// wgmma m64n128k8 over Dv in chunks of 32 channels (A = the v chunk of the
// warp's keys, split in registers; B = the g chunk transposed into rows of
// 32 channels, queries in the score order), the chunks streamed through a
// ring of one or two slots. Then per half tile of 64 queries: S^T (warp w:
// keys 16w.., the half's queries) on mma.sync from the staged K and the
// split Q half; dS^T = P o (dP^T - delta) in registers; dK += dS^T q on
// wgmma (Dk rows of the split Q half); dS^T to shared memory, dQ = dS k on
// mma.sync, added into dq_acc by a bulk reduction.
// DKC: Dk in chunks of 32 (p.dkc), so that dK's accumulator has its size.
template <typename T, int DKC>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_bwd_dkdq(const Params<T> p) {
  constexpr bool X = Op<T>::EXACT;
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int dkc = DKC;
  const int n = p.n, dkp = p.dkp, slots = p.cslots;
  constexpr int LDK = stride_a<T>(BKEY), LDQ = stride_a<T>(HQ), LDV = stride_a<T>(BKEY),
                LDG = stride_a<T>(BQ), LDD = stride_a<float>(HQ);
  // the half Q tile split for dK and S^T: big, small x [2 sub-tiles
  // (queries 0-31, 32-63)][dkc x 32 rows][32]; dS^T ([BKEY][LDD] f32) takes
  // its place after dK, and the block's dK at the end
  float* qsw = reinterpret_cast<float*>(smem);
  // the transposed g chunk, big and small: [128 queries][32 channels]; the
  // staged half Q tile ([dkp][LDQ] of T) takes its place after the chunks
  float* gsw = qsw + qsw_region(dkc);
  T* qst = reinterpret_cast<T*>(gsw);
  T* ks = reinterpret_cast<T*>(gsw + gsw_region<T>(dkp));  // [dkp][LDK]: K of the key tile
  T* vst = ks + dkp * LDK;                                 // slots x [CHUNK][LDV]: v chunks
  T* gst = vst + slots * CHUNK * LDV;                      // slots x [CHUNK][LDG]: g chunks
  float* ls = reinterpret_cast<float*>(gst + slots * CHUNK * LDG);  // [BQ]: lkq
  float* dl = ls + BQ;                                               // [BQ]: delta
  float* ds = qsw;
  float* qbig = qsw;
  float* qsmall = qsw + 2 * dkc * TILE;
  float* gbig = gsw;
  float* gsmall = gsw + 4 * TILE;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3, sg = sigma(g);
  const int wr = w & 3, wh = w >> 2;
  const int k0 = blockIdx.x * BKEY;
  const int64_t b = blockIdx.z;
  const int nq = (n + BQ - 1) / BQ, nc = (p.dv_ + CHUNK - 1) / CHUNK;
  // this block's query tiles: group blockIdx.y of qgroups, evenly spread
  const int i0 = blockIdx.y * nq / p.qgroups, i1 = (blockIdx.y + 1) * nq / p.qgroups;
  const int nkt = min(MAX_NKT, (dkp / 8 + 1) / 2);  // Dk n-tiles of a warp in dQ
  const int64_t row_s[3] = {n, 1, 0};

  // chunk c of query tile i into slot c % slots, one group
  auto issue_chunk = [&](int i, int c) {
    const int slot = c % slots;
    load_rows(vst + slot * CHUNK * LDV, LDV, p.v, p.sv, b, k0, BKEY, c * CHUNK, CHUNK, n, p.dv_,
              p.wv);
    load_rows(gst + slot * CHUNK * LDG, LDG, p.g, p.sg, b, i * BQ, BQ, c * CHUNK, CHUNK, n,
              p.dv_, p.wg);
    cp_async_commit();
  };
  load_rows(ks, LDK, p.k, p.sk, b, k0, BKEY, 0, dkp, n, p.dk_, p.wk);

  float dkacc[DKC * 4][4];  // n-tile j: Dk column 8j
#pragma unroll
  for (int j = 0; j < DKC * 4; ++j) dkacc[j][0] = dkacc[j][1] = dkacc[j][2] = dkacc[j][3] = 0.f;
  const int kr = 16 * w + g;  // the thread's first key row in the tile

  for (int i = i0; i < i1; ++i) {
    const int q0 = i * BQ;
    // every warp is done with the last tile (and its bulk reduction has read
    // the staging in the chunk slots)
    __syncthreads();
    load_rows(ls, BQ, p.lkq, row_s, b, q0, BQ, 0, 1, n, 1, 4);
    load_rows(dl, BQ, const_cast<const float*>(p.delta), row_s, b, q0, BQ, 0, 1, n, 1, 4);
    issue_chunk(i, 0);  // (with lse and delta; K too before the first)

    // dP^T = v g^T over the value chunks. The transposed g chunk has one
    // buffer: chunk c's split waits for chunk c - 1's products.
    float dp[16][4] = {};
    for (int c = 0; c < nc; ++c) {
      const int slot = c % slots;
      cp_async_wait<0>();
      wgmma_wait_all();  // chunk c - 1's products
      pin(dp);
      __syncthreads();  // chunk c staged; every warp is done with chunk c - 1 and gsw
      if (slots == 2 && c + 1 < nc) issue_chunk(i, c + 1);  // into chunk c - 1's slot
      split_cols(gbig, gsmall, 0, gst + slot * CHUNK * LDG, LDG, CHUNK, BQ, CHUNK);
      FragA f[4];
      const T* v_c = vst + slot * CHUNK * LDV;
#pragma unroll
      for (int kk = 0; kk < CHUNK / 8; ++kk) {
        const T* vr0 = v_c + (8 * kk + t) * LDV + kr;
        f[kk] = frag_a<X>(Op<T>::get(vr0[0]), Op<T>::get(vr0[8]), Op<T>::get(vr0[4 * LDV]),
                          Op<T>::get(vr0[4 * LDV + 8]));
      }
      fence_proxy_async();
      __syncthreads();  // the split is in place, and the slot read
      if (slots == 1 && c + 1 < nc) issue_chunk(i, c + 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CHUNK / 8; ++kk) wgmma3<X, X>(dp, f[kk], gbig + 8 * kk, gsmall + 8 * kk);
      wgmma_commit();
    }
    wgmma_wait_all();
    pin(dp);

#pragma unroll  // (dp's n-tiles by h: kept in registers)
    for (int h = 0; h < 2; ++h) {
      const int qh = q0 + h * HQ;
      // the half's Q tile, staged where the transposed g chunk was, then split
      __syncthreads();  // every warp is done with gsw (and the last half's ds and staging)
      load_rows(qst, LDQ, p.q, p.sq, b, qh, HQ, 0, dkp, n, p.dk_, p.wq);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      split_rows(qbig, qsmall, dkc * TILE, qst, LDQ, dkp, 32 * dkc, HQ);
      fence_proxy_async();
      __syncthreads();

      // S^T: keys kr, kr + 8 x queries 8j + sigma(g) of the half, on mma.sync
      // from the split Q half (row d, query q of sub-tile q / 32), each pass
      // over all n-tiles in turn
      float s[8][4] = {};
      for (int kk = 0; kk < dkp / 8; ++kk) {
        const T* kr0 = ks + (8 * kk + t) * LDK + kr;
        const FragA fa1 = frag_a<X>(Op<T>::get(kr0[0]), Op<T>::get(kr0[8]),
                                    Op<T>::get(kr0[4 * LDK]), Op<T>::get(kr0[4 * LDK + 8]));
        FragB fb[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int q = 8 * j + sg, at = (q >> 5) * dkc * TILE;
          const int i0s = at + swizzled<float>(8 * kk + t, q & 31);
          const int i1s = at + swizzled<float>(8 * kk + t + 4, q & 31);
          fb[j].big[0] = __float_as_uint(qbig[i0s]);
          fb[j].big[1] = __float_as_uint(qbig[i1s]);
          fb[j].small[0] = X ? 0u : __float_as_uint(qsmall[i0s]);
          fb[j].small[1] = X ? 0u : __float_as_uint(qsmall[i1s]);
        }
        mma_rows<X, X>(s, fa1, fb, 8);
      }

      // dS^T = P o (dP^T - delta), P = exp(min(S^T - lkq, 0)) (lkq: lse, +inf
      // in a one-hot row), 0 for keys or queries past N; a softmax over one
      // key has no score gradient: 0 at N = 1
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = h * HQ + 8 * j + t + 4 * (e & 1), key = kr + 8 * (e >> 1);
          const bool in = q0 + qi < n && k0 + key < n && n > 1;
          s[j][e] = in ? __expf(fminf(s[j][e] - ls[qi], 0.f)) * (dp[8 * h + j][e] - dl[qi])
                       : 0.f;
        }

      // dK += dS^T q over the half's queries: k-steps of 8 queries, 4 at a
      // time, one m64nNk8 a pass with N = 32 dkc, the split Q half's rows
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        FragA fd[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int j = 4 * hh + kk;
          fd[kk] = frag_a<false>(s[j][0], s[j][2], s[j][1], s[j][3]);
        }
        pin(dkacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int at = hh * dkc * TILE + 8 * kk;
          wgmma3<false, X>(dkacc, fd[kk], qbig + at, qsmall + at);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(dkacc);
      }
      __syncthreads();  // every warp is done with the split Q half: ds takes its place
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[(kr + 8 * (e >> 1)) * LDD + 8 * j + t + 4 * (e & 1)] = s[j][e];
      __syncthreads();

      // dQ = dS k for the half: queries 16 wr + g (+8) x Dk n-tiles
      // wh * nkt + jn, over the block's keys, each pass over all n-tiles
      float dq[MAX_NKT][4] = {};
      const int nt_dq = max(0, min(nkt, dkp / 8 - wh * nkt));  // this warp's Dk n-tiles
#pragma unroll 2
      for (int kk = 0; kk < BKEY / 8; ++kk) {
        const float* d0 = ds + (8 * kk + t) * LDD + 16 * wr + g;
        const FragA fq = frag_a<false>(d0[0], d0[8], d0[4 * LDD], d0[4 * LDD + 8]);
        FragB fb[MAX_NKT];
#pragma unroll
        for (int jn = 0; jn < MAX_NKT; ++jn) {
          if (jn >= nt_dq) break;
          const T* kq = ks + (8 * (wh * nkt + jn) + g) * LDK + 8 * kk + t;
          fb[jn] = frag_b<X>(Op<T>::get(kq[0]), Op<T>::get(kq[4]));
        }
        mma_rows<false, X>(dq, fq, fb, nt_dq);
      }
      // the half's dQ, staged dense ([64 queries][dkp] f32, as dq_acc's
      // rows) in the chunk slots, added into dq_acc by one bulk reduction
      float* stage = reinterpret_cast<float*>(vst);
#pragma unroll
      for (int jn = 0; jn < MAX_NKT; ++jn) {
        if (jn >= nt_dq) break;
        const int col = 8 * (wh * nkt + jn) + 2 * t, row = 16 * wr + g;
        *reinterpret_cast<float2*>(stage + row * dkp + col) = make_float2(dq[jn][0], dq[jn][1]);
        *reinterpret_cast<float2*>(stage + (row + 8) * dkp + col) = make_float2(dq[jn][2], dq[jn][3]);
      }
      fence_proxy_async();
      __syncthreads();
      if (tid == 0 && qh < n) {
        bulk_reduce_add(p.dq_acc + (b * n + qh) * dkp, stage, min(HQ, n - qh) * dkp * 4);
        bulk_wait_read();  // (the staging is written again next)
      }
    }
  }

  // this block's share of dK, staged dense ([BKEY keys][dkp] f32) where the
  // split Q half was, added into dk_acc by one bulk reduction
  __syncthreads();
  float* stage = qsw;
#pragma unroll
  for (int j = 0; j < DKC * 4; ++j) {
    if (8 * j >= dkp) break;
    *reinterpret_cast<float2*>(stage + kr * dkp + 8 * j + 2 * t) = make_float2(dkacc[j][0], dkacc[j][1]);
    *reinterpret_cast<float2*>(stage + (kr + 8) * dkp + 8 * j + 2 * t) =
        make_float2(dkacc[j][2], dkacc[j][3]);
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    bulk_reduce_add(p.dk_acc + (b * n + k0) * dkp, stage, min(BKEY, n - k0) * dkp * 4);
    bulk_wait();
  }
}

// A gradient (its input's type and layout: element strides so) from its f32
// (B, N, dkp) sum, through a 32 x 32 tile so that both sides are read and
// written along their stride-1 axis
template <typename T>
__global__ void __launch_bounds__(256)
    flash_attention_bwd_out(const float* acc, T* out, int64_t s0, int64_t s1, int64_t s2, int n,
                            int dk, int dkp) {
  __shared__ float tile[32][33];
  const int x = threadIdx.x, y = threadIdx.y;
  const int pos0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const int64_t b = blockIdx.z;
  for (int r = y; r < 32; r += 8) {
    const int pos = pos0 + r, d = d0 + x;
    tile[r][x] = pos < n && d < dkp ? acc[(b * n + pos) * dkp + d] : 0.f;
  }
  __syncthreads();
  out += b * s0;
  const bool pos_fast = s1 == 1 && n > 1;
  for (int r = y; r < 32; r += 8) {
    const int pos = pos0 + (pos_fast ? x : r), d = d0 + (pos_fast ? r : x);
    if (pos < n && d < dk) out[pos * s1 + d * s2] = Op<T>::put(pos_fast ? tile[x][r] : tile[r][x]);
  }
}

// cp.async width (bytes) for a tensor read along positions: the largest of
// 16, 8, 4 that the address and the batch and channel strides allow, with
// position stride 1; 0 (the threads' loads) otherwise.
template <typename T>
int load_width(const void* ptr, const long long* s, int b, int n, int c) {
  if (n < 2 || s[1] != 1) return 0;
  for (int w = 16; w >= 4; w /= 2) {
    if (w < int(sizeof(T))) break;
    const bool ok = reinterpret_cast<uintptr_t>(ptr) % w == 0 &&
                    (b == 1 || (s[0] * int64_t(sizeof(T))) % w == 0) &&
                    (c == 1 || (s[2] * int64_t(sizeof(T))) % w == 0);
    if (ok) return w;
  }
  return 0;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* out, const void* g,
           const float* lse, float* delta, float* dq_acc, float* dk_acc, void* dq, void* dk,
           void* dv, int b, int n, int dk_, int dv_, const long long* strides, void* stream_) {
  if (b < 1 || b > 65535 || n < 1 || dk_ < 1 || dk_ > MAX_DK || dv_ < 1)
    return int(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  Params<T> p{};
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.out = static_cast<const T*>(out);
  p.g = static_cast<const T*>(g);
  p.lse = lse;
  p.onehot = lse + int64_t(b) * n;
  p.delta = delta;
  p.ldv = delta + int64_t(b) * n;
  p.lkq = delta + 2 * int64_t(b) * n;
  p.dq_acc = dq_acc;
  p.dk_acc = dk_acc;
  p.dq = static_cast<T*>(dq);
  p.dk = static_cast<T*>(dk);
  p.dv = static_cast<T*>(dv);
  int64_t* dst[8] = {p.sq, p.sk, p.sv, p.so, p.sg, p.sdq, p.sdk, p.sdv};
  for (int a = 0; a < 8; ++a)
    for (int i = 0; i < 3; ++i) dst[a][i] = strides[3 * a + i];
  p.n = n;
  p.dk_ = dk_;
  p.dv_ = dv_;
  p.dkp = (dk_ + 7) & ~7;
  p.dkc = (dk_ + 31) / 32;
  p.wq = load_width<T>(q, strides, b, n, dk_);
  p.wk = load_width<T>(k, strides + 3, b, n, dk_);
  p.wv = load_width<T>(v, strides + 6, b, n, dv_);
  p.wg = load_width<T>(g, strides + 12, b, n, dv_);
  // value slices: the fewest of at most MAX_VC chunks, evenly spread
  p.chunks = (dv_ + VCOLS - 1) / VCOLS;
  p.slices = (p.chunks + MAX_VC - 1) / MAX_VC;
  p.vc = (p.chunks + p.slices - 1) / p.slices;

  const size_t e = sizeof(T), f = sizeof(float), dkp = p.dkp;
  const size_t smem_dv = f * (2 * p.vc * 2 * TILE + 2 * p.dkc * TILE) +
                         e * (dkp * stride_a<T>(BKEY) + dkp * stride_a<T>(DV_BQ) +
                              size_t(p.vc) * VCOLS * stride_a<T>(DV_BQ)) +
                         f * 2 * DV_BQ;
  auto smem_dkdq = [&](int slots) {
    return f * (qsw_region(p.dkc) + gsw_region<T>(p.dkp)) +
           e * (dkp * stride_a<T>(BKEY) + size_t(slots) * CHUNK * (stride_a<T>(BKEY) + stride_a<T>(BQ))) +
           f * 2 * BQ;
  };
  p.cslots = smem_dkdq(2) <= SMEM_MAX ? 2 : 1;
  const size_t smem_kq = smem_dkdq(p.cslots);
  if (smem_dv > SMEM_MAX || smem_kq > SMEM_MAX) return int(cudaErrorInvalidValue);

  const auto dkdq = p.dkc == 1 ? flash_attention_bwd_dkdq<T, 1>
                   : p.dkc == 2 ? flash_attention_bwd_dkdq<T, 2>
                   : p.dkc == 3 ? flash_attention_bwd_dkdq<T, 3>
                                : flash_attention_bwd_dkdq<T, 4>;
  static bool raised[1 + MAX_DKC][MAX_DEVICES] = {};
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(flash_attention_bwd_dv<T>), SMEM_MAX, raised[0]);
  if (err == cudaSuccess)
    err = allow_smem(reinterpret_cast<const void*>(dkdq), SMEM_MAX, raised[p.dkc]);
  const size_t acc_bytes = sizeof(float) * size_t(b) * n * p.dkp;
  if (err == cudaSuccess) err = cudaMemsetAsync(dq_acc, 0, acc_bytes, stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(dk_acc, 0, acc_bytes, stream);
  if (err != cudaSuccess) return int(err);

  // query groups: each key tile's query tiles over several blocks, about a
  // wave (128 blocks) a batch, so that the blocks running at once stream
  // one batch's v and g, which stay in L2 (dK is summed over the groups)
  const int ktiles = (n + BKEY - 1) / BKEY, nq = (n + BQ - 1) / BQ;
  p.qgroups = std::max(1, std::min(nq, 128 / ktiles));
  flash_attention_bwd_delta<T><<<dim3((n + 63) / 64, b), 256, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  flash_attention_bwd_dv<T><<<dim3(ktiles, p.slices, b), THREADS, smem_dv, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  dkdq<<<dim3(ktiles, p.qgroups, b), THREADS, smem_kq, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const dim3 grid((n + 31) / 32, (dk_ + 31) / 32, b), block(32, 8);
  flash_attention_bwd_out<T><<<grid, block, 0, stream>>>(dq_acc, p.dq, p.sdq[0], p.sdq[1],
                                                          p.sdq[2], n, dk_, p.dkp);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  flash_attention_bwd_out<T><<<grid, block, 0, stream>>>(dk_acc, p.dk, p.sdk[0], p.sdk[1],
                                                          p.sdk[2], n, dk_, p.dkp);
  return int(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t value; 0 is success. q, k, v, out, g and the
// gradients dq, dk, dv are f32 (flash_attention_bwd) or bf16
// (flash_attention_bwd_bf16), any strides; lse (written by the forward
// kernel), delta, dq_acc and dk_acc are f32 and contiguous: lse (2, B, N),
// the log-sum-exp and the one-hot flags, delta (3, B, N), dq_acc and dk_acc
// (B, N, Dkp) with Dkp = Dk rounded up to a multiple of 8 (delta and the two
// sums are scratch, overwritten).
// strides: 24 element strides, (batch, position, channel) of q, k, v, out,
// g, dq, dk, dv in turn. The caller has checked shapes.
extern "C" int flash_attention_bwd(const float* q, const float* k, const float* v,
                                   const float* out, const float* g, const float* lse,
                                   float* delta, float* dq_acc, float* dk_acc, float* dq,
                                   float* dk, float* dv, int b, int n, int dk_, int dv_,
                                   const long long* strides, void* stream) {
  return launch<float>(q, k, v, out, g, lse, delta, dq_acc, dk_acc, dq, dk, dv, b, n, dk_, dv_,
                       strides, stream);
}

extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* out, const void* g, const float* lse,
                                        float* delta, float* dq_acc, float* dk_acc, void* dq,
                                        void* dk, void* dv, int b, int n, int dk_, int dv_,
                                        const long long* strides, void* stream) {
  return launch<bf16>(q, k, v, out, g, lse, delta, dq_acc, dk_acc, dq, dk, dv, b, n, dk_, dv_,
                      strides, stream);
}
