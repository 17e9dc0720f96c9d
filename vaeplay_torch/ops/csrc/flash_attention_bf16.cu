// Flash-attention forward on bf16 operands for Hopper (sm_90a), both products
// on bf16 wgmma, with a plain C interface that vaeplay_torch/ops/attention.py
// binds with ctypes.
//
// Replaces the TPU kernel vaeplay_tpu/ops/attention.py:_flash_kernel at its
// default instantiation, mxu_dtype=bf16 (attention.py:37-77, launched by
// _pallas_attention at :96). It computes what that computes:
//
//   S = q . k^T from bf16 operands, summed in f32 (no 1/sqrt(d));
//   over key tiles, the running row max m and sum l in f32, P = exp(S - m)
//   in f32, l += rowsum(P), and P rounded to bf16 for P . V, summed in f32;
//   out = acc / l, rounded once to bf16.
//
// q, k: (B, N, Dk); v, out: (B, N, Dv); bf16. Each operand comes with its
// element strides (batch, position, channel): q and out may have any, and k
// and v are read where the model keeps them. By the TMA engine where it can
// describe them (channel-major, position stride 1, rows a multiple of 16
// bytes: N a multiple of 8, as BP's and BCP's 2048 and 4096); else (`direct`:
// BC's N = 258, BE_font's N = 1, a base address off 16 bytes) the threads
// load the same tiles from the strides into the same swizzled stages
// (csrc/hopper.cuh). The result is written in bf16 straight into `out`.
//
// What bounds it on this card. At BP's training shape (B 8, N 2048, Dk 90,
// Dv 720) one call is 2*B*N^2*(Dk+Dv) = 54.4 GFLOP on 53 MB of inputs and
// output, about 1000 FLOP per byte: it is bound by operations, 0.055 ms at
// the bf16 rate of 989 TFLOP/s. The design keeps both products on wgmma, the
// only way to that rate, and the score and P values in registers.
//
// Design.
//   grid  = (ceil(N/128) query tiles, T value tiles, B); one block per SM.
//   block = 2 warpgroups, each owning 64 query rows and every value column
//           of the block's value tile: no score is shared across warps.
//   T     = ceil(ceil(Dv/64) / 4): value columns come in chunks of 64 (one
//           wgmma m64n64k16 each), a block takes at most 4 chunks (256
//           columns, 128 accumulator registers a thread), and the chunks
//           are spread evenly over the fewest tiles, so the scores are
//           computed T times: at Dv = 720, 3 tiles of 4 chunks and (3 * 96 +
//           768) / 810 = 1.30x the algorithm's products; at Dv = 260, 2 tiles
//           (2 and 3 chunks), 1.32x; at Dv = 256, one tile.
//   Scores: S (64 x 64 a warpgroup) = Q . K^T as dkp/16 wgmma m64n64k16 with
//   A = Q from shared memory (K-major, staged once per block from any
//   strides) and B = the channel-major K tile read MN-major (the transpose
//   bit of a 16-bit wgmma), so k needs no transposed copy. Dk is padded with
//   zeros to a multiple of 16 (96 at Dk = 90). The accumulator layout of S is
//   the A-fragment layout of P, so the softmax runs in registers (row max and
//   sum over the 4 lanes of a quad) and P goes to P . V from registers.
//   P . V: per key tile 4 k-steps x (chunks) wgmma m64n64k16, B = the
//   channel-major V tile, which is K-major.
//   K and V tiles of 64 keys (128-byte rows) arrive in a ring of 4 stages,
//   3 tiles ahead. By TMA on one "full" mbarrier a stage (one arrival with
//   the bytes expected); each warp arrives on the stage's "empty" mbarrier
//   after its P . V, and the stage is refilled once all 8 have. Direct, by
//   cp.async of position pairs where the strides allow (N = 258) or plain
//   loads (N = 1), each thread's copies of a tile one group, waited for
//   before a barrier that opens the tile. The TPU kernel's sequential
//   k-block grid axis is the loop over key tiles; its VMEM scratch (max,
//   sum, accumulator) lives in registers. Keys past N score -1e30 (the TPU
//   kernel's mask); query rows and value columns past the edge are never
//   stored.
//   Per block: 256 threads at about 206 registers (244 with the direct
//   loads) and no spills (ptxas, CUDA 12.8; chip_smoke.py prints the
//   count); shared memory 4 stages of 48 KB (K 128 rows x 64 keys, V 4
//   chunks x 64 rows x 64 keys) and Q 32 KB, 229,440 bytes.

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = uint16_t;  // the bits of a bfloat16

constexpr int WG = 2;                   // warpgroups, 64 query rows each
constexpr int THREADS = 128 * WG;
constexpr int BQ = 64 * WG;             // query rows per block
constexpr int BK = 64;                  // keys per tile: one 128-byte row of bf16
constexpr int STAGES = 4;               // the K/V ring
constexpr int MAX_DK = 128;
constexpr int CHUNK = 64;               // value columns per wgmma
constexpr int MAX_CHUNKS = 4;           // chunks per block: at most 256 value columns
constexpr int NT = 8;                   // 8-column n-tiles of an m64n64 accumulator
constexpr float NEG_INF = -1e30f;

// Shared memory: STAGES stages of [K: MAX_DK rows][V: MAX_CHUNKS x CHUNK
// rows], each row BK keys of one channel; then Q as two atoms of BQ rows of
// 64 channels (channels 0-63, 64-127), one 128-byte row per query row; then
// the mbarriers. All swizzled, 1024-byte aligned.
constexpr int K_STAGE = MAX_DK * BK;
constexpr int V_STAGE = MAX_CHUNKS * CHUNK * BK;
constexpr int STAGE = K_STAGE + V_STAGE;
constexpr int Q_ATOM = BQ * 64;
constexpr size_t SMEM =
    sizeof(bf16) * (size_t(STAGES) * STAGE + 2 * Q_ATOM) + 2 * STAGES * sizeof(uint64_t);
static_assert(sizeof(bf16) * K_STAGE % 1024 == 0 && sizeof(bf16) * STAGE % 1024 == 0,
              "swizzled stages stay 1024-byte aligned");
static_assert(SMEM <= 232448, "one block per SM");

struct Params {
  CUtensorMap k_map, v_map;  // K and V as (N, C, B) tensors (the TMA route)
  const bf16 *q, *k, *v;
  bf16* out;
  float* lse;  // (B, N) row log-sum-exp in f32, or null: not written
  float* onehot;  // (B, N) 1 where the row is one-hot, else 0 (with lse)
  int64_t sq[3], sk[3], sv[3], so[3];  // (batch, position, channel) strides, elements
  int n, dk, dv;
  int chunks, tiles;  // value chunks in all, ceil(Dv / CHUNK); value tiles (gridDim.y)
};

#define ACC(d)                                                                                 \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),    \
      "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), \
      "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), \
      "+f"(d[7][2]), "+f"(d[7][3])
#define ACC_REGS                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64 f32, this thread's part in the mma C layout of 8 n-tiles)
// = [d +] A . B: A (64 x 16) K-major and B (16 x 64) MN-major, both from
// shared memory; the sum into d when `accumulate`, else d is overwritten.
__device__ __forceinline__ void wgmma_ss(float (&d)[NT][4], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC_REGS
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : ACC(d)
      : "l"(a), "l"(b), "r"(accumulate));
}
// d += A . B: A (64 x 16) from registers (this warp's 16 rows in the mma A
// layout, bf16 pairs), B (16 x 64) K-major from shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[NT][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : ACC(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// acc[c] += P . V over the chunks c < NC of a V stage: 4 k-steps of 16 keys,
// each 32 bytes along the V tile's rows.
template <int NC>
__device__ __forceinline__ void pv(float (&acc)[MAX_CHUNKS][NT][4],
                                   const uint32_t (&pa)[BK / 16][4], const bf16* vst) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      wgmma_rs(acc[c], pa[kk], tile_desc(vst + c * CHUNK * BK + kk * 16));
}
// Keeps the compiler from moving an accumulator while a wgmma owns it.
__device__ __forceinline__ void pin(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
// bf16 pair, lo in the low half, each rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ bf16 to_bf16(float x) {
  bf16 r;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(r) : "f"(x));
  return r;
}

// DIRECT: the threads load K and V (else the TMA engine does).
template <bool DIRECT>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_bf16_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  bf16* qs = stages + STAGES * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + 2 * Q_ATOM);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;  // fragment row group and column in the quad
  const int n = p.n, dk = p.dk, dv = p.dv;
  const int dkp = (dk + 15) & ~15, ksteps = dkp >> 4;
  const int q0 = blockIdx.x * BQ;
  // this block's value chunks: ch0 .. ch0 + nc - 1, columns from c0
  const int ch0 = blockIdx.y * p.chunks / p.tiles;
  const int nc = (blockIdx.y + 1) * p.chunks / p.tiles - ch0, c0 = ch0 * CHUNK;
  const int64_t b = blockIdx.z;
  const int ntiles = (n + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // direct loads: cp.async of the width both k's and v's strides allow, or
  // plain loads; V's rows past Dv feed only columns that are never stored
  const int width = min(direct_width(p.k, p.sk, n), direct_width(p.v, p.sv, n));
  const int vrows = min(nc * CHUNK, dv - c0);
  // Key tile j lives in stage j % STAGES. By TMA it completes phase
  // (j / STAGES) & 1 of full[j % STAGES], and the stage is refilled with tile
  // j once phase (j / STAGES - 1) & 1 of empty[] (tile j - STAGES consumed by
  // all 8 warps) completes; only thread 0 acts. Direct, every thread copies
  // its share as one cp.async group (empty past the last tile), and the loop
  // waits for tile j's group before a barrier, after which the stage of tile
  // j - 1 is free too. Every thread calls it.
  auto load = [&](int tile) {
    const int s = tile % STAGES;
    bf16* kst = stages + s * STAGE;
    bf16* vst = kst + K_STAGE;
    if (DIRECT) {
      if (tile < ntiles) {
        load_tile(kst, p.k, p.sk, b, tile * BK, n, dkp, 0, dk, tid, THREADS, width);
        load_tile(vst, p.v, p.sv, b, tile * BK, n, vrows, c0, dv, tid, THREADS, width);
        fence_proxy_async();  // plain stores, for the wgmma reads
      }
      cp_async_commit();
    } else if (tid == 0 && tile < ntiles) {
      if (tile >= STAGES) mbar_wait(empty + s, (tile / STAGES - 1) & 1);
      mbar_arrive_expect(full + s, uint32_t(sizeof(bf16) * BK * (dkp + nc * CHUNK)));
      tma_load(kst, &p.k_map, tile * BK, 0, int(b), full + s);
      for (int c = 0; c < nc; ++c)
        tma_load(vst + c * CHUNK * BK, &p.v_map, tile * BK, c0 + c * CHUNK, int(b), full + s);
    }
    __syncwarp();
  };

  for (int tile = 0; tile < STAGES - 1; ++tile) load(tile);

  // Q once, zero-padded to BQ x dkp: channel d of query row r in atom d / 64,
  // row r, position d % 64 (the A operand, K-major)
  {
    // 16-byte units of 8 channels, neighbouring threads on neighbouring rows
    // where q's position stride is 1
    const bool pos_fast = p.sq[1] == 1 && n > 1;
    const int units = dkp / 8;
    const bf16* qb = p.q + b * p.sq[0];
    for (int e = tid; e < BQ * units; e += THREADS) {
      const int r = pos_fast ? e % BQ : e / units, u = pos_fast ? e / BQ : e % units;
      const int row = q0 + r;
      union {
        bf16 x[8];
        uint4 v;
      } unit;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        unit.x[i] = row < n && 8 * u + i < dk ? __ldg(qb + row * p.sq[1] + (8 * u + i) * p.sq[2])
                                              : bf16(0);
      reinterpret_cast<uint4*>(qs + (u >> 3) * Q_ATOM)[8 * r + ((u & 7) ^ (r & 7))] = unit.v;
    }
  }
  fence_proxy_async();
  __syncthreads();

  const bf16* qw = qs + wg * 64 * 64;  // this warpgroup's 64 rows
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // rows g and g + 8 of the warp's 16
  float sc[NT][4], acc[MAX_CHUNKS][NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[j][e] = 0.f;
#pragma unroll
      for (int c = 0; c < MAX_CHUNKS; ++c) acc[c][j][e] = 0.f;
    }

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % STAGES;
    const bf16* kst = stages + s * STAGE;
    const bf16* vst = kst + K_STAGE;
    if (DIRECT) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of tile it
      __syncthreads();              // everyone's; and every warp is done with tile it - 1
      fence_proxy_async();          // the threads' copies, for the wgmma reads
      load(it + STAGES - 1);
    } else {
      load(it + STAGES - 1);
      mbar_wait(full + s, (it / STAGES) & 1);
    }

    // S = Q . K^T over dkp / 16 k-steps: a k-step is 32 bytes along Q's rows
    // (a new atom every 4) and 16 rows down the K tile
    pin(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < MAX_DK / 16; ++kk)
      if (kk < ksteps)
        wgmma_ss(sc, tile_desc(qw + (kk >> 2) * Q_ATOM + (kk & 3) * 16),
                 tile_desc(kst + kk * 16 * BK), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);

    // online softmax over the tile; element (j, e) of sc is key 8j + 2t +
    // (e & 1) of row g (e < 2) or g + 8
    const int k0 = it * BK;
    if (k0 + BK > n) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int key = k0 + 8 * j + 2 * t;
        if (key >= n) sc[j][0] = sc[j][2] = NEG_INF;
        if (key + 1 >= n) sc[j][1] = sc[j][3] = NEG_INF;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // every tile holds a valid key, so the new max is finite and masked
    // keys give exactly 0
    const float al0 = __expf(m0 - mx0), al1 = __expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      sc[j][0] = __expf(sc[j][0] - mx0);
      sc[j][1] = __expf(sc[j][1] - mx0);
      sc[j][2] = __expf(sc[j][2] - mx1);
      sc[j][3] = __expf(sc[j][3] - mx1);
      s0 += sc[j][0] + sc[j][1];
      s1 += sc[j][2] + sc[j][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    l0 = l0 * al0 + s0;  // the sum of P in f32, before its rounding
    l1 = l1 * al1 + s1;
    // P in bf16 as the A fragments of 4 k-steps of 16 keys: n-tiles 2kk and
    // 2kk + 1 of S are the k-step's two column halves
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[kk][1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[kk][2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
    }
#pragma unroll
    for (int c = 0; c < MAX_CHUNKS; ++c)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[c][j][0] *= al0; acc[c][j][1] *= al0;
        acc[c][j][2] *= al1; acc[c][j][3] *= al1;
      }

    // acc += P . V, the products of each chunk count straight-line: faster
    // than a branch around each wgmma
#pragma unroll
    for (int c = 0; c < MAX_CHUNKS; ++c) pin(acc[c]);
    wgmma_fence();
    switch (nc) {
      case 1: pv<1>(acc, pa, vst); break;
      case 2: pv<2>(acc, pa, vst); break;
      case 3: pv<3>(acc, pa, vst); break;
      default: pv<4>(acc, pa, vst);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < MAX_CHUNKS; ++c) pin(acc[c]);
    if (!DIRECT && lane == 0) mbar_arrive(empty + s);  // this warp is done with the stage
  }

  // out = acc / l, rounded once to bf16
  const int row0 = q0 + 64 * wg + 16 * (warp & 3) + g, row1 = row0 + 8;
  bf16* ob = p.out + b * p.so[0];
#pragma unroll
  for (int c = 0; c < MAX_CHUNKS; ++c) {
    if (c >= nc) break;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + c * CHUNK + 8 * j + 2 * t + e;
        if (col >= dv) continue;
        if (row0 < n) ob[row0 * p.so[1] + col * p.so[2]] = to_bf16(acc[c][j][e] / l0);
        if (row1 < n) ob[row1 * p.so[1] + col * p.so[2]] = to_bf16(acc[c][j][2 + e] / l1);
      }
  }
  // each row's log-sum-exp in f32 (l is the sum of P before its rounding),
  // for the backward: once a row (the first value tile, one thread of the quad)
  if (p.lse != nullptr && t == 0 && blockIdx.y == 0) {
    if (row0 < n) p.lse[b * n + row0] = m0 + logf(l0);
    if (row1 < n) p.lse[b * n + row1] = m1 + logf(l1);
    if (row0 < n) p.onehot[b * n + row0] = l0 <= 1.f + ONE_HOT ? 1.f : 0.f;
    if (row1 < n) p.onehot[b * n + row1] = l1 <= 1.f + ONE_HOT ? 1.f : 0.f;
  }
}

}  // namespace

// Returns a cudaError_t value; 0 is success. All four tensors are bf16.
// lse: null, or a contiguous f32 (2, B, N) for the backward: plane 0
// receives each query row's log-sum-exp (max + log of the sum), plane 1 1
// where the row is one-hot (its other keys hold under ONE_HOT of its sum of
// exp(S - max), the max's own term being 1), else 0. strides: 12 element
// strides, (batch, position, channel) of q, k, v and out
// in turn. direct = 0: k and v are read by the TMA engine and must be
// channel-major (position stride 1) with their address and channel and
// batch strides multiples of 16 bytes, else the call returns
// cudaErrorInvalidValue and launches nothing; direct = 1: the threads load
// them, from any strides. The caller has checked shapes.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                                        float* lse, int b, int n, int dk, int dv,
                                        const long long* strides, int direct, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || dk < 1 || dk > MAX_DK || dv < 1)
    return int(cudaErrorInvalidValue);
  Params p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.out = static_cast<bf16*>(out);
  p.lse = lse;
  p.onehot = lse == nullptr ? nullptr : lse + int64_t(b) * n;
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.so[i] = strides[9 + i];
  }
  p.n = n; p.dk = dk; p.dv = dv;
  // value tiles: the fewest of at most MAX_CHUNKS chunks, evenly spread
  p.chunks = (dv + CHUNK - 1) / CHUNK;
  p.tiles = (p.chunks + MAX_CHUNKS - 1) / MAX_CHUNKS;
  if (!direct &&
      (!encode_channel_major(&p.k_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, n, dk, b,
                             strides + 3, (dk + 15) & ~15) ||
       !encode_channel_major(&p.v_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, v, n, dv, b,
                             strides + 6, CHUNK)))
    return int(cudaErrorInvalidValue);

  static bool raised[2][MAX_DEVICES] = {};
  const auto kernel =
      direct ? flash_attention_bf16_kernel<true> : flash_attention_bf16_kernel<false>;
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(kernel), int(SMEM), raised[direct != 0]);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((n + BQ - 1) / BQ, p.tiles, b);
  kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}
