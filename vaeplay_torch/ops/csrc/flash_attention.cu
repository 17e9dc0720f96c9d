// Flash-attention forward for Hopper (sm_90a) on the tensor cores, with a
// plain C interface that vaeplay_torch/ops/attention.py binds with ctypes.
//
// Replaces the TPU kernel vaeplay_tpu/ops/attention.py:_flash_kernel, launched
// by _pallas_attention (attention.py:37-119). Both compute unscaled softmax
// attention:
//
//   out[b, i, :] = sum_j softmax_j(q[b, i, :] . k[b, j, :]) v[b, j, :]
//
// with no 1/sqrt(d). q, k: (B, N, Dk); v, out: (B, N, Dv); f32 (bf16 operands
// take csrc/flash_attention_bf16.cu). Each operand comes with its element
// strides (batch, position, channel), so the kernel reads q, k, v and writes
// out where the model keeps them. k and v arrive by the TMA engine where it
// can describe them: channel-major (position stride 1, the (B, C, N) layout
// of an NCHW activation) with 16-byte aligned rows. Otherwise (`direct`: a
// row of N f32 that is not a multiple of 16 bytes, as BC's N = 258; N = 1,
// where the channel stride is 1, as BE_font's embedding blocks; a base
// address off 16 bytes) the threads load the same tiles themselves from the
// strides, into the same swizzled stages. The wrapper chooses the route and
// copies nothing but position-major k or v, which no model path passes.
//
// What bounds it on this card. At the BP shape (B=4, N=2048, Dk=90, Dv=720)
// one call is 2*B*N^2*(Dk+Dv) = 27.2 GFLOP of products on 53 MB of inputs and
// output, about 500 FLOP per byte: it is bound by operations. Both products
// run as 3xTF32 on the tensor cores: each operand x is split into
// big = tf32(x) and small = tf32(x - big), and big*big + big*small +
// small*big is summed in f32. That keeps f32 accuracy (a single TF32 pass
// does not: tests/test_torch_attention.py) at three tensor-core passes, so
// the floor is 3 * 27.2 GFLOP at 495 TFLOP/s = 0.165 ms. A second bound is
// the K/V stream from L2 into the SMs, about 1 GB per call at this tiling,
// which the TMA engine moves without the warps.
//
// Design.
//   grid  = (ceil(N/64) query tiles, T value tiles, B); one block per SM.
//   block = 12 warps in 3 warpgroups: 4 row groups of 16 query rows x 3
//           column groups, column group c being warpgroup c.
//   T     = ceil(ceil(Dv/8) / 45): each block owns at most 360 value columns
//           (45 n-tiles of 8, 120 columns and 60 accumulator registers a
//           thread per warpgroup). At Dv = 720, T = 2 blocks of 360 columns,
//           so the scores are computed twice: with Dk padded to 96 the
//           executed products are (2*96 + 720) / 810 = 1.13x the
//           algorithm's (six value tiles of 128 would make it 1.60x).
//   Scores, once per block and one key tile ahead: while all warps run the
//   softmax and P.V of tile j, column groups 0 and 1 compute the 64 x 32
//   scores of tile j+1 with mma.sync m16n8k8 (warp (r, c): rows 16r.., key
//   columns 16c..16c+15) into the second of two score buffers; Q is staged
//   once per block in the A-fragment order and split as it is loaded. The
//   softmax (row max and sum over the 4 lanes of a quad) reads the scores in
//   the A-fragment layout of P. The TPU kernel's sequential k-block grid axis
//   is the loop over key tiles; its VMEM scratch (max, sum, accumulator)
//   lives in registers.
//   K and V tiles of 32 keys arrive by the TMA engine (tensor maps over
//   (N, C, B), 128-byte swizzle, mbarriers) or by the threads' direct loads
//   (csrc/hopper.cuh:load_tile: cp.async of 8 or 4 bytes, waited for before
//   the barrier that opens each key tile), in rings of two stages, K two
//   tiles ahead and V one, each warpgroup loading its own 120 V rows; keys
//   past N and channels past Dk arrive as zeros (and past Dv by TMA; the
//   direct loads skip those rows, which feed only columns never stored).
//   Each warpgroup splits its rows of the V tile in place (big) and into a
//   second buffer (small), then runs P.V as 3 x 4 wgmma m64n120k8 per tile
//   with P from registers and V read as K-major from shared memory
//   (channel-major V is K-major, as TF32 wgmma needs).
//   Dk is padded with zeros to a multiple of 32 (96 at Dk = 90). Key columns
//   past N score -1e30 (as the TPU kernel's mask); query rows and value
//   columns past the edge are never stored. Fragment reads of K and V are
//   free of bank conflicts by the swizzle.
//   Per block: 384 threads at 155 registers each (168 with the direct
//   loads) and no spills (ptxas, CUDA 12.8; chip_smoke.py prints the
//   count), 222,240 bytes of shared memory (two K stages 32 KB, two V
//   stages 90 KB, the small parts of V 45 KB, Q 32 KB, two score tiles
//   18 KB).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 32;                 // keys per staged tile, one 128-byte row
constexpr int WC = 3;                  // column groups (warpgroups)
constexpr int THREADS = 32 * 4 * WC;   // 12 warps: 4 row groups x 3 column groups
constexpr int MAX_DK = 128;
constexpr int MAX_KS = MAX_DK / 8;     // k-steps of the score product
constexpr int NT = 15;                 // value n-tiles (8 columns) per warp
constexpr int V_ROWS = NT * 8;         // value columns (V rows) per warpgroup, 120
constexpr int BLK_NT = WC * NT;        // value n-tiles per block
constexpr int LDS = BK + 4;            // row stride (elements) of the score tiles
constexpr float NEG_INF = -1e30f;

// Shared memory of one block: two K stages and two V stages first (the
// 128-byte swizzle wants 1024-byte aligned stages), the small parts of the
// V tile in use, then Q in the A-fragment order, two score tiles, and the
// mbarriers. A stage holds rows of BK keys, one row per channel.
constexpr int K_STAGE = MAX_DK * BK;
constexpr int V_STAGE = WC * V_ROWS * BK;
constexpr size_t STAGES_BYTES = 2 * sizeof(float) * (K_STAGE + V_STAGE);
constexpr size_t VSMALL_BYTES = sizeof(float) * V_STAGE;
constexpr size_t Q_BYTES = sizeof(uint32_t) * BQ * MAX_DK;
constexpr size_t S_BYTES = 2 * sizeof(float) * BQ * LDS;
constexpr size_t SMEM = STAGES_BYTES + VSMALL_BYTES + Q_BYTES + S_BYTES + 4 * sizeof(uint64_t);
static_assert(sizeof(float) * K_STAGE % 1024 == 0 && sizeof(float) * V_STAGE % 1024 == 0,
              "swizzled stages stay 1024-byte aligned");
static_assert(SMEM <= 232448, "one block per SM");

struct Params {
  CUtensorMap k_map, v_map;  // K and V as (N, C, B) tensors (the TMA route)
  const float *q, *k, *v;
  float* out;
  float* lse;                // (B, N) row log-sum-exp, or null: not written
  float* onehot;             // (B, N) 1 where the row is one-hot, else 0 (with lse)
  int64_t sq[3], sk[3], sv[3], so[3];  // (batch, position, channel) strides, elements
  int n, dk, dv;
  int bdv;                   // value columns per block, a multiple of 8
};

// The tensor cores read a TF32 operand from the top 19 bits of a 32-bit
// register and ignore the low 13. Adding half of that unit (0x1000) first
// rounds to the nearest TF32 value, ties away from zero, as cvt.rna.tf32.f32
// does for finite values, in one integer add (cvt.rna is several
// instructions on this card). big is masked so that x - big is exact.
__device__ __forceinline__ uint32_t tf32_round(uint32_t bits) { return bits + 0x1000u; }

// big = tf32(x), small = tf32(x - big)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_round(__float_as_uint(x)) & 0xffffe000u;
  small = tf32_round(__float_as_uint(x - __uint_as_float(big)));
}

// c += a . b on one 16x8x8 TF32 tile (PTX fragment layouts: a row-major
// 16x8, b column-major 8x8, c 16x8 in f32).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Keeps the compiler from moving an accumulator while a wgmma owns it.
__device__ __forceinline__ void pin(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
// d (64 x 120, this thread's part in the mma.sync C layout of 15 n-tiles)
// += a (64 x 8 TF32, this warp's 16 rows in the mma.sync A layout) . B.
__device__ __forceinline__ void wgmma_120(float (&d)[NT][4], const uint32_t (&a)[4], uint64_t b) {
  static_assert(NT == 15, "m64n120");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %65, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59}, {%60, %61, %62, %63}, %64, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Elements first, first + count, ... below total, each read by load(e) and
// written by store(e, x), 8 loads in flight a thread: Q staged from any
// strides without one global load latency an element.
template <typename T, typename Load, typename Store>
__device__ __forceinline__ void batched(int total, int first, int count, Load load, Store store) {
  constexpr int BATCH = 8;
  for (int e0 = first; e0 < total; e0 += BATCH * count) {
    T x[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) x[u] = e0 + u * count < total ? load(e0 + u * count) : T(0);
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (e0 + u * count < total) store(e0 + u * count, x[u]);
  }
}

// Element (pos, chan) of a staged tile: one row of BK positions per channel.
__device__ __forceinline__ float at(const float* tile, int pos, int chan) {
  return tile[swizzled<float>(chan, pos)];
}

// DIRECT: the threads load K and V (else the TMA engine does).
template <bool DIRECT>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_fwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* kst = reinterpret_cast<float*>(smem);  // 2 K stages
  float* vst = kst + 2 * K_STAGE;               // 2 V stages
  // the small parts of the V tile in use (its big parts replace the tile in
  // its stage), same layout
  float* vsmall = reinterpret_cast<float*>(smem + STAGES_BYTES);
  // Q in A-fragment order: [row group][k-step][lane][4]
  uint32_t* qfrag = reinterpret_cast<uint32_t*>(smem + STAGES_BYTES + VSMALL_BYTES);
  float* sbuf = reinterpret_cast<float*>(qfrag + BQ * MAX_DK);  // 2 x [BQ][LDS]
  // arrivals of K tiles (stage 0, 1) and V tiles (stage 0, 1)
  uint64_t* kfull = reinterpret_cast<uint64_t*>(sbuf + 2 * BQ * LDS);
  uint64_t* vfull = kfull + 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row group and column in the quad
  const int wr = warp & 3, wc = warp >> 2;
  const int n = p.n, dk = p.dk, dv = p.dv;
  // Dk padded with zeros to whole chunks of 4 k-steps (96 at Dk = 90)
  const int dkp = (dk + 31) & ~31, nchunks = dkp >> 5;
  const int q0 = blockIdx.x * BQ, c0 = blockIdx.y * p.bdv;
  const int64_t b = blockIdx.z;
  const float* qb = p.q + b * p.sq[0];
  float* ob = p.out + b * p.so[0];

  // K tile j lives in K stage j & 1 and V tile j in V stage j & 1. By TMA,
  // K tile j arrives on kfull[j & 1] (one arrival, thread 0) and V tile j
  // on vfull[j & 1] (one arrival per warpgroup, its 120 rows); tile j
  // completes phase (j >> 1) & 1. Direct, every thread copies its share
  // (each warpgroup its V rows below Dv: the rest feed only columns that are
  // never stored) and waits for all its copies before the loop's barrier,
  // which follows every wait. Every thread calls these.
  const int width = DIRECT ? min(direct_width(p.k, p.sk, n), direct_width(p.v, p.sv, n)) : 0;
  const int vrows = max(min(V_ROWS, dv - c0 - wc * V_ROWS), 0);
  auto issue_k = [&](int tile) {
    if (DIRECT) {
      load_tile(kst + (tile & 1) * K_STAGE, p.k, p.sk, b, tile * BK, n, dkp, 0, dk, tid, THREADS,
                width);
    } else if (tid == 0) {
      mbar_arrive_expect(kfull + (tile & 1), uint32_t(sizeof(float) * BK * dkp));
      tma_load(kst + (tile & 1) * K_STAGE, &p.k_map, tile * BK, 0, int(b), kfull + (tile & 1));
    }
  };
  // every warpgroup computes its full 120 columns; only the block's columns
  // are stored
  auto issue_v = [&](int tile) {
    if (DIRECT) {
      load_tile(vst + (tile & 1) * V_STAGE + wc * V_ROWS * BK, p.v, p.sv, b, tile * BK, n, vrows,
                c0 + wc * V_ROWS, dv, tid & 127, 128, width);
    } else if ((tid & 127) == 0) {
      mbar_arrive_expect(vfull + (tile & 1), uint32_t(sizeof(float) * BK * V_ROWS));
      tma_load(vst + (tile & 1) * V_STAGE + wc * V_ROWS * BK, &p.v_map, tile * BK,
               c0 + wc * V_ROWS, int(b), vfull + (tile & 1));
    }
  };
  auto wait_k = [&](int tile) {
    if (DIRECT) cp_async_wait<0>();
    else mbar_wait(kfull + (tile & 1), (tile >> 1) & 1);
  };
  auto wait_v = [&](int tile) {
    if (DIRECT) cp_async_wait<0>();
    else mbar_wait(vfull + (tile & 1), (tile >> 1) & 1);
  };

  // scores of rows 16wr.. and key columns 16wc..16wc+15 of tile `tile`, by
  // column groups 0 and 1, into score buffer tile & 1; even and odd k-steps
  // sum apart, for shorter chains of dependent products
  auto scores = [&](int tile) {
    if (wc >= 2) return;
    const float* ks = kst + (tile & 1) * K_STAGE;
    float* sb = sbuf + (tile & 1) * BQ * LDS;
    const uint4* qf = reinterpret_cast<const uint4*>(qfrag) + wr * MAX_KS * 32 + lane;
    float sc[2][2][4] = {};
    // the k-steps in chunks of 4 without a branch inside a chunk, so the
    // loads of one k-step overlap the products of another
#pragma unroll
    for (int kk = 0; kk < MAX_KS; ++kk) {
      if (kk % 4 == 0 && kk / 4 >= nchunks) break;
      const int d = 8 * kk + t;
      const uint4 qv = qf[kk * 32];
      uint32_t ab[4] = {qv.x, qv.y, qv.z, qv.w}, as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(__uint_as_float(ab[i]), ab[i], as[i]);
      uint32_t bb[2][2], bs[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = 16 * wc + 8 * j + g;
        split(at(ks, key, d), bb[j][0], bs[j][0]);
        split(at(ks, key, d + 4), bb[j][1], bs[j][1]);
      }
      // the passes in turn over both n-tiles, sharing the A operand
      mma(sc[kk & 1][0], as, bb[0]);
      mma(sc[kk & 1][1], as, bb[1]);
      mma(sc[kk & 1][0], ab, bs[0]);
      mma(sc[kk & 1][1], ab, bs[1]);
      mma(sc[kk & 1][0], ab, bb[0]);
      mma(sc[kk & 1][1], ab, bb[1]);
    }
    const int row = 16 * wr + g;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = 16 * wc + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(sb + row * LDS + col) =
          make_float2(sc[0][j][0] + sc[1][j][0], sc[0][j][1] + sc[1][j][1]);
      *reinterpret_cast<float2*>(sb + (row + 8) * LDS + col) =
          make_float2(sc[0][j][2] + sc[1][j][2], sc[0][j][3] + sc[1][j][3]);
    }
  };

  if (tid == 0) {
    mbar_init(kfull, 1);
    mbar_init(kfull + 1, 1);
    mbar_init(vfull, WC);
    mbar_init(vfull + 1, WC);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int ntiles = (n + BK - 1) / BK;
  issue_k(0);
  if (ntiles > 1) issue_k(1);
  issue_v(0);

  // Q once, zero-padded to BQ x dkp, in the A-fragment order: element
  // (row, d) of row group row / 16 goes to lane 4 * (row % 8) + d % 4, slot
  // (row % 16 >= 8) + 2 * (d % 8 >= 4); the scores split it as they load it
  batched<float>(
      BQ * dkp, tid, THREADS,
      [&](int e) {
        const int row = q0 + (e & (BQ - 1)), d = e >> 6;
        return row < n && d < dk ? __ldg(qb + row * p.sq[1] + d * p.sq[2]) : 0.f;
      },
      [&](int e, float x) {
        const int r = e & (BQ - 1), d = e >> 6;
        qfrag[(((r >> 4) * MAX_KS + (d >> 3)) * 32 + 4 * (r & 7) + (d & 3)) * 4 + ((r >> 3) & 1) +
              2 * ((d >> 2) & 1)] = __float_as_uint(x);
      });
  wait_k(0);
  __syncthreads();  // Q and K tile 0 are staged
  scores(0);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // rows g and g + 8
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // Iteration `it`: scores of tile it+1 (column groups 0, 1), softmax and
  // P.V of tile it (all warps), while K tile it+2 and V tile it+1 are loaded.
  const int qrow = 16 * wr + g;  // the thread's first row in the block
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) wait_k(it + 1);
    wait_v(it);
    // K tile it+1, V tile it and the scores of tile it are in place; every
    // warp is done with iteration it-1, so K stage it & 1, V stage
    // (it+1) & 1 and score buffer (it+1) & 1 are free
    __syncthreads();
    if (it + 2 < ntiles) issue_k(it + 2);
    if (it + 1 < ntiles) {
      issue_v(it + 1);
      scores(it + 1);
    }

    // online softmax over tile it, in the A-fragment layout of P
    const int k0 = it * BK;
    const float* sb = sbuf + (it & 1) * BQ * LDS;
    float pr[BK / 8][4];
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const int c = 8 * kk + t;
      const int sa = qrow * LDS + c;
      pr[kk][0] = sb[sa];
      pr[kk][1] = sb[sa + 8 * LDS];
      pr[kk][2] = sb[sa + 4];
      pr[kk][3] = sb[sa + 8 * LDS + 4];
      if (k0 + c >= n) pr[kk][0] = pr[kk][1] = NEG_INF;
      if (k0 + c + 4 >= n) pr[kk][2] = pr[kk][3] = NEG_INF;
      mx0 = fmaxf(mx0, fmaxf(pr[kk][0], pr[kk][2]));
      mx1 = fmaxf(mx1, fmaxf(pr[kk][1], pr[kk][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // every tile holds a valid key, so the new max is finite and masked
    // columns give exactly 0
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    const float al0 = __expf(m[0] - mn0), al1 = __expf(m[1] - mn1);
    m[0] = mn0;
    m[1] = mn1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      pr[kk][0] = __expf(pr[kk][0] - mn0);
      pr[kk][2] = __expf(pr[kk][2] - mn0);
      pr[kk][1] = __expf(pr[kk][1] - mn1);
      pr[kk][3] = __expf(pr[kk][3] - mn1);
      s0 += pr[kk][0] + pr[kk][2];
      s1 += pr[kk][1] + pr[kk][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    l[0] = l[0] * al0 + s0;
    l[1] = l[1] * al1 + s1;

    // acc += P . V with wgmma over the warpgroup's 120 value columns: this
    // tile's rows of the warpgroup are split in place (big) and into vsmall,
    // then three products per k-step
    float* vbig = vst + (it & 1) * V_STAGE + wc * V_ROWS * BK;
    float* vsm = vsmall + wc * V_ROWS * BK;
    constexpr int UNITS = V_ROWS * BK / 4;  // 16-byte units of the rows
#pragma unroll
    for (int i = 0; i < (UNITS + 127) / 128; ++i) {
      const int e = (tid & 127) + 128 * i;
      if (UNITS % 128 != 0 && e >= UNITS) break;
      const float4 x = reinterpret_cast<const float4*>(vbig)[e];
      uint4 big, small;
      split(x.x, big.x, small.x);
      split(x.y, big.y, small.y);
      split(x.z, big.z, small.z);
      split(x.w, big.w, small.w);
      reinterpret_cast<uint4*>(vbig)[e] = big;
      reinterpret_cast<uint4*>(vsm)[e] = small;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // for the wgmma reads
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wc) : "memory");    // the warpgroup's split
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= al0; acc[j][1] *= al0;
      acc[j][2] *= al1; acc[j][3] *= al1;
    }
    uint32_t pb[BK / 8][4], ps[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) split(pr[kk][i], pb[kk][i], ps[kk][i]);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {  // k-step kk: bytes 32kk.. of each row
      wgmma_120(acc, ps[kk], tile_desc(vbig + 8 * kk));
      wgmma_120(acc, pb[kk], tile_desc(vsm + 8 * kk));
      wgmma_120(acc, pb[kk], tile_desc(vbig + 8 * kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
  }

  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  const int row0 = q0 + qrow, row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = c0 + V_ROWS * wc + 8 * j + 2 * t + e;
      if (col >= dv || col >= c0 + p.bdv) continue;
      if (row0 < n) ob[row0 * p.so[1] + col * p.so[2]] = acc[j][e] * inv0;
      if (row1 < n) ob[row1 * p.so[1] + col * p.so[2]] = acc[j][2 + e] * inv1;
    }
  }
  // each row's log-sum-exp, for the backward: once a row (column group 0,
  // the first value tile, one thread of the quad)
  if (p.lse != nullptr && wc == 0 && t == 0 && blockIdx.y == 0) {
    if (row0 < n) p.lse[b * n + row0] = m[0] + logf(l[0]);
    if (row1 < n) p.lse[b * n + row1] = m[1] + logf(l[1]);
    if (row0 < n) p.onehot[b * n + row0] = l[0] <= 1.f + ONE_HOT ? 1.f : 0.f;
    if (row1 < n) p.onehot[b * n + row1] = l[1] <= 1.f + ONE_HOT ? 1.f : 0.f;
  }
}

}  // namespace

// Returns a cudaError_t value; 0 is success. All four tensors are f32.
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
extern "C" int flash_attention_fwd(const float* q, const float* k, const float* v, float* out,
                                   float* lse, int b, int n, int dk, int dv,
                                   const long long* strides, int direct, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || dk < 1 || dk > MAX_DK || dv < 1)
    return int(cudaErrorInvalidValue);
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = lse;
  p.onehot = lse == nullptr ? nullptr : lse + int64_t(b) * n;
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.so[i] = strides[9 + i];
  }
  p.n = n; p.dk = dk; p.dv = dv;
  // value tiles: the fewest blocks of at most BLK_NT n-tiles, evenly sized
  const int nv = (dv + 7) / 8;
  const int tiles = (nv + BLK_NT - 1) / BLK_NT;
  p.bdv = 8 * ((nv + tiles - 1) / tiles);
  if (!direct &&
      (!encode_channel_major(&p.k_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, k, n, dk, b,
                             strides + 3, (dk + 31) & ~31) ||
       !encode_channel_major(&p.v_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, v, n, dv, b,
                             strides + 6, V_ROWS)))
    return int(cudaErrorInvalidValue);

  static bool raised[2][MAX_DEVICES] = {};
  const auto kernel = direct ? flash_attention_fwd_kernel<true> : flash_attention_fwd_kernel<false>;
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(kernel), int(SMEM), raised[direct != 0]);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((n + BQ - 1) / BQ, (dv + p.bdv - 1) / p.bdv, b);
  kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}
