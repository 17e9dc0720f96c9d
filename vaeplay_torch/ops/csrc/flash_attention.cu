// Flash-attention forward for Hopper (sm_90a), with a plain C interface that
// vaeplay_torch/ops/attention.py binds with ctypes.
//
// Replaces the TPU kernel vaeplay_tpu/ops/attention.py:_flash_kernel, launched
// by _pallas_attention (attention.py:37-119). Both compute unscaled softmax
// attention:
//
//   out[b, i, :] = sum_j softmax_j(q[b, i, :] . k[b, j, :]) v[b, j, :]
//
// with no 1/sqrt(d). q, k: (B, N, Dk); v, out: (B, N, Dv); all contiguous,
// f32 or bf16. bf16 inputs are widened to f32 as they are staged; every
// product, the softmax and the accumulator run in f32, and only the output is
// rounded to the input type.
//
// What bounds it on this card. At the BP shape (B=4, N=2048, Dk=90, Dv=720,
// f32) one call does 2*B*N^2*(Dk+Dv) = 27.2 GFLOP on 53 MB of inputs and
// output, about 500 FLOP per byte, so it is bound by operations. It runs on
// the CUDA cores' f32 FMA units (no tensor cores in this version), so its
// floor is that rate.
//
// Design. The TPU kernel walks the K/V blocks as a sequential grid axis and
// carries the online-softmax state (row max, row sum, accumulator) in VMEM
// scratch from one grid step to the next. Hopper runs blocks in no order, so
// that axis becomes a loop inside one block and the state lives in registers.
//
//   grid  = (ceil(N/64) query tiles, ceil(Dv/128) value tiles, B)
//   block = 256 threads, owning 64 query rows and one 128-wide slice of Dv.
//
// Q is staged once, transposed, in shared memory; each K tile (transposed) and
// V tile is staged in turn. Thread t owns rows 4*(t/16)..+3: for the scores it
// holds 4 x 4 entries (columns 4*(t%16)..+3), for the output 4 x 8 entries
// (columns 4*(t%16)..+3 and 64 more). The 16 threads that share rows form one
// half-warp, so the row max and row sum are warp shuffles, and the
// probabilities reach the P.V product through a shared tile that only that
// half-warp reads and writes. Key columns past N get a score of -1e30 (as the
// TPU kernel's mask does) and key rows past N are staged as zeros; query rows
// and value columns past the edge are never stored. Dk is looped exactly, so
// it needs no padding.
//
// A 64 x 720 f32 accumulator (184 KB) does not fit in one block's registers,
// so Dv is split across blocks and each block recomputes its own scores: at
// Dk=90, Dv=720 the six value tiles make the executed FMAs 1.56x the
// algorithm's count. Sharing the scores (or tensor cores, for bf16 and TF32)
// is the first thing a faster version would change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // key rows per tile
constexpr int BDV = 128;     // value columns per block
constexpr int THREADS = 256;
constexpr int LDT = BQ + 4;  // row stride of the transposed Q and K tiles (BQ == BK)
constexpr int LDP = BK + 4;  // row stride of the probability tile
constexpr int MAX_DK = 128;
constexpr float NEG_INF = -1e30f;

static_assert(BQ == BK, "Q and K tiles share one stride");
static_assert(THREADS == 16 * (BQ / 4), "16 threads per group of 4 rows");
static_assert(BDV == 2 * 64, "each thread owns two 4-wide value column groups");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Reduce over the 16 lanes of a half-warp (xor offsets below 16 stay inside it).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

size_t smem_bytes(int dk) {
  return sizeof(float) * (size_t(2) * dk * LDT + size_t(BK) * BDV + size_t(BQ) * LDP);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int n, int dk, int dv) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;             // [dk][LDT]  Q tile, transposed
  float* kt = qt + dk * LDT;    // [dk][LDT]  K tile, transposed
  float* vs = kt + dk * LDT;    // [BK][BDV]  V tile
  float* ps = vs + BK * BDV;    // [BQ][LDP]  probabilities of the current tile

  const int tid = threadIdx.x;
  const int ty = tid >> 4;      // rows 4*ty .. 4*ty+3
  const int tx = tid & 15;      // score columns 4*tx..+3; value columns 4*tx..+3 and +64
  const int q0 = blockIdx.x * BQ;
  const int c0 = blockIdx.y * BDV;
  const int64_t b = blockIdx.z;
  const T* qb = q + b * n * dk;
  const T* kb = k + b * n * dk;
  const T* vb = v + b * n * dv;
  T* ob = out + b * n * dv;

  // The (BQ, dk) query tile is one contiguous run of memory.
  for (int e = tid; e < BQ * dk; e += THREADS) {
    const int r = e / dk, d = e - r * dk;
    const int row = q0 + r;
    qt[d * LDT + r] = row < n ? to_f32(qb[int64_t(row) * dk + d]) : 0.f;
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int e = tid; e < BK * dk; e += THREADS) {
      const int r = e / dk, d = e - r * dk;
      const int row = k0 + r;
      kt[d * LDT + r] = row < n ? to_f32(kb[int64_t(row) * dk + d]) : 0.f;
    }
    for (int e = tid; e < BK * BDV; e += THREADS) {
      const int r = e / BDV, c = e - r * BDV;
      const int row = k0 + r, col = c0 + c;
      vs[e] = (row < n && col < dv) ? to_f32(vb[int64_t(row) * dv + col]) : 0.f;
    }
    __syncthreads();

    // scores: s[i][j] = q[4*ty+i] . k[k0 + 4*tx+j]
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < dk; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * LDT + 4 * ty);
      const float4 c = *reinterpret_cast<const float4*>(kt + d * LDT + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k0 + 4 * tx + j >= n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = NEG_INF;
      }
    }

    // online softmax: every tile holds at least one valid key column, so
    // m_new is finite and masked columns give exactly 0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = __expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = __expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
      *reinterpret_cast<float4*>(ps + (4 * ty + i) * LDP + 4 * tx) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncwarp();  // rows 4*ty..+3 of ps are written and read by one half-warp

    // acc += P . V over the tile
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * LDP + j);
        p[i][0] = t.x; p[i][1] = t.y; p[i][2] = t.z; p[i][3] = t.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = vs + (j + jj) * BDV + 4 * tx;
        const float4 v0 = *reinterpret_cast<const float4*>(vrow);
        const float4 v1 = *reinterpret_cast<const float4*>(vrow + 64);
        const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(p[i][jj], vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= n) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + 64 * h + 4 * tx + e;
        if (col < dv) store_as(ob + int64_t(row) * dv + col, acc[i][4 * h + e] * inv);
      }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int n, int dk, int dv, cudaStream_t stream) {
  const size_t smem = smem_bytes(dk);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BQ - 1) / BQ, (dv + BDV - 1) / BDV, b);
  flash_attention_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), n, dk, dv);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value; 0 is success. bf16 != 0 selects bf16 tensors,
// else f32. The caller has checked shapes, types and contiguity.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int b, int n, int dk, int dv, int bf16, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || dk < 1 || dk > MAX_DK || dv < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch<__nv_bfloat16>(q, k, v, out, b, n, dk, dv, s)
                               : launch<float>(q, k, v, out, b, n, dk, dv, s);
  return int(err);
}
