// Throughput of mma.sync m16n8k8 TF32 on one SM sub-partition, in clocks per
// instruction, for the operand patterns of the port's attention kernel
// (vaeplay_torch/ops/csrc/flash_attention.cu). Built and run by mma_rate.py.
//
//   mode 0: A and B fixed in registers (the instruction's own rate)
//   mode 1: three passes per 16x8 tile (3xTF32), operands in registers
//   mode 2: 3xTF32 with B read from a 128-byte-swizzled shared tile and split
//           into big and small before its three products (the kernel's
//           score loop)
//   mode 3: 3xTF32 with B already split in shared memory, one 16-byte load
//           per fragment

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NACC = 15;  // independent accumulators per warp, as the kernel's n-tiles

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

template <int MODE>
__global__ void __launch_bounds__(384, 1) rate(float* out, long long* cycles, int iters) {
  __shared__ float tile[8 * 1024];
  for (int i = threadIdx.x; i < 8 * 1024; i += blockDim.x) tile[i] = 1e-3f * i;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t a1[4], a2[4], b[NACC][2];
  for (int i = 0; i < 4; ++i) {
    a1[i] = __float_as_uint(1e-3f * (threadIdx.x + i));
    a2[i] = a1[i] ^ 0x100u;
  }
  for (int j = 0; j < NACC; ++j) {
    b[j][0] = a1[j & 3] + j;
    b[j][1] = a2[j & 3] + j;
  }
  float c[NACC][4] = {};
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        if constexpr (MODE == 0) {
          mma(c[j], a1, b[0]);
        } else if constexpr (MODE == 1) {
          mma(c[j], a2, b[j]);
          mma(c[j], a1, b[(j + 1) % NACC]);
          mma(c[j], a1, b[j]);
        } else if constexpr (MODE == 2) {
          const int col = 8 * j + g, key = 8 * kk + t;
          const float x0 = tile[col * 32 + ((((key >> 2) ^ (col & 7)) << 2) | (key & 3))];
          const float x1 = tile[col * 32 + (((((key + 4) >> 2) ^ (col & 7)) << 2) | (key & 3))];
          uint32_t bb[2], bs[2];
          split(x0, bb[0], bs[0]);
          split(x1, bb[1], bs[1]);
          mma(c[j], a2, bb);
          mma(c[j], a1, bs);
          mma(c[j], a1, bb);
        } else {
          const uint4 x = reinterpret_cast<const uint4*>(tile)[(kk * 120 + 8 * j + g) * 4 + t];
          const uint32_t bb[2] = {x.x, x.y}, bs[2] = {x.z, x.w};
          mma(c[j], a2, bb);
          mma(c[j], a1, bs);
          mma(c[j], a1, bb);
        }
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.f;
  for (int j = 0; j < NACC; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

}  // namespace

// One block per SM, `threads` threads; cycles[block] gets the block's clocks.
extern "C" int mma_rate(float* out, long long* cycles, int blocks, int threads, int iters,
                        int mode) {
  switch (mode) {
    case 0: rate<0><<<blocks, threads>>>(out, cycles, iters); break;
    case 1: rate<1><<<blocks, threads>>>(out, cycles, iters); break;
    case 2: rate<2><<<blocks, threads>>>(out, cycles, iters); break;
    default: rate<3><<<blocks, threads>>>(out, cycles, iters); break;
  }
  return int(cudaGetLastError());
}
