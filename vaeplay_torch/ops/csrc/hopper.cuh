// Pieces shared by the port's Hopper (sm_90a) kernels, csrc/flash_attention.cu
// and csrc/flash_attention_bf16.cu: mbarriers, TMA loads and tensor maps,
// wgmma synchronisation and shared-memory descriptors, and the direct loads
// that fill a tile where the TMA engine cannot describe the operand.
// ops/_build.py hashes this header with each source that includes it.
//
// A staged tile holds one row of 128 bytes per channel (32 f32 or 64 bf16
// positions) in the TMA engine's 128-byte swizzle: the 16-byte unit u of row
// r sits at unit u ^ (r % 8). TMA loads and direct loads fill it alike.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

namespace hopper {

constexpr int MAX_DEVICES = 64;

// A row of softmax(S) is one-hot where its other keys hold under ONE_HOT of
// its sum of exp(S - max), the max's own term being 1. The forward kernels
// flag such rows for the backward, which takes their P as exactly one-hot
// and their dS as 0 (flash_attention_bwd.cu's note on the recomputed scores).
constexpr float ONE_HOT = 0x1p-20f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
}
// One arrival that also expects `bytes` of TMA loads in this phase.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}
// One plain arrival (release: the thread's shared-memory writes before it
// are seen by the threads that wait for the phase).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
                 "selp.u32 %0, 1, 0, p; }"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}
// A TMA load of one box of a 3-d tensor map at element coordinates (x, y, z)
// into dst, completing on `bar`; elements outside the tensor become zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y, int z,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(smem_addr(bar))
      : "memory");
}
// Orders this thread's shared-memory writes before the reads of the async
// proxy (wgmma) that a barrier after it releases.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// The wgmma shared-memory descriptor of a swizzled tile (128-byte swizzle,
// 8-row groups 1024 bytes apart). For a K-major operand the k index runs
// along a row, and a k-step starts 32 bytes further along it. For an
// MN-major one (16-bit types, with the instruction's transpose bit set) the
// m or n index runs along a row of 64 bf16 and the k index down the rows: a
// k-step of 16 starts 16 rows (2048 bytes) further down, and with one
// 128-byte atom along MN the leading offset is not used.
__device__ __forceinline__ uint64_t tile_desc(const void* p) {
  return uint64_t((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// Index, in elements of T, of position `pos` of row `row` of a staged tile.
template <typename T>
__device__ __forceinline__ int swizzled(int row, int pos) {
  constexpr int ROW = 128 / sizeof(T), UNIT = 16 / sizeof(T);
  return row * ROW + ((((pos / UNIT) ^ (row & 7)) * UNIT) | (pos % UNIT));
}

// The direct loads: where the TMA engine cannot describe k or v, the threads
// copy a tile themselves. Threads first, first + count, ... take positions
// k0 .. k0 + 128 / sizeof(T) - 1 of channels ch0 .. ch0 + rows - 1 of batch
// b of `src` (element strides s: batch, position, channel; any strides) into
// rows 0 .. rows-1 of the staged tile `dst`, zeros for positions past n and
// channels past `limit`; neighbouring threads take neighbouring positions
// where the position stride is 1, else neighbouring channels, so that the
// global reads coalesce. Asynchronously where the strides allow copies of 8
// or 4 bytes (direct_width; 8 and bf16 4 need position stride 1): cp.async,
// so the loads overlap the work on earlier tiles; the caller commits them as
// a group and waits for it before a barrier. Otherwise (width 0: bf16 at N =
// 1 or odd strides) plain loads and 16-byte stores.
template <typename T>
__device__ __forceinline__ int direct_width(const T* src, const int64_t (&s)[3], int n) {
  const auto fits = [&](int bytes) {
    return s[1] == 1 && n > 1 && s[0] * int64_t(sizeof(T)) % bytes == 0 &&
           s[2] * int64_t(sizeof(T)) % bytes == 0 && reinterpret_cast<uintptr_t>(src) % bytes == 0;
  };
  return fits(8) ? 8 : sizeof(T) == 4 || fits(4) ? 4 : 0;
}

template <int WIDTH>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(dst), "l"(src), "n"(WIDTH),
               "r"(bytes)
               : "memory");
}

template <int WIDTH, typename T>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, const int64_t (&s)[3],
                                                int64_t b, int k0, int n, int rows, int ch0,
                                                int limit, int first, int count) {
  // elements a copy; copies a row (16 or 32)
  constexpr int PER = WIDTH / sizeof(T), ITEMS = 128 / WIDTH;
  const T* base = src + b * s[0];
  if (s[1] == 1 && n > 1 && count % ITEMS == 0) {
    // a thread keeps its positions j .. j + PER - 1 and steps down the rows:
    // its addresses advance by fixed strides
    const int j = PER * (first % ITEMS), rstep = count / ITEMS, pos = k0 + j;
    const int bytes = min(max(n - pos, 0), PER) * int(sizeof(T));
    const uint32_t tile = smem_addr(dst) + WIDTH * ((j / PER) % (16 / WIDTH));
    const int unit = j * int(sizeof(T)) / 16;
    for (int r = first / ITEMS; r < rows; r += rstep) {
      const int ch = ch0 + r, got = ch < limit ? bytes : 0;
      cp_async<WIDTH>(tile + 128 * r + 16 * (unit ^ (r & 7)),
                      got ? base + pos + int64_t(ch) * s[2] : src, got);
    }
    return;
  }
  // else neighbouring threads take neighbouring channels
  for (int e = first; e < rows * ITEMS; e += count) {
    const int r = e % rows, j = PER * (e / rows);
    const int pos = k0 + j, ch = ch0 + r;
    const int got = ch < limit ? min(max(n - pos, 0), PER) * int(sizeof(T)) : 0;
    cp_async<WIDTH>(smem_addr(dst + swizzled<T>(r, j)), got ? base + pos * s[1] + ch * s[2] : src,
                    got);
  }
}

template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, const int64_t (&s)[3], int64_t b,
                                          int k0, int n, int rows, int ch0, int limit, int first,
                                          int count, int width) {
  if (width == 8) return load_tile_async<8>(dst, src, s, b, k0, n, rows, ch0, limit, first, count);
  if (width == 4) return load_tile_async<4>(dst, src, s, b, k0, n, rows, ch0, limit, first, count);
  // plain loads, a 16-byte unit (UNIT positions) a step: its positions
  // below n loaded (up to UNIT in flight), the unit stored whole, zeros and
  // all
  constexpr int UNIT = 16 / sizeof(T);
  const bool pos_fast = s[1] == 1 && n > 1;
  const T* base = src + b * s[0];
  for (int e = first; e < rows * 8; e += count) {
    const int r = pos_fast ? e >> 3 : e % rows, u = pos_fast ? e & 7 : e / rows;
    const int pos = k0 + u * UNIT, ch = ch0 + r;
    union {
      T x[UNIT];
      uint4 v;
    } unit;
#pragma unroll
    for (int i = 0; i < UNIT; ++i)
      unit.x[i] = pos + i < n && ch < limit ? __ldg(base + (pos + i) * s[1] + ch * s[2]) : T(0);
    reinterpret_cast<uint4*>(dst)[8 * r + (u ^ (r & 7))] = unit.v;
  }
}

// The thread's cp.async copies issued since the last commit form one group;
// wait until at most N groups are still in flight. A barrier after the wait
// makes every thread's copies visible to all.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return PFN_cuTensorMapEncodeTiled_v12000(nullptr);
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }();
  return fn;
}

// The TMA map of a channel-major tensor (position stride 1) as an (N, C, B)
// tensor of `elem` bytes an element, with boxes of 128 bytes of positions x
// `rows` channels in the 128-byte swizzle; false where the TMA engine cannot
// take it (a stride or the address not a multiple of 16 bytes).
inline bool encode_channel_major(CUtensorMap* map, CUtensorMapDataType type, int elem,
                                 const void* ptr, int n, int c, int b, const long long* stride,
                                 int rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  const int64_t row_bytes = stride[2] * elem;
  const int64_t batch_bytes = b > 1 ? stride[0] * elem : row_bytes * c;
  if (encode == nullptr || (stride[1] != 1 && n > 1) ||
      reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || row_bytes <= 0 || row_bytes % 16 != 0 ||
      batch_bytes <= 0 || batch_bytes % 16 != 0)
    return false;
  const cuuint64_t dims[3] = {cuuint64_t(n), cuuint64_t(c), cuuint64_t(b)};
  const cuuint64_t strides[2] = {cuuint64_t(row_bytes), cuuint64_t(batch_bytes)};
  const cuuint32_t box[3] = {cuuint32_t(128 / elem), cuuint32_t(rows), 1};
  const cuuint32_t element_strides[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box, element_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes`, once per device.
inline cudaError_t allow_smem(const void* kernel, int bytes, bool (&raised)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace hopper
