// Building blocks shared by the flash-attention kernels for Hopper (sm_90a):
// the [B, T, H, D] stride types, 16-byte cp.async copies into a 128-byte
// swizzled 64 x 64 bf16 tile, the wgmma shared-memory descriptor of that
// tile, and the two warpgroup products the tile kernels are built from
// (wgmma.m64n64k16, bf16 in, f32 accumulate). csrc/flash_fwd.cu (K1's tile
// variant) and csrc/flash_bwd.cu (K2's and K3's tile variants) include it;
// ops/flash_attention.py hashes it with each source, so an edit rebuilds
// both libraries.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;            // head dim the kernels are built for (GPT-2)
constexpr int kBK = 64;           // keys per tile (the visit rule's key tile)
constexpr float kNegInf = -1e9f;  // the framework's finite mask value
constexpr int kTileThreads = 128;         // one warpgroup
constexpr int kTileBytes = 64 * kD * 2;   // one 64 x 64 bf16 tile, 8 KB

struct Strides {
  long long b, t, h;  // element strides of a [B, T, H, D] tensor (d stride 1)
};

struct BiasStrides {
  long long b, h, q, k;  // element strides; 0 = broadcast dimension
};

// The 16-byte paths read rows of 8-element chunks: a 16-byte-aligned base
// and row strides that are multiples of 8 elements (a dimension of size 1
// is never stepped, so its stride does not matter).
inline bool aligned16(const void* p, Strides s, int B, int T, int H) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (B == 1 || s.b % 8 == 0) &&
         (T == 1 || s.t % 8 == 0) && (H == 1 || s.h % 8 == 0);
}

// Above 48 KB of dynamic shared memory needs the opt-in, once per device and
// kernel (each kernel instantiates this template, so keeps its own flags).
template <auto kernel>
cudaError_t allow_smem(size_t bytes) {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (8 bf16 of D) of row r in a 64 x 64 bf16
// tile: 128-byte rows, chunk index XOR (r mod 8). The 8 rows an ldmatrix
// reads at one chunk land in 8 distinct bank groups.
__device__ __forceinline__ uint32_t swizzle(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// 16-byte asynchronous copy; with valid false it reads nothing and fills 0.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The copies wrote through the generic proxy; wgmma reads through the async
// proxy. Each thread fences its own copies after waiting for them, before
// the barrier that publishes the tile.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [r0, r0 + 64) of a [B, T, H, D] bf16 tensor (already offset to its
// batch row and head) into a swizzled tile; rows at or past T read as 0.
// 512 16-byte chunks, 4 per thread of the warpgroup.
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* src,
                                                long long st, int r0,
                                                int T_len) {
  const int c = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (threadIdx.x >> 3) + 16 * i;
    const int t = r0 + r;
    const bool valid = t < T_len;
    cp_async16(dst + swizzle(r, c), valid ? src + t * st + c * 8 : src, valid);
  }
}

// wgmma shared-memory matrix descriptor for a tile in the 128-byte swizzle
// above (1024-byte-aligned base): start address, leading byte offset (16:
// unused by these operands), stride byte offset (1024: from one 8-row group
// to the next), swizzle mode 1 (128 bytes).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(16 >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  wgmma_commit();
  wgmma_wait<0>();
}

// Pin the accumulator registers in program order against the volatile
// wgmma statements: the compiler sees an asynchronous product's registers
// as written when it is launched, and would otherwise move their reads
// above the wait, or their writes below the launch.
__device__ __forceinline__ void fence_registers(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

#define TRLX_WGMMA_D                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define TRLX_WGMMA_D_OPERANDS(d)                                                \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),    \
      "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), \
      "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), \
      "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), \
      "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), \
      "+f"(d[7][2]), "+f"(d[7][3])

// d (+)= a b for the warpgroup's 64 x 64 tile over a k-step of 16, bf16 in,
// f32 accumulate; scale_d = 0 overwrites d. d's layout per warp is the
// mma.m16n8 C fragment of 8 n-tiles: d[j][e] = (row g + 8 (e >> 1), column
// 8 j + 2 t + (e & 1)) of the warp's 16 rows (lane = 4 g + t, warp w owns
// rows 16 w .. 16 w + 15).
// Both operands from shared memory, K-major ([m][k] and [n][k], k
// contiguous): S = Q K^T. A k-step of 16 advances both descriptors by 32
// bytes.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a_desc,
                                         uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TRLX_WGMMA_D
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TRLX_WGMMA_D_OPERANDS(d)
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
}

// A in registers (the mma.m16n8k16 A fragment of each warp's 16 rows: a0 =
// (row g, cols 2t, 2t+1), a1 = row g+8, a2 = cols +8, a3 = row g+8 and cols
// +8), B from shared memory MN-major ([k][n], n contiguous; the transpose
// bit): O += P V. A k-step of 16 rows of B advances its descriptor 2048
// bytes. The accumulator's n-tiles 2 ks and 2 ks + 1, packed to bf16 in
// that order (pack_fragment), are exactly the A fragment of k-step ks.
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[8][4],
                                            const uint32_t (&a)[4],
                                            uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TRLX_WGMMA_D
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TRLX_WGMMA_D_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// two f32 as a bf16 pair, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// k-step ks of an accumulator rounded to bf16, as the A fragment of
// wgmma_rs_mn
__device__ __forceinline__ void pack_fragment(uint32_t (&a)[4],
                                              const float (&d)[8][4], int ks) {
  a[0] = pack_bf16(d[2 * ks][0], d[2 * ks][1]);
  a[1] = pack_bf16(d[2 * ks][2], d[2 * ks][3]);
  a[2] = pack_bf16(d[2 * ks + 1][0], d[2 * ks + 1][1]);
  a[3] = pack_bf16(d[2 * ks + 1][2], d[2 * ks + 1][3]);
}

}  // namespace
