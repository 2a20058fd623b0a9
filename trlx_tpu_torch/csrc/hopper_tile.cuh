// Building blocks shared by the flash-attention kernels for Hopper (sm_90a):
// the [B, T, H, D] stride types, 16-byte cp.async copies into a 128-byte
// swizzled 64 x D bf16 tile, the wgmma shared-memory descriptor of that
// tile, and the two warpgroup products the tile kernels are built from
// (wgmma.m64n64k16, bf16 in, f32 accumulate), and the three-plane split
// that carries an f32 operand through them (split3, at the end).
// csrc/flash_fwd.cu (K1's tile and split3 variants), csrc/flash_bwd.cu (K2's
// and K3's tile and split3 variants) and csrc/split_planes.cu (the split's
// pre-pass) include it; ops/flash_attention.py hashes it with each source,
// so an edit rebuilds every library.
//
// Head dims. Every kernel is a template over the head dim D and is built
// for the dims in kHeadDims (the learning guard's and the T5 stand-in's 16,
// the randomwalks configs' 24, the GPT-2 stand-in's 32, GPT-2's 64,
// GPT-NeoX-20B's 96, GPT-Neo's 128, GPT-J's 256); the C entry points refuse
// any other, and
// a per-D constant is chosen with per_head_dim, which fails to compile for
// a D outside kHeadDims. A 64 x D tile is tile_cols<D>() / 64 swizzle atoms
// of 64 rows x 128 bytes (64 bf16 columns each, 8 KB), atom a holding
// columns 64 a .. 64 a + 63: a K-major product (S = Q K^T) steps through
// the atoms 4 k-steps at a time (kmajor_step), kmajor_steps<D>() k-steps in
// all, an MN-major one (O += P V) takes one atom per 64 output columns
// (mn_step), each with its own 64 x 64 accumulator. Where D is not a whole
// number of atoms the tile is padded: at D = 96 to 128 columns (two atoms,
// 16 KB), at D = 16, 24 and 32 to one atom of 64 columns; D = 128 is two
// whole atoms, as D = 64 is one, and pads nothing. The copies
// zero-fill the padding (cp.async src-size 0), and nothing past column D is
// read from memory. A K-major product covers D rounded up to 16 columns (6
// k-steps at 96, 1 at 16, 2 at 24 and 32): at D = 24 its second k-step
// multiplies columns 24..31, zero in both operands, so no dot product
// changes. The MN-major products' columns D..63 (of the last atom) are
// computed and dropped at the store. At D <= 32 this spends 2x to 4x the
// shared memory and product width the row needs; a 64- or 32-byte swizzle
// would not pad.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHeadDims[] = {16, 24, 32, 64, 96, 128, 256};  // the head dims the kernels are built for
constexpr int kBK = 64;           // keys per tile (the visit rule's key tile)
constexpr float kNegInf = -1e9f;  // the framework's finite mask value
constexpr int kTileThreads = 128;         // one warpgroup
constexpr int kAtomBytes = 64 * 128;      // one 64-row x 128-byte swizzle atom, 8 KB

// One constant per built head dim, given in kHeadDims' order; any other D
// fails to compile, so a new head dim must choose each constant explicitly.
template <int D, typename T>
__host__ __device__ constexpr T per_head_dim(T at16, T at24, T at32, T at64, T at96,
                                             T at128, T at256) {
  static_assert(D == 16 || D == 24 || D == 32 || D == 64 || D == 96 || D == 128 ||
                    D == 256,
                "D is not one of kHeadDims");
  return D == 16 ? at16 : D == 24 ? at24 : D == 32 ? at32 : D == 64 ? at64
       : D == 96 ? at96 : D == 128 ? at128 : at256;
}
static_assert(sizeof(kHeadDims) / sizeof(kHeadDims[0]) == 7 && kHeadDims[0] == 16 &&
                  kHeadDims[1] == 24 && kHeadDims[2] == 32 && kHeadDims[3] == 64 &&
                  kHeadDims[4] == 96 && kHeadDims[5] == 128 && kHeadDims[6] == 256,
              "per_head_dim takes its constants in kHeadDims' order");

// The columns of a 64 x D tile in shared memory: D rounded up to whole
// 64-column swizzle atoms (64 at D = 16, 24 and 32, 128 at D = 96; the
// padding is zero-filled). A row is whole 16-byte chunks (D % 8 == 0).
template <int D>
__host__ __device__ constexpr int tile_cols() {
  static_assert(D % 8 == 0, "whole 16-byte chunks of 8 bf16");
  return (D + 63) / 64 * 64;
}

// The k-steps of 16 columns a K-major product over D takes: D rounded up to
// 16 (2 at D = 24, whose columns 24..31 are zero in both operands)
template <int D>
__host__ __device__ constexpr int kmajor_steps() {
  return (D + 15) / 16;
}

// one 64 x D bf16 tile: 8 KB at D <= 64, 16 KB at D = 96 and 128, 32 KB at D = 256
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return 64 * tile_cols<D>() * 2;
}

// whether the kernels are built for head dim D (kHeadDims)
constexpr bool built_head_dim(int D) {
  for (int d : kHeadDims)
    if (d == D) return true;
  return false;
}

// f(std::integral_constant<int, D>) at a built head dim (kHeadDims); -1 for
// any other
template <typename F>
int with_head_dim(int D, F f) {
  switch (D) {
    case 16: return static_cast<int>(f(std::integral_constant<int, 16>()));
    case 24: return static_cast<int>(f(std::integral_constant<int, 24>()));
    case 32: return static_cast<int>(f(std::integral_constant<int, 32>()));
    case 64: return static_cast<int>(f(std::integral_constant<int, 64>()));
    case 96: return static_cast<int>(f(std::integral_constant<int, 96>()));
    case 128: return static_cast<int>(f(std::integral_constant<int, 128>()));
    case 256: return static_cast<int>(f(std::integral_constant<int, 256>()));
    default: return -1;
  }
}

struct Strides {
  long long b, t, h;  // element strides of a [B, T, H, D] tensor (d stride 1)
};

struct BiasStrides {
  long long b, h, q, k;  // element strides; 0 = broadcast dimension
};

// The end of the keys a CTA whose query rows start at q0 visits (the causal
// visit rule of csrc/flash_fwd.cu, which every kernel takes from here):
// under the causal flag the 64-key tiles that start before the end of the
// forward's query tile holding q0 (fwd_bq rows: 16 when Q <= 16, else 64),
// else all K keys.
__device__ __forceinline__ int visit_end(int q0, int fwd_bq, int K, int causal) {
  if (!causal) return K;
  const int tile_end = (q0 / fwd_bq + 1) * fwd_bq;
  return min(K, (tile_end + kBK - 1) / kBK * kBK);
}

// The dead-tile skip of the split3 kernels. A pair (query qi, key kj) of a
// tile is live when the key is one of the K and its additive bias is above
// NEG_INF / 2 (live_pair). A tile with no live pair weighs exactly 0 in
// every row that has already seen a live key: in the forward, a row whose
// running max m is above NEG_INF / 2 takes exp(x - m) = 0 for every x of
// the tile (x <= NEG_INF / 2 plus a logit), so m stays put, its rescale is
// exp(0) = 1 and l and O are unchanged; in the backward, a row whose
// (outside) LSE is above NEG_INF / 2 has P = exp(x - LSE) = 0, so dS = 0
// and every gradient term of the tile is 0. dead_tile votes CTA-wide on the
// bias values each thread reads for its own pairs (which the kernel then
// adds to its logits, at D <= 64): no live pair (__syncthreads_or) and every
// row live (__syncthreads_and); a CTA skips the tile only then, and a row
// that has seen no live key keeps the visit. Both are barriers, and the
// result is the same in every thread. (Taken for every tile at once before
// the loop, with the loads in flight together, the vote read the CTA's
// bias slab in a phase of its own and cost more than this one, on an H100.)
__device__ __forceinline__ bool live_pair(float bias, int kj, int K) {
  return kj < K && bias > 0.5f * kNegInf;
}

__device__ __forceinline__ bool dead_tile(bool any_live_pair, bool rows_live) {
  return !__syncthreads_or(any_live_pair) && __syncthreads_and(rows_live);
}

// The factor that turns the backward's P = exp(S - LSE) into the weights the
// forward gave a row (K1's optional p_scale output). A row with no live key
// has its max m at NEG_INF's magnitude, where f32's spacing (64 at 1e9)
// swallows log(l): its LSE rounds to m, and exp(S - LSE) sums to l, not 1,
// over the keys the forward averaged. There the factor is exp(LSE - m) / l,
// and the wrapper scales dO's row by it, which scales dP, delta, dS and P^T dO
// alike; every other row takes exactly 1. The intrinsics keep the epilogue
// free of the IEEE division's slow-path call, whose saved registers spilled
// 8 bytes in K1's fma variant at D = 256 (within 2 ulp of 1 / l; __expf(0)
// is exactly 1).
__device__ __forceinline__ float p_scale_of(float m, float lse, float l) {
  return m > 0.5f * kNegInf ? 1.f : __fdividef(__expf(lse - m), l);
}

// Whether a split3 kernel keeps the bias values its vote read for its
// logits (32 registers a thread) or reads them again: kept at D <= 64,
// where the registers are free; above, the accumulator chunk and the
// products' descriptors leave less room
template <int D>
__host__ __device__ constexpr bool split3_keep_bias() {
  return per_head_dim<D>(true, true, true, true, false, false, false);
}

// The 16-byte paths read rows of 8-element chunks: a 16-byte-aligned base
// and row strides that are multiples of 8 elements (a dimension of size 1
// is never stepped, so its stride does not matter).
inline bool aligned16(const void* p, Strides s, int B, int T, int H) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (B == 1 || s.b % 8 == 0) &&
         (T == 1 || s.t % 8 == 0) && (H == 1 || s.h % 8 == 0);
}

// Whether s are the strides of a contiguous [B, T, H, D] tensor (the split3
// planes, whose plane stride the launch takes as B T H D)
inline bool contiguous(Strides s, int T, int H, int D) {
  return s.h == D && s.t == static_cast<long long>(H) * D &&
         s.b == static_cast<long long>(T) * H * D;
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

// The dynamic shared memory from its first 1024-byte boundary (the 128-byte
// swizzle repeats over 1024 bytes): the generic pointer and the shared
// address of the same byte. A kernel asks for 1 KB of slack for this.
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw, uint32_t& addr) {
  const uint32_t a = smem_addr(raw);
  const uint32_t pad = (1024u - (a & 1023u)) & 1023u;
  addr = a + pad;
  return raw + pad;
}

// Byte offset of 16-byte chunk c (8 bf16 of D, c < 8) of row r in one
// 64 x 64 bf16 swizzle atom: 128-byte rows, chunk index XOR (r mod 8). The
// 8 rows an ldmatrix reads at one chunk land in 8 distinct bank groups.
__device__ __forceinline__ uint32_t swizzle(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// Byte offset of 16-byte chunk c (any c < tile_cols / 8) of row r in a 64 x D tile:
// atom c / 8, chunk c mod 8 within it.
__device__ __forceinline__ uint32_t tile_offset(int r, int c) {
  return static_cast<uint32_t>((c >> 3) * kAtomBytes) + swizzle(r, c & 7);
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
// batch row and head) into a swizzled 64 x D tile; rows at or past T read
// as 0. 8 tile_cols 16-byte chunks, spread over the kThreads threads that
// call it (neighbouring threads on neighbouring chunks of a row): 4 per
// thread of one warpgroup at D <= 64, 8 at D = 96 and 128, 16 at D = 256. Chunks
// D / 8 .. of a row are the padding (12..15 at D = 96; 2..7, 3..7 and 4..7
// at D = 16, 24 and 32): their copies read nothing (src-size 0) and fill 0,
// so nothing past column D - 1 is read. Above D = 64 the thread's row and
// chunk are made opaque per call: ptxas otherwise hoisted the 16 row
// offsets of each tile out of the key loop and spilled.
template <int D, int kThreads = kTileThreads>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* src,
                                                long long st, int r0,
                                                int T_len) {
  constexpr int kRowChunks = tile_cols<D>() / 8;
  constexpr int kRowsPerPass = kThreads / kRowChunks;
  constexpr bool kPadded = tile_cols<D>() != D;
  static_assert(kThreads % kRowChunks == 0 && 64 % kRowsPerPass == 0,
                "whole rows per pass");
  int c = threadIdx.x % kRowChunks, r = threadIdx.x / kRowChunks;
  if constexpr (D > 64) asm volatile("" : "+r"(c), "+r"(r));
  const bool in_row = !kPadded || c < D / 8;  // a chunk of the row, not padding
#pragma unroll
  for (int i = 0; i < 64 / kRowsPerPass; ++i) {
    const int row = r + i * kRowsPerPass;
    const int t = r0 + row;
    const bool valid = in_row && t < T_len;
    cp_async16(dst + tile_offset(row, c), valid ? src + t * st + c * 8 : src, valid);
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

// The shared address a K-major operand's descriptor starts from at k-step
// ks (16 columns of D): 32 bytes a step within an atom, the next atom every
// 4 steps.
__device__ __forceinline__ uint32_t kmajor_step(uint32_t tile, int ks) {
  return tile + static_cast<uint32_t>((ks >> 2) * kAtomBytes + 32 * (ks & 3));
}

// The shared address an MN-major B operand's descriptor starts from for
// output columns 64 n .. 64 n + 63 (atom n) at k-step ks (16 rows of the
// tile, 2048 bytes each).
__device__ __forceinline__ uint32_t mn_step(uint32_t tile, int n, int ks) {
  return tile + static_cast<uint32_t>(n * kAtomBytes + 2048 * ks);
}

// A 64 x D tile's wgmma descriptors. At D = 64 each is formed from the
// step's shared address (kmajor_step, mn_step). Above, a product takes D / 16
// k-steps, and ptxas hoisted every step's descriptor of the tiles that stay
// put across the key loop (Q, dO; both K/V stages) out of it, 2 registers
// each, and spilled: there the tile's descriptor is formed once a use, made
// opaque to the compiler, and each step adds its byte offset / 16 to the
// start-address field right at the product (no carry: every shared address
// is below 2^18).
template <int D>
struct TileDesc {
  uint32_t addr;
  uint64_t base;
  __device__ __forceinline__ explicit TileDesc(uint32_t tile)
      : addr(tile), base(smem_desc(tile)) {
    if constexpr (D > 64) asm volatile("" : "+l"(base));
  }
  // K-major operand at k-step ks (16 columns of D)
  __device__ __forceinline__ uint64_t kstep(int ks) const {
    if constexpr (D > 64)
      return base + static_cast<uint64_t>(((ks >> 2) * kAtomBytes + 32 * (ks & 3)) >> 4);
    else
      return smem_desc(kmajor_step(addr, ks));
  }
  // MN-major B operand, output columns 64 n .. 64 n + 63, k-step ks
  __device__ __forceinline__ uint64_t mn(int n, int ks) const {
    if constexpr (D > 64)
      return base + static_cast<uint64_t>((n * kAtomBytes + 2048 * ks) >> 4);
    else
      return smem_desc(mn_step(addr, n, ks));
  }
};

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

// the same for an accumulator of N 64-column chunks (a 64 x 64 N tile)
template <int N>
__device__ __forceinline__ void fence_registers(float (&d)[N][8][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) fence_registers(d[n]);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N][8][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[n][j][e] = 0.f;
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
// bytes within an atom (kmajor_step).
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
// bytes (mn_step). The accumulator's n-tiles 2 ks and 2 ks + 1, packed to bf16 in
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

// ---------------------------------------------------------------------------
// split3: an f32 operand on the bf16 tensor cores as three bf16 planes
// ---------------------------------------------------------------------------
//
// x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1): each residual is
// exact in f32 and holds at most 16, then 8, significant bits, so x0 + x1 +
// x2 is x (but where a plane falls below bf16's normal range). A product of
// two f32 operands is the sum of the plane products x_i y_j; the kernels
// take the six with i + j <= 2 (kPlanePairs) and drop x1 y2, x2 y1 and x2
// y2, terms of about 2^-24 relative (all nine summed no closer to f64). Each plane product is exact on the
// tensor cores (8-bit significands) and sums in their f32 accumulator, the
// smallest first. That accumulator does not round to nearest: summed
// across a block's key tiles (O, dQ) or query chunks (dK, dV) it drifted
// 3-10x further from f64 than the fma variant's FMAs. So each tile's or
// chunk's products sum into a fresh accumulator, which is added to the
// running one with f32 adds (accumulate_planes). An operand's planes are three 64 x D bf16 tiles one
// tile_bytes<D>() apart in shared memory, staged from the three contiguous
// [B, T, H, D] bf16 planes csrc/split_planes.cu writes (plane p at p times
// the tensor's size), with the 16-byte copies of load_tile_async. The kernels
// are csrc/flash_fwd.cu's and csrc/flash_bwd.cu's split3 variants.

constexpr int kPlanePairs = 6;

// the planes of plane pair p (0 <= p < kPlanePairs), smallest terms first:
// (1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0)
__host__ __device__ constexpr int plane_a(int p) {
  return p == 0 ? 1 : p == 1 ? 0 : p == 2 ? 2 : p == 3 ? 0 : p == 4 ? 1 : 0;
}
__host__ __device__ constexpr int plane_b(int p) {
  return p == 0 ? 1 : p == 1 ? 2 : p == 2 ? 0 : p == 3 ? 1 : 0;
}

// x as its three planes (split3_fragment's arithmetic, one value)
__device__ __forceinline__ void split3_value(float x, bf16 (&planes)[3]) {
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    planes[p] = __float2bfloat16_rn(x);
    x -= __bfloat162float(planes[p]);
  }
}

// k-step ks of an f32 accumulator as three bf16 A fragments (pack_fragment's
// layout), a[p][ks] holding plane p
__device__ __forceinline__ void split3_fragment(uint32_t (&a)[3][4][4],
                                                const float (&d)[8][4], int ks) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float x0 = d[2 * ks + (i >> 1)][2 * (i & 1)];
    float x1 = d[2 * ks + (i >> 1)][2 * (i & 1) + 1];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      a[p][ks][i] = pack_bf16(x0, x1);
      const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[p][ks][i]));
      x0 -= r.x;
      x1 -= r.y;
    }
  }
}

// Rows [r0, r0 + 64) of each of the three planes (src, src + plane, src + 2
// plane; [B, T, H, D] bf16, already offset to the batch row and head) into
// the three tiles at dst, dst + tile_bytes, dst + 2 tile_bytes:
// load_tile_async's copies, the planes one after another and four rows of
// a thread at a time (unrolled, the split3 kernels at D = 256 held the
// addresses of 48 rows at once and spilled).
template <int D, int kThreads = kTileThreads>
__device__ __forceinline__ void load_planes_async(uint32_t dst, const bf16* src,
                                                  long long plane, long long st, int r0,
                                                  int T_len) {
  constexpr int kRowChunks = tile_cols<D>() / 8;
  constexpr int kRowsPerPass = kThreads / kRowChunks;
  constexpr bool kPadded = tile_cols<D>() != D;
  static_assert(kThreads % kRowChunks == 0 && 64 % kRowsPerPass == 0, "whole rows per pass");
  const int c = threadIdx.x % kRowChunks, r = threadIdx.x / kRowChunks;
  const bool in_row = !kPadded || c < D / 8;  // a chunk of the row, not padding
#pragma unroll 1
  for (int p = 0; p < 3; ++p) {
#pragma unroll 4
    for (int i = 0; i < 64 / kRowsPerPass; ++i) {
      const int row = r + i * kRowsPerPass;
      const int t = r0 + row;
      const bool valid = in_row && t < T_len;
      cp_async16(dst + p * tile_bytes<D>() + tile_offset(row, c),
                 valid ? src + p * plane + t * st + c * 8 : src, valid);
    }
  }
}

// Whether the split3 products keep their loop over plane pairs rolled (one
// pair's wgmmas a trip): at D = 256, whose 16 k-steps a pair make the six
// pairs 96 wgmmas
template <int D>
__host__ __device__ constexpr bool split3_rolled() {
  return per_head_dim<D>(false, false, false, false, false, false, true);
}

// d = X Y^T over the planes of two 64 x D operands X, Y [row][d] in shared
// memory (K-major both): the kPlanePairs plane products, kmajor_steps<D>()
// wgmmas each, issued (not committed); d is overwritten.
template <int D>
__device__ __forceinline__ void product3_pair(float (&d)[8][4], uint32_t x, uint32_t y, int p) {
  const TileDesc<D> dx(x + plane_a(p) * tile_bytes<D>()), dy(y + plane_b(p) * tile_bytes<D>());
#pragma unroll
  for (int ks = 0; ks < kmajor_steps<D>(); ++ks)
    wgmma_ss(d, dx.kstep(ks), dy.kstep(ks), p > 0 || ks > 0);
}

template <int D>
__device__ __forceinline__ void product3(float (&d)[8][4], uint32_t x, uint32_t y) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
  fence_registers(d);
  wgmma_fence();
  if constexpr (split3_rolled<D>()) {
#pragma unroll 1
    for (int p = 0; p < kPlanePairs; ++p) product3_pair<D>(d, x, y, p);
  } else {
#pragma unroll
    for (int p = 0; p < kPlanePairs; ++p) product3_pair<D>(d, x, y, p);
  }
}

// d += A B over the planes: A as the register fragments of
// split3_fragment, B the planes of a 64 x 64 tile [k][d] (one swizzle atom,
// MN-major) at b, plane_bytes apart; issued, not committed
__device__ __forceinline__ void accumulate3_mn(float (&d)[8][4], const uint32_t (&a)[3][4][4],
                                               uint32_t b, uint32_t plane_bytes) {
#pragma unroll
  for (int p = 0; p < kPlanePairs; ++p) {
    // formed at its use, as TileDesc does above D = 64: B stays put across
    // a kernel's loop, and hoisted, its 24 descriptors would hold 48 registers
    uint64_t desc = smem_desc(b + plane_b(p) * plane_bytes);
    asm volatile("" : "+l"(desc));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs_mn(d, a[plane_a(p)][ks], desc + (2048 * ks >> 4));
  }
}

// The 64-column chunks of a split3 kernel's accumulator (O, dQ, dK, dV):
// one CTA holds one chunk, and at D = 96, 128 and 256 the 2, 2 and 4 CTAs of
// a tile each form the whole S (and dP). A chunk's accumulator and its
// tile's fresh one (accumulate_planes) are 64 registers a thread beside S,
// dP and the three fragments; two chunks of both spilled.
template <int D>
__host__ __device__ constexpr int split3_chunks() {
  return per_head_dim<D>(1, 1, 1, 1, 2, 2, 4);
}
static_assert(split3_chunks<96>() == tile_cols<96>() / 64 &&
                  split3_chunks<256>() == tile_cols<256>() / 64,
              "one chunk a swizzle atom");

__device__ __forceinline__ void zero(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
}

// acc += X B over the planes: X (f32, 64 x 64 in an accumulator's layout)
// split into three bf16 fragments a k-step (split3_fragment), B's three
// planes (one 64 x 64 atom [k][d], MN-major) at b, plane_bytes apart. The
// plane products sum into a fresh accumulator, then acc adds it with f32
// adds (round to nearest).
__device__ __forceinline__ void accumulate_planes(float (&acc)[8][4], const float (&x)[8][4],
                                                  uint32_t b, uint32_t plane_bytes) {
  uint32_t f[3][4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) split3_fragment(f, x, ks);
  float t[8][4];
  zero(t);
  fence_registers(t);
  wgmma_fence();
  accumulate3_mn(t, f, b, plane_bytes);
  wgmma_commit_and_wait();
  fence_registers(t);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += t[j][e];
}

}  // namespace
