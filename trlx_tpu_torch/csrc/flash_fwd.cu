// Flash-attention forward for Hopper (sm_90a), bound through a plain C entry
// point (`trlx_flash_fwd`) that Python loads with ctypes.
//
// Replaces the TPU kernel trlx_tpu/ops/flash_attention.py::_fwd_kernel (:97,
// launched :181). Every variant computes the same function: S = scale * Q K^T
// in f32, plus an optional additive f32 bias read through four strides (0 =
// broadcast dimension), plus an optional causal mask (finite NEG_INF) with
// wholly-future key tiles skipped; a running row max / row sum and an f32
// accumulator carried across key tiles; P rounded to V's dtype before P V
// (the row sum adds the unrounded P); O = acc / max(l, 1e-30) in q's dtype
// and LSE = m + log(max(l, 1e-30)) in f32. Keys past K are left out (zero
// weight), not masked. q/k/v are read in the port's [B, T, H, D] layout
// through strides; O is written [B, Q, H, D] contiguous, LSE [B, H, Q].
//
// The causal visit rule, which the backward kernels (csrc/flash_bwd.cu) and
// the plain backward repeat: a query row sees the 64-key tiles that start
// before the end of its query tile, and that tile has 16 rows when Q <= 16
// and 64 rows otherwise. A left-padding row whose visible keys are all
// masked therefore averages the keys of those tiles, as the TPU kernel does.
//
// Three variants, chosen in Python (ops/flash_attention.py::forward_variant)
// and passed in; a mismatched choice is refused with -1:
//
//  tile (bf16, Q > 16: serving prefill B=8 Q=512 K=576, the update forward
//    B=16 T=112 causal, the rollout prefill B=128 Q=64 K=112). At these
//    shapes the bytes bound (10.8 us at serving prefill, its [B,1,Q,K] f32
//    bias included) sits next to the tensor-core bound (7.3 us), far below
//    what f32 FMA can reach. One warpgroup (4 warps, 128 threads) per
//    (64-row query tile, head, batch row); each warp owns 16 query rows.
//    Q is staged once; 64 x 64 bf16 K and V tiles go through a 2-stage ring
//    in shared memory, filled by 16-byte cp.async copies that overlap the
//    current tile's math, in the 128-byte swizzle that wgmma reads. Both
//    products are warpgroup MMAs, wgmma.m64n64k16 with f32 accumulation:
//    S = Q K^T with both operands from shared memory (K-major), O += P V
//    with P in registers and V MN-major (the transpose bit). Scale, bias
//    and mask are applied on the accumulator fragments (each thread's 32
//    bias values are loaded before it waits for the tile, so their latency
//    overlaps the copies), the online softmax reduces each row over its
//    quad of lanes, and P never leaves registers: the S accumulator,
//    rounded to bf16, is the A operand of O += P V. TMA and warp
//    specialisation are left for a long-context shape: here one CTA runs
//    only 1-9 key tiles, and q/k/v arrive as strided views (a tensor map per
//    call costs host time).
//
//  decode (bf16, Q <= 16: serving decode B=32 K=576, rollout and eval
//    decode B=128 K=112, all one query row). A GEMV bound by the K/V bytes,
//    so it runs on the CUDA cores and is about memory-level parallelism.
//    One CTA of 4 warps per (head, batch row, query row); each group of 8
//    lanes reads one 128-byte K or V row with 16-byte loads (8 bf16 a
//    lane), so a warp covers 4 keys per load, and each group walks every
//    16th key, a batch of 4 keys at a time; the next batch's K, V and bias
//    loads are started before the current batch's math, so loads stay in
//    flight. Dot products reduce over the 8 lanes with shuffles; each group
//    keeps its own running (m, l, acc), and P is rounded to bf16 against
//    the group's running max. The groups merge with the usual exp(m_g - m)
//    rescale, in a warp by shuffles, across warps through shared memory. No
//    second launch: B*H CTAs (384 and 1536 at the path's shapes) fill the
//    132 SMs. Q in 2..16 (no path sends it) rereads K/V once per row; a
//    path that decodes several rows at once (speculative or chunked
//    decode) would want them held in one CTA. Under the causal flag the
//    visit rule leaves keys 0-63.
//
//  fma (f32, every Q): the parity path, on the CUDA cores. Register-blocked
//    4x4 f32 FMA from shared memory, K/V tiles staged in f32. Tensor cores
//    would make it TF32 and break the f32 tolerances (1e-4 at kernel level,
//    4.2e-7 relative on the full-width gradient). No bf16 call reaches it.
//
// ptxas for sm_90a (chip_smoke.py phase 1 prints it; 0 spill bytes in all):
//   tile            121 registers, 40960 B static shared memory
//   decode          114 registers, 1312 B static shared memory
//   fma BQ = 16/64  48/108 registers, 41600/66560 B dynamic shared memory
//                   (the 64-row tile opts in above 48 KB)

#include <math.h>

#include "hopper_tile.cuh"

namespace {

enum Variant { kFma = 0, kTile = 1, kDecode = 2 };

// Logit of (query row qi, key kj < K) from the raw product s. bias_row is
// the bias row read for qi (a padded row past Q reads a valid row).
__device__ __forceinline__ float logit(float s, float scale, const float* biasb,
                                       BiasStrides sb, int bias_row, int qi,
                                       int kj, int causal) {
  float x = s * scale;
  if (biasb) x += biasb[bias_row * sb.q + kj * sb.k];
  if (causal && kj > qi) x += kNegInf;
  return x;
}

// ---------------------------------------------------------------------------
// fma: the f32 parity path
// ---------------------------------------------------------------------------

constexpr int kLD = kD + 1;       // padded row stride of the Q/K/V tiles (banks)
constexpr int kLP = kBK + 1;      // padded row stride of the P tile
constexpr int kFmaThreads = 256;  // 16 x 16 threads

template <int BQ>
__global__ void __launch_bounds__(kFmaThreads)
flash_fwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     float* __restrict__ o, float* __restrict__ lse, int H,
                     int Q, int K, Strides sq, Strides sk, Strides sv,
                     BiasStrides sb, float scale, int causal) {
  constexpr int RQ = BQ / 16;  // query rows per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][kLD]
  float* Ks = Qs + BQ * kLD;     // [kBK][kLD]
  float* Vs = Ks + kBK * kLD;    // [kBK][kLD]
  float* Ps = Vs + kBK * kLD;    // [BQ][kLP]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key / head-dim column group
  const int ty = tid >> 4;  // query row group
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* biasb = bias ? bias + b * sb.b + h * sb.h : nullptr;

  for (int i = tid; i < BQ * kD; i += kFmaThreads) {
    const int r = i / kD, d = i % kD;
    const int qi = q0 + r;
    Qs[r * kLD + d] = qi < Q ? qb[qi * sq.t + d] : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][4];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  // causal: key tiles that start after the tile's last query are skipped
  const int k_end = causal ? min(K, q0 + BQ) : K;

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K/V/P reads are done
    for (int i = tid; i < kBK * kD; i += kFmaThreads) {
      const int c = i / kD, d = i % kD;
      const int kj = k0 + c;
      const bool in = kj < K;
      Ks[c * kLD + d] = in ? kb[kj * sk.t + d] : 0.f;
      Vs[c * kLD + d] = in ? vb[kj * sv.t + d] : 0.f;
    }
    __syncthreads();

    float s[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * kLD + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float qv = Qs[(ty * RQ + i) * kLD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv, kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i;
      const int qi = q0 + r;
      const int qb_row = min(qi, Q - 1);  // padded rows read a valid bias row
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        // keys past K are left out, not masked
        const float x = kj >= K ? -INFINITY
                                : logit(s[i][j], scale, biasb, sb, qb_row, qi, kj, causal);
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      // every processed tile holds at least one key < K, so m_new is finite
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        Ps[r * kLP + tx + 16 * j] = p;  // f32: rounding to V's dtype is exact
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // P complete

#pragma unroll 8
    for (int c = 0; c < kBK; ++c) {
      float vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[c * kLD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float p = Ps[(ty * RQ + i) * kLP + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + ty * RQ + i;
    if (qi >= Q) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    float* orow = o + ((static_cast<long long>(b) * Q + qi) * H + h) * kD;
#pragma unroll
    for (int j = 0; j < 4; ++j) orow[tx + 16 * j] = acc[i][j] / l_safe;
    if (lse && tx == 0)
      lse[(static_cast<long long>(b) * H + h) * Q + qi] = m[i] + logf(l_safe);
  }
}

template <int BQ>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       const void* bias, void* o, void* lse, int B, int H,
                       int Q, int K, Strides sq, Strides sk, Strides sv,
                       BiasStrides sb, float scale, int causal,
                       cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (BQ * kLD + 2 * kBK * kLD + BQ * kLP);
  cudaError_t err = allow_smem<flash_fwd_fma_kernel<BQ>>(smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Q + BQ - 1) / BQ, H, B);
  flash_fwd_fma_kernel<BQ><<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(o), static_cast<float*>(lse), H, Q, K, sq, sk, sv,
      sb, scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tile: bf16, Q > 16, tensor cores (wgmma.m64n64k16)
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;            // query rows per CTA: 4 warps x 16
constexpr int kTileMinBlocks = 4;  // CTAs per SM: caps registers at 128

// Operand layouts (hopper_tile.cuh): S = Q K^T takes Q [row][d] and K
// [key][d] K-major from shared memory (wgmma_ss); O += P V takes P's A
// fragment from registers and V [key][d] MN-major (wgmma_rs_mn).
// Why Q comes from shared memory and P may sit in registers: with Q's
// fragments loaded once into registers (ldmatrix before the key loop) as
// the A operand of S = Q K^T, ptxas packed P's fragments (F2FP) into the
// very registers that held Q and never reloaded Q, so from the second key
// tile on S took the previous tile's P for Q; "+r" operand fences on the
// fragments left the SASS unchanged. A register A operand must not outlive
// its key tile. P does not: it is packed from this tile's S accumulator
// just before the P V HGMMAs, no instruction writes those registers between
// the HGMMAs and their WARPGROUP.DEPBAR, and the next write to them is the
// next tile's S product, after that wait (cuobjdump -sass of the built
// kernel; PERF.md section 6).
__global__ void __launch_bounds__(kTileThreads, kTileMinBlocks)
flash_fwd_tile_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ bias,
                      bf16* __restrict__ o, float* __restrict__ lse, int H,
                      int Q, int K, Strides sq, Strides sk, Strides sv,
                      BiasStrides sb, float scale, int causal) {
  // Q, K[2], V[2]; the 128-byte swizzle repeats every 1024 bytes
  __shared__ __align__(1024) uint8_t smem[5 * kTileBytes];
  const uint32_t sQ = smem_addr(smem);
  const uint32_t sK0 = sQ + kTileBytes;
  const uint32_t sV0 = sQ + 3 * kTileBytes;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  // causal: key tiles that start after the tile's last query are skipped
  const int k_end = causal ? min(K, q0 + kBQ) : K;
  const int n_tiles = (k_end + kBK - 1) / kBK;

  load_tile_async(sQ, qb, sq.t, q0, Q);
  load_tile_async(sK0, kb, sk.t, 0, K);
  load_tile_async(sV0, vb, sv.t, 0, K);
  cp_async_commit();

  // this thread's two query rows (C fragment rows g and g + 8 of its warp)
  // and their bias rows (a padded row past Q reads a valid row)
  int qi[2];
  const float* brow[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    qi[hr] = q0 + warp * 16 + g + 8 * hr;
    brow[hr] = bias ? bias + b * sb.b + h * sb.h + min(qi[hr], Q - 1) * sb.q
                    : nullptr;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    const int k0 = t * kBK;
    if (t + 1 < n_tiles) {  // prefetch the next tile into the other stage
      load_tile_async(sK0 + (buf ^ 1) * kTileBytes, kb, sk.t, k0 + kBK, K);
      load_tile_async(sV0 + (buf ^ 1) * kTileBytes, vb, sv.t, k0 + kBK, K);
    }
    cp_async_commit();  // possibly empty: keeps one group per iteration
    // the bias of this thread's 32 (row, key) pairs, read before the wait
    // so that its latency overlaps the copies and the first product
    float bv[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + 8 * j + 2 * t4 + (e & 1);
        bv[j][e] = brow[0] && kj < K ? brow[e >> 1][kj * sb.k] : 0.f;
      }
    cp_async_wait<1>();  // everything up to this tile has landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t sK = sK0 + buf * kTileBytes;
    const uint32_t sV = sV0 + buf * kTileBytes;

    // S = Q K^T for the warpgroup's 64 rows x 64 keys (each warp 16 rows)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    fence_registers(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss(s, smem_desc(sQ + 32 * ks), smem_desc(sK + 32 * ks), ks > 0);
    wgmma_commit_and_wait();
    fence_registers(s);

    // logits, then the online softmax over each row's quad of lanes
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const int kj = k0 + 8 * j + 2 * t4 + (e & 1);
        float x = s[j][e] * scale + bv[j][e];
        if (causal && kj > qi[hr]) x += kNegInf;
        x = kj < K ? x : -INFINITY;  // keys past K are left out, not masked
        s[j][e] = x;
        mx[hr] = fmaxf(mx[hr], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      // the quad covers all 64 keys of the tile, one of them < K: finite
      const float m_new = fmaxf(m[hr], mx[hr]);
      alpha[hr] = __expf(m[hr] - m_new);  // 0 on the first tile
      m[hr] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 1);
      rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 2);
      l[hr] = l[hr] * alpha[hr] + rs[hr];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

    // O += bf16(P) V: 4 k-steps of 16 keys, P from registers
    uint32_t pa[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) pack_fragment(pa[ks], s, ks);
    fence_registers(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_rs_mn(acc, pa[ks], smem_desc(sV + 2048 * ks));
    wgmma_commit_and_wait();
    fence_registers(acc);
    __syncthreads();  // this stage is read; the next iteration refills it
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (qi[hr] >= Q) continue;
    const float l_safe = fmaxf(l[hr], 1e-30f);
    bf16* orow = o + ((static_cast<long long>(b) * Q + qi[hr]) * H + h) * kD;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) =
          pack_bf16(acc[j][2 * hr] / l_safe, acc[j][2 * hr + 1] / l_safe);
    if (lse && t4 == 0)
      lse[(static_cast<long long>(b) * H + h) * Q + qi[hr]] = m[hr] + logf(l_safe);
  }
}

cudaError_t launch_tile(const void* q, const void* k, const void* v,
                        const void* bias, void* o, void* lse, int B, int H,
                        int Q, int K, Strides sq, Strides sk, Strides sv,
                        BiasStrides sb, float scale, int causal,
                        cudaStream_t stream) {
  dim3 grid((Q + kBQ - 1) / kBQ, H, B);
  flash_fwd_tile_kernel<<<grid, kTileThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(o), static_cast<float*>(lse), H, Q, K, sq, sk, sv,
      sb, scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// decode: bf16, Q <= 16, CUDA cores, 16-byte K/V loads
// ---------------------------------------------------------------------------

constexpr int kDecWarps = 4;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kGroups = 4 * kDecWarps;  // groups of 8 lanes: one key row each

__device__ __forceinline__ void bf16x8_to_f32(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(p[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// exp(x - m) with m = -inf (nothing seen yet) read as 0, so that an empty
// partial (m = -inf, l = 0, acc = 0) merges as zero weight, never NaN
__device__ __forceinline__ float rescale(float x, float m) {
  return __expf(x - (m == -INFINITY ? 0.f : m));
}

constexpr int kDecBatch = 4;  // keys each group loads per batch

// One batch of keys for one lane: kDecBatch key rows (16 bytes each of K
// and V) and the bias of the CTA's query row at those keys.
struct DecodeBatch {
  uint4 k[kDecBatch], v[kDecBatch];
  float bias[kDecBatch];
};

// Start the loads of the batch at key base + u * kGroups + group; keys at or
// past k_end read as zero and are left out later.
__device__ __forceinline__ void load_batch(DecodeBatch& d, const bf16* kb,
                                           const bf16* vb, Strides sk,
                                           Strides sv, const float* brow,
                                           long long sbk, int base, int group,
                                           int k_end) {
#pragma unroll
  for (int u = 0; u < kDecBatch; ++u) {
    const int kj = base + u * kGroups + group;
    const bool in = kj < k_end;
    d.k[u] = in ? *reinterpret_cast<const uint4*>(kb + kj * sk.t) : make_uint4(0, 0, 0, 0);
    d.v[u] = in ? *reinterpret_cast<const uint4*>(vb + kj * sv.t) : make_uint4(0, 0, 0, 0);
    d.bias[u] = in && brow ? brow[kj * sbk] : 0.f;
  }
}

// One CTA per (head, batch row, query row). The paths send one query row
// (Q = 1); Q in 2..16 stays correct and rereads K/V once per row. The next
// batch's loads are started before the current batch's math.
__global__ void __launch_bounds__(kDecThreads)
flash_fwd_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ bias, bf16* __restrict__ o,
                        float* __restrict__ lse, int H, int Q, int K,
                        Strides sq, Strides sk, Strides sv, BiasStrides sb,
                        float scale, int causal) {
  constexpr int kStep = kDecBatch * kGroups;  // keys per CTA per batch
  __shared__ __align__(16) float sQ[kD];
  __shared__ float sM[kDecWarps], sL[kDecWarps];
  __shared__ __align__(16) float sAcc[kDecWarps][kD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int sub = lane & 7;  // D columns 8 sub .. 8 sub + 7
  // group 4 warp + lane / 8 walks keys 4 warp + lane / 8 + 16 i; the loop
  // steps per warp so that every lane of a warp runs the same trips and
  // meets the full-warp shuffles
  const int group = lane >> 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qi = blockIdx.z;

  const bf16* qb = q + b * sq.b + h * sq.h + qi * sq.t;
  const bf16* kb = k + b * sk.b + h * sk.h + 8 * sub;
  const bf16* vb = v + b * sv.b + h * sv.h + 8 * sub;
  const float* brow = bias ? bias + b * sb.b + h * sb.h + qi * sb.q : nullptr;

  for (int d = tid; d < kD; d += kDecThreads) sQ[d] = __bfloat162float(qb[d]);

  // causal with a 16-row query tile: the visit rule leaves key tile 0
  const int k_end = causal ? min(K, kBK) : K;

  float m = -INFINITY, l = 0.f, acc[8];
#pragma unroll
  for (int d = 0; d < 8; ++d) acc[d] = 0.f;

  DecodeBatch cur;
  load_batch(cur, kb, vb, sk, sv, brow, sb.k, 4 * warp, group, k_end);
  __syncthreads();  // sQ complete
  const float4 qa = *reinterpret_cast<const float4*>(&sQ[8 * sub]);
  const float4 qc = *reinterpret_cast<const float4*>(&sQ[8 * sub + 4]);

  for (int base = 4 * warp; base < k_end; base += kStep) {
    DecodeBatch nxt;
    if (base + kStep < k_end)
      load_batch(nxt, kb, vb, sk, sv, brow, sb.k, base + kStep, group, k_end);

    // logits of the batch: 8-lane dot products, then scale, bias, mask
    float x[kDecBatch];
#pragma unroll
    for (int u = 0; u < kDecBatch; ++u) {
      float kf[8];
      bf16x8_to_f32(cur.k[u], kf);
      float s = qa.x * kf[0];
      s = fmaf(qa.y, kf[1], s);
      s = fmaf(qa.z, kf[2], s);
      s = fmaf(qa.w, kf[3], s);
      s = fmaf(qc.x, kf[4], s);
      s = fmaf(qc.y, kf[5], s);
      s = fmaf(qc.z, kf[6], s);
      s = fmaf(qc.w, kf[7], s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      const int kj = base + u * kGroups + group;
      float y = s * scale + cur.bias[u];
      if (causal && kj > qi) y += kNegInf;
      x[u] = kj < k_end ? y : -INFINITY;  // past the keys: left out
    }
    // the group's online softmax, one update per batch; P rounded to bf16
    // against the updated running max
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kDecBatch; ++u) m_new = fmaxf(m_new, x[u]);
    const float alpha = rescale(m, m_new);
    float p[kDecBatch], ps = 0.f;
#pragma unroll
    for (int u = 0; u < kDecBatch; ++u) {
      const float pu = rescale(x[u], m_new);
      ps += pu;
      p[u] = __bfloat162float(__float2bfloat16(pu));
    }
    l = l * alpha + ps;
    m = m_new;
#pragma unroll
    for (int d = 0; d < 8; ++d) acc[d] *= alpha;
#pragma unroll
    for (int u = 0; u < kDecBatch; ++u) {
      float vf[8];
      bf16x8_to_f32(cur.v[u], vf);
#pragma unroll
      for (int d = 0; d < 8; ++d) acc[d] = fmaf(p[u], vf[d], acc[d]);
    }
    cur = nxt;
  }

  // merge the 4 groups of the warp (lanes 8 apart share a D slice)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int off = 8 << i;
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float m_new = fmaxf(m, m_o);
    const float a = rescale(m, m_new), c = rescale(m_o, m_new);
    l = l * a + l_o * c;
    m = m_new;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const float acc_o = __shfl_xor_sync(0xffffffffu, acc[d], off);
      acc[d] = acc[d] * a + acc_o * c;
    }
  }
  if (lane < 8) {
    if (lane == 0) {
      sM[warp] = m;
      sL[warp] = l;
    }
#pragma unroll
    for (int d = 0; d < 8; ++d) sAcc[warp][8 * sub + d] = acc[d];
  }
  __syncthreads();

  // merge the warps; one thread per d
  for (int d = tid; d < kD; d += kDecThreads) {
    float m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) m_all = fmaxf(m_all, sM[w]);
    float l_all = 0.f, a_all = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float c = rescale(sM[w], m_all);
      l_all += sL[w] * c;
      a_all += sAcc[w][d] * c;
    }
    const float l_safe = fmaxf(l_all, 1e-30f);
    o[((static_cast<long long>(b) * Q + qi) * H + h) * kD + d] =
        __float2bfloat16(a_all / l_safe);
    if (lse && d == 0)
      lse[(static_cast<long long>(b) * H + h) * Q + qi] = m_all + logf(l_safe);
  }
}

cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const void* bias, void* o, void* lse, int B, int H,
                          int Q, int K, Strides sq, Strides sk, Strides sv,
                          BiasStrides sb, float scale, int causal,
                          cudaStream_t stream) {
  dim3 grid(H, B, Q);
  flash_fwd_decode_kernel<<<grid, kDecThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(o), static_cast<float*>(lse), H, Q, K, sq, sk, sv,
      sb, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// variant: 0 = fma (f32), 1 = tile (bf16, Q > 16), 2 = decode (bf16,
// Q <= 16), as ops/flash_attention.py::forward_variant picks it. dtype: 0 =
// float32, 1 = bfloat16. Strides are in elements; the head dim must be
// contiguous, and the tile and decode variants need 16-byte-aligned K and V
// (and Q for tile) as `aligned16` states. bias may be null; lse may be null
// (not written). Returns 0 on success, else the CUDA error code of the launch,
// or -1 for arguments the chosen variant was not built for.
extern "C" int trlx_flash_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int variant, int dtype, int B, int H, int Q, int K, int D,
    long long sqb, long long sqt, long long sqh, long long skb, long long skt,
    long long skh, long long svb, long long svt, long long svh, long long sbb,
    long long sbh, long long sbq, long long sbk, float scale, int causal,
    void* stream) {
  if (D != kD || B < 1 || H < 1 || Q < 1 || K < 1 || H > 65535 || B > 65535)
    return -1;
  const Strides sq{sqb, sqt, sqh}, sk{skb, skt, skh}, sv{svb, svt, svh};
  const BiasStrides sb{sbb, sbh, sbq, sbk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool kv_aligned = aligned16(k, sk, B, K, H) && aligned16(v, sv, B, K, H);
  cudaError_t err;
  if (variant == kFma && dtype == 0) {
    err = Q <= 16 ? launch_fma<16>(q, k, v, bias, o, lse, B, H, Q, K, sq, sk,
                                   sv, sb, scale, causal, st)
                  : launch_fma<64>(q, k, v, bias, o, lse, B, H, Q, K, sq, sk,
                                   sv, sb, scale, causal, st);
  } else if (variant == kTile && dtype == 1 && Q > 16 && kv_aligned &&
             aligned16(q, sq, B, Q, H)) {
    err = launch_tile(q, k, v, bias, o, lse, B, H, Q, K, sq, sk, sv, sb,
                      scale, causal, st);
  } else if (variant == kDecode && dtype == 1 && Q <= 16 && kv_aligned) {
    err = launch_decode(q, k, v, bias, o, lse, B, H, Q, K, sq, sk, sv, sb,
                        scale, causal, st);
  } else {
    return -1;
  }
  return static_cast<int>(err);
}
