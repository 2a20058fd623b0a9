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
// The causal visit rule, which every kernel takes from hopper_tile.cuh's
// visit_end and the plain versions repeat: a query row sees the 64-key
// tiles that start before the end of its query tile, and that tile has 16
// rows when Q <= 16 and 64 rows otherwise. A left-padding row whose visible
// keys are all masked therefore averages the keys of those tiles, as the
// TPU kernel does.
//
// Five variants, chosen in Python (ops/flash_attention.py::forward_variant
// for dense calls, block_forward_variant for the ring's blocks,
// flash_attention_int8 for the int8 cache's decode) and passed in; a
// mismatched choice is refused with -1:
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
//    call costs host time). It takes no dead-tile vote (hopper_tile.cuh
//    dead_tile): on an H100 a vote a key tile made the serving prefill 14 %
//    and the ring's 2048-row bf16 blocks 7-19 % slower, the diagonal block
//    included, whose upper half it skipped (PERF.md section 6): the
//    softmax and P V a dead tile saves are not what bounds this kernel.
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
//    132 SMs. Q in 2..16 rereads K/V once per row, and two paths send it:
//    ILQL's eval prefill (B=128 Q=16 K=64: 0.121 ms against a 0.0095 ms
//    bound) and the serving engine's speculative verify step (B=32 Q=5
//    K=576, 12 launches a step: 0.080 ms against a 0.017 ms bound, SDPA
//    0.043 ms; chip_smoke.py phase 2 on an H100 80GB HBM3 at 700 W).
//    Holding a (head, batch row)'s query rows in one CTA would read its K/V
//    once. Under the causal flag the visit rule leaves keys 0-63.
//
//  decode_int8 (bf16 q, the int8 KV cache's K and V, Q <= 16; entry point
//    trlx_flash_fwd_int8, from ops/flash_attention.py::flash_attention_int8):
//    the decode variant reading int8 K/V and their [B, K, H, 1] bf16 scales
//    where the cache holds them. The lane layout is decode's (row_lanes<D>,
//    8 columns a lane); a lane loads 8 bytes of int8 instead of 16 of bf16,
//    plus its key row's scale, and widens each value to bf16(q * scale),
//    the element of the dequantized view the plain version attends over
//    (Int8Rows), so everything after the load is decode's math. Its bytes
//    bound is about half decode's: 28.3 MB of int8 K/V and 0.9 MB of scales
//    at serving decode B=32 H=12 K=576 D=64, 0.0088 ms. It takes 0.0439 ms
//    there against decode's 0.0245 (0.0326 against 0.0225 at the rollout
//    decode B=128 K=112; chip_smoke.py phase 23 on an H100 80GB HBM3 at
//    700 W). With 8 bytes a lane a batch holds half decode's bytes in
//    flight, and each value costs a conversion and a multiply more; which
//    of the two holds it back is not measured (no ncu on that machine).
//
//  fma (f32, every Q; dense calls): the parity path, on the CUDA cores.
//    Register-blocked 4x4 f32 FMA from shared memory, K/V tiles staged in
//    f32. One TF32 pass on the tensor cores would break the f32 tolerances
//    (1e-4 at kernel level, 4.2e-7 relative on the full-width gradient). No
//    bf16 call reaches it.
//
//  split3 (f32, the ring's block forward, flash_block_fwd, which replaces
//    trlx_tpu/ops/flash_attention.py::flash_block_fwd :468): f32 on the
//    tensor cores through three bf16 planes of each operand (hopper_tile.cuh
//    split3): S and O += P V as the sums of six plane products each, at
//    989 / 6 = 165 TFLOP/s against the 67 the fma variant cannot reach. At
//    the ring's 2048 x 2048 blocks its operations bound it, 4 D FLOPs per
//    live pair at that rate (chip_smoke.py::block_bound).
//    Layout as the tile variant: one warpgroup per 64-row query tile, Q's
//    planes staged once, each visited key tile's K and V planes staged by
//    16-byte copies from the contiguous planes the split pre-pass wrote
//    (csrc/split_planes.cu), wgmma.m64n64k16 for every plane product. The
//    online softmax runs in f32 with expf and logf as the fma variant's; P
//    goes into O += P V as three register fragments (split3_fragment), so
//    nothing is rounded to bf16 that is not carried by the next plane. A
//    key tile that weighs exactly 0 is skipped (hopper_tile.cuh dead_tile,
//    voting on the bias values the thread then adds to its logits). No
//    causal flag: a ring block carries its positions in the bias. Q, K and V's planes are 9 tiles: 73 KB at
//    D <= 64 (2 CTAs per SM), 145 KB at 96 and 128; at D = 256 K and V take
//    turns in one slot (193 KB). A CTA holds one 64-column chunk of O
//    (hopper_tile.cuh split3_chunks: at D = 96, 128 and 256 the 2, 2 and 4
//    CTAs of a query tile each form the whole S), each key tile's P V
//    summed apart and added to it in f32 (accumulate_planes).
//
// Head dims (hopper_tile.cuh kHeadDims): every variant is a template over D,
// built for 16 (the learning guard, the T5 stand-in's d_kv), 24 (the
// randomwalks configs), 32 (the GPT-2 stand-in), 64 (GPT-2; the shapes
// above), 96 (GPT-NeoX-20B), 128 (GPT-Neo) and 256 (GPT-J-6B); each per-D
// constant is
// chosen per built D (per_head_dim). At D = 16, 24 and 32 every variant
// runs D = 64's layout on a narrower row:
//  - tile: a 64 x D tile is held as one 64-column atom (hopper_tile.cuh
//    tile_cols, columns D..63 zero-filled by the copies); S = Q K^T takes
//    kmajor_steps = 1, 2 and 2 k-steps (at D = 24 the second covers columns
//    16..31, of which 24..31 are zero in Q and K); O += P V is one
//    m64n64k16 per k-step, its columns D..63 dropped at the store. Q and a
//    2-stage K/V ring are 40 KB of static shared memory, 4 CTAs per SM, as
//    at D = 64.
//  - decode: a key row is 32, 48 or 64 bytes: 2, 4 and 4 lanes of 16-byte
//    loads. At D = 24 the row's three chunks do not make a power-of-two
//    group for the xor-shuffle reduction, so 4 lanes take a key row and the
//    fourth loads nothing and adds zero (as D = 96's 16 lanes, of which 12
//    read); a warp then covers 8 keys per load.
//  - fma: as at D = 64 (64-key chunks, 64- or 16-row CTAs); each thread owns
//    output columns tx + 16 j, j < ceil(D / 16), and at D = 24 the columns
//    past 23 of its second j are neither read nor written.
// At D = 96:
//  - tile: a 64 x 96 tile is held as 64 x 128 (hopper_tile.cuh tile_cols:
//    two atoms, columns 96..127 zero-filled). S = Q K^T takes 6 k-steps
//    (atom 0's four, atom 1's first two); O += P V is two m64n64k16
//    products per k-step, the second one's columns 32..63 (96..127 of O)
//    dropped at the store. The O accumulator is 64 f32 registers a thread;
//    Q and a 2-stage K/V ring are 5 tiles of 16 KB (81 KB of dynamic
//    shared memory with the slack), so 2 CTAs per SM and up to 255
//    registers, and the bias is preloaded as at D = 64. v is read in place
//    from the fused [B, T, H, 288] projection (row strides of 288 elements,
//    its base 384 bytes in); q and k come contiguous from the rotary.
//  - decode: a key row is 192 bytes, 12 lanes of 16 bytes; the xor-shuffle
//    reduction needs a power-of-two group, so 16 lanes take a key row and
//    lanes 12..15 load nothing and add zero.
//  - fma: as at D = 64 (64-key chunks; 91 KB of padded f32 tiles).
// At D = 128 (GPT-Neo 1.3B and 2.7B: 16 or 20 heads of 128), D = 96's layout
// with nothing padded:
//  - tile: a 64 x 128 tile is two whole atoms (16 KB). S = Q K^T takes 8
//    k-steps (4 per atom); O += P V is two m64n64k16 products per k-step,
//    both stored whole. Q and a 2-stage K/V ring are 5 tiles of 16 KB (81 KB
//    of dynamic shared memory), 2 CTAs per SM, up to 255 registers (O 64, S
//    32, the preloaded bias 32). GPT-Neo's local layers send a [B, 1, Q, K]
//    band bias with causal = 0: whole key tiles before the band are visited
//    and weigh zero, as in the plain version.
//  - decode: a key row is 256 bytes, 16 lanes of 16 bytes, none idle; a warp
//    covers 2 keys per load.
//  - fma: as at D = 64 (64-key chunks, 64- or 16-row CTAs; 113 KB of padded
//    f32 tiles at 64 rows).
// At D = 256:
//  - tile: the O accumulator of 64 rows x 256 is 128 f32 registers a thread
//    (four 64-column chunks, each its own m64n64k16 product over one V
//    atom), the whole cap of 4 CTAs per SM, so the launch bounds ask for 2
//    (up to 255 registers); Q and a K/V stage are 32 KB each, so K and V
//    go through one stage (97 KB of dynamic shared memory, 2 CTAs per SM)
//    and the other CTA's copies overlap this one's math. S = Q K^T takes
//    16 k-steps, through the four atoms of Q and K.
//  - decode: a key row is 512 bytes, so a whole warp (32 lanes x 16 bytes)
//    reads one key and the dot product reduces over the warp; each warp
//    walks every 4th key.
//  - fma: 16-row query tiles and 32-key chunks keep the padded f32 tiles at
//    84 KB; the causal visit rule is taken from the forward's query tile
//    (16 or 64 rows), not from the CTA's, so it is the rule above.
// ptxas for sm_90a: chip_smoke.py phase 1 prints registers, shared memory
// and spills per instantiation (0 spill bytes is its gate; PERF.md keeps
// the numbers).

#include <math.h>

#include "hopper_tile.cuh"

namespace {

enum Variant { kFma = 0, kTile = 1, kDecode = 2, kSplit3 = 3, kDecodeInt8 = 4 };

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

constexpr int kFmaThreads = 256;  // 16 x 16 threads

// keys per staged K/V chunk: 64 at D <= 128, 32 at D = 256 (shared memory)
template <int D>
__host__ __device__ constexpr int fma_keys() { return per_head_dim<D>(64, 64, 64, 64, 64, 64, 32); }

// query rows per CTA for a forward tile of fwd_bq rows: the tile itself at
// D <= 128, 16 at D = 256 (shared memory)
template <int D>
__host__ __device__ constexpr int fma_rows(int fwd_bq) {
  return per_head_dim<D>(fwd_bq, fwd_bq, fwd_bq, fwd_bq, fwd_bq, fwd_bq, 16);
}

template <int D, int BQ>
__host__ __device__ constexpr size_t fma_smem() {
  constexpr int KC = fma_keys<D>();
  return sizeof(float) * ((BQ + 2 * KC) * (D + 1) + BQ * (KC + 1));
}

template <int D, int BQ>
__global__ void __launch_bounds__(kFmaThreads)
flash_fwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     float* __restrict__ o, float* __restrict__ lse,
                     float* __restrict__ p_scale, int H,
                     int Q, int K, Strides sq, Strides sk, Strides sv,
                     BiasStrides sb, float scale, int causal) {
  constexpr int KC = fma_keys<D>();
  constexpr int kLD = D + 1;   // padded row stride of the Q/K/V tiles (banks)
  constexpr int kLP = KC + 1;  // padded row stride of the P tile
  constexpr int RQ = BQ / 16;  // query rows per thread
  constexpr int JK = KC / 16;  // keys per thread
  constexpr int JD = (D + 15) / 16;  // output columns per thread (the last partial at D = 24)
  constexpr bool kRagged = D % 16 != 0;
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][kLD]
  float* Ks = Qs + BQ * kLD;   // [KC][kLD]
  float* Vs = Ks + KC * kLD;   // [KC][kLD]
  float* Ps = Vs + KC * kLD;   // [BQ][kLP]

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

  for (int i = tid; i < BQ * D; i += kFmaThreads) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    Qs[r * kLD + d] = qi < Q ? qb[qi * sq.t + d] : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][JD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < JD; ++j) acc[i][j] = 0.f;
  }

  // causal: key tiles that start after the forward tile's last query are
  // skipped; keys at or past k_end are left out (the forward tile is taken
  // at run time here: as a template argument, ptxas spilled 16 bytes at
  // D = 256)
  const int k_end = visit_end(q0, Q <= 16 ? 16 : 64, K, causal);

  for (int k0 = 0; k0 < k_end; k0 += KC) {
    __syncthreads();  // the previous chunk's K/V/P reads are done
    for (int i = tid; i < KC * D; i += kFmaThreads) {
      const int c = i / D, d = i % D;
      const int kj = k0 + c;
      const bool in = kj < k_end;
      Ks[c * kLD + d] = in ? kb[kj * sk.t + d] : 0.f;
      Vs[c * kLD + d] = in ? vb[kj * sv.t + d] : 0.f;
    }
    __syncthreads();

    float s[RQ][JK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < JK; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float kv[JK];
#pragma unroll
      for (int j = 0; j < JK; ++j) kv[j] = Ks[(tx + 16 * j) * kLD + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float qv = Qs[(ty * RQ + i) * kLD + d];
#pragma unroll
        for (int j = 0; j < JK; ++j) s[i][j] = fmaf(qv, kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i;
      const int qi = q0 + r;
      const int qb_row = min(qi, Q - 1);  // padded rows read a valid bias row
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        const int kj = k0 + tx + 16 * j;
        // keys past the visited ones are left out, not masked
        const float x = kj >= k_end ? -INFINITY
                                    : logit(s[i][j], scale, biasb, sb, qb_row, qi, kj, causal);
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      // every processed chunk holds at least one visited key, so m_new is finite
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < JK; ++j) {
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
      for (int j = 0; j < JD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // P complete

#pragma unroll 8
    for (int c = 0; c < KC; ++c) {
      float vv[JD];
#pragma unroll
      for (int j = 0; j < JD; ++j)
        vv[j] = !kRagged || tx + 16 * j < D ? Vs[c * kLD + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float p = Ps[(ty * RQ + i) * kLP + c];
#pragma unroll
        for (int j = 0; j < JD; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + ty * RQ + i;
    if (qi >= Q) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    float* orow = o + ((static_cast<long long>(b) * Q + qi) * H + h) * D;
#pragma unroll
    for (int j = 0; j < JD; ++j)
      if (!kRagged || tx + 16 * j < D) orow[tx + 16 * j] = acc[i][j] / l_safe;
    if (tx == 0) {
      const long long row = (static_cast<long long>(b) * H + h) * Q + qi;
      const float row_lse = m[i] + logf(l_safe);
      if (lse) lse[row] = row_lse;
      if (p_scale) p_scale[row] = p_scale_of(m[i], row_lse, l_safe);
    }
  }
}

template <int D, int BQ>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       const void* bias, void* o, void* lse, void* p_scale, int B, int H,
                       int Q, int K, Strides sq, Strides sk, Strides sv,
                       BiasStrides sb, float scale, int causal,
                       cudaStream_t stream) {
  constexpr size_t smem = fma_smem<D, BQ>();
  cudaError_t err = allow_smem<flash_fwd_fma_kernel<D, BQ>>(smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Q + BQ - 1) / BQ, H, B);
  flash_fwd_fma_kernel<D, BQ><<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(o), static_cast<float*>(lse), static_cast<float*>(p_scale), H, Q, K,
      sq, sk, sv,
      sb, scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tile: bf16, Q > 16, tensor cores (wgmma.m64n64k16)
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;  // query rows per CTA: 4 warps x 16

// K/V stages and CTAs per SM in the launch bounds: at D <= 64 a 2-stage ring
// and 4 CTAs (registers capped at 128); at D = 96 and 128 a 2-stage ring (81
// KB of shared memory) and 2 CTAs (up to 255 registers: the O accumulator is
// 64, S 32 and the preloaded bias 32); at D = 256 the O accumulator alone is
// 128 registers, so 2 CTAs (up to 255), and one stage (the other CTA's
// copies overlap this one's math)
template <int D>
__host__ __device__ constexpr int tile_stages() { return per_head_dim<D>(2, 2, 2, 2, 2, 2, 1); }
template <int D>
__host__ __device__ constexpr int tile_min_blocks() { return per_head_dim<D>(4, 4, 4, 4, 2, 2, 2); }
// Q, then K and V per stage: static shared memory when it fits the 48 KB
// static limit (40 KB at D <= 64), else dynamic with 1 KB of alignment slack
template <int D>
__host__ __device__ constexpr bool tile_static_smem() {
  return (1 + 2 * tile_stages<D>()) * tile_bytes<D>() <= 48 * 1024;
}
template <int D>
__host__ __device__ constexpr size_t tile_smem() {
  return tile_static_smem<D>() ? 0 : (1 + 2 * tile_stages<D>()) * tile_bytes<D>() + 1024;
}

// Operand layouts (hopper_tile.cuh): S = Q K^T takes Q [row][d] and K
// [key][d] K-major from shared memory (wgmma_ss); O += P V takes P's A
// fragment from registers and V [key][d] MN-major (wgmma_rs_mn), one
// product per 64 columns of D.
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
template <int D>
__global__ void __launch_bounds__(kTileThreads, tile_min_blocks<D>())
flash_fwd_tile_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ bias,
                      bf16* __restrict__ o, float* __restrict__ lse,
                      float* __restrict__ p_scale, int H,
                      int Q, int K, Strides sq, Strides sk, Strides sv,
                      BiasStrides sb, float scale, int causal) {
  constexpr int kTB = tile_bytes<D>();
  constexpr int kStages = tile_stages<D>();
  constexpr int kN = tile_cols<D>() / 64;  // 64-column chunks of O (the last padded at D != 64, 256)
  // the bias of a thread's 32 (row, key) pairs is read before the wait for
  // the tile at D <= 128; at D = 256 those 32 registers would spill
  constexpr bool kPreloadBias = per_head_dim<D>(true, true, true, true, true, true, false);
  // Q, K[stages], V[stages]; the 128-byte swizzle repeats every 1024 bytes.
  // Static at D <= 64 (40 KB: its address folds into the code), dynamic above
  uint32_t sQ;
  if constexpr (tile_static_smem<D>()) {
    __shared__ __align__(1024) uint8_t smem[(1 + 2 * kStages) * kTB];
    sQ = smem_addr(smem);
  } else {
    extern __shared__ uint8_t smem_raw[];
    aligned_smem(smem_raw, sQ);
  }
  const uint32_t sK0 = sQ + kTB;
  const uint32_t sV0 = sQ + (1 + kStages) * kTB;

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
  const int k_end = visit_end(q0, kBQ, K, causal);
  const int n_tiles = (k_end + kBK - 1) / kBK;

  load_tile_async<D>(sQ, qb, sq.t, q0, Q);
  load_tile_async<D>(sK0, kb, sk.t, 0, K);
  load_tile_async<D>(sV0, vb, sv.t, 0, K);
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
  float acc[kN][8][4];
  zero(acc);

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = kStages == 2 ? t & 1 : 0;
    const int k0 = t * kBK;
    if constexpr (kStages == 2) {
      if (t + 1 < n_tiles) {  // prefetch the next tile into the other stage
        load_tile_async<D>(sK0 + (buf ^ 1) * kTB, kb, sk.t, k0 + kBK, K);
        load_tile_async<D>(sV0 + (buf ^ 1) * kTB, vb, sv.t, k0 + kBK, K);
      }
      cp_async_commit();  // possibly empty: keeps one group per iteration
    } else if (t > 0) {   // one stage: refill it (the last tile's reads are done)
      load_tile_async<D>(sK0, kb, sk.t, k0, K);
      load_tile_async<D>(sV0, vb, sv.t, k0, K);
      cp_async_commit();
    }
    // the bias of this thread's 32 (row, key) pairs, read before the wait
    // so that its latency overlaps the copies and the first product
    float bv[8][4];
    if constexpr (kPreloadBias) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * j + 2 * t4 + (e & 1);
          bv[j][e] = brow[0] && kj < K ? brow[e >> 1][kj * sb.k] : 0.f;
        }
    }
    if constexpr (kStages == 2)
      cp_async_wait<1>();  // everything up to this tile has landed
    else
      cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    const uint32_t sK = sK0 + buf * kTB;
    const uint32_t sV = sV0 + buf * kTB;

    // S = Q K^T for the warpgroup's 64 rows x 64 keys (each warp 16 rows)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    fence_registers(s);
    wgmma_fence();
    {
      const TileDesc<D> dQ(sQ), dK(sK);
#pragma unroll
      for (int ks = 0; ks < kmajor_steps<D>(); ++ks)
        wgmma_ss(s, dQ.kstep(ks), dK.kstep(ks), ks > 0);
    }
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
        float x = s[j][e] * scale;
        if constexpr (kPreloadBias)
          x += bv[j][e];
        else
          x += brow[0] && kj < K ? brow[hr][kj * sb.k] : 0.f;
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
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][j][e] *= alpha[e >> 1];

    // O += bf16(P) V: 4 k-steps of 16 keys, P from registers, one product
    // per 64 columns of the tile
    uint32_t pa[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) pack_fragment(pa[ks], s, ks);
    fence_registers(acc);
    wgmma_fence();
    {
      const TileDesc<D> dV(sV);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int n = 0; n < kN; ++n) wgmma_rs_mn(acc[n], pa[ks], dV.mn(n, ks));
    }
    wgmma_commit_and_wait();
    fence_registers(acc);
    __syncthreads();  // this stage is read; the next iteration refills it
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (qi[hr] >= Q) continue;
    const float l_safe = fmaxf(l[hr], 1e-30f);
    bf16* orow = o + ((static_cast<long long>(b) * Q + qi[hr]) * H + h) * D;
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (64 * n + 8 * j < D)  // the tile's padded columns are dropped
          *reinterpret_cast<uint32_t*>(orow + 64 * n + 8 * j + 2 * t4) =
              pack_bf16(acc[n][j][2 * hr] / l_safe, acc[n][j][2 * hr + 1] / l_safe);
    if (t4 == 0) {
      const long long row = (static_cast<long long>(b) * H + h) * Q + qi[hr];
      const float row_lse = m[hr] + logf(l_safe);
      if (lse) lse[row] = row_lse;
      if (p_scale) p_scale[row] = p_scale_of(m[hr], row_lse, l_safe);
    }
  }
}

template <int D>
cudaError_t launch_tile(const void* q, const void* k, const void* v,
                        const void* bias, void* o, void* lse, void* p_scale, int B, int H,
                        int Q, int K, Strides sq, Strides sk, Strides sv,
                        BiasStrides sb, float scale, int causal,
                        cudaStream_t stream) {
  constexpr size_t smem = tile_smem<D>();
  if constexpr (smem > 0) {
    cudaError_t err = allow_smem<flash_fwd_tile_kernel<D>>(smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((Q + kBQ - 1) / kBQ, H, B);
  flash_fwd_tile_kernel<D><<<grid, kTileThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(o), static_cast<float*>(lse), static_cast<float*>(p_scale), H, Q, K,
      sq, sk, sv,
      sb, scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// split3: f32 through three bf16 planes on the tensor cores (the ring's blocks)
// ---------------------------------------------------------------------------

// K and V share one slot at D = 256 (Q's and one operand's planes are 192
// KB): V is staged once S = Q K^T has read K. Elsewhere Q, K and V are 9
// plane tiles, 73 KB at D <= 64 (2 CTAs per SM) and 145 KB at D = 96 and
// 128 (1 CTA per SM).
template <int D>
__host__ __device__ constexpr bool split3_shared_kv() {
  return per_head_dim<D>(false, false, false, false, false, false, true);
}
template <int D>
__host__ __device__ constexpr int split3_min_blocks() { return per_head_dim<D>(2, 2, 2, 2, 1, 1, 1); }
template <int D>
__host__ __device__ constexpr size_t split3_smem() {  // the slots
  return 3 * (split3_shared_kv<D>() ? 2 : 3) * tile_bytes<D>() + 1024;
}

// One warpgroup per (64-row query tile, head, batch row), as the tile
// variant, on f32 q, k, v given as their three bf16 planes (pq, pk, pv
// elements apart; csrc/split_planes.cu). Q's planes are staged once; each
// key tile that is not dead (dead_tile, on the bias each thread reads) stages
// K's and V's planes and runs S = sum of the plane products of Q K^T, the
// online softmax in f32 (expf, logf: the fma variant's functions), P split
// into three register fragments, O += sum of the plane products of P V. No
// causal flag (the ring's blocks carry their positions in the bias). O is
// f32.
template <int D>
__global__ void __launch_bounds__(kTileThreads, split3_min_blocks<D>())
flash_fwd_split3_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ bias,
                        float* __restrict__ o, float* __restrict__ lse, int H, int Q,
                        int K, Strides sq, Strides sk, Strides sv, long long pq,
                        long long pk, BiasStrides sb, float scale) {
  constexpr int kTB = tile_bytes<D>();
  constexpr bool kSharedKV = split3_shared_kv<D>();
  extern __shared__ uint8_t smem_raw[];
  uint32_t sQ;
  aligned_smem(smem_raw, sQ);
  const uint32_t sK = sQ + 3 * kTB;
  const uint32_t sV = kSharedKV ? sK : sK + 3 * kTB;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y / split3_chunks<D>();
  const int chunk = blockIdx.y % split3_chunks<D>();  // O's columns 64 chunk .. 64 chunk + 63
  const int b = blockIdx.z;
  const int n_tiles = (K + kBK - 1) / kBK;

  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  load_planes_async<D>(sQ, q + b * sq.b + h * sq.h, pq, sq.t, q0, Q);
  cp_async_commit();

  int qi[2];
  const float* brow[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    qi[hr] = q0 + warp * 16 + g + 8 * hr;
    brow[hr] = bias ? bias + b * sb.b + h * sb.h + min(qi[hr], Q - 1) * sb.q : nullptr;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[8][4];
  zero(acc);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    // the bias of this thread's 32 pairs and the dead-tile vote on it (its
    // barriers also order this tile's copies after the last tile's reads)
    float bv[8][4];
    bool live = false;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + 8 * j + 2 * t4 + (e & 1);
        bv[j][e] = brow[0] && kj < K ? brow[e >> 1][kj * sb.k] : 0.f;
        live |= live_pair(bv[j][e], kj, K);
      }
    if (brow[0] && dead_tile(live, m[0] > 0.5f * kNegInf && m[1] > 0.5f * kNegInf)) continue;
    load_planes_async<D>(sK, kb, pk, sk.t, k0, K);
    if constexpr (!kSharedKV) load_planes_async<D>(sV, vb, pk, sv.t, k0, K);
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();

    float s[8][4];
    product3<D>(s, sQ, sK);
    wgmma_commit_and_wait();
    fence_registers(s);
    if constexpr (kSharedKV) {
      __syncthreads();  // every warp's S has read K
      load_planes_async<D>(sV, vb, pk, sv.t, k0, K);
      cp_async_commit();
    }

    // logits, then the online softmax over each row's quad of lanes
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const int kj = k0 + 8 * j + 2 * t4 + (e & 1);
        float x = s[j][e] * scale;
        if constexpr (split3_keep_bias<D>())
          x += bv[j][e];
        else
          x += brow[0] && kj < K ? brow[hr][kj * sb.k] : 0.f;
        x = kj < K ? x : -INFINITY;  // keys past K are left out, not masked
        s[j][e] = x;
        mx[hr] = fmaxf(mx[hr], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      alpha[hr] = expf(m[hr] - m_new);  // 0 on the first tile visited
      m[hr] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
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

    if constexpr (kSharedKV) {
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
    }
    // O += P V: P (f32) as bf16 fragments of its three planes, V's planes
    // MN-major (this CTA's chunk of them)
    accumulate_planes(acc, s, sV + chunk * kAtomBytes, kTB);
    __syncthreads();  // the slots are read; the next tile refills them
  }
  cp_async_wait<0>();  // Q's copies, where every tile was skipped

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (qi[hr] >= Q) continue;
    const float l_safe = fmaxf(l[hr], 1e-30f);
    float* orow = o + ((static_cast<long long>(b) * Q + qi[hr]) * H + h) * D + 64 * chunk;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (64 * chunk + 8 * j < D)  // the tile's padded columns are dropped
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * t4) =
            make_float2(acc[j][2 * hr] / l_safe, acc[j][2 * hr + 1] / l_safe);
    if (lse && t4 == 0 && chunk == 0)
      lse[(static_cast<long long>(b) * H + h) * Q + qi[hr]] = m[hr] + logf(l_safe);
  }
}

template <int D>
cudaError_t launch_split3(const void* q, const void* k, const void* v, const void* bias,
                          void* o, void* lse, int B, int H, int Q, int K, Strides sq,
                          Strides sk, Strides sv, BiasStrides sb, float scale,
                          cudaStream_t stream) {
  constexpr size_t smem = split3_smem<D>();
  cudaError_t err = allow_smem<flash_fwd_split3_kernel<D>>(smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Q + kBQ - 1) / kBQ, H * split3_chunks<D>(), B);
  flash_fwd_split3_kernel<D><<<grid, kTileThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<float*>(o), static_cast<float*>(lse), H, Q,
      K, sq, sk, sv, static_cast<long long>(B) * Q * H * D,
      static_cast<long long>(B) * K * H * D, sb, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// decode: bf16, Q <= 16, CUDA cores, 16-byte K/V loads
// ---------------------------------------------------------------------------

constexpr int kDecWarps = 4;
constexpr int kDecThreads = 32 * kDecWarps;

// lanes that read one key row (16 bytes each): 2 at D = 16, 4 at D = 24 (3
// read, 1 adds zero) and 32, 8 at D = 64, 16 at D = 96 (12 read, 4 add
// zero: the shuffle reduction takes a power-of-two group) and 128, a warp at
// D = 256
template <int D>
__host__ __device__ constexpr int row_lanes() { return per_head_dim<D>(2, 4, 4, 8, 16, 16, 32); }
// groups of row_lanes lanes in the CTA: each reads one key row at a time
template <int D>
__host__ __device__ constexpr int dec_groups() { return 32 / row_lanes<D>() * kDecWarps; }

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

// K or V rows in bf16 (the decode variant): a lane's 8 columns are one
// 16-byte load. Both readers hand the kernel a lane's load as a uint4, so
// the batch of loads in flight is laid out alike in registers.
struct Bf16Rows {
  const bf16* p;
  Strides s;
  // the rows of (batch row b, head h) from column col on
  __device__ __forceinline__ Bf16Rows at(int b, int h, int col) const {
    return {p + b * s.b + h * s.h + col, s};
  }
  __device__ __forceinline__ uint4 load(int kj) const {
    return *reinterpret_cast<const uint4*>(p + kj * s.t);
  }
  __device__ __forceinline__ static void widen(const uint4& r, float (&f)[8]) {
    bf16x8_to_f32(r, f);
  }
};

// K or V rows of the int8 cache (the decode_int8 variant): int8 values with
// one bf16 scale per key row ([B, K, H, 1], its own strides). A lane's 8
// columns are one 8-byte load (.x, .y of its uint4) plus its row's scale
// (.z, as f32 bits); each value becomes q * scale as one correctly
// rounded bf16 product (q and the scale are exact in bf16), the element the
// plain path's dequantized bf16 view holds. The lane layout is the bf16
// rows', so the math after widen is the decode variant's, instruction for
// instruction. (An f32 product rounded to bf16, the same value, left
// ptxas 12 bytes of spills at D = 256; so did the scale carried as bf16
// bits, at every D.)
struct Int8Rows {
  const int8_t* p;
  Strides s;
  const bf16* scale;
  Strides ss;
  __device__ __forceinline__ Int8Rows at(int b, int h, int col) const {
    return {p + b * s.b + h * s.h + col, s, scale + b * ss.b + h * ss.h, ss};
  }
  __device__ __forceinline__ uint4 load(int kj) const {
    const uint2 q = *reinterpret_cast<const uint2*>(p + kj * s.t);
    return make_uint4(q.x, q.y, __float_as_uint(__bfloat162float(scale[kj * ss.t])), 0u);
  }
  // byte i of the pair of words, sign-extended by shifts, so the loaded
  // words stay in registers
  __device__ __forceinline__ static void widen(const uint4& r, float (&f)[8]) {
    const float sc = __uint_as_float(r.z);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t word = i < 4 ? r.x : r.y;
      const int q = static_cast<int>(word << (24 - 8 * (i & 3))) >> 24;
      f[i] = __bfloat162float(
          __hmul(__float2bfloat16_rn(static_cast<float>(q)), __float2bfloat16_rn(sc)));
    }
  }
};

// One batch of keys for one lane: kDecBatch key rows of K and V and the
// bias of the CTA's query row at those keys.
struct DecodeBatch {
  uint4 k[kDecBatch], v[kDecBatch];
  float bias[kDecBatch];
};

// Start the loads of the batch at key base + u * dec_groups + group; keys at
// or past k_end, and every key for a lane past the row (in_row false),
// read K and V as zero and are left out later.
template <int D, class Rows>
__device__ __forceinline__ void load_batch(DecodeBatch& d, const Rows& kr,
                                           const Rows& vr, const float* brow,
                                           long long sbk, int base, int group,
                                           int k_end, bool in_row) {
#pragma unroll
  for (int u = 0; u < kDecBatch; ++u) {
    const int kj = base + u * dec_groups<D>() + group;
    const bool in = kj < k_end;
    d.k[u] = in && in_row ? kr.load(kj) : make_uint4(0, 0, 0, 0);
    d.v[u] = in && in_row ? vr.load(kj) : make_uint4(0, 0, 0, 0);
    d.bias[u] = in && brow ? brow[kj * sbk] : 0.f;
  }
}

// One CTA per (head, batch row, query row). The paths send one query row
// (Q = 1); Q in 2..16 stays correct and rereads K/V once per row. The next
// batch's loads are started before the current batch's math. Rows is
// Bf16Rows (decode) or Int8Rows (decode_int8).
template <int D, class Rows>
__global__ void __launch_bounds__(kDecThreads)
flash_fwd_decode_kernel(const bf16* __restrict__ q, Rows k, Rows v,
                        const float* __restrict__ bias, bf16* __restrict__ o,
                        float* __restrict__ lse, float* __restrict__ p_scale, int H, int Q, int K,
                        Strides sq, BiasStrides sb, float scale, int causal) {
  constexpr int kRowLanes = row_lanes<D>();
  constexpr int kCols = 8 * kRowLanes;                // D, padded to the row's lanes
  constexpr int kWarpGroups = 32 / kRowLanes;        // groups per warp
  constexpr int kStep = kDecBatch * dec_groups<D>();  // keys per CTA per batch
  __shared__ __align__(16) float sQ[kCols];
  __shared__ float sM[kDecWarps], sL[kDecWarps];
  __shared__ __align__(16) float sAcc[kDecWarps][kCols];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int sub = lane % kRowLanes;  // D columns 8 sub .. 8 sub + 7
  const bool in_row = kCols == D || 8 * sub < D;  // past the row: loads nothing
  // group kWarpGroups warp + lane / kRowLanes walks the keys of that index
  // plus multiples of dec_groups; the loop steps per warp so that every
  // lane of a warp runs the same trips and meets the full-warp shuffles
  const int group = lane / kRowLanes;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qi = blockIdx.z;

  const bf16* qb = q + b * sq.b + h * sq.h + qi * sq.t;
  const Rows kr = k.at(b, h, 8 * sub);
  const Rows vr = v.at(b, h, 8 * sub);
  const float* brow = bias ? bias + b * sb.b + h * sb.h + qi * sb.q : nullptr;

  for (int d = tid; d < kCols; d += kDecThreads) sQ[d] = d < D ? __bfloat162float(qb[d]) : 0.f;

  // causal with a 16-row query tile: the visit rule leaves key tile 0
  const int k_end = visit_end(qi, 16, K, causal);

  float m = -INFINITY, l = 0.f, acc[8];
#pragma unroll
  for (int d = 0; d < 8; ++d) acc[d] = 0.f;

  DecodeBatch cur;
  load_batch<D>(cur, kr, vr, brow, sb.k, kWarpGroups * warp, group, k_end, in_row);
  __syncthreads();  // sQ complete
  const float4 qa = *reinterpret_cast<const float4*>(&sQ[8 * sub]);
  const float4 qc = *reinterpret_cast<const float4*>(&sQ[8 * sub + 4]);

  for (int base = kWarpGroups * warp; base < k_end; base += kStep) {
    DecodeBatch nxt;
    if (base + kStep < k_end)
      load_batch<D>(nxt, kr, vr, brow, sb.k, base + kStep, group, k_end, in_row);

    // logits of the batch: dot products over the row's lanes, then scale,
    // bias, mask
    float x[kDecBatch];
#pragma unroll
    for (int u = 0; u < kDecBatch; ++u) {
      float kf[8];
      Rows::widen(cur.k[u], kf);
      float s = qa.x * kf[0];
      s = fmaf(qa.y, kf[1], s);
      s = fmaf(qa.z, kf[2], s);
      s = fmaf(qa.w, kf[3], s);
      s = fmaf(qc.x, kf[4], s);
      s = fmaf(qc.y, kf[5], s);
      s = fmaf(qc.z, kf[6], s);
      s = fmaf(qc.w, kf[7], s);
#pragma unroll
      for (int off = 1; off < kRowLanes; off <<= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      const int kj = base + u * dec_groups<D>() + group;
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
      Rows::widen(cur.v[u], vf);
#pragma unroll
      for (int d = 0; d < 8; ++d) acc[d] = fmaf(p[u], vf[d], acc[d]);
    }
    cur = nxt;
  }
  // merge the groups of the warp (lanes kRowLanes apart share a D slice)
#pragma unroll
  for (int off = kRowLanes; off < 32; off <<= 1) {
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
  if (lane < kRowLanes) {
    if (lane == 0) {
      sM[warp] = m;
      sL[warp] = l;
    }
#pragma unroll
    for (int d = 0; d < 8; ++d) sAcc[warp][8 * sub + d] = acc[d];
  }
  __syncthreads();

  // merge the warps; one thread per d
  for (int d = tid; d < D; d += kDecThreads) {
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
    o[((static_cast<long long>(b) * Q + qi) * H + h) * D + d] =
        __float2bfloat16(a_all / l_safe);
    if (d == 0) {
      const long long row = (static_cast<long long>(b) * H + h) * Q + qi;
      const float row_lse = m_all + logf(l_safe);
      if (lse) lse[row] = row_lse;
      if (p_scale) p_scale[row] = p_scale_of(m_all, row_lse, l_safe);
    }
  }
}

template <int D, class Rows>
cudaError_t launch_decode(const void* q, Rows k, Rows v, const void* bias, void* o,
                          void* lse, void* p_scale, int B, int H, int Q, int K, Strides sq,
                          BiasStrides sb, float scale, int causal, cudaStream_t stream) {
  dim3 grid(H, B, Q);
  flash_fwd_decode_kernel<D, Rows><<<grid, kDecThreads, 0, stream>>>(
      static_cast<const bf16*>(q), k, v, static_cast<const float*>(bias),
      static_cast<bf16*>(o), static_cast<float*>(lse), static_cast<float*>(p_scale), H, Q, K,
      sq, sb, scale, causal);
  return cudaGetLastError();
}

// The int8 rows' 8-byte loads: an 8-byte-aligned base and row strides that
// are multiples of 8 elements (bytes; a dimension of size 1 is never
// stepped).
inline bool aligned8(const void* p, Strides s, int B, int T, int H) {
  return reinterpret_cast<uintptr_t>(p) % 8 == 0 && (B == 1 || s.b % 8 == 0) &&
         (T == 1 || s.t % 8 == 0) && (H == 1 || s.h % 8 == 0);
}

// The int8 cache's K and V scales ([B, K, H, 1] bf16, through strides).
struct Int8Scales {
  const void* k;
  const void* v;
  Strides sk, sv;
};

// The chosen variant at head dim D; -1 for arguments it was not built for.
// int8 (decode_int8 only, else null) holds the int8 cache's scales; k and v
// are then int8.
template <int D>
int launch_variant(const void* q, const void* k, const void* v, const void* bias,
                   void* o, void* lse, void* p_scale, int variant, int dtype, int B, int H,
                   int Q, int K, Strides sq, Strides sk, Strides sv,
                   BiasStrides sb, float scale, int causal, const Int8Scales* int8,
                   cudaStream_t st) {
  if ((variant == kDecodeInt8) != (int8 != nullptr)) return -1;
  if (variant == kDecodeInt8) {
    if (dtype != 1 || Q > 16 || !aligned8(k, sk, B, K, H) || !aligned8(v, sv, B, K, H))
      return -1;
    const Int8Rows kr{static_cast<const int8_t*>(k), sk, static_cast<const bf16*>(int8->k),
                      int8->sk};
    const Int8Rows vr{static_cast<const int8_t*>(v), sv, static_cast<const bf16*>(int8->v),
                      int8->sv};
    return static_cast<int>(launch_decode<D>(q, kr, vr, bias, o, lse, p_scale, B, H, Q, K, sq,
                                             sb, scale, causal, st));
  }
  const bool kv_aligned = aligned16(k, sk, B, K, H) && aligned16(v, sv, B, K, H);
  cudaError_t err;
  if (variant == kFma && dtype == 0) {
    // CTA rows from the forward's query tile (16 rows when Q <= 16)
    err = Q <= 16 ? launch_fma<D, fma_rows<D>(16)>(q, k, v, bias, o, lse, p_scale, B, H, Q, K,
                                                   sq, sk, sv, sb, scale, causal, st)
                  : launch_fma<D, fma_rows<D>(64)>(q, k, v, bias, o, lse, p_scale, B, H, Q, K,
                                                   sq, sk, sv, sb, scale, causal, st);
  } else if (variant == kTile && dtype == 1 && Q > 16 && kv_aligned &&
             aligned16(q, sq, B, Q, H)) {
    err = launch_tile<D>(q, k, v, bias, o, lse, p_scale, B, H, Q, K, sq, sk, sv, sb,
                         scale, causal, st);
  } else if (variant == kDecode && dtype == 1 && Q <= 16 && kv_aligned) {
    const Bf16Rows kr{static_cast<const bf16*>(k), sk}, vr{static_cast<const bf16*>(v), sv};
    err = launch_decode<D>(q, kr, vr, bias, o, lse, p_scale, B, H, Q, K, sq, sb, scale, causal,
                           st);
  } else if (variant == kSplit3 && dtype == 0 && !causal && !p_scale &&
             H <= 65535 / split3_chunks<D>() &&
             contiguous(sq, Q, H, D) &&
             contiguous(sk, K, H, D) && contiguous(sv, K, H, D) && kv_aligned &&
             aligned16(q, sq, B, Q, H)) {
    err = launch_split3<D>(q, k, v, bias, o, lse, B, H, Q, K, sq, sk, sv, sb, scale, st);
  } else {
    return -1;
  }
  return static_cast<int>(err);
}

}  // namespace

// the split3 kernel's dynamic shared memory at head dim D, in bytes (-1
// for a D it is not built for)
extern "C" int trlx_flash_fwd_split3_smem(int D) {
  return with_head_dim(D, [](auto d) { return split3_smem<decltype(d)::value>(); });
}

// variant: 0 = fma (f32), 1 = tile (bf16, Q > 16), 2 = decode (bf16,
// Q <= 16), as ops/flash_attention.py::forward_variant picks it, or 3 =
// split3 (f32, no causal flag; block_forward_variant): q, k and v are then
// the bf16 planes of the f32 tensors ([3, B, T, H, D] contiguous, from
// csrc/split_planes.cu) with the strides of one plane, and o is f32.
// dtype: 0 = float32, 1 = bfloat16 (the dtype of the function, f32 for
// split3). D: a head dim of kHeadDims (16, 24, 32, 64, 96, 128 or 256).
// Strides are in elements; the head dim must be contiguous, and the tile,
// decode and split3 variants need 16-byte-aligned K and V (and Q for tile
// and split3) as `aligned16` states. bias may be null; lse may be null (not written).
// p_scale, [B, H, Q] f32 like lse, may be null (not written; split3 takes only
// null): per row the factor that turns the backward's exp(S - LSE) into this
// forward's weights (hopper_tile.cuh p_scale_of), 1 on every row with a live key.
// Returns 0 on success, else the CUDA error code of the launch, or -1 for arguments the
// chosen variant was not built for.
extern "C" int trlx_flash_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, void* p_scale, int variant, int dtype, int B, int H, int Q, int K,
    int D,
    long long sqb, long long sqt, long long sqh, long long skb, long long skt,
    long long skh, long long svb, long long svt, long long svh, long long sbb,
    long long sbh, long long sbq, long long sbk, float scale, int causal,
    void* stream) {
  if (!built_head_dim(D) || B < 1 || H < 1 || Q < 1 || K < 1 || H > 65535 ||
      B > 65535)
    return -1;
  const Strides sq{sqb, sqt, sqh}, sk{skb, skt, skh}, sv{svb, svt, svh};
  const BiasStrides sb{sbb, sbh, sbq, sbk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_head_dim(D, [&](auto d) {
    return launch_variant<decltype(d)::value>(q, k, v, bias, o, lse, p_scale, variant, dtype,
                                              B, H, Q, K, sq, sk, sv, sb, scale, causal,
                                              nullptr, st);
  });
}

// The decode_int8 variant (4): K1's decode over the int8 KV cache, bf16 q
// and o, Q <= 16. k and v are int8 [B, K, H, D] through element strides
// (8-byte-aligned rows, as aligned8 states); k_scale and v_scale bf16 [B,
// K, H, 1] through their own (b, t, h) strides. Every other argument as
// trlx_flash_fwd's. Returns 0 on success, else the CUDA error code of the
// launch, or -1 for arguments it was not built for.
extern "C" int trlx_flash_fwd_int8(
    const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
    const void* bias, void* o, void* lse, void* p_scale, int B, int H, int Q, int K, int D,
    long long sqb, long long sqt, long long sqh, long long skb, long long skt,
    long long skh, long long svb, long long svt, long long svh, long long sksb,
    long long skst, long long sksh, long long svsb, long long svst, long long svsh,
    long long sbb, long long sbh, long long sbq, long long sbk, float scale, int causal,
    void* stream) {
  if (!built_head_dim(D) || B < 1 || H < 1 || Q < 1 || K < 1 || H > 65535 ||
      B > 65535 || !k_scale || !v_scale)
    return -1;
  const Strides sq{sqb, sqt, sqh}, sk{skb, skt, skh}, sv{svb, svt, svh};
  const Int8Scales int8{k_scale, v_scale, Strides{sksb, skst, sksh}, Strides{svsb, svst, svsh}};
  const BiasStrides sb{sbb, sbh, sbq, sbk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_head_dim(D, [&](auto d) {
    return launch_variant<decltype(d)::value>(q, k, v, bias, o, lse, p_scale, kDecodeInt8, 1,
                                              B, H, Q, K, sq, sk, sv, sb, scale, causal,
                                              &int8, st);
  });
}
