// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel, bound through plain C entry points (`trlx_flash_bwd_dq`,
// `trlx_flash_bwd_dkv`) that Python loads with ctypes.
//
// Replaces the TPU kernels trlx_tpu/ops/flash_attention.py::_dq_kernel (:211)
// and ::_dkv_kernel (:265). Both recompute the scores per tile from the
// forward's saved LSE, P = exp(S - LSE) with S = scale * Q K^T (f32) + bias +
// causal NEG_INF, and take delta = rowsum(dO * O) (f32) in the kernel instead
// of reading it from memory. Numerics kept from the TPU source:
//  - dP = dO V^T from dO and V, exact in f32 (:250, :311);
//  - P is NOT rounded to V's dtype here (the forward rounds it before P V);
//  - the dQ kernel casts dS to K's dtype before dS K (:255-257);
//  - the dK/dV kernel keeps P and dS in f32 for P^T dO and dS^T Q (:307-319);
//  - dQ and dK are scaled once, at emit (:262, :323).
//
// Shared by every variant:
//  - dQ: one CTA per (query tile, head, batch row). The TPU's sequential
//    key-tile grid axis becomes a loop inside the CTA; dQ accumulates in
//    registers across key tiles, so no atomics.
//  - dK/dV: one CTA per (64-key tile, head, batch row), looping over 64-row
//    query chunks and taking delta per chunk (as :296 does). dK and dV
//    accumulate in f32 registers; no atomics, so the result is
//    deterministic.
//  - The causal visit rule of the forward (csrc/flash_fwd.cu): a query row
//    sees the 64-key tiles that start before the end of its forward query
//    tile, 16 rows when Q <= 16 and 64 otherwise. A left-padding row whose
//    visible keys are all masked normalised over the keys of the tiles it
//    visited, so P = exp(S - LSE) sums to 1 over those tiles only: dQ walks
//    the key tiles of its query tile's forward visit, dK/dV applies the
//    predicate per row. A key tile starts at a multiple of 64, which both
//    forward tile sizes divide, so row qi visits the tile at k0 iff qi >=
//    k0. Key tiles that no query visits (the causal tail) are written as
//    zeros.
//  - Inputs are read in the port's public [B, T, H, D] layout through
//    strides, the bias through four strides (0 = broadcast dimension), the
//    LSE as [B, H, Q] f32; ragged Q/K edges are masked in the kernel and
//    keys past K are left out, as in the forward. Padded query rows have
//    P = 0, so a NEG_INF-sized logit never meets an unloaded LSE.
//  - The bias gradient (T5's learned relative position bias, which the TPU
//    wrapper leaves to XLA): the bias is added after the scale, so its
//    gradient is dS itself. The dQ kernel forms dS per (query, key) anyway,
//    so with a dbias pointer it also stores that f32 dS, before the bf16
//    cast, into a contiguous [B, H, Q, K] tensor, masking the Q and K tails.
//    The store is a template switch (kDbias): the instantiation without it
//    compiles to the same code as before. A learned bias carries T5's
//    causal mask itself, so dbias comes only without the causal flag, every
//    key tile is visited and every element written. The write doubles the
//    bias's bytes: at T5's encoder shape it bounds the kernel.
//
// Two variants, chosen in Python (ops/flash_attention.py::backward_variant)
// and passed in; a mismatched choice is refused with -1:
//
//  tile (bf16; the update backward B=16 T=112 H=12 causal with a [B,1,1,K]
//    padding bias). Both kernels are bound by the bytes they must move (5-6
//    us at that shape; the products are a tenth of that on the tensor
//    cores), so the design is about latency: one warpgroup (128 threads)
//    per CTA, 16-byte cp.async copies into the 128-byte swizzled tiles that
//    wgmma reads (hopper_tile.cuh, as K1's tile variant), a 2-stage ring
//    whose next stage loads while the current one multiplies, and every
//    product a wgmma.m64n64k16 with f32 accumulation:
//    - dQ: Q, dO and O are staged once; K and V tiles stream through the
//      ring up to the visit rule's end. S = Q K^T and dP = dO V^T take both
//      operands from shared memory; dS = P (dP - delta) is formed on the
//      accumulator fragments, rounded to bf16 (the reference's cast) and
//      is the register A operand of dQ += dS K, with K [key][d] MN-major.
//    - dK/dV: K and V are staged once; Q, dO and O stream through the ring
//      in 64-row query chunks, from the first chunk that visits the key
//      tile. The products run transposed, keys as rows: S^T = K Q^T and
//      dP^T = V dO^T from shared memory, then dV += P^T dO and dK += dS^T
//      Q with P^T and dS^T as register A operands and dO, Q [query][d]
//      MN-major: every product is one K1's tile variant already runs.
//      LSE and delta are indexed by accumulator column (the query), through
//      shared memory. The reference keeps P and dS in f32, and bf16 A
//      operands would round them: each goes in as two bf16 fragments, hi =
//      bf16(x) and lo = bf16(x - hi), two wgmmas against the same B, so the
//      product is the f32 one within about 2^-16 relative (dO and Q are
//      exact in bf16).
//    A register A operand never outlives its tile or chunk (the fault K1's
//    tile variant hit was a fragment loaded once before the loop;
//    flash_fwd.cu explains it). In the SASS (cuobjdump -sass of the built
//    library), dS (dQ) and the hi/lo fragments of P^T and dS^T (dK/dV)
//    are packed by F2FP from this tile's or chunk's accumulators after the
//    dP product's WARPGROUP.DEPBAR, partly into that product's own
//    accumulator registers; between their HGMMAs and the DEPBAR that waits
//    for them only uniform-register instructions run, and the next write
//    to those registers is the next tile's or chunk's S product, after
//    that DEPBAR and the barrier.
//    ptxas for sm_90a (chip_smoke.py phase 1 prints it; 0 spill bytes):
//    dQ 148 registers, 58368 B of dynamic shared memory, 3 CTAs per SM;
//    dK/dV 204 registers, 67072 B, 2 CTAs per SM (registers bound it: at
//    the 3-CTA cap of 168 it spilled 8-104 bytes in every arrangement
//    tried). The training shape's 384-CTA grids then take one wave (dQ)
//    and 1.45 waves (dK/dV) on 132 SMs.
//
//  fma (f32, every Q): the parity path (phase 3's full-width gradient gate
//    holds it to 1e-3 relative, the kernel tests to 1e-4). f32 FMA from
//    shared memory, register-blocked 4x4 per thread, tiles staged as f32;
//    tensor cores would make it TF32. No bf16 call reaches it.

#include <math.h>

#include "hopper_tile.cuh"

namespace {

enum Variant { kFma = 0, kTile = 1 };

constexpr int kBQ = 64;  // query rows per tile or chunk (the forward's Q > 16 tile)

// the forward kernel's query tile for Q query rows (the causal visit rule)
int forward_block_q(int Q) { return Q <= 16 ? 16 : 64; }

// Logit of (query qi, key kj), both in range, as the forward forms it.
__device__ __forceinline__ float logit(float s, float scale,
                                       const float* biasb, BiasStrides sb,
                                       int qi, int kj, int causal) {
  float x = s * scale;
  if (biasb) x += biasb[qi * sb.q + kj * sb.k];
  if (causal && kj > qi) x += kNegInf;
  return x;
}

// ---------------------------------------------------------------------------
// fma: the f32 parity path
// ---------------------------------------------------------------------------

constexpr int kLD = kD + 1;    // padded row stride of the f32 tiles (banks)
constexpr int kThreads = 256;  // 16 x 16 threads

static_assert(kBK == kD, "the P/dS tiles share the Q/K/V row stride");

// Stage rows [r0, r0 + n) of a [B, T, H, D] tensor (already offset to its
// batch row and head) into a [n][kLD] tile; rows at or past T are 0.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long st, int r0, int n,
                                          int T_len) {
  for (int i = threadIdx.x; i < n * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    const int t = r0 + r;
    dst[r * kLD + d] = t < T_len ? src[t * st + d] : 0.f;
  }
}

// delta[r] = sum_d dO[r][d] * O[r][d] for the n staged rows, and the rows'
// LSE (0 for rows past Q, whose P is forced to 0).
__device__ __forceinline__ void row_stats(float* Ds, float* Ls,
                                          const float* dOs, const float* Os,
                                          const float* lse_row, int q0, int n,
                                          int Q) {
  for (int r = threadIdx.x; r < n; r += kThreads) {
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; ++d) acc = fmaf(dOs[r * kLD + d], Os[r * kLD + d], acc);
    Ds[r] = acc;
    Ls[r] = q0 + r < Q ? lse_row[q0 + r] : 0.f;
  }
}

// S = Q K^T and dP = dO V^T for this thread's RQ rows x 4 keys (keys
// tx + 16 j of the staged tile).
template <int RQ>
__device__ __forceinline__ void scores(float (&s)[RQ][4], float (&dp)[RQ][4],
                                       const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       int tx, int ty) {
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kD; ++d) {
    float kv[4], vv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(tx + 16 * j) * kLD + d];
      vv[j] = Vs[(tx + 16 * j) * kLD + d];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const float qv = Qs[(ty * RQ + i) * kLD + d];
      const float dov = dOs[(ty * RQ + i) * kLD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv, kv[j], s[i][j]);
        dp[i][j] = fmaf(dov, vv[j], dp[i][j]);
      }
    }
  }
}

// dQ: one block per (query tile of BQ rows, head, batch row); with kDbias
// also dbias = dS for the block's rows (unscaled: the bias is added after
// the scale), into a contiguous [B, H, Q, K] f32 tensor
template <int BQ, bool kDbias>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ bias,
                        const float* __restrict__ o, const float* __restrict__ dout,
                        const float* __restrict__ lse, float* __restrict__ dq,
                        float* __restrict__ dbias,
                        int H, int Q, int K, Strides sq, Strides sk, Strides sv,
                        Strides so, Strides sdo, BiasStrides sb, float scale,
                        int causal) {
  constexpr int RQ = BQ / 16;  // query rows per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][kLD]
  float* dOs = Qs + BQ * kLD;    // [BQ][kLD]
  float* Ks = dOs + BQ * kLD;    // [kBK][kLD]
  float* Vs = Ks + kBK * kLD;    // [kBK][kLD]
  float* dSs = Vs + kBK * kLD;   // [BQ][kLD]; holds O until delta is taken
  float* Ls = dSs + BQ * kLD;    // [BQ]
  float* Ds = Ls + BQ;           // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* biasb = bias ? bias + b * sb.b + h * sb.h : nullptr;

  load_tile(Qs, q + b * sq.b + h * sq.h, sq.t, q0, BQ, Q);
  load_tile(dOs, dout + b * sdo.b + h * sdo.h, sdo.t, q0, BQ, Q);
  load_tile(dSs, o + b * so.b + h * so.h, so.t, q0, BQ, Q);
  __syncthreads();
  row_stats(Ds, Ls, dOs, dSs, lse + (static_cast<long long>(b) * H + h) * Q,
            q0, BQ, Q);

  float acc[RQ][4];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // causal: the key tiles the forward visited for this query tile
  const int k_end = causal ? min(K, q0 + BQ) : K;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // previous tile's K/dS reads (and the O reads) are done
    load_tile(Ks, kb, sk.t, k0, kBK, K);
    load_tile(Vs, vb, sv.t, k0, kBK, K);
    __syncthreads();

    float s[RQ][4], dp[RQ][4];
    scores<RQ>(s, dp, Qs, dOs, Ks, Vs, tx, ty);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i;
      const int qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float p = 0.f;  // padded rows and keys past K carry no weight
        if (qi < Q && kj < K)
          p = expf(logit(s[i][j], scale, biasb, sb, qi, kj, causal) - Ls[r]);
        const float ds = p * (dp[i][j] - Ds[r]);
        dSs[r * kLD + tx + 16 * j] = ds;
        if (kDbias && qi < Q && kj < K)
          dbias[((static_cast<long long>(b) * H + h) * Q + qi) * K + kj] = ds;
      }
    }
    __syncthreads();  // dS complete

#pragma unroll 8
    for (int c = 0; c < kBK; ++c) {
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[c * kLD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float ds = dSs[(ty * RQ + i) * kLD + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ds, kv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + ty * RQ + i;
    if (qi >= Q) continue;
    float* row = dq + ((static_cast<long long>(b) * Q + qi) * H + h) * kD;
#pragma unroll
    for (int j = 0; j < 4; ++j) row[tx + 16 * j] = acc[i][j] * scale;
  }
}

// dK, dV: one block per (64-key tile, head, batch row)
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ bias,
                         const float* __restrict__ o, const float* __restrict__ dout,
                         const float* __restrict__ lse, float* __restrict__ dk,
                         float* __restrict__ dv, int H, int Q, int K, Strides sq,
                         Strides sk, Strides sv, Strides so, Strides sdo,
                         BiasStrides sb, float scale, int causal) {
  constexpr int RQ = kBQ / 16;  // query rows per thread in the score phase
  extern __shared__ float smem[];
  float* Ks = smem;              // [kBK][kLD]
  float* Vs = Ks + kBK * kLD;    // [kBK][kLD]
  float* Qs = Vs + kBK * kLD;    // [kBQ][kLD]
  float* dOs = Qs + kBQ * kLD;   // [kBQ][kLD]
  float* Ps = dOs + kBQ * kLD;   // [kBQ][kLD]; holds O until delta is taken
  float* dSs = Ps + kBQ * kLD;   // [kBQ][kLD]
  float* Ls = dSs + kBQ * kLD;   // [kBQ]
  float* Ds = Ls + kBQ;          // [kBQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* ob = o + b * so.b + h * so.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* lse_row = lse + (static_cast<long long>(b) * H + h) * Q;
  const float* biasb = bias ? bias + b * sb.b + h * sb.h : nullptr;

  load_tile(Ks, k + b * sk.b + h * sk.h, sk.t, k0, kBK, K);
  load_tile(Vs, v + b * sv.b + h * sv.h, sv.t, k0, kBK, K);

  // this thread accumulates keys k0 + ty*4 + i, head dims tx + 16 j
  float dk_acc[4][4], dv_acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int q0 = 0; q0 < Q; q0 += kBQ) {
    // causal: the chunk is live iff its last row visited this key tile
    // (block-uniform)
    if (causal && min(q0 + kBQ, Q) - 1 < k0) continue;
    __syncthreads();  // previous chunk's reads (and the K/V stores) are done
    load_tile(Qs, qb, sq.t, q0, kBQ, Q);
    load_tile(dOs, dob, sdo.t, q0, kBQ, Q);
    load_tile(Ps, ob, so.t, q0, kBQ, Q);
    __syncthreads();
    row_stats(Ds, Ls, dOs, Ps, lse_row, q0, kBQ, Q);
    __syncthreads();  // delta taken: Ps is free for P

    float s[RQ][4], dp[RQ][4];
    scores<RQ>(s, dp, Qs, dOs, Ks, Vs, tx, ty);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i;
      const int qi = q0 + r;
      const bool visits = qi < Q && (!causal || qi >= k0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kj = k0 + c;
        float p = 0.f;
        if (visits && kj < K)
          p = expf(logit(s[i][j], scale, biasb, sb, qi, kj, causal) - Ls[r]);
        Ps[r * kLD + c] = p;
        dSs[r * kLD + c] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();  // P and dS complete

#pragma unroll 4
    for (int r = 0; r < kBQ; ++r) {
      float dov[4], qv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dov[j] = dOs[r * kLD + tx + 16 * j];
        qv[j] = Qs[r * kLD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[r * kLD + ty * 4 + i];
        const float ds = dSs[r * kLD + ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dv_acc[i][j] = fmaf(p, dov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(ds, qv[j], dk_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    if (kj >= K) continue;
    const long long off = ((static_cast<long long>(b) * K + kj) * H + h) * kD;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dk[off + tx + 16 * j] = dk_acc[i][j] * scale;
      dv[off + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// tile: bf16, tensor cores (wgmma.m64n64k16)
// ---------------------------------------------------------------------------

// CTAs per SM in the launch bounds. dQ fits 168 registers (3 CTAs); dK/dV
// holds two f32 accumulators and P, dS (hi + lo) at once and spilled at 168
// in every arrangement tried, so it takes 2 CTAs and up to 255 registers.
constexpr int kDqMinBlocks = 3;
constexpr int kDkvMinBlocks = 2;
// dynamic shared memory: the tiles, and 1 KB of slack to align them to the
// 1024 bytes the 128-byte swizzle repeats over
constexpr int kDqSmem = 7 * kTileBytes + 1024;  // Q, dO, O, K[2], V[2]
constexpr int kDkvSmem =                        // K, V, (Q, dO, O)[2], LSE, delta
    8 * kTileBytes + 2 * kBQ * static_cast<int>(sizeof(float)) + 1024;

// The dynamic shared memory from its first 1024-byte boundary: the generic
// pointer and the shared address of the same byte.
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw, uint32_t& addr) {
  const uint32_t a = smem_addr(raw);
  const uint32_t pad = (1024u - (a & 1023u)) & 1023u;
  addr = a + pad;
  return raw + pad;
}

// sum_i x[i] y[i] over 8 bf16 pairs, added to acc in f32
__device__ __forceinline__ float dot8(const uint8_t* x, const uint8_t* y,
                                      float acc) {
  const uint4 xa = *reinterpret_cast<const uint4*>(x);
  const uint4 ya = *reinterpret_cast<const uint4*>(y);
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xa);
  const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&ya);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 xf = __bfloat1622float2(xp[i]);
    const float2 yf = __bfloat1622float2(yp[i]);
    acc = fmaf(xf.x, yf.x, acc);
    acc = fmaf(xf.y, yf.y, acc);
  }
  return acc;
}

// k-step ks of an f32 accumulator as two bf16 A fragments (pack_fragment's
// layout): hi = bf16(x), lo = bf16(x - hi), so hi + lo is x within about
// 2^-17 relative
__device__ __forceinline__ void split_fragment(uint32_t (&hi)[4],
                                               uint32_t (&lo)[4],
                                               const float (&d)[8][4], int ks) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x0 = d[2 * ks + (i >> 1)][2 * (i & 1)];
    const float x1 = d[2 * ks + (i >> 1)][2 * (i & 1) + 1];
    hi[i] = pack_bf16(x0, x1);
    const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi[i]));
    lo[i] = pack_bf16(x0 - h.x, x1 - h.y);
  }
}

__device__ __forceinline__ void zero(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
}

// d = X Y^T for 64 x 64 bf16 tiles X, Y [row][d] in shared memory, issued
// (not committed) as 4 wgmmas
__device__ __forceinline__ void product(float (&d)[8][4], uint32_t x, uint32_t y) {
  zero(d);
  fence_registers(d);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_ss(d, smem_desc(x + 32 * ks), smem_desc(y + 32 * ks), ks > 0);
}

// dQ: one warpgroup per (64-row query tile, head, batch row); warp w owns
// rows 16 w .. 16 w + 15, each thread rows g and g + 8 of them. With
// kDbias it also stores dbias = dS (f32, unscaled) from the accumulator
// fragments into a contiguous [B, H, Q, K] tensor; without it the code is
// PR 4's (the store is compiled out).
template <bool kDbias>
__global__ void __launch_bounds__(kTileThreads, kDqMinBlocks)
flash_bwd_dq_tile_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ bias,
                         const bf16* __restrict__ o, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, bf16* __restrict__ dq,
                         float* __restrict__ dbias,
                         int H, int Q, int K, Strides sq, Strides sk, Strides sv,
                         Strides so, Strides sdo, BiasStrides sb, float scale,
                         int causal) {
  extern __shared__ uint8_t smem_raw[];
  uint32_t sQ;
  const uint8_t* smem = aligned_smem(smem_raw, sQ);
  const uint32_t sdO = sQ + kTileBytes, sO = sQ + 2 * kTileBytes;
  const uint32_t sK0 = sQ + 3 * kTileBytes, sV0 = sQ + 5 * kTileBytes;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  // causal: the key tiles the forward visited for this query tile (at
  // Q <= 16 the forward's 16-row tile also ends in key tile 0); the rows of
  // one 64-row tile share their forward tile, so this is the per-row rule
  const int k_end = causal ? min(K, q0 + kBQ) : K;
  const int n_tiles = (k_end + kBK - 1) / kBK;

  load_tile_async(sQ, q + b * sq.b + h * sq.h, sq.t, q0, Q);
  load_tile_async(sdO, dout + b * sdo.b + h * sdo.h, sdo.t, q0, Q);
  load_tile_async(sO, o + b * so.b + h * so.h, so.t, q0, Q);
  load_tile_async(sK0, kb, sk.t, 0, K);
  load_tile_async(sV0, vb, sv.t, 0, K);
  cp_async_commit();

  // this thread's rows, their LSE and their bias rows (a padded row reads
  // row Q - 1's, so every bias read is in bounds)
  int qi[2];
  float lse_r[2], delta[2] = {0.f, 0.f};
  const float* brow[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    qi[hr] = q0 + warp * 16 + g + 8 * hr;
    lse_r[hr] = qi[hr] < Q ? lse[(static_cast<long long>(b) * H + h) * Q + qi[hr]] : 0.f;
    brow[hr] = bias ? bias + b * sb.b + h * sb.h + min(qi[hr], Q - 1) * sb.q : nullptr;
  }
  float acc[8][4];
  zero(acc);

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    const int k0 = t * kBK;
    if (t + 1 < n_tiles) {  // prefetch the next tile into the other stage
      load_tile_async(sK0 + (buf ^ 1) * kTileBytes, kb, sk.t, k0 + kBK, K);
      load_tile_async(sV0 + (buf ^ 1) * kTileBytes, vb, sv.t, k0 + kBK, K);
    }
    cp_async_commit();  // possibly empty: keeps one group per iteration
    cp_async_wait<1>();  // everything up to this tile has landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t sK = sK0 + buf * kTileBytes;
    const uint32_t sV = sV0 + buf * kTileBytes;

    if (t == 0) {
      // delta of this thread's two rows: 16 columns each, summed over the quad
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = warp * 16 + g + 8 * hr;
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int ch = 2 * t4 + i;
          d = dot8(smem + (sdO - sQ) + swizzle(r, ch), smem + (sO - sQ) + swizzle(r, ch), d);
        }
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        delta[hr] = d + __shfl_xor_sync(0xffffffffu, d, 2);
      }
    }

    // S = Q K^T and dP = dO V^T as two wgmma groups; P is formed while
    // the second runs
    float s[8][4], dp[8][4];
    product(s, sQ, sK);
    wgmma_commit();
    product(dp, sdO, sV);
    wgmma_commit();
    wgmma_wait<1>();
    fence_registers(s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const int kj = k0 + 8 * j + 2 * t4 + (e & 1);
        // logit()'s sum in its order, formed for every element (a key past
        // K reads key K - 1's bias) and then selected: no branch per
        // element. Padded rows and keys past K carry no weight.
        float x = s[j][e] * scale;
        if (brow[hr]) x += brow[hr][min(kj, K - 1) * sb.k];
        if (causal && kj > qi[hr]) x += kNegInf;
        s[j][e] = qi[hr] < Q && kj < K ? __expf(x - lse_r[hr]) : 0.f;
      }
    wgmma_wait<0>();
    fence_registers(dp);

    // dQ += bf16(dS) K: dS = P (dP - delta), packed from this tile's
    // accumulators as the register A operand
    uint32_t da[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - delta[e >> 1]);
    if constexpr (kDbias) {
      // dS of this thread's (row, key) pairs in range, before the bf16 cast;
      // rows qi[0] and qi[0] + 8 share one base, 8 K floats apart
      float* drow = dbias + ((static_cast<long long>(b) * H + h) * Q + qi[0]) * K;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * j + 2 * t4 + (e & 1);
          if (qi[e >> 1] < Q && kj < K) drow[(e >> 1) * 8 * K + kj] = dp[j][e];
        }
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) pack_fragment(da[ks], dp, ks);
    fence_registers(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_rs_mn(acc, da[ks], smem_desc(sK + 2048 * ks));
    wgmma_commit_and_wait();
    fence_registers(acc);
    __syncthreads();  // this stage is read; the next iteration refills it
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (qi[hr] >= Q) continue;
    bf16* row = dq + ((static_cast<long long>(b) * Q + qi[hr]) * H + h) * kD;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t4) =
          pack_bf16(acc[j][2 * hr] * scale, acc[j][2 * hr + 1] * scale);
  }
}

// dK, dV: one warpgroup per (64-key tile, head, batch row); the
// accumulators hold keys as rows (warp w keys 16 w .. 16 w + 15, each
// thread keys g and g + 8 of them) and the chunk's queries as columns.
__global__ void __launch_bounds__(kTileThreads, kDkvMinBlocks)
flash_bwd_dkv_tile_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ bias,
                          const bf16* __restrict__ o, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int H, int Q, int K, Strides sq,
                          Strides sk, Strides sv, Strides so, Strides sdo,
                          BiasStrides sb, float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  uint32_t sK;
  uint8_t* smem = aligned_smem(smem_raw, sK);
  const uint32_t sV = sK + kTileBytes;
  const uint32_t sChunk0 = sK + 2 * kTileBytes;  // stage s: Q, dO, O at + 3 s tiles
  float* sL = reinterpret_cast<float*>(smem + 8 * kTileBytes);  // the chunk's LSE
  float* sD = sL + kBQ;                                         // and delta

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_chunks = (Q + kBQ - 1) / kBQ;

  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* ob = o + b * so.b + h * so.h;
  const bf16* dob = dout + b * sdo.b + h * sdo.h;
  const float* lse_row = lse + (static_cast<long long>(b) * H + h) * Q;
  const float* biasb = bias ? bias + b * sb.b + h * sb.h : nullptr;

  // causal: row qi visited this key tile iff qi >= k0, so the live chunks
  // are those from k0's chunk on (block-uniform)
  const int c_begin = causal ? min(k0 / kBQ, n_chunks) : 0;

  // this thread's keys, and their bias columns (a key past K reads key
  // K - 1's, so every bias read is in bounds)
  int kr[2];
  const float* bcol[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    kr[hr] = k0 + warp * 16 + g + 8 * hr;
    bcol[hr] = biasb ? biasb + min(kr[hr], K - 1) * sb.k : nullptr;
  }
  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);

  auto load_chunk = [&](uint32_t dst, int q0) {
    load_tile_async(dst, qb, sq.t, q0, Q);
    load_tile_async(dst + kTileBytes, dob, sdo.t, q0, Q);
    load_tile_async(dst + 2 * kTileBytes, ob, so.t, q0, Q);
  };
  if (c_begin < n_chunks) {
    load_tile_async(sK, k + b * sk.b + h * sk.h, sk.t, k0, K);
    load_tile_async(sV, v + b * sv.b + h * sv.h, sv.t, k0, K);
    load_chunk(sChunk0, c_begin * kBQ);
    cp_async_commit();
  }

  for (int c = c_begin; c < n_chunks; ++c) {
    const int buf = (c - c_begin) & 1;
    const int q0 = c * kBQ;
    const uint32_t sQ = sChunk0 + buf * 3 * kTileBytes;
    const uint32_t sdO = sQ + kTileBytes, sO = sQ + 2 * kTileBytes;
    if (c + 1 < n_chunks)  // prefetch the next chunk into the other stage
      load_chunk(sChunk0 + (buf ^ 1) * 3 * kTileBytes, q0 + kBQ);
    cp_async_commit();  // possibly empty: keeps one group per iteration
    // row sr's LSE and delta are staged by threads 2 sr (delta) and 2 sr + 1
    // (LSE); the LSE read goes out before the wait
    const int sr = tid >> 1;
    const float lse_r = (tid & 1) && q0 + sr < Q ? lse_row[q0 + sr] : 0.f;
    cp_async_wait<1>();  // everything up to this chunk has landed
    fence_proxy_async();
    __syncthreads();
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ch = 4 * (tid & 1) + i;
      d = dot8(smem + (sdO - sK) + swizzle(sr, ch), smem + (sO - sK) + swizzle(sr, ch), d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (tid & 1)
      sL[sr] = lse_r;
    else
      sD[sr] = d;
    __syncthreads();

    // S^T = K Q^T, then dP^T = V dO^T once P^T is formed (issuing both
    // at once took 8 more registers and no less time)
    float s[8][4], dp[8][4];
    product(s, sK, sQ);
    wgmma_commit_and_wait();
    fence_registers(s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t4 + (e & 1);
        const int qi = q0 + col;
        const int kj = kr[e >> 1];
        // logit()'s sum in its order, formed for every element (a padded
        // row reads row Q - 1's bias) and then selected: no branch per
        // element. Padded rows, keys past K and unvisited rows carry no
        // weight.
        float x = s[j][e] * scale;
        if (bcol[e >> 1]) x += bcol[e >> 1][min(qi, Q - 1) * sb.q];
        if (causal && kj > qi) x += kNegInf;
        const bool in = qi < Q && kj < K && (!causal || qi >= k0);
        s[j][e] = in ? __expf(x - sL[col]) : 0.f;
      }
    product(dp, sV, sdO);
    wgmma_commit_and_wait();
    fence_registers(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = s[j][e] * (dp[j][e] - sD[8 * j + 2 * t4 + (e & 1)]);

    // dV += P^T dO and dK += dS^T Q, each A operand as hi + lo fragments
    // packed from this chunk's accumulators
    uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      split_fragment(p_hi[ks], p_lo[ks], s, ks);
      split_fragment(ds_hi[ks], ds_lo[ks], dp, ks);
    }
    fence_registers(dv_acc);
    fence_registers(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wgmma_rs_mn(dv_acc, p_hi[ks], smem_desc(sdO + 2048 * ks));
      wgmma_rs_mn(dv_acc, p_lo[ks], smem_desc(sdO + 2048 * ks));
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wgmma_rs_mn(dk_acc, ds_hi[ks], smem_desc(sQ + 2048 * ks));
      wgmma_rs_mn(dk_acc, ds_lo[ks], smem_desc(sQ + 2048 * ks));
    }
    wgmma_commit_and_wait();
    fence_registers(dv_acc);
    fence_registers(dk_acc);
    __syncthreads();  // this stage and sL/sD are read; the next chunk refills them
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (kr[hr] >= K) continue;
    const long long off = ((static_cast<long long>(b) * K + kr[hr]) * H + h) * kD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j + 2 * t4) =
          pack_bf16(dk_acc[j][2 * hr] * scale, dk_acc[j][2 * hr + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j + 2 * t4) =
          pack_bf16(dv_acc[j][2 * hr], dv_acc[j][2 * hr + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *bias, *o, *dout, *lse;
  int B, H, Q, K;
  Strides sq, sk, sv, so, sdo;
  BiasStrides sb;
  float scale;
  int causal;
  cudaStream_t stream;
};

bool valid(int D, int B, int H, int Q, int K) {
  return D == kD && B >= 1 && H >= 1 && Q >= 1 && K >= 1 && H <= 65535 &&
         B <= 65535;
}

// the tile variant's 16-byte copies read all five inputs in place
bool tile_aligned(const Args& a) {
  return aligned16(a.q, a.sq, a.B, a.Q, a.H) && aligned16(a.o, a.so, a.B, a.Q, a.H) &&
         aligned16(a.dout, a.sdo, a.B, a.Q, a.H) &&
         aligned16(a.k, a.sk, a.B, a.K, a.H) && aligned16(a.v, a.sv, a.B, a.K, a.H);
}

// Launch `kernel` on a grid of (tiles, H, B) with `smem` bytes of dynamic
// shared memory; T is the element type of the five inputs, `out` the typed
// output pointers.
template <typename T, auto kernel, typename... Out>
cudaError_t launch(const Args& a, int tiles, int threads, size_t smem,
                   Out... out) {
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles, a.H, a.B), threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.bias),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), out..., a.H, a.Q, a.K, a.sq, a.sk,
      a.sv, a.so, a.sdo, a.sb, a.scale, a.causal);
  return cudaGetLastError();
}

template <int BQ, bool kDbias>
cudaError_t launch_dq_fma(const Args& a, void* dq, void* dbias) {
  constexpr size_t smem = sizeof(float) * ((3 * BQ + 2 * kBK) * kLD + 2 * BQ);
  return launch<float, flash_bwd_dq_fma_kernel<BQ, kDbias>>(
      a, (a.Q + BQ - 1) / BQ, kThreads, smem, static_cast<float*>(dq),
      static_cast<float*>(dbias));
}

template <bool kDbias>
cudaError_t launch_dq(const Args& a, int variant, int dtype, void* dq,
                      void* dbias, bool* refused) {
  if (variant == kFma && dtype == 0)
    return forward_block_q(a.Q) == 16 ? launch_dq_fma<16, kDbias>(a, dq, dbias)
                                      : launch_dq_fma<64, kDbias>(a, dq, dbias);
  if (variant == kTile && dtype == 1 && tile_aligned(a))
    return launch<bf16, flash_bwd_dq_tile_kernel<kDbias>>(
        a, (a.Q + kBQ - 1) / kBQ, kTileThreads, kDqSmem, static_cast<bf16*>(dq),
        static_cast<float*>(dbias));
  *refused = true;
  return cudaSuccess;
}

Args make_args(const void* q, const void* k, const void* v, const void* bias,
               const void* o, const void* dout, const void* lse, int B, int H,
               int Q, int K, const long long* s, float scale, int causal,
               void* stream) {
  // s: q, k, v, o, dout strides (b, t, h each), then the bias's (b, h, q, k)
  return Args{q, k, v, bias, o, dout, lse, B, H, Q, K,
              Strides{s[0], s[1], s[2]}, Strides{s[3], s[4], s[5]},
              Strides{s[6], s[7], s[8]}, Strides{s[9], s[10], s[11]},
              Strides{s[12], s[13], s[14]},
              BiasStrides{s[15], s[16], s[17], s[18]}, scale, causal,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// variant: 0 = fma (f32), 1 = tile (bf16), as
// ops/flash_attention.py::backward_variant picks it; dtype: 0 = float32, 1 =
// bfloat16. `strides` holds 19 element strides: q, k, v, o, dout as (b, t,
// h) each (head dim contiguous), then the bias's (b, h, q, k) with 0 for a
// broadcast dimension; the tile variant needs all five inputs 16-byte
// aligned as `aligned16` states. bias may be null. lse is [B, H, Q] f32;
// outputs are contiguous [B, T, H, D] in the inputs' dtype. dbias (dQ only)
// may be null; when given it receives dS, the bias's gradient, as a
// contiguous [B, H, Q, K] f32 tensor, and the causal flag is refused (a
// learned bias carries its own causal mask, so every key tile is visited
// and every element written). Each returns 0 on success, else the CUDA
// error code of the launch, or -1 for arguments the chosen variant was not
// built for.
extern "C" int trlx_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* bias, const void* o,
                                 const void* dout, const void* lse, void* dq,
                                 void* dbias, int variant, int dtype, int B,
                                 int H, int Q, int K, int D,
                                 const long long* strides, float scale,
                                 int causal, void* stream) {
  if (!valid(D, B, H, Q, K) || (dbias && causal)) return -1;
  const Args a = make_args(q, k, v, bias, o, dout, lse, B, H, Q, K, strides,
                           scale, causal, stream);
  bool refused = false;
  const cudaError_t err =
      dbias ? launch_dq<true>(a, variant, dtype, dq, dbias, &refused)
            : launch_dq<false>(a, variant, dtype, dq, nullptr, &refused);
  return refused ? -1 : static_cast<int>(err);
}

extern "C" int trlx_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* bias, const void* o,
                                  const void* dout, const void* lse, void* dk,
                                  void* dv, int variant, int dtype, int B,
                                  int H, int Q, int K, int D,
                                  const long long* strides, float scale,
                                  int causal, void* stream) {
  if (!valid(D, B, H, Q, K)) return -1;
  const Args a = make_args(q, k, v, bias, o, dout, lse, B, H, Q, K, strides,
                           scale, causal, stream);
  const int tiles = (K + kBK - 1) / kBK;
  cudaError_t err;
  if (variant == kFma && dtype == 0)
    err = launch<float, flash_bwd_dkv_fma_kernel>(
        a, tiles, kThreads, sizeof(float) * ((2 * kBK + 4 * kBQ) * kLD + 2 * kBQ),
        static_cast<float*>(dk), static_cast<float*>(dv));
  else if (variant == kTile && dtype == 1 && tile_aligned(a))
    err = launch<bf16, flash_bwd_dkv_tile_kernel>(a, tiles, kTileThreads,
                                                  kDkvSmem, static_cast<bf16*>(dk),
                                                  static_cast<bf16*>(dv));
  else
    return -1;
  return static_cast<int>(err);
}
