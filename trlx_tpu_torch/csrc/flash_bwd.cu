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
// Three variants: tile and fma, chosen in Python for dense calls
// (ops/flash_attention.py::backward_variant) and passed in, a mismatched
// choice refused with -1; and split3, the ring's block backward's, through
// entry points of its own:
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
//    ptxas for sm_90a at D = 64 (chip_smoke.py phase 1 prints it; 0 spill
//    bytes): dQ 148 registers, 58368 B of dynamic shared memory, 3 CTAs per
//    SM; dK/dV 204 registers, 67072 B, 2 CTAs per SM (registers bound it:
//    at the 3-CTA cap of 168 it spilled 8-104 bytes in every arrangement
//    tried). The training shape's 384-CTA grids then take one wave (dQ)
//    and 1.45 waves (dK/dV) on 132 SMs.
//
//  fma (f32, every Q; dense calls): the parity path (phase 3's full-width
//    gradient gate holds it to 1e-3 relative, the kernel tests to 1e-4). f32
//    FMA from shared memory, register-blocked per thread, tiles staged as
//    f32; one TF32 pass on the tensor cores would break those tolerances. No
//    bf16 call reaches it.
//
//  split3 (f32, the ring's block backward, flash_block_bwd, which replaces
//    trlx_tpu/ops/flash_attention.py::flash_block_bwd :491; no causal flag):
//    f32 on the tensor cores through three bf16 planes of q, k, v and dO
//    (hopper_tile.cuh split3; the planes from csrc/split_planes.cu), every
//    product the sum of six plane products at 989 / 6 = 165 TFLOP/s, where
//    the fma variant reached about 11 % of the card's 67 TFLOP/s off the
//    tensor cores; at the ring's blocks its operations bound it
//    (chip_smoke.py::block_bound). The tile variant's structure:
//    - dQ: one warpgroup per 64-row query tile; Q's and dO's planes staged
//      once, K's and V's per key tile; S and dP as plane sums, P = exp(S -
//      LSE) and dS = P (dP - delta) in f32 (expf), dQ += dS K with dS as
//      three register fragments (split3_fragment), K MN-major. delta =
//      rowsum(dO O) from the f32 O and dO, read in place (a quad of lanes
//      a row), not from the planes.
//    - dK/dV: two warpgroups per 64-key tile, keys as rows, as the tile
//      variant at D >= 96 (here at every D: one warpgroup's accumulator, S^T
//      and the three fragments of P^T or dS^T leave no room for a second
//      accumulator); K's and V's planes staged once, Q's and dO's per
//      64-row query chunk, LSE and delta (from the f32 tensors, 4 threads a
//      row) through shared memory; both warpgroups form P^T, warpgroup 0
//      accumulates dV += P^T dO, warpgroup 1 dP^T, dS^T and dK += dS^T Q.
//    Both skip a (query tile, key tile) that is dead (hopper_tile.cuh
//    dead_tile: no bias entry above NEG_INF / 2, every row's outside LSE
//    above it): its P is exactly 0, so it adds nothing to dQ, dK or dV. The
//    ring's future blocks skip every tile, its diagonal blocks the upper
//    half. At D <= 64 a kernel's four operands are 12 plane tiles of 8 KB
//    (dQ 2 CTAs per SM), at 96 and 128 of 16 KB (1 CTA); at D = 256 they
//    would be 384 KB, so two slots of 96 KB take them in turn (dQ: Q and K,
//    dO and V, K again; dK/dV: K and Q, dO and V, Q again). A CTA holds one
//    64-column chunk of its accumulator (hopper_tile.cuh split3_chunks: at
//    D = 96, 128 and 256 the 2, 2 and 4 CTAs of a tile each form the whole
//    S and dP), each tile's or chunk's products summed apart and added to
//    it in f32 (accumulate_planes).
//
// Head dims (hopper_tile.cuh kHeadDims): every kernel is a template over D,
// built for 16 (the learning guard, the T5 stand-in's d_kv), 24 (the
// randomwalks configs), 32 (the GPT-2 stand-in), 64 (GPT-2), 96
// (GPT-NeoX-20B), 128 (GPT-Neo) and 256 (GPT-J-6B); each per-D constant is
// chosen per built D (per_head_dim). At D = 16, 24 and 32 every kernel runs D = 64's layout
// on one padded atom (hopper_tile.cuh tile_cols: columns D..63
// zero-filled), so S and dP take kmajor_steps = 1, 2 and 2 k-steps (at
// D = 24 the second covers columns 16..31, of which 24..31 are zero in
// both operands), the MN-major products' columns D..63 are dropped at the
// store, and delta sums over the atom's 8 chunks, the padded ones zero in
// dO and O:
//  - dQ tile: 7 tiles of 8 KB (57 KB), 2 CTAs per SM (3 at 64: the dbias
//    instantiation spilled at 3's register cap);
//  - dK/dV tile: one warpgroup holding both accumulators, 8 tiles of 8 KB,
//    2 CTAs per SM, as at 64;
//  - fma: as at 64 (64-row tiles and 64-key chunks; dQ at D = 24 16 x 16,
//    as at 96), each thread owning head-dim columns tx + 16 j,
//    j < ceil(D / 16); at D = 24 the columns past 23 of its second j are
//    neither read nor written.
// At D = 96 every tile is
// held as 64 x 128 (hopper_tile.cuh tile_cols: two atoms, columns 96..127
// zero-filled), so a K-major product takes 6 k-steps and an MN-major one two
// m64n64k16 products whose padded columns are dropped at the store:
//  - dQ tile: the dQ accumulator is 64 registers; Q, dO, O and the 2-stage
//    K/V ring are 7 tiles of 16 KB (113 KB with the slack: 2 CTAs per SM,
//    up to 255 registers). delta is taken over the 12 chunks of a row.
//  - dK/dV tile: dK and dV at the padded width would be 128 registers a
//    thread on top of P, dS and their hi + lo fragments, so the CTA runs
//    D = 256's layout, two warpgroups, one per accumulator; K, V and one
//    stage of Q, dO and O are 5 tiles of 16 KB (81 KB).
//  - fma: 16-row query tiles and 16-key chunks (dQ, 31 KB of padded f32
//    tiles), 64-key tiles and 64-row query chunks (dK/dV, 138 KB).
// At D = 128 (GPT-Neo) every kernel runs D = 96's layout on two whole atoms,
// nothing padded: a K-major product takes 8 k-steps, an MN-major one two
// m64n64k16 products stored whole.
//  - dQ tile: one warpgroup, the dQ accumulator 64 registers; 7 tiles of
//    16 KB (113 KB), 2 CTAs per SM, up to 255 registers; delta over the 16
//    chunks of a row, 4 per thread of its quad.
//  - dK/dV tile: two warpgroups, one per accumulator, as at 96 (dK and dV on
//    one warpgroup would be 128 registers a thread before P, dS and their
//    hi + lo fragments); K, V and one stage of Q, dO and O, 81 KB.
//  - fma: as at 96 (dQ 16 x 16, 41 KB; dK/dV 64 x 64, 182 KB).
// GPT-Neo's local layers send a [B, 1, Q, K] band bias with causal = 0, so
// every key tile is visited and those before the band weigh zero.
// At D = 256:
//  - dQ tile: the dQ accumulator is 64 x 256 f32, 128 registers a thread
//    (four 64-column chunks, one m64n64k16 product each over one K atom);
//    Q, dO, O and the 2-stage K/V ring are 7 tiles of 32 KB, 225 KB with
//    the alignment slack, under the 227 KB a CTA may use: one CTA per SM,
//    up to 255 registers. S and dP take 16 k-steps each.
//  - dK/dV tile: dK and dV together would be 256 registers a thread, which
//    no warpgroup has, so the CTA is two warpgroups (256 threads), each
//    holding one 64 x 256 accumulator: warpgroup 0 computes S^T and P^T and
//    accumulates dV += P^T dO; warpgroup 1 computes S^T and P^T again, and
//    dP^T, and accumulates dK += dS^T Q (the same products, hi + lo
//    fragments, as at D = 64). K, V and one stage of Q, dO and O are 160
//    KB, so Q, dO and O go through one stage; delta is taken by 4 threads
//    a row.
//  - fma: 16-row query tiles (dQ) or 16-key tiles and 16-row query chunks
//    (dK/dV), and 32-key chunks (dQ), keep the padded f32 tiles at 113 KB
//    and 82 KB; the visit rule is the forward's, whatever the CTA's tile.

#include <math.h>

#include <initializer_list>

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

constexpr int kThreads = 256;  // 16 x 16 threads

// dQ: query rows per CTA for a forward tile of fwd_bq rows (the tile itself
// at D = 16, 32 and 64, 16 at D = 24, 96, 128 and 256) and keys per staged
// chunk (64 at D = 16, 32 and 64, 16 at 24, 96 and 128, 32 at 256). ptxas picks the
// register count of these kernels itself (40-128) and spilled in one of
// the four instantiations (16-row or 64-row forward tile, with or without
// dbias) at D = 96 with 64 or 32 rows and 32 or 64 keys (16-48 bytes), and
// at D = 24 with 64 rows or 64 keys (8-32 bytes); 16 x 16 builds all four
// without a spill at both.
template <int D>
__host__ __device__ constexpr int dq_fma_rows(int fwd_bq) {
  return per_head_dim<D>(fwd_bq, 16, fwd_bq, fwd_bq, 16, 16, 16);
}
template <int D>
__host__ __device__ constexpr int dq_fma_keys() { return per_head_dim<D>(64, 16, 64, 64, 16, 16, 32); }
// dK/dV: keys per CTA and query rows per chunk (64 at D <= 128, 16 at
// D = 256)
template <int D>
__host__ __device__ constexpr int dkv_fma_tile() { return per_head_dim<D>(64, 64, 64, 64, 64, 64, 16); }

// Stage rows [r0, r0 + n) of a [B, T, H, D] tensor (already offset to its
// batch row and head) into a [n][D + 1] tile; rows at or past T are 0.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long st, int r0, int n,
                                          int T_len) {
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = r0 + r;
    dst[r * (D + 1) + d] = t < T_len ? src[t * st + d] : 0.f;
  }
}

// delta[r] = sum_d dO[r][d] * O[r][d] for the n staged rows, and the rows'
// LSE (0 for rows past Q, whose P is forced to 0).
template <int D>
__device__ __forceinline__ void row_stats(float* Ds, float* Ls,
                                          const float* dOs, const float* Os,
                                          const float* lse_row, int q0, int n,
                                          int Q) {
  for (int r = threadIdx.x; r < n; r += kThreads) {
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) acc = fmaf(dOs[r * (D + 1) + d], Os[r * (D + 1) + d], acc);
    Ds[r] = acc;
    Ls[r] = q0 + r < Q ? lse_row[q0 + r] : 0.f;
  }
}

// S = Q K^T and dP = dO V^T for this thread's RQ rows x JK keys (keys
// tx + 16 j of the staged tile).
template <int D, int RQ, int JK>
__device__ __forceinline__ void scores(float (&s)[RQ][JK], float (&dp)[RQ][JK],
                                       const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       int tx, int ty) {
  constexpr int kLD = D + 1;
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < JK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float kv[JK], vv[JK];
#pragma unroll
    for (int j = 0; j < JK; ++j) {
      kv[j] = Ks[(tx + 16 * j) * kLD + d];
      vv[j] = Vs[(tx + 16 * j) * kLD + d];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const float qv = Qs[(ty * RQ + i) * kLD + d];
      const float dov = dOs[(ty * RQ + i) * kLD + d];
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        s[i][j] = fmaf(qv, kv[j], s[i][j]);
        dp[i][j] = fmaf(dov, vv[j], dp[i][j]);
      }
    }
  }
}

template <int D, int BQ>
__host__ __device__ constexpr size_t dq_fma_smem() {
  constexpr int KC = dq_fma_keys<D>();
  constexpr int kDs = BQ * (D + 1) > BQ * (KC + 1) ? BQ * (D + 1) : BQ * (KC + 1);
  return sizeof(float) * ((2 * BQ + 2 * KC) * (D + 1) + kDs + 2 * BQ);
}

// dQ: one block per (query tile of BQ = dq_fma_rows<D>(FwdBQ) rows, head,
// batch row), FwdBQ being the forward's query tile (the visit rule); with
// kDbias also dbias = dS for the block's rows (unscaled: the bias is added
// after the scale), into a contiguous [B, H, Q, K] f32 tensor
template <int D, int FwdBQ, bool kDbias>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ bias,
                        const float* __restrict__ o, const float* __restrict__ dout,
                        const float* __restrict__ lse, float* __restrict__ dq,
                        float* __restrict__ dbias,
                        int H, int Q, int K, Strides sq, Strides sk, Strides sv,
                        Strides so, Strides sdo, BiasStrides sb, float scale,
                        int causal) {
  constexpr int BQ = dq_fma_rows<D>(FwdBQ);
  constexpr int KC = dq_fma_keys<D>();
  constexpr int kLD = D + 1;   // padded row stride of the Q/K/V/dO/O tiles
  constexpr int kLS = KC + 1;  // padded row stride of the dS tile
  constexpr int RQ = BQ / 16;  // query rows per thread
  constexpr int JK = KC / 16;  // keys per thread
  constexpr int JD = (D + 15) / 16;  // dQ columns per thread (the last partial at D = 24)
  constexpr bool kRagged = D % 16 != 0;
  constexpr int kDs = BQ * kLD > BQ * kLS ? BQ * kLD : BQ * kLS;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][kLD]
  float* dOs = Qs + BQ * kLD;    // [BQ][kLD]
  float* Ks = dOs + BQ * kLD;    // [KC][kLD]
  float* Vs = Ks + KC * kLD;     // [KC][kLD]
  float* dSs = Vs + KC * kLD;    // [BQ][kLS]; holds O ([BQ][kLD]) until delta is taken
  float* Ls = dSs + kDs;         // [BQ]
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

  load_tile<D>(Qs, q + b * sq.b + h * sq.h, sq.t, q0, BQ, Q);
  load_tile<D>(dOs, dout + b * sdo.b + h * sdo.h, sdo.t, q0, BQ, Q);
  load_tile<D>(dSs, o + b * so.b + h * so.h, so.t, q0, BQ, Q);
  __syncthreads();
  row_stats<D>(Ds, Ls, dOs, dSs, lse + (static_cast<long long>(b) * H + h) * Q,
               q0, BQ, Q);

  float acc[RQ][JD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < JD; ++j) acc[i][j] = 0.f;

  // causal: the key tiles the forward visited for this query tile (FwdBQ
  // is a template argument here: taken at run time, ptxas spilled 12 bytes
  // at D = 64)
  const int k_end = visit_end(q0, FwdBQ, K, causal);
  for (int k0 = 0; k0 < k_end; k0 += KC) {
    __syncthreads();  // previous chunk's K/dS reads (and the O reads) are done
    load_tile<D>(Ks, kb, sk.t, k0, KC, k_end);
    load_tile<D>(Vs, vb, sv.t, k0, KC, k_end);
    __syncthreads();

    float s[RQ][JK], dp[RQ][JK];
    scores<D, RQ, JK>(s, dp, Qs, dOs, Ks, Vs, tx, ty);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i;
      const int qi = q0 + r;
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        const int kj = k0 + tx + 16 * j;
        float p = 0.f;  // padded rows and keys past the visited ones carry no weight
        if (qi < Q && kj < k_end)
          p = expf(logit(s[i][j], scale, biasb, sb, qi, kj, causal) - Ls[r]);
        const float ds = p * (dp[i][j] - Ds[r]);
        dSs[r * kLS + tx + 16 * j] = ds;
        if (kDbias && qi < Q && kj < K)
          dbias[((static_cast<long long>(b) * H + h) * Q + qi) * K + kj] = ds;
      }
    }
    __syncthreads();  // dS complete

#pragma unroll 8
    for (int c = 0; c < KC; ++c) {
      float kv[JD];
#pragma unroll
      for (int j = 0; j < JD; ++j)
        kv[j] = !kRagged || tx + 16 * j < D ? Ks[c * kLD + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float ds = dSs[(ty * RQ + i) * kLS + c];
#pragma unroll
        for (int j = 0; j < JD; ++j) acc[i][j] = fmaf(ds, kv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + ty * RQ + i;
    if (qi >= Q) continue;
    float* row = dq + ((static_cast<long long>(b) * Q + qi) * H + h) * D;
#pragma unroll
    for (int j = 0; j < JD; ++j)
      if (!kRagged || tx + 16 * j < D) row[tx + 16 * j] = acc[i][j] * scale;
  }
}

template <int D>
__host__ __device__ constexpr size_t dkv_fma_smem() {
  constexpr int KT = dkv_fma_tile<D>(), QC = dkv_fma_tile<D>();
  constexpr int kPs = QC * (D + 1) > QC * (KT + 1) ? QC * (D + 1) : QC * (KT + 1);
  return sizeof(float) * ((2 * KT + 2 * QC) * (D + 1) + kPs + QC * (KT + 1) + 2 * QC);
}

// dK, dV: one block per (tile of KT keys, head, batch row), looping over
// chunks of QC query rows
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ bias,
                         const float* __restrict__ o, const float* __restrict__ dout,
                         const float* __restrict__ lse, float* __restrict__ dk,
                         float* __restrict__ dv, int H, int Q, int K, Strides sq,
                         Strides sk, Strides sv, Strides so, Strides sdo,
                         BiasStrides sb, float scale, int causal) {
  constexpr int KT = dkv_fma_tile<D>();  // keys per block
  constexpr int QC = dkv_fma_tile<D>();  // query rows per chunk
  constexpr int kLD = D + 1;             // padded row stride of Q/K/V/dO/O
  constexpr int kLP = KT + 1;            // padded row stride of the P/dS tiles
  constexpr int RQ = QC / 16;            // query rows per thread in the score phase
  constexpr int JK = KT / 16;            // keys per thread (both phases)
  constexpr int JD = (D + 15) / 16;      // head-dim columns per thread (the last partial at 24)
  constexpr bool kRagged = D % 16 != 0;
  constexpr int kPs = QC * kLD > QC * kLP ? QC * kLD : QC * kLP;
  extern __shared__ float smem[];
  float* Ks = smem;              // [KT][kLD]
  float* Vs = Ks + KT * kLD;     // [KT][kLD]
  float* Qs = Vs + KT * kLD;     // [QC][kLD]
  float* dOs = Qs + QC * kLD;    // [QC][kLD]
  float* Ps = dOs + QC * kLD;    // [QC][kLP]; holds O ([QC][kLD]) until delta is taken
  float* dSs = Ps + kPs;         // [QC][kLP]
  float* Ls = dSs + QC * kLP;    // [QC]
  float* Ds = Ls + QC;           // [QC]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * KT;
  // the forward's 64-key tile holding this block's keys: row qi visited it
  // iff qi >= k_tile (both forward query tiles divide 64)
  const int k_tile = k0 / kBK * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* ob = o + b * so.b + h * so.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* lse_row = lse + (static_cast<long long>(b) * H + h) * Q;
  const float* biasb = bias ? bias + b * sb.b + h * sb.h : nullptr;

  load_tile<D>(Ks, k + b * sk.b + h * sk.h, sk.t, k0, KT, K);
  load_tile<D>(Vs, v + b * sv.b + h * sv.h, sv.t, k0, KT, K);

  // this thread accumulates keys k0 + ty * JK + i, head dims tx + 16 j
  float dk_acc[JK][JD], dv_acc[JK][JD];
#pragma unroll
  for (int i = 0; i < JK; ++i)
#pragma unroll
    for (int j = 0; j < JD; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int q0 = 0; q0 < Q; q0 += QC) {
    // causal: the chunk is live iff its last row visited this key tile
    // (block-uniform)
    if (causal && min(q0 + QC, Q) - 1 < k_tile) continue;
    __syncthreads();  // previous chunk's reads (and the K/V stores) are done
    load_tile<D>(Qs, qb, sq.t, q0, QC, Q);
    load_tile<D>(dOs, dob, sdo.t, q0, QC, Q);
    load_tile<D>(Ps, ob, so.t, q0, QC, Q);
    __syncthreads();
    row_stats<D>(Ds, Ls, dOs, Ps, lse_row, q0, QC, Q);
    __syncthreads();  // delta taken: Ps is free for P

    float s[RQ][JK], dp[RQ][JK];
    scores<D, RQ, JK>(s, dp, Qs, dOs, Ks, Vs, tx, ty);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i;
      const int qi = q0 + r;
      const bool visits = qi < Q && (!causal || qi >= k_tile);
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        const int c = tx + 16 * j;
        const int kj = k0 + c;
        float p = 0.f;
        if (visits && kj < K)
          p = expf(logit(s[i][j], scale, biasb, sb, qi, kj, causal) - Ls[r]);
        Ps[r * kLP + c] = p;
        dSs[r * kLP + c] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();  // P and dS complete

#pragma unroll 4
    for (int r = 0; r < QC; ++r) {
      float dov[JD], qv[JD];
#pragma unroll
      for (int j = 0; j < JD; ++j) {
        const bool in = !kRagged || tx + 16 * j < D;
        dov[j] = in ? dOs[r * kLD + tx + 16 * j] : 0.f;
        qv[j] = in ? Qs[r * kLD + tx + 16 * j] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < JK; ++i) {
        const float p = Ps[r * kLP + ty * JK + i];
        const float ds = dSs[r * kLP + ty * JK + i];
#pragma unroll
        for (int j = 0; j < JD; ++j) {
          dv_acc[i][j] = fmaf(p, dov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(ds, qv[j], dk_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < JK; ++i) {
    const int kj = k0 + ty * JK + i;
    if (kj >= K) continue;
    const long long off = ((static_cast<long long>(b) * K + kj) * H + h) * D;
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      if (kRagged && tx + 16 * j >= D) continue;
      dk[off + tx + 16 * j] = dk_acc[i][j] * scale;
      dv[off + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// tile: bf16, tensor cores (wgmma.m64n64k16)
// ---------------------------------------------------------------------------

// CTAs per SM in the launch bounds. At D = 64 dQ fits 168 registers (3
// CTAs); at D = 16, 24 and 32 its dbias instantiation spilled 8 bytes at
// that cap, so it takes 2 CTAs (up to 255 registers; 174-176 used); dK/dV holds two f32 accumulators and P, dS (hi + lo) at once and
// spilled at 168 in every arrangement tried, so it takes 2 CTAs and up to
// 255 registers. At D = 96 and 128 dQ's 113 KB of shared memory allow 2
// CTAs (up to 255 registers) and dK/dV's two warpgroups take up to 255
// registers, one CTA per SM. At D = 256 each is one CTA per SM (shared memory bounds it)
// with up to 255 registers a thread.
template <int D>
__host__ __device__ constexpr int dq_min_blocks() { return per_head_dim<D>(2, 2, 2, 3, 2, 2, 1); }
template <int D>
__host__ __device__ constexpr int dkv_min_blocks() { return per_head_dim<D>(2, 2, 2, 2, 1, 1, 1); }
// dK/dV: one warpgroup holding both accumulators at D <= 64, two (one per
// accumulator) at D = 96, 128 and 256
template <int D>
__host__ __device__ constexpr bool dkv_split() {
  return per_head_dim<D>(false, false, false, false, true, true, true);
}
template <int D>
__host__ __device__ constexpr int dkv_threads() { return dkv_split<D>() ? 2 * kTileThreads : kTileThreads; }
// dynamic shared memory: the tiles, and 1 KB of slack to align them to the
// 1024 bytes the 128-byte swizzle repeats over
template <int D>
__host__ __device__ constexpr int dq_smem() { return 7 * tile_bytes<D>() + 1024; }  // Q, dO, O, K[2], V[2]
// dK/dV's tiles: K, V and (Q, dO, O) in 2 stages at D <= 64, in 1 at D = 96,
// 128 and 256
template <int D>
__host__ __device__ constexpr int dkv_tiles() { return per_head_dim<D>(8, 8, 8, 8, 5, 5, 5); }
template <int D>
__host__ __device__ constexpr int dkv_smem() {  // the tiles, LSE, delta
  return dkv_tiles<D>() * tile_bytes<D>() + 2 * kBQ * static_cast<int>(sizeof(float)) + 1024;
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

// d = X Y^T for 64 x D bf16 tiles X, Y [row][d] in shared memory, issued
// (not committed) as kmajor_steps<D>() wgmmas
template <int D>
__device__ __forceinline__ void product(float (&d)[8][4], uint32_t x, uint32_t y) {
  zero(d);
  fence_registers(d);
  wgmma_fence();
  const TileDesc<D> dx(x), dy(y);
#pragma unroll
  for (int ks = 0; ks < kmajor_steps<D>(); ++ks)
    wgmma_ss(d, dx.kstep(ks), dy.kstep(ks), ks > 0);
}

// acc[n] += A B[:, 64 n .. 64 n + 63] over the 4 k-steps of a 64-row B
// tile [k][d] (MN-major), A as register fragments a[ks]
template <int N>
__device__ __forceinline__ void accumulate_mn(float (&acc)[N][8][4],
                                              const uint32_t (&a)[4][4], uint32_t b) {
  const TileDesc<64 * N> db(b);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int n = 0; n < N; ++n) wgmma_rs_mn(acc[n], a[ks], db.mn(n, ks));
}

// dQ: one warpgroup per (64-row query tile, head, batch row); warp w owns
// rows 16 w .. 16 w + 15, each thread rows g and g + 8 of them. With
// kDbias it also stores dbias = dS (f32, unscaled) from the accumulator
// fragments into a contiguous [B, H, Q, K] tensor; without it the code is
// PR 4's (the store is compiled out).
template <int D, bool kDbias>
__global__ void __launch_bounds__(kTileThreads, dq_min_blocks<D>())
flash_bwd_dq_tile_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ bias,
                         const bf16* __restrict__ o, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, bf16* __restrict__ dq,
                         float* __restrict__ dbias,
                         int H, int Q, int K, Strides sq, Strides sk, Strides sv,
                         Strides so, Strides sdo, BiasStrides sb, float scale,
                         int causal) {
  constexpr int kTB = tile_bytes<D>();
  constexpr int kN = tile_cols<D>() / 64;  // 64-column chunks of dQ (the last padded at D != 64, 256)
  // delta's 16-byte chunks per thread of a row's quad: D / 32 of the real
  // ones where that is whole; at D = 16 and 24 two each, over the whole
  // atom, whose padded chunks are zero in dO and O
  constexpr int kDeltaChunks = D % 32 == 0 ? D / 32 : tile_cols<D>() / 32;
  extern __shared__ uint8_t smem_raw[];
  uint32_t sQ;
  const uint8_t* smem = aligned_smem(smem_raw, sQ);
  const uint32_t sdO = sQ + kTB, sO = sQ + 2 * kTB;
  const uint32_t sK0 = sQ + 3 * kTB, sV0 = sQ + 5 * kTB;

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
  const int k_end = visit_end(q0, kBQ, K, causal);
  const int n_tiles = (k_end + kBK - 1) / kBK;

  load_tile_async<D>(sQ, q + b * sq.b + h * sq.h, sq.t, q0, Q);
  load_tile_async<D>(sdO, dout + b * sdo.b + h * sdo.h, sdo.t, q0, Q);
  load_tile_async<D>(sO, o + b * so.b + h * so.h, so.t, q0, Q);
  load_tile_async<D>(sK0, kb, sk.t, 0, K);
  load_tile_async<D>(sV0, vb, sv.t, 0, K);
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
  float acc[kN][8][4];
  zero(acc);

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    const int k0 = t * kBK;
    if (t + 1 < n_tiles) {  // prefetch the next tile into the other stage
      load_tile_async<D>(sK0 + (buf ^ 1) * kTB, kb, sk.t, k0 + kBK, K);
      load_tile_async<D>(sV0 + (buf ^ 1) * kTB, vb, sv.t, k0 + kBK, K);
    }
    cp_async_commit();  // possibly empty: keeps one group per iteration
    cp_async_wait<1>();  // everything up to this tile has landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t sK = sK0 + buf * kTB;
    const uint32_t sV = sV0 + buf * kTB;

    if (t == 0) {
      // delta of this thread's two rows: kDeltaChunks chunks each, summed
      // over the quad
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = warp * 16 + g + 8 * hr;
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < kDeltaChunks; ++i) {
          const int ch = kDeltaChunks * t4 + i;
          d = dot8(smem + (sdO - sQ) + tile_offset(r, ch), smem + (sO - sQ) + tile_offset(r, ch), d);
        }
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        delta[hr] = d + __shfl_xor_sync(0xffffffffu, d, 2);
      }
    }

    // S = Q K^T and dP = dO V^T as two wgmma groups; P is formed while
    // the second runs
    float s[8][4], dp[8][4];
    product<D>(s, sQ, sK);
    wgmma_commit();
    product<D>(dp, sdO, sV);
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
    accumulate_mn(acc, da, sK);
    wgmma_commit_and_wait();
    fence_registers(acc);
    __syncthreads();  // this stage is read; the next iteration refills it
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (qi[hr] >= Q) continue;
    bf16* row = dq + ((static_cast<long long>(b) * Q + qi[hr]) * H + h) * D;
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (64 * n + 8 * j < D)  // the tile's padded columns are dropped
          *reinterpret_cast<uint32_t*>(row + 64 * n + 8 * j + 2 * t4) =
              pack_bf16(acc[n][j][2 * hr] * scale, acc[n][j][2 * hr + 1] * scale);
  }
}

// P^T of a chunk in place on the S^T = K Q^T accumulator of keys kr[2]
// (this thread's) and the chunk's queries (accumulator columns): logit()'s
// sum in its order, formed for every element (a padded row reads row Q -
// 1's bias) and then selected, no branch per element. Padded rows, keys
// past K and rows that did not visit the key tile at k_tile carry no
// weight. LSE is read by column from sL.
__device__ __forceinline__ void probabilities_t(float (&s)[8][4], const int (&kr)[2],
                                                const float* const (&bcol)[2],
                                                const float* sL, BiasStrides sb,
                                                float scale, int causal, int q0,
                                                int k_tile, int Q, int K, int t4) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * t4 + (e & 1);
      const int qi = q0 + col;
      const int kj = kr[e >> 1];
      float x = s[j][e] * scale;
      if (bcol[e >> 1]) x += bcol[e >> 1][min(qi, Q - 1) * sb.q];
      if (causal && kj > qi) x += kNegInf;
      const bool in = qi < Q && kj < K && (!causal || qi >= k_tile);
      s[j][e] = in ? __expf(x - sL[col]) : 0.f;
    }
}

// dK, dV at D <= 64: one warpgroup per (64-key tile, head, batch row); the
// accumulators hold keys as rows (warp w keys 16 w .. 16 w + 15, each
// thread keys g and g + 8 of them) and the chunk's queries as columns. A
// 64 x D tile is one atom (padded below D = 64); delta sums the atom's 8
// chunks, the padded ones zero in dO and O, and the accumulators' columns
// D..63 are dropped at the store.
template <int D>
__device__ __forceinline__ void dkv_tile_joint(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ bias,
    const bf16* __restrict__ o, const bf16* __restrict__ dout,
    const float* __restrict__ lse, bf16* __restrict__ dk, bf16* __restrict__ dv,
    int H, int Q, int K, Strides sq, Strides sk, Strides sv, Strides so,
    Strides sdo, BiasStrides sb, float scale, int causal) {
  constexpr int kTB = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  uint32_t sK;
  uint8_t* smem = aligned_smem(smem_raw, sK);
  const uint32_t sV = sK + kTB;
  const uint32_t sChunk0 = sK + 2 * kTB;  // stage s: Q, dO, O at + 3 s tiles
  float* sL = reinterpret_cast<float*>(smem + 8 * kTB);  // the chunk's LSE
  float* sD = sL + kBQ;                                  // and delta

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
    load_tile_async<D>(dst, qb, sq.t, q0, Q);
    load_tile_async<D>(dst + kTB, dob, sdo.t, q0, Q);
    load_tile_async<D>(dst + 2 * kTB, ob, so.t, q0, Q);
  };
  if (c_begin < n_chunks) {
    load_tile_async<D>(sK, k + b * sk.b + h * sk.h, sk.t, k0, K);
    load_tile_async<D>(sV, v + b * sv.b + h * sv.h, sv.t, k0, K);
    load_chunk(sChunk0, c_begin * kBQ);
    cp_async_commit();
  }

  for (int c = c_begin; c < n_chunks; ++c) {
    const int buf = (c - c_begin) & 1;
    const int q0 = c * kBQ;
    const uint32_t sQ = sChunk0 + buf * 3 * kTB;
    const uint32_t sdO = sQ + kTB, sO = sQ + 2 * kTB;
    if (c + 1 < n_chunks)  // prefetch the next chunk into the other stage
      load_chunk(sChunk0 + (buf ^ 1) * 3 * kTB, q0 + kBQ);
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
    product<D>(s, sK, sQ);
    wgmma_commit_and_wait();
    fence_registers(s);
    probabilities_t(s, kr, bcol, sL, sb, scale, causal, q0, k0, Q, K, t4);
    product<D>(dp, sV, sdO);
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
    const long long off = ((static_cast<long long>(b) * K + kr[hr]) * H + h) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (8 * j >= D) continue;  // the tile's padded columns are dropped
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j + 2 * t4) =
          pack_bf16(dk_acc[j][2 * hr] * scale, dk_acc[j][2 * hr + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j + 2 * t4) =
          pack_bf16(dv_acc[j][2 * hr], dv_acc[j][2 * hr + 1]);
    }
  }
}

// dK, dV at D = 96, 128 and 256: two warpgroups per (64-key tile, head, batch row),
// each with one 64 x D accumulator, keys as rows: warpgroup 0 dV += P^T dO,
// warpgroup 1 dK += dS^T Q; both form P^T from their own S^T = K Q^T. K
// and V are staged once; Q, dO and O go through one stage per 64-row chunk.
template <int D>
__device__ __forceinline__ void dkv_tile_split(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ bias,
    const bf16* __restrict__ o, const bf16* __restrict__ dout,
    const float* __restrict__ lse, bf16* __restrict__ dk, bf16* __restrict__ dv,
    int H, int Q, int K, Strides sq, Strides sk, Strides sv, Strides so,
    Strides sdo, BiasStrides sb, float scale, int causal) {
  constexpr int kTB = tile_bytes<D>();
  constexpr int kN = tile_cols<D>() / 64;  // 64-column chunks of the accumulator
  constexpr int kT = 2 * kTileThreads;
  extern __shared__ uint8_t smem_raw[];
  uint32_t sK;
  uint8_t* smem = aligned_smem(smem_raw, sK);
  const uint32_t sV = sK + kTB, sQ = sK + 2 * kTB;
  const uint32_t sdO = sK + 3 * kTB, sO = sK + 4 * kTB;
  float* sL = reinterpret_cast<float*>(smem + 5 * kTB);  // the chunk's LSE
  float* sD = sL + kBQ;                                  // and delta

  const int tid = threadIdx.x;
  const int wg = tid / kTileThreads;  // 0: dV, 1: dK
  const int warp = (tid % kTileThreads) >> 5, lane = tid & 31;
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

  // causal: row qi visited this key tile iff qi >= k0 (block-uniform)
  const int c_begin = causal ? min(k0 / kBQ, n_chunks) : 0;

  int kr[2];
  const float* bcol[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    kr[hr] = k0 + warp * 16 + g + 8 * hr;
    bcol[hr] = biasb ? biasb + min(kr[hr], K - 1) * sb.k : nullptr;
  }
  float acc[kN][8][4];
  zero(acc);

  if (c_begin < n_chunks) {  // committed with the first chunk
    load_tile_async<D, kT>(sK, k + b * sk.b + h * sk.h, sk.t, k0, K);
    load_tile_async<D, kT>(sV, v + b * sv.b + h * sv.h, sv.t, k0, K);
  }

  for (int c = c_begin; c < n_chunks; ++c) {
    const int q0 = c * kBQ;
    load_tile_async<D, kT>(sQ, qb, sq.t, q0, Q);
    load_tile_async<D, kT>(sdO, dob, sdo.t, q0, Q);
    load_tile_async<D, kT>(sO, ob, so.t, q0, Q);
    cp_async_commit();
    // row sr's delta over 4 threads (D / 32 chunks each), its LSE by the
    // second of them; the LSE read goes out before the wait
    const int sr = tid >> 2, part = tid & 3;
    const float lse_r = part == 1 && q0 + sr < Q ? lse_row[q0 + sr] : 0.f;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      const int ch = D / 32 * part + i;
      d = dot8(smem + (sdO - sK) + tile_offset(sr, ch), smem + (sO - sK) + tile_offset(sr, ch), d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (part == 0)
      sD[sr] = d;
    else if (part == 1)
      sL[sr] = lse_r;
    __syncthreads();

    // S^T = K Q^T and P^T, in both warpgroups
    float s[8][4];
    product<D>(s, sK, sQ);
    wgmma_commit_and_wait();
    fence_registers(s);
    probabilities_t(s, kr, bcol, sL, sb, scale, causal, q0, k0, Q, K, t4);
    if (wg == 0) {
      // dV += P^T dO, P^T as hi + lo fragments
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) split_fragment(p_hi[ks], p_lo[ks], s, ks);
      fence_registers(acc);
      wgmma_fence();
      accumulate_mn(acc, p_hi, sdO);
      accumulate_mn(acc, p_lo, sdO);
      wgmma_commit_and_wait();
      fence_registers(acc);
    } else {
      // dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q
      float dp[8][4];
      product<D>(dp, sV, sdO);
      wgmma_commit_and_wait();
      fence_registers(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = s[j][e] * (dp[j][e] - sD[8 * j + 2 * t4 + (e & 1)]);
      uint32_t ds_hi[4][4], ds_lo[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) split_fragment(ds_hi[ks], ds_lo[ks], dp, ks);
      fence_registers(acc);
      wgmma_fence();
      accumulate_mn(acc, ds_hi, sQ);
      accumulate_mn(acc, ds_lo, sQ);
      wgmma_commit_and_wait();
      fence_registers(acc);
    }
    __syncthreads();  // the stage and sL/sD are read; the next chunk refills them
  }

  bf16* out = wg == 0 ? dv : dk;
  const float out_scale = wg == 0 ? 1.f : scale;  // dK is scaled once, at emit
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (kr[hr] >= K) continue;
    const long long off = ((static_cast<long long>(b) * K + kr[hr]) * H + h) * D;
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (64 * n + 8 * j < D)  // the tile's padded columns are dropped
          *reinterpret_cast<uint32_t*>(out + off + 64 * n + 8 * j + 2 * t4) = pack_bf16(
              acc[n][j][2 * hr] * out_scale, acc[n][j][2 * hr + 1] * out_scale);
  }
}

template <int D>
__global__ void __launch_bounds__(dkv_threads<D>(), dkv_min_blocks<D>())
flash_bwd_dkv_tile_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ bias,
                          const bf16* __restrict__ o, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int H, int Q, int K, Strides sq,
                          Strides sk, Strides sv, Strides so, Strides sdo,
                          BiasStrides sb, float scale, int causal) {
  if constexpr (!dkv_split<D>())
    dkv_tile_joint<D>(q, k, v, bias, o, dout, lse, dk, dv, H, Q, K, sq, sk, sv, so,
                      sdo, sb, scale, causal);
  else
    dkv_tile_split<D>(q, k, v, bias, o, dout, lse, dk, dv, H, Q, K, sq, sk, sv, so,
                      sdo, sb, scale, causal);
}

// ---------------------------------------------------------------------------
// split3: f32 through three bf16 planes on the tensor cores (the ring's blocks)
// ---------------------------------------------------------------------------

// Q's and dO's planes (dQ) or K's and V's (dK/dV) stay staged across the
// loop but at D = 256, where the four operands' planes would be 384 KB:
// there two slots of three plane tiles (192 KB) take each operand in turn.
template <int D>
__host__ __device__ constexpr bool split3_resident() {
  return per_head_dim<D>(true, true, true, true, true, true, false);
}
template <int D>
__host__ __device__ constexpr int split3_slots() { return split3_resident<D>() ? 4 : 2; }
// dQ: 97 KB at D <= 64 (2 CTAs per SM), 193 KB at D = 96, 128 and 256
template <int D>
__host__ __device__ constexpr int dq_split3_min_blocks() { return per_head_dim<D>(2, 2, 2, 2, 1, 1, 1); }
template <int D>
__host__ __device__ constexpr int dq_split3_smem() {
  return 3 * split3_slots<D>() * tile_bytes<D>() + 1024;
}
template <int D>
__host__ __device__ constexpr int dkv_split3_smem() {  // the slots, LSE, delta
  return 3 * split3_slots<D>() * tile_bytes<D>() + 2 * kBQ * static_cast<int>(sizeof(float)) + 1024;
}

// sum over columns part, part + parts, ... of D of x[c] * y[c] (f32)
template <int D>
__device__ __forceinline__ float strided_dot(const float* x, const float* y, int part,
                                             int parts) {
  float d = 0.f;
  for (int c = part; c < D; c += parts) d = fmaf(x[c], y[c], d);
  return d;
}

// dQ on f32 q, k, v and dO given as their bf16 planes (q and dO [B, Q, H,
// D], k and v [B, K, H, D], contiguous, plane p at p times the tensor's size;
// csrc/split_planes.cu), o and dO also as f32 [B, Q, H, D] through strides
// for delta: one warpgroup per (64-row query tile, head, batch row), as the
// tile variant. Each key tile that is not dead (dead_tile: the bias each
// thread reads, and every row's LSE above NEG_INF / 2) runs S and dP as the sums
// of their plane products, P = exp(S - LSE) (expf), dS = P (dP - delta) in
// f32, and dQ += dS K with dS as three register fragments. No causal flag.
template <int D>
__global__ void __launch_bounds__(kTileThreads, dq_split3_min_blocks<D>())
flash_bwd_dq_split3_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout3,
                           const float* __restrict__ bias, const float* __restrict__ o,
                           const float* __restrict__ dout, const float* __restrict__ lse,
                           float* __restrict__ dq, int H, int Q, int K, Strides so,
                           Strides sdo, BiasStrides sb, float scale) {
  constexpr int kTB = tile_bytes<D>();
  constexpr bool kRes = split3_resident<D>();
  extern __shared__ uint8_t smem_raw[];
  uint32_t sQ;
  aligned_smem(smem_raw, sQ);
  // Q, dO, K, V; at D = 256 slot A (Q, then dO) and slot B (K, then V, then K)
  const uint32_t sdO = kRes ? sQ + 3 * kTB : sQ;
  const uint32_t sK = sQ + (kRes ? 6 : 3) * kTB;
  const uint32_t sV = kRes ? sK + 3 * kTB : sK;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y / split3_chunks<D>();
  const int chunk = blockIdx.y % split3_chunks<D>();  // dQ's columns 64 chunk .. + 63
  const int b = blockIdx.z;
  const int n_tiles = (K + kBK - 1) / kBK;

  // the planes' strides: row H D, batch row T H D, plane B T H D
  const long long st = static_cast<long long>(H) * D;
  const long long pq = st * Q * gridDim.z, pk = st * K * gridDim.z;
  const bf16* qb = q + b * st * Q + h * D;
  const bf16* dob = dout3 + b * st * Q + h * D;
  const bf16* kb = k + b * st * K + h * D;
  const bf16* vb = v + b * st * K + h * D;
  if constexpr (kRes) {
    load_planes_async<D>(sQ, qb, pq, st, q0, Q);
    load_planes_async<D>(sdO, dob, pq, st, q0, Q);
    cp_async_commit();
  }

  // this thread's rows, their LSE, delta (over the quad) and bias rows
  int qi[2];
  float lse_r[2], delta[2];
  const float* brow[2];
  const float* lse_row = lse + (static_cast<long long>(b) * H + h) * Q;
  bool rows_live = true;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    qi[hr] = q0 + warp * 16 + g + 8 * hr;
    const bool in = qi[hr] < Q;
    lse_r[hr] = in ? lse_row[qi[hr]] : 0.f;
    rows_live = rows_live && (!in || lse_r[hr] > 0.5f * kNegInf);
    brow[hr] = bias ? bias + b * sb.b + h * sb.h + min(qi[hr], Q - 1) * sb.q : nullptr;
    float d = in ? strided_dot<D>(dout + b * sdo.b + qi[hr] * sdo.t + h * sdo.h,
                                  o + b * so.b + qi[hr] * so.t + h * so.h, t4, 4)
                 : 0.f;
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    delta[hr] = d + __shfl_xor_sync(0xffffffffu, d, 2);
  }
  float acc[8][4];
  zero(acc);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    // the bias of this thread's 32 pairs (a key past K reads key K - 1's)
    // and the dead-tile vote on it (its barriers order the copies)
    float bv[8][4];
    bool live = false;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + 8 * j + 2 * t4 + (e & 1), hr = e >> 1;
        bv[j][e] = brow[hr] ? brow[hr][min(kj, K - 1) * sb.k] : 0.f;
        live |= qi[hr] < Q && live_pair(bv[j][e], kj, K);
      }
    if (brow[0] && dead_tile(live, rows_live)) continue;
    if constexpr (!kRes) load_planes_async<D>(sQ, qb, pq, st, q0, Q);
    load_planes_async<D>(sK, kb, pk, st, k0, K);
    if constexpr (kRes) load_planes_async<D>(sV, vb, pk, st, k0, K);
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();

    // S and (with the operands staged) dP as two wgmma groups; P is formed
    // while the second runs
    float s[8][4], dp[8][4];
    product3<D>(s, sQ, sK);
    wgmma_commit();
    if constexpr (kRes) {
      product3<D>(dp, sdO, sV);
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_registers(s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const int kj = k0 + 8 * j + 2 * t4 + (e & 1);
        float x = s[j][e] * scale;
        if constexpr (split3_keep_bias<D>())
          x += bv[j][e];
        else if (brow[hr])
          x += brow[hr][min(kj, K - 1) * sb.k];
        s[j][e] = qi[hr] < Q && kj < K ? expf(x - lse_r[hr]) : 0.f;
      }
    if constexpr (!kRes) {
      __syncthreads();  // every warp's S has read Q and K
      load_planes_async<D>(sdO, dob, pq, st, q0, Q);
      load_planes_async<D>(sV, vb, pk, st, k0, K);
      cp_async_commit();
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
      product3<D>(dp, sdO, sV);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_registers(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - delta[e >> 1]);
    if constexpr (!kRes) {
      __syncthreads();  // every warp's dP has read dO and V
      load_planes_async<D>(sK, kb, pk, st, k0, K);
      cp_async_commit();
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
    }

    // dQ += dS K: dS (f32) as bf16 fragments of its three planes, K's
    // planes MN-major (this CTA's chunk of them)
    accumulate_planes(acc, dp, sK + chunk * kAtomBytes, kTB);
    __syncthreads();  // the slots are read; the next tile refills them
  }
  cp_async_wait<0>();  // Q's and dO's copies, where every tile was skipped

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (qi[hr] >= Q) continue;
    float* row = dq + ((static_cast<long long>(b) * Q + qi[hr]) * H + h) * D + 64 * chunk;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (64 * chunk + 8 * j < D)  // the tile's padded columns are dropped
        *reinterpret_cast<float2*>(row + 8 * j + 2 * t4) =
            make_float2(acc[j][2 * hr] * scale, acc[j][2 * hr + 1] * scale);
  }
}

// dK, dV on the planes and f32 tensors of the dQ kernel: two warpgroups per
// (64-key tile, head, batch row, 64-column chunk of dK and dV), keys as
// rows, as the tile variant at D >= 96 (here at every D, so that a thread
// holds one accumulator beside its chunk's fresh sum, S^T, dP^T, the bias
// kept from the vote and three fragments). Both form
// P^T from their own S^T = K Q^T; warpgroup 0 accumulates dV += P^T dO,
// warpgroup 1 dP^T = V dO^T, dS^T = P^T (dP^T - delta) and dK += dS^T Q,
// every product as the sum of its plane products. K's and V's planes are
// staged once (at D = 256 they take turns in two slots with Q's and dO's);
// each 64-row query chunk that is not dead (dead_tile) stages Q's and dO's
// and takes its LSE and delta (4 threads a row, delta from the f32 O and
// dO, while the copies land) through shared memory.
template <int D>
__global__ void __launch_bounds__(2 * kTileThreads, 1)
flash_bwd_dkv_split3_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout3,
                            const float* __restrict__ bias, const float* __restrict__ o,
                            const float* __restrict__ dout, const float* __restrict__ lse,
                            float* __restrict__ dk, float* __restrict__ dv, int H, int Q,
                            int K, Strides so, Strides sdo, BiasStrides sb, float scale) {
  constexpr int kTB = tile_bytes<D>();
  constexpr int kT = 2 * kTileThreads;
  constexpr bool kRes = split3_resident<D>();
  extern __shared__ uint8_t smem_raw[];
  uint32_t sK;
  uint8_t* smem = aligned_smem(smem_raw, sK);
  // K, V, Q, dO; at D = 256 slot A (K, then dO) and slot B (Q, then V, then Q)
  const uint32_t sQ = sK + (kRes ? 6 : 3) * kTB;
  const uint32_t sV = kRes ? sK + 3 * kTB : sQ;
  const uint32_t sdO = kRes ? sK + 9 * kTB : sK;
  float* sL = reinterpret_cast<float*>(smem + 3 * split3_slots<D>() * kTB);  // the chunk's LSE
  float* sD = sL + kBQ;                                                      // and delta

  const int tid = threadIdx.x;
  const int wg = tid / kTileThreads;  // 0: dV, 1: dK
  const int warp = (tid % kTileThreads) >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y / split3_chunks<D>();
  const int chunk = blockIdx.y % split3_chunks<D>();  // dK's, dV's columns 64 chunk .. + 63
  const int b = blockIdx.z;
  const int n_chunks = (Q + kBQ - 1) / kBQ;
  const uint32_t cols = chunk * kAtomBytes;  // their atom in a tile

  const long long st = static_cast<long long>(H) * D;
  const long long pq = st * Q * gridDim.z, pk = st * K * gridDim.z;
  const bf16* qb = q + b * st * Q + h * D;
  const bf16* dob = dout3 + b * st * Q + h * D;
  const bf16* kb = k + b * st * K + h * D;
  const bf16* vb = v + b * st * K + h * D;
  const float* lse_row = lse + (static_cast<long long>(b) * H + h) * Q;
  const float* biasb = bias ? bias + b * sb.b + h * sb.h : nullptr;

  int kr[2];
  const float* bcol[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    kr[hr] = k0 + warp * 16 + g + 8 * hr;
    bcol[hr] = biasb ? biasb + min(kr[hr], K - 1) * sb.k : nullptr;
  }
  float acc[8][4];
  zero(acc);
  if constexpr (kRes) {
    load_planes_async<D, kT>(sK, kb, pk, st, k0, K);
    load_planes_async<D, kT>(sV, vb, pk, st, k0, K);
    cp_async_commit();
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int q0 = c * kBQ;
    // row sr (4 threads a row): its LSE; the bias of this thread's 32 pairs
    // (a query past Q reads row Q - 1's) and the dead-chunk vote on both
    const int sr = tid >> 2, part = tid & 3;
    const bool in = q0 + sr < Q;
    const float lse_v = in ? lse_row[q0 + sr] : 0.f;
    float bv[8][4];
    bool live = false;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + 8 * j + 2 * t4 + (e & 1), hr = e >> 1;
        bv[j][e] = bcol[hr] ? bcol[hr][min(qi, Q - 1) * sb.q] : 0.f;
        live |= qi < Q && live_pair(bv[j][e], kr[hr], K);
      }
    if (bcol[0] && dead_tile(live, !in || lse_v > 0.5f * kNegInf)) continue;
    load_planes_async<D, kT>(sQ, qb, pq, st, q0, Q);
    if constexpr (kRes)
      load_planes_async<D, kT>(sdO, dob, pq, st, q0, Q);
    else
      load_planes_async<D, kT>(sK, kb, pk, st, k0, K);
    cp_async_commit();
    // row sr's delta while the copies land; the last chunk's reads of sL
    // and sD are done (its closing barrier)
    float d = in ? strided_dot<D>(dout + b * sdo.b + (q0 + sr) * sdo.t + h * sdo.h,
                                  o + b * so.b + (q0 + sr) * so.t + h * so.h, part, 4)
                 : 0.f;
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (part == 0)
      sD[sr] = d;
    else if (part == 1)
      sL[sr] = lse_v;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // publishes the tiles, sL and sD

    // S^T = K Q^T and P^T, in both warpgroups
    float s[8][4];
    product3<D>(s, sK, sQ);
    wgmma_commit_and_wait();
    fence_registers(s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t4 + (e & 1);
        const int qi = q0 + col, hr = e >> 1;
        float x = s[j][e] * scale;
        if constexpr (split3_keep_bias<D>())
          x += bv[j][e];
        else if (bcol[hr])
          x += bcol[hr][min(qi, Q - 1) * sb.q];
        s[j][e] = qi < Q && kr[hr] < K ? expf(x - sL[col]) : 0.f;
      }
    if constexpr (!kRes) {
      __syncthreads();  // both warpgroups' S^T have read K and Q
      load_planes_async<D, kT>(sdO, dob, pq, st, q0, Q);
      load_planes_async<D, kT>(sV, vb, pk, st, k0, K);
      cp_async_commit();
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
    }

    float dp[8][4];  // dS^T (warpgroup 1)
    if (wg == 0) {
      accumulate_planes(acc, s, sdO + cols, kTB);  // dV += P^T dO
    } else {
      // dP^T = V dO^T, dS^T = P^T (dP^T - delta)
      product3<D>(dp, sV, sdO);
      wgmma_commit_and_wait();
      fence_registers(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = s[j][e] * (dp[j][e] - sD[8 * j + 2 * t4 + (e & 1)]);
    }
    if constexpr (!kRes) {
      __syncthreads();  // dV and dP^T have read dO and V
      load_planes_async<D, kT>(sQ, qb, pq, st, q0, Q);
      cp_async_commit();
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
    }
    if (wg == 1) accumulate_planes(acc, dp, sQ + cols, kTB);  // dK += dS^T Q
    __syncthreads();  // the slots and sL/sD are read; the next chunk refills them
  }
  cp_async_wait<0>();  // K's and V's copies, where every chunk was skipped

  float* out = wg == 0 ? dv : dk;
  const float out_scale = wg == 0 ? 1.f : scale;  // dK is scaled once, at emit
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (kr[hr] >= K) continue;
    const long long off = ((static_cast<long long>(b) * K + kr[hr]) * H + h) * D + 64 * chunk;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (64 * chunk + 8 * j < D)  // the tile's padded columns are dropped
        *reinterpret_cast<float2*>(out + off + 8 * j + 2 * t4) =
            make_float2(acc[j][2 * hr] * out_scale, acc[j][2 * hr + 1] * out_scale);
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
  return built_head_dim(D) && B >= 1 && H >= 1 && Q >= 1 && K >= 1 && H <= 65535 &&
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

template <int D, int FwdBQ, bool kDbias>
cudaError_t launch_dq_fma(const Args& a, void* dq, void* dbias) {
  constexpr int BQ = dq_fma_rows<D>(FwdBQ);
  return launch<float, flash_bwd_dq_fma_kernel<D, FwdBQ, kDbias>>(
      a, (a.Q + BQ - 1) / BQ, kThreads, dq_fma_smem<D, BQ>(), static_cast<float*>(dq),
      static_cast<float*>(dbias));
}

template <int D, bool kDbias>
cudaError_t launch_dq(const Args& a, int variant, int dtype, void* dq,
                      void* dbias, bool* refused) {
  if (variant == kFma && dtype == 0)
    return forward_block_q(a.Q) == 16
               ? launch_dq_fma<D, 16, kDbias>(a, dq, dbias)
               : launch_dq_fma<D, 64, kDbias>(a, dq, dbias);
  if (variant == kTile && dtype == 1 && tile_aligned(a))
    return launch<bf16, flash_bwd_dq_tile_kernel<D, kDbias>>(
        a, (a.Q + kBQ - 1) / kBQ, kTileThreads, dq_smem<D>(), static_cast<bf16*>(dq),
        static_cast<float*>(dbias));
  *refused = true;
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dkv(const Args& a, int variant, int dtype, void* dk, void* dv,
                       bool* refused) {
  if (variant == kFma && dtype == 0) {
    constexpr int KT = dkv_fma_tile<D>();
    return launch<float, flash_bwd_dkv_fma_kernel<D>>(
        a, (a.K + KT - 1) / KT, kThreads, dkv_fma_smem<D>(), static_cast<float*>(dk),
        static_cast<float*>(dv));
  }
  if (variant == kTile && dtype == 1 && tile_aligned(a))
    return launch<bf16, flash_bwd_dkv_tile_kernel<D>>(
        a, (a.K + kBK - 1) / kBK, dkv_threads<D>(), dkv_smem<D>(),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv));
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

// the split3 kernels' arguments: the planes of q, k, v and dO (bf16,
// contiguous), the bias, o and dO (f32, through strides) and the LSE
struct Split3Args {
  const void *q3, *k3, *v3, *do3, *bias, *o, *dout, *lse;
  int B, H, Q, K;
  Strides so, sdo;
  BiasStrides sb;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq_split3(const Split3Args& a, void* dq) {
  constexpr int smem = dq_split3_smem<D>();
  cudaError_t err = allow_smem<flash_bwd_dq_split3_kernel<D>>(smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_split3_kernel<D>
      <<<dim3((a.Q + kBQ - 1) / kBQ, a.H * split3_chunks<D>(), a.B), kTileThreads, smem,
          a.stream>>>(
          static_cast<const bf16*>(a.q3), static_cast<const bf16*>(a.k3),
          static_cast<const bf16*>(a.v3), static_cast<const bf16*>(a.do3),
          static_cast<const float*>(a.bias), static_cast<const float*>(a.o),
          static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
          static_cast<float*>(dq), a.H, a.Q, a.K, a.so, a.sdo, a.sb, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_split3(const Split3Args& a, void* dk, void* dv) {
  constexpr int smem = dkv_split3_smem<D>();
  cudaError_t err = allow_smem<flash_bwd_dkv_split3_kernel<D>>(smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_split3_kernel<D>
      <<<dim3((a.K + kBK - 1) / kBK, a.H * split3_chunks<D>(), a.B), 2 * kTileThreads, smem,
          a.stream>>>(
          static_cast<const bf16*>(a.q3), static_cast<const bf16*>(a.k3),
          static_cast<const bf16*>(a.v3), static_cast<const bf16*>(a.do3),
          static_cast<const float*>(a.bias), static_cast<const float*>(a.o),
          static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
          static_cast<float*>(dk), static_cast<float*>(dv), a.H, a.Q, a.K, a.so, a.sdo, a.sb,
          a.scale);
  return cudaGetLastError();
}

// The split3 entry points' checks and arguments: the planes 16-byte aligned
// (the copies read them with 16-byte loads), o and dO f32 with a
// contiguous head dim
bool split3_args(Split3Args* a, const void* q3, const void* k3, const void* v3,
                 const void* do3, const void* bias, const void* o, const void* dout,
                 const void* lse, int B, int H, int Q, int K, int D, const long long* s,
                 float scale, void* stream) {
  for (const void* p : {q3, k3, v3, do3})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  if (!valid(D, B, H, Q, K) || H > 65535 / 4 || !o || !dout || !lse) return false;
  // s: o, dout strides (b, t, h each), then the bias's (b, h, q, k)
  *a = Split3Args{q3, k3, v3, do3, bias, o, dout, lse, B, H, Q, K,
                  Strides{s[0], s[1], s[2]}, Strides{s[3], s[4], s[5]},
                  BiasStrides{s[6], s[7], s[8], s[9]}, scale,
                  static_cast<cudaStream_t>(stream)};
  return true;
}

}  // namespace

// split3 (f32 through three bf16 planes on the tensor cores; the ring's
// block backward, ops/flash_attention.py::flash_block_bwd): q3, k3, v3, do3
// are the bf16 planes of q, k, v and dO (csrc/split_planes.cu: [3, B, T, H,
// D] contiguous, 16-byte aligned); o and dout the f32 [B, Q, H, D] tensors
// delta is taken from; `strides` holds 10 element strides: o and dout as
// (b, t, h) each (head dim contiguous), then the bias's (b, h, q, k) with 0
// for a broadcast dimension. bias may be null; there is no causal flag. lse
// is [B, H, Q] f32; the outputs are contiguous f32 [B, T, H, D]. Each
// returns 0 on success, else the CUDA error code of the launch, or -1 for
// arguments the variant was not built for.
extern "C" int trlx_flash_bwd_dq_split3(const void* q3, const void* k3, const void* v3,
                                        const void* do3, const void* bias, const void* o,
                                        const void* dout, const void* lse, void* dq, int B,
                                        int H, int Q, int K, int D, const long long* strides,
                                        float scale, void* stream) {
  Split3Args a;
  if (!split3_args(&a, q3, k3, v3, do3, bias, o, dout, lse, B, H, Q, K, D, strides, scale,
                   stream))
    return -1;
  return with_head_dim(D, [&](auto d) { return launch_dq_split3<decltype(d)::value>(a, dq); });
}

extern "C" int trlx_flash_bwd_dkv_split3(const void* q3, const void* k3, const void* v3,
                                         const void* do3, const void* bias, const void* o,
                                         const void* dout, const void* lse, void* dk, void* dv,
                                         int B, int H, int Q, int K, int D,
                                         const long long* strides, float scale, void* stream) {
  Split3Args a;
  if (!split3_args(&a, q3, k3, v3, do3, bias, o, dout, lse, B, H, Q, K, D, strides, scale,
                   stream))
    return -1;
  return with_head_dim(
      D, [&](auto d) { return launch_dkv_split3<decltype(d)::value>(a, dk, dv); });
}

// the split3 dQ (dkv = 0) or dK/dV (dkv = 1) kernel's dynamic shared
// memory at head dim D, in bytes (-1 for a D it is not built for)
extern "C" int trlx_flash_bwd_split3_smem(int D, int dkv) {
  return with_head_dim(D, [&](auto d) {
    return dkv ? dkv_split3_smem<decltype(d)::value>() : dq_split3_smem<decltype(d)::value>();
  });
}

// variant: 0 = fma (f32), 1 = tile (bf16), as
// ops/flash_attention.py::backward_variant picks it; dtype: 0 = float32, 1 =
// bfloat16; D: a head dim of kHeadDims (16, 24, 32, 64, 96, 128 or 256). `strides` holds 19
// element strides: q, k, v, o, dout as (b, t, h) each (head dim contiguous),
// then the bias's (b, h, q, k) with 0 for a broadcast dimension; the tile
// variant needs all five inputs 16-byte aligned as `aligned16` states. bias
// may be null. lse is [B, H, Q] f32; outputs are contiguous [B, T, H, D] in
// the inputs' dtype. dbias (dQ only) may be null; when given it receives
// dS, the bias's gradient, as a contiguous [B, H, Q, K] f32 tensor, and the
// causal flag is refused (a learned bias carries its own causal mask, so
// every key tile is visited and every element written). Each returns 0 on
// success, else the CUDA error code of the launch, or -1 for arguments the
// chosen variant was not built for.
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
  cudaError_t err;
  switch (D) {
    case 16:
      err = dbias ? launch_dq<16, true>(a, variant, dtype, dq, dbias, &refused)
                  : launch_dq<16, false>(a, variant, dtype, dq, nullptr, &refused);
      break;
    case 24:
      err = dbias ? launch_dq<24, true>(a, variant, dtype, dq, dbias, &refused)
                  : launch_dq<24, false>(a, variant, dtype, dq, nullptr, &refused);
      break;
    case 32:
      err = dbias ? launch_dq<32, true>(a, variant, dtype, dq, dbias, &refused)
                  : launch_dq<32, false>(a, variant, dtype, dq, nullptr, &refused);
      break;
    case 64:
      err = dbias ? launch_dq<64, true>(a, variant, dtype, dq, dbias, &refused)
                  : launch_dq<64, false>(a, variant, dtype, dq, nullptr, &refused);
      break;
    case 96:
      err = dbias ? launch_dq<96, true>(a, variant, dtype, dq, dbias, &refused)
                  : launch_dq<96, false>(a, variant, dtype, dq, nullptr, &refused);
      break;
    case 128:
      err = dbias ? launch_dq<128, true>(a, variant, dtype, dq, dbias, &refused)
                  : launch_dq<128, false>(a, variant, dtype, dq, nullptr, &refused);
      break;
    case 256:
      err = dbias ? launch_dq<256, true>(a, variant, dtype, dq, dbias, &refused)
                  : launch_dq<256, false>(a, variant, dtype, dq, nullptr, &refused);
      break;
    default:
      return -1;
  }
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
  bool refused = false;
  cudaError_t err;
  switch (D) {
    case 16:
      err = launch_dkv<16>(a, variant, dtype, dk, dv, &refused);
      break;
    case 24:
      err = launch_dkv<24>(a, variant, dtype, dk, dv, &refused);
      break;
    case 32:
      err = launch_dkv<32>(a, variant, dtype, dk, dv, &refused);
      break;
    case 64:
      err = launch_dkv<64>(a, variant, dtype, dk, dv, &refused);
      break;
    case 96:
      err = launch_dkv<96>(a, variant, dtype, dk, dv, &refused);
      break;
    case 128:
      err = launch_dkv<128>(a, variant, dtype, dk, dv, &refused);
      break;
    case 256:
      err = launch_dkv<256>(a, variant, dtype, dk, dv, &refused);
      break;
    default:
      return -1;
  }
  return refused ? -1 : static_cast<int>(err);
}
