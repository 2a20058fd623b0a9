// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel, bound through plain C entry points (`trlx_flash_bwd_dq`,
// `trlx_flash_bwd_dkv`) that Python loads with ctypes.
//
// Replaces the TPU kernels trlx_tpu/ops/flash_attention.py::_dq_kernel (:211)
// and ::_dkv_kernel (:265). Both recompute the scores per tile from the
// forward's saved LSE, P = exp(S - LSE) with S = scale * Q K^T (f32) + bias +
// causal NEG_INF, and take delta = rowsum(dO * O) (f32) in the kernel instead
// of reading it from memory. Numerics kept from the TPU source:
//  - dP = dO V^T with dO and V widened to f32 (:250, :311);
//  - P is NOT rounded to V's dtype here (the forward rounds it before P V);
//  - the dQ kernel casts dS to K's dtype before dS K (:255-257);
//  - the dK/dV kernel keeps P and dS in f32 for P^T dO and dS^T Q (:307-319);
//  - dQ and dK are scaled once, at emit (:262, :323).
//
// Design, and what bounds it on the card:
//  - dQ: one thread block per (query tile, head, batch row). The TPU's
//    sequential key-tile grid axis becomes a loop inside the block; dQ
//    accumulates in registers across key tiles, so no atomics. delta and the
//    LSE of the tile's rows are computed/loaded once, into shared memory.
//  - dK/dV: one block per (64-key tile, head, batch row), looping over
//    64-row query chunks and recomputing delta per chunk (as :296 does).
//    dK and dV accumulate in f32 registers; no atomics, so the result is
//    deterministic.
//  - Causal tile skipping must agree with the forward kernel
//    (csrc/flash_fwd.cu): it uses a query tile of 16 rows when Q <= 16, else
//    64, and 64-key tiles, and skips key tiles that start after the tile's
//    last query. A left-padding row whose visible keys are all masked
//    normalised over the keys of the tiles it visited, so P = exp(S - LSE)
//    sums to 1 over those tiles only: both kernels apply the forward's visit
//    predicate at the forward's tile sizes (dQ by using the forward's query
//    tile, dK/dV per row). Key tiles that no query visits (the causal tail)
//    are written as zeros.
//  - Inputs are read in the port's public [B, T, H, D] layout through
//    strides, the bias through four strides (0 = broadcast dimension), the
//    LSE as [B, H, Q] f32; ragged Q/K edges are masked in the kernel and
//    keys past K are left out, as in the forward. Padded query rows have
//    P = 0, so a NEG_INF-sized logit never meets an unloaded LSE.
//  - At the training shapes (T ~ 100, D = 64) both kernels move a few bytes
//    per operation, so their bound is the bytes they must move; this first
//    version multiplies with f32 FMA from shared memory (register-blocked
//    4x4 per thread), as the forward does: bf16 inputs are exact in f32, so
//    the numerics equal an MMA with f32 accumulation. Tensor cores
//    (mma.sync / wgmma) are later work; PERF.md keeps the time beside the
//    bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kD = 64;         // head dim the kernels are built for (GPT-2)
constexpr int kBK = 64;        // keys per tile (the forward's key tile)
constexpr int kBQ = 64;        // query rows per dK/dV chunk
constexpr int kLD = kD + 1;    // padded row stride of the tiles (banks)
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr float kNegInf = -1e9f;  // the framework's finite mask value

static_assert(kBK == kD, "the P/dS tiles share the Q/K/V row stride");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

struct Strides {
  long long b, t, h;  // element strides of a [B, T, H, D] tensor (d stride 1)
};

struct BiasStrides {
  long long b, h, q, k;  // element strides; 0 = broadcast dimension
};

// the forward kernel's query tile for Q query rows (flash_fwd.cu::dispatch)
__host__ __device__ __forceinline__ int forward_block_q(int Q) {
  return Q <= 16 ? 16 : 64;
}

// Logit of (query qi, key kj), both in range, as the forward forms it.
__device__ __forceinline__ float logit(float s, float scale,
                                       const float* biasb, BiasStrides sb,
                                       int qi, int kj, int causal) {
  float x = s * scale;
  if (biasb) x += biasb[qi * sb.q + kj * sb.k];
  if (causal && kj > qi) x += kNegInf;
  return x;
}

// Stage rows [r0, r0 + n) of a [B, T, H, D] tensor (already offset to its
// batch row and head) into a [n][kLD] f32 tile; rows at or past T are 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long st, int r0, int n,
                                          int T_len) {
  for (int i = threadIdx.x; i < n * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    const int t = r0 + r;
    dst[r * kLD + d] = t < T_len ? to_f32(src[t * st + d]) : 0.f;
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

// ---------------------------------------------------------------------------
// dQ: one block per (query tile of BQ rows, head, batch row)
// ---------------------------------------------------------------------------

template <typename T, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dq, int H,
                    int Q, int K, Strides sq, Strides sk, Strides sv,
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

  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
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
        dSs[r * kLD + tx + 16 * j] = round_to<T>(p * (dp[i][j] - Ds[r]));
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
    T* row = dq + ((static_cast<long long>(b) * Q + qi) * H + h) * kD;
#pragma unroll
    for (int j = 0; j < 4; ++j) row[tx + 16 * j] = from_f32<T>(acc[i][j] * scale);
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (64-key tile, head, batch row)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ o, const T* __restrict__ dout,
                     const float* __restrict__ lse, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Q, int K, Strides sq,
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
  const int fwd_bq = forward_block_q(Q);

  const T* qb = q + b * sq.b + h * sq.h;
  const T* ob = o + b * so.b + h * so.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
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
    if (causal) {
      // the forward visited this key tile from query row qi iff the tile
      // starts before the end of qi's forward query tile; the chunk's last
      // row has the latest end, so the chunk is live iff that row visited
      const int last = min(q0 + kBQ, Q) - 1;
      if (k0 >= (last / fwd_bq) * fwd_bq + fwd_bq) continue;  // block-uniform
    }
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
      const bool visits =
          qi < Q && (!causal || k0 < (qi / fwd_bq) * fwd_bq + fwd_bq);
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
      dk[off + tx + 16 * j] = from_f32<T>(dk_acc[i][j] * scale);
      dv[off + tx + 16 * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// above 48 KB of dynamic shared memory needs the opt-in, once per device and
// kernel (each kernel instantiates this template, so keeps its own flags)
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

struct Args {
  const void *q, *k, *v, *bias, *o, *dout, *lse;
  int B, H, Q, K;
  Strides sq, sk, sv, so, sdo;
  BiasStrides sb;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int BQ>
cudaError_t launch_dq(const Args& a, void* dq) {
  constexpr size_t smem = sizeof(float) * ((3 * BQ + 2 * kBK) * kLD + 2 * BQ);
  constexpr auto kernel = flash_bwd_dq_kernel<T, BQ>;
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Q + BQ - 1) / BQ, a.H, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.bias),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<T*>(dq), a.H, a.Q, a.K,
      a.sq, a.sk, a.sv, a.so, a.sdo, a.sb, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  constexpr size_t smem = sizeof(float) * ((2 * kBK + 4 * kBQ) * kLD + 2 * kBQ);
  constexpr auto kernel = flash_bwd_dkv_kernel<T>;
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.K + kBK - 1) / kBK, a.H, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.bias),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<T*>(dk),
      static_cast<T*>(dv), a.H, a.Q, a.K, a.sq, a.sk, a.sv, a.so, a.sdo, a.sb,
      a.scale, a.causal);
  return cudaGetLastError();
}

bool valid(int D, int B, int H, int Q, int K) {
  return D == kD && B >= 1 && H >= 1 && Q >= 1 && K >= 1 && H <= 65535 &&
         B <= 65535;
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

// dtype: 0 = float32, 1 = bfloat16. `strides` holds 19 element strides: q, k,
// v, o, dout as (b, t, h) each (head dim contiguous), then the bias's
// (b, h, q, k) with 0 for a broadcast dimension. bias may be null. lse is
// [B, H, Q] f32; outputs are contiguous [B, T, H, D] in the inputs' dtype.
// Each returns 0 on success, else the CUDA error code of the launch (or -1
// for arguments the kernels were not built for).
extern "C" int trlx_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* bias, const void* o,
                                 const void* dout, const void* lse, void* dq,
                                 int dtype, int B, int H, int Q, int K, int D,
                                 const long long* strides, float scale,
                                 int causal, void* stream) {
  if (!valid(D, B, H, Q, K)) return -1;
  const Args a = make_args(q, k, v, bias, o, dout, lse, B, H, Q, K, strides,
                           scale, causal, stream);
  const bool small = forward_block_q(Q) == 16;
  cudaError_t err;
  if (dtype == 0)
    err = small ? launch_dq<float, 16>(a, dq) : launch_dq<float, 64>(a, dq);
  else if (dtype == 1)
    err = small ? launch_dq<__nv_bfloat16, 16>(a, dq)
                : launch_dq<__nv_bfloat16, 64>(a, dq);
  else
    return -1;
  return static_cast<int>(err);
}

extern "C" int trlx_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* bias, const void* o,
                                  const void* dout, const void* lse, void* dk,
                                  void* dv, int dtype, int B, int H, int Q,
                                  int K, int D, const long long* strides,
                                  float scale, int causal, void* stream) {
  if (!valid(D, B, H, Q, K)) return -1;
  const Args a = make_args(q, k, v, bias, o, dout, lse, B, H, Q, K, strides,
                           scale, causal, stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_dkv<float>(a, dk, dv);
  else if (dtype == 1)
    err = launch_dkv<__nv_bfloat16>(a, dk, dv);
  else
    return -1;
  return static_cast<int>(err);
}
