// Flash-attention forward for Hopper (sm_90a), bound through a plain C entry
// point (`trlx_flash_fwd`) that Python loads with ctypes.
//
// Replaces the TPU kernel trlx_tpu/ops/flash_attention.py::_fwd_kernel.
// It computes the same function: S = scale * Q K^T in f32, plus an optional
// additive f32 bias that broadcasts over size-1 dims, plus an optional causal
// mask (finite NEG_INF) with wholly-future key tiles skipped; a running row
// max / row sum and an f32 accumulator carried across key tiles; P rounded to
// V's dtype before P V; O = acc / max(l, 1e-30) in q's dtype and
// LSE = m + log(max(l, 1e-30)) in f32.
//
// Design, and what bounds it on the card:
//  - One thread block per (query tile of BQ rows, head, batch row). The TPU's
//    sequential key-tile grid axis becomes a loop inside the block: each
//    iteration stages a 64-key K/V tile in shared memory (as f32) and updates
//    the running max, sum and accumulator, which live in registers. The
//    [Q, K] score matrix never reaches device memory.
//  - q/k/v are read in the port's public [B, T, H, D] layout through strides
//    (no transpose or tile padding in device memory); ragged Q/K edges are
//    masked in the kernel. Keys past K are left out (zero weight), so a row
//    whose keys are all masked averages the K real values, as the plain
//    version does.
//  - The bias is read through four strides; a stride of 0 marks a broadcast
//    dimension, so a [B,1,1,K] padding bias is never materialised at full
//    rank.
//  - Decode (one query row) is bound by the K/V bytes it reads: a 16-row
//    query tile (BQ = 16) keeps the wasted work of the empty rows small, and
//    the grid has B*H blocks to spread the cache read over the SMs.
//  - Long prefill is bound by tensor-core operations (the engine's prefill,
//    with its materialised [B,1,Q,K] f32 bias, by the bias bytes). This
//    first version multiplies with f32 FMA from shared memory
//    (register-blocked 4x4 per thread), not with the tensor cores; bf16
//    inputs are exact in f32 and the products are exact, so its numerics
//    equal an MMA with f32 accumulation. wgmma/TMA is later work; PERF.md
//    keeps its time beside its bound.
//  - Under the causal flag a query row whose visible keys are all masked (a
//    left-padding row) averages the keys of the tiles it visits, as the TPU
//    kernel does; callers discard such rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kD = 64;         // head dim the kernel is built for (GPT-2)
constexpr int kBK = 64;        // keys per tile
constexpr int kLD = kD + 1;    // padded row stride of the Q/K/V tiles (banks)
constexpr int kLP = kBK + 1;   // padded row stride of the P tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr float kNegInf = -1e9f;  // the framework's finite mask value

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

// P rounded to V's dtype (then held as f32 for the FMA product)
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

template <typename T, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Q,
                 int K, Strides sq, Strides sk, Strides sv, BiasStrides sb,
                 float scale, int causal) {
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

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* biasb = bias ? bias + b * sb.b + h * sb.h : nullptr;

  for (int i = tid; i < BQ * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    const int qi = q0 + r;
    Qs[r * kLD + d] = qi < Q ? to_f32(qb[qi * sq.t + d]) : 0.f;
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
    for (int i = tid; i < kBK * kD; i += kThreads) {
      const int c = i / kD, d = i % kD;
      const int kj = k0 + c;
      const bool in = kj < K;
      Ks[c * kLD + d] = in ? to_f32(kb[kj * sk.t + d]) : 0.f;
      Vs[c * kLD + d] = in ? to_f32(vb[kj * sv.t + d]) : 0.f;
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
        float x;
        if (kj >= K) {
          x = -INFINITY;  // keys past K are left out, not masked
        } else {
          x = s[i][j] * scale;
          if (biasb) x += biasb[qb_row * sb.q + kj * sb.k];
          if (causal && kj > qi) x += kNegInf;
        }
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
        Ps[r * kLP + tx + 16 * j] = round_to<T>(p);
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

  const int B_H = gridDim.y;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + ty * RQ + i;
    if (qi >= Q) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * Q + qi) * B_H + h) * kD;
#pragma unroll
    for (int j = 0; j < 4; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] / l_safe);
    if (lse && tx == 0)
      lse[(static_cast<long long>(b) * B_H + h) * Q + qi] = m[i] + logf(l_safe);
  }
}

template <int BQ>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * kLD + 2 * kBK * kLD + BQ * kLP);
}

template <typename T, int BQ>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* o, void* lse, int B, int H, int Q,
                   int K, Strides sq, Strides sk, Strides sv, BiasStrides sb,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BQ>();
  // above 48 KB of dynamic shared memory needs the opt-in, once per device
  // and instantiation (the flag is per instantiation: a static of this
  // template)
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !smem_set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, BQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) smem_set[dev].store(true, std::memory_order_release);
  }
  dim3 grid((Q + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, BQ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(o), static_cast<float*>(lse), H, Q, K, sq, sk, sv, sb,
      scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* bias, void* o, void* lse, int B, int H,
                     int Q, int K, Strides sq, Strides sk, Strides sv,
                     BiasStrides sb, float scale, int causal,
                     cudaStream_t stream) {
  if (Q <= 16)
    return launch<T, 16>(q, k, v, bias, o, lse, B, H, Q, K, sq, sk, sv, sb,
                         scale, causal, stream);
  return launch<T, 64>(q, k, v, bias, o, lse, B, H, Q, K, sq, sk, sv, sb,
                       scale, causal, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head dim
// must be contiguous. bias may be null; lse may be null (not written). Returns 0 on success, else the CUDA
// error code of the launch (or -1 for arguments the kernel was not built for).
extern "C" int trlx_flash_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int dtype, int B, int H, int Q, int K, int D, long long sqb,
    long long sqt, long long sqh, long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh, long long sbb, long long sbh,
    long long sbq, long long sbk, float scale, int causal, void* stream) {
  if (D != kD || B < 1 || H < 1 || Q < 1 || K < 1 || H > 65535 || B > 65535)
    return -1;
  const Strides sq{sqb, sqt, sqh}, sk{skb, skt, skh}, sv{svb, svt, svh};
  const BiasStrides sb{sbb, sbh, sbq, sbk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, bias, o, lse, B, H, Q, K, sq, sk, sv, sb,
                          scale, causal, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, bias, o, lse, B, H, Q, K, sq, sk,
                                  sv, sb, scale, causal, st);
  else
    return -1;
  return static_cast<int>(err);
}
