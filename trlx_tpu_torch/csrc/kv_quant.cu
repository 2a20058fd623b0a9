// The int8 KV cache's quantizing write for Hopper (sm_90a), bound through a
// plain C entry point (`trlx_kv_quant_write`) that Python loads with ctypes.
//
// No TPU kernel: the JAX package's int8 cache quantizes in XLA
// (trlx_tpu/models/gpt2.py::quantize_kv, fused with the write of
// write_cache :307-324 and of inference/kv_cache.py::paged_write_read
// :400-435). Here one launch per layer and step takes the new K and V slice
// [B, T, H, D] in the compute dtype (bf16 or f32, read through strides) and
// writes, for both, the int8 values [row, H, D] and the bf16 scales [row, H]
// at each token's destination row: b * row_stride + start + t (the linear
// cache's [start, start + T)) or rows[b, t] (the paged cache's physical
// position in slot b's region), and again at pub_rows[b, t] of the
// shared-prefix pool when one is given.
//
// It reproduces ops/kv_quant.py's plain version (models/gpt2.py::
// quantize_kv) bit for bit: per (token, head) the absmax over D in f32,
// scale = max(absmax, 1e-8) / 127 with IEEE division (__fdiv_rn), each value
// round(x / scale) half to even (__fdiv_rn, then __float2int_rn) clipped to
// [-127, 127], and the f32 scale rounded to bf16 only where it is stored.
//
// One warp per (batch row, token, head, K or V): the absmax is a max over
// the lanes' columns (lane l takes columns l, l + 32, ...) reduced with
// shuffles, then each lane quantizes and stores its columns. The work is a
// pass over the new K/V, bound by its bytes.

#include "hopper_tile.cuh"

namespace {

constexpr int kQuantWarps = 4;

struct QuantDest {
  int8_t* k;
  int8_t* v;
  bf16* k_scale;
  bf16* v_scale;
};

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(32 * kQuantWarps)
kv_quant_write_kernel(const T* __restrict__ k, const T* __restrict__ v, int B, int T_,
                      int H, int D, Strides sk, Strides sv, QuantDest dst,
                      const long long* __restrict__ rows, long long row_stride,
                      long long start, QuantDest pub, const long long* __restrict__ pub_rows) {
  const long long item = static_cast<long long>(blockIdx.x) * kQuantWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const long long per_tensor = static_cast<long long>(B) * T_ * H;
  if (item >= 2 * per_tensor) return;
  const bool is_v = item >= per_tensor;
  const long long i = is_v ? item - per_tensor : item;
  const int h = static_cast<int>(i % H);
  const int t = static_cast<int>(i / H % T_);
  const int b = static_cast<int>(i / (static_cast<long long>(H) * T_));
  const Strides s = is_v ? sv : sk;
  const T* src = (is_v ? v : k) + b * s.b + t * s.t + h * s.h;

  float amax = 0.f;
  for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(to_f32(src[d])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);

  const long long bt = static_cast<long long>(b) * T_ + t;
  const long long row = rows ? rows[bt] : b * row_stride + start + t;
  const long long pub_row = pub_rows ? pub_rows[bt] : -1;
  int8_t* out = (is_v ? dst.v : dst.k) + (row * H + h) * D;
  int8_t* pub_out = pub_row >= 0 ? (is_v ? pub.v : pub.k) + (pub_row * H + h) * D : nullptr;
  for (int d = lane; d < D; d += 32) {
    const int q = __float2int_rn(__fdiv_rn(to_f32(src[d]), scale));
    const int8_t qc = static_cast<int8_t>(max(-127, min(127, q)));
    out[d] = qc;
    if (pub_out) pub_out[d] = qc;
  }
  if (lane == 0) {
    const bf16 stored = __float2bfloat16_rn(scale);
    (is_v ? dst.v_scale : dst.k_scale)[row * H + h] = stored;
    if (pub_row >= 0) (is_v ? pub.v_scale : pub.k_scale)[pub_row * H + h] = stored;
  }
}

template <typename T>
cudaError_t launch_quant(const void* k, const void* v, int B, int T_, int H, int D,
                         Strides sk, Strides sv, QuantDest dst, const long long* rows,
                         long long row_stride, long long start, QuantDest pub,
                         const long long* pub_rows, cudaStream_t stream) {
  const long long items = 2LL * B * T_ * H;
  const long long blocks = (items + kQuantWarps - 1) / kQuantWarps;
  kv_quant_write_kernel<T><<<static_cast<unsigned>(blocks), 32 * kQuantWarps, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), B, T_, H, D, sk, sv, dst, rows,
      row_stride, start, pub, pub_rows);
  return cudaGetLastError();
}

}  // namespace

// k, v: [B, T, H, D] in the compute dtype (dtype 0 = float32, 1 =
// bfloat16) through element strides (b, t, h; d contiguous). ck, cv: int8
// [rows, H, D] and cks, cvs: bf16 [rows, H], contiguous; token t of batch
// row b goes to row rows[b * T + t] when rows (int64 [B, T]) is given, else
// to row b * row_stride + row_start + t. pk, pv, pks, pvs and pub_rows
// (int64 [B, T]) are the shared-prefix pool's, or all null. Returns 0 on
// success, the CUDA error code of the launch, or -1 for an empty or
// unsupported shape.
extern "C" int trlx_kv_quant_write(
    const void* k, const void* v, int dtype, int B, int T, int H, int D, long long skb,
    long long skt, long long skh, long long svb, long long svt, long long svh, void* ck,
    void* cv, void* cks, void* cvs, const void* rows, long long row_stride,
    long long row_start, void* pk, void* pv, void* pks, void* pvs, const void* pub_rows,
    void* stream) {
  if (B < 1 || T < 1 || H < 1 || D < 1 || (dtype != 0 && dtype != 1)) return -1;
  if (2LL * B * T * H > 0x7fffffffLL * kQuantWarps) return -1;
  if ((pub_rows != nullptr) != (pk != nullptr)) return -1;
  const Strides sk{skb, skt, skh}, sv{svb, svt, svh};
  const QuantDest dst{static_cast<int8_t*>(ck), static_cast<int8_t*>(cv),
                      static_cast<bf16*>(cks), static_cast<bf16*>(cvs)};
  const QuantDest pub{static_cast<int8_t*>(pk), static_cast<int8_t*>(pv),
                      static_cast<bf16*>(pks), static_cast<bf16*>(pvs)};
  const long long* r = static_cast<const long long*>(rows);
  const long long* pr = static_cast<const long long*>(pub_rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? launch_quant<bf16>(k, v, B, T, H, D, sk, sv, dst, r, row_stride, row_start,
                                      pub, pr, st)
                 : launch_quant<float>(k, v, B, T, H, D, sk, sv, dst, r, row_stride, row_start,
                                       pub, pr, st);
  return static_cast<int>(err);
}
