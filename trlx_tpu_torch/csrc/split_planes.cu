// The split3 pre-pass for Hopper (sm_90a), bound through a plain C entry
// point (`trlx_split_planes`) that Python loads with ctypes.
//
// Part of the ring's block wrappers' f32 route (ops/flash_attention.py::
// flash_block_fwd and flash_block_bwd, which replace the TPU wrappers
// trlx_tpu/ops/flash_attention.py::flash_block_fwd :468 and flash_block_bwd
// :491): it turns an f32 [B, T, H, D] tensor, read through its four strides,
// into its three bf16 planes (hopper_tile.cuh split3_value), written as one
// contiguous [3, B, T, H, D] bf16 tensor, so that the split3 kernels of
// csrc/flash_fwd.cu and csrc/flash_bwd.cu stage each plane with the 16-byte
// copies the tile kernels use. An elementwise pass bound by its bytes (4 read
// and 6 written an element: 0.0188 ms for one of the ring block's 2048-row
// q, k, v or dO at B = 4, H = 12, D = 64 on 3.35 TB/s); each thread takes one
// element, neighbouring threads neighbouring elements of the last dim.

#include "hopper_tile.cuh"

namespace {

constexpr int kSplitThreads = 256;

__global__ void __launch_bounds__(kSplitThreads)
split_planes_kernel(const float* __restrict__ x, bf16* __restrict__ out, long long n,
                    int T, int H, int D, long long sb, long long st, long long sh,
                    long long sd) {
  for (long long i = blockIdx.x * static_cast<long long>(kSplitThreads) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kSplitThreads) {
    const long long d = i % D, h = i / D % H, t = i / (static_cast<long long>(D) * H) % T,
                    b = i / (static_cast<long long>(D) * H * T);
    bf16 planes[3];
    split3_value(x[b * sb + t * st + h * sh + d * sd], planes);
#pragma unroll
    for (int p = 0; p < 3; ++p) out[p * n + i] = planes[p];
  }
}

}  // namespace

// x: f32 [B, T, H, D] through element strides (b, t, h, d); out: bf16
// [3, B, T, H, D] contiguous, plane p at p * B * T * H * D. Returns 0 on
// success, else the CUDA error code of the launch, or -1 for an empty or
// oversized shape.
extern "C" int trlx_split_planes(const void* x, void* out, int B, int T, int H, int D,
                                 long long sb, long long st, long long sh, long long sd,
                                 void* stream) {
  if (B < 1 || T < 1 || H < 1 || D < 1) return -1;
  const long long n = static_cast<long long>(B) * T * H * D;
  const long long blocks = (n + kSplitThreads - 1) / kSplitThreads;
  const int grid = static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
  split_planes_kernel<<<grid, kSplitThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<bf16*>(out), n, T, H, D, sb, st, sh, sd);
  return static_cast<int>(cudaGetLastError());
}
