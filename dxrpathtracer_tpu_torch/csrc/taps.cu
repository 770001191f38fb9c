// Bilinear wrap tap at mip 0 of the texel pool, for sm_90a.
//
// Replaces no TPU kernel: the JAX package's bilinear_from_meta
// (dxrpathtracer_tpu/scene/textures.py) is plain jnp, which XLA fuses into
// one loop. In the port its torch twin (scene/textures.py::
// bilinear_from_meta_plain) runs as some 47 kernels a tap: four 2-D torch
// gathers of 16-B texels and about 43 elementwise passes for the index
// arithmetic and the lerps, each a full pass over every lane. Here one
// thread computes a lane's whole tap.
//
// Bound: bytes. A tap does ~30 operations on ~36 B of lane input (uv 8 B,
// base/w/h 12 B) and 16 B of output, plus four 16-B texels that are
// scattered over the pool (up to 1.68 GB) and shared between the lanes of
// coherent rays. So what limits it is the number of independent texel loads
// in flight, and the card's memory latency behind them.
//
// Design:
//   - One thread per lane, 256 threads a block, no shared memory, registers
//     held to 32 (__launch_bounds__(256, 8)) so an SM keeps 64 warps
//     resident: occupancy is what hides the scattered loads' latency.
//   - Lane inputs are read in place through an element stride each, so the
//     integrator's views (uv in a 14-float vertex block, base/w/h in a
//     64-word shading row) need no copy.
//   - The four float4 texel loads go through the read-only path (__ldg)
//     and are all issued before any is used.
//   - Bit for bit the twin: every product and sum is its own IEEE
//     round-to-nearest operation in the twin's order (the __f*_rn
//     intrinsics, which are never contracted, and the build's
//     --fmad=false), the float-to-int cast truncates as torch's does on the
//     card, and the modulo takes the sign of the divisor as torch.remainder
//     does. Texels stay float32 and filtering is computed, never done by
//     the texture unit (whose 8-bit fixed-point weights give other values).
//
// Plain C interface for ctypes: the launcher returns the CUDA error code of
// the launch (0 on success) and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 64 warps resident on each SM

// torch.remainder of int32: the remainder takes the divisor's sign
__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// a + (b - a) * f, each operation rounded on its own
__device__ __forceinline__ float lerp(float a, float b, float f) {
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), f));
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float f) {
  return make_float4(lerp(a.x, b.x, f), lerp(a.y, b.y, f),
                     lerp(a.z, b.z, f), lerp(a.w, b.w, f));
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bilinear_tap_kernel(const float4* __restrict__ texels,
                    const float* __restrict__ uv, int64_t uv_row,
                    int64_t uv_col, const int32_t* __restrict__ base,
                    int64_t base_stride, const int32_t* __restrict__ w,
                    int64_t w_stride, const int32_t* __restrict__ h,
                    int64_t h_stride, float4* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float u = __ldg(uv + i * uv_row);
  const float v = __ldg(uv + i * uv_row + uv_col);
  const int b = __ldg(base + i * base_stride);
  const int wi = __ldg(w + i * w_stride);
  const int hi = __ldg(h + i * h_stride);

  // D3D texel-center convention: sample coord = uv * size - 0.5
  const float x = __fsub_rn(__fmul_rn(u, (float)wi), 0.5f);
  const float y = __fsub_rn(__fmul_rn(v, (float)hi), 0.5f);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = __fsub_rn(x, x0);
  const float fy = __fsub_rn(y, y0);

  const int x0i = floor_mod((int)x0, wi);
  const int x1i = floor_mod(x0i + 1, wi);
  const int y0i = floor_mod((int)y0, hi);
  const int y1i = floor_mod(y0i + 1, hi);
  const int row0 = b + y0i * wi;
  const int row1 = b + y1i * wi;

  const float4 t00 = __ldg(texels + (int64_t)(row0 + x0i));
  const float4 t10 = __ldg(texels + (int64_t)(row0 + x1i));
  const float4 t01 = __ldg(texels + (int64_t)(row1 + x0i));
  const float4 t11 = __ldg(texels + (int64_t)(row1 + x1i));

  const float4 top = lerp4(t00, t10, fx);
  const float4 bot = lerp4(t01, t11, fx);
  out[i] = lerp4(top, bot, fy);
}

}  // namespace

extern "C" int dxrpt_bilinear_tap(const void* texels, const void* uv,
                                  int64_t uv_row, int64_t uv_col,
                                  const void* base, int64_t base_stride,
                                  const void* w, int64_t w_stride,
                                  const void* h, int64_t h_stride, void* out,
                                  int64_t n, void* stream) {
  if (n <= 0) return 0;
  const int64_t grid = (n + kThreads - 1) / kThreads;
  bilinear_tap_kernel<<<(unsigned)grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(texels), static_cast<const float*>(uv),
      uv_row, uv_col, static_cast<const int32_t*>(base), base_stride,
      static_cast<const int32_t*>(w), w_stride,
      static_cast<const int32_t*>(h), h_stride, static_cast<float4*>(out), n);
  return (int)cudaGetLastError();
}

// Warps of bilinear_tap_kernel one SM holds at once (-1 on error).
extern "C" int dxrpt_tap_resident_warps() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, bilinear_tap_kernel, kThreads, 0) != cudaSuccess) {
    return -1;
  }
  return blocks * kThreads / 32;
}
