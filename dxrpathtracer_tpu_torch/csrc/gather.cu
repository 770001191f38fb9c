// Row gather, out[i, :] = table[idx[i], :], for sm_90a.
//
// Replaces tools/microbench_dma_gather.py::dma_gather (its Pallas `kernel`),
// which issues one async DMA per row on the TPU and keeps 16 of them in
// flight to hide HBM latency. In the port this gather feeds the bake's
// surface maps (bake/surface_map.py) and the per-vertex 256 B shading row
// (render/integrator.py::_fetch_shade_inputs).
//
// Bound: bytes. A gather does no arithmetic: it reads n indices and n rows
// and writes n rows, so its least time is (n*width*4*2 + n*4) B over the
// card's memory rate. Rows are scattered, so what limits a simple kernel is
// the number of independent loads in flight, not the issue rate.
//
// Design (simple first):
//   - One thread per 16-byte vector of an output row when width % 4 == 0 and
//     both pointers are 16-byte aligned (`gather_rows<int4>`), else one
//     thread per 4-byte word (`gather_rows<int32_t>`). A row of width w is
//     copied by w/4 (or w) neighbouring threads, so their loads and stores
//     are contiguous.
//   - A grid-stride loop over the flattened (row, vector) elements, with a
//     grid of a few blocks per SM: every thread keeps several independent
//     row loads in flight, which takes the place of the TPU kernel's
//     k_slots outstanding DMAs.
//   - No shared memory. Rows are copied as raw 4-byte words, so any 4-byte
//     dtype (f32, i32) gathers bit for bit.
//
// Plain C interface for ctypes: the launcher returns the CUDA error code of
// the launch (0 on success) and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

int grid_for(int64_t total) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  // 8 blocks of 256 threads per SM fill its 2048 thread slots; more blocks
  // than elements would only idle.
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * 8;
  return (int)(want < cap ? want : cap);
}

// Index is uint32_t when the flattened element count fits (a 32-bit
// division is a few instructions; a 64-bit one is a long library sequence),
// else int64_t.
template <typename T, typename Index>
__global__ void __launch_bounds__(kThreads)
gather_rows(const T* __restrict__ table, const int32_t* __restrict__ idx,
            T* __restrict__ out, Index total, Index per_row) {
  const Index stride = (Index)gridDim.x * blockDim.x;
  for (Index e = (Index)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const Index row = e / per_row;
    const Index col = e - row * per_row;
    const int64_t src = (int64_t)__ldg(idx + row);
    out[e] = __ldg(table + src * (int64_t)per_row + (int64_t)col);
  }
}

template <typename T>
void launch(const void* table, const void* idx, void* out, int64_t total,
            int per_row, cudaStream_t s) {
  const int grid = grid_for(total);
  const T* t = static_cast<const T*>(table);
  const int32_t* i = static_cast<const int32_t*>(idx);
  T* o = static_cast<T*>(out);
  // stride additions stay below 2^32 too: e < total + grid * kThreads
  if (total + (int64_t)grid * kThreads <= (int64_t)UINT32_MAX) {
    gather_rows<T, uint32_t><<<grid, kThreads, 0, s>>>(
        t, i, o, (uint32_t)total, (uint32_t)per_row);
  } else {
    gather_rows<T, int64_t><<<grid, kThreads, 0, s>>>(
        t, i, o, total, (int64_t)per_row);
  }
}

}  // namespace

extern "C" int dxrpt_row_gather(const void* table, const void* idx, void* out,
                                int64_t n, int32_t width, void* stream) {
  if (n <= 0 || width <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out)) &
       15u) == 0;
  if (width % 4 == 0 && aligned) {
    launch<int4>(table, idx, out, n * (width / 4), width / 4, s);
  } else {
    launch<int32_t>(table, idx, out, n * width, width, s);
  }
  return (int)cudaGetLastError();
}
