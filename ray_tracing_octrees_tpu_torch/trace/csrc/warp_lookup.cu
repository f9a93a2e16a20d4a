// Per-pixel table lookup: out[p][y, x] = T[p][lin >> 10, lin & 1023], with
// the miss sentinel where lin < 0 (-1 in plane 0, 0 in the other planes).
//
// Replaces two TPU kernels of ray_tracing_octrees_tpu/trace/warp_kernel.py:
//   - _warp_onehot_kernel (warp_lookup, one logical plane), entry point
//     warp_lookup_launch;
//   - _warp_multi_kernel (warp_lookup_multi, P logical planes sharing one
//     lin field), entry point warp_lookup_multi_launch.
// Both compute a gather. The TPU kernels reach it through one-hot MXU
// contractions over 128-lane v-groups and a u-window, on bf16 hi/lo(/mid)
// splits of the f32 table; all of that exists only for the MXU. Here each
// thread decodes its pixel's lin once and reads one f32 texel per plane
// straight from memory, so every table of width <= 1024 is taken and no
// camera is refused. A gather has no rounding: the result is bitwise the
// plain PyTorch version's (warp_kernel.warp_lookup_reference).
//
// Indices past the table (iu >= TH or iv >= TW, which no caller makes)
// clamp to its edge, as the plain version does, so no read leaves the
// table.
//
// Bound on an H100 SXM: the bytes. Per pixel the kernel reads 4 bytes of
// lin and writes 4 bytes per plane; each table plane is read at most once
// (4.2 MB at 1024x1024, L2-resident in the 50 MB L2). At 1920x1080 that is
// (16.6 + 4.2) MB / 3.35 TB/s = 6.2 us for one plane and
// (33.2 + 12.6) MB / 3.35 TB/s = 13.7 us for three. This first version is
// simple and right: one thread per pixel, coalesced lin reads and output
// writes, one texel load per plane.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void warp_lookup_kernel(const float* __restrict__ tables,
                                   int planes, int th, int tw,
                                   const int32_t* __restrict__ lin,
                                   float* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t l = __ldg(lin + i);
  const int64_t plane = (int64_t)th * tw;
  if (l < 0) {
    out[i] = -1.0f;
    for (int p = 1; p < planes; ++p) out[p * n + i] = 0.0f;
    return;
  }
  const int iu = min(l >> 10, th - 1);
  const int iv = min(l & 1023, tw - 1);
  const float* t = tables + (int64_t)iu * tw + iv;
  for (int p = 0; p < planes; ++p) out[p * n + i] = __ldg(t + p * plane);
}

int launch(const float* tables, int planes, int th, int tw,
           const int32_t* lin, float* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const int block = 256;
  const int64_t grid = (n + block - 1) / block;
  warp_lookup_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      tables, planes, th, tw, lin, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

// One plane: `table` f32[th, tw], `lin` i32[n], `out` f32[n]. Launches on
// `stream` (a cudaStream_t as void*), does not synchronise, and returns
// cudaGetLastError() (0 on success).
extern "C" int warp_lookup_launch(const float* table, int th, int tw,
                                  const int32_t* lin, float* out, int64_t n,
                                  void* stream) {
  return launch(table, 1, th, tw, lin, out, n, stream);
}

// P planes: `tables` f32[planes, th, tw], `lin` i32[n], `out`
// f32[planes, n]. Same launch contract as warp_lookup_launch.
extern "C" int warp_lookup_multi_launch(const float* tables, int planes,
                                        int th, int tw, const int32_t* lin,
                                        float* out, int64_t n, void* stream) {
  return launch(tables, planes, th, tw, lin, out, n, stream);
}
