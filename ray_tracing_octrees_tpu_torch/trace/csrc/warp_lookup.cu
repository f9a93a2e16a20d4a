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
// thread decodes its pixels' lin and reads one f32 texel per plane
// straight from memory, so every table of width <= 1024 is taken and no
// camera is refused. A gather has no rounding: the result is bitwise the
// plain PyTorch version's (warp_kernel.warp_lookup_reference).
//
// Indices past the table (iu >= TH or iv >= TW, which no caller makes)
// clamp to its edge, as the plain version does, so no read leaves the
// table.
//
// Bound on an H100 SXM: the bytes. Per pixel the kernel reads 4 bytes of
// lin and writes 4 bytes per plane; each table plane's distinct texels are
// read once (a frame names a few tens of thousands of a 1024x1024 table,
// so the table is served from L1 and L2). At 1920x1080, one plane, that is
// about 16.7 MB, 5.0 us at 3.35 TB/s; three planes from one lin move
// about 41 MB, 12.3 us.
//
// The single-plane entry is built for Hopper, because one thread per pixel
// left each thread one dependent chain (a lin load, an address, a texel
// load, a store) and the card waited on latency:
//   - the vector form: a thread takes a run of four neighbouring pixels,
//     reads their lin with one 16-byte load (a warp's loads and stores
//     cover 512 contiguous bytes), issues all four texel loads before its
//     store (a miss loads nothing and writes -1), and writes the run with
//     one 16-byte store; offsets are 32-bit (the wrapper takes
//     TH * TW <= 2^31 and sends n >= 2^31 to the general form). Eight
//     pixels a thread (two runs) measured 4.7 us against four's 4.3 at
//     1080p (PERF.md), so one run it is;
//   - the general form is the first port's kernel, warp_lookup_kernel, at
//     one plane: one pixel a thread, 64-bit offsets. It takes what the
//     vector form cannot: a lin field that is not 16-byte aligned (a
//     contiguous view at a storage offset), the last 1-3 pixels of a
//     field whose pixel count is not a multiple of 4 (the vector form
//     takes the rest), or n >= 2^31. The wrapper chooses the launches
//     (warp_kernel.lookup_forms) and counts each form's.
// The multi-plane entry launches the same first-port kernel at P planes:
// it reaches about half its bound and beats one torch.take of the same
// gather.

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

constexpr int kLookupThreads = 256;

// One plane, a run of four pixels a thread; n_runs = n / 4.
__global__ void __launch_bounds__(kLookupThreads)
    warp_lookup_vector_kernel(const float* __restrict__ table, int th,
                              int tw, const int32_t* __restrict__ lin,
                              float* __restrict__ out, int n_runs) {
  const int run = blockIdx.x * kLookupThreads + threadIdx.x;
  if (run >= n_runs) return;
  const int4 l = __ldg(reinterpret_cast<const int4*>(lin) + run);
  const int li[4] = {l.x, l.y, l.z, l.w};
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = -1.0f;
    if (li[i] >= 0)
      v[i] = __ldg(table + min(li[i] >> 10, th - 1) * tw +
                   min(li[i] & 1023, tw - 1));
  }
  reinterpret_cast<float4*>(out)[run] = make_float4(v[0], v[1], v[2], v[3]);
}

}  // namespace

// One plane: `table` f32[th, tw] with th * tw <= 2^31, `lin` i32[n],
// `out` f32[n]. `form` 0 launches the general form, 1 the vector form,
// which needs `lin` and `out` 16-byte aligned, n % 4 == 0 and n < 2^31.
// Launches on `stream` (a cudaStream_t as void*), does not synchronise,
// and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a form the arguments do not allow.
extern "C" int warp_lookup_launch(const float* table, int th, int tw,
                                  const int32_t* lin, float* out, int64_t n,
                                  int form, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (form == 1) {
    if (n % 4 != 0 || n >= ((int64_t)1 << 31) ||
        reinterpret_cast<uintptr_t>(lin) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    const int n_runs = (int)(n / 4);
    warp_lookup_vector_kernel<<<(n_runs + kLookupThreads - 1) /
                                    kLookupThreads,
                                kLookupThreads, 0, s>>>(table, th, tw, lin,
                                                        out, n_runs);
    return (int)cudaGetLastError();
  }
  if (form != 0) return (int)cudaErrorInvalidValue;
  return launch(table, 1, th, tw, lin, out, n, stream);
}

// P planes: `tables` f32[planes, th, tw], `lin` i32[n], `out`
// f32[planes, n]. Same launch contract as warp_lookup_launch.
extern "C" int warp_lookup_multi_launch(const float* tables, int planes,
                                        int th, int tw, const int32_t* lin,
                                        float* out, int64_t n, void* stream) {
  return launch(tables, planes, th, tw, lin, out, n, stream);
}
