// Fused per-pixel frame kernel: view ray -> sheared-table texel -> packed
// value -> hit point -> voxel-centre normal -> Lambert + shadow -> 0xRRGGBB.
//
// Replaces the TPU kernel ray_tracing_octrees_tpu/trace/warp_kernel.py::
// _warp_frame_kernel. It computes what that kernel computes, op for op in
// f32 (warp_kernel.py:316-413), but not how: the TPU kernel splits the f32
// table into bf16 hi/lo planes and looks texels up with one-hot MXU
// contractions over 128-lane groups and a u-window. Here each thread reads
// its texels from the f32 table straight from memory; the table (4 MB at
// 1024x1024) stays resident in the H100's 50 MB L2. With no window the
// kernel never refuses a camera.
//
// Built with -fmad=false (see trace/_build.py): contracting a*b+c into one
// FMA changes the rounding of the ray/plane math, which moves ulp-boundary
// texels against the plain PyTorch version (warp_kernel.warp_frame_reference,
// which rounds every op). Every division and sqrt is IEEE (no fast math).
//
// Bound on an H100 SXM: instruction issue, not memory. At 1920x1080 the
// kernel writes 8.3 MB and reads about 27 K distinct texels, 2.5 us at
// 3.35 TB/s; but a pixel that shades runs 12 IEEE divisions and 2 IEEE
// square roots (8-13 instructions each) beside some 117 unfused f32
// operations, 250-350 instructions. The design cuts the instructions a
// pixel issues, every cut exact by construction:
//   - compile-time sweep axis and shadow flag: the ray's sweep, A and B
//     components are named registers, never a runtime index into an array
//     (the first port's kernel indexed one and kept a 16-byte stack
//     frame);
//   - a miss (no texel, a -1 texel, or behind the reference plane) packs
//     to 0, and with shadows on a shadowed hit to the per-frame ambient
//     word, computed once on the host with the same f32 rounding
//     (warp_kernel.ambient_word): both are selects in the plain version,
//     whatever the shading gives, so such pixels stop after the texel;
//   - a lit hit whose normal faces away from the light also packs to the
//     ambient word (Lambert's max(0, .) gives +-0), so it skips the
//     normal's length and the last division;
//   - where vox's f32 reciprocal is exact (vox a power of two, as the
//     sphere scenes' 1/dim), the six divisions by vox are multiplications
//     by it: both round the same real number (the second compile-time
//     flag; other scenes keep the divisions);
//   - four neighbouring pixels of one row per thread: the y-only terms
//     (ny and ny * R[3r+1], the same rounded values for all four) once,
//     all four texel loads in flight before any shading, one 16-byte
//     store where the width is a multiple of 4 (else masked 4-byte
//     stores); a warp covers a 16 x 8 pixel patch, so silhouettes and
//     shadow edges split as few warps as possible.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// kscal slot layout (warp_kernel.py:303-307)
constexpr int KS_AXF = 0, KS_TANH = 1, KS_EYE_S = 2, KS_EYE_A = 3,
              KS_EYE_B = 4, KS_Z0 = 5, KS_AMIN = 6, KS_SCA = 7, KS_BMIN = 8,
              KS_SCB = 9, KS_VOX = 10, KS_ORG = 11, KS_CAM = 14, KS_L = 17,
              KS_BASE = 20, KS_AMB = 23, KS_R = 26, KS_N = 35;

struct Scalars {
  float v[KS_N];
};

// A block is 8 warps in a 4 x 2 grid, each warp 4 x 8 threads of 4 pixels
// in a row: the block covers 64 x 16 pixels, a warp 16 x 8.
constexpr int kThreads = 256;
constexpr int kPx = 4;          // pixels a thread holds, neighbours in a row
constexpr int kBlockW = 64, kBlockH = 16;

// world-axis index of the sweep (S), A and B components per sweep axis
template <int AW>
struct Axes {
  static constexpr int S = AW;
  static constexpr int A = AW == 0 ? 1 : 0;
  static constexpr int B = AW == 2 ? 1 : 2;
};

// x / vox. With POW2 the host has found vox's f32 reciprocal exact
// (inv * vox == 1 in real arithmetic, so vox is a power of two): x * inv
// and x / vox are then the same real number, rounded once, for every x.
template <bool POW2>
__device__ __forceinline__ float div_vox(float x, float vox, float inv) {
  return POW2 ? x * inv : x / vox;
}

// The packed 0xRRGGBB of a hit that is lit (with shadows on, no shadow
// bit): depth, hit point, voxel-centre normal, Lambert + ambient, as the
// plain version computes it. Where the normal faces away from the light
// (!(ndl < 0)) the plain version's ndotl is +-0, so with finite base
// colours (`back_exit`) the colour is the ambient word; the square root
// and the division of ndotl are skipped there.
template <bool POW2>
__device__ __forceinline__ int32_t shade_lit(const float* k, float inv_vox,
                                             int back_exit, int32_t amb_word,
                                             float val, float d0, float d1,
                                             float d2, float d_s) {
  const float vox = k[KS_VOX];
  const bool sh_bit = val >= 2048.0f;
  const float z_f = fmaxf(val - (sh_bit ? 2048.0f : 0.0f), 0.0f);
  const float d_len = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
  const float t_w = (z_f - k[KS_EYE_S]) * vox * d_len / d_s;

  const float d3[3] = {d0, d1, d2};
  float n[3];
  float ndl = 0.0f;
  const float nudge = 0.25f * vox;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float dir_c = d3[c] / d_len;
    const float p_c = k[KS_CAM + c] + dir_c * t_w;
    const float pin_c = p_c + dir_c * nudge;
    const float org_c = k[KS_ORG + c];
    const float cen_c =
        org_c + (floorf(div_vox<POW2>(pin_c - org_c, vox, inv_vox)) + 0.5f) *
                    vox;
    n[c] = p_c - cen_c;
    ndl = ndl + n[c] * k[KS_L + c];
  }
  if (back_exit && !(ndl < 0.0f)) return amb_word;
  float nrm2 = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) nrm2 = nrm2 + n[c] * n[c];
  const float ndotl = fmaxf(0.0f, -ndl / fmaxf(sqrtf(nrm2), 1e-12f));

  int32_t packed = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float col = k[KS_BASE + c] * ndotl + k[KS_AMB + c];
    const float q = fminf(fmaxf(col * 255.0f + 0.5f, 0.0f), 255.0f);
    packed = (packed << 8) | (int32_t)q;
  }
  return packed;
}

template <int AW, bool SHADOW, bool POW2>
__global__ void __launch_bounds__(kThreads)
    warp_frame_kernel(const float* __restrict__ table, int th, int tw,
                      Scalars ks, int32_t* __restrict__ out, int width,
                      int height, float sx, float sy, int32_t amb_word,
                      float inv_vox, int back_exit) {
  using Ax = Axes<AW>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int y = blockIdx.y * kBlockH + (warp >> 2) * 8 + (lane >> 2);
  const int x0 = blockIdx.x * kBlockW + (warp & 3) * 16 + (lane & 3) * kPx;
  if (y >= height || x0 >= width) return;
  const float* k = ks.v;
  const float vox = k[KS_VOX];
  const float eye_s = k[KS_EYE_S];

  // the row's terms, once for the thread's four pixels
  const float ny = (1.0f - ((float)y + 0.5f) * sy) * k[KS_TANH];
  float ny_r[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) ny_r[r] = ny * k[KS_R + 3 * r + 1];

  // view ray, reference-plane intersection and texel of every pixel; all
  // four texel loads issue before any shading
  float d[kPx][3], val[kPx];
#pragma unroll
  for (int j = 0; j < kPx; ++j) {
    const int x = x0 + j;
    const float nx = (((float)x + 0.5f) * sx - 1.0f) * k[KS_AXF];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      d[j][r] = nx * k[KS_R + 3 * r] + ny_r[r] - k[KS_R + 3 * r + 2];
    const float d_s = d[j][Ax::S], d_a = d[j][Ax::A], d_b = d[j][Ax::B];
    float denom = div_vox<POW2>(d_s, vox, inv_vox);
    if (fabsf(denom) < 1e-12f) denom = 1e-12f;
    const float t_rp = (k[KS_Z0] - eye_s) / denom;
    const float a_ref = k[KS_EYE_A] + div_vox<POW2>(d_a, vox, inv_vox) * t_rp;
    const float b_ref = k[KS_EYE_B] + div_vox<POW2>(d_b, vox, inv_vox) * t_rp;
    const bool behind = t_rp <= 0.0f;
    const float uu = (a_ref - k[KS_AMIN]) * k[KS_SCA];
    const float vv = (b_ref - k[KS_BMIN]) * k[KS_SCB];
    const bool oow = (uu < 0.0f) | (uu >= (float)th) | (vv < 0.0f) |
                     (vv >= (float)tw);
    val[j] = -1.0f;
    if ((x < width) & !(behind | oow)) {
      const int iu = min(max((int)uu, 0), th - 1);
      const int iv = min(max((int)vv, 0), tw - 1);
      val[j] = __ldg(table + (size_t)iu * tw + iv);
    }
  }

  // A texel >= 0 was loaded, so the ray is not behind the plane: hit is
  // the plain version's (val >= 0) & !behind. A miss packs to 0 and, with
  // shadows on, a shadowed hit to the ambient word: selects in the plain
  // version, whatever the shading gives.
  int32_t packed[kPx];
#pragma unroll
  for (int j = 0; j < kPx; ++j) {
    if (!(val[j] >= 0.0f))
      packed[j] = 0;
    else if (SHADOW && val[j] >= 2048.0f)
      packed[j] = amb_word;
    else
      packed[j] = shade_lit<POW2>(k, inv_vox, back_exit, amb_word, val[j],
                                  d[j][0], d[j][1], d[j][2], d[j][Ax::S]);
  }

  // one 16-byte store where the width is a multiple of 4 (the row, and so
  // the thread's four pixels, then start 16-byte aligned); else the
  // pixels inside the frame one by one
  int32_t* row = out + (size_t)y * width;
  if (width % kPx == 0) {
    *reinterpret_cast<int4*>(row + x0) =
        make_int4(packed[0], packed[1], packed[2], packed[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPx; ++j)
      if (x0 + j < width) row[x0 + j] = packed[j];
  }
}

using FrameKernel = void (*)(const float*, int, int, Scalars, int32_t*, int,
                             int, float, float, int32_t, float, int);

// [axis_world][has_shadow][vox's reciprocal exact]
const FrameKernel kKernels[3][2][2] = {
    {{warp_frame_kernel<0, false, false>, warp_frame_kernel<0, false, true>},
     {warp_frame_kernel<0, true, false>, warp_frame_kernel<0, true, true>}},
    {{warp_frame_kernel<1, false, false>, warp_frame_kernel<1, false, true>},
     {warp_frame_kernel<1, true, false>, warp_frame_kernel<1, true, true>}},
    {{warp_frame_kernel<2, false, false>, warp_frame_kernel<2, false, true>},
     {warp_frame_kernel<2, true, false>, warp_frame_kernel<2, true, true>}},
};

Scalars to_scalars(const float* kscal) {
  Scalars ks;
  for (int i = 0; i < KS_N; ++i) ks.v[i] = kscal[i];
  return ks;
}

}  // namespace

// Launch on `stream` (a cudaStream_t as void*). `kscal` is a HOST pointer
// to the 35 f32 frame scalars; they ride in the kernel's parameter block
// beside the host's exact values of three of their functions
// (warp_kernel.py): `amb_word`, the packed ambient colour; `inv_vox`,
// vox's f32 reciprocal where it is exact, else 0; `back_exit`, whether
// the base colours are finite. `axis_world` in {0, 1, 2}; `out`
// int32[height, width], 16-byte aligned. Returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for an axis out of range. Does not
// synchronise.
extern "C" int warp_frame_launch(const float* table, int th, int tw,
                                 const float* kscal, int32_t* out, int width,
                                 int height, float sx, float sy,
                                 int axis_world, int has_shadow,
                                 int32_t amb_word, float inv_vox,
                                 int back_exit, void* stream) {
  if (axis_world < 0 || axis_world > 2) return (int)cudaErrorInvalidValue;
  const FrameKernel kern =
      kKernels[axis_world][has_shadow ? 1 : 0][inv_vox != 0.0f ? 1 : 0];
  const dim3 grid((width + kBlockW - 1) / kBlockW,
                  (height + kBlockH - 1) / kBlockH);
  kern<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      table, th, tw, to_scalars(kscal), out, width, height, sx, sy, amb_word,
      inv_vox, back_exit);
  return (int)cudaGetLastError();
}
