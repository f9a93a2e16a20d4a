// Fused per-pixel frame kernel: view ray -> sheared-table texel -> packed
// value -> hit point -> voxel-centre normal -> Lambert + shadow -> 0xRRGGBB.
//
// Replaces the TPU kernel ray_tracing_octrees_tpu/trace/warp_kernel.py::
// _warp_frame_kernel. It computes what that kernel computes, op for op in
// f32 (warp_kernel.py:316-413), but not how: the TPU kernel splits the f32
// table into bf16 hi/lo planes and looks texels up with one-hot MXU
// contractions over 128-lane groups and a u-window. Here each thread reads
// its one texel from the f32 table straight from memory; the table (4 MB
// at 1024x1024) stays resident in the H100's 50 MB L2. With no window the
// kernel never refuses a camera.
//
// Bound on an H100 SXM: at 1920x1080 the kernel writes 8.3 MB of int32
// output and reads at most one f32 texel per pixel, so about 2.5 us of DRAM
// traffic at 3.35 TB/s (3.7 us counting the whole 4 MB table read once).
// This first version is simple and right, not fast: one thread per pixel,
// no tiling, no vectorised stores.
//
// Built with -fmad=false (see trace/_build.py): contracting a*b+c into one
// FMA changes the rounding of the ray/plane math, which moves ulp-boundary
// texels against the plain PyTorch version (warp_kernel.warp_frame_reference,
// which rounds every op). Every division and sqrt is IEEE (no fast math).

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

__global__ void warp_frame_kernel(const float* __restrict__ table, int th,
                                  int tw, Scalars ks, int32_t* __restrict__ out,
                                  int width, int height, float sx, float sy,
                                  int s_idx, int a_idx, int b_idx,
                                  int has_shadow) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  const float* k = ks.v;

  // view ray (unnormalised), world space
  const float nx = (((float)x + 0.5f) * sx - 1.0f) * k[KS_AXF];
  const float ny = (1.0f - ((float)y + 0.5f) * sy) * k[KS_TANH];
  float d3[3];
  for (int r = 0; r < 3; ++r)
    d3[r] = nx * k[KS_R + 3 * r] + ny * k[KS_R + 3 * r + 1] - k[KS_R + 3 * r + 2];
  const float d_s = d3[s_idx], d_a = d3[a_idx], d_b = d3[b_idx];

  // reference-plane intersection -> table coordinates
  const float vox = k[KS_VOX];
  const float eye_s = k[KS_EYE_S];
  float denom = d_s / vox;
  if (fabsf(denom) < 1e-12f) denom = 1e-12f;
  const float t_rp = (k[KS_Z0] - eye_s) / denom;
  const float a_ref = k[KS_EYE_A] + d_a / vox * t_rp;
  const float b_ref = k[KS_EYE_B] + d_b / vox * t_rp;
  const bool behind = t_rp <= 0.0f;
  const float uu = (a_ref - k[KS_AMIN]) * k[KS_SCA];
  const float vv = (b_ref - k[KS_BMIN]) * k[KS_SCB];
  const bool oow = (uu < 0.0f) | (uu >= (float)th) | (vv < 0.0f) |
                   (vv >= (float)tw);

  // packed texel: k + 0.5 [+ 2048 shadow bit], or -1 for no hit
  float val = -1.0f;
  if (!(behind | oow)) {
    const int iu = min(max((int)uu, 0), th - 1);
    const int iv = min(max((int)vv, 0), tw - 1);
    val = __ldg(table + (size_t)iu * tw + iv);
  }

  // shade: hit point, voxel-centre normal, Lambert + ambient
  const bool hit = (val >= 0.0f) & !behind;
  const bool sh_bit = val >= 2048.0f;
  const float z_f = fmaxf(val - (sh_bit ? 2048.0f : 0.0f), 0.0f);
  const float d_len = sqrtf(d3[0] * d3[0] + d3[1] * d3[1] + d3[2] * d3[2]);
  float t_w = (z_f - eye_s) * vox * d_len / d_s;
  t_w = hit ? t_w : 0.0f;

  float ndl = 0.0f, nrm2 = 0.0f;
  const float nudge = 0.25f * vox;
  for (int c = 0; c < 3; ++c) {
    const float dir_c = d3[c] / d_len;
    const float p_c = k[KS_CAM + c] + dir_c * t_w;
    const float pin_c = p_c + dir_c * nudge;
    const float org_c = k[KS_ORG + c];
    const float cen_c = org_c + (floorf((pin_c - org_c) / vox) + 0.5f) * vox;
    const float n_c = p_c - cen_c;
    nrm2 = nrm2 + n_c * n_c;
    ndl = ndl + n_c * k[KS_L + c];
  }
  const float ndotl = fmaxf(0.0f, -ndl / fmaxf(sqrtf(nrm2), 1e-12f));

  int32_t packed = 0;
  for (int c = 0; c < 3; ++c) {
    float col = k[KS_BASE + c] * ndotl + k[KS_AMB + c];
    if (has_shadow && sh_bit) col = k[KS_AMB + c];
    if (!hit) col = 0.0f;
    const float q = fminf(fmaxf(col * 255.0f + 0.5f, 0.0f), 255.0f);
    packed = (packed << 8) | (int32_t)q;
  }
  out[(size_t)y * width + x] = packed;
}

}  // namespace

// Launch on `stream` (a cudaStream_t as void*). `kscal` is a HOST pointer
// to the 35 f32 frame scalars; they ride in the kernel's parameter block.
// Returns cudaGetLastError() (0 on success). Does not synchronise.
extern "C" int warp_frame_launch(const float* table, int th, int tw,
                                 const float* kscal, int32_t* out, int width,
                                 int height, float sx, float sy, int s_idx,
                                 int a_idx, int b_idx, int has_shadow,
                                 void* stream) {
  Scalars ks;
  for (int i = 0; i < KS_N; ++i) ks.v[i] = kscal[i];
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y);
  warp_frame_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      table, th, tw, ks, out, width, height, sx, sy, s_idx, a_idx, b_idx,
      has_shadow);
  return (int)cudaGetLastError();
}
