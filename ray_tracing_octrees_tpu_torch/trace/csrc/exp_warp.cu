// The warp experiments' window lookups: four kernels, one per rule.
//
// Replaces the Pallas kernels of the retired TPU experiments under tools/:
//   1. onehot_window_kernel: tools/exp_onehot_warp.py _kernel and
//      _kernel_grouped, tools/exp_warp_tune.py _kernel, and
//      tools/exp_warp_tune2.py _k_slim and _k_persel (entry point
//      onehot_window_launch);
//   2. ablate_kernel: tools/exp_warp_ablate.py _k_null, _k_intops,
//      _k_twload and _k_select (ablate_launch);
//   3. row_window_kernel: tools/exp_warp_kernel.py _warp_kernel and
//      tools/exp_warp2pass.py _pass1_kernel (row_window_launch);
//   4. col_window_kernel: tools/exp_warp2pass.py _pass2_kernel
//      (col_window_launch).
//
// Every TPU kernel reaches a per-pixel texel through MXU machinery (one-hot
// bf16 contractions over 128-lane groups, a select by a second product or a
// masked sum, a fori_loop over window rows). That machinery is not the
// spec; the window rule it implements is, and each kernel here computes
// that rule directly: one thread block per tile takes the block-wide min of
// the tile's row (or column) index, clamps it into the table, and every
// thread then reads its pixels' texels straight from memory. Pixels whose
// index leaves the tile's window are clamped into it (1, 2) or zeroed
// (3, 4), as the TPU kernels do. The rules, bitwise:
//   1. iu = lin < 0 ? TH-1 : lin >> 10, iv = lin & 1023;
//      umin = (clip(min iu, 0, TH-win) >> 3) << 3 per ty x tx tile;
//      u' = umin + clip(iu - umin, 0, win-1);
//      out = lin < 0 ? -1 : f32(hi[u', iv]) + f32(lo[u', iv]).
//   2. the same umin (8 x 128 tiles, win 64), rel = clip(iu - umin, 0, 63):
//      null 0; intops f32(rel + iv + umin); twload f32(hi[umin, x % 128]) +
//      f32(rel); select f32(3 iv); -1 where lin < 0 except for null.
//   3. umin = clip(min iu, 0, TH-win) per 8 x 128 tile (no rounding);
//      out = 0 <= iu - umin < win ? 0 + T[iu, col] : 0, col = iv[y, x] or,
//      for the two-pass warp's first pass, the pixel's own column x.
//   4. tiles of 8 x-columns by 128 y-rows of the transposed image, y padded
//      with zeros to a multiple of 128 (the padded zeros take part in the
//      min); vmin = clip(min iv, 0, V-win);
//      out[y, x] = 0 <= iv - vmin < win ? 0 + M[y, iv] : 0.
// Each output is at most one f32 add of exact operands, and the build has
// -fmad=false, so the kernels equal their plain PyTorch versions bit for
// bit (`0 + t` turns a -0 texel into +0, as the TPU kernels' sums do).
//
// Bound on an H100 SXM: the bytes (a few integer operations per pixel).
// Per pixel each kernel reads its index fields once and writes 4 bytes;
// the table is read at most once (4.2 MB at 1024 x 1024, in bf16 hi/lo or
// f32, L2-resident in the 50 MB L2). At 1920 x 1088: 6.24 us for 1,
// 2.49 us (null) to 4.99 us for 2, 8.73 us for 3 and 6.32 us for 4. This
// first version is simple and right: coalesced index reads and output
// writes along x, the tile's index field read twice (the min, then the
// values; the second read hits L1/L2), one texel load per pixel.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float bf16_to_f32(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// Block-wide min of one value per thread; every thread gets the result.
// Called once per kernel (the shared slots are not reused).
__device__ __forceinline__ int block_min(int v) {
  __shared__ int warp_min[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_min[warp] = v;
  __syncthreads();
  v = warp_min[0];
  for (int w = 1; w < kThreads / 32; ++w) v = min(v, warp_min[w]);
  return v;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// 1. One-hot window lookup on the hi/lo split. Grid (W / tx, H / ty).
__global__ void __launch_bounds__(kThreads) onehot_window_kernel(
    const uint16_t* __restrict__ t_hl, int th, int tw,
    const int32_t* __restrict__ lin, float* __restrict__ out, int width,
    int ty, int tx, int win) {
  const int tile_px = ty * tx;
  const int64_t y0 = (int64_t)blockIdx.y * ty;
  const int x0 = blockIdx.x * tx;
  int m = INT_MAX;
  for (int p = threadIdx.x; p < tile_px; p += kThreads) {
    const int32_t l = __ldg(lin + (y0 + p / tx) * width + x0 + p % tx);
    m = min(m, l < 0 ? th - 1 : (l >> 10));
  }
  const int umin = (clampi(block_min(m), 0, th - win) >> 3) << 3;
  const int64_t lo_plane = (int64_t)th * tw;
  for (int p = threadIdx.x; p < tile_px; p += kThreads) {
    const int64_t i = (y0 + p / tx) * width + x0 + p % tx;
    const int32_t l = __ldg(lin + i);
    if (l < 0) {
      out[i] = -1.0f;
      continue;
    }
    const int u = umin + clampi((l >> 10) - umin, 0, win - 1);
    const int64_t off = (int64_t)u * tw + (l & 1023);
    out[i] = __fadd_rn(bf16_to_f32(__ldg(t_hl + off)),
                       bf16_to_f32(__ldg(t_hl + lo_plane + off)));
  }
}

// 2. The four ablations of 1, on 8 x 128 tiles with a 64-row window.
// kind: 0 null, 1 intops, 2 twload, 3 select. Grid (W / 128, H / 8).
__global__ void __launch_bounds__(kThreads) ablate_kernel(
    const uint16_t* __restrict__ t_hl, int th, int tw,
    const int32_t* __restrict__ lin, float* __restrict__ out, int width,
    int kind) {
  constexpr int kTy = 8, kTx = 128, kWin = 64;
  const int64_t y0 = (int64_t)blockIdx.y * kTy;
  const int x0 = blockIdx.x * kTx;
  if (kind == 0) {
    for (int p = threadIdx.x; p < kTy * kTx; p += kThreads)
      out[(y0 + p / kTx) * width + x0 + p % kTx] = 0.0f;
    return;
  }
  int m = INT_MAX;
  for (int p = threadIdx.x; p < kTy * kTx; p += kThreads) {
    const int32_t l = __ldg(lin + (y0 + p / kTx) * width + x0 + p % kTx);
    m = min(m, l < 0 ? th - 1 : (l >> 10));
  }
  const int umin = (clampi(block_min(m), 0, th - kWin) >> 3) << 3;
  for (int p = threadIdx.x; p < kTy * kTx; p += kThreads) {
    const int64_t i = (y0 + p / kTx) * width + x0 + p % kTx;
    const int32_t l = __ldg(lin + i);
    if (l < 0) {
      out[i] = -1.0f;
      continue;
    }
    const int rel = clampi((l >> 10) - umin, 0, kWin - 1);
    const int iv = l & 1023;
    float v;
    if (kind == 1) {
      v = (float)(rel + iv + umin);
    } else if (kind == 2) {
      v = __fadd_rn(bf16_to_f32(__ldg(t_hl + (int64_t)umin * tw + p % kTx)),
                    (float)rel);
    } else {
      v = (float)(3 * iv);
    }
    out[i] = v;
  }
}

// 3. f32 row-window select on 8 x 128 tiles. col_idx null: the column is
// the pixel's own x (the two-pass warp's first pass). Grid (W / 128, H / 8).
__global__ void __launch_bounds__(kThreads) row_window_kernel(
    const float* __restrict__ table, int th, int tc,
    const int32_t* __restrict__ row_idx, const int32_t* __restrict__ col_idx,
    float* __restrict__ out, int width, int win) {
  constexpr int kTy = 8, kTx = 128;
  const int64_t y0 = (int64_t)blockIdx.y * kTy;
  const int x0 = blockIdx.x * kTx;
  int m = INT_MAX;
  for (int p = threadIdx.x; p < kTy * kTx; p += kThreads)
    m = min(m, __ldg(row_idx + (y0 + p / kTx) * width + x0 + p % kTx));
  const int umin = clampi(block_min(m), 0, th - win);
  for (int p = threadIdx.x; p < kTy * kTx; p += kThreads) {
    const int64_t i = (y0 + p / kTx) * width + x0 + p % kTx;
    const int32_t u = __ldg(row_idx + i);
    const int64_t rel = (int64_t)u - umin;
    float v = 0.0f;
    if (rel >= 0 && rel < win) {
      const int col = col_idx ? __ldg(col_idx + i) : x0 + p % kTx;
      v = __fadd_rn(0.0f, __ldg(table + (int64_t)u * tc + col));
    }
    out[i] = v;
  }
}

// 4. f32 column-window select for the two-pass warp's second pass, on
// tiles of 8 x by 128 y of the transposed image (y padded to a multiple of
// 128 with zero indices). Grid (W / 8, ceil(H / 128)).
__global__ void __launch_bounds__(kThreads) col_window_kernel(
    const float* __restrict__ m_rows, int height, int mv,
    const int32_t* __restrict__ col_idx, float* __restrict__ out, int width,
    int win) {
  constexpr int kTx = 8, kTy = 128;
  const int y0 = blockIdx.y * kTy;
  const int x0 = blockIdx.x * kTx;
  int m = INT_MAX;
  for (int p = threadIdx.x; p < kTy * kTx; p += kThreads) {
    const int y = y0 + p / kTx;
    m = min(m, y < height
                   ? __ldg(col_idx + (int64_t)y * width + x0 + p % kTx) : 0);
  }
  const int vmin = clampi(block_min(m), 0, mv - win);
  for (int p = threadIdx.x; p < kTy * kTx; p += kThreads) {
    const int y = y0 + p / kTx;
    if (y >= height) continue;
    const int64_t i = (int64_t)y * width + x0 + p % kTx;
    const int32_t v_idx = __ldg(col_idx + i);
    const int64_t rel = (int64_t)v_idx - vmin;
    float v = 0.0f;
    if (rel >= 0 && rel < win)
      v = __fadd_rn(0.0f, __ldg(m_rows + (int64_t)y * mv + v_idx));
    out[i] = v;
  }
}

}  // namespace

// Launch contract of every entry point: it launches on `stream` (a
// cudaStream_t as void*), does not synchronise, and returns
// cudaGetLastError() (0 on success). The wrappers check shapes, types and
// divisibility before they call.

// `t_hl` bf16 bits [2 th, tw] (hi rows, then lo rows), `lin` / `out`
// [height, width] with height % ty == 0 and width % tx == 0.
extern "C" int onehot_window_launch(const uint16_t* t_hl, int th, int tw,
                                    const int32_t* lin, float* out,
                                    int height, int width, int ty, int tx,
                                    int win, void* stream) {
  if (height <= 0 || width <= 0) return 0;
  const dim3 grid(width / tx, height / ty);
  onehot_window_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      t_hl, th, tw, lin, out, width, ty, tx, win);
  return (int)cudaGetLastError();
}

// As onehot_window_launch, with 8 x 128 tiles and `kind` 0-3.
extern "C" int ablate_launch(const uint16_t* t_hl, int th, int tw,
                             const int32_t* lin, float* out, int height,
                             int width, int kind, void* stream) {
  if (height <= 0 || width <= 0) return 0;
  const dim3 grid(width / 128, height / 8);
  ablate_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      t_hl, th, tw, lin, out, width, kind);
  return (int)cudaGetLastError();
}

// `table` f32 [th, tc]; `row_idx`, `col_idx` (or null), `out`
// [height, width] with height % 8 == 0 and width % 128 == 0.
extern "C" int row_window_launch(const float* table, int th, int tc,
                                 const int32_t* row_idx,
                                 const int32_t* col_idx, float* out,
                                 int height, int width, int win,
                                 void* stream) {
  if (height <= 0 || width <= 0) return 0;
  const dim3 grid(width / 128, height / 8);
  row_window_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      table, th, tc, row_idx, col_idx, out, width, win);
  return (int)cudaGetLastError();
}

// `m_rows` f32 [height, mv]; `col_idx`, `out` [height, width] with
// width % 8 == 0.
extern "C" int col_window_launch(const float* m_rows, int mv,
                                 const int32_t* col_idx, float* out,
                                 int height, int width, int win,
                                 void* stream) {
  if (height <= 0 || width <= 0) return 0;
  const dim3 grid(width / 8, (height + 127) / 128);
  col_window_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      m_rows, height, mv, col_idx, out, width, win);
  return (int)cudaGetLastError();
}
