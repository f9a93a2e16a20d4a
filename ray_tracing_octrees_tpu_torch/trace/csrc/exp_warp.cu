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
//   4. col_window_vector_kernel, and col_window_kernel as its general form:
//      tools/exp_warp2pass.py _pass2_kernel (col_window_launch).
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
// f32, L2-resident in the 50 MB L2). At 1920 x 1088 kernel 1 moves 8 bytes
// a pixel plus its distinct texels (about 5.0 us at 3.35 TB/s), kernel 3
// 12 bytes a pixel plus its texels (about 7.5 us), kernel 4 8 bytes a pixel
// plus its distinct texels of M (about 5.0-6.3 us); a frame's index field
// is new on every frame, so it comes from device memory, not from L2.
//
// Kernels 1 and 3, the gathers, are built for Hopper:
//   - a compile-time tile: one instantiation per tile the experiments use
//     (kernel 1: 8x128, 16x128, 32x128, 16x256; kernel 3: 8x128), so a
//     pixel's row and column are shifts and masks, on 32-bit offsets (the
//     wrappers check that the image and the table hold fewer than 2^31
//     elements);
//   - one read of each index field: a thread loads its TY*TX/256 pixels'
//     indices into registers with 16-byte loads, takes their min there,
//     then __reduce_min_sync within the warp, one shared slot per warp and
//     one barrier; it decodes and gathers from its registers;
//   - all texel loads of a thread in flight before the first add (its loop
//     over its pixels is unrolled; a pixel that needs no texel loads the
//     table's first one), and the outputs written as 16-byte stores;
//   - any other tile, and index fields that are not 16-byte aligned (a
//     contiguous view at a storage offset; the output is a fresh, aligned
//     allocation), take the general instantiation: the tile at run time,
//     4-byte loads and stores, at most kMaxPx pixels a thread (a tile of
//     at most 4096), each index field still read once.
//   - not taken, measured: a persistent grid (about as many blocks as fit
//     on the card, each walking tiles and staging the next tile's indices
//     into a two-slot shared ring with cp.async) took 1.03-1.22 times the
//     time of one tile per block for kernel 1 at 8 x 128, the experiments'
//     main tile (kernel 3: 0.99-1.07), and 0.97-1.05 times at the larger
//     tiles (PERF.md): 2,040 tiles of 8 x 128 already keep about two waves
//     of blocks resident.
// Not taken: fetching hi and lo as one 4-byte word. The experiments' input
// is the planar t_hl [2 TH, TW]: a repack on every call moves 4 MB more
// than it saves, and a packed copy cached against the tensor goes stale
// when the tensor is edited in place.
// Kernel 4, the column-window select, is built the same way, transposed.
// Its tile, 8 x by 128 y, is 32 bytes wide, so a block takes four
// x-adjacent tiles (32 columns by 128 rows, 512 threads) and a warp reads
// and writes 4 rows of 128 bytes; a thread holds two runs of four
// x-neighbours, each read as one 16-byte load, takes one min per tile by
// __reduce_min_sync and one barrier, issues its eight texel loads of M
// before the first add, and writes two 16-byte stores. A tile that reaches
// past the image's last row takes vmin = 0 with no min and no barrier: its
// padded zero indices take part in the min, so the min is at most 0 and
// clip(min, 0, V-win) is 0 whatever the field holds, exactly. The first
// port's col_window_kernel stays as kernel 4's general form, for an index
// field that is not 16-byte aligned.
//   - not taken, measured (PERF.md, in turns at 1920 x 1088, us warm /
//     cold): one tile a block at 4 and 8 pixels a thread 8.1 / 9.2 and
//     8.6 / 9.7 (a warp touches 16 rows of 128-byte lines at each index
//     load, store and texel load), 2 tiles 5.4-5.9 / 7.0-7.3, 4 tiles at
//     4 and 16 pixels 8.5 / 9.8 (1024-thread blocks) and 5.2 / 6.7,
//     8 tiles 5.6-8.1 / 7.0-9.3; shipped, 4 tiles at 8 pixels, 4.9 / 6.5.
// Kernel 2 keeps the first port's form: one block per tile, the tile's
// index field read twice (the min, then the values; the second read hits
// L1/L2), one texel load per pixel.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPx = 16;   // pixels a thread holds in a general instantiation

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

// Block-wide min with one barrier: the warp's min by __reduce_min_sync, one
// slot per warp in `slots` (16-byte aligned), then every thread reads the
// eight slots as two 16-byte words. A caller that takes another min before
// its next barrier passes other slots.
static_assert(kWarps == 8, "block_min_once reads eight slots");
__device__ __forceinline__ int block_min_once(int v, int* slots) {
  v = __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  const int4 a = reinterpret_cast<const int4*>(slots)[0];
  const int4 b = reinterpret_cast<const int4*>(slots)[1];
  return min(min(min(a.x, a.y), min(a.z, a.w)),
             min(min(b.x, b.y), min(b.z, b.w)));
}

// The pixels one thread holds of a tile whose top-left pixel is (y0, x0).
// With a compile-time tile (TY > 0): kN / 4 runs of four neighbours in a
// row, run g at tile position 4 (threadIdx.x + g * kThreads), so a warp
// reads 512 contiguous bytes of one tile row. Otherwise (TY == 0, the tile
// ty x tx at run time): up to kMaxPx single pixels, pixel i at tile
// position threadIdx.x + i * kThreads, where the tile has one.
template <int TY, int TX>
struct Tile {
  static constexpr bool kVector = TY > 0;
  static constexpr int kN = kVector ? TY * TX / kThreads : kMaxPx;
  static constexpr int kRow = kVector ? TX / 4 : 1;   // runs per tile row
  static_assert(!kVector || (TY * TX) % (4 * kThreads) == 0, "whole runs");
  static_assert((kRow & (kRow - 1)) == 0, "TX / 4 a power of two");

  int off[kN];   // the pixel's offset in the image, -1 where it has none
  int x[kN];     // its column in the image

  __device__ __forceinline__ Tile(int y0, int x0, int width, int ty, int tx) {
    if constexpr (kVector) {
#pragma unroll
      for (int g = 0; g < kN / 4; ++g) {
        const int q = threadIdx.x + g * kThreads;
        const int c = x0 + 4 * (q % kRow);
        const int o = (y0 + q / kRow) * width + c;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          off[4 * g + j] = o + j;
          x[4 * g + j] = c + j;
        }
      }
    } else {
      const int npx = ty * tx;
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int p = threadIdx.x + i * kThreads;
        x[i] = x0 + p % tx;
        off[i] = p < npx ? (y0 + p / tx) * width + x[i] : -1;
      }
    }
  }

  __device__ __forceinline__ bool has(int i) const {
    return kVector || off[i] >= 0;
  }

  // v[i] = src[off[i]], `fill` where the thread holds no pixel i.
  __device__ __forceinline__ void load(const int32_t* __restrict__ src,
                                       int (&v)[kN], int fill) const {
    if constexpr (kVector) {
#pragma unroll
      for (int g = 0; g < kN / 4; ++g) {
        const int4 t = __ldg(reinterpret_cast<const int4*>(src + off[4 * g]));
        v[4 * g] = t.x;
        v[4 * g + 1] = t.y;
        v[4 * g + 2] = t.z;
        v[4 * g + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kN; ++i) v[i] = has(i) ? __ldg(src + off[i]) : fill;
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ dst,
                                        const float (&v)[kN]) const {
    if constexpr (kVector) {
#pragma unroll
      for (int g = 0; g < kN / 4; ++g)
        *reinterpret_cast<float4*>(dst + off[4 * g]) =
            make_float4(v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < kN; ++i)
        if (has(i)) dst[off[i]] = v[i];
    }
  }

};

// Kernel 1's min over the pixels a thread holds: iu = lin < 0 ? th-1 :
// lin >> 10.
template <int TY, int TX>
__device__ __forceinline__ int onehot_min(const Tile<TY, TX>& t,
                                          const int (&l)[Tile<TY, TX>::kN],
                                          int th) {
  int m = INT_MAX;
#pragma unroll
  for (int i = 0; i < Tile<TY, TX>::kN; ++i)
    if (t.has(i)) m = min(m, l[i] < 0 ? th - 1 : (l[i] >> 10));
  return m;
}

// Kernel 1's gather and store of the pixels a thread holds: every hi and lo
// texel load started before the first add. An invalid pixel loads texel 0.
template <int TY, int TX>
__device__ __forceinline__ void onehot_gather(
    const Tile<TY, TX>& t, const int (&l)[Tile<TY, TX>::kN], int umin,
    const uint16_t* __restrict__ t_hl, int lo_plane, int tw, int win,
    float* __restrict__ out) {
  constexpr int kN = Tile<TY, TX>::kN;
  uint16_t hi[kN], lo[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int o = l[i] < 0 ? 0
        : (umin + clampi((l[i] >> 10) - umin, 0, win - 1)) * tw
          + (l[i] & 1023);
    hi[i] = __ldg(t_hl + o);
    lo[i] = __ldg(t_hl + lo_plane + o);
  }
  float v[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i)
    v[i] = l[i] < 0 ? -1.0f
                    : __fadd_rn(bf16_to_f32(hi[i]), bf16_to_f32(lo[i]));
  t.store(out, v);
}

// 1. One-hot window lookup on the hi/lo split, one tile per block. Grid
// (W / tx, H / ty); TY = TX = 0 is the general instantiation.
template <int TY, int TX>
__global__ void __launch_bounds__(kThreads) onehot_window_kernel(
    const uint16_t* __restrict__ t_hl, int th, int tw,
    const int32_t* __restrict__ lin, float* __restrict__ out, int width,
    int ty, int tx, int win) {
  using T = Tile<TY, TX>;
  __shared__ __align__(16) int slots[kWarps];
  const T t(blockIdx.y * (TY > 0 ? TY : ty), blockIdx.x * (TX > 0 ? TX : tx),
            width, ty, tx);
  int l[T::kN];
  t.load(lin, l, -1);
  const int umin =
      (clampi(block_min_once(onehot_min(t, l, th), slots), 0, th - win) >> 3)
      << 3;
  onehot_gather(t, l, umin, t_hl, th * tw, tw, win, out);
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

// Kernel 3's gather and store of the pixels a thread holds (rows u,
// columns c): every texel load started before the first add. A pixel outside
// the window loads texel 0.
template <int TY, int TX>
__device__ __forceinline__ void row_gather(
    const Tile<TY, TX>& t, const int (&u)[Tile<TY, TX>::kN],
    const int (&c)[Tile<TY, TX>::kN], int umin,
    const float* __restrict__ table, int tc, int win,
    float* __restrict__ out) {
  constexpr int kN = Tile<TY, TX>::kN;
  float tex[kN];
  bool inwin[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int rel = u[i] - umin;   // exact: umin <= u or umin == 0
    inwin[i] = rel >= 0 && rel < win;
    tex[i] = __ldg(table + (inwin[i] ? u[i] * tc + c[i] : 0));
  }
  float v[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i)
    v[i] = inwin[i] ? __fadd_rn(0.0f, tex[i]) : 0.0f;
  t.store(out, v);
}

// The columns of kernel 3: col_idx's, or the pixels' own when it is null.
template <int TY, int TX>
__device__ __forceinline__ void row_columns(const Tile<TY, TX>& t,
                                            const int32_t* __restrict__ col_idx,
                                            int (&c)[Tile<TY, TX>::kN]) {
  if (col_idx) {
    t.load(col_idx, c, 0);
  } else {
#pragma unroll
    for (int i = 0; i < Tile<TY, TX>::kN; ++i) c[i] = t.x[i];
  }
}

template <int TY, int TX>
__device__ __forceinline__ int row_min(const Tile<TY, TX>& t,
                                       const int (&u)[Tile<TY, TX>::kN]) {
  int m = INT_MAX;
#pragma unroll
  for (int i = 0; i < Tile<TY, TX>::kN; ++i)
    if (t.has(i)) m = min(m, u[i]);
  return m;
}

// 3. f32 row-window select on 8 x 128 tiles, one tile per block. col_idx
// null: the column is the pixel's own x (the two-pass warp's first pass).
// Grid (W / 128, H / 8); TY = TX = 0 is the general instantiation.
template <int TY, int TX>
__global__ void __launch_bounds__(kThreads) row_window_kernel(
    const float* __restrict__ table, int th, int tc,
    const int32_t* __restrict__ row_idx, const int32_t* __restrict__ col_idx,
    float* __restrict__ out, int width, int win) {
  using T = Tile<TY, TX>;
  __shared__ __align__(16) int slots[kWarps];
  const T t(blockIdx.y * 8, blockIdx.x * 128, width, 8, 128);
  int u[T::kN], c[T::kN];
  t.load(row_idx, u, INT_MAX);
  row_columns(t, col_idx, c);
  const int umin = clampi(block_min_once(row_min(t, u), slots), 0, th - win);
  row_gather(t, u, c, umin, table, tc, win, out);
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

// Kernel 4's vector form: kColTiles x-adjacent 8 x 128 (x by y) tiles a
// block, two runs of four x-neighbours a thread (PERF.md: the fastest of
// 1, 2, 4 and 8 tiles a block at 4, 8 and 16 pixels a thread).
constexpr int kColTiles = 4;
constexpr int kColRuns = 2;
constexpr int kColPx = 4 * kColRuns;
constexpr int kColThreads = 1024 * kColTiles / kColPx;
constexpr int kColLanes = 2 * kColTiles;            // runs in a block row
constexpr int kColRows = kColThreads / kColLanes;   // rows a run apart
constexpr int kColWarps = kColThreads / 32;
static_assert(32 % kColLanes == 0, "a warp holds whole rows of the block");
static_assert(kColWarps % 4 == 0, "whole 16-byte words of slots");

// Kernel 4's block-wide mins, one per tile, with one barrier: tile t's min
// over the threads whose `tile` is t, by __reduce_min_sync in each warp,
// one slot per warp and tile, then every thread reads its tile's slots as
// 16-byte words.
__device__ __forceinline__ int block_min_tiles(
    int v, int tile, int (*slots)[kColWarps]) {
#pragma unroll
  for (int t = 0; t < kColTiles; ++t) {
    const int m = __reduce_min_sync(0xffffffffu, tile == t ? v : INT_MAX);
    if ((threadIdx.x & 31) == 0) slots[t][threadIdx.x >> 5] = m;
  }
  __syncthreads();
  int m = INT_MAX;
#pragma unroll
  for (int i = 0; i < kColWarps / 4; ++i) {
    const int4 a = reinterpret_cast<const int4*>(slots[tile])[i];
    m = min(m, min(min(a.x, a.y), min(a.z, a.w)));
  }
  return m;
}

// 4, vector form: the same rule, a warp reading and writing rows of
// 32 kColTiles bytes. Run g of thread i covers row
// y0 + i / kColLanes + g kColRows, columns x0 + 4 (i % kColLanes) + 0..3;
// its tile is (i % kColLanes) / 2, and a tile past the image's last column
// has no pixels. Needs width % 8 == 0 and 16-byte aligned col_idx and out;
// offsets are 32-bit (the wrapper checks that M and the image hold fewer
// than 2^31 elements). Grid (ceil(W / (8 kColTiles)), ceil(H / 128)).
__global__ void __launch_bounds__(kColThreads) col_window_vector_kernel(
    const float* __restrict__ m_rows, int height, int mv,
    const int32_t* __restrict__ col_idx, float* __restrict__ out, int width,
    int win) {
  __shared__ __align__(16) int slots[kColTiles][kColWarps];
  const int y0 = blockIdx.y * 128;
  const int run = threadIdx.x % kColLanes;
  const int r = y0 + threadIdx.x / kColLanes;
  const int c = blockIdx.x * 8 * kColTiles + 4 * run;
  const bool has = c < width;
  // a tile that reaches past the last row: vmin exactly 0 (see the top)
  const bool padded = y0 + 128 > height;
  int v[kColPx];
#pragma unroll
  for (int g = 0; g < kColRuns; ++g) {
    int4 t = make_int4(-1, -1, -1, -1);   // no pixel: outside every window
    if (has && (!padded || r + g * kColRows < height))
      t = __ldg(reinterpret_cast<const int4*>(
          col_idx + (r + g * kColRows) * width + c));
    v[4 * g] = t.x;
    v[4 * g + 1] = t.y;
    v[4 * g + 2] = t.z;
    v[4 * g + 3] = t.w;
  }
  int vmin = 0;
  if (!padded) {
    int m = INT_MAX;
#pragma unroll
    for (int i = 0; i < kColPx; ++i) m = min(m, v[i]);
    vmin = clampi(block_min_tiles(has ? m : INT_MAX, run / 2, slots), 0,
                  mv - win);
  }
  float tex[kColPx];
  bool inwin[kColPx];
#pragma unroll
  for (int i = 0; i < kColPx; ++i) {
    // exact: vmin <= v or vmin == 0; an in-window v is < vmin + win <= mv
    const int rel = v[i] - vmin;
    inwin[i] = rel >= 0 && rel < win;
    tex[i] = __ldg(m_rows + (inwin[i] ? (r + (i / 4) * kColRows) * mv + v[i]
                                      : 0));
  }
#pragma unroll
  for (int g = 0; g < kColRuns; ++g) {
    if (!has || r + g * kColRows >= height) continue;
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = inwin[4 * g + j] ? __fadd_rn(0.0f, tex[4 * g + j]) : 0.0f;
    *reinterpret_cast<float4*>(out + (r + g * kColRows) * width + c) =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}

// The instantiation forms the wrappers choose between (trace/exp_warp.py).
constexpr int kFormGeneral = 0, kFormVector = 1;

template <int TY, int TX>
int onehot_launch(const uint16_t* t_hl, int th, int tw, const int32_t* lin,
                  float* out, int height, int width, int ty, int tx, int win,
                  cudaStream_t stream) {
  const dim3 grid(width / tx, height / ty);
  onehot_window_kernel<TY, TX><<<grid, kThreads, 0, stream>>>(
      t_hl, th, tw, lin, out, width, ty, tx, win);
  return (int)cudaGetLastError();
}

template <int TY, int TX>
int row_launch(const float* table, int th, int tc, const int32_t* row_idx,
               const int32_t* col_idx, float* out, int height, int width,
               int win, cudaStream_t stream) {
  const dim3 grid(width / 128, height / 8);
  row_window_kernel<TY, TX><<<grid, kThreads, 0, stream>>>(
      table, th, tc, row_idx, col_idx, out, width, win);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch contract of every entry point: it launches on `stream` (a
// cudaStream_t as void*), does not synchronise, and returns
// cudaGetLastError() (0 on success). The wrappers check shapes, types and
// divisibility before they call. `form` (kernels 1 and 3) is 0 for the
// general instantiation, 1 for the tile's own, which needs a compile-time
// tile and 16-byte aligned index fields and output: the wrappers check
// (cudaErrorInvalidValue otherwise).

// `t_hl` bf16 bits [2 th, tw] (hi rows, then lo rows), `lin` / `out`
// [height, width] with height % ty == 0 and width % tx == 0; the general
// form takes tiles of at most kThreads * kMaxPx pixels.
extern "C" int onehot_window_launch(const uint16_t* t_hl, int th, int tw,
                                    const int32_t* lin, float* out,
                                    int height, int width, int ty, int tx,
                                    int win, int form, void* stream) {
  if (height <= 0 || width <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
#define ONEHOT(TY, TX) \
  onehot_launch<TY, TX>(t_hl, th, tw, lin, out, height, width, ty, tx, win, s)
  if (form == kFormGeneral)
    return ty * tx <= kThreads * kMaxPx ? ONEHOT(0, 0)
                                        : (int)cudaErrorInvalidValue;
  if (form != kFormVector) return (int)cudaErrorInvalidValue;
  if (ty == 8 && tx == 128) return ONEHOT(8, 128);
  if (ty == 16 && tx == 128) return ONEHOT(16, 128);
  if (ty == 32 && tx == 128) return ONEHOT(32, 128);
  if (ty == 16 && tx == 256) return ONEHOT(16, 256);
#undef ONEHOT
  return (int)cudaErrorInvalidValue;
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
                                 int height, int width, int win, int form,
                                 void* stream) {
  if (height <= 0 || width <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (form == kFormGeneral)
    return row_launch<0, 0>(table, th, tc, row_idx, col_idx, out, height,
                            width, win, s);
  if (form == kFormVector)
    return row_launch<8, 128>(table, th, tc, row_idx, col_idx, out, height,
                              width, win, s);
  return (int)cudaErrorInvalidValue;
}

// `m_rows` f32 [height, mv]; `col_idx`, `out` [height, width] with
// width % 8 == 0. The vector form refuses a col_idx or out that is not
// 16-byte aligned.
extern "C" int col_window_launch(const float* m_rows, int mv,
                                 const int32_t* col_idx, float* out,
                                 int height, int width, int win, int form,
                                 void* stream) {
  if (height <= 0 || width <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (form == kFormGeneral) {
    const dim3 grid(width / 8, (height + 127) / 128);
    col_window_kernel<<<grid, kThreads, 0, s>>>(m_rows, height, mv, col_idx,
                                                out, width, win);
    return (int)cudaGetLastError();
  }
  if (form != kFormVector || width % 8 != 0
      || ((uintptr_t)col_idx | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((width + 8 * kColTiles - 1) / (8 * kColTiles),
                  (height + 127) / 128);
  col_window_vector_kernel<<<grid, kColThreads, 0, s>>>(
      m_rows, height, mv, col_idx, out, width, win);
  return (int)cudaGetLastError();
}
