// FAST-10 corners for Hopper (sm_90a), plain C interface. Two entries share
// one tile loader and one arc-test device function:
//
//  ygz_fast_score   the FAST-10 score map of one [H, W] float32 image at one
//                   threshold, with the 3-px frame zeroed. It replaces the
//                   TPU kernel fast_score_map_pallas (body _fast_kernel) of
//                   ygz_tpu/ops/pallas_fast.py; wrapper
//                   ops/fast.py::fast_score_map.
//  ygz_fast_corners the extraction front over every level of a stacked
//                   [SH, W0] pyramid in one launch: scores at both
//                   thresholds, the merge where(hi > 0, hi + 1000, lo) and
//                   the 3x3 non-maximum suppression (ties kept), with 0 in
//                   each level's pad columns. That is
//                   ygz_tpu/frontend/extractor.py:71-78 per level;
//                   wrapper ops/fast.py::fast_corner_maps.
//
// Both are bit-exact against the plain versions in ops/fast.py, which repeat
// the reference's float operations (ygz_tpu/ops/fast.py::fast_score_map),
// for every threshold th >= 0 (a FAST threshold; the wrappers refuse < 0).
// Per pixel the reference forms d_q = tap_q - c, bright_q = d_q - th and
// dark_q = -d_q - th, takes the max over the 16 circular starts of the min
// over 10 contiguous taps of each, and returns s + th where s = max(bright
// arc, dark arc) > 0. Under round-to-nearest x -> fl(x - th) is monotone
// non-decreasing, so it commutes with min and max: s = fl(A - th) with one
// arc value A = max(maxmin10(d), maxmin10(-d)) per pixel, whatever th is,
// and both thresholds come from the same A. At most one side can be > 0: a
// bright arc of 10 contains both taps of two neighbouring opposite pairs
// (q, q + 8), one with an even q, while with a dark arc of 10 the positive
// taps lie within 6 contiguous positions and hold no such pair. So the
// kernel tests the 4 even pairs and computes one side only, A' =
// maxmin10(d or -d), flipping the sign with an exact multiply by -1: A' = A
// where A > 0, and A' <= A <= 0 elsewhere, where every th >= 0 scores 0
// either way. Min and max are exact in any order, so the 10-wide circular
// window is a sliding minimum (suffix minima of one block of 10 taps,
// prefix minima of the next): 44 min + 15 max, where the plain version
// takes 2 x (144 + 15). A signed zero cannot change a result (fl(+-0 - th)
// = -th, and a zero strength scores 0). The one multiply, by +-1, feeds
// only min and max, so FMA contraction cannot change a value; the two adds
// of the merge stay separate, in the reference's order; the build uses no
// --use_fast_math.
//
// Bound. The fused front over the EuRoC pyramid (752x480, 4 levels; 479,400
// level pixels in a 900 x 752 stack) reads each level pixel once and writes
// the whole stacked map once, pad zeros included: 4.62 MB, 1.38 us at 3.35
// TB/s. Its operations per interior pixel (16 differences, the 4-pair side
// test and 16 sign flips, 59 min/max, the two thresholds, the merge) and
// the NMS are ~54 M, 0.80 us at 67 TFLOP/s: bound by bytes. The
// single-threshold map at 480x752 moves 2.89 MB (0.86 us) for ~36 M
// operations (0.54 us). TMA, wgmma and warp specialisation buy nothing at
// this size. The time goes to the min/max, which the timings in PERF.md
// section 6 show issuing at about half the rate of a float add, and to the
// fixed cost of a launch; the design cuts the operations (one arc test of
// one side per pixel for both thresholds) and the launches (8 score
// launches and ~128 eager merge/NMS kernels per extraction became one).
//
// Tiles. A block has 32 x 8 threads. ygz_fast_score gives each block a 32 x
// 32 output tile (4 rows a thread); ygz_fast_corners a 30 x 30 output tile
// whose 32 x 32 ring of merged values (1.14 arc tests per output) is
// computed by one warp per ring row, 4 per thread, into shared memory; after
// a barrier each thread suppresses non-maxima for 4 consecutive output rows
// from the 3-wide maxima of 6 ring rows, so the whole front stays on the
// chip. A 30-wide tile puts the ring on whole warps: no idle lanes and no
// shared-memory bank conflicts in the arc tests, where a 32-wide tile needs
// 34 x 34 = 1156 tests spread over 4.5 rounds. Both read
// a 38 x 40 input tile (the ring or the tile plus the 3-px taps, widened to
// float4 boundaries) into shared memory: each thread keeps one float4
// column slot from one divide at the start and walks rows, with float4
// loads where the row is 16-byte aligned and element loads at the level's
// edge. One flat grid covers all levels: a level table passed by value
// holds each level's row offset, height, width and first block; a block
// finds its level from blockIdx.x. The computing blocks come first, level 0
// first (416 + 104 + 28 + 8 = 556 at EuRoC, about one wave of 132 SMs);
// the blocks that only zero the pad columns right of a smaller level's
// tiles come last, in the slots the first ones free.
//
// Registers hold the 16 differences and one block's suffix minima. nvcc
// -Xptxas -v for sm_90a (CUDA 12.8): fast_corners_kernel 39 registers,
// 10176 bytes smem, fast_score_kernel 32 registers, 6080 bytes smem; 1
// barrier and no spills each. At 39 registers 6 blocks of 256 threads fit
// an SM, so all 760 blocks of the EuRoC grid are resident at once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int SCORE_TILE = 32;        // ygz_fast_score: 32 x 32 outputs
constexpr int CORNER_TILE = 30;       // ygz_fast_corners: 30 x 30 outputs,
constexpr int RING = CORNER_TILE + 2; // from a 32 x 32 ring of merged values
constexpr int PAD_TILE = 32;          // pad blocks: 32 x 32 zeros
constexpr int IN_H = 38;              // input tile: 32 + 2 x 3 rows
constexpr int IN_W = 40;              // and 10 float4 columns
constexpr int IN4 = IN_W / 4;
constexpr int THREADS_X = 32;
constexpr int THREADS_Y = 8;
constexpr int NTHREADS = THREADS_X * THREADS_Y;
constexpr int ROWS_PER_THREAD = 32 / THREADS_Y;
constexpr int LOAD_ROWS = NTHREADS / IN4;  // 25 input rows per load pass
constexpr int FRAME = 3;              // zeroed border (taps leave the image)
constexpr int MAX_LEVELS = 8;
constexpr float HI_BONUS = 1000.0f;   // high-threshold corners rank first

struct Level {
  int row_off;         // first row of the level in the stacked buffer
  int h, w;            // the level's own size
  int tile_begin;      // first computing block of the level
  int tiles_x;         // computing tiles across w
  int pad_begin;       // first pad block of the level
  int pad_tiles_x;     // pad tiles across w0 - pad_x0
  int pad_x0;          // first column no computing tile covers
};

struct LevelTable {
  Level lv[MAX_LEVELS];
  int n;
  int w0;
  int pad_start;       // blocks below it compute, the rest write pad zeros
};

// Rows ys .. ys + IN_H - 1 and columns xs .. xs + IN_W - 1 (xs a multiple
// of 4) of a level whose row 0 is `src` (row stride `stride`, size h x w);
// 0 outside the level. Each thread keeps one float4 column slot and walks
// rows; float4 loads where the row is 16-byte aligned (`vec`).
__device__ __forceinline__ void load_tile(float (*tile)[IN_W],
                                          const float* __restrict__ src,
                                          int stride, int h, int w, int ys,
                                          int xs, bool vec) {
  const int tid = threadIdx.y * THREADS_X + threadIdx.x;
  const int slot = tid % IN4;
  const int gx = xs + 4 * slot;
  for (int r = tid / IN4; r < IN_H && tid < LOAD_ROWS * IN4; r += LOAD_ROWS) {
    const int gy = ys + r;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (gy >= 0 && gy < h) {
      const float* row = src + static_cast<size_t>(gy) * stride;
      if (vec && gx >= 0 && gx + 4 <= w) {
        v = __ldg(reinterpret_cast<const float4*>(row + gx));
      } else {
        if (gx >= 0 && gx < w) v.x = __ldg(row + gx);
        if (gx + 1 >= 0 && gx + 1 < w) v.y = __ldg(row + gx + 1);
        if (gx + 2 >= 0 && gx + 2 < w) v.z = __ldg(row + gx + 2);
        if (gx + 3 >= 0 && gx + 3 < w) v.w = __ldg(row + gx + 3);
      }
    }
    *reinterpret_cast<float4*>(&tile[r][4 * slot]) = v;
  }
}

// d_q = tap_q - c for the 16 Bresenham taps at radius 3, clockwise from
// (0, -3) (the reference's CIRCLE order); p points at the centre.
__device__ __forceinline__ void circle_diffs(const float* p, float d[16]) {
  const float c = p[0];
  d[0] = p[-3 * IN_W] - c;        // ( 0, -3)
  d[1] = p[-3 * IN_W + 1] - c;    // ( 1, -3)
  d[2] = p[-2 * IN_W + 2] - c;    // ( 2, -2)
  d[3] = p[-IN_W + 3] - c;        // ( 3, -1)
  d[4] = p[3] - c;                // ( 3,  0)
  d[5] = p[IN_W + 3] - c;         // ( 3,  1)
  d[6] = p[2 * IN_W + 2] - c;     // ( 2,  2)
  d[7] = p[3 * IN_W + 1] - c;     // ( 1,  3)
  d[8] = p[3 * IN_W] - c;         // ( 0,  3)
  d[9] = p[3 * IN_W - 1] - c;     // (-1,  3)
  d[10] = p[2 * IN_W - 2] - c;    // (-2,  2)
  d[11] = p[IN_W - 3] - c;        // (-3,  1)
  d[12] = p[-3] - c;              // (-3,  0)
  d[13] = p[-IN_W - 3] - c;       // (-3, -1)
  d[14] = p[-2 * IN_W - 2] - c;   // (-2, -2)
  d[15] = p[-3 * IN_W - 1] - c;   // (-1, -3)
}

// The pixel's one arc value A' (see the head of the file): the max over the
// 16 circular starts i of the min over the 10 taps i .. i + 9 of x, with x =
// d on the bright side and -d on the dark side. On the unrolled sequence
// y_j = x_{j mod 16}, j = 0 .. 24, the window at i < 10 is a suffix of
// y_0 .. y_9 and a prefix of y_10 .. y_18, and the window at i >= 10 a
// suffix of y_10 .. y_19 and a prefix of y_20 .. y_24 (van Herk and
// Gil-Werman's sliding minimum): 44 min + 15 max.
__device__ __forceinline__ float arc_value(const float* p) {
  float x[16];
  circle_diffs(p, x);
  // a bright arc of 10 starting at a holds both taps of the opposite pairs
  // (a, a + 8) and (a + 1, a + 9), one of them with an even first tap; with
  // a dark arc of 10 the positive taps lie within 6 contiguous positions
  // and hold no opposite pair
  float pair = fminf(x[0], x[8]);
  pair = fmaxf(pair, fminf(x[2], x[10]));
  pair = fmaxf(pair, fminf(x[4], x[12]));
  pair = fmaxf(pair, fminf(x[6], x[14]));
  const float side = pair > 0.0f ? 1.0f : -1.0f;
#pragma unroll
  for (int q = 0; q < 16; ++q) x[q] *= side;  // a sign flip: exact
  float suf[10];
  suf[9] = x[9];
#pragma unroll
  for (int k = 8; k >= 0; --k) suf[k] = fminf(x[k], suf[k + 1]);
  float best = suf[0];                         // i = 0
  float pre = x[10];
#pragma unroll
  for (int k = 1; k < 10; ++k) {               // i = 1 .. 9
    if (k > 1) pre = fminf(pre, x[(k + 9) & 15]);
    best = fmaxf(best, fminf(suf[k], pre));
  }
  suf[9] = x[19 & 15];
#pragma unroll
  for (int k = 8; k >= 0; --k) suf[k] = fminf(x[(k + 10) & 15], suf[k + 1]);
  best = fmaxf(best, suf[0]);                  // i = 10
  pre = x[20 & 15];
#pragma unroll
  for (int k = 1; k < 6; ++k) {                // i = 11 .. 15
    if (k > 1) pre = fminf(pre, x[(k + 19) & 15]);
    best = fmaxf(best, fminf(suf[k], pre));
  }
  return best;
}

// The reference's score at threshold th >= 0: s = A - th; s > 0 ? s + th : 0.
__device__ __forceinline__ float score_at(float a, float th) {
  const float s = a - th;
  return s > 0.0f ? s + th : 0.0f;
}

__device__ __forceinline__ bool interior(int y, int x, int h, int w) {
  return y >= FRAME && y < h - FRAME && x >= FRAME && x < w - FRAME;
}

__global__ void __launch_bounds__(NTHREADS)
fast_score_kernel(const float* __restrict__ img, float* __restrict__ out,
                  int H, int W, float th, bool vec) {
  __shared__ __align__(16) float tile[IN_H][IN_W];
  const int y0 = blockIdx.y * SCORE_TILE;
  const int x0 = blockIdx.x * SCORE_TILE;
  // input rows y0 - 3 .., columns x0 - 4 .. (a float4 boundary)
  load_tile(tile, img, W, H, W, y0 - FRAME, x0 - 4, vec);
  __syncthreads();
  const int lx = threadIdx.x;
  const int x = x0 + lx;
#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    const int ly = threadIdx.y + k * THREADS_Y;
    const int y = y0 + ly;
    if (y >= H || x >= W) continue;
    out[static_cast<size_t>(y) * W + x] =
        interior(y, x, H, W)
            ? score_at(arc_value(&tile[ly + FRAME][lx + 4]), th)
            : 0.0f;
  }
}

__global__ void __launch_bounds__(NTHREADS)
fast_corners_kernel(const float* __restrict__ stack, float* __restrict__ out,
                    LevelTable t, float th_hi, float th_lo, bool vec) {
  __shared__ __align__(16) float tile[IN_H][IN_W];
  __shared__ float merged[RING][RING];
  const int b = blockIdx.x;
  const bool pad = b >= t.pad_start;
  int l = 0;
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i)
    if (i < t.n && b >= (pad ? t.lv[i].pad_begin : t.lv[i].tile_begin)) l = i;
  const Level L = t.lv[l];
  const int lx = threadIdx.x;

  if (pad) {  // zeros right of the computing tiles of a smaller level
    const int j = b - L.pad_begin;
    const int y0 = (j / L.pad_tiles_x) * PAD_TILE;
    const int x = L.pad_x0 + (j % L.pad_tiles_x) * PAD_TILE + lx;
    float* dst = out + static_cast<size_t>(L.row_off) * t.w0;
#pragma unroll
    for (int k = 0; k < ROWS_PER_THREAD; ++k) {
      const int y = y0 + threadIdx.y + k * THREADS_Y;
      if (y < L.h && x < t.w0) dst[static_cast<size_t>(y) * t.w0 + x] = 0.0f;
    }
    return;
  }

  const int j = b - L.tile_begin;
  const int y0 = (j / L.tiles_x) * CORNER_TILE;
  const int x0 = (j % L.tiles_x) * CORNER_TILE;
  const int xs = (x0 - 4) & ~3;   // float4 boundary at or left of x0 - 4
  const int off = x0 - 4 - xs;    // 0 or 2
  load_tile(tile, stack + static_cast<size_t>(L.row_off) * t.w0, t.w0, L.h,
            L.w, y0 - 4, xs, vec);
  __syncthreads();

  // merged[r][c]: the merged score at (y0 - 1 + r, x0 - 1 + c), 0 in the
  // frame and outside the level as in the reference; a warp per ring row
#pragma unroll
  for (int k = 0; k < RING / THREADS_Y; ++k) {
    const int r = threadIdx.y + k * THREADS_Y;
    float m = 0.0f;
    if (interior(y0 - 1 + r, x0 - 1 + lx, L.h, L.w)) {
      const float a = arc_value(&tile[r + FRAME][lx + FRAME + off]);
      const float hi = score_at(a, th_hi);
      m = hi > 0.0f ? hi + HI_BONUS : score_at(a, th_lo);
    }
    merged[r][lx] = m;
  }
  __syncthreads();

  // thread row ty owns output rows 4 ty .. 4 ty + 3; the 3-wide maxima of
  // ring rows 4 ty .. 4 ty + 5 serve all four. m >= max of its 8
  // neighbours exactly when m >= max of all 9.
  if (lx >= CORNER_TILE) return;
  float row3[ROWS_PER_THREAD + 2];
#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD + 2; ++k) {
    const int r = ROWS_PER_THREAD * threadIdx.y + k;
    row3[k] = r < RING ? fmaxf(fmaxf(merged[r][lx], merged[r][lx + 1]),
                               merged[r][lx + 2])
                       : 0.0f;
  }
  const int x = x0 + lx;
  float* dst = out + static_cast<size_t>(L.row_off) * t.w0;
#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    const int ly = ROWS_PER_THREAD * threadIdx.y + k;
    const int y = y0 + ly;
    if (ly >= CORNER_TILE || y >= L.h || x >= t.w0) continue;
    float v = 0.0f;
    if (x < L.w) {
      const float m = merged[ly + 1][lx + 1];
      v = m >= fmaxf(fmaxf(row3[k], row3[k + 1]), row3[k + 2]) ? m : 0.0f;
    }
    dst[static_cast<size_t>(y) * t.w0 + x] = v;
  }
}

bool aligned16(const void* p, int stride) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (stride & 3) == 0;
}

int tiles(int n, int tile) { return n > 0 ? (n + tile - 1) / tile : 0; }

}  // namespace

// Both entries launch on `stream` (a cudaStream_t) and return
// cudaGetLastError(), so the caller sees a refused launch at once. The
// thresholds must be >= 0 (the wrappers check).
extern "C" int ygz_fast_score(const float* img, float* out, int H, int W,
                              float threshold, void* stream) {
  const dim3 block(THREADS_X, THREADS_Y);
  const dim3 grid(tiles(W, SCORE_TILE), tiles(H, SCORE_TILE));
  fast_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, H, W, threshold, aligned16(img, W));
  return static_cast<int>(cudaGetLastError());
}

// stack/out: [SH, w0] float32; level l has rows row_off[l] .. row_off[l] +
// heights[l] - 1 and columns 0 .. widths[l] - 1 (host arrays of n_levels).
extern "C" int ygz_fast_corners(const float* stack, float* out, int w0,
                                const int* row_off, const int* heights,
                                const int* widths, int n_levels, float th_hi,
                                float th_lo, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || w0 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  LevelTable t{};
  t.n = n_levels;
  t.w0 = w0;
  int blocks = 0;
  for (int l = 0; l < n_levels; ++l) {  // computing blocks, level 0 first
    Level& L = t.lv[l];
    L.row_off = row_off[l];
    L.h = heights[l];
    L.w = widths[l];
    L.tile_begin = blocks;
    L.tiles_x = tiles(L.w, CORNER_TILE);
    L.pad_x0 = L.tiles_x * CORNER_TILE;
    blocks += L.tiles_x * tiles(L.h, CORNER_TILE);
  }
  t.pad_start = blocks;
  for (int l = 0; l < n_levels; ++l) {  // then the pad blocks
    Level& L = t.lv[l];
    L.pad_begin = blocks;
    L.pad_tiles_x = tiles(w0 - L.pad_x0, PAD_TILE);
    blocks += L.pad_tiles_x * tiles(L.h, PAD_TILE);
  }
  if (t.pad_start == 0) return static_cast<int>(cudaErrorInvalidValue);
  fast_corners_kernel<<<blocks, dim3(THREADS_X, THREADS_Y), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      stack, out, t, th_hi, th_lo, aligned16(stack, w0));
  return static_cast<int>(cudaGetLastError());
}
