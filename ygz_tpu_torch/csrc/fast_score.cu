// FAST-10 corner score map for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ygz_tpu/ops/pallas_fast.py::fast_score_map_pallas
// (body _fast_kernel); semantics are those of its plain reference
// ygz_tpu/ops/fast.py::fast_score_map, and the result is bit-exact against
// the port's plain version ygz_tpu_torch/ops/fast.py::fast_score_map_torch:
// the same float operations in the same order (subtract, min, max, add; no
// multiply, so FMA contraction cannot change a value), and min/max are exact.
//
// Per pixel: the 16 Bresenham taps at radius 3; bright = (tap - c) - th,
// dark = (-(tap - c)) - th; arc strength = max over the 16 circular starts
// of the min over 10 contiguous taps; score = max(bright, dark) + th where
// that is > 0, else 0. A 3-px frame is zeroed (its taps leave the image;
// out-of-image taps are read as 0 here and masked, as the reference masks
// its wrapped rolls).
//
// Bound: arithmetic, not memory. Each pixel is read once from global memory
// (plus a 3-px halo per tile) and written once: ~4 B in + 4 B out, ~2.9 MB
// per launch at the main path's largest level (480 x 752), ~0.9 us at the
// data-sheet 3.35 TB/s. The arc test is the cost: 2 x 16 starts x 9 fminf
// plus the taps, ~600 dependent min/max per pixel. Measured by
// torch.profiler on an NVIDIA H100 80GB HBM3 (700 W power limit): 12.0 us
// of device time at 480 x 752 and ~5.6 us at each smaller level, where a
// block's own latency is the floor. A sliding-window arc minimum would cut
// the operation count and stay exact (min and max give the same value in
// any order); this first version keeps the reference's plain loop.
//
// Tile: 32 x 32 output pixels per block of 32 x 8 threads (each thread
// computes 4 rows). A warp spans 32 consecutive columns, so global loads
// and stores are 128-byte coalesced rows; the (32+6)^2 shared tile is
// 5.8 KB, and the halo overhead is 1444 / 1024 = 1.41 reads per pixel.
// Taller tiles would cut the halo share further but give fewer blocks on
// the small levels (60 x 94 is only 6 blocks of this size already).

#include <cuda_runtime.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 32;
constexpr int ROWS_PER_THREAD = 4;
constexpr int HALO = 3;
constexpr int SH_W = TILE_W + 2 * HALO;
constexpr int SH_H = TILE_H + 2 * HALO;
constexpr int ARC = 10;

// (dx, dy) clockwise from (0, -3): the reference's CIRCLE order.
__constant__ int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                  0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kCircleDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                  3, 3, 2, 1, 0, -1, -2, -3};

__device__ __forceinline__ float arc_strength(const float x[16]) {
  float best = 0.0f;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    float m = x[s];
#pragma unroll
    for (int j = 1; j < ARC; ++j) m = fminf(m, x[(s + j) & 15]);
    best = (s == 0) ? m : fmaxf(best, m);
  }
  return best;
}

__global__ void fast_score_kernel(const float* __restrict__ img,
                                  float* __restrict__ out, int H, int W,
                                  float th) {
  __shared__ float tile[SH_H][SH_W];
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  for (int i = tid; i < SH_H * SH_W; i += nthreads) {
    const int r = i / SH_W;
    const int c = i - r * SH_W;
    const int gy = y0 - HALO + r;
    const int gx = x0 - HALO + c;
    tile[r][c] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                     ? __ldg(img + (size_t)gy * W + gx)
                     : 0.0f;
  }
  __syncthreads();

  const int lx = threadIdx.x;
  const int x = x0 + lx;
#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    const int ly = threadIdx.y + k * blockDim.y;
    const int y = y0 + ly;
    if (x >= W || y >= H) continue;
    const float c = tile[ly + HALO][lx + HALO];
    float bright[16], dark[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const float diff = tile[ly + HALO + kCircleDy[q]][lx + HALO + kCircleDx[q]] - c;
      bright[q] = diff - th;
      dark[q] = (-diff) - th;
    }
    const float strength = fmaxf(arc_strength(bright), arc_strength(dark));
    const bool frame = (y >= HALO) && (y < H - HALO) && (x >= HALO) &&
                       (x < W - HALO);
    out[(size_t)y * W + x] =
        (frame && strength > 0.0f) ? strength + th : 0.0f;
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t); returns cudaGetLastError() so the
// caller sees a refused launch at once.
extern "C" int ygz_fast_score(const float* img, float* out, int H, int W,
                              float threshold, void* stream) {
  const dim3 block(TILE_W, TILE_H / ROWS_PER_THREAD);
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H);
  fast_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, H, W, threshold);
  return static_cast<int>(cudaGetLastError());
}
