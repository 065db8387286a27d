// Sparse inverse-compositional image alignment over all pyramid levels in one
// launch, for Hopper (sm_90a), plain C interface. Entry ygz_sparse_align;
// wrapper frontend/sparse_align.py::sparse_image_align, plain version
// sparse_image_align_torch (the same function, line for line:
// ygz_tpu/frontend/sparse_align.py::sparse_image_align, lax.fori_loops that
// XLA compiled; no Pallas kernel stands behind it).
//
// What it computes, per level (coarse to fine; the frame step runs levels 3,
// 2, 1 with 10 iterations each): the level intrinsics, the 6x6 bordered
// reference patch of every point by ops/align.py::sample_patches' shared-
// fraction bilinear rule (uv clamped to [0, W - 1.001], the integer corner to
// [0, W - 7] of the level it is given), central-difference gradients and the
// fixed IC Jacobian J = g (dpi [I | -X^]) of the 16 inner pixels, ref_ok =
// valid & z > 0.1 & a 3-px border; then `iters` GN steps: project, the 4x4
// current patch, the residual, the per-pixel Huber weight min(1, 10 /
// max(|r|, 1e-6)) on visible points, H += 1e-6 trace(H) / 6 I, the
// preconditioned solve and pose <- pose * exp(-delta) (right). At the last
// level, the diagnostics: n_meas visible points and their mean |residual|.
//
// Bound. At the main path's N = 512 over levels 3, 2, 1 of a 752x480
// pyramid the call reads the points (~12 KB) and at most the 5x5 and 7x7
// gathers of each point and level (< 1 MB, less where patches overlap;
// the images are L2-resident), and its ~20 MFLOP (30 steps x 512 points x
// 16 pixels x ~40 flops) take ~0.3 us at 67 TFLOP/s. What sets the time is
// the chain of 30 dependent steps (a block-wide sum, one thread's solve, two
// barriers each). One block walks all points, a thread owning whole points
// (n = tid, tid + 256, ...); each level's per-point setup (inner reference
// patch, gradients, the 2x6 projection Jacobian Jp, ref_ok: 61 floats) goes
// to a [61, N] scratch buffer in global memory that only its owner thread
// reads (L1/L2-resident), and J is rebuilt from gx, gy and Jp in each step
// instead of keeping [N, 16, 6]. The fixed-order block sum of
// gn_common.cuh, one solving thread and no atomics: a launch repeats bit
// for bit.
#include "gn_common.cuh"

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int P = 4;            // patch side (PATCH)
constexpr int PB = P + 2;       // bordered reference patch side
constexpr int BORDER = 3;       // PATCH_HALF + 1
// scratch rows per point: inner ref 16 | gx 16 | gy 16 | Jp 12 | ref_ok 1
constexpr int S_REF = 0, S_GX = 16, S_GY = 32, S_JP = 48, S_OK = 60;
constexpr int S_ROWS = 61;
static_assert(S_OK + 1 == S_ROWS, "scratch layout");

struct Level {
  const float* ref; int rh, rw, rs;   // ref level [rh, rw], row stride rs
  const float* cur; int ch, cw, cs;   // cur level
  float scale, fx, fy, cx, cy;        // 0.5^l and the level intrinsics
};

struct Levels {
  Level lv[MAX_LEVELS];
  int n;
};

// sample_patches(img, (u, v), size) into out[size * size]: one
// (size + 1)^2 integer gather blended by the shared fraction
template <int SIZE>
__device__ __forceinline__ void sample_patch(const float* img, int h, int w,
                                             int stride, float u, float v,
                                             float* out) {
  const float o0 = -(SIZE - 1) / 2.0f;
  const float x = gn::clamp_nan(u, 0.0f, static_cast<float>(w - 1.001))
                  + o0;
  const float y = gn::clamp_nan(v, 0.0f, static_cast<float>(h - 1.001))
                  + o0;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  // a NaN corner converts to 0 on the card; torch's clamp of its int64
  // conversion gives 0 too
  const int xi = min(max(static_cast<int>(x0), 0), w - SIZE - 1);
  const int yi = min(max(static_cast<int>(y0), 0), h - SIZE - 1);
  const float* base = img + static_cast<size_t>(yi) * stride + xi;
  float prev[SIZE + 1];
#pragma unroll
  for (int c = 0; c <= SIZE; ++c) prev[c] = base[c];
#pragma unroll
  for (int r = 0; r < SIZE; ++r) {
    float next[SIZE + 1];
    const float* row = base + static_cast<size_t>(r + 1) * stride;
#pragma unroll
    for (int c = 0; c <= SIZE; ++c) next[c] = row[c];
#pragma unroll
    for (int c = 0; c < SIZE; ++c) {
      const float top = (1.0f - fx) * prev[c] + fx * prev[c + 1];
      const float bot = (1.0f - fx) * next[c] + fx * next[c + 1];
      out[r * SIZE + c] = (1.0f - fy) * top + fy * bot;
    }
#pragma unroll
    for (int c = 0; c <= SIZE; ++c) prev[c] = next[c];
  }
}

__device__ __forceinline__ bool in_bounds(float u, float v, int w, int h) {
  return u >= BORDER && u < w - 1 - BORDER && v >= BORDER
         && v < h - 1 - BORDER;
}

struct Points {
  const float* uv;  int suv;   // [N, 2] level-0 pixels in the ref frame
  const float* X;   int sx;    // [N, 3] in the ref camera frame
  const uint8_t* valid; int sval;
  int n;
};

// project X at pose P with the level intrinsics: (u, v), z > 0.1
__device__ __forceinline__ bool project(const float* P, const Level& L,
                                        float X0, float X1, float X2,
                                        float& u, float& v) {
  const float x = X0 * P[0] + X1 * P[1] + X2 * P[2] + P[9];
  const float y = X0 * P[3] + X1 * P[4] + X2 * P[5] + P[10];
  const float z = X0 * P[6] + X1 * P[7] + X2 * P[8] + P[11];
  const float zi = 1.0f / gn::max_nan(z, 1e-6f);
  u = L.fx * x * zi + L.cx;
  v = L.fy * y * zi + L.cy;
  return z > 0.1f;
}

__global__ void __launch_bounds__(gn::THREADS)
sparse_align_kernel(Points q, Levels lv, const float* __restrict__ R0,
                    const float* __restrict__ t0, int iters,
                    float* __restrict__ S, float* __restrict__ R_out,
                    float* __restrict__ t_out,
                    long long* __restrict__ n_meas,
                    float* __restrict__ mean_res) {
  __shared__ float pose[12];
  __shared__ float scratch[gn::WARPS * gn::NSUM];
  __shared__ float sums[gn::NSUM];
  const int tid = threadIdx.x;
  const int n = q.n;
  if (tid < 9) pose[tid] = R0[tid];
  if (tid < 3) pose[9 + tid] = t0[tid];
  __syncthreads();
  float diag[2] = {0.0f, 0.0f};   // (sum of visible mean |r|, visible count)

  for (int l = 0; l < lv.n; ++l) {
    const Level L = lv.lv[l];
    // reference patches, gradients, Jp and ref_ok of my points
    for (int i = tid; i < n; i += gn::THREADS) {
      const float* uv = q.uv + static_cast<size_t>(i) * q.suv;
      const float* X = q.X + static_cast<size_t>(i) * q.sx;
      const float x = X[0], y = X[1], z = X[2];
      const float ul = (uv[0] + 0.5f) * L.scale - 0.5f;
      const float vl = (uv[1] + 0.5f) * L.scale - 0.5f;
      float B[PB * PB];
      sample_patch<PB>(L.ref, L.rh, L.rw, L.rs, ul, vl, B);
#pragma unroll
      for (int a = 0; a < P; ++a) {
#pragma unroll
        for (int b = 0; b < P; ++b) {
          const int k = a * P + b;
          S[static_cast<size_t>(S_REF + k) * n + i] = B[(a + 1) * PB + b + 1];
          S[static_cast<size_t>(S_GX + k) * n + i] =
              0.5f * (B[(a + 1) * PB + b + 2] - B[(a + 1) * PB + b]);
          S[static_cast<size_t>(S_GY + k) * n + i] =
              0.5f * (B[(a + 2) * PB + b + 1] - B[a * PB + b + 1]);
        }
      }
      const float zi = 1.0f / gn::max_nan(z, 1e-6f);
      const float zi2 = zi * zi;
      const float zero = 0.0f;
      const float d[2][3] = {{L.fx * zi, zero, -L.fx * x * zi2},
                             {zero, L.fy * zi, -L.fy * y * zi2}};
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        float* jp = S + static_cast<size_t>(S_JP + 6 * a) * n + i;
        // dpi @ [I | -hat(X)], -hat(X) = [[0, z, -y], [-z, 0, x], [y, -x, 0]]
        jp[0] = d[a][0];
        jp[static_cast<size_t>(n)] = d[a][1];
        jp[2 * static_cast<size_t>(n)] = d[a][2];
        jp[3 * static_cast<size_t>(n)] = -d[a][1] * z + d[a][2] * y;
        jp[4 * static_cast<size_t>(n)] = d[a][0] * z - d[a][2] * x;
        jp[5 * static_cast<size_t>(n)] = -d[a][0] * y + d[a][1] * x;
      }
      const bool ok = q.valid[static_cast<size_t>(i) * q.sval] && z > 0.1f
                      && in_bounds(ul, vl, L.cw, L.ch);
      S[static_cast<size_t>(S_OK) * n + i] = ok ? 1.0f : 0.0f;
    }

    for (int it = 0; it < iters; ++it) {
      float Pz[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) Pz[k] = pose[k];
      float acc[gn::NSUM];
#pragma unroll
      for (int k = 0; k < gn::NSUM; ++k) acc[k] = 0.0f;
      for (int i = tid; i < n; i += gn::THREADS) {
        const float* X = q.X + static_cast<size_t>(i) * q.sx;
        float u, v;
        const bool front = project(Pz, L, X[0], X[1], X[2], u, v);
        const bool vis = S[static_cast<size_t>(S_OK) * n + i] != 0.0f
                         && front && in_bounds(u, v, L.cw, L.ch);
        float cur[P * P];
        sample_patch<P>(L.cur, L.ch, L.cw, L.cs, u, v, cur);
        float jp[12];
#pragma unroll
        for (int k = 0; k < 12; ++k)
          jp[k] = S[static_cast<size_t>(S_JP + k) * n + i];
        const float visf = vis ? 1.0f : 0.0f;
#pragma unroll
        for (int k = 0; k < P * P; ++k) {
          const float r = cur[k] - S[static_cast<size_t>(S_REF + k) * n + i];
          const float gx = S[static_cast<size_t>(S_GX + k) * n + i];
          const float gy = S[static_cast<size_t>(S_GY + k) * n + i];
          const float wh = gn::min_nan(10.0f / gn::max_nan(fabsf(r), 1e-6f),
                                       1.0f);
          const float wr = visf * wh;
          float J[6], Jw[6];
#pragma unroll
          for (int j = 0; j < 6; ++j) {
            J[j] = gx * jp[j] + gy * jp[6 + j];
            Jw[j] = J[j] * wr;
          }
          gn::add_row(acc, Jw, J, r);
        }
      }
      gn::block_sum(acc, scratch, sums);
      if (tid == 0) gn::gn_update(sums, 1e-6f, false, pose);
      __syncthreads();
    }

    if (l == lv.n - 1) {   // diagnostics at the finest processed level
      float Pz[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) Pz[k] = pose[k];
      for (int i = tid; i < n; i += gn::THREADS) {
        const float* X = q.X + static_cast<size_t>(i) * q.sx;
        float u, v;
        const bool front = project(Pz, L, X[0], X[1], X[2], u, v);
        const bool vis = S[static_cast<size_t>(S_OK) * n + i] != 0.0f
                         && front && in_bounds(u, v, L.cw, L.ch);
        float cur[P * P];
        sample_patch<P>(L.cur, L.ch, L.cw, L.cs, u, v, cur);
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < P * P; ++k)
          s += fabsf(cur[k] - S[static_cast<size_t>(S_REF + k) * n + i]);
        if (vis) {
          diag[0] += s / 16.0f;
          diag[1] += 1.0f;
        }
      }
    }
  }
  gn::block_sum(diag, scratch, sums);
  if (tid == 0) {
    // counts up to 2^24 are exact in a float sum
    const long long m = static_cast<long long>(sums[1]);
    *n_meas = m;
    *mean_res = sums[0] / static_cast<float>(m > 1 ? m : 1);
  }
  if (tid < 9) R_out[tid] = pose[tid];
  if (tid < 3) t_out[tid] = pose[9 + tid];
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError(), so
// the caller sees a refused launch at once. The level arrays (host memory,
// n_levels entries each) give every level of the walk its two images
// (device pointers), their shapes and row strides (floats) and its scale
// and intrinsics; `scratch` holds ygz_sparse_align_scratch_floats(n,
// n_levels) floats of device memory.
extern "C" int ygz_sparse_align(
    const float* uv, int suv, const float* X, int sx, const uint8_t* valid,
    int sval, int n, const float* const* ref, const int* ref_hws,
    const float* const* cur, const int* cur_hws, const float* intr5,
    int n_levels, const float* R0, const float* t0, int iters,
    float* scratch, float* R_out, float* t_out, long long* n_meas,
    float* mean_res, void* stream) {
  if (n_levels < 0 || n_levels > MAX_LEVELS) return cudaErrorInvalidValue;
  Levels lv{};
  lv.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    Level& L = lv.lv[l];
    L.ref = ref[l];
    L.rh = ref_hws[3 * l];
    L.rw = ref_hws[3 * l + 1];
    L.rs = ref_hws[3 * l + 2];
    L.cur = cur[l];
    L.ch = cur_hws[3 * l];
    L.cw = cur_hws[3 * l + 1];
    L.cs = cur_hws[3 * l + 2];
    L.scale = intr5[5 * l];
    L.fx = intr5[5 * l + 1];
    L.fy = intr5[5 * l + 2];
    L.cx = intr5[5 * l + 3];
    L.cy = intr5[5 * l + 4];
  }
  Points q{uv, suv, X, sx, valid, sval, n};
  sparse_align_kernel<<<1, gn::THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      q, lv, R0, t0, iters, scratch, R_out, t_out, n_meas, mean_res);
  return static_cast<int>(cudaGetLastError());
}

// The floats of device scratch that ygz_sparse_align needs for n points
// over n_levels levels, or -1 where it would refuse the walk.
extern "C" int ygz_sparse_align_scratch_floats(int n, int n_levels) {
  if (n_levels < 0 || n_levels > MAX_LEVELS || n < 1) return -1;
  return S_ROWS * n;
}
