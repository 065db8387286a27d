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
// the chain of 30 dependent steps, and within a step the 8,192 pixel rows'
// instructions, more than one SM issues in a few microseconds. So the row
// pass is spread over a thread-block cluster of up to 8 blocks of 128
// threads (one SM each): four threads a point, one row of its 4x4 patch
// each, points (n = slot, slot + slots, ...) held in registers up to four a
// thread (N <= 1,024 at 8 blocks; points past that are set up again at
// each step). Each level's fixed terms of a thread's patch row (its 4 reference
// pixels, their Jacobian rows J = g (dpi [I | -X^]) and ref_ok) are formed
// once into registers. A step is gn_common.cuh's gn_step over the cluster:
// every warp of every block reduce-scatters its sums and pushes them into
// every block's shared memory (st.async, counted on each block's
// mbarrier), and every warp adds them in one fixed order and solves, so
// the pose stays in registers. No atomics: a launch repeats bit for bit.
#include "gn_common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LEVELS = 8;
constexpr int P = 4;            // patch side (PATCH)
constexpr int PB = P + 2;       // bordered reference patch side
constexpr int BORDER = 3;       // PATCH_HALF + 1
constexpr int PER_BLOCK = THREADS / P;   // points a block holds at a time
constexpr int MAX_POINTS = 4;   // points a thread holds in registers
constexpr int MAX_BLOCKS = 8;   // blocks of the cluster at most (portable)

struct Level {
  const float* ref; int rh, rw, rs;   // ref level [rh, rw], row stride rs
  const float* cur; int ch, cw, cs;   // cur level
  float scale, fx, fy, cx, cy;        // 0.5^l and the level intrinsics
};

struct Levels {
  Level lv[MAX_LEVELS];
  int n;
};

// rows r0 .. r0 + ROWS - 1 of sample_patches(img, (u, v), size): one
// (size + 1)^2 integer gather blended by the shared fraction, each entry
// by the same float operations as the whole patch's
template <int SIZE, int ROWS>
__device__ __forceinline__ void sample_rows(const float* img, int h, int w,
                                            int stride, float u, float v,
                                            int r0, float (&out)[ROWS][SIZE]) {
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
  const float* base = img + static_cast<size_t>(yi + r0) * stride + xi;
  float prev[SIZE + 1];
#pragma unroll
  for (int c = 0; c <= SIZE; ++c) prev[c] = base[c];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float next[SIZE + 1];
    const float* row = base + static_cast<size_t>(r + 1) * stride;
#pragma unroll
    for (int c = 0; c <= SIZE; ++c) next[c] = row[c];
#pragma unroll
    for (int c = 0; c < SIZE; ++c) {
      const float top = (1.0f - fx) * prev[c] + fx * prev[c + 1];
      const float bot = (1.0f - fx) * next[c] + fx * next[c + 1];
      out[r][c] = (1.0f - fy) * top + fy * bot;
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

// project X at pose Pz with the level intrinsics: (u, v), z > 0.1
__device__ __forceinline__ bool project(const float* Pz, const Level& L,
                                        float X0, float X1, float X2,
                                        float& u, float& v) {
  const float x = X0 * Pz[0] + X1 * Pz[1] + X2 * Pz[2] + Pz[9];
  const float y = X0 * Pz[3] + X1 * Pz[4] + X2 * Pz[5] + Pz[10];
  const float z = X0 * Pz[6] + X1 * Pz[7] + X2 * Pz[8] + Pz[11];
  const float zi = 1.0f / gn::max_nan(z, 1e-6f);
  u = L.fx * x * zi + L.cx;
  v = L.fy * y * zi + L.cy;
  return z > 0.1f;
}

// One point's fixed terms at one level for the thread of patch row a: the
// row's 4 inner reference pixels, their Jacobian rows, and ref_ok.
struct PointRow {
  float X0, X1, X2;
  float ref[P];
  float J[P][6];
  bool ok;
};

__device__ __forceinline__ PointRow setup(const Points& q, const Level& L,
                                          int i, int a) {
  PointRow p;
  const float* uv = q.uv + static_cast<size_t>(i) * q.suv;
  const float* X = q.X + static_cast<size_t>(i) * q.sx;
  const float x = X[0], y = X[1], z = X[2];
  p.X0 = x;
  p.X1 = y;
  p.X2 = z;
  const float ul = (uv[0] + 0.5f) * L.scale - 0.5f;
  const float vl = (uv[1] + 0.5f) * L.scale - 0.5f;
  float B[3][PB];   // rows a, a + 1, a + 2 of the bordered patch
  sample_rows<PB, 3>(L.ref, L.rh, L.rw, L.rs, ul, vl, a, B);
  const float zi = 1.0f / gn::max_nan(z, 1e-6f);
  const float zi2 = zi * zi;
  const float zero = 0.0f;
  const float d[2][3] = {{L.fx * zi, zero, -L.fx * x * zi2},
                         {zero, L.fy * zi, -L.fy * y * zi2}};
  float jp[2][6];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    // dpi @ [I | -hat(X)], -hat(X) = [[0, z, -y], [-z, 0, x], [y, -x, 0]]
    jp[e][0] = d[e][0];
    jp[e][1] = d[e][1];
    jp[e][2] = d[e][2];
    jp[e][3] = -d[e][1] * z + d[e][2] * y;
    jp[e][4] = d[e][0] * z - d[e][2] * x;
    jp[e][5] = -d[e][0] * y + d[e][1] * x;
  }
#pragma unroll
  for (int b = 0; b < P; ++b) {
    p.ref[b] = B[1][b + 1];
    const float gx = 0.5f * (B[1][b + 2] - B[1][b]);
    const float gy = 0.5f * (B[2][b + 1] - B[0][b + 1]);
#pragma unroll
    for (int j = 0; j < 6; ++j) p.J[b][j] = gx * jp[0][j] + gy * jp[1][j];
  }
  p.ok = q.valid[static_cast<size_t>(i) * q.sval] && z > 0.1f
         && in_bounds(ul, vl, L.cw, L.ch);
  return p;
}

// the point's current patch row at Pz: whether the point is visible, and
// the row's residuals r (current less reference)
__device__ __forceinline__ bool current_row(const PointRow& p, const Level& L,
                                            const float* Pz, int a,
                                            float (&r)[P]) {
  float u, v;
  const bool front = project(Pz, L, p.X0, p.X1, p.X2, u, v);
  const bool vis = p.ok && front && in_bounds(u, v, L.cw, L.ch);
  float cur[1][P];
  sample_rows<P, 1>(L.cur, L.ch, L.cw, L.cs, u, v, a, cur);
#pragma unroll
  for (int b = 0; b < P; ++b) r[b] = cur[0][b] - p.ref[b];
  return vis;
}

// acc += the normal equations of the row's 4 pixels: the residual r, the
// Huber weight min(1, 10 / max(|r|, 1e-6)) on a visible point
__device__ __forceinline__ void accumulate(const PointRow& p,
                                           const float (&r)[P], bool vis,
                                           float (&acc)[gn::NSUM]) {
  const float visf = vis ? 1.0f : 0.0f;
#pragma unroll
  for (int b = 0; b < P; ++b) {
    const float wh = gn::min_nan(10.0f / gn::max_nan(fabsf(r[b]), 1e-6f),
                                 1.0f);
    const float wr = visf * wh;
    float Jw[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) Jw[j] = p.J[b][j] * wr;
    gn::add_row(acc, Jw, p.J[b], r[b]);
  }
}

// K points a thread in registers (point slot + k * slots, slot the
// thread's place among the cluster's PER_BLOCK * nblocks point slots);
// points from K * slots on are set up again at each use. Every loop over
// points runs the same trips in every thread (the shuffles of the
// diagnostics need whole warps).
template <int K>
__global__ void __launch_bounds__(THREADS)
sparse_align_kernel(Points q, Levels lv, const float* __restrict__ R0,
                    const float* __restrict__ t0, int iters,
                    float* __restrict__ R_out, float* __restrict__ t_out,
                    long long* __restrict__ n_meas,
                    float* __restrict__ mean_res) {
  __shared__ float part[2 * MAX_BLOCKS * WARPS * 32];
  __shared__ unsigned long long bar[2];
  const int nblocks = gridDim.x;
  gn::Combine<WARPS, MAX_BLOCKS> combine(part, bar, nblocks);
  combine.init();
  const int tid = threadIdx.x;
  const int a = tid % P;
  const int slot = blockIdx.x * PER_BLOCK + tid / P;
  const int slots = nblocks * PER_BLOCK;
  const int n = q.n;
  float Pz[12];
#pragma unroll
  for (int k = 0; k < 9; ++k) Pz[k] = R0[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) Pz[9 + k] = t0[k];
  float diag[gn::NSUM];   // (sum of visible mean |r|, visible count), 0...
#pragma unroll
  for (int k = 0; k < gn::NSUM; ++k) diag[k] = 0.0f;

  for (int l = 0; l < lv.n; ++l) {
    const Level L = lv.lv[l];
    PointRow pts[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = slot + k * slots;
      if (i < n) pts[k] = setup(q, L, i, a);
    }

    for (int it = 0; it < iters; ++it) {
      float acc[gn::NSUM];
#pragma unroll
      for (int k = 0; k < gn::NSUM; ++k) acc[k] = 0.0f;
      // every held point's gathers first, so their loads overlap
      float r[K][P];
      bool vis[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        vis[k] = false;
        if (slot + k * slots < n)
          vis[k] = current_row(pts[k], L, Pz, a, r[k]);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (slot + k * slots < n) accumulate(pts[k], r[k], vis[k], acc);
      }
      for (int i = slot + K * slots; i < n; i += slots) {
        const PointRow pt = setup(q, L, i, a);
        float rt[P];
        const bool v = current_row(pt, L, Pz, a, rt);
        accumulate(pt, rt, v, acc);
      }
      gn::gn_step(combine, acc, 1e-6f, false, Pz);
    }

    if (l == lv.n - 1) {   // diagnostics at the finest processed level
      auto tally = [&](const PointRow& p, bool here) {
        float r[P];
        const bool vis = here && current_row(p, L, Pz, a, r);
        float s = 0.0f;
#pragma unroll
        for (int b = 0; b < P; ++b) s += here ? fabsf(r[b]) : 0.0f;
        // the point's four rows, in one order in each of its threads
        s += __shfl_xor_sync(gn::FULL, s, 1);
        s += __shfl_xor_sync(gn::FULL, s, 2);
        if (vis && a == 0) {
          diag[0] += s / 16.0f;
          diag[1] += 1.0f;
        }
      };
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool here = slot + k * slots < n;
        tally(pts[k], here);
      }
      for (int base = K * slots; base < n; base += slots) {
        const int i = base + slot;
        tally(i < n ? setup(q, L, i, a) : PointRow{}, i < n);
      }
    }
  }
  const float s = combine(gn::warp_reduce_scatter(diag));
  const float count = __shfl_sync(gn::FULL, s, 1);
  if (blockIdx.x == 0 && tid == 0) {
    // counts up to 2^24 are exact in a float sum
    const long long m = static_cast<long long>(count);
    *n_meas = m;
    *mean_res = s / static_cast<float>(m > 1 ? m : 1);
  }
  if (blockIdx.x == 0 && tid < 9) R_out[tid] = Pz[tid];
  if (blockIdx.x == 0 && tid < 3) t_out[tid] = Pz[9 + tid];
  combine.finish();
}

template <int K>
cudaError_t launch(int nblocks, cudaStream_t stream, const Points& q,
                   const Levels& lv, const float* R0, const float* t0,
                   int iters, float* R_out, float* t_out, long long* n_meas,
                   float* mean_res) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblocks, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nblocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = nblocks > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, sparse_align_kernel<K>, q, lv, R0, t0,
                            iters, R_out, t_out, n_meas, mean_res);
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError() (or
// the launch's own error), so the caller sees a refused launch at once. The
// level arrays (host memory, n_levels entries each) give every level of
// the walk its two images (device pointers), their shapes and row strides
// (floats) and its scale and intrinsics. One cluster of as many blocks as
// N's points fill (PER_BLOCK a block, at most MAX_BLOCKS), each thread
// holding as few points as hold all N (at most MAX_POINTS).
extern "C" int ygz_sparse_align(
    const float* uv, int suv, const float* X, int sx, const uint8_t* valid,
    int sval, int n, const float* const* ref, const int* ref_hws,
    const float* const* cur, const int* cur_hws, const float* intr5,
    int n_levels, const float* R0, const float* t0, int iters,
    float* R_out, float* t_out, long long* n_meas, float* mean_res,
    void* stream) {
  if (n_levels < 0 || n_levels > MAX_LEVELS || n < 1)
    return cudaErrorInvalidValue;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int fill = (n + PER_BLOCK - 1) / PER_BLOCK;
  const int nblocks = fill < MAX_BLOCKS ? fill : MAX_BLOCKS;
  const int per = (n + nblocks * PER_BLOCK - 1) / (nblocks * PER_BLOCK);
  cudaError_t err =
      per <= 1   ? launch<1>(nblocks, st, q, lv, R0, t0, iters, R_out, t_out,
                             n_meas, mean_res)
      : per <= 2 ? launch<2>(nblocks, st, q, lv, R0, t0, iters, R_out, t_out,
                             n_meas, mean_res)
                 : launch<MAX_POINTS>(nblocks, st, q, lv, R0, t0, iters,
                                      R_out, t_out, n_meas, mean_res);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The most pyramid levels ygz_sparse_align walks in one launch.
extern "C" int ygz_sparse_align_max_levels() { return MAX_LEVELS; }
