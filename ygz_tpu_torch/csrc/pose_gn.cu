// The staged pose-only Gauss-Newton in one launch, for Hopper (sm_90a), plain
// C interface. Entry ygz_pose_gn; wrapper backend/optim.py::
// pose_optimization, plain version pose_optimization_torch (the same
// function, line for line: ygz_tpu/backend/optim.py::pose_optimization, a
// lax.fori_loop that XLA compiled; no Pallas kernel stands behind it).
//
// What it computes: `rounds` x `iters` GN steps on a 6-DoF pose (world ->
// camera) against N reprojection rows, mono (u, v) or stereo (u, v, u_r)
// where ur >= 0. Weight inv_sigma2 * inlier * (z > 0), times the Huber
// weight of the row's chi2 at its gate (chi2_th mono, 7.815 chi2_th / 5.991
// stereo) in the rounds before the last two. H += 1e-8 trace(H) / 6 I, the
// preconditioned solve, pose <- exp(-delta) * pose (left). After each round
// the inliers are valid & (chi2 < gate) & (z > 0); the chi2 of that last
// gate pass is the output's chi2 (the plain version's final chi2 pass gives
// the same bits: the same pose, the same float operations).
//
// Bound. At the main path's N = 512 the call reads ~16 KB and writes ~3 KB,
// and its ~4 MFLOP (40 steps x 512 mono rows x ~190 flops; a stereo row
// ~270) take ~0.1 us at 67 TFLOP/s: the card's bound is far below a
// microsecond. What sets the time is the chain of 40 dependent steps. The
// design keeps the whole chain in one launch (the eager version issued
// ~7,500 kernels per call) and gives each step one barrier (gn_common.cuh's
// gn_step): a cluster of up to 4 blocks of 128 threads (a block per 128
// rows; one warp per scheduler, as every warp solves), each thread holding
// its rows (i = g, g + stride, ...; X, uv, weight, ur, valid, inlier flag
// and chi2) in registers for the whole call, up to 8 rows a thread (rows
// past that are read from global memory at each use); each thread sums its
// 27 products in row order, the cluster sums them in one fixed order, and
// every warp solves, so the pose stays in registers. No atomics: a launch
// repeats bit for bit, so a CUDA graph replay of the frame step does too.
#include "gn_common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = 8;     // rows a thread holds in registers
constexpr int MAX_BLOCKS = 4;   // blocks of the cluster at most
constexpr float CHI2_EPS = 1e-12f;

struct Rows {
  const float* X;   int sx;    // [N, 3], row stride sx
  const float* uv;  int suv;   // [N, 2]
  const float* is2; int sis2;  // [N]
  const float* ur;  int sur;   // [N] or null (all mono)
  const uint8_t* valid; int sval;  // [N] bool
  int n;
};

struct Params {
  float fx, fy, cx, cy, bf, th_mono, th_stereo;
};

// one row's inputs, read once
struct Row {
  float X0, X1, X2, u, v, is2, ur;
  bool valid;
};

__device__ __forceinline__ Row load_row(const Rows& q, int i) {
  const float* X = q.X + static_cast<size_t>(i) * q.sx;
  const float* uv = q.uv + static_cast<size_t>(i) * q.suv;
  Row w;
  w.X0 = X[0];
  w.X1 = X[1];
  w.X2 = X[2];
  w.u = uv[0];
  w.v = uv[1];
  w.is2 = q.is2[static_cast<size_t>(i) * q.sis2];
  w.ur = q.ur ? q.ur[static_cast<size_t>(i) * q.sur] : -1.0f;
  w.valid = q.valid[static_cast<size_t>(i) * q.sval] != 0;
  return w;
}

// _reproj_residual_jac3 for row w at pose P: r [3], A [3][6], z, chi2 and
// whether the row is stereo. A mono row's third residual and Jacobian row
// are zero in the plain version; here they are left unset and unused.
__device__ __forceinline__ bool residual(const Row& w, const float* P,
                                         const Params& c, float* r,
                                         float (*A)[6], float& z,
                                         float& c2) {
  const float x = P[0] * w.X0 + P[1] * w.X1 + P[2] * w.X2 + P[9];
  const float y = P[3] * w.X0 + P[4] * w.X1 + P[5] * w.X2 + P[10];
  z = P[6] * w.X0 + P[7] * w.X1 + P[8] * w.X2 + P[11];
  const float zi = 1.0f / gn::max_nan(z, 1e-6f);
  const float u = c.fx * x * zi + c.cx;
  const float v = c.fy * y * zi + c.cy;
  const bool stereo = w.ur >= 0.0f;
  r[0] = u - w.u;
  r[1] = v - w.v;
  const float zero = 0.0f * zi;
  float d[3][3] = {{c.fx * zi, zero, -c.fx * x * zi * zi},
                   {zero, c.fy * zi, -c.fy * y * zi * zi},
                   {0.0f, 0.0f, 0.0f}};
  float rr = r[0] * r[0] + r[1] * r[1];
  if (stereo) {
    r[2] = u - c.bf * zi - w.ur;
    d[2][0] = d[0][0];
    d[2][1] = d[0][1];
    d[2][2] = d[0][2] + c.bf * zi * zi;
    rr += r[2] * r[2];
  }
  // -(dpi @ hat(Xc)), hat(Xc) = [[0, -z, y], [z, 0, -x], [-y, x, 0]]
  auto jac_row = [&](int a) {
    A[a][0] = d[a][0];
    A[a][1] = d[a][1];
    A[a][2] = d[a][2];
    A[a][3] = -(d[a][1] * z - d[a][2] * y);
    A[a][4] = -(-d[a][0] * z + d[a][2] * x);
    A[a][5] = -(d[a][0] * y - d[a][1] * x);
  };
  jac_row(0);
  jac_row(1);
  if (stereo) jac_row(2);
  c2 = rr * w.is2;
  return stereo;
}

// acc += the row's normal equations: weight inv_sigma2 * inlier * (z > 0),
// times the Huber weight at the row's gate in the early rounds
__device__ __forceinline__ void accumulate(const Row& w, bool inl,
                                           const float* P, const Params& c,
                                           bool huber,
                                           float (&acc)[gn::NSUM]) {
  float r[3], A[3][6], z, c2;
  const bool stereo = residual(w, P, c, r, A, z, c2);
  float wt = w.is2 * (inl ? 1.0f : 0.0f) * (z > 0.0f ? 1.0f : 0.0f);
  if (huber) {
    const float d2 = stereo ? c.th_stereo : c.th_mono;
    wt *= c2 <= d2 ? 1.0f : sqrtf(d2 / gn::max_nan(c2, CHI2_EPS));
  }
  auto add = [&](int a) {
    float aw[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) aw[j] = A[a][j] * wt;
    gn::add_row(acc, aw, A[a], r[a]);
  };
  add(0);
  add(1);
  if (stereo) add(2);
}

// the inlier gate at P: valid & (chi2 < gate) & (z > 0), and the chi2
__device__ __forceinline__ bool gate(const Row& w, const float* P,
                                     const Params& c, float& c2) {
  float r[3], A[3][6], z;
  const bool stereo = residual(w, P, c, r, A, z, c2);
  return w.valid && c2 < (stereo ? c.th_stereo : c.th_mono) && z > 0.0f;
}

// K rows a thread in registers (row g + k * stride, g the thread's place
// among the cluster's stride = nblocks * THREADS threads); rows from
// K * stride on are read from global memory, their inlier flags kept in
// `inl`, by the thread that owns them.
template <int K>
__global__ void __launch_bounds__(THREADS)
pose_gn_kernel(Rows q, const float* __restrict__ R0,
               const float* __restrict__ t0, Params c, int rounds,
               int iters, float* __restrict__ R_out,
               float* __restrict__ t_out, uint8_t* __restrict__ inl,
               long long* __restrict__ n_inl, float* __restrict__ chi2) {
  __shared__ float part[2 * MAX_BLOCKS * WARPS * 32];
  __shared__ unsigned long long bar[2];
  const int nblocks = gridDim.x;
  gn::Combine<WARPS, MAX_BLOCKS> combine(part, bar, nblocks);
  combine.init();
  const int tid = threadIdx.x;
  const int g = blockIdx.x * THREADS + tid;
  const int stride = nblocks * THREADS;
  float P[12];
#pragma unroll
  for (int k = 0; k < 9; ++k) P[k] = R0[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) P[9 + k] = t0[k];
  Row rows[K];
  bool in[K];
  float c2s[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = g + k * stride;
    rows[k] = i < q.n ? load_row(q, i) : Row{};
    in[k] = rows[k].valid;
    c2s[k] = 0.0f;
  }
  const int tail = K * stride;
  for (int i = tail + g; i < q.n; i += stride)
    inl[i] = q.valid[static_cast<size_t>(i) * q.sval] ? 1 : 0;

  auto gate_all = [&]() {
#pragma unroll
    for (int k = 0; k < K; ++k)
      in[k] = gate(rows[k], P, c, c2s[k]);
    for (int i = tail + g; i < q.n; i += stride) {
      float c2;
      inl[i] = gate(load_row(q, i), P, c, c2) ? 1 : 0;
      chi2[i] = c2;
    }
  };

  for (int rd = 0; rd < rounds; ++rd) {
    const bool huber = rd < rounds - 2;
    for (int it = 0; it < iters; ++it) {
      float acc[gn::NSUM];
#pragma unroll
      for (int k = 0; k < gn::NSUM; ++k) acc[k] = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (g + k * stride < q.n)
          accumulate(rows[k], in[k], P, c, huber, acc);
      }
      for (int i = tail + g; i < q.n; i += stride)
        accumulate(load_row(q, i), inl[i] != 0, P, c, huber, acc);
      gn::gn_step(combine, acc, 1e-8f, true, P);
    }
    gate_all();
  }
  if (rounds <= 0) {
    gate_all();
    // no round: the inliers stay `valid`
#pragma unroll
    for (int k = 0; k < K; ++k) in[k] = rows[k].valid;
    for (int i = tail + g; i < q.n; i += stride)
      inl[i] = q.valid[static_cast<size_t>(i) * q.sval] ? 1 : 0;
  }

  // the inlier count over the cluster, by one more combine (counts up to
  // 2^24 are exact in a float sum)
  float cnt[gn::NSUM];
#pragma unroll
  for (int k = 0; k < gn::NSUM; ++k) cnt[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = g + k * stride;
    if (i < q.n) {
      inl[i] = in[k] ? 1 : 0;
      chi2[i] = c2s[k];
      cnt[0] += in[k] ? 1.0f : 0.0f;
    }
  }
  for (int i = tail + g; i < q.n; i += stride) cnt[0] += inl[i];
  const float total = combine(gn::warp_reduce_scatter(cnt));
  if (g == 0) *n_inl = static_cast<long long>(total);
  if (g < 9) R_out[g] = P[g];
  if (g < 3) t_out[g] = P[9 + g];
  combine.finish();
}

template <int K>
cudaError_t launch(int nblocks, cudaStream_t stream, const Rows& q,
                   const float* R0, const float* t0, const Params& c,
                   int rounds, int iters, float* R_out, float* t_out,
                   uint8_t* inl, long long* n_inl, float* chi2) {
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
  return cudaLaunchKernelEx(&cfg, pose_gn_kernel<K>, q, R0, t0, c, rounds,
                            iters, R_out, t_out, inl, n_inl, chi2);
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError(), so
// the caller sees a refused launch at once. Pointers are device pointers;
// strides count floats (bytes for `valid`); ur may be null.
extern "C" int ygz_pose_gn(const float* X, int sx, const float* uv, int suv,
                           const float* is2, int sis2, const float* ur,
                           int sur, const uint8_t* valid, int sval, int n,
                           const float* R0, const float* t0, float fx,
                           float fy, float cx, float cy, float bf,
                           float th_mono, float th_stereo, int rounds,
                           int iters, float* R_out, float* t_out,
                           uint8_t* inliers, long long* n_inliers,
                           float* chi2, void* stream) {
  Rows q{X, sx, uv, suv, is2, sis2, ur, sur, valid, sval, n};
  Params c{fx, fy, cx, cy, bf, th_mono, th_stereo};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // a block per THREADS rows up to MAX_BLOCKS, then the fewest register
  // rows a thread that hold all N (at most MAX_ROWS)
  const int fill = (n + THREADS - 1) / THREADS;
  const int nb = fill < MAX_BLOCKS ? (fill > 0 ? fill : 1) : MAX_BLOCKS;
  const int per = (n + nb * THREADS - 1) / (nb * THREADS);
  const cudaError_t err =
      per <= 1   ? launch<1>(nb, st, q, R0, t0, c, rounds, iters, R_out,
                             t_out, inliers, n_inliers, chi2)
      : per <= 2 ? launch<2>(nb, st, q, R0, t0, c, rounds, iters, R_out,
                             t_out, inliers, n_inliers, chi2)
      : per <= 4 ? launch<4>(nb, st, q, R0, t0, c, rounds, iters, R_out,
                             t_out, inliers, n_inliers, chi2)
                 : launch<MAX_ROWS>(nb, st, q, R0, t0, c, rounds, iters,
                                    R_out, t_out, inliers, n_inliers, chi2);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
