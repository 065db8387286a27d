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
// ~270) take ~0.1 us at 67 TFLOP/s: the card's bound is far below a microsecond. What sets the time is
// the chain of 40 dependent steps, each a block-wide sum, one thread's 6x6
// solve and exponential, and two barriers. The design keeps the whole chain
// in one block of one launch (the eager version issued ~7,500 kernels per
// call): every thread walks its rows (i = tid, tid + 256, ...) from global
// memory (L1-resident after the first step), sums its 27 products in row
// order, and the block sums them in a fixed tree (gn_common.cuh); thread 0
// solves and publishes the pose in shared memory. No atomics: a launch
// repeats bit for bit, so a CUDA graph replay of the frame step does too.
#include "gn_common.cuh"

namespace {

constexpr float CHI2_EPS = 1e-12f;

struct Rows {
  const float* X;   int sx;    // [N, 3], row stride sx
  const float* uv;  int suv;   // [N, 2]
  const float* is2; int sis2;  // [N]
  const float* ur;  int sur;   // [N] or null (all mono)
  const uint8_t* valid; int sval;  // [N] bool
  int n;
};

// _reproj_residual_jac3 for row i at pose (R, t): r [3], A [3][6], z, chi2
// and whether the row is stereo. A mono row's third residual and Jacobian
// row are zero in the plain version; here they are left unset and unused.
__device__ __forceinline__ bool residual(const Rows& q, int i,
                                         const float* P, float fx, float fy,
                                         float cx, float cy, float bf,
                                         float* r, float (*A)[6], float& z,
                                         float& c2) {
  const float* X = q.X + static_cast<size_t>(i) * q.sx;
  const float X0 = X[0], X1 = X[1], X2 = X[2];
  const float x = P[0] * X0 + P[1] * X1 + P[2] * X2 + P[9];
  const float y = P[3] * X0 + P[4] * X1 + P[5] * X2 + P[10];
  z = P[6] * X0 + P[7] * X1 + P[8] * X2 + P[11];
  const float zi = 1.0f / gn::max_nan(z, 1e-6f);
  const float u = fx * x * zi + cx;
  const float v = fy * y * zi + cy;
  const float ur = q.ur ? q.ur[static_cast<size_t>(i) * q.sur] : -1.0f;
  const bool stereo = ur >= 0.0f;
  const float* uv = q.uv + static_cast<size_t>(i) * q.suv;
  r[0] = u - uv[0];
  r[1] = v - uv[1];
  const float zero = 0.0f * zi;
  float d[3][3] = {{fx * zi, zero, -fx * x * zi * zi},
                   {zero, fy * zi, -fy * y * zi * zi},
                   {0.0f, 0.0f, 0.0f}};
  float rr = r[0] * r[0] + r[1] * r[1];
  if (stereo) {
    r[2] = u - bf * zi - ur;
    d[2][0] = d[0][0];
    d[2][1] = d[0][1];
    d[2][2] = d[0][2] + bf * zi * zi;
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
  c2 = rr * q.is2[static_cast<size_t>(i) * q.sis2];
  return stereo;
}

__global__ void __launch_bounds__(gn::THREADS)
pose_gn_kernel(Rows q, const float* __restrict__ R0,
               const float* __restrict__ t0, float fx, float fy, float cx,
               float cy, float bf, float th_mono, float th_stereo,
               int rounds, int iters, float* __restrict__ R_out,
               float* __restrict__ t_out, uint8_t* __restrict__ inl,
               long long* __restrict__ n_inl, float* __restrict__ chi2) {
  __shared__ float pose[12];
  __shared__ float scratch[gn::WARPS * gn::NSUM];
  __shared__ float sums[gn::NSUM];
  __shared__ int counts[gn::WARPS];
  const int tid = threadIdx.x;
  if (tid < 9) pose[tid] = R0[tid];
  if (tid < 3) pose[9 + tid] = t0[tid];
  for (int i = tid; i < q.n; i += gn::THREADS)
    inl[i] = q.valid[static_cast<size_t>(i) * q.sval] ? 1 : 0;
  __syncthreads();

  // the inlier gate: inliers = valid & (chi2 < gate) & (z > 0); chi2 out
  auto gate = [&]() {
    float P[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) P[k] = pose[k];
    for (int i = tid; i < q.n; i += gn::THREADS) {
      float r[3], A[3][6], z, c2;
      const bool stereo = residual(q, i, P, fx, fy, cx, cy, bf, r, A, z, c2);
      const bool ok = q.valid[static_cast<size_t>(i) * q.sval]
                      && c2 < (stereo ? th_stereo : th_mono) && z > 0.0f;
      inl[i] = ok ? 1 : 0;
      chi2[i] = c2;
    }
  };

  for (int rd = 0; rd < rounds; ++rd) {
    const bool huber = rd < rounds - 2;
    for (int it = 0; it < iters; ++it) {
      float P[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) P[k] = pose[k];
      float acc[gn::NSUM];
#pragma unroll
      for (int k = 0; k < gn::NSUM; ++k) acc[k] = 0.0f;
      for (int i = tid; i < q.n; i += gn::THREADS) {
        float r[3], A[3][6], z, c2;
        const bool stereo =
            residual(q, i, P, fx, fy, cx, cy, bf, r, A, z, c2);
        float w = q.is2[static_cast<size_t>(i) * q.sis2]
                  * (inl[i] ? 1.0f : 0.0f) * (z > 0.0f ? 1.0f : 0.0f);
        if (huber) {
          const float d2 = stereo ? th_stereo : th_mono;
          w *= c2 <= d2 ? 1.0f : sqrtf(d2 / gn::max_nan(c2, CHI2_EPS));
        }
        auto add = [&](int a) {
          float aw[6];
#pragma unroll
          for (int j = 0; j < 6; ++j) aw[j] = A[a][j] * w;
          gn::add_row(acc, aw, A[a], r[a]);
        };
        add(0);
        add(1);
        if (stereo) add(2);
      }
      gn::block_sum(acc, scratch, sums);
      if (tid == 0) gn::gn_update(sums, 1e-8f, true, pose);
      __syncthreads();
    }
    gate();
    __syncthreads();
  }
  if (rounds <= 0) {
    gate();
    // no round: the inliers stay `valid`
    for (int i = tid; i < q.n; i += gn::THREADS)
      inl[i] = q.valid[static_cast<size_t>(i) * q.sval] ? 1 : 0;
    __syncthreads();
  }

  int c = 0;
  for (int i = tid; i < q.n; i += gn::THREADS) c += inl[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    c += __shfl_down_sync(0xffffffffu, c, off);
  if ((tid & 31) == 0) counts[tid >> 5] = c;
  __syncthreads();
  if (tid == 0) {
    long long total = 0;
    for (int w = 0; w < gn::WARPS; ++w) total += counts[w];
    *n_inl = total;
  }
  if (tid < 9) R_out[tid] = pose[tid];
  if (tid < 3) t_out[tid] = pose[9 + tid];
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
  pose_gn_kernel<<<1, gn::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      q, R0, t0, fx, fy, cx, cy, bf, th_mono, th_stereo, rounds, iters,
      R_out, t_out, inliers, n_inliers, chi2);
  return static_cast<int>(cudaGetLastError());
}
