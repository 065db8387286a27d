// Device helpers shared by the one-launch Gauss-Newton kernels (pose_gn.cu,
// sparse_align.cu): the fixed-order block sum of the normal equations, the
// Jacobi-preconditioned partial-pivot LU solve of a 6x6 system and the SE(3)
// exponential. Each repeats the float operations of its plain PyTorch
// counterpart (backend/optim.py::solve_preconditioned, geometry/lie.py::
// se3_exp and se3_mul) in float32; sums run in another order than on the
// CPU, so results agree with the plain versions to float32 rounding, and a
// launch repeats bit for bit (no atomics, one summation order).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gn {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NH = 21;            // upper triangle of the 6x6 H, row-major
constexpr int NSUM = NH + 6;      // ... then the 6 entries of b

// torch.clamp / torch.minimum semantics: a NaN input stays NaN
__device__ __forceinline__ float max_nan(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float min_nan(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// acc[k] += a_i * a_j (i <= j) and acc[NH + i] += a_i * r for one row a of
// the Jacobian with its weight folded into aw = a * w
__device__ __forceinline__ void add_row(float (&acc)[NSUM], const float* aw,
                                        const float* a, float r) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += aw[i] * a[j];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[NH + i] += aw[i] * r;
}

// Sum K per-thread values over the block in one fixed order: a shuffle tree
// in each warp, then the warps' sums in warp order by the first K threads.
// On return out[0..K) (shared) holds the sums, visible to warp 0 only;
// `scratch` holds WARPS * K floats of shared memory. Every thread calls it.
template <int K>
__device__ void block_sum(float (&acc)[K], float* scratch, float* out) {
  static_assert(K <= 32, "one lane of warp 0 per sum");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) scratch[warp * K + k] = v;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = scratch[threadIdx.x];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += scratch[w * K + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncwarp();
}

// x = solve_preconditioned(H + reg * trace(H) / 6 * I, b) from the block
// sums s (NSUM: H's upper triangle, then b). Jacobi scaling by
// sqrt(clamp(diag, 1e-12)), then LU with partial pivoting as LAPACK's getrf
// (the first largest |pivot|; a zero pivot leaves its column unscaled) and
// the two triangular solves of getrs: a singular system gives non-finite
// steps, as torch.linalg.solve_ex does, and nothing is raised.
__device__ void solve6(const float* s, float reg, float* x) {
  float A[6][6], y[6], d[6];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      A[i][j] = s[k];
      A[j][i] = s[k];
      ++k;
    }
  }
  float tr = A[0][0];
#pragma unroll
  for (int i = 1; i < 6; ++i) tr += A[i][i];
  const float add = reg * tr / 6.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    A[i][i] += add;
    d[i] = sqrtf(max_nan(A[i][i], 1e-12f));
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) A[i][j] = A[i][j] / (d[i] * d[j]);
    y[i] = s[NH + i] / d[i];
  }
  int perm[6] = {0, 1, 2, 3, 4, 5};
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    int p = c;
    float best = fabsf(A[c][c]);
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      if (fabsf(A[r][c]) > best) {
        best = fabsf(A[r][c]);
        p = r;
      }
    }
    if (p != c) {
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const float tmp = A[c][j];
        A[c][j] = A[p][j];
        A[p][j] = tmp;
      }
      const int tp = perm[c];
      perm[c] = perm[p];
      perm[p] = tp;
    }
    if (A[c][c] != 0.0f) {
#pragma unroll
      for (int r = c + 1; r < 6; ++r) A[r][c] = A[r][c] / A[c][c];
    }
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
#pragma unroll
      for (int j = c + 1; j < 6; ++j) A[r][j] -= A[r][c] * A[c][j];
    }
  }
  float z[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {   // L z = P y (unit lower triangle)
    float v = y[perm[i]];
#pragma unroll
    for (int j = 0; j < i; ++j) v -= A[i][j] * z[j];
    z[i] = v;
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {  // U w = z
    float v = z[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) v -= A[i][j] * z[j];
    z[i] = v / A[i][i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) x[i] = z[i] / d[i];
}

// geometry/lie.py::se3_exp of xi = [upsilon, omega], with its small-angle
// Taylor branches (theta^2 < 1e-8) and the formulas in its order
__device__ void se3_exp(const float* xi, float* R, float* t) {
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = th2 < 1e-8f;
  const float th = sqrtf(small ? 1.0f : th2);
  const float sn = sinf(th), cs = cosf(th);
  const float a = small ? 1.0f - th2 / 6.0f : sn / th;
  const float b = small ? 0.5f - th2 / 24.0f : (1.0f - cs) / th2;
  const float c = small ? 1.0f / 6.0f - th2 / 120.0f
                        : (th - sn) / (th2 * th);
  const float W[9] = {0.0f, -w2, w1, w2, 0.0f, -w0, -w1, w0, 0.0f};
  float W2[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      W2[3 * i + j] = W[3 * i] * W[j] + W[3 * i + 1] * W[3 + j]
                      + W[3 * i + 2] * W[6 + j];
  }
  float V[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float eye = (k % 4 == 0) ? 1.0f : 0.0f;
    R[k] = eye + a * W[k] + b * W2[k];
    V[k] = eye + b * W[k] + c * W2[k];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    t[i] = V[3 * i] * xi[0] + V[3 * i + 1] * xi[1] + V[3 * i + 2] * xi[2];
}

// (Ra, ta) * (Rb, tb) = (Ra Rb, Ra tb + ta) into (R, t); R, t may not alias
__device__ void se3_mul(const float* Ra, const float* ta, const float* Rb,
                        const float* tb, float* R, float* t) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      R[3 * i + j] = Ra[3 * i] * Rb[j] + Ra[3 * i + 1] * Rb[3 + j]
                     + Ra[3 * i + 2] * Rb[6 + j];
    t[i] = Ra[3 * i] * tb[0] + Ra[3 * i + 1] * tb[1] + Ra[3 * i + 2] * tb[2]
           + ta[i];
  }
}

// One Gauss-Newton update by thread 0 from the block sums s: the step
// solve(H + reg, b), exp(-step), composed on the left of the pose
// (pose <- exp(-step) * pose) or on its right (pose <- pose * exp(-step)).
__device__ void gn_update(const float* s, float reg, bool left,
                          float* pose /* R 9 | t 3, shared */) {
  float x[6], Rd[9], td[3], R[9], t[3];
  solve6(s, reg, x);
#pragma unroll
  for (int i = 0; i < 6; ++i) x[i] = -x[i];
  se3_exp(x, Rd, td);
  if (left)
    se3_mul(Rd, td, pose, pose + 9, R, t);
  else
    se3_mul(pose, pose + 9, Rd, td, R, t);
#pragma unroll
  for (int k = 0; k < 9; ++k) pose[k] = R[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) pose[9 + k] = t[k];
}

}  // namespace gn
