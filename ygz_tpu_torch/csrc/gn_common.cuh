// Device helpers shared by the one-launch Gauss-Newton kernels (pose_gn.cu,
// sparse_align.cu): the one-barrier GN step (the normal equations' sums
// over the block or the cluster, the Jacobi-preconditioned partial-pivot LU
// solve of the 6x6 system in every warp, the SE(3) exponential) and the
// SE(3) helpers. Each repeats the float operations of its plain PyTorch
// counterpart (backend/optim.py::solve_preconditioned, geometry/lie.py::
// se3_exp and se3_mul) in float32; sums run in another order than on the
// CPU, so results agree with the plain versions to float32 rounding, and a
// launch repeats bit for bit (no atomics, one summation order).
//
// A GN step's time is a chain of latencies, not bytes or operations. The
// step here has one barrier: each warp reduce-scatters its 27 sums (a
// butterfly of 31 shuffles leaves lane L with the warp's sum L), the warps
// (of every block of a cluster) hand their sums over shared memory across
// one barrier, and every warp adds them in one fixed order, so every warp
// holds the same H and b bit for bit. Every warp then solves (the scaling
// spread over its lanes, the elimination in every lane's registers) and
// takes the exponential itself; the pose stays in every thread's
// registers, with no second barrier and no broadcast.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gn {

namespace cg = cooperative_groups;

constexpr unsigned FULL = 0xffffffffu;
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

// One stage of the butterfly: a lane keeps one half of its first 2H values
// (the upper where lane bit H is set) and adds its partner's copy of it.
template <int H>
__device__ __forceinline__ void scatter_stage(float (&v)[32], int lane) {
  const bool up = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, H);
  }
  if constexpr (H > 1) scatter_stage<H / 2>(v, lane);
}

// The butterfly reduce-scatter of a warp: lane L returns the sum over the
// warp's lanes of acc[L] (0 for L >= NSUM), in one fixed order, by five
// stages of halving (31 shuffles in all).
__device__ __forceinline__ float warp_reduce_scatter(const float (&acc)[NSUM]) {
  float v[32];
#pragma unroll
  for (int k = 0; k < NSUM; ++k) v[k] = acc[k];
#pragma unroll
  for (int k = NSUM; k < 32; ++k) v[k] = 0.0f;
  scatter_stage<16>(v, threadIdx.x & 31);
  return v[0];
}

// p[0] <- the sum of p[0 .. 2H) by a fixed pairwise tree
template <int H>
__device__ __forceinline__ void tree_sum(float* p) {
#pragma unroll
  for (int i = 0; i < H; ++i) p[i] = p[i] + p[i + H];
  if constexpr (H > 1) tree_sum<H / 2>(p);
}

// 32-bit shared-memory addresses and the Hopper cluster primitives the
// combine below uses (PTX: mapa, st.async, mbarrier)
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// The sums of a step over the warps of the block, or of every block of a
// cluster of `nblocks` (at most MAXB) blocks, across one barrier: every
// lane L of every warp gets the L-th total, bit for bit the same in every
// warp (the parts are added in (block, warp) order by a fixed tree).
// `part` is the block's shared float[2 * MAXB * WARPS * 32] and `bar` its
// shared uint64_t[2]; steps use their halves in turn. One block: each warp
// writes its part, __syncthreads. A cluster: each warp pushes its part
// into every block's `part` with st.async, which counts the bytes on that
// block's mbarrier, and each block waits on its own mbarrier for all of
// them (no cluster barrier and no memory fence in the step). Two halves
// suffice: a part for step k + 2 can only be sent by a warp past step
// k + 1's wait, which needs every warp's step k + 1 part, each sent after
// that warp read its step k parts.
template <int WARPS, int MAXB>
struct Combine {
  static_assert(((WARPS * MAXB) & (WARPS * MAXB - 1)) == 0,
                "a power-of-two tree of parts");
  float* part;
  unsigned long long* bar;
  int nblocks;
  int phase;

  __device__ Combine(float* part_, unsigned long long* bar_, int nblocks_)
      : part(part_), bar(bar_), nblocks(nblocks_), phase(0) {}

  __device__ bool clustered() const { return MAXB > 1 && nblocks > 1; }

  // Every thread calls it once, before the first step.
  __device__ void init() {
    if (!clustered()) return;
    if (threadIdx.x == 0) {
      for (int h = 0; h < 2; ++h)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                     :: "r"(smem_addr(bar + h)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cg::this_cluster().sync();
  }

  __device__ float operator()(float v) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int h = phase & 1;
    const uint32_t parity = (phase >> 1) & 1;
    ++phase;
    float* half = part + h * MAXB * WARPS * 32;
    if (clustered()) {
      const int rank = blockIdx.x;    // the grid is one cluster
      const uint32_t dst = smem_addr(half + (rank * WARPS + warp) * 32 + lane);
      const uint32_t mbar = smem_addr(bar + h);
      if (threadIdx.x == 0)
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
            :: "r"(mbar), "r"(nblocks * WARPS * 32 * 4) : "memory");
#pragma unroll
      for (int b = 0; b < MAXB; ++b) {
        if (b < nblocks)
          asm volatile(
              "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32"
              " [%0], %1, [%2];"
              :: "r"(map_rank(dst, b)), "f"(v), "r"(map_rank(mbar, b))
              : "memory");
      }
      uint32_t done = 0;
      while (!done)
        asm volatile(
            "{ .reg .pred p;"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
            " selp.u32 %0, 1, 0, p; }"
            : "=r"(done) : "r"(mbar), "r"(parity) : "memory");
    } else {
      half[warp * 32 + lane] = v;
      __syncthreads();
    }
    float p[WARPS * MAXB];
#pragma unroll
    for (int b = 0; b < MAXB; ++b) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        p[b * WARPS + w] = b < nblocks ? half[(b * WARPS + w) * 32 + lane]
                                       : 0.0f;
    }
    tree_sum<WARPS * MAXB / 2>(p);
    return p[0];
  }

  // Before a block of a cluster exits: no other block still sends to it.
  __device__ void finish() const {
    if (clustered()) cg::this_cluster().sync();
  }
};

// The index of H[i][j], i <= j, in the upper triangle (row-major)
__device__ __forceinline__ int tri(int i, int j) {
  return i * 6 - (i * (i - 1)) / 2 + (j - i);
}

// x = solve_preconditioned(H + reg * trace(H) / 6 * I, b) by one warp, every
// lane ending with all of x; lane L < NSUM holds the L-th sum s (H's upper
// triangle, then b). The Jacobi scaling by sqrt(clamp(diag, 1e-12)) is
// spread over the lanes (lane L scales its own sum); every lane then takes
// the 27 scaled sums and runs, in its own registers, the LU with partial
// pivoting of LAPACK's getrf on the augmented [A | y]: the first largest
// |pivot| at or below the diagonal (a NaN is never larger), the rows
// swapped by selects, the column below scaled by the pivot's reciprocal
// (getf2's scal; a zero pivot leaves it unscaled); then the back
// substitution by the same reciprocals. A singular system gives non-finite
// steps, as torch.linalg.solve_ex does, and nothing is raised. No shuffle
// and no divergent branch lies on the elimination's chain.
__device__ void solve6(float s, float reg, float (&x)[6]) {
  const int lane = threadIdx.x & 31;
  float tr = __shfl_sync(FULL, s, tri(0, 0));
#pragma unroll
  for (int i = 1; i < 6; ++i) tr += __shfl_sync(FULL, s, tri(i, i));
  const float add = reg * tr / 6.0f;
  // lane i < 6: the scale d_i of row and column i
  const int li = lane < 6 ? lane : 0;
  const float dl =
      sqrtf(max_nan(__shfl_sync(FULL, s, tri(li, li)) + add, 1e-12f));
  // lane L: the entry H[i][j] (L < NH) or b[i] (L >= NH) it holds, scaled
  const int i = (lane >= 6) + (lane >= 11) + (lane >= 15) + (lane >= 18)
                + (lane >= 20);
  const int j = min(lane - tri(i, i) + i, 5);
  const bool rhs = lane >= NH;
  const int bi = min(max(lane - NH, 0), 5);
  const float di = __shfl_sync(FULL, dl, rhs ? bi : i);
  const float dj = __shfl_sync(FULL, dl, j);
  const float e = rhs ? s / di : (i == j ? s + add : s) / (di * dj);
  float A[6][7];
  {
    int k = 0;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
#pragma unroll
      for (int c = r; c < 6; ++c) {
        A[r][c] = __shfl_sync(FULL, e, k++);
        A[c][r] = A[r][c];
      }
    }
#pragma unroll
    for (int r = 0; r < 6; ++r) A[r][6] = __shfl_sync(FULL, e, NH + r);
  }
  float inv[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    float best = fabsf(A[c][c]);
    int p = c;
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const float a = fabsf(A[r][c]);
      p = a > best ? r : p;
      best = a > best ? a : best;
    }
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const bool sw = p == r;
#pragma unroll
      for (int k = c; k < 7; ++k) {
        const float t = A[c][k];
        A[c][k] = sw ? A[r][k] : t;
        A[r][k] = sw ? t : A[r][k];
      }
    }
    const float piv = A[c][c];
    const float rcp = 1.0f / piv;
    inv[c] = rcp;
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const float l = piv != 0.0f ? A[r][c] * rcp : A[r][c];
#pragma unroll
      for (int k = c + 1; k < 7; ++k) A[r][k] -= l * A[c][k];
    }
  }
  float w[6];   // U w = z, from the last row up
#pragma unroll
  for (int r = 5; r >= 0; --r) {
    float v = A[r][6];
#pragma unroll
    for (int k = r + 1; k < 6; ++k) v -= A[r][k] * w[k];
    w[r] = v * inv[r];
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) x[r] = w[r] / __shfl_sync(FULL, dl, r);
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

// One Gauss-Newton step from this thread's partial sums acc: the step
// solve(H + reg, b) over the block's (or cluster's) sums, exp(-step),
// composed on the left of the pose (P <- exp(-step) * P) or on its right
// (P <- P * exp(-step)). Every thread of the block calls it, with the same
// P (R 9 | t 3, in registers), and every thread ends with the same new P.
template <int WARPS, int MAXB>
__device__ void gn_step(Combine<WARPS, MAXB>& combine,
                        const float (&acc)[NSUM], float reg, bool left,
                        float (&P)[12]) {
  const float s = combine(warp_reduce_scatter(acc));
  float x[6], Rd[9], td[3], R[9], t[3];
  solve6(s, reg, x);
#pragma unroll
  for (int i = 0; i < 6; ++i) x[i] = -x[i];
  se3_exp(x, Rd, td);
  if (left)
    se3_mul(Rd, td, P, P + 9, R, t);
  else
    se3_mul(P, P + 9, Rd, td, R, t);
#pragma unroll
  for (int k = 0; k < 9; ++k) P[k] = R[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) P[9 + k] = t[k];
}

}  // namespace gn
