// The direct tracker's per-point work in one launch per pass, for Hopper
// (sm_90a), plain C interface. Entry ygz_direct_align; wrapper
// frontend/direct_tracker.py::direct_align (called by track_local_map_direct,
// two launches, and refine_matches_core, one), plain versions
// track_local_map_direct_torch and refine_matches_core_torch. It replaces
// ygz_tpu/frontend/direct_tracker.py::_warp_setup and _make_align_all over
// ygz_tpu/ops/align.py::align2d_stacked, an XLA loop (lax.fori_loop) with no
// Pallas kernel behind it: ygz_tpu/ops/pallas_fast.py planned a
// gather-heavy patch-alignment kernel and never wrote it.
//
// What it computes, per cached point:
// 1. The setup (do_setup; else read from the scratch a setup launch wrote):
//    project with the pose; `visible` = valid & z > 0.1 & a 20-px border;
//    the affine warp cur <- ref by finite differences (d = 5 px) through the
//    point's reference camera; the search level ceil(0.5 log2 |det A|)
//    clamped to the pyramid; the 10x10 bordered warped patch resampled from
//    the stored 20x20 reference patch by _bilinear_patches' rule, and
//    warp_ok (every sample inside the stored patch); inv_sigma2 = 0.25^level.
// 2. The pass at the pose (R, t): the selection valid & z > 0.1 & the
//    20-px border & warp_ok, level-local coordinates through the stacked
//    pyramid's level table, the central-difference gradients of the warped
//    patch, the 3x3 Hessian + 1e-4 I and its inverse (a NaN patch gives a
//    NaN inverse and a point that never converges, as inv_ex does), and
//    `iters` inverse-compositional steps: the 9x9 shared-fraction gather of
//    ops/align.py::sample_patches (the integer corner clamped to the stacked
//    buffer's W0 - 9 and SH - 9, not the level's: reference defect C-ref1,
//    kept), the residual against ref + mean, J^T r, delta = Hinv g, the
//    update and the convergence test |step|^2 < eps^2. A point that has
//    converged no longer moves in the plain version, so its warp leaves the
//    loop there. Then the level's in-bounds test, the conversion back to
//    level 0 and where(good, uv0, 0); a row that `prev_ok` marks keeps
//    `prev_uv` (the frame step's pass 2 merged into pass 1).
//
// Bound. At the main path's N = 512, a frame's two launches read each
// point's inputs once (the 20x20 stored patch, 1.6 KB, and ~70 B more),
// its 9x9 window once per pass (324 B: successive steps read nearly the
// same pixels, from the ~2.7-MB stacked pyramid, L2-resident) and write
// ~18 B a point: ~1.2 MB, 0.36 us at 3.35 TB/s. The arithmetic, ~14 MFLOP
// counted at every step of every point, takes ~0.2 us at 67 TFLOP/s
// (slam_bench/metrics/direct_align_roofline.py counts both). What sets
// the time is neither: it is a chain of 10 dependent steps per pass, each
// a gather, a 3-wide sum over 64 pixels and a 3x3 product. One warp per point: a lane
// owns 2 of the 64 inner pixels and keeps their reference value and
// gradients in registers, the warped patch stays in shared memory; a step
// is one round of 8 independent loads per lane (L1/L2 hits after the
// first), then 5 rounds of shuffles. The shuffles are an xor butterfly in
// one fixed order, so every lane holds the same sums bit for bit and no
// atomics are used: a launch repeats bit for bit, and the warp leaves its
// loop together. Pass 2 skips the points pass 1 aligned. 4 warps a block:
// 512 points fill 128 of the card's 132 SMs.
#include "gn_common.cuh"

namespace {

constexpr int WARPS = 4;              // points per block, one warp each
constexpr int THREADS = 32 * WARPS;
constexpr int P = 8;                  // aligned patch side (align.py PATCH)
constexpr int PB = P + 2;             // bordered warped patch (WARP_BORDER)
constexpr int NB = PB * PB;
constexpr int PIX = P * P / 32;       // inner pixels per lane
constexpr int RP = 20;                // stored reference patch (REF_PATCH)
constexpr int BORDER = 20;            // the selection's border in level-0 px
constexpr int MAX_LEVELS = 8;
constexpr unsigned FULL = 0xffffffffu;
static_assert(P * P == 32 * PIX, "two inner pixels per lane");

struct Points {
  const float* X; int sx;             // [N, 3] world points
  const uint8_t* valid; int sval;     // [N]
  const float* patch; int sp;         // [N, 400] stored reference patches
  const float* ref_uv; int sruv;      // [N, 2] level-0 pixel in the ref frame
  const int* ref_level; int srl;      // [N] the stored patch's level
  const float* ref_R; int srR;        // [N, 9] ref camera <- world
  const float* ref_t; int srt;        // [N, 3]
  int n;
};

struct Image {
  const float* stack; int sh, w0, stride;  // stacked [SH, W0] pyramid
  int h0;                                  // level 0's height
  float xmax, ymax;                        // W0 - 1.001, SH - 1.001
  int n_levels;
  int row_off[MAX_LEVELS], h[MAX_LEVELS], w[MAX_LEVELS];
};

struct Intr {
  float v[4];          // fx, fy, cx, cy
};

struct Setup {
  float* warped;       // [N, 100]
  uint8_t* warp_ok;    // [N]
  int* level;          // [N]
  float* inv_sigma2;   // [N]
  uint8_t* visible;    // [N]
};

struct Out {
  const float* prev_uv;     // [N, 2] kept where prev_ok, or null
  const uint8_t* prev_ok;   // [N] or null
  float* uv;                // [N, 2]
  uint8_t* ok;              // [N]
};

__device__ __forceinline__ float warp_sum(float v) {
  // an xor butterfly: both partners add the same two numbers, so every lane
  // ends with the same bits
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  return v;
}

// direct_tracker.py::_project: (u, v) and the camera depth z
__device__ __forceinline__ void project(const float* R, const float* t,
                                        const float* K, float X0, float X1,
                                        float X2, float& u, float& v,
                                        float& z) {
  const float x = X0 * R[0] + X1 * R[1] + X2 * R[2] + t[0];
  const float y = X0 * R[3] + X1 * R[4] + X2 * R[5] + t[1];
  z = X0 * R[6] + X1 * R[7] + X2 * R[8] + t[2];
  const float zi = 1.0f / gn::max_nan(z, 1e-6f);
  u = K[0] * x * zi + K[2];
  v = K[1] * y * zi + K[3];
}

// ops/image.py::in_bounds with the selection's border, at level 0
__device__ __forceinline__ bool in_border(float u, float v, const Image& im) {
  return u >= BORDER && u < static_cast<float>(im.w0 - 1 - BORDER)
         && v >= BORDER && v < static_cast<float>(im.h0 - 1 - BORDER);
}

__device__ __forceinline__ int to_int(float x) {
  // a NaN converts to 0 on the card; torch's clamp of its int64 conversion
  // gives the clamp's lower end, 0 in every use below
  return static_cast<int>(x);
}

// The setup of one point: returns its level, writes the warped patch to wp
// (shared) and sets warp_ok
__device__ int warp_setup(const Points& q, const Image& im, const float* K,
                          const float* R, const float* t, int i, int lane,
                          float X0, float X1, float X2, float* wp,
                          bool& warp_ok) {
  const float* Rr = q.ref_R + static_cast<size_t>(i) * q.srR;
  const float* tr = q.ref_t + static_cast<size_t>(i) * q.srt;
  const float* ruv = q.ref_uv + static_cast<size_t>(i) * q.sruv;
  const float zr = gn::max_nan(X0 * Rr[6] + X1 * Rr[7] + X2 * Rr[8] + tr[2],
                               1e-6f);
  // ref pixel (+ du, dv) -> ref camera at depth zr -> world -> cur pixel
  float c[3][2];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float du = k == 1 ? 5.0f : 0.0f, dv = k == 2 ? 5.0f : 0.0f;
    const float xn = (ruv[0] + du - K[2]) / K[0];
    const float yn = (ruv[1] + dv - K[3]) / K[1];
    const float d0 = xn * zr - tr[0], d1 = yn * zr - tr[1], d2 = zr - tr[2];
    const float W0 = Rr[0] * d0 + Rr[3] * d1 + Rr[6] * d2;
    const float W1 = Rr[1] * d0 + Rr[4] * d1 + Rr[7] * d2;
    const float W2 = Rr[2] * d0 + Rr[5] * d1 + Rr[8] * d2;
    float z;
    project(R, t, K, W0, W1, W2, c[k][0], c[k][1], z);
  }
  // A_cur_ref: columns d(cur)/d(ref u), d(cur)/d(ref v)
  const float a00 = (c[1][0] - c[0][0]) / 5.0f;
  const float a10 = (c[1][1] - c[0][1]) / 5.0f;
  const float a01 = (c[2][0] - c[0][0]) / 5.0f;
  const float a11 = (c[2][1] - c[0][1]) / 5.0f;
  const float sdet = a00 * a11 - a01 * a10;
  float lf = ceilf(0.5f * log2f(gn::max_nan(fabsf(sdet), 1e-6f)));
  lf = gn::clamp_nan(lf, 0.0f, static_cast<float>(im.n_levels - 1));
  const int lvl = isnan(lf) ? 0 : static_cast<int>(lf);
  // _inv2x2: A_ref_cur, the determinant kept off 0
  const float det = fabsf(sdet) < 1e-8f ? 1e-8f : sdet;
  const float i00 = a11 / det, i01 = -a01 / det;
  const float i10 = -a10 / det, i11 = a00 / det;
  const int rl = q.ref_level[static_cast<size_t>(i) * q.srl];
  const float sc = ldexpf(1.0f, lvl) / ldexpf(1.0f, rl);
  const float* pr = q.patch + static_cast<size_t>(i) * q.sp;
  const float cmax = static_cast<float>(RP - 1.001);
  bool inside = true;
  for (int k = lane; k < NB; k += 32) {
    const float ox = static_cast<float>(k % PB) - 4.5f;
    const float oy = static_cast<float>(k / PB) - 4.5f;
    const float cx = (i00 * ox + i01 * oy) * sc + 0.5f * (RP - 1);
    const float cy = (i10 * ox + i11 * oy) * sc + 0.5f * (RP - 1);
    inside = inside && cx > 0.5f && cx < RP - 1.5f && cy > 0.5f
             && cy < RP - 1.5f;
    const float x = gn::clamp_nan(cx, 0.0f, cmax);
    const float y = gn::clamp_nan(cy, 0.0f, cmax);
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    const int i0 = min(max(to_int(y0), 0), RP - 2) * RP
                   + min(max(to_int(x0), 0), RP - 2);
    wp[k] = (1.0f - fy) * ((1.0f - fx) * pr[i0] + fx * pr[i0 + 1])
            + fy * ((1.0f - fx) * pr[i0 + RP] + fx * pr[i0 + RP + 1]);
  }
  warp_ok = __all_sync(FULL, inside);
  return lvl;
}

__global__ void __launch_bounds__(THREADS)
direct_align_kernel(Points q, Image im, Intr in,
                    const float* __restrict__ Rp, const float* __restrict__ tp,
                    int do_setup, Setup s, Out o, int iters, float eps2) {
  __shared__ float patch_sh[WARPS][NB];
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int i = blockIdx.x * WARPS + wi;
  if (i >= q.n) return;                 // the whole warp
  float* wp = patch_sh[wi];
  if (o.prev_ok != nullptr && o.prev_ok[i]) {   // kept from the last pass
    if (lane == 0) {
      o.uv[2 * i] = o.prev_uv[2 * i];
      o.uv[2 * i + 1] = o.prev_uv[2 * i + 1];
      o.ok[i] = 1;
    }
    return;
  }
  float K[4], R[9], t[3];
#pragma unroll
  for (int k = 0; k < 4; ++k) K[k] = in.v[k];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = Rp[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = tp[k];
  const float* X = q.X + static_cast<size_t>(i) * q.sx;
  const float X0 = X[0], X1 = X[1], X2 = X[2];
  const bool valid = q.valid[static_cast<size_t>(i) * q.sval] != 0;
  float u, v, z;
  project(R, t, K, X0, X1, X2, u, v, z);
  const bool front = valid && z > 0.1f && in_border(u, v, im);

  int lvl;
  bool warp_ok;
  if (do_setup) {
    lvl = warp_setup(q, im, K, R, t, i, lane, X0, X1, X2, wp, warp_ok);
    for (int k = lane; k < NB; k += 32)
      s.warped[static_cast<size_t>(i) * NB + k] = wp[k];
    if (lane == 0) {
      s.level[i] = lvl;
      s.warp_ok[i] = warp_ok;
      s.inv_sigma2[i] = ldexpf(1.0f, -2 * lvl);
      s.visible[i] = front;
    }
  } else {
    for (int k = lane; k < NB; k += 32)
      wp[k] = s.warped[static_cast<size_t>(i) * NB + k];
    lvl = s.level[i];
    warp_ok = s.warp_ok[i] != 0;
  }
  if (!(front && warp_ok)) {
    if (lane == 0) {
      o.uv[2 * i] = 0.0f;
      o.uv[2 * i + 1] = 0.0f;
      o.ok[i] = 0;
    }
    return;
  }
  __syncwarp();

  // ops/align.py::_patch_jacobian: the inner reference pixels, their
  // central-difference gradients, the 3x3 Hessian of J = [dx, dy, 1]
  float ref[PIX], dx[PIX], dy[PIX];
  float hxx = 0.0f, hxy = 0.0f, hx = 0.0f, hyy = 0.0f, hy = 0.0f;
#pragma unroll
  for (int m = 0; m < PIX; ++m) {
    const int p = lane + 32 * m, a = p / P + 1, b = p % P + 1;
    ref[m] = wp[a * PB + b];
    dx[m] = 0.5f * (wp[a * PB + b + 1] - wp[a * PB + b - 1]);
    dy[m] = 0.5f * (wp[(a + 1) * PB + b] - wp[(a - 1) * PB + b]);
    hxx += dx[m] * dx[m];
    hxy += dx[m] * dy[m];
    hx += dx[m];
    hyy += dy[m] * dy[m];
    hy += dy[m];
  }
  const float ha = warp_sum(hxx) + 1e-4f, hb = warp_sum(hxy);
  const float hc = warp_sum(hx), hd = warp_sum(hyy) + 1e-4f;
  const float he = warp_sum(hy), hf = static_cast<float>(P * P) + 1e-4f;
  // the symmetric inverse by cofactors (a NaN patch: NaN throughout)
  const float c00 = hd * hf - he * he, c01 = hc * he - hb * hf;
  const float c02 = hb * he - hc * hd, c11 = ha * hf - hc * hc;
  const float c12 = hb * hc - ha * he, c22 = ha * hd - hb * hb;
  const float hdet = ha * c00 + hb * c01 + hc * c02;
  const float n00 = c00 / hdet, n01 = c01 / hdet, n02 = c02 / hdet;
  const float n11 = c11 / hdet, n12 = c12 / hdet, n22 = c22 / hdet;

  // level-local start; sample_patches adds the level's row offset
  const float scale = ldexpf(1.0f, -lvl);
  const float row = static_cast<float>(im.row_off[lvl]);
  u = (u + 0.5f) * scale - 0.5f;
  v = (v + 0.5f) * scale - 0.5f;
  float mean = 0.0f;
  bool conv = false;
  const float* img = im.stack;
  for (int it = 0; it < iters && !conv; ++it) {
    const float x = gn::clamp_nan(u, 0.0f, im.xmax) - 0.5f * (P - 1);
    const float y = gn::clamp_nan(v + row, 0.0f, im.ymax) - 0.5f * (P - 1);
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    const int xi = min(max(to_int(x0), 0), im.w0 - P - 1);
    const int yi = min(max(to_int(y0), 0), im.sh - P - 1);
    float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
#pragma unroll
    for (int m = 0; m < PIX; ++m) {
      const int p = lane + 32 * m;
      const float* b = img + static_cast<size_t>(yi + p / P) * im.stride
                       + xi + p % P;
      const float top = (1.0f - fx) * __ldg(b) + fx * __ldg(b + 1);
      const float bot = (1.0f - fx) * __ldg(b + im.stride)
                        + fx * __ldg(b + im.stride + 1);
      const float r = ((1.0f - fy) * top + fy * bot) - (ref[m] + mean);
      g0 += dx[m] * r;
      g1 += dy[m] * r;
      g2 += r;
    }
    g0 = warp_sum(g0);
    g1 = warp_sum(g1);
    g2 = warp_sum(g2);
    const float d0 = n00 * g0 + n01 * g1 + n02 * g2;
    const float d1 = n01 * g0 + n11 * g1 + n12 * g2;
    const float d2 = n02 * g0 + n12 * g1 + n22 * g2;
    // inverse compositional: the warp increment is subtracted, the mean
    // accumulates; the step that converges is still applied
    u -= d0;
    v -= d1;
    mean += d2;
    conv = d0 * d0 + d1 * d1 < eps2;
  }
  if (lane == 0) {
    const bool inb = u > 0.5f * P + 1 && u < static_cast<float>(
                         im.w[lvl] - P / 2 - 2)
                     && v > 0.5f * P + 1 && v < static_cast<float>(
                         im.h[lvl] - P / 2 - 2);
    const bool good = conv && inb;
    o.uv[2 * i] = good ? (u + 0.5f) / scale - 0.5f : 0.0f;
    o.uv[2 * i + 1] = good ? (v + 0.5f) / scale - 0.5f : 0.0f;
    o.ok[i] = good;
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError(), so
// the caller sees a refused launch at once (cudaErrorInvalidValue for
// arguments the kernel cannot take). `levels` (host memory) holds each
// level's row offset in the stack, height and width; `intr` (host memory)
// fx, fy, cx, cy; R and t (device) the pose of the pass. do_setup: compute
// the setup at that pose into the five setup arrays; else read them, as a
// setup launch at the same points left them. prev_uv / prev_ok: rows to keep
// (or null).
extern "C" int ygz_direct_align(
    const float* X, int sx, const uint8_t* valid, int sval,
    const float* patch, int sp, const float* ref_uv, int sruv,
    const int* ref_level, int srl, const float* ref_R, int srR,
    const float* ref_t, int srt, int n, const float* stack, int sh, int w0,
    int stride, int h0, const int* levels, int n_levels,
    const float* intr, const float* R, const float* t, int do_setup,
    float* warped, uint8_t* warp_ok, int* level, float* inv_sigma2,
    uint8_t* visible, const float* prev_uv, const uint8_t* prev_ok,
    int iters, float eps2, float* uv, uint8_t* ok, void* stream) {
  if (n < 1 || n_levels < 1 || n_levels > MAX_LEVELS || w0 < P + 1
      || sh < P + 1 || h0 < 1 || h0 > sh || iters < 0
      || (prev_uv == nullptr) != (prev_ok == nullptr))
    return cudaErrorInvalidValue;
  Image im{};
  im.stack = stack;
  im.sh = sh;
  im.w0 = w0;
  im.stride = stride;
  im.h0 = h0;
  im.xmax = static_cast<float>(w0 - 1.001);
  im.ymax = static_cast<float>(sh - 1.001);
  im.n_levels = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    im.row_off[l] = levels[3 * l];
    im.h[l] = levels[3 * l + 1];
    im.w[l] = levels[3 * l + 2];
    if (im.row_off[l] < 0 || im.row_off[l] + im.h[l] > sh || im.w[l] > w0)
      return cudaErrorInvalidValue;
  }
  Intr in{};
  for (int k = 0; k < 4; ++k) in.v[k] = intr[k];
  Points q{X, sx, valid, sval, patch, sp, ref_uv, sruv, ref_level, srl,
           ref_R, srR, ref_t, srt, n};
  Setup s{warped, warp_ok, level, inv_sigma2, visible};
  Out o{prev_uv, prev_ok, uv, ok};
  const int blocks = (n + WARPS - 1) / WARPS;
  direct_align_kernel<<<blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      q, im, in, R, t, do_setup, s, o, iters, eps2);
  return static_cast<int>(cudaGetLastError());
}
