// Hand-written Hopper (sm_90a) kernels for batched inverse-compositional KLT.
//
// Replaces the feature-parallel Pallas TPU kernels of
// visual_odometry_ros_tpu/ops/klt_pallas_fp.py:
//   klt_pyr    <- track_level_fp (Phase A _gather_banks + Phase B
//                 _iterate_banks, and the re-anchor restart passes), and the
//                 level-by-level climb of ops/klt.py:_pyr_track around it:
//                 one launch runs every pyramid level of a track, and for a
//                 bidirectional track the backward climb too;
//   klt_scale  <- track_scale_fp (_gather_scale_banks + _iterate_banks).
// The semantics are defined by the plain PyTorch versions track_level_ref,
// track_pyr_ref, track_pyr_bidir_ref and track_scale_ref in
// ops/klt_kernels.py; this file implements exactly those.
//
// What bounds it on this card: operations, on paper, for the track climb.
// The function needs ~31 fp32 operations per window pixel of a template
// plus ~10 per Scharr lattice point, ~14 per pixel of a Gauss-Newton step
// and ~13 of the final residual, plus the window's separable rows and
// columns (chip_smoke.py OPS counts them from the plain versions); the main
// path's 3-level climb at N = 1024 needs ~0.17 G of them for its data
// (~2.5 us at 67 TFLOP/s), its six images 4.9 MB (1.5 us at 3.35 TB/s);
// the one-level stereo pass and klt_scale are bound by their images' bytes
// (~1.1 us). In practice it is latency: an iteration is a dependent chain
// (sample the window, reduce over the block, solve, move the estimate) of
// ~200 instructions per warp, one feature's chain cannot go faster than
// one warp per scheduler executes it, and N = 1024 features give each SM only
// ~8 blocks to interleave. The first version sampled straight from L2 with
// one warp per feature (~8 warps per SM) and reached a few per cent of the
// bound; PERF.md has the times of both.
//
// What the design does about it:
//   - one block per feature, with kWarps = 4 warps splitting the window's
//     pixels (of 1, 2 and 4 warps per feature, 4 was the fastest at
//     N = 512 and 1024): N = 1024 features fill up to 32 warps of each SM
//     instead of 8 and each warp's chain is shorter; partial sums cross
//     warps through shared memory, in a fixed order, so every thread holds
//     bit-identical sums and all exits are block-uniform;
//   - each level stages the feature's neighbourhood in shared memory with
//     cp.async row copies, both boxes in one batch: the template's source
//     box (the window plus the 4x4 Scharr/bilinear stencil ring), whose
//     Scharr gradients are then computed once per grid point, and a target
//     box of the window plus a 4 px margin around the current estimate.
//     A Gauss-Newton iteration samples shared memory, not L2, without a
//     per-pixel branch where the window lies inside the image. The target
//     box is re-staged only when the estimate walks out of it. Every staged
//     coordinate is clamped into the image (edge replication is exact; TMA
//     would fill zeros), and a read that falls outside the box goes to
//     global memory, so the box never changes a value, only where it is read;
//   - the pyramid climb runs in the kernel: p1 starts at p1_init / 2^(L-1),
//     an unprocessed feature keeps its estimate, the estimate doubles
//     between levels, and liveness and error are decided at level 0 — the
//     glue of ops/klt.py:_pyr_track, exact because the scalings are powers
//     of two. One launch per track instead of one per level.
//
// Build: ops/kernels.py compiles csrc/*.cu in one nvcc call
//        (-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; plain C interface, loaded with ctypes)

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxLevels = 8;  // pyramid levels a launch can climb

// Arguments of one klt_pyr launch, passed by pointer from the host.
struct PyrArgs {
  const float* img0[kMaxLevels];  // level l of the template pyramid
  const float* img1[kMaxLevels];  // level l of the target pyramid
  int H[kMaxLevels];
  int W[kMaxLevels];
  int levels;       // forward climb over levels - 1 .. 0
  int back_levels;  // backward climb (target -> template); 0: none
  const float* p0;
  const float* p1_init;
  const unsigned char* valid;
  int N;
  int radius;
  int iters;         // level-0 Gauss-Newton budget
  int iters_coarse;  // budget above level 0
  float eps;
  float min_eig;
  int epi1d;
  float* p1_out;
  float* err_out;
  unsigned char* live_out;
  unsigned char* proc_out;   // level-0 "processed" of the forward climb, or null
  float* p0b_out;            // backward climb, or null
  unsigned char* live0_out;  // backward climb, or null
};

namespace {

constexpr int kWarps = 4;                    // warps per feature (one block each)
constexpr int kMaxS = 23;                    // window side, radius <= 11
constexpr int kMaxP = kMaxS * kMaxS;         // 529 patch pixels
constexpr int kMargin = 4;                   // target box margin, px per side
constexpr int kMaxBank = (kMaxS + 2) * (kMaxS + 2);  // scale template + 1 px ring
// Box sides: ceil(2e) + 5 + 2 * margin for a half-extent e (see stage()).
constexpr int kTplSide = (kMaxS - 1) + 5;                       // 27: template box (e = r)
constexpr int kLevelSide = (kMaxS - 1) + 5 + 2 * kMargin;        // 35: target box (e = r)
constexpr int kScaleTplSide = 2 * (kMaxS + 1) + 5;               // 53: scale bank (e = 2(r+1))
constexpr int kScaleSide = 2 * (kMaxS - 1) + 5 + 2 * kMargin;    // 57: scale target (e = 2r)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Sums NV values over the block. Every thread gets the same bits: warps
// reduce by xor butterfly, then every thread adds the warps' partials in
// warp order. `red` holds two [kWarps][4] buffers used in turn, so one
// barrier per reduction suffices.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* red, int& par) {
#pragma unroll
  for (int q = 0; q < NV; ++q) v[q] = warp_sum(v[q]);
  const int warp = threadIdx.x >> 5;
  float* r = red + par * (kWarps * 4);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int q = 0; q < NV; ++q) r[warp * 4 + q] = v[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    float t = r[q];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += r[w * 4 + q];
    v[q] = t;
  }
  par ^= 1;
}

__device__ __forceinline__ int floor_i(float x) {
  return (int)floorf(fminf(fmaxf(x, -1.0e7f), 1.0e7f));  // NaN reads as -1e7
}

// Bilinear sample of the edge-replicated image (the TPU kernel's edge-padded
// slabs): the point is clamped into [0, W-1] x [0, H-1], the cell index to
// W-2 / H-2, and the fraction taken from the clamped point.
__device__ __forceinline__ void edge_cell(float u, float v, int H, int W, int& iu, int& iv,
                                          float& du, float& dv) {
  const float uc = fminf(fmaxf(u, 0.0f), (float)(W - 1));
  const float vc = fminf(fmaxf(v, 0.0f), (float)(H - 1));
  iu = min((int)floorf(uc), W - 2);
  iv = min((int)floorf(vc), H - 2);
  du = uc - (float)iu;
  dv = vc - (float)iv;
}

__device__ __forceinline__ bool inside(float u, float v, int H, int W) {
  return u >= 0.0f && v >= 0.0f && u <= (float)(W - 1) && v <= (float)(H - 1);
}

__device__ __forceinline__ bool processable(float u, float v, int H, int W, float m) {
  return u >= -m && v >= -m && u <= (float)(W - 1) + m && v <= (float)(H - 1) + m;
}

// A side x side window of one image in shared memory: s[a][c] holds
// img[min(y0 + a, H-1)][min(x0 + c, W-1)] with x0, y0 >= 0, so for any image
// coordinate (X, Y) with 0 <= X - x0 < side and 0 <= Y - y0 < side the box
// holds exactly img[Y][X]. Reads outside the box go to global memory.
struct Box {
  float* s;
  const float* img;
  int H, W, x0, y0, side;

  __device__ __forceinline__ float at(int X, int Y) const {
    const int c = X - x0, a = Y - y0;
    if ((unsigned)c < (unsigned)side && (unsigned)a < (unsigned)side) return s[a * side + c];
    return __ldg(img + (size_t)Y * W + X);
  }

  __device__ __forceinline__ float bilerp(float u, float v) const {
    int iu, iv;
    float du, dv;
    edge_cell(u, v, H, W, iu, iv, du, dv);
    const int c = iu - x0, a = iv - y0;
    if ((unsigned)c < (unsigned)(side - 1) && (unsigned)a < (unsigned)(side - 1)) {
      const float* r0 = s + a * side + c;
      const float top = r0[0] + du * (r0[1] - r0[0]);
      const float bot = r0[side] + du * (r0[side + 1] - r0[side]);
      return top + dv * (bot - top);
    }
    return bilerp_outside(*this, iu, iv, du, dv);
  }

  // The same for a cell the box does not hold (rare: the box follows the
  // estimate).
  static __device__ __forceinline__ float bilerp_outside(const Box& b, int iu, int iv, float du,
                                                      float dv) {
    const float I00 = b.at(iu, iv), I01 = b.at(iu + 1, iv);
    const float I10 = b.at(iu, iv + 1), I11 = b.at(iu + 1, iv + 1);
    const float top = I00 + du * (I01 - I00);
    const float bot = I10 + du * (I11 - I10);
    return top + dv * (bot - top);
  }

  // Bilinear read of a point in [0, W-1) x [0, H-1) whose cell the box
  // holds: there edge_cell's clamps do nothing, so this is bilerp().
  __device__ __forceinline__ float bilerp_in(float u, float v) const {
    const float fu = floorf(u), fv = floorf(v);
    const float du = u - fu, dv = v - fv;
    const float* r0 = s + ((int)fv - y0) * side + ((int)fu - x0);
    const float top = r0[0] + du * (r0[1] - r0[0]);
    const float bot = r0[side] + du * (r0[side + 1] - r0[side]);
    return top + dv * (bot - top);
  }

  // Every point within e of (cx, cy) lies in [0, W-1) x [0, H-1).
  __device__ __forceinline__ bool interior(float cx, float cy, float e) const {
    return cx - e >= 0.0f && cy - e >= 0.0f && cx + e < (float)(W - 1) && cy + e < (float)(H - 1);
  }

  // Does the box hold every cell that bilinear reads (and the 4x4 stencil)
  // of points within e of (cx, cy) need? One pixel of slack for rounding.
  __device__ __forceinline__ bool covers(float cx, float cy, float e) const {
    const int lx = max(floor_i(cx - e) - 1, 0), hx = min(floor_i(cx + e) + 2, W - 1);
    const int ly = max(floor_i(cy - e) - 1, 0), hy = min(floor_i(cy + e) + 2, H - 1);
    return lx >= x0 && hx < x0 + side && ly >= y0 && hy < y0 + side;
  }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Points a box at the window of half-extent e (+ margin) around (cx, cy),
// kept inside the image where the image is larger than the box, and starts
// filling it: cp.async row copies by the block's warps. land() waits for
// them. Callers put a barrier before it when the box held data that may
// still be read.
__device__ __forceinline__ void start_fill(Box& b, float cx, float cy, float e, int margin,
                                           int max_side) {
  const int side = min((int)ceilf(2.0f * e) + 5 + 2 * margin, max_side);
  b.side = side;
  b.x0 = max(0, min(floor_i(cx - e) - 1 - margin, b.W - side));
  b.y0 = max(0, min(floor_i(cy - e) - 1 - margin, b.H - side));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int a = warp; a < side; a += kWarps) {
    const float* row = b.img + (size_t)min(b.y0 + a, b.H - 1) * b.W;
    float* dst = b.s + a * side;
    for (int c = lane; c < side; c += 32) cp_async4(dst + c, row + min(b.x0 + c, b.W - 1));
  }
}

__device__ __forceinline__ void land() {
  cp_async_wait_all();
  __syncthreads();
}

__device__ __forceinline__ void stage(Box& b, float cx, float cy, float e, int margin,
                                      int max_side) {
  start_fill(b, cx, cy, e, margin, max_side);
  land();
}

// Scharr gradients on the grid points (a, c) in [1, side-2]^2 of a staged
// box, into gx / gy (same indexing as the box): the values level_template()
// computes there, each once instead of once per template pixel that reads it.
__device__ __forceinline__ void box_gradients(const Box& b, float* gx, float* gy) {
  const int side = b.side, n = side - 2;
  const float* s = b.s;
  for (int idx = threadIdx.x; idx < n * n; idx += 32 * kWarps) {
    const int a = 1 + idx / n, c = 1 + idx - (idx / n) * n;
    // Image rows/cols y0 + a +- 1, clamped into the image (the box origin
    // is in the image, so only the far side can clamp).
    const int ym = (a - 1) * side, y = a * side, yp = (min(b.y0 + a + 1, b.H - 1) - b.y0) * side;
    const int xm = c - 1, xp = min(b.x0 + c + 1, b.W - 1) - b.x0;
    const float sxm = s[ym + xm] * 0.1875f + s[y + xm] * 0.625f + s[yp + xm] * 0.1875f;
    const float sxp = s[ym + xp] * 0.1875f + s[y + xp] * 0.625f + s[yp + xp] * 0.1875f;
    gx[y + c] = sxm * -0.5f + sxp * 0.5f;
    const float dm = s[ym + xm] * -0.5f + s[yp + xm] * 0.5f;
    const float d0 = s[ym + c] * -0.5f + s[yp + c] * 0.5f;
    const float dp = s[ym + xp] * -0.5f + s[yp + xp] * 0.5f;
    gy[y + c] = dm * 0.1875f + d0 * 0.625f + dp * 0.1875f;
  }
}

__device__ __forceinline__ float lerp2(const float* g, int i, int side, float du, float dv) {
  const float top = g[i] + du * (g[i + 1] - g[i]);
  const float bot = g[i + side] + du * (g[i + side + 1] - g[i + side]);
  return top + dv * (bot - top);
}

// Template value and Scharr gradients at (u, v) for the plain level: the
// gradient image is taken on the integer grid with edge-replicated reads
// (ops/pyramid.scharr_gradients) and sampled bilinearly like the image.
// level_pass() reads the box's gradient grid instead wherever it holds the
// cell, and comes here only for cells at the box's rim.
__device__ __forceinline__ void level_template(const Box& bx, float u, float v, float& T,
                                               float& gx, float& gy) {
  int iu, iv;
  float du, dv;
  edge_cell(u, v, bx.H, bx.W, iu, iv, du, dv);
  float b[4][4];  // rows iv-1..iv+2, cols iu-1..iu+2, clamped
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int y = min(max(iv - 1 + a, 0), bx.H - 1);
#pragma unroll
    for (int c = 0; c < 4; ++c) b[a][c] = bx.at(min(max(iu - 1 + c, 0), bx.W - 1), y);
  }
  float GX[2][2], GY[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int r = a + 1, k = c + 1;  // grid point (iv + a, iu + c) in b
      const float sxm = b[r - 1][k - 1] * 0.1875f + b[r][k - 1] * 0.625f + b[r + 1][k - 1] * 0.1875f;
      const float sxp = b[r - 1][k + 1] * 0.1875f + b[r][k + 1] * 0.625f + b[r + 1][k + 1] * 0.1875f;
      GX[a][c] = sxm * -0.5f + sxp * 0.5f;
      const float dm = b[r - 1][k - 1] * -0.5f + b[r + 1][k - 1] * 0.5f;
      const float d0 = b[r - 1][k] * -0.5f + b[r + 1][k] * 0.5f;
      const float dp = b[r - 1][k + 1] * -0.5f + b[r + 1][k + 1] * 0.5f;
      GY[a][c] = dm * 0.1875f + d0 * 0.625f + dp * 0.1875f;
    }
  }
  {
    const float top = b[1][1] + du * (b[1][2] - b[1][1]);
    const float bot = b[2][1] + du * (b[2][2] - b[2][1]);
    T = top + dv * (bot - top);
  }
  {
    const float top = GX[0][0] + du * (GX[0][1] - GX[0][0]);
    const float bot = GX[1][0] + du * (GX[1][1] - GX[1][0]);
    gx = top + dv * (bot - top);
  }
  {
    const float top = GY[0][0] + du * (GY[0][1] - GY[0][0]);
    const float bot = GY[1][0] + du * (GY[1][1] - GY[1][0]);
    gy = top + dv * (bot - top);
  }
}

// The template of one feature at one level, spread over the block: pixel
// idx = threadIdx.x + 32 * kWarps * k of the (2r+1)^2 window lives in slot k
// of its thread's registers. A slot past the window holds offset 0, zero
// template and gradients, and a clear mask bit, so the sampling loops run
// every slot without a branch (the slots' latencies overlap) and such a
// slot adds exactly 0.
struct Patch {
  static constexpr int kPer = (kMaxP + 32 * kWarps - 1) / (32 * kWarps);
  float T[kPer], GX[kPer], GY[kPer], OU[kPer], OV[kPer];
  unsigned m0;  // bit k: template pixel of slot k inside img0
  float gxx, gxy, gyy, npix;
};

// Masked IC Gauss-Newton from (px, py), target sampled at p + s * offset
// (s = 1 for the plain level). Returns in place. `tb` is the target box,
// already staged around (px, py) with half-extent e.
template <bool EPI1D>
__device__ __forceinline__ void gn_loop(const Patch& pt, Box& tb, float e, int max_side, float s,
                                        int iters, float eps2, float& px, float& py, float* red,
                                        int& par) {
  float inv_gxx = 0.0f, inv_det = 0.0f;
  if (EPI1D) {
    inv_gxx = 1.0f / (pt.gxx < 1e-12f ? 1e-12f : pt.gxx);
  } else {
    const float det = pt.gxx * pt.gyy - pt.gxy * pt.gxy;
    inv_det = 1.0f / (fabsf(det) < 1e-12f ? 1e-12f : det);
  }
  for (int it = 0; it < iters; ++it) {
    if (!tb.covers(px, py, e)) {  // block-uniform
      __syncthreads();
      stage(tb, px, py, e, kMargin, max_side);
    }
    float acc[2] = {0.0f, 0.0f};
    if (tb.interior(px, py, e)) {  // block-uniform: no clamp, every target pixel inside
#pragma unroll
      for (int k = 0; k < Patch::kPer; ++k) {
        const float I = tb.bilerp_in(px + s * pt.OU[k], py + s * pt.OV[k]);
        const float r = (pt.T[k] - I) * (((pt.m0 >> k) & 1u) ? 1.0f : 0.0f);
        acc[0] += pt.GX[k] * r;
        acc[1] += pt.GY[k] * r;
      }
    } else {
#pragma unroll
      for (int k = 0; k < Patch::kPer; ++k) {
        const float u = px + s * pt.OU[k], v = py + s * pt.OV[k];
        const float I = tb.bilerp(u, v);
        const float w = (((pt.m0 >> k) & 1u) && inside(u, v, tb.H, tb.W)) ? 1.0f : 0.0f;
        const float r = (pt.T[k] - I) * w;
        acc[0] += pt.GX[k] * r;
        acc[1] += pt.GY[k] * r;
      }
    }
    block_sum<2>(acc, red, par);
    float du, dv;
    if (EPI1D) {
      du = acc[0] * inv_gxx;
      dv = 0.0f;
    } else {
      du = (pt.gyy * acc[0] - pt.gxy * acc[1]) * inv_det;
      dv = (pt.gxx * acc[1] - pt.gxy * acc[0]) * inv_det;
    }
    px += s * du;
    py += s * dv;
    if (du * du + dv * dv < eps2) break;  // block-uniform
  }
}

// Mean absolute residual at (px, py) over pixels valid in both images.
__device__ __forceinline__ float final_err(const Patch& pt, Box& tb, float e, int max_side,
                                           float s, float px, float py, float* red, int& par) {
  if (!tb.covers(px, py, e)) {
    __syncthreads();
    stage(tb, px, py, e, kMargin, max_side);
  }
  float acc[2] = {0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < Patch::kPer; ++k) {
    const float u = px + s * pt.OU[k], v = py + s * pt.OV[k];
    const float I = tb.bilerp(u, v);
    const float w = (((pt.m0 >> k) & 1u) && inside(u, v, tb.H, tb.W)) ? 1.0f : 0.0f;
    acc[0] += fabsf(pt.T[k] - I) * w;
    acc[1] += w;
  }
  block_sum<2>(acc, red, par);
  return acc[0] / fmaxf(acc[1], 1.0f);
}

// Template Hessian, valid-pixel count and the gates.
template <bool EPI1D>
__device__ __forceinline__ bool hessian_gates(Patch& pt, int S, float min_eig, float* red,
                                              int& par) {
  float h[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < Patch::kPer; ++k) {
    const float w = ((pt.m0 >> k) & 1u) ? 1.0f : 0.0f;
    h[0] += pt.GX[k] * pt.GX[k] * w;
    h[1] += pt.GX[k] * pt.GY[k] * w;
    h[2] += pt.GY[k] * pt.GY[k] * w;
    h[3] += w;
  }
  block_sum<4>(h, red, par);
  pt.gxx = h[0];
  pt.gxy = h[1];
  pt.gyy = h[2];
  pt.npix = fmaxf(h[3], 1.0f);
  bool eig_ok;
  if (EPI1D) {
    eig_ok = pt.gxx / pt.npix > min_eig;
  } else {
    const float tr = pt.gxx + pt.gyy;
    const float d = pt.gxx - pt.gyy;
    const float dd = sqrtf(fmaxf(d * d + 4.0f * pt.gxy * pt.gxy, 0.0f));
    eig_ok = 0.5f * (tr - dd) / pt.npix > min_eig;
  }
  return eig_ok && pt.npix > 0.5f * (float)(S * S);
}

// Shared memory of one klt_pyr block.
struct Smem {
  float tpl[kTplSide * kTplSide];    // template source box
  float gx[kTplSide * kTplSide];     // its Scharr gradients
  float gy[kTplSide * kTplSide];
  float tgt[kLevelSide * kLevelSide];  // target box
  float red[2 * kWarps * 4];              // block_sum partials
};

// One pyramid level of one feature (track_level_ref): template at (tx, ty)
// in img0, estimate (px, py) in img1 updated in place when processed.
template <bool EPI1D>
__device__ __forceinline__ void level_pass(const float* img0, const float* img1, int H, int W,
                                           float tx, float ty, float& px, float& py, bool valid,
                                           int radius, int iters, float eps2, float min_eig,
                                           bool want_err, Smem& sm, int& par, bool& proc, bool& ok,
                                           float& err) {
  const int S = 2 * radius + 1, P = S * S;
  const float e = (float)radius;
  proc = valid && processable(tx, ty, H, W, e) && processable(px, py, H, W, e);
  ok = false;
  err = 0.0f;
  if (!proc) return;

  __syncthreads();  // the boxes may still be read by the previous pass
  Box b{sm.tpl, img0, H, W, 0, 0, 0};
  Box t{sm.tgt, img1, H, W, 0, 0, 0};
  start_fill(b, tx, ty, e, 0, kTplSide);  // template source box
  start_fill(t, px, py, e, kMargin, kLevelSide);  // target box
  land();
  box_gradients(b, sm.gx, sm.gy);
  __syncthreads();
  Patch pt;
  pt.m0 = 0u;
  const int TB = b.side;
#pragma unroll
  for (int k = 0; k < Patch::kPer; ++k) {
    const int idx = threadIdx.x + 32 * kWarps * k;
    pt.T[k] = pt.GX[k] = pt.GY[k] = pt.OU[k] = pt.OV[k] = 0.0f;
    if (idx < P) {
      const int i = idx / S, j = idx - (idx / S) * S;
      pt.OU[k] = (float)(j - radius);
      pt.OV[k] = (float)(i - radius);
      const float u = tx + pt.OU[k], v = ty + pt.OV[k];
      int iu, iv;
      float du, dv;
      edge_cell(u, v, H, W, iu, iv, du, dv);
      const int c = iu - b.x0, a = iv - b.y0;
      if (c >= 1 && c <= TB - 3 && a >= 1 && a <= TB - 3) {  // cell on the gradient grid
        const int g = a * TB + c;
        pt.T[k] = lerp2(b.s, g, TB, du, dv);
        pt.GX[k] = lerp2(sm.gx, g, TB, du, dv);
        pt.GY[k] = lerp2(sm.gy, g, TB, du, dv);
      } else {
        level_template(b, u, v, pt.T[k], pt.GX[k], pt.GY[k]);
      }
      if (inside(u, v, H, W)) pt.m0 |= 1u << k;
    }
  }
  const bool act = hessian_gates<EPI1D>(pt, S, min_eig, sm.red, par);
  if (act) gn_loop<EPI1D>(pt, t, e, kLevelSide, 1.0f, iters, eps2, px, py, sm.red, par);
  if (want_err) err = final_err(pt, t, e, kLevelSide, 1.0f, px, py, sm.red, par);
  ok = act && inside(px, py, H, W);
}

// The coarse-to-fine climb of ops/klt.py:_pyr_track for one feature.
template <bool EPI1D>
__device__ __forceinline__ void climb(const float* const* A, const float* const* B, const int* Hs,
                                      const int* Ws, int L, float tx, float ty, float sx, float sy,
                                      bool valid, int radius, int iters, int iters_coarse,
                                      float eps2, float min_eig, bool want_err, float& px,
                                      float& py, bool& live, float& err, bool& proc0, Smem& sm,
                                      int& par) {
  const float top = 1.0f / (float)(1 << (L - 1));  // exact powers of two
  px = sx * top;
  py = sy * top;
  live = false;
  err = 0.0f;
  proc0 = false;
  for (int lvl = L - 1; lvl >= 0; --lvl) {
    const float inv = 1.0f / (float)(1 << lvl);
    float qx = px, qy = py, e;
    bool proc, ok;
    level_pass<EPI1D>(A[lvl], B[lvl], Hs[lvl], Ws[lvl], tx * inv, ty * inv, qx, qy, valid,
                           radius, lvl == 0 ? iters : iters_coarse, eps2, min_eig,
                           want_err && lvl == 0, sm, par, proc, ok, e);
    if (proc) {
      px = qx;
      py = qy;
    }
    if (lvl == 0) {
      live = valid && proc && ok;
      err = e;
      proc0 = proc;
    } else {
      px *= 2.0f;
      py *= 2.0f;
    }
  }
}

template <bool EPI1D>
__global__ void __launch_bounds__(32 * kWarps, 8) klt_pyr_kernel(const PyrArgs a) {
  __shared__ Smem sm;
  const int f = blockIdx.x;
  int par = 0;
  const float eps2 = a.eps * a.eps;
  const float p0x = a.p0[2 * f], p0y = a.p0[2 * f + 1];
  const bool valid = a.valid[f] != 0;
  float px, py, err;
  bool live, proc;
  climb<EPI1D>(a.img0, a.img1, a.H, a.W, a.levels, p0x, p0y, a.p1_init[2 * f],
                    a.p1_init[2 * f + 1], valid, a.radius, a.iters, a.iters_coarse, eps2,
                    a.min_eig, true, px, py, live, err, proc, sm, par);
  if (threadIdx.x == 0) {
    a.p1_out[2 * f] = px;
    a.p1_out[2 * f + 1] = py;
    a.err_out[f] = err;
    a.live_out[f] = (unsigned char)live;
    if (a.proc_out != nullptr) a.proc_out[f] = (unsigned char)proc;
  }
  if (a.back_levels > 0) {
    float bx, by, berr;
    bool live0, bproc;
    climb<EPI1D>(a.img1, a.img0, a.H, a.W, a.back_levels, px, py, p0x, p0y, live, a.radius,
                      a.iters, a.iters_coarse, eps2, a.min_eig, false, bx, by, live0, berr, bproc,
                      sm, par);
    if (threadIdx.x == 0) {
      a.p0b_out[2 * f] = bx;
      a.p0b_out[2 * f + 1] = by;
      a.live0_out[f] = (unsigned char)live0;
    }
  }
}

// Scale-compensated refinement (track_scale_ref): template resampled at
// p0 + s*(offset) and Scharr on that resampled grid (bank units); GN in
// bank units, target sampled at p1 + s*(offset).
__global__ void __launch_bounds__(32 * kWarps, 8)
klt_scale_kernel(const float* __restrict__ img0, const float* __restrict__ img1, int H, int W,
                 const float* __restrict__ p0, const float* __restrict__ p1_init,
                 const float* __restrict__ scale, const unsigned char* __restrict__ valid, int N,
                 int radius, int iters, float eps2, float* __restrict__ p1_out,
                 float* __restrict__ err_out, unsigned char* __restrict__ ok_out) {
  __shared__ float src[kScaleTplSide * kScaleTplSide];
  __shared__ float box[kScaleSide * kScaleSide];
  __shared__ float bank[kMaxBank];
  __shared__ float red[2 * kWarps * 4];
  const int f = blockIdx.x;
  int par = 0;
  const int S = 2 * radius + 1, P = S * S, SB = S + 2;
  const float p0x = p0[2 * f], p0y = p0[2 * f + 1];
  float px = p1_init[2 * f], py = p1_init[2 * f + 1];
  const float s = fminf(fmaxf(scale[f], 0.5f), 2.0f);
  const float e = s * (float)radius;
  const bool proc = valid[f] != 0 && processable(p0x, p0y, H, W, e) &&
                    processable(px, py, H, W, e);
  bool ok = false;
  float err = 0.0f;
  if (proc) {
    // Template bank on the (S+2)^2 grid (1-px ring for the stencil),
    // resampled from the edge-replicated image through the staged box.
    Box b{src, img0, H, W, 0, 0, 0};
    Box t{box, img1, H, W, 0, 0, 0};
    start_fill(b, p0x, p0y, s * (float)(radius + 1), 0, kScaleTplSide);
    start_fill(t, px, py, e, kMargin, kScaleSide);
    land();
    for (int idx = threadIdx.x; idx < SB * SB; idx += 32 * kWarps) {
      const int i = idx / SB, j = idx - (idx / SB) * SB;
      bank[idx] = b.bilerp(p0x + s * (float)(j - radius - 1), p0y + s * (float)(i - radius - 1));
    }
    __syncthreads();
    Patch pt;
    pt.m0 = 0u;
#pragma unroll
    for (int k = 0; k < Patch::kPer; ++k) {
      const int idx = threadIdx.x + 32 * kWarps * k;
      pt.T[k] = pt.GX[k] = pt.GY[k] = pt.OU[k] = pt.OV[k] = 0.0f;
      if (idx < P) {
        const int i = idx / S, j = idx - (idx / S) * S;
        const float* c = bank + (i + 1) * SB + (j + 1);
        pt.T[k] = c[0];
        const float sxm = (3.0f * (c[-SB - 1] + c[SB - 1]) + 10.0f * c[-1]) / 16.0f;
        const float sxp = (3.0f * (c[-SB + 1] + c[SB + 1]) + 10.0f * c[1]) / 16.0f;
        pt.GX[k] = (sxp - sxm) * 0.5f;
        const float sym = (3.0f * (c[-SB - 1] + c[-SB + 1]) + 10.0f * c[-SB]) / 16.0f;
        const float syp = (3.0f * (c[SB - 1] + c[SB + 1]) + 10.0f * c[SB]) / 16.0f;
        pt.GY[k] = (syp - sym) * 0.5f;
        pt.OU[k] = (float)(j - radius);
        pt.OV[k] = (float)(i - radius);
        if (inside(p0x + s * pt.OU[k], p0y + s * pt.OV[k], H, W)) pt.m0 |= 1u << k;
      }
    }
    const bool act = hessian_gates<false>(pt, S, 0.0f, red, par);
    if (act) gn_loop<false>(pt, t, e, kScaleSide, s, iters, eps2, px, py, red, par);
    err = final_err(pt, t, e, kScaleSide, s, px, py, red, par);
    ok = act && inside(px, py, H, W);
  }
  if (threadIdx.x == 0) {
    p1_out[2 * f] = px;
    p1_out[2 * f + 1] = py;
    err_out[f] = err;
    ok_out[f] = (unsigned char)ok;
  }
}

}  // namespace

extern "C" {

int klt_pyr_launch(const PyrArgs* a, void* stream) {
  if (a->radius < 1 || 2 * a->radius + 1 > kMaxS) return (int)cudaErrorInvalidValue;
  if (a->levels < 1 || a->levels > kMaxLevels || a->back_levels < 0 ||
      a->back_levels > a->levels || a->N < 1)
    return (int)cudaErrorInvalidValue;
  if (a->back_levels > 0 && (a->p0b_out == nullptr || a->live0_out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (a->epi1d)
    klt_pyr_kernel<true><<<a->N, 32 * kWarps, 0, st>>>(*a);
  else
    klt_pyr_kernel<false><<<a->N, 32 * kWarps, 0, st>>>(*a);
  return (int)cudaGetLastError();
}

int klt_scale_launch(const float* img0, const float* img1, int H, int W, const float* p0,
                     const float* p1_init, const float* scale, const unsigned char* valid,
                     int N, int radius, int iters, float eps, float* p1_out, float* err_out,
                     unsigned char* ok_out, void* stream) {
  if (radius < 1 || 2 * radius + 1 > kMaxS || N < 1) return (int)cudaErrorInvalidValue;
  klt_scale_kernel<<<N, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      img0, img1, H, W, p0, p1_init, scale, valid, N, radius, iters, eps * eps, p1_out, err_out,
      ok_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
