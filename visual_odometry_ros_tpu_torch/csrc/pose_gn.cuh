// The pose solve of csrc/pose_gn.cu, written once for two compilers.
//
// nvcc compiles it into the `pose_gn` kernel (one block per solve, threads
// striding over the points). g++ compiles it into a one-thread host version
// (csrc/pose_gn_host.cpp) that the CPU tests run against the plain PyTorch
// version, so that a formula or branch error shows without a card. Both run
// the same code below; they differ only in `Blk`, which supplies the
// thread's index, the thread count and the block-wide sums (returned to
// every thread; the only barrier of an iteration is inside the sum).
//
// Semantics: the plain versions in ops/pose_gn.py (`_pose_gn_core`,
// `pose_only_gn_mono_ref`, `pose_only_gn_stereo_ref`, `_reproj_err_px` and
// the two robust wrappers), formula for formula, with the SE(3) exponential
// of utils/geometry.py (`so3_exp`, `so3_left_jacobian`, `se3_exp`,
// `add_front_se3`): the theta2 < 1e-12 series branches and its _EPS terms.

#pragma once

#include <math.h>

#ifdef __CUDACC__
#define PG_HD __host__ __device__ __forceinline__
#else
#define PG_HD inline
#endif

namespace pose_gn {

// `PoseGNArgs` of ops/pose_gn.py, field for field.
struct Args {
  const float* X0;      // [N, 3] points in the previous (left) camera frame
  const float* pts_l;   // [N, 2] left observations (px)
  const float* pts_r;   // [N, 2] right observations; null for mono
  const bool* valid_l;  // [N]
  const bool* valid_r;  // [N]; null for mono
  const float* T_rl;    // [4, 4] left -> right camera; null for mono
  const float* T_init;  // [4, 4]
  int N;
  int stereo;  // 4 residual rows per point (left u, v, right u, v), else 2
  int passes;  // 1: one solve (pose_only_gn_*); 2: the robust two-pass solve
  float fx, fy, cx, cy;
  int max_iters;
  float huber_delta, lam, step_tol, cost_tol, reproj_thresh, min_inlier_ratio;
  int min_inliers;
  float gate_thresh;  // gate_scale * reproj_thresh (two passes)
  float* T_out;       // [4, 4]
  bool* inliers;      // [N]; holds pass 2's gate mask until the end
  float* err;         // [N] left reprojection error under the chosen pose; null for one pass
  float* mean_err;    // [1]
  bool* ok;           // [1]
  int* n_iter;        // [1]
};

// A GN loop's state. Every thread holds it and takes every step itself, on
// the same block sums, so every thread holds the same state bit for bit.
struct State {
  float T[16];  // the solve's current pose
  float prev_cost;
  int it;
  bool done;
};

constexpr float kEps2 = (float)(1e-7 * 1e-7);         // _EPS * _EPS
constexpr float kEps3 = (float)(1e-7 * 1e-7 * 1e-7);  // _EPS ** 3
constexpr int kSums = 28;                              // cost, 21 of H's upper triangle, 6 of g
constexpr int kCount = kSums;                          // then the weighted points, in the same sum
constexpr int kMaxSolves = 8;                          // solves a launch takes, one block each

struct Pass {  // what one solve returns
  float T[16];
  float mean_err;
  bool ok;
  int it;
  float count;    // the weighted points
  float extra;    // robust: the valid points within reproj_thresh under T_prior (pass 1) or T (pass 2)
  float carried;  // the sum of the threads' `carried` counts
};

PG_HD void copy16(const float* a, float* b) {
  for (int i = 0; i < 16; ++i) b[i] = a[i];
}

// out = c ? x : y, entry by entry (register arrays stay in registers).
PG_HD void select16(bool c, const float* x, const float* y, float* out) {
  for (int i = 0; i < 16; ++i) out[i] = c ? x[i] : y[i];
}

PG_HD bool all_finite16(const float* T) {
  bool f = true;
  for (int i = 0; i < 16; ++i) f = f && isfinite(T[i]);
  return f;
}

// geo.transform_points: X R^T + t.
PG_HD void transform(const float* T, const float* X, float* Y) {
  for (int i = 0; i < 3; ++i) Y[i] = X[0] * T[4 * i] + X[1] * T[4 * i + 1] + X[2] * T[4 * i + 2] + T[4 * i + 3];
}

PG_HD float inv_depth(float z) { return 1.0f / (fabsf(z) < 1e-6f ? 1e-6f : z); }

// Pixel residual of Xc against pts, and d(pixel)/d(Xc) [2][3].
PG_HD void project(const Args& a, const float* Xc, const float* pts, float* r, float P[2][3]) {
  float iz = inv_depth(Xc[2]);
  float iz2 = iz * iz;
  r[0] = Xc[0] * iz * a.fx + a.cx - pts[0];
  r[1] = Xc[1] * iz * a.fy + a.cy - pts[1];
  P[0][0] = a.fx * iz;
  P[0][1] = 0.0f;
  P[0][2] = -a.fx * Xc[0] * iz2;
  P[1][0] = 0.0f;
  P[1][1] = a.fy * iz;
  P[1][2] = -a.fy * Xc[1] * iz2;
}

// Rows of A [2][3] times d(Xc)/d(xi) = [I | -[X]x] at X, into J[0..1][6].
PG_HD void chain(const float A[2][3], const float* X, float J[][6]) {
  // -[X]x = [[0, z, -y], [-z, 0, x], [y, -x, 0]]
  const float S[3][3] = {{0.0f, X[2], -X[1]}, {-X[2], 0.0f, X[0]}, {X[1], -X[0], 0.0f}};
  for (int r = 0; r < 2; ++r) {
    for (int c = 0; c < 3; ++c) J[r][c] = A[r][c];
    for (int c = 0; c < 3; ++c) J[r][3 + c] = A[r][0] * S[0][c] + A[r][1] * S[1][c] + A[r][2] * S[2][c];
  }
}

// residual_fn of pose_only_gn_{mono,stereo} for point i under T: the R rows
// (2 mono, 4 stereo) and their Jacobians, zeroed where masked. wl / wr: the
// solve's left and right masks of the point (stereo only; mono masks by
// depth alone).
template <int R>
PG_HD void rows(const Args& a, const float* T, int i, bool wl, bool wr, float* r, float J[R][6]) {
  float Xl[3];
  transform(T, a.X0 + 3 * i, Xl);
  float P[2][3];
  project(a, Xl, a.pts_l + 2 * i, r, P);
  chain(P, Xl, J);
  if constexpr (R == 2) {
    if (!(Xl[2] > 0.01f)) {  // behind the camera: contributes nothing
      for (int k = 0; k < 2; ++k) {
        r[k] = 0.0f;
        for (int c = 0; c < 6; ++c) J[k][c] = 0.0f;
      }
    }
  } else {
    float Xr[3];
    transform(a.T_rl, Xl, Xr);
    float Pr[2][3], A[2][3];
    project(a, Xr, a.pts_r + 2 * i, r + 2, Pr);
    for (int k = 0; k < 2; ++k)  // d(pix_r)/dXr * R_rl
      for (int c = 0; c < 3; ++c) A[k][c] = Pr[k][0] * a.T_rl[c] + Pr[k][1] * a.T_rl[4 + c] + Pr[k][2] * a.T_rl[8 + c];
    chain(A, Xl, J + 2);
    bool front = (Xl[2] > 0.01f) && (Xr[2] > 0.01f);
    for (int k = 0; k < R; ++k) {
      if (!(front && (k < 2 ? wl : wr))) {
        r[k] = 0.0f;
        for (int c = 0; c < 6; ++c) J[k][c] = 0.0f;
      }
    }
  }
}

// _reproj_err_px: left-view reprojection error of point i under T (px);
// behind the camera, 1e6.
PG_HD float reproj_err(const Args& a, const float* T, int i) {
  float Xc[3];
  transform(T, a.X0 + 3 * i, Xc);
  float iz = inv_depth(Xc[2]);
  float du = Xc[0] * iz * a.fx + a.cx - a.pts_l[2 * i];
  float dv = Xc[1] * iz * a.fy + a.cy - a.pts_l[2 * i + 1];
  float e = sqrtf(du * du + dv * dv);
  return Xc[2] > 0.01f ? e : 1e6f;
}

// The solve's masks of point i: pass 1 uses (valid_l, valid_r); pass 2 the
// gate mask `keep` (kept in a.inliers) and valid_r & keep.
PG_HD void masks(const Args& a, int i, bool second, bool& wl, bool& wr) {
  wl = second ? a.inliers[i] : a.valid_l[i];
  wr = a.stereo ? (a.valid_r[i] && (!second || a.inliers[i])) : false;
}

// _solve6: Cholesky of the damped H (LAPACK's potf2 order; a pivot that is
// not > 0, NaN included, fails as cholesky_ex's info != 0 does, and the step
// is then NaN), then both triangular solves.
PG_HD void solve6(const float H[6][6], const float* g, float* x) {
  float L[6][6];
  for (int j = 0; j < 6; ++j) {
    float s = H[j][j];
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    if (!(s > 0.0f)) {
      for (int k = 0; k < 6; ++k) x[k] = NAN;
      return;
    }
    L[j][j] = sqrtf(s);
    for (int i = j + 1; i < 6; ++i) {
      float t = H[i][j];
      for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k];
      L[i][j] = t / L[j][j];
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float t = g[i];
    for (int k = 0; k < i; ++k) t -= L[i][k] * y[k];
    y[i] = t / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float t = y[i];
    for (int k = i + 1; k < 6; ++k) t -= L[k][i] * x[k];
    x[i] = t / L[i][i];
  }
}

// add_front_se3: T <- se3_exp(xi) @ T.
PG_HD void add_front_se3(const float* xi, float* T) {
  const float* v = xi;
  const float* w = xi + 3;
  float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  float theta = sqrtf(theta2 + kEps2);
  bool small = theta2 < 1e-12f;
  float s = sinf(theta), c = cosf(theta);
  float A = small ? 1.0f - theta2 / 6.0f : s / theta;
  float B = small ? 0.5f - theta2 / 24.0f : (1.0f - c) / (theta2 + kEps2);
  float C = small ? (float)(1.0 / 6.0) - theta2 / 120.0f : (theta - s) / (theta2 * theta + kEps3);
  const float W[3][3] = {{0.0f, -w[2], w[1]}, {w[2], 0.0f, -w[0]}, {-w[1], w[0], 0.0f}};
  float E[16];
  for (int i = 0; i < 3; ++i) {
    float t = 0.0f;
    for (int j = 0; j < 3; ++j) {
      float WW = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      float I = i == j ? 1.0f : 0.0f;
      E[4 * i + j] = I + A * W[i][j] + B * WW;  // so3_exp
      t += (I + B * W[i][j] + C * WW) * v[j];   // so3_left_jacobian @ v
    }
    E[4 * i + 3] = t;
  }
  E[12] = E[13] = E[14] = 0.0f;
  E[15] = 1.0f;
  float out[16];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] = E[4 * i] * T[j] + E[4 * i + 1] * T[4 + j] + E[4 * i + 2] * T[8 + j] + E[4 * i + 3] * T[12 + j];
  copy16(out, T);
}

// One iteration's step from the block sums `s` (cost, H's upper triangle
// row by row, g, the weighted points): damping, solve, update, stop test.
// Every thread takes it on the same sums, so every thread holds the same
// state bit for bit and nothing is published.
PG_HD void step(const Args& a, const float* s, State& st) {
  float cost = s[0] / fmaxf(s[kCount], 1.0f);
  float H[6][6], g[6], dxi[6];
  int k = 1;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) H[i][j] = H[j][i] = s[k++];
  for (int i = 0; i < 6; ++i) {
    g[i] = -s[22 + i];
    H[i][i] = (H[i][i] + a.lam * H[i][i]) + 1e-9f;
  }
  solve6(H, g, dxi);
  bool bad = false;
  float n2 = 0.0f;
  for (int i = 0; i < 6; ++i) {
    bad = bad || !isfinite(dxi[i]);
    n2 += dxi[i] * dxi[i];
  }
  if (!bad) add_front_se3(dxi, st.T);
  bool converged = (sqrtf(n2) < a.step_tol) || (fabsf(st.prev_cost - cost) < a.cost_tol * (cost + 1e-9f));
  st.prev_cost = cost;
  st.it += 1;
  st.done = converged || bad;
}

// _pose_gn_core from T_start over the pass's masks: the damped GN loop
// `while it < max_iters and not done` (one walk and one sum an iteration;
// the sum also counts the weighted points, what the cost divides by), then
// one walk for the inlier test, mean error and ok of the result, which
// also counts the weighted points and, in a robust launch, `extra`: the
// valid points within reproj_thresh under T_prior (pass 1) or under the
// pass's own pose (pass 2), and adds each thread's `carried` count into the
// same sum. Writes the inlier mask when the launch is one pass.
template <int R, class Blk>
PG_HD Pass solve(const Args& a, Blk& b, const float* T_start, const float* T_prior, bool second, float carried) {
  State st;
  copy16(T_start, st.T);
  st.prev_cost = INFINITY;
  st.it = 0;
  st.done = false;
  while (st.it < a.max_iters && !st.done) {
    float acc[kSums + 1];
    for (int k = 0; k <= kSums; ++k) acc[k] = 0.0f;
    for (int i = b.tid; i < a.N; i += b.nthr) {
      bool wl, wr;
      masks(a, i, second, wl, wr);
      float r[R], J[R][6];
      rows<R>(a, st.T, i, wl, wr, r, J);
      float r2 = 0.0f;
      for (int k = 0; k < R; ++k) r2 += r[k] * r[k];
      float rn = sqrtf(r2 + 1e-12f);
      float hw = rn <= a.huber_delta ? 1.0f : a.huber_delta / (rn < 1e-12f ? 1e-12f : rn);
      float w = hw * (wl ? 1.0f : 0.0f);
      acc[0] += w * rn * rn;
      for (int k = 0; k < R; ++k) {
        int m = 1;
        for (int p = 0; p < 6; ++p) {
          float jw = J[k][p] * w;
          for (int q = p; q < 6; ++q) acc[m++] += jw * J[k][q];
          acc[22 + p] += jw * r[k];
        }
      }
      acc[kCount] += wl ? 1.0f : 0.0f;
    }
    b.sum(acc);
    step(a, acc, st);
  }
  Pass out;
  copy16(st.T, out.T);
  out.it = st.it;
  float Tx[16];
  select16(second, out.T, T_prior, Tx);
  float ev[5] = {0.0f, 0.0f, 0.0f, 0.0f, carried};  // error over the weighted points, inliers, weighted, extra, carried
  for (int i = b.tid; i < a.N; i += b.nthr) {
    bool wl, wr;
    masks(a, i, second, wl, wr);
    float r[R], J[R][6];
    rows<R>(a, out.T, i, wl, wr, r, J);
    float r2 = 0.0f;
    for (int k = 0; k < R; ++k) r2 += r[k] * r[k];
    float e = sqrtf(r2 / (float)(R / 2));
    bool inl = wl && e < a.reproj_thresh;
    ev[0] += wl ? e : 0.0f;  // as the plain version: a non-finite error of an unweighted point adds nothing
    ev[1] += inl ? 1.0f : 0.0f;
    ev[2] += wl ? 1.0f : 0.0f;
    if (a.passes == 1)
      a.inliers[i] = inl;
    else
      ev[3] += (a.valid_l[i] && reproj_err(a, Tx, i) < a.reproj_thresh) ? 1.0f : 0.0f;
  }
  b.sum(ev);
  const float n_valid = fmaxf(ev[2], 1.0f);
  out.mean_err = ev[0] / n_valid;
  out.ok = all_finite16(out.T) && (ev[1] / n_valid >= a.min_inlier_ratio) && (ev[1] >= (float)a.min_inliers) &&
           isfinite(out.mean_err);
  out.count = ev[2];
  out.extra = ev[3];
  out.carried = ev[4];
  return out;
}

// The whole solve: one pass, or the robust two-pass solve of
// pose_only_gn_{stereo,mono}_robust (pass 1, the hard gate under the better
// of {pass-1 pose, prior}, pass 2 on the survivors, arbitration on inlier
// counts over the common point set and against the prior). Outside the
// iterations a robust solve walks the points four times (the two passes'
// evaluations, the gate, the final errors) and takes three block sums: the
// gate's count rides in pass 2's evaluation sum, and the valid points and
// the prior's inliers in pass 1's.
template <int R, class Blk>
PG_HD void run_rows(const Args& a, Blk& b) {
  float T0[16];
  copy16(a.T_init, T0);
  Pass p1 = solve<R>(a, b, T0, T0, false, 0.0f);
  if (a.passes == 1) {
    if (b.tid == 0) {
      copy16(p1.T, a.T_out);
      *a.mean_err = p1.mean_err;
      *a.ok = p1.ok;
      *a.n_iter = p1.it;
    }
    return;
  }
  float T1[16];
  select16(p1.ok, p1.T, T0, T1);
  float n1 = 0.0f;  // valid points within reproj_thresh under T1 (this thread's; summed by pass 2)
  for (int i = b.tid; i < a.N; i += b.nthr) {
    float e = reproj_err(a, T1, i);
    a.inliers[i] = a.valid_l[i] && e < a.gate_thresh;  // keep
    n1 += (a.valid_l[i] && e < a.reproj_thresh) ? 1.0f : 0.0f;
  }
  Pass p2 = solve<R>(a, b, T1, T1, true, n1);
  bool use2 = p2.ok && (!p1.ok || p2.extra >= p2.carried);
  float T[16];
  select16(p1.ok, p1.T, T0, T);
  select16(use2, p2.T, T, T);
  float n_fin[1] = {0.0f};
  for (int i = b.tid; i < a.N; i += b.nthr) {
    float e = reproj_err(a, T, i);
    bool inl = a.valid_l[i] && e < a.reproj_thresh;
    a.err[i] = e;
    a.inliers[i] = inl;
    n_fin[0] += inl ? 1.0f : 0.0f;
  }
  b.sum(n_fin);
  if (b.tid == 0) {
    const float n = n_fin[0], n_all = fmaxf(p1.count, 1.0f);
    copy16(T, a.T_out);
    *a.mean_err = use2 ? p2.mean_err : p1.mean_err;
    *a.ok = (p1.ok || p2.ok) && n >= (float)a.min_inliers && (n / n_all >= a.min_inlier_ratio) &&
            (n + 2.0f >= p1.extra);
    *a.n_iter = p1.it + p2.it;
  }
}

template <class Blk>
PG_HD void run(const Args& a, Blk& b) {
  if (a.stereo)
    run_rows<4>(a, b);
  else
    run_rows<2>(a, b);
}

}  // namespace pose_gn
