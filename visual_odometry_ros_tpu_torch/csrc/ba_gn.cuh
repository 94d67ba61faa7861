// The window-BA Gauss-Newton solve of csrc/ba_gn.cu, written once for two
// compilers.
//
// nvcc compiles it into the four `ba_*` kernels; g++ compiles it into a
// one-thread host version (csrc/ba_gn_host.cpp) that exports the same four
// launchers, so that the CPU tests run the kernels' launch sequence, formula
// for formula, against the plain PyTorch version. Both run the code below;
// they differ only in `Blk` (the thread's and the block's index, the counts,
// a barrier). The host runs a launch's blocks one after the other, each with
// one thread; every sum is taken in the same order on both.
//
// Semantics: ops/ba.py's plain version (`ba_solve_ref`: build_observation_
// terms, assemble_normal_blocks, schur_reduce, solve_reduced,
// back_substitute, the guard, the early stop), formula for formula, with
// add_front_se3 from pose_gn.cuh. One difference, exact for finite inputs: a
// row whose observation mask is False adds an exact zero to every sum in the
// plain version (its weight is 0 and its pixel, a zero where the ring holds
// no observation, is finite), and here it is skipped.
//
// Launch sequence of a single-device solve (ops/ba.py enqueues it; 4 iters + 2
// launches, no host read):
//   ba_terms(kErrInit)   copy the anchored start into the state, stop_at =
//                        iters, the starting error's per-block sums;
//   per iteration it = 0 .. iters - 1, each a no-op once it >= stop_at:
//     ba_terms(kTerms)   per landmark tile: the landmark blocks (C, b, B,
//                        Cinv, BCinv) and the tile's share of A, a, S_off,
//                        sb and the divergence count, as per-block partials;
//     ba_solve(kSum|kSolve) one block: the partials summed in block order
//                        into (S, s, n_bad), then the gated, Jacobi-
//                        equilibrated float32 Cholesky, both triangular
//                        solves, the dx guard and the candidate poses;
//     ba_backsub         per landmark tile: dy = Cinv (b - B^T dx) and the
//                        tile's count of non-finite dy;
//     ba_apply           the guard's decision (counts summed in block order),
//                        Xr += dy, T_cr, and stop_at = it + 1 once done;
//   ba_terms(kErrFinal)  the final error's per-block sums.
// With a process group, ba_solve runs twice per iteration (kSum, then kSolve)
// around the all-reduce of (S, s, n_bad).

#pragma once

#include <cstddef>  // offsetof

#include "pose_gn.cuh"  // PG_HD, pose_gn::add_front_se3 (utils/geometry.py's)

namespace ba_gn {

constexpr int kMaxK = 16;        // keyframes in a window
constexpr int kMaxN = 6 * kMaxK;  // the reduced system's size
constexpr int kTL = 16;          // landmarks per tile
constexpr int kMaxBlocks = 64;   // landmark-tile blocks of ba_terms and ba_backsub

// ba_terms modes and ba_solve phases.
constexpr int kTerms = 0, kErrInit = 1, kErrFinal = 2;
constexpr int kSum = 1, kSolve = 2;

// `_Args` of ops/ba.py, field for field.
struct Args {
  const float* pts;    // [M, K, 2] left observations (px)
  const float* pts_r;  // [M, K, 2] right observations
  const bool* mask;    // [M, K] observation & live keyframe & active landmark
  const bool* mask_r;  // [M, K]
  const bool* active;  // [M] lm_active
  const bool* opt;     // [K] opt_mask
  const float* T_rl;   // [4, 4]
  const float* T_in;   // [K, 4, 4] anchored start poses T_cr
  const float* X_in;   // [M, 3] anchored start points Xr
  int M, K;
  float fx, fy, cx, cy, huber_delta, lam, max_trans_update;
  int iters;
  int group;     // 1: the divergence count comes from the all-reduced system only
  int n_blocks;  // blocks of ba_terms and ba_backsub (<= kMaxBlocks)
  // state
  float* T;      // [K, 4, 4] current T_cr
  float* X;      // [M, 3] current Xr
  int* stop_at;  // [1] the iteration count at which the loop stops
  // scratch
  float* part;      // [n_blocks, n_part(K)] per-block partial sums
  float* err_part;  // [2, n_blocks] error sums: before, after
  float* sys;       // [n_sys(K)] S [K, K, 6, 6], s [K, 6], n_bad
  float* dx;        // [K, 6]
  float* T_new;     // [K, 4, 4] candidate poses
  int* dx_bad;      // [1]
  float* dy;        // [M, 3]
  int* dy_bad;      // [n_blocks] active landmarks with a non-finite dy or block
};

// Layout of a block's partial sums: A [K, 6, 6], a [K, 6] (without the
// minus), S_off [K, K, 6, 6], sb [K, 6], n_bad.
PG_HD int off_a(int K) { return 36 * K; }
PG_HD int off_S(int K) { return 42 * K; }
PG_HD int off_sb(int K) { return 42 * K + 36 * K * K; }
PG_HD int off_nb(int K) { return 48 * K + 36 * K * K; }
PG_HD int n_part(int K) { return 48 * K + 36 * K * K + 1; }
PG_HD int n_sys(int K) { return 36 * K * K + 6 * K + 1; }

// What ops/ba.py restates (its `_Args`, the sizes above, the modes and the
// tile), for the check it makes when it binds a library (`ba_layout` of
// ba_gn.cu and ba_gn_host.cpp): kMaxK, kTL, kMaxBlocks, the three modes, the
// two phases, n_part(K), n_sys(K), sizeof(Args), then each field's offset in
// declaration order. Returns the count of ints; writes them if it is <= cap.
#define BA_GN_OFFSET(f) (int)offsetof(Args, f),
inline int layout(int K, int* out, int cap) {
  const int v[] = {kMaxK, kTL, kMaxBlocks, kTerms, kErrInit, kErrFinal, kSum, kSolve, n_part(K), n_sys(K),
                   (int)sizeof(Args),
                   BA_GN_OFFSET(pts) BA_GN_OFFSET(pts_r) BA_GN_OFFSET(mask) BA_GN_OFFSET(mask_r)
                   BA_GN_OFFSET(active) BA_GN_OFFSET(opt) BA_GN_OFFSET(T_rl) BA_GN_OFFSET(T_in) BA_GN_OFFSET(X_in)
                   BA_GN_OFFSET(M) BA_GN_OFFSET(K) BA_GN_OFFSET(fx) BA_GN_OFFSET(fy) BA_GN_OFFSET(cx)
                   BA_GN_OFFSET(cy) BA_GN_OFFSET(huber_delta) BA_GN_OFFSET(lam) BA_GN_OFFSET(max_trans_update)
                   BA_GN_OFFSET(iters) BA_GN_OFFSET(group) BA_GN_OFFSET(n_blocks) BA_GN_OFFSET(T) BA_GN_OFFSET(X)
                   BA_GN_OFFSET(stop_at) BA_GN_OFFSET(part) BA_GN_OFFSET(err_part) BA_GN_OFFSET(sys)
                   BA_GN_OFFSET(dx) BA_GN_OFFSET(T_new) BA_GN_OFFSET(dx_bad) BA_GN_OFFSET(dy) BA_GN_OFFSET(dy_bad)};
  const int n = (int)(sizeof(v) / sizeof(v[0]));
  if (n <= cap)
    for (int i = 0; i < n; ++i) out[i] = v[i];
  return n;
}
#undef BA_GN_OFFSET

// Per-pair slots of a tile: B [6][3], BCinv [6][3], A's share [6][6], a's
// share [6], C's share [3][3], b's share [3], the error term, the row flag.
constexpr int kPairFloats = 18 + 18 + 36 + 6 + 9 + 3 + 1 + 1;
// Shared memory of a ba_terms / ba_backsub block, in floats.
PG_HD int tile_floats(int K) { return n_part(K) + kTL * K * kPairFloats + kTL * (9 + 3 + 1) + 1; }

// A tile's shared memory, carved out of `base`.
struct Tile {
  float *acc, *B, *BC, *Ac, *ac, *Cc, *bc, *ec, *Cinv, *b, *count;
  int *obs, *bad;
  PG_HD Tile(float* base, int K) {
    const int p = kTL * K;
    acc = base;
    B = acc + n_part(K);
    BC = B + 18 * p;
    Ac = BC + 18 * p;
    ac = Ac + 36 * p;
    Cc = ac + 6 * p;
    bc = Cc + 9 * p;
    ec = bc + 3 * p;
    obs = (int*)(ec + p);
    Cinv = (float*)(obs + p);
    b = Cinv + 9 * kTL;
    bad = (int*)(b + 3 * kTL);
    count = (float*)(bad + kTL);
  }
};

PG_HD float inv_depth(float z) { return 1.0f / (fabsf(z) < 1e-6f ? 1e-6f : z); }

// utils/robust.huber_weight.
PG_HD float huber(float rn, float delta) { return rn <= delta ? 1.0f : delta / (rn < 1e-12f ? 1e-12f : rn); }

// build_observation_terms for landmark m in keyframe k at the state (T, X):
// the n rows of the pair (left u, v if ml; right u, v if mr), their
// residuals r, pose blocks Q, point blocks Rj and Huber weights w. `err`
// (error mode) receives the left-row reprojection error, sqrt(r0^2 + r1^2).
struct Rows {
  int n;
  float r[4], Q[4][6], Rj[4][3], w[4];
};

PG_HD void pair_rows(const Args& a, const float* T, const float* X, int m, int k, bool ml, bool mr, Rows& o,
                     float* err) {
  const float* Tk = T + 16 * k;
  const float* Xm = X + 3 * m;
  float Xc[3];
  for (int i = 0; i < 3; ++i) Xc[i] = (Tk[4 * i] * Xm[0] + Tk[4 * i + 1] * Xm[1] + Tk[4 * i + 2] * Xm[2]) + Tk[4 * i + 3];
  const float* p = a.pts + 2 * (m * a.K + k);
  o.n = 0;
  if (ml) {
    float iz = inv_depth(Xc[2]);
    float xiz = Xc[0] * iz, yiz = Xc[1] * iz;
    float r0 = (xiz * a.fx + a.cx) - p[0], r1 = (yiz * a.fy + a.cy) - p[1];
    if (err) *err = sqrtf(r0 * r0 + r1 * r1);
    float rn = sqrtf((r0 * r0 + r1 * r1) + 1e-12f);
    float w = huber(rn, a.huber_delta) * (Xc[2] > 0.05f ? 1.0f : 0.0f);
    const float qu[6] = {a.fx * iz, 0.0f, -a.fx * xiz * iz, -a.fx * xiz * yiz, a.fx * (1.0f + xiz * xiz), -a.fx * yiz};
    const float qv[6] = {0.0f, a.fy * iz, -a.fy * yiz * iz, -a.fy * (1.0f + yiz * yiz), a.fy * xiz * yiz, a.fy * xiz};
    float su = a.fx * iz, sv = a.fy * iz;
    for (int row = 0; row < 2; ++row) {
      int n = o.n++;
      o.r[n] = row ? r1 : r0;
      o.w[n] = w;
      for (int c = 0; c < 6; ++c) o.Q[n][c] = row ? qv[c] : qu[c];
      for (int c = 0; c < 3; ++c)
        o.Rj[n][c] = row ? sv * (Tk[4 + c] - yiz * Tk[8 + c]) : su * (Tk[c] - xiz * Tk[8 + c]);
    }
  }
  if (mr) {
    const float* R = a.T_rl;
    float Xr[3];
    for (int i = 0; i < 3; ++i) Xr[i] = (R[4 * i] * Xc[0] + R[4 * i + 1] * Xc[1] + R[4 * i + 2] * Xc[2]) + R[4 * i + 3];
    float izr = inv_depth(Xr[2]);
    float xn = Xr[0] * izr, yn = Xr[1] * izr;
    const float* pr = a.pts_r + 2 * (m * a.K + k);
    float r2 = (xn * a.fx + a.cx) - pr[0], r3 = (yn * a.fy + a.cy) - pr[1];
    float rn = sqrtf((r2 * r2 + r3 * r3) + 1e-12f);
    float w = huber(rn, a.huber_delta) * (Xr[2] > 0.05f ? 1.0f : 0.0f);
    float su = a.fx * izr, sv = a.fy * izr;
    for (int row = 0; row < 2; ++row) {
      int n = o.n++;
      o.r[n] = row ? r3 : r2;
      o.w[n] = w;
      float d[3];  // dpiR: a row of d(pix_r)/dXr times R_rl
      for (int c = 0; c < 3; ++c) d[c] = row ? sv * (R[4 + c] - yn * R[8 + c]) : su * (R[c] - xn * R[8 + c]);
      for (int c = 0; c < 3; ++c) o.Q[n][c] = d[c];
      o.Q[n][3] = Xc[1] * d[2] - Xc[2] * d[1];  // Xc x dpiR
      o.Q[n][4] = Xc[2] * d[0] - Xc[0] * d[2];
      o.Q[n][5] = Xc[0] * d[1] - Xc[1] * d[0];
      for (int c = 0; c < 3; ++c) o.Rj[n][c] = d[0] * Tk[c] + d[1] * Tk[4 + c] + d[2] * Tk[8 + c];
    }
  }
}

// assemble_normal_blocks for one pair: its shares of A, a (without the
// minus), C, b (without the minus) and its B, into tile slot q.
PG_HD void pair_blocks(const Rows& o, Tile& t, int q, bool with_A) {
  float* B = t.B + 18 * q;
  float* Cc = t.Cc + 9 * q;
  float* bc = t.bc + 3 * q;
  for (int i = 0; i < 18; ++i) B[i] = 0.0f;
  for (int i = 0; i < 9; ++i) Cc[i] = 0.0f;
  for (int i = 0; i < 3; ++i) bc[i] = 0.0f;
  if (with_A) {
    for (int i = 0; i < 36; ++i) t.Ac[36 * q + i] = 0.0f;
    for (int i = 0; i < 6; ++i) t.ac[6 * q + i] = 0.0f;
  }
  for (int n = 0; n < o.n; ++n) {
    float wQ[6], wR[3];
    for (int c = 0; c < 6; ++c) wQ[c] = o.Q[n][c] * o.w[n];
    for (int c = 0; c < 3; ++c) wR[c] = o.Rj[n][c] * o.w[n];
    for (int c = 0; c < 6; ++c)
      for (int d = 0; d < 3; ++d) B[3 * c + d] += wQ[c] * o.Rj[n][d];
    for (int c = 0; c < 3; ++c) {
      for (int d = 0; d < 3; ++d) Cc[3 * c + d] += wR[c] * o.Rj[n][d];
      bc[c] += wR[c] * o.r[n];
    }
    if (with_A) {
      for (int c = 0; c < 6; ++c) {
        for (int d = 0; d < 6; ++d) t.Ac[36 * q + 6 * c + d] += wQ[c] * o.Q[n][d];
        t.ac[6 * q + c] += wQ[c] * o.r[n];
      }
    }
  }
}

// ops/ba._inv3x3: the adjugate over the determinant, clamped to +-1e-12.
PG_HD void inv3x3(const float* C, float* out) {
  float a00 = C[0], a01 = C[1], a02 = C[2], a10 = C[3], a11 = C[4], a12 = C[5], a20 = C[6], a21 = C[7], a22 = C[8];
  float c00 = a11 * a22 - a12 * a21, c01 = a02 * a21 - a01 * a22, c02 = a01 * a12 - a02 * a11;
  float c10 = a12 * a20 - a10 * a22, c11 = a00 * a22 - a02 * a20, c12 = a02 * a10 - a00 * a12;
  float c20 = a10 * a21 - a11 * a20, c21 = a01 * a20 - a00 * a21, c22 = a00 * a11 - a01 * a10;
  float det = (a00 * c00 + a01 * c01) + a02 * c02;
  float inv = 1.0f / (fabsf(det) < 1e-12f ? (det < 0.0f ? -1e-12f : 1e-12f) : det);
  const float adj[9] = {c00, c01, c02, c10, c11, c12, c20, c21, c22};
  for (int i = 0; i < 9; ++i) out[i] = adj[i] * inv;
}

PG_HD bool finite_n(const float* v, int n) {
  bool f = true;
  for (int i = 0; i < n; ++i) f = f && isfinite(v[i]);
  return f;
}

// The landmark blocks of one tile (landmarks c0 .. c0 + kTL - 1) at the
// current state: every pair's rows and blocks, then per landmark C, b
// (damped, summed over its keyframes in order), Cinv and the divergence
// flag; with_A also A's and a's shares and BCinv. Ends on a barrier.
template <class Blk>
PG_HD void tile_blocks(const Args& a, Blk& b, Tile& t, int c0, bool with_A) {
  const int K = a.K;
  for (int q = b.tid; q < kTL * K; q += b.nthr) {
    int l = q / K, k = q % K, m = c0 + l;
    bool ml = m < a.M && a.mask[m * K + k], mr = m < a.M && a.mask_r[m * K + k];
    t.obs[q] = ml || mr;
    if (ml || mr) {
      Rows o;
      pair_rows(a, a.T, a.X, m, k, ml, mr, o, nullptr);
      pair_blocks(o, t, q, with_A);
    }
  }
  b.sync();
  for (int l = b.tid; l < kTL; l += b.nthr) {
    int m = c0 + l;
    float C[9] = {0.0f}, bs[3] = {0.0f};
    bool finite_B = true;
    for (int k = 0; k < K; ++k) {
      int q = l * K + k;
      if (!t.obs[q]) continue;
      for (int i = 0; i < 9; ++i) C[i] += t.Cc[9 * q + i];
      for (int i = 0; i < 3; ++i) bs[i] += t.bc[3 * q + i];
      finite_B = finite_B && finite_n(t.B + 18 * q, 18);
    }
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        float e = i == j ? 1.0f : 0.0f;
        C[3 * i + j] = C[3 * i + j] + (a.lam * C[3 * i + j]) * e;  // C + lam C I
        C[3 * i + j] = C[3 * i + j] + 1e-6f * e;                   // + 1e-6 I
      }
      t.b[3 * l + i] = -bs[i];
    }
    inv3x3(C, t.Cinv + 9 * l);
    bool act = m < a.M && a.active[m];
    t.bad[l] = act && !(finite_n(t.Cinv + 9 * l, 9) && finite_n(t.b + 3 * l, 3) && finite_B);
  }
  b.sync();
  if (with_A) {
    for (int q = b.tid; q < kTL * K; q += b.nthr) {
      if (!t.obs[q]) continue;
      const float* B = t.B + 18 * q;
      const float* Ci = t.Cinv + 9 * (q / K);
      for (int c = 0; c < 6; ++c)
        for (int d = 0; d < 3; ++d)
          t.BC[18 * q + 3 * c + d] = (B[3 * c] * Ci[d] + B[3 * c + 1] * Ci[3 + d]) + B[3 * c + 2] * Ci[6 + d];
    }
    b.sync();
  }
}

// Adds one tile's share to the block's partial sums; thread tid owns the
// entries tid, tid + nthr, ... and sums over the tile's landmarks in order.
template <class Blk>
PG_HD void tile_accumulate(const Args& a, Blk& b, Tile& t) {
  const int K = a.K, P = n_part(K);
  for (int e = b.tid; e < P; e += b.nthr) {
    float s = t.acc[e];
    if (e < off_a(K)) {  // A[k][c][d]
      int k = e / 36, cd = e % 36;
      for (int l = 0; l < kTL; ++l)
        if (t.obs[l * K + k]) s += t.Ac[36 * (l * K + k) + cd];
    } else if (e < off_S(K)) {  // a[k][c]
      int k = (e - off_a(K)) / 6, c = (e - off_a(K)) % 6;
      for (int l = 0; l < kTL; ++l)
        if (t.obs[l * K + k]) s += t.ac[6 * (l * K + k) + c];
    } else if (e < off_sb(K)) {  // S_off[j][k][c][d] = sum_m BCinv_mj[c] . B_mk[d]
      int f = e - off_S(K), blk = f / 36, j = blk / K, k = blk % K, c = (f % 36) / 6, d = f % 6;
      for (int l = 0; l < kTL; ++l) {
        int qj = l * K + j, qk = l * K + k;
        if (!(t.obs[qj] && t.obs[qk])) continue;
        const float* x = t.BC + 18 * qj + 3 * c;
        const float* y = t.B + 18 * qk + 3 * d;
        s += (x[0] * y[0] + x[1] * y[1]) + x[2] * y[2];
      }
    } else if (e < off_nb(K)) {  // sb[j][c] = sum_m BCinv_mj[c] . b_m
      int j = (e - off_sb(K)) / 6, c = (e - off_sb(K)) % 6;
      for (int l = 0; l < kTL; ++l) {
        int q = l * K + j;
        if (!t.obs[q]) continue;
        const float* x = t.BC + 18 * q + 3 * c;
        const float* y = t.b + 3 * l;
        s += (x[0] * y[0] + x[1] * y[1]) + x[2] * y[2];
      }
    } else {  // n_bad
      for (int l = 0; l < kTL; ++l) s += t.bad[l] ? 1.0f : 0.0f;
    }
    t.acc[e] = s;
  }
}

// ba_terms: one block's tiles, tile index bid, bid + nblk, ... In kTerms the
// block's partial sums of the reduced system; in kErrInit / kErrFinal the
// masked left-row error sum (ops/ba.py's err_sums) of the start or the
// current state, kErrInit also copying the start into the state.
template <class Blk>
PG_HD void terms_block(const Args& a, Blk& b, float* smem, int it, int mode) {
  if (mode == kTerms && it >= *a.stop_at) return;
  const int K = a.K;
  Tile t(smem, K);
  if (mode != kTerms) {
    const bool init = mode == kErrInit;
    const float* T = init ? a.T_in : a.T;
    const float* X = init ? a.X_in : a.X;
    if (init && b.bid == 0) {
      for (int i = b.tid; i < 16 * K; i += b.nthr) a.T[i] = a.T_in[i];
      if (b.tid == 0) *a.stop_at = a.iters;
    }
    if (b.tid == 0) *t.count = 0.0f;
    for (int c0 = kTL * b.bid; c0 < a.M; c0 += kTL * b.nblk) {
      b.sync();
      for (int q = b.tid; q < kTL * K; q += b.nthr) {
        int l = q / K, k = q % K, m = c0 + l;
        bool ml = m < a.M && a.mask[m * K + k];
        t.obs[q] = ml;
        if (ml) {
          Rows o;
          pair_rows(a, T, X, m, k, true, false, o, t.ec + q);
        }
        if (init && k == 0 && m < a.M)
          for (int i = 0; i < 3; ++i) a.X[3 * m + i] = a.X_in[3 * m + i];
      }
      b.sync();
      if (b.tid == 0) {
        float s = *t.count;
        for (int q = 0; q < kTL * K; ++q)
          if (t.obs[q]) s += t.ec[q];
        *t.count = s;
      }
    }
    b.sync();
    if (b.tid == 0) a.err_part[(init ? 0 : a.n_blocks) + b.bid] = *t.count;
    return;
  }
  const int P = n_part(K);
  for (int e = b.tid; e < P; e += b.nthr) t.acc[e] = 0.0f;
  for (int c0 = kTL * b.bid; c0 < a.M; c0 += kTL * b.nblk) {
    b.sync();  // the previous tile's sums are taken
    tile_blocks(a, b, t, c0, true);
    tile_accumulate(a, b, t);
  }
  b.sync();
  for (int e = b.tid; e < P; e += b.nthr) a.part[(size_t)b.bid * P + e] = t.acc[e];
}

// ba_backsub: dy = Cinv (b - sum_k B_k^T dx_k) for the block's active
// landmarks (0 for the others), and the count of active landmarks whose
// blocks or dy are not finite.
template <class Blk>
PG_HD void backsub_block(const Args& a, Blk& b, float* smem, int it) {
  if (it >= *a.stop_at) return;
  const int K = a.K;
  Tile t(smem, K);
  if (b.tid == 0) *t.count = 0.0f;
  for (int c0 = kTL * b.bid; c0 < a.M; c0 += kTL * b.nblk) {
    b.sync();
    tile_blocks(a, b, t, c0, false);
    for (int l = b.tid; l < kTL; l += b.nthr) {
      int m = c0 + l;
      if (m >= a.M) continue;
      float dy[3] = {0.0f, 0.0f, 0.0f};
      if (a.active[m]) {
        float rhs[3];
        for (int c = 0; c < 3; ++c) {
          float s = 0.0f;
          for (int k = 0; k < K; ++k) {
            int q = l * K + k;
            if (!t.obs[q]) continue;
            for (int r = 0; r < 6; ++r) s += t.B[18 * q + 3 * r + c] * a.dx[6 * k + r];
          }
          rhs[c] = t.b[3 * l + c] - s;
        }
        const float* Ci = t.Cinv + 9 * l;
        for (int i = 0; i < 3; ++i) dy[i] = (Ci[3 * i] * rhs[0] + Ci[3 * i + 1] * rhs[1]) + Ci[3 * i + 2] * rhs[2];
        t.bad[l] = t.bad[l] || !finite_n(dy, 3);
      }
      for (int i = 0; i < 3; ++i) a.dy[3 * m + i] = dy[i];
    }
    b.sync();
    if (b.tid == 0) {
      float s = *t.count;
      for (int l = 0; l < kTL; ++l) s += t.bad[l] ? 1.0f : 0.0f;
      *t.count = s;
    }
  }
  b.sync();
  if (b.tid == 0) a.dy_bad[b.bid] = (int)*t.count;
}

// What ba_solve keeps in shared memory.
struct SolveShared {
  float H[kMaxN * kMaxN];  // the equilibrated system, then its Cholesky factor (lower)
  float z[kMaxN], y[kMaxN], dinv[kMaxN], ld[kMaxN];
};

// ba_solve: kSum sums the partials in block order into sys = (S, s, n_bad)
// (schur_reduce's damping and assembly); kSolve solves sys (solve_reduced)
// and takes the candidate step: dx, the dx guard (non-finite, or a
// translation above max_trans_update) and T_new = add_front_se3(T, dx) on
// the optimisable poses.
template <class Blk>
PG_HD void solve_block(const Args& a, Blk& b, SolveShared& sh, int it, int phase) {
  if (it >= *a.stop_at) return;
  const int K = a.K, n = 6 * K, P = n_part(K), G = a.n_blocks;
  if (phase & kSum) {
    for (int e = b.tid; e < n_sys(K); e += b.nthr) {
      float v;
      if (e < 36 * K * K) {  // S[j][k][c][d] = -S_off + [j == k] (A + lam A I)
        int blk = e / 36, j = blk / K, k = blk % K, cd = e % 36;
        float so = 0.0f;
        for (int g = 0; g < G; ++g) so += a.part[(size_t)g * P + off_S(K) + e];
        v = -so;
        if (j == k) {
          float A = 0.0f;
          for (int g = 0; g < G; ++g) A += a.part[(size_t)g * P + 36 * j + cd];
          v = v + (A + (a.lam * A) * (cd / 6 == cd % 6 ? 1.0f : 0.0f));
        }
      } else if (e < 36 * K * K + 6 * K) {  // s = a - sb
        int f = e - 36 * K * K;
        float av = 0.0f, sb = 0.0f;
        for (int g = 0; g < G; ++g) av += a.part[(size_t)g * P + off_a(K) + f];
        for (int g = 0; g < G; ++g) sb += a.part[(size_t)g * P + off_sb(K) + f];
        v = -av - sb;
      } else {
        v = 0.0f;
        for (int g = 0; g < G; ++g) v += a.part[(size_t)g * P + off_nb(K)];
      }
      a.sys[e] = v;
    }
    b.sync();
  }
  if (!(phase & kSolve)) return;
  // solve_reduced: gate the fixed and empty slots, unit diagonal there.
  for (int e = b.tid; e < n * n; e += b.nthr) {
    int i = e / n, c = e % n, j = i / 6, k = c / 6;
    float oj = a.opt[j] ? 1.0f : 0.0f, ok = a.opt[k] ? 1.0f : 0.0f;
    float v = a.sys[((j * K + k) * 6 + i % 6) * 6 + c % 6] * (oj * ok);
    v = (v * oj) * ok;
    if (i == c) v = v + (1.0f - oj);
    sh.H[e] = v;
  }
  b.sync();
  for (int i = b.tid; i < n; i += b.nthr) {
    float d = sh.H[i * n + i];
    sh.dinv[i] = 1.0f / sqrtf(d < 1e-12f ? 1e-12f : d);
  }
  b.sync();
  for (int e = b.tid; e < n * n; e += b.nthr) {
    int i = e / n, c = e % n;
    sh.H[e] = (sh.H[e] * sh.dinv[i]) * sh.dinv[c] + (i == c ? 1e-7f : 0.0f);
  }
  for (int i = b.tid; i < n; i += b.nthr) sh.z[i] = (a.sys[36 * K * K + i] * (a.opt[i / 6] ? 1.0f : 0.0f)) * sh.dinv[i];
  b.sync();
  // Cholesky, right-looking, lower triangle only; a pivot that is not > 0
  // (NaN included) fails it, as cholesky_ex's info != 0, and the step is NaN.
  bool fail = false;
  for (int j = 0; j < n; ++j) {
    float d = sh.H[j * n + j];
    if (!(d > 0.0f)) {
      fail = true;
      break;
    }
    float l = sqrtf(d);
    if (b.tid == 0) sh.ld[j] = l;
    for (int i = j + 1 + b.tid; i < n; i += b.nthr) sh.H[i * n + j] = sh.H[i * n + j] / l;
    b.sync();
    const int w = n - j - 1;
    for (int p = b.tid; p < w * w; p += b.nthr) {
      int i = j + 1 + p / w, c = j + 1 + p % w;
      if (c <= i) sh.H[i * n + c] -= sh.H[i * n + j] * sh.H[c * n + j];
    }
    b.sync();
  }
  if (!fail) {
    for (int j = 0; j < n; ++j) {  // L y = z
      float yj = sh.z[j] / sh.ld[j];
      if (b.tid == 0) sh.y[j] = yj;
      for (int i = j + 1 + b.tid; i < n; i += b.nthr) sh.z[i] -= sh.H[i * n + j] * yj;
      b.sync();
    }
    for (int j = n - 1; j >= 0; --j) {  // L^T x = y, x into z
      float xj = sh.y[j] / sh.ld[j];
      if (b.tid == 0) sh.z[j] = xj;
      for (int i = b.tid; i < j; i += b.nthr) sh.y[i] -= sh.H[j * n + i] * xj;
      b.sync();
    }
  }
  for (int i = b.tid; i < n; i += b.nthr)
    a.dx[i] = ((fail ? NAN : sh.z[i]) * sh.dinv[i]) * (a.opt[i / 6] ? 1.0f : 0.0f);
  b.sync();
  if (b.tid == 0) {
    bool bad = !finite_n(a.dx, n);
    for (int k = 0; k < K; ++k) {
      const float* d = a.dx + 6 * k;
      bad = bad || sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) > a.max_trans_update;
      float Tk[16];
      pose_gn::copy16(a.T + 16 * k, Tk);
      if (a.opt[k]) pose_gn::add_front_se3(d, Tk);
      pose_gn::copy16(Tk, a.T_new + 16 * k);
    }
    *a.dx_bad = bad;
  }
}

// ba_apply: the guard (the dx test, then the divergence counts summed in
// block order: the all-reduced n_bad, and on one device also every tile's
// non-finite dy), Xr += dy and T_cr = T_new unless bad, and the early stop:
// done = bad or max |dx| < 1e-5 sets stop_at = it + 1, which the launches of
// later iterations read (this launch's blocks compare it with it).
template <class Blk>
PG_HD void apply_block(const Args& a, Blk& b, int it) {
  if (it >= *a.stop_at) return;
  int n_dy = 0;
  for (int g = 0; g < a.n_blocks; ++g) n_dy += a.dy_bad[g];
  bool dy_bad = a.sys[n_sys(a.K) - 1] > 0.0f || (!a.group && n_dy > 0);
  bool bad = *a.dx_bad || dy_bad;
  if (!bad)
    for (int i = b.bid * b.nthr + b.tid; i < 3 * a.M; i += b.nthr * b.nblk) a.X[i] = a.X[i] + a.dy[i];
  if (b.bid == 0 && b.tid == 0) {
    float mx = 0.0f;
    if (!bad) {
      for (int i = 0; i < 16 * a.K; ++i) a.T[i] = a.T_new[i];
      for (int i = 0; i < 6 * a.K; ++i) mx = fmaxf(mx, fabsf(a.dx[i]));
    }
    if (bad || mx < 1e-5f) *a.stop_at = it + 1;
  }
}

}  // namespace ba_gn
