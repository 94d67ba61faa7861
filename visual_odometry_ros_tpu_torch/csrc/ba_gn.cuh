// The window-BA Gauss-Newton solve of csrc/ba_gn.cu, written once for two
// compilers.
//
// nvcc compiles it into the four `ba_*` kernels; g++ compiles it into a
// one-thread host version (csrc/ba_gn_host.cpp) that exports the same four
// launchers, so that the CPU tests run the kernels' launch sequence, formula
// for formula, against the plain PyTorch version. Both run the code below;
// they differ only in `Blk` (the thread's and the block's index, the counts,
// the block and warp barriers, a block-wide sum and prefix). The host runs a
// launch's blocks one after the other, each with one thread.
//
// Semantics: ops/ba.py's plain version (`ba_solve_ref`: _anchor,
// build_observation_terms, assemble_normal_blocks, schur_reduce,
// solve_reduced, back_substitute, the guard, the early stop, _write_back),
// formula for formula, with add_front_se3 from pose_gn.cuh and
// utils/geometry's se3_inverse, transform_points and so3_project. The small
// matrix products and the residuals round as the plain version's do on the
// same device (`dot`, `dot3_mv`, `mul_rn`), so the anchored start and the
// write-back equal _anchor's and _write_back's bit for bit. Three
// differences, exact for finite inputs:
//   - a row whose observation mask is False adds an exact zero to every sum
//     in the plain version (its weight is 0 and its pixel, a zero where the
//     ring holds no observation, is finite); here it is skipped, and so is
//     every landmark that is not active;
//   - solve_reduced gates the fixed and empty slots to unit rows of the
//     system and dx = 0; here they are left out of it: only the n_opt
//     optimisable slots are summed, factored and solved (their entries and
//     the order of every operation on them are the plain version's), and the
//     fixed slots' dx is an exact 0;
//   - the Cholesky reads the lower triangle only, as cholesky_ex does, so
//     only the lower block triangle of S_off is summed.
// A non-finite entry of a fixed slot's block fails the plain version's
// Cholesky and refuses the step; here the same step is refused by the
// divergence count, since such an entry comes from a non-finite B, b or Cinv
// of an active landmark. Only a product BCinv B that overflows while both
// factors are finite, on a pair with a fixed slot, decides otherwise.
//
// Launch sequence of a single-device solve (ops/ba.py enqueues it; 3 iters + 2
// launches, no host read):
//   ba_terms(kErrInit)   _anchor: the masks, lm_active, opt_mask and the
//                        start anchored at slot 0 (T_cr, Xr) into the state's
//                        first half; the list of active landmark slots and
//                        the live slots' bit set (block 0); stop_at = iters,
//                        half, the count and the ticket 0; the starting
//                        error's per-block sums;
//   per iteration it = 0 .. iters - 1, each a no-op once it >= stop_at:
//     ba_terms(kTerms)   per tile of kTL listed landmarks: the landmark
//                        blocks (C, b, B, Cinv, BCinv) and the tile's share of
//                        A, a, S_off, sb over the optimisable slots and the
//                        divergence count, as per-block partials; Cinv, b and
//                        B stored by list position for ba_backsub (`blk`);
//     ba_solve(kSum|kSolve) one block: the partials summed in block order
//                        into (S, s, n_bad) of the optimisable slots, then
//                        the Jacobi-equilibrated float32 Cholesky, both
//                        triangular solves (one warp when n_opt <= 5, else
//                        the block by 6 x 6 keyframe blocks), the guard's
//                        dx test and the system's count (step_bad), max
//                        |dx|, and the step's poses T_new =
//                        add_front_se3(T_cr, dx);
//     ba_backsub         unless refused: a thread per (listed landmark,
//                        row), dy = Cinv (b - B^T dx) from the stored blocks,
//                        Xr += dy with the previous Xr kept in X's second
//                        half, the count of non-finite dy (one atomic
//                        counter); one warp takes T_new, T_cr kept in T's
//                        second half; then every block takes a ticket, and
//                        the last one decides: a step that only dy's count
//                        refuses turns the state to the second half, and
//                        stop_at = it + 1 once done;
//   ba_terms(kErrFinal)  from the state's half: the final error's per-block
//                        sums and _write_back: T_cw (re-orthonormalised
//                        where optimised), Xw, killed.
// With a process group, ba_solve runs twice per iteration (kSum, then kSolve)
// around the all-reduce of (S, s, n_bad).

#pragma once

#include <cstddef>  // offsetof

#include "pose_gn.cuh"  // PG_HD, pose_gn::add_front_se3 (utils/geometry.py's)

namespace ba_gn {

constexpr int kMaxK = 16;                          // keyframes in a window
constexpr int kMaxN = 6 * kMaxK;                   // the reduced system's size
constexpr int kMaxPairs = kMaxK * (kMaxK + 1) / 2;  // its lower block triangle
constexpr int kTL = 16;                            // landmarks per tile

// ba_terms modes and ba_solve phases.
constexpr int kTerms = 0, kErrInit = 1, kErrFinal = 2;
constexpr int kSum = 1, kSolve = 2;

// `_Args` of ops/ba.py, field for field.
struct Args {
  // the problem, as ops/ba.BAProblem holds it
  const float* T_cw;     // [K, 4, 4] world -> camera poses
  const float* Xw;       // [M, 3] world points
  const float* pts;      // [M, K, 2] left observations (px)
  const float* pts_r;    // [M, K, 2] right observations
  const bool* mask;      // [M, K]
  const bool* mask_r;    // [M, K]
  const bool* kf_valid;  // [K]
  const bool* lm_valid;  // [M]
  const float* T_rl;     // [4, 4]
  int M, K;
  float fx, fy, cx, cy, huber_delta, lam, max_trans_update, kill_dist;
  int iters, n_fix, min_obs;
  int group;     // 1: the divergence count comes from the all-reduced system only
  int n_blocks;  // blocks of ba_terms and ba_backsub: the card's SM count, at most a block per tile
  // the result
  float* T_out;  // [K, 4, 4] T_cw after the solve
  float* X_out;  // [M, 3] Xw after the solve
  bool* killed;  // [M]
  // state, in two halves: the current T_cr and Xr in the first; in the
  // second, as they were before the last step (X for the listed landmarks
  // only); `half` says which half holds the state
  float* T;      // [2, K, 4, 4]
  float* X;      // [2, M, 3] (read for active landmarks only)
  int* half;     // [1] 0, or 1 once ba_backsub refused a step for a non-finite dy alone
  int* stop_at;  // [1] the iteration count at which the loop stops
  int* live;     // [1] the live slots as a bit set (bit k: kf_valid[k])
  bool* active;  // [M] lm_active
  int* list;     // [M] the active slots in ascending order, the first *n_act of it
  int* n_act;    // [1]
  // scratch
  float* part;      // [n_blocks, n_part(n_opt)] per-block partial sums
  float* err_part;  // [2, n_blocks, 3] error sum, left and right rows: before, after
  float* sys;       // [n_sys(n_opt)] S's lower block triangle, s, n_bad
  float* dx;        // [K, 6]
  float* T_new;     // [K, 4, 4] the step's poses
  float* blk;       // [blk_rows(n_opt), M] the landmark blocks of ba_terms, by list position
  int* step_bad;    // [1] the step refused before back-substitution: dx's guard or n_bad
  float* dx_max;    // [1] max |dx|
  int* n_dy;        // [1] listed landmarks with a non-finite dy (an integer: the same in any order)
  int* ticket;      // [1] ba_backsub's blocks that have finished their landmarks
};

// Sizes over the n optimisable slots. The lower block triangle of S holds
// the pairs (j, k), k <= j, in the order (0, 0), (1, 0), (1, 1), (2, 0) ...
// A block's partial sums: A [n, 6, 6], a [n, 6] (without the minus), S_off
// [pairs, 6, 6], sb [n, 6], n_bad. The system: S [pairs, 6, 6], s [n, 6],
// n_bad.
PG_HD int n_pairs(int n) { return n * (n + 1) / 2; }
PG_HD int off_a(int n) { return 36 * n; }
PG_HD int off_S(int n) { return 42 * n; }
PG_HD int off_sb(int n) { return 42 * n + 36 * n_pairs(n); }
PG_HD int off_nb(int n) { return 48 * n + 36 * n_pairs(n); }
PG_HD int n_part(int n) { return 48 * n + 36 * n_pairs(n) + 1; }
PG_HD int n_sys(int n) { return 36 * n_pairs(n) + 6 * n + 1; }
// Rows of `blk`, each M floats over the list positions: Cinv [9] (row-major),
// b [3], then per optimisable slot B [18] (B[3 r + c], pose row r, point
// column c; zero where the slot does not observe the landmark).
PG_HD int blk_rows(int n) { return 12 + 18 * n; }

// What ops/ba.py restates (its `_Args`, the sizes above, the modes and the
// tile), for the check it makes when it binds a library (`ba_layout` of
// ba_gn.cu and ba_gn_host.cpp): kMaxK, kTL, the three modes, the two phases,
// n_part(n), n_sys(n), blk_rows(n), sizeof(Args), then each field's offset
// in declaration order. Returns the count of ints; writes them if it is <=
// cap.
#define BA_GN_OFFSET(f) (int)offsetof(Args, f),
inline int layout(int n, int* out, int cap) {
  const int v[] = {kMaxK, kTL, kTerms, kErrInit, kErrFinal, kSum, kSolve, n_part(n), n_sys(n), blk_rows(n),
                   (int)sizeof(Args),
                   BA_GN_OFFSET(T_cw) BA_GN_OFFSET(Xw) BA_GN_OFFSET(pts) BA_GN_OFFSET(pts_r) BA_GN_OFFSET(mask)
                   BA_GN_OFFSET(mask_r) BA_GN_OFFSET(kf_valid) BA_GN_OFFSET(lm_valid) BA_GN_OFFSET(T_rl)
                   BA_GN_OFFSET(M) BA_GN_OFFSET(K) BA_GN_OFFSET(fx) BA_GN_OFFSET(fy) BA_GN_OFFSET(cx)
                   BA_GN_OFFSET(cy) BA_GN_OFFSET(huber_delta) BA_GN_OFFSET(lam) BA_GN_OFFSET(max_trans_update)
                   BA_GN_OFFSET(kill_dist) BA_GN_OFFSET(iters) BA_GN_OFFSET(n_fix) BA_GN_OFFSET(min_obs)
                   BA_GN_OFFSET(group) BA_GN_OFFSET(n_blocks) BA_GN_OFFSET(T_out) BA_GN_OFFSET(X_out)
                   BA_GN_OFFSET(killed) BA_GN_OFFSET(T) BA_GN_OFFSET(X) BA_GN_OFFSET(half) BA_GN_OFFSET(stop_at)
                   BA_GN_OFFSET(live) BA_GN_OFFSET(active) BA_GN_OFFSET(list) BA_GN_OFFSET(n_act) BA_GN_OFFSET(part)
                   BA_GN_OFFSET(err_part) BA_GN_OFFSET(sys) BA_GN_OFFSET(dx) BA_GN_OFFSET(T_new) BA_GN_OFFSET(blk)
                   BA_GN_OFFSET(step_bad) BA_GN_OFFSET(dx_max) BA_GN_OFFSET(n_dy) BA_GN_OFFSET(ticket)};
  const int n_v = (int)(sizeof(v) / sizeof(v[0]));
  if (n_v <= cap)
    for (int i = 0; i < n_v; ++i) out[i] = v[i];
  return n_v;
}
#undef BA_GN_OFFSET

// The first n_fix slots are never optimisable, so a window of K slots has at
// most this many: what the host sizes scratch by.
PG_HD int max_opt(int K, int n_fix) { return K - n_fix > 0 ? K - n_fix : 0; }

PG_HD bool opt_slot(const Args& a, int k) { return a.kf_valid[k] && k >= a.n_fix; }

// The live slots as a bit set over k (the first launch stores it as `live`
// for the others); the optimisable ones are those from n_fix on.
PG_HD unsigned live_bits(const Args& a) {
  unsigned v = 0;
  for (int k = 0; k < a.K; ++k)
    if (a.kf_valid[k]) v |= 1u << k;
  return v;
}
PG_HD unsigned opt_bits(const Args& a, unsigned kf) { return kf & ~((1u << a.n_fix) - 1u); }

PG_HD int popc(unsigned v) {
#ifdef __CUDA_ARCH__
  return __popc(v);
#else
  return __builtin_popcount(v);
#endif
}

// The lowest set bit's index (v != 0).
PG_HD int lowest(unsigned v) {
#ifdef __CUDA_ARCH__
  return __ffs(v) - 1;
#else
  return __builtin_ctz(v);
#endif
}

// The window's slots as the tile and solve launches read them, and the
// landmark list's size (from the state the first launch wrote).
struct Slots {
  int n_opt, n_act, n_tiles;
  int kf[kMaxK];             // kf_valid
  int cidx[kMaxK];           // slot k's index among the optimisable slots, -1 if fixed
  int slot[kMaxK];           // the c-th optimisable slot
  int pj[kMaxPairs], pk[kMaxPairs];  // the lower block triangle's pairs (j, k)
};

// The slot tables, each entry by its own thread from the bit set of live
// slots, which every thread reads with the list's size: slot k's index
// among the optimisable slots counts those before it, and a pair p of the
// lower block triangle finds its row j by a walk over at most kMaxK rows.
template <class Blk>
PG_HD void load_slots(const Args& a, Blk& b, Slots& s) {
  const int n_act = *a.n_act;
  const unsigned kf = (unsigned)*a.live, opt = opt_bits(a, kf);
  for (int k = b.tid; k < a.K; k += b.nthr) {
    const bool o = (opt >> k) & 1u;
    s.kf[k] = (kf >> k) & 1u;
    s.cidx[k] = o ? popc(opt & ((1u << k) - 1u)) : -1;
    if (o) s.slot[s.cidx[k]] = k;
  }
  const int n = popc(opt);
  for (int p = b.tid; p < n_pairs(n); p += b.nthr) {
    int j = 0;
    while ((j + 1) * (j + 2) / 2 <= p) ++j;
    s.pj[p] = j;
    s.pk[p] = p - j * (j + 1) / 2;
  }
  if (b.tid == 0) {
    s.n_opt = n;
    s.n_act = n_act;
    s.n_tiles = (n_act + kTL - 1) / kTL;
  }
  b.sync();
}

// Blocks of a tile launch that received a tile (the others return at once),
// and so the partial sums that ba_solve adds up.
PG_HD int used_blocks(const Args& a, int n_act) {
  const int n_tiles = (n_act + kTL - 1) / kTL;
  return n_tiles < a.n_blocks ? n_tiles : a.n_blocks;
}

// Per-pair slots of a tile, for every window slot: C's share [3][3], b's
// share [3], the observed flag, B's finite flag; for every optimisable slot:
// B [6][3], BCinv [6][3], A's share [6][6], a's share [6]; per landmark:
// Cinv, b, the divergence flag.
constexpr int kPairFloats = 9 + 3 + 1 + 1;
constexpr int kOptPairFloats = 18 + 18 + 36 + 6;
// Shared memory of a ba_terms tile block, in floats, for K slots of which
// at most n_opt are optimisable.
PG_HD int tile_floats(int K, int n_opt) {
  return n_part(n_opt) + kTL * K * kPairFloats + kTL * n_opt * kOptPairFloats + kTL * (9 + 3 + 1);
}
// ... and of an error launch: the anchored poses T_cr [K][16], T_rw, T_wr.
PG_HD int err_floats(int K) { return 16 * K + 32; }

// A tile's shared memory, carved out of `base` (q = l K + k indexes a pair,
// o = l n_opt + c an optimisable one).
struct Tile {
  float *acc, *Cc, *bc, *B, *BC, *Ac, *ac, *Cinv, *b;
  int *obs, *fin, *bad;
  PG_HD Tile(float* base, int K, int n_opt) {
    const int p = kTL * K, po = kTL * n_opt;
    acc = base;
    Cc = acc + n_part(n_opt);
    bc = Cc + 9 * p;
    B = bc + 3 * p;
    BC = B + 18 * po;
    Ac = BC + 18 * po;
    ac = Ac + 36 * po;
    Cinv = ac + 6 * po;
    b = Cinv + 9 * kTL;
    obs = (int*)(b + 3 * kTL);
    fin = obs + p;
    bad = fin + p;
  }
};

// sum_i a[i sa] b[i sb] over n terms in order, as the plain version's
// matrix products (`@`, einsum) sum an inner dimension on each device: on
// the card cuBLAS rounds the first product and fuses each later one into
// the sum (fmaf); on the host this build rounds each product. Left to nvcc,
// a*b + c*d would contract into fma(a, b, c*d), which rounds the other
// product: the anchored start then differs from _anchor's in the last bit,
// and the starting error by up to 2e-5 relative on the 200-frame leg.
PG_HD float dot(const float* a, int sa, const float* b, int sb, int n) {
  float s = a[0] * b[0];
  for (int i = 1; i < n; ++i) {
#ifdef __CUDA_ARCH__
    s = fmaf(a[i * sa], b[i * sb], s);
#else
    s = s + a[i * sa] * b[i * sb];
#endif
  }
  return s;
}

// a * b rounded on its own, as the plain version's elementwise products
// are: on the card never contracted into an fma with the add that follows.
PG_HD float mul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

// utils/geometry.transform_points: Y = R X + t, the product summed first.
PG_HD void transform(const float* T, const float* X, float* Y) {
  for (int i = 0; i < 3; ++i) Y[i] = dot(T + 4 * i, 1, X, 1, 3) + T[4 * i + 3];
}

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
  transform(Tk, Xm, Xc);
  const float* p = a.pts + 2 * (m * a.K + k);
  o.n = 0;
  if (ml) {
    float iz = inv_depth(Xc[2]);
    float xiz = Xc[0] * iz, yiz = Xc[1] * iz;
    float r0 = (mul_rn(xiz, a.fx) + a.cx) - p[0], r1 = (mul_rn(yiz, a.fy) + a.cy) - p[1];
    const float rr = mul_rn(r0, r0) + mul_rn(r1, r1);
    if (err) *err = sqrtf(rr);
    float rn = sqrtf(rr + 1e-12f);
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
    transform(R, Xc, Xr);
    float izr = inv_depth(Xr[2]);
    float xn = Xr[0] * izr, yn = Xr[1] * izr;
    const float* pr = a.pts_r + 2 * (m * a.K + k);
    float r2 = (mul_rn(xn, a.fx) + a.cx) - pr[0], r3 = (mul_rn(yn, a.fy) + a.cy) - pr[1];
    float rn = sqrtf((mul_rn(r2, r2) + mul_rn(r3, r3)) + 1e-12f);
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

// assemble_normal_blocks for one pair: its shares of C and b (without the
// minus) into pair slot q and whether its B is finite; for an optimisable
// slot (o >= 0) also its B and its shares of A and a (without the minus)
// into slot o.
PG_HD void pair_blocks(const Rows& o, Tile& t, int q, int opt) {
  float B[18];
  float* Cc = t.Cc + 9 * q;
  float* bc = t.bc + 3 * q;
  float* Ac = opt >= 0 ? t.Ac + 36 * opt : nullptr;
  float* ac = opt >= 0 ? t.ac + 6 * opt : nullptr;
  for (int i = 0; i < 18; ++i) B[i] = 0.0f;
  for (int i = 0; i < 9; ++i) Cc[i] = 0.0f;
  for (int i = 0; i < 3; ++i) bc[i] = 0.0f;
  if (Ac) {
    for (int i = 0; i < 36; ++i) Ac[i] = 0.0f;
    for (int i = 0; i < 6; ++i) ac[i] = 0.0f;
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
    if (Ac) {
      for (int c = 0; c < 6; ++c) {
        for (int d = 0; d < 6; ++d) Ac[6 * c + d] += wQ[c] * o.Q[n][d];
        ac[c] += wQ[c] * o.r[n];
      }
    }
  }
  bool fin = true;
  for (int i = 0; i < 18; ++i) fin = fin && isfinite(B[i]);
  t.fin[q] = fin;
  if (opt >= 0)
    for (int i = 0; i < 18; ++i) t.B[18 * opt + i] = B[i];
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

// Entry (row, list position p) of `blk`.
PG_HD float& blk_at(const Args& a, int row, int p) { return a.blk[(size_t)row * a.M + p]; }

// The landmark blocks of the tile of list positions p0 .. p0 + kTL - 1 at
// the current state: every pair's rows, blocks and A's and a's shares, then
// per landmark C, b (damped, summed over its keyframes in order), Cinv and
// the divergence flag, then BCinv; Cinv, b and B over the optimisable slots
// also into `blk` for ba_backsub, where they are made (a pair that is not
// observed stores B = 0: its B^T dx terms then add an exact zero to a sum
// that starts at +0, which leaves the sum as it was, as the plain version's
// masked pair adds exact zeros too). Ends on a barrier.
template <class Blk>
PG_HD void tile_blocks(const Args& a, Blk& b, const Slots& s, Tile& t, int p0) {
  const int K = a.K, no = s.n_opt;
  for (int q = b.tid; q < kTL * K; q += b.nthr) {
    const int l = q / K, k = q % K;
    const int m = p0 + l < s.n_act ? a.list[p0 + l] : -1;
    const bool ml = m >= 0 && s.kf[k] && a.mask[m * K + k], mr = m >= 0 && s.kf[k] && a.mask_r[m * K + k];
    t.obs[q] = ml || mr;
    const int opt = s.cidx[k] < 0 ? -1 : l * no + s.cidx[k];
    if (ml || mr) {
      Rows o;
      pair_rows(a, a.T, a.X, m, k, ml, mr, o, nullptr);  // a working iteration's state is the first half
      pair_blocks(o, t, q, opt);
    }
    if (opt >= 0 && m >= 0)  // B for ba_backsub, 0 where the slot does not observe the landmark
      for (int i = 0; i < 18; ++i) blk_at(a, 12 + 18 * s.cidx[k] + i, p0 + l) = ml || mr ? t.B[18 * opt + i] : 0.0f;
  }
  b.sync();
  for (int l = b.tid; l < kTL; l += b.nthr) {
    float C[9] = {0.0f}, bs[3] = {0.0f};
    bool finite_B = true;
    for (int k = 0; k < K; ++k) {
      const int q = l * K + k;
      if (!t.obs[q]) continue;
      for (int i = 0; i < 9; ++i) C[i] += t.Cc[9 * q + i];
      for (int i = 0; i < 3; ++i) bs[i] += t.bc[3 * q + i];
      finite_B = finite_B && t.fin[q];
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
    if (p0 + l < s.n_act)  // Cinv and b for ba_backsub
      for (int i = 0; i < 12; ++i) blk_at(a, i, p0 + l) = i < 9 ? t.Cinv[9 * l + i] : t.b[3 * l + i - 9];
    t.bad[l] = p0 + l < s.n_act && !(finite_n(t.Cinv + 9 * l, 9) && finite_n(t.b + 3 * l, 3) && finite_B);
  }
  b.sync();
  for (int o = b.tid; o < kTL * no; o += b.nthr) {
    const int l = o / no;
    if (!t.obs[l * K + s.slot[o % no]]) continue;
    const float* B = t.B + 18 * o;
    const float* Ci = t.Cinv + 9 * l;
    for (int c = 0; c < 6; ++c)
      for (int d = 0; d < 3; ++d)
        t.BC[18 * o + 3 * c + d] = (B[3 * c] * Ci[d] + B[3 * c + 1] * Ci[3 + d]) + B[3 * c + 2] * Ci[6 + d];
  }
  b.sync();
}

// Adds one tile's share to the block's partial sums over the optimisable
// slots; thread tid owns the entries tid, tid + nthr, ... and sums over the
// tile's landmarks in order.
template <class Blk>
PG_HD void tile_accumulate(const Args& a, Blk& b, const Slots& s, Tile& t) {
  const int K = a.K, no = s.n_opt, P = n_part(no);
  for (int e = b.tid; e < P; e += b.nthr) {
    float v = t.acc[e];
    if (e < off_a(no)) {  // A[c][.][.]
      const int c = e / 36, cd = e % 36, k = s.slot[c];
      for (int l = 0; l < kTL; ++l)
        if (t.obs[l * K + k]) v += t.Ac[36 * (l * no + c) + cd];
    } else if (e < off_S(no)) {  // a[c][i]
      const int f = e - off_a(no), c = f / 6, k = s.slot[c];
      for (int l = 0; l < kTL; ++l)
        if (t.obs[l * K + k]) v += t.ac[6 * (l * no + c) + f % 6];
    } else if (e < off_sb(no)) {  // S_off[j][k][r][d] = sum_m BCinv_mj[r] . B_mk[d], k <= j
      const int f = e - off_S(no), pb = f / 36, r = (f % 36) / 6, d = f % 6;
      const int j = s.pj[pb], k = s.pk[pb], sj = s.slot[j], sk = s.slot[k];
      for (int l = 0; l < kTL; ++l) {
        if (!(t.obs[l * K + sj] && t.obs[l * K + sk])) continue;
        const float* x = t.BC + 18 * (l * no + j) + 3 * r;
        const float* y = t.B + 18 * (l * no + k) + 3 * d;
        v += (x[0] * y[0] + x[1] * y[1]) + x[2] * y[2];
      }
    } else if (e < off_nb(no)) {  // sb[c][r] = sum_m BCinv_mc[r] . b_m
      const int f = e - off_sb(no), c = f / 6, r = f % 6, k = s.slot[c];
      for (int l = 0; l < kTL; ++l) {
        if (!t.obs[l * K + k]) continue;
        const float* x = t.BC + 18 * (l * no + c) + 3 * r;
        const float* y = t.b + 3 * l;
        v += (x[0] * y[0] + x[1] * y[1]) + x[2] * y[2];
      }
    } else {  // n_bad
      for (int l = 0; l < kTL; ++l) v += t.bad[l] ? 1.0f : 0.0f;
    }
    t.acc[e] = v;
  }
}

// ba_terms(kTerms): the block's tiles of the landmark list, tile index bid,
// bid + nblk, ..., summed into its partials of the reduced system.
template <class Blk>
PG_HD void terms_block(const Args& a, Blk& b, Slots& s, float* smem, int it) {
  if (it >= *a.stop_at) return;
  load_slots(a, b, s);
  if (b.bid >= s.n_tiles) return;
  const int no = s.n_opt, P = n_part(no);
  Tile t(smem, a.K, no);
  for (int e = b.tid; e < P; e += b.nthr) t.acc[e] = 0.0f;
  for (int tile = b.bid; tile < s.n_tiles; tile += b.nblk) {
    b.sync();  // the previous tile's sums are taken
    tile_blocks(a, b, s, t, kTL * tile);
    tile_accumulate(a, b, s, t);
  }
  b.sync();
  for (int e = b.tid; e < P; e += b.nthr) a.part[(size_t)b.bid * P + e] = t.acc[e];
}

// 4 x 4 product C = A B, each entry a `dot` over the inner index.
PG_HD void mat44(const float* A, const float* B, float* C) {
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) C[4 * i + j] = dot(A + 4 * i, 1, B + j, 4, 4);
}

// utils/geometry.se3_inverse: [R^T, -R^T t]. On the card the plain
// version's product of a 3 x 3 and a 3 x 1 matrix sums each entry of R^T t
// as fmaf(a1, b1, a0 b0) + a2 b2, not as `dot` (cuBLAS's route for that
// shape on the H100; test_torch_cuda's bit-for-bit test holds it); on the
// host as `dot`.
PG_HD float dot3_mv(const float* a, int sa, const float* b, int sb) {
#ifdef __CUDA_ARCH__
  return fmaf(a[sa], b[sb], a[0] * b[0]) + mul_rn(a[2 * sa], b[2 * sb]);
#else
  return dot(a, sa, b, sb, 3);
#endif
}

PG_HD void se3_inverse(const float* T, float* out) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) out[4 * i + j] = T[4 * j + i];
    out[4 * i + 3] = -dot3_mv(T + i, 4, T + 3, 4);
  }
  out[12] = out[13] = out[14] = 0.0f;
  out[15] = 1.0f;
}

// utils/geometry.se3_project: so3_project's two Newton steps of the polar
// decomposition, R <- R (1.5 I - 0.5 R^T R), on the rotation block; the
// translation as it is, the bottom row [0, 0, 0, 1].
PG_HD void se3_project(float* T) {
  float R[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) R[3 * i + j] = T[4 * i + j];
  for (int step = 0; step < 2; ++step) {
    float N[9], out[9];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        float rtr = dot(R + i, 3, R + j, 3, 3);
        N[3 * i + j] = (i == j ? 1.5f : 0.0f) - 0.5f * rtr;
      }
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) out[3 * i + j] = dot(R + 3 * i, 1, N + j, 3, 3);
    for (int i = 0; i < 9; ++i) R[i] = out[i];
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) T[4 * i + j] = R[3 * i + j];
  T[12] = T[13] = T[14] = 0.0f;
  T[15] = 1.0f;
}

// Whether landmark m is active: valid and seen by at least min_obs live
// keyframes of the window.
PG_HD bool lm_active(const Args& a, int m) {
  int n = 0;
  for (int k = 0; k < a.K; ++k) n += a.kf_valid[k] && a.mask[m * a.K + k];
  return a.lm_valid[m] && n >= a.min_obs;
}

// Block 0 of kErrInit: the active slots in ascending order into `list` and
// their count into n_act. A thread takes a run of consecutive slots; a
// block-wide prefix of the runs' counts places each run.
template <class Blk>
PG_HD void build_list(const Args& a, Blk& b) {
  const int per = (a.M + b.nthr - 1) / b.nthr;
  const int m0 = b.tid * per, m1 = m0 + per < a.M ? m0 + per : a.M;
  int n = 0;
  for (int m = m0; m < m1; ++m) n += lm_active(a, m);
  int total;
  int at = b.scan(n, &total);
  for (int m = m0; m < m1; ++m)
    if (lm_active(a, m)) a.list[at++] = m;
  if (b.tid == 0) *a.n_act = total;
}

// ba_terms(kErrInit / kErrFinal), a thread per landmark slot m = bid nthr +
// tid, ...: the masked left-row error sum and the left and right row counts
// (ops/ba.py's err_sums) at the anchored start or the current state (the
// half that `half` names).
// kErrInit also anchors (ops/ba._anchor: lm_active, T_cr = T_cw T_wr with
// T_wr = se3_inverse(T_cw[0]), Xr = T_rw Xw), stores the start as the state
// in the first half and, in block 0, lists the active landmarks and sets
// stop_at = iters (half, the count and the ticket 0).
// kErrFinal also writes back (ops/ba._write_back): T_cw = se3_project(T_cr
// T_rw) on the optimisable slots, Xw = T_wr Xr and the kill rule on the
// active landmarks, everything else copied from the input.
template <class Blk>
PG_HD void err_block(const Args& a, Blk& b, float* smem, int mode) {
  const bool init = mode == kErrInit;
  const int K = a.K;
  const int h = init ? 0 : *a.half;
  const float* Ts = a.T + 16 * K * h;  // the state
  float* Xs = a.X + (size_t)3 * a.M * h;
  float* Tcr = smem;  // [K][16]
  float* Trw = smem + 16 * K;
  float* Twr = Trw + 16;
  if (b.tid == 0) {
    pose_gn::copy16(a.T_cw, Trw);
    se3_inverse(Trw, Twr);
  }
  b.sync();
  if (init) {
    for (int k = b.tid; k < K; k += b.nthr) mat44(a.T_cw + 16 * k, Twr, Tcr + 16 * k);
    b.sync();
    if (b.bid == 0) {
      for (int i = b.tid; i < 16 * K; i += b.nthr) a.T[i] = Tcr[i];
      if (b.tid == 0) {
        *a.stop_at = a.iters;
        *a.live = (int)live_bits(a);
        *a.half = 0;
        *a.n_dy = 0;
        *a.ticket = 0;
      }
      build_list(a, b);
    }
  } else if (b.bid == 0) {
    for (int k = b.tid; k < K; k += b.nthr) {
      float Tk[16];
      if (opt_slot(a, k)) {
        mat44(Ts + 16 * k, Trw, Tk);
        se3_project(Tk);
      } else {
        pose_gn::copy16(a.T_cw + 16 * k, Tk);
      }
      pose_gn::copy16(Tk, a.T_out + 16 * k);
    }
  }
  const float* T = init ? Tcr : Ts;
  float err = 0.0f, n_l = 0.0f, n_r = 0.0f;
  for (int m = b.bid * b.nthr + b.tid; m < a.M; m += b.nthr * b.nblk) {
    const float* Xm = Xs + 3 * m;
    bool act;
    if (init) {
      act = lm_active(a, m);
      a.active[m] = act;
      transform(Trw, a.Xw + 3 * m, a.X + 3 * m);
    } else {
      act = a.active[m];
    }
    if (act) {
      for (int k = 0; k < K; ++k) {
        if (!a.kf_valid[k]) continue;
        if (a.mask[m * K + k]) {
          Rows o;
          float e;
          pair_rows(a, T, Xs, m, k, true, false, o, &e);
          err += e;
          n_l += 1.0f;
        }
        n_r += a.mask_r[m * K + k] ? 1.0f : 0.0f;
      }
    }
    if (!init) {
      float out[3];
      if (act)
        transform(Twr, Xm, out);
      else
        for (int i = 0; i < 3; ++i) out[i] = a.Xw[3 * m + i];
      for (int i = 0; i < 3; ++i) a.X_out[3 * m + i] = out[i];
      a.killed[m] = act && sqrtf(Xm[0] * Xm[0] + Xm[1] * Xm[1] + Xm[2] * Xm[2]) > a.kill_dist;
    }
  }
  err = b.sum(err);
  n_l = b.sum(n_l);
  n_r = b.sum(n_r);
  if (b.tid == 0) {
    float* out = a.err_part + 3 * ((init ? 0 : a.n_blocks) + b.bid);
    out[0] = err;
    out[1] = n_l;
    out[2] = n_r;
  }
}

// A load that reads through to L2: what another block of the launch wrote.
template <class T>
PG_HD T ld_cg(const T* p) {
#ifdef __CUDA_ARCH__
  return __ldcg(p);
#else
  return *p;
#endif
}

// The apply step's decision, by ba_backsub's last block once every block
// has added its landmarks' Xr += dy and its count (thread 0 alone: four
// scalars). The guard: the step was refused before back-substitution
// (`refused`: dx's test or the system's n_bad, and then nothing moved), or
// on one device a listed landmark's dy is not finite (n_dy > 0, an integer
// and so the same in any order); such a step turns the state to the second
// half, T_cr and Xr as they were before it. The early stop: done = bad or
// max |dx| < 1e-5 sets stop_at = it + 1, which the launches of later
// iterations read. The count and the ticket go back to 0 for the next
// iteration's launch.
template <class Blk>
PG_HD void apply_tail(const Args& a, Blk& b, int it, bool refused) {
  if (b.tid != 0) return;
  const int n_dy = ld_cg(a.n_dy);
  const bool bad = refused || (!a.group && n_dy > 0);
  if (bad && !refused) *a.half = 1;
  const float mx = *a.dx_max;
  if (bad || mx < 1e-5f) *a.stop_at = it + 1;
  *a.n_dy = 0;
  *a.ticket = 0;
}

// ba_backsub: dy = Cinv (b - sum_k B_k^T dx_k) over the optimisable slots
// (dx is an exact 0 on the others) for every listed landmark, from the
// blocks that ba_terms stored (`blk`), and Xr += dy, the previous Xr kept in
// X's second half; the count of listed landmarks with a non-finite dy into
// n_dy; and the step's poses. Nothing moves where the step was refused
// before back-substitution.
// A thread per (list position, row): each warp of the grid takes
// Blk::kLmPerWarp consecutive positions (the first warp of every block
// first, so that a short list spreads over the SMs), each thread the sum
// B^T dx of its row, each row's dy from the three rows' b - B^T dx; every
// entry in the plain version's order of operations (the sum over the
// optimisable slots in order, r = 0..5, then (c0 r0 + c1 r1) + c2 r2). Then
// every block, with landmarks or without, takes a ticket, and the last
// decides (`apply_tail`).
template <class Blk>
PG_HD void backsub_block(const Args& a, Blk& b, int it) {
  const int stop_at = *a.stop_at, n_act = *a.n_act;
  const bool refused = *a.step_bad;
  const unsigned opt = opt_bits(a, (unsigned)*a.live);
  if (it >= stop_at) return;
  const int L = Blk::kLmPerWarp, W = b.nwarps() * b.nblk;
  int j, c0;
  b.lm_lane(j, c0);
  const int n = refused ? 0 : n_act;
  for (int q = (b.warp() * b.nblk + b.bid) * L; q < n; q += W * L) {
    const bool on = j < L && q + j < n;
    const int p = on ? q + j : q;  // a lane without a position computes position q's rows, unwritten
    const int m = a.list[p];
    float x[Blk::kRows];
    for (int u = 0; u < Blk::kRows; ++u) x[u] = a.X[3 * m + c0 + u];
    float rhs[3];
    for (int c = c0; c < c0 + Blk::kRows; ++c) {
      // B^T dx's row c over the optimisable slots in order, kChunk slots'
      // B and dx loaded before their products are summed.
      constexpr int kChunk = 4;
      float acc = 0.0f;
      unsigned left = opt;
      for (int o0 = 0; left; o0 += kChunk) {
        float Bv[kChunk][6], dv[kChunk][6];
        int nu = 0;
        for (int u = 0; u < kChunk; ++u) {
          if (!left) continue;
          const int k = lowest(left);
          left &= left - 1u;
          for (int r = 0; r < 6; ++r) {
            Bv[u][r] = blk_at(a, 12 + 18 * (o0 + u) + 3 * r + c, p);
            dv[u][r] = a.dx[6 * k + r];
          }
          nu = u + 1;
        }
        for (int u = 0; u < kChunk; ++u)
          if (u < nu)
            for (int r = 0; r < 6; ++r) acc += Bv[u][r] * dv[u][r];
      }
      b.put_row(rhs, c, blk_at(a, 9 + c, p) - acc);
    }
    bool bad = false;
    for (int u = 0; u < Blk::kRows; ++u) {
      const int i = c0 + u;
      const float ci0 = blk_at(a, 3 * i, p), ci1 = blk_at(a, 3 * i + 1, p), ci2 = blk_at(a, 3 * i + 2, p);
      const float dy = (ci0 * rhs[0] + ci1 * rhs[1]) + ci2 * rhs[2];
      bad = bad || !isfinite(dy);
      if (on) {
        a.X[(size_t)3 * (a.M + m) + i] = x[u];
        a.X[3 * m + i] = x[u] + dy;
      }
    }
    const int n_bad = b.landmarks_with(on && bad);
    if (n_bad > 0 && b.lane() == 0) b.atomic_add(a.n_dy, n_bad);
  }
  // The step's poses, by the grid's last warp (past the landmarks' first
  // pass): T_cr into T's second half, T_new in its place.
  if (!refused && b.bid == b.nblk - 1 && b.warp() == b.nwarps() - 1)
    for (int e = b.lane(); e < 16 * a.K; e += Blk::kWarp) {
      a.T[16 * a.K + e] = a.T[e];
      a.T[e] = a.T_new[e];
    }
  if (b.last(a.ticket)) apply_tail(a, b, it, refused);
}

// What ba_solve keeps in shared memory.
struct SolveShared {
  Slots s;
  float H[kMaxN * kMaxN];  // the equilibrated system's lower triangle, then its Cholesky factor
  float z[kMaxN], y[kMaxN], dinv[kMaxN], ld[kMaxN];
  int fail;
  int bad[kMaxK];
  float mx[kMaxK];
};

// The threads that factor and solve the system: the first warp when the
// system has at most 32 unknowns (lanes own rows, __syncwarp between steps,
// no block barrier), else the whole block.
template <class Blk>
struct Team {
  Blk& b;
  bool warp;
  int tid, nthr;
  PG_HD void sync() {
    if (warp)
      b.warp_sync();
    else
      b.sync();
  }
};

// solve_reduced's Cholesky and triangular solves on the n x n equilibrated
// system (n = 6 n_opt) in sh.H (lower triangle) and sh.z, by 6 x 6 keyframe
// blocks. Per block column, the first warp of the team takes its six
// columns over every row below the diagonal (lanes own rows; per column the
// pivot, the division, the update of the block's later columns, a
// __syncwarp after each), then the team updates the trailing triangle
// entry by entry; one barrier of the team after each. The triangular solves
// are the first warp's alone, a column per __syncwarp. Every entry receives
// the right-looking scalar algorithm's operations in its order, so the
// factor and x are those of a column-by-column Cholesky. A pivot that is not
// > 0 (NaN included) fails it, as cholesky_ex's info != 0 (sh.fail). x ends
// in sh.z.
template <class Team>
PG_HD void chol_solve(Team& t, SolveShared& sh, int n) {
  float* H = sh.H;
  const int nlane = t.nthr < 32 ? t.nthr : 32;
  const bool lane = t.tid < nlane;  // a thread of the first warp
  for (int J = 0; J < n; J += 6) {
    if (lane) {
      for (int j = J; j < J + 6; ++j) {
        const float d = H[j * n + j];
        if (!(d > 0.0f)) {
          if (t.tid == 0) sh.fail = 1;
          break;
        }
        const float l = sqrtf(d);
        if (t.tid == 0) sh.ld[j] = l;
        for (int i = j + 1 + t.tid; i < n; i += nlane) H[i * n + j] = H[i * n + j] / l;
        t.b.warp_sync();
        for (int i = j + 1 + t.tid; i < n; i += nlane)
          for (int c = j + 1; c < J + 6 && c <= i; ++c) H[i * n + c] -= H[i * n + j] * H[c * n + j];
        t.b.warp_sync();
      }
    }
    t.sync();
    if (sh.fail) return;
    const int r0 = J + 6, w = n - r0;
    for (int p = t.tid; p < w * w; p += t.nthr) {
      const int i = r0 + p / w, c = r0 + p % w;
      if (c > i) continue;
      float h = H[i * n + c];
      for (int j = J; j < J + 6; ++j) h -= H[i * n + j] * H[c * n + j];
      H[i * n + c] = h;
    }
    t.sync();
  }
  if (!lane) return;
  for (int j = 0; j < n; ++j) {  // L y = z
    const float yj = sh.z[j] / sh.ld[j];
    if (t.tid == 0) sh.y[j] = yj;
    for (int i = j + 1 + t.tid; i < n; i += nlane) sh.z[i] -= H[i * n + j] * yj;
    t.b.warp_sync();
  }
  for (int j = n - 1; j >= 0; --j) {  // L^T x = y, x into z
    const float xj = sh.y[j] / sh.ld[j];
    if (t.tid == 0) sh.z[j] = xj;
    for (int i = t.tid; i < j; i += nlane) sh.y[i] -= H[j * n + i] * xj;
    t.b.warp_sync();
  }
}

// The sum over G blocks' partials p[0], p[stride], ... in block order, 16
// loads in flight.
PG_HD float sum_blocks(const float* p, int stride, int G) {
  constexpr int kInFlight = 16;
  float s = 0.0f;
  int g = 0;
  for (; g + kInFlight <= G; g += kInFlight) {
    float v[kInFlight];
    for (int u = 0; u < kInFlight; ++u) v[u] = p[(size_t)(g + u) * stride];
    for (int u = 0; u < kInFlight; ++u) s += v[u];
  }
  for (; g < G; ++g) s += p[(size_t)g * stride];
  return s;
}

// ba_solve: kSum sums the used blocks' partials in block order into sys =
// (S, s, n_bad) over the optimisable slots (schur_reduce's damping and
// assembly); kSolve solves sys (solve_reduced) and takes the step's part of
// the guard: dx, step_bad (dx not finite or a translation above
// max_trans_update, or n_bad > 0), max |dx|, and the step's poses T_new =
// add_front_se3(T_cr, dx) on the optimisable slots (ba_backsub takes them).
template <class Blk>
PG_HD void solve_block(const Args& a, Blk& b, SolveShared& sh, int it, int phase) {
  if (it >= *a.stop_at) return;
  Slots& s = sh.s;
  load_slots(a, b, s);
  const int K = a.K, no = s.n_opt, n = 6 * no, np = n_pairs(no);
  if (phase & kSum) {
    const int P = n_part(no), G = used_blocks(a, s.n_act);
    for (int e = b.tid; e < n_sys(no); e += b.nthr) {
      float v;
      if (e < 36 * np) {  // S[j][k] = -S_off + [j == k] (A + lam A I)
        const int pb = e / 36, cd = e % 36;
        v = -sum_blocks(a.part + off_S(no) + e, P, G);
        if (s.pj[pb] == s.pk[pb]) {
          const float A = sum_blocks(a.part + 36 * s.pj[pb] + cd, P, G);
          v = v + (A + (a.lam * A) * (cd / 6 == cd % 6 ? 1.0f : 0.0f));
        }
      } else if (e < 36 * np + 6 * no) {  // s = a - sb
        const int f = e - 36 * np;
        const float av = sum_blocks(a.part + off_a(no) + f, P, G), sb = sum_blocks(a.part + off_sb(no) + f, P, G);
        v = -av - sb;
      } else {
        v = sum_blocks(a.part + off_nb(no), P, G);
      }
      a.sys[e] = v;
    }
    b.sync();
  }
  if (!(phase & kSolve)) return;
  // solve_reduced over the optimisable slots: Jacobi equilibration, + 1e-7 I.
  for (int e = b.tid; e < n * n; e += b.nthr) {
    const int i = e / n, c = e % n, j = i / 6, k = c / 6;
    if (c <= i) sh.H[e] = a.sys[36 * (j * (j + 1) / 2 + k) + 6 * (i % 6) + c % 6];
  }
  if (b.tid == 0) sh.fail = 0;
  b.sync();
  for (int i = b.tid; i < n; i += b.nthr) {
    const float d = sh.H[i * n + i];
    sh.dinv[i] = 1.0f / sqrtf(d < 1e-12f ? 1e-12f : d);
  }
  b.sync();
  for (int e = b.tid; e < n * n; e += b.nthr) {
    const int i = e / n, c = e % n;
    if (c <= i) sh.H[e] = (sh.H[e] * sh.dinv[i]) * sh.dinv[c] + (i == c ? 1e-7f : 0.0f);
  }
  for (int i = b.tid; i < n; i += b.nthr) sh.z[i] = a.sys[36 * np + i] * sh.dinv[i];
  b.sync();
  const bool warp = n <= 32;
  if (!warp || b.tid < 32) {
    Team<Blk> t{b, warp, b.tid, warp && b.nthr > 32 ? 32 : b.nthr};
    chol_solve(t, sh, n);
  }
  b.sync();
  const float n_bad = a.sys[n_sys(no) - 1];
  for (int k = b.tid; k < K; k += b.nthr) {
    const int c = s.cidx[k];
    float d[6];
    for (int r = 0; r < 6; ++r) d[r] = c < 0 ? 0.0f : (sh.fail ? NAN : sh.z[6 * c + r]) * sh.dinv[6 * c + r];
    for (int r = 0; r < 6; ++r) a.dx[6 * k + r] = d[r];
    sh.bad[k] = !finite_n(d, 6) || sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) > a.max_trans_update;
    float mx = 0.0f;
    for (int r = 0; r < 6; ++r) mx = fmaxf(mx, fabsf(d[r]));
    sh.mx[k] = mx;
    float Tk[16];
    pose_gn::copy16(a.T + 16 * k, Tk);
    if (c >= 0) pose_gn::add_front_se3(d, Tk);
    pose_gn::copy16(Tk, a.T_new + 16 * k);
  }
  b.sync();
  bool bad = n_bad > 0.0f;
  float mx = 0.0f;
  for (int k = 0; k < K; ++k) {
    bad = bad || sh.bad[k];
    mx = fmaxf(mx, sh.mx[k]);
  }
  if (b.tid == 0) {
    *a.step_bad = bad;
    *a.dx_max = mx;
  }
}

}  // namespace ba_gn
