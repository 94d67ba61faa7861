// The `ba_*` kernels' algorithm (ba_gn.cuh) as one host thread, for the CPU
// tests: the same three launchers and `ba_layout`, under the same names and
// arguments as ba_gn.cu's (the stream is ignored), each launcher running the
// launch's blocks one after the other with one thread. A block's sum, max
// and prefix over its one thread are the thread's own value, it and 0; the
// warp that factors the reduced system is that thread too; in ba_backsub
// the thread is a warp of one landmark and takes all three rows; the blocks
// take their tickets in block order, so ba_backsub's last block decides.
// tests/test_torch_ba_gn.py builds it with g++ into build/kernels/ and runs
// ops/ba.py's launch sequence on it.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libba_gn_host.so ba_gn_host.cpp

#include <algorithm>
#include <memory>
#include <vector>

#include "ba_gn.cuh"

namespace {

struct HostBlock {
  int tid = 0, nthr = 1, bid = 0, nblk = 1;
  void sync() {}
  void warp_sync() {}
  int lane() const { return 0; }
  int warp() const { return 0; }
  int nwarps() const { return 1; }
  static constexpr int kWarp = 1, kLmPerWarp = 1, kRows = 3;
  void lm_lane(int& j, int& c) const { j = c = 0; }
  void put_row(float* rows, int c, float v) const { rows[c] = v; }
  int landmarks_with(bool f) const { return f ? 1 : 0; }
  void atomic_add(int* p, int v) const { *p += v; }
  float sum(float v) { return v; }
  float max(float v) { return v; }
  bool last(int* ticket) { return (*ticket)++ == nblk - 1; }
  int scan(int v, int* total) {
    *total = v;
    return 0;
  }
};

template <class F>
void blocks(int n, F f) {
  for (int bid = 0; bid < n; ++bid) {
    HostBlock b;
    b.bid = bid;
    b.nblk = n;
    f(b);
  }
}

}  // namespace

extern "C" {

int ba_terms_launch(const ba_gn::Args* a, int it, int mode, void*) {
  std::vector<float> smem(std::max(ba_gn::tile_floats(a->K, ba_gn::max_opt(a->K, a->n_fix)), ba_gn::err_floats(a->K)));
  ba_gn::Slots s;
  blocks(a->n_blocks, [&](HostBlock& b) {
    if (mode == ba_gn::kTerms)
      ba_gn::terms_block(*a, b, s, smem.data(), it);
    else
      ba_gn::err_block(*a, b, smem.data(), mode);
  });
  return 0;
}

int ba_solve_launch(const ba_gn::Args* a, int it, int phase, void*) {
  auto sh = std::make_unique<ba_gn::SolveShared>();
  blocks(1, [&](HostBlock& b) { ba_gn::solve_block(*a, b, *sh, it, phase); });
  return 0;
}

int ba_backsub_launch(const ba_gn::Args* a, int it, void*) {
  blocks(a->n_blocks, [&](HostBlock& b) { ba_gn::backsub_block(*a, b, it); });
  return 0;
}

int ba_layout(int n, int* out, int cap) { return ba_gn::layout(n, out, cap); }

}  // extern "C"
