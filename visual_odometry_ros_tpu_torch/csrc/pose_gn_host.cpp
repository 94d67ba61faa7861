// The `pose_gn` kernel's algorithm (pose_gn.cuh) as one host thread, for
// the CPU tests: the same code path as the kernel, except that the block's
// sums are a serial sum over the points, and a launch's solves run one
// after the other. tests/test_torch_pose_gn.py builds it with g++ into
// build/kernels/ and holds it to the plain PyTorch version.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libpose_gn_host.so pose_gn_host.cpp

#include "pose_gn.cuh"

namespace {

struct HostBlock {
  int tid = 0, nthr = 1;
  template <int K>
  void sum(float (&)[K]) {}  // one thread: its partial sums are the totals
};

}  // namespace

// One solve.
extern "C" int pose_gn_host(const pose_gn::Args* a) {
  HostBlock b;
  pose_gn::run(*a, b);
  return 0;
}

// n solves, as one launch of n blocks takes them: one after the other.
extern "C" int pose_gn_host_many(const pose_gn::Args* a, int n) {
  if (n < 1 || n > pose_gn::kMaxSolves) return 1;
  for (int i = 0; i < n; ++i) pose_gn_host(a + i);
  return 0;
}
