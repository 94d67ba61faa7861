// The `pose_gn` kernel's algorithm (pose_gn.cuh) as one host thread, for
// the CPU tests: the same code path as the kernel, except that the block's
// sums are a serial sum over the points. tests/test_torch_pose_gn.py builds
// it with g++ into build/kernels/ and holds it to the plain PyTorch version.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libpose_gn_host.so pose_gn_host.cpp

#include "pose_gn.cuh"

namespace {

struct HostBlock {
  int tid = 0, nthr = 1;
  void sync() {}
  template <int K>
  void sum(float (&)[K]) {}  // one thread: its partial sums are the totals
};

}  // namespace

extern "C" int pose_gn_host(const pose_gn::Args* a) {
  HostBlock b;
  pose_gn::Shared sh;
  pose_gn::run(*a, b, sh);
  return 0;
}
