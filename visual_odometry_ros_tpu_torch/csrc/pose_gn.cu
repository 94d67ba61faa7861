// Hand-written Hopper (sm_90a) kernel for the pose-only Gauss-Newton solve.
//
// Replaces what the JAX package runs on the device as XLA's while loop, not
// a Pallas kernel: the `jax.lax.while_loop` of _pose_gn_core
// (visual_odometry_ros_tpu/ops/pose_gn.py:87-121), with the code around it
// in pose_only_gn_mono (:124), pose_only_gn_stereo (:157), _reproj_err_px
// (:210) and the two-pass robust wrappers pose_only_gn_stereo_robust (:223)
// and pose_only_gn_mono_robust (:310). One launch computes a whole solve,
// one pass (PnP's polish) or two (robust), with no host round trip: the
// stop test `it < max_iters && !done` is read by the block, not the host.
// The algorithm is in pose_gn.cuh, shared with the one-thread host version
// that the CPU tests run.
//
// What bounds it on this card: latency. A solve is a chain of up to
// max_iters (100) dependent iterations per pass, two passes when robust,
// and each iteration is residuals over N points, a block-wide sum of 28
// floats, then one thread's 6x6 Cholesky, two triangular solves and an SE(3)
// exponential. The operations (~300 fp32 per stereo point and iteration)
// and bytes (~36 per point, read once) of the main path's N = 1024 solve
// bound it at a few microseconds on the 67 TFLOP/s and 3.35 TB/s of the
// card, far below the chain (chip_smoke.py computes the bound from the
// iterations its inputs need; PERF.md has both).
//
// What the design does about it:
//   - one block of kThreads threads per solve; a thread evaluates the points
//     i = tid, tid + kThreads, ... (N = 1024 stereo: two points each) and
//     keeps its 28 partial sums in registers, so an iteration's work is one
//     short pass over registers and L1-resident inputs;
//   - the sums cross the block in a fixed order (warp xor shuffles, lane 0
//     of each warp to shared memory, then 28 threads each add the warps'
//     partials in warp order), two barriers per iteration: every launch on
//     the same inputs is bit-identical;
//   - thread 0 forms the step (damping, Cholesky, triangular solves, the
//     bad test, se3_exp, the stop test) and publishes the pose and the stop
//     flag through shared memory; the loop condition is block-uniform;
//   - the robust wrapper's gate, counts and arbitration run in the same
//     launch, so the whole pose stage is one launch and no host sync.
// Batching solves (one block each) and the block shape are later work.
//
// Build: ops/kernels.py compiles csrc/*.cu in one nvcc call
//        (-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared,
//        no fast math: sinf, cosf and sqrtf round as PyTorch's do).

#include <cuda_runtime.h>

#include "pose_gn.cuh"

namespace pose_gn {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct DeviceBlock {
  int tid, nthr;
  float (*partial)[kSums];  // [kWarps][kSums] in shared memory
  float* red;               // [kSums] in shared memory

  __device__ __forceinline__ void sync() { __syncthreads(); }

  // Block-wide sums of v[0..K), returned in v to every thread, added in a
  // fixed order.
  template <int K>
  __device__ __forceinline__ void sum(float (&v)[K]) {
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float x = v[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      v[k] = x;
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) partial[warp][k] = v[k];
    }
    __syncthreads();
    if (tid < K) {
      float s = 0.0f;
      for (int w = 0; w < kWarps; ++w) s += partial[w][tid];
      red[tid] = s;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = red[k];
  }
};

__global__ void __launch_bounds__(kThreads, 1) pose_gn_kernel(const Args a) {
  __shared__ Shared sh;
  __shared__ float partial[kWarps][kSums];
  DeviceBlock b{(int)threadIdx.x, kThreads, partial, sh.red};
  run(a, b, sh);
}

}  // namespace pose_gn

extern "C" {

// One solve per launch: one block of kThreads threads on `stream`.
// Returns the launch's cudaError_t (0 on success).
int pose_gn_launch(const pose_gn::Args* a, void* stream) {
  pose_gn::pose_gn_kernel<<<1, pose_gn::kThreads, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
