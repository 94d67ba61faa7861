// Hand-written Hopper (sm_90a) kernels for the Gauss-Newton loop of
// sliding-window bundle adjustment: ba_terms, ba_solve, ba_backsub, ba_apply.
//
// Replaces what the JAX package runs on the device as XLA's while loop, not
// a Pallas kernel: the `jax.lax.while_loop(iter_cond, iteration, ...)` of
// ba_solve_impl (visual_odometry_ros_tpu/ops/ba.py:417-419; the body
// `iteration` :379-411 through build_observation_terms, assemble_normal_
// blocks, schur_reduce, solve_reduced and back_substitute; the errors
// `masked_mean_err` :366-372). A solve is a fixed sequence of launches that
// ops/ba.py enqueues without reading anything back (4 iters + 2 on one
// device): every kernel reads the device-side `stop_at` and returns at once
// from the iteration the loop stopped at, as the while loop would not have
// run it. The algorithm is in ba_gn.cuh, shared with the one-thread host
// version that the CPU tests run.
//
// What bounds it on this card: latency. At the main path's K = 10, M = 4096
// an iteration's operations (the per-observation rows, and the reduced
// system's S_off, 36 dot products of 3 per unordered pair of optimisable
// keyframes a landmark is seen in) and bytes (the observations, read once)
// bound it at a few microseconds;
// the chain of each iteration is four launches, and inside ba_solve the
// Cholesky's 60 dependent columns with two barriers each (chip_smoke.py
// computes the bound from the masks of the recorded problems; PERF.md has
// both).
//
// What the design does about it:
//   - no host round trip: the stop test, the guard and the pose update are
//     device-side; the host enqueues 4 iters + 2 launches and returns;
//   - ba_terms never writes the per-pair blocks (B, BCinv: 2 x 2.9 MB at the
//     main path's size) to device memory: a block of kTermThreads threads
//     builds a tile of kTL landmarks in shared memory, skips the masked
//     (landmark, keyframe) pairs, and adds the tile's share of A, a, S_off,
//     sb to per-block partial sums, each entry owned by one thread (no
//     atomics); ba_backsub rebuilds the tile's blocks from the same inputs
//     with the same code, bit for bit;
//   - every cross-block sum is taken in block order by one owner (ba_solve
//     sums the partials, ba_apply the counts): a relaunch is bit-identical;
//   - ba_solve is one block: the 6K x 6K system stays in shared memory for
//     the equilibration, the right-looking Cholesky and both triangular
//     solves.
// Merging launches (a cooperative grid sync) and tuning the tile are later
// work.
//
// Build: ops/kernels.py compiles csrc/*.cu in one nvcc call
//        (-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared,
//        no fast math).

#include <cuda_runtime.h>

#include "ba_gn.cuh"

namespace ba_gn {

constexpr int kTermThreads = 256;
constexpr int kSolveThreads = 512;
constexpr int kApplyThreads = 256;

struct DeviceBlock {
  int tid, nthr, bid, nblk;
  __device__ DeviceBlock() : tid(threadIdx.x), nthr(blockDim.x), bid(blockIdx.x), nblk(gridDim.x) {}
  __device__ __forceinline__ void sync() { __syncthreads(); }
};

__global__ void __launch_bounds__(kTermThreads) ba_terms_kernel(const Args a, int it, int mode) {
  extern __shared__ float smem[];
  DeviceBlock b;
  terms_block(a, b, smem, it, mode);
}

__global__ void __launch_bounds__(kSolveThreads, 1) ba_solve_kernel(const Args a, int it, int phase) {
  __shared__ SolveShared sh;
  DeviceBlock b;
  solve_block(a, b, sh, it, phase);
}

__global__ void __launch_bounds__(kTermThreads) ba_backsub_kernel(const Args a, int it) {
  extern __shared__ float smem[];
  DeviceBlock b;
  backsub_block(a, b, smem, it);
}

__global__ void __launch_bounds__(kApplyThreads) ba_apply_kernel(const Args a, int it) {
  DeviceBlock b;
  apply_block(a, b, it);
}

// The tile kernels use more than 48 KB of dynamic shared memory at large K:
// opt in once, for the largest window.
cudaError_t opt_in() {
  static cudaError_t rc = [] {
    int bytes = tile_floats(kMaxK) * (int)sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(ba_terms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(ba_backsub_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }();
  return rc;
}

}  // namespace ba_gn

extern "C" {

// Each launcher enqueues one launch on `stream` and returns its cudaError_t
// (0 on success). `a` is copied into the launch's parameters.

int ba_terms_launch(const ba_gn::Args* a, int it, int mode, void* stream) {
  cudaError_t e = ba_gn::opt_in();
  if (e != cudaSuccess) return (int)e;
  size_t smem = ba_gn::tile_floats(a->K) * sizeof(float);
  ba_gn::ba_terms_kernel<<<a->n_blocks, ba_gn::kTermThreads, smem, (cudaStream_t)stream>>>(*a, it, mode);
  return (int)cudaGetLastError();
}

int ba_solve_launch(const ba_gn::Args* a, int it, int phase, void* stream) {
  ba_gn::ba_solve_kernel<<<1, ba_gn::kSolveThreads, 0, (cudaStream_t)stream>>>(*a, it, phase);
  return (int)cudaGetLastError();
}

int ba_backsub_launch(const ba_gn::Args* a, int it, void* stream) {
  cudaError_t e = ba_gn::opt_in();
  if (e != cudaSuccess) return (int)e;
  size_t smem = ba_gn::tile_floats(a->K) * sizeof(float);
  ba_gn::ba_backsub_kernel<<<a->n_blocks, ba_gn::kTermThreads, smem, (cudaStream_t)stream>>>(*a, it);
  return (int)cudaGetLastError();
}

int ba_apply_launch(const ba_gn::Args* a, int it, void* stream) {
  int grid = (3 * a->M + ba_gn::kApplyThreads - 1) / ba_gn::kApplyThreads;
  ba_gn::ba_apply_kernel<<<grid > 0 ? grid : 1, ba_gn::kApplyThreads, 0, (cudaStream_t)stream>>>(*a, it);
  return (int)cudaGetLastError();
}

// ba_gn.cuh's layout at K (ops/ba.py checks it against its own at bind time).
int ba_layout(int K, int* out, int cap) { return ba_gn::layout(K, out, cap); }

}  // extern "C"
