// Hand-written Hopper (sm_90a) kernel for the pose-only Gauss-Newton solve.
//
// Replaces what the JAX package runs on the device as XLA's while loop, not
// a Pallas kernel: the `jax.lax.while_loop` of _pose_gn_core
// (visual_odometry_ros_tpu/ops/pose_gn.py:87-121), with the code around it
// in pose_only_gn_mono (:124), pose_only_gn_stereo (:157), _reproj_err_px
// (:210) and the two-pass robust wrappers pose_only_gn_stereo_robust (:223)
// and pose_only_gn_mono_robust (:310). One block computes a whole solve,
// one pass (PnP's polish) or two (robust), with no host round trip: the
// stop test `it < max_iters && !done` is read by the block, not the host.
// A launch takes up to kMaxSolves independent solves, one block each
// (pnp_ransac's two polishes). The algorithm is in pose_gn.cuh, shared
// with the one-thread host version that the CPU tests run.
//
// What bounds it on this card: latency. A solve is a chain of up to
// max_iters (100) dependent iterations per pass, two passes when robust,
// and each iteration is residuals over N points, a block-wide sum of 28
// floats and the count, then a 6x6 Cholesky, two triangular solves and an
// SE(3) exponential. The operations (~300 fp32 per stereo point and
// iteration) and bytes (~36 per point, read once) of the main path's
// N = 1024 solve bound it at a few microseconds on the 67 TFLOP/s and
// 3.35 TB/s of the card, far below the chain (chip_smoke.py computes the
// bound from the iterations its inputs need; PERF.md has both).
//
// What the design does about the chain of an iteration:
//   - a thread evaluates the points i = tid, tid + threads, ... and keeps
//     its partial sums in registers;
//   - the block sum: each warp reduce-scatters its 29 values (padded to
//     32) by recursive halving, 31 xor shuffles after which lane l holds
//     the warp's sum of value l; lane l stores it, one barrier, lane l adds
//     the warps' values l in warp order and the warp reads the totals back
//     from shared memory as float4s. The partials are double-buffered, so
//     this is the iteration's only barrier; the order is fixed, so every
//     launch on the same inputs is bit-identical;
//   - every thread takes the step itself from the same totals (damping,
//     the 6x6 factor, the solves, se3_exp, the stop test), so every thread
//     holds the same pose bit for bit: no thread waits for another to
//     publish it, and no barrier follows. The factor divides by each pivot
//     as before: multiplying by its reciprocal rounds otherwise, and that
//     alone moved the 200-frame plain leg's stereo ATE off the parent's
//     (PERF.md §6);
//   - the robust wrapper's gate, counts and arbitration run in the same
//     launch, four walks and three sums outside the iterations.
// Threads per block: kThreads = 256, the fastest of 128 / 256 / 512 on the
// recorded pose inputs (PERF.md has the table; `kernel_split --threads`
// re-times other sizes in an edited copy): the step is issued by every
// warp, so more warps per scheduler lengthen it, fewer lengthen the walk.
//
// Build: ops/kernels.py compiles csrc/*.cu in one nvcc call
//        (-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared,
//        no fast math: sinf, cosf and sqrtf round as PyTorch's do).

#include <cuda_runtime.h>

#include "pose_gn.cuh"

namespace pose_gn {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Batch {
  Args a[kMaxSolves];
};

struct DeviceBlock {
  int tid, nthr, lane, warp, buf;
  float (*partial)[kWarps][32];  // [2][kWarps][32] in shared memory: lane l's warp sum of value l
  float4 (*tot)[8];              // [kWarps][8] in shared memory: a warp's totals

  // One halving step: lanes with bit O set keep values [O, 2 O), the others
  // [0, O); each adds its partner's half. Values from K on are zero
  // everywhere and are skipped.
  template <int O, int K>
  __device__ __forceinline__ void halve(float (&w)[32]) const {
    const bool upper = lane & O;
#pragma unroll
    for (int k = 0; k < O && k < K; ++k) {
      const float send = upper ? w[k] : w[k + O];
      const float keep = upper ? w[k + O] : w[k];
      w[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
  }

  // Block-wide sums of v[0..K), returned in v to every thread, added in a
  // fixed order.
  template <int K>
  __device__ __forceinline__ void sum(float (&v)[K]) {
    static_assert(K <= 32, "a warp reduce-scatters at most 32 values");
    float w[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) w[k] = k < K ? v[k] : 0.0f;
    halve<16, K>(w);
    halve<8, K>(w);
    halve<4, K>(w);
    halve<2, K>(w);
    halve<1, K>(w);
    if (lane < K) partial[buf][warp][lane] = w[0];
    __syncthreads();
    float s = 0.0f;
    if (lane < K) {
#pragma unroll
      for (int q = 0; q < kWarps; ++q) s += partial[buf][q][lane];
    }
    buf ^= 1;  // the next sum writes the other buffer: no barrier after the reads
    reinterpret_cast<float*>(tot[warp])[lane] = s;
    __syncwarp();
#pragma unroll
    for (int k4 = 0; k4 < (K + 3) / 4; ++k4) {
      const float4 q = tot[warp][k4];
      v[4 * k4] = q.x;
      if (4 * k4 + 1 < K) v[4 * k4 + 1] = q.y;
      if (4 * k4 + 2 < K) v[4 * k4 + 2] = q.z;
      if (4 * k4 + 3 < K) v[4 * k4 + 3] = q.w;
    }
  }
};

__global__ void __launch_bounds__(kThreads, 1) pose_gn_kernel(const Batch batch) {
  __shared__ float partial[2][kWarps][32];
  __shared__ float4 tot[kWarps][8];
  DeviceBlock b{(int)threadIdx.x, kThreads, (int)threadIdx.x & 31, (int)threadIdx.x >> 5, 0, partial, tot};
  const Args a = batch.a[blockIdx.x];
  run(a, b);
}

}  // namespace pose_gn

extern "C" {

// n solves (1 <= n <= kMaxSolves) in one launch on `stream`: block i solves
// a[i]. Returns the launch's cudaError_t (0 on success).
int pose_gn_launch(const pose_gn::Args* a, int n, void* stream) {
  if (n < 1 || n > pose_gn::kMaxSolves) return (int)cudaErrorInvalidValue;
  pose_gn::Batch batch{};
  for (int i = 0; i < n; ++i) batch.a[i] = a[i];
  pose_gn::pose_gn_kernel<<<n, pose_gn::kThreads, 0, (cudaStream_t)stream>>>(batch);
  return (int)cudaGetLastError();
}

}  // extern "C"
