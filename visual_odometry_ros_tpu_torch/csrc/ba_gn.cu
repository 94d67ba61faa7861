// Hand-written Hopper (sm_90a) kernels for the Gauss-Newton loop of
// sliding-window bundle adjustment: ba_terms, ba_solve, ba_backsub (whose
// last block decides the apply step).
//
// Replaces what the JAX package runs on the device as XLA's while loop, not
// a Pallas kernel: the `jax.lax.while_loop(iter_cond, iteration, ...)` of
// ba_solve_impl (visual_odometry_ros_tpu/ops/ba.py:417-419; the body
// `iteration` :379-411 through build_observation_terms, assemble_normal_
// blocks, schur_reduce, solve_reduced and back_substitute; the errors
// `masked_mean_err` :366-372), with the anchoring before it and the
// write-back after it (:348-363, :421-435). A solve is a fixed sequence of
// launches that ops/ba.py enqueues without reading anything back (3 iters +
// 2 on one device): every kernel reads the device-side `stop_at` and returns
// at once from the iteration the loop stopped at, as the while loop would
// not have run it. The algorithm is in ba_gn.cuh, shared with the one-thread
// host version that the CPU tests run.
//
// What bounds it on this card: latency. At the main path's K = 10, M = 4096
// an iteration's operations (the per-observation rows, and the reduced
// system's S_off over pairs of optimisable keyframes a landmark is seen in)
// and bytes (the observations, read once) bound it at well under a
// microsecond; the chain of each iteration is three launches, inside each a
// few dependent steps (chip_smoke.py computes the bound from the masks of
// the recorded problems; PERF.md has both).
//
// What the design does about it:
//   - no host round trip: the anchoring, the stop test, the guard, the pose
//     update and the write-back are device-side; the host enqueues 3 iters +
//     2 launches, and turns three per-block sums into the error and count;
//   - only the active landmarks are walked: the first launch lists them
//     (block 0, a block-wide prefix), the tile launches cut that list into
//     tiles of kTL, and a block with no tile returns at once; the grid is
//     sized to the card, not to M: one block on each SM (ops/ba.py reads
//     the card's SM count; 132 on the H100) (a tile's 42-56 KB of shared
//     memory at K = 8-10 would let 3-4 blocks share an SM, but every block
//     adds its partials to ba_solve's sum: at the dense dryrun window's 256
//     tiles, 2 blocks per SM made ba_terms faster and the sum slower by as
//     much);
//   - only the optimisable slots are summed and solved: a tile's partials
//     hold A, a, sb and the lower block triangle of S_off over them (553
//     floats at the stereo keyframe's 4 slots, 4081 over all 10), C and b
//     still over every observing slot;
//   - ba_terms keeps the per-pair blocks (B, BCinv) in shared memory: a
//     block of kTermThreads threads builds a tile of kTL landmarks and adds
//     its share to per-block partial sums, each entry owned by one thread;
//     it stores only what back-substitution reads, Cinv, b and B over the
//     optimisable slots (12 + 18 n_opt floats a landmark, by list position:
//     ~250 KB at the stereo keyframe, in L2 for the next launch);
//   - ba_backsub reads those blocks and rebuilds nothing: a thread per
//     (listed landmark, row), ten landmarks a warp, spread over the grid's
//     first warps; it updates Xr in place (the previous Xr kept in the
//     state's second half) and counts non-finite dy with one atomic add a
//     warp where there is one; a spare warp takes the step's poses (T_cr
//     kept in the state's second half too). Its blocks take a ticket
//     (atomicAdd) and the last one only decides (the guard, the state's
//     half, the stop test): dx's guard and the system's count come from
//     ba_solve, so only dy's count comes from this launch;
//   - every cross-block sum of floats is taken in block order by one owner
//     (ba_solve sums the partials, 16 loads in flight; the count of
//     non-finite dy is an integer): a relaunch is bit-identical;
//   - ba_solve is one block; the system of the n = 6 n_opt unknowns stays in
//     shared memory. Up to 32 unknowns (both keyframe problems of the main
//     path) one warp factors and solves it, lanes owning rows, with
//     __syncwarp between steps and no block barrier; above, the Cholesky
//     works by 6 x 6 keyframe blocks, two block barriers per block column
//     (the first warp factors the block column, then the block updates the
//     trailing triangle), and the first warp alone runs both triangular
//     solves, one __syncwarp per column.
// Merging launches (a cooperative grid sync) is later work.
//
// Build: ops/kernels.py compiles csrc/*.cu in one nvcc call
//        (-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared,
//        no fast math).

#include <cuda_runtime.h>

#include "ba_gn.cuh"

namespace ba_gn {

constexpr int kTermThreads = 256;
constexpr int kSolveThreads = 512;

struct DeviceBlock {
  int tid, nthr, bid, nblk;
  __device__ DeviceBlock() : tid(threadIdx.x), nthr(blockDim.x), bid(blockIdx.x), nblk(gridDim.x) {}
  __device__ __forceinline__ void sync() { __syncthreads(); }
  __device__ __forceinline__ void warp_sync() { __syncwarp(); }
  __device__ __forceinline__ int lane() const { return tid & 31; }
  __device__ __forceinline__ int warp() const { return tid >> 5; }
  __device__ __forceinline__ int nwarps() const { return nthr >> 5; }

  // ba_backsub's threads: three lanes a landmark, one row each (lanes 30
  // and 31 hold none: landmark kLmPerWarp).
  static constexpr int kWarp = 32, kLmPerWarp = 10, kRows = 1;
  __device__ __forceinline__ void lm_lane(int& j, int& c) const {
    j = lane() / 3;
    c = lane() % 3;
  }
  // Every row's value v of the thread's landmark into rows[0..2], from its
  // three lanes (the calling lane holds row c).
  __device__ __forceinline__ void put_row(float* rows, int c, float v) const {
    const int base = lane() - c;
    rows[0] = __shfl_sync(0xffffffffu, v, base);
    rows[1] = __shfl_sync(0xffffffffu, v, base + 1);
    rows[2] = __shfl_sync(0xffffffffu, v, base + 2);
  }
  // The warp's landmarks with `f` set in any of their lanes.
  __device__ __forceinline__ int landmarks_with(bool f) const {
    const unsigned m = __ballot_sync(0xffffffffu, f);
    int n = 0;
    for (int g = 0; g < kLmPerWarp; ++g) n += (m >> (3 * g)) & 7u ? 1 : 0;
    return n;
  }
  __device__ __forceinline__ void atomic_add(int* p, int v) const { atomicAdd(p, v); }

  // The block's sum of v, in every thread: warp xor shuffles, then the
  // warps' sums in warp order.
  __device__ float sum(float v) {
    __shared__ float part[32];
    const int lane = tid & 31, warp = tid >> 5;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) part[warp] = v;
    __syncthreads();
    float s = 0.0f;
    for (int w = 0; w < (nthr >> 5); ++w) s += part[w];
    __syncthreads();
    return s;
  }

  // The exclusive prefix of v over the block's threads in thread order, and
  // the block's total.
  __device__ int scan(int v, int* total) {
    __shared__ int part[32];
    const int lane = tid & 31, warp = tid >> 5;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) part[warp] = x;
    __syncthreads();
    int before = 0, all = 0;
    for (int w = 0; w < (nthr >> 5); ++w) {
      if (w < warp) before += part[w];
      all += part[w];
    }
    __syncthreads();
    *total = all;
    return before + x - v;
  }

  // The block's max of v, in every thread (fmaxf: the same in any order).
  __device__ float max(float v) {
    __shared__ float part[32];
    const int lane = tid & 31, warp = tid >> 5;
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) part[warp] = v;
    __syncthreads();
    float s = part[0];
    for (int w = 1; w < (nthr >> 5); ++w) s = fmaxf(s, part[w]);
    __syncthreads();
    return s;
  }

  // Whether this block is the launch's last to get here: every thread's
  // writes are fenced to the device, then the block takes a ticket; the
  // last block fences again before it reads what the others wrote.
  __device__ bool last(int* ticket) {
    __shared__ int is_last;
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(ticket, 1) == nblk - 1;
    __syncthreads();
    const bool l = is_last;
    if (l) __threadfence();
    return l;
  }
};

__global__ void __launch_bounds__(kTermThreads, 2) ba_terms_kernel(const Args a, int it, int mode) {
  extern __shared__ float smem[];
  __shared__ Slots s;
  DeviceBlock b;
  if (mode == kTerms)
    terms_block(a, b, s, smem, it);
  else
    err_block(a, b, smem, mode);
}

__global__ void __launch_bounds__(kSolveThreads, 1) ba_solve_kernel(const Args a, int it, int phase) {
  __shared__ SolveShared sh;
  DeviceBlock b;
  solve_block(a, b, sh, it, phase);
}

__global__ void __launch_bounds__(kTermThreads) ba_backsub_kernel(const Args a, int it) {
  DeviceBlock b;
  backsub_block(a, b, it);
}

// The tile kernel uses more than 48 KB of dynamic shared memory at large K:
// opt in once, for the largest window.
cudaError_t opt_in() {
  static cudaError_t rc = [] {
    int bytes = tile_floats(kMaxK, kMaxK) * (int)sizeof(float);
    return cudaFuncSetAttribute(ba_terms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }();
  return rc;
}

size_t tile_bytes(const Args* a) { return tile_floats(a->K, max_opt(a->K, a->n_fix)) * sizeof(float); }

}  // namespace ba_gn

extern "C" {

// Each launcher enqueues one launch on `stream` and returns its cudaError_t
// (0 on success). `a` is copied into the launch's parameters.

int ba_terms_launch(const ba_gn::Args* a, int it, int mode, void* stream) {
  cudaError_t e = ba_gn::opt_in();
  if (e != cudaSuccess) return (int)e;
  size_t smem = mode == ba_gn::kTerms ? ba_gn::tile_bytes(a) : ba_gn::err_floats(a->K) * sizeof(float);
  ba_gn::ba_terms_kernel<<<a->n_blocks, ba_gn::kTermThreads, smem, (cudaStream_t)stream>>>(*a, it, mode);
  return (int)cudaGetLastError();
}

int ba_solve_launch(const ba_gn::Args* a, int it, int phase, void* stream) {
  ba_gn::ba_solve_kernel<<<1, ba_gn::kSolveThreads, 0, (cudaStream_t)stream>>>(*a, it, phase);
  return (int)cudaGetLastError();
}

int ba_backsub_launch(const ba_gn::Args* a, int it, void* stream) {
  ba_gn::ba_backsub_kernel<<<a->n_blocks, ba_gn::kTermThreads, 0, (cudaStream_t)stream>>>(*a, it);
  return (int)cudaGetLastError();
}

// ba_gn.cuh's layout at n optimisable slots (ops/ba.py checks it against its
// own at bind time).
int ba_layout(int n, int* out, int cap) { return ba_gn::layout(n, out, cap); }

// How each launch of a window of K slots (n_fix fixed) sits on the card:
// per launch (ba_terms' tile mode, ba_terms' error modes, ba_solve,
// ba_backsub with its decision) its registers per thread, static and dynamic
// shared bytes per block, threads per block and resident blocks per SM.
// Writes 20 ints; returns a cudaError_t.
int ba_occupancy(int K, int n_fix, int* out) {
  cudaError_t e = ba_gn::opt_in();
  if (e != cudaSuccess) return (int)e;
  ba_gn::Args a{};
  a.K = K;
  a.n_fix = n_fix;
  const void* fns[4] = {(const void*)ba_gn::ba_terms_kernel, (const void*)ba_gn::ba_terms_kernel,
                        (const void*)ba_gn::ba_solve_kernel, (const void*)ba_gn::ba_backsub_kernel};
  const int threads[4] = {ba_gn::kTermThreads, ba_gn::kTermThreads, ba_gn::kSolveThreads, ba_gn::kTermThreads};
  const size_t dyn[4] = {ba_gn::tile_bytes(&a), ba_gn::err_floats(K) * sizeof(float), 0, 0};
  for (int i = 0; i < 4; ++i) {
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, fns[i]);
    if (e != cudaSuccess) return (int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[i], threads[i], dyn[i]);
    if (e != cudaSuccess) return (int)e;
    int* o = out + 5 * i;
    o[0] = attr.numRegs;
    o[1] = (int)attr.sharedSizeBytes;
    o[2] = (int)dyn[i];
    o[3] = threads[i];
    o[4] = blocks;
  }
  return 0;
}

}  // extern "C"
