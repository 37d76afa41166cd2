// Fused rollout tick for Hopper (sm_90a): per-node delay curve, Erlang(2)
// runqlat draw and node histogram in one pass.
//
// Replaces repro/kernels/rollout_tick.py::fused_tick (body _tick_kernel,
// _node_delay), the TPU kernel behind batched_rollout(use_pallas=True).
//
// Computes, for every node row r of R (inputs packed by
// cluster/state.py::_tick_fused):
//   d[r]       = clip((base + scale*rho*rho / max(1-rho, knee))
//                     * (1 + slope*max(threads/cores - 1, 0))
//                     * exp(0.13*noise), 0, clip_max)
//   mean[r, s] = d[r] * max(jit[r, s], 0.3)
//   x          = -log(u1[r, i] * u2[r, i]) * (mean[r, i / K] / gamma_shape)
//   hist[r, b] = sum of act[r, i / K] over the samples i whose x lands in
//                bin b = clamp(floor(x / 5), 0, 199)
//
// Bound: bytes.  A row moves at most 2,796 B (nodev 32, jit 56, act 56,
// u1 896 and u2 896 in; hist 800, delay 4, mean 56 out): 55.9 MB and
// 16.7 us at 3.35 TB/s for the 20,000 rows of a 20-seed x 1,000-node
// batched tick.  The uniforms of inactive slots are never read, so the
// data's own bound is lower.  Each sample costs about ten float operations,
// far below the byte bound.
//
// Design: the TPU kernel's one-hot x weights MXU contraction has no use
// here.  One warp owns one node row, eight rows to a block.  Every lane
// recomputes the row's delay from the eight packed floats in registers, so
// no barrier is needed before the draw; lanes stride over the row's S*K
// samples (consecutive lanes, consecutive addresses), skip zero weights,
// and bin into the warp's own 200-float shared histogram with shared
// atomics.  The histogram is zeroed and written out whole, so the output
// needs no memset and each row is written once, coalesced.  Any R works:
// a warp past the last row does nothing, and only __syncwarp is used.
//
// Exactness: the arithmetic uses __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn in the plain version's order, so nvcc cannot contract a
// multiply and an add into one FMA (torch's separate elementwise kernels
// round each step); rho*rho is a product, not a pow; logf and expf are the
// full-precision ones (never --use_fast_math).  Binning is IEEE division by
// 5.0f, floor, clamp in float, then the integer cast, as in
// runqlat_hist.cu.  With 0/1 weights the counts are exact whatever order
// the atomics land in.
#include <cuda_runtime.h>

namespace {

constexpr int kNumBins = 200;
constexpr float kBinWidth = 5.0f;
constexpr int kRowsPerBlock = 8;  // one warp per row
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr int kNodeFields = 8;

__device__ __forceinline__ float node_delay(const float* v, float clip_max) {
  const float rho = v[0], threads = v[1], cores = v[2], base = v[3];
  const float scale = v[4], knee = v[5], slope = v[6], noise = v[7];
  float d = __fadd_rn(
      base, __fdiv_rn(__fmul_rn(__fmul_rn(scale, rho), rho),
                      fmaxf(__fsub_rn(1.0f, rho), knee)));
  const float over = fmaxf(__fsub_rn(__fdiv_rn(threads, cores), 1.0f), 0.0f);
  d = __fmul_rn(d, __fadd_rn(1.0f, __fmul_rn(slope, over)));
  d = __fmul_rn(d, expf(__fmul_rn(0.13f, noise)));
  return fminf(fmaxf(d, 0.0f), clip_max);
}

__global__ void rollout_tick_kernel(
    const float* __restrict__ nodev, const float* __restrict__ jit,
    const float* __restrict__ act, const float* __restrict__ u1,
    const float* __restrict__ u2, float* __restrict__ hist_out,
    float* __restrict__ delay_out, float* __restrict__ mean_out, int rows,
    int slots, int k, float gamma_shape, float clip_max) {
  __shared__ float hist[kRowsPerBlock][kNumBins];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;  // whole warps only: no block barrier below

  float* h = hist[warp];
  for (int i = lane; i < kNumBins; i += 32) h[i] = 0.0f;
  __syncwarp();

  const float d = node_delay(nodev + static_cast<long long>(row) * kNodeFields,
                             clip_max);
  const long long srow = static_cast<long long>(row) * slots;
  const float* jr = jit + srow;
  const float* ar = act + srow;
  if (lane == 0) delay_out[row] = d;
  for (int s = lane; s < slots; s += 32)
    mean_out[srow + s] = __fmul_rn(d, fmaxf(jr[s], 0.3f));

  const int n = slots * k;
  const float* p1 = u1 + static_cast<long long>(row) * n;
  const float* p2 = u2 + static_cast<long long>(row) * n;
  for (int i = lane; i < n; i += 32) {
    const int s = i / k;
    const float w = ar[s];
    if (w == 0.0f) continue;
    const float mean = __fmul_rn(d, fmaxf(jr[s], 0.3f));
    const float g = -logf(__fmul_rn(p1[i], p2[i]));
    const float x = __fmul_rn(g, __fdiv_rn(mean, gamma_shape));
    float b = floorf(__fdiv_rn(x, kBinWidth));
    b = fminf(fmaxf(b, 0.0f), static_cast<float>(kNumBins - 1));
    atomicAdd(&h[static_cast<int>(b)], w);
  }
  __syncwarp();

  float* dst = hist_out + static_cast<long long>(row) * kNumBins;
  for (int i = lane; i < kNumBins; i += 32) dst[i] = h[i];
}

}  // namespace

// nodev (rows, 8); jit, act (rows, slots); u1, u2 (rows, slots*k); all
// float32 and contiguous.  hist (rows, 200), delay (rows,), mean
// (rows, slots) float32.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int rollout_tick_launch(const void* nodev, const void* jit,
                                   const void* act, const void* u1,
                                   const void* u2, void* hist, void* delay,
                                   void* mean, int rows, int slots, int k,
                                   float gamma_shape, float clip_max,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rollout_tick_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(nodev), static_cast<const float*>(jit),
      static_cast<const float*>(act), static_cast<const float*>(u1),
      static_cast<const float*>(u2), static_cast<float*>(hist),
      static_cast<float*>(delay), static_cast<float*>(mean), rows, slots, k,
      gamma_shape, clip_max);
  return static_cast<int>(cudaGetLastError());
}
