// Weighted 200x5 runqlat histogram for Hopper (sm_90a).
//
// Replaces repro/kernels/runqlat_hist.py::runqlat_hist_pallas (body
// _hist_kernel), the TPU kernel form of repro.core.metric.histogram.
//
// Computes, for every series s of S: out[s, b] = sum of weights[s, i] over
// the samples i with clamp(floor(samples[s, i] / 5), 0, 199) == b.
//
// Bound: bytes.  Each sample costs a divide, a floor, two clamps and one
// shared-memory atomic; there is no reuse to exploit.  On the simulator's
// main path at 1,000 nodes one tick bins 8,000 online and 6,000 offline
// series of 16 samples: 1.79 MB of samples and weights in, 11.2 MB of
// histograms out, about 3.9 us for both launches at 3.35 TB/s.  At that
// size the launch overhead dominates, not the bandwidth.
//
// Design: the TPU kernel's one-hot x ones MXU contraction has no use here.
// A block takes a run of `series_per_block` consecutive series and keeps
// one 200-float shared-memory histogram per series.  The block zeroes it,
// fills it with shared atomics, and writes it out whole, so the output
// needs no separate memset and each output row is written exactly once,
// coalesced (consecutive series are consecutive rows).
//
// Binning matches metric.histogram bit for bit: IEEE division by 5.0f
// (never a multiply by 0.2, never --use_fast_math), floor, clamp in float
// to [0, 199], and only then the integer cast.  A weight of exactly zero
// adds nothing, so padding and inactive slots cannot leak.  With 0/1
// weights (the main path) the counts are small integers and the result is
// exact whatever order the atomics land in; with general float weights the
// order of the additions varies from run to run (a few float32 ulps).
#include <cuda_runtime.h>

namespace {

constexpr int kNumBins = 200;
constexpr float kBinWidth = 5.0f;
constexpr int kThreads = 256;

__global__ void runqlat_hist_kernel(const float* __restrict__ samples,
                                    const float* __restrict__ weights,
                                    float* __restrict__ out, int num_series,
                                    int n, int series_per_block) {
  extern __shared__ float hist[];  // series_per_block * kNumBins floats
  const int s0 = blockIdx.x * series_per_block;
  const int ns = min(series_per_block, num_series - s0);
  const int bins = ns * kNumBins;
  for (int i = threadIdx.x; i < bins; i += blockDim.x) hist[i] = 0.0f;
  __syncthreads();

  const float* s = samples + static_cast<long long>(s0) * n;
  const float* w = weights ? weights + static_cast<long long>(s0) * n : nullptr;
  const int count = ns * n;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const float wi = w ? w[i] : 1.0f;
    if (wi == 0.0f) continue;
    float b = floorf(s[i] / kBinWidth);
    b = fminf(fmaxf(b, 0.0f), static_cast<float>(kNumBins - 1));
    atomicAdd(&hist[(i / n) * kNumBins + static_cast<int>(b)], wi);
  }
  __syncthreads();

  float* dst = out + static_cast<long long>(s0) * kNumBins;
  for (int i = threadIdx.x; i < bins; i += blockDim.x) dst[i] = hist[i];
}

}  // namespace

// samples, weights: (num_series, n) float32, contiguous; weights may be
// null (all ones).  out: (num_series, 200) float32.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int runqlat_hist_launch(const void* samples, const void* weights,
                                   void* out, int num_series, int n,
                                   int series_per_block, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (num_series + series_per_block - 1) / series_per_block;
  const size_t smem =
      static_cast<size_t>(series_per_block) * kNumBins * sizeof(float);
  runqlat_hist_kernel<<<blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(samples), static_cast<const float*>(weights),
      static_cast<float*>(out), num_series, n, series_per_block);
  return static_cast<int>(cudaGetLastError());
}
