// Weighted 200x5 runqlat histograms for Hopper (sm_90a), several sets of
// series in one launch.
//
// Replaces repro/kernels/runqlat_hist.py::runqlat_hist_pallas (body
// _hist_kernel), the TPU kernel form of repro.core.metric.histogram.
//
// Computes, for every segment g and every series s of it: out_g[s, b] =
// sum of weights_g[s, i] over the samples i with clamp(floor(samples_g[s,
// i] / 5), 0, 199) == b.  A segment is a (S, n) set of samples with its
// weights (or none: all ones) and its (S, 200) output, each input with a
// stride per axis; weights may have stride 0 along the sample axis, so a
// per-series mask is read where it lies and never widened to (S, n).
//
// Bound: bytes.  On the simulator's main path at 1,000 nodes one tick bins
// 8,000 online and 6,000 offline series of 16 samples: 0.9 MB of samples
// and 56 KB of per-series weights in, 11.2 MB of histograms out, about 3.6
// us at 3.35 TB/s.  The output is nearly all of it.  The tick calls this
// once for both sets (one launch, not one per set): on that path the host's
// launches, not the device, set the time.
//
// Design.  All arguments are one HistArgs struct passed by value (the
// wrapper builds it once per layout and re-points it each call); the
// launch gives every segment its own run of blocks.
// * Short series (n <= 32; the main path's n is 16): a warp per series, no
//   shared memory.  Lane i holds sample i's bin and weight.  The 200-bin
//   row is 50 float4; lane j owns float4 j and j + 32.  The warp walks the
//   series' samples in order, broadcasting each (bin, weight) by shuffles,
//   and the owning lane adds the weight: every bin's sum is formed in
//   sample order, so the result is deterministic and equals a sequential
//   scatter-add bit for bit, also for general float weights.  Zero bins
//   come straight from registers and each row goes out as coalesced
//   16-byte stores: no memset, no atomics, no barrier.  14,000 warps at
//   1,000 nodes, enough to fill every SM.
// * Long series (n > 32): a block takes up to 32 whole series (2,048
//   samples at most) and keeps their histograms in shared memory, filled
//   by shared atomics and written out as float4.  With general float
//   weights the atomics add in no fixed order (a few float32 ulps from run
//   to run); with 0/1 weights the counts are small integers and exact.
//
// Binning matches metric.histogram bit for bit: IEEE division by 5.0f
// (never a multiply by 0.2, never --use_fast_math), floor, clamp in float
// to [0, 199], and only then the integer cast.  A weight of exactly zero
// adds nothing, so padding and inactive slots cannot leak.
#include <cuda_runtime.h>

constexpr int kMaxSegments = 4;

struct HistSegment {
  const float* samples;
  const float* weights;         // null: every weight is 1
  float* out;                   // (num_series, 200), rows contiguous
  long long sample_stride[2];   // elements between series, between samples
  long long weight_stride[2];   // the same for the weights (0 broadcasts)
  int num_series;
  int n;                        // samples per series
  int series_per_block;         // set by the launch
  int first_block;              // set by the launch
};

struct HistArgs {
  HistSegment seg[kMaxSegments];
  int num_segments;
};

namespace {

constexpr int kNumBins = 200;
constexpr int kRowVectors = kNumBins / 4;   // float4 a row
constexpr float kBinWidth = 5.0f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpSeries = 32;             // n up to this: a warp a series
constexpr int kSamplesPerBlock = 2048;      // long series: samples a block
constexpr int kMaxSeriesPerBlock = 32;      // 32 x 800 B of shared memory

__device__ __forceinline__ int bin_of(float x) {
  float b = floorf(x / kBinWidth);
  b = fminf(fmaxf(b, 0.0f), static_cast<float>(kNumBins - 1));
  return static_cast<int>(b);
}

__device__ __forceinline__ void add_to(float4& a, int e, float w) {
  if (e == 0) a.x += w;
  else if (e == 1) a.y += w;
  else if (e == 2) a.z += w;
  else a.w += w;
}

__device__ void warp_series(const HistSegment& g, int local_block) {
  const int lane = threadIdx.x & 31;
  const long long s =
      static_cast<long long>(local_block) * kWarps + (threadIdx.x >> 5);
  if (s >= g.num_series) return;
  int bin = 0;
  float w = 0.0f;
  if (lane < g.n) {
    w = g.weights ? g.weights[s * g.weight_stride[0] +
                              lane * g.weight_stride[1]]
                  : 1.0f;
    bin = bin_of(g.samples[s * g.sample_stride[0] +
                           lane * g.sample_stride[1]]);
  }
  float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
  for (int i = 0; i < g.n; ++i) {
    const int bi = __shfl_sync(0xffffffffu, bin, i);
    const float wi = __shfl_sync(0xffffffffu, w, i);
    if (wi == 0.0f) continue;       // the same for every lane
    const int v = bi >> 2;
    if (v == lane) add_to(lo, bi & 3, wi);
    else if (v == lane + 32) add_to(hi, bi & 3, wi);
  }
  float4* row = reinterpret_cast<float4*>(g.out + s * kNumBins);
  row[lane] = lo;
  if (lane + 32 < kRowVectors) row[lane + 32] = hi;
}

__device__ void block_series(const HistSegment& g, int local_block,
                             float4* hist4) {
  float* hist = reinterpret_cast<float*>(hist4);
  const long long s0 =
      static_cast<long long>(local_block) * g.series_per_block;
  const int ns = static_cast<int>(
      min(static_cast<long long>(g.series_per_block), g.num_series - s0));
  const int bins = ns * kNumBins;
  for (int i = threadIdx.x; i < bins; i += blockDim.x) hist[i] = 0.0f;
  __syncthreads();
  const int n = g.n, count = ns * n;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const long long s = s0 + i / n;
    const int j = i % n;
    const float wi = g.weights ? g.weights[s * g.weight_stride[0] +
                                           j * g.weight_stride[1]]
                               : 1.0f;
    if (wi == 0.0f) continue;
    const int b = bin_of(g.samples[s * g.sample_stride[0] +
                                   j * g.sample_stride[1]]);
    atomicAdd(&hist[(i / n) * kNumBins + b], wi);
  }
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(g.out + s0 * kNumBins);
  for (int i = threadIdx.x; i < ns * kRowVectors; i += blockDim.x) {
    dst[i] = hist4[i];
  }
}

__global__ void __launch_bounds__(kThreads)
runqlat_hist_kernel(const HistArgs args) {
  extern __shared__ float4 hist4[];  // long series only
  HistSegment g = args.seg[0];
#pragma unroll
  for (int i = 1; i < kMaxSegments; ++i) {
    if (i < args.num_segments &&
        static_cast<int>(blockIdx.x) >= args.seg[i].first_block) {
      g = args.seg[i];
    }
  }
  const int local_block = static_cast<int>(blockIdx.x) - g.first_block;
  if (g.n <= kWarpSeries) {
    warp_series(g, local_block);
  } else {
    block_series(g, local_block, hist4);
  }
}

}  // namespace

// args: the segments (1 to 4) with pointers, strides, num_series and n set;
// every out 16-byte aligned.  Lays the segments' blocks out one after the
// other, launches once on `stream` and returns cudaGetLastError() (0 on
// success; -1 for arguments the kernel does not take, which the wrapper
// rules out first).
extern "C" int runqlat_hist_launch(HistArgs args, int device, void* stream) {
  if (args.num_segments < 1 || args.num_segments > kMaxSegments) return -1;
  int blocks = 0, smem = 0;
  for (int i = 0; i < args.num_segments; ++i) {
    HistSegment& g = args.seg[i];
    if (g.num_series < 0 || g.n < 0) return -1;
    g.first_block = blocks;
    if (g.n <= kWarpSeries) {
      g.series_per_block = kWarps;
    } else {
      const int fit = kSamplesPerBlock / g.n;
      g.series_per_block = fit < 1 ? 1
                           : fit > kMaxSeriesPerBlock ? kMaxSeriesPerBlock
                                                      : fit;
      const int bytes = g.series_per_block * kNumBins *
                        static_cast<int>(sizeof(float));
      if (bytes > smem) smem = bytes;
    }
    const long long need =
        (static_cast<long long>(g.num_series) + g.series_per_block - 1) /
        g.series_per_block;
    if (blocks + need > 0x7fffffffLL) return -1;
    blocks += static_cast<int>(need);
  }
  if (blocks == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  runqlat_hist_kernel<<<blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
