// Fused rollout tick for Hopper (sm_90a): per-node delay curve, Erlang(2)
// runqlat draw and node histogram in one pass.
//
// Replaces repro/kernels/rollout_tick.py::fused_tick (body _tick_kernel,
// _node_delay), the TPU kernel behind batched_rollout(use_pallas=True).
//
// Computes, for every node row r of R, over its S slots (the online slots
// first, then the offline ones) and K samples a slot:
//   d[r]       = clip((base + scale*rho*rho / max(1-rho, knee))
//                     * (1 + slope*max(threads/cores - 1, 0))
//                     * exp(0.13*noise), 0, clip_max)
//   mean[r, s] = d[r] * max(jit[r, s], 0.3)
//   x          = -log(u1[r, s, i] * u2[r, s, i]) * (mean[r, s] / gamma_shape)
//   hist[r, b] = sum of act[r, s] over the samples whose x lands in bin
//                b = clamp(floor(x / 5), 0, 199)
//
// Reads the tick's tensors where they lie (cluster/state.py::_tick_fused):
// eight per-row fields, each a pointer and a stride; per slot kind (online,
// offline) the jitter, the active mask and the uniforms, each a pointer and
// a row stride.  Two layouts share the kernel (TickArgs below):
//   * the state's: jitter as raw standard normals (the kernel applies
//     1 + 0.18*x as __fadd_rn(1, __fmul_rn(0.18f, x))), bool masks, and the
//     uniforms as the noise bundle holds them, (R, S, K, 2) with the two
//     draws of a sample side by side;
//   * the TPU kernel's packed one (fused_tick): nodev (R, 8), jit_all and
//     act_all (R, S) float32, u1 and u2 (R, S*K) apart.
//
// Bound: bytes.  The 800 B histogram row is written for every row; of the
// inputs only the per-row fields, the jitter and masks, and the uniforms
// of active slots need be read.  At the replay's 5,000th batched tick
// (R = 20,000, ~3,400 active slots of 280,000) that is 16.0 MB of
// histogram, ~2.3 MB of fields, jitter, masks and means, and 0.44 MB of
// uniforms: ~5.6 us at 3.35 TB/s.  Each sample costs about a dozen float
// operations, far below the byte bound.
//
// Design: a block takes a tile of 32 rows.  (1) One thread a row reads the
// row's fields and computes its delay.  (2) The block walks the tile's
// 32 x S (row, slot) pairs, consecutive threads on consecutive pairs: it
// writes every mean, and appends each active pair (weight != 0) to a list
// in shared memory and marks its row.  (3) Only marked rows get a 800 B
// histogram in shared memory, zeroed.  (4) Threads take the listed pairs'
// samples four at a time, as two 16-byte loads of the uniforms (one float4
// of pairs (u1, u2) twice in the state's layout, one float4 of u1 and one
// of u2 in the packed layout; the wrapper requires K % 4 == 0 and 16-byte
// aligned uniforms, and raises otherwise), and bin with shared atomics.  (5) The
// tile's histogram rows go out as float4 stores, consecutive threads on
// consecutive addresses: a row with no active slot is written as zeros
// straight from registers and never touches shared memory.  Any R works:
// threads past the last row only take part in the barriers.
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
#include <stdint.h>

namespace {

constexpr int kNumBins = 200;
constexpr int kBins4 = kNumBins / 4;  // float4 chunks of a histogram row
constexpr float kBinWidth = 5.0f;
constexpr int kTile = 32;             // node rows per block
constexpr int kThreads = 256;
constexpr int kMaxSlots = 32;         // slots a row, both kinds together

}  // namespace

// One slot kind's tensors: rows r, its slots s, its samples i.
struct SlotKind {
  const void* jit;        // (R, slots) float32: raw normals or 1 + 0.18 x
  const void* act;        // (R, slots) bool or float32 weights
  const float* u1;        // first draw of sample (r, s, i)
  const float* u2;        // second draw
  long long jit_stride;   // row strides in elements
  long long act_stride;
  long long u_stride;
  int slots;
};

// Everything one launch reads and writes.  Field order: rho_p,
// threads_total, cores, delay_base, delay_scale, rho_knee, oversub_slope,
// delay noise.  Sample (r, s, i)'s draws sit at u1/u2 + r * u_stride
// + (s * K + i) * u_step, s counted within its kind.
struct TickArgs {
  const float* field[8];
  long long field_stride[8];
  SlotKind kind[2];       // online, offline
  float* hist;            // (R, 200)
  float* delay;           // (R,)
  float* mean;            // (R, S) with S = kind[0].slots + kind[1].slots
  int rows;
  int k;                  // samples a slot
  int u_step;             // 2: draws interleaved (u2 = u1 + 1); 1: apart
  int jit_raw;            // 1: jit holds normals, apply 1 + 0.18 x
  int act_bool;           // 1: act is bool; 0: float32
  float gamma_shape;
  float clip_max;
};

namespace {

__device__ __forceinline__ float node_delay(const float v[8], float clip_max) {
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

__device__ __forceinline__ void bin(float* h, float u1, float u2, float sc,
                                    float w) {
  const float g = -logf(__fmul_rn(u1, u2));
  const float x = __fmul_rn(g, sc);
  float b = floorf(__fdiv_rn(x, kBinWidth));
  b = fminf(fmaxf(b, 0.0f), static_cast<float>(kNumBins - 1));
  atomicAdd(&h[static_cast<int>(b)], w);
}

__global__ void __launch_bounds__(kThreads)
rollout_tick_kernel(const TickArgs a) {
  __shared__ float4 hist[kTile][kBins4];
  __shared__ float delay_s[kTile];
  __shared__ int row_active[kTile];
  __shared__ int n_pairs;
  __shared__ int pair_row[kTile * kMaxSlots];   // row in tile, slot kind,
  __shared__ int pair_slot[kTile * kMaxSlots];  // slot within its kind
  __shared__ float pair_w[kTile * kMaxSlots];
  __shared__ float pair_sc[kTile * kMaxSlots];  // mean / gamma_shape

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kTile;
  const int tile_rows = min(kTile, a.rows - row0);
  const int s_on = a.kind[0].slots;
  const int slots = s_on + a.kind[1].slots;

  // (1) the delay, one thread a row
  if (tid < tile_rows) {
    const long long r = row0 + tid;
    float v[8];
#pragma unroll
    for (int f = 0; f < 8; ++f) v[f] = a.field[f][r * a.field_stride[f]];
    const float d = node_delay(v, a.clip_max);
    delay_s[tid] = d;
    a.delay[r] = d;
  }
  if (tid < kTile) row_active[tid] = 0;
  if (tid == 0) n_pairs = 0;
  __syncthreads();

  // (2) every mean; the active pairs listed
  const long long mbase = static_cast<long long>(row0) * slots;
  for (int idx = tid; idx < tile_rows * slots; idx += kThreads) {
    const int rr = idx / slots, s = idx % slots;
    const int kd = s < s_on ? 0 : 1;
    const int sl = kd ? s - s_on : s;
    const SlotKind K = kd ? a.kind[1] : a.kind[0];  // no runtime index
    const long long r = row0 + rr;
    float jit = static_cast<const float*>(K.jit)[r * K.jit_stride + sl];
    if (a.jit_raw) jit = __fadd_rn(1.0f, __fmul_rn(0.18f, jit));
    const float mean = __fmul_rn(delay_s[rr], fmaxf(jit, 0.3f));
    a.mean[mbase + idx] = mean;
    const float w =
        a.act_bool
            ? (static_cast<const uint8_t*>(K.act)[r * K.act_stride + sl] ? 1.0f
                                                                        : 0.0f)
            : static_cast<const float*>(K.act)[r * K.act_stride + sl];
    if (w != 0.0f) {
      row_active[rr] = 1;
      const int p = atomicAdd(&n_pairs, 1);
      pair_row[p] = rr * 2 + kd;
      pair_slot[p] = sl;
      pair_w[p] = w;
      pair_sc[p] = __fdiv_rn(mean, a.gamma_shape);
    }
  }
  __syncthreads();

  // (3) zero the histograms of rows with an active slot
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int idx = tid; idx < tile_rows * kBins4; idx += kThreads) {
    const int rr = idx / kBins4;
    if (row_active[rr]) hist[rr][idx % kBins4] = zero;
  }
  __syncthreads();

  // (4) the active pairs' samples, four a thread (K % 4 == 0, aligned)
  const int np = n_pairs;
  const int groups = a.k / 4;
  for (int idx = tid; idx < np * groups; idx += kThreads) {
    const int p = idx / groups, i = (idx % groups) * 4;
    const int rr = pair_row[p] >> 1;
    const SlotKind K = (pair_row[p] & 1) ? a.kind[1] : a.kind[0];
    const long long off = (row0 + rr) * K.u_stride +
                          static_cast<long long>(pair_slot[p] * a.k + i) *
                              a.u_step;
    float* h = reinterpret_cast<float*>(hist[rr]);
    const float sc = pair_sc[p], w = pair_w[p];
    if (a.u_step == 2) {  // (u1, u2) pairs side by side
      const float4 lo = *reinterpret_cast<const float4*>(K.u1 + off);
      const float4 hi = *reinterpret_cast<const float4*>(K.u1 + off + 4);
      bin(h, lo.x, lo.y, sc, w);
      bin(h, lo.z, lo.w, sc, w);
      bin(h, hi.x, hi.y, sc, w);
      bin(h, hi.z, hi.w, sc, w);
    } else {
      const float4 x1 = *reinterpret_cast<const float4*>(K.u1 + off);
      const float4 x2 = *reinterpret_cast<const float4*>(K.u2 + off);
      bin(h, x1.x, x2.x, sc, w);
      bin(h, x1.y, x2.y, sc, w);
      bin(h, x1.z, x2.z, sc, w);
      bin(h, x1.w, x2.w, sc, w);
    }
  }
  __syncthreads();

  // (5) the tile's histogram rows, zeros straight from registers
  float4* dst = reinterpret_cast<float4*>(a.hist) +
                static_cast<long long>(row0) * kBins4;
  for (int idx = tid; idx < tile_rows * kBins4; idx += kThreads) {
    const int rr = idx / kBins4;
    dst[idx] = row_active[rr] ? hist[rr][idx % kBins4] : zero;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success; -1
// for more than 32 slots a row, which the wrapper rules out first).
extern "C" int rollout_tick_launch(TickArgs args, int device, void* stream) {
  if (args.kind[0].slots + args.kind[1].slots > kMaxSlots) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (args.rows + kTile - 1) / kTile;
  rollout_tick_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
