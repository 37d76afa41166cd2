// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces repro/kernels/ssd.py::ssd_pallas (body _ssd_kernel).  For x
// (B, T, H, P), dt (B, T, H), A (H,) and one B/C group (B, T, N), per
// (b, h) with a scalar decay per step and a (P x N) float32 state:
//   S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,   y_t = S_t C_t
// computed in chunks of 64 steps as the TPU kernel does: cum = inclusive
// cumsum of dt A over the chunk; y = exp(cum_t) (S C_t) (inter-chunk) +
// sum_{s <= t} exp(cum_t - cum_s) (C_t . B_s) dt_s x_s (intra-chunk); then
// S = S exp(cum_end) + sum_s exp(cum_end - cum_s) dt_s x_s B_s^T.  It also
// writes the final state (B, H, P, N), which the model's decode cache
// needs (ssd_pallas drops it from its VMEM scratch).
//
// Bound (zamba2-1.2b's prefill: B 4, T 1024, H 64, P 64, N 64, x/B/C
// bf16): x and y are 33.6 MB each, B, C, dt and the final state 6.3 MB,
// 22 us at 3.35 TB/s; the four chunk products are about 8.6 GFLOP, 8.7 us
// at the 989 TFLOP/s of bf16 tensor cores.  So the bound is bytes.  This
// first kernel computes in float32 on the CUDA cores (128 us at 67
// TFLOP/s at best): a later kernel moves the products onto tensor cores.
//
// Design: the TPU's sequential chunk axis becomes a loop inside the block,
// one block per (b, h), so the state never leaves shared memory.  Per
// chunk the block loads x, B, C (converted to float32) and dt into shared
// memory, zero for steps past T (dt = 0 neither decays nor feeds the
// state, so a ragged last chunk needs no other care), forms cum with one
// thread, and runs four 64 x 64 products, each thread owning a 4 x 4
// register tile at rows ty + 16r and columns tx + 16c: S C^T and C B^T
// together (one pass over n), then W x with W = masked decay * C B^T * dt
// kept in shared memory, then the state update.  Rows are padded to 65
// floats so that column reads fall in distinct banks.  Shared memory is
// 84 KB, so the launch raises the dynamic limit; P and N are at most 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kL = 64;       // chunk length
constexpr int kMax = 64;     // largest P and N
constexpr int kLd = kMax + 1;
constexpr int kThreads = 256;
constexpr int kTile = kMax * kLd;
constexpr size_t kSmem = (5 * kTile + 3 * kL) * sizeof(float);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y,
           float* __restrict__ state_out, int T_, int H, int P, int N) {
  extern __shared__ float smem[];
  float* st = smem;              // state   st[p * kLd + n]
  float* xs = st + kTile;        // x       xs[t * kLd + p]
  float* bs = xs + kTile;        // B       bs[t * kLd + n]
  float* cs = bs + kTile;        // C       cs[t * kLd + n]
  float* ws = cs + kTile;        // W       ws[t * kLd + s]
  float* cum = ws + kTile;       // [kL]
  float* dts = cum + kL;         // [kL]
  float* dec = dts + kL;         // [kL]  exp(cum_end - cum_s) dt_s

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float a = A[h];
  // columns past P or N are never loaded and stay zero
  for (int i = tid; i < 5 * kTile; i += kThreads) smem[i] = 0.f;

  const int nc = (T_ + kL - 1) / kL;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kL;
    const int len = min(kL, T_ - t0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = tid; i < kL * P; i += kThreads) {
      const int t = i / P, p = i % P;
      xs[t * kLd + p] =
          t < len ? to_f(x[((static_cast<long long>(b) * T_ + t0 + t) * H + h) * P + p])
                  : 0.f;
    }
    for (int i = tid; i < kL * N; i += kThreads) {
      const int t = i / N, n = i % N;
      const long long off = (static_cast<long long>(b) * T_ + t0 + t) * N + n;
      bs[t * kLd + n] = t < len ? to_f(Bm[off]) : 0.f;
      cs[t * kLd + n] = t < len ? to_f(Cm[off]) : 0.f;
    }
    if (tid < kL) {
      dts[tid] = tid < len
          ? dt[(static_cast<long long>(b) * T_ + t0 + tid) * H + h] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int t = 0; t < kL; ++t) {
        run += dts[t] * a;
        cum[t] = run;
      }
    }
    __syncthreads();
    const float cend = cum[kL - 1];
    if (tid < kL) dec[tid] = expf(cend - cum[tid]) * dts[tid];

    // y_inter[t][p] = sum_n C[t][n] S[p][n];  cb[t][s] = sum_n C[t][n] B[s][n]
    float yi[4][4], cb[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) yi[r][q] = cb[r][q] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cr[4], sp[4], bq[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cr[r] = cs[(ty + 16 * r) * kLd + n];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        sp[q] = st[(tx + 16 * q) * kLd + n];
        bq[q] = bs[(tx + 16 * q) * kLd + n];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          yi[r][q] += cr[r] * sp[q];
          cb[r][q] += cr[r] * bq[q];
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = ty + 16 * r;
      const float ct = cum[t];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = tx + 16 * q;
        ws[t * kLd + s] = t >= s ? expf(ct - cum[s]) * cb[r][q] * dts[s] : 0.f;
      }
      const float e = expf(ct);
#pragma unroll
      for (int q = 0; q < 4; ++q) yi[r][q] *= e;
    }
    __syncthreads();  // W and dec are complete; S is no longer read

    // y_intra[t][p] = sum_s W[t][s] x[s][p]
    for (int s = 0; s < kL; ++s) {
      float wr[4], xp[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) wr[r] = ws[(ty + 16 * r) * kLd + s];
#pragma unroll
      for (int q = 0; q < 4; ++q) xp[q] = xs[s * kLd + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) yi[r][q] += wr[r] * xp[q];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = ty + 16 * r;
      if (t >= len) continue;
      T* yp = y + ((static_cast<long long>(b) * T_ + t0 + t) * H + h) * P;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = tx + 16 * q;
        if (p < P) put(yp + p, yi[r][q]);
      }
    }

    // S[p][n] = S[p][n] exp(cum_end) + sum_s x[s][p] dec[s] B[s][n]
    float su[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) su[r][q] = 0.f;
    for (int s = 0; s < kL; ++s) {
      const float d = dec[s];
      float xp[4], bn[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) xp[r] = xs[s * kLd + ty + 16 * r] * d;
#pragma unroll
      for (int q = 0; q < 4; ++q) bn[q] = bs[s * kLd + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) su[r][q] += xp[r] * bn[q];
    }
    const float tot = expf(cend);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = ty + 16 * r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = tx + 16 * q;
        if (p < P && n < N) st[p * kLd + n] = st[p * kLd + n] * tot + su[r][q];
      }
    }
  }
  __syncthreads();
  float* so = state_out + static_cast<long long>(bh) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    so[i] = st[(i / N) * kLd + i % N];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* state, int B, int T_, int H, int P,
           int N, cudaStream_t stream) {
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  ssd_kernel<T><<<B * H, kThreads, kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(state), T_, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (B, T, H, P); dt: (B, T, H) float32; A: (H,) float32; B, C:
// (B, T, N); state: (B, H, P, N) float32.  x, y, B, C all float32 (dtype
// 0) or all bfloat16 (dtype 1); P, N <= 64; every array contiguous.
// Launches on `stream` and returns cudaGetLastError() (0 on success; -1
// for an unsupported dtype or size, which the wrapper rules out first).
extern "C" int ssd_launch(const void* x, const void* dt, const void* A,
                          const void* Bm, const void* Cm, void* y, void* state,
                          int B, int T_, int H, int P, int N, int dtype,
                          int device, void* stream) {
  if (P < 1 || P > kMax || N < 1 || N > kMax) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, y, state, B, T_, H, P, N, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, B, T_, H, P, N,
                                 st);
  return -1;
}
