// Backward of the Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces no TPU kernel: repro/kernels/ssd.py::ssd_pallas has no
// backward, and JAX trains through autodiff of its jnp scan
// (repro/models/ssd.py::ssd_chunked).  The port's forward runs in a kernel
// (csrc/ssd_sm90.cu for bf16, csrc/ssd.cu for float32), so its gradient is
// this hand-written VJP of the same function, the arithmetic of
// kernels/ssd.py::ssd_bwd_plain.  For x (B, T, H, P), dt (B, T, H), A (H,),
// one B/C group (B, T, N), the output gradient dy (like x) and the final
// state's gradient dS (B, H, P, N, or none for zero), per chunk of 64 steps
// with loga = dt A, cum its inclusive sum, E[t, s] = exp(cum_t - cum_s) for
// s <= t, e_s = exp(cum_end - cum_s), S0 the state at the chunk's start and
// dS1 the gradient of the state at its end:
//   dx_s = sum_t E dt_s (C_t.B_s) dy_t + e_s dt_s dS1 B_s
//   dC_t = exp(cum_t) S0^T dy_t + sum_s E dt_s (dy_t.x_s) B_s
//   dB_s = sum_t E dt_s (dy_t.x_s) C_t + e_s dt_s dS1^T x_s
//   dS0  = exp(cum_end) dS1 + sum_t exp(cum_t) dy_t C_t^T
// and dt's gradient through the terms that hold dt_s and through cum (the
// reverse cumulative sum of cum's gradient, times A; dA is that times dt,
// summed over batch and time).  Only the pairs s <= t are formed: JAX's
// autodiff takes exp of the positive cum_t - cum_s above the diagonal
// before masking it, which overflows, and its gradient is 0 * inf = NaN
// there; this kernel is finite wherever the inputs are.
//
// Four launches on one stream:
//   1. chunk states (one block per (b, chunk, h)): the chunk's own share
//      of the state, sum_s e_s dt_s x_s B_s^T, its share of dS0, sum_t
//      exp(cum_t) dy_t C_t^T, and exp(cum_end);
//   2. the chain (one thread per (b, h, p, n)): the chunk-start states S0
//      from the first chunk to the last, then dS1 from the last to the
//      first, starting at dS (or zero), each written over its share;
//   3. the chunks (one block per (b, chunk, h)): every gradient of the
//      chunk, with dB and dC per head and dA per block;
//   4. the sums (one thread per (b, t, n), one block for dA): dB and dC
//      over the heads, dA over batch and chunks, each in a fixed order.
// The chunk-start states are recomputed here rather than written by the
// forward kernels, so the forward is unchanged and nothing is kept between
// the two directions; it costs pass 1's products and the two (B, nc, H, P,
// N) float32 buffers written and read twice: at zamba2-1.2b's train
// microbatch (B 4, T 1,024, H 64, P = N = 64) 4 x 67 MB, ~80 us at 3.35
// TB/s.  No floating-point atomics: two calls give the same bits.
//
// Bound (that shape): inputs and outputs are 105 MB in bf16 (208 MB in
// float32), 31 us (62 us) at 3.35 TB/s; the least products (five P x N x 64 a
// (b, chunk, h), the pair ones over the lower triangle, C B^T once per (b,
// chunk)) are 15.1 GFLOP, 15 us at the 989 TFLOP/s of bf16 tensor cores, 92
// us at the 165 TFLOP/s of 3xTF32 (float32 accuracy on the tensor cores) or
// 226 us at the 67 TFLOP/s of float32 outside them.  So bf16 is bound by
// bytes, float32 by products.  This kernel runs eleven whole 64 x 64 x 64
// products a (b, chunk, h), 23.6 GFLOP, every one in float32 on the CUDA
// cores from register tiles fed by shared memory, for both input types: it is
// the plain version's arithmetic, which the tests hold it to, and the first
// aim is gradients that are right end to end.  So it is bound by its FFMA
// issue, far from the bf16 bound; the products on mma.sync (bf16, or 3xTF32
// for float32, as the flash backward's) are its redesign.  They did not come
// cheaply here: the eleven products take their operands in three layouts
// ([m][k] by [n][k], [m][k] by [k][n], [k][m] by [k][n]), each its own
// fragment loads, most operands are float32 values formed in the kernel (so
// bf16 would need split hi / lo operands, as ssd_sm90.cu's), and every
// elementwise term and row sum below reads the thread's 4 x 4 tile at the
// same positions across products, which the mma accumulator layout would
// scatter.
//
// Inside a block, the register tiles of scan_bwd_tiles.cuh (256 threads, each
// a 4 x 4 tile of a 64 x 64 output, from padded shared-memory tiles); bf16
// inputs are widened as they land.  Padded steps of a ragged last chunk load
// as zero with dt = 0, which neither decays nor feeds the state, as in the
// plain version.  Sums over rows of a tile reduce the 16 lanes of a half warp
// by shuffles in a fixed order; sums over columns run down the column in one
// thread.  Pass 3 holds nine tiles (150 KB), one block an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scan_bwd_tiles.cuh"

namespace {

using namespace scan_tiles;

constexpr size_t kStateSmem = (4 * kTile + 4 * kL) * sizeof(float);
constexpr size_t kChunkSmem = (9 * kTile + 10 * kL + 8) * sizeof(float);

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Sum over the 16 lanes of a half warp (the tx of one ty), fixed order.
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// dt of the chunk (zero past `len`) and, by thread 0 in step order, cum;
// then exp(cum_t) and e_t = exp(cum_end - cum_t).
__device__ __forceinline__ void chunk_decays(const float* dt, float a,
                                             long long dt_off, int H, int len,
                                             float* dts, float* cum,
                                             float* dec, float* ex_end,
                                             int tid) {
  if (tid < kL) dts[tid] = tid < len ? dt[dt_off + tid * H] : 0.f;
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int t = 0; t < kL; ++t) {
      run += dts[t] * a;
      cum[t] = run;
    }
  }
  __syncthreads();
  if (tid < kL) {
    dec[tid] = expf(cum[tid]);
    ex_end[tid] = expf(cum[kL - 1] - cum[tid]);
  }
  __syncthreads();
}

// Pass 1: per (b, chunk, h), loc = sum_s e_s dt_s x_s B_s^T (P x N),
// G = sum_t exp(cum_t) dy_t C_t^T (P x N) and tot = exp(cum_end).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const T* __restrict__ dy,
                     float* __restrict__ loc, float* __restrict__ G,
                     float* __restrict__ tot, int T_, int H, int P, int N,
                     int nc) {
  extern __shared__ float smem[];
  float* xs = smem;          // x, then x e dt
  float* dys = xs + kTile;   // dy, then dy exp(cum)
  float* bs = dys + kTile;
  float* cs = bs + kTile;
  float* dts = cs + kTile;
  float* cum = dts + kL;
  float* dec = cum + kL;
  float* ex_end = dec + kL;

  const int blk = blockIdx.x;
  const int h = blk % H, bc = blk / H, c = bc % nc, b = bc / nc;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int t0 = c * kL, len = min(kL, T_ - t0);
  const long long row = static_cast<long long>(b) * T_ + t0;
  load_tile(xs, x + (row * H + h) * P, static_cast<long long>(H) * P, len,
            P, tid);
  load_tile(dys, dy + (row * H + h) * P, static_cast<long long>(H) * P, len,
            P, tid);
  load_tile(bs, Bm + row * N, N, len, N, tid);
  load_tile(cs, Cm + row * N, N, len, N, tid);
  chunk_decays(dt, A[h], row * H + h, H, len, dts, cum, dec, ex_end, tid);
  for (int i = tid; i < kL * kMax; i += kThreads) {
    const int t = i / kMax, d = i % kMax;
    xs[t * kLd + d] *= ex_end[t] * dts[t];
    dys[t * kLd + d] *= dec[t];
  }
  __syncthreads();
  float acc[4][4];
  float* out = loc + static_cast<long long>(blk) * P * N;
  for (int pass = 0; pass < 2; ++pass) {
    zero(acc);
    mm<true, false>(acc, pass ? dys : xs, pass ? cs : bs, kL, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 16 * j;
        if (p < P && n < N) out[p * N + n] = acc[i][j];
      }
    }
    out = G + static_cast<long long>(blk) * P * N;
  }
  if (tid == 0) tot[blk] = dec[kL - 1];
}

// Pass 2: per (b, h, p, n), the chunk-start states forward over the
// chunks, written over loc, then the end-of-chunk state gradients backward
// from dS (or zero), written over G.  Each walk reads kChainAhead chunks'
// values before it writes any, so that many loads are in flight.
constexpr int kChainAhead = 8;

__global__ void __launch_bounds__(kThreads)
ssd_bwd_chain_kernel(float* __restrict__ loc, float* __restrict__ G,
                     const float* __restrict__ tot,
                     const float* __restrict__ dstate, int B, int H, int PN,
                     int nc) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(B) * H * PN) return;
  const int e = static_cast<int>(idx % PN);
  const int bh = static_cast<int>(idx / PN);
  const int h = bh % H, b = bh / H;
  const long long blk0 = static_cast<long long>(b) * nc * H + h;
  float s = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kChainAhead) {
    float l[kChainAhead], t[kChainAhead];
#pragma unroll
    for (int i = 0; i < kChainAhead; ++i) {
      const long long blk = blk0 + static_cast<long long>(c0 + i) * H;
      l[i] = c0 + i < nc ? loc[blk * PN + e] : 0.f;
      t[i] = c0 + i < nc ? tot[blk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kChainAhead; ++i) {
      if (c0 + i >= nc) break;
      loc[(blk0 + static_cast<long long>(c0 + i) * H) * PN + e] = s;
      s = t[i] * s + l[i];
    }
  }
  float d = dstate ? dstate[idx] : 0.f;
  for (int c0 = nc - 1; c0 >= 0; c0 -= kChainAhead) {
    float g[kChainAhead], t[kChainAhead];
#pragma unroll
    for (int i = 0; i < kChainAhead; ++i) {
      const long long blk = blk0 + static_cast<long long>(c0 - i) * H;
      g[i] = c0 - i >= 0 ? G[blk * PN + e] : 0.f;
      t[i] = c0 - i >= 0 ? tot[blk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kChainAhead; ++i) {
      if (c0 - i < 0) break;
      G[(blk0 + static_cast<long long>(c0 - i) * H) * PN + e] = d;
      d = t[i] * d + g[i];
    }
  }
}

// Pass 3: per (b, chunk, h), every gradient of the chunk from its inputs,
// S0 and dS1: dx, ddt, dB and dC of this head (summed over heads in pass
// 4), and this block's share of dA.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const T* __restrict__ dy,
                     const float* __restrict__ S0, const float* __restrict__ dS1,
                     T* __restrict__ dx, float* __restrict__ ddt,
                     float* __restrict__ dBh, float* __restrict__ dCh,
                     float* __restrict__ dA_part, int T_, int H, int P, int N,
                     int nc) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* dys = xs + kTile;
  float* bs = dys + kTile;
  float* cs = bs + kTile;
  float* s0 = cs + kTile;      // [p][n]
  float* ds1 = s0 + kTile;     // [p][n]
  float* Wt = ds1 + kTile;     // [t][s]  E dt_s (C_t.B_s)
  float* Rt = Wt + kTile;      // [t][s]  E dt_s (dy_t.x_s)
  float* Qt = Rt + kTile;      // [t][s]  E (C_t.B_s) (dy_t.x_s)
  float* dts = Qt + kTile;
  float* cum = dts + kL;
  float* dec = cum + kL;
  float* ex_end = dec + kL;
  float* inter = ex_end + kL;  // exp(cum_t) dy_t . S0 C_t
  float* xbds = inter + kL;    // x_s . dS1 B_s
  float* rowm = xbds + kL;     // sum_s Q[t][s] dt_s
  float* colq = rowm + kL;     // sum_t Q[t][s]
  float* dcum = colq + kL;
  float* dloga = dcum + kL;
  float* red = dloga + kL;     // [8] per-warp sums

  const int blk = blockIdx.x;
  const int h = blk % H, bc = blk / H, c = bc % nc, b = bc / nc;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int t0 = c * kL, len = min(kL, T_ - t0);
  const long long row = static_cast<long long>(b) * T_ + t0;
  const long long xrow = static_cast<long long>(H) * P;
  const float a = A[h];
  load_tile(xs, x + (row * H + h) * P, xrow, len, P, tid);
  load_tile(dys, dy + (row * H + h) * P, xrow, len, P, tid);
  load_tile(bs, Bm + row * N, N, len, N, tid);
  load_tile(cs, Cm + row * N, N, len, N, tid);
  const long long soff = static_cast<long long>(blk) * P * N;
  load_tile(s0, S0 + soff, N, P, N, tid);
  load_tile(ds1, dS1 + soff, N, P, N, tid);
  chunk_decays(dt, a, row * H + h, H, len, dts, cum, dec, ex_end, tid);

  // the pair terms, s <= t only
  {
    float cb[4][4], dyx[4][4];
    zero(cb);
    zero(dyx);
    mm<false, true>(cb, cs, bs, N, ty, tx);
    mm<false, true>(dyx, dys, xs, P, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = tx + 16 * j;
        const float e = s <= t ? expf(cum[t] - cum[s]) : 0.f;
        Wt[t * kLd + s] = e * cb[i][j] * dts[s];
        Rt[t * kLd + s] = e * dts[s] * dyx[i][j];
        Qt[t * kLd + s] = e * cb[i][j] * dyx[i][j];
      }
    }
  }
  __syncthreads();

  float acc[4][4], aux[4][4];
  // inter_t = exp(cum_t) dy_t . (S0 C_t)
  zero(aux);
  mm<false, true>(aux, cs, s0, N, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = ty + 16 * i;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) v += dys[t * kLd + tx + 16 * j] * aux[i][j];
    v = half_warp_sum(v);
    if (tx == 0) inter[t] = dec[t] * v;
  }
  // dS1 B_s, its dot with x_s, and dx = W^T dy + e_s dt_s dS1 B_s
  zero(aux);
  mm<false, true>(aux, bs, ds1, N, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = ty + 16 * i;
    const float f = ex_end[s] * dts[s];
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v += xs[s * kLd + tx + 16 * j] * aux[i][j];
      acc[i][j] = f * aux[i][j];
    }
    v = half_warp_sum(v);
    if (tx == 0) xbds[s] = v;
  }
  mm<true, false>(acc, Wt, dys, kL, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = ty + 16 * i;
    if (s >= len) continue;
    T* out = dx + ((row + s) * H + h) * P;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tx + 16 * j;
      if (p < P) put(out + p, acc[i][j]);
    }
  }
  // dC = exp(cum_t) dy S0 + R B, this head's share
  zero(acc);
  mm<false, false>(acc, dys, s0, P, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] *= dec[ty + 16 * i];
  mm<false, false>(acc, Rt, bs, kL, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = ty + 16 * i;
    if (t >= len) continue;
    float* out = dCh + ((row + t) * H + h) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tx + 16 * j;
      if (n < N) out[n] = acc[i][j];
    }
  }
  // dB = R^T C + e_s dt_s x dS1, this head's share
  zero(acc);
  mm<false, false>(acc, xs, ds1, P, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = ty + 16 * i;
    const float f = ex_end[s] * dts[s];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] *= f;
  }
  mm<true, false>(acc, Rt, cs, kL, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = ty + 16 * i;
    if (s >= len) continue;
    float* out = dBh + ((row + s) * H + h) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tx + 16 * j;
      if (n < N) out[n] = acc[i][j];
    }
  }

  // Q's row sums (times dt_s) and column sums, each in step order; S0 . dS1
  if (tid < kL) {
    float v = 0.f;
    for (int s = 0; s <= tid; ++s) v += Qt[tid * kLd + s] * dts[s];
    rowm[tid] = v;
  } else if (tid < 2 * kL) {
    const int s = tid - kL;
    float v = 0.f;
    for (int t = s; t < kL; ++t) v += Qt[t * kLd + s];
    colq[s] = v;
  }
  float dot = 0.f;
  for (int i = tid; i < P * N; i += kThreads) {
    const int o = (i / N) * kLd + i % N;
    dot += s0[o] * ds1[o];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
  }
  if (tid % 32 == 0) red[tid / 32] = dot;
  __syncthreads();

  // cum's gradient, its reverse cumulative sum (loga's), ddt and dA
  if (tid == 0) {
    float k_sum = 0.f, s0ds1 = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s0ds1 += red[w];
    for (int t = 0; t < kL; ++t) {
      const float kt = ex_end[t] * dts[t] * xbds[t];
      k_sum += kt;
      dcum[t] = inter[t] + rowm[t] - dts[t] * colq[t] - kt;
    }
    dcum[kL - 1] += k_sum + dec[kL - 1] * s0ds1;
    float run = 0.f, da = 0.f;
    for (int t = kL - 1; t >= 0; --t) {
      run += dcum[t];
      dloga[t] = run;
    }
    for (int t = 0; t < kL; ++t) da += dloga[t] * dts[t];
    dA_part[blk] = da;
  }
  __syncthreads();
  if (tid < len) {
    ddt[(row + tid) * H + h] =
        colq[tid] + ex_end[tid] * xbds[tid] + dloga[tid] * a;
  }
}

// Pass 4: dB and dC summed over the heads in head order, one thread per
// (b, t, n); the last block sums dA over the (b, chunk) blocks in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_sum_kernel(const float* __restrict__ dBh,
                   const float* __restrict__ dCh,
                   const float* __restrict__ dA_part, T* __restrict__ dB,
                   T* __restrict__ dC, float* __restrict__ dA, long long BTN,
                   int H, int N, int BC) {
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = threadIdx.x; h < H; h += kThreads) {
      float s = 0.f;
      for (int i = 0; i < BC; ++i) s += dA_part[static_cast<long long>(i) * H + h];
      dA[h] = s;
    }
    return;
  }
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= BTN) return;
  const long long bt = idx / N;
  const int n = static_cast<int>(idx % N);
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    const long long o = (bt * H + h) * N + n;
    sb += dBh[o];
    sc += dCh[o];
  }
  put(dB + idx, sb);
  put(dC + idx, sc);
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* dy, const void* dstate, void* dx,
           void* ddt, void* dA, void* dB, void* dC, void* states, void* grads,
           void* dBh, void* dCh, void* dA_part, void* tot, int B, int T_,
           int H, int P, int N, cudaStream_t st) {
  static bool configured = false;  // one attribute call per instantiation
  cudaError_t err;
  if (!configured) {
    err = cudaFuncSetAttribute(ssd_bwd_state_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kStateSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kChunkSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int nc = (T_ + kL - 1) / kL;
  const unsigned blocks = static_cast<unsigned>(B) * nc * H;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  const T* dyt = static_cast<const T*>(dy);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  float* sf = static_cast<float*>(states);
  float* gf = static_cast<float*>(grads);
  float* totf = static_cast<float*>(tot);
  ssd_bwd_state_kernel<T><<<blocks, kThreads, kStateSmem, st>>>(
      xt, dtf, af, bt, ct, dyt, sf, gf, totf, T_, H, P, N, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long chain = static_cast<long long>(B) * H * P * N;
  ssd_bwd_chain_kernel<<<static_cast<unsigned>((chain + kThreads - 1) /
                                               kThreads),
                         kThreads, 0, st>>>(
      sf, gf, totf, static_cast<const float*>(dstate), B, H, P * N, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_kernel<T><<<blocks, kThreads, kChunkSmem, st>>>(
      xt, dtf, af, bt, ct, dyt, sf, gf, static_cast<T*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dBh),
      static_cast<float*>(dCh), static_cast<float*>(dA_part), T_, H, P, N,
      nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long btn = static_cast<long long>(B) * T_ * N;
  ssd_bwd_sum_kernel<T><<<static_cast<unsigned>((btn + kThreads - 1) /
                                                kThreads) + 1,
                          kThreads, 0, st>>>(
      static_cast<const float*>(dBh), static_cast<const float*>(dCh),
      static_cast<const float*>(dA_part), static_cast<T*>(dB),
      static_cast<T*>(dC), static_cast<float*>(dA), btn, H, N,
      B * nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dy, dx: (B, T, H, P); dt, ddt: (B, T, H) float32; A, dA: (H,)
// float32; B, C, dB, dC: (B, T, N); dstate: (B, H, P, N) float32 or null
// (zero).  Scratch, all float32: states and grads (B, nc, H, P, N), dBh
// and dCh (B, T, H, N), dA_part and tot (B nc H), nc = ceil(T / 64).  x,
// B, C, dy and the outputs like them all float32 (dtype 0) or all
// bfloat16 (dtype 1); P, N <= 64; every array contiguous.  Launches four
// kernels on `stream` and returns the first cudaGetLastError() that is
// not 0 (0 on success; -1 for an unsupported dtype or size, which the
// wrapper rules out first).
extern "C" int ssd_bwd_launch(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* dy,
                              const void* dstate, void* dx, void* ddt,
                              void* dA, void* dB, void* dC, void* states,
                              void* grads, void* dBh, void* dCh,
                              void* dA_part, void* tot, int B, int T_, int H,
                              int P, int N, int dtype, int device,
                              void* stream) {
  if (P < 1 || P > kMax || N < 1 || N > kMax || B < 1 || T_ < 1 || H < 1) {
    return -1;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, dt, A, Bm, Cm, dy, dstate, dx, ddt, dA, dB, dC,
                         states, grads, dBh, dCh, dA_part, tot, B, T_, H, P,
                         N, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, dy, dstate, dx, ddt, dA,
                                 dB, dC, states, grads, dBh, dCh, dA_part,
                                 tot, B, T_, H, P, N, st);
  }
  return -1;
}
