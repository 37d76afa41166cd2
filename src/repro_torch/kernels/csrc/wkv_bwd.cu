// Backward of the RWKV-6 chunked WKV scan for Hopper (sm_90a).
//
// Replaces no TPU kernel: repro/kernels/rwkv_wkv.py::wkv_pallas has no
// backward, and JAX trains through autodiff of its jnp scan
// (repro/models/rwkv.py::wkv_chunked).  The port's forward runs in a
// kernel (csrc/wkv.cu), so its gradient is this hand-written VJP of the
// same function, the arithmetic of kernels/rwkv_wkv.py::wkv_bwd_plain.
// For r, k, v, w (B, T, H*P) float32, the bonus u (H, P), the output
// gradient dy and the final state's gradient dS (B, H, P, P, or none for
// zero), per chunk of L <= 64 steps with JAX's floors, logw = log(max(w,
// 1e-38)), cum its inclusive sum, A_incl = exp(cum), A_excl = exp(cum -
// logw), total = exp(cum_end), D = max(A_incl, 1e-30), qd = r A_excl,
// kd = k / D, kw = k total / D, att[t, s] = qd_t . kd_s and datt[t, s] =
// dy_t . v_s for s < t, S0 the state at the chunk's start and dS1 the
// gradient of the state at its end:
//   dqd = dy S0^T + datt kd      dkd = datt^T qd      dkw = v dS1^T
//   dv  = att^T dy + (r.u k) dy + kw dS1
//   dr  = dqd A_excl + (dy.v) u k
//   dk  = (dkd + dkw total) / D + (dy.v) u r
//   dS0 = diag(total) dS1 + qd^T dy
// and the decay's through cum: dqd qd, less dkd kd + dkw kw where the
// 1e-30 floor does not bind, and at the last step total (S0 . dS1) + the
// column sums of dkw kw; reverse-summed over the chunk, less dqd qd, over
// w where the 1e-38 floor does not bind (a floor's derivative is 0, as
// JAX's maximum gives).  Every term is a product of values the forward
// forms, the pair ratios A_excl[t] / A_incl[s] <= 1 (s < t) as the
// product qd_t . kd_s, and nothing is divided by A_incl squared: JAX's
// autodiff of kd = k / max(A_incl, 1e-30) is, which overflows to NaN once
// the decay passes ~1e-19 (rwkv6's default decay of 0.302 reaches it at
// step ~36 of a chunk).  So the kernel is finite where JAX is NaN.  For
// chunks of at most 64 steps at decays of at least 0.302 (the model's
// clamp), A_excl and 1/D stay normal float32 numbers.
//
// Four launches on one stream:
//   1. chunk states (one block per (b, chunk, h)): the chunk's own share
//      of the state, kw^T v, its share of dS0, qd^T dy, and total;
//   2. the chain (one thread per (b, h, p, q)): the chunk-start states S0
//      from the first chunk to the last, then dS1 from the last to the
//      first, starting at dS (or zero), each written over its share;
//   3. the chunks (one block per (b, chunk, h)): dr, dk, dv, dw of the
//      chunk and its share of du;
//   4. du summed over the (b, chunk) blocks in a fixed order.
// The chunk-start states are recomputed here rather than written by the
// forward kernel, so the forward is unchanged and nothing is kept between
// the two directions; it costs pass 1 and the two (B, nc, H, P, P)
// float32 buffers written and read twice: at rwkv6-7b's train microbatch
// (B 4, T 1,024, H 64, P 64, chunks of 64) 4 x 67 MB, ~80 us at 3.35
// TB/s.  No floating-point atomics: two calls give the same bits.
//
// Bound (that shape): r, k, v, w, dy read and dr, dk, dv, dw written are 604
// MB, 180 us at 3.35 TB/s; the least products (five P x P x L a (b, chunk,
// h), five over the strict lower triangle) are 16.0 GFLOP, 97 us at the 165
// TFLOP/s of 3xTF32 (float32 accuracy on the tensor cores) or 239 us at the
// 67 TFLOP/s of float32 outside them.  So the bound is bytes.  This kernel
// runs ten whole 64 x 64 x 64 products a (b, chunk, h), 21.5 GFLOP, in
// float32 on the CUDA cores (FFMA from register tiles), as the forward's:
// TF32 would leave JAX's float32 gradient, and 3xTF32 on mma.sync is the
// redesign.  It did not come cheaply here: the ten products take their
// operands in three layouts, each its own fragment loads, and dr, dk, dv and
// cum's gradient combine dqd, dkd and dkw at the same (row, column) of every
// thread's 4 x 4 tile, which the mma accumulator layout would scatter.
//
// Inside a block, the register tiles of scan_bwd_tiles.cuh (256 threads,
// each a 4 x 4 tile of a 64 x 64 output, from padded shared-memory tiles);
// rows past L are zero.
// The cumulative log-decay is a sequential sum down each column in step
// order, by P threads, as in the forward kernel and the plain version, so
// the floors bind at the same steps; logf / expf at full precision and
// IEEE division.  Column sums and the reverse cumulative sum run down each
// column in one thread.  Pass 3 holds thirteen tiles (217 KB), one block
// an SM; pass 1 six.
#include <cuda_runtime.h>

#include "scan_bwd_tiles.cuh"

namespace {

using namespace scan_tiles;

constexpr float kWFloor = 1e-38f;
constexpr float kAFloor = 1e-30f;
constexpr size_t kStateSmem = (6 * kTile + kMax) * sizeof(float);
constexpr size_t kChunkSmem = (13 * kTile + 2 * kMax + 2 * kL) *
                              sizeof(float);

__device__ __forceinline__ float log_decay(float w) {
  return logf(fmaxf(w, kWFloor));
}

// cum down each of the P columns in step order (P threads), total.
__device__ __forceinline__ void cumulate(const float* ws, float* cum,
                                         float* tot, int L, int P, int tid) {
  if (tid < P) {
    float run = 0.f;
    for (int t = 0; t < L; ++t) {
      run += log_decay(ws[t * kLd + tid]);
      cum[t * kLd + tid] = run;
    }
    tot[tid] = expf(run);
  }
}

// qd, kd (when given) and kw of the whole tile, zero past L rows and P
// columns.
__device__ __forceinline__ void decayed(const float* rs, const float* ks,
                                        const float* ws, const float* cum,
                                        const float* tot, float* qd,
                                        float* kd, float* kw, int L, int P,
                                        int tid) {
  for (int i = tid; i < kL * kMax; i += kThreads) {
    const int t = i / kMax, p = i % kMax, o = t * kLd + p;
    float q = 0.f, d = 0.f, e = 0.f;
    if (t < L && p < P) {
      const float c = cum[o];
      const float den = fmaxf(expf(c), kAFloor);
      q = rs[o] * expf(c - log_decay(ws[o]));
      d = ks[o] / den;
      e = ks[o] * (tot[p] / den);
    }
    qd[o] = q;
    if (kd) kd[o] = d;
    kw[o] = e;
  }
}

// Pass 1: per (b, chunk, h), loc = kw^T v (P x P), G = qd^T dy (P x P)
// and the chunk's total (P).
__global__ void __launch_bounds__(kThreads)
wkv_bwd_state_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ dy, float* __restrict__ loc,
                     float* __restrict__ G, float* __restrict__ tot_out,
                     int T_, int H, int P, int L) {
  extern __shared__ float smem[];
  float* rs = smem;           // r, then qd
  float* ks = rs + kTile;     // k, then kw
  float* vs = ks + kTile;
  float* ws = vs + kTile;
  float* dys = ws + kTile;
  float* cum = dys + kTile;
  float* tot = cum + kTile;   // [P]

  const int nc = T_ / L;
  const int blk = blockIdx.x;
  const int h = blk % H, bc = blk / H, c = bc % nc, b = bc / nc;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long stride = static_cast<long long>(H) * P;
  const long long base =
      (static_cast<long long>(b) * T_ + static_cast<long long>(c) * L) *
          stride + static_cast<long long>(h) * P;
  load_tile(rs, r + base, stride, L, P, tid);
  load_tile(ks, k + base, stride, L, P, tid);
  load_tile(vs, v + base, stride, L, P, tid);
  load_tile(ws, w + base, stride, L, P, tid);
  load_tile(dys, dy + base, stride, L, P, tid);
  __syncthreads();
  cumulate(ws, cum, tot, L, P, tid);
  __syncthreads();
  // in place: each element is read and written by the same thread
  decayed(rs, ks, ws, cum, tot, rs, nullptr, ks, L, P, tid);
  __syncthreads();
  float acc[4][4];
  for (int pass = 0; pass < 2; ++pass) {
    zero(acc);
    mm<true, false>(acc, pass ? rs : ks, pass ? dys : vs, L, ty, tx);
    float* out = (pass ? G : loc) + static_cast<long long>(blk) * P * P;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = tx + 16 * j;
        if (p < P && q < P) out[p * P + q] = acc[i][j];
      }
    }
  }
  if (tid < P) tot_out[static_cast<long long>(blk) * P + tid] = tot[tid];
}

// Pass 2: per (b, h, p, q), the chunk-start states forward over the
// chunks, written over loc, then the end-of-chunk state gradients backward
// from dS (or zero), written over G; row p decays by total[p].  Each walk
// reads kChainAhead chunks' values before it writes any, so that many
// loads are in flight.
constexpr int kChainAhead = 8;

__global__ void __launch_bounds__(kThreads)
wkv_bwd_chain_kernel(float* __restrict__ loc, float* __restrict__ G,
                     const float* __restrict__ tot,
                     const float* __restrict__ dstate, int B, int H, int P,
                     int nc) {
  const long long PP = static_cast<long long>(P) * P;
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(B) * H * PP) return;
  const long long e = idx % PP;
  const int p = static_cast<int>(e / P);
  const int bh = static_cast<int>(idx / PP);
  const int h = bh % H, b = bh / H;
  const long long blk0 = static_cast<long long>(b) * nc * H + h;
  float s = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kChainAhead) {
    float l[kChainAhead], t[kChainAhead];
#pragma unroll
    for (int i = 0; i < kChainAhead; ++i) {
      const long long blk = blk0 + static_cast<long long>(c0 + i) * H;
      l[i] = c0 + i < nc ? loc[blk * PP + e] : 0.f;
      t[i] = c0 + i < nc ? tot[blk * P + p] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kChainAhead; ++i) {
      if (c0 + i >= nc) break;
      loc[(blk0 + static_cast<long long>(c0 + i) * H) * PP + e] = s;
      s = t[i] * s + l[i];
    }
  }
  float d = dstate ? dstate[idx] : 0.f;
  for (int c0 = nc - 1; c0 >= 0; c0 -= kChainAhead) {
    float g[kChainAhead], t[kChainAhead];
#pragma unroll
    for (int i = 0; i < kChainAhead; ++i) {
      const long long blk = blk0 + static_cast<long long>(c0 - i) * H;
      g[i] = c0 - i >= 0 ? G[blk * PP + e] : 0.f;
      t[i] = c0 - i >= 0 ? tot[blk * P + p] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kChainAhead; ++i) {
      if (c0 - i < 0) break;
      G[(blk0 + static_cast<long long>(c0 - i) * H) * PP + e] = d;
      d = t[i] * d + g[i];
    }
  }
}

// Pass 3: per (b, chunk, h), dr, dk, dv, dw of the chunk from its inputs,
// S0 and dS1, and this block's share of du.
__global__ void __launch_bounds__(kThreads)
wkv_bwd_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, const float* __restrict__ dy,
                     const float* __restrict__ S0,
                     const float* __restrict__ dS1, float* __restrict__ dr,
                     float* __restrict__ dk, float* __restrict__ dv,
                     float* __restrict__ dw, float* __restrict__ du_part,
                     int T_, int H, int P, int L) {
  extern __shared__ float smem[];
  float* rs = smem;
  float* ks = rs + kTile;
  float* vs = ks + kTile;
  float* ws = vs + kTile;
  float* dys = ws + kTile;
  float* s0 = dys + kTile;     // [p][q]
  float* ds1 = s0 + kTile;     // [p][q]
  float* cum = ds1 + kTile;
  float* qd = cum + kTile;     // qd, then dkw kw
  float* kd = qd + kTile;
  float* kw = kd + kTile;
  float* att = kw + kTile;     // [t][s], then cum's gradient [t][p]
  float* datt = att + kTile;   // [t][s], then dqd qd [t][p]
  float* tot = datt + kTile;   // [P]
  float* us = tot + kMax;      // [P]
  float* bonus = us + kMax;    // [L]  r_t . (u k_t)
  float* dbonus = bonus + kL;  // [L]  dy_t . v_t

  const int nc = T_ / L;
  const int blk = blockIdx.x;
  const int h = blk % H, bc = blk / H, c = bc % nc, b = bc / nc;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long stride = static_cast<long long>(H) * P;
  const long long base =
      (static_cast<long long>(b) * T_ + static_cast<long long>(c) * L) *
          stride + static_cast<long long>(h) * P;
  load_tile(rs, r + base, stride, L, P, tid);
  load_tile(ks, k + base, stride, L, P, tid);
  load_tile(vs, v + base, stride, L, P, tid);
  load_tile(ws, w + base, stride, L, P, tid);
  load_tile(dys, dy + base, stride, L, P, tid);
  const long long soff = static_cast<long long>(blk) * P * P;
  load_tile(s0, S0 + soff, P, P, P, tid);
  load_tile(ds1, dS1 + soff, P, P, P, tid);
  if (tid < kMax) us[tid] = tid < P ? u[h * P + tid] : 0.f;
  __syncthreads();
  cumulate(ws, cum, tot, L, P, tid);
  if (tid >= kMax && tid < kMax + kL) {   // meanwhile the bonus terms
    const int t = tid - kMax;
    float bo = 0.f, db = 0.f;
    for (int p = 0; p < P; ++p) {
      bo += rs[t * kLd + p] * (us[p] * ks[t * kLd + p]);
      db += dys[t * kLd + p] * vs[t * kLd + p];
    }
    bonus[t] = bo;
    dbonus[t] = db;
  }
  __syncthreads();
  decayed(rs, ks, ws, cum, tot, qd, kd, kw, L, P, tid);
  __syncthreads();

  // att and datt, strictly below the diagonal
  {
    float a1[4][4], a2[4][4];
    zero(a1);
    zero(a2);
    mm<false, true>(a1, qd, kd, P, ty, tx);
    mm<false, true>(a2, dys, vs, P, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = tx + 16 * j;
        const bool keep = s < t && t < L;
        att[t * kLd + s] = keep ? a1[i][j] : 0.f;
        datt[t * kLd + s] = keep ? a2[i][j] : 0.f;
      }
    }
  }
  __syncthreads();

  // every thread's (row, column) = (t, p) for dqd, (s, p) for dkd and dkw,
  // (s, q) for dv: the same positions, so the elementwise terms need no
  // exchange
  float dqd[4][4], dkd[4][4], dkw[4][4], acc[4][4];
  zero(dqd);
  mm<false, true>(dqd, dys, s0, P, ty, tx);
  mm<false, false>(dqd, datt, kd, L, ty, tx);
  zero(dkd);
  mm<true, false>(dkd, datt, qd, L, ty, tx);
  zero(dkw);
  mm<false, true>(dkw, vs, ds1, P, ty, tx);
  zero(acc);
  mm<true, false>(acc, att, dys, L, ty, tx);
  mm<false, false>(acc, kw, ds1, P, ty, tx);
  float gcum[4][4], gqd[4][4], gkw[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = ty + 16 * i;
    const long long grow = base + static_cast<long long>(t) * stride;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tx + 16 * j, o = t * kLd + p;
      gcum[i][j] = gqd[i][j] = gkw[i][j] = 0.f;
      if (t >= L || p >= P) continue;
      const float cm = cum[o];
      const float a_incl = expf(cm);
      const float a_excl = expf(cm - log_decay(ws[o]));
      const float den = fmaxf(a_incl, kAFloor);
      dv[grow + p] = acc[i][j] + bonus[t] * dys[o];
      dr[grow + p] = dqd[i][j] * a_excl + dbonus[t] * (us[p] * ks[o]);
      dk[grow + p] = (dkd[i][j] + dkw[i][j] * tot[p]) / den +
                     dbonus[t] * (us[p] * rs[o]);
      gqd[i][j] = dqd[i][j] * qd[o];
      gkw[i][j] = dkw[i][j] * kw[o];
      const float floored = a_incl > kAFloor
                                ? dkd[i][j] * kd[o] + gkw[i][j] : 0.f;
      gcum[i][j] = gqd[i][j] - floored;
    }
  }
  __syncthreads();   // att, datt, qd, kd and kw are no longer read
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = (ty + 16 * i) * kLd + tx + 16 * j;
      att[o] = gcum[i][j];
      datt[o] = gqd[i][j];
      qd[o] = gkw[i][j];
    }
  __syncthreads();

  // down each column p: cum's gradient at the last step gains total (S0 .
  // dS1)_p and the column sum of dkw kw; its reverse cumulative sum, less
  // dqd qd, is logw's gradient; over w it is dw.  Meanwhile du's share.
  if (tid < P) {
    const int p = tid;
    float ksum = 0.f, dot = 0.f;
    for (int s = 0; s < L; ++s) ksum += qd[s * kLd + p];
    for (int q = 0; q < P; ++q) dot += s0[p * kLd + q] * ds1[p * kLd + q];
    float run = tot[p] * dot + ksum;
    for (int t = L - 1; t >= 0; --t) {
      const int o = t * kLd + p;
      run += att[o];
      const float wt = ws[o];
      dw[base + static_cast<long long>(t) * stride + p] =
          wt > kWFloor ? (run - datt[o]) / wt : 0.f;
    }
  } else if (tid >= kMax && tid < kMax + P) {
    const int p = tid - kMax;
    float s = 0.f;
    for (int t = 0; t < L; ++t) {
      s += dbonus[t] * rs[t * kLd + p] * ks[t * kLd + p];
    }
    du_part[static_cast<long long>(blk) * P + p] = s;
  }
}

// Pass 4: du[h][p] summed over the (b, chunk) blocks in order.
__global__ void __launch_bounds__(kThreads)
wkv_bwd_du_kernel(const float* __restrict__ du_part, float* __restrict__ du,
                  int HP, int BC) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= HP) return;
  float s = 0.f;
  for (int i = 0; i < BC; ++i) s += du_part[static_cast<long long>(i) * HP + idx];
  du[idx] = s;
}

}  // namespace

// r, k, v, w, dy, dr, dk, dv, dw: (B, T, H*P) float32; u, du: (H, P)
// float32; dstate: (B, H, P, P) float32 or null (zero).  Scratch, all
// float32: states and grads (B, nc, H, P, P), small (2, B nc H P): each
// block's du share, then each chunk's total; nc = T / L.  T a multiple of
// L; P, L <= 64; every array contiguous.  Launches four kernels on
// `stream` and returns the first cudaGetLastError() that is not 0 (0 on
// success; -1 for a size the kernel does not take, which the wrapper rules
// out first).
extern "C" int wkv_bwd_launch(const float* r, const float* k, const float* v,
                              const float* w, const float* u, const float* dy,
                              const float* dstate, float* dr, float* dk,
                              float* dv, float* dw, float* du, float* states,
                              float* grads, float* small, int B, int T_,
                              int H, int P, int L, int device, void* stream) {
  if (P < 1 || P > kMax || L < 1 || L > kL || T_ % L != 0 || B < 1 ||
      H < 1 || T_ < 1) {
    return -1;
  }
  const long long blocks = static_cast<long long>(B) * H * (T_ / L);
  if (blocks > 0x7fffffffLL) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool configured = false;
  if (!configured) {
    err = cudaFuncSetAttribute(wkv_bwd_state_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kStateSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(wkv_bwd_chunk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kChunkSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = T_ / L;
  float* du_part = small;
  float* tot = small + blocks * P;
  wkv_bwd_state_kernel<<<static_cast<unsigned>(blocks), kThreads,
                         kStateSmem, st>>>(r, k, v, w, dy, states, grads, tot,
                                           T_, H, P, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long chain = static_cast<long long>(B) * H * P * P;
  wkv_bwd_chain_kernel<<<static_cast<unsigned>((chain + kThreads - 1) /
                                               kThreads),
                         kThreads, 0, st>>>(states, grads, tot, dstate, B, H,
                                            P, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  wkv_bwd_chunk_kernel<<<static_cast<unsigned>(blocks), kThreads,
                         kChunkSmem, st>>>(r, k, v, w, u, dy, states, grads,
                                           dr, dk, dv, dw, du_part, T_, H, P,
                                           L);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  wkv_bwd_du_kernel<<<(H * P + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      du_part, du, H * P, B * nc);
  return static_cast<int>(cudaGetLastError());
}
