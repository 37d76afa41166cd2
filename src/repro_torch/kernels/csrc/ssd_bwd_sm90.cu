// Backward of the Mamba-2 SSD chunked scan for Hopper (sm_90a), its
// products on the tensor cores (mma.sync TF32).
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
//   1. chunk states (one block per (b, chunk, group of heads)): each
//      head's share of the state, sum_s e_s dt_s x_s B_s^T, its share of
//      dS0, sum_t exp(cum_t) dy_t C_t^T, and exp(cum_end);
//   2. the chain (one thread per (b, h, p, n)): the chunk-start states S0
//      from the first chunk to the last, then dS1 from the last to the
//      first, starting at dS (or zero), each written over its share;
//   3. the chunks (one block per (b, chunk, group of heads)): every
//      gradient of the chunk, dB and dC summed over the block's heads in
//      shared memory;
//   4. the sums (one thread per (b, t, n), one block for dA): dB and dC
//      over the head groups, dA over batch and chunks, each in a fixed
//      order.
// The chunk-start states are recomputed here rather than written by the
// forward kernels, so the forward is unchanged and nothing is kept between
// the two directions; it costs pass 1's products and the two (B, nc, H, P,
// N) float32 buffers written and read twice: at zamba2-1.2b's train
// microbatch (B 4, T 1,024, H 64, P = N = 64) 4 x 67 MB, ~80 us at 3.35
// TB/s.  No floating-point atomics: two calls give the same bits.
//
// Bound (that shape): inputs and outputs are 105 MB in bf16 (208 MB in
// float32), 31 us (62 us) at 3.35 TB/s; the least products (five P x N x
// 64 a (b, chunk, h), the pair ones over the lower triangle, C B^T once per
// (b, chunk)) are 15.1 GFLOP, 15 us at the 989 TFLOP/s of bf16 tensor
// cores, 92 us at the 165 TFLOP/s of 3xTF32.  So bf16 is bound by bytes,
// float32 by products.
//
// Design.  Every product runs on mma.sync m16n8k8 TF32 through the tiles
// of scan_bwd_tiles.cuh (8 warps, each a 16 x 32 part of a 64 x 64 output,
// operands from padded float32 tiles in shared memory), in one path for
// both input types: bf16 inputs widened to float32 are exact in TF32, so a
// product of two inputs (C B^T, dy x^T) is one mma and one of an input and
// a value formed here (W, R, S0, dS1, the scaled x and dy of pass 1) two;
// float32 inputs take 3xTF32 throughout, float32 accuracy.  (bf16 mma
// m16n8k16 with hi / lo bf16 operands, as ssd_sm90.cu's forward, would
// run at twice TF32's rate, but needs three terms wherever a float32
// value meets an input and another fragment path for float32: one TF32
// path serves both types.)  Against the first, SIMT version of this
// kernel (eleven whole products a head on the CUDA cores):
//   - a block takes up to 8 heads of one (b, chunk) in turn: B and C are
//     loaded and C B^T formed once for them, and dB and dC are summed over
//     them in shared memory, so pass 4 reads an eighth of the partials;
//     fewer heads where 8 would leave the card under two blocks an SM (the
//     wrapper's choice, ssd.py::_bwd_heads: the smoke width's 8 heads);
//   - C S0^T is gone: dt's inter-chunk term reads dy S0 (which dC needs)
//     at C's places, a row sum in registers;
//   - tiles wholly above the diagonal are skipped: in dy x^T and C B^T (n-
//     tiles past the row tile's last row) and in W^T dy, R B, R^T C
//     (k-steps where W or R is zero), so 10 of 16 where the SIMT kernel
//     ran them all;
//   - each thread's accumulator element sits at the same (row, column) in
//     every product, so E, W, R, Q = E (C.B) (dy.x) and the terms of dx,
//     dB, dC combine in registers; the row and column sums of Q, x.dS1 B
//     and C.dy S0 are quad shuffles plus a fixed-order sum over the warps
//     that hold the rest of the row or column.
// Pass 3 holds eleven tiles (191 KB), one block an SM; the work of a
// triangle falls evenly on the SM's four sub-partitions (see the tiles).
// Pass 1 runs two blocks an SM.  cum, and cum's gradient with its reverse
// cumulative sum, are scans by warp 0, two steps a lane.  The chain reads
// 16 chunks' values before it writes any (all of them at T 1,024).  Padded
// steps of a ragged last chunk load as zero with dt = 0, which neither
// decays nor feeds the state, as in the plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scan_bwd_tiles.cuh"

namespace {

using namespace scan_tiles;

constexpr int kMaxHeads = 8;  // heads a block (pass 1 and pass 3) at most
constexpr size_t kStateSmem = (4 * kTile + 4 * kL) * sizeof(float);
// eleven tiles, seven vectors of kL, row-sum partials [3][2][kL],
// column-sum partials [4][kL], eight warp sums
constexpr size_t kChunkSmem = (11 * kTile + 17 * kL + 8) * sizeof(float);

// Whether a widened input is exact in TF32 (bf16) or is split (float32).
template <typename T>
struct Exact {
  static constexpr bool value = false;
};
template <>
struct Exact<__nv_bfloat16> {
  static constexpr bool value = true;
};

// Inclusive sums over a warp from lane 0 (prefix) or from lane 31
// (suffix), in a fixed order.
__device__ __forceinline__ float warp_prefix(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += y;
  }
  return v;
}
__device__ __forceinline__ float warp_suffix(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_down_sync(0xffffffffu, v, off);
    if (lane + off < 32) v += y;
  }
  return v;
}

// dt of the chunk (zero past `len`), cum (a scan by warp 0, two steps a
// lane), exp(cum_t) and e_t = exp(cum_end - cum_t).
__device__ __forceinline__ void chunk_decays(const float* dt, float a,
                                             long long dt_off, int H, int len,
                                             float* dts, float* cum,
                                             float* dec, float* ex_end,
                                             int tid) {
  if (tid < 32) {
    const int t1 = tid + 32;
    const float x0 = tid < len ? dt[dt_off + tid * H] : 0.f;
    const float x1 = t1 < len ? dt[dt_off + t1 * H] : 0.f;
    const float c0 = warp_prefix(x0 * a, tid);
    const float c1 = warp_prefix(x1 * a, tid) +
                     __shfl_sync(0xffffffffu, c0, 31);
    const float end = __shfl_sync(0xffffffffu, c1, 31);
    dts[tid] = x0;
    dts[t1] = x1;
    cum[tid] = c0;
    cum[t1] = c1;
    dec[tid] = expf(c0);
    dec[t1] = expf(c1);
    ex_end[tid] = expf(end - c0);
    ex_end[t1] = expf(end - c1);
  }
  __syncthreads();
}

// acc into the tile at dst at this thread's places (each place is this
// thread's alone), over what is there unless `first`.
__device__ __forceinline__ void add_to(float* dst, const float (&acc)[4][4],
                                       bool first, const Frag& f) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float* d = dst + f.row(e) * kLd + f.col(j, e);
      *d = first ? acc[j][e] : *d + acc[j][e];
    }
}

// Pass 1: per (b, chunk, h), loc = sum_s e_s dt_s x_s B_s^T (P x N),
// G = sum_t exp(cum_t) dy_t C_t^T (P x N) and tot = exp(cum_end), for the
// block's heads in turn.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const T* __restrict__ dy,
                     float* __restrict__ loc, float* __restrict__ G,
                     float* __restrict__ tot, int T_, int H, int P, int N,
                     int nc, int heads) {
  extern __shared__ float smem[];
  float* bs = smem;
  float* cs = bs + kTile;
  float* xs = cs + kTile;   // x, then x e dt
  float* dys = xs + kTile;  // dy, then dy exp(cum)
  float* dts = dys + kTile;
  float* cum = dts + kL;
  float* dec = cum + kL;
  float* ex_end = dec + kL;

  constexpr bool kS = !Exact<T>::value;
  const int ng = (H + heads - 1) / heads;
  const int hg = blockIdx.x % ng, bc = blockIdx.x / ng;
  const int c = bc % nc, b = bc / nc;
  const int tid = threadIdx.x;
  const Frag f = frag();
  const int t0 = c * kL, len = min(kL, T_ - t0);
  const int kn = (len + 7) / 8;
  const long long row = static_cast<long long>(b) * T_ + t0;
  const long long xrow = static_cast<long long>(H) * P;
  {
    float vb[kPer], vc[kPer];
    fetch_tile(vb, Bm + row * N, N, len, N, tid);
    fetch_tile(vc, Cm + row * N, N, len, N, tid);
    store_tile(bs, vb, tid);
    store_tile(cs, vc, tid);
  }
  for (int h = hg * heads; h < min(H, (hg + 1) * heads); ++h) {
    __syncthreads();  // the previous head's tiles are read
    {
      float vx[kPer], vy[kPer];
      fetch_tile(vx, x + (row * H + h) * P, xrow, len, P, tid);
      fetch_tile(vy, dy + (row * H + h) * P, xrow, len, P, tid);
      store_tile(xs, vx, tid);
      store_tile(dys, vy, tid);
    }
    chunk_decays(dt, A[h], row * H + h, H, len, dts, cum, dec, ex_end, tid);
    for (int i = tid; i < kL * kMax; i += kThreads) {
      const int t = i / kMax, d = i % kMax;
      xs[t * kLd + d] *= ex_end[t] * dts[t];
      dys[t * kLd + d] *= dec[t];
    }
    __syncthreads();
    const long long bh = static_cast<long long>(bc) * H + h;
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      float acc[4][4];
      zero(acc);
      mm<true, false, true, kS>(acc, pass ? dys : xs, pass ? cs : bs, 0, kn,
                                4, f);
      float* out = (pass ? G : loc) + bh * P * N;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = f.row(e), n = f.col(j, e);
          if (p < P && n < N) out[p * N + n] = acc[j][e];
        }
    }
    if (tid == 0) tot[bh] = dec[kL - 1];
  }
}

// Pass 2: per (b, h, p, n), the chunk-start states forward over the
// chunks, written over loc, then the end-of-chunk state gradients backward
// from dS (or zero), written over G.  Each walk reads kChainAhead chunks'
// values before it writes any, so that many loads are in flight.
constexpr int kChainAhead = 16;

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

// Pass 3: per (b, chunk, group of heads), every gradient of the chunk from its
// inputs, S0 and dS1: dx, ddt and this block's share of dA per head, dB and
// dC summed over the block's heads (summed over the groups in pass 4).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const T* __restrict__ dy,
                     const float* __restrict__ S0, const float* __restrict__ dS1,
                     T* __restrict__ dx, float* __restrict__ ddt,
                     float* __restrict__ dBg, float* __restrict__ dCg,
                     float* __restrict__ dA_part, int T_, int H, int P, int N,
                     int nc, int heads) {
  extern __shared__ float smem[];
  float* bs = smem;
  float* cs = bs + kTile;
  float* cb = cs + kTile;      // [t][s]  C_t.B_s, s <= t
  float* xs = cb + kTile;
  float* dys = xs + kTile;
  float* s0 = dys + kTile;     // [p][n]
  float* ds1 = s0 + kTile;     // [p][n]
  float* Wt = ds1 + kTile;     // [t][s]  E dt_s (C_t.B_s)
  float* Rt = Wt + kTile;      // [t][s]  E dt_s (dy_t.x_s)
  float* dBs = Rt + kTile;     // [s][n]  dB of the block's heads so far
  float* dCs = dBs + kTile;    // [t][n]  dC of the block's heads so far
  float* dts = dCs + kTile;
  float* cum = dts + kL;
  float* dec = cum + kL;
  float* ex_end = dec + kL;
  float* xbds = ex_end + kL;   // x_s . dS1 B_s
  float* colq = xbds + kL;     // sum_t Q[t][s]
  float* dloga = colq + kL;    // loga's gradient
  float* prow = dloga + kL;    // row-sum partials [3][2][kL]: x . dS1 B,
                               // C . dy S0, Q dt
  float* pcol = prow + 6 * kL; // Q's column-sum partials [4][kL]
  float* red = pcol + 4 * kL;  // [8] per-warp sums

  constexpr bool kS = !Exact<T>::value;
  const int ng = (H + heads - 1) / heads;
  const int hg = blockIdx.x % ng, bc = blockIdx.x / ng;
  const int c = bc % nc, b = bc / nc;
  const int tid = threadIdx.x;
  const Frag f = frag();
  const int t0 = c * kL, len = min(kL, T_ - t0);
  const int kn = (len + 7) / 8, kp = (P + 7) / 8, kN = (N + 7) / 8;
  const int jl = lower_tiles(f);
  const long long row = static_cast<long long>(b) * T_ + t0;
  const long long xrow = static_cast<long long>(H) * P;
  {
    float vb[kPer], vc[kPer];
    fetch_tile(vb, Bm + row * N, N, len, N, tid);
    fetch_tile(vc, Cm + row * N, N, len, N, tid);
    store_tile(bs, vb, tid);
    store_tile(cs, vc, tid);
  }
  __syncthreads();
  {  // C B^T once for the block's heads, s <= t
    float acc[4][4];
    zero(acc);
    mm<false, true, kS, kS>(acc, cs, bs, 0, kN, jl, f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= jl) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = f.row(e), s = f.col(j, e);
        cb[t * kLd + s] = s <= t ? acc[j][e] : 0.f;
      }
    }
  }

  for (int h = hg * heads; h < min(H, (hg + 1) * heads); ++h) {
    __syncthreads();  // C B^T written; the previous head's tiles read
    const float a = A[h];
    const long long bh = static_cast<long long>(bc) * H + h;
    {
      float vx[kPer], vy[kPer];
      fetch_tile(vx, x + (row * H + h) * P, xrow, len, P, tid);
      fetch_tile(vy, dy + (row * H + h) * P, xrow, len, P, tid);
      store_tile(xs, vx, tid);
      store_tile(dys, vy, tid);
      fetch_tile(vx, S0 + bh * P * N, N, P, N, tid);
      fetch_tile(vy, dS1 + bh * P * N, N, P, N, tid);
      store_tile(s0, vx, tid);
      store_tile(ds1, vy, tid);
    }
    chunk_decays(dt, a, row * H + h, H, len, dts, cum, dec, ex_end, tid);

    // the pair terms, s <= t: W and R to shared memory, Q's row sums (times
    // dt_s) and column sums
    {
      float acc[4][4], qc[4][2] = {}, lo = 0.f, hi = 0.f;
      zero(acc);
      mm<false, true, kS, kS>(acc, dys, xs, 0, kp, jl, f);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= jl) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = f.row(e), s = f.col(j, e);
          float wv = 0.f, rv = 0.f, qv = 0.f;
          if (s <= t) {
            const float E = expf(cum[t] - cum[s]);
            const float cbv = cb[t * kLd + s];
            wv = E * cbv * dts[s];
            rv = E * dts[s] * acc[j][e];
            qv = E * cbv * acc[j][e];
          }
          Wt[t * kLd + s] = wv;
          Rt[t * kLd + s] = rv;
          qc[j][e & 1] += qv;
          (e < 2 ? lo : hi) += qv * dts[s];
        }
      }
      row_sums(lo, hi, prow + 4 * kL, f);
      col_sums(qc, pcol, f);
    }
    __syncthreads();  // W and R are written

    float acc[4][4];
    // dS1 B_s, its dot with x_s, and dx = W^T dy + e_s dt_s dS1 B_s
    {
      float lo = 0.f, hi = 0.f;
      zero(acc);
      mm<false, true, kS, true>(acc, bs, ds1, 0, kN, 4, f);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = f.row(e);
          (e < 2 ? lo : hi) += xs[s * kLd + f.col(j, e)] * acc[j][e];
          acc[j][e] *= ex_end[s] * dts[s];
        }
      row_sums(lo, hi, prow, f);
      mm<true, false, true, kS>(acc, Wt, dys, 2 * f.wm, kn, 4, f);
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int s = f.row(e);
        if (s >= len) continue;
        T* out = dx + ((row + s) * H + h) * P;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          put2(out, f.col(j, e), P, acc[j][e], acc[j][e + 1]);
        }
      }
    }
    // dC = exp(cum_t) dy S0 + R B, and C_t . (dy S0)_t for dt's gradient
    {
      float lo = 0.f, hi = 0.f;
      zero(acc);
      mm<false, false, kS, true>(acc, dys, s0, 0, kp, 4, f);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = f.row(e);
          (e < 2 ? lo : hi) += cs[t * kLd + f.col(j, e)] * acc[j][e];
          acc[j][e] *= dec[t];
        }
      row_sums(lo, hi, prow + 2 * kL, f);
      mm<false, false, true, kS>(acc, Rt, bs, 0, min(kn, 2 * f.wm + 2), 4, f);
      add_to(dCs, acc, h == hg * heads, f);
    }
    // dB = R^T C + e_s dt_s x dS1
    zero(acc);
    mm<false, false, kS, true>(acc, xs, ds1, 0, kp, 4, f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = f.row(e);
        acc[j][e] *= ex_end[s] * dts[s];
      }
    mm<true, false, true, kS>(acc, Rt, cs, 2 * f.wm, kn, 4, f);
    add_to(dBs, acc, h == hg * heads, f);

    // S0 . dS1
    float dot = 0.f;
    for (int i = tid; i < P * N; i += kThreads) {
      const int o = (i / N) * kLd + i % N;
      dot += s0[o] * ds1[o];
    }
    dot = warp_sum(dot);
    if (tid % 32 == 0) red[tid / 32] = dot;
    __syncthreads();  // every partial is written

    // by warp 0, two steps a lane: the partials' sums, cum's gradient, its
    // reverse cumulative sum (loga's gradient) and this head's share of dA
    if (tid < 32) {
      float s0ds1 = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) s0ds1 += red[w];
      float dc[2], kt[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = tid + 32 * i;
        const float xb = prow[t] + prow[kL + t];
        const float inter = dec[t] * (prow[2 * kL + t] + prow[3 * kL + t]);
        const float rowm = prow[4 * kL + t] + prow[5 * kL + t];
        const float cq = ((pcol[t] + pcol[kL + t]) + pcol[2 * kL + t]) +
                         pcol[3 * kL + t];
        xbds[t] = xb;
        colq[t] = cq;
        kt[i] = ex_end[t] * dts[t] * xb;
        dc[i] = inter + rowm - dts[t] * cq - kt[i];
      }
      const float k_sum = warp_sum(kt[0] + kt[1]);
      if (tid == 31) dc[1] += k_sum + dec[kL - 1] * s0ds1;
      const float l1 = warp_suffix(dc[1], tid);
      const float l0 = warp_suffix(dc[0], tid) +
                       __shfl_sync(0xffffffffu, l1, 0);
      dloga[tid] = l0;
      dloga[tid + 32] = l1;
      const float da = warp_sum(l0 * dts[tid] + l1 * dts[tid + 32]);
      if (tid == 0) dA_part[bh] = da;
    }
    __syncthreads();
    if (tid < len) {
      ddt[(row + tid) * H + h] =
          colq[tid] + ex_end[tid] * xbds[tid] + dloga[tid] * a;
    }
  }

  // dB and dC of the block's heads, summed in head order
  float* db = dBg + (row * ng + hg) * N;
  float* dc = dCg + (row * ng + hg) * N;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = f.row(e);
    if (t >= len) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = f.col(j, e);
      if (n < N) {
        db[static_cast<long long>(t) * ng * N + n] = dBs[t * kLd + n];
        dc[static_cast<long long>(t) * ng * N + n] = dCs[t * kLd + n];
      }
    }
  }
}

// Pass 4: dB and dC summed over the head groups in order, one thread per
// (b, t, n); the last block sums dA over the (b, chunk) blocks in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_sum_kernel(const float* __restrict__ dBg,
                   const float* __restrict__ dCg,
                   const float* __restrict__ dA_part, T* __restrict__ dB,
                   T* __restrict__ dC, float* __restrict__ dA, long long BTN,
                   int H, int ng, int N, int BC) {
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
  for (int gi = 0; gi < ng; ++gi) {
    const long long o = (bt * ng + gi) * N + n;
    sb += dBg[o];
    sc += dCg[o];
  }
  put(dB + idx, sb);
  put(dC + idx, sc);
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* dy, const void* dstate, void* dx,
           void* ddt, void* dA, void* dB, void* dC, void* states, void* grads,
           void* dBg, void* dCg, void* dA_part, void* tot, int B, int T_,
           int H, int P, int N, int heads, cudaStream_t st) {
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
  const int ng = (H + heads - 1) / heads;
  const unsigned blocks = static_cast<unsigned>(B) * nc * ng;
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
      xt, dtf, af, bt, ct, dyt, sf, gf, totf, T_, H, P, N, nc, heads);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long chain = static_cast<long long>(B) * H * P * N;
  ssd_bwd_chain_kernel<<<static_cast<unsigned>((chain + kThreads - 1) /
                                               kThreads),
                         kThreads, 0, st>>>(
      sf, gf, totf, static_cast<const float*>(dstate), B, H, P * N, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_kernel<T><<<blocks, kThreads, kChunkSmem, st>>>(
      xt, dtf, af, bt, ct, dyt, sf, gf, static_cast<T*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dBg),
      static_cast<float*>(dCg), static_cast<float*>(dA_part), T_, H, P, N,
      nc, heads);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long btn = static_cast<long long>(B) * T_ * N;
  ssd_bwd_sum_kernel<T><<<static_cast<unsigned>((btn + kThreads - 1) /
                                                kThreads) + 1,
                          kThreads, 0, st>>>(
      static_cast<const float*>(dBg), static_cast<const float*>(dCg),
      static_cast<const float*>(dA_part), static_cast<T*>(dB),
      static_cast<T*>(dC), static_cast<float*>(dA), btn, H, ng, N, B * nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dy, dx: (B, T, H, P); dt, ddt: (B, T, H) float32; A, dA: (H,)
// float32; B, C, dB, dC: (B, T, N); dstate: (B, H, P, N) float32 or null
// (zero).  `heads` heads a block, 1 to 8.  Scratch, all float32: states
// and grads (B, nc, H, P, N), dBg and dCg (B, T, ceil(H / heads), N),
// dA_part and tot (B nc H), nc = ceil(T / 64).  x, B, C, dy and the
// outputs like them all float32 (dtype 0) or all bfloat16 (dtype 1); P, N
// <= 64; every array contiguous.  Launches four kernels on `stream` and
// returns the first cudaGetLastError() that is not 0 (0 on success; -1 for
// an unsupported dtype or size, which the wrapper rules out first).
extern "C" int ssd_bwd_launch(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* dy,
                              const void* dstate, void* dx, void* ddt,
                              void* dA, void* dB, void* dC, void* states,
                              void* grads, void* dBg, void* dCg,
                              void* dA_part, void* tot, int B, int T_, int H,
                              int P, int N, int heads, int dtype, int device,
                              void* stream) {
  if (P < 1 || P > kMax || N < 1 || N > kMax || B < 1 || T_ < 1 || H < 1 ||
      heads < 1 || heads > kMaxHeads) {
    return -1;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, dt, A, Bm, Cm, dy, dstate, dx, ddt, dA, dB, dC,
                         states, grads, dBg, dCg, dA_part, tot, B, T_, H, P,
                         N, heads, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, dy, dstate, dx, ddt, dA,
                                 dB, dC, states, grads, dBg, dCg, dA_part,
                                 tot, B, T_, H, P, N, heads, st);
  }
  return -1;
}
