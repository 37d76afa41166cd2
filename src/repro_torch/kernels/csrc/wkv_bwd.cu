// Backward of the RWKV-6 chunked WKV scan for Hopper (sm_90a), its
// products on the tensor cores in 3xTF32 (mma.sync), chunks of up to 128
// steps.
//
// Replaces no TPU kernel: repro/kernels/rwkv_wkv.py::wkv_pallas has no
// backward, and JAX trains through autodiff of its jnp scan
// (repro/models/rwkv.py::wkv_chunked).  The port's forward runs in a
// kernel (csrc/wkv.cu), so its gradient is this hand-written VJP of the
// same function, the arithmetic of kernels/rwkv_wkv.py::wkv_bwd_plain.
// For r, k, v, w (B, T, H*P) float32, the bonus u (H, P), the output
// gradient dy and the final state's gradient dS (B, H, P, P, or none for
// zero), per chunk of L <= 128 steps with JAX's floors, logw = log(max(w,
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
// step ~36 of a chunk).  So the kernel is finite where JAX is NaN.  Past
// step ~64 of a chunk at that decay A_excl leaves float32's normal range
// (and is 0 past ~86) and 1/D sits at the 1e-30 floor: the plain version
// forms the same values, and what the split into TF32 loses of a value
// below the normal range is at most ~2^-11 of a term of ~1e-38 x 1e30.
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
// TFLOP/s of 3xTF32.  So the bound is bytes.
//
// Design.  Every product runs in 3xTF32 on mma.sync m16n8k8 through the
// tiles of scan_bwd_tiles.cuh (8 warps, each a 16 x 32 part of a 64 x 64
// output, operands from padded float32 tiles in shared memory).  A chunk of
// more than 64 steps is taken as two 64-row halves: its pair matrices are
// two lower triangles and one full 64 x 64 block, in which rows 64-127 read
// the first half's kd and v.  The outputs are formed half by half; each
// half holds dqd, dkd, dkw and dv in registers at the same (row, column)
// of every thread, so dr, dk, dv and cum's gradient combine there, and no
// product of the second half reads the first half's qd, so dqd qd takes
// its place.  The pair blocks go one at a time through one shared tile:
// datt(h, h') for h' <= h feeds dqd of half h, its transpose dkd of half
// h' (the off-diagonal block is formed twice, once for each half),
// att(h', h) for h' >= h feeds dv of half h; tiles wholly above a diagonal
// are neither formed nor read.  kw is kd times total, taken as kd scaled by
// total where it is an operand.  Pass 3 keeps qd, kd, v, dy and cum of each
// half, S0, dS1 and the pair tile: thirteen tiles (226 KB) for chunks of
// 65-128 steps, where the elementwise terms and the scans read r, k and w
// again from device memory (L2); up to 64 steps it also keeps r, k and w as
// read, eleven tiles (191 KB).  One block an SM either way.  (Read again at
// chunks of 64 too, the call took 1.53x as long at rwkv6-7b's microbatch on
// an H100: the elementwise terms' reads at the fragments' places are
// scattered, and the chunk pass rose from 0.96 to 1.67 ms.)  Against the
// first, SIMT version of this kernel (ten whole products on the CUDA cores
// from thirteen tiles of one 64-row chunk): the products on the tensor
// cores, none over a tile the triangles leave empty, and the tiles' loads
// in flight together.
// The cumulative log-decay is a sequential sum down each column in step
// order, by P threads, as in the forward kernel and the plain version, so
// the floors bind at the same steps (every log-decay is formed first, by
// all threads); logf / expf at full precision and IEEE division.  The
// column sums of dkw kw are shuffles and a sum over the row tiles' warps,
// the reverse cumulative sum takes four threads a column, a quarter of the
// steps each; all in a fixed order.  Pass 1 runs two blocks an SM.
#include <cuda_runtime.h>

#include "scan_bwd_tiles.cuh"

namespace {

using namespace scan_tiles;

constexpr float kWFloor = 1e-38f;
constexpr float kAFloor = 1e-30f;
constexpr int kMaxChunk = 2 * kL;  // two 64-row halves

// pass 1: qd, kw, v, dy, cum of each half, total
constexpr size_t state_smem(int NH) {
  return (5 * NH * kTile + kMax) * sizeof(float);
}
// pass 3: qd, kd, v, dy, cum of each half, S0, dS1, the pair tile, and for
// chunks of up to 64 steps w, r and k as they are read; total, u, the bonus
// terms of each step, the column-sum partials of dkw kw
__host__ __device__ constexpr bool keeps_raw(int NH) { return NH == 1; }
constexpr size_t chunk_smem(int NH) {
  return ((5 * NH + 3 + (keeps_raw(NH) ? 3 : 0)) * kTile + 2 * kMax +
          2 * NH * kL + 4 * NH * kMax) *
         sizeof(float);
}

__device__ __forceinline__ float log_decay(float w) {
  return logf(fmaxf(w, kWFloor));
}

// The chunk's rows of w, r, k, v, dy (an (B, T, H*P) input each, at base)
// into the NH 64-row halves of the tile pairs at cum, a, b, vs and dys (w
// 1 past L rows and P columns, the others 0), three and two tiles' loads in
// flight together.
template <int NH>
__device__ __forceinline__ void load_chunk(
    float* cum, float* a, float* b, float* vs, float* dys, const float* w,
    const float* r, const float* k, const float* v, const float* dy,
    long long base, long long stride, int L, int P, int tid) {
#pragma unroll 1
  for (int hh = 0; hh < NH; ++hh) {
    const long long off = base + hh * kL * stride;
    const int rows = min(kL, L - hh * kL), o = hh * kTile;
    float v0[kPer], v1[kPer], v2[kPer];
    fetch_tile(v0, w + off, stride, rows, P, tid, 1.f);
    fetch_tile(v1, r + off, stride, rows, P, tid);
    fetch_tile(v2, k + off, stride, rows, P, tid);
    store_tile(cum + o, v0, tid);
    store_tile(a + o, v1, tid);
    store_tile(b + o, v2, tid);
    fetch_tile(v0, v + off, stride, rows, P, tid);
    fetch_tile(v1, dy + off, stride, rows, P, tid);
    store_tile(vs + o, v0, tid);
    store_tile(dys + o, v1, tid);
  }
}

// cum down each of the P columns in step order (P threads), and total (1
// past P): first every log-decay, from w's tile at `ws` into cum (in place
// where ws is cum), by all threads, then the P sequential sums.  Ends
// before a barrier.
__device__ __forceinline__ void cumulate(float* cum, const float* ws,
                                         float* tot, int L, int P, int NH,
                                         int tid) {
  for (int i = tid; i < NH * kL * kMax; i += kThreads) {
    const int o = (i / kMax) * kLd + i % kMax;
    cum[o] = log_decay(ws[o]);
  }
  __syncthreads();
  if (tid < kMax) {
    float run = 0.f;
    if (tid < P) {
#pragma unroll 8
      for (int t = 0; t < L; ++t) {
        run += cum[t * kLd + tid];
        cum[t * kLd + tid] = run;
      }
    }
    tot[tid] = expf(run);
  }
}

// qd = r A_excl and kd = k / D (kw = k total / D with Kw), from the tiles
// of w, r and k at ws, rs, ks where Raw (every element: past L rows and P
// columns r and k are 0, w 1), else in place over r and k with w read
// again from device memory (each thread's loads of a half before any use;
// past L rows and P columns r and k are 0 and stay so).
template <int NH, bool Kw, bool Raw>
__device__ __forceinline__ void decays(float* qd, float* kd, const float* rs,
                                       const float* ks, const float* ws,
                                       const float* cum, const float* tot,
                                       const float* w, long long base,
                                       long long stride, int L, int P,
                                       int tid) {
#pragma unroll 1
  for (int hh = 0; hh < NH; ++hh) {
    float wv[kPer];
    if (!Raw) {
      fetch_tile(wv, w + base + hh * kL * stride, stride, min(kL, L - hh * kL),
                 P, tid, 1.f);
    }
    const int p = tid % kMax;
#pragma unroll
    for (int it = 0; it < kPer; ++it) {
      const int t = hh * kL + tid / kMax + kStep * it, o = t * kLd + p;
      if (Raw || (t < L && p < P)) {
        const float cm = cum[o];
        const float den = fmaxf(expf(cm), kAFloor);
        const float rr = Raw ? rs[o] : qd[o], kk = Raw ? ks[o] : kd[o];
        qd[o] = rr * expf(cm - log_decay(Raw ? ws[o] : wv[it]));
        kd[o] = Kw ? kk * (tot[p] / den) : kk / den;
      }
    }
  }
}

// Pass 1: per (b, chunk, h), loc = kw^T v (P x P), G = qd^T dy (P x P)
// and the chunk's total (P).
template <int NH>
__global__ void __launch_bounds__(kThreads)
wkv_bwd_state_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ dy, float* __restrict__ loc,
                     float* __restrict__ G, float* __restrict__ tot_out,
                     int T_, int H, int P, int L) {
  extern __shared__ float smem[];
  constexpr int kHalf = NH * kTile;  // a tile of NH halves
  float* qd = smem;          // r, then qd
  float* kw = qd + kHalf;    // k, then kw
  float* vs = kw + kHalf;
  float* dys = vs + kHalf;
  float* cum = dys + kHalf;  // w, then cum
  float* tot = cum + kHalf;  // [kMax]

  const int nc = T_ / L;
  const int blk = blockIdx.x;
  const int h = blk % H, bc = blk / H, c = bc % nc, b = bc / nc;
  const int tid = threadIdx.x;
  const Frag f = frag();
  const long long stride = static_cast<long long>(H) * P;
  const long long base =
      (static_cast<long long>(b) * T_ + static_cast<long long>(c) * L) *
          stride + static_cast<long long>(h) * P;
  load_chunk<NH>(cum, qd, kw, vs, dys, w, r, k, v, dy, base, stride, L, P,
                 tid);
  __syncthreads();
  cumulate(cum, cum, tot, L, P, NH, tid);
  __syncthreads();
  decays<NH, true, false>(qd, kw, qd, kw, cum, cum, tot, w, base, stride, L,
                          P, tid);
  __syncthreads();
  const int kl = (L + 7) / 8;  // the halves lie one after the other
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    float acc[4][4];
    zero(acc);
    mm<true, false, true, true>(acc, pass ? qd : kw, pass ? dys : vs, 0, kl,
                                4, f);
    float* out = (pass ? G : loc) + static_cast<long long>(blk) * P * P;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = f.row(e), q = f.col(j, e);
        if (p < P && q < P) out[p * P + q] = acc[j][e];
      }
  }
  if (tid < P) tot_out[static_cast<long long>(blk) * P + tid] = tot[tid];
}

// Pass 2: per (b, h, p, q), the chunk-start states forward over the
// chunks, written over loc, then the end-of-chunk state gradients backward
// from dS (or zero), written over G; row p decays by total[p].  Each walk
// reads kChainAhead chunks' values before it writes any, so that many
// loads are in flight.
constexpr int kChainAhead = 16;

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

// A pair block [t][s] = sum_q a[t][q] b[s][q] (3xTF32) into `pair`, s < t
// only where `strict` (the tiles wholly above the diagonal neither formed
// nor written), between barriers: the previous pair is read, this one is
// written.
__device__ __forceinline__ void form_pair(float* pair, const float* a,
                                          const float* b, bool strict, int kp,
                                          int jl, const Frag& f) {
  float acc[4][4];
  zero(acc);
  const int jn = strict ? jl : 4;
  mm<false, true, true, true>(acc, a, b, 0, kp, jn, f);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= jn) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = f.row(e), s = f.col(j, e);
      pair[t * kLd + s] = strict && s >= t ? 0.f : acc[j][e];
    }
  }
  __syncthreads();
}

// Pass 3: per (b, chunk, h), dr, dk, dv, dw of the chunk from its inputs,
// S0 and dS1, and this block's share of du.
template <int NH>
__global__ void __launch_bounds__(kThreads, 1)
wkv_bwd_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, const float* __restrict__ dy,
                     const float* __restrict__ S0,
                     const float* __restrict__ dS1, float* __restrict__ dr,
                     float* __restrict__ dk, float* __restrict__ dv,
                     float* __restrict__ dw, float* __restrict__ du_part,
                     int T_, int H, int P, int L) {
  extern __shared__ float smem[];
  constexpr int kHalf = NH * kTile;
  constexpr bool kRaw = keeps_raw(NH);
  float* qd = smem;            // (r,) qd, then dqd qd
  float* kd = qd + kHalf;      // (k,) kd (, then w)
  float* vs = kd + kHalf;      // v (, then r)
  float* dys = vs + kHalf;     // dy (, then k)
  float* cum = dys + kHalf;    // (w,) cum, then cum's gradient
  float* s0 = cum + kHalf;     // [p][q]
  float* ds1 = s0 + kTile;     // [p][q]
  float* pair = ds1 + kTile;   // [t][s] datt or att, one block at a time
  float* raw = pair + kTile;   // w, r, k as read, where kept
  float* tot = raw + (kRaw ? 3 * kTile : 0);  // [kMax]
  float* us = tot + kMax;      // [kMax]
  float* bonus = us + kMax;    // [NH kL]  r_t . (u k_t)
  float* dbonus = bonus + NH * kL;  // [NH kL]  dy_t . v_t
  float* colk = dbonus + NH * kL;   // [4 NH][kMax] partials of dkw kw
  // where w, r and k are read from, from the decays on
  float* wsrc = kRaw ? raw : kd;
  float* rsrc = kRaw ? raw + kTile : vs;
  float* ksrc = kRaw ? raw + 2 * kTile : dys;

  const int nc = T_ / L;
  const int blk = blockIdx.x;
  const int h = blk % H, bc = blk / H, c = bc % nc, b = bc / nc;
  const int tid = threadIdx.x, lane = tid & 31;
  const Frag f = frag();
  const long long stride = static_cast<long long>(H) * P;
  const long long base =
      (static_cast<long long>(b) * T_ + static_cast<long long>(c) * L) *
          stride + static_cast<long long>(h) * P;
  const long long soff = static_cast<long long>(blk) * P * P;
  if (tid < kMax) us[tid] = tid < P ? u[h * P + tid] : 0.f;
  if (kRaw) {
    load_chunk<NH>(wsrc, rsrc, ksrc, vs, dys, w, r, k, v, dy, base, stride,
                   L, P, tid);
  } else {
    load_chunk<NH>(cum, qd, kd, vs, dys, w, r, k, v, dy, base, stride, L, P,
                   tid);
  }
  {
    float v0[kPer], v1[kPer];
    fetch_tile(v0, S0 + soff, P, P, P, tid);
    fetch_tile(v1, dS1 + soff, P, P, P, tid);
    store_tile(s0, v0, tid);
    store_tile(ds1, v1, tid);
  }
  __syncthreads();
  // the bonus terms, a warp a step, before qd and kd take r's and k's place
  {
    const float* rr = kRaw ? rsrc : qd;
    const float* kk = kRaw ? ksrc : kd;
    for (int t = tid >> 5; t < NH * kL; t += kThreads / 32) {
      float bo = 0.f, db = 0.f;
      for (int p = lane; p < kMax; p += 32) {
        const int o = t * kLd + p;
        bo += rr[o] * (us[p] * kk[o]);
        db += dys[o] * vs[o];
      }
      bo = warp_sum(bo);
      db = warp_sum(db);
      if (lane == 0) {
        bonus[t] = bo;
        dbonus[t] = db;
      }
    }
  }
  cumulate(cum, kRaw ? wsrc : cum, tot, L, P, NH, tid);
  __syncthreads();
  decays<NH, false, kRaw>(qd, kd, rsrc, ksrc, wsrc, cum, tot, w, base,
                          stride, L, P, tid);
  __syncthreads();

  const int kp = (P + 7) / 8;
  const int jl = lower_tiles(f);
#pragma unroll 1
  for (int rh = 0; rh < NH; ++rh) {
    const int off = rh * kTile;  // half rh of a tile pair
    float dqd[4][4], dkd[4][4], dkw[4][4], dva[4][4];
    zero(dkw);
    mm<false, true, true, true>(dkw, vs + off, ds1, 0, kp, 4, f);
    zero(dqd);
    mm<false, true, true, true>(dqd, dys + off, s0, 0, kp, 4, f);
    zero(dkd);
    zero(dva);
    // datt(rh, sh), sh <= rh: dqd += datt kd; on the diagonal dkd += datt^T qd
    for (int sh = 0; sh <= rh; ++sh) {
      const bool diag = sh == rh;
      form_pair(pair, dys + off, vs + sh * kTile, diag, kp, jl, f);
      mm<false, false, true, true>(dqd, pair, kd + sh * kTile, 0,
                                   diag ? 2 * f.wm + 2 : 8, 4, f);
      if (diag) mm<true, false, true, true>(dkd, pair, qd + off, 2 * f.wm, 8,
                                            4, f);
    }
    // datt(th, rh), th > rh: dkd += datt^T qd
    for (int th = rh + 1; th < NH; ++th) {
      form_pair(pair, dys + th * kTile, vs + off, false, kp, jl, f);
      mm<true, false, true, true>(dkd, pair, qd + th * kTile, 0, 8, 4, f);
    }
    // att(th, rh), th >= rh: dv += att^T dy
    for (int th = rh; th < NH; ++th) {
      const bool diag = th == rh;
      form_pair(pair, qd + th * kTile, kd + off, diag, kp, jl, f);
      mm<true, false, true, true>(dva, pair, dys + th * kTile,
                                  diag ? 2 * f.wm : 0, 8, 4, f);
    }
    // dv += kw dS1, kw = kd total
    mm<false, false, true, true, true>(dva, kd + off, ds1, 0, kp, 4, f, tot);

    // the elementwise terms at this thread's (row, column)s; cum's gradient
    // written over cum (each place is this thread's alone)
    float gq[4][4], gkc[4][2] = {};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // w, r and k at this n-tile's places: from their tiles, or read again
      // from device memory (each load before any use)
      float rv[4], kv[4], wv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = rh * kL + f.row(e), p = f.col(j, e);
        const int o = t * kLd + p;
        const bool in = t < L && p < P;
        const long long gi = base + t * stride + p;
        rv[e] = kRaw ? rsrc[o] : in ? r[gi] : 0.f;
        kv[e] = kRaw ? ksrc[o] : in ? k[gi] : 0.f;
        wv[e] = kRaw ? wsrc[o] : in ? w[gi] : 1.f;
      }
#pragma unroll
      float ov[3][4];  // dv, dr, dk, stored two columns at a time
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = rh * kL + f.row(e), p = f.col(j, e);
        const int o = t * kLd + p;
        float gqv = 0.f, gkv = 0.f, gc = 0.f;
        ov[0][e] = ov[1][e] = ov[2][e] = 0.f;
        if (t < L && p < P) {
          const float rr = rv[e], kk = kv[e];
          const float cm = cum[o];
          const float a_incl = expf(cm);
          const float a_excl = expf(cm - log_decay(wv[e]));
          const float den = fmaxf(a_incl, kAFloor);
          ov[0][e] = dva[j][e] + bonus[t] * dys[o];
          ov[1][e] = dqd[j][e] * a_excl + dbonus[t] * (us[p] * kk);
          ov[2][e] = (dkd[j][e] + dkw[j][e] * tot[p]) / den +
                     dbonus[t] * (us[p] * rr);
          gqv = dqd[j][e] * qd[o];
          gkv = dkw[j][e] * (kk * (tot[p] / den));
          gc = gqv - (a_incl > kAFloor ? dkd[j][e] * kd[o] + gkv : 0.f);
        }
        gq[j][e] = gqv;
        gkc[j][e & 1] += gkv;
        cum[o] = gc;
      }
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int t = rh * kL + f.row(e), p = f.col(j, e);
        if (t >= L) continue;
        const long long gi = base + t * stride;
        put2(dv + gi, p, P, ov[0][e], ov[0][e + 1]);
        put2(dr + gi, p, P, ov[1][e], ov[1][e + 1]);
        put2(dk + gi, p, P, ov[2][e], ov[2][e + 1]);
      }
    }
    col_sums(gkc, colk + rh * 4 * kMax, f);
    // no product reads this half's qd again (the second half's read only
    // its own): dqd qd takes its place
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        qd[(rh * kL + f.row(e)) * kLd + f.col(j, e)] = gq[j][e];
      }
  }
  // where w, r and k are not kept, kd, v and dy (no longer read) take them
  // for the scans down the columns
#pragma unroll
  for (int hh = 0; hh < (kRaw ? 0 : NH); ++hh) {
    const long long off = base + hh * kL * stride;
    const int rows = min(kL, L - hh * kL), o = hh * kTile;
    float v0[kPer], v1[kPer], v2[kPer];
    fetch_tile(v0, w + off, stride, rows, P, tid, 1.f);
    fetch_tile(v1, r + off, stride, rows, P, tid);
    fetch_tile(v2, k + off, stride, rows, P, tid);
    store_tile(kd + o, v0, tid);
    store_tile(vs + o, v1, tid);
    store_tile(dys + o, v2, tid);
  }
  __syncthreads();

  // down each column p, by four threads a column, each over a quarter of
  // the steps: cum's gradient at the last step gains total (S0 . dS1)_p
  // and the column sum of dkw kw; its reverse cumulative sum, less dqd qd,
  // is logw's gradient; over w it is dw.  And du's share.  The quarters'
  // sums meet in a fixed order.
  {
    float* part = pair;  // [4][kMax] each, for four sums (pair is free)
    const int p = tid % kMax, sg = tid / kMax, seg = (L + 3) / 4;
    const int t0 = sg * seg, t1 = min(L, t0 + seg);
    float gsum = 0.f, usum = 0.f, dot = 0.f;
    if (p < P) {
      for (int t = t1 - 1; t >= t0; --t) {
        const int o = t * kLd + p;
        gsum += cum[o];
        usum += dbonus[t] * rsrc[o] * ksrc[o];
      }
      for (int q = 16 * sg; q < 16 * sg + 16; ++q) {
        dot += s0[p * kLd + q] * ds1[p * kLd + q];
      }
    }
    part[sg * kMax + p] = gsum;
    part[(4 + sg) * kMax + p] = usum;
    part[(8 + sg) * kMax + p] = dot;
    __syncthreads();
    if (p < P) {
      if (sg == 0) {
        du_part[static_cast<long long>(blk) * P + p] =
            ((part[4 * kMax + p] + part[5 * kMax + p]) + part[6 * kMax + p]) +
            part[7 * kMax + p];
      }
      float ksum = 0.f;
      for (int i = 0; i < 4 * NH; ++i) ksum += colk[i * kMax + p];
      const float d = ((part[8 * kMax + p] + part[9 * kMax + p]) +
                       part[10 * kMax + p]) + part[11 * kMax + p];
      float run = tot[p] * d + ksum;
      for (int i = 3; i > sg; --i) run += part[i * kMax + p];
      for (int t = t1 - 1; t >= t0; --t) {
        const int o = t * kLd + p;
        const long long gi = base + static_cast<long long>(t) * stride + p;
        run += cum[o];
        const float wt = wsrc[o];
        dw[gi] = wt > kWFloor ? (run - qd[o]) / wt : 0.f;
      }
    }
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

template <int NH>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* dy, const float* dstate, float* dr,
           float* dk, float* dv, float* dw, float* du, float* states,
           float* grads, float* small, int B, int T_, int H, int P, int L,
           long long blocks, cudaStream_t st) {
  static bool configured = false;  // one attribute call per instantiation
  cudaError_t err;
  if (!configured) {
    err = cudaFuncSetAttribute(wkv_bwd_state_kernel<NH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(state_smem(NH)));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(wkv_bwd_chunk_kernel<NH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(chunk_smem(NH)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int nc = T_ / L;
  float* du_part = small;
  float* tot = small + blocks * P;
  wkv_bwd_state_kernel<NH><<<static_cast<unsigned>(blocks), kThreads,
                             state_smem(NH), st>>>(r, k, v, w, dy, states,
                                                   grads, tot, T_, H, P, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long chain = static_cast<long long>(B) * H * P * P;
  wkv_bwd_chain_kernel<<<static_cast<unsigned>((chain + kThreads - 1) /
                                               kThreads),
                         kThreads, 0, st>>>(states, grads, tot, dstate, B, H,
                                            P, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  wkv_bwd_chunk_kernel<NH><<<static_cast<unsigned>(blocks), kThreads,
                             chunk_smem(NH), st>>>(
      r, k, v, w, u, dy, states, grads, dr, dk, dv, dw, du_part, T_, H, P, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  wkv_bwd_du_kernel<<<(H * P + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      du_part, du, H * P, B * nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, w, dy, dr, dk, dv, dw: (B, T, H*P) float32; u, du: (H, P)
// float32; dstate: (B, H, P, P) float32 or null (zero).  Scratch, all
// float32: states and grads (B, nc, H, P, P), small (2, B nc H P): each
// block's du share, then each chunk's total; nc = T / L.  T a multiple of
// L; P <= 64, L <= 128; every array contiguous.  Launches four kernels on
// `stream` and returns the first cudaGetLastError() that is not 0 (0 on
// success; -1 for a size the kernel does not take, which the wrapper rules
// out first).
extern "C" int wkv_bwd_launch(const float* r, const float* k, const float* v,
                              const float* w, const float* u, const float* dy,
                              const float* dstate, float* dr, float* dk,
                              float* dv, float* dw, float* du, float* states,
                              float* grads, float* small, int B, int T_,
                              int H, int P, int L, int device, void* stream) {
  if (P < 1 || P > kMax || L < 1 || L > kMaxChunk || T_ % L != 0 || B < 1 ||
      H < 1 || T_ < 1) {
    return -1;
  }
  const long long blocks = static_cast<long long>(B) * H * (T_ / L);
  if (blocks > 0x7fffffffLL) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L > kL) {
    return launch<2>(r, k, v, w, u, dy, dstate, dr, dk, dv, dw, du, states,
                     grads, small, B, T_, H, P, L, blocks, st);
  }
  return launch<1>(r, k, v, w, u, dy, dstate, dr, dk, dv, dw, du, states,
                   grads, small, B, T_, H, P, L, blocks, st);
}
