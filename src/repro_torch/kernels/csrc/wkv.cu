// RWKV-6 chunked WKV scan for Hopper (sm_90a), chunk-parallel.
//
// Replaces repro/kernels/rwkv_wkv.py::wkv_pallas (body _wkv_kernel).  For
// r, k, v, w (B, T, H*P) and the bonus u (H, P), per (b, h) with a
// (P x P) float32 state S:
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
// computed in chunks of L steps as the TPU kernel does.  Per chunk:
// logw = log(max(w, 1e-38)); cum = its inclusive sum over t = 0..L-1;
// A_incl = exp(cum), A_excl = exp(cum - logw), total = exp(cum[L-1]);
// qd = r A_excl, kd = k / max(A_incl, 1e-30), kw = k (total / max(A_incl,
// 1e-30)); y = qd S + (att v + (r . u k) v) with att = qd kd^T strictly
// below the diagonal; then S = S total^T + kw^T v.  The clamps are the
// TPU kernel's and JAX's, in the same places: they bind once a chunk's
// cumulative decay passes 1e-30, and the port keeps that result.  It also
// writes the final state (B, H, P, P), which the model's decode cache
// needs (wkv_pallas drops it from its VMEM scratch).
//
// Bound (rwkv6-7b's prefill: B 4, T 1024, H 64, P 64, float32, L 64):
// r, k, v, w and y are 67.1 MB each, 339.7 MB with u and the state,
// 101 us at 3.35 TB/s; the four chunk products (two of them over the
// strict lower triangle) are 6.4 GFLOP, 96 us at the 67 TFLOP/s of float32
// outside the tensor cores.  So the bound is bytes, closely followed by
// operations.  The products stay float32 on the CUDA cores (FFMA from
// register tiles): TF32 would leave JAX's float32 result.
//
// Design: only the state carried from chunk to chunk is sequential, so
// the grid is one block per (b, h, chunk) -- 4,096 blocks at the prefill
// shape, 16 times the (b, h) blocks of a serial chunk loop -- and all
// that does not need the carried state runs in parallel: each block loads
// its chunk, forms cum, A_incl, A_excl, total, qd, kd, kw, the bonus
// terms, att v and its share of the state, dS = kw^T v, before it touches
// the chain.  Then it waits for chunk c-1 of its (b, h) to publish S_{c-1}
// (a flag in global memory: ld.acquire by one thread, then a barrier),
// reads S_{c-1} from the state buffer (it stays in L2: 16 KB a (b, h)),
// writes S_c = S_{c-1} total^T + dS in its place and publishes it (a
// barrier, then st.release), and only then finishes y = qd S_{c-1} +
// (att v + bonus), off the chain.  Between chunks the buffer holds S
// transposed, as the next block reads it; the last chunk writes the state
// itself.  Blocks take their (b, h, chunk) from an atomic ticket in
// chunk-major order, so a block only ever waits on a block that started
// before it: a started block needs nothing from one that has not, so the
// chain cannot deadlock whatever order the hardware starts blocks in.
// The wrapper zeroes the ticket and the flags for each call.  Bytes beyond
// the work's: the state buffer's 16 KB per chunk, written and read
// through L2 (134 MB of L2 traffic at the prefill shape, next to nothing
// in device memory).
//
// Inside a block.  The tiles arrive as they lie ([t][p], rows padded to
// 68 floats) by 16-byte cp.async copies in three groups -- w, then r and
// k, then v -- each needed a phase later than the one before.  The
// cumulative log-decay is a sequential sum down each column in step
// order, by P threads (loads batched ahead of the adds), as in the plain
// version, so the 1e-30 and 1e-38 floors bind at the same steps; the bonus
// terms r_t . (u k_t) are summed meanwhile by L other threads.  The four
// products run as 64 x 64 output tiles, each thread a 4 x 4 register
// tile of FFMA fed by 16-byte shared loads, in one of two forms so that
// no operand is transposed in memory: att = qd kd^T and qd S sum along
// rows ("inner": the thread's rows and columns 16 apart, loads along the
// sum, S read transposed), dS = kw^T v and att v along columns ("outer":
// rows and columns 4 apart, att stored transposed from registers).  The
// bonus sits on att's diagonal, so att v carries it; on the diagonal tile
// the 4 x 4 pairs wholly above it are skipped, and a warp stops att v at
// its last row.  Two blocks fit an SM at L = 64 (88 KB of shared memory
// and 128 registers a thread each).  Shared memory is 4 L + max(L, P)
// rows of 68 floats plus 256 floats: r / qd, k / kd, w / logw / kw /
// att v, cum / att^T of a group of 64 rows, v / S_{c-1}^T.  P is at most
// 64 and a multiple of 4; L is at most 128 (175 KB).  Index arithmetic
// steps (t, q) pairs instead of dividing by the run-time P or L.
//
// Numerics: full-precision logf / expf and IEEE division (no fast math,
// no flush to zero): for L > 73 at the default decay, A_excl is subnormal,
// and the plain version keeps subnormals too.  One exception: kw's
// total / max(A_incl, 1e-30) is total x rcp(max(A_incl, 1e-30)) (the IEEE
// round-to-nearest reciprocal; within 1.5 float32 ulps of the quotient):
// at the served decay total is ~5e-34, where IEEE division takes its slow
// path for every element, which made the whole elementwise pass several
// times slower on the card.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxP = 64;
constexpr int kMaxL = 128;
constexpr int kTile = 64;   // output tile of a product: 16 x 16 threads x 4 x 4
constexpr int kLd = kTile + 4;  // row length of every tile in shared memory
constexpr int kThreads = 256;

inline size_t smem_bytes(int L, int P) {
  return (static_cast<size_t>(4 * L + (L > P ? L : P)) * kLd + 2 * kMaxP +
          kMaxL) * sizeof(float);
}

__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int Pending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// "outer" form, acc[i][j] += a[i] b[j]: A and B stored [k][m] and [k][n],
// the thread's rows and columns 4 apart in one 16-byte load each.
__device__ __forceinline__ void outer(float (&acc)[4][4], float4 a,
                                      float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// "inner" form, acc[i][j] += a_i . b_j over K (a multiple of 4): A and B
// stored [m][k] and [n][k], row i of A at a[i], row j of B at b[j]; the
// sum runs in k order.  With kLower, rows i and columns j interleaved by
// 16 (row ty + 16 i, column tx + 16 j) and only column < row wanted, the
// pairs j > i (all above the diagonal) are skipped.
template <bool kLower = false>
__device__ __forceinline__ void inner(float (&acc)[4][4],
                                      const float* const (&a)[4],
                                      const float* const (&b)[4], int K) {
  for (int k = 0; k < K; k += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ld4(a[i] + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = ld4(b[j] + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kLower && j > i) continue;
        float x = fmaf(av[i].x, bv[j].x, acc[i][j]);
        x = fmaf(av[i].y, bv[j].y, x);
        x = fmaf(av[i].z, bv[j].z, x);
        acc[i][j] = fmaf(av[i].w, bv[j].w, x);
      }
  }
}

// sync[0]: the ticket; sync[1 + bh]: chunks of (b, h) whose state is out.
__global__ void __launch_bounds__(kThreads, 2)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ y,
           float* state, int* sync, int T_, int H, int P, int L) {
  extern __shared__ float4 smem4[];
  __shared__ int ticket;
  float* rN = reinterpret_cast<float*>(smem4);  // [L][kLd]: r, then qd
  float* kN = rN + L * kLd;      // [L][kLd]: k, then kd
  float* wN = kN + L * kLd;      // [L][kLd]: w, logw, kw, then att v + bonus
  float* cN = wN + L * kLd;      // [L][kLd]: cum, then att^T of a group
  float* vN = cN + L * kLd;      // [max(L, P)][kLd]: v, then S_{c-1}^T
  float* tot = vN + (L > P ? L : P) * kLd;  // [P]
  float* us = tot + kMaxP;       // [P]
  float* dg = us + kMaxP;        // [L]  r_t . (u k_t)

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int r0 = 4 * ty, c0 = 4 * tx;   // outer form: rows r0.., cols c0..
  if (tid == 0) ticket = atomicAdd(sync, 1);
  __syncthreads();
  const int nc = T_ / L;
  const int BH = gridDim.x / nc;
  const int c = ticket / BH, bh = ticket % BH;   // chunk-major
  const int b = bh / H, h = bh % H;
  const long long rowlen = static_cast<long long>(H) * P;  // stride of t
  const long long base =
      (static_cast<long long>(b) * T_ + static_cast<long long>(c) * L) *
          rowlen + h * P;

  // The chunk's (L x P) tiles in 16-byte pieces, piece i = (t, 4 q) =
  // (i / P4, 4 (i % P4)); the walks step the pair rather than divide.
  // Three groups of copies: w, then r and k, then v, each needed a phase
  // later than the one before, so the log, the cumulative sums, the bonus
  // terms, qd, kd, kw and the first att overlap the copies still in flight.
  const int P4 = P / 4, tStep = kThreads / P4, qStep = kThreads % P4;
  for (int t = tid / P4, q = tid % P4; t < L;) {
    copy_async16(wN + t * kLd + 4 * q, w + base + t * rowlen + 4 * q);
    t += tStep, q += qStep;
    if (q >= P4) q -= P4, ++t;
  }
  commit_copies();
  for (int t = tid / P4, q = tid % P4; t < L;) {
    const long long off = base + t * rowlen + 4 * q;
    copy_async16(rN + t * kLd + 4 * q, r + off);
    copy_async16(kN + t * kLd + 4 * q, k + off);
    t += tStep, q += qStep;
    if (q >= P4) q -= P4, ++t;
  }
  commit_copies();
  for (int t = tid / P4, q = tid % P4; t < L;) {
    copy_async16(vN + t * kLd + 4 * q, v + base + t * rowlen + 4 * q);
    t += tStep, q += qStep;
    if (q >= P4) q -= P4, ++t;
  }
  commit_copies();
  for (int i = tid; i < P; i += kThreads) us[i] = u[h * P + i];
  wait_copies<2>();
  __syncthreads();  // w has landed
  for (int t = tid / P4, q = tid % P4; t < L;) {
    float* x = wN + t * kLd + 4 * q;
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = logf(fmaxf(x[e], 1e-38f));
    t += tStep, q += qStep;
    if (q >= P4) q -= P4, ++t;
  }
  wait_copies<1>();
  __syncthreads();  // logw is complete; r and k have landed
  if (tid < P) {
    // inclusive cumulative log-decay down column tid, in step order
    float run = 0.f;
for (int t0 = 0; t0 < L; t0 += 8) {  // loads ahead of the sums
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        x[e] = t0 + e < L ? wN[(t0 + e) * kLd + tid] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (t0 + e < L) {
          run += x[e];
          cN[(t0 + e) * kLd + tid] = run;
        }
      }
    }
    tot[tid] = expf(run);
  } else if (tid >= kMaxP && tid < kMaxP + L) {
    // meanwhile the diagonal bonus term, from r and k as loaded
    const int t = tid - kMaxP;
    float d = 0.f;
    #pragma unroll 4
    for (int p = 0; p < P; p += 4) {
      const float4 rr = ld4(rN + t * kLd + p), kk = ld4(kN + t * kLd + p);
      const float4 uu = ld4(us + p);
      d += rr.x * (uu.x * kk.x);
      d += rr.y * (uu.y * kk.y);
      d += rr.z * (uu.z * kk.z);
      d += rr.w * (uu.w * kk.w);
    }
    dg[t] = d;
  }
  __syncthreads();
  for (int t = tid / P4, q = tid % P4; t < L;) {
    const int s = t * kLd + 4 * q;
    const float4 lw4 = ld4(wN + s), cum4 = ld4(cN + s), r4 = ld4(rN + s);
    const float4 k4 = ld4(kN + s), tot4 = ld4(tot + 4 * q);
    const float lw[4] = {lw4.x, lw4.y, lw4.z, lw4.w};
    const float cum[4] = {cum4.x, cum4.y, cum4.z, cum4.w};
    const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
    const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
    const float tt[4] = {tot4.x, tot4.y, tot4.z, tot4.w};
    float qd[4], kd[4], kwv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a_incl = expf(cum[e]);
      const float a_excl = expf(cum[e] - lw[e]);
      const float den = fmaxf(a_incl, 1e-30f);
      qd[e] = rr[e] * a_excl;
      kd[e] = kk[e] / den;
      kwv[e] = kk[e] * (tt[e] * __frcp_rn(den));
    }
    *reinterpret_cast<float4*>(rN + s) =
        make_float4(qd[0], qd[1], qd[2], qd[3]);
    *reinterpret_cast<float4*>(kN + s) =
        make_float4(kd[0], kd[1], kd[2], kd[3]);
    *reinterpret_cast<float4*>(wN + s) =
        make_float4(kwv[0], kwv[1], kwv[2], kwv[3]);
    t += tStep, q += qStep;
    if (q >= P4) q -= P4, ++t;
  }
  __syncthreads();

  // per group of 64 rows t: att (strictly below the diagonal, the bonus
  // r_t . (u k_t) on it) as att^T into cN, then att v into wN; with the
  // first group, once v has landed, this chunk's share of the state,
  // dS[p][q] = sum_s kw[s][p] v[s][q]
  float su[4][4], acc[4][4];
  for (int g0 = 0; g0 < L; g0 += kTile) {
    const float* qrow[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qrow[i] = rN + min(g0 + ty + 16 * i, L - 1) * kLd;
    }
    for (int cb = 0; cb <= g0; cb += kTile) {  // later keys are all zero
      const float* krow[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        krow[j] = kN + min(cb + tx + 16 * j, L - 1) * kLd;
      }
      zero(acc);
      if (cb == g0) {
        inner<true>(acc, qrow, krow, P);   // the diagonal block
      } else {
        inner(acc, qrow, krow, P);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = cb + tx + 16 * j;
        if (s >= L) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = g0 + ty + 16 * i;
          cN[s * kLd + ty + 16 * i] =
              s < t ? acc[i][j] : (s == t ? dg[t] : 0.f);
        }
      }
    }
    __syncthreads();  // the group's att^T is complete
    if (g0 == 0) {
      wait_copies<0>();
      __syncthreads();  // v has landed
      zero(su);
      for (int s = 0; s < L; ++s) {
        outer(su, ld4(wN + s * kLd + r0), ld4(vN + s * kLd + c0));
      }
    }
    // a warp's rows end at g0 + 8 warp + 7: later keys add zeros
    const int send = min(L, g0 + 8 * (tid / 32) + 8);
    zero(acc);
    for (int s = 0; s < send; ++s) {
      outer(acc, ld4(cN + s * kLd + r0), ld4(vN + s * kLd + c0));
    }
    __syncthreads();  // att^T and kw are no longer read
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = g0 + r0 + i;
      if (t < L) {
        *reinterpret_cast<float4*>(wN + t * kLd + c0) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
  }
  __syncthreads();  // all of att v is written

  // the chain: S_{c-1} from chunk c-1, S_c = S_{c-1} total^T + dS out.
  // Between chunks the state buffer holds S transposed ([q][p]), so that
  // it lands as it lies in vN (v is no longer read) by 16-byte copies;
  // the last chunk writes the state itself ([p][q]).
  float* sp = state + static_cast<long long>(bh) * P * P;
  int* done = sync + 1 + bh;
  float* St = vN;                // [P][kLd]: S_{c-1}^T
  if (c > 0) {
    if (tid == 0) {
      while (load_acquire(done) < c) __nanosleep(64);
    }
    __syncthreads();
    for (int q = tid / P4, p = tid % P4; q < P;) {
      copy_async16(St + q * kLd + 4 * p, sp + q * P + 4 * p);
      q += tStep, p += qStep;
      if (p >= P4) p -= P4, ++q;
    }
    commit_copies();
    wait_copies<0>();
    __syncthreads();  // every read of S_{c-1} is done before S_c replaces it
  }
  if (r0 < P && c0 < P) {
    const bool last = c + 1 == nc;
    float o[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 prev = c > 0 ? ld4(St + (c0 + j) * kLd + r0)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      const float pv[4] = {prev.x, prev.y, prev.z, prev.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i][j] = pv[i] * tot[r0 + i] + su[i][j];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float* dst = last ? sp + (r0 + e) * P + c0 : sp + (c0 + e) * P + r0;
      const float4 val = last ? make_float4(o[e][0], o[e][1], o[e][2], o[e][3])
                              : make_float4(o[0][e], o[1][e], o[2][e], o[3][e]);
      __stcg(reinterpret_cast<float4*>(dst), val);
    }
  }
  if (c + 1 < nc) {
    __syncthreads();  // all of S_c is written
    if (tid == 0) store_release(done, c + 1);  // cumulative over the block
  }

  // y[t][q] = (qd S_{c-1})[t][q] + (att v + bonus)[t][q], off the chain
  const float* srow[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) srow[j] = St + min(tx + 16 * j, P - 1) * kLd;
  for (int g0 = 0; g0 < L; g0 += kTile) {
    const float* qrow[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qrow[i] = rN + min(g0 + ty + 16 * i, L - 1) * kLd;
    }
    zero(acc);
    if (c > 0) inner(acc, qrow, srow, P);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = g0 + ty + 16 * i;
      if (t >= L) continue;
      float* yp = y + base + t * rowlen;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = tx + 16 * j;
        if (q < P) yp[q] = acc[i][j] + wN[t * kLd + q];
      }
    }
  }
}

}  // namespace

// r, k, v, w, y: (B, T, H*P) float32; u: (H, P) float32; state: (B, H, P,
// P) float32; sync: 1 + B*H int32, zero; every array contiguous.  T a
// multiple of L; P <= 64, L <= 128.  Launches on `stream` and returns
// cudaGetLastError() (0 on success; -1 for a size the kernel does not take,
// which the wrapper rules out first).
extern "C" int wkv_launch(const void* r, const void* k, const void* v,
                          const void* w, const void* u, void* y, void* state,
                          void* sync, int B, int T_, int H, int P, int L,
                          int device, void* stream) {
  if (P < 4 || P > kMaxP || P % 4 != 0 || L < 1 || L > kMaxL ||
      T_ % L != 0) {
    return -1;
  }
  const long long blocks = static_cast<long long>(B) * H * (T_ / L);
  if (blocks < 1 || blocks > 0x7fffffffLL) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool configured = false;  // one attribute call for the largest L, P
  if (!configured) {
    err = cudaFuncSetAttribute(wkv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(kMaxL, kMaxP)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  wkv_kernel<<<static_cast<unsigned>(blocks), kThreads, smem_bytes(L, P),
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(y),
      static_cast<float*>(state), static_cast<int*>(sync), T_, H, P, L);
  return static_cast<int>(cudaGetLastError());
}
