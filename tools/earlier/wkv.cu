// The earlier wkv kernel (one block per (b, h) walking its chunks in
// order), kept unchanged only so that
// chip_smoke.py can build it and time it beside its replacement,
// src/repro_torch/kernels/csrc/wkv.cu, on the same inputs.  Nothing in
// the package calls it.
//
// RWKV-6 chunked WKV scan for Hopper (sm_90a).
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
// operations.  This first kernel computes on the float32 CUDA cores; a
// later one moves the products onto tensor cores.
//
// Design: the TPU's sequential chunk axis becomes a loop inside the block,
// one block per (b, h), so the state never leaves shared memory.  Per
// chunk the block loads r, k, v and logw into shared memory (rows padded
// to P + 1 floats so that column reads fall in distinct banks); P threads
// each sum one column of logw in order while L other threads form the
// bonus terms r . (u k); then every element gets its A_incl / A_excl and
// the tiles are turned in place into qd, kd and kw.  The L rows are taken
// in groups of 64: a group's att rows (64 x L) go to the area that held
// cum, and each thread owns a 4 x 4 tile of y (rows ty + 16i, columns tx
// + 16j) from qd S and att v.  Last the state update, each thread its 4 x
// 4 tile of S.  Shared memory is 4 L (P + 1) + max(L (P + 1), min(64, L)
// (L + 1)) + P (P + 1) + 2 P + L floats: 101 KB at L = P = 64 (two blocks
// an SM), 184 KB at L = 128, so the launch raises the dynamic limit.  P is
// at most 64 and L at most 128.
//
// Numerics: full-precision logf / expf and IEEE division (no fast math,
// no flush to zero): for L > 73 at the default decay, A_excl is subnormal,
// and the plain version keeps subnormals too.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxP = 64;
constexpr int kMaxL = 128;
constexpr int kRows = 64;   // rows of y and att per group: 16 thread rows x 4
constexpr int kThreads = 256;

__host__ __device__ inline int ca_floats(int L, int P) {
  const int tile = L * (P + 1);
  const int att = (L < kRows ? L : kRows) * (L + 1);
  return tile > att ? tile : att;
}

inline size_t smem_bytes(int L, int P) {
  return (static_cast<size_t>(4 * L * (P + 1)) + ca_floats(L, P) +
          P * (P + 1) + 2 * P + L) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ y,
           float* __restrict__ state_out, int T_, int H, int P, int L) {
  extern __shared__ float smem[];
  const int ldp = P + 1, lda = L + 1, tile = L * ldp;
  float* rs = smem;              // r, then qd
  float* ks = rs + tile;         // k, then kd
  float* vs = ks + tile;         // v
  float* ws = vs + tile;         // logw, then kw
  float* ca = ws + tile;         // cum, then one group's att rows
  float* st = ca + ca_floats(L, P);  // state st[p * ldp + q]
  float* tot = st + P * ldp;     // [P]
  float* us = tot + P;           // [P]
  float* dg = us + P;            // [L]  r_t . (u k_t)

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long rowlen = static_cast<long long>(H) * P;  // stride of t
  const int nq = (P + 15) / 16;  // live column tiles of y and S
  for (int i = tid; i < P * ldp; i += kThreads) st[i] = 0.f;
  for (int i = tid; i < P; i += kThreads) us[i] = u[h * P + i];

  const int nc = T_ / L;
  for (int c = 0; c < nc; ++c) {
    const long long t0 = static_cast<long long>(c) * L;
    __syncthreads();  // the previous chunk is no longer read
    for (int i = tid; i < L * P; i += kThreads) {
      const int t = i / P, p = i % P, s = t * ldp + p;
      const long long off =
          (static_cast<long long>(b) * T_ + t0 + t) * rowlen + h * P + p;
      rs[s] = r[off];
      ks[s] = k[off];
      vs[s] = v[off];
      ws[s] = logf(fmaxf(w[off], 1e-38f));
    }
    __syncthreads();
    if (tid < P) {
      // inclusive cumulative log-decay down column tid, in order
      float run = 0.f;
      for (int t = 0; t < L; ++t) {
        run += ws[t * ldp + tid];
        ca[t * ldp + tid] = run;
      }
      tot[tid] = expf(run);
    } else if (tid >= kMaxP && tid < kMaxP + L) {
      // the diagonal bonus term, from r and k as loaded
      const int t = tid - kMaxP;
      float d = 0.f;
      for (int p = 0; p < P; ++p) {
        d += rs[t * ldp + p] * (us[p] * ks[t * ldp + p]);
      }
      dg[t] = d;
    }
    __syncthreads();
    for (int i = tid; i < L * P; i += kThreads) {
      const int t = i / P, p = i % P, s = t * ldp + p;
      const float lw = ws[s], cum = ca[s];
      const float a_incl = expf(cum);
      const float a_excl = expf(cum - lw);
      const float den = fmaxf(a_incl, 1e-30f);
      const float kk = ks[s];
      rs[s] = rs[s] * a_excl;      // qd
      ks[s] = kk / den;            // kd
      ws[s] = kk * (tot[p] / den); // kw
    }
    __syncthreads();  // cum is no longer read: its area takes att

    for (int g0 = 0; g0 < L; g0 += kRows) {
      const int ns = min(L, g0 + kRows);  // keys that precede these rows
      const int nj = (ns + 15) / 16;
      // att[t][s] = qd_t . kd_s for s < t, else 0
      float at[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) at[i][j] = 0.f;
      for (int p = 0; p < P; ++p) {
        float qa[4], kb[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = g0 + ty + 16 * i;
          qa[i] = t < L ? rs[t * ldp + p] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int s = tx + 16 * j;
          kb[j] = (j < nj && s < ns) ? ks[s * ldp + p] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (j < nj) at[i][j] += qa[i] * kb[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tl = ty + 16 * i, t = g0 + tl;
        if (t >= L) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int s = tx + 16 * j;
          if (j < nj && s < ns) ca[tl * lda + s] = t > s ? at[i][j] : 0.f;
        }
      }
      __syncthreads();  // the group's att rows are complete

      // y[t][q] = (qd S)[t][q] + ((att v)[t][q] + dg[t] v[t][q])
      float yi[4][4], ya[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yi[i][j] = ya[i][j] = 0.f;
      for (int p = 0; p < P; ++p) {
        float qa[4], sq[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = g0 + ty + 16 * i;
          qa[i] = t < L ? rs[t * ldp + p] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = tx + 16 * j;
          sq[j] = (j < nq && q < P) ? st[p * ldp + q] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < nq) yi[i][j] += qa[i] * sq[j];
      }
      for (int s = 0; s < ns; ++s) {
        float aa[4], vq[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int tl = ty + 16 * i;
          aa[i] = g0 + tl < L ? ca[tl * lda + s] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = tx + 16 * j;
          vq[j] = (j < nq && q < P) ? vs[s * ldp + q] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < nq) ya[i][j] += aa[i] * vq[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = g0 + ty + 16 * i;
        if (t >= L) continue;
        float* yp = y + (static_cast<long long>(b) * T_ + t0 + t) * rowlen +
                    h * P;
        const float d = dg[t];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = tx + 16 * j;
          if (j < nq && q < P)
            yp[q] = yi[i][j] + (ya[i][j] + d * vs[t * ldp + q]);
        }
      }
      __syncthreads();  // att and S are no longer read by this group
    }

    // S[p][q] = S[p][q] total[p] + sum_s kw[s][p] v[s][q]
    float su[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) su[i][j] = 0.f;
    for (int s = 0; s < L; ++s) {
      float kp[4], vq[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = ty + 16 * i;
        kp[i] = (i < nq && p < P) ? ws[s * ldp + p] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = tx + 16 * j;
        vq[j] = (j < nq && q < P) ? vs[s * ldp + q] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (i < nq && j < nq) su[i][j] += kp[i] * vq[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * i;
      if (p >= P) continue;
      const float tp = tot[p];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = tx + 16 * j;
        if (q < P) st[p * ldp + q] = st[p * ldp + q] * tp + su[i][j];
      }
    }
  }
  __syncthreads();
  float* so = state_out + static_cast<long long>(bh) * P * P;
  for (int i = tid; i < P * P; i += kThreads) {
    so[i] = st[(i / P) * ldp + i % P];
  }
}

}  // namespace

// r, k, v, w, y: (B, T, H*P) float32; u: (H, P) float32; state: (B, H, P,
// P) float32; every array contiguous.  T a multiple of L; P <= 64, L <=
// 128.  Launches on `stream` and returns cudaGetLastError() (0 on success;
// -1 for a size the kernel does not take, which the wrapper rules out
// first).
extern "C" int wkv_launch(const void* r, const void* k, const void* v,
                          const void* w, const void* u, void* y, void* state,
                          int B, int T_, int H, int P, int L, int device,
                          void* stream) {
  if (P < 1 || P > kMaxP || L < 1 || L > kMaxL || T_ % L != 0) return -1;
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
  wkv_kernel<<<B * H, kThreads, smem_bytes(L, P),
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(y),
      static_cast<float*>(state), T_, H, P, L);
  return static_cast<int>(cudaGetLastError());
}
