// Backward flash attention for Hopper (sm_90a): dq, dk and dv of the
// forward kernels' attention, in three launches with no atomics.
//
// Replaces no Pallas kernel: it is the card's counterpart of JAX's
// custom-VJP backward of flash_mha, repro/models/attention.py::_flash_bwd
// (the FlashAttention-2 schedule in plain jnp), which the TPU ran under
// XLA.  Training on the card needs it because the forward runs in the
// hand-written kernels (flash_attention_sm90.cu, flash_attention_f32_sm90.cu),
// which have no gradient.  For q, o, do (B, S, H, hd) and k, v (B, S, KV,
// hd), query head h reading KV head h / (H / KV), it computes _flash_bwd's
// formulas in float32:
//   s = q_i . k_j * hd^-1/2, -1e30 where masked (causal keeps j <= i, the
//   window j > i - window - 1), m_i = max_j s, l_i = sum_j exp(s - m_i),
//   p = exp(s - m_i) / max(l_i, 1e-30), D_i = sum_d do_i o_i,
//   dv_j = sum_i p do_i, dp = do_i . v_j, ds = p (dp - D_i),
//   dq_i = sum_j ds k_j * hd^-1/2, dk_j = sum_i ds q_i * hd^-1/2,
// dk and dv summed over the H / KV query heads of a KV head (the gradient
// of JAX's _repeat_kv), each result in the inputs' type (bf16 or float32)
// from float32 sums.  Masked pairs give p = 0 exactly.
//
// Bound (smollm-135m's train shape: B 8, S 1,024, H 9 over KV 3, hd 64,
// causal, bf16): the five products of the backward (s again, dp, dv, dq,
// dk) over the kept pairs are ~24 GFLOP, ~24 us at the 989 TFLOP/s of the
// bf16 tensor cores; q, k, v, o, do in and dq, dk, dv out are ~51 MB, ~15
// us at 3.35 TB/s.  So operations bound it.  This first kernel is a simple
// design that is right: its products run on the float32 CUDA cores (67
// TFLOP/s), and it spends more of them than the bound counts (m and l are
// recomputed, and s and dp are formed twice): 1.91 ms at that shape on an
// H100 SXM at 700 W, in bf16 and float32 alike, where SDPA's backward takes
// 0.21-0.43 ms in bf16 (chip_smoke.py, phase flash_bwd_kernel).  wgmma on tiles
// fed by TMA, with the forward writing its log-sum-exp so that the
// pre-pass goes, is later work.
//
// Design, three launches on the caller's stream:
//   (a) pre-pass, a block per (b, h, 64-row query tile): recompute m and l
//       over the row's keys (an online max and sum across key tiles, p = 0
//       for masked pairs) and D = rowsum(do o), into float32 (B, H, S)
//       scratch the wrapper allocates;
//   (b) dk / dv, a block per (b, KV head, key tile): K and V stay in shared
//       memory while the block walks the H / KV query heads of its group
//       and, for each, the query tiles that see its keys (from the causal
//       diagonal to the window's end); per query tile it forms s and dp
//       (one pass over d), p and ds in registers, writes them to shared
//       memory, then adds p^T do into dv and ds^T q into dk, both held in
//       registers for the block's life.  The group's heads are summed in
//       the block, so no two blocks write one dk or dv row;
//   (c) dq, a block per (b, h, query tile), over the key tiles from the
//       window's start to the causal frontier: s, dp, ds as in (b), then
//       dq += ds k, held in registers.
// Tiles are 64 x 64 (32 x 32 at hd 256) for 256 threads; a thread holds a
// 4 x 4 (2 x 2) block of s, rows ty + 16 a and keys tx + 16 c, so a row's
// 16 threads share a half warp and the row reductions of (a) are four xor
// shuffles.  Shared-memory rows are padded to hd + 1 floats (odd), so the
// 16 threads of a half warp read 16 banks.  Inputs are converted to float32
// as they are loaded; rows and keys past S load as zeros and are masked,
// so any S works.  Every sum runs in a fixed order in one thread: two
// launches on the same inputs give the same bits.  Shared memory: 166 KB a
// block at hd 128, 140 KB at hd 256 (32-row tiles).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;  // 16 x 16

template <int HD>
struct BwdConfig {
  static constexpr int kB = HD == 256 ? 32 : 64;  // query rows = keys a tile
  static constexpr int kA = kB / 16;              // rows (keys) a thread
  static constexpr int kNC = (HD + 15) / 16;      // columns of hd a thread
  static constexpr int kLd = HD + 1;              // padded row, floats
  static constexpr int kLdP = kB + 1;             // padded p / ds row
  static constexpr int kTile = kB * kLd;
  static constexpr int kPTile = kB * kLdP;
  // Q, dO, K, V tiles, then p and ds, then m, l, D of the query rows
  static constexpr int kBytes = (4 * kTile + 2 * kPTile + 3 * kB) * 4;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool keep(int i, int j, int S, int causal,
                                     int window) {
  return i < S && j < S && (!causal || j <= i) &&
         (window <= 0 || j >= i - window);
}

// rows [row0, row0 + rows) of an (S, HD) slice with row stride `stride`
// (elements) into float32 shared rows of `ld`; rows past S as zeros
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long stride, int row0,
                                          int rows, int S) {
  for (int i = threadIdx.x; i < rows * HD; i += kThreads) {
    const int r = i / HD, c = i % HD, row = row0 + r;
    dst[r * ld + c] =
        row < S ? to_f(src[static_cast<long long>(row) * stride + c]) : 0.f;
  }
}

// s = A B^T and, with `both`, dp = C D^T over HD, for the thread's rows
// ty + 16 a of A and C and rows tx + 16 c of B and D (all kLd-strided)
template <int HD, bool kBoth>
__device__ __forceinline__ void two_products(
    const float* a, const float* bm, const float* c, const float* dm,
    float (&s)[BwdConfig<HD>::kA][BwdConfig<HD>::kA],
    float (&dp)[BwdConfig<HD>::kA][BwdConfig<HD>::kA]) {
  using C = BwdConfig<HD>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int x = 0; x < C::kA; ++x)
#pragma unroll
    for (int y = 0; y < C::kA; ++y) s[x][y] = dp[x][y] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float av[C::kA], bv[C::kA], cv[C::kA], dv[C::kA];
#pragma unroll
    for (int x = 0; x < C::kA; ++x) {
      av[x] = a[(ty + 16 * x) * C::kLd + d];
      bv[x] = bm[(tx + 16 * x) * C::kLd + d];
      if (kBoth) {
        cv[x] = c[(ty + 16 * x) * C::kLd + d];
        dv[x] = dm[(tx + 16 * x) * C::kLd + d];
      }
    }
#pragma unroll
    for (int x = 0; x < C::kA; ++x)
#pragma unroll
      for (int y = 0; y < C::kA; ++y) {
        s[x][y] = fmaf(av[x], bv[y], s[x][y]);
        if (kBoth) dp[x][y] = fmaf(cv[x], dv[y], dp[x][y]);
      }
  }
}

// p and ds of the thread's (row, key) pairs from s and dp, with the rows'
// m, l, D in shared memory; masked pairs give 0
template <int HD>
__device__ __forceinline__ void form_p_ds(
    float (&s)[BwdConfig<HD>::kA][BwdConfig<HD>::kA],
    float (&dp)[BwdConfig<HD>::kA][BwdConfig<HD>::kA], const float* ms,
    const float* ls, const float* Ds, int q0, int k0, int S, int causal,
    int window, float scale) {
  using C = BwdConfig<HD>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int x = 0; x < C::kA; ++x) {
    const int r = ty + 16 * x, i = q0 + r;
    const float m = ms[r], inv_l = 1.f / fmaxf(ls[r], 1e-30f), D = Ds[r];
#pragma unroll
    for (int y = 0; y < C::kA; ++y) {
      const int j = k0 + tx + 16 * y;
      const float p =
          keep(i, j, S, causal, window) ? expf(s[x][y] * scale - m) * inv_l
                                        : 0.f;
      s[x][y] = p;
      dp[x][y] = p * (dp[x][y] - D);
    }
  }
}

// m, l and D of the query rows [q0, q0 + kB) of head h into shared memory
template <int HD>
__device__ __forceinline__ void load_rows(float* ms, float* ls, float* Ds,
                                          const float* mg, const float* lg,
                                          const float* Dg, int q0, int S) {
  using C = BwdConfig<HD>;
  for (int r = threadIdx.x; r < C::kB; r += kThreads) {
    const bool in = q0 + r < S;
    ms[r] = in ? mg[q0 + r] : 0.f;
    ls[r] = in ? lg[q0 + r] : 1.f;
    Ds[r] = in ? Dg[q0 + r] : 0.f;
  }
}

struct Shape {
  int S, H, KV, causal, window;
  float scale;
};

// (a) m, l and D of one (b, h, query tile), heaviest tiles first
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ m_out, float* __restrict__ l_out,
                float* __restrict__ D_out, Shape sh, int n_tiles) {
  using C = BwdConfig<HD>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = smem + C::kTile;
  const int S = sh.S, H = sh.H, G = sh.H / sh.KV;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (n_tiles - 1 - static_cast<int>(blockIdx.y)) * C::kB;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long qst = static_cast<long long>(H) * HD;
  const long long kst = static_cast<long long>(sh.KV) * HD;
  const long long q_off = static_cast<long long>(b) * S * qst +
                          static_cast<long long>(h) * HD;
  const T* kg = k + static_cast<long long>(b) * S * kst +
                static_cast<long long>(h / G) * HD;
  const long long rows_off = static_cast<long long>(bh) * S;

  // D = rowsum(do o): a warp a row, lanes across hd
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < C::kB; r += kThreads / 32) {
    const int i = q0 + r;
    if (i >= S) break;
    float acc = 0.f;
    for (int d = lane; d < HD; d += 32) {
      const long long at = q_off + static_cast<long long>(i) * qst + d;
      acc = fmaf(to_f(dout[at]), to_f(o[at]), acc);
    }
#pragma unroll
    for (int w = 16; w > 0; w /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (lane == 0) D_out[rows_off + i] = acc;
  }

  load_tile<T, HD>(qs, C::kLd, q + q_off, qst, q0, C::kB, S);
  const int q1 = min(S, q0 + C::kB);
  const int kt0 = sh.window > 0 ? max(0, q0 - sh.window) / C::kB : 0;
  const int kt1 = sh.causal ? (q1 - 1) / C::kB + 1 : (S + C::kB - 1) / C::kB;
  float m[C::kA], l[C::kA];
#pragma unroll
  for (int x = 0; x < C::kA; ++x) m[x] = kNegInf, l[x] = 0.f;
  float s[C::kA][C::kA], unused[C::kA][C::kA];
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * C::kB;
    __syncthreads();  // Q landed; no thread reads the last K tile
    load_tile<T, HD>(ks, C::kLd, kg, kst, k0, C::kB, S);
    __syncthreads();
    two_products<HD, false>(qs, ks, nullptr, nullptr, s, unused);
#pragma unroll
    for (int x = 0; x < C::kA; ++x) {
      const int i = q0 + ty + 16 * x;
      float mx = kNegInf;
#pragma unroll
      for (int y = 0; y < C::kA; ++y) {
        s[x][y] *= sh.scale;
        if (keep(i, k0 + tx + 16 * y, S, sh.causal, sh.window))
          mx = fmaxf(mx, s[x][y]);
      }
#pragma unroll
      for (int w = 1; w < 16; w *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float mn = fmaxf(m[x], mx);
      float ps = 0.f;
#pragma unroll
      for (int y = 0; y < C::kA; ++y)
        if (keep(i, k0 + tx + 16 * y, S, sh.causal, sh.window))
          ps += expf(s[x][y] - mn);
#pragma unroll
      for (int w = 1; w < 16; w *= 2)
        ps += __shfl_xor_sync(0xffffffffu, ps, w);
      l[x] = l[x] * expf(m[x] - mn) + ps;
      m[x] = mn;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int x = 0; x < C::kA; ++x) {
      const int i = q0 + ty + 16 * x;
      if (i < S) {
        m_out[rows_off + i] = m[x];
        l_out[rows_off + i] = l[x];
      }
    }
  }
}

// (b) dk and dv of one (b, KV head, key tile), summed over the group's
// query heads; key tile 0 (the heaviest under the causal mask) first
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ m_in, const float* __restrict__ l_in,
                const float* __restrict__ D_in, T* __restrict__ dk,
                T* __restrict__ dv, Shape sh) {
  using C = BwdConfig<HD>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + C::kTile;
  float* ks = dos + C::kTile;
  float* vs = ks + C::kTile;
  float* ps = vs + C::kTile;
  float* dss = ps + C::kPTile;
  float* ms = dss + C::kPTile;
  float* ls = ms + C::kB;
  float* Ds = ls + C::kB;
  const int S = sh.S, H = sh.H, KV = sh.KV, G = H / KV;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int k0 = blockIdx.y * C::kB, k1 = min(S, k0 + C::kB);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long qst = static_cast<long long>(H) * HD;
  const long long kst = static_cast<long long>(KV) * HD;
  const long long kv_off = static_cast<long long>(b) * S * kst +
                           static_cast<long long>(kvh) * HD;
  load_tile<T, HD>(ks, C::kLd, k + kv_off, kst, k0, C::kB, S);
  load_tile<T, HD>(vs, C::kLd, v + kv_off, kst, k0, C::kB, S);

  const int n_qt = (S + C::kB - 1) / C::kB;
  const int qt0 = sh.causal ? k0 / C::kB : 0;
  const int qt1 = sh.window > 0 ? min(n_qt, (k1 - 1 + sh.window) / C::kB + 1)
                                : n_qt;
  // dv and dk of keys ty + 16 a, columns tx + 16 c
  float dva[C::kA][C::kNC], dka[C::kA][C::kNC];
#pragma unroll
  for (int x = 0; x < C::kA; ++x)
#pragma unroll
    for (int c = 0; c < C::kNC; ++c) dva[x][c] = dka[x][c] = 0.f;
  float s[C::kA][C::kA], dp[C::kA][C::kA];

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long long q_off = static_cast<long long>(b) * S * qst +
                            static_cast<long long>(h) * HD;
    const long long rows_off = (static_cast<long long>(b) * H + h) * S;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * C::kB;
      __syncthreads();  // no thread reads the last tile's Q, dO, p, ds
      load_tile<T, HD>(qs, C::kLd, q + q_off, qst, q0, C::kB, S);
      load_tile<T, HD>(dos, C::kLd, dout + q_off, qst, q0, C::kB, S);
      load_rows<HD>(ms, ls, Ds, m_in + rows_off, l_in + rows_off,
                    D_in + rows_off, q0, S);
      __syncthreads();
      two_products<HD, true>(qs, ks, dos, vs, s, dp);
      form_p_ds<HD>(s, dp, ms, ls, Ds, q0, k0, S, sh.causal, sh.window,
                    sh.scale);
#pragma unroll
      for (int x = 0; x < C::kA; ++x)
#pragma unroll
        for (int y = 0; y < C::kA; ++y) {
          ps[(ty + 16 * x) * C::kLdP + tx + 16 * y] = s[x][y];
          dss[(ty + 16 * x) * C::kLdP + tx + 16 * y] = dp[x][y];
        }
      __syncthreads();
      // dv += p^T do, dk += ds^T q over the tile's query rows
#pragma unroll 2
      for (int i = 0; i < C::kB; ++i) {
        float pv[C::kA], dsv[C::kA], dov[C::kNC], qv[C::kNC];
#pragma unroll
        for (int x = 0; x < C::kA; ++x) {
          pv[x] = ps[i * C::kLdP + ty + 16 * x];
          dsv[x] = dss[i * C::kLdP + ty + 16 * x];
        }
#pragma unroll
        for (int c = 0; c < C::kNC; ++c) {
          const int d = tx + 16 * c;
          const bool in = HD % 16 == 0 || d < HD;
          dov[c] = in ? dos[i * C::kLd + d] : 0.f;
          qv[c] = in ? qs[i * C::kLd + d] : 0.f;
        }
#pragma unroll
        for (int x = 0; x < C::kA; ++x)
#pragma unroll
          for (int c = 0; c < C::kNC; ++c) {
            dva[x][c] = fmaf(pv[x], dov[c], dva[x][c]);
            dka[x][c] = fmaf(dsv[x], qv[c], dka[x][c]);
          }
      }
    }
  }
#pragma unroll
  for (int x = 0; x < C::kA; ++x) {
    const int j = k0 + ty + 16 * x;
    if (j >= S) continue;
    const long long at = kv_off + static_cast<long long>(j) * kst;
#pragma unroll
    for (int c = 0; c < C::kNC; ++c) {
      const int d = tx + 16 * c;
      if (HD % 16 == 0 || d < HD) {
        dv[at + d] = from_f<T>(dva[x][c]);
        dk[at + d] = from_f<T>(dka[x][c] * sh.scale);
      }
    }
  }
}

// (c) dq of one (b, h, query tile), heaviest tiles first
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ m_in, const float* __restrict__ l_in,
              const float* __restrict__ D_in, T* __restrict__ dq, Shape sh,
              int n_tiles) {
  using C = BwdConfig<HD>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + C::kTile;
  float* ks = dos + C::kTile;
  float* vs = ks + C::kTile;
  float* dss = vs + C::kTile + C::kPTile;
  float* ms = dss + C::kPTile;
  float* ls = ms + C::kB;
  float* Ds = ls + C::kB;
  const int S = sh.S, H = sh.H, G = H / sh.KV;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (n_tiles - 1 - static_cast<int>(blockIdx.y)) * C::kB;
  const int q1 = min(S, q0 + C::kB);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long qst = static_cast<long long>(H) * HD;
  const long long kst = static_cast<long long>(sh.KV) * HD;
  const long long q_off = static_cast<long long>(b) * S * qst +
                          static_cast<long long>(h) * HD;
  const long long kv_off = static_cast<long long>(b) * S * kst +
                           static_cast<long long>(h / G) * HD;
  const long long rows_off = static_cast<long long>(bh) * S;
  load_tile<T, HD>(qs, C::kLd, q + q_off, qst, q0, C::kB, S);
  load_tile<T, HD>(dos, C::kLd, dout + q_off, qst, q0, C::kB, S);
  load_rows<HD>(ms, ls, Ds, m_in + rows_off, l_in + rows_off, D_in + rows_off,
                q0, S);
  const int kt0 = sh.window > 0 ? max(0, q0 - sh.window) / C::kB : 0;
  const int kt1 = sh.causal ? (q1 - 1) / C::kB + 1 : (S + C::kB - 1) / C::kB;
  // dq of rows ty + 16 a, columns tx + 16 c
  float dqa[C::kA][C::kNC];
#pragma unroll
  for (int x = 0; x < C::kA; ++x)
#pragma unroll
    for (int c = 0; c < C::kNC; ++c) dqa[x][c] = 0.f;
  float s[C::kA][C::kA], dp[C::kA][C::kA];
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * C::kB;
    __syncthreads();  // no thread reads the last K, V, ds tiles
    load_tile<T, HD>(ks, C::kLd, k + kv_off, kst, k0, C::kB, S);
    load_tile<T, HD>(vs, C::kLd, v + kv_off, kst, k0, C::kB, S);
    __syncthreads();
    two_products<HD, true>(qs, ks, dos, vs, s, dp);
    form_p_ds<HD>(s, dp, ms, ls, Ds, q0, k0, S, sh.causal, sh.window,
                  sh.scale);
#pragma unroll
    for (int x = 0; x < C::kA; ++x)
#pragma unroll
      for (int y = 0; y < C::kA; ++y)
        dss[(ty + 16 * x) * C::kLdP + tx + 16 * y] = dp[x][y];
    __syncthreads();
    // dq += ds k over the tile's keys
#pragma unroll 2
    for (int j = 0; j < C::kB; ++j) {
      float dsv[C::kA], kv[C::kNC];
#pragma unroll
      for (int x = 0; x < C::kA; ++x) dsv[x] = dss[(ty + 16 * x) * C::kLdP + j];
#pragma unroll
      for (int c = 0; c < C::kNC; ++c) {
        const int d = tx + 16 * c;
        kv[c] = HD % 16 == 0 || d < HD ? ks[j * C::kLd + d] : 0.f;
      }
#pragma unroll
      for (int x = 0; x < C::kA; ++x)
#pragma unroll
        for (int c = 0; c < C::kNC; ++c)
          dqa[x][c] = fmaf(dsv[x], kv[c], dqa[x][c]);
    }
  }
#pragma unroll
  for (int x = 0; x < C::kA; ++x) {
    const int i = q0 + ty + 16 * x;
    if (i >= S) continue;
    const long long at = q_off + static_cast<long long>(i) * qst;
#pragma unroll
    for (int c = 0; c < C::kNC; ++c) {
      const int d = tx + 16 * c;
      if (HD % 16 == 0 || d < HD) dq[at + d] = from_f<T>(dqa[x][c] * sh.scale);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* ws, int B,
           int S, int H, int KV, int causal, int window, cudaStream_t st) {
  using C = BwdConfig<HD>;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(B) * H * S;
  float* m = ws;
  float* l = ws + rows;
  float* D = ws + 2 * rows;
  const Shape sh{S, H, KV, causal, window,
                 1.f / sqrtf(static_cast<float>(HD))};
  const int n_tiles = (S + C::kB - 1) / C::kB;
  const int rows_bytes = 2 * C::kTile * 4;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_rows_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      rows_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dkdv_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dq_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_rows_kernel<T, HD><<<dim3(B * H, n_tiles), kThreads, rows_bytes, st>>>(
      q_, k_, static_cast<const T*>(o), do_, m, l, D, sh, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv_kernel<T, HD><<<dim3(B * KV, n_tiles), kThreads, C::kBytes, st>>>(
      q_, k_, v_, do_, m, l, D, static_cast<T*>(dk), static_cast<T*>(dv), sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq_kernel<T, HD><<<dim3(B * H, n_tiles), kThreads, C::kBytes, st>>>(
      q_, k_, v_, do_, m, l, D, static_cast<T*>(dq), sh, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_width(int hd, const void* q, const void* k, const void* v,
             const void* o, const void* dout, void* dq, void* dk, void* dv,
             float* ws, int B, int S, int H, int KV, int causal, int window,
             cudaStream_t st) {
  switch (hd) {
#define BWD_CASE(W)                                                        \
  case W:                                                                  \
    return launch<T, W>(q, k, v, o, dout, dq, dk, dv, ws, B, S, H, KV,    \
                        causal, window, st);
    BWD_CASE(8)
    BWD_CASE(16)
    BWD_CASE(64)
    BWD_CASE(80)
    BWD_CASE(128)
    BWD_CASE(256)
#undef BWD_CASE
    default:
      return -1;
  }
}

}  // namespace

// q, o, do, dq: (B, S, H, hd); k, v, dk, dv: (B, S, KV, hd); contiguous,
// one dtype (dtype 0 float32, 1 bfloat16); ws: 3 B H S float32 scratch
// (m, l, D); hd 8, 16, 64, 80, 128 or 256.  Three launches on `stream`;
// returns the first cudaGetLastError() that is not 0 (0 on success; -1 for
// an unsupported hd or dtype, which the wrapper rules out first).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k,
                                          const void* v, const void* o,
                                          const void* dout, void* dq,
                                          void* dk, void* dv, void* ws,
                                          int B, int S, int H, int KV, int hd,
                                          int causal, int window, int dtype,
                                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (dtype == 0)
    return by_width<float>(hd, q, k, v, o, dout, dq, dk, dv, w, B, S, H, KV,
                           causal, window, st);
  if (dtype == 1)
    return by_width<__nv_bfloat16>(hd, q, k, v, o, dout, dq, dk, dv, w, B, S,
                                   H, KV, causal, window, st);
  return -1;
}
