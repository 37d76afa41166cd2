// Backward flash attention for Hopper (sm_90a), float32: the products on the
// TF32 tensor cores in 3xTF32, which keeps float32 accuracy.
//
// Replaces no Pallas kernel: it is the card's counterpart of JAX's
// custom-VJP backward of flash_mha, repro/models/attention.py::_flash_bwd
// (plain jnp under XLA on the TPU), for float32 inputs at every width JAX's
// configs use (hd 8, 16, 64, 80, 128, 256).  bf16 inputs go to
// flash_attention_bwd_sm90.cu (wgmma / TMA); flash_attention_bwd.cu, the
// SIMT kernel these replaced, is on no route.  It computes _flash_bwd's
// formulas from the forward's log-sum-exp lse (B, H, S) (JAX keeps m and l
// as residuals; lse = m + log(max(l, 1e-30))):
//   s = q_i . k_j * hd^-1/2 (masked pairs give p = 0: causal keeps j <= i,
//   the window j > i - window - 1), p = exp(s - lse_i), D_i = sum_d do_i o_i,
//   dv_j = sum_i p do_i, dp = do_i . v_j, ds = p (dp - D_i),
//   dq_i = sum_j ds k_j * hd^-1/2, dk_j = sum_i ds q_i * hd^-1/2,
// dk and dv summed over the H / KV query heads of a KV head; p and ds stay
// float32.
//
// 3xTF32 as in flash_attention_f32_sm90.cu: every operand x is split where
// it is read into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and a product
// a b is taken as al bh + ah bl + ah bh on mma.sync m16n8k8 TF32 with
// float32 sums (what is dropped is ~2^-21 of |a b|); each k-step's three
// are summed from zero and added to the running sum in float32 (`mma3`).
//
// Bound (smollm-135m's train shape in float32: B 8, S 1,024, H 9 over 3, hd
// 64, causal): five products over the kept pairs are ~24 GFLOP, 72.6 G in
// 3xTF32, 146.6 us at the 495 TFLOP/s of TF32 tensor cores (361 us on the
// 67 TFLOP/s float32 CUDA cores, where the SIMT kernel ran them); the ~103
// MB of inputs and outputs are 30 us.  So operations bound it.  Three
// launches, no atomics:
//   (a) prep, a thread a (b, i, h) row read in 16-byte words: D =
//       rowsum(do o), and lse copied into log2 units, into (B H, Sp)
//       float32 scratch rows padded to Sp = S rounded up to 64 (zeros past
//       S);
//   (b) dk / dv, a block a (b, KV head, 64 keys), key tile 0 (the heaviest
//       under the causal mask) first: K and V stay in shared memory while
//       Q, dO, lse and D tiles (64 queries; 32 at hd 80, 16 from hd 128) of
//       the group's query heads stream through two cp.async buffers, so
//       that two blocks share an SM up to hd 128 (one block of 4 warps hid
//       too little of the mma.sync latency: hd 80 took 6.3 ms at hubert's
//       shape, 4.2 ms with the smaller tiles, on one H100), from the causal diagonal (or
//       0) to the window's
//       end (or S), the next tile loading while this one is used; a warp
//       holds 16 keys and forms S^T = K Q^T and dP^T = V dO^T, P^T and dS^T
//       in registers, then dV += P^T dO and dK += dS^T Q.  At hd 256 dK and
//       dV of 16 keys are 128 registers a thread each, so there 8 warps
//       share the 64 keys, warps 0-3 forming dV and 4-7 dK (S^T formed
//       twice), with 16-query tiles to fit shared memory;
//   (c) dq, a block a (b, h, 64 query rows), the heaviest tiles first: Q
//       and dO stay in shared memory while K and V tiles (64 keys; 32 at hd
//       80, 16 from hd 128) stream through two buffers; S = Q K^T, dP = dO
//       V^T, P and dS in registers, dQ += dS K.
// Every product is taken in the permuted k order the forward uses (k t
// stands for column or key 2t, t + 4 for 2t + 1), so that the accumulator
// fragment of S^T, dS^T or dS is the A fragment of the next product as it
// lies, and the K-major operands are float2 reads.  Shared rows are padded
// to hd + 8 floats (hd at hd 8), which keeps those float2 reads on 32 banks
// (the column reads of the MN operands meet 2-way conflicts).  Masks are
// applied only on tiles the causal diagonal, the window edge or the end of
// S cuts, and a warp skips a tile none of whose pairs it keeps; rows and
// keys past S are zero-filled by cp.async and masked, and not stored.
// Every sum runs in a fixed order: two launches give the same bits.
// Launch bounds ask for one block an SM at least: with ptxas's own
// choice hd 16 was held to 128-168 registers and spilled.  ptxas: 0 spills
// at every width but the hd-256 dk / dv kernel (255 registers, 44 bytes of
// spill stores; fully unrolled, the S^T loop spilled from hd 128 up, hence
// its unroll of 4).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 64;          // scratch rows padded to a multiple
constexpr float kLog2e = 1.4426950408889634f;

// Per head width.  dk / dv: 64 keys a block, 16 a warp (4 warps; at hd 256
// 8 warps, two to the same keys), kBq queries a streamed tile; dq: 64 query
// rows a block, kKT keys a streamed tile.  The tiles are as deep as lets
// two blocks share an SM (at most ~113 KB of shared memory each) up to hd
// 128: one block of 4 warps an SM hid too little of the mma.sync latency.
// Offsets in floats.
template <int HD>
struct Cfg {
  static constexpr int kLd = HD % 32 == 8 ? HD : HD + 8;
  static constexpr bool kSplit = HD == 256;
  static constexpr int kWarps = kSplit ? 8 : 4;
  static constexpr int kKeys = 64;
  static constexpr int kBq = HD >= 128 ? 16 : HD == 80 ? 32 : 64;
  static constexpr int kStage = 2 * kBq * kLd + 2 * kBq;  // Q, dO, lse2, D
  static constexpr int kQ = 2 * kKeys * kLd;               // after K, V
  static constexpr int kBytes = (kQ + 2 * kStage) * 4;
  static constexpr int kBM = 64;
  static constexpr int kKT = HD >= 128 ? 16 : HD == 80 ? 32 : 64;
  static constexpr int kKStage = 2 * kKT * kLd;            // K, V
  static constexpr int kDqK = 2 * kBM * kLd;               // after Q, dO
  static constexpr int kDqBytes = (kDqK + 2 * kKStage) * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !in
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special-function unit (relative error ~2^-22).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + a residual of ~2^-22 |x|, hi and lo in TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d (16 x 8) += a (16 x 8) b (8 x 8), TF32 in, float32 accumulated
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the two small cross terms first, then hi hi, formed
// from zero and then added to d in float32.  The tensor cores' own adds
// drop the low bits of what they add to a larger sum rather than round
// them, so chained in d over a whole sum they drift by its length: dk
// (over G S / 8 steps) 1.3e-4 of its largest value from the float32 sum at
// GQA group 16, S 1,024; at a trained dbrx layer's attention, with the
// products of a k-step summed apart, dk still stood 3.6e-5 from float64
// (the plain version 1.5e-6) where s and dp chained over hd / 8 steps
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(p, al, bh[0], bh[1]);
  mma_tf32(p, ah, bl[0], bl[1]);
  mma_tf32(p, ah, bh[0], bh[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += p[e];
}

// The A fragment of m16n8k8 TF32 (a0: row g, k t; a1: row g + 8, k t; a2:
// row g, k t + 4; a3: row g + 8, k t + 4), split, from the values at rows
// g and g + 8 and the columns that k t and t + 4 stand for (2t, 2t + 1).
__device__ __forceinline__ void split_a(float g0, float g1, float h0, float h1,
                                        uint32_t (&ah)[4], uint32_t (&al)[4]) {
  split(g0, ah[0], al[0]);
  split(h0, ah[1], al[1]);
  split(g1, ah[2], al[2]);
  split(h1, ah[3], al[3]);
}

// d[N / 8][4] (16 x N) = A (16 rows at `a`) B^T (N rows at `b`) over HD,
// both row-major with rows of kLd floats: A's rows g, g + 8 and B's row
// 8j + g read as float2 at columns 8kk + 2t (the permuted k order)
template <int HD, int N>
__device__ __forceinline__ void product_nt(float (&d)[N / 8][4],
                                           const float* a, const float* b) {
  constexpr int LD = Cfg<HD>::kLd;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
  const float* ar = a + g * LD + 2 * t;
  const float* br = b + g * LD + 2 * t;
  // unrolled by 4 only: fully unrolled, ptxas hoisted the loads of every
  // step and spilled from hd 128 up
#pragma unroll 4
  for (int kk = 0; kk < HD / 8; ++kk) {
    const float2 x0 = *reinterpret_cast<const float2*>(ar + 8 * kk);
    const float2 x1 = *reinterpret_cast<const float2*>(ar + 8 * LD + 8 * kk);
    uint32_t ah[4], al[4];
    split_a(x0.x, x0.y, x1.x, x1.y, ah, al);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float2 y =
          *reinterpret_cast<const float2*>(br + 8 * j * LD + 8 * kk);
      uint32_t bh[2], bl[2];
      split(y.x, bh[0], bl[0]);
      split(y.y, bh[1], bl[1]);
      mma3(d[j], ah, al, bh, bl);
    }
  }
}

// acc[HD / 8][4] (16 x HD) += X (16 x N, the accumulator fragment of a
// product_nt) M (N rows at `m` of kLd floats, HD columns): X's fragment is
// the A fragment as it lies, M read at rows 8j + 2t, 8j + 2t + 1, column
// 8n + g
template <int HD, int N>
__device__ __forceinline__ void product_nn(float (&acc)[HD / 8][4],
                                           const float (&x)[N / 8][4],
                                           const float* m) {
  constexpr int LD = Cfg<HD>::kLd;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    uint32_t ah[4], al[4];
    split_a(x[j][0], x[j][1], x[j][2], x[j][3], ah, al);
    const float* mr = m + (8 * j + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      uint32_t bh[2], bl[2];
      split(mr[8 * n], bh[0], bl[0]);
      split(mr[LD + 8 * n], bh[1], bl[1]);
      mma3(acc[n], ah, al, bh, bl);
    }
  }
}

// rows [row0, row0 + rows) of an (S, HD) slice with row stride `stride`
// into shared rows of kLd floats by the block's `threads`; rows past S as
// zeros
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int row0,
                                          int rows, int S, int threads) {
  constexpr int C4 = HD / 4, LD = Cfg<HD>::kLd;
  for (int i = threadIdx.x; i < rows * C4; i += threads) {
    const int r = i / C4, c = i % C4, row = row0 + r;
    const bool in = row < S;
    cp_async16(dst + r * LD + 4 * c, src + (in ? row : 0) * stride + 4 * c,
               in);
  }
}

// whether query i and key j attend: j <= i if causal, j >= i - window with
// a window, both < S
__device__ __forceinline__ bool keep(int i, int j, int S, int causal,
                                     int window) {
  return i < S && j < S && (!causal || j <= i) &&
         (window <= 0 || j >= i - window);
}

// Store a 16 x HD accumulator (rows row0 + g, + 8, those < S) times `mul`
// into a (B, S, heads, HD) float32 tensor at (b, head).
template <int HD>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[HD / 8][4],
                                           float mul, int b, int head,
                                           int heads, int row0, int S) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int r_lo = row0 + g, r_hi = r_lo + 8;
  const long long stride = static_cast<long long>(heads) * HD;
  float* lo = out + (static_cast<long long>(b) * S + r_lo) * stride +
              static_cast<long long>(head) * HD + 2 * t;
  float* hi = lo + 8 * stride;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (r_lo < S)
      *reinterpret_cast<float2*>(lo + 8 * n) =
          make_float2(acc[n][0] * mul, acc[n][1] * mul);
    if (r_hi < S)
      *reinterpret_cast<float2*>(hi + 8 * n) =
          make_float2(acc[n][2] * mul, acc[n][3] * mul);
  }
}

// (a) D = rowsum(do o) and lse in log2 units into the padded (B H, Sp)
// scratch, a thread a (b, i, h) row (the rows of neighbouring heads lie
// side by side, so a warp reads 32 whole rows), read in 16-byte words and
// summed in a fixed order; then zeros past S
template <int HD>
__global__ void bwd_prep_kernel(const float* __restrict__ o,
                                const float* __restrict__ dout,
                                const float* __restrict__ lse,
                                float* __restrict__ lse2,
                                float* __restrict__ Dg, int B, int S, int Sp,
                                int H) {
  const long long real = static_cast<long long>(B) * S * H;
  const long long all = real + static_cast<long long>(B) * H * (Sp - S);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < all; r += step) {
    if (r < real) {
      const float4* po = reinterpret_cast<const float4*>(o + r * HD);
      const float4* pd = reinterpret_cast<const float4*>(dout + r * HD);
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < HD / 4; ++c) {
        const float4 x = pd[c], y = po[c];
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
        acc = fmaf(x.z, y.z, acc);
        acc = fmaf(x.w, y.w, acc);
      }
      const long long bh = (r / (static_cast<long long>(S) * H)) * H + r % H;
      const int i = static_cast<int>((r / H) % S);
      Dg[bh * Sp + i] = acc;
      lse2[bh * Sp + i] = lse[bh * S + i] * kLog2e;
    } else {
      const long long p = r - real;
      const long long at = (p / (Sp - S)) * Sp + S + p % (Sp - S);
      Dg[at] = 0.f;
      lse2[at] = 0.f;
    }
  }
}

// (b) dk and dv of one (b, KV head, 64 keys), summed over the group's query
// heads
template <int HD>
__global__ void __launch_bounds__(32 * Cfg<HD>::kWarps, 1)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse2, const float* __restrict__ Dg,
                float* __restrict__ dk, float* __restrict__ dv, int S, int Sp,
                int H, int KV, int causal, int window, float scale_log2,
                float scale) {
  using C = Cfg<HD>;
  constexpr int kThreads = 32 * C::kWarps, LD = C::kLd, kBq = C::kBq;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + C::kKeys * LD;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV, G = H / KV;
  const int k0 = blockIdx.y * C::kKeys;
  const int tid = threadIdx.x, warp = tid / 32;
  const int g = (tid % 32) / 4, t = tid % 4;
  const bool do_dv = !C::kSplit || warp < 4;
  const bool do_dk = !C::kSplit || warp >= 4;
  const int kw = k0 + 16 * (warp % 4);      // the warp's first key
  const long long qst = static_cast<long long>(H) * HD;
  const long long kst = static_cast<long long>(KV) * HD;
  const long long kv_off = static_cast<long long>(b) * S * kst +
                           static_cast<long long>(kvh) * HD;
  const int q_lo = causal ? (k0 / kBq) * kBq : 0;
  const int q_hi = window > 0 ? min(S, k0 + C::kKeys + window) : S;
  const int n_qt = (q_hi - q_lo + kBq - 1) / kBq;
  const int total = G * n_qt;

  // tile n's Q, dO, lse2 and D into buffer n % 2
  auto load_tile = [&](int n) {
    float* st = ks + C::kQ + (n % 2) * C::kStage;
    const int h = kvh * G + n / n_qt, q0 = q_lo + (n % n_qt) * kBq;
    const long long q_off = static_cast<long long>(b) * S * qst +
                            static_cast<long long>(h) * HD;
    load_rows<HD>(st, q + q_off, qst, q0, kBq, S, kThreads);
    load_rows<HD>(st + kBq * LD, dout + q_off, qst, q0, kBq, S, kThreads);
    const long long at = (static_cast<long long>(b) * H + h) * Sp + q0;
    for (int i = tid; i < kBq / 2; i += kThreads) {
      const bool is_d = i >= kBq / 4;
      const int c = is_d ? i - kBq / 4 : i;
      cp_async16(st + 2 * kBq * LD + (is_d ? kBq : 0) + 4 * c,
                 (is_d ? Dg : lse2) + at + 4 * c, true);
    }
  };
  load_rows<HD>(ks, k + kv_off, kst, k0, C::kKeys, S, kThreads);
  load_rows<HD>(vs, v + kv_off, kst, k0, C::kKeys, S, kThreads);
  load_tile(0);
  cp_async_commit();

  float acc0[HD / 8][4];                     // dV (at hd 256: dV or dK)
  float acc1[C::kSplit ? 1 : HD / 8][4];     // dK (unused at hd 256)
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc0[n][e] = 0.f;
  if constexpr (!C::kSplit) {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[n][e] = 0.f;
  }
  const float* kr = ks + 16 * (warp % 4) * LD;
  const float* vr = vs + 16 * (warp % 4) * LD;

  for (int n = 0; n < total; ++n) {
    if (n + 1 < total) load_tile(n + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile n (and K, V) landed
    const float* qs = ks + C::kQ + (n % 2) * C::kStage;
    const float* dos = qs + kBq * LD;
    const float* rows = qs + 2 * kBq * LD;     // lse2, then D
    const int q0 = q_lo + (n % n_qt) * kBq;
    const bool active = kw < S && (!causal || kw <= q0 + kBq - 1) &&
                        (window <= 0 || kw + 15 >= q0 - window);
    if (active) {
      float st[kBq / 8][4], dpt[kBq / 8][4];
      product_nt<HD, kBq>(st, kr, qs);        // S^T = K Q^T
      if (do_dk) product_nt<HD, kBq>(dpt, vr, dos);   // dP^T = V dO^T
      const bool edge = q0 + kBq > S || (causal && kw + 15 > q0) ||
                        (window > 0 && kw < q0 + kBq - 1 - window);
#pragma unroll
      for (int j = 0; j < kBq / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(rows + 8 * j +
                                                           2 * t);
        const float2 dd = *reinterpret_cast<const float2*>(rows + kBq +
                                                           8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(st[j][e] * scale_log2 - ((e & 1) ? l2.y : l2.x));
          if (edge && !keep(q0 + 8 * j + 2 * t + (e & 1), kw + g + 8 * (e >> 1),
                            S, causal, window))
            p = 0.f;
          st[j][e] = p;
          if (do_dk)
            dpt[j][e] = p * (dpt[j][e] - ((e & 1) ? dd.y : dd.x));
        }
      }
      if constexpr (C::kSplit) {
        // dV += P^T dO or dK += dS^T Q: one product for both roles (two
        // spilled), its operands selected
        float x[kBq / 8][4];
#pragma unroll
        for (int j = 0; j < kBq / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) x[j][e] = do_dv ? st[j][e] : dpt[j][e];
        product_nn<HD, kBq>(acc0, x, do_dv ? dos : qs);
      } else {
        product_nn<HD, kBq>(acc0, st, dos);
        product_nn<HD, kBq>(acc1, dpt, qs);
      }
    }
    __syncthreads();  // no warp reads buffer n % 2 any more
  }
  if constexpr (C::kSplit) {
    store_rows<HD>(do_dv ? dv : dk, acc0, do_dv ? 1.f : scale, b, kvh, KV,
                   kw, S);
  } else {
    store_rows<HD>(dv, acc0, 1.f, b, kvh, KV, kw, S);
    store_rows<HD>(dk, acc1, scale, b, kvh, KV, kw, S);
  }
}

// (c) dq of one (b, h, 64 query rows), heaviest tiles first
template <int HD>
__global__ void __launch_bounds__(128, 1)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse2, const float* __restrict__ Dg,
              float* __restrict__ dq, int S, int Sp, int H, int KV,
              int causal, int window, float scale_log2, float scale,
              int n_qtiles) {
  using C = Cfg<HD>;
  constexpr int LD = C::kLd, KT = C::kKT;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + C::kBM * LD;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (n_qtiles - 1 - static_cast<int>(blockIdx.y)) * C::kBM;
  const int tid = threadIdx.x, warp = tid / 32;
  const int g = (tid % 32) / 4, t = tid % 4;
  const int r0 = q0 + 16 * warp;             // the warp's first row
  const long long qst = static_cast<long long>(H) * HD;
  const long long kst = static_cast<long long>(KV) * HD;
  const long long q_off = static_cast<long long>(b) * S * qst +
                          static_cast<long long>(h) * HD;
  const long long kv_off = static_cast<long long>(b) * S * kst +
                           static_cast<long long>(h / (H / KV)) * HD;
  const int k_end = causal ? min(S, q0 + C::kBM) : S;
  const int k_lo = window > 0 ? (max(0, q0 - window) / KT) * KT : 0;
  const int n_kt = (k_end - k_lo + KT - 1) / KT;

  auto load_tile = [&](int n) {
    float* st = qs + C::kDqK + (n % 2) * C::kKStage;
    load_rows<HD>(st, k + kv_off, kst, k_lo + n * KT, KT, S, 128);
    load_rows<HD>(st + KT * LD, v + kv_off, kst, k_lo + n * KT, KT, S, 128);
  };
  load_rows<HD>(qs, q + q_off, qst, q0, C::kBM, S, 128);
  load_rows<HD>(dos, dout + q_off, qst, q0, C::kBM, S, 128);
  load_tile(0);
  cp_async_commit();
  // the thread's two rows' lse (log2 units) and D
  float l2[2], dd[2];
  {
    const long long at = static_cast<long long>(bh) * Sp;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = r0 + g + 8 * e;
      l2[e] = r < S ? lse2[at + r] : 0.f;
      dd[e] = r < S ? Dg[at + r] : 0.f;
    }
  }
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int n = 0; n < n_kt; ++n) {
    if (n + 1 < n_kt) load_tile(n + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile n (and Q, dO) landed
    const float* kt_s = qs + C::kDqK + (n % 2) * C::kKStage;
    const float* vt_s = kt_s + KT * LD;
    const int kt = k_lo + n * KT;
    const bool active = r0 < S && (!causal || kt <= r0 + 15) &&
                        (window <= 0 || kt + KT - 1 >= r0 - window);
    if (active) {
      float sc[KT / 8][4], dp[KT / 8][4];
      product_nt<HD, KT>(sc, qs + 16 * warp * LD, kt_s);    // S = Q K^T
      product_nt<HD, KT>(dp, dos + 16 * warp * LD, vt_s);   // dP = dO V^T
      const bool edge = kt + KT > S || (causal && kt + KT - 1 > r0) ||
                        (window > 0 && kt < r0 + 15 - window);
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(sc[j][e] * scale_log2 - l2[e >> 1]);
          if (edge && !keep(r0 + g + 8 * (e >> 1), kt + 8 * j + 2 * t + (e & 1),
                            S, causal, window))
            p = 0.f;
          dp[j][e] = p * (dp[j][e] - dd[e >> 1]);
        }
      product_nn<HD, KT>(acc, dp, kt_s);                    // dQ += dS K
    }
    __syncthreads();  // no warp reads buffer n % 2 any more
  }
  store_rows<HD>(dq, acc, scale, b, h, H, r0, S);
}

struct Args {
  const float *q, *k, *v, *o, *dout, *lse;
  float *dq, *dk, *dv, *ws;
  int B, S, H, KV, causal, window;
};

template <int HD>
int launch(const Args& a, cudaStream_t st) {
  using C = Cfg<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dq_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kDqBytes);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int B = a.B, S = a.S, H = a.H, KV = a.KV;
  const int Sp = (S + kPad - 1) / kPad * kPad;
  const long long rows = static_cast<long long>(B) * H * Sp;
  float* lse2 = a.ws;
  float* Dg = a.ws + rows;
  const float scale = 1.f / sqrtf(static_cast<float>(HD));
  const float scale_log2 = scale * kLog2e;
  const long long blocks = (rows + 255) / 256;   // a thread a row
  const int prep_blocks = static_cast<int>(blocks < 16LL * sms ? blocks
                                                               : 16LL * sms);
  bwd_prep_kernel<HD><<<prep_blocks, 256, 0, st>>>(a.o, a.dout, a.lse, lse2,
                                                   Dg, B, S, Sp, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_ktiles = (S + C::kKeys - 1) / C::kKeys;
  bwd_dkdv_kernel<HD><<<dim3(B * KV, n_ktiles), 32 * C::kWarps, C::kBytes,
                        st>>>(a.q, a.k, a.v, a.dout, lse2, Dg, a.dk, a.dv, S,
                              Sp, H, KV, a.causal, a.window, scale_log2,
                              scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (S + C::kBM - 1) / C::kBM;
  bwd_dq_kernel<HD><<<dim3(B * H, n_qtiles), 128, C::kDqBytes, st>>>(
      a.q, a.k, a.v, a.dout, lse2, Dg, a.dq, S, Sp, H, KV, a.causal,
      a.window, scale_log2, scale, n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, do, dq: (B, S, H, hd); k, v, dk, dv: (B, S, KV, hd); contiguous,
// 16-byte aligned, float32; lse: (B, H, S) float32, the forward's
// log-sum-exp; ws: 2 B H Sp float32 scratch (Sp = S rounded up to 64); hd
// 8, 16, 64, 80, 128 or 256; S at most 65,535 tiles of 64.  Three launches
// on `stream` (prep, dk / dv, dq); returns the first cudaGetLastError() that
// is not 0 (0 on success; -1 for an unsupported hd).
extern "C" int flash_attention_bwd_f32_sm90_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv, void* ws,
    int B, int S, int H, int KV, int hd, int causal, int window, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(o),
               static_cast<const float*>(dout), static_cast<const float*>(lse),
               static_cast<float*>(dq), static_cast<float*>(dk),
               static_cast<float*>(dv), static_cast<float*>(ws), B, S, H, KV,
               causal, window};
  switch (hd) {
    case 8: return launch<8>(a, st);
    case 16: return launch<16>(a, st);
    case 64: return launch<64>(a, st);
    case 80: return launch<80>(a, st);
    case 128: return launch<128>(a, st);
    case 256: return launch<256>(a, st);
    default: return -1;
  }
}
