// Forward flash attention for Hopper (sm_90a), float32: the products on the
// TF32 tensor cores in 3xTF32, which keeps float32 accuracy.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (body
// _flash_kernel) for float32 inputs at every width JAX's configs use: hd 8,
// 16, 64, 80, 128 and 256.  bf16 inputs go to flash_attention_sm90.cu;
// flash_attention.cu, the SIMT kernel this replaced (its products on the
// float32 CUDA cores), is on no route and is built only to be timed beside.
// Computes, for q (B, S, H, hd) and k, v (B, S, KV, hd) with H % KV == 0,
// query head h reading KV head h / (H / KV):
//   o[b, i, h] = sum_j softmax_j(mask(q_i . k_j * hd^-1/2)) v_j
// with the TPU kernel's arithmetic: scores in float32, masked scores set to
// -1e30, an online softmax (running max m, sum l, float32 accumulator) over
// KV tiles, P kept in float32 for O += P V (flash_attention.py:55-62), and
// o = acc / max(l, 1e-30).  The causal mask keeps j <= i, the sliding
// window j > i - window - 1.  The softmax runs in base 2 (scores prescaled
// by hd^-1/2 * log2(e), ex2.approx at 2^-22 relative), as in the bf16
// kernel.
//
// 3xTF32: every operand x is split once into hi = rna_tf32(x) and lo =
// rna_tf32(x - hi), and a product a b is taken as al bh + ah bl + ah bh on
// mma.sync m16n8k8 TF32, accumulated in float32.  What is dropped (al bl,
// and the residual of lo's rounding) is about 2^-21 of |a b|, inside the
// float32 tolerance the port holds its kernels to (2e-5); one TF32 product
// (2^-11) would not be.  Q is split as its fragments are read, once per
// 8 columns for all of a tile's keys; K and V as they are read; P in
// registers before P V.
//
// Bound (B 2, S 1,000, H 8 over KV 4, hd 256, causal): q, k, v and o are
// 49 MB, 14.7 us at 3.35 TB/s; the kept pairs need 8.2 GFLOP of products,
// 24.6 G in 3xTF32, 49.7 us at the 495 TFLOP/s of TF32 tensor cores (122.4
// us on the 67 TFLOP/s float32 CUDA cores, where the SIMT kernel ran
// them).  So operations bound it, and the design keeps the tensor cores
// fed and every operand split where it is read:
//   * a block takes one (b, h) and 16 query rows a warp (4 warps, 64 rows;
//     8 warps, 128 rows at hd 256); blocks run heaviest first (the last
//     query tile, which sees the most keys, on the grid's first row).
//     When every block is resident at once (B 2, S 1,000, H 8) the
//     heaviest ones set the time.  Pairing tile p with tile n - 1 - p in a
//     block evens the blocks, but holding both tiles' key ranges made
//     ptxas spill at every width from 64 up, and it was slower at every
//     shape but that one, so blocks take one tile;
//   * Q stays in shared memory for the block's life; K and V tiles of KT
//     keys (64; 32 at hd 256) stream through one buffer each by cp.async,
//     V_n loading while S_n runs and K_{n+1} while the softmax and P_n V_n
//     do (hd 256: Q 132 KB, K 33 KB, V 33 KB, 198 KB in all);
//   * S = Q K^T and O += P V run on m16n8k8 with both contractions taken
//     in a permuted order that needs no shuffle: the k-index t of a
//     fragment stands for column (or key) 2t and t + 4 for 2t + 1, so the
//     accumulator fragment of S (a thread holds keys 2t, 2t + 1) is P's A
//     fragment as it lies, and Q and K fragments are float2 reads;
//   * shared-memory rows are padded so that every fragment read hits 32
//     banks: Q and K rows of hd + 8 floats (hd at hd 8), read as float2 at
//     (row g, column 2t); V rows of hd + 4, read at (key 2t, column g);
//   * the online softmax runs on the S fragment (two rows a thread, row
//     max and sum across the four threads of a row by shuffles); masks are
//     applied only on tiles the causal diagonal, the window edge or the end
//     of S cuts, and a warp skips a tile no key of which its rows keep;
//   * the KV loop stops at the block's causal frontier and starts at the
//     first tile the window reaches (a tile masked for every row only adds
//     terms that the first unmasked score multiplies by exp2(-1e30 - m) =
//     0).  Keys and rows past S are zero-filled by cp.async and masked,
//     rows past S are not stored, so any S works.
// With a non-null lse the kernel also writes each row's log-sum-exp, (m +
// log2 l) ln 2, for the backward kernels.  Launch bounds ask for one block
// an SM at least: beside that epilogue ptxas's own choice held hd 64 and
// 128 to 128 and 168 registers and spilled 48 and 8 bytes; so it takes 142
// and 186 and spills nothing at any width (hd 80's earlier 4-byte spill
// went too), at equal or lower times on an H100.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Per head width: warps of 16 query rows a block, keys a K / V tile, and
// the padded row strides (floats) of Q and K (8 or 24 mod 32) and of V (4
// or 12 mod 16), which keep the fragment reads free of bank conflicts.
// Offsets in floats: Q, then K, then V.
template <int HD>
struct F32Config {
  static constexpr int kWarps = HD == 256 ? 8 : 4;
  static constexpr int kBM = 16 * kWarps;
  static constexpr int kKT = HD == 256 ? 32 : 64;
  static constexpr int kLdQK = HD % 32 == 8 ? HD : HD + 8;
  static constexpr int kLdV = HD + 4;
  static constexpr int kK = kBM * kLdQK;
  static constexpr int kV = kK + kKT * kLdQK;
  static constexpr int kBytes = (kV + kKT * kLdV) * 4;
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
// Wait until at most N committed groups of this thread are in flight.
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

// log2(x) on the special-function unit (absolute error ~2^-22), for the
// log-sum-exp of a row (x = max(l, 1e-30), a normal float)
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
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
// from zero and then added to d in float32 (the tensor cores' own adds
// drop the low bits of what they add to a larger sum rather than round
// them, and chained in d over a whole sum they drift by its length: see
// flash_attention_bwd_f32_sm90.cu).  Here O chains over S / 8 k-steps:
// chained, out stood 1.1e-5 of its largest value from float64 at a
// trained qwen3-moe layer (S 1,024), the plain float32 version 2.7e-6 and
// this form 9.3e-7 (tools/flash_bwd_precision.py --forward), for 12-41%
// more time
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
  split(g0, ah[0], al[0]);   // row g, column 2t
  split(h0, ah[1], al[1]);   // row g + 8, column 2t
  split(g1, ah[2], al[2]);   // row g, column 2t + 1
  split(h1, ah[3], al[3]);   // row g + 8, column 2t + 1
}

template <int HD>
__global__ void __launch_bounds__(32 * F32Config<HD>::kWarps, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int KV, int causal,
                 int window, float scale_log2, int n_qtiles) {
  using C = F32Config<HD>;
  constexpr int kThreads = 32 * C::kWarps, KT = C::kKT, C4 = HD / 4;
  constexpr int LQ = C::kLdQK, LV = C::kLdV;
  static_assert(HD % 8 == 0, "hd a multiple of the k-step of 8");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + C::kK;
  float* vs = qs + C::kV;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (n_qtiles - 1 - static_cast<int>(blockIdx.y)) * C::kBM;
  const int tid = threadIdx.x, warp = tid / 32;
  const int g = (tid % 32) / 4, t = tid % 4;   // the fragments' group, thread
  const int r0 = q0 + 16 * warp;                // the warp's first row
  const long long q_stride = static_cast<long long>(H) * HD;
  const long long kv_stride = static_cast<long long>(KV) * HD;
  const float* qg = q + static_cast<long long>(b) * S * q_stride +
                    static_cast<long long>(h) * HD;
  const long long kv_off = static_cast<long long>(b) * S * kv_stride +
                           static_cast<long long>(h / (H / KV)) * HD;
  const float* kg = k + kv_off;
  const float* vg = v + kv_off;

  // rows [row0, row0 + rows) of an (S, hd) slice with row stride `stride`
  // into shared memory rows of `ld` floats; rows past S read as zeros
  auto load = [&](float* dst, int ld, const float* src, long long stride,
                  int row0, int rows) {
    for (int i = tid; i < rows * C4; i += kThreads) {
      const int r = i / C4, c = i % C4, row = row0 + r;
      const bool in = row < S;
      cp_async16(dst + r * ld + 4 * c, src + (in ? row : 0) * stride + 4 * c,
                 in);
    }
  };

  // causal: no key past the block's last row; window: none before the
  // first key its first row sees
  const int k_end = causal ? min(S, q0 + C::kBM) : S;
  const int k_begin = window > 0 ? (max(0, q0 - window) / KT) * KT : 0;
  load(qs, LQ, qg, q_stride, q0, C::kBM);
  load(ks, LQ, kg, kv_stride, k_begin, KT);
  cp_async_commit();

  float acc[HD / 8][4];  // O: 8 columns an n-tile (row g: 0, 1; g + 8: 2, 3)
  float sc[KT / 8][4];   // S, then P: 8 keys an n-tile
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float* qw = qs + (16 * warp + g) * LQ + 2 * t;  // row g, column 2t

  for (int kt = k_begin; kt < k_end; kt += KT) {
    cp_async_wait<0>();
    __syncthreads();  // K_n (and Q) landed; no warp reads V_{n-1} any more
    load(vs, LV, vg, kv_stride, kt, KT);
    cp_async_commit();
    // whether the warp's rows keep any key of the tile (warp-uniform)
    const bool active = r0 < S && (!causal || kt <= r0 + 15) &&
                        (window <= 0 || kt + KT - 1 >= r0 - window);
    if (active) {
      // S = Q K^T over HD / 8 k-steps; the Q fragment split once a step
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const float2 x0 = *reinterpret_cast<const float2*>(qw + 8 * kk);
        const float2 x1 =
            *reinterpret_cast<const float2*>(qw + 8 * LQ + 8 * kk);
        uint32_t ah[4], al[4];
        split_a(x0.x, x0.y, x1.x, x1.y, ah, al);
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          // B: k t, t + 4 -> columns 2t, 2t + 1 of key 8j + g
          const float2 y = *reinterpret_cast<const float2*>(
              ks + (8 * j + g) * LQ + 8 * kk + 2 * t);
          uint32_t bh2[2], bl2[2];
          split(y.x, bh2[0], bl2[0]);
          split(y.y, bh2[1], bl2[1]);
          mma3(sc[j], ah, al, bh2, bl2);
        }
      }
    }
    __syncthreads();  // no warp reads K_n any more
    if (kt + KT < k_end) load(ks, LQ, kg, kv_stride, kt + KT, KT);
    cp_async_commit();
    float al2[2] = {1.f, 1.f};
    if (active) {
      // one online-softmax step: scores to log2 units, masked on cut tiles
      // (row r keeps keys in [lo, hi]), the new row max across the row's
      // four threads, p = 2^(s - m)
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] *= scale_log2;
      const bool edge = kt + KT > S || (causal && kt + KT - 1 > r0) ||
                        (window > 0 && kt < r0 + 15 - window);
      if (edge) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int row = r0 + g + 8 * e2;
          const int lo = window > 0 ? row - window : 0;
          const int hi = causal ? min(row, S - 1) : S - 1;
#pragma unroll
          for (int j = 0; j < KT / 8; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int key = kt + 8 * j + 2 * t + c;
              if (key < lo || key > hi) sc[j][2 * e2 + c] = kNegInf;
            }
        }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int d = 1; d < 4; d *= 2)
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], d));
        const float mn = fmaxf(m[i], mx[i]);
        al2[i] = ex2(m[i] - mn);
        m[i] = mn;
      }
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = ex2(sc[j][e] - m[e / 2]);
          ps[e / 2] += sc[j][e];
        }
      l[0] = l[0] * al2[0] + ps[0];
      l[1] = l[1] * al2[1] + ps[1];
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[n][0] *= al2[0];
        acc[n][1] *= al2[0];
        acc[n][2] *= al2[1];
        acc[n][3] *= al2[1];
      }
    }
    cp_async_wait<1>();
    __syncthreads();  // V_n landed
    if (active) {
      // O += P V: P's A fragment is S's accumulator fragment (k t, t + 4 ->
      // keys 2t, 2t + 1), split once for every n-tile of O
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        uint32_t ah[4], al[4];
        split_a(sc[j][0], sc[j][1], sc[j][2], sc[j][3], ah, al);
        const float* vr = vs + (8 * j + 2 * t) * LV + g;  // key 2t, column g
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          uint32_t bh2[2], bl2[2];
          split(vr[8 * n], bh2[0], bl2[0]);
          split(vr[LV + 8 * n], bh2[1], bl2[1]);
          mma3(acc[n], ah, al, bh2, bl2);
        }
      }
    }
  }

  float l_lo = l[0], l_hi = l[1];
#pragma unroll
  for (int d = 1; d < 4; d *= 2) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, d);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, d);
  }
  const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
  const int row_lo = r0 + g, row_hi = row_lo + 8;
  float* o_lo = o + (static_cast<long long>(b) * S + row_lo) * q_stride +
                static_cast<long long>(h) * HD + 2 * t;
  float* o_hi = o_lo + 8 * q_stride;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (row_lo < S)
      *reinterpret_cast<float2*>(o_lo + 8 * n) =
          make_float2(acc[n][0] / den_lo, acc[n][1] / den_lo);
    if (row_hi < S)
      *reinterpret_cast<float2*>(o_hi + 8 * n) =
          make_float2(acc[n][2] / den_hi, acc[n][3] / den_hi);
  }
  // the rows' log-sum-exp in natural-log units, m + log2(l) (log2 units)
  // converted once: one thread of the row's four writes it
  if (lse != nullptr && t == 0) {
    float* lr = lse + static_cast<long long>(bh) * S;
    if (row_lo < S) lr[row_lo] = (m[0] + lg2(den_lo)) * kLn2;
    if (row_hi < S) lr[row_hi] = (m[1] + lg2(den_hi)) * kLn2;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int H, int KV, int causal, int window,
           cudaStream_t stream) {
  using C = F32Config<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (S + C::kBM - 1) / C::kBM;
  const dim3 grid(B * H, n_qtiles);  // every (b, h) of a query tile together
  flash_f32_kernel<HD><<<grid, 32 * C::kWarps, C::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, H, KV,
      causal, window, kLog2e / sqrtf(static_cast<float>(HD)), n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (B, S, H, hd); k, v: (B, S, KV, hd); contiguous, 16-byte aligned,
// float32; hd 8, 16, 64, 80, 128 or 256; S at most 65,535 query tiles.
// lse: null, or (B, H, S) float32 that receives each row's log-sum-exp (the
// backward's residual).  Launches on `stream` and returns cudaGetLastError()
// (0 on success; -1 for an unsupported hd, which the wrapper rules out
// first).
extern "C" int flash_attention_f32_sm90_launch(const void* q, const void* k,
                                               const void* v, void* o,
                                               void* lse, int B, int S, int H,
                                               int KV, int hd, int causal,
                                               int window, int device,
                                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (hd) {
    case 8: return launch<8>(q, k, v, o, l, B, S, H, KV, causal, window, st);
    case 16: return launch<16>(q, k, v, o, l, B, S, H, KV, causal, window, st);
    case 64: return launch<64>(q, k, v, o, l, B, S, H, KV, causal, window, st);
    case 80: return launch<80>(q, k, v, o, l, B, S, H, KV, causal, window, st);
    case 128: return launch<128>(q, k, v, o, l, B, S, H, KV, causal, window, st);
    case 256: return launch<256>(q, k, v, o, l, B, S, H, KV, causal, window, st);
    default: return -1;
  }
}
