// Tensor-core tiles of the scan backward kernels (ssd_bwd_sm90.cu,
// wkv_bwd.cu): products of 64-row tiles on mma.sync m16n8k8 TF32, with
// float32 sums.
//
// A block of kThreads = 256 threads (8 warps) forms a 64 x 64 output.  Warp
// w holds its rows 16 wm .. 16 wm + 15 and columns 32 wn .. 32 wn + 31, four
// n-tiles of 8, with wn = w / 4 and wm = w below 4, 7 - w from 4: the two
// warps of an SM sub-partition (w and w + 4) hold row tiles wm and 3 - wm,
// so a product over a triangle loads the four sub-partitions evenly.  Each
// thread holds acc[j][e] at row 16 wm + g + 8 (e / 2) and column 32 wn + 8 j
// + 2 t + e % 2 (g = lane / 4, t = lane % 4: the accumulator layout of
// m16n8k8), the same place in every product, so terms of several products
// at one (row, column) combine in registers.  Sums along a row are a quad's
// shuffles plus the other column half's warp; sums down a column, shuffles
// over g plus the other three row tiles' warps; both in a fixed order.
//
// Operands sit in shared memory as float32 tiles of 64 rows padded to kLd =
// 68 floats; a product reads them in three layouts ([m][k] by [n][k], [m][k]
// by [k][n], [k][m] by [k][n]) with scalar loads (TF32 has no
// ldmatrix.trans).  An operand read along its rows takes k = t and t + 4 in
// a k-step (banks 4 g + t: conflict-free); where one is read down its
// columns the k-step takes 2 t and 2 t + 1 (banks 8 t + g: conflict-free
// there, 2-way on the [m][k] side of an [m][k] by [k][n] product).
//
// Precision: a float32 operand x is split into hi (x rounded to TF32) and
// lo = x - hi, and a product a b is taken as al bh + ah bl + ah bh
// (3xTF32: what is dropped is ~2^-21 of |a b|, float32's own rounding); a
// bf16 input widened to float32 is exact in TF32 (8 of its 10 mantissa
// bits), so against it two terms suffice (al b + ah b), and one where both
// operands are bf16 inputs.  Values below float32's normal range lose bits
// in the split as in any float32 product.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace scan_tiles {

constexpr int kL = 64;         // rows of a tile
constexpr int kMax = 64;       // columns of a tile: the largest P and N
constexpr int kLd = kMax + 4;  // padded row
constexpr int kTile = kL * kLd;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// x0, x1 at columns p, p + 1 (p even) of the row at out, those below P: one
// store of both where P is even (the row and p then hold their alignment)
__device__ __forceinline__ void put2(float* out, int p, int P, float x0,
                                     float x1) {
  if (P % 2 == 0 && p < P) {
    *reinterpret_cast<float2*>(out + p) = make_float2(x0, x1);
  } else {
    if (p < P) out[p] = x0;
    if (p + 1 < P) out[p + 1] = x1;
  }
}
__device__ __forceinline__ void put2(__nv_bfloat16* out, int p, int P,
                                     float x0, float x1) {
  if (P % 2 == 0 && p < P) {
    *reinterpret_cast<__nv_bfloat162*>(out + p) =
        __floats2bfloat162_rn(x0, x1);
  } else {
    if (p < P) out[p] = __float2bfloat16(x0);
    if (p + 1 < P) out[p + 1] = __float2bfloat16(x1);
  }
}

// This thread's place in a 64 x 64 output (see the note above).
struct Frag {
  int wm, wn, g, t;
  __device__ __forceinline__ int row(int e) const {
    return 16 * wm + g + ((e & 2) << 2);
  }
  __device__ __forceinline__ int col(int j, int e) const {
    return 32 * wn + 8 * j + 2 * t + (e & 1);
  }
};

__device__ __forceinline__ Frag frag() {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return {w < 4 ? w : 7 - w, w >> 2, lane >> 2, lane & 3};
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// d (16 x 8) += a (16 x 8) b (8 x 8), TF32 in, float32 accumulated
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x as hi + lo (S), or its own bits where x is exact in TF32.  hi is x
// rounded to TF32 by integer operations (half an ulp of TF32 added, the 13
// low bits dropped) and lo = x - hi exactly, handed over with the low bits
// that the tensor cores ignore, so truncated to TF32 there: what is lost is
// under 2^-21 of |x|.  No cvt.rna.tf32.f32: with it, the splits set the
// pace of the products.
template <bool S>
__device__ __forceinline__ void cut(float x, uint32_t& hi, uint32_t& lo) {
  if (S) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// (i, k) of a tile stored [i][k], or [k][i] when Tr
template <bool Tr>
__device__ __forceinline__ float at(const float* p, int i, int k) {
  return Tr ? p[k * kLd + i] : p[i * kLd + k];
}

// acc += a b over the k-steps [k0, k1) (8 k each), for this warp's n-tiles
// j < jn only, with a(m, k) = A[m][k] (A[k][m] when TA) and b(k, n) =
// B[k][n] (B[n][k] when TB).  SA / SB: that operand holds float32 values,
// taken as hi + lo; else its values are exact in TF32.  With Sc, A's values
// are first multiplied by sc at their column in A's storage (k, or m when
// TA).
template <bool TA, bool TB, bool SA, bool SB, bool Sc = false>
__device__ __forceinline__ void mm(float (&acc)[4][4], const float* A,
                                   const float* B, int k0, int k1, int jn,
                                   const Frag& f, const float* sc = nullptr) {
  constexpr bool kPerm = TA || !TB;  // an operand read down its columns
  const int ka = kPerm ? 2 * f.t : f.t;
  const int kb = kPerm ? 2 * f.t + 1 : f.t + 4;
  const int m0 = 16 * f.wm + f.g;
#pragma unroll 2
  for (int ks = k0; ks < k1; ++ks) {
    const int k = 8 * ks;
    float av[4] = {at<TA>(A, m0, k + ka), at<TA>(A, m0 + 8, k + ka),
                   at<TA>(A, m0, k + kb), at<TA>(A, m0 + 8, k + kb)};
    if (Sc) {
      if (TA) {
        av[0] *= sc[m0];
        av[1] *= sc[m0 + 8];
        av[2] *= sc[m0];
        av[3] *= sc[m0 + 8];
      } else {
        av[0] *= sc[k + ka];
        av[1] *= sc[k + ka];
        av[2] *= sc[k + kb];
        av[3] *= sc[k + kb];
      }
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) cut<SA>(av[i], ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < jn) {
        const int n = 32 * f.wn + 8 * j + f.g;
        uint32_t bh[2], bl[2];
        cut<SB>(at<!TB>(B, n, k + ka), bh[0], bl[0]);
        cut<SB>(at<!TB>(B, n, k + kb), bh[1], bl[1]);
        if (SA) mma_tf32(acc[j], al, bh[0], bh[1]);
        if (SB) mma_tf32(acc[j], ah, bl[0], bl[1]);
        mma_tf32(acc[j], ah, bh[0], bh[1]);
      }
    }
  }
}

// How many of this warp's n-tiles hold a column <= the last row of its row
// tile: the tiles of a lower-triangular output that are not wholly above
// the diagonal.
__device__ __forceinline__ int lower_tiles(const Frag& f) {
  const int d = 16 * f.wm + 15 - 32 * f.wn;
  return d < 0 ? 0 : min(4, d / 8 + 1);
}

// Row sums: this thread's sums over its columns of rows row(0) (lo) and
// row(2) (hi), then the quad's; lanes t == 0 write them to part[wn][row].
// The caller adds part[0][r] + part[1][r] after a barrier.  Every lane of
// the warp calls it.
__device__ __forceinline__ void row_sums(float lo, float hi, float* part,
                                         const Frag& f) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    lo += __shfl_xor_sync(0xffffffffu, lo, off);
    hi += __shfl_xor_sync(0xffffffffu, hi, off);
  }
  if (f.t == 0) {
    part[f.wn * kL + f.row(0)] = lo;
    part[f.wn * kL + f.row(2)] = hi;
  }
}

// Column sums: this thread's sums over its two rows of columns col(j, e)
// (c[j][e]), then over g by shuffles; lanes g == 0 write them to
// part[wm][column].  The caller adds part[0..3][c] in order after a
// barrier.  Every lane of the warp calls it.
__device__ __forceinline__ void col_sums(float (&c)[4][2], float* part,
                                         const Frag& f) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = c[j][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
      }
      if (f.g == 0) part[f.wm * kL + f.col(j, e)] = s;
    }
}

// A thread's elements of a 64 x 64 tile: column tid % kMax of the rows
// tid / kMax + kStep it, it < kPer.
constexpr int kPer = kL * kMax / kThreads;
constexpr int kStep = kThreads / kMax;

// This thread's elements of the (rows x D) tile at src, `stride` elements
// between rows, widened to float32: `fill` past `rows` rows and D columns.
// Callers fetch every tile they need before they store any, so that all
// the loads are in flight together.  The addresses step by a fixed stride
// from one base, so nothing per element is kept across the caller's loops.
template <typename T>
__device__ __forceinline__ void fetch_tile(float (&v)[kPer], const T* src,
                                           long long stride, int rows, int D,
                                           int tid, float fill = 0.f) {
  const int t0 = tid / kMax, d = tid % kMax;
  const T* q = src + t0 * stride + d;
#pragma unroll
  for (int it = 0; it < kPer; ++it) {
    v[it] = t0 + kStep * it < rows && d < D ? to_f(*q) : fill;
    q += kStep * stride;
  }
}

__device__ __forceinline__ void store_tile(float* dst, const float (&v)[kPer],
                                           int tid) {
  float* q = dst + (tid / kMax) * kLd + tid % kMax;
#pragma unroll
  for (int it = 0; it < kPer; ++it) q[kStep * kLd * it] = v[it];
}

// Sums over a warp in a fixed order (every lane gets the sum).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

}  // namespace scan_tiles
