// Register-tile helpers of the scan backward kernels (ssd_bwd_sm90.cu,
// wkv_bwd.cu).  A block of kThreads = 256 threads forms a 64 x 64 output,
// each thread a 4 x 4 register tile at rows ty + 16 i and columns
// tx + 16 j (ty = tid / 16, tx = tid % 16), from tiles of 64 rows padded
// to kLd = 65 floats in shared memory, so that every operand, read along
// its rows or its columns, falls in distinct banks.
#pragma once

#include <cuda_bf16.h>

namespace scan_tiles {

constexpr int kL = 64;       // rows of a tile: the longest chunk
constexpr int kMax = 64;     // columns of a tile: the largest P and N
constexpr int kLd = kMax + 1;
constexpr int kTile = kL * kLd;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_{k < K} a(ty + 16 i, k) b(k, tx + 16 j), with a(m, k) =
// A[m][k] (A[k][m] with TA) and b(k, n) = Bm[k][n] (Bm[n][k] with TB).
template <bool TA, bool TB>
__device__ __forceinline__ void mm(float (&acc)[4][4], const float* A,
                                   const float* Bm, int K, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = TA ? A[k * kLd + ty + 16 * i] : A[(ty + 16 * i) * kLd + k];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = TB ? Bm[(tx + 16 * j) * kLd + k] : Bm[k * kLd + tx + 16 * j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The (rows x D) tile at src, `stride` elements between rows, into a
// 64 x 64 tile widened to float32: zero past `rows` rows and D columns.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int rows, int D,
                                          int tid) {
  for (int i = tid; i < kL * kMax; i += kThreads) {
    const int t = i / kMax, d = i % kMax;
    dst[t * kLd + d] = t < rows && d < D ? to_f(src[t * stride + d]) : 0.f;
  }
}

}  // namespace scan_tiles
