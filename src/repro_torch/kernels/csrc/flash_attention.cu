// Forward flash attention for Hopper (sm_90a), the first, SIMT kernel: on
// no route of the port.  It was the port of
// repro/kernels/flash_attention.py::flash_attention_pallas (body
// _flash_kernel) until flash_attention_sm90.cu (bf16, wgmma + TMA) and
// flash_attention_f32_sm90.cu (float32, 3xTF32 on the tensor cores)
// replaced it at every width; it is still built, and called through its
// entry directly, so that chip_smoke.py and tools/flash_widths.py time it
// beside both replacements on the same inputs.  Computes, for q (B, S, H, hd) and k, v (B, S, KV, hd)
// with H % KV == 0, query head h reading KV head h / (H / KV):
//   o[b, i, h] = sum_j softmax_j(mask(q_i . k_j * hd^-1/2)) v_j
// with the TPU kernel's arithmetic: scores in float32, masked scores set
// to -1e30, an online softmax (running max m, sum l, float32 accumulator)
// over KV tiles, and o = acc / max(l, 1e-30) in q's type.  The causal
// mask keeps j <= i, the sliding window j > i - window - 1.
//
// Bound (zamba2-1.2b's prefill: B 4, S 1024, H 32, hd 64, bf16, causal):
// q, k, v and o are 67 MB, 20 us at 3.35 TB/s; the causal products are
// about 17 GFLOP, 17 us at the 989 TFLOP/s of bf16 tensor cores.  So the
// data bound is bytes, barely.  This first kernel runs its products on the
// float32 CUDA cores (67 TFLOP/s), about 0.26 ms at best: a later kernel
// reaches the bound with wgmma on bf16 tiles fed by TMA.
//
// Design: a block takes one (b, h) and a tile of 64 query rows, L threads
// per row (L = min(4, hd / 4): four from hd 16 up, two at hd 8).  Each
// thread keeps 1/L of its row's q and of the float32 accumulator in
// registers, in float4 chunks interleaved across the L lanes (lane t holds
// chunks t, t + L, ...), so a row's lanes read one key's 16-byte chunks
// side by side from shared memory and the rows of a warp read the same
// addresses (a broadcast).  K and V stream through shared memory in tiles
// of KT keys, converted to float32 on load; a score is the L lanes'
// partial dots summed by xor shuffles.  Per tile each lane holds the KT
// scores, takes the tile max, rescales l and its accumulator once, and
// adds p V.  The KV loop stops at the block's causal frontier (the TPU
// kernel's loop bound) and starts at the first tile the sliding window
// reaches: a tile that is masked for every row of the block would only add
// terms that the first unmasked score multiplies by exp(-1e30 - m) = 0, so
// skipping it changes nothing.  Keys past S are masked and read as zeros,
// and rows past S are computed but not written, so any S works (the TPU
// kernel asserts S % 128 == 0).
//
// Head widths: every width a JAX config uses, 8, 16, 64, 80, 128 and 256
// (a multiple of 4 and of L float4 chunks; the wrapper refuses others).
// KT shrinks as hd grows so that ks and vs stay in the 48 KB of static
// shared memory: 64 keys up to hd 64, 32 at hd 80 and 128, 16 at hd 256
// (2 x 16 x 256 x 4 bytes = 32 KB).  At hd 256 a thread holds 16 float4
// of q and 16 of the accumulator (128 registers) beside its 16 scores:
// one block of 256 threads an SM (ptxas: 231 registers in bf16, 238 in
// float32, no spills), a first kernel that is right and slow: 5.94 ms at
// gemma3-4b's prefill (B 4, S 2048, H 8 over 4, causal, bf16) on an H100
// SXM at 700 W, against a 69 us bound and 0.14 ms for PyTorch's SDPA.  At
// B 2, S 1,000, H 8 over 4, causal: bf16 hd 8 / 16 0.080 / 0.141 ms
// (SDPA 0.027 / 0.037), float32 hd 256 1.10 ms (SDPA 0.68), where the
// float32 CUDA cores (67 TFLOP/s) bound its products; the tensor-core
// kernels that replaced it take every one of these pairs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;                  // query rows per block
constexpr float kNegInf = -1e30f;

// threads per query row: four float4 chunks side by side, fewer when the
// row has fewer chunks (hd 8: two)
constexpr int lanes_for(int hd) { return hd / 4 < 4 ? hd / 4 : 4; }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(v.x, v.y);
  p2[1] = __floats2bfloat162_rn(v.z, v.w);
}

template <typename T, int HD, int KT, int L>
__global__ void __launch_bounds__(kRows * L)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int H,
             int KV, int causal, int window, float scale) {
  constexpr int kThreads = kRows * L;
  constexpr int C4 = HD / 4;          // float4 chunks per row
  constexpr int D4 = C4 / L;          // chunks per thread
  static_assert(HD % 4 == 0 && C4 % L == 0 && D4 > 0, "unsupported hd");
  static_assert(2 * KT * C4 * 16 <= 48 * 1024, "K/V tiles past 48 KB");
  __shared__ float4 ks[KT][C4];
  __shared__ float4 vs[KT][C4];

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int row = threadIdx.x / L, lane = threadIdx.x % L;
  const int qi = q0 + row;
  const int kvh = h / (H / KV);

  float4 qr[D4], acc[D4];
  const T* qp = q + ((static_cast<long long>(b) * S + min(qi, S - 1)) * H + h) * HD;
#pragma unroll
  for (int i = 0; i < D4; ++i) {
    qr[i] = load4(qp + 4 * (lane + L * i));
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf, l = 0.f;

  // causal: no key past the block's last row; window: none before the
  // first key its first row sees
  const int k_end = causal ? min(S, q0 + kRows) : S;
  const int k_begin = window > 0 ? (max(0, q0 - window) / KT) * KT : 0;

  for (int kt = k_begin; kt < k_end; kt += KT) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < KT * C4; idx += kThreads) {
      const int j = idx / C4, c = idx % C4;
      const int key = kt + j;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (key < S) {
        const long long off =
            ((static_cast<long long>(b) * S + key) * KV + kvh) * HD + 4 * c;
        kk = load4(k + off);
        vv = load4(v + off);
      }
      ks[j][c] = kk;
      vs[j][c] = vv;
    }
    __syncthreads();

    float s[KT];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < D4; ++i) {
        const float4 kk = ks[j][lane + L * i];
        part += qr[i].x * kk.x + qr[i].y * kk.y + qr[i].z * kk.z +
                qr[i].w * kk.w;
      }
#pragma unroll
      for (int off = 1; off < L; off *= 2)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const int key = kt + j;
      const bool keep = key < S && (!causal || key <= qi) &&
                        (window <= 0 || key > qi - window - 1);
      s[j] = keep ? part * scale : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < D4; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float p = s[j];
#pragma unroll
      for (int i = 0; i < D4; ++i) {
        const float4 vv = vs[j][lane + L * i];
        acc[i].x += p * vv.x;
        acc[i].y += p * vv.y;
        acc[i].z += p * vv.z;
        acc[i].w += p * vv.w;
      }
    }
    m = m_new;
  }

  if (qi < S) {
    const float den = fmaxf(l, 1e-30f);
    T* op = o + ((static_cast<long long>(b) * S + qi) * H + h) * HD;
#pragma unroll
    for (int i = 0; i < D4; ++i) {
      store4(op + 4 * (lane + L * i),
             make_float4(acc[i].x / den, acc[i].y / den, acc[i].z / den,
                         acc[i].w / den));
    }
  }
}

template <typename T, int HD, int KT>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, int causal, int window, cudaStream_t stream) {
  constexpr int L = lanes_for(HD);
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_kernel<T, HD, KT, L><<<grid, kRows * L, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, causal, window,
      1.0f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int KV, int hd, int causal, int window,
              cudaStream_t st) {
  switch (hd) {
    case 8: return launch<T, 8, 64>(q, k, v, o, B, S, H, KV, causal, window, st);
    case 16: return launch<T, 16, 64>(q, k, v, o, B, S, H, KV, causal, window, st);
    case 64: return launch<T, 64, 64>(q, k, v, o, B, S, H, KV, causal, window, st);
    case 80: return launch<T, 80, 32>(q, k, v, o, B, S, H, KV, causal, window, st);
    case 128: return launch<T, 128, 32>(q, k, v, o, B, S, H, KV, causal, window, st);
    case 256: return launch<T, 256, 16>(q, k, v, o, B, S, H, KV, causal, window, st);
    default: return -1;
  }
}

}  // namespace

// q, o: (B, S, H, hd); k, v: (B, S, KV, hd); contiguous, 16-byte aligned,
// all float32 (dtype 0) or all bfloat16 (dtype 1); hd 8, 16, 64, 80, 128 or
// 256.  Launches on `stream` and returns cudaGetLastError() (0 on success;
// -1 for an unsupported hd or dtype, which the wrapper rules out first).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int KV, int hd, int causal,
                                      int window, int dtype, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(q, k, v, o, B, S, H, KV, hd, causal, window, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, o, B, S, H, KV, hd, causal,
                                    window, st);
  return -1;
}
