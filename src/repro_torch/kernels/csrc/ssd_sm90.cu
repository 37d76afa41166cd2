// Mamba-2 SSD chunked scan for Hopper (sm_90a), bf16, on the tensor cores.
//
// Replaces repro/kernels/ssd.py::ssd_pallas (body _ssd_kernel) for bf16
// x, B and C; float32 inputs keep the SIMT kernel in ssd.cu.  For x
// (B, T, H, P), dt (B, T, H), A (H,) and one B/C group (B, T, N), per
// (b, h) with a scalar decay per step and a (P x N) float32 state:
//   S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,   y_t = S_t C_t
// in chunks of 64 steps (the decomposition of Mamba-2, arXiv:2405.21060
// section 6): cum = inclusive cumsum of dt A over the chunk,
//   y   = exp(cum_t) (C S_{c-1}^T)_t + (W x)_t,
//         W[t][s] = [s <= t] exp(cum_t - cum_s) (C B^T)[t][s] dt_s,
//   S_c = exp(cum_end) S_{c-1} + x^T (dec o B),
//         dec_s = exp(cum_end - cum_s) dt_s.
// It also writes the final state (B, H, P, N) float32, which the model's
// decode cache needs (ssd_pallas drops it from its VMEM scratch).
//
// Bound (zamba2-1.2b's prefill: B 4, T 1024, H 64, P 64, N 64): x and y
// are 33.6 MB each, B, C, dt and the final state 6.3 MB: 73.4 MB of HBM
// bytes, 21.9 us at 3.35 TB/s.  The four products are ~6.5 GFLOP, 6.5 us
// at the 989 TFLOP/s of bf16 tensor cores (this kernel issues about twice
// that: each float32 operand is split in two, see below).  So the bound is
// bytes.  The chain adds L2 traffic beyond those bytes: each of the 4,096
// (b, h, chunk) hops reads S_{c-1} and writes S_c, 2 x 16 KB, ~134 MB
// through L2 at the serve shape, next to nothing in device memory.
//
// What held the first kernel (ssd.cu) back, and what this one does:
// 1. Its four products ran as float32 FFMA from shared-memory register
//    tiles.  Here they run as bf16 mma.sync m16n8k16 with float32 sums.
//    x, B and C are bf16 and enter exactly.  The float32 operand of each
//    product (W, dec o B, S_{c-1}) is split as hi = bf16(v), lo = bf16(v -
//    hi) and multiplied twice, which keeps ~16 bits of each operand and
//    float32 sums (the state is held to 1e-4; one bf16 rounding of dec o B
//    is not).  W and dec o B are formed in registers in the A-fragment
//    layout: W from C B^T (whose accumulator layout is that of an A
//    fragment), dec o B from B read by a transposing ldmatrix and scaled.
// 2. Its 16 chunks ran one after another inside one (b, h) block, with
//    scalar loads behind barriers and a serial cumsum.  Here only the
//    state carried from chunk to chunk is sequential (as in wkv.cu): one
//    block per (b, chunk, group of G heads) does all that does not need
//    S_{c-1} -- its loads (16-byte cp.async, B, C and dt in a first group
//    and x in a second, rows past T zero-filled: dt = 0 neither decays nor
//    feeds the state, so a ragged last chunk needs no other care), the
//    cumsum (a warp-shuffle scan a head), C B^T, W x and x^T (dec o B) --
//    before it reads S_{c-1}, writes S_c and forms exp(cum_t) C S_{c-1}^T.
//    Blocks take their (b, group, chunk) from an atomic ticket in
//    chunk-major order, so a block only ever waits on a block that started
//    before it: the chain cannot deadlock whatever order blocks start in.
//    The hand-over of S waits on no flag.  A first version published S_c
//    behind a per-(b, group) flag (barrier, st.release; ld.acquire,
//    barrier, then S_{c-1} read), and its phase marks
//    (tools/ssd_sm90_phases.py) showed the chain to be the kernel's time:
//    a hop of ~6.7 us, three L2 round trips in a row -- the flag, then
//    S_{c-1}, then the stores before the release -- each 1.5-2.5 us on the
//    loaded card, 16 hops a chain.  Here each thread passes its own part
//    of the state straight to its twin in the next chunk's block: the
//    values carry their chunk in their two low bits (see tag_of), each
//    reader lane polls its own values, and the buffer is in fragment
//    order, so each warp access is 512 contiguous bytes.  The wrapper
//    zeroes the state buffer, the ticket and the per-(b, group) counts
//    that keep the tags unambiguous, each call.
//    Where the time goes now: 128 registers a thread hold a head's 64 x 64
//    y and state accumulators, so two blocks fit an SM and ~2 chunk
//    indices of the serve shape are in flight at once; a block lives
//    ~10.7 us, most of it waiting on memory (its loads, the hand-over)
//    rather than computing.  Hiding those waits takes a persistent,
//    software-pipelined kernel (the next tiles loading while this chain
//    waits), which this one is not.
// 3. It recomputed C B^T, and reloaded B and C, for every head, though
//    they depend only on (b, chunk).  Here a block loads B and C once and
//    forms C B^T once for its G heads (the lower triangle in 16-row
//    tiles, shared through shared memory).
//
// Inside a block: 4 warps a head; warp (j, i) owns rows 16 i..16 i + 15 of
// head j's y (t) and of its x^T (dec o B) (n), and a share of C B^T's row
// tile i.  P and N are multiples of 16 up to 64, each (P, N) its own
// instantiation; T, B and H any (a masked tail handles H not divisible by
// G).  G is kGroup, chosen by measurement.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;        // chunk length
constexpr int kMax = 64;      // largest P and N
constexpr int kNT = kMax / 8; // n-tiles of 8 columns at the largest P
constexpr int kLdCB = kL + 8; // row length of C B^T (floats)
// heads a block: 2 measured faster than 1 and 4 at the serve shape
// (tools/ssd_sm90_phases.py --groups builds each)
constexpr int kGroup = 2;

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

// shared memory for (G, P, N): C, B [t][n]; x, then y [t][j P + p];
// C B^T [t][s] float32; S_{c-1}^T as bf16 hi and lo [j][n][p]; dt, cum,
// dec and exp(cum) [j][t] float32.  Rows of bf16 tiles carry 16 bytes of
// padding so that the eight rows an ldmatrix reads fall in distinct banks.
struct Layout {
  int ldC, ldX, ldS;                       // row lengths, bf16 elements
  int offB, offX, offCB, offShi, offSlo, offF, bytes;
};

__host__ __device__ inline Layout layout(int G, int P, int N) {
  Layout l;
  l.ldC = N + 8;
  l.ldX = G * P + 8;
  l.ldS = P + 8;
  int off = kL * l.ldC * 2;
  l.offB = off;
  off += kL * l.ldC * 2;
  l.offX = off;
  off += kL * l.ldX * 2;
  l.offCB = off;
  off += kL * kLdCB * 4;
  l.offShi = off;
  off += G * N * l.ldS * 2;
  l.offSlo = off;
  off += G * N * l.ldS * 2;
  l.offF = off;
  off += 4 * G * kL * 4;
  l.bytes = off;
  return l;
}

// Phase marks for tools/ssd_sm90_phases.py, which builds this source with
// SSD_PHASES defined: thread 0 of each block writes the global timer at
// each MARK into g_marks[ticket][k].  Without SSD_PHASES a MARK is nothing.
#ifdef SSD_PHASES
constexpr int kMarks = 8;
__device__ unsigned long long* g_marks;
#define MARK(k)                                                        \
  if (tid == 0) {                                                      \
    unsigned long long now;                                            \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));            \
    g_marks[static_cast<long long>(ticket) * kMarks + (k)] = now;      \
  }
#else
#define MARK(k)
#endif

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte (or 4-byte) copy, zero-filled when !ok (nothing is read then)
__device__ __forceinline__ void copy16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void copy4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int Pending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// The state passed along the chain carries its chunk in its two lowest
// mantissa bits: chunk c writes tag(c) = c % 3 + 1 and the buffer starts
// zero (tag 0).  A reader of chunk c wants S_{c-1}; the value it finds is
// the newest written so far, and once chunk c-3 has written (its count,
// below) that is S_{c-3}, S_{c-2} or S_{c-1}, three tags apart: so the tag
// alone says when S_{c-1} is there.  32-bit accesses are single-copy
// atomic, so a value is read whole.  The tag moves a value by at most 3
// float32 ulps (3.6e-7 of it) a hop.  Each (b, group) also counts the
// chunks whose state is wholly written (a barrier, then st.release, off
// the chain); a block of chunk c >= 3 checks that count for chunk c-3 at
// its start, while its tiles load (ld.relaxed, then fence.acq_rel), which
// in the stream of blocks has long been true.
__device__ __forceinline__ unsigned tag_of(int c) { return c % 3 + 1; }

__device__ __forceinline__ int load_relaxed_int(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ float tagged(float v, unsigned tag) {
  return __uint_as_float((__float_as_uint(v) & ~3u) | tag);
}

__device__ __forceinline__ bool has_tag(float4 v, unsigned tag) {
  return ((__float_as_uint(v.x) & 3u) == tag) &
         ((__float_as_uint(v.y) & 3u) == tag) &
         ((__float_as_uint(v.z) & 3u) == tag) &
         ((__float_as_uint(v.w) & 3u) == tag);
}

__device__ __forceinline__ float4 load_relaxed4(const float4* p) {
  float4 v;
  asm volatile("ld.relaxed.gpu.global.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed4(float4* p, float4 v) {
  asm volatile("st.relaxed.gpu.global.v4.f32 [%0], {%1,%2,%3,%4};\n" ::"l"(p),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, float32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(bf162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<bf162*>(&v));
}

// (a, b) as bf16 pairs hi = bf16(v) and lo = bf16(v - hi), a in the low half
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  const bf162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// the 4 warps of head j meet here (named barrier 1 + j)
__device__ __forceinline__ void head_barrier(int j) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + j) : "memory");
}

template <int P, int N>
__global__ void __launch_bounds__(128 * kGroup, 4 / kGroup)
ssd_sm90_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const bf16* __restrict__ Bm,
                const bf16* __restrict__ Cm, bf16* __restrict__ y,
                float* state, int* sync, int T_, int H, int nc) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ticket;
  constexpr int G = kGroup, kThreads = 128 * G;
  const Layout lay = layout(G, P, N);
  bf16* Cs = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + lay.offB);
  bf16* Xs = reinterpret_cast<bf16*>(smem + lay.offX);
  float* CBs = reinterpret_cast<float*>(smem + lay.offCB);
  bf16* Shi = reinterpret_cast<bf16*>(smem + lay.offShi);
  bf16* Slo = reinterpret_cast<bf16*>(smem + lay.offSlo);
  float* dts = reinterpret_cast<float*>(smem + lay.offF);  // [G][kL]
  float* cum = dts + G * kL;
  float* dec = cum + G * kL;
  float* ecum = dec + G * kL;
  const int ldC = lay.ldC, ldX = lay.ldX, ldS = lay.ldS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = warp >> 2, i = warp & 3;   // head of the group, row tile
  const int g8 = lane >> 2, q = lane & 3;  // fragment row and column pair
  if (tid == 0) ticket = atomicAdd(sync, 1);
  __syncthreads();
  MARK(0);
  const int chains = gridDim.x / nc;
  const int c = ticket / chains, bg = ticket % chains;  // chunk-major
  const int groups = (H + G - 1) / G;
  const int b = bg / groups, h0 = (bg % groups) * G;
  const int t0 = c * kL, len = min(kL, T_ - t0);
  const long long row0 = static_cast<long long>(b) * T_ + t0;  // (b, t0)
  int* written = sync + 1 + bg;  // chunks of (b, group) wholly written

  // loads: B, C and dt first (C B^T and the cumsum need them), then x
  const int NP = N / 8;
  for (int k = tid; k < kL * NP; k += kThreads) {
    const int t = k / NP, e = (k - t * NP) * 8;
    const bool ok = t < len;
    const long long off = (row0 + (ok ? t : 0)) * N + e;
    copy16(Cs + t * ldC + e, Cm + off, ok);
    copy16(Bs + t * ldC + e, Bm + off, ok);
  }
  for (int k = tid; k < kL * G; k += kThreads) {
    const int t = k / G, jj = k - t * G;
    const bool ok = t < len && h0 + jj < H;
    copy4(dts + jj * kL + t,
          dt + (row0 + (ok ? t : 0)) * H + (ok ? h0 + jj : 0), ok);
  }
  commit_copies();
  const int XP = G * P / 8, PP = P / 8;
  for (int k = tid; k < kL * XP; k += kThreads) {
    const int t = k / XP, e = k - t * XP;
    const bool ok = t < len && h0 + e / PP < H;
    const long long off = ok ? ((row0 + t) * H + h0) * P + e * 8 : 0;
    copy16(Xs + t * ldX + e * 8, x + off, ok);
  }
  commit_copies();
  if (c >= 3 && tid == 0) {
    // chunk c-3 has written its state (see tag_of), checked while the
    // tiles are in flight; the barrier below passes the acquire on
    for (long long n = 0; load_relaxed_int(written) < c - 2; ++n) {
      if (n > (1LL << 26)) __trap();
      __nanosleep(32);
    }
    fence_acq_rel();
  }
  wait_copies<1>();
  __syncthreads();  // B, C and dt have landed
  MARK(1);

  if (i == 0) {
    // cum of head j by a warp-shuffle scan, lane holding t and t + 32
    const float a = h0 + j < H ? A[h0 + j] : 0.f;
    const float d0 = dts[j * kL + lane], d1 = dts[j * kL + lane + 32];
    float v0 = d0 * a, v1 = d1 * a;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u0 = __shfl_up_sync(0xffffffffu, v0, o);
      const float u1 = __shfl_up_sync(0xffffffffu, v1, o);
      if (lane >= o) v0 += u0, v1 += u1;
    }
    v1 += __shfl_sync(0xffffffffu, v0, 31);
    const float cend = __shfl_sync(0xffffffffu, v1, 31);
    cum[j * kL + lane] = v0;
    cum[j * kL + lane + 32] = v1;
    dec[j * kL + lane] = expf(cend - v0) * d0;
    dec[j * kL + lane + 32] = expf(cend - v1) * d1;
    ecum[j * kL + lane] = expf(v0);
    ecum[j * kL + lane + 32] = expf(v1);
  }
  {
    // C B^T, row tile i, columns s < 16 (i + 1): the G warps of row tile i
    // take its 8-column tiles in turn
    const int ntiles = 2 * i + 2;
    for (int nt = j; nt < ntiles; nt += G) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kt = 0; kt < N / 16; ++kt) {
        uint32_t a[4], bb[2];
        ldsm_x4(a, Cs + (16 * i + (lane & 7) + ((lane >> 3) & 1) * 8) * ldC +
                       16 * kt + (lane >> 4) * 8);
        ldsm_x2(bb, Bs + (8 * nt + (lane & 7)) * ldC + 16 * kt +
                        ((lane >> 3) & 1) * 8);
        mma(acc, a, bb[0], bb[1]);
      }
      float* row = CBs + (16 * i + g8) * kLdCB + 8 * nt + 2 * q;
      *reinterpret_cast<float2*>(row) = make_float2(acc[0], acc[1]);
      *reinterpret_cast<float2*>(row + 8 * kLdCB) =
          make_float2(acc[2], acc[3]);
    }
  }
  wait_copies<0>();
  __syncthreads();  // x has landed; C B^T, cum, dec and exp(cum) are set
  MARK(2);

  // y_intra = W x (rows 16 i.. of head j) and dS^T = (dec o B)^T x (rows
  // n = 16 i..), over key tiles of 16 steps; both take x as B operand
  constexpr int nP = P / 8;
  const bool has_s = i < N / 16;
  const float* cumj = cum + j * kL;
  const float* dtj = dts + j * kL;
  const float* decj = dec + j * kL;
  const bf16* xj = Xs + j * P;
  const int tr = 16 * i + g8;  // this thread's rows tr and tr + 8
  float yacc[kNT][4], sacc[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[nt][e] = sacc[nt][e] = 0.f;
  const float ct[2] = {cumj[tr], cumj[tr + 8]};
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    const bool intra = kt <= i;
    if (!intra && !has_s) break;
    uint32_t wh[4], wl[4], dh[4], dl[4];
    if (intra) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = 16 * kt + 8 * half + 2 * q;
        const float cs0 = cumj[s], cs1 = cumj[s + 1];
        const float d0 = dtj[s], d1 = dtj[s + 1];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = tr + 8 * r;
          const float2 cb =
              *reinterpret_cast<const float2*>(CBs + t * kLdCB + s);
          const float w0 = t >= s ? __expf(ct[r] - cs0) * cb.x * d0 : 0.f;
          const float w1 = t > s ? __expf(ct[r] - cs1) * cb.y * d1 : 0.f;
          split(w0, w1, wh[r + 2 * half], wl[r + 2 * half]);
        }
      }
    }
    if (has_s) {
      uint32_t bt[4];
      const int mi = lane >> 3;
      ldsm_x4_t(bt, Bs + (16 * kt + (lane & 7) + (mi >> 1) * 8) * ldC +
                        16 * i + (mi & 1) * 8);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int s = 16 * kt + (r >> 1) * 8 + 2 * q;
        const float2 v = unpack(bt[r]);
        split(v.x * decj[s], v.y * decj[s + 1], dh[r], dl[r]);
      }
    }
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      if (np < nP / 2) {
        uint32_t xb[4];
        ldsm_x4_t(xb, xj + (16 * kt + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               ldX + 16 * np + (lane >> 4) * 8);
        if (intra) {
          mma(yacc[2 * np], wh, xb[0], xb[1]);
          mma(yacc[2 * np], wl, xb[0], xb[1]);
          mma(yacc[2 * np + 1], wh, xb[2], xb[3]);
          mma(yacc[2 * np + 1], wl, xb[2], xb[3]);
        }
        if (has_s) {
          mma(sacc[2 * np], dh, xb[0], xb[1]);
          mma(sacc[2 * np], dl, xb[0], xb[1]);
          mma(sacc[2 * np + 1], dh, xb[2], xb[3]);
          mma(sacc[2 * np + 1], dl, xb[2], xb[3]);
        }
      }
    }
  }

  // the chain, thread by thread: S_c^T = exp(cum_end) S_{c-1}^T + dS^T at
  // this thread's accumulators' (n, p).  Between chunks the state buffer
  // holds S^T tagged and in fragment order -- float4 (nt, lane) of warp
  // slot i is (n, p), (n, p + 1), (n + 8, p), (n + 8, p + 1) with n = 16 i
  // + g8, p = 8 nt + 2 q -- so the thread of chunk c reads what the same
  // thread of chunk c-1 wrote, each warp access 512 contiguous bytes.  The
  // last chunk writes the final state [p][n].  S_{c-1}^T also goes to
  // shared memory as bf16 hi and lo for y_inter.
  const bool head_ok = h0 + j < H, last = c + 1 == nc;
  float* sp = state + (static_cast<long long>(b) * H + h0 + j) * P * N;
  float4* frag = reinterpret_cast<float4*>(sp) + i * nP * 32 + lane;
  if (has_s && head_ok) {
    const float tot = ecum[j * kL + kL - 1];
    const unsigned want = tag_of(c - 1), mine = tag_of(c);
#pragma unroll
    for (int half = 0; half < kNT / 4; ++half) {
      float4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c > 0) {
        // each lane polls its own values of S_{c-1} until all carry the
        // tag; a tag that never comes (a state buffer not zeroed) traps
        // after some seconds rather than hanging the card
        for (long long tries = 0;; ++tries) {
          bool ok = true;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (4 * half + k < nP) {
              v[k] = load_relaxed4(frag + (4 * half + k) * 32);
              ok &= has_tag(v[k], want);
            }
          }
          if (ok) break;
          if (tries > (1LL << 26)) __trap();
          __nanosleep(32);
        }
        if (half == 0) {
          MARK(3);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int nt = 4 * half + k;
        if (nt < nP) {
          float* a = sacc[nt];
          a[0] = fmaf(v[k].x, tot, a[0]);
          a[1] = fmaf(v[k].y, tot, a[1]);
          a[2] = fmaf(v[k].z, tot, a[2]);
          a[3] = fmaf(v[k].w, tot, a[3]);
          if (c > 0) {
            const int at = (j * N + 16 * i + g8) * ldS + 8 * nt + 2 * q;
            uint32_t hi, lo;
            split(v[k].x, v[k].y, hi, lo);
            *reinterpret_cast<uint32_t*>(Shi + at) = hi;
            *reinterpret_cast<uint32_t*>(Slo + at) = lo;
            split(v[k].z, v[k].w, hi, lo);
            *reinterpret_cast<uint32_t*>(Shi + at + 8 * ldS) = hi;
            *reinterpret_cast<uint32_t*>(Slo + at + 8 * ldS) = lo;
          }
          if (!last) {
            store_relaxed4(frag + nt * 32,
                           make_float4(tagged(a[0], mine), tagged(a[1], mine),
                                       tagged(a[2], mine), tagged(a[3], mine)));
          }
        }
      }
    }
  }
  if (last) {
    __syncthreads();  // every read of the chain buffer is done
    if (has_s && head_ok) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        if (nt < nP) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int n = 16 * i + g8 + 8 * r, p = 8 * nt + 2 * q;
            sp[p * N + n] = sacc[nt][2 * r];
            sp[(p + 1) * N + n] = sacc[nt][2 * r + 1];
          }
        }
      }
    }
  }
  MARK(4);
  head_barrier(j);  // head j's S_{c-1}^T is staged, its x no longer read
  MARK(5);

  // y_inter = exp(cum_t) C S_{c-1}^T, off the chain: C (A operand) against
  // the staged S_{c-1}^T, hi and lo
  if (c > 0) {
    float iacc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) iacc[nt][e] = 0.f;
    for (int kt = 0; kt < N / 16; ++kt) {
      uint32_t a[4];
      ldsm_x4(a, Cs + (16 * i + (lane & 7) + ((lane >> 3) & 1) * 8) * ldC +
                     16 * kt + (lane >> 4) * 8);
      const int srow = j * N + 16 * kt + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        if (np < nP / 2) {
          uint32_t bh[4], bl[4];
          const int at = srow * ldS + 16 * np + (lane >> 4) * 8;
          ldsm_x4_t(bh, Shi + at);
          ldsm_x4_t(bl, Slo + at);
          mma(iacc[2 * np], a, bh[0], bh[1]);
          mma(iacc[2 * np], a, bl[0], bl[1]);
          mma(iacc[2 * np + 1], a, bh[2], bh[3]);
          mma(iacc[2 * np + 1], a, bl[2], bl[3]);
        }
      }
    }
    const float e0 = ecum[j * kL + tr], e1 = ecum[j * kL + tr + 8];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      yacc[nt][0] = fmaf(e0, iacc[nt][0], yacc[nt][0]);
      yacc[nt][1] = fmaf(e0, iacc[nt][1], yacc[nt][1]);
      yacc[nt][2] = fmaf(e1, iacc[nt][2], yacc[nt][2]);
      yacc[nt][3] = fmaf(e1, iacc[nt][3], yacc[nt][3]);
    }
  }
  MARK(6);

  // y as bf16 into x's tile, then out by 16-byte stores, rows t < len
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    if (nt < nP) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<bf162*>(Xs + (tr + 8 * r) * ldX + j * P + 8 * nt +
                                  2 * q) =
            __floats2bfloat162_rn(yacc[nt][2 * r], yacc[nt][2 * r + 1]);
      }
    }
  }
  __syncthreads();  // y is staged and every thread's S_c written
  if (!last && tid == 0) store_release(written, c + 1);
  for (int k = tid; k < len * XP; k += kThreads) {
    const int t = k / XP, e = k - t * XP;
    if (h0 + e / PP < H) {
      *reinterpret_cast<uint4*>(y + ((row0 + t) * H + h0) * P + e * 8) =
          *reinterpret_cast<const uint4*>(Xs + t * ldX + e * 8);
    }
  }
  MARK(7);
}

template <int P, int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* state, void* sync, int B, int T_,
           int H, cudaStream_t stream) {
  const int bytes = layout(kGroup, P, N).bytes;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_sm90_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int nc = (T_ + kL - 1) / kL;
  const long long blocks =
      static_cast<long long>(B) * ((H + kGroup - 1) / kGroup) * nc;
  if (blocks > 0x7fffffffLL) return -1;
  ssd_sm90_kernel<P, N><<<static_cast<unsigned>(blocks), 128 * kGroup,
                          bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<bf16*>(y),
      static_cast<float*>(state), static_cast<int*>(sync), T_, H, nc);
  return static_cast<int>(cudaGetLastError());
}

// P and N are compile-time in the kernel (its loops and fragments unroll
// to them), so each (P, N) the kernel takes is an instantiation
#define SSD_ARGS x, dt, A, Bm, Cm, y, state, sync, B, T_, H, stream
#define SSD_PARAMS                                                       \
  const void *x, const void *dt, const void *A, const void *Bm,          \
      const void *Cm, void *y, void *state, void *sync, int B, int T_,   \
      int H, cudaStream_t stream

template <int P>
int launch_n(int N, SSD_PARAMS) {
  switch (N) {
    case 16: return launch<P, 16>(SSD_ARGS);
    case 32: return launch<P, 32>(SSD_ARGS);
    case 48: return launch<P, 48>(SSD_ARGS);
    case 64: return launch<P, 64>(SSD_ARGS);
    default: return -1;
  }
}

int launch_pn(int P, int N, SSD_PARAMS) {
  switch (P) {
    case 16: return launch_n<16>(N, SSD_ARGS);
    case 32: return launch_n<32>(N, SSD_ARGS);
    case 48: return launch_n<48>(N, SSD_ARGS);
    case 64: return launch_n<64>(N, SSD_ARGS);
    default: return -1;
  }
}

#undef SSD_ARGS
#undef SSD_PARAMS

}  // namespace

#ifdef SSD_PHASES
// where the phase marks go: kMarks unsigned 64-bit values a block
extern "C" int ssd_sm90_set_marks(void* marks) {
  return static_cast<int>(
      cudaMemcpyToSymbol(g_marks, &marks, sizeof(marks)));
}
#endif

// x, y: (B, T, H, P) bf16; dt: (B, T, H) float32; A: (H,) float32; B, C:
// (B, T, N) bf16; state: (B, H, P, N) float32, zero (the chain passes the
// state through it); sync: 1 + B H int32, zero (the ticket, then a count
// of written chunks for each (b, group of heads), of which there are at
// most B H).  Every array contiguous; x, y, B and C 16-byte aligned; P
// and N multiples of 16 up to 64.  Launches on `stream` and returns
// cudaGetLastError() (0 on success; -1 for a size the kernel does not
// take, which the wrapper rules out first).
extern "C" int ssd_sm90_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* state, void* sync, int B, int T_, int H,
                               int P, int N, int device, void* stream) {
  if (B < 1 || T_ < 1 || H < 1) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_pn(P, N, x, dt, A, Bm, Cm, y, state, sync, B, T_, H,
                   static_cast<cudaStream_t>(stream));
}
