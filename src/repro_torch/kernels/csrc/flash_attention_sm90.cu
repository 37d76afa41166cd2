// Forward flash attention for Hopper (sm_90a), bfloat16: wgmma fed by TMA.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (body
// _flash_kernel) for bf16 inputs at every width JAX's configs use: hd 8,
// 16, 64, 80, 128 and 256.  float32 inputs go to flash_attention_f32_sm90.cu
// (3xTF32); flash_attention.cu, the SIMT kernel these replaced, is on no
// route.
// Computes, for q (B, S, H, hd) and k, v (B, S, KV, hd) with H % KV == 0,
// query head h reading KV head h / (H / KV):
//   o[b, i, h] = sum_j softmax_j(mask(q_i . k_j * hd^-1/2)) v_j
// with the TPU kernel's online softmax: scores in float32, masked scores
// set to -1e30, a running max m and sum l and a float32 accumulator over
// KV tiles, o = acc / max(l, 1e-30) in bf16.  The causal mask keeps
// j <= i, the sliding window j > i - window - 1.  Two departures, both
// within a bf16 ulp of the output:
//   * the softmax runs in base 2: scores are prescaled by hd^-1/2 * log2(e)
//     and exponentiated with ex2.approx (2^-22 relative), so m is kept in
//     log2 units;
//   * P is rounded to bf16 before O += P V (the TPU kernel multiplies P in
//     float32, flash_attention.py:55-58), so that the product runs on the
//     tensor cores with P straight from registers.  l sums the unrounded P.
//
// Bound (zamba2-1.2b's prefill: B 4, S 1024, H 32, hd 64, causal): q, k, v
// and o are 67 MB, 20 us at 3.35 TB/s; the causal products are 17.2 GFLOP,
// 17 us at the 989 TFLOP/s of bf16 tensor cores.  At gemma3-4b's prefill
// (B 4, S 2048, H 8 over KV 4, hd 256) the causal products are 68.8 GFLOP,
// 70 us, and the 101 MB of q, k, v and o 30 us: operations bound it, and
// a K / V tile is read from L2 by every item of its KV head (~0.56 GB in
// all).  Either way the design keeps the tensor cores fed and every tile
// read once a work item:
//   * a work item is one (b, h) and 128 query rows; the kernel is
//     persistent, one block an SM, each block walking the items numbered
//     heaviest first (the last query tile of every (b, h), which sees the
//     most keys, comes first) with the grid as stride, so the causal tail
//     is short and no block pays a launch and a cold start per item;
//   * a block has two consumer warpgroups of 64 rows each and one producer
//     warpgroup, of which one thread issues every copy and runs ahead into
//     the next item while the consumers finish one; setmaxnreg moves
//     registers from the producer (24) to the consumers (240);
//   * Q is loaded once an item by TMA, into a buffer the consumers release
//     after the item's last S; K and V tiles stream through a ring in
//     shared memory, each stage with a full barrier for K and one for V
//     (TMA completes their byte counts) and an empty barrier for each, on
//     which every consumer warp arrives: for K once its S has landed, for
//     V once its P V has, so the producer refills a K slot a step early;
//   * the ring by head width: 128 keys a tile in three stages at hd 8,
//     16, 64, 80 and 128 (Q 16-32 KB, ring <= 192 KB); at hd 256 Q alone
//     is 64 KB, so 64 keys a tile in two stages (ring 128 KB, 193 KB in
//     all);
//   * every tile lands in the 128-byte swizzle, rows of 64 bf16, a wider
//     hd as two or four such column chunks, which is the layout wgmma
//     reads; hd 80 takes two chunks, TMA zero-filling columns 80-127 past
//     the tensor's edge (its rows are 160 bytes, which no 128-byte chunk
//     divides); hd 8 and 16 take one chunk, TMA zero-filling columns 8-63
//     or 16-63 (their rows are 16 or 32 bytes, a stride TMA takes);
//   * S = Q K^T is wgmma m64n128k16 (m64n64k16 at hd 256) with both
//     operands in shared memory (K-major), over the ceil(hd / 16) column
//     steps that hold data (5 at hd 80, one at hd 8 and 16: at hd 8 its
//     upper 8 columns are TMA's zeros), accumulating in float32 registers; at
//     hd 256 O is 128 float32 registers a thread, S 32 and P 16, under the
//     consumers' 240; the online softmax
//     runs on that fragment (two rows a thread, row max and sum across the
//     four threads of a row by shuffles);
//   * O += P V is wgmma m64n64k16, one per column chunk and 16 keys, with
//     P, rounded to bf16, as the register A operand (the accumulator
//     fragment is the A fragment's layout) and V read from shared memory
//     as an MN-major B operand; at hd 80 the second chunk's product runs
//     on 16 real columns and 48 zero ones, at hd 8 and 16 the one chunk's
//     on 8 or 16 real columns, and only the hd real columns are rescaled
//     and stored.  At hd 8 and 16 the padded P V does 8 or 4 times the
//     real products, which the tensor cores have to spare: there the
//     bound is the softmax's exponentials (16 a clock an SM on the
//     special-function unit; B 2, S 1,000, H 8, causal: 8.0 M of them,
//     ~1.9 us, beside ~0.5 us of products and bytes);
//   * the two consumer warpgroups take turns issuing their products (named
//     barriers), so one warpgroup's softmax overlaps the other's products;
//   * within a warpgroup the two products overlap the softmax: the next
//     tile's S is issued before this tile's P V, and its softmax runs while
//     P V is on the tensor cores (wgmma.wait_group 1; an empty asm on the
//     softmax's registers keeps ptxas from sinking it below the wait for
//     P V); only the rescale of O and the packing of P wait for P V;
//   * masks are applied only on tiles the causal diagonal, the window edge
//     or the end of S cuts; the KV loop stops at the block's causal
//     frontier and starts at the first tile the window reaches (a tile
//     masked for every row only adds terms that the first unmasked score
//     multiplies by exp2(-1e30 - m) = 0).
// With a non-null lse the kernel also writes each row's log-sum-exp, (m +
// log2 l) ln 2, for the backward kernels; the output is the same either way.
// Descriptors are 4-D over (hd, heads, S, B), encoded per call on the host
// with cuTensorMapEncodeTiled (taken through cudaGetDriverEntryPoint, so
// the library needs no -lcuda) and passed as __grid_constant__ params: a
// ragged S is zero-filled and never reads the next batch.  Keys past S are
// masked, rows past S are not stored.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;          // query rows per work item
constexpr int kConsumers = 2;     // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kRowBytes = 128;    // a swizzled tile row: 64 bf16
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The tiles of a head width hd are TW columns wide: hd rounded up to whole
// 64-column chunks (TMA zero-fills the columns past hd).  K / V tiles hold
// kBN keys in a ring of kStages; at TW 256 the ring is shallower so that
// Q (64 KB) and the ring (2 x 64 KB) fit in a block's 227 KB.  Byte
// offsets in the block's shared memory (1024-byte aligned): chunk c
// (columns 64c..64c+63) of a tile of R rows sits at c * R * 128.
template <int TW>
struct Config {
  static constexpr int kChunks = TW / 64;
  static constexpr int kBN = TW == 256 ? 64 : 128;
  static constexpr int kStages = TW == 256 ? 2 : 3;
  static constexpr int kQBytes = kBM * TW * 2;
  static constexpr int kTileBytes = kBN * TW * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;                  // + s * kTileBytes
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBytes = kV + kStages * kTileBytes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of the 4-D map (hd, heads, S, B) into shared memory at dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a tile in the 128-byte swizzle: start
// address, leading offset 16 B (unused by these shapes), stride 1024 B
// between groups of eight 128-byte rows, layout B128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma registers across
// the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A consumer thread's first row in its warpgroup's 64 (the fragment's row
// r_lo; r_lo + 8 is its other) and its first column in an 8-wide chunk,
// computed where they are used (the masks of cut tiles, the store) rather
// than held across the KV loop: at hd 256 the consumers' 240 registers
// are full, and holding them spilled.
struct Lane {
  int row, col;
};
__device__ __forceinline__ Lane lane_coords() {
  const int t = threadIdx.x % 128;
  return {(t / 32) * 16 + (t % 32) / 4, (t % 4) * 2};
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (relative error ~2^-22, subnormal
// results flushed to 0): well inside the bf16 output's rounding.
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

// One online-softmax step on an S fragment of kBN keys (two rows a thread:
// row r_lo holds values 0, 1 of each 8-key chunk, row r_lo + 8 values 2,
// 3), in place: scores to log2 units, masked to -1e30 when the tile is cut
// by a mask (`edge`; row r keeps keys in [r - window, r] when causal, in
// [0, S) otherwise; the thread's rows and the bounds are computed here, on
// cut tiles only, so that they hold no registers across the KV loop), the
// new row max across the row's four threads, then p = 2^(s - m).  Updates
// m and the thread's share of l; returns in `al` the factor by which the
// row's accumulator must shrink.
template <int kBN>
__device__ __forceinline__ void softmax_step(
    float* sc, bool edge, int kt, int row0, int S, int causal, int window,
    float scale_log2, float (&m)[2], float (&l)[2], float (&al)[2]) {
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) sc[i] *= scale_log2;
  if (edge) {
    const Lane ln = lane_coords();
    int lo[2], hi[2];  // keys row r_lo + 8 k2 keeps: [lo[k2], hi[k2]]
#pragma unroll
    for (int k2 = 0; k2 < 2; ++k2) {
      const int row = row0 + ln.row + 8 * k2;
      lo[k2] = window > 0 ? row - window : 0;
      hi[k2] = causal ? min(row, S - 1) : S - 1;
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + 8 * j + ln.col + (e & 1);
        if (key < lo[e / 2] || key > hi[e / 2]) sc[4 * j + e] = kNegInf;
      }
    }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i)
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int d = 1; d < 4; d *= 2)
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], d));
    const float mn = fmaxf(m[i], mx[i]);
    al[i] = ex2(m[i] - mn);
    m[i] = mn;
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    sc[i] = ex2(sc[i] - m[(i / 2) % 2]);
    ps[(i / 2) % 2] += sc[i];
  }
  l[0] = l[0] * al[0] + ps[0];
  l[1] = l[1] * al[1] + ps[1];
}

// d[64] += A (64 x 16, shared) * B (16 x 128, shared)^T; both K-major.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[32] += A (64 x 16, shared) * B (16 x 64, shared)^T; both K-major.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// S += Q K^T over 16 hd columns for a K tile of kBN keys.
template <int kBN>
__device__ __forceinline__ void wgmma_s(float* d, uint64_t desc_a,
                                        uint64_t desc_b, int scale_d) {
  if constexpr (kBN == 128)
    wgmma_m64n128k16_ss(d, desc_a, desc_b, scale_d);
  else
    wgmma_m64n64k16_ss(d, desc_a, desc_b, scale_d);
}

// d[32] += A (64 x 16, registers: P in bf16) * B (16 x 64, shared), B
// MN-major (the V tile as TMA stores it: keys by rows, hd contiguous).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// One work item: a (b, h) and a tile of kBM query rows.  Items are
// numbered heaviest first: the last query tile, which sees the most keys,
// of every (b, h) before the tile below it.
struct Item {
  int b, h, q0, k_begin, n_tiles;
};

template <int kBN>
__device__ __forceinline__ Item item_at(int w, int S, int H, int B,
                                        int n_qtiles, int causal,
                                        int window) {
  Item it;
  const int level = w / (H * B), rem = w % (H * B);
  it.h = rem % H;
  it.b = rem / H;
  it.q0 = (n_qtiles - 1 - level) * kBM;
  const int k_end = causal ? min(S, it.q0 + kBM) : S;
  it.k_begin = window > 0 ? (max(0, it.q0 - window) / kBN) * kBN : 0;
  it.n_tiles = (k_end - it.k_begin + kBN - 1) / kBN;
  return it;
}

// HD: the head width (a multiple of 8); TW: the tiles' width (HD rounded up
// to 64 columns).
template <int HD, int TW>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  int B, int S, int H, int KV, int causal, int window,
                  float scale_log2, int n_qtiles) {
  using C = Config<TW>;
  constexpr int kBN = C::kBN, kStages = C::kStages;
  static_assert(HD % 8 == 0 && HD <= TW && TW - HD < 64, "tile width");
  extern __shared__ uint8_t smem_raw[];
  // Q full, Q empty; per stage: K full, V full, K empty, V empty
  __shared__ __align__(8) uint64_t bars[2 + 4 * kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_q = smem_u32(bars), bar_q_empty = bar_q + 8;
  const uint32_t bar_k = bar_q + 16, bar_v = bar_k + 8 * kStages;
  const uint32_t bar_k_empty = bar_v + 8 * kStages;
  const uint32_t bar_v_empty = bar_k_empty + 8 * kStages;
  const int n_items = n_qtiles * H * B;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q_empty, kConsumers * 4);       // every consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_k_empty + 8 * s, kConsumers * 4);
      mbar_init(bar_v_empty + 8 * s, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread keeps the TMA loads in flight, running
    // ahead into the block's next item while the consumers finish one ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers * 128) {
      int ring = 0;  // K/V tiles loaded so far, across items
      int i = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++i) {
        const Item it = item_at<kBN>(w, S, H, B, n_qtiles, causal, window);
        const int kvh = it.h / (H / KV);
        mbar_wait(bar_q_empty, (i & 1) ^ 1);
        mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          tma_load(base + C::kQ + c * kBM * kRowBytes, &tq, bar_q, 64 * c,
                   it.h, it.q0, it.b);
        for (int n = 0; n < it.n_tiles; ++n, ++ring) {
          const int s = ring % kStages;
          const uint32_t parity = ((ring / kStages) & 1) ^ 1;
          const int kt = it.k_begin + n * kBN;
          const uint32_t tile = s * C::kTileBytes;
          mbar_wait(bar_k_empty + 8 * s, parity);
          mbar_expect_tx(bar_k + 8 * s, C::kTileBytes);
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c)
            tma_load(base + C::kK + tile + c * kBN * kRowBytes, &tk,
                     bar_k + 8 * s, 64 * c, kvh, kt, it.b);
          mbar_wait(bar_v_empty + 8 * s, parity);
          mbar_expect_tx(bar_v + 8 * s, C::kTileBytes);
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c)
            tma_load(base + C::kV + tile + c * kBN * kRowBytes, &tv,
                     bar_v + 8 * s, 64 * c, kvh, kt, it.b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup ----
    // Software pipeline: while O += P_n V_n runs on the tensor cores, the
    // next tile's S = Q K_{n+1}^T is already issued ahead of it and its
    // softmax runs as soon as it lands; only the accumulator's rescale
    // and P's conversion wait for P_n V_n to finish.  K_n is released as
    // soon as S_n has landed, V_n once P_n V_n has, so that the producer
    // refills a K slot a step before the V slot beside it.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const bool lead = tid % 32 == 0;            // the warp's lane 0
    const uint32_t q_base = base + C::kQ + wg * 64 * kRowBytes;

    float acc[TW / 2];  // O: TW/8 chunks of 8 columns, 4 values a thread
    float sc[kBN / 2];  // S, then P: kBN/8 chunks
    uint32_t pa[kBN / 4];  // P in bf16: A fragments, 4 per 16 keys
    float m[2], l[2], al[2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;

    // The two warpgroups take turns on the tensor cores: a warpgroup
    // issues its products between bar.sync on its own named barrier and
    // bar.arrive on the other's, so one's softmax runs while the other's
    // products do.  Warpgroup 1 hands warpgroup 0 the first turn, and
    // warpgroup 0 takes the last hand-back after its last item.
    auto turn_begin = [&]() {
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
    };
    auto turn_end = [&]() {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
    };
    if (wg == 1) turn_end();

    int ring = 0;  // K/V tiles consumed so far, across items
    int i = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++i) {
      const Item it = item_at<kBN>(w, S, H, B, n_qtiles, causal, window);
      const int row0 = it.q0 + wg * 64;         // the warpgroup's first row
#pragma unroll
      for (int j = 0; j < TW / 2; ++j) acc[j] = 0.f;
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;

      // S = Q K_n^T into sc (issued, committed, not waited for), over the
      // ceil(HD / 16) column steps that hold data
      auto issue_s = [&](int n) {
        const int s = (ring + n) % kStages;
        mbar_wait(bar_k + 8 * s, ((ring + n) / kStages) & 1);
        fence_regs<kBN / 2>(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < (HD + 15) / 16; ++kk) {
          const int c = kk / 4, w4 = (kk % 4) * 32;  // chunk, bytes in a row
          wgmma_s<kBN>(
              sc, sw128_desc(q_base + c * kBM * kRowBytes + w4),
              sw128_desc(base + C::kK + s * C::kTileBytes +
                         c * kBN * kRowBytes + w4),
              kk > 0);
        }
        wgmma_commit();
      };
      // O += P_n V_n (issued, committed, not waited for)
      auto issue_pv = [&](int n) {
        const int s = (ring + n) % kStages;
        mbar_wait(bar_v + 8 * s, ((ring + n) / kStages) & 1);
        fence_regs<TW / 2>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c)
            wgmma_m64n64k16_rs(
                acc + 32 * c, pa + 4 * kk,
                sw128_desc(base + C::kV + s * C::kTileBytes +
                           c * kBN * kRowBytes + kk * 16 * kRowBytes));
        }
        wgmma_commit();
      };
      // K_n (after S_n) or V_n (after P_n V_n) read by this warp
      auto release_k = [&](int n) {
        if (lead) mbar_arrive(bar_k_empty + 8 * ((ring + n) % kStages));
      };
      auto release_v = [&](int n) {
        if (lead) mbar_arrive(bar_v_empty + 8 * ((ring + n) % kStages));
      };
      // one softmax step on tile n; a tile is masked only where the causal
      // diagonal, the window edge or the end of S cuts it
      auto softmax = [&](int n) {
        const int kt = it.k_begin + n * kBN;
        const bool edge = kt + kBN > S || (causal && kt + kBN - 1 > row0) ||
                          (window > 0 && kt < row0 + 63 - window);
        softmax_step<kBN>(sc, edge, kt, row0, S, causal, window, scale_log2,
                          m, l, al);
        // the softmax must be done before wait_group 0 below, or ptxas
        // moves it after the wait and P V no longer hides it
        fence_regs<kBN / 2>(sc);
      };
      // the accumulator rescaled (its HD real columns: the rest stay 0)
      // and P packed for O += P V
      auto rescale_and_pack = [&]() {
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          acc[4 * j] *= al[0];
          acc[4 * j + 1] *= al[0];
          acc[4 * j + 2] *= al[1];
          acc[4 * j + 3] *= al[1];
        }
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          pa[2 * j] = pack_bf16(sc[4 * j], sc[4 * j + 1]);          // r_lo
          pa[2 * j + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);  // r_hi
        }
      };

      mbar_wait(bar_q, i & 1);
      turn_begin();
      issue_s(0);
      turn_end();
      wgmma_wait<0>();
      fence_regs<kBN / 2>(sc);
      release_k(0);
      softmax(0);
      rescale_and_pack();
      // steady state, written without branches on the wgmma groups so
      // that ptxas can follow them: the next tile's S, this tile's P V,
      // the next softmax as soon as S lands (wait_group 1), then P V done
      for (int n = 0; n + 1 < it.n_tiles; ++n) {
        turn_begin();
        issue_s(n + 1);
        issue_pv(n);
        turn_end();
        wgmma_wait<1>();
        fence_regs<kBN / 2>(sc);
        release_k(n + 1);
        softmax(n + 1);
        wgmma_wait<0>();
        fence_regs<TW / 2>(acc);
        release_v(n);
        rescale_and_pack();
      }
      // every S of the item is done: Q may be replaced by the next item's
      if (lead) mbar_arrive(bar_q_empty);
      turn_begin();
      issue_pv(it.n_tiles - 1);
      turn_end();
      wgmma_wait<0>();
      fence_regs<TW / 2>(acc);
      release_v(it.n_tiles - 1);
      ring += it.n_tiles;

      float l_lo = l[0], l_hi = l[1];
#pragma unroll
      for (int d = 1; d < 4; d *= 2) {
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, d);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, d);
      }
      const float den_lo = fmaxf(l_lo, 1e-30f);
      const float den_hi = fmaxf(l_hi, 1e-30f);
      const Lane ln = lane_coords();
      const int r_lo = row0 + ln.row, r_hi = r_lo + 8;
      const long long stride = static_cast<long long>(H) * HD;
      __nv_bfloat16* o_lo = o + (static_cast<long long>(it.b) * S + r_lo) *
                                    stride +
                            static_cast<long long>(it.h) * HD + ln.col;
      __nv_bfloat16* o_hi = o_lo + 8 * stride;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        if (r_lo < S)
          *reinterpret_cast<__nv_bfloat162*>(o_lo + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j] / den_lo,
                                    acc[4 * j + 1] / den_lo);
        if (r_hi < S)
          *reinterpret_cast<__nv_bfloat162*>(o_hi + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2] / den_hi,
                                    acc[4 * j + 3] / den_hi);
      }
      // the rows' log-sum-exp in natural-log units, m + log2(l) (log2
      // units) converted once: one thread of the row's four writes it
      if (lse != nullptr && ln.col == 0) {
        float* lr = lse + (static_cast<long long>(it.b) * H + it.h) * S;
        if (r_lo < S) lr[r_lo] = (m[0] + lg2(den_lo)) * kLn2;
        if (r_hi < S) lr[r_hi] = (m[1] + lg2(den_hi)) * kLn2;
      }
    }
    if (wg == 0) turn_begin();  // the hand-back after the last turn
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A 4-D map over a (B, S, heads, hd) bf16 tensor, innermost first, with
// boxes of 64 columns x 1 head x `rows` positions x 1 batch, 128-byte
// swizzle, zero fill past the edges.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B,
              int S, int heads, int hd, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(hd) * 2,
      static_cast<cuuint64_t>(heads) * hd * 2,
      static_cast<cuuint64_t>(S) * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int TW>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int H, int KV, int causal, int window,
           cudaStream_t stream) {
  using C = Config<TW>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -2;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, q, B, S, H, HD, kBM) ||
      !make_map(encode, &tk, k, B, S, KV, HD, C::kBN) ||
      !make_map(encode, &tv, v, B, S, KV, HD, C::kBN))
    return -3;
  const int smem = C::kBytes + 1024;  // + the 1024-byte alignment
  cudaError_t err = cudaFuncSetAttribute(
      flash_sm90_kernel<HD, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (S + kBM - 1) / kBM;
  const int blocks = min(n_qtiles * H * B, sms);  // one resident block an SM
  flash_sm90_kernel<HD, TW><<<blocks, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, B, S, H, KV, causal,
      window,
      kLog2e / sqrtf(static_cast<float>(HD)), n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (B, S, H, hd); k, v: (B, S, KV, hd); contiguous, 16-byte aligned,
// bfloat16; hd 8, 16, 64, 80, 128 or 256.  lse: null, or (B, H, S) float32
// that receives each row's log-sum-exp (the backward's residual).  Launches
// on `stream` and returns cudaGetLastError() (0 on success); -1 for an
// unsupported hd, -2 when the driver has no cuTensorMapEncodeTiled, -3 when
// a map cannot be encoded.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int B, int S, int H, int KV, int hd,
                                           int causal, int window, int device,
                                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  // the head width, then the tiles' width: hd 8 and 16 run in 64-column
  // tiles, hd 80 in 128-column ones
  switch (hd) {
    case 8:
      return launch<8, 64>(q, k, v, o, l, B, S, H, KV, causal, window, st);
    case 16:
      return launch<16, 64>(q, k, v, o, l, B, S, H, KV, causal, window, st);
    case 64:
      return launch<64, 64>(q, k, v, o, l, B, S, H, KV, causal, window, st);
    case 80:
      return launch<80, 128>(q, k, v, o, l, B, S, H, KV, causal, window, st);
    case 128:
      return launch<128, 128>(q, k, v, o, l, B, S, H, KV, causal, window, st);
    case 256:
      return launch<256, 256>(q, k, v, o, l, B, S, H, KV, causal, window, st);
    default:
      return -1;
  }
}
