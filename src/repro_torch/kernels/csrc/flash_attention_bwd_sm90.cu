// Backward flash attention for Hopper (sm_90a), bfloat16: wgmma fed by TMA.
//
// Replaces no Pallas kernel: it is the card's counterpart of JAX's
// custom-VJP backward of flash_mha, repro/models/attention.py::_flash_bwd
// (plain jnp under XLA on the TPU), for bf16 inputs at every width JAX's
// configs use (hd 8, 16, 64, 80, 128, 256).  float32 inputs go to
// flash_attention_bwd_f32_sm90.cu (3xTF32); flash_attention_bwd.cu, the SIMT
// kernel these replaced, is on no route.  For q, o, do (B, S, H, hd) and k,
// v (B, S, KV, hd), query head h reading KV head h / (H / KV), and the
// forward's log-sum-exp lse (B, H, S) (JAX keeps m and l as residuals,
// attention.py:176-178; lse = m + log(max(l, 1e-30))), it computes
// _flash_bwd's formulas:
//   s = q_i . k_j * hd^-1/2 (masked pairs give p = 0: causal keeps j <= i,
//   the window j > i - window - 1), p = exp(s - lse_i), D_i = sum_d do_i o_i,
//   dv_j = sum_i p do_i, dp = do_i . v_j, ds = p (dp - D_i),
//   dq_i = sum_j ds k_j * hd^-1/2, dk_j = sum_i ds q_i * hd^-1/2,
// dk and dv summed over the H / KV query heads of a KV head (the gradient
// of JAX's _repeat_kv).  Sums are float32; p and ds are rounded to bf16
// where they enter a product (dv, dk, dq), as the bf16 forward rounds P
// before P V (flash_attention_sm90.cu).
//
// Bound (smollm-135m's train shape: B 8, S 1,024, H 9 over KV 3, hd 64,
// causal): five products over the kept pairs (s, dp, dv, dq, dk) are ~24
// GFLOP, ~24 us at the 989 TFLOP/s of the bf16 tensor cores; q, k, v, o,
// do in and dq, dk, dv out are ~51 MB, ~15 us at 3.35 TB/s.  So operations
// bound it.  The design spends 7 products (s and dp are formed again for
// dq, the price of no atomics) on the tensor cores, every operand brought
// by TMA:
//   (a) prep, a thread a (b, i, h) row read in 16-byte words: D =
//       rowsum(do o) in float32, and lse copied into log2 units, both into
//       (B H, Sp) float32 scratch rows padded to Sp = S rounded up to 64
//       (zeros past S), so that a tile's rows are one aligned bulk copy;
//   (b) dk / dv, a work item a (b, KV head, 128 keys): persistent, one
//       block an SM, items numbered heaviest first (key tile 0, which every
//       query of a causal head sees, first) and dealt to the blocks in a
//       snake (snake_item); two consumer warpgroups of 64
//       keys and one producer warpgroup (setmaxnreg 24 / 240) whose one
//       thread loads the item's K and V once and streams Q, dO, lse and D
//       tiles of 64 queries (32 from hd 80 up) of every query head of the
//       group through a ring of 3 stages (full / empty mbarriers), from the
//       causal diagonal
//       (or 0) to the window's end (or S); a consumer forms S^T = K Q^T and
//       dP^T = V dO^T (wgmma, both operands K-major in shared memory), then
//       P^T = 2^(S^T scale log2(e) - lse log2(e)) and dS^T = P^T (dP^T - D)
//       in registers, then dV += P^T dO and dK += dS^T Q as one group
//       (wgmma with P^T, dS^T in bf16 as the register A operand, the
//       accumulator fragment being the A fragment's layout, and dO, Q as
//       MN-major B operands, the layout the forward reads V in).  From hd
//       80 up dK and dV hold 128 registers, and S^T and dP^T of 64 queries
//       beside them spilled, hence the 32-query tiles there.  The group's
//       heads are summed in the
//       block, so no two blocks write one dk or dv row.  At hd 256 dK and dV
//       of 64 keys are 128 float32 registers a thread each, over the
//       consumers' 240: there an item is 64 keys and the two warpgroups
//       split the work, one forming S^T and dV, the other S^T, dP^T and dK
//       (S^T formed twice), with 32-query tiles;
//   (c) dq, a work item a (b, h, 128 query rows), the forward's structure:
//       Q and dO loaded once an item, K and V tiles of 64 keys (32 at hd
//       256) streamed through the ring from the window's start to the causal
//       frontier; S = Q K^T and dP = dO V^T (smem x smem), P and dS in
//       registers, dQ += dS K (dS the register A operand, K MN-major).
// Every tile lands in the 128-byte swizzle, rows of 64 bf16, a wider hd as
// two or four column chunks; hd 80 takes two chunks and hd 8 / 16 one, TMA
// zero-filling the columns past hd (the products over hd run on the
// ceil(hd / 16) column steps that hold data).  Masks are applied only on
// tiles the causal diagonal, the window edge or the end of S cuts, and a
// warpgroup skips a tile none of whose pairs it keeps.  Rows and keys past
// S are zero-filled by TMA (and masked), and not stored, so any S works.
// Every sum runs in a fixed order: two launches give the same bits.
// TMA descriptors are 4-D over (hd, heads, S, B), encoded per call on the
// host with cuTensorMapEncodeTiled (through cudaGetDriverEntryPoint, no
// -lcuda), passed as __grid_constant__ params.  ptxas: 0 spills at every
// width (168 registers reported, the launch bound; the consumers raise
// theirs to 240 with setmaxnreg).
//
// Where the time goes (H100 SXM, smollm's shape, device time from CUDA
// graphs and the profiler): 0.176 ms a call, dk / dv 0.093, dq 0.069, prep
// 0.012, against SDPA's backward 0.136 ms of device time, which takes 5
// products with atomics for dq.  A warpgroup runs each tile's products,
// its elementwise work and the next products in turn, so the tensor cores
// wait while only two warpgroups overlap.  Tried and slower on the same
// card: the forward's software pipeline (S^T of tile n + 1 issued ahead of
// tile n's dV and dK; 0.267 ms against 0.229 before the snake order, 0.278
// with its warpgroup turns), dk / dv split between the warpgroups at hd
// 80 and 128, 128-key dq tiles.  At hd 256 ptxas serializes the dk / dv
// kernel's wgmma (C7520: the two warpgroups' roles branch around them).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 2;     // warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kRowBytes = 128;    // a swizzled tile row: 64 bf16
constexpr int kRows = 128;        // dq: query rows an item
constexpr int kPad = 64;          // scratch rows padded to a multiple
constexpr float kLog2e = 1.4426950408889634f;

// The tiles of a head width are TW columns wide (hd rounded up to whole
// 64-column chunks).  Byte offsets in the block's shared memory (1024-byte
// aligned); chunk c of a tile of R rows sits at c * R * 128.
template <int TW>
struct BwdConfig {
  static constexpr int kChunks = TW / 64;
  // dk / dv: at hd 256 one warpgroup takes dV, the other dK, of 64 keys
  static constexpr bool kSplit = TW == 256;
  static constexpr int kKeys = kSplit ? 64 : 128;   // keys an item
  // queries a tile: 32 from hd 80 up, where dK and dV take 128 registers
  // and 64-query S^T and dP^T tiles beside them spilled
  static constexpr int kBq = TW >= 128 ? 32 : 64;
  static constexpr int kStages = 3;
  static constexpr int kKVTile = kKeys * TW * 2;
  static constexpr int kQTile = kBq * TW * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kKVTile;
  static constexpr int kQ = 2 * kKVTile;     // + s * 2 kQTile; dO + kQTile
  static constexpr int kLse = kQ + kStages * 2 * kQTile;  // + s * 8 kBq
  static constexpr int kBytes = kLse + kStages * 8 * kBq;
  // dq: Q and dO of 128 rows once an item, K and V tiles in a ring
  static constexpr int kBk = kSplit ? 32 : 64;      // keys a tile
  static constexpr int kKStages = kSplit ? 2 : 3;
  static constexpr int kRowTile = kRows * TW * 2;
  static constexpr int kKTile = kBk * TW * 2;
  static constexpr int kDqQ = 0;
  static constexpr int kDqDo = kRowTile;
  static constexpr int kDqK = 2 * kRowTile;  // + s * 2 kKTile; V + kKTile
  static constexpr int kDqBytes = kDqK + kKStages * 2 * kKTile;
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

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16) into shared
// memory at dst, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
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

// A consumer thread's first row in its warpgroup's 64 (r_lo; r_lo + 8 is
// its other) and its first column in an 8-wide chunk.
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

// 2^x on the special-function unit (relative error ~2^-22).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// d[16] += A (64 x 16, shared) * B (16 x 32, shared)^T; both K-major.
__device__ __forceinline__ void wgmma_m64n32k16_ss(float* d, uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d += A B^T over 16 columns for a B tile of N rows (64 or 32).
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  if constexpr (N == 64)
    wgmma_m64n64k16_ss(d, desc_a, desc_b, scale_d);
  else
    wgmma_m64n32k16_ss(d, desc_a, desc_b, scale_d);
}

// d[32] += A (64 x 16, registers, bf16) * B (16 x 64, shared), B MN-major
// (a tile as TMA stores it: the 16 contracted rows, 64 columns contiguous).
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

// acc (64 x TW, TW / 64 chunks of 32 registers) += A (64 x 16k, registers,
// `a`: 4 words a 16-row step) * T (16k rows of a tile of R rows at `tile`,
// MN-major), over `steps` steps of 16 contracted rows
template <int TW, int R, int kSteps>
__device__ __forceinline__ void rs_product(float* acc, const uint32_t* a,
                                           uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
    for (int c = 0; c < TW / 64; ++c)
      wgmma_m64n64k16_rs(acc + 32 * c, a + 4 * kk,
                         sw128_desc(tile + c * R * kRowBytes +
                                    kk * 16 * kRowBytes));
}

// d (64 x N) = A (64 rows at `a` of a tile of RA rows) B^T (N rows: a tile
// of N rows at `b`) over the ceil(HD / 16) column steps that hold data
template <int HD, int N, int RA>
__device__ __forceinline__ void ss_product(float* d, uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < (HD + 15) / 16; ++kk) {
    const int c = kk / 4, w4 = (kk % 4) * 32;  // chunk, bytes in a row
    wgmma_ss<N>(d, sw128_desc(a + c * RA * kRowBytes + w4),
                sw128_desc(b + c * N * kRowBytes + w4), kk > 0);
  }
}

// The accumulator fragment of a 64 x N product as the register A operand
// (bf16) of the next: 8 columns j, row r_lo values 4j, 4j + 1, row r_hi
// 4j + 2, 4j + 3 -> words 2j (r_lo), 2j + 1 (r_hi).
template <int N>
__device__ __forceinline__ void pack_a(const float* x, uint32_t* a) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    a[2 * j] = pack_bf16(x[4 * j], x[4 * j + 1]);
    a[2 * j + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

// Store a 64 x HD accumulator (rows row0 + the lane's rows, those < S) in
// bf16, times `mul`, into a (B, S, heads, HD) tensor at (b, head).
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float* acc,
                                           float mul, int b, int head,
                                           int heads, int row0, int S) {
  const Lane ln = lane_coords();
  const int r_lo = row0 + ln.row, r_hi = r_lo + 8;
  const long long stride = static_cast<long long>(heads) * HD;
  __nv_bfloat16* lo = out + (static_cast<long long>(b) * S + r_lo) * stride +
                      static_cast<long long>(head) * HD + ln.col;
  __nv_bfloat16* hi = lo + 8 * stride;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (r_lo < S)
      *reinterpret_cast<__nv_bfloat162*>(lo + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (r_hi < S)
      *reinterpret_cast<__nv_bfloat162*>(hi + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// The work item a block takes in its round r: items are numbered heaviest
// first and dealt to the blocks in a snake (round 0 left to right, round 1
// right to left, ...), so that the blocks that took the heaviest items in
// one round take the lightest in the next (with the grid as a plain stride,
// smollm's dk / dv blocks carried up to 66 tiles against an average of 39;
// in a snake 48, as longest-first greedy does).
__device__ __forceinline__ int snake_item(int r) {
  const int g = gridDim.x, b = blockIdx.x;
  return r * g + ((r & 1) ? g - 1 - b : b);
}

// whether query i and key j attend: j <= i if causal, j >= i - window with
// a window, both < S
__device__ __forceinline__ bool keep(int i, int j, int S, int causal,
                                     int window) {
  return i < S && j < S && (!causal || j <= i) &&
         (window <= 0 || j >= i - window);
}

// the sum of the products of 8 bf16 pairs packed in two 16-byte words
__device__ __forceinline__ float dot16(uint4 x, uint4 y) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
  }
  return acc;
}

// (a) D = rowsum(do o) and lse in log2 units into the padded (B H, Sp)
// scratch, a thread a (b, i, h) row (the rows of neighbouring heads lie
// side by side, so a warp reads 32 whole rows), read in 16-byte words and
// summed in a fixed order; then zeros past S
template <int HD>
__global__ void bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                                const __nv_bfloat16* __restrict__ dout,
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
      const uint4* po = reinterpret_cast<const uint4*>(o + r * HD);
      const uint4* pd = reinterpret_cast<const uint4*>(dout + r * HD);
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) acc += dot16(pd[c], po[c]);
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

// (b) dk and dv of one (b, KV head, kKeys keys), summed over the group's
// query heads; items heaviest first (key tile 0 first)
template <int HD, int TW>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const float* __restrict__ lse2, const float* __restrict__ Dg,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                int B, int S, int Sp, int H, int KV, int causal, int window,
                float scale_log2, float scale, int n_ktiles) {
  using C = BwdConfig<TW>;
  constexpr int kKeys = C::kKeys, kBq = C::kBq, kStages = C::kStages;
  static_assert(HD % 8 == 0 && HD <= TW && TW - HD < 64, "tile width");
  extern __shared__ uint8_t smem_raw[];
  // K / V full, K / V empty; per stage: full, empty
  __shared__ __align__(8) uint64_t bars[2 + 2 * kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_kv = smem_u32(bars), bar_kv_empty = bar_kv + 8;
  const uint32_t bar_full = bar_kv + 16, bar_empty = bar_full + 8 * kStages;
  const int G = H / KV;
  const int n_items = n_ktiles * KV * B;
  // the item's query range: from the causal diagonal (or 0) to the last
  // query the window lets see its keys (or S), in tiles of kBq
  auto item = [&](int w, int& b, int& kvh, int& k0, int& q_lo, int& n_qt) {
    const int level = w / (KV * B), rem = w % (KV * B);
    kvh = rem % KV;
    b = rem / KV;
    k0 = level * kKeys;
    q_lo = causal ? (k0 / kBq) * kBq : 0;
    const int q_hi = window > 0 ? min(S, k0 + kKeys + window) : S;
    n_qt = (q_hi - q_lo + kBq - 1) / kBq;
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_kv_empty, kConsumers * 4);      // every consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread loads K and V once an item and keeps the
    // Q / dO / lse / D tiles of its query heads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers * 128) {
      int ring = 0, i = 0;
      for (int w = snake_item(0); w < n_items; w = snake_item(++i)) {
        int b, kvh, k0, q_lo, n_qt;
        item(w, b, kvh, k0, q_lo, n_qt);
        mbar_wait(bar_kv_empty, (i & 1) ^ 1);
        mbar_expect_tx(bar_kv, 2 * C::kKVTile);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load(base + C::kK + c * kKeys * kRowBytes, &tk, bar_kv, 64 * c,
                   kvh, k0, b);
          tma_load(base + C::kV + c * kKeys * kRowBytes, &tv, bar_kv, 64 * c,
                   kvh, k0, b);
        }
        for (int n = 0; n < G * n_qt; ++n, ++ring) {
          const int s = ring % kStages;
          const int h = kvh * G + n / n_qt, q0 = q_lo + (n % n_qt) * kBq;
          const uint32_t tile = base + C::kQ + s * 2 * C::kQTile;
          const uint32_t rows = base + C::kLse + s * 8 * kBq;
          const long long at = (static_cast<long long>(b) * H + h) * Sp + q0;
          mbar_wait(bar_empty + 8 * s, ((ring / kStages) & 1) ^ 1);
          mbar_expect_tx(bar_full + 8 * s, 2 * C::kQTile + 8 * kBq);
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c) {
            tma_load(tile + c * kBq * kRowBytes, &tq, bar_full + 8 * s,
                     64 * c, h, q0, b);
            tma_load(tile + C::kQTile + c * kBq * kRowBytes, &tdo,
                     bar_full + 8 * s, 64 * c, h, q0, b);
          }
          bulk_load(rows, lse2 + at, 4 * kBq, bar_full + 8 * s);
          bulk_load(rows + 4 * kBq, Dg + at, 4 * kBq, bar_full + 8 * s);
        }
      }
    }
  } else {
    // ---- consumers: 64 keys a warpgroup (at hd 256 the same 64 keys,
    // warpgroup 0 forming dV, warpgroup 1 dK) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const bool lead = tid % 32 == 0;
    const bool do_dv = !C::kSplit || wg == 0;
    const bool do_dk = !C::kSplit || wg == 1;
    const int key_off = C::kSplit ? 0 : 64 * wg;  // the warpgroup's keys
    float acc0[TW / 2];                   // dV (at hd 256: dV or dK)
    float acc1[C::kSplit ? 1 : TW / 2];   // dK (unused at hd 256)
    float* dva = acc0;
    float* dka = C::kSplit ? acc0 : acc1;
    float st[kBq / 2], dpt[kBq / 2];      // S^T then P^T; dP^T then dS^T
    uint32_t pp[kBq / 4], pd[kBq / 4];    // P^T, dS^T in bf16: A fragments
#pragma unroll
    for (int j = 0; j < kBq / 2; ++j) st[j] = dpt[j] = 0.f;

    int ring = 0, i = 0;
    for (int w = snake_item(0); w < n_items; w = snake_item(++i)) {
      int b, kvh, k0, q_lo, n_qt;
      item(w, b, kvh, k0, q_lo, n_qt);
      const int kw = k0 + key_off;        // the warpgroup's first key
#pragma unroll
      for (int j = 0; j < TW / 2; ++j) acc0[j] = 0.f;
      if constexpr (!C::kSplit) {
#pragma unroll
        for (int j = 0; j < TW / 2; ++j) acc1[j] = 0.f;
      }
      mbar_wait(bar_kv, i & 1);
      const uint32_t k_a = base + C::kK + key_off * kRowBytes;
      const uint32_t v_a = base + C::kV + key_off * kRowBytes;
      for (int n = 0; n < G * n_qt; ++n, ++ring) {
        const int s = ring % kStages;
        const int q0 = q_lo + (n % n_qt) * kBq;
        const uint32_t q_t = base + C::kQ + s * 2 * C::kQTile;
        const uint32_t do_t = q_t + C::kQTile;
        mbar_wait(bar_full + 8 * s, (ring / kStages) & 1);
        // does the warpgroup keep any (query, key) pair of the tile?
        const bool active = kw < S && (!causal || kw <= q0 + kBq - 1) &&
                            (window <= 0 || kw + 63 >= q0 - window);
        if (active) {
          fence_regs<kBq / 2>(st);
          fence_regs<kBq / 2>(dpt);
          wgmma_fence();
          ss_product<HD, kBq, kKeys>(st, k_a, q_t);       // S^T = K Q^T
          if (do_dk) ss_product<HD, kBq, kKeys>(dpt, v_a, do_t);  // V dO^T
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<kBq / 2>(st);
          fence_regs<kBq / 2>(dpt);
          // P^T = 2^(S^T scale log2(e) - lse2) and dS^T = P^T (dP^T - D),
          // masked to 0 on cut tiles; a thread's keys are rows r_lo and
          // r_lo + 8, its queries columns 8j + col, + 1
          const float* rows = reinterpret_cast<const float*>(
              smem_raw + (base - smem_u32(smem_raw)) + C::kLse + s * 8 * kBq);
          const Lane ln = lane_coords();
          const bool edge = q0 + kBq > S || (causal && kw + 63 > q0) ||
                            (window > 0 && kw < q0 + kBq - 1 - window);
#pragma unroll
          for (int j = 0; j < kBq / 8; ++j) {
            const float2 l2 =
                *reinterpret_cast<const float2*>(rows + 8 * j + ln.col);
            const float2 dd = *reinterpret_cast<const float2*>(
                rows + kBq + 8 * j + ln.col);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float p = ex2(st[4 * j + e] * scale_log2 - ((e & 1) ? l2.y : l2.x));
              if (edge && !keep(q0 + 8 * j + ln.col + (e & 1),
                                kw + ln.row + 8 * (e >> 1), S, causal, window))
                p = 0.f;
              st[4 * j + e] = p;
              if (do_dk) dpt[4 * j + e] = p * (dpt[4 * j + e] -
                                                ((e & 1) ? dd.y : dd.x));
            }
          }
          // dV += P^T dO and dK += dS^T Q, in one group
          if (do_dv) pack_a<kBq>(st, pp);
          if (do_dk) pack_a<kBq>(dpt, pd);
          fence_regs<TW / 2>(acc0);
          if constexpr (!C::kSplit) fence_regs<TW / 2>(acc1);
          wgmma_fence();
          if (do_dv) rs_product<TW, kBq, kBq / 16>(dva, pp, do_t);
          if (do_dk) rs_product<TW, kBq, kBq / 16>(dka, pd, q_t);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<TW / 2>(acc0);
          if constexpr (!C::kSplit) fence_regs<TW / 2>(acc1);
        }
        if (lead) mbar_arrive(bar_empty + 8 * s);  // this warp is done with it
      }
      if (lead) mbar_arrive(bar_kv_empty);  // K and V of the item are read
      if (do_dv) store_rows<HD>(dv, dva, 1.f, b, kvh, KV, kw, S);
      if (do_dk) store_rows<HD>(dk, dka, scale, b, kvh, KV, kw, S);
    }
  }
}

// (c) dq of one (b, h, 128 query rows), items heaviest first (the last
// query tile of every (b, h) first)
template <int HD, int TW>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const float* __restrict__ lse2, const float* __restrict__ Dg,
              __nv_bfloat16* __restrict__ dq, int B, int S, int Sp, int H,
              int KV, int causal, int window, float scale_log2, float scale,
              int n_qtiles) {
  using C = BwdConfig<TW>;
  constexpr int kBk = C::kBk, kStages = C::kKStages;
  static_assert(HD % 8 == 0 && HD <= TW && TW - HD < 64, "tile width");
  extern __shared__ uint8_t smem_raw[];
  // Q / dO full, Q / dO empty; per stage: full, empty
  __shared__ __align__(8) uint64_t bars[2 + 2 * kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_q = smem_u32(bars), bar_q_empty = bar_q + 8;
  const uint32_t bar_full = bar_q + 16, bar_empty = bar_full + 8 * kStages;
  const int n_items = n_qtiles * H * B;
  // the item's key range: from the first tile the window reaches to the
  // causal frontier, in tiles of kBk
  auto item = [&](int w, int& b, int& h, int& q0, int& k_lo, int& n_kt) {
    const int level = w / (H * B), rem = w % (H * B);
    h = rem % H;
    b = rem / H;
    q0 = (n_qtiles - 1 - level) * kRows;
    const int k_end = causal ? min(S, q0 + kRows) : S;
    k_lo = window > 0 ? (max(0, q0 - window) / kBk) * kBk : 0;
    n_kt = (k_end - k_lo + kBk - 1) / kBk;
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q_empty, kConsumers * 4);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers * 128) {
      int ring = 0, i = 0;
      for (int w = snake_item(0); w < n_items; w = snake_item(++i)) {
        int b, h, q0, k_lo, n_kt;
        item(w, b, h, q0, k_lo, n_kt);
        const int kvh = h / (H / KV);
        mbar_wait(bar_q_empty, (i & 1) ^ 1);
        mbar_expect_tx(bar_q, 2 * C::kRowTile);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load(base + C::kDqQ + c * kRows * kRowBytes, &tq, bar_q, 64 * c,
                   h, q0, b);
          tma_load(base + C::kDqDo + c * kRows * kRowBytes, &tdo, bar_q,
                   64 * c, h, q0, b);
        }
        for (int n = 0; n < n_kt; ++n, ++ring) {
          const int s = ring % kStages;
          const int kt = k_lo + n * kBk;
          const uint32_t tile = base + C::kDqK + s * 2 * C::kKTile;
          mbar_wait(bar_empty + 8 * s, ((ring / kStages) & 1) ^ 1);
          mbar_expect_tx(bar_full + 8 * s, 2 * C::kKTile);
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c) {
            tma_load(tile + c * kBk * kRowBytes, &tk, bar_full + 8 * s,
                     64 * c, kvh, kt, b);
            tma_load(tile + C::kKTile + c * kBk * kRowBytes, &tv,
                     bar_full + 8 * s, 64 * c, kvh, kt, b);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const bool lead = tid % 32 == 0;
    float dqa[TW / 2];
    float sc[kBk / 2], dp[kBk / 2];       // S then P; dP then dS
    uint32_t pa[kBk / 4];                 // dS in bf16, A fragments
#pragma unroll
    for (int j = 0; j < kBk / 2; ++j) sc[j] = dp[j] = 0.f;
    const uint32_t q_a = base + C::kDqQ + wg * 64 * kRowBytes;
    const uint32_t do_a = base + C::kDqDo + wg * 64 * kRowBytes;

    int ring = 0, i = 0;
    for (int w = snake_item(0); w < n_items; w = snake_item(++i)) {
      int b, h, q0, k_lo, n_kt;
      item(w, b, h, q0, k_lo, n_kt);
      const int row0 = q0 + wg * 64;     // the warpgroup's first row
#pragma unroll
      for (int j = 0; j < TW / 2; ++j) dqa[j] = 0.f;
      // the thread's two rows' lse (log2 units) and D
      float l2[2], dd[2];
      {
        const Lane ln = lane_coords();
        const long long at = (static_cast<long long>(b) * H + h) * Sp;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = row0 + ln.row + 8 * e;
          l2[e] = r < S ? lse2[at + r] : 0.f;
          dd[e] = r < S ? Dg[at + r] : 0.f;
        }
      }
      mbar_wait(bar_q, i & 1);
      for (int n = 0; n < n_kt; ++n, ++ring) {
        const int s = ring % kStages;
        const int kt = k_lo + n * kBk;
        const uint32_t k_t = base + C::kDqK + s * 2 * C::kKTile;
        const uint32_t v_t = k_t + C::kKTile;
        mbar_wait(bar_full + 8 * s, (ring / kStages) & 1);
        const bool active = row0 < S && (!causal || kt <= row0 + 63) &&
                            (window <= 0 || kt + kBk - 1 >= row0 - window);
        if (active) {
          fence_regs<kBk / 2>(sc);
          fence_regs<kBk / 2>(dp);
          wgmma_fence();
          ss_product<HD, kBk, kRows>(sc, q_a, k_t);     // S = Q K^T
          ss_product<HD, kBk, kRows>(dp, do_a, v_t);    // dP = dO V^T
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<kBk / 2>(sc);
          fence_regs<kBk / 2>(dp);
          const Lane ln = lane_coords();
          const bool edge = kt + kBk > S || (causal && kt + kBk - 1 > row0) ||
                            (window > 0 && kt < row0 + 63 - window);
#pragma unroll
          for (int j = 0; j < kBk / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float p = ex2(sc[4 * j + e] * scale_log2 - l2[e >> 1]);
              if (edge && !keep(row0 + ln.row + 8 * (e >> 1),
                                kt + 8 * j + ln.col + (e & 1), S, causal,
                                window))
                p = 0.f;
              dp[4 * j + e] = p * (dp[4 * j + e] - dd[e >> 1]);
            }
          pack_a<kBk>(dp, pa);
          fence_regs<TW / 2>(dqa);
          wgmma_fence();
          rs_product<TW, kBk, kBk / 16>(dqa, pa, k_t);  // dQ += dS K
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<TW / 2>(dqa);
        }
        if (lead) mbar_arrive(bar_empty + 8 * s);
      }
      if (lead) mbar_arrive(bar_q_empty);  // Q and dO of the item are read
      store_rows<HD>(dq, dqa, scale, b, h, H, row0, S);
    }
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

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *dq, *dk, *dv, *ws;
  int B, S, H, KV, causal, window;
};

template <int HD, int TW>
int launch(const Args& a, cudaStream_t st) {
  using C = BwdConfig<TW>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -2;
  const int B = a.B, S = a.S, H = a.H, KV = a.KV;
  CUtensorMap tq, tdo, tk, tv, rq, rdo, rk, rv;
  if (!make_map(encode, &tq, a.q, B, S, H, HD, C::kBq) ||
      !make_map(encode, &tdo, a.dout, B, S, H, HD, C::kBq) ||
      !make_map(encode, &tk, a.k, B, S, KV, HD, C::kKeys) ||
      !make_map(encode, &tv, a.v, B, S, KV, HD, C::kKeys) ||
      !make_map(encode, &rq, a.q, B, S, H, HD, kRows) ||
      !make_map(encode, &rdo, a.dout, B, S, H, HD, kRows) ||
      !make_map(encode, &rk, a.k, B, S, KV, HD, C::kBk) ||
      !make_map(encode, &rv, a.v, B, S, KV, HD, C::kBk))
    return -3;
  const int smem_kv = C::kBytes + 1024;    // + the 1024-byte alignment
  const int smem_q = C::kDqBytes + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_kernel<HD, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_kv);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dq_kernel<HD, TW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_q);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Sp = (S + kPad - 1) / kPad * kPad;
  const long long rows = static_cast<long long>(B) * H * Sp;
  float* lse2 = static_cast<float*>(a.ws);
  float* Dg = lse2 + rows;
  const float scale = 1.f / sqrtf(static_cast<float>(HD));
  const float scale_log2 = scale * kLog2e;
  const long long blocks = (rows + 255) / 256;   // a thread a row
  const int prep_blocks = static_cast<int>(blocks < 16LL * sms ? blocks
                                                               : 16LL * sms);
  bwd_prep_kernel<HD><<<prep_blocks, 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(a.o),
      static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), lse2, Dg, B, S, Sp, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_ktiles = (S + C::kKeys - 1) / C::kKeys;
  const int kv_items = n_ktiles * KV * B;
  bwd_dkdv_kernel<HD, TW><<<min(kv_items, sms), kThreads, smem_kv, st>>>(
      tq, tdo, tk, tv, lse2, Dg, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), B, S, Sp, H, KV, a.causal, a.window,
      scale_log2, scale, n_ktiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (S + kRows - 1) / kRows;
  const int q_items = n_qtiles * H * B;
  bwd_dq_kernel<HD, TW><<<min(q_items, sms), kThreads, smem_q, st>>>(
      rq, rdo, rk, rv, lse2, Dg, static_cast<__nv_bfloat16*>(a.dq), B, S, Sp,
      H, KV, a.causal, a.window, scale_log2, scale, n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, do, dq: (B, S, H, hd); k, v, dk, dv: (B, S, KV, hd); contiguous,
// 16-byte aligned, bfloat16; lse: (B, H, S) float32, the forward's
// log-sum-exp; ws: 2 B H Sp float32 scratch (Sp = S rounded up to 64); hd
// 8, 16, 64, 80, 128 or 256.  Three launches on `stream` (prep, dk / dv,
// dq); returns the first cudaGetLastError() that is not 0 (0 on success;
// -1 for an unsupported hd, -2 when the driver has no
// cuTensorMapEncodeTiled, -3 when a map cannot be encoded).
extern "C" int flash_attention_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv, void* ws,
    int B, int S, int H, int KV, int hd, int causal, int window, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, o, dout, lse, dq, dk, dv, ws, B, S, H, KV, causal,
               window};
  switch (hd) {
    case 8: return launch<8, 64>(a, st);
    case 16: return launch<16, 64>(a, st);
    case 64: return launch<64, 64>(a, st);
    case 80: return launch<80, 128>(a, st);
    case 128: return launch<128, 128>(a, st);
    case 256: return launch<256, 256>(a, st);
    default: return -1;
  }
}
