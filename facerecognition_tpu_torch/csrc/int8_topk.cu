// Exact top-k over an int8-quantized gallery, for sm_90a.
//
// Replaces `cosine_topk_int8` (facerecognition_tpu/ops/matcher.py), an XLA
// query normalisation and quantization, an s8 x s8 -> s32 `dot_general`, a
// rank-1 dequantisation and `lax.top_k`, as three launches on the caller's
// stream that never write the (B, N) score matrix:
//
//   scores[b, n] = ((float)acc[b, n] * (q_scale[b] * r)) * (g_scale[n] * r)
//
// with acc the exact int32 product of the query and gallery codes and
// r = float32(1 / 127), each product rounded to nearest as written (XLA
// rewrites `/ 127.0` into a product with that reciprocal; the plain version
// `ops/matcher.int8_scores` computes this order).
//
//   int8_quantize: one warp per query row computes the plain version's
//     `quantize_embeddings_int8(l2_normalize_windowed(x))` in its order of
//     roundings (squares, each 32-column window summed left to right, the
//     window sums left to right, a float64 root rounded once, true
//     divisions, a max that keeps NaN, half-to-even codes) and writes the
//     codes, zero-padded to 16-byte rows, and the scales to a workspace
//     that pass 1's query tensor map reads. Callers holding codes skip it.
//   pass 1 (int8_partial): grid (n_split, groups), 256 threads, one block per
//     SM: two consumer warpgroups, each feeding its own ring of stages by
//     TMA (its thread 0 refills a stage once its four warps have released
//     it), each stage a (128 gallery rows x 128 dims) int8 tile and the
//     group's (W x 128) query-code tile, 128-byte swizzled, with mbarrier
//     completion. Rows >= n_valid lie outside the gallery's tensor map and
//     arrive as zeros; they never enter a list. The warpgroups are
//     ping-pong consumers: each takes whole 128-row tiles in turn (even and
//     odd), so one consumer's epilogue runs while the other's wgmmas are in
//     flight. A consumer issues two m64nWk32 s32.s8.s8 wgmmas per k-step
//     (tile rows 0-63 and 64-127, gallery rows on the M side, both operands
//     K-major as 8-bit wgmma requires), four k-steps per stage, a tile's
//     stages back to back; it releases them once the tile's products are
//     done, so their refills load under its epilogue. The int32 accumulator
//     is exact, so it carries the whole row across the chunks. The epilogue
//     stays in registers: each thread dequantises its elements in place in
//     the plain version's order and holds each against its query's float
//     threshold, the score of the k-th key of the query's list (-inf until
//     the list holds k), into a mask. The few that reach it go one at a
//     time through a single copy of the exact test (picked out of the
//     registers by a tree of selects; a copy per unrolled element nearly
//     doubled the kernel's code and cost 15% at B = 128, PERF.md): they
//     take their order keys (order_key.cuh: NaN above +inf), and only an
//     element whose key passes the k-th key goes to shared memory, compacted
//     per query as (key, row); each query's owner thread folds those into
//     its register top-k list (ties to the
//     lowest row). The k-th key is a lower bound taken before the tile (all
//     of whose rows are higher than the list's), so an element it drops
//     cannot be among the k best, and after the first tiles almost every
//     element is dropped. In a consumer's first tile (its lists empty), in
//     a round after an overflow, and in every tile after an overflow past a
//     consumer's first tile (rows that keep entering the lists, as in a
//     gallery whose scores rise with the row), a bound from the tile itself
//     also applies: the
//     k-th best of each warp's eight lane maxima, which k rows of the tile
//     reach (k <= 8). A query's compaction buffer holds `cap` entries;
//     when more pass, the epilogue takes further rounds over the elements
//     not yet placed, each against the list as it then stands (key >= k-th
//     key, as a tie may now sit on a higher row of the same tile). Each
//     consumer writes its k best per query to scratch: 2 * n_split
//     candidate lists per query.
//   pass 2 (topk_merge): one block per query merges the candidates, as in
//     stream_topk.cu.
//
// The work split (W, groups, n_split, rows_per_split) is stream_topk's plan
// (ops/stream_topk.plan) with W at most 64, made in Python and passed in.
// The ring's depth is chosen here at launch, as the deepest that fits the
// shared memory.
//
// What bounds it, on the H100 SXM's published 3.35 TB/s and 1,979 TOP/s
// (int8, dense): the gallery codes and scales are read once, (D + 4) bytes a
// row, and the product is 2BND integer operations. At (B, N, D) = (128, 1M,
// 512) that is max(0.154 ms of bytes, 0.068 ms of operations): bound by the
// memory path, and at B = 1 and B = 32 more so. A 128-row int8 tile at D =
// 512 is 64 KB, about 2.6 us of one SM's share of HBM. Folding every row
// through shared memory took 5.8 us a tile at B = 128, 62% of it the fold
// (PERF.md), hence the filtered register epilogue. At B = 128 the
// epilogue's issue rate, two warps a sub-partition, still bounds it
// (PERF.md); at B = 1 the memory path does.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "order_key.cuh"

namespace {

constexpr int CONSUMERS = 2;                  // consumer warpgroups, whole tiles in turn
constexpr int WG_ROWS = 64;                   // gallery rows of one wgmma (M)
constexpr int TILE_ROWS = 2 * WG_ROWS;        // rows of a tile: two wgmmas a k-step
constexpr int K_CHUNK = 128;                  // dims per stage: 128 bytes, the swizzle span
constexpr int K_STEP = 32;                    // dims per s8 wgmma (32 bytes)
constexpr int K_STEPS = K_CHUNK / K_STEP;
// Two consumer warpgroups and no producer warp (each consumer feeds its own
// ring from its thread 0): eight warps, two on each SM sub-partition, leave
// every thread up to 255 registers for its two W / 2 accumulators and its
// top-k list (a ninth warp caps every thread at 168, setmaxnreg or not).
constexpr int THREADS = 128 * CONSUMERS;
constexpr int GALLERY_TILE_BYTES = TILE_ROWS * K_CHUNK;
constexpr int SMEM_ALIGN = 1024;              // a 128-byte swizzle atom is 8 rows of 128 bytes
constexpr int MAX_SMEM = 232448;
constexpr int MIN_STAGES = 2 * CONSUMERS;     // two stages a ring
constexpr int MAX_STAGES = 8;
constexpr int MERGE_THREADS = 256;
constexpr int BUF_ENTRIES = 2016;             // (key, row) slots of a consumer's compaction buffer
constexpr int QUANT_WARPS = 4;                // int8_quantize: query rows per block
constexpr int WINDOW = 32;                    // columns the norm sums as one window
constexpr float UNFILLED_SCORE = -1e30f;
constexpr float INV_127 = 0x1.020408p-7f;     // float32(1 / 127), as XLA folds `/ 127.0`

// Shared memory of pass 1: `stages` x (gallery tile, query tile), a ring of
// stages / 2 for each consumer (a stage shared by both would see its fills
// alternate between them, and as TMA fills complete in any order, a
// consumer could take a parity two fills old for its own), then per
// consumer its compaction buffer (W x cap (key, row) pairs), its W counts,
// its W k-th keys, their W float thresholds and W lower bounds of a tile's
// k-th key, then the W query scales times r and the full and empty
// barriers.
struct Layout {
  int width;
  int stages;
  // entries of a query's compaction buffer: a whole tile where it fits
  __host__ __device__ int cap() const { return min(TILE_ROWS, BUF_ENTRIES / width); }
  __host__ __device__ int query_bytes() const { return width * K_CHUNK; }
  __host__ __device__ int stage_bytes() const { return GALLERY_TILE_BYTES + query_bytes(); }
  __host__ __device__ int buf_offset() const { return stages * stage_bytes(); }
  __host__ __device__ int count_offset() const { return buf_offset() + CONSUMERS * BUF_ENTRIES * 8; }
  __host__ __device__ int kth_offset() const { return count_offset() + CONSUMERS * width * 4; }
  __host__ __device__ int thr_offset() const { return kth_offset() + CONSUMERS * width * 4; }
  __host__ __device__ int lo_offset() const { return thr_offset() + CONSUMERS * width * 4; }
  __host__ __device__ int qscale_offset() const { return lo_offset() + CONSUMERS * width * 4; }
  __host__ __device__ int barriers_offset() const { return qscale_offset() + width * 4; }
  __host__ __device__ int bytes() const { return barriers_offset() + 2 * stages * 8 + SMEM_ALIGN; }
};

// A stage of one consumer's ring (stages first, first + 1, ...) and the
// parity of its current use.
struct RingCursor {
  int stage;
  int phase = 0;
  __device__ __forceinline__ void advance(int first, int ring) {
    if (++stage == first + ring) {
      stage = first;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ bool better(int s, int i, int t, int j) {
  return s > t || (s == t && i < j);
}

// Insert (s, i) into a list kept sorted best first; a full list drops its
// worst entry. All indices are compile-time, so the list stays in registers.
template <int KMAX>
__device__ __forceinline__ void insert(int (&ts)[KMAX], int (&ti)[KMAX], int s, int i) {
  if (!better(s, i, ts[KMAX - 1], ti[KMAX - 1])) return;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (better(s, i, ts[j], ti[j])) {
      const int fs = ts[j];
      const int fi = ti[j];
      ts[j] = s;
      ti[j] = i;
      s = fs;
      i = fi;
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the (K_CHUNK x rows) box at (x = dim, y = row) of `map` into `dst`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                         int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// A named barrier that returns whether any of its threads passed `pred`.
__device__ __forceinline__ bool named_barrier_any(int id, int threads, bool pred) {
  int any;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.s32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, %3, p;\nselp.s32 %0, 1, 0, q;\n}\n"
      : "=r"(any)
      : "r"((int)pred), "r"(id), "r"(threads)
      : "memory");
  return any != 0;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Returns once at most the last committed group of wgmmas is in flight.
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Keeps the compiler from touching a register across an asynchronous wgmma.
__device__ __forceinline__ void reg_fence(int& x) { asm volatile("" : "+r"(x)::"memory"); }

// Shared-memory descriptor of a K-major operand tile with the 128-byte
// swizzle: 8-row groups 1024 bytes apart; the leading offset is unused.
__device__ __forceinline__ uint64_t kmajor_sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// wgmma m64nWk32, s32 (+)= s8 x s8, A and B by descriptor (both K-major).
// The accumulator: d[4i + j] is row 16w + l/4 + 8 * (j / 2), column
// 8i + 2 * (l % 4) + j % 2, for lane l of warp w of the warpgroup.
template <int W>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ __forceinline__ static void mma(int (&d)[4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, %4, %5, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(int (&d)[8], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(int (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(int (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// The float NaN-propagating max, as torch.amax takes it (fmaxf drops NaN).
__device__ __forceinline__ float max_keep_nan(float a, float b) { return (b > a || b != b) ? b : a; }

// quantize_embeddings_int8(l2_normalize_windowed(x)) of (B, D) float32 rows
// (D a multiple of 4, rows 16-byte aligned) in the plain version's order of
// roundings; codes (B, pitch) int8 with zero codes past D, scales (B,).
__global__ void __launch_bounds__(QUANT_WARPS * 32)
    int8_quantize(const float* __restrict__ x, int B, int D, int pitch, int8_t* __restrict__ codes,
                  float* __restrict__ scales) {
  const int row = blockIdx.x * QUANT_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= B) return;
  const float* xr = x + (size_t)row * D;

  // Lane w sums window w's squares left to right; the window sums are then
  // added left to right (every lane adds the same values in the same order).
  const int windows = (D + WINDOW - 1) / WINDOW;
  float total = 0.f;
  for (int w0 = 0; w0 < windows; w0 += 32) {
    const int w = w0 + lane;
    float part = 0.f;
    if (w < windows) {
      const int end = min(D, (w + 1) * WINDOW);
      for (int j = w * WINDOW; j < end; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(xr + j);
        part = __fadd_rn(part, __fmul_rn(v.x, v.x));
        part = __fadd_rn(part, __fmul_rn(v.y, v.y));
        part = __fadd_rn(part, __fmul_rn(v.z, v.z));
        part = __fadd_rn(part, __fmul_rn(v.w, v.w));
      }
    }
    const int here = min(32, windows - w0);
    for (int u = 0; u < here; ++u) total = __fadd_rn(total, __shfl_sync(0xffffffffu, part, u));
  }
  const float norm = __double2float_rn(__dsqrt_rn((double)total));
  const float safe = norm < 1e-12f ? 1e-12f : norm;  // clamp keeps a NaN

  float scale = 0.f;
  for (int j = 4 * lane; j < D; j += 128) {
    const float4 v = *reinterpret_cast<const float4*>(xr + j);
    scale = max_keep_nan(scale, fabsf(__fdiv_rn(v.x, safe)));
    scale = max_keep_nan(scale, fabsf(__fdiv_rn(v.y, safe)));
    scale = max_keep_nan(scale, fabsf(__fdiv_rn(v.z, safe)));
    scale = max_keep_nan(scale, fabsf(__fdiv_rn(v.w, safe)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    scale = max_keep_nan(scale, __shfl_xor_sync(0xffffffffu, scale, off));
  const float qsafe = scale < 1e-12f ? 1e-12f : scale;

  // round(x / safe * 127) half to even; a NaN gives code 0, as the
  // conversion to int8 gives it on the card and the CPU.
  int8_t* cr = codes + (size_t)row * pitch;
  for (int j = 4 * lane; j < pitch; j += 128) {
    uint32_t word = 0;
    if (j < D) {
      const float4 v = *reinterpret_cast<const float4*>(xr + j);
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float c = __fmul_rn(__fdiv_rn(__fdiv_rn(e[u], safe), qsafe), 127.f);
        const int code = c != c ? 0 : (int)rintf(c);
        word |= (uint32_t)(code & 0xFF) << (8 * u);
      }
    }
    *reinterpret_cast<uint32_t*>(cr + j) = word;
  }
  if (lane == 0) scales[row] = scale;
}

// The score of a query's k-th key as a float threshold that every element
// entering the list reaches: -inf while the list is short (or its k-th key
// lies below -inf's, a negative NaN), +inf from +inf's key up (only +inf
// and NaN scores can pass then). A score below it cannot pass, whatever
// its row; NaN scores are always looked at.
__device__ __forceinline__ float threshold_of(int kth) {
  constexpr int KEY_NEG_INF = (int)0x807FFFFF;  // order_key(-inf)
  constexpr int KEY_POS_INF = 0x7F800000;       // order_key(+inf)
  if (kth <= KEY_NEG_INF) return key_score(KEY_NEG_INF);
  if (kth >= KEY_POS_INF) return key_score(KEY_POS_INF);
  return key_score(kth);
}

// Dequantises one wgmma's accumulator in place, to its scores' bits, in the
// plain version's order (element e = 4i + j: row 2 * half + j / 2 of the
// thread's four, column 8i + cb + j % 2).
template <int W>
__device__ __forceinline__ void dequantise(int (&acc)[W / 2], int half, const float* qs_r, int cb,
                                           const float (&gs_r)[4]) {
#pragma unroll
  for (int i = 0; i < W / 8; ++i) {
    const float2 q = *reinterpret_cast<const float2*>(qs_r + 8 * i + cb);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[4 * i + j] = __float_as_int(__fmul_rn(
          __fmul_rn(__int2float_rn(acc[4 * i + j]), j % 2 ? q.y : q.x), gs_r[2 * half + j / 2]));
  }
}

// The elements of one wgmma's scores that reach their query's float
// threshold, as a mask (bit e for element e).
template <int W>
__device__ __forceinline__ uint32_t near_mask(const int (&sc)[W / 2], const float* thr, int cb) {
  uint32_t near = 0;
#pragma unroll
  for (int i = 0; i < W / 8; ++i) {
    const float2 t = *reinterpret_cast<const float2*>(thr + 8 * i + cb);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      near |= (uint32_t)!(__int_as_float(sc[4 * i + j]) < (j % 2 ? t.y : t.x)) << (4 * i + j);
  }
  return near;
}

// v[e] for an e known only at run time, by a tree of selects on e's bits
// (a register array indexed at run time would move to local memory).
template <int N>
__device__ __forceinline__ int pick(const int (&v)[N], int e) {
  int s[N];
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = v[i];
#pragma unroll
  for (int w = 1; w < N; w *= 2) {
#pragma unroll
    for (int i = 0; i + w < N; i += 2 * w) s[i] = (e & w) ? s[i + w] : s[i];
  }
  return s[0];
}

// A lower bound of each query's k-th best key in the tile (k <= 8), for a
// round whose list is short (a consumer's first tile) or overflowed: each
// lane takes the best of its four rows of each of its W / 4 columns, then,
// one column at a time through a single copy of the sort, the eight lanes
// sharing the column sort those bests in shuffles, and the warp's k-th is a
// key that k rows of the tile reach, so every row below it has k rows above
// it. The largest of the four warps' bounds goes to lo.
template <int W>
__device__ __forceinline__ void tile_bound(const int (&sc0)[W / 2], const int (&sc1)[W / 2], int cb,
                                           int lane, int k, const int (&row)[4], int* lo) {
  int best[W / 4];  // column 8 * (m / 2) + cb + m % 2
#pragma unroll
  for (int i = 0; i < W / 8; ++i) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      int v = INT_MIN;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int s = h < 2 ? sc0[4 * i + jj + 2 * h] : sc1[4 * i + jj + 2 * (h - 2)];
        v = row[h] >= 0 ? max(v, order_key(__int_as_float(s))) : v;
      }
      best[2 * i + jj] = v;
    }
  }
  const int p = lane >> 2;  // this lane's place among the eight sharing its columns
#pragma unroll 1
  for (int m = 0; m < W / 4; ++m) {
    int v = pick<W / 4>(best, m);
#pragma unroll
    for (int size = 2; size <= 8; size <<= 1) {  // bitonic sort, best first
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const int o = __shfl_xor_sync(0xffffffffu, v, stride << 2);
        v = ((p & stride) == 0) == ((p & size) == 0) ? max(v, o) : min(v, o);
      }
    }
    const int kth_best = __shfl_sync(0xffffffffu, v, ((k - 1) << 2) | (lane & 3));
    if (lane < 4) atomicMax(&lo[8 * (m >> 1) + cb + (m & 1)], kth_best);
  }
}

// The exact test of one wgmma's elements in `near` (those that reached
// their query's float threshold), one element at a time through a single
// copy of this code: an element whose order key passes the query's k-th key
// (strictly in round 0, where the k-th key comes from rows before the tile;
// or equal in a later round, against lists that now hold rows of this tile)
// and the round's bound from the tile itself (in a kernel built with the
// bounded round, k <= 8), on a live row and query, and that no earlier round
// placed, takes a slot of its query's buffer while there is one.
template <int W, bool BOUNDED>
__device__ __forceinline__ void offer(const int (&sc)[W / 2], int half, uint32_t near,
                                      const int* kth, const int* lo, int* count, int2* buf,
                                      int cap, int ncols, int cb, const int (&row)[4], bool later,
                                      uint32_t& placed) {
  near &= ~placed;
  while (near) {
    const int e = __ffs(near) - 1;
    near &= near - 1;
    const int c = 8 * (e >> 2) + cb + (e & 1);
    const int r = (e & 2) ? row[2 * half + 1] : row[2 * half];
    const int key = order_key(__int_as_float(pick<W / 2>(sc, e)));
    const int fk = kth[c];
    if (!(key > fk || (later && key == fk)) || (BOUNDED && key < lo[c]) || r < 0 || c >= ncols)
      continue;
    const int slot = atomicAdd(&count[c], 1);
    if (slot < cap) {
      buf[c * cap + slot] = make_int2(key, r);
      placed |= 1u << e;
    }
  }
}

template <int KMAX, int W>
__global__ void __launch_bounds__(THREADS, 1)
    int8_partial(const __grid_constant__ CUtensorMap gallery_map,
                 const __grid_constant__ CUtensorMap query_map,
                 const float* __restrict__ q_scale, const float* __restrict__ g_scale, int B,
                 int N, int D, int k, int rows_per_split, int stages, int* __restrict__ cand_s,
                 int* __restrict__ cand_i) {
  constexpr bool BOUNDED = KMAX <= 8;  // the bounded round: tile_bound ranks eight lane maxima
  static_assert(W <= 64, "a wgmma's elements of a thread are one 32-bit mask");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((SMEM_ALIGN - (smem_u32(smem_raw) & (SMEM_ALIGN - 1))) &
                                    (SMEM_ALIGN - 1));
  const Layout lay{W, stages};
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.barriers_offset());
  uint64_t* empty = full + stages;
  float* qs_r = reinterpret_cast<float*>(smem + lay.qscale_offset());

  const int split = blockIdx.x;
  const int group = blockIdx.y;
  const long long r_begin = (long long)split * rows_per_split;
  const long long r_end = min((long long)N, r_begin + rows_per_split);
  const long long n_tiles = (r_end - r_begin + TILE_ROWS - 1) / TILE_ROWS;
  const int n_chunks = (D + K_CHUNK - 1) / K_CHUNK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of each warp of the ring's consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (threadIdx.x < W) {
    const int q = group * W + threadIdx.x;
    qs_r[threadIdx.x] = q < B ? __fmul_rn(q_scale[q], INV_127) : 0.f;
  }
  for (int i = threadIdx.x; i < CONSUMERS * W; i += THREADS) {
    reinterpret_cast<int*>(smem + lay.count_offset())[i] = 0;
    reinterpret_cast<int*>(smem + lay.kth_offset())[i] = INT_MIN;
    // a query past B never passes: its threshold is +inf's
    reinterpret_cast<float*>(smem + lay.thr_offset())[i] =
        threshold_of(group * W + i % W < B ? INT_MIN : INT_MAX);
    reinterpret_cast<int*>(smem + lay.lo_offset())[i] = INT_MIN;
  }
  __syncthreads();

  // Consumer `cons` takes tiles cons, cons + 2, ... and feeds its own ring
  // of `ring` stages: its chunks (a tile's 128-dim slices in order) fill the
  // ring's stages in turn, and its thread 0 loads the chunk `ring` places
  // ahead into a stage once all four warps have released the chunk there.
  const int cons = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ring = stages / CONSUMERS;
  long long loads_left = (n_tiles - cons + 1) / CONSUMERS * n_chunks;  // this consumer's chunks
  long long load_row = r_begin + cons * TILE_ROWS;
  int load_dim = 0;
  auto load = [&](int stage) {  // the next chunk in this consumer's order
    unsigned char* sbuf = smem + stage * lay.stage_bytes();
    mbar_expect_tx(&full[stage], lay.stage_bytes());
    tma_load(sbuf, &gallery_map, &full[stage], load_dim, (int)load_row);
    tma_load(sbuf + GALLERY_TILE_BYTES, &query_map, &full[stage], load_dim, group * W);
    load_dim += K_CHUNK;
    if (load_dim >= D) {
      load_dim = 0;
      load_row += CONSUMERS * TILE_ROWS;
    }
    --loads_left;
  };
  RingCursor take{cons * ring}, give{cons * ring};  // the next chunk to consume, to release
  if (tid == 0)
    for (int s = 0; s < ring && loads_left > 0; ++s) load(cons * ring + s);
  auto release = [&]() {  // the oldest chunk not yet released: its wgmmas are done
    const int stage = give.stage;
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (tid == 0 && loads_left > 0) {
      mbar_wait(&empty[stage], give.phase);
      load(stage);
    }
    give.advance(cons * ring, ring);
  };

  const int rb = warp * 16 + lane / 4;  // rows rb, rb + 8, rb + 64, rb + 72 of a tile
  const int cb = 2 * (lane % 4);        // columns 8i + cb and 8i + cb + 1
  const int cap = lay.cap();
  int2* buf = reinterpret_cast<int2*>(smem + lay.buf_offset()) + cons * BUF_ENTRIES;
  int* count = reinterpret_cast<int*>(smem + lay.count_offset()) + cons * W;
  int* kth = reinterpret_cast<int*>(smem + lay.kth_offset()) + cons * W;
  float* thr = reinterpret_cast<float*>(smem + lay.thr_offset()) + cons * W;
  int* lo = reinterpret_cast<int*>(smem + lay.lo_offset()) + cons * W;
  const int ncols = min(W, B - group * W);  // live queries of the group
  const bool owner = tid < ncols;           // folds query column tid

  int ts[KMAX];
  int ti[KMAX];
#pragma unroll
  for (int m = 0; m < KMAX; ++m) {
    ts[m] = INT_MIN;
    ti[m] = INT_MAX;
  }

  // A tile's gallery scales (times r) and rows, -1 past the split; each own
  // tile's are loaded during the epilogue of the one before.
  float gs_r[4];
  int row[4];
  auto scales_of = [&](long long t0) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const long long r = t0 + rb + 8 * (h % 2) + WG_ROWS * (h / 2);
      row[h] = r < r_end ? (int)r : -1;
      gs_r[h] = r < r_end ? __fmul_rn(g_scale[r], INV_127) : 0.f;
    }
  };
  scales_of(r_begin + cons * TILE_ROWS);

  bool overflowed = false;  // a buffer of this consumer's overflowed after its first tile
  for (long long j = cons; j < n_tiles; j += CONSUMERS) {
    const long long t0 = r_begin + j * TILE_ROWS;
    int acc0[W / 2];
    int acc1[W / 2];
#pragma unroll
    for (int e = 0; e < W / 2; ++e) acc0[e] = acc1[e] = 0;

    // A tile's chunks are issued back to back and released once its
    // products are done (their refills then load under the epilogue); a
    // tile longer than the ring frees its oldest chunk before each new one.
    for (int c = 0; c < n_chunks; ++c) {
      if (c >= ring) {
        wgmma_wait_one();
        release();
      }
      const int stage = take.stage;
      mbar_wait(&full[stage], take.phase);
      take.advance(cons * ring, ring);
      const unsigned char* sbuf = smem + stage * lay.stage_bytes();
      const uint64_t a_desc = kmajor_sw128_desc(smem_u32(sbuf));
      const uint64_t a_desc1 = kmajor_sw128_desc(smem_u32(sbuf + WG_ROWS * K_CHUNK));
      const uint64_t b_desc = kmajor_sw128_desc(smem_u32(sbuf + GALLERY_TILE_BYTES));
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < K_STEPS; ++s) {  // 32 bytes per k-step along the swizzled rows
        Wgmma<W>::mma(acc0, a_desc + 2 * s, b_desc + 2 * s, 1);
        Wgmma<W>::mma(acc1, a_desc1 + 2 * s, b_desc + 2 * s, 1);
      }
      wgmma_commit();
    }
    wgmma_wait_all();
#pragma unroll
    for (int e = 0; e < W / 2; ++e) {
      reg_fence(acc0[e]);
      reg_fence(acc1[e]);
    }
    for (int c = max(0, n_chunks - ring); c < n_chunks; ++c) release();

    // The epilogue, while the other consumer's wgmmas run: the scores once,
    // then rounds of the filter and the fold.
    dequantise<W>(acc0, 0, qs_r, cb, gs_r);
    dequantise<W>(acc1, 1, qs_r, cb, gs_r);
    uint32_t placed0 = 0, placed1 = 0;  // elements already in a buffer
    for (bool later = false;; later = true) {
      // a consumer's first tile (its lists empty), a round after an overflow
      // and every tile after an overflow past the first tile are also held to
      // the tile's own bound, which joins the float threshold for the round
      if (BOUNDED && (later || j == cons || overflowed)) {
        tile_bound<W>(acc0, acc1, cb, lane, k, row, lo);
        named_barrier(5 + cons, 128);
        if (owner) thr[tid] = fmaxf(thr[tid], threshold_of(lo[tid]));
        named_barrier(5 + cons, 128);
      }
      offer<W, BOUNDED>(acc0, 0, near_mask<W>(acc0, thr, cb), kth, lo, count, buf, cap, ncols, cb,
                        row, later, placed0);
      offer<W, BOUNDED>(acc1, 1, near_mask<W>(acc1, thr, cb), kth, lo, count, buf, cap, ncols, cb,
                        row, later, placed1);
      named_barrier(1 + cons, 128);  // the buffers are written
      bool more = false;
      if (owner) {
        const int n = count[tid];
        const int2* mine = buf + tid * cap;
        const int m = min(n, cap);
        int2 e = mine[0];  // each entry loaded one insert ahead
        for (int s = 0; s < m; ++s) {
          const int2 cur = e;
          if (s + 1 < m) e = mine[s + 1];
          insert<KMAX>(ts, ti, cur.x, cur.y);
        }
        count[tid] = 0;
        more = n > cap;
        int kk = INT_MIN;
#pragma unroll
        for (int mm = 0; mm < KMAX; ++mm)
          if (mm == k - 1 && ti[mm] != INT_MAX) kk = ts[mm];
        kth[tid] = kk;
        thr[tid] = threshold_of(kk);
        if (BOUNDED) lo[tid] = INT_MIN;
      }
      // the buffers are read, the counts and k-th keys are new
      if (!named_barrier_any(3 + cons, 128, more)) break;
      if (j != cons) overflowed = true;  // a first tile's rare overflow says nothing of the rest
    }
    if (j + CONSUMERS < n_tiles) scales_of(t0 + CONSUMERS * TILE_ROWS);
  }

  if (owner) {
    const int query = group * W + tid;
    const size_t out = (((size_t)query * gridDim.x + split) * CONSUMERS + cons) * k;
#pragma unroll
    for (int m = 0; m < KMAX; ++m) {
      if (m < k) {
        cand_s[out + m] = ts[m];
        cand_i[out + m] = ti[m];
      }
    }
  }
}

template <int KMAX>
__global__ void __launch_bounds__(MERGE_THREADS)
    topk_merge(const int* __restrict__ cand_s, const int* __restrict__ cand_i,
               int n_cand, int k, float* __restrict__ out_s, int* __restrict__ out_i) {
  __shared__ int ws[MERGE_THREADS / 32];
  __shared__ int wi[MERGE_THREADS / 32];
  __shared__ int best_s;
  __shared__ int best_i;

  const int qi = blockIdx.x;
  const int* cs = cand_s + (size_t)qi * n_cand;
  const int* ci = cand_i + (size_t)qi * n_cand;

  int ts[KMAX];
  int ti[KMAX];
#pragma unroll
  for (int m = 0; m < KMAX; ++m) {
    ts[m] = INT_MIN;
    ti[m] = INT_MAX;
  }
  for (int c = threadIdx.x; c < n_cand; c += MERGE_THREADS) insert<KMAX>(ts, ti, cs[c], ci[c]);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int m = 0; m < k; ++m) {
    int s = ts[0];
    int i = ti[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int os = __shfl_down_sync(0xffffffffu, s, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (better(os, oi, s, i)) {
        s = os;
        i = oi;
      }
    }
    if (lane == 0) {
      ws[warp] = s;
      wi[warp] = i;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      s = ws[0];
      i = wi[0];
      for (int w = 1; w < MERGE_THREADS / 32; ++w) {
        if (better(ws[w], wi[w], s, i)) {
          s = ws[w];
          i = wi[w];
        }
      }
      best_s = s;
      best_i = i;
      const bool filled = i != INT_MAX;
      out_s[(size_t)qi * k + m] = filled ? key_score(s) : UNFILLED_SCORE;
      out_i[(size_t)qi * k + m] = filled ? i : 0;
    }
    __syncthreads();
    // Real rows are unique across candidates, so exactly one thread pops.
    if (ti[0] == best_i && ts[0] == best_s) {
#pragma unroll
      for (int j = 0; j + 1 < KMAX; ++j) {
        ts[j] = ts[j + 1];
        ti[j] = ti[j + 1];
      }
      ts[KMAX - 1] = INT_MIN;
      ti[KMAX - 1] = INT_MAX;
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, without linking libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, cols) int8 row-major matrix with a row stride of `stride` bytes
// (a multiple of 16), read in (box_rows x 128) boxes with the 128-byte
// swizzle; boxes past the edge are zero-filled.
bool encode(EncodeTiled fn, CUtensorMap* map, const int8_t* base, int rows, int cols,
            long long stride, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride};
  const cuuint32_t box[2] = {(cuuint32_t)K_CHUNK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KMAX, int W>
cudaError_t launch_partial(const CUtensorMap& gmap, const CUtensorMap& qmap, const float* qs,
                           const float* gs, int B, int N, int D, int k, int groups, int n_split,
                           int rows_per_split, int* cand_s, int* cand_i, cudaStream_t stream) {
  Layout lay{W, MAX_STAGES};
  while (lay.stages > MIN_STAGES && lay.bytes() > MAX_SMEM) lay.stages -= CONSUMERS;
  const int bytes = lay.bytes();
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(int8_partial<KMAX, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int8_partial<KMAX, W><<<dim3(n_split, groups), THREADS, bytes, stream>>>(
      gmap, qmap, qs, gs, B, N, D, k, rows_per_split, lay.stages, cand_s, cand_i);
  return cudaSuccess;
}

// Pass 1 at query width W, then pass 2; the widths each list length takes
// are stream_topk's plan's, at most 64.
template <int KMAX>
cudaError_t launch_passes(const CUtensorMap& gmap, const CUtensorMap& qmap, const float* qs,
                          const float* gs, int B, int N, int D, int k, int width, int groups,
                          int n_split, int rows_per_split, int n_cand, int* cand_s, int* cand_i,
                          float* out_s, int* out_i, cudaStream_t st) {
  cudaError_t err = cudaErrorInvalidValue;
#define INT8_TOPK_PASS1(W)                                                                   \
  err = launch_partial<KMAX, W>(gmap, qmap, qs, gs, B, N, D, k, groups, n_split,             \
                                rows_per_split, cand_s, cand_i, st)
  switch (width) {
    case 8: INT8_TOPK_PASS1(8); break;
    case 16: INT8_TOPK_PASS1(16); break;
    case 32: INT8_TOPK_PASS1(32); break;
    case 64: if constexpr (KMAX <= 16) INT8_TOPK_PASS1(64); break;
    default: break;
  }
#undef INT8_TOPK_PASS1
  if (err == cudaSuccess)
    topk_merge<KMAX><<<B, MERGE_THREADS, 0, st>>>(cand_s, cand_i, n_cand, k, out_s, out_i);
  return err;
}

cudaError_t launch_quantize(const float* x, int B, int D, int pitch, int8_t* codes,
                            float* scales, cudaStream_t st) {
  int8_quantize<<<(B + QUANT_WARPS - 1) / QUANT_WARPS, QUANT_WARPS * 32, 0, st>>>(x, B, D, pitch,
                                                                                 codes, scales);
  return cudaGetLastError();
}

// Runs `launch` with `device` current and restores the caller's device;
// returns 0, a CUDA error code, or -1 when `launch` refused its arguments.
template <typename Launch>
int on_device(int device, Launch&& launch) {
  int caller_device = 0;
  cudaError_t err = cudaGetDevice(&caller_device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = launch();
  const cudaError_t restored = cudaSetDevice(caller_device);
  if (err != cudaSuccess) return err == cudaErrorInvalidValue ? -1 : (int)err;
  if (restored != cudaSuccess) return (int)restored;
  return (int)cudaGetLastError();
}

int padded_width(int D) { return (D + 15) / 16 * 16; }

}  // namespace

extern "C" {

// int8_quantize alone: x (B, D) float32 rows (D a multiple of 4, the base
// 16-byte aligned) to codes (B, D rounded up to a multiple of 16) int8 and
// scales (B,) float32. Returns 0, a CUDA error code, or -1 for a shape it
// cannot take.
int int8_quantize_launch(const float* x, int B, int D, int8_t* codes, float* scales, int device,
                         void* stream) {
  if (B < 1 || D < 4 || D % 4) return -1;
  return on_device(device, [&] {
    return launch_quantize(x, B, D, padded_width(D), codes, scales,
                           static_cast<cudaStream_t>(stream));
  });
}

// The top-k of B queries against gallery codes gq (row stride `g_stride`
// bytes, rows [0, n_valid) read) with their float32 scales gs. Given float
// `queries` (B, D), int8_quantize first writes their codes to qq (B, dims)
// and their scales to qs; given none (nullptr), qq (B, dims) and qs are the
// caller's codes and scales. dims, the codes' row width, is D rounded up to
// a multiple of 16 (the codes past D are zeros); both row strides are
// multiples of 16 bytes and the bases 16-byte aligned. The plan (query width
// W, groups, n_split, rows_per_split, n_cand) comes from the Python wrapper;
// cand_s/cand_i are (B, n_cand) int32 scratch (score keys and rows). All
// launches go to `stream`. Returns 0 on success, a CUDA error code, or -1
// for a plan or shape it cannot run and -2 when the driver's tensor-map
// encoder is missing or refuses a map.
int int8_topk_launch(const float* queries, int8_t* qq, float* qs, const int8_t* gq,
                     long long g_stride, const float* gs, int B, int n_valid, int D, int dims,
                     int k, int width, int groups, int n_split, int rows_per_split, int n_cand,
                     int* cand_s, int* cand_i, float* out_s, int* out_i, int device,
                     void* stream) {
  if (B < 1 || n_valid < 1 || dims < 16 || dims % 16 || g_stride < dims || g_stride % 16 ||
      (queries != nullptr && (D < 4 || D % 4 || padded_width(D) != dims)) || k < 1 || k > 32 ||
      k > n_valid || width % 8 || groups < 1 || groups * width < B || n_split < 1 ||
      rows_per_split % TILE_ROWS || (long long)(n_split - 1) * rows_per_split >= n_valid ||
      (long long)n_split * rows_per_split < n_valid || n_cand != n_split * CONSUMERS * k)
    return -1;
  const EncodeTiled fn = encoder();
  CUtensorMap gmap, qmap;
  if (fn == nullptr || !encode(fn, &gmap, gq, n_valid, dims, g_stride, TILE_ROWS) ||
      !encode(fn, &qmap, qq, B, dims, dims, width))
    return -2;
  auto* passes = k <= 8 ? &launch_passes<8> : k <= 16 ? &launch_passes<16> : &launch_passes<32>;
  const auto st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    cudaError_t err = queries != nullptr ? launch_quantize(queries, B, D, dims, qq, qs, st)
                                         : cudaSuccess;
    if (err != cudaSuccess) return err;
    return passes(gmap, qmap, qs, gs, B, n_valid, dims, k, width, groups, n_split,
                  rows_per_split, n_cand, cand_s, cand_i, out_s, out_i, st);
  });
}

}  // extern "C"
