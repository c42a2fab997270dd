// Exact top-k over an int8-quantized gallery, for sm_90a.
//
// Replaces `cosine_topk_int8` (facerecognition_tpu/ops/matcher.py), an XLA
// s8 x s8 -> s32 `dot_general`, a rank-1 dequantisation and `lax.top_k`, as
// one streaming pass that never writes the (B, N) score matrix:
//
//   scores[b, n] = ((float)acc[b, n] * (q_scale[b] * r)) * (g_scale[n] * r)
//
// with acc the exact int32 product of the query and gallery codes and
// r = float32(1 / 127), each product rounded to nearest as written (XLA
// rewrites `/ 127.0` into a product with that reciprocal; the plain version
// `ops/matcher.int8_scores` computes this order). The query codes and
// scales come from the wrapper (ops/int8_topk.py), which quantizes them on
// the device with the plain version's functions, so both paths see the same
// codes.
//
//   pass 1 (int8_partial): grid (n_split, groups), 384 threads, one block per
//     SM. Warpgroup 0 is the producer: one thread keeps a ring of stages in
//     flight by TMA, each a (128 gallery rows x 128 dims) int8 tile and the
//     group's (W x 128) query-code tile, 128-byte swizzled, with mbarrier
//     completion. (Keeping the group's whole query block resident instead
//     measured no faster; see PERF.md.) Rows >= n_valid lie outside the
//     gallery's tensor map and
//     arrive as zeros; they never enter a list. Warpgroups 1 and 2 are the
//     consumers: each takes 64 rows of the tile as the wgmma A operand
//     (gallery rows on the M side, both operands K-major as 8-bit wgmma
//     requires) and issues four m64nWk32 s32.s8.s8 wgmmas per stage, A and B
//     by descriptor, keeping one stage's group in flight while it waits for
//     the next. The int32 accumulator is exact, so it carries the whole row
//     across the chunks. After a tile's last chunk each consumer writes its
//     (64 x W) dequantised scores to shared memory, and each of its first W
//     threads folds the 64 rows, in row order and eight loads ahead, into a
//     register top-k list of (order key, row) for its query (order_key.cuh:
//     NaN above +inf, ties to the lowest row). Each consumer writes its k best per query to
//     scratch: 2 * n_split candidate lists per query.
//   pass 2 (topk_merge): one block per query merges the candidates, as in
//     stream_topk.cu.
//
// The work split (W, groups, n_split, rows_per_split) is stream_topk's plan
// (ops/stream_topk.plan), made in Python and passed in. The ring's depth is
// chosen here at launch, as the deepest that fits the shared memory.
//
// What bounds it, on the H100 SXM's published 3.35 TB/s and 1,979 TOP/s
// (int8, dense): the gallery codes and scales are read once, (D + 4) bytes a
// row, and the product is 2BND integer operations. At (B, N, D) = (128, 1M,
// 512) that is max(0.154 ms of bytes, 0.068 ms of operations): bound by the
// memory path, and at B = 1 and B = 32 more so. A 128-row int8 tile at D =
// 512 is 64 KB, a quarter of stream_topk's float32 tile, and the products
// need no split into tf32 pairs, so the tensor cores have slack everywhere;
// the ring's depth and the epilogue's fold decide how close it comes to the
// memory rate.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "order_key.cuh"

namespace {

constexpr int CONSUMERS = 2;                  // consumer warpgroups
constexpr int WG_ROWS = 64;                   // gallery rows per consumer (wgmma M)
constexpr int TILE_ROWS = CONSUMERS * WG_ROWS;
constexpr int K_CHUNK = 128;                  // dims per stage: 128 bytes, the swizzle span
constexpr int K_STEP = 32;                    // dims per s8 wgmma (32 bytes)
constexpr int K_STEPS = K_CHUNK / K_STEP;
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int GALLERY_TILE_BYTES = TILE_ROWS * K_CHUNK;
constexpr int SMEM_ALIGN = 1024;              // a 128-byte swizzle atom is 8 rows of 128 bytes
constexpr int MAX_SMEM = 232448;
constexpr int MIN_STAGES = 2;
constexpr int MAX_STAGES = 8;
constexpr int MERGE_THREADS = 256;
constexpr int FOLD_BATCH = 8;                 // score-tile rows a fold step loads before it inserts
constexpr float UNFILLED_SCORE = -1e30f;
constexpr float INV_127 = 0x1.020408p-7f;     // float32(1 / 127), as XLA folds `/ 127.0`

// Shared memory of pass 1: `stages` x (gallery tile, query tile), then each
// consumer's (64 x (W + 4)) score tile, the W query scales times r, and the
// full and empty barriers.
struct Layout {
  int width;
  int stages;
  __host__ __device__ int query_bytes() const { return width * K_CHUNK; }
  __host__ __device__ int stage_bytes() const { return GALLERY_TILE_BYTES + query_bytes(); }
  __host__ __device__ int score_stride() const { return width + 4; }
  __host__ __device__ int scores_offset() const { return stages * stage_bytes(); }
  __host__ __device__ int qscale_offset() const {
    return scores_offset() + CONSUMERS * WG_ROWS * score_stride() * 4;
  }
  __host__ __device__ int barriers_offset() const { return qscale_offset() + width * 4; }
  __host__ __device__ int bytes() const { return barriers_offset() + 2 * stages * 8 + SMEM_ALIGN; }
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

template <int KMAX, int W>
__global__ void __launch_bounds__(THREADS, 1)
    int8_partial(const __grid_constant__ CUtensorMap gallery_map,
                 const __grid_constant__ CUtensorMap query_map,
                 const float* __restrict__ q_scale, const float* __restrict__ g_scale, int B,
                 int N, int D, int k, int rows_per_split, int stages, int* __restrict__ cand_s,
                 int* __restrict__ cand_i) {
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
  const int n_chunks = (D + K_CHUNK - 1) / K_CHUNK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (threadIdx.x < W) {
    const int q = group * W + threadIdx.x;
    qs_r[threadIdx.x] = q < B ? __fmul_rn(q_scale[q], INV_127) : 0.f;
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (long long t0 = r_begin; t0 < r_end; t0 += TILE_ROWS) {
        for (int c = 0; c < n_chunks; ++c) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* buf = smem + stage * lay.stage_bytes();
          mbar_expect_tx(&full[stage], lay.stage_bytes());
          tma_load(buf, &gallery_map, &full[stage], c * K_CHUNK, (int)t0);
          tma_load(buf + GALLERY_TILE_BYTES, &query_map, &full[stage], c * K_CHUNK, group * W);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumer
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int cons = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = warp * 16 + lane / 4;  // and row0 + 8, within this consumer's 64 rows
  const int col = lane % 4;                // columns 8i + 2col (+1)
  float* scores = reinterpret_cast<float*>(smem + lay.scores_offset()) +
                  cons * WG_ROWS * lay.score_stride();
  const int query = group * W + tid;
  const bool owns_query = tid < W && query < B;

  int ts[KMAX];
  int ti[KMAX];
#pragma unroll
  for (int m = 0; m < KMAX; ++m) {
    ts[m] = INT_MIN;
    ti[m] = INT_MAX;
  }

  int stage = 0, phase = 0;
  for (long long t0 = r_begin; t0 < r_end; t0 += TILE_ROWS) {
    int acc[W / 2];
#pragma unroll
    for (int j = 0; j < W / 2; ++j) acc[j] = 0;

    // One stage's wgmmas stay in flight while the next stage is awaited;
    // a stage is released once the group after it has been issued and its
    // own group is done.
    int prev = -1;
    for (int c = 0; c < n_chunks; ++c) {
      mbar_wait(&full[stage], phase);
      const unsigned char* buf = smem + stage * lay.stage_bytes();
      const uint64_t a_desc = kmajor_sw128_desc(smem_u32(buf + cons * WG_ROWS * K_CHUNK));
      const uint64_t b_desc = kmajor_sw128_desc(smem_u32(buf + GALLERY_TILE_BYTES));
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < K_STEPS; ++s)  // 32 bytes per k-step along the swizzled rows
        Wgmma<W>::mma(acc, a_desc + 2 * s, b_desc + 2 * s, 1);
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait_one();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = stage;
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < W / 2; ++j) reg_fence(acc[j]);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // Dequantise as the plain version rounds: ((float)acc * qs·r) * gs·r.
    const long long base = t0 + cons * WG_ROWS;
    const float gs0 = base + row0 < r_end ? __fmul_rn(g_scale[base + row0], INV_127) : 0.f;
    const float gs1 = base + row0 + 8 < r_end ? __fmul_rn(g_scale[base + row0 + 8], INV_127) : 0.f;
    named_barrier(1 + cons, 128);  // the previous tile's scores are read
#pragma unroll
    for (int i = 0; i < W / 8; ++i) {
      const int cc = 8 * i + 2 * col;
      const float q0 = qs_r[cc];
      const float q1 = qs_r[cc + 1];
      float* p = scores + row0 * lay.score_stride() + cc;
      *reinterpret_cast<float2*>(p) =
          make_float2(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * i]), q0), gs0),
                      __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * i + 1]), q1), gs0));
      *reinterpret_cast<float2*>(p + 8 * lay.score_stride()) =
          make_float2(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * i + 2]), q0), gs1),
                      __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * i + 3]), q1), gs1));
    }
    named_barrier(1 + cons, 128);
    if (owns_query) {
      // Rows in order; a full tile loads FOLD_BATCH keys before it inserts
      // them, so their shared-memory latencies overlap.
      const float* column = scores + tid;
      const int stride = lay.score_stride();
      const int rows = (int)min((long long)WG_ROWS, r_end - base);
      if (rows == WG_ROWS) {
#pragma unroll 1
        for (int r0 = 0; r0 < WG_ROWS; r0 += FOLD_BATCH) {
          int key[FOLD_BATCH];
#pragma unroll
          for (int u = 0; u < FOLD_BATCH; ++u) key[u] = order_key(column[(r0 + u) * stride]);
#pragma unroll
          for (int u = 0; u < FOLD_BATCH; ++u) insert<KMAX>(ts, ti, key[u], (int)base + r0 + u);
        }
      } else {
        for (int r = 0; r < rows; ++r)
          insert<KMAX>(ts, ti, order_key(column[r * stride]), (int)base + r);
      }
    }
  }

  if (owns_query) {
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
  while (lay.stages > MIN_STAGES && lay.bytes() > MAX_SMEM) --lay.stages;
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
// are stream_topk's plan's.
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
    case 128: if constexpr (KMAX <= 8) INT8_TOPK_PASS1(128); break;
    default: break;
  }
#undef INT8_TOPK_PASS1
  if (err == cudaSuccess)
    topk_merge<KMAX><<<B, MERGE_THREADS, 0, st>>>(cand_s, cand_i, n_cand, k, out_s, out_i);
  return err;
}

}  // namespace

extern "C" {

// qq (B, D) int8 query codes with their (B,) float32 scales; gq int8
// gallery codes, row stride `g_stride` bytes, of which rows [0, n_valid)
// are read, with their float32 scales. D and both row strides are multiples
// of 16 bytes and the bases 16-byte aligned. The plan (query width W,
// groups, n_split, rows_per_split, n_cand) comes from the Python wrapper;
// cand_s/cand_i are (B, n_cand) int32 scratch (score keys and rows). Returns
// 0 on success, a CUDA error code, or -1 for a plan or shape it cannot run
// and -2 when the driver's tensor-map encoder is missing or refuses a map.
int int8_topk_launch(const int8_t* qq, const float* qs, const int8_t* gq, long long g_stride,
                     const float* gs, int B, int n_valid, int D, int k, int width, int groups,
                     int n_split, int rows_per_split, int n_cand, int* cand_s, int* cand_i,
                     float* out_s, int* out_i, int device, void* stream) {
  if (B < 1 || n_valid < 1 || D < 16 || D % 16 || g_stride < D || g_stride % 16 || k < 1 ||
      k > 32 || k > n_valid || width % 8 || groups < 1 || groups * width < B || n_split < 1 ||
      rows_per_split % TILE_ROWS || (long long)(n_split - 1) * rows_per_split >= n_valid ||
      (long long)n_split * rows_per_split < n_valid || n_cand != n_split * CONSUMERS * k)
    return -1;
  const EncodeTiled fn = encoder();
  CUtensorMap gmap, qmap;
  if (fn == nullptr || !encode(fn, &gmap, gq, n_valid, D, g_stride, TILE_ROWS) ||
      !encode(fn, &qmap, qq, B, D, D, width))
    return -2;
  int caller_device = 0;
  cudaError_t err = cudaGetDevice(&caller_device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto* passes = k <= 8 ? &launch_passes<8> : k <= 16 ? &launch_passes<16> : &launch_passes<32>;
  err = passes(gmap, qmap, qs, gs, B, n_valid, D, k, width, groups, n_split, rows_per_split,
               n_cand, cand_s, cand_i, out_s, out_i, static_cast<cudaStream_t>(stream));
  const cudaError_t restored = cudaSetDevice(caller_device);
  if (err != cudaSuccess) return err == cudaErrorInvalidValue ? -1 : (int)err;
  if (restored != cudaSuccess) return (int)restored;
  return (int)cudaGetLastError();
}

}  // extern "C"
