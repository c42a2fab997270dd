// Exact top-k cosine search over a float32 gallery, for sm_90a.
//
// Replaces the Pallas kernel `_topk_tile_kernel` behind `pallas_cosine_topk`
// (facerecognition_tpu/ops/pallas_topk.py). It computes the same function,
// not the same tiling: the TPU kernel carries one running top-k across a
// sequential grid, while Hopper runs blocks in parallel, so
//
//   split_queries: each query is L2-normalised and split into a tf32 pair,
//     hi = rna_tf32(x), lo = rna_tf32(x - hi); cut into groups of W (a
//     multiple of 8, at most 128) and padded with zero rows, the pairs go to
//     a (2 * groups * W, D) scratch.
//   pass 1 (topk_partial): grid (n_split, groups), 384 threads, one block per
//     SM. Warpgroup 0 is the producer: one thread keeps a ring of 2-4 stages in
//     flight by TMA, each a (128 gallery rows x 32 dims) tile and the
//     group's hi and lo (W x 32) query tiles, all 128-byte swizzled, with
//     mbarrier completion. Warpgroups 1 and 2 are the consumers: each takes
//     64 rows of the tile as the wgmma A operand (gallery rows on the M
//     side), loads them from shared memory into registers and splits them
//     there into hi and lo, and issues m64nWk8 tf32 wgmmas against the
//     query tiles (B, by descriptor): lo*hi, hi*lo, hi*hi per k-step, small
//     terms first ("3xTF32"; one tf32 product is off by up to 7e-5 at
//     D = 512). The tensor cores sum one 32-dim chunk (12 wgmmas); the
//     chunk sums are added in float32 on the SIMT pipes. Summing all 192
//     wgmmas of D = 512 in the tensor cores' accumulator, whose float32 adds
//     do not round to nearest, was off by up to 6.4e-6 on the card; the
//     chunk sums bring that to 4.8e-7, below the float32 FMA kernel's 8.3e-7.
//     The second accumulator costs W / 2 registers, so the producer warpgroup
//     gives its registers to the consumers (setmaxnreg 40 / 232). A is
//     split in registers rather than written back to shared memory as hi and
//     lo tiles: the tile is read from shared memory once, and the split costs
//     three ALU operations per element where the tensor cores are the limit.
//     The same registers give each row's sum of squares: every row is summed
//     by four lanes in the same k order and reduced by the same shuffles, so
//     two equal rows get bit-equal norms and scores wherever they sit. After
//     the last chunk each consumer scales its scores by 1/max(|g|, 1e-12),
//     writes the (64 x W) tile to shared memory, and each of its first W
//     threads folds the 64 rows, in row order, into a register top-k list
//     for its query. Rows >= N (zero-filled by TMA) and rows of the next
//     split never enter. Each consumer writes its k best per query to
//     scratch: 2 * n_split candidate lists per query.
//   pass 2 (topk_merge): one block per query merges the candidates.
//
// Order everywhere is (score descending, index ascending), so ties resolve
// to the lowest gallery row, as lax.top_k does. Scores are ranked by an int32
// key of IEEE total order (order_key), so a NaN score ranks above +inf, as in
// lax.top_k; the lists and the candidates hold keys, and the merge turns the
// winners back into floats. Indices are int32 end to end; row offsets and the
// split bounds are 64-bit, so any N below 2^31 rows is taken. Slots left unfilled (k > N) come out as score -1e30, index 0, as the
// Pallas wrapper clamps them. The gallery is read once and never normalised
// in device memory. The plan (W, groups, splits) is made by the Python
// wrapper and passed in; the ring's depth is chosen here, at launch, as the
// deepest that fits the shared memory, since only this file knows the layout.
//
// What bounds it, on the H100 SXM's published 3.35 TB/s and 495 TFLOP/s
// (tf32, dense): the work is three tf32 products, 3 * 2BND operations, and
// the gallery and queries read once. At the serving match shape (B = 128,
// N = 1,000,000, D = 512) that is max(0.61 ms of bytes, 0.795 ms of
// operations): bound by the tensor cores. At B = 1 and B = 32 the gallery
// read binds (0.611 ms at N = 1M; 0.061 ms at N = 100k); there the W = 8
// padding of the query side costs tensor-core work, not memory-path work.
// The query tiles are read again for every 128-row gallery tile, from L2:
// 2 * W / 128 bytes of L2 per byte of gallery from HBM (2.0 at W = 128,
// 0.5 at W = 32, 0.125 at W = 8). The two consumer warpgroups share one
// tile so the ratio is half that of one 64-row consumer; a cluster that
// multicasts the query tiles would halve it again.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "order_key.cuh"

namespace {

constexpr int CONSUMERS = 2;                  // consumer warpgroups
constexpr int WG_ROWS = 64;                   // gallery rows per consumer (wgmma M)
constexpr int TILE_ROWS = CONSUMERS * WG_ROWS;
constexpr int K_CHUNK = 32;                   // dims per stage: 128 bytes, the swizzle span
constexpr int K_STEP = 8;                     // dims per tf32 wgmma
constexpr int K_STEPS = K_CHUNK / K_STEP;
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int GALLERY_TILE_BYTES = TILE_ROWS * K_CHUNK * 4;
constexpr int SMEM_ALIGN = 1024;              // a 128-byte swizzle atom is 8 rows of 128 bytes
constexpr int MAX_SMEM = 232448;
constexpr int MIN_STAGES = 2;
constexpr int MAX_STAGES = 4;
constexpr int MERGE_THREADS = 256;
constexpr int SPLIT_THREADS = 128;
constexpr float UNFILLED_SCORE = -1e30f;

// Shared memory of pass 1: `stages` x (gallery tile, hi queries, lo
// queries), then each consumer's (64 x (W + 4)) score tile, then the full
// and empty barriers. The launch takes the deepest ring of MIN_STAGES to
// MAX_STAGES that fits MAX_SMEM.
struct Layout {
  int width;
  int stages;
  __host__ __device__ int query_bytes() const { return width * K_CHUNK * 4; }
  __host__ __device__ int stage_bytes() const { return GALLERY_TILE_BYTES + 2 * query_bytes(); }
  __host__ __device__ int score_stride() const { return width + 4; }
  __host__ __device__ int scores_offset() const { return stages * stage_bytes(); }
  __host__ __device__ int barriers_offset() const {
    return scores_offset() + CONSUMERS * WG_ROWS * score_stride() * 4;
  }
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

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
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

// Keeps the compiler from touching a register across an asynchronous wgmma.
__device__ __forceinline__ void reg_fence(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

// Shared-memory descriptor of a K-major operand tile with the 128-byte
// swizzle: 8-row groups 1024 bytes apart; the leading offset is unused.
__device__ __forceinline__ uint64_t kmajor_sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Element (r, c) of a (rows x 32) float tile that TMA wrote with the 128-byte
// swizzle: the 16-byte chunk c / 4 of row r sits at chunk (c / 4) ^ (r % 8).
__device__ __forceinline__ float swizzled(const unsigned char* tile, int r, int c) {
  return *reinterpret_cast<const float*>(tile + r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2)));
}

// wgmma m64nWk8, f32 (+)= tf32 x tf32, A from registers, B by descriptor
// (K-major, as tf32 requires). The fragment of A: lane l of warp w holds
// rows 16w + l/4 (+8) and columns l%4 (+4). The accumulator: d[4i + j] is
// row 16w + l/4 + 8 * (j / 2), column 8i + 2 * (l % 4) + j % 2.
template <int W>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ __forceinline__ static void mma(float (&d)[4], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <int KMAX, int W>
__global__ void __launch_bounds__(THREADS, 1)
    topk_partial(const __grid_constant__ CUtensorMap gallery_map,
                 const __grid_constant__ CUtensorMap query_map, int B, int N, int D, int k,
                 int rows_per_split, int stages, int* __restrict__ cand_s,
                 int* __restrict__ cand_i) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((SMEM_ALIGN - (smem_u32(smem_raw) & (SMEM_ALIGN - 1))) &
                                    (SMEM_ALIGN - 1));
  const Layout lay{W, stages};
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.barriers_offset());
  uint64_t* empty = full + stages;

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
          tma_load(buf + GALLERY_TILE_BYTES, &query_map, &full[stage], c * K_CHUNK,
                   2 * group * W);
          tma_load(buf + GALLERY_TILE_BYTES + lay.query_bytes(), &query_map, &full[stage],
                   c * K_CHUNK, (2 * group + 1) * W);
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
  const int row0 = cons * WG_ROWS + warp * 16 + lane / 4;  // and row0 + 8, within the tile
  const int col = lane % 4;                                // and col + 4, within a k-step
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
    float acc[W / 2], total[W / 2];
#pragma unroll
    for (int j = 0; j < W / 2; ++j) total[j] = acc[j] = 0.f;
    float sq0 = 0.f, sq1 = 0.f;

    for (int c = 0; c < n_chunks; ++c) {
      mbar_wait(&full[stage], phase);
      const unsigned char* buf = smem + stage * lay.stage_bytes();
      const uint64_t hi_desc = kmajor_sw128_desc(smem_u32(buf + GALLERY_TILE_BYTES));
      const uint64_t lo_desc =
          kmajor_sw128_desc(smem_u32(buf + GALLERY_TILE_BYTES + lay.query_bytes()));
      uint32_t a_hi[K_STEPS][4], a_lo[K_STEPS][4];
#pragma unroll
      for (int s = 0; s < K_STEPS; ++s) {
        const float x[4] = {
            swizzled(buf, row0, s * K_STEP + col), swizzled(buf, row0 + 8, s * K_STEP + col),
            swizzled(buf, row0, s * K_STEP + col + 4), swizzled(buf, row0 + 8, s * K_STEP + col + 4)};
        sq0 = fmaf(x[0], x[0], sq0);
        sq0 = fmaf(x[2], x[2], sq0);
        sq1 = fmaf(x[1], x[1], sq1);
        sq1 = fmaf(x[3], x[3], sq1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a_hi[s][e] = tf32_rna(x[e]);
          a_lo[s][e] = tf32_rna(x[e] - __uint_as_float(a_hi[s][e]));
        }
      }
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < K_STEPS; ++s) {
        // 32 bytes per k-step along the swizzled 128-byte rows; the chunk's
        // first product overwrites the accumulator (scale-d = 0).
        Wgmma<W>::mma(acc, a_lo[s], hi_desc + 2 * s, s > 0);
        Wgmma<W>::mma(acc, a_hi[s], lo_desc + 2 * s, 1);
        Wgmma<W>::mma(acc, a_hi[s], hi_desc + 2 * s, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < W / 2; ++j) {
        reg_fence(acc[j]);
        total[j] += acc[j];
      }
#pragma unroll
      for (int s = 0; s < K_STEPS; ++s) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          reg_fence(a_hi[s][e]);
          reg_fence(a_lo[s][e]);
        }
      }
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // The four lanes of a row hold its partial sums; the same shuffles for every row.
    sq0 += __shfl_xor_sync(0xffffffffu, sq0, 1);
    sq0 += __shfl_xor_sync(0xffffffffu, sq0, 2);
    sq1 += __shfl_xor_sync(0xffffffffu, sq1, 1);
    sq1 += __shfl_xor_sync(0xffffffffu, sq1, 2);
    const float inv0 = 1.f / fmaxf(sqrtf(sq0), 1e-12f);
    const float inv1 = 1.f / fmaxf(sqrtf(sq1), 1e-12f);

    named_barrier(1 + cons, 128);  // the previous tile's scores are read
    const int r_local = row0 - cons * WG_ROWS;
#pragma unroll
    for (int i = 0; i < W / 8; ++i) {
      float* p = scores + r_local * lay.score_stride() + 8 * i + 2 * col;
      *reinterpret_cast<float2*>(p) = make_float2(total[4 * i] * inv0, total[4 * i + 1] * inv0);
      *reinterpret_cast<float2*>(p + 8 * lay.score_stride()) =
          make_float2(total[4 * i + 2] * inv1, total[4 * i + 3] * inv1);
    }
    named_barrier(1 + cons, 128);
    if (owns_query) {
      const int base = (int)t0 + cons * WG_ROWS;
      const int rows = (int)min((long long)WG_ROWS, r_end - base);
      for (int r = 0; r < rows; ++r)
        insert<KMAX>(ts, ti, order_key(scores[r * lay.score_stride() + tid]), base + r);
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

// One block per padded query row r (group r / W): x / max(|x|, 1e-12), as
// the plain version normalises, split into tf32 hi (row 2gW + r % W of the
// scratch) and lo (row (2g + 1)W + r % W). Rows past B are zero.
__global__ void __launch_bounds__(SPLIT_THREADS)
    split_queries(const float* __restrict__ q, int B, int D, int width,
                  float* __restrict__ out) {
  __shared__ float partial[SPLIT_THREADS / 32];
  const int row = blockIdx.x;
  const float* x = q + (size_t)row * D;
  float ss = 0.f;
  if (row < B)
    for (int d = threadIdx.x; d < D; d += SPLIT_THREADS) ss = fmaf(x[d], x[d], ss);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = ss;
  __syncthreads();
  ss = 0.f;
#pragma unroll
  for (int w = 0; w < SPLIT_THREADS / 32; ++w) ss += partial[w];
  const float norm = fmaxf(sqrtf(ss), 1e-12f);
  float* hi_row = out + ((size_t)(2 * (row / width)) * width + row % width) * D;
  float* lo_row = hi_row + (size_t)width * D;
  for (int d = threadIdx.x; d < D; d += SPLIT_THREADS) {
    const float v = row < B ? x[d] / norm : 0.f;
    const uint32_t hi = tf32_rna(v);
    hi_row[d] = __uint_as_float(hi);
    lo_row[d] = __uint_as_float(tf32_rna(v - __uint_as_float(hi)));
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

// A (rows, cols) float32 row-major matrix read in (box_rows x 32) boxes with
// the 128-byte swizzle; boxes past the edge are zero-filled.
bool encode(EncodeTiled fn, CUtensorMap* map, const float* base, int rows, int cols,
            int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)K_CHUNK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KMAX, int W>
cudaError_t launch_partial(const CUtensorMap& gmap, const CUtensorMap& qmap, int B, int N, int D,
                           int k, int groups, int n_split, int rows_per_split,
                           int* cand_s, int* cand_i, cudaStream_t stream) {
  int stages = MAX_STAGES;
  while (stages > MIN_STAGES && Layout{W, stages}.bytes() > MAX_SMEM) --stages;
  const int bytes = Layout{W, stages}.bytes();
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(topk_partial<KMAX, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  topk_partial<KMAX, W><<<dim3(n_split, groups), THREADS, bytes, stream>>>(
      gmap, qmap, B, N, D, k, rows_per_split, stages, cand_s, cand_i);
  return cudaSuccess;
}

// Pass 1 at query width W, then pass 2. The widest W shrinks as the lists
// grow, so that accumulators and lists fit the registers.
template <int KMAX>
cudaError_t launch_passes(const CUtensorMap& gmap, const CUtensorMap& qmap, int B, int N, int D,
                          int k, int width, int groups, int n_split, int rows_per_split,
                          int n_cand, int* cand_s, int* cand_i, float* out_s, int* out_i,
                          cudaStream_t st) {
  cudaError_t err = cudaErrorInvalidValue;
#define STREAM_TOPK_PASS1(W)                                                                  \
  err = launch_partial<KMAX, W>(gmap, qmap, B, N, D, k, groups, n_split, rows_per_split,  \
                                cand_s, cand_i, st)
  switch (width) {
    case 8: STREAM_TOPK_PASS1(8); break;
    case 16: STREAM_TOPK_PASS1(16); break;
    case 32: STREAM_TOPK_PASS1(32); break;
    case 64: if constexpr (KMAX <= 16) STREAM_TOPK_PASS1(64); break;
    case 128: if constexpr (KMAX <= 8) STREAM_TOPK_PASS1(128); break;
    default: break;
  }
#undef STREAM_TOPK_PASS1
  if (err == cudaSuccess)
    topk_merge<KMAX><<<B, MERGE_THREADS, 0, st>>>(cand_s, cand_i, n_cand, k, out_s, out_i);
  return err;
}

// The three launches of one call on `st`: split, pass 1, pass 2.
cudaError_t launch_all(const CUtensorMap& gmap, const CUtensorMap& qmap, const float* q, int B,
                       int N, int D, int k, int width, int groups, int n_split,
                       int rows_per_split, int n_cand, float* q_split,
                       int* cand_s, int* cand_i, float* out_s, int* out_i, cudaStream_t st) {
  split_queries<<<groups * width, SPLIT_THREADS, 0, st>>>(q, B, D, width, q_split);
  auto* passes = k <= 8 ? &launch_passes<8> : k <= 16 ? &launch_passes<16> : &launch_passes<32>;
  return passes(gmap, qmap, B, N, D, k, width, groups, n_split, rows_per_split, n_cand, cand_s,
                cand_i, out_s, out_i, st);
}

}  // namespace

extern "C" {

// q (B, D) and g (N, D) any rows, both float32 row-major with
// D % 4 == 0 and 16-byte aligned. The plan (query width W, groups, n_split,
// rows_per_split, n_cand) comes from the Python wrapper; q_split is
// a (2 * groups * W, D) float32 scratch, cand_s/cand_i (B, n_cand) int32 (score
// keys and rows). Returns
// 0 on success, a CUDA error code, or -1 for a plan it cannot run and -2
// when the driver's tensor-map encoder is missing or refuses a map.
int stream_topk_launch(const float* q, const float* g, int B, int N, int D, int k, int width,
                       int groups, int n_split, int rows_per_split, int n_cand,
                       float* q_split, int* cand_s, int* cand_i, float* out_s, int* out_i,
                       int device, void* stream) {
  if (B < 1 || N < 1 || D < 4 || D % 4 || k < 1 || k > 32 || width % 8 || groups < 1 ||
      groups * width < B || n_split < 1 || rows_per_split % TILE_ROWS ||
      (long long)(n_split - 1) * rows_per_split >= N ||
      (long long)n_split * rows_per_split < N || n_cand != n_split * CONSUMERS * k)
    return -1;
  const EncodeTiled fn = encoder();
  CUtensorMap gmap, qmap;
  if (fn == nullptr || !encode(fn, &gmap, g, N, D, TILE_ROWS) ||
      !encode(fn, &qmap, q_split, 2 * groups * width, D, width))
    return -2;
  int caller_device = 0;
  cudaError_t err = cudaGetDevice(&caller_device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = launch_all(gmap, qmap, q, B, N, D, k, width, groups, n_split, rows_per_split, n_cand,
                   q_split, cand_s, cand_i, out_s, out_i,
                   static_cast<cudaStream_t>(stream));
  const cudaError_t restored = cudaSetDevice(caller_device);
  if (err != cudaSuccess) return err == cudaErrorInvalidValue ? -1 : (int)err;
  if (restored != cudaSuccess) return (int)restored;
  return (int)cudaGetLastError();
}

}  // extern "C"
